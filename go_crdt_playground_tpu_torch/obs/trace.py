"""Merge-decision trace rendering.

The counterpart of the JAX package's ``obs/trace.py``.  Reproduces the
reference's trace lines byte for byte (``> phase %d %-10q %-18s => %s``,
awset.go:120, and the ``merge %v <- %v`` header, awset.go:121) from
either source:

  * spec-model TraceEvents (models/spec.py collects them via a TraceFn);
  * the plain merge's MergeTrace decision tensors (ops/merge.py,
    ops/delta.delta_apply_traced), whose per-element codes are decoded
    back to lines in element-id order — the deterministic normalization
    of Go's random map-iteration order.

Tensors are read as numpy (int32 bits as uint32) through ``_host.host``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from go_crdt_playground_tpu_torch._host import host
from go_crdt_playground_tpu_torch.models.spec import (Dot, TraceEvent,
                                                      VersionVector,
                                                      _go_quote)
from go_crdt_playground_tpu_torch.ops.merge import (OUTCOME_ADD, OUTCOME_KEEP,
                                                    OUTCOME_NONE,
                                                    OUTCOME_REMOVE,
                                                    OUTCOME_SKIP,
                                                    OUTCOME_UPDATE,
                                                    MergeTrace)

OUTCOME_NAMES: Dict[int, str] = {
    OUTCOME_UPDATE: "update",
    OUTCOME_KEEP: "keep",
    OUTCOME_SKIP: "skip",
    OUTCOME_ADD: "add",
    OUTCOME_REMOVE: "remove",
}


def _dot_str(dot: Optional[Tuple[int, int]]) -> str:
    """Go ``Dot.String`` via the spec model's renderer (crdt-misc.go:17-19);
    ``()`` for a nil dot."""
    if dot is None:
        return "()"
    return str(Dot(dot[0], dot[1]))


def vv_str(vv: Sequence[int]) -> str:
    """Go ``VersionVector.String`` via the spec model's renderer
    (crdt-misc.go:57-68)."""
    return str(VersionVector([int(n) for n in vv]))


def format_line(phase: int, key: str, dst_dot: Optional[Tuple[int, int]],
                src_dot: Optional[Tuple[int, int]], outcome: str) -> str:
    """One ``logOutcome`` line (awset.go:109-120)."""
    dots = f"{_dot_str(dst_dot)} <- {_dot_str(src_dot)}"
    return f"> phase {phase} {_go_quote(key):<10} {dots:<18} => {outcome}"


def _as_pair(dot) -> Optional[Tuple[int, int]]:
    if dot is None:
        return None
    if isinstance(dot, Dot):
        return (int(dot.actor), int(dot.counter))
    return (int(dot[0]), int(dot[1]))


def format_event(ev: TraceEvent) -> str:
    """Render one spec-model TraceEvent as the reference line."""
    return format_line(ev.phase, ev.key, _as_pair(ev.dst_dot),
                       _as_pair(ev.src_dot), ev.outcome)


def render_spec_trace(events: Iterable[TraceEvent]) -> List[str]:
    return [format_event(ev) for ev in events]


def render_tensor_trace(
    trace: MergeTrace,
    dst_before,
    src,
    key_of=None,
    header: bool = True,
) -> List[str]:
    """Decode a kernel MergeTrace back to reference-format lines.

    dst_before/src: single-replica AWSetState slices captured BEFORE the
    merge (the kernel is functional, so the caller still has them).
    key_of: element id -> key string (e.g. ElementDict.decode); defaults
    to the decimal id.  Lines come out in element-id order — Go's map
    order is nondeterministic, so comparisons should sort both sides.
    """
    key_of = key_of or (lambda e: str(e))
    p1 = host(trace.phase1)
    p2 = host(trace.phase2)
    dst_p = host(dst_before.present)
    src_p = host(src.present)
    dst_dot = (host(dst_before.dot_actor),
               host(dst_before.dot_counter))
    src_dot = (host(src.dot_actor), host(src.dot_counter))
    if p1.ndim != 1:
        raise ValueError("render_tensor_trace takes single-replica slices; "
                         "index the batch first")

    def dot_at(dots, e):
        return (int(dots[0][e]), int(dots[1][e]))

    lines: List[str] = []
    if header:
        lines.append(f"merge {vv_str(host(dst_before.vv))} "
                     f"<- {vv_str(host(src.vv))}")
    for e in np.nonzero(p1 != OUTCOME_NONE)[0]:
        code = int(p1[e])
        d = dot_at(dst_dot, e) if dst_p[e] else None
        s = dot_at(src_dot, e) if src_p[e] else None
        lines.append(format_line(1, key_of(int(e)), d, s,
                                 OUTCOME_NAMES[code]))
    for e in np.nonzero(p2 != OUTCOME_NONE)[0]:
        code = int(p2[e])
        # phase 2 logs the POST-phase-1 dst dot (awset.go:145-147): for
        # lanes present on both sides phase 1 overwrote it with src's dot
        if src_p[e]:
            d = dot_at(src_dot, e)
            s = dot_at(src_dot, e)
        else:
            d = dot_at(dst_dot, e)
            s = None
        lines.append(format_line(2, key_of(int(e)), d, s,
                                 OUTCOME_NAMES[code]))
    return lines


def format_delta_extract(changed, deleted) -> str:
    """The sender-side δ-extraction print (awset-delta_test.go:103):
    ``delta: changed map[D:(A 4) E:(A 5)], deleted map[B:(A 3)]``.
    Go's ``%v`` renders a map[string]Dot with SORTED keys (fmt sorts map
    keys for deterministic output), bare keys, the Dot's String(), and a
    nil or empty map as ``map[]``."""
    def go_map(d) -> str:
        if not d:
            return "map[]"
        inner = " ".join(
            f"{k}:{_dot_str(_as_pair(v))}" for k, v in sorted(d.items()))
        return f"map[{inner}]"

    return f"delta: changed {go_map(changed)}, deleted {go_map(deleted)}"


def format_delta_extract_tensor(payload, key_of=None) -> str:
    """``format_delta_extract`` from a single-replica DeltaPayload
    (ops/delta.delta_extract): payload masks decode to the same Go map
    rendering, with element ids mapped through ``key_of`` (the
    ElementDict decode in dictionary-coded deployments)."""
    key_of = key_of or (lambda e: str(e))
    changed = host(payload.changed)
    if changed.ndim != 1:
        raise ValueError("format_delta_extract_tensor takes a "
                         "single-replica payload; index the batch first")
    # one host copy per array: a per-lane scalar index on a device tensor
    # is a round trip each
    ch_da, ch_dc = host(payload.ch_da), host(payload.ch_dc)
    del_da, del_dc = host(payload.del_da), host(payload.del_dc)
    ch = {key_of(int(e)): (int(ch_da[e]), int(ch_dc[e]))
          for e in np.nonzero(changed)[0]}
    dl = {key_of(int(e)): (int(del_da[e]), int(del_dc[e]))
          for e in np.nonzero(host(payload.deleted))[0]}
    return format_delta_extract(ch, dl)


def render_delta_tensor_trace(
    trace: MergeTrace,
    dst_before,
    payload,
    key_of=None,
    header: bool = True,
    delta_semantics: str = "reference",
) -> List[str]:
    """Decode a δ-apply trace (ops.delta.delta_apply_traced) back to the
    reference's deltaMerge log lines (awset-delta_test.go:113-163).

    dst_before: the receiver slice BEFORE the apply; payload: the
    DeltaPayload that was applied.  The phase-2 dst dot is the
    post-phase-1 live dot, reconstructed here the same way the spec
    model reads ``dst.entries`` after phase 1 mutated it.
    """
    key_of = key_of or (lambda e: str(e))
    p1 = host(trace.phase1)
    p2 = host(trace.phase2)
    dst_p = host(dst_before.present)
    changed = host(payload.changed)
    ch_dot = (host(payload.ch_da), host(payload.ch_dc))
    del_dot = (host(payload.del_da), host(payload.del_dc))
    dst_dot = (host(dst_before.dot_actor),
               host(dst_before.dot_counter))
    if p1.ndim != 1:
        raise ValueError("render_delta_tensor_trace takes single-replica "
                         "slices; index the batch first")

    def dot_at(dots, e):
        return (int(dots[0][e]), int(dots[1][e]))

    lines: List[str] = []
    if header:
        lines.append(f"merge {vv_str(host(dst_before.vv))} "
                     f"<- {vv_str(host(payload.src_vv))}")
    for e in np.nonzero(p1 != OUTCOME_NONE)[0]:
        code = int(p1[e])
        d = dot_at(dst_dot, e) if dst_p[e] else None
        lines.append(format_line(1, key_of(int(e)), d, dot_at(ch_dot, e),
                                 OUTCOME_NAMES[code]))
    # post-phase-1 live dot: changed lanes taken in phase 1 carry the
    # payload dot (take = changed & (present | outcome != skip))
    take = changed & (dst_p | (p1 == OUTCOME_ADD))
    for e in np.nonzero(p2 != OUTCOME_NONE)[0]:
        code = int(p2[e])
        live = dot_at(ch_dot, e) if take[e] else dot_at(dst_dot, e)
        present1 = dst_p[e] or take[e]
        if not present1:
            d, s = None, None                      # no-op delete, :160-162
        elif code == OUTCOME_REMOVE:
            d, s = live, None                      # :570/:582 in the spec
        elif delta_semantics == "v2":
            d, s = live, dot_at(del_dot, e)        # v2 keep
        else:
            d, s = None, dot_at(del_dot, e)        # reference keep, :153-155
        lines.append(format_line(2, key_of(int(e)), d, s,
                                 OUTCOME_NAMES[code]))
    return lines


# The fixtures' boxed dump rule: exactly 48 em-dashes (awset_test.go:170).
_BOX_RULE = "—" * 48


def printstate(replicas, names: Optional[Sequence[str]] = None) -> str:
    """The test fixtures' boxed replica dump (awset_test.go:169-174),
    byte-identical for two replicas named A and B and generalized to any
    replica count.  ``replicas`` are spec AWSets (rendered via their
    canonical String) or pre-rendered strings (e.g. utils.codec.
    render_packed output for the tensor path)."""
    if names is None:
        names = [chr(ord("A") + i) for i in range(len(replicas))]
    elif len(names) != len(replicas):
        raise ValueError(
            f"{len(names)} names for {len(replicas)} replicas — a debug "
            "dump must never silently drop state")
    lines = [_BOX_RULE]
    for name, rep in zip(names, replicas):
        lines.append(f"Replica {name}: {rep}")
    lines.append(_BOX_RULE)
    return "\n".join(lines) + "\n"


def trace_counts(trace: MergeTrace) -> Dict[str, Dict[str, int]]:
    """Outcome histograms per phase — the aggregate view that replaces
    stdout-scraping for bulk merges (works on batched traces too)."""
    out: Dict[str, Dict[str, int]] = {}
    for phase_name, arr in (("phase1", trace.phase1),
                            ("phase2", trace.phase2)):
        counts = np.bincount(host(arr).ravel(), minlength=6)
        out[phase_name] = {
            name: int(counts[code]) for code, name in OUTCOME_NAMES.items()
            if counts[code]
        }
    return out
