"""δ-state payloads: extract, apply, slice overwrite, first-contact
merge and deletion-log GC.

The counterpart of the JAX package's ``ops/delta.py``.  A payload is a
pair of masked dense tensors: ``changed`` lanes carry live dots the
receiver's clock has not covered, ``deleted`` lanes carry deletion dots
not obsoleted by a local re-add (the reference's ``MakeDeltaMergeData``,
awset-delta_test.go:79-105).  Every function takes one replica slice
(vv[A], lanes[E], actor[]) or a batch of them (vv[R, A], lanes[R, E],
actor[R]) alike, so the δ round's plain version (ops/cuda_delta.py)
composes ``delta_extract``, ``delta_apply`` and ``full_merge_delta``
here: the decision table lives in this module once.

uint32 fields are int32 bits (``_u32.py``): compares that order
counters widen to int64 first.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from go_crdt_playground_tpu_torch._u32 import MASK, narrow, widen
from go_crdt_playground_tpu_torch.models.awset_delta import AWSetDeltaState
from go_crdt_playground_tpu_torch.ops.merge import merge_kernel
from go_crdt_playground_tpu_torch.ops.vv import clock_at, has_dot, vv_join


class DeltaPayload(NamedTuple):
    """Sender-compressed δ payload (one replica slice, or a batch)."""

    src_vv: torch.Tensor         # int32[A]
    changed: torch.Tensor        # bool[E]
    ch_da: torch.Tensor          # int32[E]  live dots on changed lanes
    ch_dc: torch.Tensor          # int32[E]
    deleted: torch.Tensor        # bool[E]
    del_da: torch.Tensor         # int32[E]  deletion dots on deleted lanes
    del_dc: torch.Tensor         # int32[E]
    src_actor: torch.Tensor      # int32[]
    src_processed: torch.Tensor  # int32[A]  (v2 bookkeeping)


def delta_extract(src: AWSetDeltaState,
                  dst_vv: torch.Tensor) -> DeltaPayload:
    """Sender-side ``MakeDeltaMergeData`` for src against one receiver
    vv."""
    changed = src.present & ~has_dot(dst_vv, src.dot_actor, src.dot_counter)
    # re-add filter: skip records whose key is live locally under a
    # different actor or a higher counter (awset-delta_test.go:94-97)
    resurrected = src.present & (
        (src.dot_actor != src.del_dot_actor)
        | (widen(src.dot_counter) > widen(src.del_dot_counter)))
    deleted = src.deleted & ~resurrected
    return DeltaPayload(
        src_vv=src.vv,
        changed=changed,
        ch_da=torch.where(changed, src.dot_actor, 0),
        ch_dc=torch.where(changed, src.dot_counter, 0),
        deleted=deleted,
        del_da=torch.where(deleted, src.del_dot_actor, 0),
        del_dc=torch.where(deleted, src.del_dot_counter, 0),
        src_actor=src.actor,
        src_processed=src.processed,
    )


def _join_processed(processed, src_processed, src_actor, src_vv):
    """Spec ``_join_processed``: elementwise max, then the sender's own
    slot advances to its clock (an id outside [0, A) advances nothing,
    as the JAX scatter drops it)."""
    proc = torch.maximum(widen(processed), widen(src_processed))
    svv = widen(src_vv)
    slots = torch.arange(proc.shape[-1], device=proc.device)
    own = slots == widen(src_actor)[..., None]
    return narrow(torch.where(own & (proc < svv), svv, proc))


def _absorb_records(dst: AWSetDeltaState, deleted, del_da, del_dc):
    """v2 record absorb: overwrite if absent here or (counter, actor)
    lexicographically newer, so the absorb is a join and two replicas
    converge bitwise on the lane whatever the arrival order."""
    sxc, dxc = widen(del_dc), widen(dst.del_dot_counter)
    newer = (sxc > dxc) | ((sxc == dxc)
                           & (widen(del_da) > widen(dst.del_dot_actor)))
    take = deleted & (~dst.deleted | newer)
    return (dst.deleted | deleted,
            torch.where(take, del_da, dst.del_dot_actor),
            torch.where(take, del_dc, dst.del_dot_counter))


def delta_apply(dst: AWSetDeltaState, p: DeltaPayload,
                delta_semantics: str = "reference",
                strict_reference_semantics: bool = True) -> AWSetDeltaState:
    """Receiver-side ``deltaMerge`` (awset-delta_test.go:107-166)."""
    if delta_semantics not in ("v2", "reference"):
        raise ValueError(f"unknown delta_semantics {delta_semantics!r}")
    # phase 1 over changed lanes: the full merge's phase-1 table
    seen_by_dst = has_dot(dst.vv, p.ch_da, p.ch_dc)
    p1_take = p.changed & (dst.present | ~seen_by_dst)
    present1 = dst.present | p1_take
    da1 = torch.where(p1_take, p.ch_da, dst.dot_actor)
    dc1 = torch.where(p1_take, p.ch_dc, dst.dot_counter)

    if delta_semantics == "v2":
        # remove iff the SENDER's clock covers our post-phase-1 dot
        remove = p.deleted & present1 & has_dot(p.src_vv, da1, dc1)
    else:
        # reference arbitration: keep iff OUR clock covers the deletion dot
        remove = p.deleted & present1 & ~has_dot(dst.vv, p.del_da, p.del_dc)
    present = present1 & ~remove
    da = torch.where(present, da1, 0)
    dc = torch.where(present, dc1, 0)

    joined = vv_join(dst.vv, p.src_vv)
    if delta_semantics == "reference" and strict_reference_semantics:
        # the empty-δ early return (awset-delta_test.go:60-64) as a select
        nonempty = (p.changed.any(dim=-1, keepdim=True)
                    | p.deleted.any(dim=-1, keepdim=True))
        vv = torch.where(nonempty, joined, dst.vv)
    else:
        vv = joined

    if delta_semantics == "v2":
        deleted_log, del_da, del_dc = _absorb_records(
            dst, p.deleted, p.del_da, p.del_dc)
        processed = _join_processed(dst.processed, p.src_processed,
                                    p.src_actor, p.src_vv)
    else:
        deleted_log = dst.deleted
        del_da, del_dc = dst.del_dot_actor, dst.del_dot_counter
        processed = dst.processed
    return AWSetDeltaState(
        vv=vv, present=present, dot_actor=da, dot_counter=dc,
        actor=dst.actor, deleted=deleted_log, del_dot_actor=del_da,
        del_dot_counter=del_dc, processed=processed)


def slice_apply(dst: AWSetDeltaState, p: DeltaPayload) -> AWSetDeltaState:
    """Keyspace-handoff apply: the payload is the donor's complete fenced
    state for the lanes it names (``changed | deleted``), so those lanes
    are OVERWRITTEN, never vv-arbitrated; lanes outside the payload are
    untouched and the vv/processed joins keep the clocks monotone."""
    in_slice = p.changed | p.deleted
    return AWSetDeltaState(
        vv=vv_join(dst.vv, p.src_vv),
        present=torch.where(in_slice, p.changed, dst.present),
        dot_actor=torch.where(in_slice, p.ch_da, dst.dot_actor),
        dot_counter=torch.where(in_slice, p.ch_dc, dst.dot_counter),
        actor=dst.actor,
        deleted=torch.where(in_slice, p.deleted, dst.deleted),
        del_dot_actor=torch.where(in_slice, p.del_da, dst.del_dot_actor),
        del_dot_counter=torch.where(in_slice, p.del_dc, dst.del_dot_counter),
        processed=_join_processed(dst.processed, p.src_processed,
                                  p.src_actor, p.src_vv))


def full_merge_delta(dst: AWSetDeltaState, src: AWSetDeltaState,
                     delta_semantics: str) -> AWSetDeltaState:
    """First-contact branch (awset-delta_test.go:53-56): the plain
    full-state merge.  Reference mode leaves the receiver's log
    untouched; v2 absorbs src's log and processed vector."""
    vv, present, da, dc, _ = merge_kernel(
        dst.vv, dst.present, dst.dot_actor, dst.dot_counter,
        src.vv, src.present, src.dot_actor, src.dot_counter)
    if delta_semantics == "v2":
        deleted_log, del_da, del_dc = _absorb_records(
            dst, src.deleted, src.del_dot_actor, src.del_dot_counter)
        processed = _join_processed(dst.processed, src.processed,
                                    src.actor, src.vv)
    else:
        deleted_log = dst.deleted
        del_da, del_dc = dst.del_dot_actor, dst.del_dot_counter
        processed = dst.processed
    return AWSetDeltaState(
        vv=vv, present=present, dot_actor=da, dot_counter=dc,
        actor=dst.actor, deleted=deleted_log, del_dot_actor=del_da,
        del_dot_counter=del_dc, processed=processed)


# ---------------------------------------------------------------------------
# δ-log GC: causal stability via the frontier min over replicas
# ---------------------------------------------------------------------------


def gc_frontier(processed: torch.Tensor,
                participating: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """frontier[a] = min over participating replicas of processed[r, a]
    (unsigned); a deletion record (k, (a, c)) is stable iff
    c <= frontier[a].  processed: int32[R, A]; participating: bool[R]
    (None = all)."""
    proc = widen(processed)
    if participating is not None:
        proc = torch.where(participating[:, None], proc, MASK)
    return narrow(proc.min(dim=0).values)


def gc_apply(state: AWSetDeltaState,
             frontier: torch.Tensor) -> AWSetDeltaState:
    """Drop stable deletion records: deleted lanes whose dot counter the
    frontier covers for the dot's origin actor (ids clipped, as
    ``jnp.take(mode="clip")``)."""
    covered = clock_at(frontier, state.del_dot_actor)
    stable = state.deleted & (widen(state.del_dot_counter) <= covered)
    keep = state.deleted & ~stable
    return state._replace(
        deleted=keep,
        del_dot_actor=torch.where(keep, state.del_dot_actor, 0),
        del_dot_counter=torch.where(keep, state.del_dot_counter, 0))
