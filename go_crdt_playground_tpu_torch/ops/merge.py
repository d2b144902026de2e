"""The AWSet merge as closed-form masks over the element axis.

``AWSet.merge`` (awset.go:107-161) is two sequential map loops plus a VV
join.  Here every per-key decision is a mask, the two phases compose
into closed-form expressions, and ``HasDot`` is a gather and an unsigned
compare.  The functions take one replica pair (vv[A], lanes[E]) or a
batch of pairs (vv[R, A], lanes[R, E]) alike.

Semantics preserved exactly, including the quirks:
  * unconditional dot overwrite when present on both sides, even when
    the src dot is older;
  * ``skip`` when dst's clock covers an absent entry's dot;
  * removal only when the SRC clock covers dst's live dot.

Canonical form: dot lanes are zeroed where absent.

This is the plain version of the merge kernels (ops/cuda_merge.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from go_crdt_playground_tpu_torch.models.awset import AWSetState
from go_crdt_playground_tpu_torch.ops.vv import has_dot, vv_join

# Merge-decision outcome labels (the reference's logOutcome tracing)
OUTCOME_NONE = 0
OUTCOME_UPDATE = 1   # present both sides, dots differ
OUTCOME_KEEP = 2
OUTCOME_SKIP = 3     # dst clock covers unseen entry
OUTCOME_ADD = 4      # genuinely new to dst
OUTCOME_REMOVE = 5   # src witnessed and dropped


class MergeTrace(NamedTuple):
    """Per-element decision tensors (uint8[..., E]) for the two phases."""

    phase1: torch.Tensor
    phase2: torch.Tensor


def _codes(*pairs, default: int) -> torch.Tensor:
    """First matching (mask, code) pair per lane, else ``default``."""
    out = torch.full_like(pairs[0][0], default, dtype=torch.uint8)
    for mask, code in reversed(pairs):
        out = torch.where(mask, code, out)
    return out


def merge_kernel(dst_vv, dst_present, dst_da, dst_dc,
                 src_vv, src_present, src_da, src_dc,
                 with_trace: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor, Optional[MergeTrace]]:
    """``dst <- src`` as closed-form masks; returns (vv, present, da, dc,
    trace)."""
    seen_by_dst = has_dot(dst_vv, src_da, src_dc)   # dst clock covers src dot
    seen_by_src = has_dot(src_vv, dst_da, dst_dc)   # src clock covers dst dot

    # phase 1: lanes that end up carrying the src dot
    take_src = src_present & (dst_present | ~seen_by_dst)
    # phase 2: dst-only lanes removed iff src witnessed them
    remove = dst_present & ~src_present & seen_by_src

    present = take_src | (dst_present & ~src_present & ~seen_by_src)
    da = torch.where(take_src, src_da, dst_da)
    dc = torch.where(take_src, src_dc, dst_dc)
    # canonical form: zero dots on absent lanes
    da = torch.where(present, da, 0)
    dc = torch.where(present, dc, 0)
    vv = vv_join(dst_vv, src_vv)

    trace = None
    if with_trace:
        both = dst_present & src_present
        p1 = _codes(
            (both & ((dst_da != src_da) | (dst_dc != src_dc)),
             OUTCOME_UPDATE),
            (both, OUTCOME_KEEP),
            (src_present & seen_by_dst, OUTCOME_SKIP),
            (src_present, OUTCOME_ADD),
            default=OUTCOME_NONE)
        present1 = dst_present | (src_present & ~seen_by_dst)
        p2 = _codes((present1 & remove, OUTCOME_REMOVE),
                    (present1, OUTCOME_KEEP), default=OUTCOME_NONE)
        trace = MergeTrace(phase1=p1, phase2=p2)
    return vv, present, da, dc, trace


def _merge_state_arrays(dst: AWSetState, src: AWSetState, with_trace: bool):
    vv, present, da, dc, trace = merge_kernel(
        dst.vv, dst.present, dst.dot_actor, dst.dot_counter,
        src.vv, src.present, src.dot_actor, src.dot_counter,
        with_trace=with_trace)
    return AWSetState(vv=vv, present=present, dot_actor=da, dot_counter=dc,
                      actor=dst.actor), trace


def merge_pairwise(dst: AWSetState, src: AWSetState,
                   with_trace: bool = False):
    """Batched ``dst[r] <- src[r]`` for every replica r.  Returns
    (merged AWSetState, Optional[MergeTrace])."""
    return _merge_state_arrays(dst, src, with_trace)


def merge_one_into(dst: AWSetState, r_dst, src: AWSetState, r_src,
                   with_trace: bool = False, kernel: str = "auto"):
    """Replica ``r_dst`` of ``dst`` absorbs replica ``r_src`` of ``src``
    (the direct method call of the reference's simulation harness, and
    the bridge's full-state merge).  Returns (the new ``dst``, the trace
    or None).

    ``kernel`` follows the K wrappers' rule (ops/cuda_merge.use_kernel):
    on CUDA tensors the two rows go through K3 (``cuda_merge.
    merge_pairwise`` on two one-row batches), on CPU tensors through the
    plain version.  No kernel emits a trace, so ``with_trace=True`` runs
    the plain version, and raises with ``kernel="cuda"``."""
    from go_crdt_playground_tpu_torch.ops import cuda_merge

    r_dst, r_src = int(r_dst), int(r_src)
    if with_trace:
        if kernel == "cuda":
            raise ValueError("with_trace=True runs the plain version (no "
                             "kernel emits a merge trace); kernel='cuda' "
                             "cannot honour it")
        on_kernel = False
    else:
        on_kernel = cuda_merge.use_kernel(kernel, dst.vv)
    if on_kernel:
        merged = cuda_merge.merge_pairwise(
            AWSetState(*(x[r_dst:r_dst + 1] for x in dst)),
            AWSetState(*(x[r_src:r_src + 1] for x in src)))
        merged, trace = AWSetState(*(x[0] for x in merged)), None
    else:
        merged, trace = _merge_state_arrays(
            AWSetState(*(x[r_dst] for x in dst)),
            AWSetState(*(x[r_src] for x in src)), with_trace)
    return set_row(dst, r_dst, merged), trace


def set_row(full, r: int, row):
    """A copy of the state ``full`` with row ``r`` of every field but the
    replica's own actor column replaced by ``row``'s."""
    fields = []
    for name, x, y in zip(full._fields, full, row):
        if name != "actor":
            x = x.clone()
            x[r] = y
        fields.append(x)
    return type(full)(*fields)


def _sample_awset(rng, n: int, n_ops: int, device="cuda") -> AWSetState:
    """Reachable AWSet rows for the lattice laws: seeded adds and
    deletes plus gossip mixing through the merge itself, drawn as the
    reference's ``_sample_awset`` draws.  One add per element: a re-add
    while a stale copy of the element's dot circulates exercises the
    documented (order-sensitive) stale-dot overwrite, and the laws are
    promised over the single-dot regime."""
    from go_crdt_playground_tpu_torch.models import awset
    from go_crdt_playground_tpu_torch.ops import lattices

    n_elems = 8
    state = awset.init(n, n_elems, n, device=device)
    join = lambda d, s: merge_pairwise(d, s)[0]  # noqa: E731
    unadded = list(range(n_elems))
    for _ in range(n_ops):
        roll = rng.random()
        if roll < 0.35 and unadded:
            e = unadded.pop(int(rng.integers(len(unadded))))
            state = awset.add_element(state, e % n, e)
        elif roll < 0.55:
            state = awset.del_element(state, rng.integers(n),
                                      rng.integers(n_elems))
        else:
            state = lattices.mix_rows(join, state, rng)
    return state


def _register_awset_join() -> None:
    from go_crdt_playground_tpu_torch._u32 import host
    from go_crdt_playground_tpu_torch.ops import lattices

    def join(dst: AWSetState, src: AWSetState) -> AWSetState:
        # K2 for CUDA tensors (the law pass on the card), its plain
        # version -- this module's merge -- for CPU tensors
        from go_crdt_playground_tpu_torch.ops import cuda_merge

        return cuda_merge.merge_pairwise_rows(dst, src)

    lattices.register_join(lattices.JoinSpec(
        "awset_merge", _sample_awset, join,
        # the observable projection only: dot metadata is order-sensitive
        # by documented design (the stale-dot overwrite)
        lambda s: {"vv": host(s.vv), "present": host(s.present)}))


_register_awset_join()
