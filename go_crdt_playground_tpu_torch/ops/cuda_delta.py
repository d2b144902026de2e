"""The δ-AWSet anti-entropy round on a hand-written CUDA kernel
(csrc/delta.cu).

Kernels and the Pallas kernels they replace
(go_crdt_playground_tpu/ops/pallas_delta.py):

  K4 ``delta_ring_round``           <- ``pallas_delta_ring_round``: replica
                                       r absorbs the δ of (r + offset) mod R;
  K5 ``delta_gossip_round``         <- ``pallas_delta_gossip_round``: r
                                       absorbs the δ of perm[r];
  K8 ``delta_ring_round_packed``    <- ``pallas_delta_ring_round_packed``:
                                       K4 on the bitpacked layout;
  K9 ``delta_ring_round_dotpacked`` <- ``pallas_delta_ring_round_dotpacked``:
                                       K4 on the dot-word layout
                                       (models/packed.py), on its own
                                       kernel: warps walk segments of the
                                       ring's cycles (``ring_segments``).

All take the three δ semantics of the JAX package: v2, reference
(strict: the empty-δ vv skip) and reference_loose.  Dispatch, checks and
launch counting follow ops/cuda_merge.py; the plain version is
``delta_round_plain`` below on whole [R, E] tensors, built from
ops/delta.py (the packed entries unpack, run it and pack).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple

import torch

from go_crdt_playground_tpu_torch.models import packed
from go_crdt_playground_tpu_torch.models.awset_delta import AWSetDeltaState
from go_crdt_playground_tpu_torch.ops import _build
from go_crdt_playground_tpu_torch.ops import delta as delta_ops
from go_crdt_playground_tpu_torch.ops.cuda_merge import (
    LAYOUT_BITS, LAYOUT_DOTWORD, MAX_FUSED_ACTORS, PARTNER_GATHER,
    PARTNER_RING, _count_lock, as_index, check_ring_rows, check_state,
    layout_of, out_like, ptr, ring_index, stream_of, use_kernel)

MODES = {"v2": 0, "reference": 1, "reference_loose": 2}
# K9's segment length L: a segment reads L + 1 rows for L outputs, so a
# round reads (1 + 1/L) x the state; 16 keeps that within 7% of one read
# and still gives 65,536 segments (warps) at R = 2^20, offset 1.
SEGMENT_ROWS = 16

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int


def kernel_mode(delta_semantics: str,
                strict_reference_semantics: bool) -> str:
    if delta_semantics == "v2":
        return "v2"
    if delta_semantics == "reference":
        return ("reference" if strict_reference_semantics
                else "reference_loose")
    raise ValueError(f"unknown delta_semantics {delta_semantics!r}")


# kernel mode -> (delta_semantics, strict_reference_semantics)
_SEMANTICS = {"v2": ("v2", True), "reference": ("reference", True),
              "reference_loose": ("reference", False)}


def delta_round_plain(state: AWSetDeltaState, index: torch.Tensor,
                      mode: str) -> AWSetDeltaState:
    """The plain version of every entry: replica r absorbs the δ of row
    index[r], by the first-contact full merge where r's clock for the
    sender's actor is 0, else by extract + apply
    (ops/delta.delta_merge_pairwise)."""
    sem, strict = _SEMANTICS[mode]
    return delta_ops.delta_merge_pairwise(
        state, AWSetDeltaState(*(x[index] for x in state)), sem, strict)


class RingSegments(NamedTuple):
    """How K9 walks a ring round.  Under r -> (r + offset) mod R the rows
    form ``cycles`` = gcd(offset, R) cycles of ``cycle_len`` = R / cycles
    rows; position j of cycle k is row (k + j offset) mod R.  Each cycle
    is cut into ``per_cycle`` segments of at most ``seg_len`` positions."""
    num_r: int
    offset: int      # offset mod R
    cycles: int
    cycle_len: int
    per_cycle: int
    seg_len: int

    @property
    def count(self) -> int:
        return self.cycles * self.per_cycle


def ring_segments(num_r: int, offset, seg_len: int = SEGMENT_ROWS
                  ) -> RingSegments:
    """The geometry of a ring round's cycles, cut into segments of at
    most ``seg_len`` rows (offset 0: R cycles of one row)."""
    if num_r < 1 or seg_len < 1:
        raise ValueError(f"need R >= 1 and seg_len >= 1, got R={num_r}, "
                         f"seg_len={seg_len}")
    o = int(offset) % num_r
    g = math.gcd(o, num_r)
    n = num_r // g
    return RingSegments(num_r, o, g, n, -(-n // seg_len), seg_len)


def segment_rows(geom: RingSegments, q: int) -> List[int]:
    """Rows c_0 .. c_len of segment q, as the kernel computes them: step
    i writes row c_i from c_i and its partner c_{i+1}, so the last entry
    is the last step's partner (c_0 again when the segment is its whole
    cycle)."""
    k, t = divmod(q, geom.per_cycle)
    j0 = t * geom.seg_len
    length = min(geom.seg_len, geom.cycle_len - j0)
    start = (k + j0 * geom.offset) % geom.num_r
    return [(start + m * geom.offset) % geom.num_r
            for m in range(length + 1)]


def _delta_lanes(state):
    """The six E-shaped lane pointers' tensors in the kernel's order;
    the dot-word layout fills the counter slots with None."""
    layout = layout_of(state)
    if layout == LAYOUT_DOTWORD:
        return (state.present_bits, state.dots, None, state.deleted_bits,
                state.del_dots, None)
    if layout == LAYOUT_BITS:
        return (state.present_bits, state.dot_actor, state.dot_counter,
                state.deleted_bits, state.del_dot_actor,
                state.del_dot_counter)
    return (state.present, state.dot_actor, state.dot_counter,
            state.deleted, state.del_dot_actor, state.del_dot_counter)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("delta")
    lib.crdt_delta_round.argtypes = (
        [_P] * 10 + [_I64, _I32, _I32] + [_P] * 8
        + [_I64, _I64, _I32, _I32, _P])
    lib.crdt_delta_round.restype = ctypes.c_int
    lib.crdt_delta_ring_dotword.argtypes = (
        [_P] * 13 + [_I64] * 4 + [_I32, _I32, _I64, _I64, _I32, _P])
    lib.crdt_delta_ring_dotword.restype = ctypes.c_int
    return lib


def _launch(state, perm, offset: int, partner_mode: int, mode: str,
            max_actors=MAX_FUSED_ACTORS):
    check_state(state, max_actors)
    num_r, num_a = state.vv.shape
    outs = out_like(state)
    lib = _lib()
    with torch.cuda.device(state.vv.device):
        rc = lib.crdt_delta_round(
            ptr(state.vv), ptr(state.processed),
            *map(ptr, _delta_lanes(state)), ptr(state.actor),
            ptr(perm), offset, partner_mode, MODES[mode],
            ptr(outs.vv), ptr(outs.processed),
            *map(ptr, _delta_lanes(outs)),
            num_r, packed.num_elements(state), num_a, layout_of(state),
            stream_of(state.vv))
    _build.check(lib, rc, "crdt_delta_round")
    return outs


_DOT_FIELDS = ("vv", "processed", "present_bits", "dots", "deleted_bits",
               "del_dots")


def _launch_walk(state: packed.DotPackedAWSetDeltaState, geom: RingSegments,
                 mode: str) -> packed.DotPackedAWSetDeltaState:
    check_state(state)
    num_r, num_a = state.vv.shape
    outs = out_like(state)
    lib = _lib()
    with torch.cuda.device(state.vv.device):
        rc = lib.crdt_delta_ring_dotword(
            *(ptr(getattr(state, f)) for f in _DOT_FIELDS), ptr(state.actor),
            *(ptr(getattr(outs, f)) for f in _DOT_FIELDS),
            geom.offset, geom.cycle_len, geom.per_cycle, geom.count,
            geom.seg_len, MODES[mode], num_r, packed.num_elements(state),
            num_a, stream_of(state.vv))
    _build.check(lib, rc, "crdt_delta_ring_dotword")
    return outs


def delta_ring_round(state: AWSetDeltaState, offset, *,
                     delta_semantics: str = "v2",
                     strict_reference_semantics: bool = True,
                     kernel: str = "auto") -> AWSetDeltaState:
    """K4: one δ round against partner (r + offset) mod R."""
    mode = kernel_mode(delta_semantics, strict_reference_semantics)
    num_r = state.num_replicas
    if not use_kernel(kernel, state.vv):
        return delta_round_plain(
            state, ring_index(num_r, offset, state.vv.device), mode)
    out = _launch(state, None, int(offset) % num_r if num_r else 0,
                  PARTNER_RING, mode)
    delta_ring_round.launches += 1
    return out


def delta_gossip_round(state: AWSetDeltaState, perm, *,
                       delta_semantics: str = "v2",
                       strict_reference_semantics: bool = True,
                       kernel: str = "auto") -> AWSetDeltaState:
    """K5: one δ round in which replica r absorbs the δ of perm[r]; any
    actor axis A."""
    mode = kernel_mode(delta_semantics, strict_reference_semantics)
    perm = as_index(perm, state.num_replicas, state.vv.device)
    if not use_kernel(kernel, state.vv):
        return delta_round_plain(state, perm, mode)
    out = _launch(state, perm, 0, PARTNER_GATHER, mode, max_actors=None)
    with _count_lock:  # the bridge's connection threads call it at once
        delta_gossip_round.launches += 1
    return out


def delta_ring_round_packed(state: packed.PackedAWSetDeltaState, offset, *,
                            delta_semantics: str = "v2",
                            strict_reference_semantics: bool = True,
                            kernel: str = "auto"
                            ) -> packed.PackedAWSetDeltaState:
    """K8: K4 on the bitpacked layout.  The plain version unpacks, runs
    the δ round against the ring partner and packs."""
    mode = kernel_mode(delta_semantics, strict_reference_semantics)
    num_r = state.vv.shape[0]
    check_ring_rows(num_r)
    if not use_kernel(kernel, state.vv):
        full = packed.unpack_awset_delta(state, packed.num_elements(state))
        return packed.pack_awset_delta(delta_round_plain(
            full, ring_index(num_r, offset, state.vv.device), mode))
    out = _launch(state, None, int(offset) % num_r, PARTNER_RING, mode)
    delta_ring_round_packed.launches += 1
    return out


def delta_ring_round_dotpacked(state: packed.DotPackedAWSetDeltaState,
                               offset, *, delta_semantics: str = "v2",
                               strict_reference_semantics: bool = True,
                               kernel: str = "auto"
                               ) -> packed.DotPackedAWSetDeltaState:
    """K9: K4 on the dot-word layout, on the cycle-walking kernel.  The
    plain version unpacks, runs the δ round against the ring partner and
    packs."""
    mode = kernel_mode(delta_semantics, strict_reference_semantics)
    num_r = state.vv.shape[0]
    check_ring_rows(num_r)
    if not use_kernel(kernel, state.vv):
        full = packed.unpack_awset_delta_dots(state,
                                              packed.num_elements(state))
        return packed.pack_awset_delta_dots(delta_round_plain(
            full, ring_index(num_r, offset, state.vv.device), mode))
    out = _launch_walk(state, ring_segments(num_r, offset), mode)
    delta_ring_round_dotpacked.launches += 1
    return out


def _delta_ring_round_dotpacked_rowwise(
        state: packed.DotPackedAWSetDeltaState, offset, *,
        delta_semantics: str = "v2", strict_reference_semantics: bool = True
        ) -> packed.DotPackedAWSetDeltaState:
    """K9's function on K8's block-per-row kernel (a block per row, the
    partner row read apart).  No entry point calls it: chip_smoke.py times
    it beside K9 on the same card."""
    mode = kernel_mode(delta_semantics, strict_reference_semantics)
    return _launch(state, None, int(offset) % state.vv.shape[0],
                   PARTNER_RING, mode)


delta_ring_round.launches = 0
delta_gossip_round.launches = 0
delta_ring_round_packed.launches = 0
delta_ring_round_dotpacked.launches = 0
