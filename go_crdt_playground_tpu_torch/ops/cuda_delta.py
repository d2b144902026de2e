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
                                       (models/packed.py).

All take the three δ semantics of the JAX package: v2, reference
(strict: the empty-δ vv skip) and reference_loose.  Dispatch, checks and
launch counting follow ops/cuda_merge.py; the plain version is
``_delta_algebra`` below on whole [R, E] tensors (the packed entries
unpack, run it and pack).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from go_crdt_playground_tpu_torch._u32 import narrow, widen
from go_crdt_playground_tpu_torch.models import packed
from go_crdt_playground_tpu_torch.models.awset_delta import AWSetDeltaState
from go_crdt_playground_tpu_torch.ops import _build
from go_crdt_playground_tpu_torch.ops.cuda_merge import (
    LAYOUT_BITS, LAYOUT_DOTWORD, PARTNER_GATHER, PARTNER_RING, as_index,
    check_ring_rows, check_state, layout_of, out_like, ptr, ring_index,
    stream_of, use_kernel)
from go_crdt_playground_tpu_torch.ops.vv import clock_at, has_dot, vv_join

MODES = {"v2": 0, "reference": 1, "reference_loose": 2}

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


def _delta_algebra(dst: AWSetDeltaState, src: AWSetDeltaState,
                   s_actor: torch.Tensor, mode: str = "v2"):
    """The fused δ exchange on whole tensors: src rows aligned with dst
    rows, s_actor int32[R] the sender's actor per row.  Returns the 8
    output tensors in state order (vv, processed, present, dot_actor,
    dot_counter, deleted, del_dot_actor, del_dot_counter)."""
    dvv, svv = dst.vv, src.vv
    dp, sp = dst.present, src.present
    dda, sda = dst.dot_actor, src.dot_actor
    ddc, sdc = dst.dot_counter, src.dot_counter
    dd, sd = dst.deleted, src.deleted
    ddda, sdda = dst.del_dot_actor, src.del_dot_actor
    dddc, sddc = dst.del_dot_counter, src.del_dot_counter

    # first contact: the receiver's counter for the sender's actor is 0
    fc = clock_at(dvv, s_actor[:, None]) == 0            # bool[R, 1]

    seen_s_by_d = has_dot(dvv, sda, sdc)   # receiver covers src dot
    seen_d_by_s = has_dot(svv, dda, ddc)   # sender covers dst dot

    # ---- FULL branch (first contact) ----
    take_f = sp & (dp | ~seen_s_by_d)
    present_f = take_f | (dp & ~sp & ~seen_d_by_s)
    da_f = torch.where(present_f, torch.where(take_f, sda, dda), 0)
    dc_f = torch.where(present_f, torch.where(take_f, sdc, ddc), 0)

    # ---- δ branch, phase 1 ----
    changed = sp & ~seen_s_by_d
    resurrected = sp & ((sda != sdda) | (widen(sdc) > widen(sddc)))
    deleted_p = sd & ~resurrected
    present1 = dp | changed
    da1 = torch.where(changed, sda, dda)
    dc1 = torch.where(changed, sdc, ddc)
    joined_vv = vv_join(dvv, svv)

    if mode == "v2":
        # deletion-record absorb: a (counter, actor) lexicographic join
        sxc, dxc = widen(sddc), widen(dddc)
        rec_newer = (sxc > dxc) | ((sxc == dxc)
                                   & (widen(sdda) > widen(ddda)))
        rec_f = sd & (~dd | rec_newer)
        deleted_f = dd | sd
        del_da_f = torch.where(rec_f, sdda, ddda)
        del_dc_f = torch.where(rec_f, sddc, dddc)
        # remove iff the SENDER's clock covers the post-phase-1 dot
        remove = deleted_p & present1 & has_dot(svv, da1, dc1)
        present_d = present1 & ~remove
        rec_d = deleted_p & (~dd | rec_newer)
        deleted_d = dd | deleted_p
        del_da_d = torch.where(rec_d, sdda, ddda)
        del_dc_d = torch.where(rec_d, sddc, dddc)
        proc = torch.maximum(widen(dst.processed), widen(src.processed))
        svv_w = widen(svv)
        # the sender's own slot advances to its clock
        onehot = (torch.arange(dvv.shape[1], device=dvv.device)[None, :]
                  == widen(s_actor)[:, None])
        out_proc = narrow(torch.where(onehot & (proc < svv_w), svv_w, proc))
        out_p = torch.where(fc, present_f, present_d)
        return (joined_vv, out_proc, out_p,
                torch.where(fc, da_f, torch.where(present_d, da1, 0)),
                torch.where(fc, dc_f, torch.where(present_d, dc1, 0)),
                torch.where(fc, deleted_f, deleted_d),
                torch.where(fc, del_da_f, del_da_d),
                torch.where(fc, del_dc_f, del_dc_d))

    # reference arbitration: keep iff OUR clock covers the deletion dot;
    # deletion log, deletion dots and processed stay untouched
    remove = deleted_p & present1 & ~has_dot(dvv, sdda, sddc)
    present_d = present1 & ~remove
    out_p = torch.where(fc, present_f, present_d)
    out_da = torch.where(fc, da_f, torch.where(present_d, da1, 0))
    out_dc = torch.where(fc, dc_f, torch.where(present_d, dc1, 0))
    if mode == "reference_loose":
        vv = joined_vv
    else:
        # strict: an empty δ (and no first contact) skips the vv join
        nonempty = (changed | deleted_p).any(dim=1, keepdim=True)
        vv = torch.where(fc | nonempty, joined_vv, dvv)
    return (vv, dst.processed, out_p, out_da, out_dc, dd, ddda, dddc)


def _rebuild(state: AWSetDeltaState, outs) -> AWSetDeltaState:
    vv, proc, p, da, dc, d, dda, ddc = outs
    return AWSetDeltaState(
        vv=vv, present=p, dot_actor=da, dot_counter=dc, actor=state.actor,
        deleted=d, del_dot_actor=dda, del_dot_counter=ddc, processed=proc)


def delta_round_plain(state: AWSetDeltaState, index: torch.Tensor,
                      mode: str) -> AWSetDeltaState:
    """The plain version of both entries: replica r absorbs the δ of
    row index[r]."""
    src = AWSetDeltaState(*(x[index] for x in state))
    return _rebuild(state, _delta_algebra(state, src, src.actor, mode))


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
    return lib


def _launch(state, perm, offset: int, partner_mode: int, mode: str):
    check_state(state)
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
    """K5: one δ round in which replica r absorbs the δ of perm[r]."""
    mode = kernel_mode(delta_semantics, strict_reference_semantics)
    perm = as_index(perm, state.num_replicas, state.vv.device)
    if not use_kernel(kernel, state.vv):
        return delta_round_plain(state, perm, mode)
    out = _launch(state, perm, 0, PARTNER_GATHER, mode)
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
    """K9: K4 on the dot-word layout.  The plain version unpacks, runs
    the δ round against the ring partner and packs."""
    mode = kernel_mode(delta_semantics, strict_reference_semantics)
    num_r = state.vv.shape[0]
    check_ring_rows(num_r)
    if not use_kernel(kernel, state.vv):
        full = packed.unpack_awset_delta_dots(state,
                                              packed.num_elements(state))
        return packed.pack_awset_delta_dots(delta_round_plain(
            full, ring_index(num_r, offset, state.vv.device), mode))
    out = _launch(state, None, int(offset) % num_r, PARTNER_RING, mode)
    delta_ring_round_dotpacked.launches += 1
    return out


delta_ring_round.launches = 0
delta_gossip_round.launches = 0
delta_ring_round_packed.launches = 0
delta_ring_round_dotpacked.launches = 0
