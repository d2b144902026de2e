"""The full-state merge round on a hand-written CUDA kernel (csrc/merge.cu).

Kernels and the Pallas kernels they replace
(go_crdt_playground_tpu/ops/pallas_merge.py):

  K1 ``ring_round_rows``      <- ``pallas_ring_round_rows``: replica r
                                 absorbs (r + offset) mod R, partner rows
                                 read in place;
  K2 ``gossip_round_rows``    <- ``pallas_gossip_round_rows``: r absorbs
                                 perm[r], partner rows read through perm;
     ``merge_pairwise_rows``  <- ``pallas_merge_pairwise_rows``: r absorbs
                                 row r of an independent batch.

``kernel="auto"`` launches the kernel for CUDA tensors and runs the plain
version (ops/merge.merge_kernel on whole [R, E] tensors) for CPU
tensors; ``kernel="cuda"`` insists on the kernel and ``kernel="torch"``
asks for the plain version.  Outputs are new tensors (partner rows are
read by other blocks of the same launch), so peak memory is state plus
outputs.  Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from go_crdt_playground_tpu_torch.models.awset import AWSetState
from go_crdt_playground_tpu_torch.ops import _build
from go_crdt_playground_tpu_torch.ops.merge import merge_kernel

# Shared-memory cap on the actor axis: the dst and partner vv rows are
# staged per block (2 x A x 4 B = 16 KB at the cap).
MAX_FUSED_ACTORS = 2048

KERNEL_CHOICES = ("auto", "cuda", "torch")
PARTNER_RING, PARTNER_GATHER, PARTNER_PAIRWISE = 0, 1, 2
_BOOL_FIELDS = frozenset({"present", "deleted"})
_ACTOR_FIELDS = frozenset({"vv", "processed"})

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int


def use_kernel(kernel: str, tensor: torch.Tensor) -> bool:
    """True: launch the CUDA kernel; False: run the plain version.  The
    plain version is taken only when asked for, or when ``auto`` finds a
    CPU tensor; a CUDA tensor never falls back to it silently."""
    if kernel not in KERNEL_CHOICES:
        raise ValueError(f"kernel must be one of {KERNEL_CHOICES}, "
                         f"got {kernel!r}")
    if kernel == "torch":
        return False
    if tensor.device.type == "cuda":
        return True
    if kernel == "cuda":
        raise ValueError(f"kernel='cuda' needs CUDA tensors, got "
                         f"{tensor.device}")
    return False


def check_state(state) -> None:
    """Device, dtype, shape and contiguity checks before passing
    pointers to a kernel."""
    num_r, num_a = state.vv.shape
    num_e = state.present.shape[-1]
    if num_a < 1:
        raise ValueError("the actor axis must be non-empty")
    if num_a > MAX_FUSED_ACTORS:
        raise ValueError(
            f"actor axis A={num_a} exceeds the CUDA kernels' shared-memory "
            f"cap ({MAX_FUSED_ACTORS}); pass kernel='torch' to run the "
            "plain version")
    for name, t in zip(state._fields, state):
        want_dtype = torch.bool if name in _BOOL_FIELDS else torch.int32
        want_shape = ((num_r,) if name == "actor" else
                      (num_r, num_a) if name in _ACTOR_FIELDS else
                      (num_r, num_e))
        if t.dtype != want_dtype or tuple(t.shape) != want_shape:
            raise ValueError(f"{name}: expected {want_dtype}{want_shape}, "
                             f"got {t.dtype}{tuple(t.shape)}")
        if t.device != state.vv.device:
            raise ValueError(f"{name} lies on {t.device}, vv on "
                             f"{state.vv.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def as_index(perm, num_r: int, device) -> torch.Tensor:
    """A partner permutation as a checked int64[R] tensor on ``device``
    (out-of-range rows would read outside the state).

    Host input (numpy, lists, CPU tensors) is range-checked on the host
    before it moves.  A permutation already on the GPU is checked by an
    asynchronous device assert, so a round costs no device->host sync;
    an out-of-range entry fails the next synchronising call."""
    if not isinstance(perm, torch.Tensor):
        perm = torch.from_numpy(np.asarray(perm, dtype=np.int64))
    if tuple(perm.shape) != (num_r,):
        raise ValueError(f"perm must have shape ({num_r},), got "
                         f"{tuple(perm.shape)}")
    perm = perm.to(dtype=torch.int64)
    if perm.device.type == "cpu":
        if num_r and (int(perm.min()) < 0 or int(perm.max()) >= num_r):
            raise ValueError(f"perm entries must lie in [0, {num_r})")
    elif num_r:
        torch._assert_async(((perm >= 0) & (perm < num_r)).all(),
                            f"perm entries must lie in [0, {num_r})")
    return perm.to(device=device).contiguous()


def ring_index(num_r: int, offset, device) -> torch.Tensor:
    """Partner rows of a ring round: (r + offset) mod R."""
    off = int(offset) % num_r
    return (torch.arange(num_r, dtype=torch.int64, device=device)
            + off) % num_r


def stream_of(tensor: torch.Tensor) -> int:
    return torch.cuda.current_stream(tensor.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("merge")
    lib.crdt_merge_round.argtypes = (
        [_P] * 9 + [_I64, _I32] + [_P] * 4 + [_I64, _I64, _I32, _P])
    lib.crdt_merge_round.restype = ctypes.c_int
    return lib


def _launch(dst: AWSetState, src: AWSetState, perm, offset: int,
            partner_mode: int) -> AWSetState:
    check_state(dst)
    if src is not dst:
        check_state(src)
        if (src.vv.shape != dst.vv.shape
                or src.present.shape != dst.present.shape
                or src.vv.device != dst.vv.device):
            raise ValueError("dst and src batches must match in shape "
                             "and device")
    num_r, num_a = dst.vv.shape
    num_e = dst.present.shape[-1]
    outs = AWSetState(
        vv=torch.empty_like(dst.vv), present=torch.empty_like(dst.present),
        dot_actor=torch.empty_like(dst.dot_actor),
        dot_counter=torch.empty_like(dst.dot_counter), actor=dst.actor)
    lib = _lib()
    with torch.cuda.device(dst.vv.device):
        rc = lib.crdt_merge_round(
            dst.vv.data_ptr(), dst.present.data_ptr(),
            dst.dot_actor.data_ptr(), dst.dot_counter.data_ptr(),
            src.vv.data_ptr(), src.present.data_ptr(),
            src.dot_actor.data_ptr(), src.dot_counter.data_ptr(),
            None if perm is None else perm.data_ptr(), offset, partner_mode,
            outs.vv.data_ptr(), outs.present.data_ptr(),
            outs.dot_actor.data_ptr(), outs.dot_counter.data_ptr(),
            num_r, num_e, num_a, stream_of(dst.vv))
    _build.check(lib, rc, "crdt_merge_round")
    return outs


def merge_rows_plain(dst: AWSetState, src: AWSetState) -> AWSetState:
    """The plain version of every entry below: ``dst[r] <- src[r]`` on
    whole [R, E] tensors (ops/merge.merge_kernel, int64 widening)."""
    vv, present, da, dc, _ = merge_kernel(
        dst.vv, dst.present, dst.dot_actor, dst.dot_counter,
        src.vv, src.present, src.dot_actor, src.dot_counter)
    return AWSetState(vv=vv, present=present, dot_actor=da, dot_counter=dc,
                      actor=dst.actor)


def _rows(state, index):
    return type(state)(*(x[index] for x in state))


def ring_round_rows(state: AWSetState, offset,
                    kernel: str = "auto") -> AWSetState:
    """K1: one round against partner (r + offset) mod R; an offset >= R
    reduces mod R, offset 0 merges each row with itself."""
    num_r = state.num_replicas
    if not use_kernel(kernel, state.vv):
        return merge_rows_plain(
            state, _rows(state, ring_index(num_r, offset, state.vv.device)))
    offset = int(offset) % num_r if num_r else 0
    out = _launch(state, state, None, offset, PARTNER_RING)
    ring_round_rows.launches += 1
    return out


def gossip_round_rows(state: AWSetState, perm,
                      kernel: str = "auto") -> AWSetState:
    """K2: one round in which replica r absorbs replica perm[r]."""
    perm = as_index(perm, state.num_replicas, state.vv.device)
    if not use_kernel(kernel, state.vv):
        return merge_rows_plain(state, _rows(state, perm))
    out = _launch(state, state, perm, 0, PARTNER_GATHER)
    gossip_round_rows.launches += 1
    return out


def merge_pairwise_rows(dst: AWSetState, src: AWSetState,
                        kernel: str = "auto") -> AWSetState:
    """K2, pairwise: ``dst[r] <- src[r]`` between two batches."""
    if not use_kernel(kernel, dst.vv):
        return merge_rows_plain(dst, src)
    out = _launch(dst, src, None, 0, PARTNER_PAIRWISE)
    merge_pairwise_rows.launches += 1
    return out


ring_round_rows.launches = 0
gossip_round_rows.launches = 0
merge_pairwise_rows.launches = 0
