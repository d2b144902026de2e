"""The full-state merge round on a hand-written CUDA kernel (csrc/merge.cu).

Kernels and the Pallas kernels they replace
(go_crdt_playground_tpu/ops/pallas_merge.py):

  K1 ``ring_round_rows``          <- ``pallas_ring_round_rows``: replica r
                                     absorbs (r + offset) mod R, partner
                                     rows read in place;
  K2 ``gossip_round_rows``        <- ``pallas_gossip_round_rows``: r absorbs
                                     perm[r], partner rows read through perm;
     ``merge_pairwise_rows``      <- ``pallas_merge_pairwise_rows``: r
                                     absorbs row r of an independent batch;
  K3 ``gossip_round``             <- ``pallas_gossip_round``, and
     ``merge_pairwise``           <- ``pallas_merge_pairwise``: the entries
                                     of the one-row Pallas kernel (bool
                                     layout): K2's block-per-row kernel
                                     on a lean launch of its own
                                     (``crdt_merge_rows_k3``);
  K6 ``ring_round_rows_packed``   <- ``pallas_ring_round_rows_packed``: K1
                                     on the bitpacked layout;
  K7 ``ring_round_rows_dotpacked`` <- ``pallas_ring_round_rows_dotpacked``:
                                     K1 on the dot-word layout
                                     (models/packed.py).

``kernel="auto"`` launches the kernel for CUDA tensors and runs the plain
version (ops/merge.merge_kernel on whole [R, E] tensors; the packed
entries unpack, merge and pack) for CPU tensors; ``kernel="cuda"``
insists on the kernel and ``kernel="torch"`` asks for the plain version.
Outputs are new tensors (partner rows are read by other blocks of the
same launch), so peak memory is state plus outputs.  Each wrapper counts
its launches in ``<wrapper>.launches``.

K3's host side is lean, since its launch at the gossip verb's shapes
(64 x 128) takes a few microseconds on the card: one check pass over
both batches, two allocations, no device context when the state is on
the current device, the raw stream, and no range check of a device
``perm`` on the host or as extra device operations: the kernel checks
each entry and fails the launch with a device-side assert, which the
next synchronizing call raises.  A host ``perm`` is checked on the host
before it moves.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Optional

import numpy as np
import torch

from go_crdt_playground_tpu_torch.models import packed
from go_crdt_playground_tpu_torch.models.awset import AWSetState
from go_crdt_playground_tpu_torch.ops import _build
from go_crdt_playground_tpu_torch.ops.merge import merge_kernel

# Cap on the actor axis of the entries that check it (``check_state``):
# the dst and partner vv rows are staged per block (2 x A x 4 B = 16 KB at
# the cap).  K3 (and K5, ops/cuda_delta.py) take any A: past the card's
# shared memory their kernels read the vv rows from device memory.
MAX_FUSED_ACTORS = 2048
# The reference's packed ring kernels take whole 64-row blocks, at least
# two (pallas_merge.ring_supported); the packed entries keep that domain.
_RING_BLOCK_R = 64

KERNEL_CHOICES = ("auto", "cuda", "torch")
PARTNER_RING, PARTNER_GATHER, PARTNER_PAIRWISE = 0, 1, 2
LAYOUT_BOOL, LAYOUT_BITS, LAYOUT_DOTWORD = 0, 1, 2   # csrc/common.cuh
_BOOL_FIELDS = frozenset({"present", "deleted"})
_ACTOR_FIELDS = frozenset({"vv", "processed"})
_WORD_FIELDS = frozenset({"present_bits", "deleted_bits"})

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
# K3's entries may be called from several threads: their counts are
# read-modify-writes
_count_lock = threading.Lock()


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


def layout_of(state) -> int:
    """The lane layout of a state class (csrc/common.cuh ``Layout``)."""
    if "dots" in state._fields:
        return LAYOUT_DOTWORD
    if "present_bits" in state._fields:
        return LAYOUT_BITS
    return LAYOUT_BOOL


def check_state(state, max_actors: Optional[int] = MAX_FUSED_ACTORS
                ) -> None:
    """Device, dtype, shape and contiguity checks before passing
    pointers to a kernel; for the bool, bitpacked and dot-word states
    alike.  ``max_actors``: the entry's cap on A (None: any A)."""
    num_r, num_a = state.vv.shape
    num_e = packed.num_elements(state)
    num_w = packed.packed_width(num_e)
    if num_a < 1:
        raise ValueError("the actor axis must be non-empty")
    if max_actors is not None and num_a > max_actors:
        raise ValueError(
            f"actor axis A={num_a} exceeds the CUDA kernels' shared-memory "
            f"cap ({max_actors}); pass kernel='torch' to run the "
            "plain version")
    for name, t in zip(state._fields, state):
        want_dtype = torch.bool if name in _BOOL_FIELDS else torch.int32
        want_shape = ((num_r,) if name == "actor" else
                      (num_r, num_a) if name in _ACTOR_FIELDS else
                      (num_r, num_w) if name in _WORD_FIELDS else
                      (num_r, num_e))
        if t.dtype != want_dtype or tuple(t.shape) != want_shape:
            raise ValueError(f"{name}: expected {want_dtype}{want_shape}, "
                             f"got {t.dtype}{tuple(t.shape)}")
        if t.device != state.vv.device:
            raise ValueError(f"{name} lies on {t.device}, vv on "
                             f"{state.vv.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_ring_rows(num_r: int) -> None:
    """The packed ring entries raise where the reference's do: R must
    be a multiple of 64 and at least 128 (the CUDA kernel itself would
    take any R)."""
    if num_r % _RING_BLOCK_R or num_r < 2 * _RING_BLOCK_R:
        raise ValueError(
            f"packed ring rounds need R % {_RING_BLOCK_R} == 0 and R >= "
            f"{2 * _RING_BLOCK_R}, got R={num_r}; unpack and use the "
            "bool-layout paths instead")


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
    """The calling thread's current stream on the tensor's device, as the
    raw handle (torch's own C accessor: no Stream object is built)."""
    return torch._C._cuda_getCurrentRawStream(tensor.device.index)


def device_guard(device: torch.device):
    """``torch.cuda.device(device)``, or nothing to enter when ``device``
    is already the current one (the common case: entering and leaving
    the context costs microseconds on a launch that takes a few)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def out_like(state):
    """Uninitialised outputs of a round: every field but the replica's
    own actor column, which passes through."""
    return type(state)(*(x if name == "actor" else torch.empty_like(x)
                         for name, x in zip(state._fields, state)))


def ptr(t):
    return None if t is None else t.data_ptr()


def _merge_lanes(state):
    """(membership, dot actor or dot word, dot counter or None)."""
    layout = layout_of(state)
    if layout == LAYOUT_DOTWORD:
        return state.present_bits, state.dots, None
    if layout == LAYOUT_BITS:
        return state.present_bits, state.dot_actor, state.dot_counter
    return state.present, state.dot_actor, state.dot_counter


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("merge")
    lib.crdt_merge_round.argtypes = (
        [_P] * 9 + [_I64, _I32] + [_P] * 4 + [_I64, _I64, _I32, _I32, _P])
    lib.crdt_merge_round.restype = ctypes.c_int
    lib.crdt_merge_rows_k3.argtypes = (
        [_P] * 9 + [_I32] + [_P] * 4 + [_I64, _I64, _I32, _P])
    lib.crdt_merge_rows_k3.restype = ctypes.c_int
    return lib


def _launch(dst, src, perm, offset: int, partner_mode: int):
    check_state(dst)
    if src is not dst:
        check_state(src)
        if (type(src) is not type(dst)
                or any(s.shape != d.shape for s, d in zip(src, dst))
                or src.vv.device != dst.vv.device):
            raise ValueError("dst and src batches must match in layout, "
                             "shape and device")
    num_r, num_a = dst.vv.shape
    outs = out_like(dst)
    lib = _lib()
    with device_guard(dst.vv.device):
        rc = lib.crdt_merge_round(
            ptr(dst.vv), *map(ptr, _merge_lanes(dst)),
            ptr(src.vv), *map(ptr, _merge_lanes(src)),
            ptr(perm), offset, partner_mode,
            ptr(outs.vv), *map(ptr, _merge_lanes(outs)),
            num_r, packed.num_elements(dst), num_a, layout_of(dst),
            stream_of(dst.vv))
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


def _ring_plain(full: AWSetState, offset) -> AWSetState:
    return merge_rows_plain(
        full, _rows(full, ring_index(full.num_replicas, offset,
                                     full.vv.device)))


def ring_round_rows(state: AWSetState, offset,
                    kernel: str = "auto") -> AWSetState:
    """K1: one round against partner (r + offset) mod R; an offset >= R
    reduces mod R, offset 0 merges each row with itself."""
    num_r = state.num_replicas
    if not use_kernel(kernel, state.vv):
        return _ring_plain(state, offset)
    offset = int(offset) % num_r if num_r else 0
    out = _launch(state, state, None, offset, PARTNER_RING)
    ring_round_rows.launches += 1
    return out


_K3_FIELDS = (("vv", torch.int32), ("present", torch.bool),
              ("dot_actor", torch.int32), ("dot_counter", torch.int32),
              ("actor", torch.int32))


def _k3_check(dst: AWSetState, src: AWSetState):
    """One pass over both batches' fields (bool-layout ``AWSetState``s,
    one CUDA device, contiguous, [R, A] / [R, E] / [R]); returns (R, E,
    A, device)."""
    vv = dst.vv
    if vv.dim() != 2 or dst.present.dim() != 2:
        raise ValueError("K3 takes [R, A] vv and [R, E] lanes")
    num_r, num_a = vv.shape
    num_e = dst.present.shape[1]
    if num_a < 1:
        raise ValueError("the actor axis must be non-empty")
    dev = vv.device
    shapes = ((num_r, num_a), (num_r, num_e), (num_r, num_e),
              (num_r, num_e), (num_r,))
    for st in (dst,) if src is dst else (dst, src):
        if type(st) is not AWSetState:
            raise ValueError(f"K3 takes AWSetState batches, got "
                             f"{type(st).__name__}")
        for t, (name, dtype), shape in zip(st, _K3_FIELDS, shapes):
            if (t.dtype != dtype or t.shape != shape or t.device != dev
                    or not t.is_contiguous()):
                raise ValueError(
                    f"{name}: expected a contiguous {dtype}{shape} on "
                    f"{dev}, got {t.dtype}{tuple(t.shape)} on {t.device}")
    return num_r, num_e, num_a, dev


def _k3_perm(perm, num_r: int, device):
    """A device ``perm`` as it is (int32 or int64, shape (R,),
    contiguous; its entries are the kernel's to check), anything else
    through ``as_index`` (checked on the host, then moved)."""
    if (isinstance(perm, torch.Tensor) and perm.device == device
            and perm.dtype in (torch.int32, torch.int64)):
        if perm.shape != (num_r,):
            raise ValueError(f"perm must have shape ({num_r},), got "
                             f"{tuple(perm.shape)}")
        return perm.contiguous()
    return as_index(perm, num_r, device)


def _k3_launch(dst: AWSetState, src: AWSetState, perm,
               lib=None) -> AWSetState:
    """One K3 launch: ``dst[r] <- src[perm[r]]`` (or ``src[r]`` with
    ``perm`` None).  ``lib``: another build of csrc/merge.cu with the
    same interface, for same-card comparisons."""
    num_r, num_e, num_a, dev = _k3_check(dst, src)
    if perm is not None:
        perm = _k3_perm(perm, num_r, dev)
    words = torch.empty(num_r * (num_a + 2 * num_e), dtype=torch.int32,
                        device=dev)
    present = torch.empty((num_r, num_e), dtype=torch.bool, device=dev)
    vv, da, dc = words.split_with_sizes(
        (num_r * num_a, num_r * num_e, num_r * num_e))
    lib = lib or _lib()
    with device_guard(dev):
        rc = lib.crdt_merge_rows_k3(
            dst.vv.data_ptr(), dst.present.data_ptr(),
            dst.dot_actor.data_ptr(), dst.dot_counter.data_ptr(),
            src.vv.data_ptr(), src.present.data_ptr(),
            src.dot_actor.data_ptr(), src.dot_counter.data_ptr(),
            None if perm is None else perm.data_ptr(),
            perm is not None and perm.dtype == torch.int32,
            vv.data_ptr(), present.data_ptr(), da.data_ptr(), dc.data_ptr(),
            num_r, num_e, num_a, stream_of(words))
    if rc:
        _build.check(lib, rc, "crdt_merge_rows_k3")
    return AWSetState(vv=vv.view(num_r, num_a), present=present,
                      dot_actor=da.view(num_r, num_e),
                      dot_counter=dc.view(num_r, num_e), actor=dst.actor)


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


def gossip_round(state: AWSetState, perm,
                 kernel: str = "auto") -> AWSetState:
    """K3: one round in which replica r absorbs replica perm[r] (the
    one-row Pallas kernel's entry).  A device ``perm`` (int32 or int64)
    is read as it is and checked by the kernel."""
    if not use_kernel(kernel, state.vv):
        perm = as_index(perm, state.num_replicas, state.vv.device)
        return merge_rows_plain(state, _rows(state, perm))
    out = _k3_launch(state, state, perm)
    with _count_lock:
        gossip_round.launches += 1
    return out


def merge_pairwise(dst: AWSetState, src: AWSetState,
                   kernel: str = "auto") -> AWSetState:
    """K3, pairwise: ``dst[r] <- src[r]`` between two batches (the
    bridge's one-row merges, ops/merge.merge_one_into); any actor axis
    A."""
    if not use_kernel(kernel, dst.vv):
        return merge_rows_plain(dst, src)
    out = _k3_launch(dst, src, None)
    with _count_lock:
        merge_pairwise.launches += 1
    return out


def ring_round_rows_packed(state: packed.PackedAWSetState, offset,
                           kernel: str = "auto") -> packed.PackedAWSetState:
    """K6: K1 on the bitpacked layout.  The plain version unpacks,
    merges with the ring partner and packs."""
    num_r = state.vv.shape[0]
    check_ring_rows(num_r)
    if not use_kernel(kernel, state.vv):
        full = packed.unpack_awset(state, packed.num_elements(state))
        return packed.pack_awset(_ring_plain(full, offset))
    out = _launch(state, state, None, int(offset) % num_r, PARTNER_RING)
    ring_round_rows_packed.launches += 1
    return out


def ring_round_rows_dotpacked(state: packed.DotPackedAWSetState, offset,
                              kernel: str = "auto"
                              ) -> packed.DotPackedAWSetState:
    """K7: K1 on the dot-word layout.  The plain version unpacks,
    merges with the ring partner and packs."""
    num_r = state.vv.shape[0]
    check_ring_rows(num_r)
    if not use_kernel(kernel, state.vv):
        full = packed.unpack_awset_dots(state, packed.num_elements(state))
        return packed.pack_awset_dots(_ring_plain(full, offset))
    out = _launch(state, state, None, int(offset) % num_r, PARTNER_RING)
    ring_round_rows_dotpacked.launches += 1
    return out


ring_round_rows.launches = 0
gossip_round_rows.launches = 0
merge_pairwise_rows.launches = 0
gossip_round.launches = 0
merge_pairwise.launches = 0
ring_round_rows_packed.launches = 0
ring_round_rows_dotpacked.launches = 0
