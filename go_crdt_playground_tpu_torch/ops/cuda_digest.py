"""Per-lane digests and their group fold on a hand-written CUDA kernel
(csrc/digest.cu).

Kernel and the Pallas kernel it replaces:

  K11 ``lane_fingerprints``   <- ``pallas_lane_fingerprints``
      ``state_group_digests`` <- ``pallas_state_group_digests``
      (go_crdt_playground_tpu/ops/pallas_digest.py ``_fused_fingerprints``
      + ``_digest_kernel``): fingerprint every lane of one replica slice
      over its convergent projection and, for the second entry, XOR-fold
      the lanes into ``ceil(E / group_size)`` group digests in the same
      launch (the TPU ran that fold in XLA around its kernel).

Both take a single-replica ``AWSetDeltaState`` slice and return int32
bits (uint32 values, ``_u32.py``).  ``kernel="auto"`` launches the kernel
for CUDA tensors and runs the plain version (ops/digest.py) for CPU
tensors; ``kernel="cuda"`` insists on the kernel and ``kernel="torch"``
asks for the plain version.  Outputs are new tensors; no state tensor is
written.  The launch goes on the calling thread's current stream, so
server threads, a supervisor thread and client calls may digest the same
node concurrently.  Each wrapper counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from go_crdt_playground_tpu_torch.models.awset_delta import AWSetDeltaState
from go_crdt_playground_tpu_torch.ops import _build
from go_crdt_playground_tpu_torch.ops import digest as digest_ops
from go_crdt_playground_tpu_torch.ops.cuda_merge import (ptr, stream_of,
                                                         use_kernel)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
# server threads and clients launch concurrently: the counts are
# read-modify-writes
_count_lock = threading.Lock()
# the lanes the fingerprint reads, and their storage
_LANES = (("present", torch.bool), ("deleted", torch.bool),
          ("del_dot_actor", torch.int32), ("del_dot_counter", torch.int32))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("digest")
    lib.crdt_lane_fingerprints.argtypes = [_P] * 5 + [_I64, _P]
    lib.crdt_lane_fingerprints.restype = ctypes.c_int
    lib.crdt_group_digests.argtypes = [_P] * 5 + [_I64, _I64, _P]
    lib.crdt_group_digests.restype = ctypes.c_int
    return lib


def _lanes(state: AWSetDeltaState):
    """The four read lanes, checked: one device, [E], their storage
    dtype, contiguous."""
    lanes = [getattr(state, name) for name, _ in _LANES]
    (num_e,) = lanes[0].shape
    for (name, dtype), t in zip(_LANES, lanes):
        if t.dtype != dtype or tuple(t.shape) != (num_e,):
            raise ValueError(f"{name}: expected {dtype}({num_e},), got "
                             f"{t.dtype}{tuple(t.shape)}")
        if t.device != lanes[0].device:
            raise ValueError(f"{name} lies on {t.device}, present on "
                             f"{lanes[0].device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return lanes, num_e


def _launch(fn_name: str, state: AWSetDeltaState, out_len, *extra):
    lanes, num_e = _lanes(state)
    out = torch.empty(out_len(num_e), dtype=torch.int32,
                      device=lanes[0].device)
    lib = _lib()
    with torch.cuda.device(out.device):
        rc = getattr(lib, fn_name)(*map(ptr, lanes), ptr(out), num_e,
                                   *extra, stream_of(out))
    _build.check(lib, rc, fn_name)
    return out


def lane_fingerprints(state: AWSetDeltaState,
                      kernel: str = "auto") -> torch.Tensor:
    """K11: int32-bits [E] lane fingerprints of one replica slice."""
    if not use_kernel(kernel, state.present):
        return digest_ops.lane_fingerprints(state)
    out = _launch("crdt_lane_fingerprints", state, lambda e: e)
    with _count_lock:
        lane_fingerprints.launches += 1
    return out


def state_group_digests(state: AWSetDeltaState,
                        group_size: int = digest_ops.DIGEST_GROUP_LANES,
                        kernel: str = "auto") -> torch.Tensor:
    """K11: int32-bits [ceil(E / group_size)] group digests of one replica
    slice, fingerprints and fold in one launch; any group_size >= 1."""
    group_size = int(group_size)
    if group_size < 1:
        raise ValueError(f"group size must be >= 1, got {group_size}")
    if not use_kernel(kernel, state.present):
        return digest_ops.state_group_digests(state, group_size)
    out = _launch("crdt_group_digests", state,
                  lambda e: digest_ops.num_groups(e, group_size), group_size)
    with _count_lock:
        state_group_digests.launches += 1
    return out


lane_fingerprints.launches = 0
state_group_digests.launches = 0
