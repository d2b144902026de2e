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
``<wrapper>.launches`` (under a lock, so the counts stay exact under
concurrent launches).  The host side is kept lean, since a launch at
the serving shapes takes a few microseconds on the card: one check pass
over the four lanes, one allocation, and no device context when the
lanes are on the current device.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from go_crdt_playground_tpu_torch.models.awset_delta import AWSetDeltaState
from go_crdt_playground_tpu_torch.ops import _build
from go_crdt_playground_tpu_torch.ops import digest as digest_ops
from go_crdt_playground_tpu_torch.ops.cuda_merge import (device_guard,
                                                         stream_of,
                                                         use_kernel)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
# server threads and clients launch concurrently: the counts are
# read-modify-writes
_count_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("digest")
    lib.crdt_group_digests.argtypes = [_P] * 5 + [_I64, _I64, _I64, _P]
    lib.crdt_group_digests.restype = ctypes.c_int
    return lib


def _launch(state: AWSetDeltaState, group_size: int,
            lib=None, lane_base: int = 0) -> torch.Tensor:
    """One pass over the four read lanes (one CUDA device, [E], their
    storage dtype, contiguous), one allocation, one launch; the device
    context is entered only when the lanes are not on the current
    device.  ``lib``: another build of csrc/digest.cu with the same
    interface, for same-card comparisons."""
    p, d = state.present, state.deleted
    xa, xc = state.del_dot_actor, state.del_dot_counter
    dev = p.device
    num_e = p.shape[0] if p.dim() == 1 else -1
    for name, t, dtype in (("present", p, torch.bool),
                           ("deleted", d, torch.bool),
                           ("del_dot_actor", xa, torch.int32),
                           ("del_dot_counter", xc, torch.int32)):
        if (t.dtype != dtype or t.dim() != 1 or t.shape[0] != num_e
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(
                f"{name}: expected a contiguous {dtype}({num_e},) on "
                f"{dev}, got {t.dtype}{tuple(t.shape)} on {t.device}"
                f"{'' if t.is_contiguous() else ', not contiguous'}")
    out = torch.empty(digest_ops.num_groups(num_e, group_size),
                      dtype=torch.int32, device=dev)
    lib = lib or _lib()
    with device_guard(dev):
        rc = lib.crdt_group_digests(p.data_ptr(), d.data_ptr(),
                                    xa.data_ptr(), xc.data_ptr(),
                                    out.data_ptr(), num_e, group_size,
                                    lane_base, stream_of(out))
    if rc:
        _build.check(lib, rc, "crdt_group_digests")
    return out


def lane_fingerprints(state: AWSetDeltaState, kernel: str = "auto",
                      lane_base: int = 0) -> torch.Tensor:
    """K11: int32-bits [E] lane fingerprints of one replica slice (the
    kernel at group size 1); lane e hashes as global id lane_base + e."""
    if not use_kernel(kernel, state.present):
        return digest_ops.lane_fingerprints(state, lane_base)
    out = _launch(state, 1, lane_base=lane_base)
    with _count_lock:
        lane_fingerprints.launches += 1
    return out


def state_group_digests(state: AWSetDeltaState,
                        group_size: int = digest_ops.DIGEST_GROUP_LANES,
                        kernel: str = "auto",
                        lane_base: int = 0) -> torch.Tensor:
    """K11: int32-bits [ceil(E / group_size)] group digests of one replica
    slice, fingerprints and fold in one launch; any group_size >= 1.
    ``lane_base``: the global id of lane 0 (a lane-sharded node's
    slot)."""
    group_size = int(group_size)
    if group_size < 1:
        raise ValueError(f"group size must be >= 1, got {group_size}")
    if not use_kernel(kernel, state.present):
        return digest_ops.state_group_digests(state, group_size, lane_base)
    out = _launch(state, group_size, lane_base=lane_base)
    with _count_lock:
        state_group_digests.launches += 1
    return out


lane_fingerprints.launches = 0
state_group_digests.launches = 0
