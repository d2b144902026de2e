"""Per-lane digests of one replica slice: O(diff) anti-entropy fingerprints.

The counterpart of the JAX package's ``ops/digest.py``, bit for bit.
Every element lane of a single-replica ``AWSetDeltaState`` slice is
fingerprinted over its CONVERGENT projection (present bit, deletion-log
membership, deletion dot) with the lane id folded in, and the lane
fingerprints XOR-fold into ``ceil(E / group_size)`` group digests.  Two
replicas exchange the digests (net/digestsync.py); a mismatched group
names exactly the lanes to ship, a matched group ships nothing.

Live dots are excluded: the reference merge's both-present rule leaves
two converged replicas holding different live dots for the same present
lane, and folding them in would make such lanes mismatch forever.  A
lane pair differing only in its live dot agrees on membership, so
withholding it ships nothing the receiver observably lacks.

Fingerprint (all arithmetic uint32): ``h = fmix32(e ^ 0x9E3779B9)``, then
``h = fmix32(h ^ v)`` for v = present, deleted, del_dot_actor,
del_dot_counter, with murmur3's fmix32.  Lanes past E in the ragged last
group hash as ZERO lanes at their true ids E, E+1, ... so every replica
of one universe pads identically.

This module holds the plain versions (torch on int64 holding uint32
values, ``_u32``'s convention); the K11 kernel (ops/cuda_digest.py)
computes the same on the card.  ``digest_regime`` picks by device.
"""

from __future__ import annotations

import numpy as np
import torch

from go_crdt_playground_tpu_torch._u32 import (from_numpy_u32, mul32,
                                               narrow, widen)
from go_crdt_playground_tpu_torch.device import resolve_device
from go_crdt_playground_tpu_torch.models.awset_delta import AWSetDeltaState
from go_crdt_playground_tpu_torch.ops.delta import DeltaPayload, delta_extract

# protocol parameter (net/digestsync.py carries and checks it on the
# wire): lanes per uint32 group digest
DIGEST_GROUP_LANES = 64

# fingerprint seed and murmur3 fmix32 multipliers
_SEED = 0x9E3779B9
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64 lanes holding uint32 values."""
    h = h ^ (h >> 16)
    h = mul32(h, _M1)
    h = h ^ (h >> 13)
    h = mul32(h, _M2)
    return h ^ (h >> 16)


def _fold(h: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Fold one uint32 component (int64 value) into the lane hash."""
    return _mix32(h ^ v)


def lane_fingerprint_arrays(lane_ids, present, deleted, del_dot_actor,
                            del_dot_counter) -> torch.Tensor:
    """The fingerprint algebra on raw component tensors: ``lane_ids``
    int64, ``present``/``deleted`` bool (or any integer, nonzero is
    set), the deletion dot as int32 bits.  Returns int64 values in
    [0, 2^32)."""
    h = _mix32(lane_ids ^ _SEED)
    h = _fold(h, (present != 0).to(torch.int64))
    h = _fold(h, (deleted != 0).to(torch.int64))
    h = _fold(h, widen(del_dot_actor))
    return _fold(h, widen(del_dot_counter))


def lane_fingerprints(state: AWSetDeltaState,
                      lane_base: int = 0) -> torch.Tensor:
    """int32-bits [E] per-lane fingerprints of one replica slice (fields
    [E]/[A]); vv and processed are not folded in.  ``lane_base``: the
    global id of lane 0 (a lane-sharded node's slot hashes global ids)."""
    e = state.present.shape[-1]
    ids = torch.arange(lane_base, lane_base + e, dtype=torch.int64,
                       device=state.present.device)
    return narrow(lane_fingerprint_arrays(
        ids, state.present, state.deleted, state.del_dot_actor,
        state.del_dot_counter))


def pad_fingerprints(num_elements: int, group_size: int,
                     device, lane_base: int = 0) -> torch.Tensor:
    """int32-bits fingerprints of the zero lanes that pad E up to whole
    groups, at their true ids lane_base + E, lane_base + E + 1, ..."""
    pad = (-num_elements) % group_size
    first = lane_base + num_elements
    ids = torch.arange(first, first + pad, dtype=torch.int64,
                       device=device)
    z = torch.zeros(pad, dtype=torch.int32, device=device)
    return narrow(lane_fingerprint_arrays(ids, z, z, z, z))


def group_fold(fp: torch.Tensor, group_size: int,
               lane_base: int = 0) -> torch.Tensor:
    """XOR-fold int32-bits [E] lane fingerprints into [ceil(E/gs)] group
    digests, the ragged last group padded with zero-lane fingerprints
    (at global ids past ``lane_base + E``)."""
    if group_size < 1:
        raise ValueError(f"group size must be >= 1, got {group_size}")
    e = fp.shape[-1]
    fp = torch.cat([fp, pad_fingerprints(e, group_size, fp.device,
                                         lane_base)])
    g = fp.view(-1, group_size)
    while g.shape[1] > 1:
        half = g.shape[1] // 2
        folded = g[:, :half] ^ g[:, half:2 * half]
        if g.shape[1] % 2:
            folded[:, 0] ^= g[:, -1]
        g = folded
    return g[:, 0].contiguous()


def state_group_digests(state: AWSetDeltaState,
                        group_size: int = DIGEST_GROUP_LANES,
                        lane_base: int = 0) -> torch.Tensor:
    """Per-lane fingerprints and the group XOR fold: K11's plain version.
    ``digest_regime`` is the device dispatch callers should use."""
    return group_fold(lane_fingerprints(state, lane_base), group_size,
                      lane_base)


def digest_regime(num_elements: int, device="cuda"):
    """The digest pass for a node on ``device``: a ``digests_fn(state_slice,
    group_size) -> int32-bits [G]``, the K11 kernel (ops/cuda_digest.py)
    on CUDA, the plain pass above on the CPU.  Both are bitwise equal,
    so either side of an exchange may run either."""
    del num_elements  # shape-independent today; keeps the seam stable
    if resolve_device(device).type == "cuda":
        from go_crdt_playground_tpu_torch.ops.cuda_digest import \
            state_group_digests as k11

        return k11
    return state_group_digests


def num_groups(num_elements: int,
               group_size: int = DIGEST_GROUP_LANES) -> int:
    return -(-num_elements // group_size)


def _digests_on(x, device) -> torch.Tensor:
    """Group digests (an int32-bits tensor or a numpy uint32 array) as a
    tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return from_numpy_u32(x, device)


def digest_diff_payload(state: AWSetDeltaState, own_digests, peer_digests,
                        group_size: int = DIGEST_GROUP_LANES) -> DeltaPayload:
    """Our complete state for the lanes of the groups whose digests
    differ, computed on the state's device: every present lane with its
    dot and every un-resurrected deletion record in a mismatched group,
    nothing from matched groups.  ``src_vv`` is our FULL vv: withheld
    lanes sit in digest-matched groups, observably identical on the
    receiver (to the 2^-32-per-group collision bound)."""
    dev = state.vv.device
    e = state.present.shape[-1]
    mism = _digests_on(own_digests, dev) != _digests_on(peer_digests, dev)
    lane_mask = mism.repeat_interleave(group_size)[:e]
    p = delta_extract(state, torch.zeros_like(state.vv))
    return p._replace(
        changed=p.changed & lane_mask,
        ch_da=torch.where(lane_mask, p.ch_da, 0),
        ch_dc=torch.where(lane_mask, p.ch_dc, 0),
        deleted=p.deleted & lane_mask,
        del_da=torch.where(lane_mask, p.del_da, 0),
        del_dc=torch.where(lane_mask, p.del_dc, 0))


def mismatched_group_count(own_digests, peer_digests) -> int:
    """Host-side census of mismatched groups (numpy uint32 arrays)."""
    return int(np.sum(np.asarray(own_digests, np.uint32)
                      != np.asarray(peer_digests, np.uint32)))
