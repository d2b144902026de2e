"""Reductions over the replica axis: VV join and convergence detection.

Convergence detection is a commutative membership hash per replica,
reduced with min/max.  All hashes are uint32 with wraparound, computed
on int64 with ``& 0xFFFFFFFF`` and returned as int32 bits, bit for bit
the JAX package's values.
"""

from __future__ import annotations

import torch

from go_crdt_playground_tpu_torch._u32 import MASK, mul32, narrow, widen

# Fibonacci hashing multiplier (2^32 / golden ratio, odd)
_MIX = 0x9E3779B1


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """xorshift-multiply mix of uint32 lanes (int64 in, int64 out)."""
    x = widen(x)
    x = mul32(x ^ (x >> 16), _MIX)
    x = mul32(x ^ (x >> 13), 0x85EBCA77)
    return x ^ (x >> 16)


def _lanes(n: int, device, lane_base: int = 0) -> torch.Tensor:
    return _mix32(torch.arange(lane_base + 1, lane_base + n + 1,
                               dtype=torch.int64, device=device))


def membership_hash(present: torch.Tensor,
                    lane_base: int = 0) -> torch.Tensor:
    """Per-replica membership digest: the sum (mod 2^32) of mixed element
    ids over present lanes.  present: bool[R, E] -> int32[R] (uint32
    bits).  ``lane_base``: the global id of lane 0, for a slice of the
    element axis (a sharded state's partial sums add up to the whole
    hash)."""
    lane = narrow(_lanes(present.shape[-1], present.device, lane_base))
    total = torch.where(present, lane, 0).sum(dim=-1, dtype=torch.int64)
    return narrow(total)


def _vv_hash(vv: torch.Tensor, lane_base: int = 0) -> torch.Tensor:
    lane = _lanes(vv.shape[-1], vv.device, lane_base)
    return mul32(_mix32(vv), lane).sum(dim=-1) & MASK


def state_digest(present: torch.Tensor, vv: torch.Tensor) -> torch.Tensor:
    """(membership, VV) digest per replica, int32[R] (uint32 bits).  Dots
    are not part of it: per-entry dots may legitimately diverge."""
    return narrow(widen(membership_hash(present)) ^ _vv_hash(vv))


def all_equal(digest: torch.Tensor) -> torch.Tensor:
    """True iff every replica's digest agrees (min == max)."""
    return digest.min() == digest.max()


def converged(present: torch.Tensor, vv: torch.Tensor) -> torch.Tensor:
    """Scalar bool tensor: has the batch converged on (membership, VV)?"""
    return all_equal(state_digest(present, vv))


def converged_packed(present_bits: torch.Tensor,
                     vv: torch.Tensor) -> torch.Tensor:
    """``converged`` on the bitpacked membership layout
    (models/packed.py): equal words <=> equal membership (the tail bits
    past E are zero), so the digest hashes word lanes directly, with no
    unpack.  present_bits: int32[R, W] (uint32 bits)."""
    lane = _lanes(present_bits.shape[-1], present_bits.device)
    mh = mul32(_mix32(present_bits), lane).sum(dim=-1) & MASK
    return all_equal(narrow(mh ^ _vv_hash(vv)))


def global_vv_join(vv: torch.Tensor) -> torch.Tensor:
    """Elementwise unsigned max over the replica axis: int32[R, A] ->
    int32[A]."""
    return narrow(widen(vv).max(dim=0).values)
