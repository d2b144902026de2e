"""Fixed-K compact δ payloads: a payload's claimed lanes as K index/value
slots instead of O(E) masks.

The counterpart of the JAX package's ``ops/compact.py``, on one replica
slice.  ``compact_payload`` packs the lanes of each section into the
first slots (stable, ascending element id); lanes past K are left out
and ``overflow`` is set.  On overflow the compact form carries a zero
``src_vv`` and ``src_processed``: a truncated payload must not advance a
receiver's clock past adds it withheld (the JAX module docstring gives
the argument), so the exchange degrades to partial data with no clock
advance, which converges by retry.

The JAX scatter with ``mode="drop"`` becomes a scatter into K + 1 slots,
the unclaimed lanes all aimed at slot K, which is then cut off.  Every
function takes one payload or a batch of them (a leading replica axis
on every field): ``compact_payload_batch`` and ``expand_payload_batch``
are the JAX package's vmapped forms, the batch dimension written out.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from go_crdt_playground_tpu_torch._u32 import widen
from go_crdt_playground_tpu_torch.ops.delta import DeltaPayload


class CompactDeltaPayload(NamedTuple):
    """One payload in fixed-K index form.  ``*_idx`` are element ids of
    the claimed lanes, valid where ``*_valid``."""

    src_vv: torch.Tensor         # int32[A]  zero on overflow
    ch_idx: torch.Tensor         # int32[Kc]
    ch_valid: torch.Tensor       # bool[Kc]
    ch_da: torch.Tensor          # int32[Kc]
    ch_dc: torch.Tensor          # int32[Kc]
    del_idx: torch.Tensor        # int32[Kd]
    del_valid: torch.Tensor      # bool[Kd]
    del_da: torch.Tensor         # int32[Kd]
    del_dc: torch.Tensor         # int32[Kd]
    overflow: torch.Tensor       # bool[]  either section truncated
    src_actor: torch.Tensor      # int32[]
    src_processed: torch.Tensor  # int32[A]  zero on overflow


def _compact_section(mask: torch.Tensor, k: int, *values):
    """Pack the lanes where ``mask`` into the first of k slots along the
    last axis.  Returns (idx, valid, packed values, overflowed)."""
    num_e = mask.shape[-1]
    pos = torch.cumsum(mask.to(torch.int64), dim=-1) - 1  # destination
    claim = mask & (pos < k)
    dest = torch.where(claim, pos, k)

    def scatter(src):
        buf = torch.zeros(mask.shape[:-1] + (k + 1,), dtype=src.dtype,
                          device=src.device)
        return buf.scatter_(-1, dest, torch.where(
            claim, src, torch.zeros_like(src)))[..., :k]

    eids = torch.arange(num_e, dtype=torch.int32,
                        device=mask.device).expand(mask.shape)
    return (scatter(eids), scatter(claim),
            tuple(scatter(v) for v in values),
            mask.sum(dim=-1) > k)


def compact_payload(p: DeltaPayload, k_changed: int,
                    k_deleted: int) -> CompactDeltaPayload:
    """Dense payload (one replica slice, or a batch) -> fixed-K form."""
    ch_idx, ch_valid, (ch_da, ch_dc), ch_over = _compact_section(
        p.changed, k_changed, p.ch_da, p.ch_dc)
    del_idx, del_valid, (del_da, del_dc), del_over = _compact_section(
        p.deleted, k_deleted, p.del_da, p.del_dc)
    overflow = ch_over | del_over
    zero_clock = overflow.unsqueeze(-1)
    return CompactDeltaPayload(
        src_vv=torch.where(zero_clock, 0, p.src_vv),
        ch_idx=ch_idx, ch_valid=ch_valid, ch_da=ch_da, ch_dc=ch_dc,
        del_idx=del_idx, del_valid=del_valid, del_da=del_da,
        del_dc=del_dc, overflow=overflow, src_actor=p.src_actor,
        src_processed=torch.where(zero_clock, 0, p.src_processed))


def expand_payload(c: CompactDeltaPayload,
                   num_elements: int) -> DeltaPayload:
    """Fixed-K form -> dense payload (the inverse of ``compact_payload``
    on payloads that fit; the claimed subset otherwise).  Slots that are
    not valid, or name an id outside [0, E), are dropped."""

    def scatter(idx, valid, vals):
        idx = widen(idx)
        dest = torch.where(valid & (idx < num_elements), idx, num_elements)
        buf = torch.zeros(idx.shape[:-1] + (num_elements + 1,),
                          dtype=vals.dtype, device=vals.device)
        return buf.scatter_(-1, dest, vals)[..., :num_elements]

    return DeltaPayload(
        src_vv=c.src_vv,
        changed=scatter(c.ch_idx, c.ch_valid, c.ch_valid),
        ch_da=scatter(c.ch_idx, c.ch_valid, c.ch_da),
        ch_dc=scatter(c.ch_idx, c.ch_valid, c.ch_dc),
        deleted=scatter(c.del_idx, c.del_valid, c.del_valid),
        del_da=scatter(c.del_idx, c.del_valid, c.del_da),
        del_dc=scatter(c.del_idx, c.del_valid, c.del_dc),
        src_actor=c.src_actor,
        src_processed=c.src_processed)


# the JAX package's vmapped forms: the functions above take the batch
compact_payload_batch = compact_payload
expand_payload_batch = expand_payload
