"""Packed state layouts: membership bitpacked, optionally dots as words.

The counterparts of the JAX package's ``models/packed.py``:

  PackedAWSetState           present as present_bits int32[R, W],
                             W = ceil(E/32): bit e % 32 of word e // 32,
                             the tail bits past E zero;
  PackedAWSetDeltaState      the same for present and deleted;
  DotPackedAWSetState        bitpacked membership, and each element's
                             (actor, counter) dot as ONE word
                             (actor << 20) | counter;
  DotPackedAWSetDeltaState   the same for both dot pairs of a δ state.

Every field is uint32 in the JAX package and int32 holding the same
bits here (``_u32.py``); a word with bit 31 set is negative, so words
are built in int64 and narrowed, and read through ``widen`` (torch's
``>>`` on int32 is arithmetic).  The element count is not recoverable
from W, so the unpacks take ``num_elements``.

The dot-word layout holds 12 actor bits and 20 counter bits: packing
refuses A > DOT_MAX_ACTORS or a counter above DOT_MAX_COUNTER, which
would alias a neighbouring actor's dot.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from go_crdt_playground_tpu_torch._u32 import (
    MASK, from_numpy_u32, narrow, widen)
from go_crdt_playground_tpu_torch.device import resolve_device
from go_crdt_playground_tpu_torch.models import awset as awset_mod
from go_crdt_playground_tpu_torch.models.awset import AWSetState
from go_crdt_playground_tpu_torch.models.awset_delta import AWSetDeltaState

_WORD = 32
# the JAX package's ops/pallas_merge.py constants, copied
_DOT_SHIFT = 20
_DOT_CMASK = (1 << _DOT_SHIFT) - 1
DOT_MAX_ACTORS = 1 << (32 - _DOT_SHIFT)
DOT_MAX_COUNTER = _DOT_CMASK


class PackedAWSetState(NamedTuple):
    vv: torch.Tensor            # int32[R, A]
    present_bits: torch.Tensor  # int32[R, W]
    dot_actor: torch.Tensor     # int32[R, E]
    dot_counter: torch.Tensor   # int32[R, E]
    actor: torch.Tensor         # int32[R]


class PackedAWSetDeltaState(NamedTuple):
    vv: torch.Tensor
    present_bits: torch.Tensor
    dot_actor: torch.Tensor
    dot_counter: torch.Tensor
    actor: torch.Tensor
    deleted_bits: torch.Tensor  # int32[R, W]
    del_dot_actor: torch.Tensor
    del_dot_counter: torch.Tensor
    processed: torch.Tensor


class DotPackedAWSetState(NamedTuple):
    vv: torch.Tensor            # int32[R, A]
    present_bits: torch.Tensor  # int32[R, W]
    dots: torch.Tensor          # int32[R, E]: (actor << 20) | counter
    actor: torch.Tensor         # int32[R]


class DotPackedAWSetDeltaState(NamedTuple):
    vv: torch.Tensor
    present_bits: torch.Tensor
    dots: torch.Tensor
    actor: torch.Tensor
    deleted_bits: torch.Tensor
    del_dots: torch.Tensor      # int32[R, E]
    processed: torch.Tensor


PACKED_STATES = (PackedAWSetState, PackedAWSetDeltaState,
                 DotPackedAWSetState, DotPackedAWSetDeltaState)


# ---------------------------------------------------------------------------
# Bits and dot words
# ---------------------------------------------------------------------------


def packed_width(num_e: int) -> int:
    """Packed word count for an element axis: ceil(E/32)."""
    return (num_e + _WORD - 1) // _WORD


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool[R, E] -> int32[R, ceil(E/32)] (bit e % 32 of word e // 32;
    the tail bits past E are zero)."""
    num_r, num_e = mask.shape
    w = packed_width(num_e)
    m = torch.zeros((num_r, w * _WORD), dtype=torch.int64,
                    device=mask.device)
    m[:, :num_e] = mask
    shifts = torch.arange(_WORD, dtype=torch.int64, device=mask.device)
    return narrow((m.view(num_r, w, _WORD) << shifts).sum(dim=2))


def unpack_bits(bits: torch.Tensor, num_e: int) -> torch.Tensor:
    """int32[R, ceil(E/32)] -> bool[R, E] (inverse of pack_bits)."""
    num_r, w = bits.shape
    shifts = torch.arange(_WORD, dtype=torch.int64, device=bits.device)
    out = (widen(bits)[:, :, None] >> shifts) & 1
    return out.reshape(num_r, w * _WORD)[:, :num_e] != 0


def dot_words(actor: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """(actor << 20) | counter as uint32 bits, wrapping as the JAX
    package's uint32 shift does (the pack_* functions check the caps)."""
    return narrow(((widen(actor) << _DOT_SHIFT) & MASK) | widen(counter))


def dot_actor_of(words: torch.Tensor) -> torch.Tensor:
    return narrow(widen(words) >> _DOT_SHIFT)


def dot_counter_of(words: torch.Tensor) -> torch.Tensor:
    return narrow(widen(words) & _DOT_CMASK)


def _check_dot_caps(num_actors: int, *counters: torch.Tensor) -> None:
    """Refuse a state the dot-word layout cannot hold.  The counter max
    is unsigned: a counter >= 2^31 is a negative int32."""
    if num_actors > DOT_MAX_ACTORS:
        raise ValueError(
            f"dot-word layout holds {32 - _DOT_SHIFT} actor bits "
            f"(A <= {DOT_MAX_ACTORS}); got A={num_actors}")
    for c in counters:
        max_c = int(widen(c).max()) if c.numel() else 0
        if max_c > DOT_MAX_COUNTER:
            raise ValueError(
                f"dot counter {max_c} exceeds the dot-word layout's "
                f"{_DOT_SHIFT}-bit counter cap {DOT_MAX_COUNTER}; use "
                "the uint32 layouts for unbounded-counter fleets")


# ---------------------------------------------------------------------------
# Pack / unpack
# ---------------------------------------------------------------------------


def pack_awset(state: AWSetState) -> PackedAWSetState:
    return PackedAWSetState(
        vv=state.vv, present_bits=pack_bits(state.present),
        dot_actor=state.dot_actor, dot_counter=state.dot_counter,
        actor=state.actor)


def unpack_awset(packed: PackedAWSetState, num_elements: int) -> AWSetState:
    return AWSetState(
        vv=packed.vv, present=unpack_bits(packed.present_bits, num_elements),
        dot_actor=packed.dot_actor, dot_counter=packed.dot_counter,
        actor=packed.actor)


def pack_awset_dots(state: AWSetState) -> DotPackedAWSetState:
    _check_dot_caps(state.vv.shape[1], state.dot_counter)
    return DotPackedAWSetState(
        vv=state.vv, present_bits=pack_bits(state.present),
        dots=dot_words(state.dot_actor, state.dot_counter),
        actor=state.actor)


def unpack_awset_dots(packed: DotPackedAWSetState,
                      num_elements: int) -> AWSetState:
    return AWSetState(
        vv=packed.vv, present=unpack_bits(packed.present_bits, num_elements),
        dot_actor=dot_actor_of(packed.dots),
        dot_counter=dot_counter_of(packed.dots), actor=packed.actor)


def pack_awset_delta(state: AWSetDeltaState) -> PackedAWSetDeltaState:
    return PackedAWSetDeltaState(
        vv=state.vv, present_bits=pack_bits(state.present),
        dot_actor=state.dot_actor, dot_counter=state.dot_counter,
        actor=state.actor, deleted_bits=pack_bits(state.deleted),
        del_dot_actor=state.del_dot_actor,
        del_dot_counter=state.del_dot_counter, processed=state.processed)


def unpack_awset_delta(packed: PackedAWSetDeltaState,
                       num_elements: int) -> AWSetDeltaState:
    return AWSetDeltaState(
        vv=packed.vv, present=unpack_bits(packed.present_bits, num_elements),
        dot_actor=packed.dot_actor, dot_counter=packed.dot_counter,
        actor=packed.actor,
        deleted=unpack_bits(packed.deleted_bits, num_elements),
        del_dot_actor=packed.del_dot_actor,
        del_dot_counter=packed.del_dot_counter, processed=packed.processed)


def pack_awset_delta_dots(state: AWSetDeltaState) -> DotPackedAWSetDeltaState:
    _check_dot_caps(state.vv.shape[1], state.dot_counter,
                    state.del_dot_counter)
    return DotPackedAWSetDeltaState(
        vv=state.vv, present_bits=pack_bits(state.present),
        dots=dot_words(state.dot_actor, state.dot_counter),
        actor=state.actor, deleted_bits=pack_bits(state.deleted),
        del_dots=dot_words(state.del_dot_actor, state.del_dot_counter),
        processed=state.processed)


def unpack_awset_delta_dots(packed: DotPackedAWSetDeltaState,
                            num_elements: int) -> AWSetDeltaState:
    return AWSetDeltaState(
        vv=packed.vv, present=unpack_bits(packed.present_bits, num_elements),
        dot_actor=dot_actor_of(packed.dots),
        dot_counter=dot_counter_of(packed.dots), actor=packed.actor,
        deleted=unpack_bits(packed.deleted_bits, num_elements),
        del_dot_actor=dot_actor_of(packed.del_dots),
        del_dot_counter=dot_counter_of(packed.del_dots),
        processed=packed.processed)


def num_elements(packed) -> int:
    """E of a packed state, read from its E-shaped dot field."""
    return (packed.dots if hasattr(packed, "dots")
            else packed.dot_actor).shape[-1]


# ---------------------------------------------------------------------------
# The numpy bridge
# ---------------------------------------------------------------------------


def from_arrays(arrays: Dict[str, np.ndarray], device="cuda"):
    """A numpy dict of a JAX packed state's fields (every one uint32)
    -> the port's packed state of the same fields, bit for bit.  The
    field names pick the class."""
    dev = resolve_device(device)
    for cls in PACKED_STATES:
        if set(cls._fields) == set(arrays):
            return cls(*(from_numpy_u32(arrays[name], dev)
                         for name in cls._fields))
    raise ValueError(f"no packed state has the fields {sorted(arrays)}")


# every packed field is uint32: awset.to_arrays gives the numpy dict
to_arrays = awset_mod.to_arrays
