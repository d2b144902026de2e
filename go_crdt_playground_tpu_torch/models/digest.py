"""Content digests for replica states: one CRC32 per array (dtype and
shape folded in, so a reinterpreted buffer cannot pass as intact) and one
order-stable digest per state (field names folded in).  The checkpoint
manifest (utils/checkpoint.py) stores them and restore re-verifies them.

uint32 fields are hashed through their uint32 view: the dtype string is
part of the CRC, so hashing the int32 storage would give every
checkpoint a digest the JAX package's never matches.
"""

from __future__ import annotations

import zlib

from go_crdt_playground_tpu_torch._u32 import host


def array_digest(a) -> int:
    """CRC32 over dtype, shape and bytes of one array (a tensor is taken
    as its uint32 or bool view)."""
    a = host(a)
    h = zlib.crc32(f"{a.dtype.str}|{a.shape}|".encode("ascii"))
    return zlib.crc32(a.tobytes(order="C"), h)


def state_digest(state) -> int:
    """Order-stable CRC32 of a whole state NamedTuple: per-field digests
    chained in field order with the field names folded in."""
    fields = getattr(state, "_fields", None)
    if fields is None:
        raise TypeError(
            f"state_digest wants a state NamedTuple, got {type(state)!r}")
    h = 0
    for name in fields:
        h = zlib.crc32(f"{name}|".encode("ascii"), h)
        h = zlib.crc32(array_digest(getattr(state, name))
                       .to_bytes(4, "little"), h)
    return h
