"""δ-payload wire format: dense masked payloads <-> compact bytes.

The codecs of the JAX package's ``utils/wire.py``, byte for byte.  The
masked and vv sections go through the C++ codec (native/codec.cpp) when
it builds, else through the Python functions below; both give the same
bytes and reject the same input.  A dense payload serializes as

  changed-section || deleted-section || vv-section

where each masked section is ``varint E, varint n_set, bitmask,
(varint dot_actor, varint dot_counter) per set lane`` and the vv section
is ``varint A, varint counter * A``.  The compact WAL record body and the
index-lane payload (MODE_DIGEST) carry lane sections ``varint n, n x
(varint element, varint dot_actor, varint dot_counter)`` instead of
bitmasks, with the writer's universe E embedded and checked.

Encoders take payload fields as numpy arrays or tensors (int32 bits are
read as uint32); decoders return payloads of numpy arrays (uint32 and
bool) and raise ``ValueError`` on any structural problem.  The node moves
decoded arrays to its device.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Tuple

import numpy as np

from go_crdt_playground_tpu_torch import native
from go_crdt_playground_tpu_torch._host import host

if TYPE_CHECKING:  # the decoders import it when they build one
    from go_crdt_playground_tpu_torch.ops.delta import DeltaPayload


def _put_varint(out: bytearray, v: int) -> None:
    while True:
        if v < 0x80:
            out.append(v)
            return
        out.append((v & 0x7F) | 0x80)
        v >>= 7


def _get_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        if pos >= len(buf) or shift > 63:
            raise ValueError("malformed varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _encode_masked_py(mask: np.ndarray, da: np.ndarray,
                      dc: np.ndarray) -> bytes:
    e = mask.shape[0]
    out = bytearray()
    _put_varint(out, e)
    _put_varint(out, int(mask.sum()))
    out.extend(np.packbits(mask, bitorder="little").tobytes())
    for i in np.nonzero(mask)[0]:
        _put_varint(out, int(da[i]))
        _put_varint(out, int(dc[i]))
    return bytes(out)


def _decode_masked_py(buf: bytes, pos: int, e: int):
    enc_e, pos = _get_varint(buf, pos)
    if enc_e != e:
        raise ValueError(f"universe mismatch: encoded {enc_e}, expected {e}")
    n_set, pos = _get_varint(buf, pos)
    nbytes = (e + 7) // 8
    bits = np.frombuffer(buf[pos:pos + nbytes], np.uint8)
    if bits.size != nbytes:
        raise ValueError("truncated bitmask")
    pos += nbytes
    mask = np.unpackbits(bits, count=e, bitorder="little").astype(bool)
    if int(mask.sum()) != n_set:
        raise ValueError("bitmask popcount mismatch")
    da = np.zeros(e, np.uint32)
    dc = np.zeros(e, np.uint32)
    for i in np.nonzero(mask)[0]:
        a, pos = _get_varint(buf, pos)
        c, pos = _get_varint(buf, pos)
        if a > 0xFFFFFFFF or c > 0xFFFFFFFF:
            raise ValueError("dot component out of uint32 range")
        da[i], dc[i] = a, c
    return mask, da, dc, pos


def _encode_vv_py(vv: np.ndarray) -> bytes:
    out = bytearray()
    _put_varint(out, vv.shape[0])
    for c in vv:
        _put_varint(out, int(c))
    return bytes(out)


def _decode_vv_py(buf: bytes, pos: int, a: int):
    enc_a, pos = _get_varint(buf, pos)
    if enc_a != a:
        raise ValueError(f"actor-axis mismatch: encoded {enc_a}, expected {a}")
    vv = np.zeros(a, np.uint32)
    for i in range(a):
        v, pos = _get_varint(buf, pos)
        if v > 0xFFFFFFFF:
            raise ValueError("counter out of uint32 range")
        vv[i] = v
    return vv, pos


def _payload(src_vv, changed, ch_da, ch_dc, deleted, del_da, del_dc,
             src_actor, src_processed) -> DeltaPayload:
    from go_crdt_playground_tpu_torch.ops.delta import DeltaPayload

    return DeltaPayload(
        src_vv=src_vv, changed=changed, ch_da=ch_da, ch_dc=ch_dc,
        deleted=deleted, del_da=del_da, del_dc=del_dc,
        src_actor=np.asarray(src_actor, np.uint32),
        src_processed=np.asarray(src_processed, np.uint32))


# ---------------------------------------------------------------------------
# Native-backed primitives (native/codec.cpp, the same bytes)
# ---------------------------------------------------------------------------


def _ptr(a: np.ndarray, ctype):
    import ctypes

    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _encode_masked_native(lib, mask, da, dc) -> bytes:
    import ctypes

    e = mask.shape[0]
    cap = int(lib.delta_encode_bound(e))
    out = (ctypes.c_uint8 * cap)()
    n = lib.delta_encode(
        _ptr(np.ascontiguousarray(mask, np.uint8), ctypes.c_uint8),
        _ptr(np.ascontiguousarray(da, np.uint32), ctypes.c_uint32),
        _ptr(np.ascontiguousarray(dc, np.uint32), ctypes.c_uint32),
        e, out, cap)
    if n < 0:
        raise ValueError("native delta_encode failed")
    return bytes(out[:n])


def _decode_masked_native(lib, buf: bytes, pos: int, e: int):
    import ctypes

    mask = np.zeros(e, np.uint8)
    da = np.zeros(e, np.uint32)
    dc = np.zeros(e, np.uint32)
    raw = np.ascontiguousarray(np.frombuffer(buf, np.uint8)[pos:])
    n = lib.delta_decode(
        _ptr(raw, ctypes.c_uint8), raw.size, e, _ptr(mask, ctypes.c_uint8),
        _ptr(da, ctypes.c_uint32), _ptr(dc, ctypes.c_uint32))
    if n < 0:
        raise ValueError("malformed delta section")
    return mask.astype(bool), da, dc, pos + int(n)


def _encode_vv_native(lib, vv) -> bytes:
    import ctypes

    a = vv.shape[0]
    cap = int(lib.vv_encode_bound(a))
    out = (ctypes.c_uint8 * cap)()
    n = lib.vv_encode(
        _ptr(np.ascontiguousarray(vv, np.uint32), ctypes.c_uint32), a, out,
        cap)
    if n < 0:
        raise ValueError("native vv_encode failed")
    return bytes(out[:n])


def _decode_vv_native(lib, buf: bytes, pos: int, a: int):
    import ctypes

    vv = np.zeros(a, np.uint32)
    raw = np.ascontiguousarray(np.frombuffer(buf, np.uint8)[pos:])
    n = lib.vv_decode(_ptr(raw, ctypes.c_uint8), raw.size, a,
                      _ptr(vv, ctypes.c_uint32))
    if n < 0:
        raise ValueError("malformed vv section")
    return vv, pos + int(n)


# ---------------------------------------------------------------------------
# Payload-level API
# ---------------------------------------------------------------------------


def encode_payload(p: DeltaPayload, prefer_native: bool = True) -> bytes:
    """Serialize one replica's δ payload (fields [E]/[A]) to the compact
    wire form, through the native codec when it builds (the same bytes
    either way)."""
    changed, deleted = host(p.changed).astype(bool), host(p.deleted).astype(
        bool)
    sections = ((changed, host(p.ch_da), host(p.ch_dc)),
                (deleted, host(p.del_da), host(p.del_dc)))
    vv = host(p.src_vv)
    lib = native.load() if prefer_native else None
    if lib is not None:
        return (b"".join(_encode_masked_native(lib, *s) for s in sections)
                + _encode_vv_native(lib, vv))
    return (b"".join(_encode_masked_py(*s) for s in sections)
            + _encode_vv_py(vv))


def payload_nbytes_wire(p: DeltaPayload) -> int:
    """Wire size of a payload, as shipped (``nbytes_dense`` is the
    on-device dense form's)."""
    return len(encode_payload(p))


def decode_payload(buf: bytes, num_elements: int, num_actors: int,
                   src_actor: int = 0,
                   prefer_native: bool = True) -> DeltaPayload:
    """Inverse of encode_payload.  ``src_processed`` is not shipped (v2
    local bookkeeping) and comes back zeroed; ``src_actor`` rides out of
    band."""
    lib = native.load() if prefer_native else None
    if lib is not None:
        changed, ch_da, ch_dc, pos = _decode_masked_native(
            lib, buf, 0, num_elements)
        deleted, del_da, del_dc, pos = _decode_masked_native(
            lib, buf, pos, num_elements)
        vv, pos = _decode_vv_native(lib, buf, pos, num_actors)
    else:
        changed, ch_da, ch_dc, pos = _decode_masked_py(buf, 0, num_elements)
        deleted, del_da, del_dc, pos = _decode_masked_py(
            buf, pos, num_elements)
        vv, pos = _decode_vv_py(buf, pos, num_actors)
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} trailing bytes after payload")
    return _payload(vv, changed, ch_da, ch_dc, deleted, del_da, del_dc,
                    src_actor, np.zeros(num_actors, np.uint32))


# ---------------------------------------------------------------------------
# Compact WAL record bodies
# ---------------------------------------------------------------------------
#
# A dense WAL record (guard-vv || PAYLOAD frame body) costs two E/8-byte
# section bitmasks however few lanes a batch touched; the compact record
# is the same δ in index form.  A dense record body begins with the guard
# vv's ``varint A`` and every store has A >= 1, so a leading 0x00 byte
# tags a compact record: body = 0x00 | version | varint src_actor |
# guard-vv | processed-vv | src-vv | varint E | changed-lanes |
# deleted-lanes.

WAL_COMPACT_TAG = 0x00
WAL_COMPACT_V1 = 1


def _put_lane_section(out: bytearray, idx, da, dc) -> None:
    _put_varint(out, len(idx))
    for i, a, c in zip(idx, da, dc):
        _put_varint(out, int(i))
        _put_varint(out, int(a))
        _put_varint(out, int(c))


def _get_lane_section(buf: bytes, pos: int, e: int):
    n, pos = _get_varint(buf, pos)
    if n > e:
        raise ValueError(f"lane section claims {n} lanes in universe {e}")
    mask = np.zeros(e, bool)
    da = np.zeros(e, np.uint32)
    dc = np.zeros(e, np.uint32)
    for _ in range(n):
        i, pos = _get_varint(buf, pos)
        a, pos = _get_varint(buf, pos)
        c, pos = _get_varint(buf, pos)
        if i >= e:
            raise ValueError(f"lane id {i} outside universe {e}")
        if a > 0xFFFFFFFF or c > 0xFFFFFFFF:
            raise ValueError("dot component out of uint32 range")
        mask[i], da[i], dc[i] = True, a, c
    return mask, da, dc, pos


def encode_compact_wal_body(guard_vv, src_actor: int, processed, src_vv,
                            ch_idx, ch_da, ch_dc, del_idx, del_da, del_dc,
                            num_elements: int) -> bytes:
    """One compact WAL record body.  ``*_idx``/``*_da``/``*_dc`` are 1-D
    sequences of the claimed lanes only; ``num_elements`` is the writer's
    universe, embedded for the decode-time dimension check."""
    out = bytearray((WAL_COMPACT_TAG, WAL_COMPACT_V1))
    _put_varint(out, int(src_actor))
    body = bytes(out)
    body += _encode_vv_py(host(guard_vv))
    body += _encode_vv_py(host(processed))
    body += _encode_vv_py(host(src_vv))
    tail = bytearray()
    _put_varint(tail, int(num_elements))
    _put_lane_section(tail, ch_idx, ch_da, ch_dc)
    _put_lane_section(tail, del_idx, del_da, del_dc)
    return body + tail


def decode_compact_wal_body(body: bytes, num_elements: int,
                            num_actors: int):
    """Inverse of ``encode_compact_wal_body``: ``(guard_vv, payload)``
    with the lane sections scattered back to the dense form."""
    if len(body) < 2 or body[0] != WAL_COMPACT_TAG:
        raise ValueError("not a compact WAL record")
    if body[1] != WAL_COMPACT_V1:
        raise ValueError(f"unknown compact WAL record version {body[1]}")
    src_actor, pos = _get_varint(body, 2)
    if src_actor >= num_actors:
        raise ValueError(f"src_actor {src_actor} outside actor axis "
                         f"{num_actors}")
    guard, pos = _decode_vv_py(body, pos, num_actors)
    processed, pos = _decode_vv_py(body, pos, num_actors)
    src_vv, pos = _decode_vv_py(body, pos, num_actors)
    enc_e, pos = _get_varint(body, pos)
    if enc_e != num_elements:
        raise ValueError(f"universe mismatch: encoded {enc_e}, "
                         f"expected {num_elements}")
    changed, ch_da, ch_dc, pos = _get_lane_section(body, pos, num_elements)
    deleted, del_da, del_dc, pos = _get_lane_section(body, pos,
                                                     num_elements)
    if pos != len(body):
        raise ValueError(f"{len(body) - pos} trailing bytes after "
                         "compact WAL record")
    return guard, _payload(src_vv, changed, ch_da, ch_dc, deleted, del_da,
                           del_dc, src_actor, processed)


# ---------------------------------------------------------------------------
# Index-lane payload bodies (MODE_DIGEST)
# ---------------------------------------------------------------------------


def encode_payload_lanes(p: DeltaPayload, num_elements: int) -> bytes:
    """Index-lane wire form of a sparse payload: ``varint E |
    vv-section(src_vv) | changed lane-section | deleted lane-section``."""
    out = bytearray()
    _put_varint(out, num_elements)
    body = bytes(out) + _encode_vv_py(host(p.src_vv))
    tail = bytearray()
    ch = np.nonzero(host(p.changed))[0]
    _put_lane_section(tail, ch, host(p.ch_da)[ch], host(p.ch_dc)[ch])
    dl = np.nonzero(host(p.deleted))[0]
    _put_lane_section(tail, dl, host(p.del_da)[dl], host(p.del_dc)[dl])
    return body + bytes(tail)


def decode_payload_lanes(buf: bytes, num_elements: int, num_actors: int,
                         src_actor: int = 0) -> DeltaPayload:
    """Inverse of encode_payload_lanes."""
    enc_e, pos = _get_varint(buf, 0)
    if enc_e != num_elements:
        raise ValueError(f"universe mismatch: encoded {enc_e}, "
                         f"expected {num_elements}")
    src_vv, pos = _decode_vv_py(buf, pos, num_actors)
    changed, ch_da, ch_dc, pos = _get_lane_section(buf, pos, num_elements)
    deleted, del_da, del_dc, pos = _get_lane_section(buf, pos, num_elements)
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} trailing bytes after lane "
                         "payload")
    return _payload(src_vv, changed, ch_da, ch_dc, deleted, del_da, del_dc,
                    src_actor, np.zeros(num_actors, np.uint32))
