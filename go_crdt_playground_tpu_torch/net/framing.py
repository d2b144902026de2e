"""Message framing of the peer sync protocol and the WAL record policy.

The JAX package's ``net/framing.py``, byte for byte:

  frame    MAGIC(2) | type(1) | varint body_len | body
  HELLO    varint actor | varint E | vv-section(vv)
  PAYLOAD  mode(1) | varint src_actor | vv-section(processed) | payload
  ERROR    utf-8 message
  DIGEST   the digest summary (net/digestsync.py owns its codec)

where ``payload`` is utils/wire.encode_payload's three-section form (the
index-lane form for MODE_DIGEST).  A dense WAL record is the replay
guard's vv section followed by a PAYLOAD body; ``encode_delta_wal_record``
picks between that and the compact record form (utils/wire.py).

Every receive with a timeout has a deadline for the WHOLE frame: a peer
trickling one byte per timeout window cannot hold a read open, and the
socket's own timeout is restored afterwards.
"""

from __future__ import annotations

import socket
import time
from typing import Optional, Tuple

import numpy as np

from go_crdt_playground_tpu_torch._host import host, to_host
from go_crdt_playground_tpu_torch.utils import wire

MAGIC = b"\xc7\xd1"

MSG_HELLO = 1
MSG_PAYLOAD = 2
# protocol-ignore: internal — recv_frame raises it as RemoteError
# before any dispatcher sees a frame type
MSG_ERROR = 3
MSG_DIGEST = 4

MODE_DELTA = 0
MODE_FULL = 1
# keyspace-handoff slice: the donor's complete fenced state for the lanes
# it names, applied by overwrite (ops/delta.slice_apply)
MODE_SLICE = 2
# digest-sync lane payload, index-encoded, applied by δ arbitration
MODE_DIGEST = 3

# the codec ceiling of any declared body length
_MAX_BODY = 1 << 30


def peer_frame_cap(num_elements: int, num_actors: int) -> int:
    """The largest legal peer-dialect body, with slack: a dense FULL
    payload (two E/8-byte bitmasks, at most ~10 varint bytes per set lane
    per section) plus vv sections."""
    return 32 * int(num_elements) + 8 * int(num_actors) + (1 << 16)


class ProtocolError(RuntimeError):
    pass


class TruncatedFrame(ProtocolError):
    """The connection closed mid-frame: transport loss (retryable), told
    apart from a peer that spoke the protocol wrong."""


class RemoteError(RuntimeError):
    """The peer reported a protocol-level failure (MSG_ERROR frame)."""


# ---------------------------------------------------------------------------
# Frames on a socket
# ---------------------------------------------------------------------------


def _recv_exact(sock: socket.socket, n: int,
                deadline: Optional[float] = None) -> bytes:
    """Read exactly n bytes.  With a ``deadline`` (time.monotonic()) the
    whole read must finish by then: each recv's timeout is the remaining
    budget.  The socket's timeout is restored on exit, raise or not."""
    if deadline is None:
        return _recv_exact_inner(sock, n, None)
    saved = sock.gettimeout()
    try:
        return _recv_exact_inner(sock, n, deadline)
    finally:
        sock.settimeout(saved)


def _recv_exact_inner(sock: socket.socket, n: int,
                      deadline: Optional[float]) -> bytes:
    chunks = []
    while n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("frame deadline exceeded")
            sock.settimeout(remaining)
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise TruncatedFrame("connection closed mid-frame")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _recv_varint(sock: socket.socket,
                 deadline: Optional[float] = None) -> int:
    out = 0
    shift = 0
    while True:
        b = _recv_exact(sock, 1, deadline)[0]
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out
        shift += 7
        if shift > 63:
            raise ProtocolError("malformed varint")


def frame_size(body_len: int) -> int:
    """Total on-wire bytes of a frame with a body_len-byte body."""
    n, varint_len = body_len, 1
    while n >= 0x80:
        n >>= 7
        varint_len += 1
    return 2 + 1 + varint_len + body_len


def send_frame(sock: socket.socket, msg_type: int, body: bytes) -> int:
    head = bytearray(MAGIC)
    head.append(msg_type)
    wire._put_varint(head, len(body))
    data = bytes(head) + body
    sock.sendall(data)
    return len(data)


def recv_frame(sock: socket.socket, timeout: Optional[float] = None,
               max_body=_MAX_BODY) -> Tuple[int, bytes]:
    """Receive one frame.  ``timeout`` bounds the WHOLE frame and the
    socket's timeout is restored afterwards; None leaves the socket's
    per-recv timeout in force.  ``max_body`` caps the declared body size
    before any body byte is read; it may be a callable ``msg_type ->
    int``.  An ERROR frame raises ``RemoteError``."""
    if timeout is None:
        return _recv_frame(sock, None, max_body)
    saved = sock.gettimeout()
    try:
        return _recv_frame(sock, time.monotonic() + timeout, max_body)
    finally:
        sock.settimeout(saved)


def _recv_frame(sock: socket.socket, deadline: Optional[float],
                max_body=_MAX_BODY) -> Tuple[int, bytes]:
    magic = _recv_exact(sock, 2, deadline)
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r}")
    msg_type = _recv_exact(sock, 1, deadline)[0]
    n = _recv_varint(sock, deadline)
    limit = max_body(msg_type) if callable(max_body) else max_body
    if n > min(limit, _MAX_BODY):
        raise ProtocolError(f"oversized frame ({n} bytes)")
    body = _recv_exact(sock, n, deadline)
    if msg_type == MSG_ERROR:
        raise RemoteError(body.decode("utf-8", "replace"))
    return msg_type, body


# ---------------------------------------------------------------------------
# Bodies
# ---------------------------------------------------------------------------


def encode_hello(actor: int, num_elements: int, vv) -> bytes:
    out = bytearray()
    wire._put_varint(out, actor)
    wire._put_varint(out, num_elements)
    return bytes(out) + wire._encode_vv_py(np.asarray(host(vv), np.uint32))


def decode_hello(body: bytes, num_elements: int,
                 num_actors: int) -> Tuple[int, np.ndarray]:
    """``(actor, vv)``; raises ``ProtocolError`` on any dimension
    disagreement: peers share one universe and actor axis."""
    try:
        actor, pos = wire._get_varint(body, 0)
        e, pos = wire._get_varint(body, pos)
        if e != num_elements:
            raise ProtocolError(f"element-universe mismatch: peer E={e}, "
                                f"ours E={num_elements}")
        vv, pos = wire._decode_vv_py(body, pos, num_actors)
    except ValueError as err:  # wire-layer section mismatch / malformed
        raise ProtocolError(str(err)) from err
    if pos != len(body):
        raise ProtocolError("trailing bytes after HELLO")
    if actor >= num_actors:
        raise ProtocolError(f"peer actor {actor} outside actor axis "
                            f"{num_actors}")
    return actor, vv


def encode_payload_msg(mode: int, src_actor: int, processed,
                       payload) -> bytes:
    """A PAYLOAD body.  Payload fields may be tensors or numpy arrays;
    tensors reach the host in one copy."""
    # transfer-ok: one copy of the whole payload (fields already on the
    # host pass through); the exchange that built it encodes it under
    # its node-lock hold, as the WAL's dense record does
    payload = to_host(payload)
    out = bytearray()
    out.append(mode)
    wire._put_varint(out, src_actor)
    head = bytes(out) + wire._encode_vv_py(
        np.asarray(host(processed), np.uint32))
    if mode == MODE_DIGEST:
        return head + wire.encode_payload_lanes(
            payload, int(payload.changed.shape[-1]))
    return head + wire.encode_payload(payload)


def encode_delta_wal_record(pre_vv, src_actor: int, payload, compact=None,
                            *, compact_records: bool = True,
                            num_elements: Optional[int] = None
                            ) -> Tuple[bytes, bool]:
    """THE WAL record-form policy for one δ: ``(body, is_compact)``.

    The fixed-K on-device form when ``compact`` (an
    ops/compact.CompactDeltaPayload) is given and did not overflow; else
    host-side compaction of the dense ``payload`` while under the
    break-even (about 3 bytes of index varints per lane against the dense
    record's two E/8-byte bitmasks); else the dense record (guard vv ||
    PAYLOAD body).  ``compact_records=False`` forces the dense form.

    Every form filters the deletion section by the replay guard: a
    deletion dot (a, c) with c <= pre_vv[a] predates this record's ops,
    so the record that introduced it replays earlier, and only the
    deletions of this record's own window are written.

    ``compact`` reaches the host in ONE device->host copy of the whole
    fixed-K form; the dense payload is pulled (in one copy) only when a
    host-side form is needed.  ``payload`` may be None when ``compact``
    did not overflow and ``num_elements`` gives E."""
    pre_vv = np.asarray(host(pre_vv), np.uint32)
    if num_elements is None:
        num_elements = int(payload.changed.shape[-1])

    def fresh_mask(da: np.ndarray, dc: np.ndarray) -> np.ndarray:
        # NOT covered by the guard: introduced by this record's window
        return dc > np.take(pre_vv, da.astype(np.int64), mode="clip")

    if compact_records:
        if compact is not None:
            # transfer-ok: the one sanctioned bounded pull of the WAL
            # encode path (called under the node lock via
            # _append_delta_record)
            compact = to_host(compact)
        if compact is not None and not bool(compact.overflow):
            chv = compact.ch_valid
            dlv = compact.del_valid & fresh_mask(compact.del_da,
                                                 compact.del_dc)
            return wire.encode_compact_wal_body(
                pre_vv, src_actor, compact.src_processed, compact.src_vv,
                compact.ch_idx[chv], compact.ch_da[chv], compact.ch_dc[chv],
                compact.del_idx[dlv], compact.del_da[dlv],
                compact.del_dc[dlv], num_elements), True
        # transfer-ok: the dense δ in one copy, only when no fixed-K form
        # was made or it overflowed (under the node lock via
        # _append_delta_record; host fields pass through)
        payload = to_host(payload)
        changed = payload.changed
        deleted = payload.deleted & fresh_mask(payload.del_da,
                                               payload.del_dc)
        # break-even on the FILTERED lane count: an old deletion log must
        # not push a small record into the dense form
        lanes = int(changed.sum()) + int(deleted.sum())
        if lanes * 3 <= max(16, num_elements // 4):
            ch = np.nonzero(changed)[0]
            dl = np.nonzero(deleted)[0]
            return wire.encode_compact_wal_body(
                pre_vv, src_actor, payload.src_processed, payload.src_vv,
                ch, payload.ch_da[ch], payload.ch_dc[ch],
                dl, payload.del_da[dl], payload.del_dc[dl],
                num_elements), True
    # transfer-ok: the dense record's one copy, and a pass-through when
    # the host-side compaction above already pulled it
    payload = to_host(payload)
    deleted = payload.deleted & fresh_mask(payload.del_da, payload.del_dc)
    filtered = payload._replace(
        deleted=deleted,
        del_da=np.where(deleted, payload.del_da, np.uint32(0)),
        del_dc=np.where(deleted, payload.del_dc, np.uint32(0)))
    body = encode_payload_msg(MODE_DELTA, src_actor, payload.src_processed,
                              filtered)
    return wire._encode_vv_py(pre_vv) + body, False


def decode_payload_msg(body: bytes, num_elements: int, num_actors: int):
    """``(mode, payload)`` of a PAYLOAD body, numpy fields, with
    src_actor and src_processed rehydrated from the out-of-band fields.
    Raises ``ProtocolError`` on anything malformed."""
    if not body:
        raise ProtocolError("empty PAYLOAD body")
    mode = body[0]
    if mode not in (MODE_DELTA, MODE_FULL, MODE_SLICE, MODE_DIGEST):
        raise ProtocolError(f"unknown payload mode {mode}")
    try:
        src_actor, pos = wire._get_varint(body, 1)
        if src_actor >= num_actors:
            raise ProtocolError(f"payload src_actor {src_actor} outside "
                                f"actor axis {num_actors}")
        processed, pos = wire._decode_vv_py(body, pos, num_actors)
        decode = (wire.decode_payload_lanes if mode == MODE_DIGEST
                  else wire.decode_payload)
        payload = decode(body[pos:], num_elements, num_actors,
                         src_actor=src_actor)
    except ValueError as err:  # wire-layer section mismatch / malformed
        raise ProtocolError(str(err)) from err
    return mode, payload._replace(src_processed=processed)
