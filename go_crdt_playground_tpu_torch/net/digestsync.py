"""Digest-driven anti-entropy: O(diff) sync rounds between nodes.

The counterpart of the JAX package's ``net/digestsync.py``, byte for
byte on the wire.  The FULL/DELTA ladder (net/peer.py) ships at least two
E/8-byte section bitmasks and the whole un-resurrected deletion log every
round, even between converged replicas.  Here peers first exchange a
DIGEST SUMMARY (vv, processed, one uint32 per group of ``group_size``
lanes: ops/digest.py, K11 on a CUDA node), then ship only the lanes of
mismatched groups, index-encoded (``MODE_DIGEST``).  A quiescent pair
costs two summaries and two empty lane payloads.

Exchange (one push-pull round, ``Node.sync_with``'s shape)::

    client                                  server
      DIGEST(vv, processed, digests)  --->
                                      <---  DIGEST(vv, processed, digests)
      PAYLOAD(lanes | δ | empty)      --->  apply
                                      <---  PAYLOAD(...)  (after the apply)
      apply

Each side builds its payload by one rule (``build_reply_payload``):

* some groups mismatch: ``MODE_DIGEST`` with our complete lane state for
  exactly those groups (ops/digest.digest_diff_payload), applied by v2 δ
  arbitration;
* no group mismatches but the vvs differ (a vv-only divergence, or a
  digest collision, 2^-32 per group): the δ ladder's payload for this
  round (``Node._extract_payload``), counted ``digest.fallback_delta``;
* digests and vvs agree: an empty ``MODE_DIGEST`` payload built on the
  host with no extraction, counted ``digest.quiescent``.

A pre-digest server answers MSG_DIGEST with "expected HELLO", surfaced as
``DigestUnsupported``; the supervisor then pins the peer to the ladder
(net/antientropy.py).  The server adopts the client's group size when it
is on ``ALLOWED_GROUP_SIZES``.  Each side records the peer's advertised
``processed`` even when no state ships, so deletion GC keeps advancing.

Metric names: ``digest.exchanges``, ``digest.bytes_sent`` /
``digest.bytes_received``, ``digest.lanes_sent`` (state lanes shipped on
any rung), ``digest.groups_mismatched``, ``digest.quiescent``,
``digest.fallback_delta``.  The recorder is duck-typed: ``count_many``.
"""

from __future__ import annotations

import socket
import threading
from typing import NamedTuple, Optional, Set, Tuple

import numpy as np

from go_crdt_playground_tpu_torch._u32 import to_host
from go_crdt_playground_tpu_torch.net import framing
from go_crdt_playground_tpu_torch.net.framing import (MODE_DIGEST, MSG_DIGEST,
                                                      MSG_PAYLOAD,
                                                      ProtocolError)
from go_crdt_playground_tpu_torch.net.peer import (ConnectFailed,
                                                   DigestSummary,
                                                   PeerProtocolError,
                                                   PeerReset, PeerTimeout)
from go_crdt_playground_tpu_torch.ops import digest as digest_ops
from go_crdt_playground_tpu_torch.ops.delta import DeltaPayload
from go_crdt_playground_tpu_torch.ops.digest import (DIGEST_GROUP_LANES,
                                                     num_groups)
from go_crdt_playground_tpu_torch.utils import wire

Addr = Tuple[str, int]

# summary-body version: bumped when the summary layout or the
# fingerprint algebra changes incompatibly
DIGEST_V1 = 1

# group sizes a server adopts from a client's summary; anything else is
# a deterministic config error, like a universe mismatch
ALLOWED_GROUP_SIZES = (8, 16, 32, 64, 128)


class DigestUnsupported(Exception):
    """The peer answered MSG_DIGEST with the ladder's "expected HELLO":
    it predates the digest protocol.  Not a failure: the caller syncs
    over ``Node.sync_with`` and pins the peer legacy."""


class DigestSyncStats(NamedTuple):
    """One digest exchange, measured (client side)."""

    bytes_sent: int
    bytes_received: int
    mode_sent: int            # MODE_DIGEST | MODE_DELTA | MODE_FULL
    mode_received: int
    lanes_sent: int           # state lanes in our payload (0 quiescent)
    groups_mismatched: int
    quiescent: bool


class DigestNegotiator:
    """Per-peer digest capability (thread-safe): ``use_digest`` before
    each dial, ``mark_legacy`` pins a peer that answered "expected
    HELLO" for its lifetime in this process."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._legacy: Set[Addr] = set()  # guarded-by: _lock

    def use_digest(self, addr: Addr) -> bool:
        key = (addr[0], int(addr[1]))
        with self._lock:
            return key not in self._legacy

    def mark_legacy(self, addr: Addr) -> None:
        with self._lock:
            self._legacy.add((addr[0], int(addr[1])))

    def legacy_peers(self) -> Set[Addr]:
        with self._lock:
            return set(self._legacy)


class AdaptiveGroupSize:
    """Per-peer online tuning of the digest group size: the summary costs
    ``4 E / gs`` bytes every round while a mismatched group ships up to
    ``gs`` lanes.  One rung of ``ALLOWED_GROUP_SIZES`` at a time, on
    streaks: ``GROW_AFTER`` consecutive clean digest rounds grow it,
    ``SHRINK_AFTER`` consecutive sparse-divergence rounds (at most 1/8 of
    the groups mismatched) shrink it; dense divergence and δ-fallback
    rounds move nothing.  ``pin`` fixes a peer's size.  Thread-safe."""

    GROW_AFTER = 4
    SHRINK_AFTER = 2
    SPARSE_FRACTION = 1 / 8

    def __init__(self, num_elements: int,
                 initial: int = DIGEST_GROUP_LANES,
                 ladder: Tuple[int, ...] = ALLOWED_GROUP_SIZES):
        if initial not in ladder:
            raise ValueError(f"initial group size {initial} not on the "
                             f"ladder {ladder}")
        self.num_elements = int(num_elements)
        self.ladder = tuple(sorted(ladder))
        self.initial = int(initial)
        self._lock = threading.Lock()
        self._size: dict = {}          # guarded-by: _lock
        self._clean: dict = {}         # guarded-by: _lock
        self._sparse: dict = {}        # guarded-by: _lock
        self._pinned: Set[Addr] = set()  # guarded-by: _lock

    @staticmethod
    def _key(addr: Addr) -> Addr:
        return (addr[0], int(addr[1]))

    def size(self, addr: Addr) -> int:
        with self._lock:
            return self._size.get(self._key(addr), self.initial)

    def pin(self, addr: Addr, size: int) -> None:
        """Fix a peer at ``size`` for its lifetime in this process."""
        with self._lock:
            k = self._key(addr)
            self._size[k] = int(size)
            self._pinned.add(k)

    def observe(self, addr: Addr, stats: DigestSyncStats) -> str:
        """Advance the peer's streaks with one exchange's evidence;
        returns "grow", "shrink" or "hold" (the caller counts)."""
        k = self._key(addr)
        with self._lock:
            if k in self._pinned or stats.mode_sent != MODE_DIGEST:
                return "hold"
            size = self._size.get(k, self.initial)
            i = self.ladder.index(size)
            if stats.groups_mismatched == 0:
                self._sparse[k] = 0
                c = self._clean.get(k, 0) + 1
                if c >= self.GROW_AFTER and i + 1 < len(self.ladder):
                    self._size[k] = self.ladder[i + 1]
                    self._clean[k] = 0
                    return "grow"
                self._clean[k] = c
                return "hold"
            self._clean[k] = 0
            total = num_groups(self.num_elements, size)
            if stats.groups_mismatched <= max(1, int(
                    total * self.SPARSE_FRACTION)):
                s = self._sparse.get(k, 0) + 1
                if s >= self.SHRINK_AFTER and i > 0:
                    self._size[k] = self.ladder[i - 1]
                    self._sparse[k] = 0
                    return "shrink"
                self._sparse[k] = s
            else:
                self._sparse[k] = 0
            return "hold"


# ---------------------------------------------------------------------------
# Summary body codec
# ---------------------------------------------------------------------------
#
#   varint version | varint actor | varint E | varint group_size |
#   vv-section(vv) | vv-section(processed) | varint G | G x uint32 LE


def encode_summary(actor: int, num_elements: int, group_size: int,
                   vv: np.ndarray, processed: np.ndarray,
                   digests: np.ndarray) -> bytes:
    out = bytearray()
    wire._put_varint(out, DIGEST_V1)
    wire._put_varint(out, actor)
    wire._put_varint(out, num_elements)
    wire._put_varint(out, group_size)
    body = bytes(out)
    body += wire._encode_vv_py(np.asarray(vv, np.uint32))
    body += wire._encode_vv_py(np.asarray(processed, np.uint32))
    d = np.asarray(digests, np.uint32)
    tail = bytearray()
    wire._put_varint(tail, d.shape[0])
    return body + bytes(tail) + d.astype("<u4").tobytes()


def decode_summary(body: bytes, num_elements: int, num_actors: int
                   ) -> Tuple[int, int, np.ndarray, np.ndarray, np.ndarray]:
    """``(actor, group_size, vv, processed, digests)``; raises
    ``ProtocolError`` on any structural or dimensional disagreement."""
    try:
        version, pos = wire._get_varint(body, 0)
        if version != DIGEST_V1:
            raise ProtocolError(f"digest summary version {version} != "
                                f"{DIGEST_V1}")
        actor, pos = wire._get_varint(body, pos)
        e, pos = wire._get_varint(body, pos)
        if e != num_elements:
            raise ProtocolError(f"element-universe mismatch: peer E={e}, "
                                f"ours E={num_elements}")
        group_size, pos = wire._get_varint(body, pos)
        if group_size < 1:
            raise ProtocolError("digest group size must be >= 1")
        vv, pos = wire._decode_vv_py(body, pos, num_actors)
        processed, pos = wire._decode_vv_py(body, pos, num_actors)
        g, pos = wire._get_varint(body, pos)
        if g != num_groups(num_elements, group_size):
            raise ProtocolError(
                f"digest count {g} does not cover E={num_elements} at "
                f"group size {group_size}")
        raw = body[pos:pos + 4 * g]
        if len(raw) != 4 * g or pos + 4 * g != len(body):
            raise ProtocolError("malformed digest section")
        digests = np.frombuffer(raw, "<u4").astype(np.uint32)
    except ValueError as err:  # wire-layer section mismatch / malformed
        raise ProtocolError(str(err)) from err
    if actor >= num_actors:
        raise ProtocolError(f"peer actor {actor} outside actor axis "
                            f"{num_actors}")
    return actor, group_size, vv, processed, digests


# ---------------------------------------------------------------------------
# Shared exchange halves
# ---------------------------------------------------------------------------


def node_summary(node, group_size: int = DIGEST_GROUP_LANES) -> bytes:
    """This node's current digest summary frame body (the arrays from
    ``Node.digest_summary_arrays``: one K11 launch on a CUDA node, one
    device->host copy)."""
    vv, processed, digests = node.digest_summary_arrays(group_size)
    return encode_summary(node.actor, node.num_elements, group_size,
                          vv, processed, digests)


def warm(node, group_size: int = DIGEST_GROUP_LANES) -> None:
    """Run one self-exchange on ``node`` (a summary, and the mismatched-
    group extraction against perturbed digests), so the first real round
    pays for no kernel build or first launch.  Side-effect free."""
    body = node_summary(node, group_size)
    _, _, vv, _, digs = decode_summary(body, node.num_elements,
                                       node.num_actors)
    digs = np.asarray(digs, np.uint32) ^ np.uint32(1)
    with node._lock:
        build_reply_payload(node, vv, digs, group_size)


def _lanes(payload) -> int:
    """State lanes a host payload ships."""
    return int(payload.changed.sum()) + int(payload.deleted.sum())


# requires-lock: node._lock
def build_reply_payload(node, peer_vv: np.ndarray, peer_digests: np.ndarray,
                        group_size: int) -> Tuple[int, bytes, int, int]:
    """This side's PAYLOAD frame body against the peer's summary, from
    the CURRENT state (the server calls it after absorbing the client's
    payload, so transitively learned lanes ride along).  Caller holds the
    node lock.  Returns ``(mode, body, lanes, groups_mismatched)`` by the
    module docstring's rule; ``lanes`` counts the state lanes shipped on
    every rung, the δ fallback's included."""
    me = node._row()
    own_t = node._digest_fn(me, group_size)
    # transfer-ok: the summary's one bounded pull (both clocks and the G
    # group digests in one copy); the reply is built from the state the
    # caller's node lock holds, after absorbing the peer's payload
    vv, processed, own = to_host(DigestSummary(me.vv, me.processed, own_t))
    n_mism = digest_ops.mismatched_group_count(own, peer_digests)
    if n_mism == 0:
        if np.array_equal(vv, np.asarray(peer_vv, np.uint32)):
            # quiescent: the empty payload is built on the host, with no
            # extraction on the device
            e = int(me.present.shape[-1])
            zb = np.zeros(e, bool)
            zu = np.zeros(e, np.uint32)
            payload = DeltaPayload(
                src_vv=vv, changed=zb, ch_da=zu, ch_dc=zu, deleted=zb,
                del_da=zu, del_dc=zu, src_actor=np.uint32(node.actor),
                src_processed=processed)
            body = framing.encode_payload_msg(MODE_DIGEST, node.actor,
                                              processed, payload)
            return MODE_DIGEST, body, 0, 0
        # digests claim equality, clocks disagree: this round rides the
        # δ ladder (FULL on first contact)
        mode, _, payload = node._extract_payload(np.asarray(peer_vv))
        # transfer-ok: the δ fallback's payload in one copy, encoded under
        # the same node-lock hold that extracted it
        payload = to_host(payload)
        body = framing.encode_payload_msg(mode, node.actor, processed,
                                          payload)
        return mode, body, _lanes(payload), 0
    # transfer-ok: the digest-diff payload in one copy, encoded under the
    # same node-lock hold that extracted it
    payload = to_host(digest_ops.digest_diff_payload(me, own_t, peer_digests,
                                                     group_size))
    body = framing.encode_payload_msg(MODE_DIGEST, node.actor, processed,
                                      payload)
    return MODE_DIGEST, body, _lanes(payload), n_mism


def _record(node, *, bytes_sent: int, bytes_received: int, lanes: int,
            groups: int, mode_sent: int, quiescent: bool) -> None:
    if node.recorder is None:
        return
    counts = {"digest.exchanges": 1, "digest.bytes_sent": bytes_sent,
              "digest.bytes_received": bytes_received}
    if lanes > 0:
        counts["digest.lanes_sent"] = lanes
    if groups:
        counts["digest.groups_mismatched"] = groups
    if quiescent:
        counts["digest.quiescent"] = 1
    if mode_sent != MODE_DIGEST:
        counts["digest.fallback_delta"] = 1
    node.recorder.count_many(counts)


# ---------------------------------------------------------------------------
# Server half (dispatched from Node._serve_conn on MSG_DIGEST)
# ---------------------------------------------------------------------------


def serve_digest_exchange(node, conn: socket.socket,
                          summary_body: bytes) -> None:
    """Answer one inbound digest exchange: summary for summary, then
    payload for payload with the apply and the reply under one lock hold.
    The server adopts the client's group size; a protocol error is
    answered with MSG_ERROR."""
    try:
        peer_actor, peer_gs, peer_vv, peer_processed, peer_digests = \
            decode_summary(summary_body, node.num_elements, node.num_actors)
        if peer_gs not in ALLOWED_GROUP_SIZES:
            raise ProtocolError(
                f"digest group-size mismatch: peer {peer_gs} not in "
                f"{ALLOWED_GROUP_SIZES}")
    except ProtocolError as e:
        framing.send_frame(conn, framing.MSG_ERROR, str(e).encode())
        return
    group_size = peer_gs
    sent = framing.send_frame(conn, MSG_DIGEST, node_summary(node, group_size))
    recv = framing.frame_size(len(summary_body))
    node.note_peer_processed(peer_actor, peer_processed)
    msg_type, body = framing.recv_frame(conn, timeout=node.conn_timeout_s,
                                        max_body=node._frame_cap)
    if msg_type != MSG_PAYLOAD:
        framing.send_frame(conn, framing.MSG_ERROR,
                           f"expected PAYLOAD, got {msg_type}".encode())
        return
    try:
        with node._lock:
            mode_recv = node._apply_msg(body)
            mode, out, lanes, groups = build_reply_payload(
                node, peer_vv, peer_digests, group_size)
    except (ProtocolError, ValueError) as e:
        # ValueError: the apply hit a closed WAL (a teardown race)
        framing.send_frame(conn, framing.MSG_ERROR, str(e).encode())
        return
    sent += framing.send_frame(conn, MSG_PAYLOAD, out)
    recv += framing.frame_size(len(body))
    _record(node, bytes_sent=sent, bytes_received=recv, lanes=lanes,
            groups=groups, mode_sent=mode,
            quiescent=(mode == MODE_DIGEST and lanes == 0
                       and mode_recv == MODE_DIGEST))


# ---------------------------------------------------------------------------
# Client half
# ---------------------------------------------------------------------------


def sync_digest(node, addr: Addr, timeout: float = 30.0, *,
                connect_timeout_s: Optional[float] = None,
                group_size: int = DIGEST_GROUP_LANES) -> DigestSyncStats:
    """One push-pull digest exchange with the peer at ``addr``.

    The dial is bounded by ``connect_timeout_s`` (default ``timeout``),
    both reply frames by ``timeout`` (the summary reply sits behind the
    server's digest pass).  Raises the typed ``SyncError`` hierarchy of
    ``Node.sync_with``, ``framing.RemoteError`` for a server-reported
    failure, and ``DigestUnsupported`` for a pre-digest peer."""
    my_summary = node_summary(node, group_size)
    connect_t = timeout if connect_timeout_s is None else connect_timeout_s
    try:
        sock = socket.create_connection(addr, timeout=connect_t)
    except socket.timeout as e:
        raise PeerTimeout(f"connect to {addr}: {e}", phase="connect") from e
    except OSError as e:
        raise ConnectFailed(f"connect to {addr}: {e}") from e
    sock.settimeout(timeout)
    with sock:
        phase = "digest"
        try:
            sent = framing.send_frame(sock, MSG_DIGEST, my_summary)
            try:
                msg_type, body = framing.recv_frame(
                    sock, timeout=timeout, max_body=node._frame_cap)
            except framing.RemoteError as e:
                if "expected HELLO" in str(e):
                    raise DigestUnsupported(str(e)) from e
                raise
            if msg_type != MSG_DIGEST:
                raise ProtocolError(f"expected DIGEST, got {msg_type}")
            peer_actor, peer_gs, peer_vv, peer_processed, peer_digests = \
                decode_summary(body, node.num_elements, node.num_actors)
            if peer_gs != group_size:
                raise ProtocolError(
                    f"digest group-size mismatch: peer {peer_gs}, "
                    f"ours {group_size}")
            recv = framing.frame_size(len(body))
            node.note_peer_processed(peer_actor, peer_processed)
            with node._lock:
                mode_sent, out, lanes, groups = build_reply_payload(
                    node, peer_vv, peer_digests, group_size)
            phase = "payload"
            sent += framing.send_frame(sock, MSG_PAYLOAD, out)
            msg_type, body = framing.recv_frame(
                sock, timeout=timeout, max_body=node._frame_cap)
            if msg_type != MSG_PAYLOAD:
                raise ProtocolError(f"expected PAYLOAD, got {msg_type}")
            recv += framing.frame_size(len(body))
            with node._lock:
                mode_recv = node._apply_msg(body)
        except (DigestUnsupported, framing.RemoteError):
            raise  # typed already; RemoteError carries the message
        except socket.timeout as e:
            raise PeerTimeout(f"{phase} exchange with {addr}: {e}",
                              phase=phase) from e
        except framing.TruncatedFrame as e:
            raise PeerReset(f"{phase} exchange with {addr}: {e}") from e
        except ProtocolError as e:
            raise PeerProtocolError(str(e)) from e
        except OSError as e:
            raise PeerReset(f"{phase} exchange with {addr}: {e}") from e
    quiescent = (mode_sent == MODE_DIGEST and lanes == 0
                 and mode_recv == MODE_DIGEST)
    _record(node, bytes_sent=sent, bytes_received=recv, lanes=lanes,
            groups=groups, mode_sent=mode_sent, quiescent=quiescent)
    return DigestSyncStats(
        bytes_sent=sent, bytes_received=recv, mode_sent=mode_sent,
        mode_received=mode_recv, lanes_sent=lanes,
        groups_mismatched=groups, quiescent=quiescent)
