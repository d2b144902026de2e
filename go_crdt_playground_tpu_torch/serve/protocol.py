"""Client op-ingest wire protocol (DESIGN.md §16 "Serving ladder").

Rides the SAME frame armor as the peer sync protocol —
``net/framing.py``'s ``MAGIC(2) | type(1) | varint body_len | body`` —
with a disjoint message-type range (>= 16), so one listener could in
principle speak both dialects and a serve frame can never be mistaken
for an anti-entropy frame.  Bodies reuse the ``utils/wire.py`` varint
codec; there is no new byte format below the body layouts here.

    OP       varint req_id | kind(1: 0=add 1=del) | varint deadline_us
             | varint k | k x varint element_id
    ACK      varint req_id
    REJECT   varint req_id | code(1) | utf-8 reason
    QUERY    varint req_id
    MEMBERS  varint req_id | varint n | n x varint element_id
             | varint A | A x varint vv
    STATS    varint req_id
    STATS_REPLY  varint req_id | utf-8 JSON (obs.Recorder.snapshot())
    RESHARD  varint req_id | mode(1: 0=join 1=leave) | str sid
             | [join only: str host | varint port]     (str = varint
             len + utf-8)
    RESHARD_REPLY  varint req_id | ok(1) | utf-8 JSON detail
    SLICE_PULL     varint req_id | varint k | k x varint element_id
    SLICE_STATE    varint req_id | anti-entropy PAYLOAD body (opaque)
    SLICE_PUSH     varint req_id | anti-entropy PAYLOAD body (opaque)
    FRONTIER       varint req_id
    FRONTIER_REPLY varint req_id | flags(1: bit0 = isolated decl)
                   | varint A | A x varint frontier
                   | A x varint processed
    GC             varint req_id | varint A | A x varint frontier
    GC_REPLY       varint req_id | varint dropped | varint remaining

``deadline_us`` is the client's remaining latency budget in
MICROSECONDS at send time (0 = none); the server converts it to an
absolute deadline at admission and sheds the op with ``REJECT_EXPIRED``
instead of applying it late — deadline propagation, not server-side
guessing.  ``REJECT`` is the typed load-shed reply (never a silent
drop): ``REJECT_OVERLOADED`` (admission queue full), ``REJECT_EXPIRED``
(deadline passed before apply), ``REJECT_DRAINING`` (shutdown in
progress), ``REJECT_INVALID`` (element id outside the universe),
``REJECT_UNAVAILABLE`` (the routed shard owning the keyspace is
unreachable — shard/router.py degradation, DESIGN.md §17),
``REJECT_MOVING`` (the element's slice is fenced for a live-reshard
handoff — brief, retryable, DESIGN.md §18).  Each maps to a typed
client-side exception below.

An ``ACK`` is only ever sent AFTER the op's effects are fsync'd in the
replica's delta WAL (``Node.ingest_batch`` group commit) — the same
durable-before-ack contract as DESIGN.md §14.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from go_crdt_playground_tpu_torch.net.framing import ProtocolError
from go_crdt_playground_tpu_torch.utils import wire

# message types (>= 16: disjoint from net/framing's HELLO/PAYLOAD/ERROR).
# Direction is machine-checked (W001, analysis/protocol_contract.py):
# a constant carrying the reply-direction ignore annotation is
# client-inbound and must have an arm in the ServeClient reader;
# everything unannotated is server-inbound and must have an arm (or a
# dispatcher-scoped ignore) in EVERY registered server dispatcher.
MSG_OP = 16
MSG_ACK = 17  # protocol-ignore: reply — op acked (ServeClient reader)
MSG_REJECT = 18  # protocol-ignore: reply — typed shed (client reader)
MSG_QUERY = 19
MSG_MEMBERS = 20  # protocol-ignore: reply — QUERY answer (client reader)
MSG_STATS = 21
MSG_STATS_REPLY = 22  # protocol-ignore: reply — STATS answer
# live-resharding verbs (DESIGN.md §18).  RESHARD is the router-side
# admin verb (join/leave a shard); SLICE_PULL/SLICE_STATE/SLICE_PUSH are
# the keyspace-handoff transfer the router drives against shard
# frontends: PULL asks the donor for the moved slice as an anti-entropy
# payload body (net/framing's MODE_SLICE wire form: authoritative for
# the lanes it names, applied by overwrite — ops/delta.slice_apply —
# with everything outside the slice untouched), PUSH hands that body
# to the new owner, which applies it through the normal WAL-logged
# payload path and acks only once it is as durable as any client op.
MSG_RESHARD = 23
MSG_RESHARD_REPLY = 24  # protocol-ignore: reply — handoff verdict
MSG_SLICE_PULL = 25
MSG_SLICE_STATE = 26  # protocol-ignore: reply — pulled slice payload
MSG_SLICE_PUSH = 27
# fleet-aware deletion-record GC (DESIGN.md §16/§17): shards of a
# sharded fleet never anti-entropy with each other (disjoint
# keyspaces), so a shard's own ``_peer_processed`` evidence can never
# cover the fleet — the ROUTER is the evidence channel.  FRONTIER asks
# a shard for its local provable causal-stability frontier
# (Node.deletion_frontier under the shard's own declared membership);
# the router mins the replies into the true FLEET frontier (the
# collective-min gc_frontier of ops/delta.py, computed over sockets)
# and pushes it back via GC, which each shard clamps to its own
# frontier before applying — conservative on both hops.
MSG_FRONTIER = 28
MSG_FRONTIER_REPLY = 29  # protocol-ignore: reply — GC evidence
MSG_GC = 30
MSG_GC_REPLY = 31  # protocol-ignore: reply — GC accounting
# digest-summary read (ROADMAP digest rung b — the router's member
# cache): DSUM asks a frontend for its replica's digest summary — the
# ``net/digestsync.py`` summary body (vv, processed, packed per-lane-
# group digests), opaque here — which is a few dozen bytes against a
# MEMBERS reply's O(membership).  Two equal summaries imply equal
# membership AND vv (present bits are fingerprinted, the vv is
# explicit; the 2^-32-per-group collision bound is ops/digest.py's),
# so a router can cache per-shard member sets keyed by the summary and
# re-pull only on mismatch: repeated fleet reads become O(diff).
MSG_DSUM = 32
MSG_DSUM_REPLY = 33  # protocol-ignore: reply — digest summary body
# router high availability (DESIGN.md §22): RING_SYNC is one verb with
# two jobs.  (1) TAIL — a warm-standby router (shard/ha.py) asks the
# primary for its committed routing record (generation, digest, shard
# map, router epoch) and persists it locally, so a promotion adopts
# the exact ring the primary last committed.  (2) FENCE — a router
# ANNOUNCES its monotone router epoch to a shard frontend before
# driving admin-plane verbs; the frontend persists the highest epoch
# it has ever seen and from then on answers any admin verb
# (SLICE_PULL/SLICE_PUSH/FRONTIER/GC) whose connection announced a
# lower epoch — or none at all — with the typed ``REJECT_STALE_EPOCH``,
# so a deposed primary that resurrects can never commit a reshard
# transfer or force a GC drop (split-brain containment; the promotion
# sequence bumps the epoch and announces it fleet-wide BEFORE serving).
MSG_RING_SYNC = 34
MSG_RING_SYNC_REPLY = 35  # protocol-ignore: reply — ring/epoch record
# shard replication groups (DESIGN.md §23): WAL_SYNC is the data-plane
# sibling of RING_SYNC — a warm-standby SHARD (shard/replica.py) tails
# its primary's committed δ-WAL records by seq cursor (the reply ships
# a contiguous batch plus the primary's shard epoch, WAL-instance
# nonce and retained-seq bounds), and the same request doubles as the
# standby's liveness/ack signal: ``from_seq`` acknowledges everything
# below it, which is what the primary's semi-synchronous group-commit
# gate waits on (serve/batcher.py).  A cursor below the retained
# minimum (a checkpoint truncated the log) replies typed-truncated and
# the standby catches up O(diff): it re-sends WAL_SYNC carrying its
# own digest summary and the reply carries a digest-sync payload
# (net/digestsync.build_reply_payload) plus the fresh cursor.  An
# ``epoch`` claim above the shard's own fences it exactly like
# RING_SYNC fences a router (the promoting standby's deposition
# notice).
MSG_WAL_SYNC = 36
MSG_WAL_SYNC_REPLY = 37  # protocol-ignore: reply — WAL tail batch
# the keyspace-failover announce (DESIGN.md §23): a PROMOTED shard
# standby claims its primary's keyspace at the ROUTER under a bumped,
# persisted shard epoch.  The router adjudicates per sid (highest
# epoch wins, durably), swaps the sid's downstream address under the
# existing RouteState machinery — the ring and owner map are
# untouched; only where the keyspace's ops go changes — and persists
# the swap so a router restart redials the promoted member.  A claim
# below the adjudicated epoch is the resurrected OLD primary's
# startup probe: typed ``REJECT_STALE_SHARD_EPOCH``, on which it
# boots self-fenced (writes shed typed; the PR-13 deposed-router
# containment one tier down).
MSG_SHARD_FAILOVER = 38
MSG_SHARD_FAILOVER_REPLY = 39  # protocol-ignore: reply — failover verdict

OP_ADD = 0
OP_DEL = 1

RESHARD_JOIN = 0
RESHARD_LEAVE = 1

REJECT_OVERLOADED = 1
REJECT_EXPIRED = 2
REJECT_DRAINING = 3
REJECT_INVALID = 4
REJECT_UNAVAILABLE = 5
REJECT_MOVING = 6
REJECT_STALE_EPOCH = 7
REJECT_STORAGE = 8
REJECT_STALE_SHARD_EPOCH = 9

_MAX_REASON = 1 << 16


class ServeError(RuntimeError):
    """Base of every typed op-reject a client can receive."""


class Overloaded(ServeError):
    """The frontend shed the op WITHOUT applying it and the condition
    is transient: admission queue at depth, or a server-side apply
    fault.  Retry with backoff — the CRDT op is idempotent, so a
    duplicate retry after an ambiguous failure is harmless by
    construction."""


class DeadlineExceeded(ServeError):
    """The op's propagated deadline passed before the batcher applied
    it; it was NOT applied."""


class Draining(ServeError):
    """The frontend is shutting down gracefully and no longer admits
    new ops (already-admitted ops still flush and ack)."""


class InvalidOp(ServeError):
    """The op named an element outside the configured universe."""


class ShardUnavailable(ServeError):
    """The router tier (shard/router.py) could not reach the shard
    frontend owning this op's keyspace — its circuit breaker is open or
    the dial/forward failed.  The op was NOT applied on that shard (a
    spanning op's sub-ops on REACHABLE shards may have applied — they
    are idempotent, so the retry is still a plain resubmit).  Transient:
    retry with backoff; other shards' keyspaces keep serving."""


class KeyspaceMoving(ServeError):
    """The op named an element inside a keyspace slice currently FENCED
    for a live-reshard handoff (shard/handoff.py): the router refused it
    TYPED rather than risk landing it on a donor whose slice snapshot
    has already been taken (a silent acked-op loss at ring swap).  The
    op was NOT applied anywhere.  Transient and brief — the fence lasts
    one slice transfer; retry with backoff and the op lands on whichever
    shard owns the key when the ring settles (old owner on abort, new
    owner on commit)."""


class StaleRouterEpoch(ServeError):
    """The admin verb was driven under a router epoch OLDER than the
    highest this endpoint has adjudicated (DESIGN.md §22): the caller
    is a DEPOSED router — a standby has promoted past it.  The verb was
    NOT applied.  Deterministic, never retryable with the same epoch:
    a deposed router must stop driving admin actions (its in-flight
    handoff aborts typed, with the old ring still serving) and an
    operator resolves which router is current via STATS/RING_SYNC."""


class StorageDegraded(ServeError):
    """The frontend's durable WAL append/fsync path failed (ENOSPC, an
    fsync error) — the op was NOT acked and NOT durable.  The frontend
    degrades gracefully: reads (QUERY/STATS/DSUM) keep serving, writes
    shed with this typed reject until a write probe succeeds again.
    Transient from the client's perspective: retry with backoff — the
    op is idempotent, and the frontend re-probes the disk on a
    cooldown cadence."""


class StaleShardEpoch(ServeError):
    """The caller acted under a SHARD epoch older than the highest
    adjudicated for that keyspace (DESIGN.md §23): it is a deposed
    shard primary — its warm standby promoted past it.  Writes to the
    deposed member were NOT applied (it sheds them typed with this
    code the moment it learns the adjudicated epoch); a failover
    announce under a stale epoch was NOT adopted.  Deterministic,
    never retryable with the same epoch: clients re-resolve the
    keyspace's active member through the router, which keeps serving
    it throughout."""


REJECT_EXCEPTIONS = {
    REJECT_OVERLOADED: Overloaded,
    REJECT_EXPIRED: DeadlineExceeded,
    REJECT_DRAINING: Draining,
    REJECT_INVALID: InvalidOp,
    REJECT_UNAVAILABLE: ShardUnavailable,
    REJECT_MOVING: KeyspaceMoving,
    REJECT_STALE_EPOCH: StaleRouterEpoch,
    REJECT_STORAGE: StorageDegraded,
    REJECT_STALE_SHARD_EPOCH: StaleShardEpoch,
}

# exception class -> wire code (the ROUTER's relay direction: a typed
# reject read off a downstream shard re-encodes upstream with the same
# code, so the client sees exactly what the shard said)
REJECT_CODES = {exc: code for code, exc in REJECT_EXCEPTIONS.items()}


def encode_op(req_id: int, kind: int, elements: Sequence[int],
              deadline_us: int = 0) -> bytes:
    if kind not in (OP_ADD, OP_DEL):
        raise ValueError(f"unknown op kind {kind}")
    if not elements:
        raise ValueError("an op must name at least one element")
    if len(set(elements)) != len(elements):
        # the frame body is a key SET: the packed batch apply is
        # selector-based, while the reference host path ticks the clock
        # once per ARGUMENT — duplicates would make identical op
        # streams diverge by ingress path, so they are refused at both
        # ends (the listener rejects them typed, serve/frontend.py)
        raise ValueError("duplicate element ids in one op")
    out = bytearray()
    wire._put_varint(out, req_id)
    out.append(kind)
    wire._put_varint(out, max(0, int(deadline_us)))
    wire._put_varint(out, len(elements))
    for e in elements:
        wire._put_varint(out, int(e))
    return bytes(out)


def decode_op(body: bytes) -> Tuple[int, int, List[int], int]:
    """Returns (req_id, kind, elements, deadline_us).  Range-validation
    of element ids against the universe is the LISTENER's job (it knows
    the universe and owes the client a typed per-request reject, not a
    connection-fatal protocol error)."""
    try:
        req_id, pos = wire._get_varint(body, 0)
        if pos >= len(body):
            raise ProtocolError("truncated OP body")
        kind = body[pos]
        pos += 1
        if kind not in (OP_ADD, OP_DEL):
            raise ProtocolError(f"unknown op kind {kind}")
        deadline_us, pos = wire._get_varint(body, pos)
        k, pos = wire._get_varint(body, pos)
        if k == 0:
            raise ProtocolError("empty OP key set")
        elements = []
        for _ in range(k):
            e, pos = wire._get_varint(body, pos)
            elements.append(e)
    except ValueError as err:
        raise ProtocolError(str(err)) from err
    if pos != len(body):
        raise ProtocolError("trailing bytes after OP")
    return req_id, kind, elements, deadline_us


def encode_ack(req_id: int) -> bytes:
    out = bytearray()
    wire._put_varint(out, req_id)
    return bytes(out)


def decode_ack(body: bytes) -> int:
    try:
        req_id, pos = wire._get_varint(body, 0)
    except ValueError as err:
        raise ProtocolError(str(err)) from err
    if pos != len(body):
        raise ProtocolError("trailing bytes after ACK")
    return req_id


def encode_reject(req_id: int, code: int, reason: str) -> bytes:
    if code not in REJECT_EXCEPTIONS:
        raise ValueError(f"unknown reject code {code}")
    out = bytearray()
    wire._put_varint(out, req_id)
    out.append(code)
    return bytes(out) + reason.encode("utf-8")[:_MAX_REASON]


def decode_reject(body: bytes) -> Tuple[int, int, str]:
    try:
        req_id, pos = wire._get_varint(body, 0)
    except ValueError as err:
        raise ProtocolError(str(err)) from err
    if pos >= len(body):
        raise ProtocolError("truncated REJECT body")
    code = body[pos]
    if code not in REJECT_EXCEPTIONS:
        raise ProtocolError(f"unknown reject code {code}")
    return req_id, code, body[pos + 1:].decode("utf-8", "replace")


def encode_query(req_id: int) -> bytes:
    out = bytearray()
    wire._put_varint(out, req_id)
    return bytes(out)


def decode_query(body: bytes) -> int:
    try:
        req_id, pos = wire._get_varint(body, 0)
    except ValueError as err:
        raise ProtocolError(str(err)) from err
    if pos != len(body):
        raise ProtocolError("trailing bytes after QUERY")
    return req_id


def encode_stats(req_id: int) -> bytes:
    out = bytearray()
    wire._put_varint(out, req_id)
    return bytes(out)


def decode_stats(body: bytes) -> int:
    try:
        req_id, pos = wire._get_varint(body, 0)
    except ValueError as err:
        raise ProtocolError(str(err)) from err
    if pos != len(body):
        raise ProtocolError("trailing bytes after STATS")
    return req_id


def encode_stats_reply(req_id: int, snapshot: dict) -> bytes:
    import json

    out = bytearray()
    wire._put_varint(out, req_id)
    return bytes(out) + json.dumps(snapshot).encode("utf-8")


def decode_stats_reply(body: bytes) -> Tuple[int, dict]:
    import json

    try:
        req_id, pos = wire._get_varint(body, 0)
        snapshot = json.loads(body[pos:].decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as err:
        raise ProtocolError(str(err)) from err
    return req_id, snapshot


def encode_members(req_id: int, members: Sequence[int],
                   vv: np.ndarray) -> bytes:
    out = bytearray()
    wire._put_varint(out, req_id)
    wire._put_varint(out, len(members))
    for e in members:
        wire._put_varint(out, int(e))
    vv = np.asarray(vv, np.uint32)
    wire._put_varint(out, vv.shape[0])
    for c in vv:
        wire._put_varint(out, int(c))
    return bytes(out)


def _put_str(out: bytearray, s: str) -> None:
    raw = s.encode("utf-8")
    wire._put_varint(out, len(raw))
    out.extend(raw)


def _get_str(body: bytes, pos: int) -> Tuple[str, int]:
    n, pos = wire._get_varint(body, pos)
    if pos + n > len(body):
        raise ProtocolError("truncated string")
    return body[pos:pos + n].decode("utf-8"), pos + n


def encode_reshard(req_id: int, mode: int, sid: str,
                   addr: Optional[Tuple[str, int]] = None) -> bytes:
    """The admin verb: stage a ring change and drive the handoff.
    ``mode`` is RESHARD_JOIN (``addr`` required: the joining frontend's
    serve address) or RESHARD_LEAVE (``addr`` must be None)."""
    if mode not in (RESHARD_JOIN, RESHARD_LEAVE):
        raise ValueError(f"unknown reshard mode {mode}")
    if (addr is None) == (mode == RESHARD_JOIN):
        raise ValueError("join requires addr; leave forbids it")
    if not sid:
        raise ValueError("empty shard id")
    out = bytearray()
    wire._put_varint(out, req_id)
    out.append(mode)
    _put_str(out, sid)
    if addr is not None:
        _put_str(out, addr[0])
        wire._put_varint(out, int(addr[1]))
    return bytes(out)


def decode_reshard(body: bytes
                   ) -> Tuple[int, int, str, Optional[Tuple[str, int]]]:
    try:
        req_id, pos = wire._get_varint(body, 0)
        if pos >= len(body):
            raise ProtocolError("truncated RESHARD body")
        mode = body[pos]
        pos += 1
        if mode not in (RESHARD_JOIN, RESHARD_LEAVE):
            raise ProtocolError(f"unknown reshard mode {mode}")
        sid, pos = _get_str(body, pos)
        if not sid:
            raise ProtocolError("empty shard id in RESHARD")
        addr = None
        if mode == RESHARD_JOIN:
            host, pos = _get_str(body, pos)
            port, pos = wire._get_varint(body, pos)
            addr = (host, port)
    except ValueError as err:
        raise ProtocolError(str(err)) from err
    if pos != len(body):
        raise ProtocolError("trailing bytes after RESHARD")
    return req_id, mode, sid, addr


def encode_reshard_reply(req_id: int, ok: bool, detail: dict) -> bytes:
    """``detail`` is the handoff's accounting (moved counts, epoch,
    fence window, old/new digests — or the abort reason), JSON so the
    soak and operators read the same record."""
    import json

    out = bytearray()
    wire._put_varint(out, req_id)
    out.append(1 if ok else 0)
    return bytes(out) + json.dumps(detail).encode("utf-8")


def decode_reshard_reply(body: bytes) -> Tuple[int, bool, dict]:
    import json

    try:
        req_id, pos = wire._get_varint(body, 0)
        if pos >= len(body):
            raise ProtocolError("truncated RESHARD_REPLY body")
        ok = body[pos] != 0
        detail = json.loads(body[pos + 1:].decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as err:
        raise ProtocolError(str(err)) from err
    return req_id, ok, detail


def encode_slice_pull(req_id: int, elements: Sequence[int]) -> bytes:
    if not elements:
        raise ValueError("a slice pull must name at least one element")
    out = bytearray()
    wire._put_varint(out, req_id)
    wire._put_varint(out, len(elements))
    for e in elements:
        wire._put_varint(out, int(e))
    return bytes(out)


def decode_slice_pull(body: bytes) -> Tuple[int, List[int]]:
    try:
        req_id, pos = wire._get_varint(body, 0)
        k, pos = wire._get_varint(body, pos)
        if k == 0:
            raise ProtocolError("empty slice pull")
        elements = []
        for _ in range(k):
            e, pos = wire._get_varint(body, pos)
            elements.append(e)
    except ValueError as err:
        raise ProtocolError(str(err)) from err
    if pos != len(body):
        raise ProtocolError("trailing bytes after SLICE_PULL")
    return req_id, elements


def _encode_slice_body(req_id: int, payload: bytes) -> bytes:
    out = bytearray()
    wire._put_varint(out, req_id)
    return bytes(out) + payload


def _decode_slice_body(body: bytes, what: str) -> Tuple[int, bytes]:
    try:
        req_id, pos = wire._get_varint(body, 0)
    except ValueError as err:
        raise ProtocolError(str(err)) from err
    if pos >= len(body):
        raise ProtocolError(f"empty {what} payload")
    return req_id, body[pos:]


def encode_slice_state(req_id: int, payload: bytes) -> bytes:
    """``payload`` is an anti-entropy PAYLOAD frame body (opaque to the
    router: it shuttles the bytes donor→recipient unparsed)."""
    return _encode_slice_body(req_id, payload)


def decode_slice_state(body: bytes) -> Tuple[int, bytes]:
    return _decode_slice_body(body, "SLICE_STATE")


def encode_slice_push(req_id: int, payload: bytes) -> bytes:
    return _encode_slice_body(req_id, payload)


def decode_slice_push(body: bytes) -> Tuple[int, bytes]:
    return _decode_slice_body(body, "SLICE_PUSH")


# -- fleet-aware deletion-record GC (router-aggregated frontier) ------------

_FRONTIER_ISOLATED = 0x01


def _put_u32_array(out: bytearray, arr: np.ndarray) -> None:
    arr = np.asarray(arr, np.uint32)
    for v in arr:
        wire._put_varint(out, int(v))


def _get_u32_array(body: bytes, pos: int, n: int
                   ) -> Tuple[np.ndarray, int]:
    if n > len(body) - pos:
        # every entry costs >= 1 byte, so a count beyond the remaining
        # body is malformed — checked BEFORE the allocation a huge
        # varint count would otherwise trigger
        raise ValueError(f"array count {n} exceeds body")
    arr = np.zeros(n, np.uint32)
    for i in range(n):
        v, pos = wire._get_varint(body, pos)
        if v > 0xFFFFFFFF:
            # ValueError, like wire._decode_vv_py: the decoders map it
            # to ProtocolError -> MSG_ERROR (an unchecked assignment
            # raises OverflowError, which escapes that contract and
            # kills the reader thread instead)
            raise ValueError("counter out of uint32 range")
        arr[i] = v
    return arr, pos


def encode_frontier(req_id: int) -> bytes:
    out = bytearray()
    wire._put_varint(out, req_id)
    return bytes(out)


def decode_frontier(body: bytes) -> int:
    try:
        req_id, pos = wire._get_varint(body, 0)
    except ValueError as err:
        raise ProtocolError(str(err)) from err
    if pos != len(body):
        raise ProtocolError("trailing bytes after FRONTIER")
    return req_id


def encode_frontier_reply(req_id: int, frontier: np.ndarray,
                          processed: np.ndarray,
                          isolated: bool) -> bytes:
    """The shard's GC evidence, both halves the aggregation needs:
    ``frontier`` is its local provable causal-stability vector
    (``Node.deletion_frontier`` under its own declared membership —
    zeros when undeclared or healing), ``processed`` its raw applied
    vv (what actor lanes it HOLDS state for), and ``isolated`` whether
    its declared membership is the explicit empty set — the one case
    where ``processed[a] == 0`` proves the shard's whole deployment
    unit holds no lane-``a`` state (with replicas declared, its own vv
    says nothing about what a replica may hold)."""
    frontier = np.asarray(frontier, np.uint32)
    processed = np.asarray(processed, np.uint32)
    if frontier.shape != processed.shape:
        raise ValueError("frontier/processed length mismatch")
    out = bytearray()
    wire._put_varint(out, req_id)
    out.append(_FRONTIER_ISOLATED if isolated else 0)
    wire._put_varint(out, frontier.shape[0])
    _put_u32_array(out, frontier)
    _put_u32_array(out, processed)
    return bytes(out)


def decode_frontier_reply(body: bytes
                          ) -> Tuple[int, np.ndarray, np.ndarray, bool]:
    try:
        req_id, pos = wire._get_varint(body, 0)
        if pos >= len(body):
            raise ProtocolError("truncated FRONTIER_REPLY body")
        flags = body[pos]
        pos += 1
        a, pos = wire._get_varint(body, pos)
        frontier, pos = _get_u32_array(body, pos, a)
        processed, pos = _get_u32_array(body, pos, a)
    except ValueError as err:
        raise ProtocolError(str(err)) from err
    if pos != len(body):
        raise ProtocolError("trailing bytes after FRONTIER_REPLY")
    return req_id, frontier, processed, bool(flags & _FRONTIER_ISOLATED)


def encode_gc(req_id: int, frontier: np.ndarray) -> bytes:
    frontier = np.asarray(frontier, np.uint32)
    out = bytearray()
    wire._put_varint(out, req_id)
    wire._put_varint(out, frontier.shape[0])
    _put_u32_array(out, frontier)
    return bytes(out)


def decode_gc(body: bytes) -> Tuple[int, np.ndarray]:
    try:
        req_id, pos = wire._get_varint(body, 0)
        a, pos = wire._get_varint(body, pos)
        frontier, pos = _get_u32_array(body, pos, a)
    except ValueError as err:
        raise ProtocolError(str(err)) from err
    if pos != len(body):
        raise ProtocolError("trailing bytes after GC")
    return req_id, frontier


def encode_gc_reply(req_id: int, dropped: int, remaining: int) -> bytes:
    out = bytearray()
    wire._put_varint(out, req_id)
    wire._put_varint(out, max(0, int(dropped)))
    wire._put_varint(out, max(0, int(remaining)))
    return bytes(out)


def decode_gc_reply(body: bytes) -> Tuple[int, int, int]:
    try:
        req_id, pos = wire._get_varint(body, 0)
        dropped, pos = wire._get_varint(body, pos)
        remaining, pos = wire._get_varint(body, pos)
    except ValueError as err:
        raise ProtocolError(str(err)) from err
    if pos != len(body):
        raise ProtocolError("trailing bytes after GC_REPLY")
    return req_id, dropped, remaining


def encode_dsum(req_id: int) -> bytes:
    out = bytearray()
    wire._put_varint(out, req_id)
    return bytes(out)


def decode_dsum(body: bytes) -> int:
    try:
        req_id, pos = wire._get_varint(body, 0)
    except ValueError as err:
        raise ProtocolError(str(err)) from err
    if pos != len(body):
        raise ProtocolError("trailing bytes after DSUM")
    return req_id


def encode_dsum_reply(req_id: int, summary: bytes) -> bytes:
    """``summary`` is a ``net/digestsync.py`` summary body — opaque to
    this dialect (the router compares it byte-for-byte as a cache key;
    only digest-sync peers ever parse one)."""
    out = bytearray()
    wire._put_varint(out, req_id)
    return bytes(out) + summary


def decode_dsum_reply(body: bytes) -> Tuple[int, bytes]:
    try:
        req_id, pos = wire._get_varint(body, 0)
    except ValueError as err:
        raise ProtocolError(str(err)) from err
    if pos >= len(body):
        raise ProtocolError("empty DSUM_REPLY summary")
    return req_id, body[pos:]


# -- router HA: epoch announce + committed-ring tail (DESIGN.md §22) --------


def encode_ring_sync(req_id: int, epoch: int, router_id: str) -> bytes:
    """``epoch`` is the caller's claimed router epoch (0 = pure read,
    no claim — the standby's tail poll); ``router_id`` identifies the
    claimant in the adjudicator's persisted record and its logs."""
    if epoch < 0:
        raise ValueError(f"router epoch must be >= 0, got {epoch}")
    out = bytearray()
    wire._put_varint(out, req_id)
    wire._put_varint(out, int(epoch))
    _put_str(out, router_id)
    return bytes(out)


def decode_ring_sync(body: bytes) -> Tuple[int, int, str]:
    try:
        req_id, pos = wire._get_varint(body, 0)
        epoch, pos = wire._get_varint(body, pos)
        router_id, pos = _get_str(body, pos)
    except ValueError as err:
        raise ProtocolError(str(err)) from err
    if pos != len(body):
        raise ProtocolError("trailing bytes after RING_SYNC")
    return req_id, epoch, router_id


def encode_ring_sync_reply(req_id: int, record: dict) -> bytes:
    """``record`` is the responder's routing/epoch record as JSON: a
    router replies its committed RouteState (``generation``,
    ``digest``, ``shards`` with addresses, ``seed``, ``elements``,
    ``epoch`` of the handoff machine) plus ``router_epoch``; a shard
    frontend replies just ``router_epoch`` (the highest it has
    adjudicated) — the standby's tail and the fence acknowledgment
    share one reply shape."""
    import json

    out = bytearray()
    wire._put_varint(out, req_id)
    return bytes(out) + json.dumps(record).encode("utf-8")


def decode_ring_sync_reply(body: bytes) -> Tuple[int, dict]:
    import json

    try:
        req_id, pos = wire._get_varint(body, 0)
        record = json.loads(body[pos:].decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as err:
        raise ProtocolError(str(err)) from err
    if not isinstance(record, dict):
        raise ProtocolError("RING_SYNC_REPLY record is not a JSON object")
    return req_id, record


# -- shard replication: WAL tail + keyspace failover (DESIGN.md §23) --------

# WAL_SYNC request flags
WAL_SYNC_CATCHUP = 0x01   # body tail is the standby's digest summary
# WAL_SYNC_REPLY flags
WAL_TRUNCATED = 0x01      # cursor below the retained minimum: catch up
WAL_CATCHUP_PAYLOAD = 0x02  # body tail is a digest-sync payload body


class WalSyncReply(NamedTuple):
    """One decoded WAL_SYNC reply (the field story is the module-level
    MSG_WAL_SYNC comment's)."""

    req_id: int
    flags: int
    shard_epoch: int
    shard_id: str
    nonce: str          # primary WAL-instance nonce: a restart resets
    #                     record numbering, so a cursor only means
    #                     anything against the nonce it was minted under
    min_seq: int        # oldest retained record seq
    next_seq: int       # the cursor to poll with next
    first_seq: int      # seq of records[0] (== next_seq - len(records))
    records: Tuple[bytes, ...]
    payload: Optional[bytes]  # digest-sync catch-up payload body


def encode_wal_sync(req_id: int, from_seq: int, epoch: int,
                    standby_id: str, wait_ms: int = 0,
                    max_records: int = 0,
                    summary: Optional[bytes] = None) -> bytes:
    """``from_seq`` is the tail cursor AND the ack: the standby has
    durably applied every record below it.  ``epoch`` is a shard-epoch
    claim (0 = pure read — the normal tail poll); a promoting standby
    sends its bumped epoch as the deposition notice.  ``wait_ms`` asks
    the primary to long-poll that long when no record is ready;
    ``max_records`` bounds the reply batch (0 = server default).
    ``summary`` flips the request into the catch-up form: the tail is
    the standby's digest summary and the reply carries the O(diff)
    payload instead of records."""
    if from_seq < 1:
        raise ValueError(f"from_seq must be >= 1, got {from_seq}")
    if epoch < 0:
        raise ValueError(f"shard epoch must be >= 0, got {epoch}")
    if summary is not None and len(summary) == 0:
        raise ValueError("empty catch-up summary")
    out = bytearray()
    wire._put_varint(out, req_id)
    out.append(WAL_SYNC_CATCHUP if summary is not None else 0)
    wire._put_varint(out, int(epoch))
    _put_str(out, standby_id)
    wire._put_varint(out, int(from_seq))
    wire._put_varint(out, max(0, int(wait_ms)))
    wire._put_varint(out, max(0, int(max_records)))
    return bytes(out) + (summary if summary is not None else b"")


def decode_wal_sync(body: bytes) -> Tuple[int, int, str, int, int, int,
                                          Optional[bytes]]:
    """Returns ``(req_id, epoch, standby_id, from_seq, wait_ms,
    max_records, summary)`` — ``summary`` is None for a plain tail
    poll, the opaque digest-summary bytes for a catch-up request."""
    try:
        req_id, pos = wire._get_varint(body, 0)
        if pos >= len(body):
            raise ProtocolError("truncated WAL_SYNC body")
        flags = body[pos]
        pos += 1
        epoch, pos = wire._get_varint(body, pos)
        standby_id, pos = _get_str(body, pos)
        from_seq, pos = wire._get_varint(body, pos)
        if from_seq < 1:
            raise ProtocolError(f"WAL_SYNC from_seq {from_seq} < 1")
        wait_ms, pos = wire._get_varint(body, pos)
        max_records, pos = wire._get_varint(body, pos)
    except ValueError as err:
        raise ProtocolError(str(err)) from err
    summary: Optional[bytes] = None
    if flags & WAL_SYNC_CATCHUP:
        if pos >= len(body):
            raise ProtocolError("empty WAL_SYNC catch-up summary")
        summary = body[pos:]
    elif pos != len(body):
        raise ProtocolError("trailing bytes after WAL_SYNC")
    return req_id, epoch, standby_id, from_seq, wait_ms, max_records, \
        summary


def encode_wal_sync_reply(req_id: int, flags: int, shard_epoch: int,
                          shard_id: str, nonce: str, min_seq: int,
                          next_seq: int, first_seq: int,
                          records: Sequence[bytes],
                          payload: Optional[bytes] = None) -> bytes:
    if payload is not None:
        flags |= WAL_CATCHUP_PAYLOAD
        if len(payload) == 0:
            raise ValueError("empty catch-up payload")
        if records:
            raise ValueError("a reply carries records OR a catch-up "
                             "payload, never both (the opaque tail is "
                             "the payload's)")
    out = bytearray()
    wire._put_varint(out, req_id)
    out.append(flags & 0xFF)
    wire._put_varint(out, max(0, int(shard_epoch)))
    _put_str(out, shard_id)
    _put_str(out, nonce)
    wire._put_varint(out, max(0, int(min_seq)))
    wire._put_varint(out, max(0, int(next_seq)))
    wire._put_varint(out, max(0, int(first_seq)))
    wire._put_varint(out, len(records))
    for rec in records:
        wire._put_varint(out, len(rec))
        out.extend(rec)
    return bytes(out) + (payload if payload is not None else b"")


def decode_wal_sync_reply(body: bytes) -> WalSyncReply:
    try:
        req_id, pos = wire._get_varint(body, 0)
        if pos >= len(body):
            raise ProtocolError("truncated WAL_SYNC_REPLY body")
        flags = body[pos]
        pos += 1
        shard_epoch, pos = wire._get_varint(body, pos)
        shard_id, pos = _get_str(body, pos)
        nonce, pos = _get_str(body, pos)
        min_seq, pos = wire._get_varint(body, pos)
        next_seq, pos = wire._get_varint(body, pos)
        first_seq, pos = wire._get_varint(body, pos)
        n, pos = wire._get_varint(body, pos)
        if n > len(body) - pos:
            # every record costs >= 1 length byte: checked BEFORE any
            # allocation a hostile count could trigger
            raise ProtocolError(f"record count {n} exceeds body")
        records = []
        for _ in range(n):
            ln, pos = wire._get_varint(body, pos)
            if pos + ln > len(body):
                raise ProtocolError("truncated WAL_SYNC_REPLY record")
            records.append(body[pos:pos + ln])
            pos += ln
    except ValueError as err:
        raise ProtocolError(str(err)) from err
    payload: Optional[bytes] = None
    if flags & WAL_CATCHUP_PAYLOAD:
        if pos >= len(body):
            raise ProtocolError("empty WAL_SYNC_REPLY catch-up payload")
        payload = body[pos:]
    elif pos != len(body):
        raise ProtocolError("trailing bytes after WAL_SYNC_REPLY")
    return WalSyncReply(req_id, flags, shard_epoch, shard_id, nonce,
                        min_seq, next_seq, first_seq, tuple(records),
                        payload)


def encode_shard_failover(req_id: int, epoch: int, sid: str,
                          owner_id: str, addr: Tuple[str, int]) -> bytes:
    """The promoted standby's keyspace claim at the router (module-
    level MSG_SHARD_FAILOVER comment): adopt ``addr`` as shard
    ``sid``'s downstream under shard epoch ``epoch``.  Also the
    resurrection probe: a restarting member announces its OWN epoch
    and address — an echo of the already-adjudicated state is
    idempotent-ok, a stale epoch replies typed."""
    if epoch < 1:
        raise ValueError(f"a failover claim needs an epoch >= 1, "
                         f"got {epoch}")
    if not sid:
        raise ValueError("empty shard id")
    out = bytearray()
    wire._put_varint(out, req_id)
    wire._put_varint(out, int(epoch))
    _put_str(out, sid)
    _put_str(out, owner_id)
    _put_str(out, addr[0])
    wire._put_varint(out, int(addr[1]))
    return bytes(out)


def decode_shard_failover(body: bytes
                          ) -> Tuple[int, int, str, str,
                                     Tuple[str, int]]:
    try:
        req_id, pos = wire._get_varint(body, 0)
        epoch, pos = wire._get_varint(body, pos)
        if epoch < 1:
            raise ProtocolError(f"shard-failover epoch {epoch} < 1")
        sid, pos = _get_str(body, pos)
        if not sid:
            raise ProtocolError("empty shard id in SHARD_FAILOVER")
        owner_id, pos = _get_str(body, pos)
        host, pos = _get_str(body, pos)
        port, pos = wire._get_varint(body, pos)
        if port > 0xFFFF:
            raise ProtocolError(f"port {port} out of range")
    except ValueError as err:
        raise ProtocolError(str(err)) from err
    if pos != len(body):
        raise ProtocolError("trailing bytes after SHARD_FAILOVER")
    return req_id, epoch, sid, owner_id, (host, port)


def encode_shard_failover_reply(req_id: int, record: dict) -> bytes:
    """``record`` is the router's adjudication as JSON: the sid's
    durable shard epoch after this claim, whether the downstream
    address swapped, and the active address — the promoted standby's
    confirmation and the soak's audit record share one shape."""
    import json

    out = bytearray()
    wire._put_varint(out, req_id)
    return bytes(out) + json.dumps(record).encode("utf-8")


def decode_shard_failover_reply(body: bytes) -> Tuple[int, dict]:
    import json

    try:
        req_id, pos = wire._get_varint(body, 0)
        record = json.loads(body[pos:].decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as err:
        raise ProtocolError(str(err)) from err
    if not isinstance(record, dict):
        raise ProtocolError(
            "SHARD_FAILOVER_REPLY record is not a JSON object")
    return req_id, record


def decode_members(body: bytes) -> Tuple[int, List[int], np.ndarray]:
    """Self-describing (carries its own lengths): the client needs no
    out-of-band universe/actor-axis configuration to read a reply.
    Counts are checked against the remaining body BEFORE any
    allocation and vv entries against uint32 range — the W003 codec
    harness found this decoder shipped without the guards every
    sibling (``_get_u32_array``, ``wire._decode_vv_py``) carries: a
    5-byte varint in a garbled reply raised ``OverflowError`` through
    the client reader thread instead of the typed error."""
    try:
        req_id, pos = wire._get_varint(body, 0)
        n, pos = wire._get_varint(body, pos)
        if n > len(body) - pos:
            raise ValueError(f"member count {n} exceeds body")
        members = []
        for _ in range(n):
            e, pos = wire._get_varint(body, pos)
            members.append(e)
        a, pos = wire._get_varint(body, pos)
        vv, pos = _get_u32_array(body, pos, a)
    except ValueError as err:
        raise ProtocolError(str(err)) from err
    if pos != len(body):
        raise ProtocolError("trailing bytes after MEMBERS")
    return req_id, members, vv
