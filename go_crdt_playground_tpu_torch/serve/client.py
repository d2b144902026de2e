"""Pipelined client for the op-ingest frontend.

One connection, many in-flight ops: ``submit_async`` assigns a
connection-scoped request id and returns a ``PendingOp`` immediately; a
background reader thread matches ACK/REJECT frames back by id, stamps
the latency, and resolves the handle.  The synchronous ``add`` /
``delete`` / ``members`` helpers are one submit + wait.  Rejects raise
the typed ``serve.protocol`` exceptions (``Overloaded``,
``DeadlineExceeded``, ``Draining``, ``InvalidOp``), so a load generator
can count shed classes without string matching.

An op the server never answered (connection died, server killed) is
UNRESOLVED, not acked — ``PendingOp.wait`` raises ``ConnectionError``
for it.  The protocol is deliberately at-least-once: ops are idempotent
CRDT mutations, so the client-side retry for an ambiguous outcome is a
plain resubmit.

**Router-HA failover (DESIGN.md §22).**  ``addr`` may be an ORDERED
LIST of addresses — a primary router and its warm standby(s).  The
client serves through one connection at a time; when that connection
dies it rotates to the next address on the next attempt (wrapping, so
a recovered primary is retried too).  The failover contract is typed
and idempotence-aware:

* **in-flight OPs** whose ack died with the old router resolve with the
  typed ``AmbiguousOp`` (a ``ConnectionError`` subclass): the outcome
  is UNKNOWN — the op may be durably applied behind the dead ack.
  They are NEVER silently resent: the caller's ledger decides to
  resubmit (idempotent), which is what keeps the zero-phantom
  invariant adjudicable.
* **idempotence-safe reads** (QUERY/STATS/DSUM/RING_SYNC) retry
  transparently on the successor address — a dashboard or autopilot
  poll rides through a failover without seeing it.
* **non-idempotent verbs** (OP submit, RESHARD, SLICE_*, GC/FRONTIER)
  stay single-shot per call; only the NEXT call dials the successor.

A single-address client behaves exactly as before: its reader's death
flips ``closed`` and every later submit fails fast (the connection-pool
sweep contract ``shard/router._ShardLink`` relies on).
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from go_crdt_playground_tpu_torch.net import framing
from go_crdt_playground_tpu_torch.serve import protocol

Addr = Tuple[str, int]


class AmbiguousOp(ConnectionError):
    """An in-flight op's connection died before its ack/reject arrived
    (router failover, SIGKILL): the outcome is UNKNOWN — the op may be
    durably applied on its shard behind the dead reply stream.  Typed
    so a ledgered workload can count ambiguity separately from true
    unresolved transport loss, then resubmit idempotently.  Subclasses
    ``ConnectionError`` on purpose: every pre-HA call site that treated
    connection death as resubmit-and-continue keeps doing so."""


def _is_multi_addr(addr) -> bool:
    """A (host, port) pair vs a sequence of them: the pair's first
    element is a string, an address list's first element is not."""
    return (isinstance(addr, (list, tuple)) and len(addr) > 0
            and not isinstance(addr[0], str))


def normalize_addrs(addr) -> List[Addr]:
    """One (host, port) pair — or an ordered failover sequence of them
    — as a normalized list.  THE address-shape heuristic for every HA
    surface (this client, the actuator, the autopilot): one place to
    change what counts as a list."""
    if _is_multi_addr(addr):
        out = [(a[0], int(a[1])) for a in addr]
    else:
        out = [(addr[0], int(addr[1]))]
    if not out:
        raise ValueError("at least one address is required")
    return out


class PendingOp:
    """One in-flight op's resolution slot."""

    __slots__ = ("req_id", "t_sent", "_event", "_error", "latency_s")

    def __init__(self, req_id: int, t_sent: float):
        self.req_id = req_id
        self.t_sent = t_sent
        self._event = threading.Event()
        self._error: Optional[BaseException] = None
        self.latency_s: Optional[float] = None

    def _resolve(self, error: Optional[BaseException],
                 latency_s: Optional[float]) -> None:
        self._error = error
        self.latency_s = latency_s
        self._event.set()

    def wait(self, timeout: Optional[float] = None) -> float:
        """Block until acked/rejected; returns the measured latency.
        Raises the typed reject, or ``ConnectionError`` if the server
        went away without answering (outcome UNKNOWN — resubmit)."""
        if not self._event.wait(timeout):
            raise socket.timeout(f"op {self.req_id}: no reply")
        if self._error is not None:
            raise self._error
        return self.latency_s if self.latency_s is not None else 0.0

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def acked(self) -> bool:
        return self._event.is_set() and self._error is None

    @property
    def error(self) -> Optional[BaseException]:
        """The typed reject (or transport failure) that resolved this
        op, None if acked/pending — load generators classify shed
        classes from this without catching."""
        return self._error


class ServeClient:
    """One pipelined connection to a ``ServeFrontend`` (or, with an
    ordered address list, to whichever of a router HA pair is
    currently serving — module docstring)."""

    # explicit reply-body cap (W004 frame-cap discipline): the largest
    # legal reply is a SLICE_STATE payload, which scales with the
    # universe the client does not know — 64MB covers a dense slice of
    # an ~E=3M universe with slack, while a garbled/hostile length
    # header can no longer commit the reader thread to buffering the
    # codec's 1GB ceiling (pre-fix, this was the ONLY serve-dialect
    # endpoint reading frames with no cap at all)
    MAX_REPLY_BODY = 64 << 20

    def __init__(self, addr: Union[Addr, Sequence[Addr]],
                 timeout: float = 30.0,
                 on_result: Optional[Callable[[PendingOp], None]] = None,
                 connect_timeout: Optional[float] = None,
                 max_reply_body: Optional[int] = None):
        """``connect_timeout`` bounds the DIAL separately from the
        reply ``timeout`` (a router probing a blackholed shard needs a
        short dial bound without shortening reply waits).
        ``max_reply_body`` overrides ``MAX_REPLY_BODY`` for
        deployments whose slice replies outgrow the default (the cap
        is a DoS bound, not a protocol limit — size it to the
        universe like the server side's per-verb caps)."""
        self.timeout = timeout
        self.max_reply_body = (self.MAX_REPLY_BODY
                               if max_reply_body is None
                               else int(max_reply_body))
        self._on_result = on_result
        self.addrs: List[Addr] = normalize_addrs(addr)
        self._connect_timeout = (timeout if connect_timeout is None
                                 else connect_timeout)
        self._wlock = threading.Lock()
        self._lock = threading.Lock()
        # serializes (re)connect attempts so two stalled callers cannot
        # dial two sockets for one logical connection; never held while
        # _lock is held (the order is _dial_lock -> _lock)
        self._dial_lock = threading.Lock()
        self._pending: dict = {}  # guarded-by: _lock
        self._next_id = 0  # guarded-by: _lock
        self._replies: dict = {}  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        self._user_closed = False  # guarded-by: _lock
        self._sock: Optional[socket.socket] = None  # guarded-by: _lock
        self._gen = 0  # guarded-by: _lock
        self._active = 0  # guarded-by: _lock
        self._next_dial = 0  # guarded-by: _lock
        self._rotations = 0  # guarded-by: _lock
        self._reader: Optional[threading.Thread] = None  # guarded-by: _lock
        self._ensure_conn()

    @property
    def closed(self) -> bool:
        """True once this client can never serve again: the user closed
        it, or — single-address clients only — its reader exited
        (server gone, idle timeout).  A connection POOL
        (shard/router._ShardLink) polls this to sweep-and-redial a
        client that died of read-idle instead of paying one doomed
        request to find out.  A multi-address (HA) client reconnects
        instead of flipping closed."""
        with self._lock:
            return self._closed

    @property
    def active_addr(self) -> Addr:
        """The address of the connection currently (last) serving —
        which member of an HA pair this client is actually talking to."""
        with self._lock:
            return self.addrs[self._active]

    @property
    def rotations(self) -> int:
        """How many times this client failed over to a different
        address (0 for the single-address case by construction)."""
        with self._lock:
            return self._rotations

    # -- connection management ----------------------------------------------

    def _ensure_conn(self) -> None:
        """Connect if disconnected, rotating through the address list
        starting at the failover candidate.  Raises ``ConnectionError``
        when no address answers (the caller retries later)."""
        with self._lock:
            if self._closed:
                raise ConnectionError("client closed")
            if self._sock is not None:
                return
        with self._dial_lock:
            with self._lock:
                if self._closed:
                    raise ConnectionError("client closed")
                if self._sock is not None:
                    return
                start = self._next_dial
            n = len(self.addrs)
            last: Optional[BaseException] = None
            for i in range(n):
                idx = (start + i) % n
                try:
                    sock = socket.create_connection(
                        self.addrs[idx], timeout=self._connect_timeout)
                except OSError as e:
                    last = e
                    continue
                sock.settimeout(self.timeout)
                reader = None
                with self._lock:
                    if self._closed:
                        # close() raced the dial: never leak the socket
                        try:
                            sock.close()
                        except OSError:
                            pass
                        raise ConnectionError("client closed")
                    self._gen += 1
                    gen = self._gen
                    self._sock = sock
                    if idx != self._active and self._gen > 1:
                        self._rotations += 1
                    self._active = idx
                    self._next_dial = idx
                    reader = threading.Thread(
                        target=self._read_loop, args=(sock, gen),
                        name="serve-client-reader", daemon=True)
                    self._reader = reader
                reader.start()
                return
            raise ConnectionError(
                f"no reachable address in {self.addrs}: {last}")

    # -- submit path --------------------------------------------------------

    def submit_async(self, kind: int, elements: Sequence[int],
                     deadline_s: Optional[float] = None) -> PendingOp:
        self._ensure_conn()
        with self._lock:
            if self._closed:
                raise ConnectionError("client closed")
            sock = self._sock
            if sock is None:
                raise ConnectionError(
                    "client disconnected (failover dial pending)")
            self._next_id += 1
            req_id = self._next_id
            op = PendingOp(req_id, time.monotonic())
            self._pending[req_id] = op
        deadline_us = int(deadline_s * 1e6) if deadline_s else 0
        body = protocol.encode_op(req_id, kind, elements, deadline_us)
        try:
            with self._wlock:
                framing.send_frame(sock, protocol.MSG_OP, body)
        except OSError as e:
            # ownership handshake with the read loop's death sweep: if
            # the sweep already popped this op it also resolved it and
            # fired on_result — return the resolved op so the caller
            # counts it exactly once (raising too would double-count);
            # if we still own it, resolve quietly and raise.
            with self._lock:
                owned = self._pending.pop(req_id, None) is not None
            if not owned:
                return op
            op._resolve(ConnectionError(f"send failed: {e}"), None)
            raise
        return op

    def add(self, *elements: int,
            deadline_s: Optional[float] = None) -> float:
        """Submit one Add(k...) op and wait for its durable ack; returns
        the measured latency.  Raises the typed rejects."""
        return self.submit_async(protocol.OP_ADD, elements,
                                 deadline_s).wait(self.timeout)

    def delete(self, *elements: int,
               deadline_s: Optional[float] = None) -> float:
        return self.submit_async(protocol.OP_DEL, elements,
                                 deadline_s).wait(self.timeout)

    def _request_reply(self, msg_type: int, encode,
                       timeout: Optional[float] = None,
                       idempotent: bool = False) -> object:
        """One synchronous request.  ``idempotent`` requests (reads:
        QUERY/STATS/DSUM/RING_SYNC) retry transparently across the
        address list on TRANSPORT failure — typed ServeError rejects
        always propagate.  Non-idempotent verbs stay single-shot."""
        attempts = len(self.addrs) if idempotent else 1
        last: Optional[BaseException] = None
        for attempt in range(attempts):
            try:
                return self._request_reply_once(msg_type, encode, timeout)
            except protocol.ServeError:
                raise
            except (OSError, ConnectionError) as e:
                # socket.timeout and ConnectionError are OSError
                # subclasses; framing.RemoteError is NOT (a server
                # really answered — never retried blind)
                last = e
                if attempt + 1 >= attempts:
                    raise
        raise ConnectionError(f"request failed on every address: {last}")

    def _request_reply_once(self, msg_type: int, encode,
                            timeout: Optional[float] = None) -> object:
        self._ensure_conn()
        with self._lock:
            if self._closed:
                raise ConnectionError("client closed")
            sock = self._sock
            if sock is None:
                raise ConnectionError(
                    "client disconnected (failover dial pending)")
            self._next_id += 1
            req_id = self._next_id
            op = PendingOp(req_id, time.monotonic())
            self._pending[req_id] = op
        try:
            with self._wlock:
                framing.send_frame(sock, msg_type, encode(req_id))
        except OSError:
            # a failed send must not leave the entry pending (the read
            # loop would later resolve it as a phantom failure on top
            # of the raised error); if the death sweep popped it first
            # it owns the resolution — just don't double-resolve
            with self._lock:
                owned = self._pending.pop(req_id, None) is not None
            if owned:
                op._resolve(ConnectionError("send failed"), None)
            raise
        try:
            op.wait(self.timeout if timeout is None else timeout)
        except BaseException:
            # abandoned waiter: drop our entries so a LATE reply can't
            # strand a decoded snapshot in _replies forever (_finish
            # drops the other half of the race)
            with self._lock:
                self._pending.pop(req_id, None)
                self._replies.pop(req_id, None)
            raise
        with self._lock:
            # None for ack-only replies (e.g. a SLICE_PUSH answered by
            # a plain ACK): resolution without a stored body
            return self._replies.pop(req_id, None)

    def members(self) -> Tuple[List[int], np.ndarray]:
        """Read back the replica's live element ids + vv."""
        return self._request_reply(protocol.MSG_QUERY,
                                   protocol.encode_query,
                                   idempotent=True)

    def stats(self) -> dict:
        """The frontend's SLO read-out: its ``obs.Recorder.snapshot()``
        (serve.ingest_latency_s p50/p95/p99, shed counters, batch
        occupancy, queue depth) — what dashboards and the serve soak
        both consume."""
        return self._request_reply(protocol.MSG_STATS,
                                   protocol.encode_stats,
                                   idempotent=True)

    def digest_summary(self) -> bytes:
        """The replica's digest summary body (opaque bytes): the
        O(E/16) freshness key the router's member cache compares
        before deciding whether a full ``members()`` pull is needed."""
        return self._request_reply(protocol.MSG_DSUM,
                                   protocol.encode_dsum,
                                   idempotent=True)

    def ring_sync(self, epoch: int = 0, router_id: str = "") -> dict:
        """The router-HA verb (DESIGN.md §22): with ``epoch == 0`` a
        pure read of the responder's routing/epoch record (the
        standby's tail poll); with ``epoch > 0`` an epoch ANNOUNCEMENT
        the responder adjudicates — a stale claim raises the typed
        ``StaleRouterEpoch``.  Announcing the same epoch twice is
        idempotent, so the call retries across an HA address list."""
        return self._request_reply(
            protocol.MSG_RING_SYNC,
            lambda rid: protocol.encode_ring_sync(rid, epoch, router_id),
            idempotent=True)

    def wal_sync(self, from_seq: int, *, epoch: int = 0,
                 standby_id: str = "", wait_ms: int = 0,
                 max_records: int = 0,
                 summary: Optional[bytes] = None
                 ) -> "protocol.WalSyncReply":
        """The shard-replication tail verb (DESIGN.md §23): poll the
        primary's committed WAL records from ``from_seq`` (which also
        ACKS everything below it), or — with ``summary`` — request the
        O(diff) digest catch-up.  ``epoch > 0`` is a shard-epoch claim
        (the promoting standby's deposition notice); announcing the
        same epoch twice is idempotent, and the read itself is pure,
        so the call retries across an HA address list.  A reply
        timeout must cover ``wait_ms`` (the server long-polls that
        long before answering empty)."""
        return self._request_reply(
            protocol.MSG_WAL_SYNC,
            lambda rid: protocol.encode_wal_sync(
                rid, from_seq, epoch, standby_id, wait_ms, max_records,
                summary),
            timeout=(self.timeout + wait_ms / 1e3 if wait_ms else None),
            idempotent=True)

    def shard_failover(self, epoch: int, sid: str, owner_id: str,
                       addr: Addr) -> dict:
        """The keyspace-failover claim at the router (DESIGN.md §23):
        adjudicate ``epoch`` for shard ``sid`` and swap its downstream
        address to ``addr``.  Idempotent by construction (re-claiming
        the adjudicated state echoes it), so the promoted standby's
        announce retries across an ordered router HA list; a stale
        claim raises the typed ``StaleShardEpoch``."""
        return self._request_reply(
            protocol.MSG_SHARD_FAILOVER,
            lambda rid: protocol.encode_shard_failover(
                rid, epoch, sid, owner_id, addr),
            idempotent=True)

    # -- fleet-aware GC (router aggregation, DESIGN.md §17) -----------------

    def frontier(self) -> Tuple[np.ndarray, np.ndarray, bool]:
        """Read the shard's GC evidence: ``(frontier, processed,
        isolated)`` — its local provable causal-stability vector, its
        raw applied vv, and whether its membership declaration is the
        explicit isolated one (the router's lane-mask input)."""
        return self._request_reply(protocol.MSG_FRONTIER,
                                   protocol.encode_frontier)

    def gc(self, frontier: np.ndarray) -> Tuple[int, int]:
        """Push a fleet frontier for the shard to GC against (clamped
        shard-side to its own provable evidence).  Returns
        ``(dropped, remaining)`` deletion-record lane counts."""
        return self._request_reply(
            protocol.MSG_GC,
            lambda rid: protocol.encode_gc(rid, frontier))

    # -- live resharding (DESIGN.md §18) ------------------------------------

    def slice_pull(self, elements: Sequence[int]) -> bytes:
        """Handoff donor read: the shard's complete state for
        ``elements`` as an opaque anti-entropy payload body."""
        return self._request_reply(
            protocol.MSG_SLICE_PULL,
            lambda rid: protocol.encode_slice_pull(rid, elements))

    def slice_push(self, payload: bytes) -> None:
        """Handoff recipient write: hand a pulled slice payload to its
        new owner; returns once the shard has durably applied it."""
        self._request_reply(
            protocol.MSG_SLICE_PUSH,
            lambda rid: protocol.encode_slice_push(rid, payload))

    def reshard(self, mode: int, sid: str,
                addr: Optional[Tuple[str, int]] = None,
                timeout: Optional[float] = None) -> Tuple[bool, dict]:
        """The router admin verb: drive a live join
        (``protocol.RESHARD_JOIN``, ``addr`` = the new frontend) or
        leave (``protocol.RESHARD_LEAVE``).  Blocks for the WHOLE
        handoff (fence → transfer → swap), so ``timeout`` must be
        sized to the keyspace — and it cannot exceed the client's own
        ``timeout`` (the CONNECTION read deadline: past it the reader
        thread times the idle admin connection out and resolves this
        call as ConnectionError even though the handoff may later
        commit — construct the client with the larger timeout
        instead; refused loudly rather than silently mis-reported).
        Returns ``(ok, detail)``: the handoff accounting on commit,
        the abort reason on failure (the old ring is still serving in
        that case)."""
        if timeout is not None and timeout > self.timeout:
            raise ValueError(
                f"reshard timeout {timeout}s exceeds this client's "
                f"connection timeout {self.timeout}s — the reader "
                "would time the connection out first; construct "
                f"ServeClient(addr, timeout={timeout}) instead")
        return self._request_reply(
            protocol.MSG_RESHARD,
            lambda rid: protocol.encode_reshard(rid, mode, sid, addr),
            timeout=timeout)

    # -- reader -------------------------------------------------------------

    def _read_loop(self, sock: socket.socket, gen: int) -> None:
        err: BaseException = ConnectionError("connection closed")
        try:
            while True:
                msg_type, body = framing.recv_frame(
                    sock, max_body=self.max_reply_body)
                now = time.monotonic()
                if msg_type == protocol.MSG_ACK:
                    req_id = protocol.decode_ack(body)
                    self._finish(req_id, None, now, sock, gen)
                elif msg_type == protocol.MSG_REJECT:
                    req_id, code, reason = protocol.decode_reject(body)
                    exc = protocol.REJECT_EXCEPTIONS[code](reason)
                    self._finish(req_id, exc, now, sock, gen)
                elif msg_type == protocol.MSG_MEMBERS:
                    req_id, members, vv = protocol.decode_members(body)
                    with self._lock:
                        self._replies[req_id] = (members, vv)
                    self._finish(req_id, None, now, sock, gen)
                elif msg_type == protocol.MSG_STATS_REPLY:
                    req_id, snapshot = protocol.decode_stats_reply(body)
                    with self._lock:
                        self._replies[req_id] = snapshot
                    self._finish(req_id, None, now, sock, gen)
                elif msg_type == protocol.MSG_SLICE_STATE:
                    req_id, payload = protocol.decode_slice_state(body)
                    with self._lock:
                        self._replies[req_id] = payload
                    self._finish(req_id, None, now, sock, gen)
                elif msg_type == protocol.MSG_RESHARD_REPLY:
                    req_id, ok, detail = protocol.decode_reshard_reply(body)
                    with self._lock:
                        self._replies[req_id] = (ok, detail)
                    self._finish(req_id, None, now, sock, gen)
                elif msg_type == protocol.MSG_FRONTIER_REPLY:
                    req_id, fr, proc, iso = \
                        protocol.decode_frontier_reply(body)
                    with self._lock:
                        self._replies[req_id] = (fr, proc, iso)
                    self._finish(req_id, None, now, sock, gen)
                elif msg_type == protocol.MSG_GC_REPLY:
                    req_id, dropped, remaining = \
                        protocol.decode_gc_reply(body)
                    with self._lock:
                        self._replies[req_id] = (dropped, remaining)
                    self._finish(req_id, None, now, sock, gen)
                elif msg_type == protocol.MSG_DSUM_REPLY:
                    req_id, summary = protocol.decode_dsum_reply(body)
                    with self._lock:
                        self._replies[req_id] = summary
                    self._finish(req_id, None, now, sock, gen)
                elif msg_type == protocol.MSG_RING_SYNC_REPLY:
                    req_id, record = protocol.decode_ring_sync_reply(body)
                    with self._lock:
                        self._replies[req_id] = record
                    self._finish(req_id, None, now, sock, gen)
                elif msg_type == protocol.MSG_WAL_SYNC_REPLY:
                    reply = protocol.decode_wal_sync_reply(body)
                    with self._lock:
                        self._replies[reply.req_id] = reply
                    self._finish(reply.req_id, None, now, sock, gen)
                elif msg_type == protocol.MSG_SHARD_FAILOVER_REPLY:
                    req_id, record = \
                        protocol.decode_shard_failover_reply(body)
                    with self._lock:
                        self._replies[req_id] = record
                    self._finish(req_id, None, now, sock, gen)
                else:
                    err = framing.ProtocolError(
                        f"unexpected frame type {msg_type}")
                    return
        except (framing.RemoteError, framing.ProtocolError, OSError) as e:
            err = e
        finally:
            # the reader IS the connection's liveness: once it exits
            # (idle timeout, torn connection) later submits could send
            # fine but never resolve.  Single-address clients flip
            # closed so they fail fast; HA clients mark themselves
            # disconnected and aim the next dial at the successor
            # address.  Socket teardown happens inline (close() would
            # join the current thread).
            with self._lock:
                if self._gen != gen:
                    # a racing close()+reconnect superseded this
                    # connection; its pending set is not ours to sweep
                    return
                self._sock = None
                failover = len(self.addrs) > 1 and not self._user_closed
                if failover:
                    self._next_dial = (self._active + 1) % len(self.addrs)
                else:
                    self._closed = True
                dead_addr = self.addrs[self._active]
                pending = list(self._pending.values())
                self._pending.clear()
            try:
                sock.close()
            except OSError:
                pass
            if isinstance(err, framing.RemoteError):
                wrapped: BaseException = err
            elif failover and pending:
                # the typed-ambiguous contract (module docstring): the
                # ops may be durably applied behind the dead ack — the
                # ledger resubmits, the client never resends silently
                wrapped = AmbiguousOp(
                    f"connection to {dead_addr} died with "
                    f"{len(pending)} ops in flight (outcome unknown — "
                    f"resubmit): {err}")
            else:
                wrapped = ConnectionError(f"server went away: {err}")
            for op in pending:
                op._resolve(wrapped, None)
                if self._on_result is not None:
                    # load generators tally through this callback; an op
                    # resolved by connection death must count there too,
                    # or the tally reads "unresolved" for ops that DID
                    # resolve (with an unknown outcome)
                    self._on_result(op)

    def _finish(self, req_id: int, exc: Optional[BaseException],
                now: float, sock: Optional[socket.socket] = None,
                gen: int = -1) -> None:
        rotate_sock = None
        with self._lock:
            op = self._pending.pop(req_id, None)
            if op is None:
                # duplicate/stale reply — a waiter that timed out and
                # cleaned up may have raced our reply store; drop it so
                # abandoned queries can't strand replies forever
                self._replies.pop(req_id, None)
                return
            if (isinstance(exc, protocol.StaleRouterEpoch)
                    and len(self.addrs) > 1 and gen == self._gen):
                # a DEPOSED router answered: it is alive but must not
                # be used — aim the next dial at the successor and
                # tear this connection down so the next attempt
                # rotates (the reject still resolves this op typed;
                # remaining in-flight ops surface typed-ambiguous).
                # Scoped to the connection the reject ARRIVED on (the
                # reader's sock/gen, the same check its death sweep
                # makes): by now self._sock can already be a NEWER
                # dial to the promoted successor, and shutting that
                # down would kill a healthy connection and surface
                # spurious AmbiguousOp for its in-flight ops
                self._next_dial = (self._active + 1) % len(self.addrs)
                rotate_sock = sock
        if rotate_sock is not None:
            try:
                rotate_sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        latency = now - op.t_sent
        op._resolve(exc, None if exc is not None else latency)
        if self._on_result is not None:
            self._on_result(op)

    def close(self) -> None:
        with self._lock:
            if self._user_closed:
                return
            self._user_closed = True
            self._closed = True
            sock, self._sock = self._sock, None
            reader = self._reader
        # shutdown BEFORE close: a reader blocked in recv() does not
        # reliably wake on close() alone (it can sit until the socket
        # timeout); shutdown tears the connection under it immediately
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        if reader is not None:
            reader.join(timeout=5.0)

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
