"""One client connection's write half: a bounded outbound queue drained
by the session's OWN writer thread.

A session's replies come from several threads — its reader (immediate
rejects, QUERY replies), the batcher (acks after the group commit), and
in the router tier every downstream shard link's relay thread — so
``send()`` only ENQUEUES: it appends the frame to a bounded per-session
queue and returns immediately, and a dedicated writer thread drains the
queue onto the socket in FIFO order.  The callers that used to pay a
stalled client's socket stall (one ``SEND_TIMEOUT_S`` each, SERIALIZED
through the single batcher thread — the pre-refactor shape ROADMAP's
serve-path ladder called out) now pay an O(1) append: a read-stalled
client wedges only its own writer thread.

The failure ladder for a client that stops reading its replies: first
its TCP window fills, then the writer blocks up to ``SEND_TIMEOUT_S``
per frame, meanwhile the queue absorbs up to ``QUEUE_DEPTH`` frames —
and when the queue is full too, the session flips closed (the stalled
client is shed; ops it had in flight are already durable, it re-learns
outcomes via idempotent resubmit).  Every transport failure closes the
session the same way: replies to a dead client are dropped, not
retried.

The write half is a ``dup()`` of the connection with its OWN short
timeout: socket timeouts are per-object, so the reader's whole-frame
idle deadline and the writer's per-frame send bound never race over
one setting.  ``close(flush_timeout_s=...)`` gives the writer a bounded
window to drain already-queued replies first — the graceful-drain path
uses it so the last batch's acks are not torn off by teardown.
"""

from __future__ import annotations

import socket
import threading
from collections import deque
from typing import Deque, Tuple

from go_crdt_playground_tpu_torch.net import framing


class Session:
    """Bounded-queue, failure-absorbing frame writer over one client
    socket (one writer thread per session)."""

    # per-frame send bound for the writer thread: only a reader stalled
    # long enough to fill its ~64KB kernel window of unread replies
    # ever trips this — and it costs THIS session's writer, nobody else
    SEND_TIMEOUT_S = 0.25
    # outbound frames buffered while the transport is slow; reply
    # frames are tiny (a few varints), so this bounds per-session
    # memory at a few KB while absorbing ack bursts from whole batches
    QUEUE_DEPTH = 1024

    def __init__(self, conn: socket.socket, peer: str = "?",
                 send_timeout_s: float = SEND_TIMEOUT_S,
                 queue_depth: int = QUEUE_DEPTH):
        self._conn = conn
        self._wconn = conn.dup()  # independent timeout for the writer
        self._wconn.settimeout(send_timeout_s)
        self.peer = peer
        # the router epoch this connection ANNOUNCED via RING_SYNC
        # (DESIGN.md §22), 0 = never announced.  Admin-plane verbs on a
        # shard frontend adjudicate it against the highest epoch the
        # frontend has ever seen — the deposed-router fence.
        # race-ok: written and read only on this connection's single
        # reader thread (the dispatch callback runs there)
        self.router_epoch = 0
        self._cond = threading.Condition()
        self._queue: Deque[Tuple[int, bytes]] = deque()  # guarded-by: _cond
        self._depth = queue_depth
        self._closed = False  # guarded-by: _cond
        # a frame popped but not yet on the wire: close(flush=...) must
        # wait it out too, or the last ack of a drain gets torn off
        self._inflight = False  # guarded-by: _cond
        self._writer = threading.Thread(
            target=self._write_loop, name=f"session-writer-{peer}",
            daemon=True)
        self._writer.start()

    def send(self, msg_type: int, body: bytes) -> bool:
        """Queue one frame for the writer; False if the session is (now)
        closed — including the full-queue shed, which CLOSES the session
        rather than dropping one frame silently (a reply stream with a
        hole would un-resolve a pipelined client's op forever; a torn
        connection resolves them all as ConnectionError, which the
        client already handles by resubmitting)."""
        with self._cond:
            if self._closed:
                return False
            if len(self._queue) >= self._depth:
                self._close_locked()
                return False
            self._queue.append((msg_type, body))
            self._cond.notify()
            return True

    # -- writer thread ------------------------------------------------------

    def _write_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if self._closed:
                    return
                msg_type, body = self._queue.popleft()
                self._inflight = True
            try:
                # outside the lock: a blocked sendall must not block
                # send() callers — they have the queue
                framing.send_frame(self._wconn, msg_type, body)
            except OSError:
                with self._cond:
                    self._inflight = False
                self.close()
                return
            with self._cond:
                self._inflight = False
                if not self._queue:
                    self._cond.notify_all()  # wake a close() flush wait

    # requires-lock: _cond
    def _close_locked(self) -> None:
        self._closed = True
        self._queue.clear()
        self._cond.notify_all()  # writer exits; flush waiters give up
        # shutdown BEFORE close: the connection's reader thread may be
        # blocked in recv() and does not reliably wake on a bare
        # close() (it can sit out the idle timeout)
        try:
            self._conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        for s in (self._wconn, self._conn):
            try:
                s.close()
            except OSError:
                pass

    def close(self, flush_timeout_s: float = 0.0) -> None:
        """Close the session; with ``flush_timeout_s`` > 0, first give
        the writer that long to drain already-queued replies (graceful
        drain — every queued ack gets its chance onto the wire)."""
        with self._cond:
            if self._closed:
                return
            if flush_timeout_s > 0:
                self._cond.wait_for(
                    lambda: (not self._queue and not self._inflight)
                    or self._closed,
                    timeout=flush_timeout_s)
            if not self._closed:
                self._close_locked()

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def queued(self) -> int:
        """Outbound frames not yet on the wire (tests/metrics)."""
        with self._cond:
            return len(self._queue)
