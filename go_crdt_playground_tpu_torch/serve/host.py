"""Shared TCP host plumbing: listener, accept loop, per-connection
readers, connection slots, session registry.

``ServeFrontend`` and ``ShardRouter`` used to hand-copy this whole
stack from each other — including the subtle shutdown-before-close
listener fix (a bare ``close()`` does not reliably wake a thread
blocked in ``accept()`` on this kernel, and until it wakes the kernel
keeps completing new dials into the backlog, so a "closed" listener
kept accepting).  Accept-path fixes must land ONCE; this module is
that once (the ROADMAP serve-ladder housekeeping rung).

``ConnHost`` owns the transport half of a serve-dialect endpoint:

* a listener + accept thread with the connection-slot cap (at capacity
  new dials are shed, not queued — the ``net/peer.py`` lesson: bounded
  reader-thread growth or a slow-loris client kills the process);
* one daemon reader thread per connection, framing each request and
  handing ``(session, msg_type, body)`` to the owner's ``dispatch``
  callback (return False to end the connection);
* the session registry and the two-phase teardown the graceful drains
  need: ``stop_accepting()`` (shutdown-then-close the listener so new
  dials are REFUSED, not accepted-then-rejected) separate from
  ``close_sessions(flush_timeout_s)`` (one SHARED flush window across
  all sessions, so a herd of stalled clients costs seconds total,
  never sessions x seconds).

The dispatch callback runs on the connection's reader thread and must
be thread-safe; everything it replies with goes through the session's
own bounded writer queue (serve/session.py), so a read-stalled client
can never block another connection's dispatch.
"""

from __future__ import annotations

import socket
import threading
from typing import Callable, List, Optional, Tuple

from go_crdt_playground_tpu_torch.net import framing
from go_crdt_playground_tpu_torch.serve.session import Session

Addr = Tuple[str, int]

# dispatch(session, msg_type, body) -> keep serving this connection?
Dispatch = Callable[[Session, int, bytes], bool]


class ConnHost:
    """Listener + reader plumbing shared by the frontend and router."""

    # a client that connects and sends nothing must release its reader
    # thread eventually; requests themselves are admitted in
    # microseconds
    IDLE_TIMEOUT_S = 60.0
    # every legal serve frame is tiny (a few varints per key); cap the
    # declared body size far below framing's peer-payload limit so an
    # untrusted length header cannot balloon per-connection memory
    MAX_FRAME_BODY = 1 << 20
    # client-connection cap: at capacity new dials are shed, not queued
    MAX_CONNS = 256

    def __init__(self, dispatch: Dispatch, *, recorder=None,
                 counter_prefix: str = "serve",
                 thread_name: str = "conn-host",
                 idle_timeout_s: Optional[float] = None,
                 max_frame_body=None,
                 max_conns: Optional[int] = None):
        # max_frame_body: int, or callable msg_type -> int for dialects
        # whose legal frame sizes differ by verb (framing.recv_frame
        # enforces it before any body byte is buffered)
        self._dispatch = dispatch
        self.recorder = recorder
        self._prefix = counter_prefix
        self._thread_name = thread_name
        self.idle_timeout_s = (self.IDLE_TIMEOUT_S if idle_timeout_s is None
                               else idle_timeout_s)
        self.max_frame_body = (self.MAX_FRAME_BODY if max_frame_body is None
                               else max_frame_body)
        self._conn_slots = threading.BoundedSemaphore(
            self.MAX_CONNS if max_conns is None else max_conns)
        self._lock = threading.Lock()
        self._sessions: set = set()  # guarded-by: _lock
        self._draining = threading.Event()
        # race-ok: listen()/stop_accepting() owner thread; accept loop
        # snapshots
        self._listener: Optional[socket.socket] = None
        # race-ok: listen()/close owner thread only
        self._accept_thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    def listen(self, host: str = "127.0.0.1", port: int = 0) -> Addr:
        if self._listener is not None:
            raise RuntimeError("already listening")
        sock = socket.create_server((host, port))
        self._listener = sock
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"{self._thread_name}-accept",
            daemon=True)
        self._accept_thread.start()
        return sock.getsockname()[:2]

    @property
    def listening(self) -> bool:
        return self._listener is not None

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def stop_accepting(self) -> None:
        """First half of any drain: stop taking dials.  shutdown BEFORE
        close (the session.py lesson, for the LISTENER): a bare close
        does not reliably wake the accept loop blocked in accept(), and
        until it wakes the kernel keeps completing new dials into the
        backlog — "stop accepting dials" must mean refused, not
        accepted-then-rejected."""
        self._draining.set()
        listener = self._listener
        if listener is not None:
            try:
                listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                listener.close()
            except OSError:
                pass
            self._listener = None

    def close_sessions(self, flush_timeout_s: float = 2.0) -> None:
        """Second half of a drain: flush + close every live session
        under ONE shared deadline (a herd of stalled clients costs
        ~flush_timeout_s total, never sessions x that)."""
        import time

        with self._lock:
            sessions = list(self._sessions)
            self._sessions.clear()
        flush_deadline = time.monotonic() + flush_timeout_s
        for s in sessions:
            s.close(flush_timeout_s=max(
                0.0, flush_deadline - time.monotonic()))

    def sessions(self) -> List[Session]:
        with self._lock:
            return list(self._sessions)

    # -- accept / per-connection reader -------------------------------------

    def _accept_loop(self) -> None:
        sock = self._listener  # snapshot: stop_accepting may null it
        assert sock is not None
        while not self._draining.is_set():
            try:
                conn, addr = sock.accept()
            except OSError:
                return  # listener closed
            if not self._conn_slots.acquire(blocking=False):
                self._count(f"{self._prefix}.shed.connections")
                conn.close()  # at capacity: shed the dial, not queue it
                continue
            self._count(f"{self._prefix}.connections")
            session = Session(conn, peer=f"{addr[0]}:{addr[1]}")
            with self._lock:
                self._sessions.add(session)
            # finally-shaped slot handoff (the net/peer.py lesson): ANY
            # failure to start the reader must shed the dial AND return
            # the slot, else capacity decays one leak at a time
            handed_off = False
            try:
                threading.Thread(
                    target=self._reader, args=(conn, session),
                    daemon=True).start()
                handed_off = True
            except RuntimeError:
                pass  # OS thread exhaustion: shed, keep accepting
            finally:
                if not handed_off:
                    with self._lock:
                        self._sessions.discard(session)
                    session.close()
                    self._conn_slots.release()

    def _reader(self, conn: socket.socket, session: Session) -> None:
        try:
            conn.settimeout(self.idle_timeout_s)
            while not session.closed:
                try:
                    msg_type, body = framing.recv_frame(
                        conn, timeout=self.idle_timeout_s,
                        max_body=self.max_frame_body)
                except (framing.ProtocolError, OSError):
                    return  # torn/idle/garbled connection: drop it
                if not self._dispatch(session, msg_type, body):
                    return
        finally:
            with self._lock:
                self._sessions.discard(session)
            session.close()
            self._conn_slots.release()

    def _count(self, name: str, n: int = 1) -> None:
        if self.recorder is not None:
            self.recorder.count(name, n)
