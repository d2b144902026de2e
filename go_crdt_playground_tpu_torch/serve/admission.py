"""Admission control: the bounded queue between listeners and batcher.

The op-ingest hot path is producer/consumer: connection reader threads
``offer()`` decoded ops, the single batcher thread ``take_batch()``es
them on the micro-batching watermarks.  The queue depth is the
admission limit — the ONLY place ops ever wait unboundedly would be
here, so it is bounded and a full queue sheds the op immediately with a
typed ``Overloaded`` reply (serve/protocol.py) instead of queueing into
latency collapse: past saturation, added offered load converts to shed
replies, not to p99 (the acceptance shape SERVE_CURVE.json pins).

``take_batch`` implements the continuous micro-batching watermarks
(inference-serving shape): block up to ``wait_s`` for the FIRST op,
then keep gathering until either ``max_n`` ops are in hand (size
watermark) or ``flush_s`` has elapsed since the first take (time
watermark).  An idle frontend therefore adds at most ``flush_s`` to a
lone op's latency, while a busy one fills whole batches with no timer
waits at all.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional


class OpRequest:
    """One admitted client op, queued for the batcher.

    ``deadline`` is an ABSOLUTE ``time.monotonic()`` instant (None =
    no budget) computed at admission from the wire's relative
    ``deadline_us`` — propagation happens once, at the edge.  Single
    writer per field (the reader thread builds it, the batcher consumes
    it); only ``session`` is shared, and it locks itself.

    ``elements`` doubles as the op's KEY SET for the conflict-aware
    admission scheduler (serve/scheduler.py): ops whose key sets are
    connected through shared keys form one key-run and keep their
    queue order; disjoint runs may be reordered and spread across a
    striped target's dp ingest stripes.  ``key_set()`` is the named
    accessor for that reading of the field.
    """

    __slots__ = ("req_id", "kind", "elements", "deadline", "session",
                 "t_arrival")

    def __init__(self, req_id: int, kind: int, elements: List[int],
                 deadline: Optional[float], session,
                 t_arrival: float):
        self.req_id = req_id
        self.kind = kind
        self.elements = elements
        self.deadline = deadline
        self.session = session
        self.t_arrival = t_arrival

    def key_set(self) -> frozenset:
        """The elements this op touches, as the scheduler's conflict
        domain: two ops commute iff their key sets are disjoint (the
        AWSet join is per-element), which is the whole license for
        cross-run reordering (serve/scheduler.py)."""
        return frozenset(self.elements)


class AdmissionQueue:
    """Bounded MPSC op queue with micro-batch draining.  Thread-safe."""

    def __init__(self, maxdepth: int,
                 clock: Callable[[], float] = time.monotonic):
        if maxdepth < 1:
            raise ValueError("maxdepth must be >= 1")
        self.maxdepth = maxdepth
        self._clock = clock
        self._cond = threading.Condition()
        self._items: deque = deque()  # guarded-by: _cond
        self._closed = False  # guarded-by: _cond

    def offer(self, req: OpRequest) -> bool:
        """Admit one op; False = shed (queue at depth, or closed).  The
        caller owes the client the typed reject — a False return must
        never be a silent drop."""
        with self._cond:
            if self._closed or len(self._items) >= self.maxdepth:
                return False
            self._items.append(req)
            self._cond.notify()
            return True

    def take_batch(self, max_n: int, wait_s: float,
                   flush_s: float) -> List[OpRequest]:
        """Drain up to ``max_n`` ops on the micro-batching watermarks
        (see module docstring).  Returns [] when ``wait_s`` elapses with
        nothing queued — the batcher's idle tick, where it re-checks its
        stop/drain flags."""
        out: List[OpRequest] = []
        with self._cond:
            deadline = self._clock() + wait_s
            while not self._items:
                if self._closed:
                    return out
                remaining = deadline - self._clock()
                if remaining <= 0:
                    return out
                self._cond.wait(timeout=remaining)
            flush_deadline = self._clock() + flush_s
            while len(out) < max_n:
                while self._items and len(out) < max_n:
                    out.append(self._items.popleft())
                if len(out) >= max_n or self._closed:
                    break
                remaining = flush_deadline - self._clock()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
        return out

    def depth(self) -> int:
        with self._cond:
            return len(self._items)

    def close(self) -> None:
        """Refuse new offers (drain mode: already-queued ops still come
        out of ``take_batch``) and wake any waiting consumer."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed
