"""The per-peer circuit breaker of the anti-entropy runtime and the
router tier.

It lives apart from ``net/antientropy.py`` (which re-exports it) because
the router imports it and must not load torch: the supervisor beside it
drives a ``Node``, which does.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_GAUGE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class CircuitBreaker:
    """Per-peer consecutive-failure breaker.

        CLOSED    --failure x threshold-->  OPEN
        OPEN      --cooldown elapsed----->  HALF_OPEN (one probe per
                                            cool-down window)
        HALF_OPEN --probe success------->   CLOSED
        HALF_OPEN --probe failure------->   OPEN (fresh cooldown)
        any       --trip()-------------->   OPEN

    ``allow()`` is the gate before a dial and performs OPEN -> HALF_OPEN
    itself; a probe whose owner never reports re-grants after a further
    cooldown.  Thread-safe."""

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable[[str, str], None]] = None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED  # guarded-by: _lock
        self._consecutive = 0  # guarded-by: _lock
        self._opened_at = 0.0  # guarded-by: _lock
        self._probe_granted_at = 0.0  # guarded-by: _lock

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def consecutive_failures(self) -> int:
        with self._lock:
            return self._consecutive

    # requires-lock: _lock
    def _set_state(self, new: str) -> None:
        """Runs the transition hook under the lock: keep hooks cheap."""
        old, self._state = self._state, new
        if old != new and self._on_transition is not None:
            self._on_transition(old, new)

    def allow(self) -> bool:
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self.cooldown_s:
                    self._set_state(HALF_OPEN)
                    self._probe_granted_at = self._clock()
                    return True
                return False
            # HALF_OPEN: the probe is in flight; a wedged one re-grants
            if self._clock() - self._probe_granted_at >= self.cooldown_s:
                self._probe_granted_at = self._clock()
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            if self._state != CLOSED:
                self._set_state(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            if self._state == HALF_OPEN or (
                    self._state == CLOSED
                    and self._consecutive >= self.failure_threshold):
                self._opened_at = self._clock()
                self._set_state(OPEN)
            elif self._state == OPEN:
                # a racing failure while OPEN refreshes the cooldown
                self._opened_at = self._clock()

    def trip(self) -> None:
        """Force OPEN now."""
        with self._lock:
            self._opened_at = self._clock()
            if self._state != OPEN:
                self._set_state(OPEN)
