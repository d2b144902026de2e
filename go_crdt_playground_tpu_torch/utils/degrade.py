"""Shared probe-window degradation latch (DESIGN.md §16 tail, §23).

Two serving-path subsystems degrade the same way when a dependency
fails: the disk-full ladder (serve/batcher.py: a WAL fsync failure
sheds writes typed ``StorageDegraded``) and the replication ladder
(shard/replica.py: a dead/slow standby degrades semi-sync group commit
to async).  Both follow one probe-window shape:

* **arm** — the failure opens a window of ``retry_s`` seconds during
  which the degraded behavior holds (writes shed, or acks stop
  waiting);
* **expire** — the window lapses on its own; the NEXT operation is the
  probe (one batch tests the disk, one ack gate waits for the standby
  again);
* **probe success** — ``clear()``: the dependency recovered, the
  window drops immediately;
* **probe failure** — ``arm()`` again: another full window, another
  probe after it.

``DegradeWindow`` is that latch, extracted so both ladders share one
implementation and one test suite (tests/test_degrade.py).  Lock-free
by the same argument the original batcher field made: the deadline is
a single float written by the arming thread; readers polling
``armed()`` from other threads see either the old or the new value (a
float store is atomic in CPython), and the worst stale read
misclassifies ONE operation between two typed retryable outcomes —
never correctness.  ``windows`` counts distinct armings (an arm while
already armed extends the deadline without counting a new window, so
``repl.degraded_windows``-style counters measure degraded EPISODES,
not failing operations).
"""

from __future__ import annotations

import time
from typing import Callable


class DegradeWindow:
    """One probe-window degradation latch (module docstring)."""

    def __init__(self, retry_s: float,
                 clock: Callable[[], float] = time.monotonic):
        if retry_s <= 0:
            raise ValueError("retry_s must be > 0")
        self.retry_s = float(retry_s)
        self._clock = clock
        # monotonic deadline; 0 = healthy.  race-ok: single arming
        # writer per subsystem, cross-thread readers tolerate one
        # stale classification (module docstring)
        self._until = 0.0
        # distinct degraded episodes (never reset; metrics diff it).
        # race-ok: written only by the arming thread
        self.windows = 0

    def arm(self) -> bool:
        """Open (or re-open, after a failed probe) the degrade window.
        Returns True when this arming STARTED a new degraded episode —
        the caller counts its ``*.degraded_windows`` metric on that —
        and False when it extended a live one.  An episode runs from
        the first arm to the next ``clear()``: a failed probe's re-arm
        is the SAME outage continuing, not a new one."""
        fresh = not self.armed_ever()
        if fresh:
            self.windows += 1
        self._until = self._clock() + self.retry_s
        return fresh

    def clear(self) -> None:
        """A probe succeeded: drop the window immediately."""
        self._until = 0.0

    def active(self) -> bool:
        """True while the window holds — the degraded behavior applies
        and no probe runs.  False once it expires: the next operation
        is the probe (its success must ``clear()``, its failure must
        ``arm()``)."""
        until = self._until
        return bool(until) and self._clock() < until

    def armed_ever(self) -> bool:
        """True from the first arm until the next ``clear()`` —
        including the expired-awaiting-probe gap where ``active()`` is
        already False.  The probe dispatcher keys on this: an expired
        window means "run the probe", a cleared one means "healthy,
        nothing to prove"."""
        return bool(self._until)
