"""Jittered exponential backoff: one policy object for every retry loop.

The counterpart of the JAX package's ``utils/backoff.py`` (host only).
Delay law for attempt k (0-based):

    nominal_k = min(cap_s, base_s * multiplier**k)
    delay_k   = nominal_k * (1 + jitter * u_k),   u_k ~ Uniform[-1, 1]

so delays stay inside ``[(1-jitter)*nominal, (1+jitter)*nominal]`` and the
nominal sequence is monotone with a hard cap.  Jitter draws come from a
private ``random.Random(seed)``: equal seeds replay equal schedules, so
a seeded fleet's timing is reproducible.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple, Type


@dataclass(frozen=True)
class BackoffPolicy:
    """Immutable retry-delay configuration (shared; the per-loop cursor
    is ``Backoff``)."""

    base_s: float = 0.05
    multiplier: float = 2.0
    cap_s: float = 2.0
    jitter: float = 0.1     # fraction of nominal, symmetric
    max_retries: int = 3    # retries AFTER the first attempt

    def __post_init__(self) -> None:
        if self.base_s < 0 or self.cap_s < 0:
            raise ValueError("backoff delays must be non-negative")
        if self.multiplier < 1.0:
            raise ValueError(
                f"multiplier {self.multiplier} < 1 would make the nominal "
                "sequence decay: that is a rate limiter, not a backoff")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter {self.jitter} outside [0, 1)")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")

    def nominal(self, attempt: int) -> float:
        """Un-jittered delay after failed attempt ``attempt`` (0-based)."""
        return min(self.cap_s, self.base_s * self.multiplier ** attempt)

    def delays(self, seed: int = 0) -> Iterator[float]:
        """The full jittered schedule (max_retries entries) as a fresh
        deterministic stream."""
        rng = random.Random(seed)
        for k in range(self.max_retries):
            n = self.nominal(k)
            yield n * (1.0 + self.jitter * rng.uniform(-1.0, 1.0))


class Backoff:
    """Mutable cursor over one policy's delay schedule: ``next_delay()``
    returns the next jittered delay, or None once the retry budget is
    spent; ``reset()`` rewinds the cursor and the jitter stream."""

    def __init__(self, policy: BackoffPolicy, seed: int = 0):
        self.policy = policy
        self._seed = seed
        self._rng = random.Random(seed)
        self._attempt = 0

    @property
    def attempt(self) -> int:
        return self._attempt

    def next_delay(self) -> Optional[float]:
        if self._attempt >= self.policy.max_retries:
            return None
        n = self.policy.nominal(self._attempt)
        self._attempt += 1
        return n * (1.0 + self.policy.jitter * self._rng.uniform(-1.0, 1.0))

    def reset(self) -> None:
        self._rng = random.Random(self._seed)
        self._attempt = 0


def retry_call(fn: Callable[[], object], policy: BackoffPolicy,
               retry_on: Tuple[Type[BaseException], ...] = (OSError,),
               seed: int = 0,
               sleep: Callable[[float], None] = time.sleep,
               on_retry: Optional[Callable[[BaseException, float], None]]
               = None):
    """Call ``fn`` with up to ``policy.max_retries`` retries on
    ``retry_on`` exceptions, sleeping the policy's jittered delays in
    between; the last failure propagates unchanged."""
    bo = Backoff(policy, seed=seed)
    while True:
        try:
            return fn()
        except retry_on as e:
            d = bo.next_delay()
            if d is None:
                raise
            if on_retry is not None:
                on_retry(e, d)
            sleep(d)
