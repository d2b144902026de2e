"""Runtime guards: uint32 overflow detection + single-install registry.

The counterpart of the JAX package's ``utils/guards.py``.

Overflow guards: the reference's clocks are Go ``uint`` (64-bit), so it
can tick forever; the packed tensors hold uint32 counters (int32 bits
here, ``_u32.py``), which wrap after 2^32 - 1 ticks per actor, and a
wrapped counter silently corrupts causality because every decision is a
``>=`` compare on counters.  These guards make clock exhaustion loud
before it becomes wrong answers.  ``overflow_risk`` returns a device
scalar (no host sync), so a gossip loop can fold it into its per-round
convergence fetch; ``check_headroom`` is the host-side wrapper that
raises.  Counters are read unsigned: a clock at 2^31 and above is a
large count, never a negative one.

Install guards: ``InstallGuard`` / the process-wide ``SHIM_GUARD`` make
monkeypatch-style shims loudly refuse double installation — two stacked
shims silently corrupt each other's view, so the second ``install`` must
raise, not wedge.
"""

from __future__ import annotations

import threading
from typing import Dict, Hashable

import torch

from go_crdt_playground_tpu_torch._u32 import narrow, widen

UINT32_MAX = 0xFFFF_FFFF

# One ``Add(k...)`` ticks once per key (awset.go:91) and a δ-``Del`` once
# per call (awset-delta_test.go:15-16): a margin of 2^20 ticks is
# thousands of full-universe rewrites of warning space.
DEFAULT_MARGIN = 1 << 20


def counter_headroom(vv: torch.Tensor) -> torch.Tensor:
    """Ticks left before the fastest clock wraps: UINT32_MAX - max(vv).

    vv: int32[..., A] holding uint32 bits (any leading batch axes).
    Returns an int32 scalar holding the uint32 headroom's bits."""
    return narrow(UINT32_MAX - widen(vv).max())


def overflow_risk(vv: torch.Tensor,
                  margin: int = DEFAULT_MARGIN) -> torch.Tensor:
    """A bool scalar on vv's device: True when any actor clock is within
    ``margin`` ticks of wrapping."""
    return widen(counter_headroom(vv)) < margin


def check_headroom(state, margin: int = DEFAULT_MARGIN):
    """Host-side guard: raise ``OverflowError`` when the state's clocks are
    within ``margin`` ticks of uint32 wraparound; otherwise return the
    state unchanged (chainable)."""
    headroom = int(widen(counter_headroom(state.vv)))
    if headroom < margin:
        raise OverflowError(
            f"uint32 clock exhaustion: only {headroom} ticks of headroom "
            f"left (margin {margin}).  The packed representation caps each "
            f"actor at {UINT32_MAX} events (the Go reference's 64-bit uint "
            "does not); repack with a wider dtype or retire the actor id."
        )
    return state


# ---------------------------------------------------------------------------
# shim install guard
# ---------------------------------------------------------------------------


class AlreadyInstalledError(RuntimeError):
    """A shim was installed twice under the same key.  Stacked shims
    (e.g. a race-detector tracing class wrapping another tracing class)
    silently corrupt each other; the second install must fail fast."""


class InstallGuard:
    """Thread-safe once-only registry for monkeypatch-style shims.

    ``install(key)`` claims the key or raises ``AlreadyInstalledError``;
    ``uninstall(key)`` releases it (KeyError on a key never installed —
    an unbalanced uninstall is a bug worth hearing about).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._installed: Dict[Hashable, str] = {}

    def install(self, key: Hashable, owner: str = "") -> None:
        with self._lock:
            if key in self._installed:
                prev = self._installed[key]
                raise AlreadyInstalledError(
                    f"shim {key!r} is already installed"
                    + (f" (by {prev})" if prev else "")
                    + "; uninstall the first shim before stacking another")
            self._installed[key] = owner

    def uninstall(self, key: Hashable) -> None:
        with self._lock:
            if key not in self._installed:
                raise KeyError(
                    f"shim {key!r} is not installed (unbalanced uninstall)")
            del self._installed[key]

    def installed(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._installed


# the process-wide registry shims install under
SHIM_GUARD = InstallGuard()
