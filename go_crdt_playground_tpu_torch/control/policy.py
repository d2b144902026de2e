"""The decide third of the control loop: seeded, hysteresis-banded.

One rule governs the whole module: **the policy is a deterministic
pure-ish function of the signal trace** — same configured bands, same
seed, same sequence of ``FleetView``s ⇒ the same decision sequence
(pinned by tests/test_control.py).  Nothing here reads a clock, a
socket, or a random stream mid-decision; the controller feeds it
views and outcome notes, and every verdict comes back as a structured,
replayable ``Decision`` record.

Bands (DESIGN.md §21):

* **hot** — a shard burns its p99 budget (windowed ingest p99 >
  ``p99_budget_s``) or its admission queue sits above
  ``queue_watermark``.  One hot sample means nothing (a single fsync
  hiccup trips it); a shard must stay hot for ``hot_windows``
  CONSECUTIVE views before a split fires — the hysteresis half that
  stops flapping on an oscillating load.
* **cold** — the whole fleet idles: every reachable shard's p99 is
  under ``p99_budget_s/2`` (the band GAP between the split and merge
  thresholds is the other flap guard: a fleet hovering at the budget
  is neither hot enough to split nor cold enough to merge), queues
  are near-empty, and the fleet-wide offered rate would fit one fewer
  shard with slack (< ``cold_rate_per_shard`` × (n-1)).  Sustained for
  ``cold_windows`` views ⇒ drain-and-merge.
* **cooldown** — after ANY action outcome, decisions hold for
  ``cooldown_s`` (``abort_cooldown_s`` after an abort: the typed abort
  is the SAFE path — old ring provably serving — and the correct
  response is to cool down and re-observe, never a retry storm).

A single action in flight, by construction: the controller calls
``decide`` only between actions (matching the HandoffCoordinator's
one-handoff invariant), and streaks reset after every action so fresh
evidence must re-accumulate against the post-action ring.

Unreachable shards contribute NO evidence: outages are the breaker
ladder's job (typed rejects + redial probes), and any cold verdict is
withheld while a shard is dark — merging away capacity because a
process is mid-restart would be actively wrong.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from go_crdt_playground_tpu_torch.control.signals import FleetView

ACTION_SPLIT = "split"
ACTION_MERGE = "merge"
ACTION_HOLD = "hold"

OUTCOME_COMMITTED = "committed"
OUTCOME_ABORTED = "aborted"
OUTCOME_UNREACHABLE = "unreachable"


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """The declared bands — these exact numbers are the budgets the
    autopilot soak adjudicates convergence against (CONTROL_CURVE)."""

    p99_budget_s: float = 0.25      # windowed ingest p99 burn threshold
    queue_watermark: float = 48.0   # admission-queue hot threshold
    hot_windows: int = 3            # consecutive hot views before split
    cold_windows: int = 8           # consecutive cold views before merge
    cooldown_s: float = 10.0        # post-commit re-observe window
    abort_cooldown_s: float = 20.0  # post-abort window (longer: the
    #                                 fleet just proved it was not ready)
    min_shards: int = 1
    max_shards: int = 8
    cold_rate_per_shard: float = 100.0  # fleet offered ops/s per
    #                                     REMAINING shard under which a
    #                                     merge is even considered

    def __post_init__(self) -> None:
        if self.hot_windows < 1 or self.cold_windows < 1:
            raise ValueError("streak windows must be >= 1")
        if self.min_shards < 1 or self.max_shards < self.min_shards:
            raise ValueError("need 1 <= min_shards <= max_shards")
        if self.p99_budget_s <= 0:
            raise ValueError("p99_budget_s must be > 0")


@dataclasses.dataclass(frozen=True)
class Decision:
    """One replayable decision record (JSONL-able via ``to_record``)."""

    seq: int
    action: str                    # split | merge | hold
    reason: str
    hot_sid: Optional[str] = None  # the shard whose burn triggered it
    signals: Optional[Dict] = None  # FleetView.to_record() at decision

    def to_record(self) -> Dict:
        return {"seq": self.seq, "action": self.action,
                "reason": self.reason, "hot_sid": self.hot_sid,
                "signals": self.signals}


class AutopilotPolicy:
    """Deterministic hysteresis policy over a FleetView stream.

    Single-owner object (the controller loop thread); ``seed`` is
    recorded into every decision so a replay names the exact policy
    instance, and seeds any future stochastic tie-break — today every
    tie-break is lexicographic, so two replicas of the policy agree
    with or without it."""

    def __init__(self, config: Optional[PolicyConfig] = None,
                 seed: int = 0):
        self.config = config if config is not None else PolicyConfig()
        self.seed = int(seed)
        # race-ok: controller loop thread only (all fields below)
        self._hot_streak: Dict[str, int] = {}
        self._cold_streak = 0
        self._cooldown_until = 0.0
        self._seq = 0
        self.last_outcome: Optional[str] = None

    # -- the decide step ----------------------------------------------------

    def decide(self, view: FleetView) -> Decision:
        """Consume one view, return one decision.  Streak state
        advances on EVERY call (cooldown included) so a burn that
        persists through a cooldown fires the moment the window
        opens."""
        cfg = self.config
        self._seq += 1
        hot_sid = self._update_hot_streaks(view)
        cold = self._update_cold_streak(view)
        if view.t < self._cooldown_until:
            return self._hold(view, f"cooldown until "
                                    f"t={self._cooldown_until:.1f}")
        if view.fenced > 0:
            # a handoff someone else is driving is mid-flight: the
            # one-action invariant extends to operators
            return self._hold(view, "keyspace fenced (handoff live)")
        n = len(view.shards)
        if hot_sid is not None:
            if n >= cfg.max_shards:
                return self._hold(view, f"hot shard {hot_sid} but ring "
                                        f"at max_shards={cfg.max_shards}")
            return self._emit(
                view, ACTION_SPLIT, hot_sid,
                f"shard {hot_sid} hot for {cfg.hot_windows} consecutive "
                f"windows (p99 budget {cfg.p99_budget_s * 1e3:.0f}ms / "
                f"queue watermark {cfg.queue_watermark:g})")
        if cold and self._cold_streak >= cfg.cold_windows:
            if n <= cfg.min_shards:
                return self._hold(view, "fleet cold but ring at "
                                        f"min_shards={cfg.min_shards}")
            return self._emit(
                view, ACTION_MERGE, None,
                f"fleet cold for {cfg.cold_windows} consecutive windows "
                f"(offered rate fits {n - 1} shards with slack)")
        return self._hold(view, "inside bands")

    # -- outcome feedback (the controller reports what the actuator saw) ----

    def note_outcome(self, action: str, outcome: str, t: float) -> None:
        """Arm the cooldown and reset streaks: fresh evidence must
        re-accumulate against the post-action ring.  An abort cools
        LONGER — the typed abort is the safe path (old ring provably
        serving), and retry-storming a handoff that just refused would
        burn fence windows for nothing."""
        cfg = self.config
        self.last_outcome = outcome
        wait = (cfg.abort_cooldown_s if outcome != OUTCOME_COMMITTED
                else cfg.cooldown_s)
        self._cooldown_until = t + wait
        self._hot_streak.clear()
        self._cold_streak = 0

    # -- internals ----------------------------------------------------------

    def _update_hot_streaks(self, view: FleetView) -> Optional[str]:
        """Advance per-shard hot streaks; returns the split trigger
        (the longest-burning shard, p99-then-sid tie-break —
        deterministic) once some streak crosses the band."""
        cfg = self.config
        live = set(view.per_shard)
        for sid in [s for s in self._hot_streak if s not in live]:
            del self._hot_streak[sid]
        for sid, s in sorted(view.per_shard.items()):
            hot = s.reachable and (
                (s.p99_s is not None and s.p99_s > cfg.p99_budget_s)
                or s.queue_depth >= cfg.queue_watermark)
            self._hot_streak[sid] = (self._hot_streak.get(sid, 0) + 1
                                     if hot else 0)
        burning = [(streak,
                    view.per_shard[sid].p99_s or 0.0, sid)
                   for sid, streak in self._hot_streak.items()
                   if streak >= cfg.hot_windows]
        if not burning:
            return None
        burning.sort(key=lambda x: (-x[0], -x[1], x[2]))
        return burning[0][2]

    def _update_cold_streak(self, view: FleetView) -> bool:
        cfg = self.config
        shards = list(view.per_shard.values())
        n = len(shards)
        cold = bool(shards) and all(s.reachable for s in shards) and all(
            (s.p99_s is None or s.p99_s <= cfg.p99_budget_s / 2)
            and s.queue_depth <= cfg.queue_watermark / 4
            for s in shards)
        if cold and n > 1:
            offered = sum(s.op_rate for s in shards)
            cold = offered < cfg.cold_rate_per_shard * (n - 1)
        self._cold_streak = self._cold_streak + 1 if cold else 0
        return cold

    def _emit(self, view: FleetView, action: str,
              hot_sid: Optional[str], reason: str) -> Decision:
        return Decision(seq=self._seq, action=action, reason=reason,
                        hot_sid=hot_sid, signals=view.to_record())

    def _hold(self, view: FleetView, reason: str) -> Decision:
        return Decision(seq=self._seq, action=ACTION_HOLD, reason=reason,
                        hot_sid=None, signals=view.to_record())
