"""The actuate third of the control loop: typed, abortable verbs.

The actuator owns exactly one power: driving the EXISTING live-reshard
admin verb (``RESHARD`` join/leave, shard/handoff.py) through an
ordinary ``ServeClient`` — the same surface an operator's ``reshard``
CLI uses, so everything the handoff machinery proves (fence →
transfer → atomic swap, abort ⇒ old ring serving) is inherited, not
re-implemented.

Failure ladder (the module's whole design):

* **typed abort** (``ok=False`` reply) — the SAFE path.  The router
  already funnelled every mid-handoff failure through the abort arm:
  the old ring is provably serving, nothing transferred twice, the
  fence is down.  The actuator does NOT retry — retrying a handoff
  that just refused (donor mid-restart, another handoff in flight,
  transfer deadline) would burn fence windows against a fleet that
  just proved it was not ready.  It reports ``aborted`` and the
  policy cools down.
* **transport failure** (dial refused, connection death, timeout) —
  the outcome of the verb is UNKNOWN (the handoff may still commit
  behind a dead admin connection), so the actuator re-READS before
  re-acting: each retry first checks the ring via STATS — if the
  generation moved past the pre-action generation, the verb landed
  and the outcome is ``committed``.  Retries are seeded-jitter
  backoff (utils/backoff) through a bounded attempt budget; past it,
  ``unreachable``.

Counters: ``control.actions.committed`` / ``control.actions.aborted``
/ ``control.actions.unreachable``, ``control.actuator.retries``.
"""

from __future__ import annotations

import socket
import time
from typing import Dict, NamedTuple, Optional, Tuple

from go_crdt_playground_tpu_torch.utils.backoff import Backoff, BackoffPolicy

Addr = Tuple[str, int]

OUTCOME_COMMITTED = "committed"
OUTCOME_ABORTED = "aborted"
OUTCOME_UNREACHABLE = "unreachable"


class ActionOutcome(NamedTuple):
    """One actuation's verdict + the router's own accounting."""

    outcome: str          # committed | aborted | unreachable
    action: str           # join | leave
    sid: str
    detail: Dict          # the reshard reply detail (or failure reason)
    elapsed_s: float
    attempts: int


class ReshardActuator:
    """Drives join/leave against one router, one action at a time.

    Single-owner object (the controller loop thread).  Each action
    uses a FRESH admin connection: a reshard blocks for the whole
    handoff, so the client read deadline must cover it
    (``reshard_timeout_s``), and a dead admin connection must never
    poison a later action's pipelining."""

    DEFAULT_POLICY = BackoffPolicy(base_s=0.2, multiplier=2.0, cap_s=2.0,
                                   jitter=0.2, max_retries=4)

    def __init__(self, router_addr, *,
                 reshard_timeout_s: float = 120.0,
                 policy: Optional[BackoffPolicy] = None,
                 recorder=None, seed: int = 0):
        from go_crdt_playground_tpu_torch.serve.client import normalize_addrs

        # router HA (DESIGN.md §22): an ordered address list makes
        # every fresh admin connection re-resolve the ACTIVE router —
        # an action interrupted by a failover retries against the
        # promoted standby, and the ring-generation arbitration below
        # adjudicates it exactly like any other transport ambiguity
        self.router_addrs = normalize_addrs(router_addr)
        self.router_addr = self.router_addrs[0]
        self.reshard_timeout_s = float(reshard_timeout_s)
        self.policy = policy if policy is not None else self.DEFAULT_POLICY
        self.recorder = recorder
        self.seed = int(seed)
        # race-ok: controller loop thread only
        self._action_seq = 0

    # -- the two verbs ------------------------------------------------------

    def join(self, sid: str, addr: Addr) -> ActionOutcome:
        return self._act("join", sid, addr)

    def leave(self, sid: str) -> ActionOutcome:
        return self._act("leave", sid, None)

    # -- internals ----------------------------------------------------------

    def _act(self, action: str, sid: str,
             addr: Optional[Addr]) -> ActionOutcome:
        from go_crdt_playground_tpu_torch.serve import protocol

        mode = (protocol.RESHARD_JOIN if action == "join"
                else protocol.RESHARD_LEAVE)
        self._action_seq += 1
        bo = Backoff(self.policy,
                     seed=self.seed * 7919 + self._action_seq)
        t0 = time.monotonic()
        attempts = 0
        # the ambiguity anchor: a transport death mid-verb leaves the
        # outcome unknown, but the ring generation is monotone and a
        # commit bumps it — observed-before vs observed-after decides.
        # The baseline is MANDATORY: without it a verb that commits
        # behind a dead admin connection would be retried, and the
        # retry's typed "already in the ring" abort would be reported
        # as ABORTED — the pool never records the join and every later
        # split re-picks the same deployed standby.  Safer to refuse
        # to act than to act unadjudicably.
        pre_gen, _ = self._ring_state()
        while pre_gen is None:
            delay = bo.next_delay()
            if delay is None:
                return self._done(
                    action, sid, OUTCOME_UNREACHABLE,
                    {"reason": "router unreachable for the "
                               "pre-action ring read (verb never "
                               "sent)"}, t0, attempts)
            self._count("control.actuator.retries")
            time.sleep(delay)
            pre_gen, _ = self._ring_state()
        last_err = "never attempted"
        while True:
            attempts += 1
            try:
                ok, detail = self._reshard_once(mode, sid, addr)
            except (OSError, ConnectionError, socket.timeout) as e:
                last_err = f"{type(e).__name__}: {e}"
                self._count("control.actuator.retries")
                landed = self._landed(action, sid, pre_gen)
                if landed is not None:
                    # the verb committed behind the dead connection
                    return self._done(action, sid, OUTCOME_COMMITTED,
                                      {**landed, "recovered": last_err},
                                      t0, attempts)
                delay = bo.next_delay()
                if delay is None:
                    return self._done(
                        action, sid, OUTCOME_UNREACHABLE,
                        {"reason": last_err}, t0, attempts)
                time.sleep(delay)
                continue
            if ok:
                return self._done(action, sid, OUTCOME_COMMITTED,
                                  detail, t0, attempts)
            # typed abort — but a RETRY of a verb that already landed
            # aborts typed too ("already in the ring"): the ring state
            # arbitrates before the abort is believed
            landed = self._landed(action, sid, pre_gen)
            if landed is not None:
                return self._done(action, sid, OUTCOME_COMMITTED,
                                  {**landed,
                                   "abort_was_stale": str(
                                       detail.get("reason", ""))},
                                  t0, attempts)
            # genuine typed abort: the safe path — old ring provably
            # serving; never retried here (the policy cools down)
            return self._done(action, sid, OUTCOME_ABORTED, detail,
                              t0, attempts)

    def _reshard_once(self, mode: int, sid: str,
                      addr: Optional[Addr]) -> Tuple[bool, Dict]:
        from go_crdt_playground_tpu_torch.serve.client import ServeClient

        with ServeClient(self.router_addrs,
                         timeout=self.reshard_timeout_s,
                         connect_timeout=5.0) as c:
            return c.reshard(mode, sid, addr,
                             timeout=self.reshard_timeout_s)

    def _ring_state(self) -> Tuple[Optional[int], Tuple[str, ...]]:
        """Best-effort (generation, shards) read on a short throwaway
        dial; (None, ()) when the router is unreachable (the ambiguity
        stays unresolved and the retry ladder continues)."""
        from go_crdt_playground_tpu_torch.serve.client import ServeClient

        try:
            with ServeClient(self.router_addrs, timeout=10.0,
                             connect_timeout=2.0) as c:
                ring = c.stats()["ring"]
                return (int(ring["generation"]),
                        tuple(ring.get("shards", ())))
        except (OSError, ConnectionError, socket.timeout, KeyError,
                ValueError, TypeError):
            return None, ()

    def _landed(self, action: str, sid: str,
                pre_gen: int) -> Optional[Dict]:
        """Did this verb already COMMIT?  True only when the ring
        generation advanced past the pre-action baseline AND the
        membership reflects the verb's end state (a join's sid in the
        ring / a leave's sid gone) — generation alone could be some
        OTHER operator's concurrent handoff.  None = not provably
        landed (unreachable router reads as not-landed; the caller's
        ladder continues)."""
        gen, shards = self._ring_state()
        if gen is None or gen <= pre_gen:
            return None
        in_ring = sid in shards
        if (action == "join") == in_ring:
            return {"generation": gen, "shards": list(shards)}
        return None

    def _done(self, action: str, sid: str, outcome: str, detail: Dict,
              t0: float, attempts: int) -> ActionOutcome:
        self._count(f"control.actions.{outcome}")
        return ActionOutcome(outcome=outcome, action=action, sid=sid,
                             detail=dict(detail),
                             elapsed_s=round(time.monotonic() - t0, 3),
                             attempts=attempts)

    def _count(self, name: str, n: int = 1) -> None:
        if self.recorder is not None:
            self.recorder.count(name, n)
