"""The loop: observe → decide → actuate, plus the standby pool,
decision log, and controller-restart resumption.

``FleetAutopilot`` is a daemon thread against ONE router.  Each wake:

1. **observe** — poll the router STATS fan-out through a pooled
   ``ServeClient`` (redialed through failures; a dark router costs a
   counted poll failure, never a crash) into ``FleetSignals``;
2. **decide** — feed the view to the ``AutopilotPolicy``; every
   decision (holds included) appends a structured record to the JSONL
   decision log, so a trace replays;
3. **actuate** — a split pops the next UNDEPLOYED standby and drives
   ``join``; a merge drains the most recently deployed standby
   (LIFO — the autopilot only ever drains shards it added, never the
   operator's initial fleet) via ``leave``.  Actuation is synchronous
   on the loop thread: ONE action in flight by construction, matching
   the HandoffCoordinator's single-handoff invariant.  The outcome is
   logged and fed back to the policy (commit and abort both arm
   cooldowns; abort cools longer).

**Restart resumption**: the durable truth is the ROUTER's persisted
committed ring (shard/handoff.py ``ring.json``) — the controller
itself keeps no authoritative state.  On ``start()`` the autopilot
reads the active ring via STATS and marks every standby already IN
the ring as deployed, so a controller SIGKILLed mid-flight resumes
against whatever the fleet actually is: an action that committed
behind its death is adopted (the standby reads as deployed), one that
aborted left the old ring and the standby stays available.  A
``resume`` record with the adopted generation/digest/deployed set
opens the new log.

Metric names (the contract): counters ``control.polls``,
``control.poll_failures``, ``control.decisions.split`` /
``control.decisions.merge`` / ``control.decisions.hold``,
``control.actions.skipped`` (a decision with no eligible standby),
``control.resume``; gauges ``control.fleet_shards``,
``control.deployed_standbys`` (plus the actuator's
``control.actions.*`` / ``control.actuator.retries``).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from go_crdt_playground_tpu_torch.control.actuator import (OUTCOME_COMMITTED,
                                                     ReshardActuator)
from go_crdt_playground_tpu_torch.control.policy import (ACTION_HOLD,
                                                   ACTION_MERGE,
                                                   ACTION_SPLIT,
                                                   AutopilotPolicy,
                                                   Decision, PolicyConfig)
from go_crdt_playground_tpu_torch.control.signals import FleetSignals, FleetView

Addr = Tuple[str, int]


class StandbyPool:
    """The ordered standby-shard roster: processes that are RUNNING
    (serving their ports, owning no keyspace) but not necessarily in
    the ring.  Split deploys in roster order; merge drains in reverse
    (LIFO) — both deterministic, so a decision trace names its targets
    reproducibly.  Single-owner (controller loop thread)."""

    def __init__(self, standbys: Sequence[Tuple[str, Addr]]):
        seen = set()
        for sid, _ in standbys:
            if sid in seen:
                raise ValueError(f"duplicate standby sid {sid!r}")
            seen.add(sid)
        self._roster: List[Tuple[str, Addr]] = [
            (sid, (a[0], int(a[1]))) for sid, a in standbys]
        # race-ok: controller loop thread only
        self._deployed: List[str] = []  # deploy order (merge pops last)

    @property
    def roster(self) -> List[Tuple[str, Addr]]:
        return list(self._roster)

    @property
    def deployed(self) -> List[str]:
        return list(self._deployed)

    def adopt(self, ring_shards: Sequence[str]) -> List[str]:
        """Resumption: standbys already in the active ring are
        deployed — the router's persisted committed ring is the truth,
        whatever this controller's predecessor managed to finish."""
        in_ring = set(ring_shards)
        self._deployed = [sid for sid, _ in self._roster
                          if sid in in_ring]
        return list(self._deployed)

    def next_join(self) -> Optional[Tuple[str, Addr]]:
        for sid, addr in self._roster:
            if sid not in self._deployed:
                return sid, addr
        return None

    def next_leave(self) -> Optional[str]:
        return self._deployed[-1] if self._deployed else None

    def note_joined(self, sid: str) -> None:
        if sid not in self._deployed:
            self._deployed.append(sid)

    def note_left(self, sid: str) -> None:
        if sid in self._deployed:
            self._deployed.remove(sid)


class FleetAutopilot:
    """The closed-loop controller over one router + a standby pool."""

    def __init__(self, router_addr,
                 standbys: Sequence[Tuple[str, Addr]] = (), *,
                 policy: Optional[AutopilotPolicy] = None,
                 config: Optional[PolicyConfig] = None,
                 poll_interval_s: float = 1.0,
                 reshard_timeout_s: float = 120.0,
                 decision_log: Optional[str] = None,
                 recorder=None, seed: int = 0):
        from go_crdt_playground_tpu_torch.obs import Recorder
        from go_crdt_playground_tpu_torch.serve.client import normalize_addrs

        if poll_interval_s <= 0:
            raise ValueError("poll_interval_s must be > 0")
        # router HA (DESIGN.md §22): with an ordered address list the
        # STATS poll client and every actuation re-resolve the active
        # router — the autopilot rides through a failover with only a
        # counted poll failure, and the decision log's signal records
        # carry the epoch bump (FleetView.router_epoch)
        self.router_addrs = normalize_addrs(router_addr)
        self.router_addr = self.router_addrs[0]
        self.recorder = recorder if recorder is not None else Recorder()
        self.pool = StandbyPool(standbys)
        self.policy = (policy if policy is not None
                       else AutopilotPolicy(config, seed=seed))
        self.signals = FleetSignals()
        self.actuator = ReshardActuator(
            self.router_addrs, reshard_timeout_s=reshard_timeout_s,
            recorder=self.recorder, seed=seed)
        self.poll_interval_s = float(poll_interval_s)
        self.decision_log_path = decision_log
        self.seed = int(seed)
        self._stop = threading.Event()
        # race-ok: start()/stop() owner thread only
        self._thread: Optional[threading.Thread] = None
        # race-ok: controller loop thread only
        self._stats_client = None
        # race-ok: loop thread writes, post-stop readers inspect
        self.last_view: Optional[FleetView] = None
        self.last_decision: Optional[Decision] = None
        self.resumed: Optional[Dict] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self, resume_timeout_s: float = 30.0) -> Dict:
        """Adopt the fleet as it IS (the router's persisted committed
        ring, read via STATS), open the decision log with a ``resume``
        record, start the loop.  Returns the resume record."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("autopilot already running")
        deadline = time.monotonic() + resume_timeout_s
        last_err: Optional[str] = None
        while True:
            try:
                view = self.signals.poll(self._client(),
                                         time.monotonic())
                break
            except (OSError, ConnectionError, socket.timeout) as e:
                self._drop_client()
                last_err = f"{type(e).__name__}: {e}"
                self._count("control.poll_failures")
                if time.monotonic() > deadline:
                    raise ConnectionError(
                        f"router {self.router_addr} unreachable for "
                        f"{resume_timeout_s}s: {last_err}")
                time.sleep(0.2)
        deployed = self.pool.adopt(view.shards)
        self.resumed = {
            "record": "resume",
            "t": round(view.t, 3),
            "router": list(self.router_addr),
            "router_addrs": [list(a) for a in self.router_addrs],
            "router_epoch": view.router_epoch,
            "generation": view.generation,
            "digest": view.digest,
            "shards": list(view.shards),
            "standbys": [sid for sid, _ in self.pool.roster],
            "deployed_adopted": deployed,
            "seed": self.seed,
            "policy": dict(
                p99_budget_s=self.policy.config.p99_budget_s,
                queue_watermark=self.policy.config.queue_watermark,
                hot_windows=self.policy.config.hot_windows,
                cold_windows=self.policy.config.cold_windows,
                cooldown_s=self.policy.config.cooldown_s,
                abort_cooldown_s=self.policy.config.abort_cooldown_s,
                min_shards=self.policy.config.min_shards,
                max_shards=self.policy.config.max_shards,
                cold_rate_per_shard=(self.policy.config
                                     .cold_rate_per_shard)),
        }
        self._log(self.resumed)
        self._count("control.resume")
        self.last_view = view
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-autopilot",
                                        daemon=True)
        self._thread.start()
        return self.resumed

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # the loop may be inside a synchronous reshard: give it
            # the verb budget, not just a poll interval
            self._thread.join(timeout=self.actuator.reshard_timeout_s
                              + self.poll_interval_s + 5.0)
        self._drop_client()

    def __enter__(self) -> "FleetAutopilot":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the loop -----------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.run_cycle()
            except Exception:  # noqa: BLE001 — the controller must
                # never die of one bad cycle; the fleet serves without
                # it and the next wake re-observes
                self._count("control.cycle_errors")

    def run_cycle(self) -> Optional[Decision]:
        """One observe→decide→actuate cycle (the loop body, exposed as
        a seam so tests drive cycles without wall-clock waits)."""
        t = time.monotonic()
        try:
            view = self.signals.poll(self._client(), t)
        except (OSError, ConnectionError, socket.timeout):
            self._drop_client()
            self._count("control.poll_failures")
            return None
        self._count("control.polls")
        self.last_view = view
        self.recorder.set_gauge("control.fleet_shards",
                                len(view.shards))
        self.recorder.set_gauge("control.deployed_standbys",
                                len(self.pool.deployed))
        decision = self.policy.decide(view)
        self.last_decision = decision
        self._count(f"control.decisions.{decision.action}")
        # every verdict is logged — holds included: the log IS the
        # replayable trace
        self._log({"record": "decision", **decision.to_record()})
        if decision.action != ACTION_HOLD:
            self._actuate(decision, t)
        return decision

    def _actuate(self, decision: Decision, t: float) -> None:
        if decision.action == ACTION_SPLIT:
            target = self.pool.next_join()
            if target is None:
                self._skip(decision, t, "standby pool exhausted")
                return
            sid, addr = target
            outcome = self.actuator.join(sid, addr)
        elif decision.action == ACTION_MERGE:
            sid = self.pool.next_leave()
            if sid is None:
                self._skip(decision, t,
                           "no autopilot-deployed shard to drain")
                return
            outcome = self.actuator.leave(sid)
        else:  # pragma: no cover — decide() emits only the 3 actions
            return
        if outcome.outcome == OUTCOME_COMMITTED:
            if outcome.action == "join":
                self.pool.note_joined(outcome.sid)
            else:
                self.pool.note_left(outcome.sid)
        self._log({"record": "outcome", "decision_seq": decision.seq,
                   "action": outcome.action, "sid": outcome.sid,
                   "outcome": outcome.outcome,
                   "attempts": outcome.attempts,
                   "elapsed_s": outcome.elapsed_s,
                   "detail": _jsonable(outcome.detail)})
        self.policy.note_outcome(decision.action, outcome.outcome,
                                 time.monotonic())

    def _skip(self, decision: Decision, t: float, reason: str) -> None:
        """A decision with no eligible target: logged, counted, and
        cooled down like an abort — the pool will not refill by
        itself, so re-deciding every poll would just spam the log."""
        self._count("control.actions.skipped")
        self._log({"record": "outcome", "decision_seq": decision.seq,
                   "action": decision.action, "sid": None,
                   "outcome": "skipped", "detail": {"reason": reason}})
        self.policy.note_outcome(decision.action, "skipped", t)

    # -- plumbing -----------------------------------------------------------

    def _client(self):
        from go_crdt_playground_tpu_torch.serve.client import ServeClient

        if self._stats_client is None or self._stats_client.closed:
            self._drop_client()
            self._stats_client = ServeClient(
                self.router_addrs, timeout=30.0, connect_timeout=2.0)
        return self._stats_client

    def _drop_client(self) -> None:
        if self._stats_client is not None:
            try:
                self._stats_client.close()
            except OSError:
                pass
            self._stats_client = None

    def _log(self, record: Dict) -> None:
        """Append one JSONL record.  Flushed per record (the log is an
        audit trail read by the soak and operators; the authoritative
        resumption state is the ROUTER's ring.json, so fsync-per-line
        durability buys nothing here)."""
        if self.decision_log_path is None:
            return
        line = json.dumps(record, sort_keys=True)
        with open(self.decision_log_path, "a") as f:
            f.write(line + "\n")

    def _count(self, name: str, n: int = 1) -> None:
        if self.recorder is not None:
            self.recorder.count(name, n)


def _jsonable(obj):
    """Reshard detail dicts are JSON-safe already; guard the odd numpy
    scalar a future detail might carry."""
    try:
        json.dumps(obj)
        return obj
    except TypeError:
        return json.loads(json.dumps(obj, default=str))


def read_decision_log(path: str) -> List[Dict]:
    """Parse a JSONL decision log (the soak's adjudication reader);
    tolerates a torn final line (controller SIGKILL mid-append)."""
    out: List[Dict] = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                break  # torn tail: everything before it is intact
    return out
