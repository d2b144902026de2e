"""The port's fleet autopilot (control/): tests/test_control.py's
scenarios on the port's policy, signals, pool, actuator and controller
(the loop in process over torch frontends on the CPU), then the two
packages side by side: the same ``FleetView`` sequence gives equal
``Decision`` records, and two controllers fed the same STATS replies,
clock and actuation outcomes write decision logs equal line for line
outside the named time fields (``t``, ``elapsed_s``)."""

import os
import time

import pytest

from go_crdt_playground_tpu_torch.control import (AutopilotPolicy,
                                            FleetAutopilot, FleetSignals,
                                            PolicyConfig, ReshardActuator,
                                            StandbyPool)
from go_crdt_playground_tpu_torch.control.policy import (ACTION_HOLD,
                                                   ACTION_MERGE,
                                                   ACTION_SPLIT,
                                                   OUTCOME_ABORTED,
                                                   OUTCOME_COMMITTED)
from go_crdt_playground_tpu_torch.control.signals import FleetView, ShardSignals


# ---------------------------------------------------------------------------
# synthetic views (the policy never sees a socket)
# ---------------------------------------------------------------------------


def _view(t, p99s, *, queue=None, op_rate=50.0, shards=None,
          reachable=None, fenced=0, generation=0):
    shards = shards if shards is not None else [
        f"s{i}" for i in range(len(p99s))]
    per = {}
    for i, sid in enumerate(shards):
        per[sid] = ShardSignals(
            sid=sid,
            reachable=True if reachable is None else reachable[i],
            op_rate=op_rate, acked_rate=op_rate, shed_rate=0.0,
            queue_depth=0.0 if queue is None else queue[i],
            p99_s=p99s[i])
    return FleetView(t=t, generation=generation, digest="d",
                     shards=tuple(shards), fenced=fenced, load_stats={},
                     per_shard=per)


CFG = PolicyConfig(p99_budget_s=0.2, queue_watermark=10.0,
                   hot_windows=3, cold_windows=4, cooldown_s=5.0,
                   abort_cooldown_s=12.0, min_shards=2, max_shards=4,
                   cold_rate_per_shard=100.0)


def _trace_hot(n, hot_from=1):
    """s0 burns its p99 budget from view ``hot_from`` on."""
    return [_view(float(t), [0.5 if t >= hot_from else 0.05, 0.05])
            for t in range(n)]


def test_policy_same_trace_same_decisions():
    """Determinism: the decision sequence is a pure function of
    (config, seed, trace)."""
    trace = _trace_hot(8)
    pa, pb = AutopilotPolicy(CFG, seed=7), AutopilotPolicy(CFG, seed=7)
    a = [pa.decide(v).action for v in trace]
    b = [pb.decide(v).action for v in trace]
    assert a == b
    # and the shape is the banded one: holds until the streak fills,
    # then a split (the controller would actuate + cool down here;
    # without feedback the policy keeps asserting the same verdict)
    assert a[:3] == [ACTION_HOLD] * 3
    assert a[3] == ACTION_SPLIT


def test_policy_split_names_trigger_and_signals():
    pol = AutopilotPolicy(CFG)
    d = None
    for v in _trace_hot(6):
        d = pol.decide(v)
        if d.action == ACTION_SPLIT:
            break
    assert d is not None and d.action == ACTION_SPLIT
    assert d.hot_sid == "s0"
    rec = d.to_record()
    assert rec["signals"]["per_shard"]["s0"]["p99_ms"] == 500.0
    assert rec["reason"]


def test_policy_oscillation_never_splits():
    """The hysteresis half: a load flapping across the budget every
    other window never accumulates ``hot_windows`` consecutive hot
    samples, so it never fires."""
    pol = AutopilotPolicy(CFG)
    for t in range(40):
        hot = t % 2 == 0
        d = pol.decide(_view(float(t), [0.5 if hot else 0.05, 0.05]))
        assert d.action == ACTION_HOLD, (t, d)


def test_policy_abort_cooldown_not_retry_storm():
    """After an abort the policy HOLDS for abort_cooldown_s even under
    a sustained burn, then (burn persisting) decides exactly once
    more — never a tight retry loop."""
    pol = AutopilotPolicy(CFG)
    t = 0.0
    d = None
    while True:
        d = pol.decide(_view(t, [0.5, 0.05]))
        if d.action == ACTION_SPLIT:
            break
        t += 1.0
    pol.note_outcome(ACTION_SPLIT, OUTCOME_ABORTED, t)
    fired = []
    for dt in range(1, 20):
        d = pol.decide(_view(t + dt, [0.5, 0.05]))
        if d.action != ACTION_HOLD:
            fired.append((dt, d.action))
    # nothing fires inside the 12s abort cooldown; the streak keeps
    # accumulating through it by design (decide advances streaks on
    # every call), so a burn that persists refires on the FIRST view
    # at/past the window's edge — and not one view sooner
    assert fired, "burn persisted past cooldown but never refired"
    assert fired[0][0] == 12, fired
    assert all(dt >= 12 for dt, _ in fired)


def test_policy_commit_cooldown_shorter_than_abort():
    pol = AutopilotPolicy(CFG)
    pol.note_outcome(ACTION_SPLIT, OUTCOME_COMMITTED, 0.0)
    assert pol.decide(_view(4.9, [0.5, 0.05])).action == ACTION_HOLD
    pol2 = AutopilotPolicy(CFG)
    pol2.note_outcome(ACTION_SPLIT, OUTCOME_ABORTED, 0.0)
    # same instant relative to the two cooldowns: commit's has expired
    # (streaks still must refill), abort's has not
    d2 = pol2.decide(_view(5.1, [0.5, 0.05]))
    assert "cooldown" in d2.reason


def test_policy_cold_merge_and_min_shards():
    cold_cfg = PolicyConfig(p99_budget_s=0.2, queue_watermark=10.0,
                            hot_windows=3, cold_windows=3,
                            min_shards=2, max_shards=4,
                            cold_rate_per_shard=100.0)
    pol = AutopilotPolicy(cold_cfg)
    # 3 shards, idle: offered 30 ops/s total < 100 * 2 ⇒ cold
    acts = [pol.decide(_view(float(t), [0.01] * 3, op_rate=10.0)).action
            for t in range(5)]
    assert acts[:2] == [ACTION_HOLD] * 2
    assert ACTION_MERGE in acts
    # at min_shards the same trace only holds
    pol2 = AutopilotPolicy(cold_cfg)
    acts2 = [pol2.decide(_view(float(t), [0.01] * 2,
                               op_rate=10.0)).action
             for t in range(8)]
    assert acts2 == [ACTION_HOLD] * 8


def test_policy_cold_withheld_while_shard_dark():
    """An unreachable shard is 'no evidence', never 'cold': no merge
    may fire while part of the fleet is dark."""
    pol = AutopilotPolicy(CFG)
    for t in range(20):
        d = pol.decide(_view(float(t), [0.01, None, 0.01], op_rate=1.0,
                             reachable=[True, False, True]))
        assert d.action == ACTION_HOLD


def test_policy_max_shards_and_fence_hold():
    pol = AutopilotPolicy(CFG)
    for t in range(6):
        d = pol.decide(_view(float(t), [0.5] * 4))
    assert d.action == ACTION_HOLD and "max_shards" in d.reason
    pol2 = AutopilotPolicy(CFG)
    for t in range(6):
        d = pol2.decide(_view(float(t), [0.5, 0.05], fenced=7))
    assert d.action == ACTION_HOLD and "fenced" in d.reason


# ---------------------------------------------------------------------------
# signals: poll-to-poll windowing
# ---------------------------------------------------------------------------


def _stats(acked, buckets, *, queue=2.0, shed=0, rate=50.0,
           shards=("s0",), dark=()):
    shard_snaps = {}
    for sid in shards:
        if sid in dark:
            shard_snaps[sid] = None
            continue
        shard_snaps[sid] = {
            "counters": {"serve.ops.acked": acked,
                         "serve.shed.overload": shed},
            "gauges": {"serve.queue.depth": queue},
            "observations": {"serve.ingest_latency_s":
                             {"buckets": list(buckets)}}}
    return {"ring": {"generation": 3, "digest": "abc",
                     "shards": list(shards), "fenced": 0,
                     "load_stats": {"loads": [10] * len(shards)}},
            "shards": shard_snaps,
            "autopilot": {"op_rates": {sid: rate for sid in shards}}}


def test_signals_windowing():
    fs = FleetSignals()
    b0 = [0] * 64
    b1 = [0] * 64
    b1[30] = 100  # all this window's samples in one low bucket
    v1 = fs.ingest(_stats(100, b0), 10.0)
    assert v1.per_shard["s0"].p99_s is None  # first poll: no window
    v2 = fs.ingest(_stats(250, b1, shed=30), 13.0)
    s = v2.per_shard["s0"]
    assert s.acked_rate == pytest.approx(50.0)
    assert s.shed_rate == pytest.approx(10.0)
    # bucket 30's nominal upper bound: 1e-6 · √2^30 ≈ 33ms
    assert s.p99_s is not None and 0.01 < s.p99_s < 0.05
    assert s.op_rate == 50.0
    assert v2.generation == 3 and v2.load_stats["loads"] == [10]


def test_signals_counter_regression_reads_zero_not_negative():
    """A shard restart resets its counters; the window across the
    restart must read as no-evidence, never negative rates."""
    fs = FleetSignals()
    fs.ingest(_stats(1000, [0] * 64), 0.0)
    v = fs.ingest(_stats(50, [0] * 64), 1.0)
    assert v.per_shard["s0"].acked_rate == 0.0


def test_signals_unreachable_drops_window():
    fs = FleetSignals()
    fs.ingest(_stats(100, [0] * 64), 0.0)
    v = fs.ingest(_stats(100, [0] * 64, dark=("s0",)), 1.0)
    assert not v.per_shard["s0"].reachable
    assert v.per_shard["s0"].p99_s is None
    # back up: the first reachable poll rebuilds the baseline instead
    # of diffing across the outage
    v = fs.ingest(_stats(5, [0] * 64), 2.0)
    assert v.per_shard["s0"].reachable
    assert v.per_shard["s0"].acked_rate == 0.0


def test_view_imbalance():
    per = {
        "s0": ShardSignals("s0", True, 90.0, 0, 0, 0, None),
        "s1": ShardSignals("s1", True, 10.0, 0, 0, 0, None),
    }
    v = FleetView(0.0, 0, "d", ("s0", "s1"), 0, {}, per)
    assert v.imbalance() == pytest.approx(1.8)


# ---------------------------------------------------------------------------
# standby pool
# ---------------------------------------------------------------------------


def test_pool_roster_order_and_lifo_drain():
    pool = StandbyPool([("a", ("h", 1)), ("b", ("h", 2)),
                        ("c", ("h", 3))])
    assert pool.next_join()[0] == "a"
    pool.note_joined("a")
    pool.note_joined("b")
    assert pool.next_join()[0] == "c"
    assert pool.next_leave() == "b"  # LIFO: drain the newest first
    pool.note_left("b")
    assert pool.next_leave() == "a"


def test_pool_adopt_from_ring():
    pool = StandbyPool([("a", ("h", 1)), ("b", ("h", 2))])
    adopted = pool.adopt(["s0", "s1", "b"])
    assert adopted == ["b"] and pool.deployed == ["b"]
    assert pool.next_join()[0] == "a"
    with pytest.raises(ValueError):
        StandbyPool([("a", ("h", 1)), ("a", ("h", 2))])


# ---------------------------------------------------------------------------
# the loop against a real in-process fleet
# ---------------------------------------------------------------------------

E, A = 64, 5


@pytest.fixture()
def fleet(tmp_path):
    from go_crdt_playground_tpu_torch.serve import ServeFrontend
    from go_crdt_playground_tpu_torch.shard.router import ShardRouter

    fes = [ServeFrontend(E, A, actor=i, device="cpu",
                         durable_dir=str(tmp_path / f"s{i}"),
                         max_batch=8, flush_ms=1.0, queue_depth=32)
           for i in range(3)]
    addrs = {f"s{i}": fe.serve() for i, fe in enumerate(fes)}
    router = ShardRouter({k: v for k, v in addrs.items() if k != "s2"},
                         E, seed=5,
                         state_dir=str(tmp_path / "router-state"))
    raddr = router.serve()
    yield {"addrs": addrs, "router": router, "raddr": raddr,
           "tmp": tmp_path}
    router.close()
    for fe in fes:
        fe.close()


def _pilot(fleet, *, log_name="decisions.jsonl", **cfg_kw):
    cfg = PolicyConfig(**{**dict(queue_watermark=0.0, hot_windows=2,
                                 cooldown_s=2.0, max_shards=4), **cfg_kw})
    return FleetAutopilot(
        fleet["raddr"], [("s2", fleet["addrs"]["s2"])], config=cfg,
        poll_interval_s=30.0,  # cycles are test-driven via run_cycle
        decision_log=str(fleet["tmp"] / log_name), seed=3)


def test_controller_split_then_restart_resumes(fleet):
    """The loop end to end: a burn (queue_watermark=0 makes every view
    hot) splits the hot keyspace onto the standby via a REAL handoff;
    a NEW controller then resumes from the router's persisted
    committed ring — the standby reads as deployed, no double-join."""
    from go_crdt_playground_tpu_torch.control.controller import \
        read_decision_log
    from go_crdt_playground_tpu_torch.serve.client import ServeClient

    pilot = _pilot(fleet)
    resumed = pilot.start()
    assert resumed["generation"] == 0
    assert resumed["deployed_adopted"] == []
    try:
        deadline = time.monotonic() + 60.0
        while (pilot.pool.deployed != ["s2"]
               and time.monotonic() < deadline):
            pilot.run_cycle()
            time.sleep(0.05)
        assert pilot.pool.deployed == ["s2"]
    finally:
        pilot.stop()
    with ServeClient(fleet["raddr"]) as c:
        snap = c.stats()
    assert "s2" in snap["ring"]["shards"]
    assert snap["ring"]["generation"] == 1
    # the STATS surface the controller read: load_stats + op_rates
    assert len(snap["ring"]["load_stats"]["loads"]) == 3
    assert "op_rates" in snap["autopilot"]

    # the decision log holds the split decision WITH its triggering
    # signals and the committed outcome
    recs = read_decision_log(str(fleet["tmp"] / "decisions.jsonl"))
    assert recs[0]["record"] == "resume"
    splits = [r for r in recs if r["record"] == "decision"
              and r["action"] == ACTION_SPLIT]
    assert splits and splits[0]["signals"]["per_shard"]
    outs = [r for r in recs if r["record"] == "outcome"]
    assert outs and outs[0]["outcome"] == "committed"
    assert outs[0]["sid"] == "s2"

    # controller restart: the router's committed ring is the truth
    pilot2 = _pilot(fleet, log_name="d2.jsonl")
    resumed2 = pilot2.start()
    try:
        assert resumed2["generation"] == 1
        assert resumed2["deployed_adopted"] == ["s2"]
        # with the pool exhausted, a further burn skips (logged +
        # cooled), never re-joins the deployed standby
        for _ in range(4):
            pilot2.run_cycle()
    finally:
        pilot2.stop()
    recs2 = read_decision_log(str(fleet["tmp"] / "d2.jsonl"))
    joins = [r for r in recs2 if r["record"] == "outcome"
             and r.get("action") == ACTION_SPLIT
             and r.get("outcome") == "committed"]
    assert joins == []
    skips = [r for r in recs2 if r["record"] == "outcome"
             and r.get("outcome") == "skipped"]
    assert skips, recs2


def test_actuator_typed_abort_no_retry(fleet):
    """Joining a sid already in the ring is a deterministic typed
    abort: ONE attempt, outcome 'aborted', old ring untouched."""
    from go_crdt_playground_tpu_torch.obs import Recorder
    from go_crdt_playground_tpu_torch.serve.client import ServeClient

    rec = Recorder()
    act = ReshardActuator(fleet["raddr"], reshard_timeout_s=30.0,
                          recorder=rec, seed=1)
    out = act.join("s0", fleet["addrs"]["s0"])
    assert out.outcome == "aborted" and out.attempts == 1
    assert "already in the ring" in out.detail["reason"]
    assert rec.counter("control.actions.aborted") == 1
    assert rec.counter("control.actuator.retries") == 0
    with ServeClient(fleet["raddr"]) as c:
        assert c.stats()["ring"]["generation"] == 0


def test_actuator_unreachable_never_sends_without_baseline():
    """A dark router means no pre-action generation baseline, and
    without a baseline a transport-ambiguous verb could never be
    adjudicated — so the actuator retries the BASELINE read, then
    reports unreachable WITHOUT ever sending the verb."""
    from go_crdt_playground_tpu_torch.obs import Recorder
    from go_crdt_playground_tpu_torch.utils.backoff import BackoffPolicy

    rec = Recorder()
    act = ReshardActuator(
        ("127.0.0.1", 1), reshard_timeout_s=5.0, recorder=rec, seed=1,
        policy=BackoffPolicy(base_s=0.01, multiplier=2.0, cap_s=0.05,
                             jitter=0.1, max_retries=2))
    out = act.leave("s0")
    assert out.outcome == "unreachable"
    assert out.attempts == 0  # the verb was never sent
    assert "never sent" in out.detail["reason"]
    assert rec.counter("control.actions.unreachable") == 1
    assert rec.counter("control.actuator.retries") == 2


# ---------------------------------------------------------------------------
# decision-log reader
# ---------------------------------------------------------------------------


def test_read_decision_log_tolerates_torn_tail(tmp_path):
    from go_crdt_playground_tpu_torch.control.controller import \
        read_decision_log

    p = str(tmp_path / "log.jsonl")
    with open(p, "w") as f:
        f.write('{"record": "resume", "seq": 0}\n')
        f.write('{"record": "decision", "seq": 1}\n')
        f.write('{"record": "outco')  # SIGKILL mid-append
    recs = read_decision_log(p)
    assert [r["seq"] for r in recs] == [0, 1]
    assert read_decision_log(str(tmp_path / "absent.jsonl")) == []


# ---------------------------------------------------------------------------
# the two packages side by side
# ---------------------------------------------------------------------------


def _package(name):
    if name == "jax":
        from go_crdt_playground_tpu import control
        from go_crdt_playground_tpu.control import controller, signals
    else:
        from go_crdt_playground_tpu_torch import control
        from go_crdt_playground_tpu_torch.control import controller, signals
    return control, controller, signals


def _views(signals, sigs):
    """Views as FleetViews of one package: each of ``sigs`` in the form a
    decision record keeps them (``t``, ``generation``, ``shards``,
    ``fenced``, ``router_epoch``, ``shard_epochs`` and ``per_shard``'s
    rates, queue depth and p99 in ms)."""
    out = []
    for s in sigs:
        per = {sid: signals.ShardSignals(
            sid, v["reachable"], v["op_rate"], v["acked_rate"],
            v["shed_rate"], v["queue_depth"],
            None if v["p99_ms"] is None else v["p99_ms"] / 1e3)
            for sid, v in s["per_shard"].items()}
        out.append(signals.FleetView(
            t=s["t"], generation=s["generation"], digest="",
            shards=tuple(s["shards"]), fenced=s["fenced"], load_stats={},
            per_shard=per, router_epoch=s["router_epoch"],
            shard_epochs=s["shard_epochs"]))
    return out


def _trace(seed, n=60):
    """A seeded view trace (hot, cold, dark shards, shard counts 1-4) in
    the form ``_views`` reads."""
    import numpy as np

    rng = np.random.default_rng(seed)
    trace, k = [], 2
    for t in range(n):
        k = int(min(4, max(1, k + rng.integers(-1, 2))))
        p99s = [(50.0, 500.0, None)[int(rng.integers(0, 3))]
                for _ in range(k)]
        queue = [float(rng.integers(0, 20)) for _ in range(k)]
        reach = [bool(rng.random() < 0.9) for _ in range(k)]
        op_rate = float(rng.choice([5.0, 50.0, 400.0]))
        shards = [f"s{i}" for i in range(k)]
        trace.append({
            "t": float(t), "generation": 0, "shards": shards, "fenced": 0,
            "router_epoch": 0, "shard_epochs": None,
            "per_shard": {sid: {
                "reachable": reach[i], "op_rate": op_rate,
                "acked_rate": op_rate, "shed_rate": 0.0,
                "queue_depth": queue[i], "p99_ms": p99s[i]}
                for i, sid in enumerate(shards)}})
    return trace


def _replay(name, config, seed, sigs, outcome):
    """``sigs`` through one package's ``AutopilotPolicy`` (``config`` a
    dict of ``PolicyConfig``'s fields): each decision's record, and
    after each action ``policy.note_outcome(action, *outcome(i, view))``
    where ``outcome`` gives one."""
    control, _, signals = _package(name)
    policy = control.AutopilotPolicy(control.PolicyConfig(**config),
                                     seed=seed)
    out = []
    for i, view in enumerate(_views(signals, sigs)):
        d = policy.decide(view)
        out.append(d.to_record())
        noted = outcome(i, view) if d.action != "hold" else None
        if noted is not None:
            policy.note_outcome(d.action, *noted)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_policies_decide_alike_across_packages(seed):
    """One seeded view trace (hot, cold, dark shards, shard counts
    1-4), the outcomes fed back alike: decision for decision equal."""
    config = dict(p99_budget_s=0.2, queue_watermark=10.0, hot_windows=2,
                  cold_windows=3, cooldown_s=3.0, abort_cooldown_s=6.0,
                  min_shards=1, max_shards=4, cold_rate_per_shard=100.0)
    records = {name: _replay(
        name, config, seed, _trace(seed),
        lambda i, view: (("committed", "aborted", "skipped")[i % 3],
                         view.t)) for name in ("jax", "torch")}
    assert records["torch"] == records["jax"]
    assert {r["action"] for r in records["torch"]} >= {"hold", "split"}


AUTOPILOT_TRACE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "fixtures", "torch_autopilot_trace.json")


def _through_first_action(records):
    """The decisions up to and including the first that is not a hold,
    each as ``(seq, action, reason, hot_sid)`` (a replayed record's
    signals differ from the recorded ones in the rounding of derived
    fields such as ``imbalance``)."""
    out = []
    for r in records:
        if r.get("record", "decision") != "decision":
            continue
        out.append((r["seq"], r["action"], r["reason"], r["hot_sid"]))
        if r["action"] != "hold":
            break
    return out


def test_recorded_autopilot_trace_decides_alike_across_packages():
    """A recorded decision log of the autopilot soak
    (tests/fixtures/torch_autopilot_trace.json, written by
    tools/torch_autopilot_baseline.py: the first controller's log
    through its first split's outcome): the recorded views through both
    packages' policies, at the configuration and seed of its resume
    record, each outcome noted at its decision's time plus the
    actuation's ``elapsed_s``, give equal decisions, and those equal
    the recorded ones through the first split; the baseline window
    holds exactly when the run held."""
    import json

    with open(AUTOPILOT_TRACE) as f:
        trace = json.load(f)
    log = trace["decision_log"]
    resume = next(r for r in log if r.get("record") == "resume")
    decisions = [r for r in log if r.get("record") == "decision"]
    outcomes = {r["decision_seq"]: r for r in log
                if r.get("record") == "outcome"}

    def outcome(i, view):
        o = outcomes.get(decisions[i]["seq"])
        return None if o is None else (
            o["outcome"], view.t + (o.get("elapsed_s") or 0.0))

    got = {name: _replay(name, resume["policy"], resume["seed"],
                         [r["signals"] for r in decisions], outcome)
           for name in ("jax", "torch")}
    assert got["torch"] == got["jax"]
    first = _through_first_action(log)
    assert first[-1][1] == "split"
    assert _through_first_action(got["torch"]) == first
    end = trace["baseline_window_t"][1]
    baseline = [r["action"] for r in decisions if r["signals"]["t"] <= end]
    held = trace["summary"]["after_baseline_generation"] == 0
    assert baseline and (set(baseline) == {"hold"}) == held


class _StubClient:
    closed = False

    def __init__(self, replies):
        self.replies = list(replies)

    def stats(self):
        return self.replies.pop(0)

    def close(self):
        pass


class _Clock:
    def __init__(self):
        self.now = 100.0

    def monotonic(self):
        self.now += 0.25
        return self.now

    def sleep(self, s):
        self.now += s


class _StubActuator:
    def __init__(self, outcome_cls):
        self.cls = outcome_cls
        self.reshard_timeout_s = 1.0
        self.calls = 0

    def _outcome(self, action, sid):
        self.calls += 1
        outcome = ("committed", "aborted")[self.calls % 2 == 0]
        return self.cls(outcome, action, sid,
                        {"generation": self.calls, "moved": 7 * self.calls,
                         "fence_s": 0.01 * self.calls}, 0.5, 1)

    def join(self, sid, addr):
        return self._outcome("join", sid)

    def leave(self, sid):
        return self._outcome("leave", sid)


TIME_FIELDS = ("t", "elapsed_s")


def test_decision_logs_equal_across_packages(tmp_path, monkeypatch):
    """Two controllers, one per package, fed the same STATS replies on
    the same clock with the same actuation outcomes: their decision
    logs are equal line for line outside the time fields."""
    import json

    replies = []
    for i in range(40):
        hot = 8 <= i < 24
        n = 2 + (i >= 14)
        snap = _stats(100 * (i + 1), [0] * 64, queue=30.0 if hot else 1.0,
                      rate=400.0 if hot else 5.0,
                      shards=tuple(f"s{k}" for k in range(n)))
        replies.append(snap)
    lines = {}
    for name in ("jax", "torch"):
        control, controller, _ = _package(name)
        monkeypatch.setattr(controller, "time", _Clock())
        log = str(tmp_path / f"{name}.jsonl")
        pilot = controller.FleetAutopilot(
            ("127.0.0.1", 9), [("s2", ("127.0.0.1", 8)),
                               ("s3", ("127.0.0.1", 7))],
            config=control.PolicyConfig(
                p99_budget_s=0.2, queue_watermark=10.0, hot_windows=2,
                cold_windows=3, cooldown_s=2.0, abort_cooldown_s=4.0,
                min_shards=2, max_shards=4, cold_rate_per_shard=100.0),
            poll_interval_s=30.0, decision_log=log, seed=5)
        client = _StubClient(json.loads(json.dumps(replies)))
        pilot._client = lambda c=client: c
        pilot.actuator = _StubActuator(control.ActionOutcome)
        pilot.start()
        pilot.stop()
        while client.replies:
            pilot.run_cycle()
        with open(log) as f:
            lines[name] = [json.loads(line) for line in f]
    assert len(lines["torch"]) == len(lines["jax"]) > 40
    for ours, theirs in zip(lines["torch"], lines["jax"]):
        for rec in (ours, theirs):
            for field in TIME_FIELDS:
                rec.pop(field, None)
        assert ours == theirs
    kinds = {(r["record"], r.get("outcome")) for r in lines["torch"]}
    assert ("outcome", "committed") in kinds
    assert ("outcome", "aborted") in kinds


def test_control_modules_load_no_torch():
    """The autopilot and the router standby are host-only: importing
    them loads no torch."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import go_crdt_playground_tpu_torch.control\n"
            "import go_crdt_playground_tpu_torch.shard.ha\n"
            "import go_crdt_playground_tpu_torch.shard.fleet\n"
            "assert 'torch' not in sys.modules\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=repo, check=True,
                   timeout=120)
