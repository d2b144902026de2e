"""tools/torch_fleet_serve_soak.py and tools/torch_chaos_soak.py: the
port's fleet soak and digest chaos leg.

Each fleet-soak mode's quick run spawns real ``serve --ingest`` shards
and a ``router --serve`` of the port on the CPU and SIGKILLs some, so
those tests are marked ``slow`` (as tests/test_fleet_serve_soak.py is).
The named checks' adjudication and the chaos leg run here directly."""

import copy
import json
import os
import sys
from typing import Dict

import pytest

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

MODES = {"sweep": [], "router_ha": ["--router-ha"],
         "shard_repl": ["--shard-repl"], "autopilot": ["--autopilot"],
         "mesh": ["--mesh"], "zipf": ["--zipf"]}


@pytest.mark.slow
@pytest.mark.parametrize("mode", sorted(MODES))
def test_fleet_soak_quick_mode_on_cpu(tmp_path, mode):
    import torch_fleet_serve_soak as soak

    out = str(tmp_path / "fleet.json")
    rc = soak.main(["--quick", "--device", "cpu", "--out", out,
                    *MODES[mode]])
    with open(out) as f:
        res = json.load(f)
    assert res["mode"] == mode and res["device"] == "cpu"
    assert res["guarantee_failures"] == [] and res["failures"] == [], res
    assert rc == 0


def test_mesh_and_zipf_modes_are_refused():
    """The mesh and zipf modes run now (the port has the mesh replicas
    and the scheduler); asking for two modes at once is refused, and a
    mesh worker's slots take card 0 when the device is ``cuda``."""
    import torch_fleet_serve_soak as soak

    for flags in (("--mesh", "--zipf"), ("--mesh", "--router-ha")):
        with pytest.raises(SystemExit) as e:
            soak.main(["--quick", "--device", "cpu", *flags])
        assert e.value.code == 2
    old = soak.DEVICE
    try:
        for device, slots in (("cuda", "cuda:0"), ("cuda:1", "cuda:1"),
                              ("cpu", "cpu")):
            soak.DEVICE = device
            assert soak.mesh_device() == slots
            spec = soak._mesh_spec("2x2", 144, 29, sched="on")
            assert spec.device == slots
            assert spec.extra_args == ("--mesh-devices", "2x2", "--sched",
                                       "on")
        with pytest.raises(ValueError):
            soak._mesh_spec("2x", 144, 29)
    finally:
        soak.DEVICE = old


def _mesh_result():
    """A --mesh result that meets every check."""
    leg = {"unresolved": 0, "goodput": 400.0}
    crash = {"outage": {"typed_unavailable": 3, "unresolved": 0},
             "victim_acked_before_kill": 50, "lost_acked_ops": [],
             "phantom_members": [], "unfinished": []}
    return {
        "serve_curve": [dict(leg, mesh_devices=n, worker_banner_mesh=str(n))
                        for n in (1, 2)],
        "serve_curve_2d": [
            dict(leg, mesh_devices=s, worker_banner_mesh=s,
                 server_mesh={"rows_per_dispatch": r})
            for s, r in (("1x2", 4.0), ("2x2", 7.5))],
        "parity": {"bitwise_equal": True, "ops": 172},
        "parity_2d": {"bitwise_equal": True, "ops": 172},
        "crash": copy.deepcopy(crash), "crash_2d": copy.deepcopy(crash)}


def _zipf_result():
    """A --zipf result that meets every check."""
    def leg(spec, s, sched, cps, rpd):
        return {"unresolved": 0, "goodput": 800.0, "mesh_devices": spec,
                "worker_banner_mesh": spec, "worker_banner_sched": sched,
                "zipf_s": s, "sched": sched,
                "server_mesh": {"cuts_per_super_batch": cps,
                                "rows_per_dispatch": rpd}}

    return {
        "zipf_curve": [leg(spec, s, "on", 0.0, rpd) for s in (0.99, 1.2)
                       for spec, rpd in (("1x2", 6.0), ("4x2", 20.0))],
        "zipf_baseline": leg("4x2", 1.2, "off", 1.5, 9.0),
        "zipf_replay": {"bitwise_equal": True, "members_agree": True,
                        "acked_adds": 90, "lost_acked_ops": [],
                        "phantom_members": [],
                        "traffic": {"unresolved": 0}}}


@pytest.mark.parametrize("case", [
    None, ("mesh", "parity", "bitwise_equal", False),
    ("mesh", "crash_2d", "lost_acked_ops", [7]),
    ("zipf", "zipf_baseline", "server_mesh",
     {"cuts_per_super_batch": 0.0, "rows_per_dispatch": 9.0}),
    ("zipf", "zipf_replay", "members_agree", False)])
def test_mesh_and_zipf_checks_name_each_failure(case):
    import torch_fleet_serve_soak as soak

    for mode, build, checks in (("mesh", _mesh_result, soak.checks_mesh),
                                ("zipf", _zipf_result, soak.checks_zipf)):
        r = build()
        if case is not None and case[0] == mode:
            r[case[1]][case[2]] = case[3]
        failed = [c.name for c in checks(r) if not c.ok]
        if case is None or case[0] != mode:
            assert failed == [], failed
        else:
            assert len(failed) == 1, failed


def _sweep_result():
    """A default-sweep result that meets every check."""
    ledger = {"lost_acked_ops": [], "phantom_members": [],
              "unfinished": []}
    return {
        "shard_curve": [{"shards": 1, "unresolved": 0, "goodput": 600.0},
                        {"shards": 3, "unresolved": 0, "goodput": 600.0}],
        "kill_leg": {"outage": {"typed_unavailable": 5,
                                "acked_survivor": 9, "unresolved": 0},
                     "victim_acked_before_kill": 20, **ledger},
        "reshard_leg": {
            "events": [
                {"event": "join_recipient_killed_mid_handoff", "ok": False,
                 "joiner_died": True, "ring_unchanged": True},
                {"event": "join_committed_via_cli", "ok": True,
                 "cli_rc": 0, "digest_changed": True, "moved": 44,
                 "observed_fraction": 0.3, "predicted_fraction": 0.3,
                 "fence_s": 0.01},
                {"event": "leave_committed", "ok": True,
                 "digest_restored": True, "fence_s": 0.01}],
            "finished": True, "traffic": {"unresolved": 0}, **ledger},
        "chaos_leg": {"proxy": {"truncated": 1, "refused": 1},
                      "outage": {"typed_unavailable": 4,
                                 "acked_survivor_during_chaos": 7,
                                 "unresolved": 0}, **ledger},
    }


# one broken reading each, the check it fails, and whether that check
# is one of the guarantees
BROKEN = {
    "unresolved": (("shard_curve", 1, "unresolved"), 2,
                   "sweep/unresolved", True),
    "no goodput": (("shard_curve", 0, "goodput"), 0.0, "sweep/goodput",
                   False),
    "no outage": (("kill_leg", "outage", "typed_unavailable"), 0,
                  "kill/typed_unavailable", False),
    "kill lost": (("kill_leg", "lost_acked_ops"), [4],
                  "kill/lost_acked_ops", True),
    "abort swapped": (("reshard_leg", "events", 0, "ring_unchanged"),
                      False, "reshard/join_abort_typed_old_ring_serving",
                      True),
    "remap": (("reshard_leg", "events", 1, "observed_fraction"), 0.31,
              "reshard/join_remap_fraction", True),
    "slow fence": (("reshard_leg", "events", 1, "fence_s"), 20.0,
                   "reshard/join_fence_s", False),
    "digest": (("reshard_leg", "events", 2, "digest_restored"), False,
               "reshard/leave_committed_digest_restored", True),
    "phantom": (("reshard_leg", "phantom_members"), [9],
                "reshard/phantom_members", True),
    "no chaos": (("chaos_leg", "proxy", "refused"), 0,
                 "chaos/proxy_faults", False),
    "chaos unfinished": (("chaos_leg", "unfinished"), [3],
                         "chaos/unfinished", True),
}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_sweep_checks_name_each_failure(case):
    """A result meeting every check passes; one broken reading fails
    exactly its named check, a guarantee or a load-shape check as the
    reference's adjudication treats it."""
    import torch_fleet_serve_soak as soak

    assert [c for c in soak.checks_sweep(_sweep_result(), True)
            if not c.ok] == []
    path, value, name, guarantee = BROKEN[case]
    res = copy.deepcopy(_sweep_result())
    target = res
    for key in path[:-1]:
        target = target[key]
    target[path[-1]] = value
    failed = [c for c in soak.checks_sweep(res, True) if not c.ok]
    assert [(c.name, c.guarantee) for c in failed] == [(name, guarantee)]


def test_chaos_soak_converges_on_torch_nodes(tmp_path):
    """tools/torch_chaos_soak.py --chaos-leg on CPU nodes: the
    fleet converges and its fault census equals the JAX leg's."""
    import torch_chaos_soak

    out = str(tmp_path / "chaos.json")
    assert torch_chaos_soak.main(["--chaos-leg", "--device", "cpu",
                                  "--out", out]) == 0
    with open(out) as f:
        res = json.load(f)
    assert res["converged"] and res["fault_kinds_missing"] == []
    assert set(res["fault_kinds_expected"]) >= {"refused", "dropped",
                                                "truncated"}
    assert res["census_equal"] is True
    assert res["digest_exchanges"] > 0


@pytest.mark.parametrize("reference", ["missing", "unreadable", "other"])
def test_chaos_soak_fails_without_the_jax_census(tmp_path, reference):
    """A missing or unreadable reference fails the leg, and so does a
    census that departs from the reference's."""
    import torch_chaos_soak

    ref = tmp_path / "SYNC_CURVE.json"
    if reference == "unreadable":
        ref.write_text("{not json")
    elif reference == "other":
        with open(os.path.join(torch_chaos_soak.REPO, "SYNC_CURVE.json")) as f:
            curve = json.load(f)
        curve["chaos"]["faults_injected"]["refused"] += 1
        ref.write_text(json.dumps(curve))
    out = str(tmp_path / "chaos.json")
    assert torch_chaos_soak.main(["--chaos-leg", "--device", "cpu",
                                  "--out", out, "--reference", str(ref)]) == 1
    with open(out) as f:
        res = json.load(f)
    assert res["converged"]
    assert res["census_equal"] is False


# -- the autopilot leg's calibration -----------------------------------------


class _Shard:
    """A one-op shard whose readers parse every frame (``c_read`` s of
    the interpreter lock each; tools/torch_serve_admission.py read
    1.28-1.62 ms of reader CPU a frame on an H100 80GB HBM3's host),
    whose batcher applies each admitted
    op (``c_apply``) and whose queue holds ``queue`` ops.  Offered
    ``rate`` for one window from an empty queue, it acks all of it up
    to its knee, 1 / (c_read + c_apply), and sheds once the excess has
    filled the queue; shedding, it acks only what the readers leave of
    each second, (1 - rate c_read) / c_apply."""

    def __init__(self, knee: float, c_read: float = 1.35e-3,
                 queue: int = 64):
        self.knee, self.c_read, self.queue = knee, c_read, queue
        self.c_apply = 1.0 / knee - c_read

    def offer(self, rate: float) -> Dict[str, float]:
        if rate <= self.knee + self.queue:
            return {"s": 1.0, "offered": rate, "acked": rate, "shed": 0}
        acked = max(0.0, 1.0 - rate * self.c_read) / self.c_apply
        return {"s": 1.0, "offered": rate, "acked": acked,
                "shed": rate - acked}


class _WarmingShard:
    """A one-op shard (``_Shard``) whose knee rises with the seconds
    since its fleet started, on ``clock``: ``first`` until ``rise[0]``,
    then linearly to ``late`` at ``rise[1]``.  Fitted to a failed whole
    chip_smoke.py run on an H100 80GB HBM3's host, whose calibration
    right after the start read s1's onset at 227.9 ops/s (its ramp: 250
    shed, 227.3 shed, 206.6 clean, 227.3 shed in two windows of three)
    and whose burn then offered s1 about 264 ops/s, absorbed without a
    shed; and to the onsets of the passing legs, about 450 ops/s: a
    knee of 160 (an onset of 224, the queue's 64 ops above it) rising to
    386.  Each window takes 1.1 s of the clock (1 s offered, then its
    ops resolved), and reads its age as ``shard_offer`` does."""

    def __init__(self, clock, first: float = 160.0, late: float = 386.0,
                 rise=(6.0, 16.0)):
        self.clock, self.first, self.late, self.rise = (clock, first, late,
                                                        rise)

    def knee(self, t: float) -> float:
        f = min(1.0, max(0.0, (t - self.rise[0])
                         / (self.rise[1] - self.rise[0])))
        return self.first + f * (self.late - self.first)

    def offer(self, rate: float) -> Dict[str, float]:
        out = dict(_Shard(self.knee(self.clock.t)).offer(rate),
                   age_s=round(self.clock.t, 2))
        self.clock.t += 1.1
        return out


class _Clock:
    """Seconds since the leg's fleet started."""
    t = 0.0


def _recording(offer):
    """``offer`` that also records the rates it was asked for."""
    calls = []

    def wrapped(rate):
        calls.append(round(rate, 1))
        return offer(rate)

    return wrapped, calls


def test_capacity_is_the_onset_of_shedding():
    """A shard fitted to H100 80GB HBM3 readings of the autopilot leg's
    one-op shard (486.0 ops/s acked of 488.3 offered without a shed,
    245.5-284.7 of 610.4 while shedding): the capacity is the offered
    rate from which it sheds in most of three windows, not its acked
    rate while it sheds (about half) nor the rate a step below."""
    import torch_fleet_serve_soak as soak

    shard = _Shard(knee=500.0)
    assert shard.offer(488.3)["shed"] == 0
    assert 240.0 < shard.offer(610.4)["acked"] < 290.0
    offer, calls = _recording(shard.offer)
    cal = soak.measure_capacity(offer)
    assert cal["capacity_ops_s"] == 589.5 and cal["saturated"]
    assert cal["below_onset_acked_ops_s"] == 535.9
    assert max(cal["window_acked_ops_s"]) < 0.6 * cal["capacity_ops_s"]
    assert calls == [250.0, 275.0, 302.5, 332.8, 366.0, 402.6, 442.9,
                     487.2, 535.9, 589.5, 589.5, 589.5]
    assert soak.CAPACITY_WINDOWS >= 3 and soak.CAPACITY_WINDOW_S >= 1.0
    assert [r["shed"] > 0 for r in cal["ramp"]] == [False] * 9 + [True]
    assert cal["acked_spread"] == 0.0


def test_an_onset_below_the_start_steps_down():
    """A shard that already sheds at the ramp's first rate: the ramp
    steps down until a rate does not shed, and the onset is the next
    rate up, with the clean step's acked rate beside it; a shard that
    sheds at every rate is refused, not read at the start."""
    import torch_fleet_serve_soak as soak

    offer, calls = _recording(_Shard(knee=150.0).offer)
    cal = soak.measure_capacity(offer)
    assert calls == [250.0, 227.3, 206.6, 227.3, 227.3, 227.3]
    assert cal["capacity_ops_s"] == 227.3 and cal["saturated"]
    assert cal["below_onset_acked_ops_s"] == 206.6
    assert [r["shed"] > 0 for r in cal["ramp"]] == [True, True, False, True]

    def always(rate):
        return {"s": 1.0, "offered": rate, "acked": rate / 2,
                "shed": rate / 2}

    with pytest.raises(RuntimeError, match="above a clean step"):
        soak.measure_capacity(always)


def test_spread_windows_are_measured_again():
    """Onset windows whose acked rates lie further apart than
    CAPACITY_SPREAD of their median are measured again; windows that
    stay spread through CAPACITY_RETRIES new measurements are
    refused."""
    import torch_fleet_serve_soak as soak

    shard = _Shard(knee=500.0)
    knocked = []  # per shedding window: does it lose half its acks?

    def offer(rate):
        out = shard.offer(rate)
        if out["shed"] and knocked and knocked.pop(0):
            return dict(out, acked=out["acked"] / 2)
        return out

    spread = soak.capacity_estimate([shard.offer(600.0),
                                     dict(shard.offer(600.0), acked=150.0)])
    assert spread["acked_spread"] > soak.CAPACITY_SPREAD
    offer, calls = _recording(offer)
    knocked[:] = [False, True, False, False, False, False]
    cal = soak.measure_capacity(offer)
    assert cal["capacity_ops_s"] == 589.5 and cal["acked_spread"] == 0.0
    assert [a["acked_spread"] > soak.CAPACITY_SPREAD
            for a in cal["attempts"]] == [True, False]
    assert calls.count(589.5) == 6
    knocked[:] = [False, True, False] * (1 + soak.CAPACITY_RETRIES)
    with pytest.raises(RuntimeError, match="stayed spread"):
        soak.measure_capacity(offer)


def test_a_stall_is_not_the_onset():
    """A window that sheds where the next two at its rate do not (a
    stall) leaves the ramp going, and two of three that shed stop it; a
    shard no rate saturates is refused."""
    import torch_fleet_serve_soak as soak

    shard = _Shard(knee=500.0)
    stalls = iter([True, False, False])

    def offer(rate):
        out = shard.offer(rate)
        if 360.0 < rate < 370.0 and next(stalls):
            return dict(out, acked=rate - 30.0, shed=30.0)
        return out

    offer, calls = _recording(offer)
    cal = soak.measure_capacity(offer)
    assert cal["capacity_ops_s"] == 589.5
    assert [a["saturated"] for a in cal["attempts"]] == [False, True]
    assert calls.count(366.0) == 3
    stalls = iter([True, False, True])
    cal = soak.measure_capacity(offer)
    assert cal["capacity_ops_s"] == 366.0
    assert cal["window_shed"] == [30, 0, 30]
    with pytest.raises(RuntimeError, match="saturated the shard"):
        soak.measure_capacity(_Shard(knee=1e6).offer)


def test_capacity_offer_reads_one_window(tmp_path):
    """``shard_offer`` against a live CPU frontend (a durable one-op
    batcher behind an 8-deep queue): one window of deletes, every op
    resolved, sheds past its capacity and none far below it; deletes
    only, so no member appears."""
    import torch_fleet_serve_soak as soak
    from go_crdt_playground_tpu_torch.serve.client import ServeClient
    from go_crdt_playground_tpu_torch.serve.frontend import ServeFrontend

    fe = ServeFrontend(32, 2, actor=0, device="cpu", queue_depth=8,
                       max_batch=1, flush_ms=5.0,
                       durable_dir=str(tmp_path / "d"),
                       checkpoint_every=0)
    try:
        addr = fe.serve(port=0)
        offer = soak.shard_offer(addr, list(range(16)), 32, window_s=0.5)
        past = offer(3000.0)
        assert past["s"] == 0.5 and past["acked"] > 0 and past["shed"] > 0
        assert offer(20.0)["shed"] == 0
        with ServeClient(addr, timeout=10.0) as c:
            assert list(c.members()[0]) == []
    finally:
        fe.close()


@pytest.mark.parametrize("capacity", [250.0, 400.0, 600.0])
def test_planned_loads_for_seed_29(capacity):
    """Seed 29's ring and key pickers, replayed over the ops each leg
    offers: the baseline's hottest shard s0 takes 0.558 of its ops and
    the burn's s1 0.725 (the shares over 20,000 draws), each within
    three sampling errors sqrt(p (1 - p) / n) of a share over the leg's
    n draws; in units of the capacity, 0.558 x 0.72 and 0.725 x 1.6."""
    import math

    import torch_fleet_serve_soak as soak
    from go_crdt_playground_tpu_torch.shard.ring import HashRing

    ring0 = HashRing(["s0", "s1"], seed=29)
    ring4 = ring0.with_shard("s2").with_shard("s3")
    hot = soak.hot_key_set(ring0, ring4, 192, "s1")
    assert len(hot) == 12 and {ring0.owner(e) for e in hot} == {"s1"}
    assert len({ring4.owner(e) for e in hot}) == 3
    scale = capacity / soak.REF_SHARD_CAPACITY
    base, burn = soak.REF_RATES["base"] * scale, soak.REF_RATES["burn"] * scale
    n_base, n_burn = round(base * 5.0), round(burn * 16.0)
    plan = soak.planned_loads(192, 29, ring0, hot, n_base, n_burn)
    assert plan["draws"] == [n_base, n_burn]
    for share, want, n in ((plan["baseline"]["s0"], 0.558, n_base),
                           (plan["burn"]["s1"], 0.725, n_burn)):
        assert abs(share - want) <= 3 * math.sqrt(want * (1 - want) / n)
    assert max(plan["baseline"], key=plan["baseline"].get) == "s0"
    assert abs(plan["baseline"]["s0"] * base / capacity
               - 0.558 * 0.72) <= 0.72 * 3 * math.sqrt(0.558 * 0.442 / n_base)
    assert abs(plan["burn"]["s1"] * burn / capacity
               - 0.725 * 1.6) <= 1.6 * 3 * math.sqrt(0.725 * 0.275 / n_burn)
    big = soak.planned_loads(192, 29, ring0, hot, 20_000, 20_000)
    assert round(big["baseline"]["s0"], 3) == 0.558
    assert round(big["burn"]["s1"], 3) == 0.725


def _carrying(limit: float = float("inf")):
    """A ``carry`` whose router and client carry the rate offered up to
    ``limit`` ops/s, and the rates it was asked for."""
    calls = []

    def carry(rate):
        calls.append(round(rate, 1))
        return {"s": 1.0, "offered": rate, "acked": min(rate, limit),
                "shed": 0, "carried": min(rate, limit)}

    return carry, calls


def test_calibrate_sizes_from_the_last_of_three_onsets(monkeypatch):
    """``calibrate`` reads the onset CALIBRATION_READINGS times, each
    ramp after the first from two steps below the last onset, and sizes
    from the last reading, the nearest to the burn: on a steady shard
    whose knee is 500 ops/s, 589.5; on one that warms up
    (``_WarmingShard``: onsets 227.3, then 487.2 twice), 487.2; an
    onset read low or high before the last moves nothing.  The router
    is then offered the planned burn's fleet rate (1.6 of the onset)
    three times; where it carries all of it, the bound (the carry over
    1.25 x 2 x 0.6) lies above the onset and moves nothing."""
    import torch_fleet_serve_soak as soak

    assert soak.CALIBRATION_READINGS == 3
    assert (soak.CARRY_MARGIN, soak.COLD_AFTER_SPLIT) == (1.25, 2)
    offer, calls = _recording(_Shard(knee=500.0).offer)
    carry, asked = _carrying()
    cal = soak.calibrate(offer, carry, 1.6, 0.6)
    assert [r["capacity_ops_s"] for r in cal["readings"]] == [589.5] * 3
    assert cal["capacity_ops_s"] == cal["onset_ops_s"] == 589.5
    assert calls[12:] == [487.2, 535.9, 589.5, 589.5, 589.5] * 2
    assert len(cal["windows"]) == len(calls)
    assert asked == [943.2] * 3
    assert cal["carry"] == {"offered_ops_s": 943.2,
                            "window_offered_ops_s": [943.2] * 3,
                            "window_carried_ops_s": [943.2] * 3,
                            "carried_ops_s": 943.2, "bound_ops_s": 628.8}

    clock = _Clock()
    cal = soak.calibrate(_WarmingShard(clock).offer, _carrying()[0], 1.6,
                         0.6)
    assert [r["capacity_ops_s"] for r in cal["readings"]] == [227.3, 487.2,
                                                              487.2]
    assert cal["capacity_ops_s"] == 487.2
    assert cal["readings"][0]["age_s"] == [0.0, 5.5]
    assert cal["window_shed"] == [211, 211, 211]

    for odd in ([300.0, 900.0, 589.5], [900.0, 227.3, 589.5]):
        onsets = iter(odd)
        monkeypatch.setattr(soak, "measure_capacity", lambda offer, start=0:
                            {"capacity_ops_s": next(onsets), "windows": [{}],
                             "window_acked_ops_s": [], "window_shed": []})
        assert soak.calibrate(None, _carrying()[0], 1.6,
                              0.6)["capacity_ops_s"] == 589.5


def test_calibrate_bounds_the_onset_by_the_carry(monkeypatch):
    """Where the router and the client carry less than the planned
    burn, the capacity is the median carried rate over 1.5 (the cold
    line after the first split, 2 x 0.6 of the capacity, a quarter
    under it), whatever the onset; a carry that dips in one window of
    three moves nothing."""
    import torch_fleet_serve_soak as soak

    onsets = iter([443.7, 488.7, 866.6])
    monkeypatch.setattr(soak, "measure_capacity", lambda offer, start=0:
                        {"capacity_ops_s": next(onsets), "windows": [{}],
                         "window_acked_ops_s": [], "window_shed": []})
    carried = iter([1040.0, 700.0, 1100.0])
    cal = soak.calibrate(None, lambda rate: {"offered": rate,
                                             "carried": next(carried)},
                         1.6, 0.6)
    assert cal["onset_ops_s"] == 866.6
    assert cal["carry"]["window_carried_ops_s"] == [1040.0, 700.0, 1100.0]
    assert cal["carry"]["carried_ops_s"] == 1040.0
    assert cal["capacity_ops_s"] == cal["carry"]["bound_ops_s"] == 693.3


def _fake_leg(monkeypatch, shard, clock, carry=None,
              second_reading=False):
    """``run_autopilot_mode`` with its fleet, router, controller,
    sampler and ledgered traffic replaced by fakes that run on
    ``clock`` (a controller takes 3 s to engage, a traffic leg its
    duration), s1's probes offered to ``shard`` and the fleet's to
    ``carry`` (default: a router that carries every rate).  Returns the
    leg's result and its events in order: ``(what, t)``, and
    ``("traffic", t, rate)``."""
    import argparse

    import torch_fleet_serve_soak as soak
    from go_crdt_playground_tpu_torch.control import controller

    events = []

    class Fleet:
        def __init__(self, repo, root, spec, **kwargs):
            self.spec, self.shards, self.router = spec, [], None

        sid = staticmethod(lambda i: f"s{i}")

        def start(self, extra=()):
            events.append(("start", clock.t))
            return ("fake", 1)

        def shard_addr(self, i):
            return ("fake", 10 + i)

        def close(self):
            events.append(("close", clock.t))

    fleet_offer = carry or _carrying()[0]

    def shard_offer(router, keys, elements, **kwargs):
        def offer(rate):
            events.append(("probe", clock.t))
            if len(keys) == elements:
                clock.t += 1.1
                return fleet_offer(rate)
            return shard.offer(rate)
        return offer

    class Sampler:
        samples = []

        def __init__(self, *args, **kwargs):
            pass

        def start(self):
            pass

        def mark(self):
            return 0

        def window(self, since_idx=0):
            return []

        def stop(self):
            pass

        def is_alive(self):
            return False

    class Pilot:
        def __init__(self, *args):
            self.proc = self

        def await_engaged(self, timeout_s=60.0):
            clock.t += 3.0
            events.append(("engaged", clock.t))
            return {"generation": 1, "adopted": "['s2']"}

        def sigkill(self):
            events.append(("pilot_down", clock.t))

        terminate = sigkill

        def close(self):
            pass

    def traffic(addr, rate, duration_s, elements, **kwargs):
        events.append(("traffic", clock.t, rate))
        clock.t += duration_s
        return {"workload": "fake", "goodput": rate, "acked": 1,
                "shed_overloaded": 0, "unresolved": 0, "p99_ms": 1.0,
                "acked_elements": [], "submitted_elements": [],
                "acked_deletes": []}

    class Client:
        def __init__(self, *args, **kwargs):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def members(self):
            return [], {}

    for name, fake in (("ShardFleet", Fleet), ("shard_offer", shard_offer),
                       ("_SignalSampler", Sampler),
                       ("_AutopilotProc", Pilot),
                       ("open_loop_leg", traffic), ("ServeClient", Client),
                       ("_ring_info", lambda addr: {
                           "generation": 0, "shards": ["s0", "s1"],
                           "seed": 29})):
        monkeypatch.setattr(soak, name, fake)
    monkeypatch.setattr(controller, "read_decision_log", lambda path: [])
    res = soak.run_autopilot_mode(argparse.Namespace(
        quick=True, seed=29, second_reading=second_reading))
    return res, events


def test_burn_meets_a_warming_shard_above_its_knee(monkeypatch):
    """A failed leg on a model: s1's knee rises from 160 to 386 ops/s
    in the leg's first 16 s (``_WarmingShard``).  One onset read right
    after the start (``measure_capacity`` alone, no warm-up reading)
    plans s1's burn at 1.16 x 227.3 = 264 ops/s, below the knee it
    meets when the burn starts; the leg's calibration plans it above
    that knee, with the baseline's hottest shard still at 0.40 of the
    capacity."""
    import torch_fleet_serve_soak as soak

    clock = _Clock()
    shard = _WarmingShard(clock)
    once = soak.measure_capacity(shard.offer)
    assert once["capacity_ops_s"] == 227.3
    # one reading, then the controller's start and the baseline
    t_burn = clock.t + 3.0 + 5.0
    assert 1.1636 * once["capacity_ops_s"] < shard.knee(t_burn)

    clock = _Clock()
    res, events = _fake_leg(monkeypatch, _WarmingShard(clock), clock)
    cal = res["calibration"]
    burn = [e for e in events if e[0] == "traffic"][1]
    s1_burn = cal["shares"]["burn"]["s1"] * burn[2]
    assert s1_burn > _WarmingShard(clock).knee(burn[1]) + 64 / 16.0
    assert s1_burn / cal["capacity_ops_s"] == pytest.approx(
        cal["planned_load"]["burn"]["of_capacity"], abs=1e-4)
    assert 0.38 < cal["planned_load"]["baseline"]["of_capacity"] < 0.42


@pytest.mark.parametrize("second_reading", [False, True])
def test_autopilot_leg_order(monkeypatch, second_reading):
    """The leg's order: the fleet starts, s1 is read three times (the
    first two readings are the warm-up) and the router offered the
    planned burn three times, the capacity comes from them, and only
    then does the controller engage; no probe runs while a controller
    does; with ``--second-reading`` s1 is read once more after the last
    controller is stopped and before the fleet closes, and without it
    nothing is offered after the checks' readings."""
    import torch_fleet_serve_soak as soak

    clock = _Clock()
    res, events = _fake_leg(monkeypatch, _Shard(knee=500.0), clock,
                            second_reading=second_reading)
    kinds = [e[0] for e in events]
    assert kinds[0] == "start" and kinds[-1] == "close"
    engaged = kinds.index("engaged")
    assert kinds[1:engaged] == ["probe"] * (engaged - 1)
    cal = res["calibration"]
    assert len(cal["readings"]) == 3
    assert len(cal["windows"]) + soak.CAPACITY_WINDOWS == engaged - 1
    assert cal["capacity_ops_s"] == 589.5
    # the controllers run from their engagement to their stop
    down = [i for i, k in enumerate(kinds) if k == "pilot_down"]
    assert len(down) == 2 and kinds.count("engaged") == 2
    running = set(range(engaged, down[0])) | set(
        range(kinds.index("engaged", down[0]), down[1]))
    assert not [i for i in running if kinds[i] == "probe"]
    after = kinds[down[1] + 1:-1]
    assert [e[0] for e in events if e[0] == "traffic"] == ["traffic"] * 5
    if not second_reading:
        assert after == [] and "drift" not in res
        return
    assert after and set(after) == {"probe"}
    assert res["second_reading"]["capacity_ops_s"] == 589.5
    assert res["drift"]["second_over_onset"] == 1.0


def _cold_after_split(cold_rate: float, fleet_ops_s: float) -> bool:
    """The controller's verdict on three calm shards (queues empty, p99
    10 ms) that the router gives ``fleet_ops_s`` between them, with
    ``cold_rate`` a shard, over its cold windows: merge or not."""
    from go_crdt_playground_tpu_torch.control.policy import (
        AutopilotPolicy, PolicyConfig)
    from go_crdt_playground_tpu_torch.control.signals import (
        FleetView, ShardSignals)

    policy = AutopilotPolicy(PolicyConfig(
        p99_budget_s=1.5, queue_watermark=32.0, hot_windows=3,
        cold_windows=6, min_shards=2, max_shards=4,
        cold_rate_per_shard=cold_rate))
    shards = ("s0", "s1", "s2")
    per = {s: ShardSignals(s, True, fleet_ops_s / 3, fleet_ops_s / 3, 0.0,
                           0.0, 0.01) for s in shards}
    actions = [policy.decide(FleetView(float(t), 1, "d", shards, 0, {},
                                       per)).action for t in range(6)]
    return actions[-1] == "merge"


def test_burn_splits_and_holds_under_a_router_cap(monkeypatch):
    """A leg's readings on an H100 80GB HBM3's host replayed: s1's
    onsets read 443.7, 488.7, then 866.6 ops/s while the router carried
    1,040-1,200 ops/s, and s1 read 474.5 again after the checks.  Sized
    from 866.6 alone, the leg plans a fleet burn of 1,386.6 that a
    router carrying 1,040 cannot deliver, and the controller's cold
    line with three shards (2 x 520.0) is the carry itself: a calm
    fleet 5% under it merges in the converge leg.  The leg bounds the
    capacity by the carry (693.3): the cold line falls to 832.0, the
    fleet stays warm down to 0.85 of the carry, and s1's share of what
    the router carries (0.725 of 1,040) is still above its capacity at
    the burn, so it splits."""
    import torch_fleet_serve_soak as soak

    onsets = iter([443.7, 488.7, 866.6])
    monkeypatch.setattr(soak, "measure_capacity", lambda offer, start=0:
                        {"capacity_ops_s": next(onsets),
                         "windows": [{"age_s": 0.0}],
                         "window_acked_ops_s": [], "window_shed": []})
    clock = _Clock()
    carry, asked = _carrying(1040.0)
    res, events = _fake_leg(monkeypatch, None, clock, carry=carry)
    cal = res["calibration"]
    assert asked == [1386.6] * 3
    assert cal["onset_ops_s"] == 866.6 and cal["capacity_ops_s"] == 693.3
    cold_rate = res["budgets"]["pilot_flags"]["cold-rate"]
    assert cold_rate == 416.0
    burn = [e for e in events if e[0] == "traffic"][1][2]
    carried = min(burn, 1040.0)
    assert carried == 1040.0 < burn
    # s1's share of the burn as the router carries it, over s1's onset
    # read after the checks
    assert cal["shares"]["burn"]["s1"] * carried > 1.5 * 474.5
    assert not _cold_after_split(cold_rate, 0.85 * carried)
    # the last onset alone
    unbounded_cold = round(0.6 * 866.6, 1)
    assert 1.6 * 866.6 > 1040.0
    assert _cold_after_split(unbounded_cold, 0.95 * carried)


