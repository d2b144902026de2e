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
