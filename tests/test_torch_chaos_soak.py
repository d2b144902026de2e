"""tools/torch_chaos_soak.py: the severity curve and the sync curve on
torch nodes against tools/chaos_soak.py on JAX nodes.

The quick severity sweep's runs on CPU torch nodes against the JAX
tool's ``run_scenario`` in process with the same arguments (converged,
the fault census and the breaker transitions equal), the quick sync
curve's legs against the JAX tool's numbers, and the full sweep's
census against the committed CHAOS_CURVE.json (``slow``).  Every fleet
binds port 0 on 127.0.0.1.
"""

import json
import os
import sys

import pytest

from tests.test_torch_digestsync import jax_fleet_waits  # noqa: F401
from tests.test_torch_net import prompt_jax_close  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import chaos_soak  # noqa: E402
import torch_chaos_soak  # noqa: E402

QUICK_NODES, QUICK_ELEMENTS = 4, 32


def _severity_args(sev, seed=11):
    """tools/chaos_soak.py main's arguments for one severity's run."""
    return dict(drop_rate=sev, truncate_rate=sev / 2,
                duplicate_rate=0.1 if sev > 0 else 0.0, seed=seed,
                max_rounds=60, partition_rounds=(0, 2) if sev > 0 else None,
                detect_races=True)


@pytest.fixture(scope="module")
def warm_jax_fleet():
    """One JAX run at the quick fleet's shape first: a JAX node compiles
    each step on its first call, and a compile inside a 1 s sync deadline
    is a timeout, a retry and one more proxied connection in the census
    (what the committed CHAOS_CURVE.json's severity 0 records)."""
    import socket

    from go_crdt_playground_tpu.net.peer import Node as JaxNode

    close = JaxNode.close

    def prompt(self):
        if self._server_sock is not None:
            try:
                self._server_sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        close(self)

    JaxNode.close = prompt
    try:
        chaos_soak.run_scenario(QUICK_NODES, QUICK_ELEMENTS,
                                **_severity_args(0.25, seed=12))
    finally:
        JaxNode.close = close


@pytest.mark.parametrize("sev", [0.0, 0.25])
def test_quick_severity_run_matches_the_jax_tool(sev, warm_jax_fleet):
    """Each run of the quick severity sweep (4 nodes x 32 elements, seed
    11, race detection on): the torch fleet and the JAX tool's fleet both
    converge, in the same rounds, with the same fault census, breaker
    transitions and retries, and no race."""
    want = chaos_soak.run_scenario(QUICK_NODES, QUICK_ELEMENTS,
                                   **_severity_args(sev))
    got = torch_chaos_soak.run_scenario(QUICK_NODES, QUICK_ELEMENTS,
                                        device="cpu", **_severity_args(sev))
    assert got["converged"] and want["converged"]
    assert got["faults"] == want["faults"]
    for key in ("rounds", "breaker", "retries", "races"):
        assert got[key] == want[key], key
    assert got["races"] == []
    if sev > 0:
        assert got["faults"]["refused"] > 0 and got["faults"]["dropped"] > 0


def test_quick_severity_sweep_writes_the_curve(tmp_path):
    """``--quick --detect-races`` exits 0 with the reference's artifact
    fields, the device named in place of the platform."""
    out = str(tmp_path / "CHAOS_CURVE_TORCH.json")
    assert torch_chaos_soak.main(["--quick", "--device", "cpu",
                                  "--detect-races", "--out", out]) == 0
    with open(out) as f:
        art = json.load(f)
    assert art["device"] == "cpu" and "platform" not in art
    assert art["fleet"] == {"nodes": 4, "elements": 32, "quick": True}
    assert [e["drop_rate"] for e in art["curve"]] == [0.0, 0.25]
    assert art["race_detection"] == {"enabled": True, "races": []}
    with open(os.path.join(REPO, "CHAOS_CURVE.json")) as f:
        ref = json.load(f)
    for got, want in zip(art["curve"], ref["curve"]):
        assert set(got) == set(want)


def test_sync_curve_quick_legs_match_the_jax_tool(tmp_path,
                                                  jax_fleet_waits):
    """``--sync-curve --quick``: each divergent leg's numbers (bytes,
    rounds, lanes, quiescent counts) equal tools/chaos_soak.py's
    ``run_traffic_leg`` on a JAX fleet with the same arguments, the
    quiescent section is the first leg's, and the digest chaos leg
    converges without a race."""
    out = str(tmp_path / "SYNC_CURVE_TORCH.json")
    assert torch_chaos_soak.main(["--sync-curve", "--quick", "--device",
                                  "cpu", "--detect-races", "--out",
                                  out]) == 0
    with open(out) as f:
        art = json.load(f)
    [leg] = art["divergent"]
    assert leg["ops_per_round"] == 4 and leg["ok"]
    for mode in ("digest", "delta"):
        want = chaos_soak.run_traffic_leg(mode, 4, 256, 4, 5, seed=17,
                                          quiescent_rounds=4)
        assert leg[mode] == want, mode
    assert art["quiescent"] == {
        "digest_bytes_per_round": leg["digest"]["quiescent_bytes_per_round"],
        "delta_bytes_per_round": leg["delta"]["quiescent_bytes_per_round"],
        "digest_state_lanes": 0,
        "digest_exchanges": leg["digest"]["quiescent_exchanges"]}
    assert art["chaos"]["converged"] and art["chaos"]["severity"] == 0.25
    assert art["race_detection"]["races"] == []
    assert art["device"] == "cpu"
    with open(os.path.join(REPO, "SYNC_CURVE.json")) as f:
        ref = json.load(f)
    assert set(art) - {"device", "race_detection"} \
        == set(ref) - {"platform"}


@pytest.mark.slow
def test_full_severity_sweep_census_matches_the_committed_curve(tmp_path):
    """The full sweep (6 x 60, severities 0-0.4, seeds 11-13) on CPU
    torch nodes against the committed CHAOS_CURVE.json: every severity
    converged in the same rounds, and every faulted severity's census,
    breaker transitions and retries equal.  At severity 0 the committed
    run holds one retry (a JAX compile inside a sync deadline, see
    warm_jax_fleet): there the proxied connections less the retries are
    equal."""
    out = str(tmp_path / "CHAOS_CURVE_TORCH.json")
    assert torch_chaos_soak.main(["--device", "cpu", "--detect-races",
                                  "--out", out]) == 0
    with open(out) as f:
        art = json.load(f)
    with open(os.path.join(REPO, "CHAOS_CURVE.json")) as f:
        ref = json.load(f)
    assert len(art["curve"]) == len(ref["curve"]) == 5
    for got, want in zip(art["curve"], ref["curve"]):
        for key in ("drop_rate", "converged_runs", "seeds", "rounds_min",
                    "rounds_median", "rounds_max"):
            assert got[key] == want[key], (got["drop_rate"], key)
        census = got["faults_injected"]
        if got["drop_rate"] > 0:
            assert torch_chaos_soak.census_equal(
                census, want["faults_injected"]), got["drop_rate"]
            assert got["breaker_transitions"] == want["breaker_transitions"]
            assert got["retries"] == want["retries"]
        else:
            ref_census = want["faults_injected"]
            assert (census["connections"] - got["retries"]
                    == ref_census["connections"] - want["retries"])
