"""tools/torch_fleet_soak.py: eight torch node processes gossiping over
real TCP through lossy proxies (tests/test_fleet_soak.py's fleet), on
the CPU here.  The reference test's assertions, and the fleet's final vv
equal to JAX nodes' after the same adds."""

import json
import os
import sys

import numpy as np

from go_crdt_playground_tpu.net.peer import Node as JaxNode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import torch_fleet_soak  # noqa: E402


def test_fleet_converges_under_injected_loss(tmp_path):
    out = str(tmp_path / "fleet.json")
    rc = torch_fleet_soak.main(["--device", "cpu", "--out", out])
    with open(out) as f:
        res = json.load(f)
    assert res["failures"] == [] and rc == 0, res
    n, per = torch_fleet_soak.N_WORKERS, torch_fleet_soak.PER_WORKER
    assert res["workers"] == n and res["device"] == "cpu"
    # the loss injection fired: about 20% of the proxied dials were cut
    assert res["dropped"] >= 10
    assert res["total"] >= 100
    assert res["lost"] >= 10, "proxy cuts must surface as lost exchanges"
    expected = sorted(e for i in range(n) for e in range(i * per,
                                                         i * per + per))
    for i, (members, vv) in enumerate(zip(res["members"], res["vv"])):
        assert members == expected, f"worker {i} diverged"
        assert vv == res["vv"][0], f"worker {i} VV diverged"
    # each worker's own clock is a JAX node's after the same adds
    want = []
    for i in range(n):
        node = JaxNode(i, torch_fleet_soak.NUM_ELEMENTS, n)
        node.add(*range(i * per, i * per + per))
        want.append(int(np.asarray(node.vv())[i]))
    assert res["vv"][0] == want
