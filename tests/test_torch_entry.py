"""The port's entry points against the JAX package's, and the port's
ground rules: no JAX imports, CUDA by default, no silent CPU fallback."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__
import bench
from go_crdt_playground_tpu.__main__ import main as jax_main
from go_crdt_playground_tpu_torch import fleet
from go_crdt_playground_tpu_torch.config import REFERENCE_CONFIG, Config
from go_crdt_playground_tpu_torch.entry import entry
from go_crdt_playground_tpu_torch.utils import prng
from tests.test_torch_models import assert_same

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "go_crdt_playground_tpu_torch"


def test_entry_matches_graft_entry():
    jfn, (jstate, joff) = __graft_entry__.entry()
    tfn, (tstate, toff) = entry(device="cpu")
    assert_same(jstate, tstate, "example state")
    assert int(toff) == int(joff)
    jmerged, jconv = jfn(jstate, joff)
    tmerged, tconv = tfn(tstate, toff)
    assert_same(jmerged, tmerged, "merged")
    assert bool(tconv) == bool(jconv)


@pytest.mark.parametrize("R,E,W", [(300, 64, 16), (70, 33, 70)])
def test_fleets_match_bench_builders(R, E, W):
    """uint32 wrapping products reproduced bit for bit."""
    assert_same(bench.build_state(R, E, W),
                fleet.build_state(R, E, W, device="cpu"))
    assert_same(bench._delta_fleet(R, E, W),
                fleet.delta_fleet(R, E, W, device="cpu"))
    for delta in (False, True):
        assert_same(__graft_entry__._demo_state(R, E, delta=delta),
                    fleet.demo_state(R, E, delta=delta, device="cpu"))


def _port_cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.run(
        [sys.executable, "-m", "go_crdt_playground_tpu_torch", "gossip",
         *args], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("args", [
    ("--replicas", "8"),
    ("--replicas", "16", "--delta", "--schedule", "butterfly"),
    ("--replicas", "8", "--drop-rate", "0.2", "--seed", "3"),
    ("--replicas", "16", "--delta", "--schedule", "random", "--seed", "3"),
])
def test_gossip_verb_prints_what_the_jax_verb_prints(args, capsys):
    assert jax_main(["gossip", *args]) == 0
    want = capsys.readouterr().out.strip().splitlines()[-1]
    got = _port_cli(*args, "--device", "cpu")
    assert got == want
    assert "converged in" in got


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "go_crdt_playground_tpu"), \
                f"{path.relative_to(REPO)} imports {mod}"


def test_default_device_is_cuda_and_never_falls_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    from go_crdt_playground_tpu_torch.__main__ import main
    from go_crdt_playground_tpu_torch.models import awset, awset_delta
    from go_crdt_playground_tpu_torch.net.antientropy import SyncSupervisor
    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.ops import cuda_digest, digest
    from go_crdt_playground_tpu_torch.ops.cuda_ingest import \
        ingest_rows_delta_fused
    from go_crdt_playground_tpu_torch.parallel import gossip
    from go_crdt_playground_tpu_torch.utils.checkpoint import (
        CheckpointStore, restore_checkpoint, save_checkpoint)

    calls = [
        lambda: awset.init(2, 4, 2),
        lambda: awset_delta.init(2, 4, 2),
        lambda: awset.from_arrays({"vv": np.zeros((1, 1), np.uint32),
                                   "present": np.zeros((1, 1), bool),
                                   "dot_actor": np.zeros((1, 1), np.uint32),
                                   "dot_counter": np.zeros((1, 1), np.uint32),
                                   "actor": np.zeros(1, np.uint32)}),
        lambda: fleet.build_state(8, 4, 2),
        lambda: fleet.delta_fleet(8, 4, 2),
        lambda: entry(),
        lambda: Config(num_replicas=2, num_actors=2).init_awset(),
        lambda: main(["gossip", "--replicas", "4"]),
        lambda: Node(0, 16, 2),
        lambda: Node.restore_durable(str(tmp_path)),
        lambda: CheckpointStore(str(tmp_path)).restore(),
        lambda: restore_checkpoint(str(tmp_path / "ck")),
        lambda: digest.digest_regime(64),
        lambda: SyncSupervisor.restore(str(tmp_path / "ck"), []),
        lambda: SyncSupervisor.restore_durable(str(tmp_path), []),
        lambda: gossip.ring_perm(4),
        lambda: gossip.butterfly_perm(4, 0),
        lambda: gossip.random_perm(prng.key(0), 4),
    ]
    CheckpointStore(str(tmp_path)).save(
        Node(0, 4, 2, device="cpu").state_slice(), metadata={"actor": 0})
    save_checkpoint(str(tmp_path / "ck"),
                    awset_delta.init(1, 4, 2, device="cpu"))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()
    # the K10 wrapper follows its tensors: CPU tensors run the plain
    # version and never count a launch; insisting on the kernel raises
    row = awset_delta.init(1, 4, 2, device="cpu")
    row = type(row)(*(x[0] for x in row))
    rows = torch.zeros((1, 4), dtype=torch.bool)
    before = ingest_rows_delta_fused.launches
    ingest_rows_delta_fused(row, rows, rows, rows[:, 0], k_changed=4,
                            k_deleted=4)
    assert ingest_rows_delta_fused.launches == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ingest_rows_delta_fused(row, rows, rows, rows[:, 0], k_changed=4,
                                k_deleted=4, kernel="cuda")
    # so does K11's
    before = cuda_digest.state_group_digests.launches
    assert torch.equal(cuda_digest.state_group_digests(row, 2),
                       digest.state_group_digests(row, 2))
    assert cuda_digest.state_group_digests.launches == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cuda_digest.state_group_digests(row, 2, kernel="cuda")


def test_config_validates():
    assert REFERENCE_CONFIG.num_replicas == 3
    with pytest.raises(ValueError):
        Config(num_replicas=0)
    with pytest.raises(ValueError):
        Config(num_actors=0)
    st = REFERENCE_CONFIG.init_awset_delta(device="cpu")
    assert tuple(st.vv.shape) == (3, 3)


def test_cuda_tests_run_without_jax():
    """tests/test_torch_cuda.py runs on a GPU machine that has no JAX:
    with ``import jax`` failing and the suite's conftest skipped, it
    collects every test and each skips here (no GPU) or passes."""
    code = ("import sys, pytest; sys.modules['jax'] = None; "
            "sys.exit(pytest.main(['--noconftest', '-q', '-p', "
            "'no:cacheprovider', '-m', 'cuda', "
            "'tests/test_torch_cuda.py']))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "error" not in out.stdout.lower(), out.stdout
    assert "68 skipped" in out.stdout or "68 passed" in out.stdout, \
        out.stdout
