"""tools/torch_crash_soak.py: the process-kill crash soak on torch nodes.

The per-incarnation δ-loss verdict on synthetic statuses; one short
faulted scenario on CPU worker processes whose final durable dirs the
port's and the JAX package's ``Node.restore_durable`` both restore to
the same convergent state; the kernel build's rename protocol under a
SIGKILLed builder; and the ``--quick`` sweep (``slow``: it spawns and
SIGKILLs node processes for about half a minute, as
tests/test_crash_soak.py does for the reference's).
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import textwrap
import time
import zlib

import numpy as np
import pytest

from go_crdt_playground_tpu.models.digest import array_digest as jax_digest
from go_crdt_playground_tpu.net.peer import Node as JaxNode
from go_crdt_playground_tpu_torch._u32 import host
from go_crdt_playground_tpu_torch.net.peer import Node

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import torch_crash_soak  # noqa: E402

WINDOWS = ("restore.fallbacks", "wal.torn_tail", "wal.bad_records",
           "wal.future_records")


def _status(lost_acks, **counters):
    return {"actor": 0, "pid": 1, "rounds": 3, "lost_acks": lost_acks,
            "members": [], "vv": [0, 0, 0], "digest": 0, "generation": 1,
            "counters": {"wal.records": 2, **counters}, "races": []}


def test_loss_with_no_window_open_is_delta_loss():
    assert torch_crash_soak.delta_loss(_status(1))
    assert torch_crash_soak.delta_loss(_status(3, **{"wal.replayed_dense": 2}))


@pytest.mark.parametrize("window", WINDOWS)
def test_loss_inside_a_window_is_not_delta_loss(window):
    assert not torch_crash_soak.delta_loss(_status(2, **{window: 1}))


@pytest.mark.parametrize("window", (None,) + WINDOWS)
def test_no_loss_is_never_delta_loss(window):
    counters = {} if window is None else {window: 1}
    assert not torch_crash_soak.delta_loss(_status(0, **counters))


def _jax_convergence_digest(state) -> int:
    """tools/crash_soak.py's status digest of a JAX state."""
    digest = 0
    for name in torch_crash_soak.CONVERGENT_FIELDS:
        digest = zlib.crc32(
            jax_digest(getattr(state, name)).to_bytes(4, "little"), digest)
    return digest


def test_faulted_run_dirs_restore_equal_in_both_packages(tmp_path):
    """A faulted run (3 CPU worker processes, kill rate 0.25, a shortened
    kill window) converges with no δ loss; every final durable dir, copied
    once per package, restores to the same vv, present and deleted under
    the port's and the JAX package's ``restore_durable`` (bitwise), and
    both give the status digest the last incarnation published."""
    root = tmp_path / "run"
    root.mkdir()
    res = torch_crash_soak.run_scenario(
        3, 24, 0.25, seed=23, kill_ticks=8, max_ticks=120,
        root_dir=str(root), device="cpu")
    assert res["converged"], res
    assert res["kills"] > 0 and res["delta_loss_violations"] == 0, res
    assert res["unexpected_exits"] == 0, res
    for i in range(3):
        d = root / f"node-{i}"
        with open(d / "status.json") as f:
            status = json.load(f)
        port_dir, jax_dir = tmp_path / f"port-{i}", tmp_path / f"jax-{i}"
        shutil.copytree(d, port_dir)
        shutil.copytree(d, jax_dir)
        port = Node.restore_durable(str(port_dir), device="cpu")
        jax = JaxNode.restore_durable(str(jax_dir))
        try:
            ps, js = port.state_slice(), jax.state_slice()
            for name in torch_crash_soak.CONVERGENT_FIELDS:
                p, j = host(getattr(ps, name)), np.asarray(getattr(js, name))
                assert p.dtype == j.dtype and np.array_equal(p, j), name
            digest = torch_crash_soak.convergence_digest(ps)
            assert digest == _jax_convergence_digest(js) == status["digest"]
            assert port.members().tolist() == list(range(24))
        finally:
            for n in (port, jax):
                n.wal.close()
                n.close()


def test_a_spare_dead_before_its_turn_is_an_unexpected_exit(tmp_path):
    """The fleet hands a node to a live spare: one SIGKILLed before its
    turn counts as an unexpected exit, and the node's worker restores,
    serves and publishes its status from the next spare."""
    fleet = torch_crash_soak._Fleet(1, 8, str(tmp_path), seed=1,
                                    checkpoint_every=3, worker_tick_s=0.05,
                                    device="cpu")
    try:
        for _ in range(2):
            fleet._start_spare()
        os.kill(fleet.spares[0].pid, signal.SIGKILL)
        fleet.spares[0].wait()
        fleet.spawn(0)
        assert fleet.unexpected_exits == 1
        deadline = time.monotonic() + 60
        while (fleet.status(0) or {}).get("pid") != fleet.procs[0].pid:
            assert time.monotonic() < deadline, "no status"
            assert fleet.procs[0].poll() is None
            time.sleep(0.05)
        assert len(fleet.spares) == 1
    finally:
        fleet.teardown()
    assert all(p.poll() is not None for p in fleet.spares + fleet.procs)


def test_killed_builder_leaves_no_library(tmp_path):
    """A kernel build SIGKILLed while nvcc writes its output leaves no
    library at the target path (only the temporary file), so the next
    build starts again and no truncated library is ever loaded."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(textwrap.dedent("""\
        #!/bin/sh
        while [ "$1" != "-o" ]; do shift; done
        printf 'partial' > "$2"
        touch "$2.started"
        sleep 60
    """))
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    code = textwrap.dedent(f"""\
        from pathlib import Path
        from go_crdt_playground_tpu_torch.ops import _build
        _build.BUILD = Path({str(build)!r})
        _build.nvcc_path = lambda: {str(nvcc)!r}
        _build.build_all(["digest"])
    """)
    from go_crdt_playground_tpu_torch.ops import _build

    target = build / _build._library_path("digest").name
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            start_new_session=True)
    try:
        deadline = time.monotonic() + 60
        while not list(build.glob("*.started")):
            assert proc.poll() is None, "builder exited early"
            assert time.monotonic() < deadline, "nvcc never started"
            time.sleep(0.02)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        os.killpg(proc.pid, signal.SIGKILL)
    assert not target.exists()
    assert [p.read_bytes() for p in build.glob("*.so")] == [b"partial"]


@pytest.mark.slow
def test_crash_soak_quick_mode(tmp_path):
    """The --quick sweep on CPU workers with race detection: the
    reference wrapper's assertions, and no unexpected worker exit."""
    out = str(tmp_path / "CRASH_CURVE_TORCH.json")
    rc = torch_crash_soak.main(["--quick", "--device", "cpu",
                                "--detect-races", "--out", out])
    with open(out) as f:
        artifact = json.load(f)
    assert artifact["device"] == "cpu"
    assert artifact["race_detection"]["races"] == []
    curve = artifact["curve"]
    assert any(e["kill_rate"] >= 0.2 for e in curve)
    for e in curve:
        assert e["converged_runs"] == e["seeds"]
        assert e["delta_loss_violations"] == 0
        assert e["unexpected_exits"] == 0
    faulted = [e for e in curve if e["kill_rate"] > 0]
    assert all(e["kills"] > 0 for e in faulted)
    assert any(sum(e["storage_faults"].get(k, 0)
                   for k in ("torn_writes", "bit_flips", "zero_fills")) > 0
               for e in faulted)
    assert any(e["corruption_injected"]
               and e["restore_counters"].get("restore.fallbacks", 0) > 0
               for e in faulted)
    modes = artifact["wal_record_modes"]
    assert modes.get("wal.compact_records", 0) > 0, modes
    assert modes.get("wal.dense_records", 0) > 0, modes
    assert (modes.get("wal.replayed_compact", 0)
            + modes.get("wal.replayed_dense", 0)) > 0, modes
    assert rc == 0
