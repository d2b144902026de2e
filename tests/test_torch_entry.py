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


# the one sanctioned JAX import site: the differential soak's CPU mode
# holds the plain versions against the JAX package, importing it lazily
JAX_SIDE = (REPO / "tools" / "torch_soak_differential.py", "_jax_side")


def _imported_modules(path: Path, skip_function: str = None):
    tree = ast.parse(path.read_text(), filename=str(path))
    skipped = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == skip_function:
            skipped |= {id(n) for n in ast.walk(node)}
    for node in ast.walk(tree):
        if id(node) in skipped:
            continue
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "tools").glob("torch_*.py"))
             + sorted((REPO / "examples").glob("torch_*.py")))
    assert len(files) > 10
    for part in ("analysis/__main__.py", "analysis/purity.py",
                 "analysis/transfer_lock.py", "analysis/lattice_laws.py",
                 "analysis/codec_symmetry.py", "analysis/locksets.py",
                 "analysis/protomodel.py"):
        assert PORT / part in files
    for extra in ("tools/torch_analyze.py",
                  "tools/torch_soak_differential.py",
                  "examples/torch_quickstart.py",
                  "examples/torch_tcp_sync.py"):
        assert REPO / extra in files
    for part in ("serve/frontend.py", "shard/replica.py", "obs/metrics.py",
                 "utils/degrade.py", "parallel/mesh.py",
                 "parallel/shardmap.py", "parallel/multihost.py",
                 "parallel/meshtarget.py", "parallel/meshtarget2d.py",
                 "serve/scheduler.py", "utils/checkpoint_sharded.py",
                 "bridge/service.py", "bridge/messages.py",
                 "bridge/convert.py", "native/__init__.py",
                 "models/spec.py", "utils/codec.py", "obs/trace.py"):
        assert PORT / part in files
    assert REPO / "tools" / "torch_serve_soak.py" in files
    for path in files:
        skip = JAX_SIDE[1] if path == JAX_SIDE[0] else None
        for mod in _imported_modules(path, skip):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "go_crdt_playground_tpu",
                               "google"), \
                f"{path.relative_to(REPO)} imports {mod}"


def test_soak_imports_jax_only_in_its_cpu_mode():
    """The exception is one function, reached only with a CPU device:
    its imports are the JAX ones, and on CUDA the soak never calls it."""
    path, fn = JAX_SIDE
    every = set(_imported_modules(path))
    outside = set(_imported_modules(path, fn))
    inside = {m.split(".")[0] for m in every - outside}
    assert inside == {"jax", "go_crdt_playground_tpu"}
    calls = [n for n in ast.walk(ast.parse(path.read_text()))
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
             and n.func.id == fn]
    assert len(calls) == 1
    assert f'jx = {fn}() if dev.type == "cpu" else None' in \
        path.read_text()


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
    from go_crdt_playground_tpu_torch.serve import ServeFrontend
    from go_crdt_playground_tpu_torch.utils.checkpoint import (
        CheckpointStore, restore_checkpoint, save_checkpoint)

    sys.path.insert(0, str(REPO / "tools"))
    import torch_serve_soak

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
        lambda: main(["serve", "--ingest"]),
        lambda: ServeFrontend(16, 2),
        lambda: torch_serve_soak.Worker(
            str(tmp_path / "soak"), torch_serve_soak.free_port(), 16,
            "cuda", queue_depth=8, max_batch=4, flush_ms=1.0),
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


def test_bridge_and_scenario_need_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    from go_crdt_playground_tpu_torch.__main__ import main
    from go_crdt_playground_tpu_torch.bridge import (MergerServer,
                                                     execute_merge,
                                                     serve_grpc)
    from go_crdt_playground_tpu_torch.bridge.messages import MergeRequest

    for call in (lambda: MergerServer(),
                 lambda: execute_merge(MergeRequest()),
                 lambda: serve_grpc(),
                 lambda: main(["scenario"]),
                 lambda: main(["serve"])):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()


def test_scenario_verb_prints_what_the_jax_verb_prints(capsys):
    assert jax_main(["scenario"]) == 0
    want = capsys.readouterr().out
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    got = subprocess.run(
        [sys.executable, "-m", "go_crdt_playground_tpu_torch", "scenario",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert got.returncode == 0, got.stderr
    assert got.stdout == want
    assert "add-wins holds: True" in want


def test_bridge_serve_verb_banner_ping_merge_and_sigterm():
    """``serve`` without ``--ingest`` is the Merger bridge: the JAX verb's
    banner (flushed), a ping, a merge, and SIGTERM ends it with 0."""
    import re
    import signal

    from go_crdt_playground_tpu_torch.bridge import MergerClient
    from go_crdt_playground_tpu_torch.models.spec import AWSet, VersionVector

    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "go_crdt_playground_tpu_torch", "serve",
         "--device", "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        text=True)
    try:
        banner = proc.stdout.readline().strip()
        m = re.fullmatch(
            r"Merger bridge listening on (\S+):(\d+) \(method 0x01 = Merge, "
            r"0x02 = Ping; 5-byte header \+ proto body\)", banner)
        assert m, banner
        a = AWSet(actor=0, version_vector=VersionVector([0, 0]))
        b = AWSet(actor=1, version_vector=VersionVector([0, 0]))
        a.add("Anne")
        b.add("Bob")
        with MergerClient(m.group(1), int(m.group(2))) as client:
            assert client.ping()
            assert client.merge(a, b).sorted_values() == ["Anne", "Bob"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        proc.kill()
        proc.wait()


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
    assert "169 skipped" in out.stdout or "169 passed" in out.stdout, \
        out.stdout


# -- the fleet verbs ----------------------------------------------------------


@pytest.mark.parametrize("args", [
    ("--shard", "s0=127.0.0.1:1", "--shard", "s1=127.0.0.1:2",
     "--shard", "s2=127.0.0.1:3", "--seed", "5"),
    ("--shard", "a=h:1", "--shard", "b=h:2", "--elements", "4096"),
    ("--shard", "s1=h:2", "--shard", "s0=h:1,h:3", "--seed", "29",
     "--elements", "144"),
])
def test_router_verb_prints_what_the_jax_verb_prints(args, capsys):
    """``router`` without ``--serve`` prints the owner-map digest line of
    the JAX verb for the same shards, seed and elements."""
    from go_crdt_playground_tpu_torch.__main__ import main

    assert jax_main(["router", *args]) == 0
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert main(["router", *args]) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want and got.startswith("owner-map digest ")


def test_router_verb_adopts_a_committed_state_dir(tmp_path, capsys):
    from go_crdt_playground_tpu.shard.handoff import (RING_FILE,
                                                      write_json_atomic)
    from go_crdt_playground_tpu.shard.ring import HashRing
    from go_crdt_playground_tpu_torch.__main__ import main

    ring = HashRing(["a", "b", "c"], seed=2)
    write_json_atomic(str(tmp_path), RING_FILE, {
        "phase": "committed", "epoch": 1, "generation": 1, "seed": 2,
        "elements": 256, "digest": ring.digest(256, ring.owner_map(256)),
        "shards": {s: ["h", i] for i, s in enumerate("abc")}})
    args = ["router", "--shard", "z=h:9", "--seed", "2", "--elements",
            "256", "--state-dir", str(tmp_path)]
    assert jax_main(args) == 0
    want = capsys.readouterr().out
    assert main(args) == 0
    assert capsys.readouterr().out == want
    assert "ring from state-dir" in want
    assert main(args[:-4] + ["--seed", "3", "--elements", "256",
                             "--state-dir", str(tmp_path)]) == 2


def test_serve_standby_needs_a_gpu_and_the_jax_verbs_flags(tmp_path):
    """``serve --ingest --standby-of`` builds its replica on the card
    unless told otherwise; without a GPU it raises.  The flags the JAX
    verb requires exit 2 as they do there."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    from go_crdt_playground_tpu_torch.__main__ import main

    base = ["serve", "--ingest", "--standby-of", "127.0.0.1:9"]
    full = base + ["--port", "5999", "--durable-dir", str(tmp_path),
                   "--shard-id", "s0"]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main(full)
    assert main(base + ["--durable-dir", str(tmp_path),
                        "--shard-id", "s0"]) == 2  # no fixed port
    assert main(base + ["--port", "5999", "--shard-id", "s0"]) == 2
    assert main(base + ["--port", "5999", "--durable-dir",
                        str(tmp_path)]) == 2


def test_fleet_spawns_shards_on_the_card_by_default(tmp_path):
    from go_crdt_playground_tpu_torch.shard.fleet import (FleetSpec,
                                                          ShardProc)

    spec = FleetSpec(n_shards=1, elements=16)
    assert spec.device == "cuda"
    proc = ShardProc(str(REPO), str(tmp_path), spec, 0, 1,
                     extra_args=("--help",))
    try:
        proc.proc.wait(timeout=120)
        argv = proc.proc.args
        assert argv[1:3] == ["-m", "go_crdt_playground_tpu_torch"]
        assert argv[argv.index("--device") + 1] == "cuda"
    finally:
        proc.close()


def test_host_tiers_load_no_torch():
    """The router, its standby, the fleet runner, fault injection and
    the autopilot are host-only: neither importing them nor running
    the ``router`` dry run loads torch."""
    code = (
        "import sys\n"
        "import go_crdt_playground_tpu_torch.shard.router\n"
        "import go_crdt_playground_tpu_torch.shard.ha\n"
        "import go_crdt_playground_tpu_torch.shard.fleet\n"
        "import go_crdt_playground_tpu_torch.shard\n"
        "import go_crdt_playground_tpu_torch.net.faults\n"
        "import go_crdt_playground_tpu_torch.control\n"
        "from go_crdt_playground_tpu_torch.__main__ import main\n"
        "assert main(['router', '--shard', 's0=h:1']) == 0\n"
        "assert 'torch' not in sys.modules, 'torch loaded'\n"
        "assert 'jax' not in sys.modules, 'jax loaded'\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


@pytest.mark.parametrize("tool,argv", [
    ("torch_crash_soak", ["--quick"]),
    ("torch_crash_soak", ["--worker", "--actor", "0", "--nodes", "3",
                          "--elements", "24", "--port", "0",
                          "--peer-ports", ""]),
    ("torch_crash_soak", ["--spare", "--nodes", "3", "--elements", "24"]),
    ("torch_chaos_soak", ["--quick"]),
    ("torch_chaos_soak", ["--sync-curve", "--quick"]),
    ("torch_chaos_soak", ["--chaos-leg", "--quick"]),
    ("torch_fleet_soak", []),
    ("torch_fleet_soak", ["--worker", "0", "8", "64"]),
])
def test_fault_soaks_default_to_cuda_and_raise_without_one(tmp_path, tool,
                                                           argv):
    """Every mode of the fault soaks, parent and worker, defaults to
    ``--device cuda`` and raises before it runs anything when there is
    no GPU: no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    import importlib

    sys.path.insert(0, str(REPO / "tools"))
    mod = importlib.import_module(tool)
    if tool == "torch_crash_soak" and ("--worker" in argv
                                       or "--spare" in argv):
        argv = [*argv, "--dir", str(tmp_path)]
    elif "--worker" not in argv:
        argv = [*argv, "--out", str(tmp_path / "out.json")]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        mod.main(argv)
    assert not (tmp_path / "out.json").exists()


def test_fleet_modules_fall_under_the_import_scan():
    files = set(PORT.rglob("*.py")) | set((REPO / "tools").glob("torch_*.py"))
    for part in ("net/faults.py", "net/breaker.py", "shard/router.py",
                 "shard/ha.py", "shard/fleet.py", "shard/handoff.py",
                 "control/signals.py", "control/policy.py",
                 "control/actuator.py", "control/controller.py"):
        assert PORT / part in files
    for tool in ("torch_fleet_serve_soak.py", "torch_chaos_soak.py",
                 "torch_crash_soak.py", "torch_fleet_soak.py",
                 "torch_soak_util.py"):
        assert REPO / "tools" / tool in files


@pytest.mark.parametrize("argv", [
    ["--mesh-devices", "4"],
    ["--mesh-devices", "2x2", "--sched", "auto"],
    ["--sched", "off"],
])
def test_serve_banner_mesh_and_sched_tokens_match_the_jax_verb(
        argv, monkeypatch, capsys):
    """``serve --ingest --mesh-devices N|DPxMP --sched MODE`` prints the
    JAX verb's banner, ``mesh=`` and ``sched=`` tokens included."""
    import go_crdt_playground_tpu.__main__ as jax_cli
    import go_crdt_playground_tpu_torch.__main__ as port_cli

    class _Stop(Exception):
        pass

    class _FakeFrontend:
        def serve(self, port=0, peer_port=None):
            return "127.0.0.1", 7001

    banners = []
    for mod in (jax_cli, port_cli):
        real = mod._ingest_banner

        def banner(args, host, bound, real=real):
            real(args, host, bound)
            raise _Stop

        monkeypatch.setattr(mod, "_build_frontend",
                            lambda args: _FakeFrontend())
        monkeypatch.setattr(mod, "_ingest_banner", banner)
        with pytest.raises(_Stop):
            mod.main(["serve", "--ingest", *argv])
        banners.append(capsys.readouterr().out.strip().splitlines()[-1])
    assert banners[0] == banners[1]
    want = {"4": "mesh=4", "2x2": "mesh=2x2"}.get(
        argv[1] if argv[0] == "--mesh-devices" else None, "mesh=off")
    assert want in banners[1]
    assert f"sched={argv[-1] if '--sched' in argv else 'auto'}" in banners[1]
    # a malformed spec exits 2 in both verbs
    for mod in (jax_cli, port_cli):
        with pytest.raises(SystemExit) as e:
            mod.main(["serve", "--ingest", "--mesh-devices", "2x"])
        assert e.value.code == 2


def test_mesh_entry_points_need_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    from go_crdt_playground_tpu_torch.entry import dryrun_multichip
    from go_crdt_playground_tpu_torch.parallel import (mesh, meshtarget,
                                                      multihost)

    for call in (lambda: dryrun_multichip(2),
                 lambda: meshtarget.MeshApplyTarget(0, 16, 2,
                                                    mesh_devices=1),
                 lambda: mesh.take_devices(2, "cuda"),
                 lambda: mesh.take_devices(1, "cuda:0"),
                 lambda: mesh.take_devices(2),
                 lambda: mesh.make_mesh(),
                 lambda: multihost.global_mesh(),
                 lambda: multihost.initialize("file:///nonexistent", 1, 0)):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()
