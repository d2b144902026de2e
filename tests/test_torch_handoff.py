"""Live resharding in the port (shard/handoff.py): a torch router and a
JAX router run the same join, aborted join and leave over equivalent
fleets on the same ports; the ring, epoch and ring-file records they
write are equal byte for byte but for the named time fields
(``fence_s``, ``elapsed_s``), the writers serialize one record to the
same bytes, each package's router adopts the other's state directory,
and a router killed mid-handoff restarts on the old ring.

Torch frontends run on the CPU (``device="cpu"``).
"""

import json
import os
import re
import socket

import numpy as np
import pytest

from go_crdt_playground_tpu.serve.frontend import \
    ServeFrontend as JaxFrontend
from go_crdt_playground_tpu.shard import handoff as jax_handoff
from go_crdt_playground_tpu.shard import router as jax_router_mod
from go_crdt_playground_tpu_torch.serve import protocol
from go_crdt_playground_tpu_torch.serve.client import ServeClient
from go_crdt_playground_tpu_torch.serve.frontend import ServeFrontend
from go_crdt_playground_tpu_torch.shard import handoff
from go_crdt_playground_tpu_torch.shard import router as router_mod
from go_crdt_playground_tpu_torch.shard.ring import HashRing, remap_fraction
from tests.test_torch_net import prompt_jax_close  # noqa: F401 (autouse)

E, A = 64, 4
FE_KW = dict(max_batch=8, flush_ms=1.0, queue_depth=32)
TIME_FIELDS = ("fence_s", "elapsed_s")
PACKAGES = {
    "jax": (lambda i, d: JaxFrontend(E, A, actor=i, durable_dir=d, **FE_KW),
            jax_router_mod, jax_handoff),
    "torch": (lambda i, d: ServeFrontend(E, A, actor=i, durable_dir=d,
                                         device="cpu", **FE_KW),
              router_mod, handoff),
}


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def masked(text):
    """A record's bytes with the named time fields' values blanked."""
    for name in TIME_FIELDS:
        text = re.sub(rf'("{name}": )[-0-9.e]+', r"\1T", text)
    return text


def read(state_dir, name):
    path = os.path.join(state_dir, name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read()


def run_handoffs(package, root, ports):
    """2 shards and a joiner on fixed ports behind ``package``'s router
    with a state dir: populate, join s2, a join of s3 to a dead address
    (aborts after the fence, in the transfer), then leave s2.  Returns
    the records after each step and what the client saw."""
    make_fe, rmod, _ = PACKAGES[package]
    state_dir = os.path.join(root, "router-state")
    fes = [make_fe(i, os.path.join(root, f"s{i}")) for i in range(3)]
    out = {"state_dir": state_dir, "steps": []}
    router = None
    try:
        addrs = [fe.serve(port=p) for fe, p in zip(fes, ports)]
        router = rmod.ShardRouter({"s0": addrs[0], "s1": addrs[1]}, E,
                                  seed=5, state_dir=state_dir,
                                  transfer_timeout_s=1.0)
        addr = router.serve()
        with ServeClient(addr, timeout=60.0) as c:
            c.add(*range(0, E, 2))
            c.delete(4)
            c.add(*range(1, E, 2))
            steps = [("join", protocol.RESHARD_JOIN, "s2", addrs[2]),
                     ("abort", protocol.RESHARD_JOIN, "s3",
                      ("127.0.0.1", 1)),
                     ("leave", protocol.RESHARD_LEAVE, "s2", None)]
            for name, mode, sid, a in steps:
                ok, detail = c.reshard(mode, sid, a, timeout=60.0)
                out["steps"].append({
                    "step": name, "ok": ok, "detail": detail,
                    "ring": read(state_dir, handoff.RING_FILE),
                    "epoch": read(state_dir, handoff.EPOCH_FILE),
                    "info": c.stats()["ring"],
                    "members": c.members()[0]})
        out["final_info"] = router.route().info()
    finally:
        if router is not None:
            router.close()
        for fe in fes:
            fe.close()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("handoff")
    ports = free_ports(3)
    return {pkg: run_handoffs(pkg, str(root / pkg), ports)
            for pkg in ("jax", "torch")}


def test_join_abort_leave_outcomes(runs):
    """Join commits and moves exactly ``remap_fraction``'s slice, the
    aborted join leaves the old ring's generation and digest in STATS,
    the leave restores the birth digest; members never change."""
    for pkg, run in runs.items():
        join, abort, leave = run["steps"]
        assert join["ok"] and leave["ok"] and not abort["ok"], pkg
        r0 = HashRing(["s0", "s1"], seed=5)
        r1 = r0.with_shard("s2")
        rm = remap_fraction(r0.owner_map(E), r1.owner_map(E),
                            r0.shards, r1.shards)
        assert join["detail"]["moved"] == rm["moved"] > 0
        assert join["detail"]["fraction"] == pytest.approx(rm["fraction"])
        assert join["detail"]["moved_transferred"] == rm["moved"]
        assert abort["info"]["generation"] == join["info"]["generation"]
        assert abort["info"]["digest"] == join["info"]["digest"]
        assert abort["ring"] == join["ring"], "an abort rewrote the ring"
        assert json.loads(abort["epoch"])["phase"] == handoff.PHASE_ABORTED
        assert leave["info"]["generation"] == 2
        assert leave["info"]["digest"] == r0.digest(E, r0.owner_map(E))
        want = sorted(set(range(E)) - {4})
        assert join["members"] == abort["members"] == \
            leave["members"] == want


def test_records_equal_across_packages(runs):
    """The ring and epoch records of each step, and the reshard verdict
    details, equal the JAX router's byte for byte outside the named
    time fields."""
    for j, t in zip(runs["jax"]["steps"], runs["torch"]["steps"]):
        assert masked(t["ring"]) == masked(j["ring"]), t["step"]
        assert masked(t["epoch"]) == masked(j["epoch"]), t["step"]
        jd, td = dict(j["detail"]), dict(t["detail"])
        for name in TIME_FIELDS:
            jd.pop(name, None)
            td.pop(name, None)
        assert jd == td, t["step"]
        assert t["info"] == j["info"]
    assert runs["torch"]["final_info"] == runs["jax"]["final_info"]


@pytest.mark.parametrize("phase", [handoff.PHASE_STAGED,
                                   handoff.PHASE_COMMITTED,
                                   handoff.PHASE_ABORTED])
def test_writers_serialize_the_same_bytes(tmp_path, phase):
    """One coordinator record, each package's writer: equal bytes, and
    the router- and shard-epoch files too."""
    class Stub:
        num_elements = E

    ring = HashRing(["s0", "s1", "s2"], seed=5)
    info = {"generation": 3, "digest": ring.digest(E, ring.owner_map(E)),
            "shards": list(ring.shards), "seed": 5, "fenced": 0}
    detail = {"mode": "join", "sid": "s2", "moved": 21, "generation": 3,
              "digest": info["digest"], "fraction": 0.328125,
              "fence_s": 0.0123, "pairs": [["s0", "s2", 11]]}
    shards = {"s0": ("127.0.0.1", 1), "s1": ("127.0.0.1", 2),
              "s2": [("127.0.0.1", 3), ("127.0.0.1", 4)]}
    files = {}
    for name, mod in (("jax", jax_handoff), ("torch", handoff)):
        d = str(tmp_path / name)
        os.makedirs(d)
        coord = mod.HandoffCoordinator(Stub(), state_dir=d)
        coord._persist(7, phase, info, detail,
                       shards_map=shards if phase == "committed" else None)
        mod.persist_router_epoch(d, 4, "router-a")
        mod.persist_shard_epochs(d, {"s0": 2, "s1": 1})
        files[name] = {f: read(d, f) for f in sorted(os.listdir(d))}
    assert files["torch"] == files["jax"]
    assert handoff.load_router_epoch(str(tmp_path / "jax")) == 4
    assert jax_handoff.load_shard_epochs(str(tmp_path / "torch")) == {
        "s0": 2, "s1": 1}


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_router_adopts_the_other_packages_state_dir(runs, writer, reader):
    """A router of one package restarted on the state dir the other
    package's router committed: the same ring, generation, digest and
    epoch counter, whatever the ``--shard`` flags say."""
    rmod = PACKAGES[reader][1]
    router = rmod.ShardRouter({"zz": ("127.0.0.1", 9)}, E, seed=5,
                              state_dir=runs[writer]["state_dir"])
    try:
        assert router.route().info() == runs[writer]["final_info"]
        assert router.handoff.epoch == 3
    finally:
        router.close()


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_restart_mid_handoff_serves_the_old_ring(tmp_path, package):
    """A torch router dies with a handoff STAGED on disk (the fence up,
    nothing committed): a router of either package restarts on the last
    committed ring, with the epoch counter past the dead one."""
    make_fe, _, _ = PACKAGES["torch"]
    d = str(tmp_path / "router-state")
    fes = [make_fe(i, str(tmp_path / f"s{i}")) for i in range(3)]
    try:
        addrs = [fe.serve() for fe in fes]
        router = router_mod.ShardRouter(
            {"s0": addrs[0], "s1": addrs[1]}, E, seed=5, state_dir=d)
        router.serve()
        ok = router.handoff.reshard("join", "s2", addrs[2])
        committed = router.route().info()
        assert ok["generation"] == 1
        # the next handoff gets as far as its staged record and fence
        rt = router.route()
        router.handoff._persist(2, handoff.PHASE_STAGED, rt.info(),
                                {"mode": "leave", "sid": "s2",
                                 "moved": 1})
        fence = np.zeros(E, bool)
        fence[:8] = True
        router.set_fence(fence)
        router.close()  # killed mid-handoff
        rmod = PACKAGES[package][1]
        again = rmod.ShardRouter({"s0": addrs[0], "s1": addrs[1]}, E,
                                 seed=5, state_dir=d)
        try:
            info = again.route().info()
            assert info == {**committed, "fenced": 0}
            assert again.handoff.epoch == 2
            assert again.route().fence is None
        finally:
            again.close()
    finally:
        for fe in fes:
            fe.close()
