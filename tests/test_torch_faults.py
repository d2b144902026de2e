"""The port's fault injection (net/faults.py): tests/test_chaos.py's
in-process scenarios on torch nodes, and the seeded fault streams held
equal to the JAX package's.

Torch nodes run on the CPU (``device="cpu"``).  The scripted scenarios
run behind the port's ``ChaosProxy`` and behind the JAX package's (one
wire, either proxy); the seeded ``ChaosProxy`` plans and the
``StorageFaults`` counters and corrupted bytes are compared with the
JAX objects' for the same seed and scenario, and a corrupted durable
directory written by the port restores (or fails typed) exactly as the
JAX package restores the same bytes.
"""

import dataclasses
import os
import shutil
import socket
import time

import numpy as np
import pytest

from go_crdt_playground_tpu.net import faults as jax_faults
from go_crdt_playground_tpu.net.peer import Node as JaxNode
from go_crdt_playground_tpu_torch.net import faults, framing
from go_crdt_playground_tpu_torch.net.antientropy import SyncSupervisor
from go_crdt_playground_tpu_torch.net.faults import (ChaosProxy,
                                                     ChaosScenario,
                                                     StorageFaults,
                                                     StorageScenario,
                                                     fleet_proxies)
from go_crdt_playground_tpu_torch.net.peer import Node, PeerReset, SyncError
from go_crdt_playground_tpu_torch.obs import Recorder
from go_crdt_playground_tpu_torch.utils.backoff import BackoffPolicy
from go_crdt_playground_tpu_torch.utils.checkpoint import CheckpointStore
from go_crdt_playground_tpu_torch.utils.wal import DeltaWal
from tests.test_torch_net import prompt_jax_close  # noqa: F401 (autouse)

E = 48
FAST = BackoffPolicy(base_s=0.002, cap_s=0.02, max_retries=2, jitter=0.0)

# either package's proxy carries the same bytes (the port's is a copy)
PROXIES = pytest.mark.parametrize(
    "proxy_cls", [ChaosProxy, jax_faults.ChaosProxy],
    ids=["torch-proxy", "jax-proxy"])


def node(actor, num_actors=2, **kw):
    return Node(actor, E, num_actors, device="cpu", **kw)


def proxy_addr(p):
    return ("127.0.0.1", p.port)


def sync_eventually(n, addr, deadline_s: float = 10.0):
    """Retry a direct sync until it lands (for post-fault assertions)."""
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            return n.sync_with(addr, timeout=5.0)
        except (OSError, framing.ProtocolError, framing.RemoteError):
            if time.monotonic() > deadline:
                raise
            time.sleep(0.02)


def wait_for(pred, seconds=10.0):
    deadline = time.monotonic() + seconds
    while not pred():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.02)


# -- scripted single faults on torch nodes ----------------------------------


@PROXIES
def test_scripted_drop_before_hello(proxy_cls):
    a, b = node(0), node(1)
    with b:
        proxy = proxy_cls(b.serve(), script=["drop", "ok"])
        with proxy:
            a.add(1)
            with pytest.raises(SyncError):
                a.sync_with(proxy_addr(proxy), timeout=3.0)
            assert b.members().size == 0, "dropped dial must apply nothing"
            sync_eventually(a, proxy_addr(proxy))
            assert 1 in b.members()
            c = proxy.counters()
            assert c["dropped"] == 1 and c["passed"] == 1


@PROXIES
def test_mid_frame_truncation_is_all_or_nothing(proxy_cls):
    a, b = node(0), node(1)
    with b:
        proxy = proxy_cls(b.serve(), script=["truncate:30"])
        with proxy:
            a.add(*range(20))
            with pytest.raises(PeerReset):
                a.sync_with(proxy_addr(proxy), timeout=3.0)
            wait_for(lambda: proxy.counters()["truncated"] == 1)
            assert b.members().size == 0, \
                "mid-frame truncation corrupted applied state"
            sync_eventually(a, proxy_addr(proxy))
            np.testing.assert_array_equal(b.members(), np.arange(20))


@PROXIES
def test_garbled_magic_rejected_without_corruption(proxy_cls):
    a, b = node(0), node(1)
    with b:
        proxy = proxy_cls(b.serve(), script=["garble:0"])
        with proxy:
            a.add(3, 7)
            before = b.vv().copy()
            with pytest.raises((SyncError, framing.RemoteError)):
                a.sync_with(proxy_addr(proxy), timeout=3.0)
            assert b.members().size == 0
            np.testing.assert_array_equal(b.vv(), before)
            assert proxy.counters()["garbled"] == 1
            sync_eventually(a, proxy_addr(proxy))
            np.testing.assert_array_equal(b.members(), [3, 7])


@PROXIES
def test_garbled_body_field_rejected_as_remote_error(proxy_cls):
    a, b = node(0), node(1)
    with b:
        proxy = proxy_cls(b.serve(), script=["garble:5"])
        with proxy:
            a.add(3)
            with pytest.raises(framing.RemoteError,
                               match="universe mismatch"):
                a.sync_with(proxy_addr(proxy), timeout=3.0)
            assert b.members().size == 0
            sync_eventually(a, proxy_addr(proxy))
            np.testing.assert_array_equal(b.members(), [3])


@PROXIES
def test_duplicate_delivery_is_idempotent(proxy_cls):
    rec = Recorder()
    a, b = node(0), node(1, recorder=rec)
    with b:
        proxy = proxy_cls(b.serve(), script=["duplicate"])
        with proxy:
            a.add(1, 2, 3)
            a.sync_with(proxy_addr(proxy), timeout=5.0)
            members_after = set(b.members())
            vv_after = b.vv().copy()
            wait_for(lambda: rec.snapshot()["counters"].get(
                "sync.exchanges", 0) >= 2)
            assert set(b.members()) == members_after == {1, 2, 3}
            np.testing.assert_array_equal(b.vv(), vv_after)
            assert proxy.counters()["duplicated"] == 1


@PROXIES
def test_partition_refuses_then_heals(proxy_cls):
    a, b = node(0), node(1)
    with b:
        proxy = proxy_cls(b.serve())
        with proxy:
            a.add(5)
            proxy.partition()
            with pytest.raises(SyncError):
                a.sync_with(proxy_addr(proxy), timeout=3.0)
            assert proxy.counters()["refused"] == 1
            assert b.members().size == 0
            proxy.heal()
            sync_eventually(a, proxy_addr(proxy))
            assert 5 in b.members()


# -- the seeded streams, across packages ------------------------------------


SCENARIOS = [dict(drop_rate=0.3, truncate_rate=0.2, duplicate_rate=0.2),
             dict(drop_rate=0.25, truncate_rate=0.1, duplicate_rate=0.1,
                  garble_rate=0.1),
             dict(truncate_rate=1.0)]


@pytest.mark.parametrize("seed", [0, 17, 99, 2**31 + 5])
@pytest.mark.parametrize("scenario", range(len(SCENARIOS)))
def test_seeded_chaos_plans_equal_across_packages(seed, scenario):
    """The same seed and scenario plan the same fault stream in both
    packages (the census the chaos legs compare rests on it), and two
    port proxies with one seed agree with each other."""
    srv = socket.create_server(("127.0.0.1", 0))
    try:
        target = srv.getsockname()[:2]
        plans = []
        for mod in (faults, faults, jax_faults):
            sc = mod.ChaosScenario(**SCENARIOS[scenario])
            p = mod.ChaosProxy(target, seed=seed, scenario=sc)
            try:
                plans.append([(pl.action, pl.cut_after, pl.duplicate,
                               pl.garble, pl.garble_offset, pl.delay_s)
                              for pl in (p._next_plan()
                                         for _ in range(64))])
            finally:
                p.close()
        assert plans[0] == plans[1] == plans[2]
    finally:
        srv.close()


def test_fleet_proxy_seeds_equal_across_packages():
    srv = socket.create_server(("127.0.0.1", 0))
    try:
        addrs = [srv.getsockname()[:2]] * 3
        sc = dict(drop_rate=0.25, truncate_rate=0.1, duplicate_rate=0.1)
        ours = fleet_proxies(addrs, seed=17, scenario=ChaosScenario(**sc))
        theirs = jax_faults.fleet_proxies(
            addrs, seed=17, scenario=jax_faults.ChaosScenario(**sc))
        try:
            for p, q in zip(ours, theirs):
                assert dataclasses.asdict(p.scenario) == \
                    dataclasses.asdict(q.scenario)
                assert ([p._next_plan().action for _ in range(32)]
                        == [q._next_plan().action for _ in range(32)])
        finally:
            for p in ours + theirs:
                p.close()
    finally:
        srv.close()


def _durable_dir(tmp_path, name):
    """A torch node's durable dir: a checkpoint, then a WAL tail."""
    d = str(tmp_path / name)
    n = node(0, 4, wal=DeltaWal(os.path.join(d, "wal")))
    n.add(1, 2, 3)
    n.save_durable(CheckpointStore(d))
    n.add(7, 9)
    n.delete(2)
    n.add(11)
    n.wal.close()
    return d


def _files(d):
    return sorted(os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs)


def _bytes_of(d):
    return {os.path.relpath(p, d): open(p, "rb").read() for p in _files(d)}


STORAGE = [dict(torn_write_rate=1.0), dict(bit_flip_rate=1.0),
           dict(zero_fill_rate=1.0),
           dict(torn_write_rate=0.3, bit_flip_rate=0.3, zero_fill_rate=0.3)]


@pytest.mark.parametrize("seed", [1, 23])
@pytest.mark.parametrize("storage", range(len(STORAGE)))
def test_storage_faults_equal_across_packages(tmp_path, seed, storage):
    """One port-written durable dir, corrupted by each package's
    ``StorageFaults`` with one seed and scenario: the same counters and
    the same bytes, and each package restores the corrupted dir to the
    same state (or fails with the same exception type)."""
    base = _durable_dir(tmp_path, "base")
    copies = {}
    counters = {}
    for name, mod in (("torch", faults), ("jax", jax_faults)):
        d = str(tmp_path / name)
        shutil.copytree(base, d)
        sf = mod.StorageFaults(mod.StorageScenario(**STORAGE[storage]),
                               seed=seed)
        verbs = [sf.inject(p) for p in _files(d)]
        sf.bit_flip_array(next(p for p in _files(d)
                               if p.endswith(".ckpt")))
        counters[name] = (verbs, sf.counters())
        copies[name] = d
    assert counters["torch"] == counters["jax"]
    assert _bytes_of(copies["torch"]) == _bytes_of(copies["jax"])

    outcomes = []
    for restore in (
            lambda d: Node.restore_durable(
                d, fallback_init=lambda: node(0, 4), device="cpu"),
            lambda d: JaxNode.restore_durable(
                d, fallback_init=lambda: JaxNode(0, E, 4))):
        d = str(tmp_path / f"restore-{len(outcomes)}")
        shutil.copytree(copies["torch"], d)
        try:
            n = restore(d)
        except Exception as e:  # noqa: BLE001 — the type is compared
            outcomes.append(("raised", type(e).__name__))
            continue
        outcomes.append(("restored", sorted(int(x) for x in n.members()),
                         [int(x) for x in np.asarray(n.vv())]))
        n.close()
    assert outcomes[0] == outcomes[1]


def test_storage_scenario_and_verbs_match_reference():
    assert dataclasses.asdict(StorageScenario()) == \
        dataclasses.asdict(jax_faults.StorageScenario())
    assert dataclasses.asdict(ChaosScenario()) == \
        dataclasses.asdict(jax_faults.ChaosScenario())
    for name in ("STORAGE_TORN", "STORAGE_BITFLIP", "STORAGE_ZERO"):
        assert getattr(faults, name) == getattr(jax_faults, name)
    assert StorageFaults().counters() == jax_faults.StorageFaults().counters()


# -- the acceptance scenario on torch nodes ----------------------------------


def test_seeded_chaos_fleet_acceptance(tmp_path):
    """tests/test_chaos.py's acceptance scenario on torch nodes: ≥20%
    exchange drop, an asymmetric partition that heals and a guaranteed
    mid-frame truncation; the 4-node fleet converges, the breakers go
    open, half-open and closed, and a node restored from its supervisor
    checkpoint reconverges through the FULL-state first contact."""
    N_ACTIVE, N_ACTORS = 4, 5
    recs = [Recorder() for _ in range(N_ACTIVE)]
    nodes = [node(i, N_ACTORS, recorder=recs[i], hello_timeout_s=0.5)
             for i in range(N_ACTIVE)]
    proxies, sups = [], []
    ck = str(tmp_path / "node3.ckpt")
    try:
        addrs = [n.serve() for n in nodes]
        for i, n in enumerate(nodes):
            n.add(*range(i * 8, i * 8 + 8))
        scenario = ChaosScenario(drop_rate=0.25, truncate_rate=0.1,
                                 duplicate_rate=0.1)
        proxies = fleet_proxies(addrs, seed=17, scenario=scenario)
        proxies[1]._script.append("truncate:30")
        for i in range(N_ACTIVE):
            peer_addrs = [proxy_addr(proxies[j])
                          for j in range(N_ACTIVE) if j != i]
            sups.append(SyncSupervisor(
                nodes[i], peer_addrs, policy=FAST, sync_timeout_s=2.0,
                breaker_threshold=2, breaker_cooldown_s=0.1,
                interval_s=0.0, recorder=recs[i], seed=700 + i,
                checkpoint_path=ck if i == 3 else None,
                checkpoint_every=2 if i == 3 else 0))

        def lockstep(group=sups):
            for s in group:
                s.sync_round()

        expected = set(range(N_ACTIVE * 8))

        def converged(members_expected, live):
            vv0 = live[0].vv()
            return all(set(n.members()) == members_expected
                       and np.array_equal(n.vv(), vv0) for n in live)

        lockstep()
        proxies[0].partition()
        for _ in range(3):
            lockstep()
            time.sleep(0.11)  # breaker cooldowns elapse between rounds
        proxies[0].heal()
        deadline = time.monotonic() + 90.0
        while not converged(expected, nodes):
            assert time.monotonic() < deadline, [
                sorted(n.members()) for n in nodes]
            lockstep()
            time.sleep(0.05)

        census = {}
        for p in proxies:
            for k, v in p.counters().items():
                census[k] = census.get(k, 0) + v
        assert census["refused"] >= 1
        assert census["truncated"] >= 1
        assert census["dropped"] >= 1

        deadline = time.monotonic() + 60.0
        while not all(s.breaker(p).state == "closed"
                      for s in sups for p in s.peers):
            assert time.monotonic() < deadline, \
                "breakers never recovered after the heal"
            lockstep()
            time.sleep(0.11)
        agg = {}
        for r in recs:
            for k, v in r.snapshot()["counters"].items():
                agg[k] = agg.get(k, 0) + v
        for t in ("open", "half_open", "closed"):
            assert agg.get(f"breaker.to_{t}", 0) >= 1, agg
        retries = {k: v for k, v in agg.items()
                   if k.startswith("sync.retries.")}
        assert retries and all(v >= 1 for v in retries.values()), agg
        assert agg.get("sync.checkpoints", 0) >= 1

        sups[3].stop(timeout=2.0)
        nodes[3].close()
        proxies[3].close()
        nodes[0].add(40, 41)
        for _ in range(2):
            lockstep(sups[:3])

        sup3 = SyncSupervisor.restore(
            ck, [proxy_addr(proxies[j]) for j in range(3)],
            recorder=Recorder(), policy=FAST, sync_timeout_s=5.0,
            interval_s=0.0, seed=703, device="cpu")
        restored = sup3.node
        assert restored.actor == 3
        assert set(restored.members()) <= expected

        late = node(4, N_ACTORS)
        with late:
            addr4 = late.serve()
            late.add(44, 45)
            restored.serve()
            stats = restored.sync_with(addr4, timeout=5.0)
            assert stats.mode_sent == framing.MODE_FULL
            expected2 = expected | {40, 41, 44, 45}
            live = [nodes[0], nodes[1], nodes[2], restored, late]
            deadline = time.monotonic() + 90.0
            while not converged(expected2, live):
                assert time.monotonic() < deadline, [
                    sorted(n.members()) for n in live]
                lockstep(sups[:3])
                sup3.sync_round()
                try:
                    restored.sync_with(addr4, timeout=5.0)
                except (OSError, framing.ProtocolError):
                    pass
                time.sleep(0.05)
            sup3.stop(timeout=1.0)
            restored.close()
    finally:
        for s in sups:
            s.stop(timeout=1.0)
        for p in proxies:
            p.close()
        for n in nodes:
            n.close()
