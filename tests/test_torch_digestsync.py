"""Digest-driven anti-entropy on the port (net/digestsync.py, the
supervisor's digest regime) against the JAX package.

The JAX package's tests/test_digestsync.py replayed on torch nodes
(CPU), then parity: the summary and PAYLOAD bodies of every rung of
``build_reply_payload`` byte for byte against the JAX node's for the
same state, mixed JAX <-> torch pairs over real sockets at every allowed
group size reporting the exchanges and reaching the states of a JAX-only
pair (``np.array_equal``, dtype included), the sync curve's quick leg on
a torch fleet against tools/chaos_soak.py's on a JAX fleet, and a mixed
fleet.  Sockets bind port 0 on 127.0.0.1; every wait is bounded.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

import chip_smoke
from go_crdt_playground_tpu.net import digestsync as jax_digestsync
from go_crdt_playground_tpu.net import framing as jax_framing
from go_crdt_playground_tpu.net.antientropy import \
    SyncSupervisor as JaxSupervisor
from go_crdt_playground_tpu.net.peer import Node as JaxNode
from go_crdt_playground_tpu.obs import Recorder
from go_crdt_playground_tpu.utils.backoff import BackoffPolicy as JaxPolicy
from go_crdt_playground_tpu_torch._u32 import host
from go_crdt_playground_tpu_torch.net import digestsync, framing
from go_crdt_playground_tpu_torch.net.antientropy import SyncSupervisor
from go_crdt_playground_tpu_torch.net.digestsync import (
    ALLOWED_GROUP_SIZES, AdaptiveGroupSize, DigestNegotiator, DigestSyncStats,
    DigestUnsupported, sync_digest)
from go_crdt_playground_tpu_torch.net.framing import (MODE_DELTA, MODE_DIGEST,
                                                      MODE_FULL)
from go_crdt_playground_tpu_torch.net.peer import Node
from go_crdt_playground_tpu_torch.ops.delta import delta_extract
from go_crdt_playground_tpu_torch.utils.backoff import BackoffPolicy
from go_crdt_playground_tpu_torch.utils.wal import DeltaWal
from tests.test_torch_net import prompt_jax_close  # noqa: F401 (autouse)
from tests.test_torch_node import assert_nodes_same

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

E, A = 256, 4  # 4 digest groups of 64


def node(actor, e=E, a=A, **kw):
    return Node(actor, e, a, device="cpu", **kw)


def _pair(recorders=False, e=E):
    recs = [Recorder(), Recorder()] if recorders else [None, None]
    return node(0, e, recorder=recs[0]), node(1, e, recorder=recs[1]), recs


def _converge(a, addr, gs=64):
    for _ in range(4):
        if sync_digest(a, addr, group_size=gs).quiescent:
            return
    raise AssertionError("pair failed to reach a quiescent round")


# ---------------------------------------------------------------------------
# tests/test_digestsync.py on torch nodes
# ---------------------------------------------------------------------------


def test_summary_codec_roundtrip_and_bytes():
    vv = np.asarray([3, 0, 9, 0xFFFFFFFF], np.uint32)
    proc = np.asarray([2, 0, 9, 1], np.uint32)
    digs = np.arange(4, dtype=np.uint32) * 0x1234567
    body = digestsync.encode_summary(2, E, 64, vv, proc, digs)
    assert body == jax_digestsync.encode_summary(2, E, 64, vv, proc, digs)
    actor, gs, vv2, proc2, digs2 = digestsync.decode_summary(body, E, A)
    assert (actor, gs) == (2, 64)
    for x, y in ((vv, vv2), (proc, proc2), (digs, digs2)):
        assert y.dtype == np.uint32 and np.array_equal(x, y)
    with pytest.raises(framing.ProtocolError, match="universe"):
        digestsync.decode_summary(body, E + 1, A)
    with pytest.raises(framing.ProtocolError):
        digestsync.decode_summary(body[:-2], E, A)
    with pytest.raises(framing.ProtocolError, match="does not cover"):
        digestsync.decode_summary(
            digestsync.encode_summary(2, E, 32, vv, proc, digs), E, A)
    with pytest.raises(framing.ProtocolError, match="version"):
        digestsync.decode_summary(b"\x02" + body[1:], E, A)


def test_digest_payload_mode_roundtrip():
    a, _, _ = _pair()
    a.add(3, 70, 200)
    a.delete(70)
    me = a.state_slice()
    p = delta_extract(me, torch.zeros_like(me.vv))
    body = framing.encode_payload_msg(MODE_DIGEST, 0, me.processed, p)
    mode, p2 = framing.decode_payload_msg(body, E, A)
    assert mode == MODE_DIGEST
    for name in ("changed", "ch_dc", "deleted", "del_dc"):
        assert np.array_equal(host(getattr(p, name)), getattr(p2, name)), name
    dense = framing.encode_payload_msg(MODE_DELTA, 0, me.processed, p)
    assert len(body) < len(dense) - 2 * (E // 8) + 16


def test_divergent_pair_ships_only_mismatched_lanes():
    a, b, recs = _pair(recorders=True)
    a.add(*range(0, 8))
    b.add(*range(64, 70))
    addr = b.serve()
    try:
        st = sync_digest(a, addr)
        chip_smoke.wait_served([b])
    finally:
        b.close()
    assert st.mode_sent == MODE_DIGEST
    assert st.groups_mismatched == 2 and st.lanes_sent == 8
    assert a.members().tolist() == b.members().tolist() == \
        list(range(8)) + list(range(64, 70))
    assert np.array_equal(a.vv(), b.vv())
    assert recs[1].counter("digest.lanes_sent") == 6


def test_quiescent_pair_ships_zero_state_lanes():
    a, b, recs = _pair(recorders=True)
    a.add(1, 2, 100)
    a.delete(2)
    addr = b.serve()
    try:
        _converge(a, addr)
        chip_smoke.wait_served([b])

        def total(name):
            return recs[0].counter(name) + recs[1].counter(name)

        base_bytes, lanes_before = (total("digest.bytes_sent"),
                                    total("digest.lanes_sent"))
        for _ in range(5):
            st = sync_digest(a, addr)
            assert st.quiescent and st.lanes_sent == 0
            assert st.mode_sent == MODE_DIGEST
        chip_smoke.wait_served([b])
        assert total("digest.lanes_sent") == lanes_before
        assert recs[0].counter("digest.quiescent") >= 5
        assert (total("digest.bytes_sent") - base_bytes) / 5 < 4 * (E // 8)
    finally:
        b.close()


def test_deletion_heavy_quiescence_beats_delta_ladder():
    a, b, recs = _pair(recorders=True)
    a.add(*range(32))
    a.delete(*range(16))
    addr = b.serve()
    try:
        _converge(a, addr)
        chip_smoke.wait_served([b])

        def total(name):
            return recs[0].counter(name) + recs[1].counter(name)

        r0 = total("digest.bytes_sent")
        assert sync_digest(a, addr).quiescent
        chip_smoke.wait_served([b])
        digest_round = total("digest.bytes_sent") - r0
        s0 = total("sync.bytes_sent")
        a.sync_with(addr)
        chip_smoke.wait_served([b])
        assert digest_round < total("sync.bytes_sent") - s0
    finally:
        b.close()


def test_vv_only_divergence_falls_back_to_delta():
    a, b, _ = _pair()
    a.add(1)
    addr = b.serve()
    try:
        _converge(a, addr)
        a.delete(200)   # ticks a's clock, touches no lane
        a.recorder = rec = Recorder()
        st = sync_digest(a, addr)
        assert st.mode_sent in (MODE_DELTA, MODE_FULL)
        assert rec.counter("digest.fallback_delta") == 1
        assert np.array_equal(a.vv(), b.vv())
        assert sync_digest(a, addr).quiescent
    finally:
        b.close()


def _legacy_serve_conn(self, conn):
    """A pre-digest server's dispatch: no MSG_DIGEST branch."""
    try:
        with conn:
            conn.settimeout(self.conn_timeout_s)
            msg_type, body = framing.recv_frame(conn,
                                                timeout=self.hello_timeout_s)
            if msg_type != framing.MSG_HELLO:
                framing.send_frame(conn, framing.MSG_ERROR,
                                   f"expected HELLO, got {msg_type}".encode())
                return
            _, peer_vv = framing.decode_hello(body, self.num_elements,
                                              self.num_actors)
            framing.send_frame(conn, framing.MSG_HELLO, framing.encode_hello(
                self.actor, self.num_elements, self.vv()))
            msg_type, body = framing.recv_frame(conn,
                                                timeout=self.conn_timeout_s)
            with self._lock:
                self._apply_msg(body)
                _, reply = self._extract_msg(peer_vv)
            framing.send_frame(conn, framing.MSG_PAYLOAD, reply)
    except Exception:  # noqa: BLE001 — test double
        pass


def test_legacy_peer_negotiates_down():
    a, b, _ = _pair()
    b._serve_conn = types.MethodType(_legacy_serve_conn, b)
    a.add(5)
    addr = b.serve()
    neg = DigestNegotiator()
    try:
        with pytest.raises(DigestUnsupported):
            sync_digest(a, addr)
        neg.mark_legacy(addr)
        assert not neg.use_digest(addr) and neg.legacy_peers() == {addr}
        a.sync_with(addr)
        assert b.members().tolist() == [5]
        # the supervisor pins the peer legacy and completes the same round
        rec = Recorder()
        sup = SyncSupervisor(a, [addr], sync_mode="digest", recorder=rec,
                             interval_s=0.0)
        a.add(6)
        assert sup.sync_round()["succeeded"] == 1
        assert rec.counter("sync.digest.unsupported") == 1
        assert b.members().tolist() == [5, 6]
        sup.sync_round()
        assert rec.counter("sync.digest.unsupported") == 1
    finally:
        b.close()


def test_digest_payloads_are_wal_logged_and_replay(tmp_path):
    """A lane payload applied over a digest exchange is logged before the
    state mutates and replays through restore_durable, on the port and
    (the same directory) on the JAX package."""
    d = str(tmp_path / "durable")
    rec = Recorder()
    b = node(1, recorder=rec, wal=DeltaWal(os.path.join(d, "wal"),
                                           recorder=rec))
    a = node(0)
    a.add(3, 9, 70)
    a.delete(9)
    addr = b.serve()
    try:
        assert sync_digest(a, addr).mode_sent == MODE_DIGEST
    finally:
        b.close()
    live = b.state_slice()
    with b._lock:
        b.wal.close()
    back = Node.restore_durable(d, fallback_init=lambda: node(1),
                                device="cpu")
    for name, x, y in zip(live._fields, live, back.state_slice()):
        assert x.dtype == y.dtype and bool((x == y).all()), name
    assert back.members().tolist() == [3, 70]
    back.wal.close()
    jback = JaxNode.restore_durable(d, fallback_init=lambda: JaxNode(1, E, A))
    assert_nodes_same(jback, back, "JAX restore of the port's directory")
    jback.wal.close()


def test_quiescent_rounds_feed_gc_evidence():
    a, b, _ = _pair()
    a.add(1, 2)
    a.delete(1)
    addr = b.serve()
    try:
        _converge(a, addr)
        assert a.deletion_frontier(participants=[1]).any()
        assert a.gc_deletions(participants=[1])["dropped"] == 1
    finally:
        b.close()


def test_supervisor_digest_regime_converges_fleet():
    n, e = 3, 192
    recs = [Recorder() for _ in range(n)]
    nodes = [node(i, e, n, recorder=recs[i]) for i in range(n)]
    addrs = [nd.serve() for nd in nodes]
    for i, nd in enumerate(nodes):
        nd.add(*range(i * 16, (i + 1) * 16))
    sups = []
    try:
        for i in range(n):
            sups.append(SyncSupervisor(
                nodes[i], [addrs[j] for j in range(n) if j != i],
                sync_mode="digest",
                policy=BackoffPolicy(base_s=0.005, cap_s=0.02,
                                     max_retries=1),
                sync_timeout_s=5.0, interval_s=0.0, recorder=recs[i],
                seed=7 + i))
        expected = set(range(16 * n))
        for _ in range(6):
            for s in sups:
                s.sync_round()
            if all(set(nd.members().tolist()) == expected for nd in nodes):
                break
        assert all(set(nd.members().tolist()) == expected for nd in nodes)
        for _ in range(3):
            for s in sups:
                s.sync_round()
        assert all(np.array_equal(nd.vv(), nodes[0].vv()) for nd in nodes)
        chip_smoke.wait_served(nodes)
        lanes0 = sum(r.counter("digest.lanes_sent") for r in recs)
        for _ in range(2):
            for s in sups:
                s.sync_round()
        chip_smoke.wait_served(nodes)
        assert sum(r.counter("digest.lanes_sent") for r in recs) == lanes0
        assert sum(r.counter("digest.quiescent") for r in recs) > 0
        assert sum(r.counter("sync.exchanges") for r in recs) == 0
    finally:
        for s in sups:
            s.stop(timeout=1.0)
        for nd in nodes:
            nd.close()


def test_supervisor_refuses_digest_on_reference_semantics():
    with pytest.raises(ValueError, match="v2"):
        SyncSupervisor(node(0, 32, 2, delta_semantics="reference"), [],
                       sync_mode="digest")
    with pytest.raises(ValueError, match="sync_mode"):
        SyncSupervisor(node(0, 32, 2), [], sync_mode="bogus")


def test_server_adopts_client_group_size_and_refuses_off_ladder():
    for gs in (16, 32, 128):
        a, b, _ = _pair()
        b.add(3, 70, 200)
        addr = b.serve("127.0.0.1", 0)
        try:
            assert sync_digest(a, addr, group_size=gs).groups_mismatched > 0
            assert sync_digest(a, addr, group_size=gs).quiescent
            assert a.members().tolist() == [3, 70, 200]
        finally:
            b.close()
    a, b, _ = _pair()
    addr = b.serve("127.0.0.1", 0)
    try:
        with pytest.raises(framing.RemoteError, match="group-size"):
            sync_digest(a, addr, group_size=48)
    finally:
        b.close()


def test_group_size_tradeoff_moves_the_right_way():
    seed_node = node(2)
    seed_node.add(*range(120))
    body = seed_node.extract_slice(np.ones(E, bool))
    assert len(digestsync.node_summary(seed_node, 128)) < \
        len(digestsync.node_summary(seed_node, 32)) < \
        len(digestsync.node_summary(seed_node, 16))
    lanes = {}
    for gs in (16, 128):
        server = node(3)
        server.apply_payload_body(body)
        addr = server.serve("127.0.0.1", 0)
        try:
            client = node(2)
            client.apply_payload_body(body)
            client.add(121)
            st = sync_digest(client, addr, group_size=gs)
            assert st.groups_mismatched == 1
            lanes[gs] = st.lanes_sent
        finally:
            server.close()
    assert lanes[128] > lanes[16] > 0, lanes


def test_adaptive_ladder_streaks_match_jax():
    """The same evidence through the port's and the JAX package's tuner
    gives the same moves and sizes, step for step."""
    p, q = ("127.0.0.1", 9999), ("127.0.0.1", 9998)
    total = digestsync.num_groups(E, 64)
    script = ([(0, 0, MODE_DIGEST)] * 9 + [(1, 3, MODE_DIGEST)] * 2
              + [(total, 200, MODE_DIGEST), (0, 50, MODE_DELTA)]
              + [(1, 1, MODE_DIGEST)] * 5 + [(0, 0, MODE_DIGEST)] * 3)
    logs = []
    for mod in (digestsync, jax_digestsync):
        ad = mod.AdaptiveGroupSize(E)
        log = []
        for i, (groups, lanes, mode) in enumerate(script):
            if i == len(script) - 4:
                ad.pin(p, 32)
            st = mod.DigestSyncStats(0, 0, mode, mode, lanes, groups,
                                     groups == 0 and lanes == 0)
            log.append((ad.observe(p, st), ad.size(p), ad.size(q)))
        logs.append(log)
    assert logs[0] == logs[1]
    assert ("grow", 128, 64) in logs[0] and ("shrink", 64, 64) in logs[0]
    with pytest.raises(ValueError):
        AdaptiveGroupSize(E, initial=48)
    assert DigestSyncStats._fields == jax_digestsync.DigestSyncStats._fields


def test_supervisor_adapts_group_size_online():
    rec = Recorder()
    a, b = node(0, recorder=rec), node(1)
    b.add(1, 2, 3)
    addr = b.serve("127.0.0.1", 0)
    sup = SyncSupervisor(a, [addr], sync_mode="digest", recorder=rec)
    try:
        for _ in range(8):
            sup.sync_round()
        assert rec.counter("digest.group_grow") >= 1
        assert sup._group_adapter.size(addr) > 64
        assert rec.snapshot()["gauges"]["digest.group_size"] > 64
        assert a.members().tolist() == [1, 2, 3]
    finally:
        sup.stop(timeout=1.0)
        b.close()


def test_supervisor_pins_the_default_size_for_a_pre_adaptive_server():
    """A server that refuses any non-default group size: the supervisor
    pins the peer to 64 and completes the same attempt at it."""
    rec = Recorder()
    a, b = node(0, recorder=rec), node(1)
    b.add(4)
    serve = digestsync.serve_digest_exchange

    def strict(server, conn, body):
        if digestsync.decode_summary(body, E, A)[1] != 64:
            framing.send_frame(conn, framing.MSG_ERROR,
                               b"digest group-size mismatch: peer, ours 64")
            return
        serve(server, conn, body)

    addr = b.serve()
    sup = SyncSupervisor(a, [addr], sync_mode="digest", recorder=rec)
    sup._group_adapter = AdaptiveGroupSize(E, initial=32)
    digestsync.serve_digest_exchange = strict
    try:
        assert sup.sync_round()["succeeded"] == 1
        assert rec.counter("digest.group_pinned") == 1
        assert sup._group_adapter.size(addr) == 64
        assert a.members().tolist() == [4]
    finally:
        digestsync.serve_digest_exchange = serve
        b.close()


# ---------------------------------------------------------------------------
# bodies against the JAX package's, every rung
# ---------------------------------------------------------------------------


def _twins(ops):
    """A JAX node and a torch node (actor 0) after the same ops."""
    j, t = JaxNode(0, E, A), node(0)
    for kind, ids in ops:
        for n in (j, t):
            getattr(n, kind)(*ids)
    return j, t


OPS = [("add", (1, 2, 70, 130, 255)), ("delete", (2, 130)), ("add", (2,)),
       ("delete", (9,)), ("add", (64, 65, 66))]


@pytest.mark.parametrize("gs", ALLOWED_GROUP_SIZES)
def test_summary_and_reply_bodies_match_jax_on_every_rung(gs):
    j, t = _twins(OPS)
    body = digestsync.node_summary(t, gs)
    assert body == jax_digestsync.node_summary(j, gs)
    _, _, vv, _, own = digestsync.decode_summary(body, E, A)
    peer = JaxNode(1, E, A)
    peer.add(3, 70, 200)
    peer.delete(70)
    _, _, peer_vv, _, peer_digs = jax_digestsync.decode_summary(
        jax_digestsync.node_summary(peer, gs), E, A)
    bumped = vv.copy()
    bumped[1] += 1
    never = vv.copy()
    never[0] = 0
    rungs = {
        "mismatched groups": (peer_vv, peer_digs, MODE_DIGEST),
        "quiescent": (vv, own, MODE_DIGEST),
        "δ fallback": (bumped, own, MODE_DELTA),
        "δ fallback, first contact": (never, own, MODE_FULL),
    }
    for rung, (pvv, pdigs, mode) in rungs.items():
        with j._lock:
            want = jax_digestsync.build_reply_payload(j, pvv, pdigs, gs)
        with t._lock:
            got = digestsync.build_reply_payload(t, pvv, pdigs, gs)
        assert got == want, rung
        assert got[0] == mode, rung
    assert framing.encode_hello(0, E, t.vv()) == \
        jax_framing.encode_hello(0, E, np.asarray(j.vv()))


# ---------------------------------------------------------------------------
# mixed JAX <-> torch pairs, digest exchanges at every allowed group size
# ---------------------------------------------------------------------------


def _digest_steps(client, server, sync, rng_seed):
    """Ops on both sides, then digest exchanges at each allowed group
    size in turn until quiescent; returns every exchange's stats."""
    rng = np.random.default_rng(rng_seed)
    out = []
    with server:
        addr = server.serve()
        client.sync_with(addr, timeout=10.0)   # first contact
        for gs in ALLOWED_GROUP_SIZES:
            for n in (client, server):
                n.add(*[int(x) for x in rng.choice(E, 3, replace=False)])
                n.delete(*[int(x) for x in rng.choice(E, 2, replace=False)])
            for _ in range(3):
                st = sync(client, addr, timeout=10.0, group_size=gs)
                out.append((gs, tuple(st)))
                if st.quiescent:
                    break
            assert st.quiescent, gs
    return out


@pytest.mark.parametrize("torch_side", ["client", "server"])
def test_mixed_digest_pair_matches_the_jax_pair(torch_side):
    ref = [JaxNode(i, E, A) for i in range(2)]
    want = _digest_steps(ref[0], ref[1], jax_digestsync.sync_digest, 5)
    t = 0 if torch_side == "client" else 1
    mixed = [JaxNode(i, E, A) for i in range(2)]
    mixed[t] = node(t)
    sync = sync_digest if t == 0 else jax_digestsync.sync_digest
    got = _digest_steps(mixed[0], mixed[1], sync, 5)
    assert got == want
    assert {gs for gs, _ in got} == set(ALLOWED_GROUP_SIZES)
    assert_nodes_same(ref[t], mixed[t], f"torch {torch_side}")
    for name, x, y in zip(ref[1 - t].state_slice()._fields,
                          ref[1 - t].state_slice(),
                          mixed[1 - t].state_slice()):
        assert np.array_equal(np.asarray(x), np.asarray(y)), name


# ---------------------------------------------------------------------------
# supervisor fleets
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_fleet_waits(monkeypatch):
    """tools/chaos_soak.run_traffic_leg reads the fleet's counters as soon
    as its clients return, while a served half may still be recording its
    own (a server counts after its last send), so under load its numbers
    move: a late server count falls out of the window it belongs to.  The
    port's leg waits for every served exchange (chip_smoke.wait_served).
    Here each supervisor round of the JAX fleet ends the same way: once
    every node of the fleet has finished serving."""
    import go_crdt_playground_tpu.net as jax_net

    nodes = []

    class FleetNode(jax_net.Node):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            nodes.append(self)

    class WaitingSupervisor(jax_net.SyncSupervisor):
        def sync_round(self, *args, **kwargs):
            out = super().sync_round(*args, **kwargs)
            chip_smoke.wait_served(nodes)
            return out

    monkeypatch.setattr(jax_net, "Node", FleetNode)
    monkeypatch.setattr(jax_net, "SyncSupervisor", WaitingSupervisor)


def _quick_legs(sync_mode):
    import chaos_soak

    want = chaos_soak.run_traffic_leg(sync_mode, 4, 256, 4, 5, seed=17,
                                      quiescent_rounds=4)
    got, states = chip_smoke.sync_traffic_leg(sync_mode, 4, 256, 4, 5, 17,
                                              quiescent_rounds=4,
                                              device="cpu")
    return want, got, states


@pytest.mark.parametrize("sync_mode", ["digest", "delta"])
def test_sync_curve_quick_leg_matches_the_jax_fleet(sync_mode,
                                                    jax_fleet_waits):
    """tools/chaos_soak.py's quick traffic leg (4 nodes, E = 256, 4 ops a
    round, 5 traffic and 4 quiescent rounds) on a torch fleet through
    chip_smoke.sync_traffic_leg, and on a JAX fleet through the tool:
    the same bytes, rounds, lanes and quiescent counts."""
    want, got, states = _quick_legs(sync_mode)
    assert got == want
    assert got["converged"] and len(states) == 4
    if sync_mode == "digest":
        assert got["quiescent_state_lanes"] == 0
        assert got["delta_fallbacks"] == 0
        assert got["quiescent_exchanges"] > 0


@pytest.mark.parametrize("sync_mode", ["digest", "delta"])
def test_sync_curve_quick_leg_counts_every_served_half(sync_mode,
                                                       jax_fleet_waits,
                                                       monkeypatch):
    """Every served half's counter record 50 ms late in both packages
    (what a loaded machine does to a server thread after its last send):
    both fleets still count the same bytes, rounds and lanes, and the
    same as with prompt records."""
    import threading
    import time

    import go_crdt_playground_tpu.net.digestsync as jax_ds
    import go_crdt_playground_tpu.net.peer as jax_peer

    want_prompt, got_prompt, _ = _quick_legs(sync_mode)

    def late(record):
        def wrapped(*args, **kwargs):
            if threading.current_thread() is not threading.main_thread():
                time.sleep(0.05)
            return record(*args, **kwargs)
        return wrapped

    for mod, name in ((jax_peer.Node, "_record"), (jax_ds, "_record"),
                      (Node, "_record"), (digestsync, "_record")):
        monkeypatch.setattr(mod, name, late(getattr(mod, name)))
    want, got, _ = _quick_legs(sync_mode)
    assert got == want == got_prompt == want_prompt


def test_mixed_fleet_converges_on_the_digest_regime():
    """Two JAX and two torch nodes, each driven by its own package's
    supervisor in lockstep digest rounds: converged, then quiescent
    rounds ship no state lanes."""
    n = 4
    recs = [Recorder() for _ in range(n)]
    nodes = [JaxNode(i, E, n, recorder=recs[i]) if i % 2
             else node(i, E, n, recorder=recs[i]) for i in range(n)]
    addrs = [nd.serve() for nd in nodes]
    sups = []
    try:
        for i, nd in enumerate(nodes):
            nd.add(*range(i * 10, i * 10 + 10))
            nd.delete(i * 10)
            cls, pol = ((JaxSupervisor, JaxPolicy) if i % 2
                        else (SyncSupervisor, BackoffPolicy))
            sups.append(cls(nd, [addrs[j] for j in range(n) if j != i],
                            policy=pol(base_s=0.005, cap_s=0.02,
                                       max_retries=1),
                            sync_timeout_s=5.0, fanout=1, interval_s=0.0,
                            sync_mode="digest", recorder=recs[i],
                            seed=3 + i))

        def converged():
            return all(np.array_equal(nd.members(), nodes[0].members())
                       and np.array_equal(nd.vv(), nodes[0].vv())
                       for nd in nodes)

        for _ in range(12):
            for s in sups:
                s.sync_round()
            if converged():
                break
        assert converged()
        expected = sorted(set(range(40)) - set(range(0, 40, 10)))
        assert nodes[0].members().tolist() == expected
        for _ in range(2):
            for s in sups:
                s.sync_round()
        chip_smoke.wait_served([nd for nd in nodes if isinstance(nd, Node)])
        lanes0 = sum(r.counter("digest.lanes_sent") for r in recs)
        for _ in range(2):
            for s in sups:
                s.sync_round()
        chip_smoke.wait_served([nd for nd in nodes if isinstance(nd, Node)])
        assert sum(r.counter("digest.lanes_sent") for r in recs) == lanes0
        assert sum(r.counter("digest.fallback_delta") for r in recs) == 0
        # the convergent projection (ops/digest.py) agrees across packages
        for name in ("present", "deleted", "del_dot_actor",
                     "del_dot_counter", "vv"):
            rows = [np.asarray(getattr(nd.state_slice(), name))
                    if isinstance(nd, JaxNode)
                    else host(getattr(nd.state_slice(), name))
                    for nd in nodes]
            assert all(r.dtype == rows[0].dtype
                       and np.array_equal(r, rows[0]) for r in rows), name
    finally:
        for s in sups:
            s.stop(timeout=1.0)
        for nd in nodes:
            nd.close()
