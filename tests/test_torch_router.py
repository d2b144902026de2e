"""The port's router tier (shard/router.py): tests/test_shard_router.py's
scenarios on torch frontends behind a torch router, and the same
scenarios in mixed stacks.

Every fleet scenario runs in four stacks: ``torch`` (a torch router
over torch shards), ``jax-router`` (the JAX package's router over torch
shards), ``jax-shards`` (a torch router over JAX shards) and ``mixed``
(a torch router over a JAX, a torch and a JAX shard).  The client is
the port's; its typed rejects are the port's classes.  Torch frontends
run on the CPU (``device="cpu"``).  The union served through every
stack is compared with the ops' set algebra and each shard's replica
with a node of its package fed the sub-stream the ring assigns it; one
frame stream through a JAX and a torch router over equivalent fleets
gets equal reply bytes.
"""

import json
import os
import socket
import sys
import threading
import time

import numpy as np
import pytest

from go_crdt_playground_tpu.net.peer import Node as JaxNode
from go_crdt_playground_tpu.serve.frontend import \
    ServeFrontend as JaxFrontend
from go_crdt_playground_tpu.shard import router as jax_router_mod
from go_crdt_playground_tpu_torch._host import host
from go_crdt_playground_tpu_torch.net import framing
from go_crdt_playground_tpu_torch.net.peer import Node
from go_crdt_playground_tpu_torch.serve import protocol
from go_crdt_playground_tpu_torch.serve.client import ServeClient
from go_crdt_playground_tpu_torch.serve.frontend import ServeFrontend
from go_crdt_playground_tpu_torch.shard import router as router_mod
from go_crdt_playground_tpu_torch.shard.handoff import RING_FILE
from go_crdt_playground_tpu_torch.shard.ring import HashRing, remap_fraction
from go_crdt_playground_tpu_torch.utils import wire
from tests.test_torch_net import prompt_jax_close  # noqa: F401 (autouse)

E, A = 64, 4
N_SHARDS = 3
FE_KW = dict(max_batch=8, flush_ms=1.0, queue_depth=32)


def torch_frontend(actor, d, **kw):
    return ServeFrontend(E, A, actor=actor, durable_dir=d, device="cpu",
                         **{**FE_KW, **kw})


def jax_frontend(actor, d, **kw):
    return JaxFrontend(E, A, actor=actor, durable_dir=d,
                       **{**FE_KW, **kw})


class Stack:
    def __init__(self, name, router_mod_, kinds):
        self.name, self.router_mod, self.kinds = name, router_mod_, kinds

    def frontend(self, i, d, **kw):
        kind = self.kinds[i % len(self.kinds)]
        return (torch_frontend if kind == "torch" else jax_frontend)(
            i, d, **kw)

    def __repr__(self):
        return self.name


STACKS = [Stack("torch", router_mod, ("torch",)),
          Stack("jax-router", jax_router_mod, ("torch",)),
          Stack("jax-shards", router_mod, ("jax",)),
          Stack("mixed", router_mod, ("jax", "torch", "jax"))]
stacks = pytest.mark.parametrize("stack", STACKS, ids=repr)


class _Fleet:
    """N in-process frontends + a router, torn down in order."""

    def __init__(self, tmp_path, stack, n_shards=N_SHARDS, **router_kw):
        self.stack = stack
        self.frontends = []
        try:
            for i in range(n_shards):
                self.frontends.append(
                    stack.frontend(i, str(tmp_path / f"s{i}")))
            self.addrs = {f"s{i}": fe.serve()
                          for i, fe in enumerate(self.frontends)}
            self.router = stack.router_mod.ShardRouter(
                self.addrs, E, seed=5, **router_kw)
            self.addr = self.router.serve()
        except BaseException:
            for fe in self.frontends:
                fe.close()
            raise

    def owned_by(self, sid):
        return [e for e in range(E)
                if self.router.ring.shards[self.router._owner[e]] == sid]

    def close(self):
        self.router.close()
        for fe in self.frontends:
            fe.close()


@pytest.fixture(params=STACKS, ids=repr)
def fleet(request, tmp_path):
    f = _Fleet(tmp_path, request.param)
    yield f
    f.close()


def _rows(state):
    """A node's state slice as numpy (uint32 / bool), either package."""
    return {name: host(v) for name, v in zip(state._fields, state)}


def test_routed_ingest_end_to_end(fleet):
    with ServeClient(fleet.addr) as c:
        c.add(1, 2, 3)
        c.add(40)
        c.delete(2)
        members, vv = c.members()
    assert members == [1, 3, 40]
    assert int(np.asarray(vv).sum()) == 5
    snap = fleet.router.recorder.snapshot()
    assert snap["counters"]["router.ops.forwarded"] == 3
    assert snap["counters"]["router.acks.relayed"] == 3


STREAM = [(protocol.OP_ADD, [3, 9, 11]), (protocol.OP_DEL, [9]),
          (protocol.OP_ADD, [9, 20]), (protocol.OP_DEL, [3, 20]),
          (protocol.OP_ADD, [40, 41, 42, 43]), (protocol.OP_DEL, [41]),
          (protocol.OP_ADD, [0, 63])]


def _fed(node, stream, keep=None):
    for kind, elems in stream:
        mine = [e for e in elems if keep is None or e in keep]
        if mine:
            (node.add if kind == protocol.OP_ADD else node.delete)(*mine)
    return node


@stacks
def test_routed_matches_single_node_bitwise(tmp_path, stack):
    """The same op stream through router + fleet: the union equals one
    node fed the whole stream, and each shard's replica equals, bitwise,
    a torch node AND a JAX node (same actor lane) fed the sub-stream the
    ring assigns it."""
    fleet = _Fleet(tmp_path, stack)
    try:
        with ServeClient(fleet.addr) as c:
            for kind, elems in STREAM:
                c.submit_async(kind, elems).wait(30.0)
            members, vv = c.members()
        single = _fed(Node(0, E, A, device="cpu"), STREAM)
        np.testing.assert_array_equal(np.asarray(members),
                                      single.members())
        vv_sum = np.zeros(A, np.uint32)
        for i, fe in enumerate(fleet.frontends):
            owned = set(fleet.owned_by(f"s{i}"))
            got = _rows(fe.node.state_slice())
            for ref in (Node(i, E, A, device="cpu"), JaxNode(i, E, A)):
                want = _rows(_fed(ref, STREAM, owned).state_slice())
                assert got.keys() == want.keys()
                for name in want:
                    np.testing.assert_array_equal(
                        got[name], want[name],
                        err_msg=f"{stack} shard s{i} field {name}")
            vv_sum = np.maximum(vv_sum, got["vv"])
        # the routed vv is the lane-wise join of the shards' clocks
        np.testing.assert_array_equal(np.asarray(vv, np.uint32), vv_sum)
    finally:
        fleet.close()


def test_spanning_op_acks_once(fleet):
    all_elems = list(range(12))
    with ServeClient(fleet.addr) as c:
        c.add(*all_elems)
        members, _ = c.members()
    assert members == all_elems
    snap = fleet.router.recorder.snapshot()
    assert snap["counters"]["router.ops.split"] >= 1
    assert snap["counters"]["router.acks.relayed"] == 1


def test_router_rejects_invalid_and_duplicate(fleet):
    with ServeClient(fleet.addr) as c:
        with pytest.raises(protocol.InvalidOp):
            c.add(E + 3)
        c.add(1)
    body = bytearray()
    wire._put_varint(body, 5)
    body.append(protocol.OP_ADD)
    for v in (0, 2, 7, 7):
        wire._put_varint(body, v)
    raw = socket.create_connection(fleet.addr, timeout=10.0)
    try:
        framing.send_frame(raw, protocol.MSG_OP, bytes(body))
        msg_type, reply = framing.recv_frame(raw, timeout=10.0)
        assert msg_type == protocol.MSG_REJECT
        req_id, code, _ = protocol.decode_reject(reply)
        assert (req_id, code) == (5, protocol.REJECT_INVALID)
    finally:
        raw.close()


def test_dead_shard_degrades_typed_and_survivors_serve(fleet):
    dead_keys = fleet.owned_by("s1")
    live_keys = [e for e in range(E) if e not in set(dead_keys)]
    with ServeClient(fleet.addr) as c:
        c.add(live_keys[0])
        c.add(dead_keys[0])
        fleet.frontends[1].close()
        t0 = time.monotonic()
        with pytest.raises(protocol.ShardUnavailable):
            c.add(dead_keys[1])
        assert time.monotonic() - t0 < 5.0, "reject stalled"
        with pytest.raises(protocol.ShardUnavailable):
            c.add(dead_keys[2])
        c.add(live_keys[1])
        members, _ = c.members()
    assert live_keys[0] in members and live_keys[1] in members
    assert dead_keys[0] not in members
    snap = fleet.router.recorder.snapshot()
    assert snap["counters"]["router.shed.unavailable"] >= 1
    assert snap["counters"]["router.queries.partial"] >= 1


def test_spanning_op_with_dead_shard_rejects_whole_op(fleet):
    dead_keys = fleet.owned_by("s2")
    live_keys = fleet.owned_by("s0")
    fleet.frontends[2].close()
    with ServeClient(fleet.addr) as c:
        with pytest.raises(protocol.ShardUnavailable):
            c.add(live_keys[0], dead_keys[0])
        members, _ = c.members()
    assert live_keys[0] in members


def test_router_stats_fan_out_shapes(fleet):
    with ServeClient(fleet.addr) as c:
        c.add(1, 2, 3)
        snap = c.stats()
    assert snap["counters"]["serve.ops.acked"] >= 1
    assert "observations" in snap
    assert set(snap["shards"]) == {"s0", "s1", "s2"}
    assert all(s is not None for s in snap["shards"].values())
    agg = snap["aggregate"]["counters"]
    assert agg["serve.ops.acked"] == sum(
        s["counters"].get("serve.ops.acked", 0)
        for s in snap["shards"].values())
    assert snap["router"]["counters"]["router.stats"] == 1
    assert list(snap) == ["counters", "observations", "gauges", "router",
                          "shards", "aggregate", "ring", "autopilot"]


def test_router_draining_rejects_typed(fleet):
    with ServeClient(fleet.addr) as c:
        c.add(1)
        fleet.router.host._draining.set()
        with pytest.raises(protocol.Draining):
            c.add(2)


def test_router_concurrent_clients_converge(fleet):
    """Pipelined concurrent clients: every op resolves, the union is
    the submitted set (a typed Overloaded shed resolves by resubmit)."""
    n_clients, per_client = 4, 24
    errors = []

    def run(base):
        try:
            with ServeClient(fleet.addr) as c:
                todo = [(base + i) % E for i in range(per_client)]
                for _ in range(50):
                    ops = [(e, c.submit_async(protocol.OP_ADD, [e]))
                           for e in todo]
                    shed = []
                    for e, op in ops:
                        try:
                            op.wait(30.0)
                        except protocol.Overloaded:
                            shed.append(e)
                    if not shed:
                        return
                    todo = shed
                    time.sleep(0.01)
                errors.append(AssertionError(f"ops never landed: {todo}"))
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(w * per_client,))
               for w in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert not errors, errors
    with ServeClient(fleet.addr) as c:
        members, _ = c.members()
    assert members == sorted({(w * per_client + i) % E
                              for w in range(n_clients)
                              for i in range(per_client)})


def test_fence_rejects_typed_moving(fleet):
    fenced_e, free_e = 7, 8
    fence = np.zeros(E, bool)
    fence[fenced_e] = True
    with ServeClient(fleet.addr, timeout=10.0) as c:
        c.add(free_e)
        fleet.router.set_fence(fence)
        with pytest.raises(protocol.KeyspaceMoving):
            c.add(fenced_e)
        c.add(free_e)
        with pytest.raises(protocol.KeyspaceMoving):
            c.add(fenced_e, free_e)
        fleet.router.clear_fence()
        c.add(fenced_e)
        m, _ = c.members()
    assert fenced_e in m
    snap = fleet.router.recorder.snapshot()
    assert snap["counters"]["router.shed.moving"] == 2
    assert fleet.router.route().fence is None


def test_reshard_staging_failures_are_typed(fleet):
    with ServeClient(fleet.addr, timeout=10.0) as c:
        ring0 = c.stats()["ring"]
        ok, d = c.reshard(protocol.RESHARD_JOIN, "s0",
                          ("127.0.0.1", 9), timeout=10.0)
        assert not ok and "already in the ring" in d["reason"]
        ok, d = c.reshard(protocol.RESHARD_LEAVE, "nope", timeout=10.0)
        assert not ok and "not in ring" in d["reason"]
        with pytest.raises(ValueError):
            c.reshard(protocol.RESHARD_LEAVE, "s1", timeout=999.0)
        assert c.stats()["ring"] == ring0


def _cache_counters(router):
    snap = router.recorder.snapshot()["counters"]
    return (snap.get("router.member_cache.hits", 0),
            snap.get("router.member_cache.refreshes", 0))


def test_member_cache_hits_quiescent_refreshes_on_change(fleet):
    with ServeClient(fleet.addr) as c:
        c.add(1, 2, 3)
        m1, vv1 = c.members()
        assert _cache_counters(fleet.router) == (0, N_SHARDS)
        m2, vv2 = c.members()
        assert m2 == m1
        np.testing.assert_array_equal(np.asarray(vv2), np.asarray(vv1))
        assert _cache_counters(fleet.router) == (N_SHARDS, N_SHARDS)
        lone = fleet.owned_by("s0")[0]
        c.add(lone)
        m3, _ = c.members()
        assert lone in m3
        assert _cache_counters(fleet.router) == (
            2 * N_SHARDS - 1, N_SHARDS + 1)


def test_member_cache_legacy_shard_pinned_uncached(fleet):
    mod = fleet.stack.router_mod
    link = fleet.router.links_snapshot()["s0"]
    calls = {"n": 0}

    def legacy_dsum():
        calls["n"] += 1
        raise mod._DsumUnsupported("shard s0 is pre-digest: unexpected "
                                   "frame type 32")

    link.digest_summary_probe = legacy_dsum
    with ServeClient(fleet.addr) as c:
        c.add(1, 2, 3)
        m1, _ = c.members()
        assert calls["n"] == 1
        assert "s0" in fleet.router._dsum_unsupported
        m2, _ = c.members()
        assert m2 == m1
        assert calls["n"] == 1
    with fleet.router._member_cache_lock:
        assert set(fleet.router._member_cache) == {"s1", "s2"}
    assert _cache_counters(fleet.router) == (N_SHARDS - 1, N_SHARDS - 1)


def test_member_cache_transient_dsum_failure_stays_cacheable(fleet):
    mod = fleet.stack.router_mod
    link = fleet.router.links_snapshot()["s0"]
    real_probe = link.digest_summary_probe
    calls = {"n": 0}

    def flaky_probe():
        calls["n"] += 1
        if calls["n"] == 1:
            raise mod._Unreachable("shard s0 dsum probe: server went "
                                   "away: unexpected frame type 9")
        return real_probe()

    link.digest_summary_probe = flaky_probe
    with ServeClient(fleet.addr) as c:
        c.add(1, 2, 3)
        m1, _ = c.members()
        assert "s0" not in fleet.router._dsum_unsupported
        m2, _ = c.members()
        assert m2 == m1
    assert calls["n"] == 2
    with fleet.router._member_cache_lock:
        assert "s0" in fleet.router._member_cache


# -- live resharding through the router ---------------------------------------


@stacks
def test_live_join_and_leave_zero_loss(tmp_path, capsys, stack):
    """Populate, JOIN a third shard live, then LEAVE it through the
    port's CLI verb: members byte-identical at every step, the moved
    count equals ``remap_fraction``'s, the joiner holds its slice, a
    delete at the new owner sticks and the leave restores the digest."""
    from go_crdt_playground_tpu_torch.__main__ import main as cli_main

    fleet = _Fleet(tmp_path, stack, n_shards=2)
    joiner = stack.frontend(2, str(tmp_path / "joiner"))
    joiner_addr = joiner.serve()
    try:
        with ServeClient(fleet.addr, timeout=60.0) as c:
            c.add(*range(0, E, 2))
            c.add(*range(1, E, 2))
            c.delete(3)
            before, _ = c.members()
            ring0 = c.stats()["ring"]
            ok, detail = c.reshard(protocol.RESHARD_JOIN, "s2",
                                   joiner_addr, timeout=60.0)
            assert ok, detail
            after_join, _ = c.members()
            assert after_join == before
            r0 = fleet.router.route().ring.without_shard("s2")
            r1 = fleet.router.route().ring
            rm = remap_fraction(r0.owner_map(E), r1.owner_map(E),
                                r0.shards, r1.shards)
            assert detail["moved"] == rm["moved"] > 0
            assert detail["moved_transferred"] == rm["moved"]
            assert detail["fraction"] == pytest.approx(rm["fraction"])
            assert detail["gratuitous"] == 0
            assert detail["generation"] == 1
            ring1 = c.stats()["ring"]
            assert ring1["generation"] == 1
            assert ring1["digest"] != ring0["digest"]
            rt = fleet.router.route()
            owned = [e for e in range(E) if rt.owner_sid(e) == "s2"]
            assert len(owned) == detail["moved"]
            assert set(owned) - {3} <= {
                int(x) for x in host(joiner.node.members())}
            victim = next(e for e in owned if e != 3)
            c.delete(victim)
            m, _ = c.members()
            assert victim not in m
            host_, port_ = fleet.addr
            assert cli_main(["reshard", "--router", f"{host_}:{port_}",
                             "--leave", "s2"]) == 0
            verdict = json.loads(capsys.readouterr().out)
            assert verdict["ok"] and verdict["mode"] == "leave"
            m2, _ = c.members()
            assert m2 == m and victim not in m2
            ring2 = c.stats()["ring"]
            assert ring2["generation"] == 2
            assert ring2["digest"] == ring0["digest"]
            c.add(victim)
            assert victim in c.members()[0]
    finally:
        joiner.close()
        fleet.close()


@stacks
def test_failed_join_leaves_old_ring_serving(tmp_path, stack):
    fleet = _Fleet(tmp_path, stack, n_shards=2, transfer_timeout_s=1.5)
    try:
        with ServeClient(fleet.addr, timeout=30.0) as c:
            c.add(1, 2, 3)
            ring0 = c.stats()["ring"]
            t0 = time.monotonic()
            ok, detail = c.reshard(protocol.RESHARD_JOIN, "sX",
                                   ("127.0.0.1", 1), timeout=30.0)
            assert not ok and "reason" in detail
            assert time.monotonic() - t0 < 15.0, "abort was unbounded"
            ring1 = c.stats()["ring"]
            assert (ring1["generation"], ring1["digest"]) == (
                ring0["generation"], ring0["digest"])
            c.add(4)
            assert c.members()[0] == [1, 2, 3, 4]
        snap = fleet.router.recorder.snapshot()
        assert snap["counters"]["router.reshard.aborts"] == 1
        assert snap["counters"].get("router.reshard.commits", 0) == 0
    finally:
        fleet.close()


def test_router_restart_adopts_committed_ring(tmp_path):
    state_dir = str(tmp_path / "router-state")
    os.makedirs(state_dir)
    ring = HashRing(["a", "b", "c"], seed=5)
    rec = {"epoch": 4, "phase": "committed", "generation": 3,
           "seed": 5, "elements": E,
           "shards": {"a": ["127.0.0.1", 1111], "b": ["127.0.0.1", 2222],
                      "c": ["127.0.0.1", 3333]},
           "digest": ring.digest(E, ring.owner_map(E))}
    with open(os.path.join(state_dir, RING_FILE), "w") as f:
        json.dump(rec, f)
    router = router_mod.ShardRouter({"zz": ("127.0.0.1", 9)}, E, seed=5,
                                    state_dir=state_dir)
    try:
        info = router.route().info()
        assert info["generation"] == 3
        assert sorted(info["shards"]) == ["a", "b", "c"]
        assert info["digest"] == rec["digest"]
        assert router.shard_addr("b") == ("127.0.0.1", 2222)
        assert router.handoff._epoch == 4
    finally:
        router.close()
    with pytest.raises(ValueError):
        router_mod.ShardRouter({"zz": ("127.0.0.1", 9)}, E, seed=6,
                               state_dir=state_dir)
    rec["phase"] = "aborted"
    with open(os.path.join(state_dir, RING_FILE), "w") as f:
        json.dump(rec, f)
    router = router_mod.ShardRouter({"zz": ("127.0.0.1", 9)}, E, seed=5,
                                    state_dir=state_dir)
    try:
        assert list(router.route().ring.shards) == ["zz"]
        assert router.route().generation == 0
    finally:
        router.close()


# -- one frame stream through a JAX router and a torch router ----------------


def router_frames(seed):
    rng = np.random.default_rng(seed)
    frames, req = [], 0
    for i in range(40):
        req += 1
        keys = sorted(rng.choice(E, size=int(rng.integers(1, 6)),
                                 replace=False).tolist())
        kind = protocol.OP_DEL if rng.random() < 0.3 else protocol.OP_ADD
        frames.append((protocol.MSG_OP, protocol.encode_op(req, kind, keys)))
        if i % 10 == 4:
            req += 1
            frames.append((protocol.MSG_QUERY, protocol.encode_query(req)))
    dup = bytearray()
    wire._put_varint(dup, req + 1)
    dup.append(protocol.OP_ADD)
    for v in (0, 2, 7, 7):
        wire._put_varint(dup, v)
    frames += [
        (protocol.MSG_OP, protocol.encode_op(req + 2, protocol.OP_ADD,
                                             [E + 3])),
        (protocol.MSG_OP, bytes(dup)),
        (protocol.MSG_RESHARD, protocol.encode_reshard(
            req + 4, protocol.RESHARD_LEAVE, "nope")),
        (protocol.MSG_QUERY, protocol.encode_query(req + 5)),
        (protocol.MSG_STATS, protocol.encode_stats(req + 6)),
    ]
    return frames


@pytest.mark.parametrize("seed", [3, 11])
def test_routers_reply_the_same_bytes(tmp_path, seed):
    """A JAX router over JAX shards and a torch router over torch shards,
    one frame stream each, one frame in flight: every reply frame equal
    byte for byte (STATS by its counters and shape)."""
    frames = router_frames(seed)
    replies = {}
    for stack in (Stack("jax", jax_router_mod, ("jax",)), STACKS[0]):
        fleet = _Fleet(tmp_path / stack.name, stack)
        try:
            conn = socket.create_connection(fleet.addr, timeout=30.0)
            try:
                out = []
                for msg_type, body in frames:
                    framing.send_frame(conn, msg_type, body)
                    out.append(framing.recv_frame(conn, timeout=30.0))
            finally:
                conn.close()
            replies[stack.name] = out
        finally:
            fleet.close()
    kinds = set()
    for i, ((jt, jb), (tt, tb)) in enumerate(zip(replies["jax"],
                                                 replies["torch"])):
        kinds.add(tt)
        if tt == protocol.MSG_STATS_REPLY:
            jsnap = protocol.decode_stats_reply(jb)[1]
            tsnap = protocol.decode_stats_reply(tb)[1]
            assert list(jsnap) == list(tsnap)
            assert jsnap["router"]["counters"] == tsnap["router"]["counters"]
            assert jsnap["aggregate"]["counters"] == \
                tsnap["aggregate"]["counters"]
            # the rings alike but for the shards' ports
            jring, tring = dict(jsnap["ring"]), dict(tsnap["ring"])
            assert set(jring.pop("shard_addrs")) == \
                set(tring.pop("shard_addrs"))
            assert jring == tring
            continue
        assert (jt, jb) == (tt, tb), f"reply {i} to frame type " \
                                     f"{frames[i][0]}"
    assert {protocol.MSG_ACK, protocol.MSG_REJECT, protocol.MSG_MEMBERS,
            protocol.MSG_STATS_REPLY} <= kinds


def test_router_module_loads_no_torch():
    """The router tier is host-only: importing it loads no torch."""
    import subprocess

    code = ("import sys\n"
            "import go_crdt_playground_tpu_torch.shard.router\n"
            "assert 'torch' not in sys.modules\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=repo, check=True,
                   timeout=120)
