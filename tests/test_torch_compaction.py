"""The port's SLO-aware background compaction (serve/compaction.py) and
the fleet-GC verbs of its frontend: the scenarios of
tests/test_compaction.py replayed on the port (nodes on the CPU,
``run_cycle`` driven by hand), and the FRONTIER / GC replies of a torch
frontend against a JAX frontend fed the same ops (the router that
aggregates them is not ported; the test plays its part)."""

import os
import time

import numpy as np
import pytest

from go_crdt_playground_tpu.serve.client import ServeClient as JaxClient
from go_crdt_playground_tpu.serve.frontend import \
    ServeFrontend as JaxFrontend
from go_crdt_playground_tpu_torch._u32 import from_numpy_u32, host
from go_crdt_playground_tpu_torch.net import framing as fr
from go_crdt_playground_tpu_torch.net.peer import Node
from go_crdt_playground_tpu_torch.obs import Recorder
from go_crdt_playground_tpu_torch.obs.metrics import percentile_of_counts
from go_crdt_playground_tpu_torch.ops import delta as delta_ops
from go_crdt_playground_tpu_torch.serve import protocol
from go_crdt_playground_tpu_torch.serve.client import ServeClient
from go_crdt_playground_tpu_torch.serve.compaction import CompactionScheduler
from go_crdt_playground_tpu_torch.serve.frontend import ServeFrontend
from tests.test_torch_net import prompt_jax_close  # noqa: F401 (autouse)

E, A = 48, 3


def _node(rec, **kw):
    return Node(0, E, A, recorder=rec, device="cpu", **kw)


def test_percentile_of_counts_windows():
    rec = Recorder()
    for v in (0.001,) * 90 + (2.0,) * 10:
        rec.observe("lat", v)
    h1 = rec.histogram("lat")
    assert percentile_of_counts(h1, 0.50) == pytest.approx(0.001, rel=0.5)
    assert percentile_of_counts(h1, 0.99) >= 1.0
    assert percentile_of_counts([0] * len(h1), 0.99) is None  # empty window
    for v in (0.5,) * 10:
        rec.observe("lat", v)
    h2 = rec.histogram("lat")
    window = [a - b for a, b in zip(h2, h1)]
    assert percentile_of_counts(window, 0.5) == pytest.approx(0.5, rel=0.5)


def test_no_headroom_backs_off_exponentially():
    rec = Recorder()
    sched = CompactionScheduler(_node(rec), rec, interval_s=0.5,
                                queue_depth_max=4, max_backoff_s=3.0)
    rec.set_gauge("serve.queue.depth", 50)  # saturated
    waits = []
    for _ in range(4):
        out = sched.run_cycle()
        assert out["ran"] is False
        waits.append(out["backoff_s"])
    assert waits == [1.0, 2.0, 3.0, 3.0]  # doubles, then caps
    snap = rec.snapshot()
    assert snap["counters"]["compact.backoffs"] == 4
    assert snap["gauges"]["compact.headroom"] == 0.0
    rec.set_gauge("serve.queue.depth", 0)
    assert sched.run_cycle()["ran"] is True
    assert sched._wait_s == 0.5


def test_recent_latency_spike_blocks_compaction():
    rec = Recorder()
    sched = CompactionScheduler(_node(rec), rec, interval_s=0.5,
                                p99_budget_s=0.05)
    rec.set_gauge("serve.queue.depth", 0)
    for _ in range(50):
        rec.observe("serve.ingest_latency_s", 0.001)
    assert sched.run_cycle()["ran"] is True  # first window: calm
    for _ in range(20):
        rec.observe("serve.ingest_latency_s", 0.5)  # spike now
    assert sched.run_cycle()["ran"] is False
    assert sched.run_cycle()["ran"] is True  # spike aged out of window


def test_gc_drops_stable_deletions_and_reports_occupancy():
    rec = Recorder()
    node = _node(rec)
    node.add(*range(10))
    node.delete(1, 2, 3)
    undeclared = CompactionScheduler(node, rec, interval_s=0.5)
    rec.set_gauge("serve.queue.depth", 0)
    out = undeclared.run_cycle()
    assert out["ran"] is True and out["gc"] is None
    sched = CompactionScheduler(node, rec, interval_s=0.5,
                                gc_participants=())
    out = sched.run_cycle()
    assert out["gc"] == {"dropped": 3, "remaining": 0}
    snap = rec.snapshot()
    assert snap["counters"]["compact.gc_runs"] == 1
    assert snap["counters"]["compact.gc_dropped_lanes"] == 3
    assert snap["gauges"]["compact.deleted_lanes"] == 0
    assert sorted(int(e) for e in node.members()) == [0] + list(range(4, 10))


def _peer_body(peer, processed):
    """A DELTA body from ``peer`` advertising ``processed``."""
    prow = peer.state_slice()
    payload = delta_ops.delta_extract(prow, from_numpy_u32(
        np.zeros(A, np.uint32), "cpu"))
    return fr.encode_payload_msg(fr.MODE_DELTA, 1, processed, payload)


def test_gc_frontier_waits_for_peer_acknowledgement():
    rec = Recorder()
    node = _node(rec)
    node.add(1, 2)
    node.delete(1)
    peer = Node(1, E, A, device="cpu")
    node.apply_payload_body(_peer_body(peer, peer.state_slice().processed))
    assert node.gc_deletions(participants=[1])["dropped"] == 0
    node.apply_payload_body(_peer_body(
        peer, from_numpy_u32(np.asarray([10, 10, 10], np.uint32), "cpu")))
    assert node.gc_deletions()["dropped"] == 0
    assert np.all(node.deletion_frontier() == 0)
    assert node.gc_deletions(participants=[1, 2])["dropped"] == 0
    assert node.gc_deletions(participants=[1])["dropped"] == 1


def test_gc_skipped_mid_heal_and_on_reference_semantics():
    rec = Recorder()
    node = _node(rec)
    node.add(1)
    node.delete(1)
    with node._lock:
        node.full_resync_pending = True
    sched = CompactionScheduler(node, rec, interval_s=0.5,
                                gc_participants=())
    rec.set_gauge("serve.queue.depth", 0)
    out = sched.run_cycle()
    assert out["ran"] is True and out["gc"] is None  # healing: no GC
    with node._lock:
        node.full_resync_pending = False
    assert sched.run_cycle()["gc"] is not None  # heal done: GC resumes
    ref = Node(0, E, A, delta_semantics="reference", device="cpu")
    with pytest.raises(ValueError, match="v2"):
        ref.gc_deletions()


def test_checkpoint_rotation_waits_for_wal_growth(tmp_path):
    from go_crdt_playground_tpu_torch.utils.checkpoint import CheckpointStore
    from go_crdt_playground_tpu_torch.utils.wal import DeltaWal

    d = str(tmp_path / "durable")
    rec = Recorder()
    node = _node(rec)
    node.wal = DeltaWal(os.path.join(d, "wal"), recorder=rec, fsync=False)
    store = CheckpointStore(d, recorder=rec)
    calls = []

    def ckpt():
        calls.append(node.save_durable(store))

    sched = CompactionScheduler(node, rec, checkpoint=ckpt, interval_s=0.5,
                                checkpoint_wal_bytes=200)
    sched._ckpt_base_bytes = rec.counter("wal.appended_bytes")
    rec.set_gauge("serve.queue.depth", 0)
    node.add(1)
    assert sched.run_cycle()["checkpointed"] is False  # not enough WAL
    for i in range(2, 30):
        node.add(i)
    out = sched.run_cycle()
    assert out["checkpointed"] is True
    assert calls == [1]
    assert rec.snapshot()["counters"]["compact.checkpoints"] == 1
    assert node.wal.record_count() == 0  # rotation retired the segments
    assert sched.run_cycle()["checkpointed"] is False
    with node._lock:
        node.wal.close()


def test_fleet_gc_protocol_roundtrip():
    fr_ = np.asarray([5, 0, 9], np.uint32)
    proc = np.asarray([7, 1, 9], np.uint32)
    body = protocol.encode_frontier_reply(3, fr_, proc, True)
    rid, f2, p2, iso = protocol.decode_frontier_reply(body)
    assert (rid, iso) == (3, True)
    assert np.array_equal(f2, fr_) and np.array_equal(p2, proc)
    body = protocol.encode_frontier_reply(4, fr_, proc, False)
    assert protocol.decode_frontier_reply(body)[3] is False
    rid, f3 = protocol.decode_gc(protocol.encode_gc(9, fr_))
    assert rid == 9 and np.array_equal(f3, fr_)
    assert protocol.decode_gc_reply(
        protocol.encode_gc_reply(1, 2, 3)) == (1, 2, 3)
    with pytest.raises(Exception):
        protocol.decode_gc(protocol.encode_gc(9, fr_) + b"x")


def test_fleet_gc_verbs_match_the_jax_frontend(tmp_path):
    """FRONTIER and GC, read and pushed by hand as the router does, on a
    torch frontend and a JAX frontend fed the same ops (isolated GC
    declaration): the same evidence, the same records dropped, a
    frontier beyond a shard's own evidence clamped to it, the same
    members after."""
    out = {}
    for name, make, client in (
            ("jax", JaxFrontend, JaxClient),
            ("torch", lambda *a, **k: ServeFrontend(*a, device="cpu", **k),
             ServeClient)):
        fe = make(E, A, durable_dir=str(tmp_path / name), max_batch=8,
                  flush_ms=1.0, gc_participants=())
        fe.serve()
        try:
            with client(fe.addr) as c:
                c.add(1, 2, 3, 4)
                c.delete(2, 3)
                ev = c.frontier()
                none = c.gc(np.zeros(A, np.uint32))
                wide = c.gc(np.full(A, 1 << 20, np.uint32))
                c.add(2)
                members, vv = c.members()
            out[name] = (ev, none, wide, members, vv)
        finally:
            fe.close()
    (jev, jnone, jwide, jm, jvv), (tev, tnone, twide, tm, tvv) = \
        out["jax"], out["torch"]
    assert all(np.array_equal(x, y) for x, y in zip(jev, tev))
    assert jnone == tnone and jwide == twide
    assert twide[0] == 2 and twide[1] == 0  # both records dropped
    assert tm == jm == [1, 2, 4] and np.array_equal(jvv, tvv)


def test_frontend_integration_compacts_under_idle(tmp_path):
    fe = ServeFrontend(E, A, durable_dir=str(tmp_path / "n0"), max_batch=8,
                       flush_ms=1.0, compact_interval_s=0.05, device="cpu")
    fe.serve()
    try:
        with ServeClient(fe.addr) as c:
            c.add(1, 2, 3)
            c.delete(2)
            deadline = time.monotonic() + 30.0
            dropped = 0
            while time.monotonic() < deadline:
                dropped = c.stats()["counters"].get(
                    "compact.gc_dropped_lanes", 0)
                if dropped:
                    break
                time.sleep(0.05)
            assert dropped == 1, "idle frontend never GC'd the deletion"
            assert c.members()[0] == [1, 3]
            c.add(10)  # still serving after maintenance
            assert c.members()[0] == [1, 3, 10]
        with fe.node._lock:
            assert int(host(fe.node._state.deleted[0]).sum()) == 0
    finally:
        fe.close()


def test_payload_metrics_match_the_reference():
    """obs.payload_metrics on the port's payloads (torch tensors) equals
    the JAX package's on the same δ: lane counts, dense bytes, wire
    bytes."""
    import jax

    from go_crdt_playground_tpu.net.peer import Node as JaxNode
    from go_crdt_playground_tpu.obs import payload_metrics as jax_metrics
    from go_crdt_playground_tpu.ops import delta as jax_delta
    from go_crdt_playground_tpu_torch.obs import payload_metrics

    jnode, tnode = JaxNode(0, E, A), Node(0, E, A, device="cpu")
    for n in (jnode, tnode):
        n.add(*range(0, E, 3))
        n.delete(3, 9, 30)
    zero = np.zeros(A, np.uint32)
    want = jax_metrics(jax_delta.delta_extract(
        jax.tree.map(lambda x: x[0], jnode._state), zero))
    got = payload_metrics(delta_ops.delta_extract(
        tnode.state_slice(), from_numpy_u32(zero, "cpu")))
    assert got == want and got["changed_lanes"] > 0
