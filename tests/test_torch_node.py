"""The port's Node (net/peer.py): the serving write path and durable
recovery, side by side with the JAX package's Node.

Both nodes get the same op log from a numpy seed; WAL records are
compared byte for byte and states field by field (``np.array_equal``,
dtype included), so the tolerance is exact.  The port runs on the CPU
in the plain regime, and in the CUDA regime's arithmetic (K10's plain
version with K = min(128, E)) against the JAX node on the Pallas kernel
in interpret mode.  The last part replays the JAX package's durability
scenarios (tests/test_durability.py) on the port.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from go_crdt_playground_tpu.net import Node as JaxNode
from go_crdt_playground_tpu.net import StorageFaults
from go_crdt_playground_tpu.obs import Recorder
from go_crdt_playground_tpu.ops.pallas_ingest import pallas_ingest_rows_delta
from go_crdt_playground_tpu.utils.checkpoint import \
    CheckpointStore as JaxStore
from go_crdt_playground_tpu.utils.wal import DeltaWal as JaxWal
from go_crdt_playground_tpu_torch._u32 import from_numpy_u32
from go_crdt_playground_tpu_torch.net import framing
from go_crdt_playground_tpu_torch.net.peer import Node
from go_crdt_playground_tpu_torch.ops import cuda_ingest, ingest
from go_crdt_playground_tpu_torch.ops.delta import DeltaPayload, delta_extract
from go_crdt_playground_tpu_torch.utils import wire
from go_crdt_playground_tpu_torch.utils.checkpoint import (CheckpointCorrupt,
                                                            CheckpointStore)
from go_crdt_playground_tpu_torch.utils.wal import DeltaWal
from tests.test_torch_ingest import assert_same


def _node(actor, e, a, d=None, rec=None, **kw):
    wal = DeltaWal(os.path.join(d, "wal"), recorder=rec) if d else None
    return Node(actor, e, a, recorder=rec, wal=wal, device="cpu", **kw)


def _jax_node(actor, e, a, d=None, rec=None, **kw):
    wal = JaxWal(os.path.join(d, "wal"), recorder=rec) if d else None
    return JaxNode(actor, e, a, recorder=rec, wal=wal, **kw)


def _jax_row(node):
    return jax.tree.map(lambda x: x[0], node._state)


def assert_nodes_same(jnode, tnode, ctx=""):
    assert_same(_jax_row(jnode), tnode.state_slice(), ctx)


def assert_port_same(a, b, ctx=""):
    """Two port states field by field, dtype included."""
    for name, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{ctx}:{name}"


def peer_body(peer, dst_vv):
    """The PAYLOAD body ``peer`` (a port node) ships to a receiver that
    advertised ``dst_vv``: FULL on first contact, else its δ."""
    with peer._lock:
        me = peer._row()
    if int(dst_vv[peer.actor]) == 0:
        mode = framing.MODE_FULL
        p = DeltaPayload(
            src_vv=me.vv, changed=me.present, ch_da=me.dot_actor,
            ch_dc=me.dot_counter, deleted=me.deleted, del_da=me.del_dot_actor,
            del_dc=me.del_dot_counter, src_actor=me.actor,
            src_processed=me.processed)
    else:
        mode = framing.MODE_DELTA
        p = delta_extract(me, from_numpy_u32(dst_vv, "cpu"))
    return framing.encode_payload_msg(mode, peer.actor, me.processed, p)


def pull(node, peer):
    """The receiving half of one anti-entropy exchange: ``node`` applies
    what ``peer`` ships against its advertised vv."""
    node.apply_payload_body(peer_body(peer, node.vv()))


def _op_log(seed, e, steps):
    """(kind, args) ops: batches of 1 and 16 keys per op with deletes and
    padding rows, single adds and deletes."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(steps):
        b = int(rng.choice([1, 4, 8]))
        keys = 16 if i % 3 == 2 else 1
        add = np.zeros((b, e), bool)
        for r in range(b):
            add[r, rng.integers(0, e, keys)] = True
        dl = np.zeros((b, e), bool)
        dl[rng.random(b) < 0.3, rng.integers(0, e)] = True
        live = rng.random(b) < 0.8
        ops.append(("batch", (add, dl, live)))
        if i % 4 == 1:
            ops.append(("add", tuple(int(x) for x in rng.integers(0, e, 3))))
        if i % 5 == 3:
            ops.append(("delete", tuple(int(x) for x in
                                        rng.integers(0, e, 2))))
    return ops


def _run(node, ops):
    for kind, args in ops:
        if kind == "batch":
            node.ingest_batch(*args)
        elif kind == "add":
            node.add(*args)
        else:
            node.delete(*args)


# -- the same op log, side by side -------------------------------------------


@pytest.mark.parametrize("compact_records", [True, False])
def test_same_op_log_writes_identical_wal_records(tmp_path, compact_records):
    e, a = 64, 4
    jrec, trec = Recorder(), Recorder()
    jn = _jax_node(1, e, a, str(tmp_path / "j"), jrec,
                   wal_compact_records=compact_records)
    tn = _node(1, e, a, str(tmp_path / "t"), trec,
               wal_compact_records=compact_records)
    peer = _node(2, e, a)
    peer.add(3, 30, 40)
    peer.delete(30)
    ops = _op_log(5, e, 24)
    _run(jn, ops[:20])
    _run(tn, ops[:20])
    body = peer_body(peer, tn.vv())
    jn.apply_payload_body(body)
    tn.apply_payload_body(body)
    _run(jn, ops[20:])
    _run(tn, ops[20:])
    assert list(tn.wal.records()) == list(jn.wal.records())
    assert_nodes_same(jn, tn, "after the op log")
    assert trec.snapshot()["counters"] == jrec.snapshot()["counters"]
    for n in (jn, tn):
        n.wal.close()


def test_cuda_regime_node_records_match_the_pallas_regime(tmp_path):
    """The node's CUDA regime (K10, K = min(128, E), compact records from
    the fixed-K form) against the JAX node's TPU regime (the Pallas
    kernel), both through their plain arithmetic on the CPU.  E = 200 >
    K, so dense batches overflow into the fallback forms."""
    e, a = 200, 4
    k = min(ingest.WAL_COMPACT_K, e)
    jn = _jax_node(0, e, a, str(tmp_path / "j"))
    jn._fused_regime = (functools.partial(pallas_ingest_rows_delta,
                                          interpret=True), k)
    tn = _node(0, e, a, str(tmp_path / "t"))
    tn._fused_regime = (cuda_ingest.ingest_rows_delta_fused, k)
    rng = np.random.default_rng(9)
    for density in (0.01, 0.05, 0.5, 0.02, 0.0):
        add = rng.random((6, e)) < density
        dl = rng.random((6, e)) < density / 2
        live = np.arange(6) != 4
        jn.ingest_batch(add, dl, live)
        tn.ingest_batch(add, dl, live)
    tn.ingest_batch(np.zeros((0, e), bool), np.zeros((0, e), bool))
    jn.ingest_batch(np.zeros((0, e), bool), np.zeros((0, e), bool))
    bodies = list(tn.wal.records())
    assert bodies == list(jn.wal.records())
    assert len(bodies) == 6
    assert_nodes_same(jn, tn)
    for n in (jn, tn):
        n.wal.close()


def test_reads_and_slices_match(tmp_path):
    e, a = 48, 3
    jn, tn = _jax_node(0, e, a), _node(0, e, a)
    ops = _op_log(11, e, 8)
    _run(jn, ops)
    _run(tn, ops)
    assert np.array_equal(tn.members(), jn.members())
    tm, tvv = tn.members_vv()
    jm, jvv = jn.members_vv()
    assert np.array_equal(tm, jm) and np.array_equal(tvv, jvv)
    assert tvv.dtype == jvv.dtype == np.uint32
    mask = np.random.default_rng(1).random(e) < 0.5
    assert tn.extract_slice(mask) == jn.extract_slice(mask)
    with pytest.raises(ValueError, match="slice mask shape"):
        tn.extract_slice(mask[:5])
    # the slice applies by overwrite on both
    jr, tr = _jax_node(2, e, a), _node(2, e, a)
    jr.apply_payload_body(jn.extract_slice(mask))
    tr.apply_payload_body(tn.extract_slice(mask))
    assert_nodes_same(jr, tr, "slice applied")


def test_gc_and_frontier_match():
    e, a = 48, 3
    nodes = [(_jax_node(i, e, a), _node(i, e, a)) for i in range(2)]
    for jn, tn in nodes:
        for n in (jn, tn):
            n.add(*range(10 * n.actor, 10 * n.actor + 8))
            n.delete(10 * n.actor + 1, 10 * n.actor + 2)
    (j0, t0), (j1, t1) = nodes
    with j0._lock:
        _, body = j0._extract_msg(j1.vv())
    assert peer_body(t0, t1.vv()) == body
    j1.apply_payload_body(body)
    t1.apply_payload_body(body)
    for part in (None, [], [0], [0, 1]):
        assert np.array_equal(t1.deletion_frontier(part),
                              j1.deletion_frontier(part))
        assert t1.gc_deletions(participants=part) == \
            j1.gc_deletions(participants=part)
        assert_nodes_same(j1, t1, f"gc {part}")
    t1.note_peer_processed(0, np.full(a, 99, np.uint32))
    j1.note_peer_processed(0, np.full(a, 99, np.uint32))
    assert t1.gc_deletions(participants=[0]) == \
        j1.gc_deletions(participants=[0])
    assert_nodes_same(j1, t1, "gc after a noted vector")
    ref = _node(0, e, a, delta_semantics="reference")
    with pytest.raises(ValueError, match="v2"):
        ref.gc_deletions(participants=[])


def test_standby_applies_shipped_records_bitwise(tmp_path):
    e, a = 48, 3
    primary = _node(0, e, a, str(tmp_path / "p"))
    peer = _node(1, e, a)
    peer.add(40, 41)
    _run(primary, _op_log(13, e, 6))
    pull(primary, peer)
    _run(primary, _op_log(14, e, 3))
    standby = _node(0, e, a, str(tmp_path / "s"))
    bodies = list(primary.wal.records())
    assert [standby.apply_wal_record(b) for b in bodies] == \
        ["applied"] * len(bodies)
    assert_port_same(primary.state_slice(), standby.state_slice())
    assert list(standby.wal.records()) == bodies
    fresh = _node(0, e, a)
    assert fresh.apply_wal_record(bodies[-1]) == "future"
    for n in (primary, standby):
        n.wal.close()


def test_node_guards():
    with pytest.raises(ValueError, match="outside actor axis"):
        _node(3, 16, 3)
    n = _node(0, 16, 3)
    with pytest.raises(ValueError, match="outside universe"):
        n.add(16)
    with pytest.raises(ValueError, match="outside universe"):
        n.delete(-1)
    with pytest.raises(ValueError, match="does not match"):
        n.ingest_batch(np.zeros((2, 15), bool), np.zeros((2, 15), bool))
    with pytest.raises(ValueError, match="live mask"):
        n.ingest_batch(np.zeros((2, 16), bool), np.zeros((2, 16), bool),
                       np.ones(3, bool))
    with n:
        n.add()          # an empty add is a no-op
    assert int(n.vv()[0]) == 0


# -- durable directories, both directions -------------------------------------


def _durable_history(node, store, ops):
    _run(node, ops[:10])
    node.save_durable(store)
    _run(node, ops[10:])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_durable_dirs_cross_restore(tmp_path, direction):
    e, a = 64, 4
    d = str(tmp_path / "durable")
    ops = _op_log(21, e, 16)
    if direction == "jax_to_port":
        writer = _jax_node(2, e, a, d)
        _durable_history(writer, JaxStore(d), ops)
        writer.wal.close()
        back = Node.restore_durable(d, device="cpu")
        assert_same(_jax_row(writer), back.state_slice())
    else:
        writer = _node(2, e, a, d)
        _durable_history(writer, CheckpointStore(d), ops)
        writer.wal.close()
        back = JaxNode.restore_durable(d)
        assert_same(_jax_row(back), writer.state_slice())
    assert back.generation == 1 and not back.full_resync_pending
    assert back.wal.record_count() > 0
    back.wal.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_only_history_cross_restores(tmp_path, writer):
    """No checkpoint yet: the WAL alone, replayed by both packages to the
    same state.  (Replay rebuilds the writer's members and clocks; the
    deletion log of a lane deleted twice may keep an older record, in
    both packages alike.)"""
    e, a = 48, 3
    d = str(tmp_path / "durable")
    w = (_jax_node if writer == "jax" else _node)(0, e, a, d)
    _run(w, _op_log(22, e, 6))
    w.wal.close()
    back = Node.restore_durable(d, device="cpu",
                                fallback_init=lambda: _node(0, e, a))
    jback = JaxNode.restore_durable(d, fallback_init=lambda: JaxNode(0, e, a))
    assert_same(_jax_row(jback), back.state_slice())
    assert np.array_equal(back.members(), w.members())
    assert np.array_equal(back.vv(), w.vv())
    for n in (back, jback):
        n.wal.close()


def test_save_and_restore_single_checkpoint(tmp_path):
    n = _node(1, 32, 2)
    n.add(1, 2, 3)
    n.delete(2)
    p = str(tmp_path / "ck")
    n.save(p, metadata={"note": "x"})
    back = Node.restore(p, device="cpu")
    assert_same(JaxNode.restore(p)._state, back._state)
    assert back.actor == 1 and back.delta_semantics == "v2"
    from go_crdt_playground_tpu_torch.utils.checkpoint import save_checkpoint

    save_checkpoint(str(tmp_path / "bare"), n._state)
    with pytest.raises(ValueError, match="lacks node metadata"):
        Node.restore(str(tmp_path / "bare"), device="cpu")


# -- the JAX package's durability scenarios, on the port ---------------------
# (tests/test_durability.py; a peer exchange is the receiving half of
# sync_with, ``pull``, until the port has sockets)


def test_node_kill_restore_replays_wal_tail(tmp_path):
    d = str(tmp_path / "durable")
    rec = Recorder()
    node = _node(0, 32, 2, d, rec)
    store = CheckpointStore(d, recorder=rec)
    node.add(1, 2, 3)
    assert node.save_durable(store) == 1
    assert node.wal.record_count() == 0, "checkpoint truncates the WAL"
    node.add(4)
    node.delete(2)
    node.wal.close()

    rec2 = Recorder()
    back = Node.restore_durable(d, recorder=rec2, device="cpu")
    assert set(int(x) for x in back.members()) == {1, 3, 4}
    assert back.generation == 1
    assert rec2.snapshot()["counters"]["wal.records"] >= 1
    back.wal.close()


def test_partial_replay_resets_wal_so_second_kill_keeps_new_acks(tmp_path):
    d = str(tmp_path / "durable")
    peer = _node(1, 32, 2)
    peer.add(20)
    node = _node(0, 32, 2, d, Recorder())
    store = CheckpointStore(d)
    node.save_durable(store)        # gen1
    pull(node, peer)                # record A
    node.save_durable(store)        # gen2; WAL reset
    peer.add(21)
    pull(node, peer)                # record B (context: gen2)
    node.wal.close()
    StorageFaults(seed=5).bit_flip_array(store.path_for(2))

    back = Node.restore_durable(d, recorder=Recorder(), device="cpu")
    assert back.wal.record_count() == 0   # refused suffix reset
    back.add(7)
    back.wal.close()
    rec3 = Recorder()
    again = Node.restore_durable(d, recorder=rec3, device="cpu")
    assert 7 in set(int(x) for x in again.members())
    assert rec3.snapshot()["counters"]["wal.records"] >= 1
    again.wal.close()


def test_resync_pending_flag_survives_rekill(tmp_path):
    d = str(tmp_path / "durable")
    node = _node(0, 16, 2, d)
    store = CheckpointStore(d)
    node.add(1)
    node.save_durable(store)
    node.add(2)
    node.save_durable(store)
    node.wal.close()
    StorageFaults(seed=4).bit_flip_array(store.path_for(2))

    back = Node.restore_durable(d, device="cpu")
    assert back.full_resync_is_pending()
    back.wal.close()
    again = Node.restore_durable(d, device="cpu")
    assert again.full_resync_pending
    assert not again.full_resync_done_for(("127.0.0.1", 1))
    again.clear_full_resync()
    assert not os.path.exists(os.path.join(d, "resync-pending"))
    again.wal.close()
    third = Node.restore_durable(d, device="cpu")
    assert third.full_resync_pending
    third.wal.close()


def test_restore_durable_all_corrupt_uses_fallback_init(tmp_path):
    d = str(tmp_path / "durable")
    node = _node(0, 16, 2, d)
    store = CheckpointStore(d)
    node.add(1)
    node.save_durable(store)
    node.add(2)
    node.wal.close()
    with open(store.path_for(1), "r+b") as f:
        f.seek(os.path.getsize(store.path_for(1)) // 2)
        b = f.read(1)
        f.seek(os.path.getsize(store.path_for(1)) // 2)
        f.write(bytes([b[0] ^ 1]))
    with pytest.raises(CheckpointCorrupt):
        Node.restore_durable(d, device="cpu")
    rec2 = Recorder()
    back = Node.restore_durable(d, recorder=rec2, device="cpu",
                                fallback_init=lambda: _node(0, 16, 2))
    assert list(back.members()) == []
    assert rec2.snapshot()["counters"]["wal.future_records"] >= 1
    assert back.full_resync_pending
    back.wal.close()


def test_save_durable_seals_then_drops_only_covered_records(tmp_path):
    d = str(tmp_path / "durable")
    node = _node(0, 16, 2, d)
    node.add(1)

    class SlowStore(CheckpointStore):
        # a mutation racing the out-of-lock dump lands post-seal
        def save(self, state, **kw):
            node.add(2)
            return super().save(state, **kw)

    assert node.save_durable(SlowStore(d)) == 1
    assert node.wal.record_count() == 1
    node.wal.close()
    back = Node.restore_durable(d, device="cpu")
    assert set(int(x) for x in back.members()) == {1, 2}
    back.wal.close()


def test_wal_alone_recovers_pre_first_checkpoint_history(tmp_path):
    d = str(tmp_path / "durable")
    node = _node(0, 16, 2, d)
    node.add(1, 2)
    node.delete(1)
    node.add(3)
    node.wal.close()
    rec2 = Recorder()
    back = Node.restore_durable(d, recorder=rec2, device="cpu",
                                fallback_init=lambda: _node(0, 16, 2))
    assert set(int(x) for x in back.members()) == {2, 3}
    snap = rec2.snapshot()["counters"]
    assert snap["wal.records"] == 3 and "wal.future_records" not in snap
    assert not back.full_resync_pending
    back.wal.close()


def test_mixed_dense_compact_segment_replays_in_order(tmp_path):
    d = str(tmp_path / "durable")
    rec = Recorder()
    node = _node(0, 48, 3, d, rec)
    node.add(1, 2)                       # compact
    with node._lock:
        node.wal_compact_records = False
    node.add(7)                          # dense
    with node._lock:
        node.wal_compact_records = True
    node.delete(2)                       # compact
    peer = _node(1, 48, 3)
    peer.add(30, 31)
    node.apply_payload_body(peer_body(peer, np.zeros(3, np.uint32)))
    node.ingest_batch(np.eye(48, dtype=bool)[[40]], np.zeros((1, 48), bool))
    node.wal.close()
    snap = rec.snapshot()["counters"]
    assert snap["wal.compact_records"] == 3
    assert snap["wal.dense_records"] == 2

    rec2 = Recorder()
    back = Node.restore_durable(d, recorder=rec2, device="cpu",
                                fallback_init=lambda: _node(0, 48, 3))
    assert_port_same(node.state_slice(), back.state_slice())
    snap2 = rec2.snapshot()["counters"]
    assert snap2["wal.records"] == 5
    assert snap2["wal.replayed_compact"] == 3
    assert snap2["wal.replayed_dense"] == 2
    back.wal.close()


def test_compact_record_respects_causal_replay_guard(tmp_path):
    d = str(tmp_path / "durable")
    os.makedirs(d)
    w = DeltaWal(os.path.join(d, "wal"))
    w.append(wire.encode_compact_wal_body(
        np.zeros(2, np.uint32), 0, np.asarray([1, 0], np.uint32),
        np.asarray([1, 0], np.uint32), [3], [0], [1], [], [], [], 16))
    w.append(wire.encode_compact_wal_body(
        np.asarray([5, 0], np.uint32), 0, np.asarray([6, 0], np.uint32),
        np.asarray([6, 0], np.uint32), [9], [0], [6], [], [], [], 16))
    w.close()
    rec = Recorder()
    back = Node.restore_durable(d, recorder=rec, device="cpu",
                                fallback_init=lambda: _node(0, 16, 2))
    assert [int(x) for x in back.members()] == [3]
    snap = rec.snapshot()["counters"]
    assert snap["wal.records"] == 1 and snap["wal.future_records"] == 1
    assert back.full_resync_pending
    assert back.wal.record_count() == 0
    back.wal.close()


def test_compact_and_dense_records_replay_to_identical_state(tmp_path):
    states = {}
    for mode, compact in (("compact", True), ("dense", False)):
        d = str(tmp_path / mode)
        node = _node(0, 48, 3, d, wal_compact_records=compact)
        add = np.zeros((3, 48), bool)
        add[0, [1, 5]] = True
        add[1, 9] = True
        dl = np.zeros((3, 48), bool)
        dl[2, 5] = True
        node.ingest_batch(add, dl)
        node.add(20)
        node.delete(9)
        node.wal.close()
        back = Node.restore_durable(d, device="cpu",
                                    fallback_init=lambda: _node(0, 48, 3))
        states[mode] = (node.state_slice(), back.state_slice())
        back.wal.close()
    assert_port_same(states["compact"][1], states["dense"][1])
    assert_port_same(states["compact"][0], states["compact"][1])


def test_compact_record_refuses_universe_change(tmp_path):
    d = str(tmp_path / "durable")
    os.makedirs(d)
    w = DeltaWal(os.path.join(d, "wal"))
    w.append(wire.encode_compact_wal_body(
        np.zeros(2, np.uint32), 0, np.asarray([1, 0], np.uint32),
        np.asarray([1, 0], np.uint32), [3], [0], [1], [], [], [], 64))
    w.close()
    rec = Recorder()
    back = Node.restore_durable(d, recorder=rec, device="cpu",
                                fallback_init=lambda: _node(0, 16, 2))
    assert list(back.members()) == []
    assert rec.snapshot()["counters"]["wal.bad_records"] == 1
    back.wal.close()


def _record_payload(body, e, a):
    if body[:1] == bytes((wire.WAL_COMPACT_TAG,)):
        return wire.decode_compact_wal_body(body, e, a)[1]
    _, pos = wire._decode_vv_py(body, 0, a)
    return framing.decode_payload_msg(body[pos:], e, a)[1]


def test_wal_records_filter_guard_covered_deletions(tmp_path):
    d = str(tmp_path / "durable")
    node = _node(0, 48, 3, d)
    node.add(*range(20))
    node.delete(*range(10))
    node.ingest_batch(np.eye(48, dtype=bool)[[30, 31]],
                      np.zeros((2, 48), bool))
    node.ingest_batch(np.zeros((1, 48), bool), np.eye(48, dtype=bool)[[15]])
    bodies = list(node.wal.records())
    assert len(bodies) == 4
    payloads = [_record_payload(b, 48, 3) for b in bodies]
    assert int(payloads[1].deleted.sum()) == 10
    assert bodies[2][:1] == bytes((wire.WAL_COMPACT_TAG,))
    assert int(payloads[2].deleted.sum()) == 0
    assert np.nonzero(payloads[3].deleted)[0].tolist() == [15]
    node.wal.close()
    back = Node.restore_durable(d, device="cpu",
                                fallback_init=lambda: _node(0, 48, 3))
    assert_port_same(node.state_slice(), back.state_slice())
    back.wal.close()


def test_dense_fallback_record_filters_deletions_too(tmp_path):
    e = 48
    d = str(tmp_path / "durable")
    node = _node(0, e, 3, d)
    node.add(*range(24))
    node.delete(*range(12))
    add = np.zeros((1, e), bool)
    add[0, 24:48] = True
    pre_vv = node.vv()
    node.ingest_batch(add, np.zeros((1, e), bool))
    last = list(node.wal.records())[-1]
    assert last[:1] != bytes((wire.WAL_COMPACT_TAG,)), "expected dense"
    guard, pos = wire._decode_vv_py(last, 0, 3)
    assert np.array_equal(guard, pre_vv)
    _, payload = framing.decode_payload_msg(last[pos:], e, 3)
    assert int(payload.deleted.sum()) == 0
    assert int(payload.changed.sum()) == 24
    node.wal.close()
    back = Node.restore_durable(d, device="cpu",
                                fallback_init=lambda: _node(0, e, 3))
    assert_port_same(node.state_slice(), back.state_slice())
    back.wal.close()
    # with a zero guard nothing is covered: every deletion survives
    p = delta_extract(node.state_slice(),
                      from_numpy_u32(np.zeros(3, np.uint32), "cpu"))
    body, _ = framing.encode_delta_wal_record(np.zeros(3, np.uint32), 0, p,
                                              None)
    assert int(_record_payload(body, e, 3).deleted.sum()) == 12
