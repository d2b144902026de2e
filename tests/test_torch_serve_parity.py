"""A torch frontend (CPU) and a JAX frontend side by side over 127.0.0.1:
the same frame stream to each, every reply frame compared byte for
byte, every WAL record compared byte for byte (batch boundaries fixed
at one op a batch), the counters of STATS compared by name and value,
and the two durable directories restored by the other package to equal
members and vv.  The comparisons are exact."""

import socket

import numpy as np
import pytest

from go_crdt_playground_tpu.net.peer import Node as JaxNode
from go_crdt_playground_tpu.serve.frontend import \
    ServeFrontend as JaxFrontend
from go_crdt_playground_tpu_torch.net import framing
from go_crdt_playground_tpu_torch.net.peer import Node
from go_crdt_playground_tpu_torch.serve import protocol
from go_crdt_playground_tpu_torch.serve.frontend import ServeFrontend
from go_crdt_playground_tpu_torch.utils import wire
from tests.test_torch_net import prompt_jax_close  # noqa: F401 (autouse)

E, A = 96, 4


def frame_stream(seed: int):
    """(msg_type, body) frames: adds and deletes of 1-5 keys from a
    numpy seed, with an out-of-universe op, a duplicate-key op (built
    by hand: the encoder refuses it), an empty-universe slice pull,
    queries, digest-summary reads, slice pulls, the GC evidence verbs,
    a router-epoch read and STATS."""
    rng = np.random.default_rng(seed)
    frames, req = [], 0
    for i in range(60):
        req += 1
        keys = sorted(rng.choice(E, size=int(rng.integers(1, 6)),
                                 replace=False).tolist())
        kind = protocol.OP_DEL if rng.random() < 0.3 else protocol.OP_ADD
        frames.append((protocol.MSG_OP, protocol.encode_op(req, kind, keys)))
        if i % 10 == 4:
            req += 1
            frames.append((protocol.MSG_QUERY, protocol.encode_query(req)))
            req += 1
            frames.append((protocol.MSG_DSUM, protocol.encode_dsum(req)))
        if i % 20 == 7:
            req += 1
            frames.append((protocol.MSG_SLICE_PULL,
                           protocol.encode_slice_pull(req, keys)))
    dup = bytearray()
    wire._put_varint(dup, req + 1)
    dup.append(protocol.OP_ADD)
    for v in (0, 2, 7, 7):  # deadline, k, the keys
        wire._put_varint(dup, v)
    frames += [
        (protocol.MSG_OP, protocol.encode_op(req + 2, protocol.OP_ADD,
                                             [E + 3])),
        (protocol.MSG_OP, bytes(dup)),
        (protocol.MSG_SLICE_PULL, protocol.encode_slice_pull(req + 3,
                                                             [E])),
        (protocol.MSG_FRONTIER, protocol.encode_frontier(req + 4)),
        (protocol.MSG_GC, protocol.encode_gc(
            req + 5, np.zeros(A, np.uint32))),
        (protocol.MSG_RING_SYNC, protocol.encode_ring_sync(req + 6, 0, "")),
        (protocol.MSG_QUERY, protocol.encode_query(req + 7)),
        (protocol.MSG_STATS, protocol.encode_stats(req + 8)),
    ]
    return frames


def drive(fe, frames):
    """Send each frame and read its reply before the next; returns the
    (msg_type, body) replies and the WAL bodies appended meanwhile."""
    bodies = []
    append = fe.node.wal.append

    def tee(body):
        bodies.append(body)
        append(body)

    fe.node.wal.append = tee
    replies = []
    conn = socket.create_connection(fe.addr, timeout=30.0)
    try:
        for msg_type, body in frames:
            framing.send_frame(conn, msg_type, body)
            replies.append(framing.recv_frame(conn, timeout=30.0))
    finally:
        conn.close()
    return replies, bodies


@pytest.mark.parametrize("seed", [3, 11])
def test_frontends_reply_and_log_the_same_bytes(tmp_path, seed):
    frames = frame_stream(seed)
    kw = dict(max_batch=1, flush_ms=0.0, queue_depth=16, gc_participants=())
    jfe = JaxFrontend(E, A, durable_dir=str(tmp_path / "jax"), **kw)
    tfe = ServeFrontend(E, A, durable_dir=str(tmp_path / "torch"),
                        device="cpu", **kw)
    out = {}
    for name, fe in (("jax", jfe), ("torch", tfe)):
        fe.serve()
        try:
            out[name] = drive(fe, frames)
            out[name + "_state"] = fe.node.members_vv()
        finally:
            fe.close()
    (jrep, jwal), (trep, twal) = out["jax"], out["torch"]
    assert len(jrep) == len(trep) == len(frames)
    kinds = set()
    for i, ((jt, jb), (tt, tb)) in enumerate(zip(jrep, trep)):
        kinds.add(tt)
        if tt == protocol.MSG_STATS_REPLY:
            jsnap = protocol.decode_stats_reply(jb)[1]
            tsnap = protocol.decode_stats_reply(tb)[1]
            assert jsnap["counters"] == tsnap["counters"]
            assert set(jsnap["observations"]) == set(tsnap["observations"])
            assert set(jsnap["gauges"]) == set(tsnap["gauges"])
            continue
        assert (jt, jb) == (tt, tb), f"reply {i} to frame type " \
                                     f"{frames[i][0]}"
    assert {protocol.MSG_ACK, protocol.MSG_REJECT, protocol.MSG_MEMBERS,
            protocol.MSG_DSUM_REPLY, protocol.MSG_SLICE_STATE,
            protocol.MSG_FRONTIER_REPLY, protocol.MSG_GC_REPLY,
            protocol.MSG_RING_SYNC_REPLY, protocol.MSG_STATS_REPLY} <= kinds
    assert len(jwal) == len(twal) > 40
    assert jwal == twal
    (jm, jvv), (tm, tvv) = out["jax_state"], out["torch_state"]
    assert np.array_equal(jm, tm) and np.array_equal(jvv, tvv)

    # the durable dirs, drained and checkpointed, restore across packages
    from_jax = Node.restore_durable(str(tmp_path / "jax"), device="cpu")
    from_torch = JaxNode.restore_durable(str(tmp_path / "torch"))
    for node in (from_jax, from_torch):
        members, vv = node.members_vv()
        assert np.array_equal(members, tm) and np.array_equal(vv, tvv)
        with node._lock:
            node.wal.close()
        node.close()


def test_wal_only_dirs_cross_restore_mid_stream(tmp_path):
    """A crash-shaped stop (no drain, no checkpoint: the WAL is the only
    carrier) on each package's frontend; the other package's frontend
    restores the directory to the same members and vv."""
    frames = [f for f in frame_stream(5) if f[0] == protocol.MSG_OP][:30]
    want = None
    for name, make, other in (
            ("jax", lambda d: JaxFrontend(E, A, durable_dir=d, max_batch=4),
             lambda d: ServeFrontend(E, A, durable_dir=d, device="cpu")),
            ("torch", lambda d: ServeFrontend(E, A, durable_dir=d,
                                              max_batch=4, device="cpu"),
             lambda d: JaxFrontend(E, A, durable_dir=d))):
        d = str(tmp_path / name)
        fe = make(d)
        fe.serve()
        drive(fe, frames)
        state = fe.node.members_vv()
        fe.batcher.stop()
        with fe.node._lock:
            fe.node.wal.close()
        fe.node.close()
        back = other(d)
        got = back.node.members_vv()
        assert all(np.array_equal(x, y) for x, y in zip(got, state))
        want = state if want is None else want
        assert all(np.array_equal(x, y) for x, y in zip(state, want))
        back.batcher.stop()
        with back.node._lock:
            back.node.wal.close()
        back.node.close()


def test_wal_sync_tail_and_catch_up_match(tmp_path):
    """The replication verb on both frontends after the same ops (one
    op a batch): the tail poll ships the same WAL records (the nonce is
    per WAL instance, so it differs), and a digest catch-up from an
    empty standby returns the same payload, which a fresh torch node
    applies to the frontends' members and vv."""
    from go_crdt_playground_tpu.serve.client import ServeClient as JaxClient
    from go_crdt_playground_tpu_torch.net import digestsync
    from go_crdt_playground_tpu_torch.serve.client import ServeClient

    frames = [f for f in frame_stream(9) if f[0] == protocol.MSG_OP][:25]
    replies = {}
    for name, make, client in (
            ("jax", lambda d: JaxFrontend(E, A, durable_dir=d, max_batch=1,
                                          flush_ms=0.0), JaxClient),
            ("torch", lambda d: ServeFrontend(E, A, durable_dir=d,
                                              max_batch=1, flush_ms=0.0,
                                              device="cpu"), ServeClient)):
        fe = make(str(tmp_path / name))
        fe.serve()
        try:
            drive(fe, frames)
            standby = Node(3, E, A, device="cpu")
            with client(fe.addr) as c:
                tail = c.wal_sync(1, standby_id="s")
                catch = c.wal_sync(1, standby_id="s",
                                   summary=digestsync.node_summary(standby))
            replies[name] = (tail, catch, fe.node.members_vv())
        finally:
            fe.close()
    (jt, jc, _), (tt, tc, (members, vv)) = replies["jax"], replies["torch"]
    assert tt.records == jt.records and len(tt.records) > 15
    assert (tt.flags, tt.min_seq, tt.next_seq, tt.first_seq) == \
        (jt.flags, jt.min_seq, jt.next_seq, jt.first_seq)
    assert tc.payload == jc.payload and tc.payload
    node = Node(3, E, A, device="cpu")
    node.apply_payload_body(tc.payload)
    got_m, got_vv = node.members_vv()
    assert np.array_equal(got_m, members)
    assert np.array_equal(got_vv[:3], vv[:3])
