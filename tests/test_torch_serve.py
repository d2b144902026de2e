"""The port's serve tier (serve/): the scenarios of tests/test_serve.py
replayed on it, and run across the two packages.

Every scenario in which a client meets a frontend runs in three stacks:
``torch`` (the port's client against the port's frontend), ``jax-client``
(the JAX package's ``ServeClient`` against the port's frontend) and
``jax-frontend`` (the port's client against the JAX package's
frontend); the typed rejects are the client package's classes.  Torch
frontends run on the CPU (``device="cpu"``, K10's plain version); the
op streams are fixed and the comparisons exact.  The admission queue,
session writer and protocol scenarios run on the port's modules alone.
"""

import os
import socket
import threading
import time

import numpy as np
import pytest

from go_crdt_playground_tpu.serve import protocol as jax_protocol
from go_crdt_playground_tpu.serve.client import ServeClient as JaxClient
from go_crdt_playground_tpu.serve.frontend import \
    ServeFrontend as JaxFrontend
from go_crdt_playground_tpu_torch.net import framing
from go_crdt_playground_tpu_torch.net.framing import ProtocolError
from go_crdt_playground_tpu_torch.net.peer import Node
from go_crdt_playground_tpu_torch.serve import protocol
from go_crdt_playground_tpu_torch.serve.admission import (AdmissionQueue,
                                                          OpRequest)
from go_crdt_playground_tpu_torch.serve.client import ServeClient
from go_crdt_playground_tpu_torch.serve.frontend import (NotYetPorted,
                                                         ServeFrontend)
from go_crdt_playground_tpu_torch.utils import wire
from tests.test_torch_net import prompt_jax_close  # noqa: F401 (autouse)

E, A = 64, 2


def torch_frontend(*args, **kw):
    return ServeFrontend(*args, device="cpu", **kw)


class Stack:
    """A frontend factory, a client class and the client's protocol
    module (its typed rejects)."""

    def __init__(self, name, frontend, client, proto):
        self.name, self.frontend, self.client, self.proto = (
            name, frontend, client, proto)

    def __repr__(self):
        return self.name


STACKS = [Stack("torch", torch_frontend, ServeClient, protocol),
          Stack("jax-client", torch_frontend, JaxClient, jax_protocol),
          Stack("jax-frontend", JaxFrontend, ServeClient, protocol)]
stacks = pytest.mark.parametrize("stack", STACKS, ids=repr)


# ---------------------------------------------------------------------------
# protocol bodies
# ---------------------------------------------------------------------------


def test_protocol_op_roundtrip():
    body = protocol.encode_op(7, protocol.OP_ADD, [1, 5, 300],
                              deadline_us=2_000_000)
    assert protocol.decode_op(body) == (7, protocol.OP_ADD, [1, 5, 300],
                                        2_000_000)
    body = protocol.encode_op(1, protocol.OP_DEL, [0])
    assert protocol.decode_op(body) == (1, protocol.OP_DEL, [0], 0)


def test_protocol_op_rejects_malformed():
    with pytest.raises(ValueError):
        protocol.encode_op(1, 9, [1])  # unknown kind
    with pytest.raises(ValueError):
        protocol.encode_op(1, protocol.OP_ADD, [])  # empty key set
    good = protocol.encode_op(3, protocol.OP_ADD, [1, 2])
    with pytest.raises(ProtocolError):
        protocol.decode_op(good + b"\x00")  # trailing bytes
    with pytest.raises(ProtocolError):
        protocol.decode_op(good[:-1])  # truncated
    with pytest.raises(ProtocolError):
        protocol.decode_op(b"")


def test_protocol_ack_reject_members_roundtrip():
    assert protocol.decode_ack(protocol.encode_ack(42)) == 42
    body = protocol.encode_reject(9, protocol.REJECT_OVERLOADED, "full")
    assert protocol.decode_reject(body) == (9, protocol.REJECT_OVERLOADED,
                                            "full")
    with pytest.raises(ValueError):
        protocol.encode_reject(1, 99, "?")
    req, members, vv = protocol.decode_members(
        protocol.encode_members(5, [1, 2, 9], np.asarray([3, 0, 7])))
    assert (req, members, vv.tolist()) == (5, [1, 2, 9], [3, 0, 7])
    assert set(protocol.REJECT_EXCEPTIONS) == {
        protocol.REJECT_OVERLOADED, protocol.REJECT_EXPIRED,
        protocol.REJECT_DRAINING, protocol.REJECT_INVALID,
        protocol.REJECT_UNAVAILABLE, protocol.REJECT_MOVING,
        protocol.REJECT_STALE_EPOCH, protocol.REJECT_STORAGE,
        protocol.REJECT_STALE_SHARD_EPOCH}
    for code, exc in protocol.REJECT_EXCEPTIONS.items():
        assert protocol.REJECT_CODES[exc] == code


def test_reshard_and_slice_protocol_roundtrips():
    body = protocol.encode_reshard(7, protocol.RESHARD_JOIN, "s9",
                                   ("10.0.0.1", 4242))
    assert protocol.decode_reshard(body) == (
        7, protocol.RESHARD_JOIN, "s9", ("10.0.0.1", 4242))
    body = protocol.encode_reshard(8, protocol.RESHARD_LEAVE, "s1")
    assert protocol.decode_reshard(body) == (
        8, protocol.RESHARD_LEAVE, "s1", None)
    with pytest.raises(ValueError):
        protocol.encode_reshard(1, protocol.RESHARD_JOIN, "x")  # no addr
    with pytest.raises(ValueError):
        protocol.encode_reshard(1, protocol.RESHARD_LEAVE, "x", ("h", 1))
    with pytest.raises(ValueError):
        protocol.encode_reshard(1, 9, "x")  # unknown mode
    with pytest.raises(ProtocolError):
        protocol.decode_reshard(body + b"\x00")  # trailing bytes
    body = protocol.encode_reshard_reply(3, True, {"moved": 5})
    assert protocol.decode_reshard_reply(body) == (3, True, {"moved": 5})
    body = protocol.encode_slice_pull(11, [4, 9, 60])
    assert protocol.decode_slice_pull(body) == (11, [4, 9, 60])
    with pytest.raises(ValueError):
        protocol.encode_slice_pull(1, [])
    payload = b"\x01opaque-payload-bytes"
    assert protocol.decode_slice_state(
        protocol.encode_slice_state(12, payload)) == (12, payload)
    assert protocol.decode_slice_push(
        protocol.encode_slice_push(13, payload)) == (13, payload)
    with pytest.raises(ProtocolError):
        protocol.decode_slice_push(b"")


# ---------------------------------------------------------------------------
# admission queue (no sockets)
# ---------------------------------------------------------------------------


def _req(i: int) -> OpRequest:
    return OpRequest(i, protocol.OP_ADD, [i], None, None, 0.0)


def test_admission_queue_bounds_and_sheds():
    q = AdmissionQueue(2)
    assert q.offer(_req(1)) and q.offer(_req(2))
    assert not q.offer(_req(3))  # at depth: shed, never queue
    assert q.depth() == 2
    batch = q.take_batch(10, wait_s=0.0, flush_s=0.0)
    assert [r.req_id for r in batch] == [1, 2]
    assert q.offer(_req(4))  # drained: admits again


def test_admission_queue_size_watermark():
    q = AdmissionQueue(16)
    for i in range(5):
        q.offer(_req(i))
    assert len(q.take_batch(3, wait_s=0.0, flush_s=10.0)) == 3
    assert len(q.take_batch(3, wait_s=0.0, flush_s=0.0)) == 2


def test_admission_queue_time_watermark_gathers_late_arrivals():
    q = AdmissionQueue(16)
    q.offer(_req(0))
    t = threading.Thread(
        target=lambda: (time.sleep(0.05), q.offer(_req(1))), daemon=True)
    t.start()
    batch = q.take_batch(8, wait_s=1.0, flush_s=1.0)
    t.join()
    assert [r.req_id for r in batch] == [0, 1]


def test_admission_queue_close_drains_then_refuses():
    q = AdmissionQueue(4)
    q.offer(_req(1))
    q.close()
    assert not q.offer(_req(2))  # closed: refuse new
    assert [r.req_id for r in q.take_batch(4, 0.0, 0.0)] == [1]
    assert q.take_batch(4, wait_s=5.0, flush_s=0.0) == []  # no hang


# ---------------------------------------------------------------------------
# frontends
# ---------------------------------------------------------------------------


@pytest.fixture()
def served(tmp_path, request):
    """A serving frontend of the stack's package (durable, batches of 8)."""
    stack = request.param
    fe = stack.frontend(E, A, durable_dir=str(tmp_path / "n0"),
                        max_batch=8, flush_ms=1.0, queue_depth=16)
    fe.serve()
    yield stack, fe
    fe.close()


served_stacks = pytest.mark.parametrize("served", STACKS, ids=repr,
                                        indirect=True)


def _gate_batcher(fe):
    """Block the batcher inside its next apply until the gate releases
    (``gate.entered`` is set once it is blocked, holding its ops)."""
    gate = threading.Event()
    gate.entered = threading.Event()
    inner = fe.node.ingest_batch

    def gated(*args, **kwargs):
        gate.entered.set()
        gate.wait(10.0)
        return inner(*args, **kwargs)

    fe.node.ingest_batch = gated
    return gate


@served_stacks
def test_ingest_end_to_end_and_query(served):
    stack, fe = served
    with stack.client(fe.addr) as c:
        c.add(1, 2, 3)
        c.add(5)
        c.delete(2)
        members, vv = c.members()
    assert members == [1, 3, 5]
    assert vv[0] == 5  # 4 add ticks + 1 del tick, actor 0
    snap = fe.recorder.snapshot()
    assert snap["counters"]["serve.ops.acked"] == 3
    assert snap["counters"]["serve.ops.admitted"] == 3
    lat = snap["observations"]["serve.ingest_latency_s"]
    assert lat["n"] == 3 and 0 < lat["p50"] <= lat["p99"]
    assert snap["observations"]["serve.batch.occupancy"]["n"] >= 1


@pytest.mark.parametrize("fused", [True, False])
def test_ingest_batch_matches_sequential_ops(tmp_path, fused):
    """The packed batch apply, fused (one step) and the seed two-step
    path alike, equals the same requests through the node's per-op
    path, end to end through the wire."""
    fe = torch_frontend(E, A, durable_dir=str(tmp_path / "n0"),
                        max_batch=4, flush_ms=0.5, ingest_fused=fused)
    fe.serve()
    try:
        with ServeClient(fe.addr) as c:
            c.add(3, 9, 11)
            c.delete(9)
            c.add(9, 20)
            c.delete(3, 20)
        got = fe.node.state_slice()
        dispatches = fe.recorder.snapshot()["counters"]["ingest.dispatches"]
        batches = fe.recorder.snapshot()["counters"]["serve.batches"]
    finally:
        fe.close()
    assert dispatches == batches * (1 if fused else 2)
    ref = Node(0, E, A, device="cpu")
    ref.add(3, 9, 11)
    ref.delete(9)
    ref.add(9, 20)
    ref.delete(3, 20)
    want = ref.state_slice()
    for name in want._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            err_msg=name)


@served_stacks
def test_invalid_element_is_typed_reject(served):
    stack, fe = served
    with stack.client(fe.addr) as c:
        with pytest.raises(stack.proto.InvalidOp):
            c.add(E + 5)
        c.add(1)  # the connection survives an invalid op
    assert fe.recorder.snapshot()["counters"]["serve.rejects.invalid"] == 1


@served_stacks
def test_duplicate_elements_refused_both_ends(served):
    """The client encoder refuses a duplicate key; a hand-crafted wire
    frame gets the typed per-request reject."""
    stack, fe = served
    with pytest.raises(ValueError, match="duplicate"):
        stack.proto.encode_op(1, protocol.OP_ADD, [7, 7])
    body = bytearray()
    wire._put_varint(body, 5)          # req_id
    body.append(protocol.OP_ADD)
    wire._put_varint(body, 0)          # deadline
    wire._put_varint(body, 2)          # k
    wire._put_varint(body, 7)
    wire._put_varint(body, 7)
    raw = socket.create_connection(fe.addr, timeout=10.0)
    try:
        framing.send_frame(raw, protocol.MSG_OP, bytes(body))
        msg_type, reply = framing.recv_frame(raw, timeout=10.0)
        assert msg_type == protocol.MSG_REJECT
        req_id, code, reason = protocol.decode_reject(reply)
        assert (req_id, code) == (5, protocol.REJECT_INVALID)
        assert "duplicate" in reason
    finally:
        raw.close()


@served_stacks
def test_client_fails_fast_after_reader_death(served):
    stack, fe = served
    c = stack.client(fe.addr)
    c.add(1)
    c._sock.shutdown(2)  # tear the transport under the reader
    c._reader.join(timeout=10.0)
    assert not c._reader.is_alive()
    with pytest.raises(ConnectionError):
        c.submit_async(protocol.OP_ADD, [2])
    c.close()


@stacks
def test_overload_sheds_with_typed_reply(tmp_path, stack):
    fe = stack.frontend(E, A, durable_dir=str(tmp_path / "n0"),
                        max_batch=1, flush_ms=0.0, queue_depth=2)
    gate = _gate_batcher(fe)
    fe.serve()
    try:
        with stack.client(fe.addr) as c:
            ops = [c.submit_async(protocol.OP_ADD, [0])]
            assert gate.entered.wait(5.0)
            ops += [c.submit_async(protocol.OP_ADD, [i]) for i in (1, 2)]
            while fe.queue.depth() < 2:
                time.sleep(0.005)
            with pytest.raises(stack.proto.Overloaded):
                c.submit_async(protocol.OP_ADD, [7]).wait(5.0)
            gate.set()
            for op in ops:  # everything admitted still acks
                op.wait(10.0)
        snap = fe.recorder.snapshot()
        assert snap["counters"]["serve.shed.overload"] == 1
        assert snap["counters"]["serve.ops.acked"] == 3
    finally:
        gate.set()
        fe.close()


@stacks
def test_deadline_propagation_sheds_expired(tmp_path, stack):
    fe = stack.frontend(E, A, durable_dir=str(tmp_path / "n0"),
                        max_batch=8, flush_ms=0.0, queue_depth=16)
    gate = _gate_batcher(fe)
    fe.serve()
    try:
        with stack.client(fe.addr) as c:
            hold = c.submit_async(protocol.OP_ADD, [1])
            assert gate.entered.wait(5.0)
            while fe.queue.depth() > 0:
                time.sleep(0.005)
            doomed = c.submit_async(protocol.OP_ADD, [2], deadline_s=0.01)
            time.sleep(0.05)  # deadline passes while queued
            gate.set()
            with pytest.raises(stack.proto.DeadlineExceeded):
                doomed.wait(10.0)
            hold.wait(10.0)
            members, _ = c.members()
        assert members == [1]  # the expired op was never applied
        assert fe.recorder.snapshot()["counters"]["serve.shed.expired"] == 1
    finally:
        gate.set()
        fe.close()


@stacks
def test_graceful_drain_acks_admitted_ops(tmp_path, stack):
    fe = stack.frontend(E, A, durable_dir=str(tmp_path / "n0"),
                        max_batch=4, flush_ms=0.0, queue_depth=16)
    gate = _gate_batcher(fe)
    fe.serve()
    with stack.client(fe.addr) as c:
        ops = [c.submit_async(protocol.OP_ADD, [0])]
        assert gate.entered.wait(5.0)
        ops += [c.submit_async(protocol.OP_ADD, [i]) for i in range(1, 6)]
        while fe.queue.depth() < 5:  # one op is held by the gated batcher
            time.sleep(0.005)
        closer = threading.Thread(target=fe.close, daemon=True)
        closer.start()
        while not fe.host.draining:
            time.sleep(0.005)
        with pytest.raises(stack.proto.Draining):
            c.submit_async(protocol.OP_ADD, [9]).wait(5.0)
        gate.set()
        closer.join(timeout=30.0)
        assert not closer.is_alive()
        for op in ops:
            op.wait(5.0)  # already resolved: close() flushed first
    snap = fe.recorder.snapshot()
    assert snap["counters"]["serve.ops.acked"] == 6
    assert snap["counters"]["serve.shed.draining"] == 1


@stacks
def test_durable_ack_survives_restart(tmp_path, stack):
    """Everything acked before an abrupt teardown (no final checkpoint)
    is recovered from the WAL alone, by the same package and, across
    packages, by the other one's frontend."""
    d = str(tmp_path / "n0")
    fe = stack.frontend(E, A, durable_dir=d, max_batch=8, flush_ms=0.5)
    fe.serve()
    with stack.client(fe.addr) as c:
        c.add(1, 2, 3)
        c.delete(2)
        c.add(40)
    fe.batcher.stop()
    with fe.node._lock:
        fe.node.wal.close()
    fe.node.close()
    other = JaxFrontend if stack.frontend is torch_frontend else \
        torch_frontend
    for factory in (stack.frontend, other):
        fe2 = factory(E, A, durable_dir=d)
        assert list(fe2.node.members()) == [1, 3, 40]
        fe2.batcher.stop()
        with fe2.node._lock:
            fe2.node.wal.close()
        fe2.node.close()


@pytest.mark.parametrize("peer_pkg", ["torch", "jax"])
def test_frontend_disseminates_to_peers(tmp_path, peer_pkg):
    """Ingested state rides anti-entropy: a plain node of either package
    converges to the torch frontend's membership."""
    from go_crdt_playground_tpu.net.peer import Node as JaxNode

    peer = Node(1, E, A, device="cpu") if peer_pkg == "torch" \
        else JaxNode(1, E, A)
    peer_addr = peer.serve("127.0.0.1", 0)
    fe = torch_frontend(E, A, durable_dir=str(tmp_path / "n0"),
                        peers=[peer_addr], max_batch=8, flush_ms=0.5,
                        sync_interval_s=0.01)
    fe.serve()
    try:
        with ServeClient(fe.addr) as c:
            c.add(4, 8, 15)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if list(peer.members()) == [4, 8, 15]:
                break
            time.sleep(0.02)
        assert list(peer.members()) == [4, 8, 15]
    finally:
        fe.close()
        peer.close()


def test_session_writer_queue_sheds_stalled_reader():
    """``send()`` only enqueues: a client that stops reading its acks
    never blocks the caller; the session is shed instead."""
    from go_crdt_playground_tpu_torch.serve.session import Session

    a, b = socket.socketpair()
    try:
        a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        b.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        s = Session(a, send_timeout_s=0.2, queue_depth=64)
        body = b"x" * 8192
        t0 = time.monotonic()
        sends = 0
        max_send_s = 0.0
        while True:
            s0 = time.monotonic()
            ok = s.send(protocol.MSG_ACK, body)
            max_send_s = max(max_send_s, time.monotonic() - s0)
            if not ok:
                break
            sends += 1
            assert sends < 10_000, "send never shed the stalled reader"
        elapsed = time.monotonic() - t0
        assert s.closed
        assert max_send_s < 0.1, f"send() blocked {max_send_s:.3f}s"
        assert elapsed < 5.0, f"shed took {elapsed:.1f}s despite bounds"
        assert not s.send(protocol.MSG_ACK, b"y")  # closed: instant no-op
    finally:
        for sock in (a, b):
            sock.close()


def test_session_writer_decouples_sessions():
    """One read-stalled client does not delay another session's replies
    through the same calling thread."""
    from go_crdt_playground_tpu_torch.serve.session import Session

    a1, b1 = socket.socketpair()  # stalled: b1 never read
    a2, b2 = socket.socketpair()  # healthy: b2 read below
    try:
        a1.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        b1.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        stalled = Session(a1, send_timeout_s=0.2, queue_depth=16)
        healthy = Session(a2, send_timeout_s=0.2)
        body = b"x" * 8192
        t0 = time.monotonic()
        for i in range(20):
            stalled.send(protocol.MSG_ACK, body)
            assert healthy.send(protocol.MSG_ACK, protocol.encode_ack(i))
        assert time.monotonic() - t0 < 1.0
        for i in range(20):  # every healthy ack arrives, in order
            msg_type, reply = framing.recv_frame(b2, timeout=10.0)
            assert msg_type == protocol.MSG_ACK
            assert protocol.decode_ack(reply) == i
        stalled.close()
        healthy.close()
    finally:
        for sock in (a1, b1, a2, b2):
            sock.close()


@stacks
def test_poison_batch_rejects_retryable_and_keeps_serving(tmp_path, stack):
    """An apply failure rejects its ops retryable-typed (an OSError as
    ``StorageDegraded``, anything else as ``Overloaded``) and the
    batcher keeps serving; while the storage window is armed writes
    shed at admission and reads serve; a probe batch clears it."""
    fe = stack.frontend(E, A, durable_dir=str(tmp_path / "n0"),
                        max_batch=4, flush_ms=0.5)
    inner = fe.node.ingest_batch
    poison = {"kind": OSError}

    def flaky(*args, **kwargs):
        if poison["kind"] is not None:
            raise poison["kind"]("injected disk error")
        return inner(*args, **kwargs)

    fe.node.ingest_batch = flaky
    fe.serve()
    proto = stack.proto
    try:
        with stack.client(fe.addr) as c:
            with pytest.raises(proto.StorageDegraded, match="retry"):
                c.add(1)
            assert fe.batcher.storage_degraded()
            with pytest.raises(proto.StorageDegraded):
                c.add(1)
            members, _ = c.members()
            assert members == []
            poison["kind"] = RuntimeError
            deadline = time.monotonic() + 10.0
            saw_overloaded = False
            while time.monotonic() < deadline:
                try:
                    c.add(1)
                except proto.StorageDegraded:
                    time.sleep(0.05)  # window still armed
                except proto.Overloaded:
                    saw_overloaded = True
                    break
            assert saw_overloaded
            poison["kind"] = None  # heal the fault
            deadline = time.monotonic() + 10.0
            while True:  # the next admitted batch is the disk probe
                try:
                    c.add(2)
                    break
                except proto.ServeError:
                    assert time.monotonic() < deadline
                    time.sleep(0.05)
            assert not fe.batcher.storage_degraded()
            members, _ = c.members()
        assert members == [2]
        snap = fe.recorder.snapshot()
        assert snap["counters"]["serve.batch_errors"] >= 1
        assert snap["counters"]["serve.shed.storage"] >= 1
    finally:
        fe.close()


def test_client_on_result_fires_on_connection_death():
    listener = socket.create_server(("127.0.0.1", 0))
    results = []
    try:
        c = ServeClient(listener.getsockname()[:2],
                        on_result=results.append)
        conn, _ = listener.accept()
        op = c.submit_async(protocol.OP_ADD, [1])
        conn.close()  # server dies without answering
        with pytest.raises(ConnectionError):
            op.wait(10.0)
        assert len(results) == 1 and results[0] is op
        assert isinstance(op.error, ConnectionError)
        c.close()
    finally:
        listener.close()


@stacks
def test_connection_cap_sheds_excess_dials(tmp_path, stack):
    fe = stack.frontend(E, A, durable_dir=str(tmp_path / "n0"),
                        max_conns=2, flush_ms=0.5)
    fe.serve()
    try:
        c1 = stack.client(fe.addr)
        c2 = stack.client(fe.addr)
        c1.add(1)
        c2.add(2)
        c3 = stack.client(fe.addr)
        with pytest.raises((ConnectionError, OSError)):
            c3.add(3)
        c3.close()
        c1.close()
        deadline = time.monotonic() + 10.0
        c4 = None
        while time.monotonic() < deadline:  # c1's slot frees asynchronously
            try:
                c4 = stack.client(fe.addr)
                c4.add(4)
                break
            except (ConnectionError, OSError):
                if c4 is not None:
                    c4.close()
                    c4 = None
                time.sleep(0.05)
        assert c4 is not None, "released slot never admitted a new dial"
        c4.close()
        c2.close()
        assert fe.recorder.snapshot()["counters"][
            "serve.shed.connections"] >= 1
    finally:
        fe.close()


@stacks
def test_oversized_frame_drops_connection(tmp_path, stack):
    fe = stack.frontend(E, A, durable_dir=str(tmp_path / "n0"))
    fe.serve()
    try:
        raw = socket.create_connection(fe.addr, timeout=10.0)
        head = bytearray(framing.MAGIC)
        head.append(protocol.MSG_OP)
        wire._put_varint(head, 64 << 20)  # declares a 64 MiB body
        raw.sendall(bytes(head))
        assert raw.recv(1) == b""  # dropped without buffering
        raw.close()
        with stack.client(fe.addr) as c:
            c.add(1)
            assert c.members()[0] == [1]
    finally:
        fe.close()


def test_close_is_idempotent_and_queryable_metrics(tmp_path):
    fe = torch_frontend(E, A, durable_dir=str(tmp_path / "n0"))
    fe.serve()
    fe.close()
    fe.close()  # second close is a no-op, not an error
    assert os.path.isdir(str(tmp_path / "n0"))


@stacks
def test_slice_pull_push_transfers_state(tmp_path, stack):
    """Pull a slice off one frontend, push it into another (the other
    package's frontend in the mixed stacks): the recipient serves the
    moved elements, a deletion's absence included, durably."""
    donor = stack.frontend(E, A, durable_dir=str(tmp_path / "donor"),
                           max_batch=8, flush_ms=1.0)
    other = JaxFrontend if stack.name == "torch" else torch_frontend
    recipient = other(E, A, actor=1, durable_dir=str(tmp_path / "recip"),
                      max_batch=8, flush_ms=1.0)
    donor.serve()
    recipient.serve()
    try:
        with stack.client(donor.addr) as c:
            c.add(1, 2, 3, 9)
            c.delete(2)
            with pytest.raises(stack.proto.InvalidOp):
                c.slice_pull([E + 1])
            payload = c.slice_pull([1, 2, 3])
        with stack.client(recipient.addr) as c:
            c.add(50)
            c.slice_push(payload)
            members, _ = c.members()
        assert members == [1, 3, 50]
        assert donor.recorder.snapshot()["counters"][
            "serve.slice.pulls"] == 1
        assert recipient.recorder.snapshot()["counters"][
            "serve.slice.pushes"] == 1
    finally:
        recipient.close()
        donor.close()


def test_slice_transfer_survives_vv_inflation():
    """A later slice whose dot the recipient's (inflated) vv already
    covers still lands: MODE_SLICE applies by overwrite."""
    donor = Node(1, 32, 4, device="cpu")
    donor.add(5, 9)
    recip = Node(2, 32, 4, device="cpu")
    m = np.zeros(32, bool)
    m[5] = True
    recip.apply_payload_body(donor.extract_slice(m))  # move 5 only
    assert list(recip.members()) == [5]
    m = np.zeros(32, bool)
    m[9] = True
    later = donor.extract_slice(m)
    recip.apply_payload_body(later)  # 9's dot is already vv-covered
    assert list(recip.members()) == [5, 9]
    recip.apply_payload_body(later)  # retry idempotence
    assert list(recip.members()) == [5, 9]
    donor.delete(5)
    m = np.zeros(32, bool)
    m[5] = True
    recip.apply_payload_body(donor.extract_slice(m))
    assert list(recip.members()) == [9]


def test_unported_options_raise_typed():
    """The reference's mesh replicas and admission scheduler are not
    ported: asking for them raises ``NotYetPorted``; ``sched='auto'``
    and ``'off'`` serve FIFO on one device."""
    with pytest.raises(NotYetPorted, match="mesh"):
        torch_frontend(E, A, mesh_devices=2)
    with pytest.raises(NotYetPorted, match="scheduler"):
        torch_frontend(E, A, sched="on")
    with pytest.raises(ValueError, match="sched"):
        torch_frontend(E, A, sched="sometimes")
    for sched in ("auto", "off"):
        fe = torch_frontend(E, A, sched=sched)
        assert fe.scheduler is None
        fe.close()
