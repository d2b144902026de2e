"""The port's node over real sockets (net/peer.py's socket half,
net/framing.py's frames, net/antientropy.py, utils/backoff.py).

The JAX package's tests/test_net.py and tests/test_antientropy.py
replayed on torch nodes (CPU), plus parity: frames byte for byte
against the JAX package's framing, mixed JAX <-> torch pairs whose every
exchange reports the bytes and modes of a JAX-only pair and whose states
equal the JAX-only pair's field by field (``np.array_equal``, dtype
included), and the breaker and backoff schedules step for step.  Every
socket binds port 0 on 127.0.0.1 and every wait is bounded.
"""

import socket
import threading
import time

import numpy as np
import pytest

from go_crdt_playground_tpu.models.spec import AWSetDelta, VersionVector
from go_crdt_playground_tpu.net import antientropy as jax_antientropy
from go_crdt_playground_tpu.net import framing as jax_framing
from go_crdt_playground_tpu.net.peer import Node as JaxNode
from go_crdt_playground_tpu.obs import Recorder
from go_crdt_playground_tpu.utils import backoff as jax_backoff
from go_crdt_playground_tpu_torch.net import framing
from go_crdt_playground_tpu_torch.net.antientropy import (CLOSED, HALF_OPEN,
                                                          OPEN, CircuitBreaker,
                                                          SyncSupervisor,
                                                          classify_failure)
from go_crdt_playground_tpu_torch.net.framing import MODE_DELTA, MODE_FULL
from go_crdt_playground_tpu_torch.net.peer import (ConnectFailed, Node,
                                                   PeerProtocolError,
                                                   PeerReset, PeerTimeout,
                                                   SyncError)
from go_crdt_playground_tpu_torch.utils import backoff
from go_crdt_playground_tpu_torch.utils.backoff import BackoffPolicy
from tests.test_torch_node import assert_nodes_same

E = 32
A = 2
FAST = BackoffPolicy(base_s=0.001, cap_s=0.005, max_retries=2, jitter=0.0)


def node(actor, e=E, a=A, **kw):
    return Node(actor, e, a, device="cpu", **kw)


@pytest.fixture(autouse=True)
def prompt_jax_close(monkeypatch):
    """The JAX node's close() closes its listener without shutting it
    down, which leaves the accept thread blocked until close()'s 5 s
    join gives up; shut it down first so each JAX server here stops at
    once."""
    close = JaxNode.close

    def prompt(self):
        sock = self._server_sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        close(self)

    monkeypatch.setattr(JaxNode, "close", prompt)


def retry_sync(peer, addr, seconds=10.0):
    """sync_with until it succeeds (a shed or timed-out dial is retried)."""
    deadline = time.monotonic() + seconds
    while True:
        try:
            return peer.sync_with(addr, timeout=5.0)
        except (OSError, framing.ProtocolError):
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


# ---------------------------------------------------------------------------
# tests/test_net.py on torch nodes
# ---------------------------------------------------------------------------


def test_two_node_convergence_and_modes():
    a, b = node(0), node(1)
    with b:
        addr = b.serve()
        a.add(1, 2, 3)
        b.add(3, 4)
        stats = a.sync_with(addr)
        assert stats.mode_sent == MODE_FULL == stats.mode_received
        assert a.members().tolist() == b.members().tolist() == [1, 2, 3, 4]
        a.add(5)
        stats = a.sync_with(addr)
        assert stats.mode_sent == MODE_DELTA == stats.mode_received
        assert b.members().tolist() == [1, 2, 3, 4, 5]


def test_add_wins_over_concurrent_delete():
    a, b = node(0), node(1)
    with b:
        addr = b.serve()
        a.add(5)
        a.sync_with(addr)
        b.delete(5)
        a.add(5)
        a.sync_with(addr)
        assert a.members().tolist() == b.members().tolist() == [5]


def test_observed_delete_sticks():
    a, b = node(0), node(1)
    with b:
        addr = b.serve()
        a.add(7)
        a.sync_with(addr)
        b.delete(7)
        a.sync_with(addr)
        assert a.members().size == 0 and b.members().size == 0


def test_three_node_transitive_propagation():
    a, b, c = (node(i, a=3) for i in range(3))
    with a, b, c:
        addr_b, addr_c = b.serve(), c.serve()
        a.add(1)
        c.add(9)
        a.sync_with(addr_b)
        b.sync_with(addr_c)
        b.sync_with(addr_c)
        a.sync_with(addr_b)
        for n in (a, b, c):
            assert n.members().tolist() == [1, 9]


def test_payload_bytes_shrink_after_convergence():
    a, b = node(0), node(1)
    with b:
        addr = b.serve()
        a.add(*range(20))
        b.add(30)
        first = a.sync_with(addr)
        second = a.sync_with(addr)
        assert second.mode_sent == MODE_DELTA == second.mode_received
        assert second.bytes_sent < first.bytes_sent
        assert second.bytes_received < first.bytes_received
        assert second.bytes_sent < 48


def test_write_free_replica_keeps_full_dispatch():
    a, b = node(0), node(1)
    with b:
        addr = b.serve()
        a.add(1)
        assert a.sync_with(addr).mode_received == MODE_FULL
        stats = a.sync_with(addr)
        assert stats.mode_sent == MODE_DELTA
        assert stats.mode_received == MODE_FULL


def test_dimension_mismatch_rejected():
    a, b = node(0), node(1, e=2 * E)
    with b:
        addr = b.serve()
        with pytest.raises(framing.RemoteError, match="universe mismatch"):
            a.sync_with(addr)


def test_actor_axis_mismatch_rejected():
    a, b = node(0, a=2), node(1, a=3)
    with b:
        addr = b.serve()
        with pytest.raises(framing.RemoteError, match="actor-axis mismatch"):
            a.sync_with(addr)
        c = node(0, a=3)
        c.add(4)
        c.sync_with(addr)
        assert b.members().tolist() == [4]


def _spec(actor, semantics, num_actors=A):
    return AWSetDelta(actor=actor,
                      version_vector=VersionVector([0] * num_actors),
                      delta_semantics=semantics)


def _spec_members(spec):
    return sorted(int(k[1:]) for k in spec.entries)


@pytest.mark.parametrize("delta_semantics", ["v2", "reference"])
def test_randomized_scenario_matches_spec(delta_semantics):
    """Random ops and exchanges over the socket track the executable
    spec's replica pair step for step (an exchange is server.merge(client)
    then client.merge(server))."""
    rng = np.random.default_rng(7)
    a = node(0, delta_semantics=delta_semantics)
    b = node(1, delta_semantics=delta_semantics)
    sa, sb = _spec(0, delta_semantics), _spec(1, delta_semantics)

    def key(i):
        return f"e{i:03d}"

    with b:
        addr = b.serve()
        for _ in range(60):
            op = rng.integers(0, 4)
            if op in (0, 1):
                who, spec = (a, sa) if op == 0 else (b, sb)
                ids = rng.choice(E, size=rng.integers(1, 4), replace=False)
                who.add(*ids)
                spec.add(*(key(i) for i in ids))
            elif op == 2:
                who, spec = (a, sa) if rng.integers(2) else (b, sb)
                live = who.members()
                if live.size:
                    ids = rng.choice(live, size=rng.integers(
                        1, min(3, live.size) + 1), replace=False)
                    who.delete(*ids)
                    spec.del_(*(key(i) for i in ids))
            else:
                a.sync_with(addr)
                sb.merge(sa)
                sa.merge(sb)
                assert a.members().tolist() == _spec_members(sa)
                assert b.members().tolist() == _spec_members(sb)
        a.sync_with(addr)
        sb.merge(sa)
        sa.merge(sb)
        assert a.members().tolist() == _spec_members(sa)
        assert b.members().tolist() == _spec_members(sb)
        if delta_semantics == "v2":
            assert a.vv().tolist() == [sa.version_vector[i] for i in range(A)]
            assert b.vv().tolist() == [sb.version_vector[i] for i in range(A)]


def test_recorder_counts_exchanges():
    ra, rb = Recorder(), Recorder()
    a, b = node(0, recorder=ra), node(1, recorder=rb)
    with b:
        addr = b.serve()
        a.add(1)
        stats = a.sync_with(addr)
        deadline = time.monotonic() + 5.0
        while (rb.counter("sync.exchanges") == 0
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert ra.counter("sync.exchanges") == rb.counter("sync.exchanges") \
            == 1
        assert ra.counter("sync.bytes_sent") == stats.bytes_sent
        assert ra.counter("sync.bytes_received") == stats.bytes_received
        assert rb.counter("sync.bytes_sent") == stats.bytes_received
        assert ra.counter("sync.full_payloads") == 1


def test_soak_concurrent_clients_bounded_threads():
    """Concurrent clients x repeated exchanges against one server: every
    client converges and the connection threads stay bounded."""
    n_clients, n_rounds = 16, 3
    server = node(0, e=64, a=n_clients + 1)
    clients = [node(i + 1, e=64, a=n_clients + 1) for i in range(n_clients)]
    errors, peak = [], [threading.active_count()]
    with server:
        addr = server.serve()
        server.add(0)

        def run(i, c):
            try:
                c.add(i + 1)
                for _ in range(n_rounds):
                    c.sync_with(addr, timeout=5.0)
                    peak[0] = max(peak[0], threading.active_count())
            except Exception as e:  # noqa: BLE001 — collected
                errors.append((i, e))

        threads = [threading.Thread(target=run, args=(i, c))
                   for i, c in enumerate(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors[:3]
        assert set(server.members()) == set(range(n_clients + 1))
        for c in clients:
            c.sync_with(addr, timeout=5.0)
            assert set(c.members()) == set(range(n_clients + 1))
    assert peak[0] <= threading.active_count() + n_clients \
        + server.MAX_CONNS + 8


def test_server_sheds_connections_at_capacity():
    server = node(0, max_conns=1, conn_timeout_s=5.0)
    with server:
        addr = server.serve()
        hog = socket.create_connection(addr, timeout=5.0)
        try:
            time.sleep(0.1)
            probe = socket.create_connection(addr, timeout=5.0)
            with probe:
                probe.settimeout(5.0)
                assert probe.recv(1) == b""  # closed, not served
        finally:
            hog.close()
        peer = node(1)
        peer.add(3)
        retry_sync(peer, addr)
        assert 3 in server.members()


def test_half_open_dial_releases_slot_at_hello_deadline():
    server = node(0, max_conns=1, conn_timeout_s=30.0, hello_timeout_s=0.5)
    with server:
        addr = server.serve()
        hog = socket.create_connection(addr, timeout=5.0)
        try:
            time.sleep(0.8)
            peer = node(1)
            peer.add(5)
            retry_sync(peer, addr)
            assert 5 in server.members()
        finally:
            hog.close()


def test_trickling_dial_releases_slot_at_hello_deadline():
    server = node(0, max_conns=1, conn_timeout_s=30.0, hello_timeout_s=0.5)
    with server:
        addr = server.serve()
        hog = socket.create_connection(addr, timeout=5.0)
        stop = threading.Event()

        def trickle():
            for b in framing.MAGIC * 1000:
                if stop.is_set():
                    return
                try:
                    hog.sendall(bytes([b]))
                except OSError:
                    return
                time.sleep(0.3)

        t = threading.Thread(target=trickle, daemon=True)
        t.start()
        try:
            time.sleep(1.0)
            peer = node(1)
            peer.add(7)
            retry_sync(peer, addr)
            assert 7 in server.members()
        finally:
            stop.set()
            hog.close()
            t.join(timeout=2.0)


def test_hello_timeout_ctor_param_clamped():
    assert node(0, hello_timeout_s=7.0, conn_timeout_s=3.0) \
        .hello_timeout_s == 3.0
    assert node(0, hello_timeout_s=0.25).hello_timeout_s == 0.25
    assert node(0).hello_timeout_s == Node.HELLO_TIMEOUT_S
    assert node(0, max_conns=3)._conn_slots._value == 3
    assert node(0)._frame_cap == framing.peer_frame_cap(E, A)


def test_recv_exact_restores_socket_timeout():
    a, b = socket.socketpair()
    try:
        a.settimeout(12.5)
        b.sendall(b"xyz")
        assert framing._recv_exact(a, 3, time.monotonic() + 5.0) == b"xyz"
        assert a.gettimeout() == 12.5
        with pytest.raises(socket.timeout):
            framing._recv_exact(a, 1, time.monotonic() - 1.0)
        assert a.gettimeout() == 12.5
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# frames against the JAX package's
# ---------------------------------------------------------------------------


def _sent_bytes(send, msg_type, body):
    a, b = socket.socketpair()
    try:
        n = send(a, msg_type, body)
        a.close()
        data = b""
        while chunk := b.recv(1 << 16):
            data += chunk
        assert n == len(data)
        return data
    finally:
        b.close()


@pytest.mark.parametrize("body_len", [0, 1, 127, 128, 16_383, 16_384, 70_000])
def test_frames_match_jax_byte_for_byte(body_len):
    body = bytes(np.random.default_rng(body_len).integers(
        0, 256, body_len, dtype=np.uint8))
    for msg_type in (framing.MSG_HELLO, framing.MSG_PAYLOAD,
                     framing.MSG_DIGEST):
        got = _sent_bytes(framing.send_frame, msg_type, body)
        assert got == _sent_bytes(jax_framing.send_frame, msg_type, body)
        assert len(got) == framing.frame_size(body_len) == \
            jax_framing.frame_size(body_len)
        a, b = socket.socketpair()
        with a, b:
            b.sendall(got)
            assert framing.recv_frame(a, timeout=5.0) == (msg_type, body)
    assert (framing.MAGIC, framing.MSG_ERROR, framing.MODE_DIGEST) == \
        (jax_framing.MAGIC, jax_framing.MSG_ERROR, jax_framing.MODE_DIGEST)


def test_recv_frame_caps_truncation_and_remote_errors():
    frame = _sent_bytes(framing.send_frame, framing.MSG_PAYLOAD, b"x" * 200)
    for cap in (199, lambda t: 199 if t == framing.MSG_PAYLOAD else 1 << 20):
        a, b = socket.socketpair()
        with a, b:
            b.sendall(frame)
            with pytest.raises(framing.ProtocolError, match="oversized"):
                framing.recv_frame(a, timeout=5.0, max_body=cap)
    a, b = socket.socketpair()
    with a:
        b.sendall(frame[:50])
        b.close()
        with pytest.raises(framing.TruncatedFrame):
            framing.recv_frame(a, timeout=5.0)
    a, b = socket.socketpair()
    with a, b:
        framing.send_frame(b, framing.MSG_ERROR, b"expected HELLO, got 4")
        with pytest.raises(framing.RemoteError, match="expected HELLO"):
            framing.recv_frame(a, timeout=5.0)
    a, b = socket.socketpair()
    with a, b:
        b.sendall(b"\x00\x00\x01\x00")
        with pytest.raises(framing.ProtocolError, match="bad magic"):
            framing.recv_frame(a, timeout=5.0)


def test_hello_bodies_match_jax():
    vv = np.array([0, 1, 127, 128, 0xFFFFFFFF], np.uint32)
    for actor, e in ((0, 1), (4, 1 << 20), (3, 300)):
        body = framing.encode_hello(actor, e, vv)
        assert body == jax_framing.encode_hello(actor, e, vv)
        got_actor, got_vv = framing.decode_hello(body, e, 5)
        assert got_actor == actor and np.array_equal(got_vv, vv)
    body = framing.encode_hello(4, 300, vv)
    for bad, match in (((301, 5), "universe mismatch"),
                       ((300, 4), "actor-axis mismatch"),
                       ((300, 5), "trailing")):
        data = body + b"\x00" if match == "trailing" else body
        with pytest.raises(framing.ProtocolError, match=match):
            framing.decode_hello(data, *bad)
    with pytest.raises(framing.ProtocolError, match="outside actor axis"):
        framing.decode_hello(framing.encode_hello(5, 300, vv), 300, 5)


# ---------------------------------------------------------------------------
# mixed JAX <-> torch pairs over the FULL/DELTA ladder
# ---------------------------------------------------------------------------


def _ops_and_syncs(seed, e):
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(24):
        roll = rng.random()
        who = int(rng.integers(2))
        if roll < 0.45:
            steps.append(("add", who, [int(x) for x in rng.choice(
                e, size=int(rng.integers(1, 4)), replace=False)]))
        elif roll < 0.7:
            steps.append(("delete", who, [int(x) for x in rng.choice(
                e, size=int(rng.integers(1, 3)), replace=False)]))
        else:
            steps.append(("sync", 0, []))
    steps.append(("sync", 0, []))
    return steps


def _drive_pair(client, server, steps):
    stats = []
    with server:
        addr = server.serve()
        for kind, who, ids in steps:
            n = (client, server)[who]
            if kind == "add":
                n.add(*ids)
            elif kind == "delete":
                n.delete(*ids)
            else:
                stats.append(tuple(client.sync_with(addr, timeout=10.0)))
    return stats


@pytest.mark.parametrize("semantics", ["v2", "reference"])
@pytest.mark.parametrize("torch_side", ["client", "server"])
def test_mixed_pair_matches_the_jax_pair(torch_side, semantics):
    """A JAX node and a torch node exchange over real sockets in one
    direction or the other: every exchange's bytes and modes equal those
    of a JAX-only pair on the same steps, and every node's state equals
    its JAX-only counterpart's."""
    e, a = 64, 3
    steps = _ops_and_syncs(11 if semantics == "v2" else 12, e)
    ref = [JaxNode(i, e, a, delta_semantics=semantics) for i in range(2)]
    want = _drive_pair(ref[0], ref[1], steps)
    mixed = [JaxNode(i, e, a, delta_semantics=semantics) for i in range(2)]
    t = 0 if torch_side == "client" else 1
    mixed[t] = Node(t, e, a, delta_semantics=semantics, device="cpu")
    got = _drive_pair(mixed[0], mixed[1], steps)
    assert got == want
    assert_nodes_same(ref[t], mixed[t], f"torch {torch_side}")
    assert np.array_equal(mixed[0].members(), mixed[1].members())


# ---------------------------------------------------------------------------
# tests/test_antientropy.py: breaker, classification, typed errors
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _breaker_script(cls):
    """One scripted run of a breaker with an injected clock: the
    transitions and every allow()/state read, in order."""
    clk, log = FakeClock(), []
    br = cls(failure_threshold=2, cooldown_s=5.0, clock=clk,
             on_transition=lambda o, n: log.append(("to", o, n)))
    script = ["fail", "allow", "ok", "fail", "fail", "allow", ("t", 4.9),
              "allow", ("t", 5.0), "allow", "allow", "fail", ("t", 9.9),
              "allow", ("t", 10.0), "allow", ("t", 15.0), "allow", "ok",
              "allow", "trip", "allow", ("t", 20.0), "allow", "fail",
              "fail"]
    for step in script:
        if step == "fail":
            br.record_failure()
        elif step == "ok":
            br.record_success()
        elif step == "trip":
            br.trip()
        elif step == "allow":
            log.append(("allow", br.allow()))
        else:
            clk.t = step[1]
        log.append((br.state, br.consecutive_failures))
    return log


def test_breaker_transitions_match_jax():
    log = _breaker_script(CircuitBreaker)
    assert log == _breaker_script(jax_antientropy.CircuitBreaker)
    assert ("to", CLOSED, OPEN) in log and ("to", OPEN, HALF_OPEN) in log
    assert ("to", HALF_OPEN, CLOSED) in log
    with pytest.raises(ValueError):
        CircuitBreaker(failure_threshold=0)
    with pytest.raises(ValueError):
        CircuitBreaker(cooldown_s=-1.0)


def test_classification_table():
    cases = [
        (ConnectFailed("refused"), "connect_refused"),
        (PeerTimeout("slow dial", phase="connect"), "connect_timeout"),
        (PeerTimeout("slow hello", phase="hello"), "frame_deadline"),
        (PeerTimeout("slow payload", phase="payload"), "frame_deadline"),
        (PeerReset("torn"), "reset"),
        (PeerProtocolError("bad magic"), "protocol"),
        (framing.ProtocolError("bad magic"), "protocol"),
        (framing.TruncatedFrame("closed mid-frame"), "reset"),
        (framing.RemoteError("universe mismatch"), "remote"),
        (ConnectionResetError("reset by peer"), "reset"),
        (socket.timeout("raw"), "frame_deadline"),
        (OSError("raw dial failure"), "connect_refused"),
        (ValueError("not a sync failure"), "unknown"),
    ]
    for exc, expected in cases:
        assert classify_failure(exc) == expected, (exc, expected)
    assert issubclass(ConnectFailed, OSError) and \
        issubclass(ConnectFailed, SyncError)
    assert issubclass(PeerTimeout, socket.timeout)
    assert issubclass(PeerReset, OSError)
    assert issubclass(PeerProtocolError, framing.ProtocolError)


def test_typed_errors_out_of_sync_with():
    n = node(0)
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    dead = probe.getsockname()[:2]
    probe.close()
    with pytest.raises(ConnectFailed):
        n.sync_with(dead, timeout=2.0)
    silent = socket.create_server(("127.0.0.1", 0))
    try:
        t0 = time.monotonic()
        with pytest.raises(PeerTimeout) as ei:
            n.sync_with(silent.getsockname()[:2], timeout=30.0,
                        hello_timeout_s=0.3)
        assert ei.value.phase == "hello"
        assert time.monotonic() - t0 < 5.0
    finally:
        silent.close()
    srv = socket.create_server(("127.0.0.1", 0))

    def slam():
        conn, _ = srv.accept()
        conn.close()

    t = threading.Thread(target=slam, daemon=True)
    t.start()
    try:
        with pytest.raises(PeerReset):
            n.sync_with(srv.getsockname()[:2], timeout=2.0)
    finally:
        t.join(timeout=2.0)
        srv.close()


# ---------------------------------------------------------------------------
# the supervisor on torch nodes
# ---------------------------------------------------------------------------


def test_supervisor_converges_and_counts():
    rec = Recorder()
    a, b, c = node(0, a=4, recorder=rec), node(1, a=4), node(2, a=4)
    with b, c:
        addrs = [b.serve(), c.serve()]
        a.add(1)
        b.add(2)
        c.add(3)
        sup = SyncSupervisor(a, addrs, policy=FAST, interval_s=0.0,
                             recorder=rec)
        assert sup.sync_round() == {"succeeded": 2, "failed": 0,
                                    "skipped": 0}
        assert set(a.members()) == {1, 2, 3}
        assert rec.counter("sync.successes") == 2
        assert rec.counter("sync.supervisor.rounds") == 1


def test_supervisor_retries_then_opens_breaker_on_dead_peer():
    rec = Recorder()
    a = node(0, recorder=rec)
    dead = ("127.0.0.1", 1)
    sup = SyncSupervisor(a, [dead], policy=FAST, breaker_threshold=2,
                         breaker_cooldown_s=30.0, interval_s=0.0,
                         recorder=rec)
    for _ in range(3):
        sup.sync_round()
    assert rec.counter("sync.failures.connect_refused") >= 4
    assert rec.counter("sync.retries.connect_refused") >= 2
    assert rec.counter("sync.peer_failures") == 2
    assert rec.counter("breaker.to_open") == 1
    assert rec.counter("sync.skipped_open") == 1
    assert sup.breaker(dead).state == OPEN
    assert rec.snapshot()["gauges"]["breaker.state.127.0.0.1:1"] == 1


def test_supervisor_breaker_recovers_and_trips_on_remote_error():
    rec = Recorder()
    a = node(0, recorder=rec)
    a.add(5)
    placeholder = socket.create_server(("127.0.0.1", 0))
    host, port = placeholder.getsockname()[:2]
    placeholder.close()
    sup = SyncSupervisor(a, [(host, port)], policy=FAST, breaker_threshold=1,
                         breaker_cooldown_s=0.05, interval_s=0.0,
                         recorder=rec)
    sup.sync_round()
    assert sup.breaker((host, port)).state == OPEN
    b = node(1)
    with b:
        b.serve(host=host, port=port)
        deadline = time.monotonic() + 10.0
        while sup.breaker((host, port)).state != CLOSED:
            time.sleep(0.06)
            sup.sync_round()
            assert time.monotonic() < deadline, "breaker never recovered"
        assert 5 in b.members()
    wide = node(1, e=2 * E)
    with wide:
        addr = wide.serve()
        rec2 = Recorder()
        sup2 = SyncSupervisor(a, [addr], policy=FAST, breaker_threshold=5,
                              interval_s=0.0, recorder=rec2)
        sup2.sync_round()
        assert rec2.counter("sync.failures.remote") == 1
        assert rec2.counter("sync.retries.remote") == 0
        assert sup2.breaker(addr).state == OPEN


def test_supervisor_run_until_pacing_and_background_thread():
    a, b = node(0), node(1)
    sleeps = []
    with b:
        addr = b.serve()
        b.add(7)
        sup = SyncSupervisor(a, [addr], policy=FAST, interval_s=0.5,
                             sleep=sleeps.append)
        assert sup.run(max_rounds=3, until=lambda: 7 in a.members()) == 1
        assert not sleeps
        sup.run(max_rounds=2)
        assert len(sleeps) == 1 and 0.4 <= sleeps[0] <= 0.6
        with pytest.raises(ValueError):
            sup.run()
        b.add(9)
        bg = SyncSupervisor(a, [addr], policy=FAST, interval_s=0.01)
        bg.start()
        with pytest.raises(RuntimeError):
            bg.start()
        deadline = time.monotonic() + 10.0
        while 9 not in a.members() and time.monotonic() < deadline:
            time.sleep(0.01)
        bg.stop()
        assert 9 in a.members()


def test_supervisor_checkpoint_restart_and_durable_restore(tmp_path):
    ck = str(tmp_path / "node0.ckpt")
    rec = Recorder()
    a, b = node(0, a=4, recorder=rec), node(1, a=4)
    with b:
        addr_b = b.serve()
        a.add(1, 2)
        sup = SyncSupervisor(a, [addr_b], policy=FAST, interval_s=0.0,
                             recorder=rec, checkpoint_path=ck,
                             checkpoint_every=2)
        sup.sync_round()
        sup.sync_round()
        assert rec.counter("sync.checkpoints") == 1
        a.close()
        b.add(3, 4)
        sup2 = SyncSupervisor.restore(ck, [addr_b], policy=FAST,
                                      interval_s=0.0, device="cpu")
        restored = sup2.node
        assert restored.actor == 0 and set(restored.members()) == {1, 2}
        c = node(2, a=4)
        with c:
            assert restored.sync_with(c.serve()).mode_sent == MODE_FULL
        sup2.sync_round()
        assert set(restored.members()) >= {1, 2, 3, 4}

        durable = str(tmp_path / "durable")
        d = node(3, a=4)
        d.add(10)
        sup3 = SyncSupervisor(d, [addr_b], policy=FAST, interval_s=0.0,
                              durable_dir=durable, checkpoint_every=1)
        sup3.sync_round()
        d.add(11)          # logged to the WAL after the checkpoint
        live = d.state_slice()
        d.wal.close()
        sup4 = SyncSupervisor.restore_durable(durable, [addr_b],
                                              policy=FAST, interval_s=0.0,
                                              device="cpu")
        for name, x, y in zip(live._fields, live, sup4.node.state_slice()):
            assert x.dtype == y.dtype and bool((x == y).all()), name
        sup4.node.wal.close()
    with pytest.raises(ValueError, match="alternative"):
        SyncSupervisor(node(0), [], checkpoint_path=ck,
                       durable_dir=durable)


# ---------------------------------------------------------------------------
# utils/backoff.py
# ---------------------------------------------------------------------------


def test_backoff_schedules_match_jax():
    for kw in ({}, {"base_s": 0.01, "multiplier": 3.0, "cap_s": 0.5,
                    "jitter": 0.3, "max_retries": 6},
               {"jitter": 0.0, "max_retries": 0}):
        pol, jpol = BackoffPolicy(**kw), jax_backoff.BackoffPolicy(**kw)
        for seed in (0, 1, 12345):
            assert list(pol.delays(seed)) == list(jpol.delays(seed))
            bo, jbo = backoff.Backoff(pol, seed), jax_backoff.Backoff(jpol,
                                                                     seed)
            seq = [bo.next_delay() for _ in range(pol.max_retries + 2)]
            assert seq == [jbo.next_delay()
                           for _ in range(pol.max_retries + 2)]
            assert seq[-1] is None and bo.attempt == pol.max_retries
            bo.reset()
            assert [bo.next_delay() for _ in range(pol.max_retries)] == \
                seq[:pol.max_retries]
    for bad in ({"base_s": -1}, {"multiplier": 0.5}, {"jitter": 1.0},
                {"max_retries": -1}):
        with pytest.raises(ValueError):
            BackoffPolicy(**bad)


def test_retry_call_budget():
    sleeps, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("transient")
        return "done"

    pol = BackoffPolicy(max_retries=3, jitter=0.0)
    assert backoff.retry_call(flaky, pol, sleep=sleeps.append) == "done"
    assert sleeps == [pol.nominal(0), pol.nominal(1)]

    def dead():
        raise ConnectionError("down")

    with pytest.raises(ConnectionError):
        backoff.retry_call(dead, BackoffPolicy(max_retries=2),
                           sleep=lambda s: None)
    with pytest.raises(ValueError):
        backoff.retry_call(lambda: int("x"), pol, sleep=lambda s: None)
