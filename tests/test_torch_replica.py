"""The port's shard replication (shard/replica.py): the scenarios of
tests/test_replica.py that need no router, replayed on torch frontends
(CPU): shard-epoch files, the semi-synchronous ``ReplicationPublisher``
gate, the WAL_SYNC verb (tail, truncation and digest catch-up, the
deposition claim), the batcher's gate riding a live standby, and the
``ShardStandby`` state machine (tail to a bitwise mirror, promote,
nonce reset, the never-tailed guard); plus a torch standby tailing a
JAX primary to a bitwise mirror, and shard/ring.py routing as the
reference's.  The router's half (the failover adjudication) is not
ported."""

import os
import socket
import threading
import time

import numpy as np
import pytest

from go_crdt_playground_tpu.serve.frontend import \
    ServeFrontend as JaxFrontend
from go_crdt_playground_tpu_torch.net.peer import Node
from go_crdt_playground_tpu_torch.obs import Recorder
from go_crdt_playground_tpu_torch.serve import protocol
from go_crdt_playground_tpu_torch.serve.client import ServeClient
from go_crdt_playground_tpu_torch.serve.frontend import ServeFrontend
from go_crdt_playground_tpu_torch.shard.replica import (
    POLL_CAUGHT_UP, POLL_FAILED, POLL_PROMOTED, POLL_TAILED,
    ReplicationPublisher, ShardStandby, load_shard_epoch,
    load_shard_epoch_seen, persist_shard_epoch)
from tests.test_torch_net import prompt_jax_close  # noqa: F401 (autouse)

E, A = 48, 4


def _frontend(dirpath, *, actor=0, sid="s0", epoch=0, cls=None):
    kw = dict(actor=actor, durable_dir=str(dirpath), max_batch=4,
              flush_ms=1.0, shard_id=sid, shard_epoch=epoch,
              repl_ack_timeout_ms=150.0)
    if cls is not None:
        return cls(E, A, **kw)
    return ServeFrontend(E, A, device="cpu", **kw)


def _full_slice(node) -> bytes:
    return node.extract_slice(np.ones(E, bool))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Wal:
    def __init__(self, n=1):
        self.n = n

    def next_seq(self):
        return self.n


def test_shard_epoch_file_roundtrip(tmp_path):
    d = str(tmp_path)
    assert load_shard_epoch(d) == 0 and load_shard_epoch_seen(d) == 0
    assert load_shard_epoch(None) == 0
    persist_shard_epoch(d, 3, "s0-standby")
    assert load_shard_epoch(d) == 3
    assert load_shard_epoch_seen(d) == 3  # seen >= own always
    persist_shard_epoch(d, 3, "s0", seen=7)
    assert load_shard_epoch(d) == 3 and load_shard_epoch_seen(d) == 7
    with open(os.path.join(d, "shard_epoch.json"), "w") as f:
        f.write("not json")
    assert load_shard_epoch(d) == 0


def test_publisher_gate_no_standby_is_transparent():
    p = ReplicationPublisher(ack_timeout_s=0.05)
    assert p.gate(_Wal(5)) is True          # dormant: pre-HA ack path
    assert p.gate(None) is True             # non-durable target
    assert p.window.windows == 0
    p.note_poll("", 99)                     # anonymous: not enrolled
    assert not p.has_standby()


def test_publisher_gate_waits_for_cursor_then_degrades():
    rec = Recorder()
    p = ReplicationPublisher(rec, ack_timeout_s=0.2, degrade_retry_s=0.15)
    wal = _Wal(4)
    p.note_poll("sb", 1)

    def late_ack():
        time.sleep(0.05)
        p.note_poll("sb", 4)

    t = threading.Thread(target=late_ack)
    t.start()
    assert p.gate(wal) is True              # woken by the ack
    t.join()
    assert p.window.windows == 0
    wal.n = 9
    t0 = time.monotonic()
    assert p.gate(wal) is False             # silent standby: degrade
    assert time.monotonic() - t0 >= 0.15
    assert p.window.active()
    assert rec.snapshot()["counters"]["repl.degraded_windows"] == 1
    t0 = time.monotonic()
    assert p.gate(wal) is False             # degraded: immediate
    assert time.monotonic() - t0 < 0.1
    time.sleep(0.2)
    p.note_poll("sb", 9)
    assert p.gate(wal) is True              # the probe heals it
    assert not p.window.armed_ever()
    snap = rec.snapshot()["counters"]
    assert snap["repl.heals"] == 1 and snap["repl.degraded_windows"] == 1


def test_publisher_waits_for_slowest_live_standby(monkeypatch):
    p = ReplicationPublisher(ack_timeout_s=0.05)
    p.note_poll("sb1", 9)
    p.note_poll("sb2", 3)
    wal = _Wal(9)
    assert p.lag_records(wal.next_seq()) == 6
    assert p.gate(wal) is False
    monkeypatch.setattr(ReplicationPublisher, "STALE_AFTER_S", 0.0)
    p.window.clear()
    assert p.lag_records(wal.next_seq()) == 0
    assert set(p.snapshot()["standbys"]) == {"sb1", "sb2"}
    t0 = time.monotonic()
    assert p.gate(wal) is False             # no live member: no wait
    assert time.monotonic() - t0 < 1.0


@pytest.fixture(scope="module")
def primary(tmp_path_factory):
    fe = _frontend(tmp_path_factory.mktemp("primary"), epoch=1)
    addr = fe.serve(port=0)
    client = ServeClient(addr, timeout=10.0)
    for e in range(10):
        client.add(e)
    client.delete(3)
    yield fe, addr, client
    client.close()
    fe.close()


def test_wal_sync_tail_serves_records_and_acks(primary):
    fe, addr, client = primary
    r = client.wal_sync(1, standby_id="t-ack")
    assert r.shard_epoch == 1 and r.shard_id == "s0"
    assert r.first_seq == 1 and len(r.records) >= 11
    assert r.next_seq == r.first_seq + len(r.records)
    assert r.min_seq == 1 and r.flags == 0 and r.payload is None
    assert fe.repl.snapshot()["standbys"]["t-ack"]["acked_seq"] == 1
    r2 = client.wal_sync(r.next_seq, standby_id="t-ack")
    assert r2.records == () and r2.next_seq == r.next_seq
    assert fe.repl.snapshot()["standbys"]["t-ack"]["acked_seq"] == \
        r.next_seq
    assert r2.nonce == r.nonce
    r3 = client.wal_sync(r.next_seq + 1000, standby_id="t-ack")
    assert r3.flags & protocol.WAL_TRUNCATED and r3.records == ()


def test_wal_sync_truncation_then_digest_catchup(primary):
    from go_crdt_playground_tpu_torch.net import digestsync

    fe, addr, client = primary
    fe.supervisor.checkpoint()
    r = client.wal_sync(1, standby_id="t-cu")
    assert r.flags & protocol.WAL_TRUNCATED and r.min_seq > 1
    scratch = Node(0, E, A, device="cpu")
    rc = client.wal_sync(r.next_seq, standby_id="t-cu",
                         summary=digestsync.node_summary(scratch))
    assert rc.payload is not None
    assert rc.flags & protocol.WAL_CATCHUP_PAYLOAD
    scratch.apply_payload_body(rc.payload)
    assert _full_slice(scratch) == _full_slice(fe.node)
    assert rc.next_seq >= r.min_seq


def test_wal_sync_epoch_claim_deposes_writes_not_reads(tmp_path):
    fe = _frontend(tmp_path / "dep", epoch=1)
    addr = fe.serve(port=0)
    with ServeClient(addr, timeout=10.0) as c:
        c.add(1, 2)
        assert not fe.shard_deposed
        assert c.wal_sync(1, epoch=4, standby_id="sb").shard_epoch == 1
        assert fe.shard_deposed
        with pytest.raises(protocol.StaleShardEpoch):
            c.add(5)
        members, _vv = c.members()  # reads keep serving
        assert set(int(e) for e in members) == {1, 2}
        with pytest.raises(protocol.StaleShardEpoch):
            c.wal_sync(1, epoch=2, standby_id="older")
    fe.close()
    fe2 = _frontend(tmp_path / "dep", epoch=1)
    assert fe2.shard_deposed  # the adjudication persisted
    fe2.close()


def test_batcher_gate_rides_live_standby(tmp_path):
    fe = _frontend(tmp_path / "gate", epoch=1)
    addr = fe.serve(port=0)
    client = ServeClient(addr, timeout=10.0)
    stop = threading.Event()

    def tail():
        with ServeClient(addr, timeout=5.0) as tc:
            cursor = tc.wal_sync(1, standby_id="live-sb").next_seq
            while not stop.is_set():
                cursor = tc.wal_sync(cursor, standby_id="live-sb",
                                     wait_ms=50).next_seq

    t = threading.Thread(target=tail, daemon=True)
    t.start()
    time.sleep(0.05)
    windows_before = fe.repl.window.windows
    for e in range(20, 30):
        client.add(e)
    stop.set()
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert fe.repl.window.windows == windows_before
    assert fe.repl.snapshot()["standbys"]["live-sb"]["acked_seq"] > 1
    client.close()
    fe.close()


@pytest.mark.parametrize("primary_pkg", ["torch", "jax"])
def test_standby_tails_to_a_mirror_and_promotes(tmp_path, primary_pkg):
    """A torch standby tails a primary of either package to a bitwise
    mirror; the primary dies, the polls cross the threshold, the
    standby promotes under epoch tailed + 1 (no router to announce to)
    and serves every acked op."""
    p_dir = tmp_path / "p0"
    fe = _frontend(p_dir, epoch=1,
                   cls=JaxFrontend if primary_pkg == "jax" else None)
    a0 = fe.serve(port=0)
    with ServeClient(a0, timeout=10.0) as c:
        for e in range(14):
            c.add(e)
        c.delete(2, 7)
    sfe = _frontend(tmp_path / "sb")
    port = _free_port()
    sb = ShardStandby(a0, sfe, sid="s0", standby_id="s0-standby",
                      listen_addr=("127.0.0.1", port), poll_interval_s=0.02,
                      failure_threshold=2, wait_ms=50)
    try:
        assert sb.poll_once() == POLL_TAILED and sb.tailed_ever
        assert _full_slice(sfe.node) == _full_slice(fe.node)
        fe.close()
        verdicts = [sb.poll_once(), sb.poll_once()]
        assert verdicts[-1] == POLL_PROMOTED, verdicts
        assert sb.promoted and sb.promote_reason
        assert load_shard_epoch(str(tmp_path / "sb")) == 2
        restored = Node.restore_durable(str(p_dir), device="cpu")
        assert _full_slice(restored) == _full_slice(sfe.node)
        restored.wal.close()
        with ServeClient(("127.0.0.1", port), timeout=10.0) as c:
            c.add(30)
            members, _vv = c.members()
        assert set(int(m) for m in members) == \
            set(range(14)) - {2, 7} | {30}
    finally:
        sb.close()


@pytest.mark.parametrize("primary_pkg", ["torch", "jax"])
def test_standby_catch_up_state_equals_the_reference_standby(tmp_path,
                                                             primary_pkg):
    """A torch standby and a JAX standby catch up by digest from the
    same truncated primary, then tail it: their whole replica states
    (membership, dots, deletion lanes, vv, processed) are equal field
    by field after the catch-up and after the tail, not only their
    universe slices."""
    from go_crdt_playground_tpu.shard.replica import \
        ShardStandby as JaxStandby
    from tests.test_torch_ingest import assert_same

    fe = _frontend(tmp_path / "p0", epoch=1,
                   cls=JaxFrontend if primary_pkg == "jax" else None)
    a0 = fe.serve(port=0)
    client = ServeClient(a0, timeout=10.0)
    for e in range(0, 14, 2):
        client.add(e, e + 1)
    client.delete(2, 7, 9)
    fe.supervisor.checkpoint()  # the WAL under cursor 1 is gone
    client.add(20, 2)
    client.delete(4)
    sfe = _frontend(tmp_path / "sb")
    jsfe = _frontend(tmp_path / "jsb", cls=JaxFrontend)
    sb = ShardStandby(a0, sfe, sid="s0", standby_id="torch-sb",
                      poll_interval_s=0.02, failure_threshold=99,
                      wait_ms=20)
    jsb = JaxStandby(a0, jsfe, sid="s0", standby_id="jax-sb",
                     poll_interval_s=0.02, failure_threshold=99,
                     wait_ms=20)
    try:
        for standby in (sb, jsb):
            verdicts = [standby.poll_once() for _ in range(3)]
            assert POLL_CAUGHT_UP in verdicts, verdicts
            assert standby.cursor == sb.cursor
        assert_same(jsfe.node.state_slice(), sfe.node.state_slice(),
                    "after the catch-up")
        assert _full_slice(sfe.node) == _full_slice(fe.node)
        client.add(31, 4, 7)
        client.delete(0, 20)
        for standby in (sb, jsb):
            assert standby.poll_once() == POLL_TAILED
        assert jsb.cursor == sb.cursor
        assert_same(jsfe.node.state_slice(), sfe.node.state_slice(),
                    "after the tail")
        assert _full_slice(sfe.node) == _full_slice(fe.node)
    finally:
        client.close()
        sb.close()
        jsb.close()
        fe.close()


def test_standby_nonce_reset_catches_primary_restart(tmp_path):
    port = _free_port()
    p_dir = tmp_path / "p"
    fe1 = _frontend(p_dir, epoch=1)
    fe1.serve(port=port)
    with ServeClient(("127.0.0.1", port), timeout=10.0) as c:
        for e in range(6):
            c.add(e)
    sfe = _frontend(tmp_path / "sb")
    sb = ShardStandby(("127.0.0.1", port), sfe, sid="s0",
                      poll_interval_s=0.02, failure_threshold=99,
                      wait_ms=20)
    assert sb.poll_once() == POLL_TAILED
    assert sb.cursor > 1
    fe1.close()
    assert sb.poll_once() == POLL_FAILED
    fe2 = _frontend(p_dir, epoch=1)
    fe2.serve(port=port)
    with ServeClient(("127.0.0.1", port), timeout=10.0) as c:
        c.add(40)
    v1 = sb.poll_once()          # detects the nonce change, resets
    v2 = sb.poll_once()          # ...and catches up O(diff)
    assert POLL_CAUGHT_UP in (v1, v2), (v1, v2)
    assert _full_slice(sfe.node) == _full_slice(fe2.node)
    sb.close()
    fe2.close()


def test_standby_never_tailed_blocks_promotion(tmp_path):
    sfe = _frontend(tmp_path / "sb")
    sb = ShardStandby(("127.0.0.1", 1), sfe, sid="s0", poll_interval_s=0.01,
                      failure_threshold=2, poll_timeout_s=0.2)
    assert sb.poll_once() == POLL_FAILED
    assert sb.poll_once() == POLL_FAILED  # threshold crossed, blocked
    assert not sb.promoted
    assert sfe.recorder.snapshot()["counters"]["repl.promote_blocked"] >= 1
    sb.close()


@pytest.mark.parametrize("seed", [0, 5, 1 << 40])
def test_hash_ring_routes_as_the_reference(seed):
    """The port's shard/ring.py routes every element as the JAX
    package's does: owner maps, digests, a join's handoff plan and remap
    fraction, load stats."""
    from go_crdt_playground_tpu.shard import ring as jax_ring
    from go_crdt_playground_tpu_torch.shard import ring

    n = E * 4
    shards = ["s2", "s0", "s1"]
    port, ref = ring.HashRing(shards, seed), jax_ring.HashRing(shards, seed)
    before = port.owner_map(n)
    assert np.array_equal(before, ref.owner_map(n))
    assert port.digest(n) == ref.digest(n)
    port2, ref2 = port.with_shard("s3"), ref.with_shard("s3")
    after = port2.owner_map(n)
    assert np.array_equal(after, ref2.owner_map(n))
    args = (before, after, port.shards, port2.shards)
    assert ring.handoff_plan(*args) == jax_ring.handoff_plan(*args)
    assert ring.remap_fraction(*args) == jax_ring.remap_fraction(*args)
    assert ring.load_stats(before, 3) == jax_ring.load_stats(before, 3)
    assert port2.without_shard("s3").digest(n) == port.digest(n)
