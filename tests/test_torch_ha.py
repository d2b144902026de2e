"""Router HA in the port (shard/ha.py): tests/test_ha.py's scenarios on
the port's router, standby router, frontends and client, then the two
packages mixed: each package's standby tails the other's primary and
promotes, the RING_SYNC bodies are equal byte for byte, and a deposed
primary's write is refused typed and never applied.

In process, on 127.0.0.1, torch frontends on the CPU
(``device="cpu"``); the standby state machine is driven through its
``poll_once`` seam, so no assertion waits on a sleep.
"""

import os
import socket
import threading

import pytest

from go_crdt_playground_tpu_torch.serve import protocol
from go_crdt_playground_tpu_torch.serve.client import AmbiguousOp, ServeClient
from go_crdt_playground_tpu_torch.serve.frontend import ServeFrontend
from go_crdt_playground_tpu_torch.shard.fleet import free_port
from go_crdt_playground_tpu_torch.shard.ha import (POLL_FAILED, POLL_PROMOTED,
                                             POLL_TAILED, RouterStandby)
from go_crdt_playground_tpu_torch.shard.handoff import (load_router_epoch,
                                                  persist_router_epoch)
from go_crdt_playground_tpu_torch.shard.router import ShardRouter
from tests.test_torch_net import prompt_jax_close  # noqa: F401 (autouse)

E, A = 16, 2


def _addr(fe):
    return fe.addr


# ---------------------------------------------------------------------------
# wire + persistence plumbing
# ---------------------------------------------------------------------------


def test_ring_sync_codec_roundtrip():
    body = protocol.encode_ring_sync(7, 3, "router-a")
    assert protocol.decode_ring_sync(body) == (7, 3, "router-a")
    with pytest.raises(ValueError):
        protocol.encode_ring_sync(1, -1, "x")
    rec = {"router_epoch": 9, "generation": 2, "shards": {"s0": ["h", 1]}}
    rid, got = protocol.decode_ring_sync_reply(
        protocol.encode_ring_sync_reply(5, rec))
    assert rid == 5 and got == rec
    from go_crdt_playground_tpu_torch.net.framing import ProtocolError
    with pytest.raises(ProtocolError):
        protocol.decode_ring_sync(body + b"\x00")
    with pytest.raises(ProtocolError):
        protocol.decode_ring_sync_reply(
            protocol.encode_ring_sync_reply(5, rec)[:3])


def test_router_epoch_file_roundtrip(tmp_path):
    d = str(tmp_path)
    assert load_router_epoch(d) == 0
    assert load_router_epoch(None) == 0
    persist_router_epoch(d, 4, "router-b")
    assert load_router_epoch(d) == 4
    # garbage reads as absent, never raises
    with open(os.path.join(d, "router_epoch.json"), "w") as f:
        f.write("{torn")
    assert load_router_epoch(d) == 0


def test_wal_append_errors_counter(tmp_path):
    """Satellite: an OSError in the WAL write path is counted at the
    site (wal.append_errors) and re-raised for the serving layer to
    classify typed."""
    from go_crdt_playground_tpu_torch.obs import Recorder
    from go_crdt_playground_tpu_torch.utils.wal import DeltaWal

    rec = Recorder()
    wal = DeltaWal(str(tmp_path / "wal"), fsync=False, recorder=rec)

    class _Enospc:
        def write(self, data):
            raise OSError(28, "No space left on device")

        def flush(self):
            pass

        def tell(self):
            return 0

        def close(self):
            pass

        def fileno(self):
            return -1

    with wal._lock:
        wal._file = _Enospc()
    with pytest.raises(OSError):
        wal.append(b"doomed")
    snap = rec.snapshot()["counters"]
    assert snap["wal.append_errors"] == 1
    assert "wal.appends" not in snap


def test_wal_heals_torn_tail_before_probe_append(tmp_path):
    """A failed append can leave a PARTIAL record on disk; the degrade
    window's probe append must not land (and be acked) beyond it —
    recovery's prefix rule stops at the first tear, so everything acked
    after it would be silently dropped on restart.  append() heals the
    tail (truncate to the known-good end, reopen) before the next byte
    lands."""
    from go_crdt_playground_tpu_torch.obs import Recorder
    from go_crdt_playground_tpu_torch.utils.wal import DeltaWal

    rec = Recorder()
    path = str(tmp_path / "wal")
    wal = DeltaWal(path, fsync=False, recorder=rec)
    wal.append(b"acked-before")

    class _TornEnospc:
        """Writes HALF the record, then fails — the torn-mid-record
        shape a real ENOSPC/EIO leaves behind."""

        def __init__(self, f):
            self._f = f

        def write(self, data):
            self._f.write(data[:len(data) // 2])
            self._f.flush()
            raise OSError(28, "No space left on device")

        def __getattr__(self, name):
            return getattr(self._f, name)

    with wal._lock:
        wal._file = _TornEnospc(wal._file)
    with pytest.raises(OSError):
        wal.append(b"doomed-unacked")
    # the disk heals; the probe append repairs the tear FIRST, so its
    # record is readable — in-process and after a restart
    wal.append(b"acked-probe")
    assert list(wal.records()) == [b"acked-before", b"acked-probe"]
    snap = rec.snapshot()["counters"]
    assert snap["wal.tail_repairs"] == 1
    assert snap["wal.append_errors"] == 1
    wal.close()
    wal2 = DeltaWal(path, fsync=False)
    try:
        assert list(wal2.records()) == [b"acked-before", b"acked-probe"]
        # the in-process heal already trimmed the tear: open-time
        # repair found nothing left to do
        assert not wal2.torn_tail_repaired
    finally:
        wal2.close()


def test_wal_reopen_failure_stays_retryable_not_closed(tmp_path):
    """A transient OSError while opening the fresh segment (truncate's
    reset, a rotation) must leave the log retryable-degraded — the
    next append heals it, including the directory fsync for a segment
    that was never created — not wedged as 'closed' (a ValueError
    would escape the serving layer's typed OSError classification)."""
    from go_crdt_playground_tpu_torch.obs import Recorder
    from go_crdt_playground_tpu_torch.utils.wal import DeltaWal

    rec = Recorder()
    wal = DeltaWal(str(tmp_path / "wal"), fsync=False, recorder=rec)
    wal.append(b"pre-truncate")
    orig = wal._open_segment

    def flaky(seq, fresh):
        raise OSError(5, "Input/output error")

    wal._open_segment = flaky
    with pytest.raises(OSError):
        wal.truncate()
    wal._open_segment = orig
    wal.append(b"post-heal")  # heals: fresh segment, dir fsync'd
    assert list(wal.records()) == [b"post-heal"]
    snap = rec.snapshot()["counters"]
    assert snap["wal.tail_repairs"] == 1
    wal.close()


def test_wal_truncate_reclaims_despite_dirty_buffer(tmp_path):
    """truncate() IS the disk-space reclaim after a checkpoint: on a
    FULL disk the poisoned buffer's implicit flush re-raises ENOSPC at
    close — truncate must swallow that and still unlink (unlinking
    needs no free space, and every buffered byte is about to go)."""
    from go_crdt_playground_tpu_torch.utils.wal import DeltaWal

    wal = DeltaWal(str(tmp_path / "wal"), fsync=False)
    wal.append(b"checkpointed")

    class _FullDisk:
        def write(self, data):
            raise OSError(28, "No space left on device")

        def close(self):
            raise OSError(28, "No space left on device")

        def __getattr__(self, name):
            raise AssertionError(f"unexpected {name} on full disk")

    with wal._lock:
        real, wal._file = wal._file, _FullDisk()
    real.close()
    with pytest.raises(OSError):
        wal.append(b"doomed")
    wal.truncate()  # reclaim proceeds past the re-raising close
    wal.append(b"post-reclaim")
    assert list(wal.records()) == [b"post-reclaim"]
    wal.close()


# ---------------------------------------------------------------------------
# shard-side fence adjudication
# ---------------------------------------------------------------------------


def test_frontend_epoch_adjudication(tmp_path):
    """The shard half of the fence: adopt-and-persist higher epochs,
    reject stale claims typed, fence every admin verb for lower (or
    missing) announcements, stay dormant with no epoch ever seen."""
    fe = ServeFrontend(E, A, device="cpu", durable_dir=str(tmp_path / "n0"),
                       flush_ms=0.5)
    fe.serve()
    try:
        with ServeClient(_addr(fe)) as legacy:
            # fence dormant: an unannounced admin verb works (pre-HA)
            assert legacy.slice_pull([0, 1])
            # adopt epoch 5 (persisted), acked with the record
            with ServeClient(_addr(fe)) as c5:
                rec = c5.ring_sync(5, "router-a")
                assert rec["router_epoch"] == 5
                # a stale claim rejects typed
                with ServeClient(_addr(fe)) as c4:
                    with pytest.raises(protocol.StaleRouterEpoch):
                        c4.ring_sync(4, "router-old")
                    # ... and its admin verbs are fenced too
                    with pytest.raises(protocol.StaleRouterEpoch):
                        c4.slice_pull([0])
                # once a fence exists, a NEVER-announced connection is
                # fenced as well (a deposed pre-announce code path)
                with pytest.raises(protocol.StaleRouterEpoch):
                    legacy.slice_pull([0])
                with pytest.raises(protocol.StaleRouterEpoch):
                    legacy.frontier()
                with pytest.raises(protocol.StaleRouterEpoch):
                    import numpy as np

                    legacy.gc(np.zeros(A, np.uint32))
                # the announced-current connection keeps working
                assert c5.slice_pull([0, 1])
                # reads are NEVER fenced (serve-through-degradation)
                members, _vv = legacy.members()
                assert members == []
        assert load_router_epoch(str(tmp_path / "n0")) == 5
        snap = fe.recorder.snapshot()["counters"]
        assert snap["serve.router_epoch.adopted"] == 1
        assert snap["serve.rejects.stale_epoch"] >= 4
    finally:
        fe.close()


def test_frontend_epoch_survives_restart(tmp_path):
    """The fence is durable: a restarted shard still rejects the old
    epoch (a deposed primary cannot wait out a shard crash)."""
    d = str(tmp_path / "n0")
    fe = ServeFrontend(E, A, device="cpu", durable_dir=d, flush_ms=0.5)
    fe.serve()
    try:
        with ServeClient(_addr(fe)) as c:
            c.ring_sync(3, "router-b")
    finally:
        fe.close()
    fe2 = ServeFrontend(E, A, device="cpu", durable_dir=d, flush_ms=0.5)
    fe2.serve()
    try:
        with ServeClient(_addr(fe2)) as c:
            with pytest.raises(protocol.StaleRouterEpoch):
                c.ring_sync(2, "router-a")
            assert c.ring_sync(3, "router-b")["router_epoch"] == 3
    finally:
        fe2.close()


# ---------------------------------------------------------------------------
# router-side record + self-fence
# ---------------------------------------------------------------------------


def test_router_ring_record_and_self_fence(tmp_path):
    fe = ServeFrontend(E, A, device="cpu", flush_ms=0.5)
    fe.serve()
    router = ShardRouter({"s0": _addr(fe)}, E, seed=3,
                         state_dir=str(tmp_path / "router"),
                         router_epoch=1, router_id="router-a")
    addr = router.serve()
    try:
        with ServeClient(addr) as c:
            # the tail read: committed RouteState + epoch, addresses in
            rec = c.ring_sync(0, "standby")
            assert rec["router_epoch"] == 1
            assert rec["generation"] == 0
            assert rec["shards"] == {"s0": list(_addr(fe))}
            assert rec["elements"] == E and rec["seed"] == 3
            c.add(1)  # data plane serving normally
            # a higher claim arms the self-fence ...
            assert c.ring_sync(2, "router-b")["max_epoch_seen"] == 2
            assert router.deposed
            # ... RESHARD refuses typed with the reason
            ok, detail = c.reshard(protocol.RESHARD_LEAVE, "s0")
            assert not ok and "StaleRouterEpoch" in detail["reason"]
            # ... fleet GC refuses
            assert router.run_fleet_gc()["pushed"] is False
            # ... and the data plane sheds typed (stale-ring hazard)
            with pytest.raises(protocol.StaleRouterEpoch):
                c.add(2)
            # ... and the refused write was never applied
            assert fe.node.members().tolist() == [1]
            # a STALE claim (below the max seen) rejects typed
            with ServeClient(addr) as c1:
                with pytest.raises(protocol.StaleRouterEpoch):
                    c1.ring_sync(1, "router-a-again")
            # reads keep serving through deposition
            members, _ = c.members()
            assert 1 in members
        snap = router.recorder.snapshot()["counters"]
        assert snap["router.shed.deposed"] >= 1
        assert snap["router.reshard.deposed"] == 1
    finally:
        router.close()
        fe.close()


def test_epoch_zero_primary_restart_self_fences(tmp_path):
    """Resurrection containment without ``--router-epoch``: a primary
    left at the DEFAULT epoch 0 but given a state_dir still runs the
    serve()-time discovery probe (an epoch-0 RING_SYNC is a pure read),
    hears the promoted epoch from the shards, and starts life deposed —
    data plane sheds typed, reads keep serving."""
    shard_dir = str(tmp_path / "s0")
    fe = ServeFrontend(E, A, device="cpu", durable_dir=shard_dir, flush_ms=0.5)
    fe.serve()
    try:
        # a standby promoted to epoch 2 while this primary was dead
        with ServeClient(_addr(fe)) as c:
            c.ring_sync(2, "router-b")
        router = ShardRouter({"s0": _addr(fe)}, E,
                             state_dir=str(tmp_path / "router-a"),
                             router_id="router-a")  # epoch defaults to 0
        addr = router.serve()
        try:
            assert router.deposed
            with ServeClient(addr) as c:
                with pytest.raises(protocol.StaleRouterEpoch):
                    c.add(1)
                members, _ = c.members()  # reads serve through it
                assert members == []
            snap = router.recorder.snapshot()["counters"]
            assert snap["router.shed.deposed"] >= 1
        finally:
            router.close()
    finally:
        fe.close()


# ---------------------------------------------------------------------------
# the standby state machine (poll_once seam — no wall-clock waits)
# ---------------------------------------------------------------------------


def test_standby_tail_promote_and_fence(tmp_path):
    fe = ServeFrontend(E, A, device="cpu", durable_dir=str(tmp_path / "s0"),
                       flush_ms=0.5)
    fe.serve()
    primary_state = str(tmp_path / "router-a")
    standby_state = str(tmp_path / "router-b")
    primary = ShardRouter({"s0": _addr(fe)}, E, seed=7,
                          state_dir=primary_state,
                          router_epoch=1, router_id="router-a")
    primary_addr = primary.serve()
    standby_port = free_port()
    standby = RouterStandby(
        primary_addr, {"s0": _addr(fe)}, E, seed=7,
        state_dir=standby_state, standby_id="router-b",
        listen_addr=("127.0.0.1", standby_port),
        failure_threshold=2)
    try:
        with ServeClient(primary_addr) as c:
            c.add(3)
        # tail: the committed ring lands in the standby's state_dir
        assert standby.poll_once() == POLL_TAILED
        rec = standby.last_record
        assert rec["router_epoch"] == 1 and rec["generation"] == 0
        from go_crdt_playground_tpu_torch.shard.handoff import load_ring_file
        ring_rec = load_ring_file(standby_state)
        assert ring_rec["phase"] == "committed"
        assert ring_rec["shards"] == {"s0": list(_addr(fe))}
        # primary dies: below threshold first, then promote
        primary.close()
        assert standby.poll_once() == POLL_FAILED
        assert not standby.promoted
        assert standby.poll_once() == POLL_PROMOTED
        assert standby.promoted and standby.router is not None
        assert standby.promotion_s is not None
        promoted = standby.router
        # the promoted router adopted the TAILED committed ring under
        # the bumped persisted epoch
        assert promoted.router_epoch == 2
        assert load_router_epoch(standby_state) == 2
        assert promoted.route().generation == 0
        # the shard adjudicated the new epoch at promotion
        assert standby.announce_results == {"s0": True}
        assert load_router_epoch(str(tmp_path / "s0")) == 2
        # an HA client rides through: ordered list [dead primary,
        # standby] — reads rotate transparently, writes ack, and the
        # acked state from the old primary is still served
        with ServeClient([primary_addr,
                          ("127.0.0.1", standby_port)]) as hc:
            members, _ = hc.members()
            assert 3 in members
            hc.add(5)
            members, _ = hc.members()
            assert {3, 5} <= set(members)
            assert hc.active_addr == ("127.0.0.1", standby_port)
        # actuator re-resolution: the ordered list reads the promoted
        # router's ring state
        from go_crdt_playground_tpu_torch.control.actuator import \
            ReshardActuator
        act = ReshardActuator(
            [primary_addr, ("127.0.0.1", standby_port)])
        gen, shards = act._ring_state()
        assert gen == 0 and shards == ("s0",)
    finally:
        standby.close()
        fe.close()


def test_standby_never_tailed_never_promotes(tmp_path):
    """The epoch-collision guard: a standby that has NEVER tailed the
    primary holds neither its committed ring nor its epoch — promoting
    would serve the flag ring under an epoch that can collide with the
    primary's own (equal epochs adjudicate as current: no fence).  It
    must keep polling instead, however many failures accumulate."""
    dead = ("127.0.0.1", free_port())  # nothing ever listened here
    standby = RouterStandby(dead, {"s0": ("127.0.0.1", 1)}, E,
                            state_dir=str(tmp_path / "b"),
                            failure_threshold=2, poll_timeout_s=0.5)
    try:
        for _ in range(5):
            assert standby.poll_once() == POLL_FAILED
        assert not standby.promoted and standby.router is None
        snap = standby.recorder.snapshot()["counters"]
        assert snap["router.ha.promote_blocked"] >= 3
        assert "router.ha.promotions" not in snap
    finally:
        standby.close()


def test_standby_does_not_promote_while_primary_healthy(tmp_path):
    fe = ServeFrontend(E, A, device="cpu", flush_ms=0.5)
    fe.serve()
    primary = ShardRouter({"s0": _addr(fe)}, E, seed=1,
                          router_epoch=1, router_id="router-a")
    primary_addr = primary.serve()
    standby = RouterStandby(primary_addr, {"s0": _addr(fe)}, E, seed=1,
                            state_dir=str(tmp_path / "b"),
                            failure_threshold=2)
    try:
        for _ in range(4):
            assert standby.poll_once() == POLL_TAILED
        assert not standby.promoted
        snap = standby.recorder.snapshot()["counters"]
        assert snap["router.ha.polls"] == 4
        assert "router.ha.promotions" not in snap
    finally:
        standby.close()
        primary.close()
        fe.close()


def test_promote_is_single_entry(tmp_path):
    """A manual promote() racing the poll loop (or a second retry) must
    never build TWO routers: with listen_addr=None (embedded use) both
    would survive and one would leak its shard links and reader
    threads.  The promotion lock serializes the whole sequence; the
    loser returns the winner's router."""
    fe = ServeFrontend(E, A, device="cpu", durable_dir=str(tmp_path / "s0"),
                       flush_ms=0.5)
    fe.serve()
    standby = RouterStandby(("127.0.0.1", free_port()),
                            {"s0": _addr(fe)}, E,
                            state_dir=str(tmp_path / "b"),
                            standby_id="router-b")
    routers = []
    barrier = threading.Barrier(2)

    def race():
        barrier.wait()
        routers.append(standby.promote(reason="race"))

    try:
        threads = [threading.Thread(target=race) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        assert len(routers) == 2
        assert routers[0] is routers[1]
        assert standby.router is routers[0]
        snap = standby.recorder.snapshot()["counters"]
        assert snap["router.ha.promotions"] == 1
    finally:
        standby.close()
        fe.close()


def test_standby_warns_on_epoch_zero_primary(tmp_path):
    """The fence is only airtight when a resurrected primary can
    rediscover the adjudicated epoch: tailing a primary that runs the
    default epoch 0 (and so may restart blind) is loud — one warning
    per standby plus a counter — never fatal."""
    fe = ServeFrontend(E, A, device="cpu", flush_ms=0.5)
    fe.serve()
    primary = ShardRouter({"s0": _addr(fe)}, E)  # pre-HA default: 0
    primary_addr = primary.serve()
    standby = RouterStandby(primary_addr, {"s0": _addr(fe)}, E,
                            state_dir=str(tmp_path / "b"))
    try:
        with pytest.warns(RuntimeWarning, match="router epoch 0"):
            assert standby.poll_once() == POLL_TAILED
        assert standby.poll_once() == POLL_TAILED  # warned once only
        snap = standby.recorder.snapshot()["counters"]
        assert snap["router.ha.primary_epoch_zero"] == 1
    finally:
        standby.close()
        primary.close()
        fe.close()


# ---------------------------------------------------------------------------
# client failover semantics
# ---------------------------------------------------------------------------


def test_client_ambiguous_inflight_and_rotation(tmp_path):
    """An op whose connection dies un-answered surfaces the TYPED
    AmbiguousOp (never silently resent); the next attempt rotates to
    the successor address and serves."""
    # addr0: a server that accepts, reads one frame, closes unanswered
    listener = socket.create_server(("127.0.0.1", 0))
    dead_addr = listener.getsockname()[:2]

    def one_shot():
        conn, _ = listener.accept()
        try:
            conn.recv(64)  # the op frame arrives ...
        finally:
            conn.close()   # ... and dies with no reply

    t = threading.Thread(target=one_shot, daemon=True)
    t.start()
    fe = ServeFrontend(E, A, device="cpu", flush_ms=0.5)
    fe.serve()
    try:
        c = ServeClient([dead_addr, _addr(fe)], timeout=10.0)
        try:
            with pytest.raises(AmbiguousOp):
                c.add(1)
            # the ledger's resubmit lands on the successor
            c.add(1)
            assert c.rotations >= 1
            assert c.active_addr == _addr(fe)
            members, _ = c.members()
            assert members == [1]
        finally:
            c.close()
    finally:
        fe.close()
        listener.close()
    # single-address clients keep the legacy fail-fast contract.  A
    # round trip first: the frontend has accepted the connection before
    # it closes (a dial still in its accept queue could outlive the
    # drain); then the reader thread's exit, not a sleep, is awaited
    fe2 = ServeFrontend(E, A, device="cpu", flush_ms=0.5)
    fe2.serve()
    c2 = ServeClient(_addr(fe2))
    assert c2.members()[0] == []
    with c2._lock:
        reader = c2._reader
    fe2.close()
    try:
        reader.join(timeout=30.0)
        assert not reader.is_alive() and c2.closed
        with pytest.raises(ConnectionError):
            c2.add(1)
    finally:
        c2.close()


def test_client_idempotent_reads_retry_across_list():
    """QUERY/STATS retry transparently on the successor when the
    active address refuses the dial entirely."""
    fe = ServeFrontend(E, A, device="cpu", flush_ms=0.5)
    fe.serve()
    dead = free_port()  # nothing listens here
    try:
        with ServeClient([("127.0.0.1", dead), _addr(fe)],
                         connect_timeout=1.0) as c:
            members, _ = c.members()
            assert members == []
            assert c.stats()["counters"] is not None
    finally:
        fe.close()


def test_stale_epoch_reject_only_rotates_its_own_connection():
    """A StaleRouterEpoch reject tears down the connection it ARRIVED
    on — never a newer socket a concurrent failover re-dial already
    replaced it with (shutting that down would kill a healthy
    connection and surface spurious AmbiguousOp for its in-flight
    ops)."""
    import time as time_mod

    from go_crdt_playground_tpu_torch.serve.client import PendingOp

    class _FakeSock:
        def __init__(self):
            self.shut = False

        def shutdown(self, how):
            self.shut = True

    fe = ServeFrontend(E, A, device="cpu", flush_ms=0.5)
    fe.serve()
    try:
        with ServeClient([_addr(fe), ("127.0.0.1", free_port())]) as c:
            with c._lock:
                cur_gen = c._gen
                c._pending[9901] = PendingOp(9901, time_mod.monotonic())
                dial_before = c._next_dial
            # a reject from a SUPERSEDED connection: no rotation, and
            # the (stale) socket it came on is left alone too — its
            # reader's death sweep already owns that teardown
            stale_sock = _FakeSock()
            c._finish(9901, protocol.StaleRouterEpoch("deposed"),
                      time_mod.monotonic(), stale_sock, cur_gen - 1)
            assert not stale_sock.shut
            with c._lock:
                assert c._next_dial == dial_before
            members, _ = c.members()  # the live connection still serves
            assert members == []
            # the same reject on the CURRENT connection rotates it
            with c._lock:
                cur_gen = c._gen
                c._pending[9902] = PendingOp(9902, time_mod.monotonic())
            live_sock = _FakeSock()
            c._finish(9902, protocol.StaleRouterEpoch("deposed"),
                      time_mod.monotonic(), live_sock, cur_gen)
            assert live_sock.shut
            with c._lock:
                assert c._next_dial != dial_before
    finally:
        fe.close()


# ---------------------------------------------------------------------------
# the two packages mixed
# ---------------------------------------------------------------------------


def test_ring_sync_bodies_equal_across_packages():
    from go_crdt_playground_tpu.serve import protocol as jax_protocol

    rec = {"router_epoch": 9, "generation": 2, "digest": "ab",
           "shards": {"s0": ["127.0.0.1", 1], "s1": [["h", 2], ["h", 3]]},
           "elements": E, "seed": 3, "max_epoch_seen": 9}
    for ours, theirs in (
            (protocol.encode_ring_sync(7, 3, "router-a"),
             jax_protocol.encode_ring_sync(7, 3, "router-a")),
            (protocol.encode_ring_sync_reply(5, rec),
             jax_protocol.encode_ring_sync_reply(5, rec))):
        assert ours == theirs
    assert protocol.decode_ring_sync_reply(
        jax_protocol.encode_ring_sync_reply(5, rec)) == (5, rec)


def _packages(name):
    if name == "jax":
        from go_crdt_playground_tpu.serve.frontend import \
            ServeFrontend as JaxFrontend
        from go_crdt_playground_tpu.shard import ha as jax_ha
        from go_crdt_playground_tpu.shard.router import \
            ShardRouter as JaxRouter

        return JaxFrontend, JaxRouter, jax_ha
    from go_crdt_playground_tpu_torch.shard import ha

    return (lambda *a, **kw: ServeFrontend(*a, device="cpu", **kw),
            ShardRouter, ha)


@pytest.mark.parametrize("primary_pkg,standby_pkg",
                         [("torch", "jax"), ("jax", "torch"),
                          ("torch", "torch")])
def test_standby_tails_and_promotes_across_packages(tmp_path, primary_pkg,
                                                    standby_pkg):
    """A standby of one package tails a primary router of the other over
    shards of the primary's package, promotes under the bumped epoch
    onto the tailed ring, and the deposed primary, restarted on its
    state dir, sheds writes typed without applying them."""
    make_fe, make_router, _ = _packages(primary_pkg)
    _, _, ha = _packages(standby_pkg)
    fe = make_fe(E, A, durable_dir=str(tmp_path / "s0"), flush_ms=0.5)
    fe.serve()
    primary_state = str(tmp_path / "router-a")
    primary = make_router({"s0": _addr(fe)}, E, seed=7,
                          state_dir=primary_state, router_epoch=1,
                          router_id="router-a")
    primary_addr = primary.serve()
    standby_port = free_port()
    standby = ha.RouterStandby(
        primary_addr, {"s0": _addr(fe)}, E, seed=7,
        state_dir=str(tmp_path / "router-b"), standby_id="router-b",
        listen_addr=("127.0.0.1", standby_port), failure_threshold=2)
    resurrected = None
    try:
        with ServeClient(primary_addr) as c:
            c.add(3, 9)
        assert standby.poll_once() == ha.POLL_TAILED
        info_before = primary.route().info()
        primary.close()
        assert standby.poll_once() == ha.POLL_FAILED
        assert standby.poll_once() == ha.POLL_PROMOTED
        promoted = standby.router
        assert promoted.router_epoch == 2
        assert promoted.route().info() == info_before
        assert load_router_epoch(str(tmp_path / "s0")) == 2
        with ServeClient([primary_addr,
                          ("127.0.0.1", standby_port)]) as hc:
            hc.add(5)
            assert hc.members()[0] == [3, 5, 9]
        # the deposed primary comes back on its own state dir
        resurrected = make_router({"s0": _addr(fe)}, E, seed=7,
                                  state_dir=primary_state,
                                  router_id="router-a")
        old_addr = resurrected.serve()
        assert resurrected.deposed
        with ServeClient(old_addr) as c:
            with pytest.raises(protocol.StaleRouterEpoch):
                c.add(11)
            ok, detail = c.reshard(protocol.RESHARD_LEAVE, "s0")
            assert not ok and "StaleRouterEpoch" in detail["reason"]
        with ServeClient(("127.0.0.1", standby_port)) as c:
            assert c.members()[0] == [3, 5, 9], \
                "the deposed primary's write was applied"
    finally:
        if resurrected is not None:
            resurrected.close()
        standby.close()
        fe.close()
