"""The op-ingest serving frontend: listener + admission + batcher + node.

``ServeFrontend`` is the subsystem the ROADMAP's "serves heavy traffic"
north star plugs into: clients dial a TCP port and submit add/del ops
against a keyed AWSet replica (serve/protocol.py); connection reader
threads admit them into the bounded ``AdmissionQueue`` (full queue ⇒
typed ``Overloaded`` shed, never a silent drop); the ``MicroBatcher``
coalesces admitted ops into packed ``(B, E)`` tensor applies through
the kernel path and acks only after the WAL group commit
(``Node.ingest_batch``); and the merged state disseminates through the
EXISTING anti-entropy machinery — the frontend's ``Node`` is an
ordinary ``net/peer.py`` replica, optionally driven against a peer set
by a ``SyncSupervisor`` on the §14 durability regime.

Shutdown is a drain, not a drop (``close()``): stop accepting dials,
flip draining (in-flight connections get typed ``Draining`` rejects for
NEW ops), flush the batcher (every admitted op acks or typed-rejects),
take a final durable checkpoint (seals + retires the WAL segments the
dump covers), then close sessions and the node.

SLO accounting rides the shared ``obs.Recorder`` (names in DESIGN.md
§16): listener-side counters ``serve.ops.admitted``,
``serve.shed.overload``, ``serve.shed.draining``,
``serve.rejects.invalid``, ``serve.queries``, ``serve.connections``;
the batcher adds the latency/occupancy streams.

The counterpart of the JAX package's ``serve/frontend.py``: the same
frames, replies, WAL records and counter names.  The replica lives on
``device`` (CUDA by default); there every micro-batch is one K10 launch
(ops/cuda_ingest.py), made from the batcher's thread on the node's
device, and ``--sync-mode digest`` exchanges read the lane digests
through K11.  The reference's device-mesh replicas and admission
scheduler raise ``NotYetPorted``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional, Sequence, Tuple

from go_crdt_playground_tpu_torch._u32 import host as to_numpy
from go_crdt_playground_tpu_torch.device import resolve_device
from go_crdt_playground_tpu_torch.net import framing
from go_crdt_playground_tpu_torch.net.peer import Node
from go_crdt_playground_tpu_torch.serve import protocol
from go_crdt_playground_tpu_torch.serve.admission import AdmissionQueue, OpRequest
from go_crdt_playground_tpu_torch.serve.batcher import MicroBatcher
from go_crdt_playground_tpu_torch.serve.host import ConnHost
from go_crdt_playground_tpu_torch.serve.session import Session

Addr = Tuple[str, int]

# reshard-soak crash hook: "pull" SIGKILLs the process on the next
# SLICE_PULL (the donor dying mid-handoff), "push" on the next
# SLICE_PUSH before it applies (the recipient dying mid-handoff) — the
# two windows the fleet soak's kill-mid-handoff leg adjudicates (a
# failed handoff must leave the OLD ring fully serving)
_SLICE_CRASH_ENV = "CRDT_SERVE_CRASH_ON_SLICE"


class NotYetPorted(NotImplementedError):
    """An option of the reference frontend whose slice of the port has
    not landed yet (the device-mesh replicas, the admission
    scheduler)."""


class ServeFrontend:
    """TCP op-ingest frontend over one durable AWSet replica."""

    def __init__(self, num_elements: int, num_actors: int, *,
                 actor: int = 0, durable_dir: Optional[str] = None,
                 peers: Sequence[Addr] = (), queue_depth: int = 256,
                 max_batch: int = 32, flush_ms: float = 2.0,
                 checkpoint_every: int = 0, sync_interval_s: float = 0.05,
                 wal_fsync: bool = True, recorder=None, seed: int = 0,
                 max_conns: Optional[int] = None,
                 ingest_fused: bool = True,
                 wal_compact_records: bool = True,
                 compact_interval_s: float = 0.0,
                 compact_p99_budget_s: float = 0.25,
                 gc_participants: Optional[Sequence[int]] = None,
                 sync_mode: str = "delta",
                 mesh_devices: Optional[int] = None,
                 shard_id: Optional[str] = None,
                 shard_epoch: int = 0,
                 announce_to=None,
                 repl_ack_timeout_ms: float = 250.0,
                 sched: str = "auto", device="cuda"):
        from go_crdt_playground_tpu_torch.obs import Recorder

        self.recorder = recorder if recorder is not None else Recorder()
        self.durable_dir = durable_dir
        # the replica flavor: a plain single-device Node on ``device``
        # (CUDA by default: every micro-batch is one K10 launch).  The
        # reference's device-mesh flavors (``mesh_devices``) and its
        # admission scheduler (``sched="on"``) raise NotYetPorted.
        device = resolve_device(device)
        if mesh_devices is not None:
            raise NotYetPorted(
                "mesh_devices: the device-mesh replica targets "
                "(parallel/meshtarget.py, meshtarget2d.py) are not part "
                "of the port yet; serve one device")
        if durable_dir is not None:
            os.makedirs(durable_dir, exist_ok=True)
            self.node = Node.restore_durable(
                durable_dir, recorder=self.recorder, device=device,
                fallback_init=lambda: Node(
                    actor, num_elements, num_actors,
                    recorder=self.recorder, device=device))
        else:
            # non-durable regime (benchmarks/tests): acks are NOT backed
            # by an fsync — production serving always passes durable_dir
            self.node = Node(actor, num_elements, num_actors,
                             recorder=self.recorder, device=device)
        # serve-ladder knobs (plain config attrs — restore_durable
        # rebuilds the node from checkpoint metadata, which does not
        # carry them): fused one-dispatch ingest+δ and compact WAL
        # records default ON; the soak's seed-comparison leg turns them
        # off to measure the two-dispatch/dense-record baseline
        self.node.ingest_fused = ingest_fused
        self.node.wal_compact_records = wal_compact_records
        self.queue = AdmissionQueue(queue_depth)
        # shard replication (DESIGN.md §23): the publisher tracks
        # tailing standbys' durable cursors and gates the batcher's
        # acks semi-synchronously on them (degrading typed to async
        # when the standby is dead/slow — a standby can never take
        # this primary's availability down).  Dormant until the first
        # WAL_SYNC poll registers a standby.
        from go_crdt_playground_tpu_torch.shard.replica import \
            ReplicationPublisher

        self.repl = ReplicationPublisher(
            self.recorder, ack_timeout_s=repl_ack_timeout_ms / 1e3)
        # conflict-aware admission scheduling (serve/scheduler.py,
        # DESIGN.md §25): "auto" turns it on exactly when the replica
        # serves >1 ingest stripe (the 2-D dp×mp mesh — the only
        # flavor where cross-key reordering buys throughput), "on"
        # forces it (a dp=1 scheduler still coalesces, useful for
        # parity tests), "off" keeps the byte-identical FIFO path.
        if sched not in ("auto", "on", "off"):
            raise ValueError(
                f"sched must be auto/on/off, got {sched!r}")
        if sched == "on":
            raise NotYetPorted(
                "sched='on': the conflict-aware admission scheduler "
                "(serve/scheduler.py) is not part of the port yet")
        # "auto" engages the scheduler only on a replica with more than
        # one ingest stripe (the 2-D mesh), which the port has not: FIFO
        self.scheduler = None
        self.batcher = MicroBatcher(
            self.node, self.queue, max_batch=max_batch,
            flush_s=flush_ms / 1000.0, recorder=self.recorder,
            repl=self.repl, scheduler=self.scheduler)
        # the dissemination half rides the EXISTING supervisor; it also
        # owns the durable checkpoint cadence (and attaches a WAL to a
        # fresh non-restored node when durable_dir is set)
        self.supervisor = None
        self.sync_mode = sync_mode
        if peers or durable_dir is not None:
            from go_crdt_playground_tpu_torch.net.antientropy import SyncSupervisor

            self.supervisor = SyncSupervisor(
                self.node, peers, durable_dir=durable_dir,
                checkpoint_every=checkpoint_every,
                interval_s=sync_interval_s, wal_fsync=wal_fsync,
                sync_mode=sync_mode,
                recorder=self.recorder, seed=seed)
        # SLO-aware background compaction (serve/compaction.py):
        # deletion-record GC + WAL-driven checkpoint rotation, run only
        # when the serve gauges show ingest-latency headroom
        self.compactor = None
        if compact_interval_s > 0:
            from go_crdt_playground_tpu_torch.serve.compaction import \
                CompactionScheduler

            ckpt = (self.supervisor.checkpoint
                    if self.supervisor is not None
                    and durable_dir is not None else None)
            self.compactor = CompactionScheduler(
                self.node, self.recorder, checkpoint=ckpt,
                interval_s=compact_interval_s,
                p99_budget_s=compact_p99_budget_s,
                gc_participants=gc_participants)
        # the listener/reader/conn-slot plumbing is the shared host
        # (serve/host.py) — the router tier runs the identical stack,
        # so accept-path fixes land once.  Frame caps are PER VERB: the
        # keyspace-handoff verbs scale with the universe (a SLICE_PUSH
        # body is two dense E-lane sections + ~6 bytes per entry, a
        # SLICE_PULL request one varint per moved element) — without
        # that a large-keyspace reshard could never transfer — while
        # every other frame keeps the tiny cap that bounds what an
        # untrusted length header can make one connection buffer.
        slice_cap = max(ConnHost.MAX_FRAME_BODY,
                        16 * num_elements + 4096)
        # WAL_SYNC requests carry a digest summary in the catch-up form
        # (O(E/16) bytes) — same universe-scaled treatment
        slice_verbs = (protocol.MSG_SLICE_PUSH, protocol.MSG_SLICE_PULL,
                       protocol.MSG_WAL_SYNC)
        self.host = ConnHost(
            self._dispatch, recorder=self.recorder,
            counter_prefix="serve", thread_name="serve",
            max_conns=max_conns,
            max_frame_body=lambda t: (slice_cap if t in slice_verbs
                                      else ConnHost.MAX_FRAME_BODY))
        self._has_peers = bool(peers)
        # the GC membership declaration as CONFIGURED; serve() resolves
        # it (deriving None-vs-() from the peer config when unset) into
        # _gc_declared, which the compactor AND the fleet-GC verbs
        # (FRONTIER/GC — the router's evidence channel) share
        self.gc_participants = gc_participants
        self._gc_declared = gc_participants
        self._closed = threading.Event()
        # race-ok: serve() owner thread sets it before any reader runs
        self.addr: Optional[Addr] = None
        # race-ok: read-only after __init__ (reshard-soak crash hook)
        self._slice_crash = os.environ.get(_SLICE_CRASH_ENV) or None
        # router-epoch fence (DESIGN.md §22): the highest router epoch
        # this shard has ever ADJUDICATED, persisted under durable_dir
        # (fsync-then-rename) so a restart cannot forget that a
        # primary was deposed.  Admin-plane verbs (SLICE_PULL/PUSH,
        # FRONTIER, GC) reject typed StaleRouterEpoch for any
        # connection that announced a lower epoch — or, once a fence
        # exists, never announced at all.
        from go_crdt_playground_tpu_torch.shard.handoff import \
            load_router_epoch

        self._epoch_lock = threading.Lock()
        self._router_epoch = load_router_epoch(
            durable_dir)  # guarded-by: _epoch_lock
        # SHARD-epoch fence (DESIGN.md §23): this member's own claim to
        # its keyspace and the highest epoch it has ever adjudicated
        # (a standby's deposition notice, or the router's typed verdict
        # on the serve()-time announce probe).  seen > own = deposed:
        # a standby promoted past this member — writes shed typed
        # StaleShardEpoch, reads keep serving (CRDT lower bound).
        from go_crdt_playground_tpu_torch.shard.replica import (
            load_shard_epoch, load_shard_epoch_seen, persist_shard_epoch)

        self.shard_id = shard_id
        self.announce_to = announce_to
        self._shard_epoch = max(int(shard_epoch), load_shard_epoch(
            durable_dir))  # guarded-by: _epoch_lock
        self._shard_epoch_seen = max(
            self._shard_epoch,
            load_shard_epoch_seen(durable_dir))  # guarded-by: _epoch_lock
        if (durable_dir is not None and shard_epoch > 0
                and self._shard_epoch == int(shard_epoch)):
            # a flag-raised epoch persists before it is acted on, the
            # router-epoch discipline
            persist_shard_epoch(durable_dir, self._shard_epoch,
                                shard_id or "?",
                                seen=self._shard_epoch_seen)
        # WAL-instance nonce: record seqs are only meaningful within
        # one DeltaWal lifetime; a restart renumbers, and the nonce in
        # every WAL_SYNC reply is how standbys find out (typed cursor
        # reset, never a silent gap).  race-ok: read-only after init
        self._wal_nonce = os.urandom(8).hex()
        # race-ok: serve()/warmup() owner thread only
        self._warmed = False

    # -- lifecycle ----------------------------------------------------------

    def serve(self, host: str = "127.0.0.1", port: int = 0,
              peer_port: Optional[int] = None) -> Addr:
        """Start serving client ops; returns the bound (host, port).
        With ``peer_port`` (or any registered peers) the node also
        starts its anti-entropy server / supervisor loop."""
        if self.host.listening:
            raise RuntimeError("already serving")
        self.warmup()
        if port != 0:
            # announce BEFORE the listener opens when the serving
            # address is declared: a deposed member must learn its
            # verdict before the first direct write can reach it
            self._announce_shard((host, port))
        self.addr = self.host.listen(host, port)
        if port == 0:
            self._announce_shard(self.addr)
        self.batcher.start()
        if peer_port is not None:
            self.node.serve(host, peer_port)
        if self.supervisor is not None and (self.supervisor.peers
                                            or self.supervisor.
                                            checkpoint_every > 0):
            self.supervisor.start()
        if self._gc_declared is None:
            # derive the GC membership declaration from the peer
            # CONFIG (restart-stable, unlike any heard-traffic
            # heuristic): no peer set and no anti-entropy listener
            # means this replica IS the deployment (the isolated
            # declaration, ``()``); any peer surface without an
            # explicit --gc-participants keeps GC disabled
            self._gc_declared = (
                None if (self._has_peers or peer_port is not None)
                else ())
        if self.compactor is not None:
            if self.compactor.gc_participants is None:
                self.compactor.gc_participants = self._gc_declared
            self.compactor.start()
        return self.addr

    def warmup(self) -> None:
        """Idempotent public warmup: a shard STANDBY (shard/replica.py)
        builds and runs the whole serving path at ENGAGE time so its
        promotion pays a bind + announce, not a first-batch kernel
        build inside the failover budget; ``serve()`` calls this too
        and skips the second run."""
        if not self._warmed:
            self._warmup()
            self._warmed = True

    def _announce_shard(self, addr: Addr) -> None:
        """The serve()-time keyspace announce / resurrection probe
        (DESIGN.md §23): tell the router which member serves
        ``shard_id`` under which shard epoch.  Idempotent for the
        active member; a RESURRECTED deposed primary gets the typed
        ``StaleShardEpoch`` verdict here — the router's per-sid fence
        is durable — and boots self-fenced.  Best-effort beyond that:
        an unreachable router never blocks serving (pre-HA deployments
        configure no ``announce_to`` at all)."""
        if self.announce_to is None or self.shard_id is None:
            return
        from go_crdt_playground_tpu_torch.serve.client import ServeClient
        from go_crdt_playground_tpu_torch.shard.replica import \
            persist_shard_epoch as _persist

        bump = False
        with self._epoch_lock:
            if self._shard_epoch < 1:
                # an announce-configured member IS a replication-group
                # member: adopt epoch 1 as our OWN claim (persisted)
                # rather than claiming an epoch the WAL_SYNC replies
                # would then contradict — a standby tailing the raw 0
                # would promote at 0+1=1 and COLLIDE with this very
                # claim at the router (equal epoch, different address
                # = typed-stale: the failover could never swap)
                self._shard_epoch = 1
                self._shard_epoch_seen = max(self._shard_epoch_seen, 1)
                bump = True
            epoch = self._shard_epoch
            seen = self._shard_epoch_seen
        if bump:
            _persist(self.durable_dir, epoch, self.shard_id, seen=seen)
        try:
            with ServeClient(self.announce_to, timeout=5.0,
                             connect_timeout=2.0) as c:
                c.shard_failover(epoch, self.shard_id,
                                 f"serve-{os.getpid()}", addr)
            self._count("serve.shard.announces")
        except protocol.StaleShardEpoch:
            # the adjudicated epoch is higher: a standby promoted past
            # this member while it was down.  Self-fence (exact value
            # immaterial — deposed is a comparison) and persist the
            # adjudication so a re-restart boots fenced even if the
            # router is unreachable then
            from go_crdt_playground_tpu_torch.shard.replica import \
                persist_shard_epoch

            with self._epoch_lock:
                self._shard_epoch_seen = max(self._shard_epoch_seen,
                                             self._shard_epoch + 1)
                own, seen = self._shard_epoch, self._shard_epoch_seen
            persist_shard_epoch(self.durable_dir, own,
                                self.shard_id, seen=seen)
            self._count("serve.shard.deposed_boot")
        except Exception:  # noqa: BLE001 — transport failure or an
            # unexpected router reply: the router may be mid-failover
            # itself; its link-level ordered-address redial finds us
            # regardless, so serving never blocks on the probe
            self._count("serve.shard.announce_failures")

    def claim_shard_epoch(self, epoch: int) -> None:
        """Adopt a promotion-claimed shard epoch (the standby persists
        it BEFORE calling this — shard/replica.py step 1)."""
        with self._epoch_lock:
            self._shard_epoch = max(self._shard_epoch, int(epoch))
            self._shard_epoch_seen = max(self._shard_epoch_seen,
                                         self._shard_epoch)

    @property
    def shard_deposed(self) -> bool:
        """True once a HIGHER shard epoch than our own has been
        adjudicated: a standby owns this keyspace now.  Writes shed
        typed; reads keep serving."""
        with self._epoch_lock:
            return self._shard_epoch_seen > self._shard_epoch

    def _warmup(self) -> None:
        """Build the kernels (``nvcc`` at first use on a GPU machine) and
        run one throwaway ingest (the K10 batch, the WAL record's encode
        and append) on a scratch node of the serving shapes BEFORE the
        listener opens: the first client batch must pay the flush
        watermark, not a kernel build.  The scratch node has the real
        node's device and ingest regime (a ``--no-fused-ingest`` worker
        warms the two-step path it runs); the keyspace-handoff transfer
        (slice extract + payload apply) and, in the digest sync mode,
        K11 run once too.  The REAL node is untouched."""
        import tempfile

        import numpy as np

        from go_crdt_playground_tpu_torch.utils.wal import DeltaWal

        B, E = self.batcher.width, self.node.num_elements
        with tempfile.TemporaryDirectory(prefix="serve-warmup-") as d:
            scratch = type(self.node)(
                self.node.actor, E, self.node.num_actors,
                ingest_fused=self.node.ingest_fused,
                wal_compact_records=self.node.wal_compact_records,
                wal=DeltaWal(os.path.join(d, "wal"), fsync=False),
                device=self.node.device)
            add = np.zeros((B, E), bool)
            add[0, 0] = True  # one live lane: the δ-extract path runs
            scratch.ingest_batch(add, np.zeros((B, E), bool),
                                 np.asarray([True] + [False] * (B - 1)))
            mask = np.zeros(E, bool)
            mask[0] = True
            scratch.apply_payload_body(scratch.extract_slice(mask))
            if self.sync_mode == "digest":
                from go_crdt_playground_tpu_torch.net import digestsync

                digestsync.warm(scratch)
            with scratch._lock:
                scratch.wal.close()

    def close(self, drain_timeout_s: float = 30.0) -> None:
        """Graceful drain (module docstring): admitted ops ack before
        the process lets go of them."""
        if self._closed.is_set():
            return
        # stop accepting dials FIRST (the host does the shutdown-
        # before-close listener dance); in-flight connections get typed
        # Draining rejects for new ops from here on
        self.host.stop_accepting()
        if self.compactor is not None:
            # before the drain: a background checkpoint racing the
            # final drain checkpoint would double-write the store
            self.compactor.stop()
        self.batcher.drain(timeout=drain_timeout_s)
        if self.supervisor is not None:
            self.supervisor.stop()
            if self.supervisor.durable_dir is not None:
                # final checkpoint: seals the WAL and retires the
                # segments the dump covers (Node.save_durable two-phase)
                try:
                    self.supervisor.checkpoint()
                except Exception:  # noqa: BLE001 — drain must finish;
                    # the WAL already holds everything the dump would
                    self._count("serve.final_checkpoint_failures")
        # node BEFORE wal: the node's peer-sync server logs every
        # applied payload, so the WAL must outlive the listener (an
        # inbound exchange against a closed WAL is a served error, not
        # a crashed handler — net/peer.py catches it — but not serving
        # it at all is better)
        self.node.close()
        with self.node._lock:
            wal = self.node.wal
        if wal is not None:
            wal.close()
        # flush: the batcher's final acks are in per-session writer
        # queues (serve/session.py); the host gives the writers ONE
        # shared bounded window to get them onto the wire
        self.host.close_sessions(flush_timeout_s=2.0)
        self._closed.set()

    def __enter__(self) -> "ServeFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- request dispatch (runs on the host's reader threads) ---------------

    def _dispatch(self, session: Session, msg_type: int,
                  body: bytes) -> bool:
        if msg_type == protocol.MSG_OP:
            return self._handle_op(session, body)
        if msg_type == protocol.MSG_QUERY:
            self._handle_query(session, body)
            return True
        if msg_type == protocol.MSG_STATS:
            self._handle_stats(session, body)
            return True
        if msg_type == protocol.MSG_SLICE_PULL:
            return self._handle_slice_pull(session, body)
        if msg_type == protocol.MSG_SLICE_PUSH:
            return self._handle_slice_push(session, body)
        if msg_type == protocol.MSG_FRONTIER:
            return self._handle_frontier(session, body)
        if msg_type == protocol.MSG_GC:
            return self._handle_gc(session, body)
        if msg_type == protocol.MSG_DSUM:
            return self._handle_dsum(session, body)
        if msg_type == protocol.MSG_RING_SYNC:
            return self._handle_ring_sync(session, body)
        if msg_type == protocol.MSG_WAL_SYNC:
            return self._handle_wal_sync(session, body)
        # protocol-ignore: MSG_RESHARD — router-only admin verb; a
        # frontend answers it with the typed unknown-frame error below
        # protocol-ignore: MSG_SHARD_FAILOVER — router-only failover
        # adjudication verb; same typed unknown-frame answer
        session.send(framing.MSG_ERROR,
                     f"unexpected frame type {msg_type}".encode())
        return False

    def _handle_op(self, session: Session, body: bytes) -> bool:
        """Admit one OP frame; False ends the connection (undecodable
        frame — the stream may be out of sync)."""
        try:
            req_id, kind, elements, deadline_us = protocol.decode_op(body)
        except framing.ProtocolError as e:
            session.send(framing.MSG_ERROR, str(e).encode())
            return False
        E = self.node.num_elements
        if any(not 0 <= e < E for e in elements):
            self._count("serve.rejects.invalid")
            session.send(protocol.MSG_REJECT, protocol.encode_reject(
                req_id, protocol.REJECT_INVALID,
                f"element id outside universe E={E}"))
            return True
        if len(set(elements)) != len(elements):
            # key-SET contract (serve/protocol.py): duplicates would
            # apply set-wise here but per-argument on the reference host
            # path — refuse rather than silently diverge by ingress
            self._count("serve.rejects.invalid")
            session.send(protocol.MSG_REJECT, protocol.encode_reject(
                req_id, protocol.REJECT_INVALID,
                "duplicate element ids in one op"))
            return True
        if self.host.draining:
            self._count("serve.shed.draining")
            session.send(protocol.MSG_REJECT, protocol.encode_reject(
                req_id, protocol.REJECT_DRAINING, "frontend draining"))
            return True
        if self.shard_deposed:
            # shard-epoch self-fence (DESIGN.md §23): a standby owns
            # this keyspace — a write applied here would be acked by a
            # member the router never reads again (acked-but-invisible,
            # the one thing zero-acked-op-loss can never tolerate).
            # Reads below keep serving: a stale member's state is a
            # correct CRDT lower bound.
            self._count("serve.shed.shard_deposed")
            session.send(protocol.MSG_REJECT, protocol.encode_reject(
                req_id, protocol.REJECT_STALE_SHARD_EPOCH,
                "shard member deposed (stale shard epoch) — a standby "
                "was promoted for this keyspace; dial the router"))
            return True
        if self.batcher.storage_degraded():
            # disk-full graceful degrade (DESIGN.md §16 tail): the WAL
            # append/fsync path failed recently — shed WRITES typed at
            # admission (reads keep serving) until the batcher's next
            # probe window lets one batch test the disk again
            self._count("serve.shed.storage")
            session.send(protocol.MSG_REJECT, protocol.encode_reject(
                req_id, protocol.REJECT_STORAGE,
                "durable WAL append failing (storage degraded; "
                "reads still served — retry with backoff)"))
            return True
        now = time.monotonic()
        deadline = (now + deadline_us / 1e6) if deadline_us > 0 else None
        req = OpRequest(req_id, kind, elements, deadline, session, now)
        if self.queue.offer(req):
            self._count("serve.ops.admitted")
        else:
            # admission limit: shed with the TYPED reply — under
            # saturation offered load converts to Overloaded replies,
            # not queue growth (bounded p99, SERVE_CURVE.json)
            self._count("serve.shed.overload")
            session.send(protocol.MSG_REJECT, protocol.encode_reject(
                req_id, protocol.REJECT_OVERLOADED,
                f"admission queue full (depth {self.queue.maxdepth})"))
        return True

    def _handle_query(self, session: Session, body: bytes) -> None:
        try:
            req_id = protocol.decode_query(body)
        except framing.ProtocolError as e:
            session.send(framing.MSG_ERROR, str(e).encode())
            return
        self._count("serve.queries")
        # ONE lock hold for membership + vv (separate members()/vv()
        # calls could interleave with a batch commit and reply with a
        # vv covering an add the membership doesn't show — a state no
        # replica ever held), pulling ONLY the present mask + vv: on a
        # mesh-sharded replica the dot/deletion lanes stay on-device
        members, vv = self.node.members_vv()
        session.send(protocol.MSG_MEMBERS, protocol.encode_members(
            req_id, [int(e) for e in members], vv))

    def _handle_stats(self, session: Session, body: bytes) -> None:
        """The SLO read-out: the recorder snapshot (ingest latency
        p50/p95/p99, batch occupancy, shed counters, queue depth) over
        the wire — operators and the serve soak read the same numbers."""
        try:
            req_id = protocol.decode_stats(body)
        except framing.ProtocolError as e:
            session.send(framing.MSG_ERROR, str(e).encode())
            return
        session.send(protocol.MSG_STATS_REPLY, protocol.encode_stats_reply(
            req_id, self.recorder.snapshot()))

    def _handle_dsum(self, session: Session, body: bytes) -> bool:
        """The digest-summary read (protocol.MSG_DSUM): this replica's
        ``net/digestsync`` summary body — the O(E/16)-byte freshness
        key the router's member cache compares instead of re-pulling
        O(membership) MEMBERS replies.  On a mesh-sharded replica the
        digests come off the collective kernel; either way no state
        lane crosses to the host for this read."""
        from go_crdt_playground_tpu_torch.net import digestsync

        try:
            req_id = protocol.decode_dsum(body)
        except framing.ProtocolError as e:
            session.send(framing.MSG_ERROR, str(e).encode())
            return False
        self._count("serve.digest_reads")
        session.send(protocol.MSG_DSUM_REPLY, protocol.encode_dsum_reply(
            req_id, digestsync.node_summary(self.node)))
        return True

    # -- router-epoch fence (router HA, DESIGN.md §22) ----------------------

    # fence-ok: this verb IS the router-epoch fence mechanism — it
    # adjudicates claims persist-then-adopt and must answer on a
    # deposed member so the member can learn its own deposition
    def _handle_ring_sync(self, session: Session, body: bytes) -> bool:
        """Adjudicate a router-epoch announcement (or serve a pure
        read).  A claim ABOVE the recorded maximum is adopted and
        persisted BEFORE it is acknowledged — from that fsync on, no
        older router can drive an admin verb here.  A claim BELOW it
        is the deposed router itself: typed ``StaleRouterEpoch``."""
        from go_crdt_playground_tpu_torch.shard.handoff import \
            persist_router_epoch

        try:
            req_id, epoch, router_id = protocol.decode_ring_sync(body)
        except framing.ProtocolError as e:
            session.send(framing.MSG_ERROR, str(e).encode())
            return False
        with self._epoch_lock:
            current = self._router_epoch
            if epoch > current:
                # persist-then-adopt under the lock: two racing
                # announcements serialize here, and the on-disk record
                # is monotone because only the winner of the compare
                # ever writes
                persist_router_epoch(self.durable_dir, epoch, router_id)
                self._router_epoch = epoch
                current = epoch
                self._count("serve.router_epoch.adopted")
        if 0 < epoch < current:
            self._count("serve.rejects.stale_epoch")
            session.send(protocol.MSG_REJECT, protocol.encode_reject(
                req_id, protocol.REJECT_STALE_EPOCH,
                f"router epoch {epoch} is stale: epoch {current} "
                "already adjudicated (a standby promoted past you)"))
            return True
        if epoch > 0:
            # the fence stamp the admin verbs below adjudicate against
            session.router_epoch = epoch
        session.send(protocol.MSG_RING_SYNC_REPLY,
                     protocol.encode_ring_sync_reply(
                         req_id, {"router_epoch": current,
                                  "role": "shard"}))
        return True

    def _epoch_fenced(self, session: Session, req_id: int) -> bool:
        """The admin-plane fence check: True (and a typed reject sent)
        when this connection's announced router epoch is older than the
        highest adjudicated one — including the never-announced case
        once any fence exists, so a deposed pre-announce code path can
        never slip an admin write through.  With no epoch ever seen
        (non-HA deployments) the fence is dormant and every existing
        caller is untouched."""
        with self._epoch_lock:
            current = self._router_epoch
        if current > 0 and session.router_epoch < current:
            self._count("serve.rejects.stale_epoch")
            session.send(protocol.MSG_REJECT, protocol.encode_reject(
                req_id, protocol.REJECT_STALE_EPOCH,
                f"admin verb under router epoch "
                f"{session.router_epoch or 'none'}: epoch {current} "
                "already adjudicated (announce via RING_SYNC)"))
            return True
        return False

    # -- shard replication: the WAL_SYNC serve verb (DESIGN.md §23) ---------

    # reply-batch bounds: a tail reply never exceeds either, so one
    # poll can neither blow the standby's frame cap nor hold the
    # session writer behind a megarecord burst
    WAL_SYNC_MAX_RECORDS = 256
    WAL_SYNC_MAX_BYTES = 1 << 20

    # fence-ok: this verb IS the shard-epoch fence mechanism — it
    # adjudicates standby claims persist-before-ack, and the tail read
    # must keep serving on a deposed member so a lagging standby can
    # finish catching up before arbitration
    def _handle_wal_sync(self, session: Session, body: bytes) -> bool:
        """Serve one standby tail poll / catch-up / epoch claim
        (serve/protocol.py MSG_WAL_SYNC).  The ``from_seq`` cursor is
        the standby's durable ack — it feeds the semi-sync publisher
        BEFORE the records are read, so the batcher's gate wakes the
        moment the ack lands.  An epoch claim above everything seen is
        the promoting standby's deposition notice: adopted, persisted,
        and from then on this member's writes shed typed."""
        from go_crdt_playground_tpu_torch.utils.wal import WalTruncated

        try:
            (req_id, epoch, standby_id, from_seq, wait_ms, max_records,
             summary) = protocol.decode_wal_sync(body)
        except framing.ProtocolError as e:
            session.send(framing.MSG_ERROR, str(e).encode())
            return False
        # -- shard-epoch adjudication (the deposition notice path) ----------
        if epoch > 0:
            from go_crdt_playground_tpu_torch.shard.replica import \
                persist_shard_epoch

            persist = None
            with self._epoch_lock:
                if epoch > self._shard_epoch_seen:
                    self._shard_epoch_seen = epoch
                    persist = (self._shard_epoch, epoch)
                seen = self._shard_epoch_seen
            if persist is not None:
                # durable BEFORE the ack: a restart cannot forget that
                # this keyspace was claimed past us
                persist_shard_epoch(self.durable_dir, persist[0],
                                    self.shard_id or "?",
                                    seen=persist[1])
                self._count("serve.shard_epoch.adopted")
            if epoch < seen:
                self._count("serve.rejects.stale_shard_epoch")
                session.send(protocol.MSG_REJECT, protocol.encode_reject(
                    req_id, protocol.REJECT_STALE_SHARD_EPOCH,
                    f"shard epoch {epoch} is stale: epoch {seen} "
                    "already adjudicated"))
                return True
        with self._epoch_lock:
            own_epoch = self._shard_epoch
        node = self.node
        with node._lock:
            wal = node.wal
        # -- catch-up: reply the O(diff) digest payload ---------------------
        if summary is not None:
            from go_crdt_playground_tpu_torch.net import digestsync

            try:
                _actor, group_size, vv, _proc, digests = \
                    digestsync.decode_summary(summary, node.num_elements,
                                              node.num_actors)
            except framing.ProtocolError as e:
                session.send(framing.MSG_ERROR, str(e).encode())
                return False
            try:
                with node._lock:
                    # cursor read under the SAME lock hold as the
                    # payload build: every record below next_seq is in
                    # the payload's state, so resuming the tail there
                    # can never skip one (appends take this lock)
                    next_seq = wal.next_seq() if wal is not None else 1
                    _mode, payload, _lanes, _gm = \
                        digestsync.build_reply_payload(
                            node, vv, digests, group_size)
            except Exception as e:  # noqa: BLE001 — a failed extract
                # must reply typed, not kill the reader thread
                self._count("repl.ship_errors")
                session.send(protocol.MSG_REJECT, protocol.encode_reject(
                    req_id, protocol.REJECT_OVERLOADED,
                    f"catch-up extract failed (retry): {e}"))
                return True
            self._count("repl.catchups_served")
            session.send(protocol.MSG_WAL_SYNC_REPLY,
                         protocol.encode_wal_sync_reply(
                             req_id, 0, own_epoch, self.shard_id or "?",
                             self._wal_nonce,
                             wal.min_seq() if wal is not None else 1,
                             next_seq, next_seq, (), payload))
            return True
        # -- tail poll: the ack, then a bounded record batch ----------------
        self.repl.note_poll(standby_id, from_seq)
        flags = 0
        records: list = []
        first_seq = from_seq
        if wal is None:
            min_seq = next_seq = 1
        else:
            self.repl.refresh_gauges(wal.next_seq())
            if from_seq > wal.next_seq():
                # a cursor beyond this WAL instance's tail is from a
                # previous numbering (the nonce catches the common
                # case; this guard catches a standby that missed it):
                # typed reset, never a silent forever-spin
                session.send(protocol.MSG_WAL_SYNC_REPLY,
                             protocol.encode_wal_sync_reply(
                                 req_id, protocol.WAL_TRUNCATED,
                                 own_epoch, self.shard_id or "?",
                                 self._wal_nonce, wal.min_seq(),
                                 wal.next_seq(), from_seq, ()))
                return True
            cap = min(max_records or self.WAL_SYNC_MAX_RECORDS,
                      self.WAL_SYNC_MAX_RECORDS)
            deadline = (time.monotonic() + min(wait_ms, 5000) / 1e3
                        if wait_ms > 0 else None)
            while True:
                try:
                    total = 0
                    for seq, rec in wal.stream_from(from_seq):
                        if not records:
                            first_seq = seq
                        records.append(rec)
                        total += len(rec)
                        if (len(records) >= cap
                                or total >= self.WAL_SYNC_MAX_BYTES):
                            break
                except WalTruncated:
                    # typed, never a silent gap: the standby must
                    # digest-catch-up and resume at next_seq
                    flags |= protocol.WAL_TRUNCATED
                    records = []
                except OSError:
                    self._count("repl.ship_errors")
                    records = []
                if records or flags or deadline is None \
                        or time.monotonic() >= deadline \
                        or self.host.draining:
                    break
                # long-poll: the standby parks here between batches so
                # a fresh record ships within ~one tick of its fsync
                time.sleep(0.005)
            min_seq = wal.min_seq()
            next_seq = (first_seq + len(records) if records
                        else wal.next_seq() if flags else from_seq)
            if records:
                self._count("repl.records_shipped", len(records))
        session.send(protocol.MSG_WAL_SYNC_REPLY,
                     protocol.encode_wal_sync_reply(
                         req_id, flags, own_epoch, self.shard_id or "?",
                         self._wal_nonce, min_seq, next_seq, first_seq,
                         records))
        return True

    # -- keyspace handoff (live resharding, DESIGN.md §18) ------------------

    def _crash_if_armed(self, which: str) -> None:
        """The reshard soak's kill-mid-handoff hook: SIGKILL the whole
        process at the named slice verb — donor death ("pull") before
        any state leaves, recipient death ("push") before any state
        lands, so the aborted handoff provably transferred nothing."""
        if self._slice_crash == which:
            import signal

            os.kill(os.getpid(), signal.SIGKILL)

    def _handle_slice_pull(self, session: Session, body: bytes) -> bool:
        """Serve the donor half of a keyspace handoff: the complete
        slice state as an anti-entropy payload body (opaque bytes the
        router shuttles to the new owner)."""
        try:
            req_id, elements = protocol.decode_slice_pull(body)
        except framing.ProtocolError as e:
            session.send(framing.MSG_ERROR, str(e).encode())
            return False
        E = self.node.num_elements
        if any(not 0 <= e < E for e in elements):
            self._count("serve.rejects.invalid")
            session.send(protocol.MSG_REJECT, protocol.encode_reject(
                req_id, protocol.REJECT_INVALID,
                f"slice element outside universe E={E}"))
            return True
        if self.host.draining:
            self._count("serve.shed.draining")
            session.send(protocol.MSG_REJECT, protocol.encode_reject(
                req_id, protocol.REJECT_DRAINING, "frontend draining"))
            return True
        if self._epoch_fenced(session, req_id):
            return True
        self._crash_if_armed("pull")
        import numpy as np

        mask = np.zeros(E, bool)
        mask[elements] = True
        payload = self.node.extract_slice(mask)
        self._count("serve.slice.pulls")
        session.send(protocol.MSG_SLICE_STATE,
                     protocol.encode_slice_state(req_id, payload))
        return True

    def _handle_slice_push(self, session: Session, body: bytes) -> bool:
        """Serve the recipient half: apply the pushed slice through the
        WAL-logged payload path and ack only once it is durable — the
        ring swap that follows this ack trusts it exactly like a client
        trusts an op ack."""
        try:
            req_id, payload = protocol.decode_slice_push(body)
        except framing.ProtocolError as e:
            session.send(framing.MSG_ERROR, str(e).encode())
            return False
        if self.host.draining:
            self._count("serve.shed.draining")
            session.send(protocol.MSG_REJECT, protocol.encode_reject(
                req_id, protocol.REJECT_DRAINING, "frontend draining"))
            return True
        if self._epoch_fenced(session, req_id):
            return True
        self._crash_if_armed("push")
        try:
            self.node.apply_payload_body(payload)
        except framing.ProtocolError as e:
            # malformed/incompatible payload: deterministic — the
            # router must abort the handoff, not retry the same bytes
            self._count("serve.rejects.invalid")
            session.send(protocol.MSG_REJECT, protocol.encode_reject(
                req_id, protocol.REJECT_INVALID,
                f"slice payload refused: {e}"))
            return True
        except ValueError as e:
            # transient server trouble (e.g. a closing WAL refusing the
            # append): retryable, like a poison batch
            self._count("serve.slice.push_failures")
            session.send(protocol.MSG_REJECT, protocol.encode_reject(
                req_id, protocol.REJECT_OVERLOADED,
                f"slice apply failed (retry): {e}"))
            return True
        self._count("serve.slice.pushes")
        session.send(protocol.MSG_ACK, protocol.encode_ack(req_id))
        return True

    # -- fleet-aware deletion-record GC (router aggregation, §17) -----------

    def _handle_frontier(self, session: Session, body: bytes) -> bool:
        """Report this shard's GC evidence for the router's fleet
        aggregation: local provable frontier + raw processed vv +
        whether the membership declaration is the explicit isolated
        one (serve/protocol.encode_frontier_reply documents why all
        three travel together).  A non-v2 or mid-heal shard reports a
        zero frontier — it can prove nothing stable, and the zeros
        block fleet GC for every lane it holds state in."""
        import numpy as np

        try:
            req_id = protocol.decode_frontier(body)
        except framing.ProtocolError as e:
            session.send(framing.MSG_ERROR, str(e).encode())
            return False
        if self._epoch_fenced(session, req_id):
            return True
        node = self.node
        declared = self._gc_declared
        with node._lock:
            processed = to_numpy(node._state.processed[0])
        if (node.delta_semantics != "v2"
                or node.full_resync_is_pending()):
            frontier = np.zeros(node.num_actors, np.uint32)
        else:
            frontier = node.deletion_frontier(declared)
        isolated = declared is not None and len(tuple(declared)) == 0
        self._count("serve.fleet_gc.frontier_reads")
        session.send(protocol.MSG_FRONTIER_REPLY,
                     protocol.encode_frontier_reply(
                         req_id, frontier, processed, isolated))
        return True

    def _handle_gc(self, session: Session, body: bytes) -> bool:
        """Apply a router-pushed fleet frontier, CLAMPED lane-wise to
        what this shard can prove locally — conservative on both hops:
        a buggy or hostile router can never make a shard drop a record
        its own evidence does not already cover (so an undeclared shard
        clamps everything to zero and never GCs)."""
        import numpy as np

        try:
            req_id, fleet = protocol.decode_gc(body)
        except framing.ProtocolError as e:
            session.send(framing.MSG_ERROR, str(e).encode())
            return False
        if self._epoch_fenced(session, req_id):
            return True
        node = self.node
        dropped = 0
        if (node.delta_semantics == "v2"
                and not node.full_resync_is_pending()):
            own = node.deletion_frontier(self._gc_declared)
            eff = np.zeros(node.num_actors, np.uint32)
            n = min(own.shape[0], fleet.shape[0])
            eff[:n] = np.minimum(own[:n], fleet[:n])
            if eff.any():
                out = node.gc_deletions(frontier=eff)
                dropped = out["dropped"]
                remaining = out["remaining"]
                self._count("serve.fleet_gc.runs")
                if dropped:
                    self._count("serve.fleet_gc.dropped_lanes", dropped)
            else:
                with node._lock:
                    remaining = int(node._state.deleted[0].sum())
        else:
            with node._lock:
                remaining = int(node._state.deleted[0].sum())
        session.send(protocol.MSG_GC_REPLY,
                     protocol.encode_gc_reply(req_id, dropped, remaining))
        return True

    def _count(self, name: str, n: int = 1) -> None:
        if self.recorder is not None:
            self.recorder.count(name, n)
