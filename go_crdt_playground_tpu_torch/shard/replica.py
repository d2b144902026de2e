"""Shard replication groups: WAL-shipped warm standbys with fenced
shard epochs and keyspace failover (DESIGN.md §23).

Router HA removed the router tier's single point of failure, but a
SIGKILLed SHARD still took its whole keyspace dark — typed
``ShardUnavailable`` until an operator restarted the process and
``restore_durable`` replayed its WAL.  The δ-state CRDT model makes
true shard HA cheap: the WAL already contains exactly the
δ-mutations a replica needs (arXiv:1410.2803 — the δ-groups ARE the
replication stream), and digest sync (arXiv:1803.02750) gives an
O(diff) catch-up for a standby that fell behind.  This module is the
``shard/ha.py`` tail/promote pattern applied to the DATA plane:

* **tail** — ``ShardStandby`` polls the primary's ``WAL_SYNC`` verb
  (serve/protocol.py): each reply ships a contiguous batch of
  committed WAL records by seq cursor, which the standby applies
  through ``Node.apply_wal_record`` — the records are WAL-logged
  VERBATIM on the standby and applied through the identical payload
  path, so the standby's state is bitwise-convergent with what a
  ``restore_durable`` restart of the primary would produce.  The
  cursor in the next poll IS the durable ack: everything below it is
  fsync'd on the standby.
* **semi-synchronous group commit** — the primary's batcher gates
  each batch's client acks on the standby's cursor covering the
  batch's last WAL record (``ReplicationPublisher.gate``), bounded by
  ``ack_timeout_s``.  A dead or slow standby degrades TYPED to async
  replication — a ``repl.degraded`` probe window, the exact
  ``storage_degraded()`` shape (utils/degrade.py) — so a standby can
  never take the primary's availability down with it.  The residual
  window is honest: records fsync'd on the primary whose ship the
  SIGKILL interrupts were never client-acked, so promotion loses no
  acked op even when it loses the unshipped tail.
* **catch-up** — a cursor below the primary's retained minimum (a
  checkpoint truncated the log) or a WAL-instance nonce change (the
  primary restarted and renumbered) surfaces typed, never as a
  silent gap; the standby then sends its own digest summary and the
  primary replies the O(diff) digest-sync payload
  (net/digestsync.build_reply_payload) plus a fresh cursor.
* **promote** — on N consecutive poll failures the standby persists
  ``shard_epoch = max(tailed primary epoch, own) + 1`` FIRST
  (fsync-then-rename), claims the keyspace at the ROUTER
  (``SHARD_FAILOVER``: the router adjudicates per-sid epochs durably
  and swaps the keyspace's downstream address under the existing
  RouteState machinery), best-effort deposes the old primary (a
  ``WAL_SYNC`` epoch claim — the false-positive-promotion
  containment), then binds its pre-declared serve port.  The
  standard listening banner doubles as the promotion handshake.
* **deposed primary** — a resurrected old primary announces its OWN
  (stale) epoch to the router at serve() time and learns the
  adjudicated one from the typed ``StaleShardEpoch`` reply: it boots
  self-fenced — writes shed typed, reads keep serving (a harmless
  CRDT lower bound) — exactly the PR-13 deposed-router containment,
  one tier down.

Counters/gauges (the §23 metric catalog): ``repl.polls`` /
``repl.records_shipped`` / ``repl.catchups_served`` on the primary's
serve side; ``repl.tail_records`` / ``repl.tail_polls`` /
``repl.poll_failures`` / ``repl.catchups`` / ``repl.apply_future`` /
``repl.promotions`` / ``repl.promote_blocked`` on the standby;
``repl.ship_errors`` / ``repl.degraded_windows`` / ``repl.heals`` and
the ``repl.lag_records`` / ``repl.lag_seconds`` gauges on the
publisher.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from go_crdt_playground_tpu_torch.shard.handoff import write_json_atomic
from go_crdt_playground_tpu_torch.utils.degrade import DegradeWindow

Addr = Tuple[str, int]

# the persisted SHARD epoch (DESIGN.md §23) — the data-plane sibling of
# handoff.ROUTER_EPOCH_FILE: a replication-group member's own claim to
# its keyspace, monotone across the group (a promoting standby persists
# max(tailed primary epoch, own) + 1 BEFORE announcing or serving).
# "seen" additionally records the highest epoch this member has ever
# ADJUDICATED (a live primary hearing its standby's deposition notice
# persists the fence so a restart cannot forget it).
SHARD_EPOCH_FILE = "shard_epoch.json"


def load_shard_epoch(state_dir: Optional[str]) -> int:
    """The persisted shard epoch (0 = absent/unreadable: the pre-HA
    configuration, fence dormant)."""
    rec = _load_epoch_rec(state_dir)
    try:
        return max(0, int(rec.get("shard_epoch", 0)))
    except (TypeError, ValueError):
        return 0


def load_shard_epoch_seen(state_dir: Optional[str]) -> int:
    """The highest shard epoch this member has durably adjudicated."""
    rec = _load_epoch_rec(state_dir)
    try:
        return max(0, int(rec.get("seen", 0)))
    except (TypeError, ValueError):
        return 0


def _load_epoch_rec(state_dir: Optional[str]) -> dict:
    import json

    if state_dir is None:
        return {}
    try:
        with open(os.path.join(state_dir, SHARD_EPOCH_FILE)) as f:
            rec = json.load(f)
        return rec if isinstance(rec, dict) else {}
    except (OSError, ValueError):
        return {}


def persist_shard_epoch(state_dir: Optional[str], epoch: int,
                        owner: str, seen: Optional[int] = None) -> None:
    """Durably record this member's shard epoch (and the highest
    adjudicated one) — fsync'd BEFORE the epoch is acted on, so a
    restart can never regress the fence."""
    if state_dir is None:
        return
    os.makedirs(state_dir, exist_ok=True)
    write_json_atomic(state_dir, SHARD_EPOCH_FILE,
                      {"shard_epoch": int(epoch), "owner": owner,
                       "seen": int(max(epoch, seen if seen is not None
                                       else 0))})


class ReplicationPublisher:
    """Primary-side semi-synchronous replication state (module
    docstring): who is tailing, how far each standby's durable cursor
    has advanced, and the degrade window the ack gate rides when the
    standby is dead or slow.

    ``note_poll`` runs on WAL_SYNC reader threads; ``gate`` runs on
    the batcher thread; the condition serializes both.  The lag
    gauges are refreshed from both sides so STATS stays honest even
    when only one side is moving.
    """

    # a standby whose last poll is older than this no longer counts as
    # LIVE: the gate stops waiting on its cursor (the degrade window
    # already covers the transition, this just keeps a long-dead
    # standby from consuming a probe timeout per window forever)
    STALE_AFTER_S = 30.0

    def __init__(self, recorder=None, *, ack_timeout_s: float = 0.25,
                 degrade_retry_s: float = 1.0,
                 clock=time.monotonic):
        self.recorder = recorder
        self.ack_timeout_s = float(ack_timeout_s)
        self._clock = clock
        self.window = DegradeWindow(degrade_retry_s, clock)
        self._cond = threading.Condition()
        # standby_id -> (acked_seq, last_poll_t); acked_seq N means
        # "every record below N is durably applied over there"
        self._standbys: Dict[str, Tuple[int, float]] = {}  # guarded-by: _cond
        self._ever = False  # guarded-by: _cond
        # when the live-min cursor last covered the WAL tail (for the
        # lag_seconds gauge); None = currently caught up
        self._lagging_since: Optional[float] = None  # guarded-by: _cond

    def note_poll(self, standby_id: str, from_seq: int) -> None:
        """One WAL_SYNC tail poll arrived: ``from_seq`` acknowledges
        every record below it (the standby fsync'd them).  Wakes any
        gate waiting on the cursor.  An EMPTY standby id is an
        anonymous observability read — it must not enroll in the
        replication group (the gate waits on the slowest live member,
        and a one-off debugging poll would pin that minimum until it
        staled out)."""
        if not standby_id:
            self._count("repl.polls")
            return
        now = self._clock()
        with self._cond:
            prev = self._standbys.get(standby_id, (0, 0.0))[0]
            self._standbys[standby_id] = (max(prev, int(from_seq)), now)
            self._ever = True
            self._cond.notify_all()
        self._count("repl.polls")

    def has_standby(self) -> bool:
        with self._cond:
            return self._ever

    # requires-lock: _cond
    def _live_acked_locked(self, now: float) -> Optional[int]:
        """The min durable cursor across LIVE standbys (semi-sync must
        wait for the slowest live group member — the one that may be
        promoted); None when no standby is live."""
        live = [seq for seq, t in self._standbys.values()
                if now - t <= self.STALE_AFTER_S]
        return min(live) if live else None

    def lag_records(self, wal_next_seq: int) -> int:
        """Records committed on the primary but not yet acked by the
        slowest live standby (0 with no live standby reads as the
        degrade ladder's problem, not a lag of 0 — the gauges pair
        with ``repl.degraded_windows`` for that reason)."""
        with self._cond:
            acked = self._live_acked_locked(self._clock())
        if acked is None:
            return 0
        return max(0, int(wal_next_seq) - acked)

    def refresh_gauges(self, wal_next_seq: int) -> None:
        if self.recorder is None:
            return
        now = self._clock()
        with self._cond:
            acked = self._live_acked_locked(now)
            lag = (max(0, int(wal_next_seq) - acked)
                   if acked is not None else 0)
            if lag > 0:
                if self._lagging_since is None:
                    self._lagging_since = now
                lag_s = now - self._lagging_since
            else:
                self._lagging_since = None
                lag_s = 0.0
        if hasattr(self.recorder, "set_gauge"):
            self.recorder.set_gauge("repl.lag_records", lag)
            self.recorder.set_gauge("repl.lag_seconds", lag_s)

    def gate(self, wal) -> bool:
        """The semi-sync ack gate (module docstring): called by the
        batcher AFTER the group-commit fsync, BEFORE the acks.  Waits
        up to ``ack_timeout_s`` for the slowest live standby's cursor
        to cover the WAL tail; a timeout arms the degrade window
        (``repl.degraded_windows``) under which later gates return
        immediately — typed degradation to async — until the window
        expires and the next gate is the probe.  Returns True when
        the batch is standby-covered, False when it acked async."""
        if wal is None:
            return True
        target = int(wal.next_seq())  # cover every record below this
        with self._cond:
            if not self._ever:
                return True  # no replication group configured/tailed
        if self.window.active():
            # degraded: async acks until the window lapses (the next
            # gate after expiry probes the standby again)
            self.refresh_gauges(target)
            return False
        deadline = self._clock() + self.ack_timeout_s
        with self._cond:
            if self._live_acked_locked(self._clock()) is None:
                # no LIVE standby at all (decommissioned without
                # deregistering): waiting cannot succeed — go straight
                # to the degrade path instead of burning one
                # ack_timeout per probe forever (a returning standby
                # re-enrolls via note_poll and the next probe sees it)
                ok = False
            else:
                while True:
                    now = self._clock()
                    acked = self._live_acked_locked(now)
                    if acked is not None and acked >= target:
                        ok = True
                        break
                    remaining = deadline - now
                    if remaining <= 0:
                        ok = False
                        break
                    self._cond.wait(timeout=min(remaining, 0.05))
        self.refresh_gauges(target)
        if ok:
            if self.window.armed_ever():
                # the probe succeeded: the standby is back — semi-sync
                # resumes for every later batch
                self.window.clear()
                self._count("repl.heals")
            return True
        if self.window.arm():
            self._count("repl.degraded_windows")
        return False

    def snapshot(self) -> Dict[str, object]:
        """Observability read (tests + STATS debugging)."""
        now = self._clock()
        with self._cond:
            return {
                "standbys": {k: {"acked_seq": seq,
                                 "stale_s": round(now - t, 3)}
                             for k, (seq, t) in self._standbys.items()},
                "degraded": self.window.active(),
                "windows": self.window.windows,
            }

    def _count(self, name: str, n: int = 1) -> None:
        if self.recorder is not None:
            self.recorder.count(name, n)


# poll_once() verdicts (the state-machine seam tests drive directly —
# the shard/ha.py pattern)
POLL_TAILED = "tailed"       # primary answered; records applied
POLL_CAUGHT_UP = "caught_up"  # primary answered via digest catch-up
POLL_FAILED = "failed"       # transport failure, below the threshold
POLL_PROMOTED = "promoted"   # threshold crossed: this poll promoted us


class ShardStandby:
    """Warm standby for one shard frontend (module docstring).

    Owns a constructed-but-not-serving ``ServeFrontend`` whose node it
    feeds from the primary's WAL stream; ``promote()`` turns that
    frontend into the keyspace's serving member.  Single promotion per
    instance; the standby owns the frontend until ``close()``.
    """

    def __init__(self, primary, frontend, *, sid: str,
                 standby_id: str = "shard-standby",
                 listen_addr: Optional[Addr] = None,
                 announce_to=None,
                 poll_interval_s: float = 0.1,
                 failure_threshold: int = 5,
                 poll_timeout_s: float = 2.0,
                 wait_ms: int = 300,
                 max_records: int = 256):
        from go_crdt_playground_tpu_torch.serve.client import normalize_addrs

        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if frontend.durable_dir is None:
            raise ValueError("a shard standby needs a durable frontend "
                             "(its replica and fenced epoch must "
                             "survive its own restart)")
        self.primary: List[Addr] = normalize_addrs(primary)
        self.frontend = frontend
        self.sid = sid
        self.standby_id = standby_id
        self.listen_addr = (None if listen_addr is None
                            else (listen_addr[0], int(listen_addr[1])))
        self.announce_to: Optional[List[Addr]] = (
            None if announce_to is None else normalize_addrs(announce_to))
        self.poll_interval_s = float(poll_interval_s)
        self.failure_threshold = int(failure_threshold)
        self.poll_timeout_s = float(poll_timeout_s)
        self.wait_ms = int(wait_ms)
        self.max_records = int(max_records)
        self.recorder = frontend.recorder
        self._lock = threading.Lock()
        # whole-promotion serialization, the shard/ha.py shape: the
        # order is _promote_lock -> _lock, never the reverse
        self._promote_lock = threading.Lock()
        self._client = None  # guarded-by: _lock
        self._failures = 0  # guarded-by: _lock
        self._cursor = 1  # guarded-by: _lock
        self._nonce: Optional[str] = None  # guarded-by: _lock
        self._need_catchup = False  # guarded-by: _lock
        self._tailed_ever = False  # guarded-by: _lock
        self._last_primary_epoch = load_shard_epoch(
            frontend.durable_dir)  # guarded-by: _lock
        self._promote_reason: Optional[str] = None  # guarded-by: _lock
        self._promotion_s: Optional[float] = None  # guarded-by: _lock
        self._announce_result: Optional[dict] = None  # guarded-by: _lock
        self._promoted = threading.Event()
        self._stop_loop = threading.Event()
        # race-ok: start()/close() owner thread only
        self._thread: Optional[threading.Thread] = None
        # build and run the whole serving path NOW: promotion must pay a
        # bind + announce, not a first-batch kernel build
        # (the exact stall ServeFrontend._warmup exists to prevent —
        # here it would land inside the failover budget)
        frontend.warmup()

    # -- observers ----------------------------------------------------------

    @property
    def promoted(self) -> bool:
        return self._promoted.is_set()

    @property
    def tailed_ever(self) -> bool:
        with self._lock:
            return self._tailed_ever

    @property
    def cursor(self) -> int:
        with self._lock:
            return self._cursor

    @property
    def promote_reason(self) -> Optional[str]:
        with self._lock:
            return self._promote_reason

    @property
    def promotion_s(self) -> Optional[float]:
        with self._lock:
            return self._promotion_s

    @property
    def announce_result(self) -> Optional[dict]:
        with self._lock:
            return (None if self._announce_result is None
                    else dict(self._announce_result))

    def await_promoted(self, timeout_s: float) -> bool:
        return self._promoted.wait(timeout_s)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("standby already running")
        self._stop_loop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name=f"shard-standby-{self.sid}",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop_loop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.poll_timeout_s + self.wait_ms / 1e3
                   + self.poll_interval_s + 10.0)
        self._drop_client()

    def close(self) -> None:
        self.stop()
        # a racing manual promote() finishes (or unwinds) before the
        # frontend is torn down — the shard/ha.py close discipline
        with self._promote_lock:
            pass
        self.frontend.close()

    def __enter__(self) -> "ShardStandby":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _loop(self) -> None:
        while not self._stop_loop.wait(self.poll_interval_s):
            try:
                if self.poll_once() == POLL_PROMOTED:
                    return
            except Exception:  # noqa: BLE001 — the standby must outlive
                # any single bad poll; the next wake retries (and a
                # promotion failure retries the same way: the failure
                # count is still past threshold)
                self._count("repl.loop_errors")

    # -- the tail/health/promotion state machine ----------------------------

    def poll_once(self) -> str:
        """One tail/health probe (exposed so tests drive the state
        machine without wall-clock waits).  Returns a ``POLL_*``
        verdict."""
        import socket as socket_mod

        if self._promoted.is_set():
            return POLL_PROMOTED
        self._count("repl.tail_polls")
        with self._lock:
            cursor = self._cursor
            catchup = self._need_catchup
        try:
            if catchup:
                verdict = self._catch_up(cursor)
            else:
                verdict = self._tail(cursor)
        except (OSError, ConnectionError, socket_mod.timeout) as e:
            self._drop_client()
            self._count("repl.poll_failures")
            with self._lock:
                self._failures += 1
                failures = self._failures
                tailed = self._tailed_ever
            if failures >= self.failure_threshold:
                if not tailed and load_shard_epoch(
                        self.frontend.durable_dir) == 0:
                    # never tailed and no persisted epoch: this standby
                    # holds neither the primary's state nor its epoch —
                    # promoting would serve an EMPTY replica under an
                    # epoch that can collide with the primary's own.
                    # Warm means tailed; keep polling, let the operator
                    # see the counter
                    self._count("repl.promote_blocked")
                    return POLL_FAILED
                self.promote(reason=f"{failures} consecutive WAL_SYNC "
                                    f"poll failures: {e}")
                return POLL_PROMOTED
            return POLL_FAILED
        with self._lock:
            self._failures = 0
        return verdict

    def _tail(self, cursor: int) -> str:
        """One WAL_SYNC tail poll: apply the shipped records in order,
        advance the cursor (the NEXT poll's cursor is the durable
        ack)."""
        reply = self._tail_client().wal_sync(
            cursor, standby_id=self.standby_id, wait_ms=self.wait_ms,
            max_records=self.max_records)
        self._ingest_epoch(reply.shard_epoch)
        from go_crdt_playground_tpu_torch.serve import protocol

        with self._lock:
            nonce_changed = (self._nonce is not None
                             and self._nonce != reply.nonce)
            self._nonce = reply.nonce
        if nonce_changed or (reply.flags & protocol.WAL_TRUNCATED):
            # the primary restarted (renumbered cursor space) or
            # checkpoint-truncated under our cursor: typed, never a
            # silent gap — catch up O(diff) next poll
            with self._lock:
                self._need_catchup = True
                self._cursor = max(1, int(reply.next_seq))
            self._count("repl.cursor_resets")
            return POLL_TAILED
        node = self.frontend.node
        applied = 0
        for i, body in enumerate(reply.records):
            seq = reply.first_seq + i
            if seq < cursor:
                continue  # overlap after a catch-up: idempotent skip
            verdict = node.apply_wal_record(body)
            if verdict == "future":
                # a gap (should be impossible on an in-order stream):
                # never skip past it — digest catch-up re-proves the
                # state instead
                self._count("repl.apply_future")
                with self._lock:
                    self._need_catchup = True
                break
            applied += 1
            with self._lock:
                self._cursor = seq + 1
                self._tailed_ever = True
        if applied:
            self._count("repl.tail_records", applied)
        with self._lock:
            if not self._tailed_ever and reply.next_seq <= 1:
                # an EMPTY primary log is still a successful tail: the
                # standby mirrors an empty replica (promoting it serves
                # exactly what a primary restart would)
                self._tailed_ever = True
        return POLL_TAILED

    def _catch_up(self, cursor: int) -> str:
        """O(diff) digest-sync catch-up (module docstring): ship our
        summary, apply the primary's mismatched-lane payload, resume
        tailing from the fresh cursor."""
        from go_crdt_playground_tpu_torch.net import digestsync

        node = self.frontend.node
        summary = digestsync.node_summary(node)
        reply = self._tail_client().wal_sync(
            max(1, cursor), standby_id=self.standby_id,
            summary=summary)
        self._ingest_epoch(reply.shard_epoch)
        if reply.payload is not None:
            node.apply_payload_body(reply.payload)
        with self._lock:
            self._nonce = reply.nonce
            self._cursor = max(1, int(reply.next_seq))
            self._need_catchup = False
            self._tailed_ever = True
        self._count("repl.catchups")
        return POLL_CAUGHT_UP

    def _ingest_epoch(self, epoch: int) -> None:
        """Remember (and persist) the primary's shard epoch: the
        promotion bumps past it, and a persisted tailed epoch is what
        keeps a RESTARTED standby warm (the never-tailed promote guard
        would otherwise block it forever against a dead primary)."""
        epoch = int(epoch or 0)
        with self._lock:
            if epoch <= self._last_primary_epoch:
                return
            self._last_primary_epoch = epoch
        persist_shard_epoch(self.frontend.durable_dir, epoch,
                            f"tailed:{self.sid}")

    def promote(self, reason: str = "manual"):
        """The promotion sequence (module docstring): persist the
        bumped epoch FIRST, claim the keyspace at the router, depose
        the old primary best-effort, then serve.  Single-entry end to
        end; a concurrent call blocks, then returns with the winner's
        promotion standing."""
        t0 = time.monotonic()
        with self._promote_lock:
            return self._promote_locked(reason, t0)

    # requires-lock: _promote_lock
    def _promote_locked(self, reason: str, t0: float):
        from go_crdt_playground_tpu_torch.serve.client import ServeClient

        if self._promoted.is_set():
            return self.frontend
        with self._lock:
            epoch = max(self._last_primary_epoch,
                        load_shard_epoch(self.frontend.durable_dir)) + 1
        # 1. the fence root: the claimed epoch is durable before anyone
        # can hear it (a standby crash mid-promotion re-promotes at an
        # equal-or-higher epoch, never lower)
        persist_shard_epoch(self.frontend.durable_dir, epoch,
                            self.standby_id)
        self.frontend.claim_shard_epoch(epoch)
        # 2. the keyspace claim: the router adjudicates the epoch
        # durably and swaps this sid's downstream address.  Bounded
        # retries — the router may itself be failing over (its HA pair
        # is an ordered list here) — but an unreachable router does NOT
        # block serving: the router's per-shard ordered address list
        # rotates to us on its next redial, and the fence completes at
        # the next successful announce (serve()-time re-announce).
        announce: Optional[dict] = None
        if self.announce_to is not None and self.listen_addr is not None:
            announce = self._announce_router(epoch)
        # 3. best-effort deposition notice to the old primary: a
        # false-positive promotion (network blip, not a death) leaves
        # it alive and acking — one WAL_SYNC epoch claim flips its
        # self-fence so its writes shed typed instead of landing on a
        # member the router no longer reads.  A dead primary learns
        # the same thing from its serve()-time router announce.
        try:
            with ServeClient(self.primary, timeout=self.poll_timeout_s,
                             connect_timeout=1.0) as c:
                c.wal_sync(1, epoch=epoch, standby_id=self.standby_id)
        except (OSError, ConnectionError):
            pass  # dead primary: the normal case
        # 4. serve on the pre-declared address — the router's swapped
        # link (and its ordered-list redial fallback) lands here
        if self.listen_addr is not None:
            self.frontend.serve(self.listen_addr[0], self.listen_addr[1])
        self._count("repl.promotions")
        with self._lock:
            self._promotion_s = time.monotonic() - t0
            self._promote_reason = reason
            self._announce_result = announce
        self._promoted.set()
        return self.frontend

    # requires-lock: _promote_lock
    def _announce_router(self, epoch: int) -> Optional[dict]:
        from go_crdt_playground_tpu_torch.serve import protocol
        from go_crdt_playground_tpu_torch.serve.client import ServeClient

        last: Optional[dict] = None
        for attempt in range(3):
            try:
                with ServeClient(self.announce_to,
                                 timeout=self.poll_timeout_s,
                                 connect_timeout=1.0) as c:
                    last = c.shard_failover(epoch, self.sid,
                                            self.standby_id,
                                            self.listen_addr)
                    return last
            except protocol.StaleShardEpoch:
                # a HIGHER epoch is already adjudicated: someone
                # promoted past us mid-promotion.  Serve anyway (the
                # router never routes here) but surface it loudly
                self._count("repl.promote_stale")
                return {"stale": True}
            except (OSError, ConnectionError, protocol.ServeError):
                time.sleep(0.2 * (attempt + 1))
        self._count("repl.announce_failures")
        return last

    # -- plumbing -----------------------------------------------------------

    def _tail_client(self):
        from go_crdt_playground_tpu_torch.serve.client import ServeClient

        with self._lock:
            client = self._client
        if client is not None and not client.closed:
            return client
        self._drop_client()
        # reply timeout must cover the long-poll window
        client = ServeClient(
            self.primary,
            timeout=self.poll_timeout_s + self.wait_ms / 1e3,
            connect_timeout=self.poll_timeout_s,
            max_reply_body=max(ServeClient.MAX_REPLY_BODY,
                               32 * self.frontend.node.num_elements
                               + (1 << 20)))
        with self._lock:
            self._client = client
        return client

    def _drop_client(self) -> None:
        with self._lock:
            client, self._client = self._client, None
        if client is not None:
            try:
                client.close()
            except OSError:
                pass

    def _count(self, name: str, n: int = 1) -> None:
        if self.recorder is not None:
            self.recorder.count(name, n)
