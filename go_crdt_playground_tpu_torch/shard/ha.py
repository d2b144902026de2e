"""Router high availability: a warm standby with fenced promotion
(DESIGN.md §22).

Every durability ladder below the routing tier survives SIGKILL with
zero acked-op loss — but the ``ShardRouter`` itself was one process: a
dead router took the whole fleet dark even though every shard beneath
it kept serving.  ``RouterStandby`` closes that hole with the cheapest
correct shape the existing machinery allows:

* **tail** — the standby polls the primary's ``RING_SYNC`` record (the
  committed ``RouteState``: generation, owner-map digest, shard map
  WITH addresses, the handoff-epoch counter, the primary's router
  epoch) and persists it into its own ``state_dir`` in the exact
  ``ring.json`` shape ``shard/handoff.py`` commits — so promotion is
  literally the router-restart path: ``ShardRouter(state_dir=...)``
  adopts the last ring the primary COMMITTED, never a staged or
  half-transferred one (a kill mid-handoff reads as aborted, same as a
  primary restart).
* **health-check** — the same poll is the health probe: N consecutive
  transport failures (connection refused/torn/timeout) trip promotion.
  One wrong promotion is SAFE, not split-brain: the data plane through
  either router is idempotent CRDT traffic over the same committed
  ring, and the admin plane is epoch-fenced below.
* **promote** — the standby persists ``router_epoch =
  max(primary's, own) + 1`` (fsync-then-rename, BEFORE anything is
  announced or served), constructs a real ``ShardRouter`` over the
  tailed ring under that epoch, ANNOUNCES the epoch to every reachable
  shard (``announce_epoch`` fan-out — from each shard's fsync on, any
  admin verb under a lower epoch rejects typed ``StaleRouterEpoch``),
  then binds its pre-declared listen address.  Clients carrying the
  ordered address list (``ServeClient`` failover) rotate to it; their
  in-flight ops surfaced typed-ambiguous and resubmit idempotently.
* **deposed primary** — a resurrected primary still serves reads and
  idempotent OPs (harmless: same ring, CRDT join), but every admin
  action is contained: its links announce the OLD epoch per connection
  and the shards reject typed, so it can never commit a reshard
  transfer or force a GC drop; its own RESHARD verb also refuses once
  it HEARS the higher epoch (the router self-fence).

Counters: ``router.ha.polls`` / ``router.ha.poll_failures`` /
``router.ha.tail_records`` / ``router.ha.promotions``.
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Dict, Mapping, Optional, Tuple

from go_crdt_playground_tpu_torch.shard.handoff import (PHASE_COMMITTED,
                                                  RING_FILE,
                                                  load_router_epoch,
                                                  persist_router_epoch,
                                                  write_json_atomic)
from go_crdt_playground_tpu_torch.shard.router import ShardRouter

Addr = Tuple[str, int]

# poll_once() verdicts (the state-machine seam tests drive directly)
POLL_TAILED = "tailed"       # primary answered; record tailed/persisted
POLL_FAILED = "failed"       # transport failure, below the threshold
POLL_PROMOTED = "promoted"   # threshold crossed: this poll promoted us


class RouterStandby:
    """Warm standby for one ``ShardRouter`` primary (module docstring).

    Single promotion per instance: after ``promote()`` the standby IS
    a serving router (``self.router``) and the tail loop exits.  The
    standby owns the router it creates until ``close()``.
    """

    def __init__(self, primary: Addr, shards: Mapping[str, Addr],
                 num_elements: int, *, seed: int = 0,
                 state_dir: Optional[str] = None,
                 standby_id: str = "router-standby",
                 listen_addr: Optional[Addr] = None,
                 poll_interval_s: float = 0.25,
                 failure_threshold: int = 3,
                 poll_timeout_s: float = 2.0,
                 recorder=None,
                 router_kwargs: Optional[dict] = None):
        from go_crdt_playground_tpu_torch.obs import Recorder

        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        from go_crdt_playground_tpu_torch.serve.client import normalize_addrs

        self.primary = (primary[0], int(primary[1]))
        # values may be single pairs or ordered replication-group
        # rosters (DESIGN.md §23); keep whatever shape arrives — the
        # promoted ShardRouter normalizes either
        norm = {sid: normalize_addrs(a) for sid, a in shards.items()}
        self.shards = {sid: (addrs[0] if len(addrs) == 1 else addrs)
                       for sid, addrs in norm.items()}
        self.num_elements = int(num_elements)
        self.seed = int(seed)
        self.state_dir = state_dir
        if state_dir is not None:
            import os

            os.makedirs(state_dir, exist_ok=True)
        self.standby_id = standby_id
        self.listen_addr = (None if listen_addr is None
                            else (listen_addr[0], int(listen_addr[1])))
        self.poll_interval_s = float(poll_interval_s)
        self.failure_threshold = int(failure_threshold)
        self.poll_timeout_s = float(poll_timeout_s)
        self.recorder = recorder if recorder is not None else Recorder()
        # extra ShardRouter kwargs the promotion passes through
        # (timeouts, breaker knobs) — race-ok: read-only after __init__
        self.router_kwargs = dict(router_kwargs or {})
        self._lock = threading.Lock()
        # serializes the WHOLE promotion sequence (epoch persist →
        # router build → announce → bind): the router-is-None check at
        # promote() entry alone would let a manual promote racing the
        # poll loop build two live routers — with listen_addr the loser
        # merely fails on bind, but embedded (listen_addr=None) both
        # would survive and one leaks its shard links and readers.
        # Never held while _lock is held the other way: the order is
        # _promote_lock -> _lock
        self._promote_lock = threading.Lock()
        self._client = None  # guarded-by: _lock
        self._failures = 0  # guarded-by: _lock
        self._last_record: Optional[Dict] = None  # guarded-by: _lock
        self._last_primary_epoch = load_router_epoch(
            state_dir)  # guarded-by: _lock
        self._persisted_generation: Optional[int] = None  # guarded-by: _lock
        self.router: Optional[ShardRouter] = None  # guarded-by: _lock
        self._promotion_s: Optional[float] = None  # guarded-by: _lock
        self._announce_results: Dict = {}  # guarded-by: _lock
        self._promote_reason: Optional[str] = None  # guarded-by: _lock
        self._warned_epoch_zero = False  # guarded-by: _lock
        self._promoted = threading.Event()
        self._stop_loop = threading.Event()
        # race-ok: start()/close() owner thread only
        self._thread: Optional[threading.Thread] = None

    # -- observers ----------------------------------------------------------

    @property
    def promoted(self) -> bool:
        return self._promoted.is_set()

    @property
    def last_record(self) -> Optional[Dict]:
        """The most recently tailed primary record (None before the
        first successful poll)."""
        with self._lock:
            return (None if self._last_record is None
                    else dict(self._last_record))

    @property
    def promotion_s(self) -> Optional[float]:
        """Wall seconds the promotion itself took (persist epoch →
        router constructed → fleet announced → listener bound)."""
        with self._lock:
            return self._promotion_s

    @property
    def announce_results(self) -> Dict:
        """sid -> True | failure string from the promotion announce."""
        with self._lock:
            return dict(self._announce_results)

    @property
    def promote_reason(self) -> Optional[str]:
        """Why this standby promoted (None before promotion)."""
        with self._lock:
            return self._promote_reason

    def await_promoted(self, timeout_s: float) -> bool:
        return self._promoted.wait(timeout_s)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("standby already running")
        self._stop_loop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="router-standby",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the tail loop (the promoted router, if any, keeps
        serving — ``close()`` tears everything down)."""
        self._stop_loop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.poll_timeout_s
                   + self.poll_interval_s + 10.0)
        self._drop_client()

    def close(self) -> None:
        self.stop()
        # _promote_lock: a manual promote() mid-sequence finishes (or
        # unwinds) before the router is read — without it, close()
        # could observe router=None while the racing promote is between
        # construction and the store, leaking the router it builds
        # (shard links, reader threads, a bound listener)
        with self._promote_lock:
            with self._lock:
                router = self.router
        if router is not None:
            router.close()

    def __enter__(self) -> "RouterStandby":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _loop(self) -> None:
        while not self._stop_loop.wait(self.poll_interval_s):
            try:
                if self.poll_once() == POLL_PROMOTED:
                    return
            except Exception:  # noqa: BLE001 — the standby must
                # outlive any single bad poll; the next wake retries
                # (a promotion failure is retried the same way: the
                # failure count is still past threshold)
                self._count("router.ha.loop_errors")

    # -- the tail/health/promotion state machine ----------------------------

    def poll_once(self) -> str:
        """One tail/health probe (the loop body, exposed so tests
        drive the state machine without wall-clock waits).  Returns a
        ``POLL_*`` verdict."""
        import socket as socket_mod

        if self._promoted.is_set():
            return POLL_PROMOTED
        self._count("router.ha.polls")
        try:
            record = self._tail_client().ring_sync(0, self.standby_id)
        except (OSError, ConnectionError, socket_mod.timeout) as e:
            self._drop_client()
            self._count("router.ha.poll_failures")
            with self._lock:
                self._failures += 1
                failures = self._failures
                tailed = self._last_record is not None
            if failures >= self.failure_threshold:
                if not tailed and load_router_epoch(self.state_dir) == 0:
                    # NEVER tailed (and no prior epoch on disk): this
                    # standby holds neither the primary's committed
                    # ring nor its epoch — promoting would serve the
                    # possibly-stale FLAG ring under an epoch that can
                    # COLLIDE with the primary's own (equal epochs
                    # adjudicate as current: no fence).  Warm means
                    # tailed; keep polling and let the operator see
                    # the counter instead
                    self._count("router.ha.promote_blocked")
                    return POLL_FAILED
                self.promote(reason=f"{failures} consecutive poll "
                                    f"failures: {e}")
                return POLL_PROMOTED
            return POLL_FAILED
        self._ingest_record(record)
        return POLL_TAILED

    def _ingest_record(self, record: Dict) -> None:
        """Adopt one tailed primary record: reset the failure count,
        remember the primary's epoch, persist the committed ring in
        the restart-adoptable shape (only when the generation moved —
        tail polls are frequent and fsyncs are not free)."""
        generation = record.get("generation")
        warn_epoch_zero = False
        with self._lock:
            self._failures = 0
            self._last_record = dict(record)
            epoch = int(record.get("router_epoch", 0) or 0)
            if epoch == 0 and not self._warned_epoch_zero:
                self._warned_epoch_zero = True
                warn_epoch_zero = True
            persist_epoch = epoch > self._last_primary_epoch
            if persist_epoch:
                self._last_primary_epoch = epoch
            persist = (self.state_dir is not None
                       and record.get("shards")
                       and generation is not None
                       and generation != self._persisted_generation)
            if persist:
                self._persisted_generation = generation
        if warn_epoch_zero:
            # resurrection containment is only airtight when the
            # PRIMARY can rediscover the adjudicated epoch before
            # taking traffic again.  A state_dir primary probes the
            # shards at serve() regardless of its epoch, but one
            # started with neither --router-epoch >= 1 nor a state_dir
            # restarts blind after this standby promotes: deposed stays
            # False and it forwards ops over its stale ring — exactly
            # the acked-writes-stranded hazard the fence exists for.
            # Loud and counted, not fatal: epoch-0 primaries are every
            # pre-HA deployment, and the standby still contains the
            # admin plane either way.
            self._count("router.ha.primary_epoch_zero")
            warnings.warn(
                "RouterStandby is tailing a primary at router epoch 0; "
                "restart the primary with --router-epoch >= 1 (or a "
                "--state-dir) or a resurrected primary will not "
                "self-fence its data plane after a promotion",
                RuntimeWarning, stacklevel=2)
        if persist_epoch:
            # the tailed epoch is part of what makes this standby WARM:
            # without it on disk, a standby restart would read as
            # never-tailed and the promote guard would block forever
            # against a dead primary even though the committed ring IS
            # durable here (and promoting at tailed+1 can never collide)
            persist_router_epoch(self.state_dir, epoch,
                                 f"tailed:{record.get('router_id', '?')}")
        if persist:
            # the exact record shape HandoffCoordinator commits, so a
            # promotion (or a later restart of the promoted router)
            # adopts it through the unchanged load_ring_file path
            write_json_atomic(self.state_dir, RING_FILE, {
                "epoch": int(record.get("epoch", 0) or 0),
                "phase": PHASE_COMMITTED,
                "shards": {s: list(a)
                           for s, a in record["shards"].items()},
                "seed": int(record.get("seed", self.seed)),
                "elements": int(record.get("elements",
                                           self.num_elements)),
                "generation": int(generation),
                "digest": str(record.get("digest", "")),
                "tailed_from": record.get("router_id", "?"),
            })
            self._count("router.ha.tail_records")

    def promote(self, reason: str = "manual") -> ShardRouter:
        """The promotion sequence (module docstring): persist the
        bumped epoch FIRST, build the router over the tailed ring,
        announce the epoch fleet-wide, then bind the listener.
        Single-entry end to end (``_promote_lock``): a concurrent call
        blocks until the winner finishes, then returns the winner's
        router — never a second one."""
        t0 = time.monotonic()
        with self._promote_lock:
            return self._promote_locked(reason, t0)

    # requires-lock: _promote_lock
    def _promote_locked(self, reason: str, t0: float) -> ShardRouter:
        with self._lock:
            if self.router is not None:
                return self.router
            epoch = max(self._last_primary_epoch,
                        load_router_epoch(self.state_dir)) + 1
        # 1. the fence root: the claimed epoch is durable before any
        # shard can hear it (a standby crash mid-promotion re-promotes
        # at an equal-or-higher epoch, never a lower one)
        persist_router_epoch(self.state_dir, epoch, self.standby_id)
        # 2. the router: state_dir makes it adopt the tailed committed
        # ring over the constructor shard map (exactly the restart
        # path a SIGKILLed primary would take)
        router = ShardRouter(self.shards, self.num_elements,
                             seed=self.seed, state_dir=self.state_dir,
                             recorder=self.recorder,
                             router_epoch=epoch,
                             router_id=self.standby_id,
                             **self.router_kwargs)
        try:
            # 3. the fence fan-out: every reachable shard adjudicates
            # the new epoch now; unreachable ones learn it on first
            # admin contact (announce-per-connection in
            # _ShardLink._request)
            announce = router.announce_epoch()
            # 3b. best-effort deposition notice to the old primary: a
            # FALSE-POSITIVE promotion (network blip, not a death)
            # leaves it alive and forwarding — one RING_SYNC claim
            # flips its self-fence so it sheds typed instead of
            # forwarding over a ring this router may reshard past.  A
            # dead primary learns the same thing from the shards at
            # its own restart probe.
            try:
                from go_crdt_playground_tpu_torch.serve.client import \
                    ServeClient

                with ServeClient(self.primary,
                                 timeout=self.poll_timeout_s,
                                 connect_timeout=1.0) as c:
                    c.ring_sync(epoch, self.standby_id)
            except (OSError, ConnectionError):
                pass  # dead primary: the normal case
            # 4. serve on the pre-declared address — clients holding
            # the ordered address list rotate here on their next try
            if self.listen_addr is not None:
                router.serve(self.listen_addr[0], self.listen_addr[1])
        except BaseException:
            # partial promotion (e.g. the listen port is taken): the
            # retry loop re-enters promote() next poll — the router
            # built THIS attempt must not leak its shard-link sockets
            # and reader threads each round
            router.close()
            raise
        self._count("router.ha.promotions")
        with self._lock:
            self.router = router
            self._announce_results = dict(announce)
            self._promotion_s = time.monotonic() - t0
            self._promote_reason = reason
        self._promoted.set()
        return router

    # -- plumbing -----------------------------------------------------------

    def _tail_client(self):
        from go_crdt_playground_tpu_torch.serve.client import ServeClient

        with self._lock:
            client = self._client
        if client is not None and not client.closed:
            return client
        self._drop_client()
        client = ServeClient(self.primary, timeout=self.poll_timeout_s,
                             connect_timeout=self.poll_timeout_s)
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
