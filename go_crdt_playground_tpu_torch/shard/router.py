"""The router tier: one serve-dialect endpoint over N shard frontends.

``ShardRouter`` speaks ``serve/protocol.py`` on BOTH sides.  Upstream
it is indistinguishable from a ``ServeFrontend`` — an unmodified
``ServeClient`` dials it, pipelines OPs, and reads typed ACK/REJECT
back by req_id.  Downstream it holds one pipelined ``ServeClient`` per
shard frontend and forwards:

* **OP** — elements are grouped by the ACTIVE route's owner map (a
  ``shard/handoff.RouteState`` snapshot: ring + precomputed owner map +
  fence, swapped atomically by live resharding — the hot path reads one
  snapshot and one array lookup per element).  An op whose keys span
  shards fans out as one sub-op per owner; the upstream reply is ONE
  frame: ACK when every sub-op acked, else the first reject (relayed
  with the downstream's own code — the client sees what the shard
  said).  Sub-ops on reachable shards may have applied when another
  shard rejects; that is the protocol's at-least-once shape — CRDT ops
  are idempotent, the client resubmits the whole op.  An op naming a
  FENCED element (a slice mid-handoff) gets the typed retryable
  ``REJECT_MOVING`` — never applied anywhere, resubmit lands it on the
  post-swap owner.
* **QUERY** — fan-out to every shard; each shard's members are
  FILTERED BY OWNERSHIP before the union (a donor's stale copy of a
  moved slice must not shadow the new owner — the no-double-serve half
  of DESIGN.md §18), vv joined element-wise (shards tick disjoint actor
  lanes).  Unreachable shards are EXCLUDED and counted: the union is a
  correct CRDT lower bound (membership only inflates), not an error.
* **STATS** — fan-out; the JSON reply carries ``router`` (this tier's
  recorder), ``shards`` (per-shard snapshots, ``null`` for unreachable
  ones), ``aggregate`` (summed shard counters) and ``ring`` (the
  ACTIVE route's generation + owner-map digest + member list — how an
  operator or the fleet soak asserts which ring a router is actually
  serving; before this, a swapped ring was observationally invisible).
* **RESHARD** — the admin verb: stage a candidate ring, drive the
  keyspace handoff, swap atomically (``shard/handoff.py`` owns the
  state machine; a failed handoff replies typed failure with the old
  ring still serving).

**Degradation ladder** (the per-shard half of DESIGN.md §13's):
each shard link carries the EXISTING ``net/breaker.CircuitBreaker``
and a seeded ``utils/backoff.BackoffPolicy``-jittered redial gate.  A
dead shard costs its keyspace a typed ``REJECT_UNAVAILABLE`` per op —
never a silent drop, never a stall — while every other shard's
keyspace keeps serving; the breaker's HALF_OPEN probe re-admits the
shard the moment it answers again.  Downstream ops in flight when a
shard dies resolve as connection errors and relay upstream as the same
typed reject, so THROUGH the router every submitted op resolves
ack-or-typed-reject even across a shard SIGKILL (the fleet soak's
``unresolved == 0`` adjudication).

The listener/reader/conn-slot plumbing is the shared ``serve/host.py``
``ConnHost`` (the frontend runs the identical stack); relay threads
write upstream through the per-session writer queues
(serve/session.py), so one read-stalled client never blocks a shard
link's reply stream.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from go_crdt_playground_tpu_torch.net import framing
from go_crdt_playground_tpu_torch.net.breaker import CircuitBreaker
from go_crdt_playground_tpu_torch.serve import protocol
from go_crdt_playground_tpu_torch.serve.client import ServeClient, normalize_addrs
from go_crdt_playground_tpu_torch.serve.host import ConnHost
from go_crdt_playground_tpu_torch.serve.session import Session
from go_crdt_playground_tpu_torch.shard.handoff import (PHASE_COMMITTED,
                                                  RING_FILE,
                                                  HandoffCoordinator,
                                                  HandoffError, RouteState,
                                                  load_ring_file,
                                                  load_router_epoch,
                                                  load_shard_epochs,
                                                  persist_router_epoch,
                                                  persist_shard_epochs,
                                                  write_json_atomic)
from go_crdt_playground_tpu_torch.shard.ring import HashRing, load_stats
from go_crdt_playground_tpu_torch.utils.backoff import Backoff, BackoffPolicy

Addr = Tuple[str, int]


class _Unreachable(Exception):
    """Internal: the link could not take the sub-op (breaker open, dial
    or forward failed).  Always surfaces upstream as the typed
    ``REJECT_UNAVAILABLE`` — callers never let it escape the frame
    handler."""


class _DsumUnsupported(Exception):
    """Internal: the shard ANSWERED the DSUM probe with the legacy
    unknown-frame ``MSG_ERROR`` reply (a ``framing.RemoteError`` — the
    server really said it, as opposed to a locally-synthesized
    desync/teardown message that merely CONTAINS the same text).  The
    caller pins the sid to the uncached path; every other probe
    failure is transient and must stay re-probeable."""


class _OpRateWindow:
    """Per-shard forwarded-op counts in coarse time buckets — the
    windowed op-rate the fleet autopilot reads from STATS (DESIGN.md
    §21).  One-second buckets, a bounded ring of them per sid; readers
    get ops/s over the last ``window_s`` whole buckets (the current
    partial bucket is excluded so a poll landing early in a second
    cannot read an artificially low rate).  Cheap enough for the OP
    hot path: one lock hold + one dict update per sub-op group."""

    BUCKET_S = 1.0
    KEEP = 32  # bounded history: > any sane window_s

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # sid -> {bucket_epoch: count}, pruned to the last KEEP buckets
        self._buckets: Dict[str, Dict[int, int]] = {}  # guarded-by: _lock

    def note(self, sid: str, n: int = 1,
             now: Optional[float] = None) -> None:
        t = time.monotonic() if now is None else now
        epoch = int(t / self.BUCKET_S)
        with self._lock:
            b = self._buckets.setdefault(sid, {})
            b[epoch] = b.get(epoch, 0) + n
            if len(b) > self.KEEP:
                for old in sorted(b)[:len(b) - self.KEEP]:
                    del b[old]

    def drop(self, sid: str) -> None:
        """A shard that left the ring must not linger in the read-out."""
        with self._lock:
            self._buckets.pop(sid, None)

    def rates(self, window_s: float = 5.0,
              now: Optional[float] = None) -> Dict[str, float]:
        """sid -> forwarded ops/s over the last ``window_s`` COMPLETE
        buckets."""
        t = time.monotonic() if now is None else now
        current = int(t / self.BUCKET_S)
        n_buckets = max(1, int(window_s / self.BUCKET_S))
        lo = current - n_buckets
        with self._lock:
            return {
                sid: sum(c for ep, c in b.items()
                         if lo <= ep < current) / (n_buckets
                                                   * self.BUCKET_S)
                for sid, b in self._buckets.items()}


class _Relay:
    """One upstream OP's fan-out accounting: ack upstream only when
    every sub-op acked; the FIRST reject wins otherwise (deterministic
    for the common one-shard case; for spanning ops any reject means
    "resubmit", so which one the client sees is immaterial)."""

    __slots__ = ("_lock", "session", "req_id", "_remaining", "_reject")

    def __init__(self, session: Session, req_id: int, n_subops: int):
        self._lock = threading.Lock()
        self.session = session
        self.req_id = req_id
        self._remaining = n_subops  # guarded-by: _lock
        self._reject: Optional[Tuple[int, str]] = None  # guarded-by: _lock

    def resolve_one(self, reject: Optional[Tuple[int, str]]
                    ) -> Optional[Optional[Tuple[int, str]]]:
        """Record one sub-op outcome (None = acked).  Returns the final
        verdict — None-the-ack or (code, reason) — once ALL sub-ops
        resolved, else the not-done-yet sentinel ``None`` is NOT
        returned: the caller distinguishes via the wrapped tuple."""
        with self._lock:
            if reject is not None and self._reject is None:
                self._reject = reject
            self._remaining -= 1
            if self._remaining > 0:
                return None
            return (self._reject,)  # wrapped: (None,) means "ack now"


class _ShardLink:
    """Router-side state for ONE shard frontend: a lazily-dialed
    pipelined ServeClient, the breaker/backoff gate, and the
    downstream-req-id -> (_Relay, elements) map (the element list rides
    along so a reshard fence can count in-flight sub-ops touching the
    moving slice)."""

    # bound on the DIAL alone: a blackholed shard (SYN silently
    # dropped, no RST) must cost its keyspace at most this per breaker
    # probe, not the full reply timeout, and the cost is paid at most
    # once per cooldown because the breaker opens on the failure
    DIAL_TIMEOUT_S = 1.0

    # admin-plane calls that must be fenced by the router epoch: the
    # link ANNOUNCES its router's epoch (one RING_SYNC per dialed
    # connection) before driving any of these, so the shard can
    # adjudicate staleness per DESIGN.md §22
    ADMIN_CALLS = frozenset(
        {"slice_pull", "slice_push", "gc", "frontier"})

    def __init__(self, sid: str, addr, *, timeout_s: float,
                 breaker_threshold: int, breaker_cooldown_s: float,
                 policy: BackoffPolicy, seed: int, on_reply,
                 max_reply_body: Optional[int] = None,
                 router_epoch: int = 0, router_id: str = "",
                 on_deposed=None) -> None:
        self.sid = sid
        # ORDERED address list (DESIGN.md §23): the keyspace's active
        # member first, then its replication-group standbys.  Every
        # dial starts at the active member; the multi-address
        # ServeClient rotates on dial failure, so the keyspace comes
        # back through the promoted standby even before its
        # SHARD_FAILOVER announce lands (the announce then reorders
        # the roster durably).  race-ok: read-only after construction
        # (a failover swap builds a NEW link)
        self.addrs = normalize_addrs(addr)
        self.addr = self.addrs[0]
        self.timeout_s = timeout_s
        # the owning router's leadership epoch/id (0 = fence dormant,
        # pre-HA behavior).  race-ok: read-only after construction
        self.router_epoch = int(router_epoch)
        self.router_id = router_id
        # router._note_deposed (thread-safe): a shard adjudicated our
        # epoch stale — arm the router-wide self-fence
        self._on_deposed = on_deposed
        # reply-body cap for every client this link dials: the router
        # drives SLICE_PULL against shard frontends, and a donor slice
        # reply scales with the universe — the default 64MB ServeClient
        # ceiling would make a large-universe reshard permanently
        # impossible (every retry fails identically), so the router
        # sizes it from E like the frontend sizes its SLICE_PUSH cap
        self.max_reply_body = max_reply_body  # race-ok: read-only
        self._on_reply = on_reply  # router._relay_reply (thread-safe)
        self._lock = threading.Lock()
        self._client: Optional[ServeClient] = None  # guarded-by: _lock
        # latched by close(): a reader that raced past the router's
        # draining check must not redial a "closed" link (the leaked
        # client would outlive the router)
        self._closing = False  # guarded-by: _lock
        # req_ids are CONNECTION-scoped, so pending keys carry the dial
        # generation: a dead client's sweep can only ever resolve its
        # own generation's entries, never a successor's
        self._gen = 0  # guarded-by: _lock
        self._pending: Dict[Tuple[int, int],
                            Tuple[_Relay, Tuple[int, ...]]] = {}  # guarded-by: _lock
        # dial generation whose connection has ANNOUNCED the router
        # epoch (admin-plane fence): announce-once-per-connection, so
        # a redial re-announces and a deposed router's stale epoch is
        # re-adjudicated on every fresh connection
        self._announced_gen = 0  # guarded-by: _lock
        self.breaker = CircuitBreaker(
            failure_threshold=breaker_threshold,
            cooldown_s=breaker_cooldown_s)
        self._backoff = Backoff(policy, seed=seed)
        self._earliest_redial = 0.0  # guarded-by: _lock

    # -- dialing ------------------------------------------------------------

    # requires-lock: _lock
    def _sweep_dead_client_locked(self) -> Optional[ServeClient]:
        """Detach a client whose reader already exited (read-idle
        timeout on a quiet link, or the server went away between
        requests) so the caller redials instead of paying one doomed
        request to find out.  NOT a breaker failure: an idle-reaped
        connection says nothing about the shard's health.  The caller
        must close the returned client OUTSIDE the lock (its reader is
        already dead, but a racing death-sweep callback takes this
        lock)."""
        if self._client is not None and self._client.closed:
            client, self._client = self._client, None
            return client
        return None

    # requires-lock: _lock
    def _ensure_client_locked(self) -> ServeClient:
        if self._closing:
            raise _Unreachable(f"shard {self.sid} link closed")
        if self._client is not None:
            return self._client
        now = time.monotonic()
        if now < self._earliest_redial or not self.breaker.allow():
            raise _Unreachable(f"shard {self.sid} breaker open")
        gen = self._gen + 1
        try:
            client = ServeClient(
                self.addrs, timeout=self.timeout_s,
                connect_timeout=self.DIAL_TIMEOUT_S,
                max_reply_body=self.max_reply_body,
                on_result=lambda op: self._downstream_result(gen, op))
        except (OSError, ConnectionError) as e:
            self.breaker.record_failure()
            delay = self._backoff.next_delay()
            if delay is None:
                self._backoff.reset()
                delay = self._backoff.policy.cap_s
            self._earliest_redial = now + delay
            raise _Unreachable(
                f"shard {self.sid} dial failed: {e}") from e
        self.breaker.record_success()
        self._backoff.reset()
        self._earliest_redial = 0.0
        self._gen = gen
        self._client = client
        return client

    # requires-lock: _lock
    def _retire_client_locked(self, gen: int) -> Optional[ServeClient]:
        """Detach the current client if it is still generation ``gen``;
        the CALLER must close the returned client OUTSIDE the lock
        (close() joins the reader thread, and the reader takes this
        lock in the reply callback — closing under the lock would stall
        both sides on each other)."""
        if self._gen != gen or self._client is None:
            return None
        client, self._client = self._client, None
        self.breaker.record_failure()
        return client

    def submit(self, relay: _Relay, kind: int, elements: Sequence[int],
               deadline_s: Optional[float]) -> None:
        """Forward one sub-op; registers the relay BEFORE the reply can
        race back (submit + register share the lock the reply callback
        takes).  Raises ``_Unreachable`` — the caller owes the relay a
        typed resolve_one."""
        retired: List[Optional[ServeClient]] = []
        try:
            with self._lock:
                retired.append(self._sweep_dead_client_locked())
                client = self._ensure_client_locked()
                gen = self._gen
                try:
                    op = client.submit_async(kind, elements,
                                             deadline_s=deadline_s)
                except (OSError, ConnectionError) as e:
                    # forward failed: the connection is dead.  Retire it
                    # (closed below, outside the lock) so the next op
                    # redials through the breaker; its in-flight ops
                    # resolve via its own sweep -> _downstream_result.
                    retired.append(self._retire_client_locked(gen))
                    raise _Unreachable(
                        f"shard {self.sid} send failed: {e}") from e
                self._pending[(gen, op.req_id)] = (relay, tuple(elements))
        finally:
            for r in retired:
                if r is not None:
                    r.close()

    def pending_touching(self, mask: np.ndarray) -> int:
        """In-flight sub-ops naming any masked element — the reshard
        fence waits this to zero before snapshotting the donor slice
        (every resolution is a durable donor ack or a typed reject)."""
        with self._lock:
            return sum(1 for _, elems in self._pending.values()
                       if any(mask[e] for e in elems))

    # -- reply path (runs on the downstream client's reader thread) ---------

    def _downstream_result(self, gen: int, op) -> None:
        with self._lock:
            entry = self._pending.pop((gen, op.req_id), None)
            if op.error is not None and not isinstance(
                    op.error, protocol.ServeError):
                # transport death: every pending op on this client is
                # being swept (generation-fenced: a stale sweep cannot
                # retire a successor client).  No close() here — the
                # sweep IS the client's own teardown path.
                self._retire_client_locked(gen)
        if entry is None:
            return
        relay, _ = entry
        if op.error is None:
            reject = None
        elif isinstance(op.error, protocol.ServeError):
            # relay the shard's own verdict, code-for-code
            code = protocol.REJECT_CODES.get(
                type(op.error), protocol.REJECT_OVERLOADED)
            reject = (code, f"shard {self.sid}: {op.error}")
        else:
            reject = (protocol.REJECT_UNAVAILABLE,
                      f"shard {self.sid} went away (retry): {op.error}")
        self._on_reply(relay, reject)

    # -- fan-out reads + handoff transfer -----------------------------------

    def _request(self, call: str, *args):
        """One synchronous request/reply on the link's client with the
        drop-on-failure treatment members()/stats() pioneered.  Admin
        calls (``ADMIN_CALLS``) first announce the router epoch on
        this connection — once per dial generation — so the shard's
        fence adjudicates every admin verb; a typed
        ``StaleRouterEpoch`` from the announce or the call itself
        PROPAGATES (deterministic: the router is deposed; the handoff
        machinery aborts typed, never retries the same epoch)."""
        stale = None
        try:
            with self._lock:
                stale = self._sweep_dead_client_locked()
                client = self._ensure_client_locked()
                gen = self._gen
                announce = (self.router_epoch > 0
                            and call in self.ADMIN_CALLS
                            and self._announced_gen != gen)
        finally:
            if stale is not None:
                stale.close()
        if announce:
            try:
                client.ring_sync(self.router_epoch, self.router_id)
            except protocol.ServeError as e:
                if (isinstance(e, protocol.StaleRouterEpoch)
                        and self._on_deposed is not None):
                    # the shard adjudicated us deposed: arm the router
                    # self-fence too (RESHARD/fleet-GC/OP shed typed
                    # from here on), then propagate — the handoff
                    # machinery aborts typed on this
                    self._on_deposed()
                raise  # typed adjudication: deposed
            except (OSError, ConnectionError, socket.timeout,
                    framing.RemoteError) as e:
                self._drop_client(gen)
                raise _Unreachable(
                    f"shard {self.sid} epoch announce failed: {e}"
                ) from e
            with self._lock:
                if self._gen == gen:
                    self._announced_gen = gen
        try:
            result = getattr(client, call)(*args)
        except (OSError, ConnectionError, socket.timeout,
                framing.RemoteError) as e:
            # RemoteError too: a shard answering MSG_ERROR (e.g. a
            # --shard flag pointed at the wrong dialect's port) must
            # count as unreachable, not kill the calling thread
            self._drop_client(gen)
            raise _Unreachable(
                f"shard {self.sid} {call} failed: {e}") from e
        if call == "ring_sync":
            # an explicit announce (promotion fan-out) also satisfies
            # the once-per-connection announce contract
            with self._lock:
                if self._gen == gen:
                    self._announced_gen = gen
        return result

    def members(self) -> Tuple[List[int], np.ndarray]:
        return self._request("members")

    def digest_summary(self) -> bytes:
        return self._request("digest_summary")

    def digest_summary_probe(self) -> bytes:
        """First-ever DSUM against this shard, on a THROWAWAY dial: a
        pre-digest frontend answers an unknown frame by ENDING the
        connection (the ConnHost dispatch-False contract), which on
        the shared pipelined client would also tear down every
        in-flight OP and charge the breaker for a healthy shard — so
        classification pays its one possible failure on its own
        socket.  Never touches the breaker.  Classification is by
        exception TYPE: only a ``framing.RemoteError`` (the server's
        own MSG_ERROR reply) proves the shard is a pre-digest build —
        a torn/desynced reply surfaces as a locally-synthesized
        ``ConnectionError`` that may CONTAIN the same "unexpected
        frame type" text and must stay transient/re-probeable."""
        try:
            probe = ServeClient(self.addrs, timeout=self.timeout_s,
                                connect_timeout=self.DIAL_TIMEOUT_S,
                                max_reply_body=self.max_reply_body)
        except (OSError, ConnectionError) as e:
            raise _Unreachable(
                f"shard {self.sid} dsum probe dial failed: {e}") from e
        try:
            return probe.digest_summary()
        except framing.RemoteError as e:
            if "unexpected frame type" in str(e):
                raise _DsumUnsupported(
                    f"shard {self.sid} is pre-digest: {e}") from e
            raise _Unreachable(
                f"shard {self.sid} dsum probe: {e}") from e
        except Exception as e:  # noqa: BLE001 — transient
            raise _Unreachable(
                f"shard {self.sid} dsum probe: {e}") from e
        finally:
            probe.close()

    def stats(self) -> dict:
        return self._request("stats")

    def announce_epoch(self) -> dict:
        """Announce the owning router's epoch to this shard (the
        promotion fence fan-out); returns the shard's epoch record.
        Raises typed ``StaleRouterEpoch`` when this router is already
        deposed — the caller must stop acting, not retry."""
        return self._request("ring_sync", self.router_epoch,
                             self.router_id)

    def frontier(self) -> Tuple[np.ndarray, np.ndarray, bool]:
        return self._request("frontier")

    def gc(self, fleet_frontier: np.ndarray) -> Tuple[int, int]:
        return self._request("gc", fleet_frontier)

    def slice_pull(self, elements: Sequence[int]) -> bytes:
        """Handoff donor read (typed ServeError rejects propagate — the
        coordinator decides retry-vs-abort per class)."""
        return self._request("slice_pull", elements)

    def slice_push(self, payload: bytes) -> None:
        """Handoff recipient write; returns once the shard durably
        applied the slice."""
        self._request("slice_push", payload)

    def _drop_client(self, gen: int) -> None:
        """Retire after a fan-out failure and CLOSE the retired client
        (a timeout on a live-but-slow connection would otherwise leak
        its socket + reader thread every poll)."""
        with self._lock:
            retired = self._retire_client_locked(gen)
        if retired is not None:
            retired.close()

    def close(self) -> None:
        with self._lock:
            self._closing = True
            client, self._client = self._client, None
        if client is not None:
            client.close()


class ShardRouter:
    """Serve-dialect TCP router over a dynamic shard fleet.

    ``shards`` maps shard id -> (host, port) of a ``serve --ingest``
    frontend — the INITIAL fleet; live resharding (the RESHARD admin
    verb) grows and shrinks it at runtime.  ``num_elements`` is the
    fleet-wide element universe the owner map is built over (every
    shard runs the same E; each owns the active ring's slice of it).
    With ``state_dir``, committed ring swaps persist (fsync-then-rename
    ``ring.json``) and a restarted router adopts the last COMMITTED
    ring over its CLI flags — a kill mid-handoff therefore restarts on
    the old ring (staged-but-uncommitted epochs read as aborted).
    """

    IDLE_TIMEOUT_S = 60.0
    MAX_FRAME_BODY = 1 << 20
    MAX_CONNS = 256

    def __init__(self, shards: Mapping[str, Addr], num_elements: int, *,
                 seed: int = 0, recorder=None,
                 downstream_timeout_s: float = 10.0,
                 breaker_threshold: int = 1,
                 breaker_cooldown_s: float = 0.5,
                 backoff: Optional[BackoffPolicy] = None,
                 max_conns: Optional[int] = None,
                 state_dir: Optional[str] = None,
                 fence_timeout_s: float = 10.0,
                 transfer_timeout_s: float = 30.0,
                 fleet_gc_interval_s: float = 0.0,
                 router_epoch: int = 0,
                 router_id: Optional[str] = None):
        from go_crdt_playground_tpu_torch.obs import Recorder

        if not shards:
            raise ValueError("a router needs at least one shard")
        self.recorder = recorder if recorder is not None else Recorder()
        self.num_elements = int(num_elements)
        # router-leadership epoch (DESIGN.md §22): monotone across the
        # HA pair, adjudicated by SHARDS on every admin-plane verb.  0
        # keeps the fence dormant (pre-HA deployments).  The persisted
        # record wins over a smaller flag so a restarted router can
        # never regress its own claim; a larger flag (a promotion)
        # persists before anything is announced or served.
        # race-ok: read-only after __init__ (a promotion constructs a
        # NEW router; nothing bumps a live router's own epoch)
        self.router_epoch = max(int(router_epoch),
                                load_router_epoch(state_dir))
        self.router_id = (router_id if router_id
                          else f"router-{os.getpid()}")
        self._state_dir = state_dir
        if state_dir is not None and self.router_epoch > 0:
            persist_router_epoch(state_dir, self.router_epoch,
                                 self.router_id)
        self._downstream_timeout_s = downstream_timeout_s
        self._breaker_threshold = breaker_threshold
        self._breaker_cooldown_s = breaker_cooldown_s
        self._policy = backoff if backoff is not None else BackoffPolicy(
            base_s=0.05, multiplier=2.0, cap_s=2.0, jitter=0.1,
            max_retries=4)
        self._seed = seed

        # values may be single (host, port) pairs or ORDERED address
        # lists (active member first, then replication-group standbys
        # — DESIGN.md §23); one normalization covers both shapes
        shard_map = {sid: normalize_addrs(a) for sid, a in shards.items()}
        generation = 0
        if state_dir is not None:
            rec = load_ring_file(state_dir)
            if rec is not None and rec.get("phase") == PHASE_COMMITTED:
                if (int(rec.get("elements", num_elements))
                        != int(num_elements)
                        or int(rec.get("seed", seed)) != int(seed)):
                    raise ValueError(
                        f"persisted ring in {state_dir!r} was committed "
                        f"under different (E, seed) than the flags — "
                        "delete ring.json to reset membership from flags")
                # the committed membership wins over the CLI flags: the
                # flags describe the fleet at FIRST launch, the record
                # describes it after every reshard AND every keyspace
                # failover since (the persisted order is active-first,
                # so a restart redials the promoted member)
                shard_map = {s: normalize_addrs(a)
                             for s, a in rec["shards"].items()}
                generation = int(rec.get("generation", 0))
                self._count("router.ring.restored")

        ring = HashRing(list(shard_map), seed=seed)
        owner = ring.owner_map(self.num_elements)
        self._lock = threading.Lock()
        # the hot path's atomic snapshot: ring + owner map + fence,
        # swapped whole by commit_route (immutable, so readers are
        # lock-free-consistent after one locked fetch)
        self._route = RouteState(  # guarded-by: _lock
            ring, owner, generation,
            ring.digest(self.num_elements, owner))
        self._links: Dict[str, _ShardLink] = {}  # guarded-by: _lock
        self._link_seq = 0  # guarded-by: _lock
        # the highest router epoch this router has ever HEARD claimed
        # (its own included): a RING_SYNC claim above our own means a
        # standby promoted past us — self-fence: refuse RESHARD and
        # fleet-GC rounds typed rather than drive admin verbs the
        # shards would reject one by one
        self._max_epoch_seen = self.router_epoch  # guarded-by: _lock
        # latched by announce_epoch(): serve() skips its startup probe
        # when the owner (the promotion path) already fanned it out
        # race-ok: single-writer latch, worst case one redundant probe
        self._announced_fleet = False
        # per-sid SHARD epochs (DESIGN.md §23): which replication-group
        # member the router has adjudicated as each keyspace's active
        # serving member.  Persisted fsync-then-rename BEFORE a
        # failover swap acts; a restart can never hand a keyspace back
        # to a deposed member.
        self._shard_epochs: Dict[str, int] = load_shard_epochs(
            state_dir)  # guarded-by: _lock
        # serializes whole failover adjudications (persist -> swap):
        # two racing claims for one sid must order their durable
        # records.  The order is _failover_lock -> _lock
        self._failover_lock = threading.Lock()
        with self._lock:
            for sid in ring.shards:
                self._links[sid] = self._new_link(sid, shard_map[sid])
        # op handlers between their fence check and their last submit,
        # counted PER FENCE EPOCH (set_fence bumps the epoch): the
        # reshard fence waits only for handlers that entered BEFORE it
        # went up — they might carry moved-slice ops it never rejected
        # — while post-fence handlers (which provably saw the fence)
        # can dial dead shards for seconds without wedging a handoff
        self._op_epoch = 0  # guarded-by: _lock
        self._inflight_by_epoch: Dict[int, int] = {}  # guarded-by: _lock
        # digest-guarded member cache (ROADMAP digest rung b): per
        # shard, the last MEMBERS reply keyed by the digest summary it
        # was fresh under.  QUERY fan-out fetches the O(E/16)-byte
        # summary first and re-pulls the O(membership) member set only
        # on mismatch — a quiescent fleet's repeated reads become
        # O(diff).  Safe because a replica's vv is monotone and rides
        # the summary: a stale summary key can never recur, so a
        # hit proves the cached reply is the one the shard would give
        # (to ops/digest.py's 2^-32-per-group collision bound).
        self._member_cache_lock = threading.Lock()
        self._member_cache: Dict[
            str, Tuple[bytes, List[int], np.ndarray]] = {}  # guarded-by: _member_cache_lock
        # bumped on every membership drop: a QUERY fan-out worker that
        # snapshotted its links BEFORE a reshard-leave can finish its
        # (seconds-long) members() pull AFTER the leave's eviction ran
        # — stores stamped with an older epoch are dropped, so a
        # departed sid can never be resurrected into the cache or the
        # DSUM classification (a rejoining sid may be a different
        # binary)
        self._member_cache_epoch = 0  # guarded-by: _member_cache_lock
        # DSUM classification, per sid until it leaves the ring:
        # supported sids ride the shared link client; sids that
        # answered the probe with the legacy "unexpected frame type"
        # error are queried uncached for good.  Unclassified sids
        # probe on a THROWAWAY dial (a legacy frontend ENDS the
        # connection on the unknown frame — on the shared client that
        # would tear down every in-flight OP).
        self._dsum_supported: set = set()  # guarded-by: _member_cache_lock
        self._dsum_unsupported: set = set()  # guarded-by: _member_cache_lock
        # per-shard windowed op-rate (the autopilot's imbalance signal,
        # exposed in STATS — no new wire verb); internally locked
        self._op_rates = _OpRateWindow()
        self._fleet_gc_interval_s = float(fleet_gc_interval_s)
        # race-ok: serve() owner thread only
        self._fleet_gc_thread: Optional[threading.Thread] = None
        self._closed = threading.Event()
        self.host = ConnHost(self._dispatch, recorder=self.recorder,
                             counter_prefix="router", thread_name="router",
                             max_conns=(self.MAX_CONNS if max_conns is None
                                        else max_conns),
                             idle_timeout_s=self.IDLE_TIMEOUT_S,
                             max_frame_body=self.MAX_FRAME_BODY)
        self.handoff = HandoffCoordinator(
            self, state_dir=state_dir, recorder=self.recorder,
            fence_timeout_s=fence_timeout_s,
            transfer_timeout_s=transfer_timeout_s, seed=seed)

    # -- route / link registry (the handoff seam) ---------------------------

    def route(self) -> RouteState:
        """The ACTIVE routing snapshot — take one per request and use
        it throughout; never mix fields from two takes."""
        with self._lock:
            return self._route

    @property
    def ring(self) -> HashRing:
        return self.route().ring

    @property
    def _owner(self) -> np.ndarray:
        # legacy read (tests/CLI banner): the active owner map
        return self.route().owner

    # requires-lock: _lock
    def _new_link(self, sid: str, addr: Addr) -> _ShardLink:
        self._link_seq += 1
        return _ShardLink(
            sid, addr, timeout_s=self._downstream_timeout_s,
            breaker_threshold=self._breaker_threshold,
            breaker_cooldown_s=self._breaker_cooldown_s,
            policy=self._policy, seed=self._seed * 1000 + self._link_seq,
            on_reply=self._relay_reply,
            router_epoch=self.router_epoch, router_id=self.router_id,
            on_deposed=self._note_deposed,
            # slice replies scale with the universe (the frontend's
            # SLICE_PUSH cap formula, §18); the 64MB floor keeps
            # MEMBERS/STATS bounded on small universes
            max_reply_body=max(ServeClient.MAX_REPLY_BODY,
                               16 * self.num_elements + 4096))

    def make_link(self, sid: str, addr: Addr) -> _ShardLink:
        """A STAGED link for a joining shard: full breaker/backoff
        machinery, but not in the routing registry — no client op can
        reach it until ``commit_route`` installs it."""
        with self._lock:
            return self._new_link(sid, addr)

    def link(self, sid: str) -> Optional[_ShardLink]:
        with self._lock:
            return self._links.get(sid)

    def links_snapshot(self) -> Dict[str, _ShardLink]:
        with self._lock:
            return dict(self._links)

    def shard_addr(self, sid: str) -> Addr:
        link = self.link(sid)
        if link is None:
            raise KeyError(sid)
        return link.addr

    def shard_roster(self, sid: str):
        """The sid's ordered address roster in the ring.json value
        shape: a legacy (host, port) pair when single, a list of
        pairs when the replication group has standbys — so a handoff
        commit's persisted record never silently drops a roster."""
        link = self.link(sid)
        if link is None:
            raise KeyError(sid)
        return (link.addrs[0] if len(link.addrs) == 1
                else [list(a) for a in link.addrs])

    def set_fence(self, fence: np.ndarray) -> None:
        with self._lock:
            self._route = self._route.with_fence(fence)
            # epoch bump under the SAME lock hold: any handler entering
            # after this observes the fenced route (one lock orders
            # its epoch read after ours and its route read after the
            # swap), so await_ops_settled need not wait for it
            self._op_epoch += 1

    def clear_fence(self) -> None:
        with self._lock:
            self._route = self._route.with_fence(None)

    def await_ops_settled(self, deadline: float) -> None:
        """Wait until every op handler that entered BEFORE the fence
        went up has left its fence-check-to-last-submit window — after
        this, every in-flight moved-slice sub-op is visible in some
        link's pending map, and every later op saw the fence.  Scoped
        to PRE-fence handlers on purpose: post-fence ops can be stuck
        a full DIAL_TIMEOUT_S against an unreachable (and unrelated)
        shard, and waiting for global quiescence would make resharding
        unavailable exactly when an operator is resizing around a
        failure."""
        with self._lock:
            fence_epoch = self._op_epoch
        while True:
            with self._lock:
                stale = sum(n for ep, n in self._inflight_by_epoch.items()
                            if ep < fence_epoch)
            if stale == 0:
                return
            if time.monotonic() > deadline:
                raise HandoffError(
                    f"{stale} pre-fence op handlers still in flight")
            time.sleep(0.002)

    def commit_route(self, ring: HashRing, owner: np.ndarray, digest: str,
                     *, add_sid: Optional[str] = None,
                     add_link: Optional[_ShardLink] = None,
                     drop_sid: Optional[str] = None) -> int:
        """The atomic swap: new ring + owner map under one lock hold,
        fence cleared, generation bumped; a leave's retired link closes
        OUTSIDE the lock (close joins its reader thread)."""
        retired = None
        with self._lock:
            if self._closed.is_set():
                # shutdown raced the commit: refuse rather than install
                # a live link into a swept registry.  The committed
                # ring record may already be persisted — harmless: a
                # restart adopts it, and its slices are already durable
                # on their recipients.
                raise HandoffError("router closed during commit")
            gen = self._route.generation + 1
            self._route = RouteState(ring, owner, gen, digest, None)
            if add_sid is not None and add_link is not None:
                self._links[add_sid] = add_link
            if drop_sid is not None:
                retired = self._links.pop(drop_sid, None)
        if drop_sid is not None:
            self._op_rates.drop(drop_sid)
            # a left shard's cached member set must not linger (its
            # link is gone, so nothing would ever refresh the entry),
            # and its DSUM classification resets with it — the sid
            # may rejoin as a different (upgraded or downgraded)
            # binary on the same id.  The epoch bump (same lock hold)
            # invalidates any in-flight fan-out worker's pending store
            # for the departed sid.
            with self._member_cache_lock:
                self._member_cache.pop(drop_sid, None)
                self._dsum_unsupported.discard(drop_sid)
                self._dsum_supported.discard(drop_sid)
                self._member_cache_epoch += 1
        if retired is not None:
            retired.close()
        return gen

    # -- lifecycle ----------------------------------------------------------

    def serve(self, host: str = "127.0.0.1", port: int = 0) -> Addr:
        if not self._announced_fleet and (self.router_epoch > 0
                                          or self._state_dir is not None):
            # HA deployments: announce/probe BEFORE taking traffic —
            # a resurrected deposed primary discovers the promoted
            # epoch here (the shards remember it durably) and starts
            # life self-fenced: admin verbs refuse typed AND the data
            # plane sheds typed, because forwarding ops over a ring
            # the promoted router may have resharded past could strand
            # acked writes on handoff donors (read-filtered, invisible
            # to fleet reads — the one thing zero-acked-op-loss can
            # never tolerate).  Gated on state_dir as well as epoch:
            # a primary left at the DEFAULT epoch 0 never persists a
            # claim, so an epoch test alone would let its resurrection
            # skip straight to forwarding over a possibly-stale ring —
            # with epoch 0 the probe is a pure RING_SYNC read, and a
            # shard record carrying any adjudicated epoch > 0 arms the
            # self-fence (announce_epoch's reply check).  Skipped when
            # the owner already fanned the announce out (the promotion
            # path) — one fleet RTT, not two, on the SIGKILL-to-serving
            # critical path.
            self.announce_epoch()
        addr = self.host.listen(host, port)
        if self._fleet_gc_interval_s > 0:
            self._fleet_gc_thread = threading.Thread(
                target=self._fleet_gc_loop, name="router-fleet-gc",
                daemon=True)
            self._fleet_gc_thread.start()
        return addr

    def _fleet_gc_loop(self) -> None:
        while not self._closed.wait(self._fleet_gc_interval_s):
            try:
                self.run_fleet_gc()
            except Exception:  # noqa: BLE001 — maintenance must never
                # take the router down; the next wake retries
                self._count("router.fleet_gc.errors")

    def close(self) -> None:
        if self._closed.is_set():
            return
        # set FIRST (under the route lock): from here commit_route
        # refuses, so a handoff racing shutdown can never install a
        # live link into the registry this method is about to sweep
        with self._lock:
            self._closed.set()
        self.host.stop_accepting()
        # downstream first: closing a link resolves its in-flight ops as
        # connection errors, which relay typed rejects through sessions
        # that are still open
        for link in self.links_snapshot().values():
            link.close()
        # one SHARED flush window across all sessions (the frontend's
        # drain shape): stalled clients cost ~1s total, not each
        self.host.close_sessions(flush_timeout_s=1.0)
        if self._fleet_gc_thread is not None:
            self._fleet_gc_thread.join(timeout=5.0)

    def __enter__(self) -> "ShardRouter":
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
        if msg_type == protocol.MSG_RESHARD:
            return self._handle_reshard(session, body)
        if msg_type == protocol.MSG_RING_SYNC:
            return self._handle_ring_sync(session, body)
        if msg_type == protocol.MSG_SHARD_FAILOVER:
            return self._handle_shard_failover(session, body)
        # The router DRIVES the verbs below against shard frontends; it
        # never serves them itself (W001 dispatcher-scoped exclusions):
        # protocol-ignore: MSG_SLICE_PULL — handoff donor read, driven
        # protocol-ignore: MSG_SLICE_PUSH — handoff recipient write, driven
        # protocol-ignore: MSG_FRONTIER — GC evidence read, driven
        # protocol-ignore: MSG_GC — fleet-frontier push, driven
        # protocol-ignore: MSG_DSUM — member-cache freshness read, driven
        # protocol-ignore: MSG_WAL_SYNC — shard-side replication tail
        # verb; standbys dial their primary SHARD, never the router
        session.send(framing.MSG_ERROR,
                     f"unexpected frame type {msg_type}".encode())
        return False

    # -- router HA: epoch record + self-fence (DESIGN.md §22) ---------------

    @property
    def deposed(self) -> bool:
        """True once a HIGHER router epoch than our own has been heard
        claimed: a standby promoted past this router.  The data plane
        (OP/QUERY/STATS) keeps serving — CRDT ops are safe through any
        correct ring holder — but admin actions refuse typed."""
        with self._lock:
            return self._max_epoch_seen > self.router_epoch

    def ring_record(self) -> Dict[str, object]:
        """The committed routing record a warm standby tails: ring
        generation/digest/membership WITH addresses, the handoff epoch
        counter, and this router's leadership epoch — everything a
        promotion needs to adopt the exact ring the primary last
        committed (shard/ha.py persists it in the ring.json shape a
        restarted/promoted router adopts)."""
        rt = self.route()
        links = self.links_snapshot()
        with self._lock:
            seen = self._max_epoch_seen
        return {
            "role": "router",
            "router_id": self.router_id,
            "router_epoch": self.router_epoch,
            "max_epoch_seen": seen,
            "generation": rt.generation,
            "digest": rt.digest,
            "seed": rt.ring.seed,
            "elements": self.num_elements,
            "epoch": self.handoff.epoch,
            # active member first; multi-member rosters ship as lists
            # of pairs (normalize_addrs reads both shapes back)
            "shards": {sid: (list(link.addrs[0])
                             if len(link.addrs) == 1
                             else [list(a) for a in link.addrs])
                       for sid, link in links.items()
                       if sid in rt.ring.shards},
        }

    # fence-ok: this verb IS the router-epoch fence mechanism — the
    # standby's tail read and the promotion's deposition notice both
    # ride it, and a deposed primary must keep answering so it can
    # learn (and persist) its own deposition
    def _handle_ring_sync(self, session: Session, body: bytes) -> bool:
        """Serve the tail read / adjudicate an epoch claim.  A claim
        above everything seen is NOTED (self-fence: this router stops
        admin actions) and acknowledged; a claim below the maximum is
        the deposed router itself — typed ``StaleRouterEpoch``."""
        try:
            req_id, epoch, router_id = protocol.decode_ring_sync(body)
        except framing.ProtocolError as e:
            session.send(framing.MSG_ERROR, str(e).encode())
            return False
        noted = False
        with self._lock:
            if epoch > self._max_epoch_seen:
                self._max_epoch_seen = epoch
                noted = True
            seen = self._max_epoch_seen
        if noted:
            self._count("router.epoch.noted")
        if 0 < epoch < seen:
            self._count("router.rejects.stale_epoch")
            session.send(protocol.MSG_REJECT, protocol.encode_reject(
                req_id, protocol.REJECT_STALE_EPOCH,
                f"router epoch {epoch} is stale: epoch {seen} "
                "already observed"))
            return True
        self._count("router.ring_syncs")
        session.send(protocol.MSG_RING_SYNC_REPLY,
                     protocol.encode_ring_sync_reply(
                         req_id, self.ring_record()))
        return True

    def _note_deposed(self) -> None:
        """A shard (or a RING_SYNC claimant) proved a HIGHER epoch
        exists: arm the self-fence.  The exact successor epoch is
        immaterial — ``deposed`` is a comparison, and our own epoch
        never changes on a live router."""
        with self._lock:
            if self._max_epoch_seen <= self.router_epoch:
                self._max_epoch_seen = self.router_epoch + 1
        self._count("router.epoch.noted")

    def _announce_one(self, sid: str, link: _ShardLink):
        try:
            return link.announce_epoch()
        except protocol.StaleRouterEpoch as e:
            # adjudicated deposed by this shard's durable fence (the
            # resurrection-discovery path: link._request only arms the
            # self-fence on the implicit admin-call announce, and this
            # was the EXPLICIT one)
            self._note_deposed()
            return e

    def announce_epoch(self) -> Dict[str, object]:
        """Fan this router's epoch out to every shard — the promotion
        fence, and the resurrection DISCOVERY probe: each shard either
        adopts/acks the epoch (its record rides back — a record
        carrying a higher adjudicated epoch arms our self-fence) or
        rejects it typed StaleRouterEpoch (we are deposed).  Returns
        sid -> True | the failure/verdict string.  An unreachable
        shard learns the epoch lazily on the first admin dial instead;
        promotion proceeds — the fence only needs to beat the deposed
        router to each shard, and the announce-per-connection
        discipline makes every later admin contact carry it."""
        results = self._fan_out_fn(self._announce_one)
        self._announced_fleet = True
        self._count("router.epoch.announces")
        out: Dict[str, object] = {}
        for sid, r in results.items():
            if isinstance(r, dict):
                if int(r.get("router_epoch", 0) or 0) > self.router_epoch:
                    self._note_deposed()
                out[sid] = True
            else:
                out[sid] = str(r)
        return out

    # -- shard replication: keyspace failover (DESIGN.md §23) ---------------

    def shard_epochs(self) -> Dict[str, int]:
        """The adjudicated per-sid shard epochs (STATS + tests)."""
        with self._lock:
            return dict(self._shard_epochs)

    def _handle_shard_failover(self, session: Session,
                               body: bytes) -> bool:
        """Adjudicate one keyspace-failover claim (or a restarting
        member's idempotent announce probe).  A deposed ROUTER refuses
        typed — its adjudications would desync from the promoted
        router's; the claimant's ordered router list retries there."""
        try:
            req_id, epoch, sid, owner_id, addr = \
                protocol.decode_shard_failover(body)
        except framing.ProtocolError as e:
            session.send(framing.MSG_ERROR, str(e).encode())
            return False
        if self.host.draining:
            session.send(protocol.MSG_REJECT, protocol.encode_reject(
                req_id, protocol.REJECT_DRAINING, "router draining"))
            return True
        if self.deposed:
            self._count("router.shard_failover.deposed")
            session.send(protocol.MSG_REJECT, protocol.encode_reject(
                req_id, protocol.REJECT_STALE_EPOCH,
                "router deposed (stale router epoch) — claim the "
                "keyspace at the promoted router"))
            return True
        try:
            record = self.failover_shard(sid, epoch, addr,
                                         owner=owner_id)
        except KeyError:
            self._count("router.rejects.invalid")
            session.send(protocol.MSG_REJECT, protocol.encode_reject(
                req_id, protocol.REJECT_INVALID,
                f"unknown shard id {sid!r}"))
            return True
        except protocol.StaleShardEpoch as e:
            self._count("router.rejects.stale_shard_epoch")
            session.send(protocol.MSG_REJECT, protocol.encode_reject(
                req_id, protocol.REJECT_STALE_SHARD_EPOCH, str(e)))
            return True
        session.send(protocol.MSG_SHARD_FAILOVER_REPLY,
                     protocol.encode_shard_failover_reply(req_id, record))
        return True

    def failover_shard(self, sid: str, epoch: int, addr: Addr, *,
                       owner: str = "?") -> Dict[str, object]:
        """Adopt ``addr`` as shard ``sid``'s active downstream member
        under shard epoch ``epoch`` (module-level story: the promoted
        standby's claim).  Durable-before-act: the adjudicated epoch
        map persists first, then the link swaps (new ordered roster,
        claimed member first), then the active-first address order
        persists into the committed ring record so a router restart
        redials the promoted member.  Raises typed
        ``StaleShardEpoch`` for a claim at or below the adjudicated
        epoch from a different address (the resurrected old primary),
        ``KeyError`` for an unknown sid.  An echo of the adjudicated
        state is idempotent-ok (``swapped: False``)."""
        addr = (addr[0], int(addr[1]))
        with self._failover_lock:
            with self._lock:
                link = self._links.get(sid)
                if link is None:
                    raise KeyError(sid)
                cur = self._shard_epochs.get(sid, 0)
                active = link.addrs[0]
                roster = list(link.addrs)
            if epoch < cur or (epoch == cur and addr != active):
                raise protocol.StaleShardEpoch(
                    f"shard epoch {epoch} for {sid} is stale: epoch "
                    f"{cur} already adjudicated at "
                    f"{active[0]}:{active[1]} (a standby was promoted "
                    "past this member)")
            if epoch == cur and addr == active:
                # the active member's idempotent announce probe
                return {"sid": sid, "shard_epoch": cur,
                        "swapped": False, "addr": list(active)}
            # 1. durable adjudication BEFORE the swap: a crash between
            # the two leaves the fence armed and the swap re-claimable
            # (the standby's announce is idempotent)
            with self._lock:
                epochs = dict(self._shard_epochs)
            epochs[sid] = epoch
            persist_shard_epochs(self._state_dir, epochs)
            # 2. the swap: a NEW link whose roster leads with the
            # claimed member (the old roster rides behind it so a
            # later failover can rotate back)
            new_roster = [addr] + [a for a in roster if a != addr]
            retired = None
            with self._lock:
                if self._closed.is_set():
                    raise HandoffError("router closed during failover")
                self._shard_epochs[sid] = epoch
                new_link = self._new_link(sid, new_roster)
                retired = self._links.get(sid)
                self._links[sid] = new_link
            # the swapped member may be a different binary/replica:
            # its cached member set and DSUM classification must not
            # survive the swap (the drop_sid eviction discipline)
            with self._member_cache_lock:
                self._member_cache.pop(sid, None)
                self._dsum_unsupported.discard(sid)
                self._dsum_supported.discard(sid)
                self._member_cache_epoch += 1
            if retired is not None:
                retired.close()
            # 3. persist the active-first order for restarts
            self._persist_addr_roster()
            self._count("router.shard_failovers")
            return {"sid": sid, "shard_epoch": epoch, "swapped": True,
                    "addr": list(addr), "owner": owner}

    def _persist_addr_roster(self) -> None:
        """Write the committed ring record with the CURRENT active-
        first address rosters (the failover half of ring persistence —
        membership and generation unchanged).  Single-addr rosters
        persist in the legacy pair shape, so pre-HA records stay
        byte-compatible."""
        if self._state_dir is None:
            return
        rt = self.route()
        links = self.links_snapshot()
        shards = {}
        for sid in rt.ring.shards:
            link = links.get(sid)
            if link is None:
                continue
            shards[sid] = (list(link.addrs[0]) if len(link.addrs) == 1
                           else [list(a) for a in link.addrs])
        write_json_atomic(self._state_dir, RING_FILE, {
            "epoch": self.handoff.epoch,
            "phase": PHASE_COMMITTED,
            "shards": shards,
            "seed": rt.ring.seed,
            "elements": self.num_elements,
            "generation": rt.generation,
            "digest": rt.digest,
        })

    # -- OP forwarding ------------------------------------------------------

    def _handle_op(self, session: Session, body: bytes) -> bool:
        try:
            req_id, kind, elements, deadline_us = protocol.decode_op(body)
        except framing.ProtocolError as e:
            session.send(framing.MSG_ERROR, str(e).encode())
            return False
        E = self.num_elements
        if any(not 0 <= e < E for e in elements):
            self._count("router.rejects.invalid")
            session.send(protocol.MSG_REJECT, protocol.encode_reject(
                req_id, protocol.REJECT_INVALID,
                f"element id outside universe E={E}"))
            return True
        if len(set(elements)) != len(elements):
            self._count("router.rejects.invalid")
            session.send(protocol.MSG_REJECT, protocol.encode_reject(
                req_id, protocol.REJECT_INVALID,
                "duplicate element ids in one op"))
            return True
        if self.host.draining:
            self._count("router.shed.draining")
            session.send(protocol.MSG_REJECT, protocol.encode_reject(
                req_id, protocol.REJECT_DRAINING, "router draining"))
            return True
        if self.deposed:
            # a deposed router must not forward ops: its ring may be
            # STALE relative to the promoted router's reshards, and an
            # op applied on a handoff donor is acked-but-read-filtered
            # — invisible to fleet reads, a silent acked-op loss.  The
            # typed reject tells an HA client to rotate (ServeClient
            # arms its failover on this code).
            self._count("router.shed.deposed")
            session.send(protocol.MSG_REJECT, protocol.encode_reject(
                req_id, protocol.REJECT_STALE_EPOCH,
                "router deposed (stale router epoch) — dial the "
                "promoted router"))
            return True
        # the in-flight window the reshard fence synchronizes with:
        # from BEFORE the fence check to AFTER the last sub-op is
        # registered in its link's pending map — an op can never both
        # miss the fence and be invisible to the fence's drain.
        # Epoch-tagged: set_fence bumps the epoch, so the fence only
        # waits for handlers that entered before it existed.
        with self._lock:
            op_epoch = self._op_epoch
            self._inflight_by_epoch[op_epoch] = (
                self._inflight_by_epoch.get(op_epoch, 0) + 1)
        try:
            rt = self.route()
            if rt.fenced(elements):
                self._count("router.shed.moving")
                session.send(protocol.MSG_REJECT, protocol.encode_reject(
                    req_id, protocol.REJECT_MOVING,
                    "keyspace slice mid-handoff (retry)"))
                return True
            # group by owner, preserving client key order per group
            groups: Dict[str, List[int]] = {}
            for e in elements:
                groups.setdefault(rt.owner_sid(e), []).append(e)
            self._count("router.ops.forwarded")
            if len(groups) > 1:
                self._count("router.ops.split")
            # deadline: forward the client's remaining budget unchanged
            # — grouping costs microseconds, and the shard re-anchors
            # it at its own admission (propagation, not re-guessing)
            deadline_s = deadline_us / 1e6 if deadline_us > 0 else None
            relay = _Relay(session, req_id, len(groups))
            for sid, elems in groups.items():
                # imbalance signal: forwarded SUB-OPS per shard per
                # second (counted at forward, not ack — the autopilot
                # watches offered pressure, which exists even while a
                # saturated shard sheds)
                self._op_rates.note(sid)
                # per-group lookup, not a dict copy per op: the common
                # single-shard op pays one lock hold, no allocation
                link = self.link(sid)
                try:
                    if link is None:
                        # a ring/links transition blink (the snapshot
                        # straddled a commit): typed retry, the resubmit
                        # routes by the settled ring
                        raise _Unreachable(f"shard {sid} not linked")
                    link.submit(relay, kind, elems, deadline_s)
                except _Unreachable as e:
                    self._count("router.shed.unavailable")
                    self._relay_reply(
                        relay, (protocol.REJECT_UNAVAILABLE, str(e)))
        finally:
            with self._lock:
                n = self._inflight_by_epoch.get(op_epoch, 0) - 1
                if n <= 0:
                    self._inflight_by_epoch.pop(op_epoch, None)
                else:
                    self._inflight_by_epoch[op_epoch] = n
        return True

    def _relay_reply(self, relay: _Relay,
                     reject: Optional[Tuple[int, str]]) -> None:
        """One sub-op resolved; sends the upstream frame when the whole
        op has.  Runs on downstream reader threads AND the upstream
        reader thread (unreachable-at-submit) — the relay's own lock
        arbitrates."""
        verdict = relay.resolve_one(reject)
        if verdict is None:
            return  # sub-ops still outstanding
        final = verdict[0]
        if final is None:
            self._count("router.acks.relayed")
            relay.session.send(protocol.MSG_ACK,
                               protocol.encode_ack(relay.req_id))
        else:
            code, reason = final
            self._count("router.rejects.relayed")
            relay.session.send(protocol.MSG_REJECT,
                               protocol.encode_reject(relay.req_id, code,
                                                      reason))

    # -- fan-out reads ------------------------------------------------------

    def _fan_out(self, call: str, *args) -> Dict[str, object]:
        """Run ``link.<call>(*args)`` on every shard concurrently; returns
        sid -> result or the _Unreachable error.  Thread-per-shard per
        request is a deliberate control-plane tradeoff: QUERY/STATS are
        orders of magnitude rarer than OPs, and the alternative (async
        QUERY plumbing through ServeClient or long-lived fan-out
        workers) buys nothing until read fan-out is a measured cost —
        revisit if dashboards ever poll hot."""
        return self._fan_out_fn(
            lambda sid, link: getattr(link, call)(*args))

    def _fan_out_fn(self, fn) -> Dict[str, object]:
        """The fan-out engine behind ``_fan_out``: run ``fn(sid, link)``
        per shard concurrently (the member-cache read needs a two-step
        per-shard call, not a single link method)."""
        links = self.links_snapshot()
        # pre-seeded: a worker that dies unexpectedly or outlives the
        # join bound leaves its sentinel in place, so the shard reads
        # as unreachable-and-counted — NEVER silently absent from the
        # union (indistinguishable from a smaller healthy fleet)
        results: Dict[str, object] = {
            sid: _Unreachable(f"shard {sid} fan-out timed out")
            for sid in links}
        lock = threading.Lock()

        def one(sid: str, link: _ShardLink) -> None:
            try:
                r = fn(sid, link)
            except _Unreachable as e:
                r = e
            except Exception as e:  # noqa: BLE001 — any escape still
                # counts as unreachable rather than a vanished shard
                r = _Unreachable(f"shard {sid} fan-out raised: {e}")
            with lock:
                results[sid] = r

        threads = [threading.Thread(target=one, args=(sid, link),
                                    daemon=True)
                   for sid, link in links.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self._downstream_timeout_s + 5.0)
        with lock:
            return dict(results)

    def _members_cached(self, sid: str, link: _ShardLink):
        """One shard's QUERY read through the digest-guarded member
        cache: fetch the summary (cheap), serve the cached member set
        on a byte-identical key, re-pull MEMBERS only on mismatch.
        Counters: ``router.member_cache.hits`` / ``.refreshes``.  A
        shard that cannot answer DSUM (pre-digest build) is pinned to
        the uncached path so one legacy shard costs one failed probe,
        not a doomed extra round-trip per query."""
        with self._member_cache_lock:
            epoch0 = self._member_cache_epoch
            unsupported = sid in self._dsum_unsupported
            supported = sid in self._dsum_supported
        summ = None
        if not unsupported:
            try:
                if supported:
                    summ = link.digest_summary()
                else:
                    # unclassified: probe on a throwaway dial (a
                    # legacy frontend closes the connection on the
                    # unknown frame — never risk the shared client)
                    summ = link.digest_summary_probe()
                    with self._member_cache_lock:
                        if self._member_cache_epoch == epoch0:
                            self._dsum_supported.add(sid)
            except _DsumUnsupported:
                with self._member_cache_lock:
                    if self._member_cache_epoch == epoch0:
                        self._dsum_unsupported.add(sid)
            except _Unreachable:
                # transient (dead shard / torn link / desynced reply):
                # let members() classify it — both paths share the
                # breaker — and re-probe next query
                summ = None
        if summ is not None:
            with self._member_cache_lock:
                cached = self._member_cache.get(sid)
            if cached is not None and cached[0] == summ:
                self._count("router.member_cache.hits")
                return cached[1], cached[2]
        m, vv = link.members()
        if summ is not None:
            # keyed by the summary fetched BEFORE the member pull: if
            # the shard advanced in between, the stored key is stale
            # and the next query refreshes — never serves wrong data
            # (a replica's vv is monotone, so an old key cannot recur).
            # Epoch-guarded: if a reshard dropped membership while we
            # were pulling, this store would resurrect a dead entry.
            stored = False
            with self._member_cache_lock:
                if self._member_cache_epoch == epoch0:
                    self._member_cache[sid] = (summ, m, vv)
                    stored = True
            if stored:
                self._count("router.member_cache.refreshes")
        return m, vv

    def _handle_query(self, session: Session, body: bytes) -> None:
        try:
            req_id = protocol.decode_query(body)
        except framing.ProtocolError as e:
            session.send(framing.MSG_ERROR, str(e).encode())
            return
        self._count("router.queries")
        # route snapshot BEFORE the fan-out: the filter must pair with
        # the ring the replies were served under — a commit landing
        # mid-fan-out would otherwise filter a donor's reply by the NEW
        # owner map while the recipient's reply predates its slice (one
        # query transiently missing the whole moved slice)
        rt = self.route()
        results = self._fan_out_fn(self._members_cached)
        # ownership filter (no-double-serve): each shard contributes
        # ONLY the elements the active ring assigns it — a donor's
        # stale copy of a moved slice must not shadow the new owner
        # (e.g. a post-handoff delete applied there)
        members: set = set()
        vvs: List[np.ndarray] = []
        unreachable = 0
        for sid, r in results.items():
            if isinstance(r, _Unreachable):
                unreachable += 1
                continue
            try:
                idx = rt.ring.shards.index(sid)
            except ValueError:
                # left the ring between fan-out and reply: its whole
                # keyspace is served by the post-swap owners
                continue
            m, vv = r
            members.update(
                int(e) for e in m
                if 0 <= e < self.num_elements and rt.owner[e] == idx)
            vvs.append(np.asarray(vv, np.uint32))
        if unreachable:
            # the union over reachable shards is a valid CRDT lower
            # bound (membership only inflates) — served, and counted,
            # not errored
            self._count("router.queries.partial", unreachable)
        if vvs:
            a = max(v.shape[0] for v in vvs)
            vv = np.zeros(a, np.uint32)
            for v in vvs:  # element-wise join; shards tick disjoint lanes
                vv[:v.shape[0]] = np.maximum(vv[:v.shape[0]], v)
        else:
            vv = np.zeros(0, np.uint32)
        session.send(protocol.MSG_MEMBERS, protocol.encode_members(
            req_id, sorted(int(e) for e in members), vv))

    def _handle_stats(self, session: Session, body: bytes) -> None:
        try:
            req_id = protocol.decode_stats(body)
        except framing.ProtocolError as e:
            session.send(framing.MSG_ERROR, str(e).encode())
            return
        self._count("router.stats")
        results = self._fan_out("stats")
        shards: Dict[str, object] = {}
        aggregate: Dict[str, int] = {}
        for sid, r in results.items():
            if isinstance(r, _Unreachable):
                shards[sid] = None
                continue
            shards[sid] = r
            for name, v in r.get("counters", {}).items():
                aggregate[name] = aggregate.get(name, 0) + int(v)
        snap = self.recorder.snapshot()
        # top level is FRONTEND-shaped (counters/observations/gauges):
        # a stats reader written against one frontend reads the fleet
        # aggregate unmodified; the per-shard split rides alongside.
        # Aggregating shard-side latency PERCENTILES is statistically
        # meaningless, so observations stay router-local (empty today).
        counters = dict(aggregate)
        counters.update(snap.get("counters", {}))
        # the autopilot's observability surface (DESIGN.md §21): the
        # active ring's keyspace balance and the per-shard windowed
        # forwarded-op rate ride the EXISTING stats verb — imbalance is
        # observable with no new wire verb, by any dialect client
        rt = self.route()
        ring_info = rt.info()
        ring_info["load_stats"] = load_stats(rt.owner,
                                             len(rt.ring.shards))
        # which ROUTER is serving, not just which ring: the HA client
        # and the autopilot's decision log adjudicate failovers from
        # these (DESIGN.md §22)
        with self._lock:
            seen = self._max_epoch_seen
            shard_epochs = dict(self._shard_epochs)
        ring_info["router_epoch"] = self.router_epoch
        ring_info["router_id"] = self.router_id
        ring_info["max_epoch_seen"] = seen
        # the shard-replication observability half (DESIGN.md §23):
        # which member serves each keyspace (active-first rosters) and
        # under which adjudicated shard epoch — the failover soak and
        # the autopilot's decision records read these
        ring_info["shard_epochs"] = shard_epochs
        ring_info["shard_addrs"] = {
            sid: [list(a) for a in link.addrs]
            for sid, link in self.links_snapshot().items()
            if sid in rt.ring.shards}
        session.send(protocol.MSG_STATS_REPLY, protocol.encode_stats_reply(
            req_id, {"counters": counters,
                     "observations": {},
                     "gauges": snap.get("gauges", {}),
                     "router": snap,
                     "shards": shards,
                     "aggregate": {"counters": aggregate},
                     # which ring this router is ACTUALLY serving —
                     # generation + owner-map digest (the soak asserts
                     # a failed handoff left these untouched)
                     "ring": ring_info,
                     "autopilot": {
                         "op_rates": self._op_rates.rates(),
                         "op_rate_window_s": 5.0,
                     }}))

    # -- fleet-aware deletion-record GC (ROADMAP item c, DESIGN.md §17) -----

    def run_fleet_gc(self) -> dict:
        """One fleet GC round: collect every shard's GC evidence
        (FRONTIER), aggregate the true FLEET frontier, push it back
        (GC) for each shard to apply clamped to its own proof.

        Aggregation is a lane-wise MIN with one exclusion: a shard
        whose declared membership is the explicit isolated set AND
        whose applied vv is zero for lane ``a`` provably holds no
        lane-``a`` state anywhere in its deployment unit, so it is no
        constraint on lane ``a`` (without the exclusion, disjoint
        keyspaces would pin every foreign lane to zero forever and
        fleet GC would never drop anything).  A shard WITH declared
        replicas is always included — its own vv says nothing about
        what a replica may hold via transitive gossip, and a future
        reshard can hand that replica's cluster any element.  An
        UNREACHABLE shard blocks the whole round (its evidence is
        unknown, and unknown must read as zero everywhere).

        Returns the round's accounting; the periodic driver and the
        fleet soak read the same dict."""
        if self.deposed:
            # self-fence (DESIGN.md §22): a deposed router must never
            # push a GC frontier — its fleet view may be stale and the
            # shards would reject the verbs typed anyway
            self._count("router.fleet_gc.deposed")
            return {"pushed": False,
                    "reason": "router deposed (stale router epoch)"}
        results = self._fan_out("frontier")
        evidence = []
        for sid, r in sorted(results.items()):
            if isinstance(r, _Unreachable):
                self._count("router.fleet_gc.partial")
                return {"pushed": False,
                        "reason": f"shard {sid} unreachable"}
            evidence.append(r)
        a_max = max(f.shape[0] for f, _, _ in evidence)
        fleet = np.zeros(a_max, np.uint32)
        for lane in range(a_max):
            lanes = [int(f[lane]) if lane < f.shape[0] else 0
                     for f, proc, isolated in evidence
                     if not (isolated
                             and (lane >= proc.shape[0]
                                  or proc[lane] == 0))]
            if lanes:
                fleet[lane] = min(lanes)
        if not fleet.any():
            self._count("router.fleet_gc.noop")
            return {"pushed": False, "reason": "all-zeros fleet frontier",
                    "frontier": fleet}
        pushes = self._fan_out("gc", fleet)
        dropped = 0
        unreachable = 0
        for sid, r in pushes.items():
            if isinstance(r, _Unreachable):
                # GC is local compaction: a shard that missed this push
                # just keeps its records until a later round
                unreachable += 1
                continue
            dropped += int(r[0])
        self._count("router.fleet_gc.runs")
        if dropped:
            self._count("router.fleet_gc.dropped_lanes", dropped)
        if unreachable:
            self._count("router.fleet_gc.push_misses", unreachable)
        return {"pushed": True, "frontier": fleet, "dropped": dropped,
                "push_misses": unreachable}

    # -- the admin verb -----------------------------------------------------

    def _handle_reshard(self, session: Session, body: bytes) -> bool:
        """Run one live join/leave SYNCHRONOUSLY on this admin
        connection's reader thread (the handoff is seconds-scale and
        the admin client holds the connection open for the verdict);
        client ops ride other connections' readers, unaffected."""
        try:
            req_id, mode_code, sid, addr = protocol.decode_reshard(body)
        except framing.ProtocolError as e:
            session.send(framing.MSG_ERROR, str(e).encode())
            return False
        if self.host.draining:
            session.send(protocol.MSG_RESHARD_REPLY,
                         protocol.encode_reshard_reply(
                             req_id, False, {"reason": "router draining"}))
            return True
        if self.deposed:
            # self-fence: the typed refusal an operator (or autopilot)
            # gets from a deposed primary BEFORE any shard has to
            # reject a transfer verb — the reply names the reason so
            # the caller re-resolves the active router
            self._count("router.reshard.deposed")
            session.send(protocol.MSG_RESHARD_REPLY,
                         protocol.encode_reshard_reply(
                             req_id, False,
                             {"reason": "StaleRouterEpoch: router "
                                        "deposed — a standby promoted "
                                        "past this epoch"}))
            return True
        mode = ("join" if mode_code == protocol.RESHARD_JOIN else "leave")
        self._count("router.reshard.requests")
        try:
            detail = self.handoff.reshard(mode, sid, addr)
        except HandoffError as e:
            session.send(protocol.MSG_RESHARD_REPLY,
                         protocol.encode_reshard_reply(
                             req_id, False, {"reason": str(e)}))
            return True
        session.send(protocol.MSG_RESHARD_REPLY,
                     protocol.encode_reshard_reply(req_id, True, detail))
        return True

    def _count(self, name: str, n: int = 1) -> None:
        if self.recorder is not None:
            self.recorder.count(name, n)
