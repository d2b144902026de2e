"""Live resharding: dynamic ring membership with zero-loss keyspace
handoff (DESIGN.md §18).

The PR-6 fleet was frozen at birth: an immutable ``HashRing`` and a
static owner map meant restart-to-resize.  This module makes membership
change a ROUTER operation under live traffic.  Correctness is anchored
on three facts:

* HRW gives **exact minimal remap** (``ring.remap_fraction``): a
  join/leave moves only the forced slice, so the handoff is a bounded
  one-shot state transfer, not a rebalance;
* the CRDT join makes the transfer **unconditionally safe to retry or
  duplicate** (arxiv 1803.02750's framing: a state-based sync round) —
  a half-delivered slice is a lower bound, never corruption;
* so the only hard problem is ROBUSTNESS: no acked op may be lost and
  no keyspace may double-serve while the ring swaps, even when a donor
  or recipient is SIGKILLed mid-handoff.

State machine (one epoch per admin verb, ``HandoffCoordinator``):

    IDLE --stage--> FENCED --transfer--> COMMITTED (ring swapped)
                       \\--any failure--> ABORTED  (old ring serving)

**stage**: build the candidate ring (``with_shard``/``without_shard``),
derive the moved slice per (donor, recipient) pair
(``ring.handoff_plan``), persist the epoch record.  **fence**: ops
naming moved elements get the typed retryable ``REJECT_MOVING`` — the
chosen fence semantics is *reject-and-retry*, not dual-write: a
dual-write would need cross-shard atomicity the protocol doesn't have,
while a typed reject reuses the client's existing idempotent-resubmit
contract and bounds unavailability to the transfer window (measured as
``fence_s``, adjudicated by the fleet soak).  After fencing, the
coordinator waits for router-level op handlers to settle and for every
donor's in-flight moved-slice sub-ops to resolve — a donor ack is an
fsync'd op, so everything acked is in the slice snapshot that follows.
**transfer**: per plan pair, ``SLICE_PULL`` the donor's complete slice
state and ``SLICE_PUSH`` it to the recipient, which applies it through
its WAL-logged payload path and acks only once durable (the recipient
half of zero-loss rides the EXISTING §14 durability layer).  Pulls and
pushes retry on transient failure with seeded jittered backoff
(``utils/backoff``) through the links' circuit breakers, bounded by the
transfer deadline.  **commit**: swap the router's ``RouteState``
atomically (new ring + owner map + generation + digest, fence cleared)
and persist the committed ring; a leave's retired link is closed after
the swap.  **abort** (the main path under fault injection): clear the
fence, close a staged link, persist the abort — the old ring never
stopped being the active route, so a failed join/leave leaves the
prior ring fully serving by construction (its owner-map digest is what
STATS keeps reporting; the soak pins this).

Double-serve is prevented on the READ path: the router filters each
shard's QUERY reply by the active owner map, so a donor's stale copy
of a moved slice is invisible the moment the ring swaps (and a delete
at the new owner is never shadowed by the donor's old ``present``
lane).

Epoch persistence: with a ``state_dir`` the coordinator writes
``ring.json`` (epoch, phase, ring, digest) fsync-then-rename atomic; a
router restart adopts a COMMITTED ring over its CLI flags and treats a
staged-but-uncommitted epoch as aborted.  A router SIGKILL mid-handoff
therefore resumes serving the old ring; donors/recipients recover
their halves from their own WAL/checkpoints.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from go_crdt_playground_tpu_torch.shard.ring import (HashRing, handoff_plan,
                                               remap_fraction)
from go_crdt_playground_tpu_torch.utils.backoff import Backoff, BackoffPolicy
from go_crdt_playground_tpu_torch.utils.fsutil import fsync_dir

Addr = Tuple[str, int]

PHASE_STAGED = "staged"
PHASE_COMMITTED = "committed"
PHASE_ABORTED = "aborted"

RING_FILE = "ring.json"    # the last COMMITTED ring (what a restart adopts)
EPOCH_FILE = "epoch.json"  # the last epoch's phase breadcrumb (post-mortems
                           # + the monotone epoch counter across restarts)
# the ROUTER-LEADERSHIP epoch (DESIGN.md §22) — monotone across the HA
# pair: a promoted standby persists primary_epoch + 1 here before it
# announces/serves, and every shard frontend persists the highest
# epoch it has adjudicated so a restart cannot forget the fence.
# Distinct from EPOCH_FILE on purpose: handoff epochs count ring
# CHANGES under one router; router epochs count which ROUTER may
# drive them.
ROUTER_EPOCH_FILE = "router_epoch.json"
# per-shard SHARD epochs the ROUTER has adjudicated (DESIGN.md §23):
# which replication-group member may serve each sid's keyspace.
# Monotone per sid; persisted fsync-then-rename BEFORE a failover swap
# acts, so a router restart can never hand a keyspace back to a
# deposed member.
SHARD_EPOCHS_FILE = "shard_epochs.json"


class HandoffError(RuntimeError):
    """A handoff aborted (reason in the message).  The old ring is
    still the active route — callers reply failure and keep serving."""


class RouteState:
    """One immutable routing snapshot: the ring, its precomputed owner
    map, a monotone swap generation, the owner-map digest, and the
    optional handoff fence.  The hot path reads ONE of these per op
    (``ShardRouter.route()``), so a ring swap is atomic by construction
    — there is no half-updated routing state to observe."""

    __slots__ = ("ring", "owner", "generation", "digest", "fence")

    def __init__(self, ring: HashRing, owner: np.ndarray, generation: int,
                 digest: str, fence: Optional[np.ndarray] = None):
        # race-ok: all fields are write-once at construction; every
        # reader got this object from a locked swap point
        self.ring = ring
        self.owner = owner
        self.generation = generation
        self.digest = digest
        self.fence = fence  # bool[E] moved-slice mask, None = no fence

    def owner_sid(self, element_id: int) -> str:
        return self.ring.shards[self.owner[element_id]]

    def fenced(self, elements: Sequence[int]) -> bool:
        if self.fence is None:
            return False
        return any(self.fence[e] for e in elements)

    def with_fence(self, fence: Optional[np.ndarray]) -> "RouteState":
        return RouteState(self.ring, self.owner, self.generation,
                          self.digest, fence)

    def info(self) -> Dict[str, object]:
        """The STATS/banner read-out: which ring this router is
        actually serving (the observability the soak's failed-handoff
        adjudication leans on)."""
        return {
            "generation": self.generation,
            "digest": self.digest,
            "shards": list(self.ring.shards),
            "seed": self.ring.seed,
            "fenced": (int(self.fence.sum())
                       if self.fence is not None else 0),
        }


def _load_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def load_ring_file(state_dir: str) -> Optional[dict]:
    """Read the persisted COMMITTED-ring record; None when
    absent/unreadable (a torn write is indistinguishable from no record
    — both mean "trust the CLI flags", the pre-reshard configuration).
    Only commits ever write this file, so a kill during a staged or
    aborting handoff can never clobber the ring a restart adopts."""
    return _load_json(os.path.join(state_dir, RING_FILE))


def load_epoch_file(state_dir: str) -> Optional[dict]:
    """The last epoch breadcrumb (any phase) — post-mortem material and
    the restart seed for the monotone epoch counter."""
    return _load_json(os.path.join(state_dir, EPOCH_FILE))


def write_json_atomic(state_dir: str, filename: str, rec: dict) -> None:
    """fsync-then-rename atomic JSON record write — the persistence
    discipline every routing-state file in this module shares (a torn
    write must read as ABSENT, never as a half-record)."""
    path = os.path.join(state_dir, filename)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f, indent=2)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(state_dir)


def load_router_epoch(state_dir: Optional[str]) -> int:
    """The persisted router-leadership epoch (0 when absent/unreadable
    — the pre-HA configuration, fence dormant)."""
    if state_dir is None:
        return 0
    rec = _load_json(os.path.join(state_dir, ROUTER_EPOCH_FILE))
    if rec is None:
        return 0
    try:
        return max(0, int(rec.get("router_epoch", 0)))
    except (TypeError, ValueError):
        return 0


def load_shard_epochs(state_dir: Optional[str]) -> Dict[str, int]:
    """The router's adjudicated per-sid shard epochs (empty when
    absent/unreadable — every sid at its pre-HA epoch 0)."""
    if state_dir is None:
        return {}
    rec = _load_json(os.path.join(state_dir, SHARD_EPOCHS_FILE))
    if not isinstance(rec, dict):
        return {}
    out: Dict[str, int] = {}
    for sid, e in rec.get("epochs", {}).items():
        try:
            out[str(sid)] = max(0, int(e))
        except (TypeError, ValueError):
            continue
    return out


def persist_shard_epochs(state_dir: Optional[str],
                         epochs: Dict[str, int]) -> None:
    """Durably record the router's per-sid shard-epoch adjudications —
    fsync'd BEFORE the failover swap acts on them."""
    if state_dir is None:
        return
    os.makedirs(state_dir, exist_ok=True)
    write_json_atomic(state_dir, SHARD_EPOCHS_FILE,
                      {"epochs": {sid: int(e)
                                  for sid, e in epochs.items()}})


def persist_router_epoch(state_dir: Optional[str], epoch: int,
                         owner: str) -> None:
    """Durably record the highest router epoch this endpoint has seen
    (or, for a promoting standby, now CLAIMS) — fsync'd BEFORE the
    epoch is acted on, so a restart can never regress the fence."""
    if state_dir is None:
        return
    os.makedirs(state_dir, exist_ok=True)
    write_json_atomic(state_dir, ROUTER_EPOCH_FILE,
                      {"router_epoch": int(epoch), "owner": owner})


class HandoffCoordinator:
    """Drives one handoff epoch at a time against a ``ShardRouter``.

    Single concurrent handoff by design (``_active``): overlapping
    membership changes would need plan composition nothing requires —
    the admin verb replies a typed failure and the operator retries.
    """

    # pull/push retry gate (seeded, jittered — utils/backoff)
    DEFAULT_POLICY = BackoffPolicy(base_s=0.05, multiplier=2.0, cap_s=1.0,
                                   jitter=0.1, max_retries=6)

    def __init__(self, router, *, state_dir: Optional[str] = None,
                 recorder=None, fence_timeout_s: float = 10.0,
                 transfer_timeout_s: float = 30.0,
                 policy: Optional[BackoffPolicy] = None, seed: int = 0):
        self.router = router
        self.recorder = recorder
        self.state_dir = state_dir
        self.fence_timeout_s = fence_timeout_s
        self.transfer_timeout_s = transfer_timeout_s
        self.policy = policy if policy is not None else self.DEFAULT_POLICY
        self.seed = seed
        self._lock = threading.Lock()
        self._active = False  # guarded-by: _lock
        self._epoch = 0  # guarded-by: _lock
        if state_dir is not None:
            os.makedirs(state_dir, exist_ok=True)
            epoch = 0
            for rec in (load_ring_file(state_dir),
                        load_epoch_file(state_dir)):
                if rec is not None:
                    epoch = max(epoch, int(rec.get("epoch", 0)))
            with self._lock:
                self._epoch = epoch

    @property
    def epoch(self) -> int:
        """The monotone HANDOFF epoch (ring-change counter) — exposed
        so the RING_SYNC tail record can carry it and a promoting
        standby's coordinator resumes past it."""
        with self._lock:
            return self._epoch

    # -- the admin verb -----------------------------------------------------

    def reshard(self, mode: str, sid: str,
                addr: Optional[Addr] = None) -> dict:
        """Run one join/leave handoff end to end; returns the commit
        accounting.  Raises ``HandoffError`` on abort — the old ring is
        still serving and the router replies the reason typed."""
        with self._lock:
            if self._active:
                raise HandoffError("another handoff is in progress")
            self._active = True
            self._epoch += 1
            epoch = self._epoch
        try:
            return self._run(epoch, mode, sid, addr)
        finally:
            with self._lock:
                self._active = False

    def _run(self, epoch: int, mode: str, sid: str,
             addr: Optional[Addr]) -> dict:
        router = self.router
        t0 = time.monotonic()
        staged_link = None
        fenced = False
        try:
            rt = router.route()
            ring_after = self._candidate_ring(rt.ring, mode, sid, addr)
            owners_after = ring_after.owner_map(router.num_elements)
            remap = remap_fraction(rt.owner, owners_after,
                                   rt.ring.shards, ring_after.shards)
            plan = handoff_plan(rt.owner, owners_after,
                                rt.ring.shards, ring_after.shards)
            self._persist(epoch, PHASE_STAGED, rt.info(),
                          {"mode": mode, "sid": sid,
                           "moved": remap["moved"]})
            if mode == "join":
                # the recipient link exists STAGED-only until commit:
                # no client op can route to it, but the transfer rides
                # the same breaker/backoff machinery as live links
                staged_link = router.make_link(sid, addr)

            # fence: moved-slice ops now reject typed-retryable; wait
            # for handlers that pre-date the fence to finish
            # registering, then for every donor's in-flight moved
            # sub-ops to resolve (each resolution is a durable donor
            # ack or a typed reject — either way the slice snapshot
            # that follows contains everything ever acked)
            fence = np.zeros(router.num_elements, bool)
            for _, _, elems in plan:
                fence[elems] = True
            router.set_fence(fence)
            fenced = True
            t_fence = time.monotonic()
            self._count("router.reshard.fences")
            settle_deadline = t_fence + self.fence_timeout_s
            router.await_ops_settled(settle_deadline)
            self._await_donors_drained(plan, fence, settle_deadline)

            # transfer: pull each donor slice, push to its recipient
            transfer_deadline = time.monotonic() + self.transfer_timeout_s
            moved_transferred = 0
            for src_sid, dst_sid, elems in plan:
                src_link = router.link(src_sid)
                if src_link is None:
                    raise HandoffError(f"donor {src_sid} not in ring")
                if staged_link is not None and dst_sid == sid:
                    dst_link = staged_link
                else:
                    dst_link = router.link(dst_sid)
                    if dst_link is None:
                        raise HandoffError(
                            f"recipient {dst_sid} not in ring")
                payload = self._with_retries(
                    lambda: src_link.slice_pull(elems),
                    f"pull {len(elems)} elements from {src_sid}",
                    transfer_deadline, epoch)
                self._with_retries(
                    lambda: dst_link.slice_push(payload),
                    f"push {len(elems)} elements to {dst_sid}",
                    transfer_deadline, epoch)
                moved_transferred += len(elems)

            # commit, in two steps whose failure modes are both safe:
            # PERSIST the committed record FIRST (a failure here
            # funnels to the abort arm while the old ring genuinely is
            # still the active route — persisting after the swap could
            # report "aborted" for a ring that irreversibly swapped),
            # THEN the atomic in-memory RouteState swap.  A process
            # death between the two restarts onto the persisted NEW
            # ring, whose slices are already durable on their
            # recipients — routing-consistent either way.
            digest = ring_after.digest(router.num_elements, owners_after)
            generation = router.route().generation + 1  # single handoff
            committed_shards = {
                s: (staged_link.addr
                    if staged_link is not None and s == sid
                    else router.shard_roster(s))
                for s in ring_after.shards}
            fence_s = time.monotonic() - t_fence
            detail = {
                "epoch": epoch,
                "mode": mode,
                "sid": sid,
                "moved": remap["moved"],
                "moved_transferred": moved_transferred,
                "fraction": remap["fraction"],
                "gratuitous": len(remap["gratuitous"]),
                "pairs": [[s, d, len(e)] for s, d, e in plan],
                "fence_s": round(fence_s, 4),
                "elapsed_s": round(time.monotonic() - t0, 4),
                "generation": generation,
                "digest": digest,
                "shards": list(ring_after.shards),
            }
            new_info = {"generation": generation, "digest": digest,
                        "shards": list(ring_after.shards),
                        "seed": ring_after.seed, "fenced": 0}
            self._persist(epoch, PHASE_COMMITTED, new_info, detail,
                          shards_map=committed_shards)
            swapped_gen = router.commit_route(
                ring_after, owners_after, digest,
                add_sid=sid if mode == "join" else None,
                add_link=staged_link,
                drop_sid=sid if mode == "leave" else None)
            assert swapped_gen == generation, (swapped_gen, generation)
            staged_link = None  # the router owns it now
            fenced = False      # cleared by the swap
            self._count("router.reshard.commits")
            return detail
        except Exception as e:  # noqa: BLE001 — EVERY failure funnels
            # through the abort arm: the old ring must come back
            # serving no matter what broke mid-handoff
            if fenced:
                router.clear_fence()
            if staged_link is not None:
                staged_link.close()
            reason = (str(e) if isinstance(e, HandoffError)
                      else f"{type(e).__name__}: {e}")
            self._persist(epoch, PHASE_ABORTED, router.route().info(),
                          {"mode": mode, "sid": sid, "reason": reason})
            self._count("router.reshard.aborts")
            if isinstance(e, HandoffError):
                raise
            raise HandoffError(f"handoff aborted: {reason}") from e

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def _candidate_ring(ring: HashRing, mode: str, sid: str,
                        addr: Optional[Addr]) -> HashRing:
        if mode == "join":
            if addr is None:
                raise HandoffError("join requires the shard's address")
            if sid in ring.shards:
                raise HandoffError(f"shard {sid!r} already in the ring")
            return ring.with_shard(sid)
        if mode == "leave":
            try:
                return ring.without_shard(sid)
            except ValueError as e:
                raise HandoffError(str(e)) from e
        raise HandoffError(f"unknown reshard mode {mode!r}")

    def _await_donors_drained(self, plan, fence: np.ndarray,
                              deadline: float) -> None:
        for src_sid in sorted({s for s, _, _ in plan}):
            link = self.router.link(src_sid)
            if link is None:
                raise HandoffError(f"donor {src_sid} not in ring")
            while link.pending_touching(fence) > 0:
                if time.monotonic() > deadline:
                    raise HandoffError(
                        f"in-flight ops on donor {src_sid} did not "
                        f"settle within {self.fence_timeout_s}s")
                time.sleep(0.005)

    def _with_retries(self, fn, what: str, deadline: float,
                      epoch: int):
        """Run one transfer step with jittered-backoff retries on
        TRANSIENT failure, bounded by the transfer deadline.  A
        deterministic reject (e.g. an incompatible payload) aborts
        immediately — retrying the same bytes cannot help."""
        from go_crdt_playground_tpu_torch.serve import protocol
        from go_crdt_playground_tpu_torch.shard import router as router_mod

        bo = Backoff(self.policy, seed=self.seed * 100003 + epoch)
        while True:
            try:
                return fn()
            except (router_mod._Unreachable, protocol.Overloaded,
                    protocol.Draining, ConnectionError, OSError) as e:
                self._count("router.reshard.transfer_retries")
                delay = bo.next_delay()
                if delay is None:
                    bo.reset()
                    delay = self.policy.cap_s
                if time.monotonic() + delay > deadline:
                    raise HandoffError(
                        f"transfer step failed past deadline "
                        f"({what}): {e}") from e
                time.sleep(delay)
            except protocol.ServeError as e:
                raise HandoffError(
                    f"transfer step refused ({what}): {e}") from e

    def _persist(self, epoch: int, phase: str, route_info: dict,
                 detail: dict,
                 shards_map: Optional[Dict[str, Addr]] = None) -> None:
        """fsync-then-rename atomic epoch records.  Every phase writes
        the EPOCH breadcrumb; only COMMITTED (which must pass
        ``shards_map``, the post-swap membership with addresses) also
        rewrites the ring record a restart adopts — so a kill during a
        staged/aborting handoff leaves the previously-committed ring
        intact on disk (restart = old ring serving, the
        abort-on-restart semantics)."""
        if self.state_dir is None:
            return
        rec = {"epoch": epoch, "phase": phase, "route": route_info,
               "detail": detail}
        write_json_atomic(self.state_dir, EPOCH_FILE, rec)
        if phase == PHASE_COMMITTED:
            # a restarted router rebuilds the ring from this
            rec = dict(rec)
            rec["shards"] = {s: list(a) for s, a in shards_map.items()}
            rec["seed"] = int(route_info["seed"])
            rec["elements"] = self.router.num_elements
            rec["generation"] = detail["generation"]
            rec["digest"] = detail["digest"]
            write_json_atomic(self.state_dir, RING_FILE, rec)

    def _count(self, name: str, n: int = 1) -> None:
        if self.recorder is not None:
            self.recorder.count(name, n)
