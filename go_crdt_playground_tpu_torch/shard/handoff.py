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

The port holds the durable records of this module (the ring and epoch
files, the router and shard epochs) that a serving frontend and a
shard standby read and write.  ``HandoffCoordinator`` and
``RouteState`` drive the router's side and come with the router tier,
which is not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

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
