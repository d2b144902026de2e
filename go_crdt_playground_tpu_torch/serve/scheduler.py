"""Conflict-aware admission scheduling: key-runs -> pre-striped batches.

The counterpart of the JAX package's ``serve/scheduler.py`` (pure
Python; the port keeps its own copy).  The 2-D dp x mp mesh
(parallel/meshtarget2d.py) only pays off on key-disjoint super-batches:
``plan_stripes`` is strictly order-preserving, so under a zipf workload
the hot keys keep filling one stripe early and CUTTING the super-batch.
CRDT ops COMMUTE across distinct keys, so the admission layer may
reorder ops across keys as long as each key's own arrival order is
kept:

1. **Key-runs** (``key_runs``): a union-find over the keys of one
   drained batch partitions its ops into runs; two ops share a run iff
   they are connected through shared keys.  Within a run arrival order
   is kept, so per-key FIFO holds by construction.
2. **Single-chunk least-loaded placement with carryover**
   (``plan_emit``): runs are packed whole onto one stripe,
   longest-run-first onto the least-loaded stripe, into EXACTLY ONE
   dp x cap chunk; a run longer than its stripe's room ships its head
   now and DEFERS its tail to the next super-batch, ahead of every newer
   arrival.  A run's head (every cold singleton op) always ships.
3. **Advisory hints, mandatory safety**: the per-row stripe assignment
   rides to ``plan_stripes(..., assign=...)`` as a hint; the planner
   still enforces key-disjointness and stripe capacity itself.

The scheduler's emitted order IS the durable order: the batcher packs,
the mesh target counter-prefixes and WAL-logs, and replay follows the
records in that order, so the served state is bitwise a sequential
worker's fed the emitted op log.  Counters ``sched.keyruns``,
``sched.coalesced_rows``, ``sched.deferred_rows``; observation
``sched.reorder_distance``; gauge ``sched.stripe_fill``.  One instance
is owned by the batcher thread and keeps no cross-batch state.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["key_runs", "plan_emit", "ConflictScheduler"]


def key_runs(key_lists: Sequence[Sequence[int]]) -> List[List[int]]:
    """Partition op indices ``0..len(key_lists)-1`` into key-runs.

    ``key_lists[i]`` is op i's touched-key set (an Add/Del selector's
    element ids).  Two ops land in one run iff connected through
    shared keys, transitively.  Runs come back ordered by their first
    op's arrival index, each run's ops in arrival order — the per-key
    FIFO invariant is a property of this output shape: any two ops
    sharing a key share a run, and runs never reorder internally.  An
    op with no keys (a degenerate empty selector) is its own singleton
    run.
    """
    parent: Dict[int, int] = {}  # key -> union-find parent key

    def find(k: int) -> int:
        root = k
        while parent[root] != root:
            root = parent[root]
        while parent[k] != root:  # path compression
            parent[k], k = root, parent[k]
        return root

    op_root: List[int] = []  # op index -> representative key (or -1)
    for keys in key_lists:
        it = iter(keys)
        first = next(it, None)
        if first is None:
            op_root.append(-1)
            continue
        first = int(first)
        if first not in parent:
            parent[first] = first
        root = find(first)
        for k in it:
            k = int(k)
            if k not in parent:
                parent[k] = root
            else:
                parent[find(k)] = root
        op_root.append(root)

    runs: List[List[int]] = []
    by_root: Dict[int, int] = {}  # final root -> index into runs
    for i, root in enumerate(op_root):
        if root < 0:
            runs.append([i])
            continue
        root = find(root)
        j = by_root.get(root)
        if j is None:
            by_root[root] = len(runs)
            runs.append([i])
        else:
            runs[j].append(i)
    return runs


def plan_emit(key_lists: Sequence[Sequence[int]], dp: int, cap: int
              ) -> Tuple[List[int], List[int], List[int]]:
    """Single-chunk least-loaded placement of one batch's key-runs.

    Returns ``(order, assign, deferred)``: ``order`` is the emitted
    permutation of op indices (feed the packed rows in this order),
    ``assign[j]`` the stripe hint for emitted row j, ``deferred`` the
    op indices (arrival order) carried into the NEXT super-batch —
    tail rows of runs hotter than one stripe's remaining room.  The
    emission always fits one dp×cap chunk, so ``plan_stripes`` on
    ``(order, assign)`` dispatches it in ONE conflict-free plan with
    zero cuts.

    Placement: runs longest-first (LPT — the balance heuristic), each
    run onto the least-loaded stripe; what outgrows that stripe's room
    defers whole (earlier rows emitted now, later rows next batch, so
    per-key FIFO survives).  While any run remains unplaced the placed
    rows total strictly less than dp×cap, so the least-loaded stripe
    always has room ≥ 1: a run's head — every cold singleton op —
    never defers.  Within the longest-first sweep, equal-length runs
    keep arrival order (python's stable sort), which also makes the
    whole emission deterministic — replay-identical given the same
    batch.
    """
    if dp < 1 or cap < 1:
        raise ValueError(f"need dp >= 1 and cap >= 1, got {dp}/{cap}")
    return _place_runs(key_runs(key_lists), dp, cap)


def _place_runs(runs: List[List[int]], dp: int, cap: int
                ) -> Tuple[List[int], List[int], List[int]]:
    loads: List[int] = [0] * dp
    stripes: List[List[int]] = [[] for _ in range(dp)]
    deferred: List[int] = []
    for run in sorted(runs, key=len, reverse=True):
        s = min(range(dp), key=loads.__getitem__)
        room = cap - loads[s]
        # room == 0 only when every stripe is full, which (runs being
        # a partition of ≤ dp*cap ops in the batcher's use) can only
        # happen once every op is placed — defensively, the whole run
        # then defers rather than overflowing the chunk
        take, rest = run[:room] if room > 0 else [], run[max(room, 0):]
        stripes[s].extend(take)
        loads[s] += len(take)
        deferred.extend(rest)
    order: List[int] = []
    assign: List[int] = []
    for s, rows in enumerate(stripes):
        order.extend(rows)
        assign.extend([s] * len(rows))
    deferred.sort()  # arrival order: the carryover re-enters FIFO
    return order, assign, deferred


class ConflictScheduler:
    """Per-batch reordering between ``AdmissionQueue`` and the target.

    Owned by the batcher thread; stateless across batches (the
    starvation bound in the module docstring is exactly this
    statelessness).  ``dp`` is the target's ``ingest_stripes`` and
    ``cap`` the per-stripe row budget the downstream planner will
    enforce — mirror of ``Mesh2DApplyTarget._apply_batch_locked``'s
    ``cap = ceil(width / dp)`` so the hint and the enforcement agree.
    """

    def __init__(self, dp: int, *, recorder=None):
        if dp < 1:
            raise ValueError(f"ingest stripes must be >= 1, got {dp}")
        # race-ok: read-only configuration after __init__
        self.dp = int(dp)
        # race-ok: read-only configuration after __init__ (the
        # recorder locks itself)
        self.recorder = recorder

    def schedule(self, batch: Sequence, width: int
                 ) -> Tuple[List, np.ndarray, List]:
        """Reorder one drained batch of ``OpRequest``-shaped items
        (anything exposing ``.elements``) and return ``(emitted,
        assign, deferred)``: the reordered list, an int32 stripe hint
        per emitted item ready for ``ingest_batch(...,
        stripe_hint=...)``, and the hot-run tail items the batcher
        must carry — AT THE FRONT — into its next drained batch.
        ``width`` is the batcher's packed row budget (== the target
        batch axis), from which the per-stripe capacity derives."""
        cap = max(1, -(-int(width) // self.dp))
        runs = key_runs([r.elements for r in batch])
        order, assign, deferred_ix = _place_runs(runs, self.dp, cap)
        emitted = [batch[i] for i in order]
        hint = np.asarray(assign, np.int32)
        if self.recorder is not None:
            coalesced = len(batch) - len(runs)
            self.recorder.count("sched.keyruns", len(runs))
            if coalesced:
                self.recorder.count("sched.coalesced_rows", coalesced)
            if deferred_ix:
                self.recorder.count("sched.deferred_rows",
                                    len(deferred_ix))
            for j, i in enumerate(order):
                self.recorder.observe("sched.reorder_distance",
                                      abs(j - i))
            self.recorder.set_gauge(
                "sched.stripe_fill",
                len(order) / float(self.dp * cap))
        return emitted, hint, [batch[i] for i in deferred_ix]
