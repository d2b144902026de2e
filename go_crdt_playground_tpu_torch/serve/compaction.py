"""SLO-aware background compaction: GC + checkpoint rotation off-peak.

Deletion records accumulate unboundedly on a serving replica —
``ops/delta.gc_frontier``/``gc_apply`` existed but nothing ever
scheduled them — and the WAL only shrinks when something takes a
checkpoint.  This scheduler is the missing driver, with one governing
rule: **maintenance must never cost the serve path its SLO**.  Each
wake it reads the serve gauges and runs a compaction cycle ONLY when
the ingest path shows headroom; otherwise it backs off exponentially
and re-probes, so a saturated frontend sheds maintenance before it
sheds client ops.

Headroom is judged from two live signals (DESIGN.md §16 names):

* ``serve.queue.depth`` — the admission queue's instantaneous depth
  (near-zero when the batcher keeps up; climbing means every spare
  cycle belongs to clients);
* a WINDOWED p99 of ``serve.ingest_latency_s`` — the bucket-count diff
  of the recorder histogram between wakes (``obs.metrics.
  percentile_of_counts``), compared against ``p99_budget_s``.  The
  cumulative p99 would let an hour of idle history mask a current
  spike; the window reacts within one interval.

A cycle runs up to two rungs:

1. **Deletion-record GC** — ``Node.gc_deletions()`` against the node's
   provable causal-stability frontier: its own ``processed`` vector
   joined with the advertised vector of EVERY declared participant
   replica (``gc_participants``; an unheard participant contributes
   zeros, disabling GC for its lanes — gossip is transitive, so
   membership is DECLARED, never inferred from traffic: None =
   undeclared = GC off, ``()`` = the explicit isolated declaration).
   Deletion lanes every participant already reflects are dropped,
   shrinking both the state the merge kernels stream and every future
   FULL payload.  Skipped while a forced-FULL resync epoch is pending
   (a healing node must not shed records mid-heal), on non-v2
   semantics, and on an all-zeros frontier (a provable no-op never
   contends for the node lock).
2. **Checkpoint rotation** — once ``wal.appended_bytes`` has grown by
   ``checkpoint_wal_bytes`` since the last rotation, the injected
   ``checkpoint`` callable (``SyncSupervisor.checkpoint`` →
   ``Node.save_durable``: seal WAL → dump outside the lock → drop the
   sealed segments) bounds both recovery replay time and disk.

Metric names (the contract, like the batcher's): counters
``compact.gc_runs``, ``compact.gc_dropped_lanes``,
``compact.checkpoints``, ``compact.checkpoint_failures``,
``compact.backoffs``; gauges ``compact.deleted_lanes`` (post-GC
deletion-lane occupancy), ``compact.backoff_s`` (current wait — the
soak's provable-backoff signal), ``compact.headroom`` (1/0: the last
decision).
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from go_crdt_playground_tpu_torch.obs.metrics import percentile_of_counts

_LATENCY_STREAM = "serve.ingest_latency_s"
_QUEUE_GAUGE = "serve.queue.depth"


class CompactionScheduler:
    """One daemon thread running the maintenance ladder off-peak."""

    def __init__(self, node, recorder, *,
                 checkpoint: Optional[Callable[[], object]] = None,
                 interval_s: float = 2.0,
                 p99_budget_s: float = 0.25,
                 queue_depth_max: int = 4,
                 checkpoint_wal_bytes: int = 256 << 10,
                 backoff_factor: float = 2.0,
                 max_backoff_s: float = 30.0,
                 gc_participants=None):
        """``gc_participants``: the deployment's replica-actor set,
        forwarded to ``Node.deletion_frontier``.  DECLARED, never
        inferred (gossip is transitive and runtime heuristics are
        forgotten across restarts while the fleet is not): None =
        undeclared = GC disabled; ``()`` = the explicit isolated
        declaration; a non-empty set = GC what every listed replica
        provably processed.  ``ServeFrontend.serve`` derives
        None-vs-() from its own peer CONFIG when not told."""
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.node = node
        self.recorder = recorder
        self.checkpoint = checkpoint
        self.gc_participants = gc_participants
        self.interval_s = interval_s
        self.p99_budget_s = p99_budget_s
        self.queue_depth_max = queue_depth_max
        self.checkpoint_wal_bytes = checkpoint_wal_bytes
        self.backoff_factor = backoff_factor
        self.max_backoff_s = max_backoff_s
        self._stop = threading.Event()
        # race-ok: start()/stop() owner thread only
        self._thread: Optional[threading.Thread] = None
        # race-ok: loop-thread-only scheduling state (tests read them
        # only after stop(), via the run_cycle seam, or as breadcrumbs)
        self._wait_s = interval_s
        self._last_hist: Optional[List[int]] = None
        self._ckpt_base_bytes = 0
        self._last_generation = -1
        # race-ok: post-mortem breadcrumb (loop thread writes, a
        # post-stop reader inspects); no control flow depends on it
        self.last_error: Optional[BaseException] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("compaction scheduler already running")
        self._stop.clear()
        self._ckpt_base_bytes = self.recorder.counter("wal.appended_bytes")
        with self.node._lock:
            # else the first cycle's generation-change check (gen !=
            # -1) would discard the baseline just recorded above
            self._last_generation = self.node.generation
        self._thread = threading.Thread(
            target=self._loop,
            name=f"serve-compactor-{getattr(self.node, 'actor', '?')}",
            daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)

    def _loop(self) -> None:
        while not self._stop.wait(self._wait_s):
            try:
                self.run_cycle()
            except Exception as e:  # noqa: BLE001 — maintenance must
                # never take the serving process down; the cycle retries
                # on the next wake and the breadcrumb names the failure
                self.last_error = e
                self._count("compact.cycle_errors")

    # -- one decision + cycle (the testable seam) ---------------------------

    def headroom(self) -> bool:
        """Read the serve gauges and judge ingest-latency headroom.
        Also advances the latency window (one call per wake)."""
        depth = self.recorder.gauge(_QUEUE_GAUGE)
        hist = self.recorder.histogram(_LATENCY_STREAM)
        recent_p99 = None
        if hist is not None:
            if self._last_hist is not None:
                window = [a - b for a, b in zip(hist, self._last_hist)]
                recent_p99 = percentile_of_counts(window, 0.99)
            self._last_hist = hist
        ok = depth <= self.queue_depth_max and (
            recent_p99 is None or recent_p99 <= self.p99_budget_s)
        self.recorder.set_gauge("compact.headroom", 1.0 if ok else 0.0)
        return ok

    def run_cycle(self) -> dict:
        """One wake: judge headroom, then either back off or run the
        maintenance rungs.  Returns what happened (the soak and the
        deterministic tests read this instead of sleeping)."""
        if not self.headroom():
            self._count("compact.backoffs")
            self._wait_s = min(self._wait_s * self.backoff_factor,
                               self.max_backoff_s)
            self.recorder.set_gauge("compact.backoff_s", self._wait_s)
            return {"ran": False, "backoff_s": self._wait_s}
        self._wait_s = self.interval_s
        self.recorder.set_gauge("compact.backoff_s", self._wait_s)
        out = {"ran": True, "gc": None, "checkpointed": False}
        # rung 1: deletion-record GC (v2 only; never mid-heal — the
        # forced-FULL resync epoch re-ships records GC would drop).
        # An all-zeros frontier (membership undeclared, or a declared
        # participant with no advertised evidence yet) can prove
        # nothing stable — skip the state pull + kernel dispatch
        # instead of contending with the batcher for the node lock on
        # a guaranteed no-op.
        if (self.node.delta_semantics == "v2"
                and not self.node.full_resync_is_pending()):
            frontier = self.node.deletion_frontier(self.gc_participants)
            if frontier.any():
                gc = self.node.gc_deletions(frontier=frontier)
                out["gc"] = gc
                self._count("compact.gc_runs")
                if gc["dropped"]:
                    self._count("compact.gc_dropped_lanes",
                                gc["dropped"])
                self.recorder.set_gauge("compact.deleted_lanes",
                                        gc["remaining"])
        # rung 2: checkpoint rotation once the WAL grew enough (seals +
        # drops segments — Node.save_durable's two-phase, so the dump
        # itself runs outside the node lock)
        if self.checkpoint is not None:
            appended = self.recorder.counter("wal.appended_bytes")
            with self.node._lock:
                gen = self.node.generation
            if gen != self._last_generation:
                # someone else rotated (the supervisor's cadence
                # checkpoint, a drain): the WAL was just retired —
                # rebase the growth threshold instead of taking a
                # redundant full-state dump over a near-empty log
                self._last_generation = gen
                self._ckpt_base_bytes = appended
            if appended - self._ckpt_base_bytes >= \
                    self.checkpoint_wal_bytes:
                try:
                    self.checkpoint()
                except Exception as e:  # noqa: BLE001 — a failed dump
                    # leaves the WAL authoritative; retry next cycle
                    self.last_error = e
                    self._count("compact.checkpoint_failures")
                else:
                    self._ckpt_base_bytes = appended
                    with self.node._lock:
                        self._last_generation = self.node.generation
                    out["checkpointed"] = True
                    self._count("compact.checkpoints")
        return out

    def _count(self, name: str, n: int = 1) -> None:
        if self.recorder is not None:
            self.recorder.count(name, n)
