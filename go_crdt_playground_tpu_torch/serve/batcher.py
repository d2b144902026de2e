"""Continuous micro-batcher: admission queue → one packed apply → acks.

The serving core (inference-serving shape): a single batcher thread
drains the admission queue on time/size watermarks
(``AdmissionQueue.take_batch``), coalesces the drained ops into one
packed ``(B, E)`` tensor pair, applies them with ONE durable
group-commit call on its ``ApplyTarget`` (serve/apply.py — a local
``Node``'s kernel launch + WAL fsync today; a sharded or remote
replica behind the same protocol tomorrow), and only then acks each
op.  Under load the fsync and dispatch costs amortize over whole
batches; idle, a lone op pays at most the flush watermark.

Deadline propagation happens at BUILD time: an op whose absolute
deadline passed while queued is shed with a typed ``REJECT_EXPIRED``
and never applied — late effects are worse than honest rejection for a
client that already timed out (it will retry idempotently).

With a ``ConflictScheduler`` attached (serve/scheduler.py, DESIGN.md
§25) the drained batch is reordered ACROSS key-runs before packing —
per-key FIFO preserved, same-key runs coalesced into one stripe,
distinct runs spread least-loaded over a striped target's dp stripes —
and the emitted order becomes the durable order end to end (packing,
counter prefixes, WAL records, acks).  The emission always fits one
striped dispatch; tail rows of a run hotter than a whole stripe carry
over to the FRONT of the next super-batch (``_carry``).  Cold keys
ship in the super-batch they were drained into — the §25 starvation
bound — and a deferred tail precedes every newer arrival, so per-key
FIFO holds across the deferral.

SLO accounting (obs.Recorder; names are the DESIGN.md §16 contract):
counters ``serve.ops.acked`` / ``serve.shed.expired`` /
``serve.batches`` / ``serve.ack_send_failures``; observations
``serve.ingest_latency_s`` (admission→ack, histogram-backed p50/p95/
p99), ``serve.batch.occupancy`` (live ops per applied batch) and
``serve.batch.apply_s``; gauge ``serve.queue.depth``.

Crash-window test hook: ``CRDT_SERVE_CRASH_AFTER_BATCHES=<n>`` SIGKILLs
the PROCESS right after the n-th batch's WAL fsync returns and BEFORE
any of its acks are sent — the exact between-append-and-ack window the
serve soak's crash leg adjudicates (acked ops must survive restart;
ops caught in the window were never acked, so the client re-submits
idempotently).
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from go_crdt_playground_tpu_torch.serve import protocol
from go_crdt_playground_tpu_torch.serve.admission import AdmissionQueue, OpRequest
from go_crdt_playground_tpu_torch.utils.degrade import DegradeWindow

_CRASH_ENV = "CRDT_SERVE_CRASH_AFTER_BATCHES"


class MicroBatcher:
    """One thread turning queued ops into packed durable batches."""

    # disk-full degrade window: after an OSError escapes the durable
    # apply path (ENOSPC, fsync failure), the frontend sheds writes
    # typed StorageDegraded at ADMISSION for this long, then lets one
    # batch through as a disk probe — a still-broken disk re-arms the
    # window, a healed one clears it (serve reads the whole time)
    STORAGE_RETRY_S = 1.0

    def __init__(self, target, queue: AdmissionQueue, *,
                 max_batch: int = 32, flush_s: float = 0.002,
                 idle_wait_s: float = 0.05, recorder=None,
                 clock: Callable[[], float] = time.monotonic,
                 repl=None, scheduler=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        # anything satisfying serve/apply.ApplyTarget (ingest_batch
        # must be durable-on-return: acks follow immediately)
        self.target = target
        self.queue = queue
        self.max_batch = max_batch
        # effective super-batch width: a target serving replicated
        # ingest stripes (serve/apply.py ``ingest_stripes``; the 2-D
        # dp×mp mesh replica, parallel/meshtarget2d.py) takes
        # stripes × max_batch rows per durable group commit — that
        # multiplier IS the dp throughput axis, so it belongs to the
        # batcher's drain watermark, not just the kernel
        # race-ok: read-only after construction
        self.width = max_batch * max(
            1, int(getattr(target, "ingest_stripes", 1)))
        self.flush_s = flush_s
        self.idle_wait_s = idle_wait_s
        self.recorder = recorder
        self._clock = clock
        # semi-synchronous replication gate (shard/replica.py §23):
        # after the group-commit fsync, acks wait — bounded — for the
        # standby's durable cursor to cover the batch.  None/dormant
        # keeps the pre-HA ack path byte-identical.
        # race-ok: read-only after construction
        self.repl = repl
        # conflict-aware admission scheduler (serve/scheduler.py):
        # reorders each drained batch across key-runs (per-key FIFO
        # kept) and pre-stripes it for a replicated-ingest target.
        # The EMITTED order is the durable order — rows are packed,
        # counter-prefixed, and WAL-logged in it.  None = FIFO, the
        # pre-scheduler byte-identical path.
        # race-ok: read-only after construction
        self.scheduler = scheduler
        # hot-run tail carryover (serve/scheduler.py): ops the
        # scheduler deferred from the last super-batch, re-entering
        # the NEXT one at the front (per-key FIFO across the
        # deferral).  Loop-thread-only; _flush_remaining runs after
        # the loop thread is joined.
        self._carry: List[OpRequest] = []
        self._stop = threading.Event()
        # race-ok: start()/stop() owner thread only
        self._thread: Optional[threading.Thread] = None
        # race-ok: post-mortem breadcrumb (loop thread writes, a
        # post-stop reader inspects); no control flow depends on it
        self.last_error: Optional[BaseException] = None
        # the disk-full probe window (utils/degrade.py — the shared
        # latch this batcher's inline deadline field grew into).
        # Armed by the batcher loop thread only; listener reader
        # threads poll it through storage_degraded() — the worst stale
        # read costs one op a REJECT_STORAGE-vs-Overloaded
        # classification, never correctness (both typed retryable)
        self._storage = DegradeWindow(self.STORAGE_RETRY_S, clock)
        # race-ok: loop-thread-only batch counter driving the SIGKILL
        # test hook (None = hook disabled)
        self._crash_after: Optional[int] = None
        raw = os.environ.get(_CRASH_ENV)
        if raw:
            try:
                n = int(raw)
            except ValueError:
                n = 0  # malformed value: hook stays off, never aborts
            if n > 0:  # "0" means disabled, like an unset var
                self._crash_after = n

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("batcher already running")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop,
            name=f"serve-batcher-{getattr(self.target, 'actor', '?')}",
            daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        """Stop WITHOUT draining (crash-shaped teardown for tests);
        graceful shutdown is ``drain()``."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)

    def drain(self, timeout: float = 30.0) -> None:
        """Graceful flush: close the queue to new offers, let the loop
        apply+ack everything already admitted, then stop the thread.
        Every admitted op is either acked or (deadline passed while
        draining) typed-rejected by the time this returns."""
        self.queue.close()
        t = self._thread
        if t is None or not t.is_alive():
            self._flush_remaining()
            return
        deadline = self._clock() + timeout
        while self.queue.depth() > 0 and self._clock() < deadline:
            time.sleep(0.005)
        self._stop.set()
        t.join(timeout=max(0.1, deadline - self._clock()))
        self._flush_remaining()

    def storage_degraded(self) -> bool:
        """True while the disk-full degrade window is armed: the
        admission path sheds writes typed ``StorageDegraded`` instead
        of queueing them toward a WAL that just refused an fsync.  The
        window expires on its own (the next admitted batch is the disk
        probe) and clears immediately on a successful apply."""
        return self._storage.active()

    def _flush_remaining(self) -> None:
        """Post-stop sweep: anything still queued OR carried (loop
        died, or drain raced the stop flag) is applied inline so no
        admitted op is ever silently dropped.  Terminates: each pass
        ships at least one stripe-capacity's worth of any carried run,
        so the carryover strictly shrinks once the queue is empty."""
        while True:
            batch = self.queue.take_batch(
                max(1, self.width - len(self._carry)), 0.0, 0.0)
            if not batch and not self._carry:
                return
            self._apply(batch)

    # -- the loop -----------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self.queue.take_batch(
                max(1, self.width - len(self._carry)),
                self.idle_wait_s, self.flush_s)
            if self.recorder is not None:
                self.recorder.set_gauge("serve.queue.depth",
                                        self.queue.depth())
            if not batch and not self._carry:
                if self.queue.closed and self.queue.depth() == 0:
                    return  # drained
                continue
            try:
                self._apply(batch)
            except Exception as e:  # noqa: BLE001 — last resort: the
                # apply path has its own poison-batch handling inside
                # _apply; anything escaping here is a reply-path bug,
                # and the serving loop must still survive it
                self.last_error = e
                self._count("serve.batch_errors")

    def _apply(self, batch: List[OpRequest]) -> None:
        if self._carry:
            # last batch's deferred hot-run tails re-enter FIRST:
            # their arrival precedes everything drained after them, so
            # prepending is what keeps per-key FIFO global across the
            # deferral (they rejoin their run at its head)
            batch = self._carry + batch
            self._carry = []
        now = self._clock()
        live: List[OpRequest] = []
        for r in batch:
            if r.deadline is not None and now > r.deadline:
                self._count("serve.shed.expired")
                r.session.send(
                    protocol.MSG_REJECT,
                    protocol.encode_reject(
                        r.req_id, protocol.REJECT_EXPIRED,
                        "deadline passed before apply"))
            else:
                live.append(r)
        if not live:
            return
        # conflict-aware reorder (serve/scheduler.py): coalesce
        # same-key runs, spread distinct runs across the target's
        # ingest stripes, and emit the batch pre-striped.  From here
        # on `live` IS the durable order — rows pack, counter-prefix,
        # WAL-log, and ack in the scheduler's emitted order.
        hint = None
        if self.scheduler is not None and len(live) > 1:
            live, assign, self._carry = self.scheduler.schedule(
                live, self.width)
            hint = np.full(self.width, -1, np.int32)
            hint[:len(assign)] = assign
        # one packed (B, E) pair, B fixed at the effective width: every
        # occupancy is the same shape (padding rows masked by live)
        E = self.target.num_elements
        add_rows = np.zeros((self.width, E), bool)
        del_rows = np.zeros((self.width, E), bool)
        live_mask = np.zeros(self.width, bool)
        for b, r in enumerate(live):
            rows = add_rows if r.kind == protocol.OP_ADD else del_rows
            rows[b, r.elements] = True
            live_mask[b] = True
        t0 = self._clock()
        try:
            # durable on return: state applied + batch δ WAL-fsync'd
            if hint is None:
                self.target.ingest_batch(add_rows, del_rows, live_mask)
            else:
                self.target.ingest_batch(add_rows, del_rows, live_mask,
                                         stripe_hint=hint)
        except OSError as e:
            # the DISK failed the durable contract (ENOSPC, an fsync
            # error in the WAL append path — utils/wal.py counts the
            # site as wal.append_errors): classify typed
            # StorageDegraded, never the generic Overloaded, and arm
            # the degrade window the admission path sheds against —
            # reads keep serving, writes shed typed until a probe
            # batch survives this call again
            self.last_error = e
            self._storage.arm()
            self._count("serve.batch_errors")
            for r in live:
                self._count("serve.shed.storage")
                r.session.send(
                    protocol.MSG_REJECT,
                    protocol.encode_reject(
                        r.req_id, protocol.REJECT_STORAGE,
                        f"durable WAL append failed (storage "
                        f"degraded; retry with backoff): {e}"))
            return
        except Exception as e:  # noqa: BLE001 — poison batch: reject
            # its (not-yet-replied) ops as RETRYABLE — an apply failure
            # is transient server trouble (disk error, kernel fault),
            # not the permanent invalid-op verdict — and keep serving.
            # Runs here, not in the loop, so the drain-time flush gets
            # the same protection (an ENOSPC mid-drain must not abort
            # close() half-way with ops silently dropped).
            self.last_error = e
            self._count("serve.batch_errors")
            for r in live:
                r.session.send(
                    protocol.MSG_REJECT,
                    protocol.encode_reject(
                        r.req_id, protocol.REJECT_OVERLOADED,
                        f"batch apply failed (retry): {e}"))
            return
        if self._storage.armed_ever():
            # the probe batch survived: the disk recovered — clear the
            # degrade window so admission stops shedding writes
            self._storage.clear()
        if self._crash_after is not None:
            self._crash_after -= 1
            if self._crash_after <= 0:
                # the test window: durably applied, NOT yet acked
                os.kill(os.getpid(), signal.SIGKILL)
        if self.repl is not None:
            # semi-sync group commit (DESIGN.md §23): wait — bounded —
            # for the standby's durable cursor to cover this batch's
            # WAL records before the acks go out.  A dead/slow standby
            # degrades typed to async inside gate() (the repl.degraded
            # window), so this can stall an ack by at most one
            # ack_timeout per degraded episode, never indefinitely.
            wal = None
            lock = getattr(self.target, "_lock", None)
            if lock is not None:
                with lock:
                    wal = getattr(self.target, "wal", None)
            self.repl.gate(wal)
        apply_s = self._clock() - t0
        acked = 0
        for r in live:
            if r.session.send(protocol.MSG_ACK,
                              protocol.encode_ack(r.req_id)):
                acked += 1
            else:
                self._count("serve.ack_send_failures")
        ack_t = self._clock()
        if self.recorder is not None:
            self.recorder.count_many({"serve.ops.acked": acked,
                                      "serve.batches": 1})
            self.recorder.observe("serve.batch.occupancy", len(live))
            self.recorder.observe("serve.batch.apply_s", apply_s)
            for r in live:
                self.recorder.observe("serve.ingest_latency_s",
                                      ack_t - r.t_arrival)

    def _count(self, name: str, n: int = 1) -> None:
        if self.recorder is not None:
            self.recorder.count(name, n)
