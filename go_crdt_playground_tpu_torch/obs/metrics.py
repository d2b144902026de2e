"""North-star metrics plumbing (SURVEY §5.5, BASELINE.md).

The reference has zero metrics machinery; its operational counters are
implicit in stdout traces.  This module gives the framework the three
counters the measurement ladder tracks — merges/sec, rounds-to-
convergence, δ-payload bytes — behind one small thread-safe ``Recorder``
(net.Node takes one and counts every sync exchange on it) plus
payload-size helpers for δ payloads.
"""

from __future__ import annotations

import math
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

# Bounded log-spaced histogram backing observe()/percentile().  Bucket i
# covers (BASE·G^(i-1), BASE·G^i]; index 0 is the underflow bucket
# (values <= BASE, incl. zero/negatives) and the last bucket absorbs
# overflow.  With BASE=1µs and G=√2, 64 buckets span ~1e-6..4.3e3 —
# microsecond kernel dispatches through hour-long soaks — at a worst-case
# relative quantile error of √2, and the whole histogram is one fixed
# 64-int list per stream (bounded memory however long the stream runs).
_HIST_BASE = 1e-6
_HIST_GROWTH = math.sqrt(2.0)
_HIST_BUCKETS = 64
_LOG_GROWTH = math.log(_HIST_GROWTH)


def _bucket_index(value: float) -> int:
    if value <= _HIST_BASE:
        return 0
    i = 1 + int(math.floor(math.log(value / _HIST_BASE) / _LOG_GROWTH))
    return min(i, _HIST_BUCKETS - 1)


def _bucket_upper(index: int) -> float:
    return _HIST_BASE * (_HIST_GROWTH ** index)


class Recorder:
    """Thread-safe counters, value observations, and wall-clock timers.

    count():      monotonically increasing totals (merges, rounds, bytes).
    observe():    value streams summarized as n/sum/min/max PLUS a bounded
                  log-spaced histogram (fixed buckets, so memory never
                  grows with the stream).
    percentile(): quantile estimate from the histogram (worst-case √2
                  relative error, clamped to the exact observed min/max);
                  snapshot() reports p50/p95/p99 per stream — the serve
                  frontend's SLO numbers (DESIGN.md §16) ride these.
    time():       context manager feeding observe() with elapsed seconds.
    set_gauge():  last-write-wins point-in-time values (e.g. the per-peer
                  circuit-breaker state the sync supervisor exports:
                  0=closed, 1=open, 2=half_open — net/antientropy.py).

    Durability-layer names (the crash-recovery contract, DESIGN.md §14
    "Durability ladder"): counters ``wal.appends`` / ``wal.appended_bytes``
    / ``wal.truncations`` (write path), ``wal.records`` /
    ``wal.bad_records`` / ``wal.future_records`` (replay; the last is a
    record refused by the causal replay guard), ``wal.torn_tail`` (tear
    found and repaired), ``restore.fallbacks`` (a checkpoint generation
    failed verification and the previous one was used),
    ``restore.unknown_type`` (restore degraded to a plain array dict),
    ``restore.full_resync`` / ``sync.full_resync_complete`` (the
    regressed-restore forced-FULL healing epoch armed / retired); gauge
    ``restore.generation`` (the generation recovery actually loaded).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._observations: Dict[str, Dict[str, float]] = {}
        self._histograms: Dict[str, List[int]] = {}  # guarded-by: _lock
        self._gauges: Dict[str, float] = {}

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def count_many(self, counts: Dict[str, int]) -> None:
        """Atomically bump several counters — a snapshot() concurrent with
        one count_many sees either none or all of its increments."""
        with self._lock:
            for name, n in counts.items():
                self._counters[name] = self._counters.get(name, 0) + n

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            o = self._observations.get(name)
            if o is None:
                self._observations[name] = {
                    "n": 1, "sum": float(value),
                    "min": float(value), "max": float(value),
                }
                self._histograms[name] = [0] * _HIST_BUCKETS
            else:
                o["n"] += 1
                o["sum"] += float(value)
                o["min"] = min(o["min"], float(value))
                o["max"] = max(o["max"], float(value))
            self._histograms[name][_bucket_index(float(value))] += 1

    # requires-lock: _lock
    def _percentile_locked(self, name: str, q: float) -> float:
        """Caller holds the lock.  Smallest bucket upper bound covering
        the q-quantile rank, clamped to the exact observed [min, max] —
        a stream of identical values reports that value exactly, and no
        estimate can leave the observed range."""
        o = self._observations[name]
        hist = self._histograms[name]
        rank = max(1, math.ceil(q * o["n"]))
        cum = 0
        for i, c in enumerate(hist):
            cum += c
            if cum >= rank:
                if i == _HIST_BUCKETS - 1:
                    return o["max"]  # overflow bucket: nominal upper lies
                return min(max(_bucket_upper(i), o["min"]), o["max"])
        return o["max"]  # unreachable: buckets always sum to n

    def percentile(self, name: str, q: float) -> float:
        """Estimate the q-quantile (q in [0, 1]) of an observed stream
        from its bounded histogram.  Raises KeyError for a stream never
        observed — "no data" must not read as "zero latency"."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if name not in self._observations:
                raise KeyError(f"no observations for {name!r}")
            return self._percentile_locked(name, q)

    @contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def set_gauge(self, name: str, value: float) -> None:
        """Set a last-write-wins instantaneous value (unlike count(),
        snapshot() reports the CURRENT value, not an accumulation)."""
        with self._lock:
            self._gauges[name] = value

    def gauge(self, name: str, default: float = 0.0) -> float:
        """Read one gauge without paying a full snapshot()."""
        with self._lock:
            return self._gauges.get(name, default)

    def counter(self, name: str, default: int = 0) -> int:
        """Read one counter without paying a full snapshot()."""
        with self._lock:
            return self._counters.get(name, default)

    def histogram(self, name: str) -> Optional[List[int]]:
        """Copy of a stream's bucket counts (CUMULATIVE since process
        start), or None if never observed.  Pollers that need a RECENT
        quantile — e.g. the compaction scheduler's headroom check,
        serve/compaction.py — diff two copies and feed the window to
        ``percentile_of_counts``; the cumulative histogram alone would
        let an hour of idle history mask a current latency spike."""
        with self._lock:
            h = self._histograms.get(name)
            return None if h is None else list(h)

    def snapshot(self) -> Dict[str, object]:
        """Point-in-time copy: {"counters": {...}, "observations": {...},
        "gauges": {...}} with per-stream mean and histogram-derived
        p50/p95/p99 added, plus the raw cumulative ``buckets`` vector —
        a REMOTE poller (the fleet autopilot reading STATS over the
        wire, control/signals.py) windows a quantile exactly like the
        in-process compaction scheduler does: diff two snapshots'
        buckets and feed ``percentile_of_counts``.  64 ints per stream,
        bounded like the histogram itself."""
        with self._lock:
            obs = {
                name: {**o, "mean": o["sum"] / o["n"],
                       "p50": self._percentile_locked(name, 0.50),
                       "p95": self._percentile_locked(name, 0.95),
                       "p99": self._percentile_locked(name, 0.99),
                       "buckets": list(self._histograms[name])}
                for name, o in self._observations.items()
            }
            return {"counters": dict(self._counters), "observations": obs,
                    "gauges": dict(self._gauges)}


def percentile_of_counts(hist: Sequence[int], q: float) -> Optional[float]:
    """Quantile estimate over a raw bucket-count vector (the same
    log-spaced buckets ``Recorder.observe`` fills) — for WINDOWED
    quantiles built by diffing two ``Recorder.histogram`` copies.
    Returns the covering bucket's nominal upper bound (no exact min/max
    is known for a window), or None for an empty window ("no recent
    data" must stay distinguishable from "zero latency")."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    n = sum(hist)
    if n <= 0:
        return None
    rank = max(1, math.ceil(q * n))
    cum = 0
    for i, c in enumerate(hist):
        cum += c
        if cum >= rank:
            return _bucket_upper(i)
    return _bucket_upper(_HIST_BUCKETS - 1)  # unreachable


def payload_metrics(payload, wire: bool = True) -> Dict[str, int]:
    """Size/occupancy metrics for one δ payload (ops/delta.DeltaPayload,
    single-replica slices): changed/deleted lane counts, dense on-device
    bytes, and (optionally — it costs an encode) actual wire bytes."""
    out = {
        "changed_lanes": int(payload.changed.sum()),
        "deleted_lanes": int(payload.deleted.sum()),
        "dense_bytes": int(payload.nbytes_dense()),
    }
    if wire:
        from go_crdt_playground_tpu_torch.utils.wire import payload_nbytes_wire

        out["wire_bytes"] = int(payload_nbytes_wire(payload))
    return out
