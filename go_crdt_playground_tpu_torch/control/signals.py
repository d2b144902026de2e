"""The observe third of the control loop: windowed fleet signals.

``FleetSignals`` turns the router's STATS fan-out (one reply: router
counters + per-shard frontend snapshots + ring info + per-shard
windowed op-rates — shard/router.py) into the per-shard WINDOWED view
the policy consumes.  Windowing is poll-to-poll differencing, the same
recipe the in-process compaction scheduler uses (serve/compaction.py):

* **op rate** — two sources: the router's own forwarded-op window
  (``autopilot.op_rates`` in the STATS reply, offered pressure — it
  exists even while a saturated shard sheds) and the diff of each
  shard's ``serve.ops.acked`` counter between polls (absorbed rate);
* **windowed ingest p99** — the bucket-count diff of the shard's
  ``serve.ingest_latency_s`` histogram (``buckets`` rides the
  Recorder snapshot since the autopilot round) through
  ``obs.metrics.percentile_of_counts``.  The cumulative p99 would let
  an hour of calm history mask a live burn; the window reacts within
  one poll;
* **queue depth / shed rate** — the ``serve.queue.depth`` gauge and
  the diff of ``serve.shed.overload``;
* **keyspace heat** — the active ring's ``load_stats`` (keyspace
  balance) + generation/digest, so the policy can see which ring its
  own past actions produced.

A shard the router could not reach reports ``reachable=False`` with
zeroed signals — outages are the BREAKER ladder's job (typed rejects,
redial probes); the autopilot never scales on them, so the policy
treats unreachable as "no evidence", not "cold".

Pure-function core: ``ingest(stats, t)`` consumes an already-fetched
snapshot, so tests replay recorded traces without sockets; ``poll``
is the thin wire wrapper.  All state is touched by the controller
loop thread only.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

from go_crdt_playground_tpu_torch.obs.metrics import percentile_of_counts

_LATENCY_STREAM = "serve.ingest_latency_s"
_QUEUE_GAUGE = "serve.queue.depth"
_ACKED = "serve.ops.acked"
_SHED = "serve.shed.overload"


class ShardSignals(NamedTuple):
    """One shard's windowed signals at one poll."""

    sid: str
    reachable: bool
    op_rate: float          # router-forwarded sub-ops/s (offered)
    acked_rate: float       # acked ops/s since the last poll (absorbed)
    shed_rate: float        # typed Overloaded sheds/s since last poll
    queue_depth: float      # instantaneous admission-queue depth
    p99_s: Optional[float]  # windowed ingest p99; None = no admitted
    #                         ops this window (idle ≠ zero latency)


class FleetView(NamedTuple):
    """One poll's fleet-wide view — everything the policy reads."""

    t: float
    generation: int
    digest: str
    shards: Tuple[str, ...]
    fenced: int              # elements currently fenced (handoff live)
    load_stats: Dict         # ring keyspace balance (shard/ring.py)
    per_shard: Dict[str, ShardSignals]
    # which ROUTER answered this poll (DESIGN.md §22): a failover
    # shows up as an epoch bump between consecutive views, and every
    # decision record carries it — the soak adjudicates that a split
    # after a failover committed through the PROMOTED router
    router_epoch: int = 0
    # which replication-group MEMBER serves each keyspace (DESIGN.md
    # §23): a shard failover shows up as a per-sid epoch bump between
    # consecutive views — the decision log records keyspace failovers
    # the same way it records router ones.  None (not {}: a mutable
    # NamedTuple default is shared class-wide) = pre-§23 router
    shard_epochs: Optional[Dict] = None

    @property
    def reachable(self) -> List[ShardSignals]:
        return [s for s in self.per_shard.values() if s.reachable]

    def imbalance(self) -> Optional[float]:
        """max/mean of the reachable shards' OFFERED op rates — the
        live-traffic imbalance the split exists to fix (keyspace
        balance alone misses skewed keys).  None when idle."""
        rates = [s.op_rate for s in self.reachable]
        if not rates or sum(rates) <= 0:
            return None
        mean = sum(rates) / len(rates)
        return max(rates) / mean if mean > 0 else None

    def to_record(self) -> Dict:
        """The replayable form embedded in decision records."""
        return {
            "t": round(self.t, 3),
            "generation": self.generation,
            "router_epoch": self.router_epoch,
            "shard_epochs": dict(self.shard_epochs or {}),
            "shards": list(self.shards),
            "fenced": self.fenced,
            "imbalance": self.imbalance(),
            "per_shard": {
                sid: {"reachable": s.reachable,
                      "op_rate": round(s.op_rate, 1),
                      "acked_rate": round(s.acked_rate, 1),
                      "shed_rate": round(s.shed_rate, 1),
                      "queue_depth": s.queue_depth,
                      "p99_ms": (None if s.p99_s is None
                                 else round(s.p99_s * 1e3, 2))}
                for sid, s in sorted(self.per_shard.items())},
        }


class FleetSignals:
    """Poll-to-poll windowing over the router STATS surface.

    Single-owner object: the controller loop thread polls and ingests;
    nothing here is touched concurrently (race-ok annotations below
    record that contract for the analysis gate)."""

    def __init__(self) -> None:
        # sid -> (t, acked, shed, latency buckets) of the PREVIOUS
        # poll; the window is the diff against it
        # race-ok: controller loop thread only
        self._prev: Dict[str, Tuple[float, int, int,
                                    Optional[List[int]]]] = {}
        # race-ok: controller loop thread only
        self.last_view: Optional[FleetView] = None

    def poll(self, client, t: float) -> FleetView:
        """One wire poll through an existing ServeClient (raises the
        client's transport errors — the controller counts and retries)."""
        return self.ingest(client.stats(), t)

    def ingest(self, stats: Dict, t: float) -> FleetView:
        """Consume one STATS reply (already fetched) at time ``t``."""
        ring = stats.get("ring", {})
        shard_snaps = stats.get("shards", {})
        op_rates = stats.get("autopilot", {}).get("op_rates", {})
        per_shard: Dict[str, ShardSignals] = {}
        for sid in ring.get("shards", []):
            snap = shard_snaps.get(sid)
            if snap is None:
                # unreachable: no evidence this window; drop the prev
                # sample too — a counter diff across an outage+restart
                # window would go negative (restart resets counters)
                self._prev.pop(sid, None)
                per_shard[sid] = ShardSignals(
                    sid, False, float(op_rates.get(sid, 0.0)),
                    0.0, 0.0, 0.0, None)
                continue
            counters = snap.get("counters", {})
            gauges = snap.get("gauges", {})
            acked = int(counters.get(_ACKED, 0))
            shed = int(counters.get(_SHED, 0))
            buckets = (snap.get("observations", {})
                       .get(_LATENCY_STREAM, {}).get("buckets"))
            prev = self._prev.get(sid)
            acked_rate = shed_rate = 0.0
            p99 = None
            if prev is not None:
                t0, acked0, shed0, buckets0 = prev
                dt = max(1e-6, t - t0)
                # counter regression = the shard restarted between
                # polls: the WHOLE window is unusable — zero rates AND
                # no p99 (a pre-restart vs post-restart bucket diff
                # would fabricate a latency sample from two different
                # process lifetimes)
                if acked >= acked0:
                    acked_rate = (acked - acked0) / dt
                    shed_rate = max(0, shed - shed0) / dt
                    if buckets is not None:
                        if buckets0 is not None and len(buckets0) == len(
                                buckets):
                            window = [max(0, b - a)
                                      for a, b in zip(buckets0, buckets)]
                        else:
                            window = list(buckets)
                        p99 = percentile_of_counts(window, 0.99)
            self._prev[sid] = (t, acked, shed,
                               None if buckets is None else list(buckets))
            per_shard[sid] = ShardSignals(
                sid, True, float(op_rates.get(sid, 0.0)), acked_rate,
                shed_rate, float(gauges.get(_QUEUE_GAUGE, 0.0)), p99)
        # shards that left the ring must not leak stale prev samples
        live = set(per_shard)
        for sid in [s for s in self._prev if s not in live]:
            del self._prev[sid]
        view = FleetView(
            t=t,
            generation=int(ring.get("generation", 0)),
            digest=str(ring.get("digest", "")),
            shards=tuple(ring.get("shards", [])),
            fenced=int(ring.get("fenced", 0)),
            load_stats=dict(ring.get("load_stats", {})),
            per_shard=per_shard,
            router_epoch=int(ring.get("router_epoch", 0) or 0),
            shard_epochs={str(s): int(e) for s, e in
                          (ring.get("shard_epochs") or {}).items()})
        self.last_view = view
        return view
