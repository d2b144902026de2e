"""The analysis gate CLI (DESIGN.md §15, §26).

    python -m go_crdt_playground_tpu_torch.analysis           # full gate
    python -m go_crdt_playground_tpu_torch.analysis --fast    # tier-1
    python -m go_crdt_playground_tpu_torch.analysis --out P   # report
    python -m go_crdt_playground_tpu_torch.analysis --json    # summary
    python -m go_crdt_playground_tpu_torch.analysis --device cpu

The port's twin of ``python -m go_crdt_playground_tpu.analysis``: the
same fourteen passes over the port's own tree.  ``--device`` (default
``cuda``, which raises without a GPU, as every port entry does) is where
the runtime passes run: the lattice laws sample and join on it (the
AWSet and OR-Map joins through K2 on the card) and the lockset exercise
drives a ``Node`` there (K10 on the card).

Runs every registered pass and writes ``ANALYSIS_REPORT_TORCH.json``:

1. lock-discipline lint (``# guarded-by:`` + lock-order cycles) over
   the threaded runtime files;
2. a short in-process lockset race-detector exercise (instrumented
   Node + DeltaWal driven from racing threads, micro-batches through
   ``ingest_batch`` among the node's mutations) so the runtime pass is
   covered on every gate run, not only under the opt-in soaks;
3. durability-ordering lint over the WAL/checkpoint modules and the
   kernel-purity lint over ``ops/`` (roots: the plain versions and the
   ctypes launchers);
4. lattice-law property checks of every registered join (each family's
   declared law subset — non-idempotent merge strategies like the
   model-merging mean register fewer laws, never zero checks);
5. the wire-contract suite: W001 dispatch exhaustiveness + W002
   reject-code discipline + W004 frame-cap discipline
   (``protocol_contract``), W003 codec symmetry with the seeded
   roundtrip/truncation/garble harness (``codec_symmetry``), and the
   M001 metrics contract (``metrics_contract``);
6. the protocol verification ladder (§26): E001 persist-before-
   announce ordering over the registered promotion paths
   (``epoch_order``), E002 fence coverage of every write-verb
   dispatcher arm (``fence_coverage``), D002 blocking device
   transfers under held locks (``transfer_lock``), and the
   ``protomodel`` explorer — exhaustive interleaving+crash
   enumeration of the router-HA / shard-replication / handoff models
   with E003 freshness pins against the mirrored source;
7. report freshness: the COMMITTED ``ANALYSIS_REPORT_TORCH.json``'s pass
   list must match the registered passes — a new pass cannot land
   while the committed artifact silently claims full coverage.

All source-reading passes share one parse cache (``loader.py``); its
hit counts and the gate wall time land in the report's ``meta`` block
(tier-1 asserts ``--fast`` stays under ``FAST_BUDGET_S``).

Exit status: 0 iff no ERROR finding.  ``--fast`` trims the lattice
seeds, the codec sample counts, and the lockset exercise, not the
pass list — every pass runs in every mode (tier-1 wires ``--fast`` in
as a non-slow test).  ``--json`` prints one machine-readable summary
line instead of per-finding lines; the exit contract is identical.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
from typing import List, Optional

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# pass targets, package-relative (DESIGN.md §15 pass catalog; the
# serve/ files are the serving frontend — its admission queue,
# session writers, batcher, and client are all multi-threaded shared
# state, so the guarded-by sweep covers them like the sync runtime;
# the shard/ files are the router tier — its per-shard links, relay
# fan-in, and fleet runner cross as many threads as the frontend does)
LOCK_TARGETS = ["net/peer.py", "net/antientropy.py", "net/digestsync.py",
                # the port's CircuitBreaker lives here (the reference
                # keeps it in net/antientropy.py): swept like its home
                "net/breaker.py",
                "utils/wal.py",
                "serve/admission.py", "serve/session.py",
                "serve/batcher.py", "serve/frontend.py",
                "serve/client.py", "serve/host.py", "serve/compaction.py",
                "obs/metrics.py",
                "shard/ring.py", "shard/router.py", "shard/fleet.py",
                "shard/handoff.py",
                # the mesh replica tier: a Node subclass
                # whose compiled-program caches and re-pin paths run
                # under the node lock like every other state mutation
                "parallel/meshtarget.py",
                # the 2-D dp×mp tier: its striping planner
                # and chunked apply loop run under the node lock; the
                # stripe/program caches follow the 1-D discipline
                "parallel/meshtarget2d.py",
                # the fleet autopilot: the controller loop
                # thread owns most state (race-ok-annotated), but the
                # signal poller, standby pool and actuator cross the
                # loop thread with start/stop owners and post-stop
                # readers — swept like every other runtime tier
                "control/signals.py", "control/policy.py",
                "control/actuator.py", "control/controller.py",
                # the router HA tier: the standby's tail
                # loop thread, the promotion path, and await/observer
                # readers all cross on the standby lock
                "shard/ha.py",
                # the shard replication tier: the publisher's
                # condition crosses WAL_SYNC reader threads with the
                # batcher's ack gate, and the shard
                # standby's tail loop crosses promote()/observers —
                # plus the shared degrade-window latch both serving
                # ladders poll cross-thread
                "shard/replica.py", "utils/degrade.py",
                # the conflict-aware admission scheduler:
                # owned by the batcher loop thread, race-ok-annotated
                # read-only config — swept so the annotations stay
                # honest as the scheduler grows state
                "serve/scheduler.py"]
# extra files that participate in the lock-ORDER graph (their locks can
# nest under the runtime's)
LOCK_ORDER_EXTRA = ["utils/checkpoint.py"]
DURABILITY_TARGETS = ["utils/wal.py", "utils/checkpoint.py",
                      "utils/checkpoint_sharded.py", "utils/fsutil.py",
                      "shard/handoff.py"]
PURITY_TARGETS = ["ops/merge.py", "ops/delta.py", "ops/lattices.py",
                  "ops/vv.py", "ops/compact.py", "ops/cuda_merge.py",
                  "ops/cuda_delta.py", "ops/ingest.py",
                  "ops/cuda_ingest.py", "ops/digest.py",
                  "ops/cuda_digest.py", "parallel/meshtarget.py",
                  "parallel/meshtarget2d.py",
                  # the scheduler's planning core (key_runs/plan_emit)
                  # is pure host-side combinatorics: no I/O, no
                  # hidden state — hold it to the kernel bar
                  "serve/scheduler.py"]
# attribute-name -> class hints for cross-class lock-order edges
ATTR_CLASSES = {"wal": "DeltaWal", "node": "Node",
                "recorder": "Recorder", "_store": "CheckpointStore",
                "breaker": "CircuitBreaker", "queue": "AdmissionQueue",
                "session": "Session", "batcher": "MicroBatcher",
                "supervisor": "SyncSupervisor", "target": "Node",
                "ring": "HashRing", "router": "ShardRouter",
                "relay": "_Relay", "_client": "ServeClient",
                "host": "ConnHost", "handoff": "HandoffCoordinator",
                "_route": "RouteState",
                "compactor": "CompactionScheduler",
                "_negotiator": "DigestNegotiator",
                "_group_adapter": "AdaptiveGroupSize",
                "policy": "AutopilotPolicy",
                "actuator": "ReshardActuator",
                "signals": "FleetSignals",
                "pool": "StandbyPool",
                "pilot": "FleetAutopilot",
                "standby": "RouterStandby",
                "repl": "ReplicationPublisher",
                "window": "DegradeWindow",
                "_storage": "DegradeWindow",
                "scheduler": "ConflictScheduler"}

# the D002 sweep: every lock-swept runtime file plus the framing
# module (its WAL-record encoder runs under the node lock by call,
# not by lexical with-block — the fixpoint finds it)
TRANSFER_TARGETS = LOCK_TARGETS + ["net/framing.py"]

# the full pass list (report keys): the report-freshness lint pins the
# COMMITTED artifact's pass list to this — landing a new pass without
# regenerating ANALYSIS_REPORT_TORCH.json fails the gate instead of letting
# the committed artifact silently claim full coverage
REGISTERED_PASSES = ("lockdiscipline", "locksets", "durability",
                     "purity", "lattice_laws", "protocol_contract",
                     "codec_symmetry", "metrics_contract",
                     "report_freshness", "thread_shadow",
                     "epoch_order", "fence_coverage", "transfer_lock",
                     "protomodel")

# the --fast wall-time envelope (meta.fast_budget_s): generous against
# the measured ~7s so CI jitter never flakes, tight enough that a
# pass going quadratic (or a model scope exploding) fails tier-1
FAST_BUDGET_S = 60.0


def _paths(rel: List[str], root: str) -> List[str]:
    return [os.path.join(root, p) for p in rel]


def run_lockset_exercise(report, *, rounds: int = 200,
                         device="cuda") -> None:
    """A small deliberately-contended workload under the instrumented
    classes: two threads mutate one Node (adds/deletes and one-row
    micro-batches through ``ingest_batch`` vs members/vv reads) while
    two more hammer one DeltaWal.  Everything shared is lock-guarded in
    the current tree, so a clean run reports zero races — and the pass
    is exercised end-to-end on every gate run.  The node lives on
    ``device``: on the card its batches launch K10."""
    import tempfile

    import numpy as np

    from go_crdt_playground_tpu_torch.analysis.locksets import RaceDetector
    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.utils.wal import DeltaWal

    det = RaceDetector()
    with tempfile.TemporaryDirectory(prefix="analysis-locksets-") as d:
        node = Node(0, 32, 4, device=device)
        wal = DeltaWal(os.path.join(d, "wal"), fsync=False)
        det.instrument(node, label="Node#gate")
        det.instrument(wal, label="DeltaWal#gate")
        try:
            stop = threading.Event()

            def mutate() -> None:
                i = 0
                while not stop.is_set():
                    node.add(i % 32)
                    if i % 3 == 0:
                        node.delete((i + 1) % 32)
                    if i % 2 == 0:
                        add = np.zeros((1, 32), bool)
                        dl = np.zeros((1, 32), bool)
                        add[0, (i + 7) % 32] = True
                        dl[0, (i + 11) % 32] = True
                        node.ingest_batch(add, dl)
                    i += 1

            def observe() -> None:
                while not stop.is_set():
                    node.members()
                    node.vv()

            def log(tag: bytes) -> None:
                i = 0
                while not stop.is_set():
                    wal.append(tag + str(i).encode())
                    i += 1

            threads = [threading.Thread(target=t, args=a, daemon=True)
                       for t, a in ((mutate, ()), (observe, ()),
                                    (log, (b"a",)), (log, (b"b",)))]
            for t in threads:
                t.start()
            # bound by work, not wall time: wait until the WAL saw
            # enough appends (or a short timeout on pathologic hosts)
            deadline = rounds
            import time as _time

            t0 = _time.monotonic()
            while _time.monotonic() - t0 < 10.0:
                if wal.record_count() >= deadline:
                    break
                _time.sleep(0.01)
            stop.set()
            for t in threads:
                t.join(timeout=5.0)
        finally:
            stats = det.stats()
            det.uninstall(node)
            det.uninstall(wal)
            wal.close()
    report.extend(det.findings)
    report.add_stats("locksets", mode="gate-exercise", **stats)


def check_report_freshness(report, committed_path: str,
                           out_path: Optional[str] = None) -> None:
    """The committed artifact's pass list must match the registered
    passes (F001) — stale coverage claims fail the gate; regenerating
    the artifact with the full gate is the documented fix.  When THIS
    run's ``--out`` is the committed path itself, the run IS the
    regeneration: the pre-run file is about to be superseded, so it is
    recorded (mode=regenerating), never flagged — without this, the
    documented fix command would exit 1 on its own first run and embed
    a spurious stale-against-itself finding in the fresh artifact.
    CI and the tier-1 test write to a separate --out, so staleness of
    the committed file stays enforced where it matters."""
    import json

    from go_crdt_playground_tpu_torch.analysis.report import (
        REPORT_STALE, SEVERITY_ERROR, Finding)

    # the path as the repo names it (a checkout's own prefix stays out
    # of the committed artifact)
    stats = {"registered": sorted(REGISTERED_PASSES),
             "committed_path": os.path.relpath(
                 committed_path, os.path.dirname(PKG_ROOT))}
    if (out_path is not None and os.path.abspath(out_path)
            == os.path.abspath(committed_path)):
        report.add_stats("report_freshness", mode="regenerating",
                         **stats)
        return
    if not os.path.exists(committed_path):
        # a fresh clone mid-regeneration: the write at the end of this
        # very run creates it — absence is not a stale claim
        report.add_stats("report_freshness", committed=None, **stats)
        return
    try:
        with open(committed_path) as f:
            committed = sorted(json.load(f).get("passes", {}))
    except (ValueError, OSError) as e:
        report.extend([Finding(
            analyzer="report_freshness", code=REPORT_STALE,
            severity=SEVERITY_ERROR, path=committed_path,
            message=f"committed ANALYSIS_REPORT_TORCH.json unreadable: {e}")])
        report.add_stats("report_freshness", committed=None, **stats)
        return
    report.add_stats("report_freshness", committed=committed, **stats)
    if set(committed) != set(REGISTERED_PASSES):
        missing = sorted(set(REGISTERED_PASSES) - set(committed))
        extra = sorted(set(committed) - set(REGISTERED_PASSES))
        report.extend([Finding(
            analyzer="report_freshness", code=REPORT_STALE,
            severity=SEVERITY_ERROR, path=committed_path,
            message=(f"committed report's pass list is stale "
                     f"(missing {missing}, extra {extra}) — "
                     "regenerate it with the full gate: "
                     "python -m go_crdt_playground_tpu_torch.analysis"))])


def build_report(fast: bool, root: str = PKG_ROOT,
                 skip_runtime: bool = False,
                 committed_report: Optional[str] = None,
                 out_path: Optional[str] = None, device="cuda"):
    import time

    from go_crdt_playground_tpu_torch.device import resolve_device

    from go_crdt_playground_tpu_torch.analysis import (
        codec_symmetry, durability, epoch_order, fence_coverage, lattice_laws,
        lockdiscipline, metrics_contract, protocol_contract, protomodel,
        purity, thread_shadow, transfer_lock)
    from go_crdt_playground_tpu_torch.analysis.loader import SourceLoader
    from go_crdt_playground_tpu_torch.analysis.report import Report

    device = resolve_device(device)
    t0 = time.monotonic()
    report = Report()
    # ONE parse per file per gate run: every source-reading pass below
    # shares this cache (meta.parse_cache records the dedup)
    loader = SourceLoader()

    findings, stats = lockdiscipline.analyze_files(
        _paths(LOCK_TARGETS + LOCK_ORDER_EXTRA, root),
        attr_classes=ATTR_CLASSES, loader=loader)
    # the extra files join the lock-order graph only; their guarded-by
    # coverage is (deliberately) not yet swept, so restrict L001/L003 to
    # the targeted runtime files
    targeted = {os.path.abspath(p) for p in _paths(LOCK_TARGETS, root)}
    findings = [f for f in findings
                if f.code == "L002" or f.path is None
                or os.path.abspath(f.path) in targeted]
    report.extend(findings)
    report.add_stats("lockdiscipline", **stats)

    f2, s2 = durability.analyze_files(_paths(DURABILITY_TARGETS, root),
                                      loader=loader)
    report.extend(f2)
    report.add_stats("durability", **s2)

    f3, s3 = purity.analyze_files(_paths(PURITY_TARGETS, root),
                                  loader=loader)
    report.extend(f3)
    report.add_stats("purity", **s3)

    seeds = (11,) if fast else (11, 12, 13)
    n_ops = 24 if fast else 40
    f4, s4 = lattice_laws.check_registry(seeds, n_ops=n_ops, device=device)
    report.extend(f4)
    report.add_stats("lattice_laws", **s4)

    # the wire-contract suite (DESIGN.md §15 W001-W004 + M001)
    f5, s5 = protocol_contract.analyze(root, loader=loader)
    report.extend(f5)
    report.add_stats("protocol_contract", **s5)

    f6, s6 = codec_symmetry.analyze(root, fast=fast, loader=loader)
    report.extend(f6)
    report.add_stats("codec_symmetry", **s6)

    f7, s7 = metrics_contract.analyze(root, loader=loader)
    report.extend(f7)
    report.add_stats("metrics_contract", **s7)

    # T001 Thread-subclass attribute shadowing (the
    # _stop-breaks-join() bug class, now gate-time)
    f8, s8 = thread_shadow.analyze(root, loader=loader)
    report.extend(f8)
    report.add_stats("thread_shadow", **s8)

    # the protocol verification ladder (DESIGN.md §26): ordering lint,
    # fence coverage, transfer-under-lock, and the model checker
    f9, s9 = epoch_order.analyze(root, loader=loader)
    report.extend(f9)
    report.add_stats("epoch_order", **s9)

    f10, s10 = fence_coverage.analyze(root, loader=loader)
    report.extend(f10)
    report.add_stats("fence_coverage", **s10)

    f11, s11 = transfer_lock.analyze(root, TRANSFER_TARGETS,
                                     loader=loader)
    report.extend(f11)
    report.add_stats("transfer_lock", **s11)

    f12, s12 = protomodel.analyze(root, loader=loader)
    report.extend(f12)
    report.add_stats("protomodel", **s12)

    if committed_report is None:
        committed_report = os.path.join(os.path.dirname(root),
                                        "ANALYSIS_REPORT_TORCH.json")
    check_report_freshness(report, committed_report, out_path)

    if skip_runtime:
        report.add_stats("locksets", mode="skipped")
    else:
        run_lockset_exercise(report, rounds=60 if fast else 200,
                             device=device)

    # meta is top-level report metadata, deliberately NOT a pass: the
    # F001 pass-list comparison and the census tests key on "passes"
    report.meta.update({
        "wall_time_s": round(time.monotonic() - t0, 3),
        "fast": bool(fast),
        "device": str(device),
        "fast_budget_s": FAST_BUDGET_S,
        "parse_cache": loader.stats(),
    })
    return report


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m go_crdt_playground_tpu_torch.analysis",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--fast", action="store_true",
                    help="tier-1 budget: fewer lattice seeds, shorter "
                         "lockset exercise (every pass still runs)")
    ap.add_argument("--out", default="ANALYSIS_REPORT_TORCH.json",
                    help="report path (default: "
                         "./ANALYSIS_REPORT_TORCH.json)")
    ap.add_argument("--root", default=PKG_ROOT,
                    help="package root to analyze (default: the "
                         "installed go_crdt_playground_tpu_torch)")
    ap.add_argument("--skip-runtime", action="store_true",
                    help="skip the in-process lockset exercise (pass is "
                         "reported as skipped, not covered)")
    ap.add_argument("--committed-report", default=None,
                    help="committed ANALYSIS_REPORT_TORCH.json the "
                         "freshness lint checks (default: <repo>/"
                         "ANALYSIS_REPORT_TORCH.json next to the "
                         "package)")
    ap.add_argument("--device", default="cuda",
                    help="where the runtime passes run (lattice laws, "
                         "lockset exercise): cuda (default; raises "
                         "without a GPU) or cpu")
    ap.add_argument("--json", action="store_true",
                    help="print one machine-readable JSON summary line "
                         "instead of per-finding lines (same exit "
                         "contract: 0 iff no ERROR finding)")
    args = ap.parse_args(argv)

    report = build_report(args.fast, root=args.root,
                          skip_runtime=args.skip_runtime,
                          committed_report=args.committed_report,
                          out_path=args.out, device=args.device)
    report.write_json(args.out)
    n_err = len(report.errors())
    if args.json:
        import json

        summary = {
            "ok": report.ok(),
            "findings": len(report.findings),
            "errors": n_err,
            "passes": sorted(report.stats),
            "wall_time_s": report.meta.get("wall_time_s"),
            "model_states": report.stats.get(
                "protomodel", {}).get("total_states"),
            "out": args.out,
            "device": report.meta.get("device"),
        }
        print(json.dumps(summary, sort_keys=True))
        return 0 if report.ok() else 1
    for f in report.findings:
        print(f.render())
    print(f"wrote {args.out}: {len(report.findings)} findings, "
          f"{n_err} errors, passes: "
          + ", ".join(sorted(report.stats)))
    return 0 if report.ok() else 1


if __name__ == "__main__":
    sys.exit(main())
