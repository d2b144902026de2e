"""tools/torch_serve_soak.py: the port's serve soak.

The quick mode spawns real ``serve --ingest`` workers and SIGKILLs
them, so it is marked ``slow`` (as tests/test_serve_soak.py is); a
short open-loop leg and the ledger's adjudication run in process
against a torch frontend on the CPU."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))


def test_open_loop_leg_in_process(tmp_path):
    import torch_serve_soak as soak

    from go_crdt_playground_tpu_torch.serve import ServeFrontend, ServeClient

    fe = ServeFrontend(64, 4, durable_dir=str(tmp_path / "d"), max_batch=8,
                       flush_ms=1.0, queue_depth=32, device="cpu")
    fe.serve()
    ledger = soak.Ledger()
    try:
        leg = soak.open_loop_leg(fe.addr, 300.0, 0.5, 64, ledger)
        with ServeClient(fe.addr) as c:
            members, vv = c.members()
    finally:
        fe.close()
    accounted = (leg["acked"] + leg["overloaded"] + leg["expired"]
                 + leg["other"])
    assert accounted == leg["submitted"] > 100 and leg["unresolved"] == 0
    assert int(vv[0]) == leg["acked"]  # one key an op: one tick each
    verdict = ledger.adjudicate(members)
    assert verdict == {"lost_acked_ops": [], "phantom_members": []}
    # the adjudication itself: a missing acked add and a stray member
    kept = min(ledger.acked_adds - ledger.deleted)  # no delete sent
    assert ledger.adjudicate([m for m in members if m != kept]
                             )["lost_acked_ops"] == [kept]
    assert ledger.adjudicate(list(members) + [10_000])[
        "phantom_members"] == [10_000]


@pytest.mark.slow
def test_torch_serve_soak_quick_mode_on_cpu(tmp_path):
    import json

    import torch_serve_soak as soak

    out = str(tmp_path / "soak.json")
    assert soak.main(["--quick", "--device", "cpu", "--out", out]) == 0
    with open(out) as f:
        results = json.load(f)
    assert results["failures"] == []
    assert results["crash"]["kills"] == {"window_hook": 1,
                                         "parent_sigkill": 1}


def _passing_results():
    """A soak result that meets every check of ``failures``."""
    clean = {"lost_acked_ops": [], "phantom_members": [], "drained": True}
    leg = {"offered_rate": 200.0, "achieved_offer_rate": 200.0,
           "goodput": 200.0, "overloaded": 0, "unresolved": 0,
           "send_errors": 0, "p50_ms": 5.0, "submitted": 600,
           "window_end": {},
           "server_ingest_p99_ms": 6.0}
    top = {**leg, "offered_rate": 6000.0, "achieved_offer_rate": 6000.0,
           "goodput": 400.0, "overloaded": 100,
           "server_ingest_p99_ms": 900.0}
    worker = {"dispatches_per_batch": 1.0, "wal_bytes_per_acked_op": 10.0,
              "wal_bytes_per_record": 50.0, "ops_per_batch": 5.0,
              "wal_compact_records": 200, "goodput": 400.0,
              "ingest_p99_ms": 30.0, "unresolved": 0, **clean}
    return {
        "load": {"open_loop": [leg, top], **clean},
        "ingest_compare": {
            "fused": worker,
            "seed": {**worker, "dispatches_per_batch": 2.0,
                     "wal_bytes_per_acked_op": 16.0,
                     "wal_compact_records": 0}},
        "compaction": {"gc_dropped_lanes_under_traffic": 80,
                       "light_server_p99_ms": 30.0,
                       "backoffs_during_heavy": 6, "light_unresolved": 0,
                       "heavy_unresolved": 0, **clean},
        "crash": {"kills": {"window_hook": 1, "parent_sigkill": 1},
                  "record_modes": {"wal.replayed_compact": 60},
                  "unfinished": [], **clean},
        "chaos": {"proxy_counters": {"dropped": 3, "truncated": 4,
                                     "delayed": 9, "refused": 1},
                  "gave_up": [], **clean}}


# one result each of tools/serve_soak.py's checks breaks, and the word
# its failure line carries
BROKEN = {
    "no scaling": (("load", "open_loop", 1, "goodput"), 250.0, "scale"),
    "low goodput": (("load", "open_loop", 0, "goodput"), 150.0, "0.8"),
    "unresolved": (("load", "open_loop", 0, "unresolved"), 1,
                   "unresolved"),
    "no shed": (("load", "open_loop", 1, "overloaded"), 0, "shed"),
    "server p99": (("load", "open_loop", 1, "server_ingest_p99_ms"),
                   2500.0, "p99"),
    "two steps": (("ingest_compare", "fused", "dispatches_per_batch"), 2.0,
                  "steps"),
    "wal bytes": (("ingest_compare", "fused", "wal_bytes_per_acked_op"),
                  12.0, "WAL bytes"),
    "seed compact": (("ingest_compare", "seed", "wal_compact_records"), 3,
                     "compact records"),
    "fused goodput": (("ingest_compare", "fused", "goodput"), 300.0,
                      "goodput"),
    "fused p99": (("ingest_compare", "fused", "ingest_p99_ms"), None,
                  "p99"),
    "no gc": (("compaction", "gc_dropped_lanes_under_traffic"), 0, "GC"),
    "light p99": (("compaction", "light_server_p99_ms"), 2000.0, "p99"),
    "no backoff": (("compaction", "backoffs_during_heavy"), 0, "backoff"),
    "kills": (("crash", "kills", "window_hook"), 0, "kills"),
    "no replay": (("crash", "record_modes", "wal.replayed_compact"), 0,
                  "replayed"),
    "unfinished": (("crash", "unfinished"), [7], "never acked"),
    "lost": (("crash", "lost_acked_ops"), [3], "lost"),
    "phantom": (("compaction", "phantom_members"), [9], "phantom"),
    "no drain": (("ingest_compare", "seed", "drained"), False, "drain"),
    "chaos lost": (("chaos", "lost_acked_ops"), [5], "lost"),
    "chaos gave up": (("chaos", "gave_up"), [6], "never acked"),
    "chaos no delay": (("chaos", "proxy_counters", "delayed"), 0,
                       "proxy counters"),
}


# the checks of what the serve tier guarantees on any hardware
GUARANTEES = {"unresolved", "kills", "no replay", "unfinished", "lost",
              "phantom", "no drain", "chaos lost", "chaos gave up"}

# the named check each broken result fails
NAMES = {"no scaling": "open_loop/scaling",
         "low goodput": "open_loop/goodput_floor",
         "unresolved": "open_loop/unresolved", "no shed": "open_loop/shed",
         "server p99": "open_loop/server_p99",
         "two steps": "ingest_compare/steps",
         "wal bytes": "ingest_compare/wal_bytes",
         "seed compact": "ingest_compare/compact_records",
         "fused goodput": "ingest_compare/goodput",
         "fused p99": "ingest_compare/p99", "no gc": "compaction/gc",
         "light p99": "compaction/light_p99",
         "no backoff": "compaction/backoff", "kills": "crash/kills",
         "no replay": "crash/replayed", "unfinished": "crash/unfinished",
         "lost": "crash/ledger", "phantom": "compaction/ledger",
         "no drain": "ingest_seed/drained", "chaos lost": "chaos/ledger",
         "chaos gave up": "chaos/gave_up",
         "chaos no delay": "chaos/faults_fired"}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_failures_carry_the_reference_checks(case):
    """``failures`` holds a run to tools/serve_soak.py's adjudication:
    a result meeting every check passes, and breaking any one check
    yields exactly one failure line, which names it;
    ``guarantee_failures`` holds the durability and accounting checks
    among them and no others."""
    import copy

    import torch_serve_soak as soak

    assert soak.failures(_passing_results()) == []
    path, value, word = BROKEN[case]
    results = copy.deepcopy(_passing_results())
    target = results
    for key in path[:-1]:
        target = target[key]
    target[path[-1]] = value
    bad = soak.failures(results)
    assert len(bad) == 1 and word in bad[0], bad
    assert soak.check_name(bad[0]) == NAMES[case], bad
    held = soak.guarantee_failures(results)
    assert held == (bad if case in GUARANTEES else []), held
