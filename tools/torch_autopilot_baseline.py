#!/usr/bin/env python3
"""The autopilot soak's baseline leg, run again and again: does the
controller split a healthy fleet, and on what signal?

Runs ``tools/torch_fleet_serve_soak.py --autopilot --quick`` RUNS times
at seed SEED and, for each run, reads its first controller's decision
log (every decision, holds included, with the signals it was taken on)
against the baseline leg's window:

* the failed checks, the ring generation after the baseline, the
  calibrated heat rate and the baseline's offered rate;
* the decisions taken inside the baseline window: their count by
  action, the views in which some shard was hot (windowed p99 over the
  budget, or the queue at the watermark) and the worst p99 and queue
  depth seen;
* the first split, its time against the baseline's end, its shard and
  the signal that made it hot.

Each run's decision log, harness timeline and budgets are written to
``--out-dir/run-<i>.json``; the summary to ``--out-dir/summary.json``;
``--out-dir/trace.json`` keeps the first run that split in its
baseline, or else the run whose baseline came nearest to the
watermark, as a replay test reads it
(tests/fixtures/torch_autopilot_trace.json,
tests/test_torch_control.py).

Usage:
    python tools/torch_autopilot_baseline.py [--device cuda] --out-dir DIR
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

RUNS = 10
SEED = 29


def trace_fixture(run: Dict, source: str) -> Dict:
    """What a replay test keeps of one run (a ``run-<i>.json``): the
    first controller's log through its first split's outcome, the
    baseline window and the run's verdict."""
    log, keep = run["decision_log_1"], []
    first = None
    for r in log:
        keep.append(r)
        if r.get("record") == "decision" and r["action"] == "split":
            first = r["seq"]
        if r.get("record") == "outcome" and r.get("decision_seq") == first:
            break
    return {"source": source, "baseline_window_t": run["baseline_window_t"],
            "failures": run["failures"], "summary": run["summary"],
            "decision_log": keep}


def _hot(shard: Dict, policy: Dict) -> Optional[str]:
    if not shard["reachable"]:
        return None
    if shard["p99_ms"] is not None and \
            shard["p99_ms"] / 1e3 > policy["p99_budget_s"]:
        return "p99"
    if shard["queue_depth"] >= policy["queue_watermark"]:
        return "queue"
    return None


def summarize(run: int, res: Dict, rc: int, wall: float) -> Dict:
    """One run's verdict (module docstring)."""
    r = res["result"]
    log = r["decision_log_1"]
    policy = next(x for x in log if x.get("record") == "resume")["policy"]
    t_end = r["baseline_window_t"][1]
    decisions = [x for x in log if x.get("record") == "decision"]
    base = [x for x in decisions if x["signals"]["t"] <= t_end]
    hot_views = [x for x in base if any(
        _hot(s, policy) for s in x["signals"]["per_shard"].values())]
    p99s = [s["p99_ms"] for x in base
            for s in x["signals"]["per_shard"].values()
            if s["p99_ms"] is not None]
    queues = [s["queue_depth"] for x in base
              for s in x["signals"]["per_shard"].values()]
    first = next((x for x in decisions if x["action"] == "split"), None)
    first_split = None
    if first is not None:
        sh = first["signals"]["per_shard"][first["hot_sid"]]
        first_split = {
            "seq": first["seq"], "hot_sid": first["hot_sid"],
            "s_after_baseline_end": round(first["signals"]["t"] - t_end, 3),
            "in_baseline": first["signals"]["t"] <= t_end,
            "signal": _hot(sh, policy), "shard": sh}
    leg = r["legs"]["baseline"]
    return {
        "run": run, "rc": rc, "wall_s": round(wall, 1),
        "failures": res["failures"],
        "after_baseline_generation": r["rings"]["after_baseline_generation"],
        "heat_rate_ops_s": r["calibration"]["heat_rate_ops_s"],
        "base_rate_ops_s": r["calibration"]["rates_ops_s"]["base"],
        "baseline_leg": {k: leg.get(k) for k in (
            "goodput", "acked", "shed_overloaded", "unresolved", "p99_ms")},
        "baseline_decisions": {
            "n": len(base),
            "actions": dict(collections.Counter(x["action"] for x in base)),
            "hot_views": len(hot_views),
            "max_p99_ms": max(p99s, default=None),
            "max_queue_depth": max(queues, default=None)},
        "first_split": first_split,
    }


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", required=True)
    args = ap.parse_args(argv)
    from torch_soak_util import device_label

    label = device_label(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    tool = os.path.join(REPO, "tools", "torch_fleet_serve_soak.py")
    runs, kept = [], {}
    for i in range(RUNS):
        path = os.path.join(args.out_dir, f"run-{i}.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, tool, "--autopilot", "--quick", "--device",
             args.device, "--seed", str(SEED), "--out", path],
            capture_output=True, text=True, timeout=900, cwd=REPO)
        wall = time.perf_counter() - t0
        if not os.path.exists(path):
            print(f"run {i}: no result (rc {proc.returncode}): "
                  f"{proc.stdout[-1500:]} {proc.stderr[-1500:]}", flush=True)
            runs.append({"run": i, "rc": proc.returncode, "result": None})
            continue
        with open(path) as f:
            res = json.load(f)
        s = summarize(i, res, proc.returncode, wall)
        runs.append(s)
        r = res["result"]
        kept[i] = {"summary": s, "failures": res["failures"],
                   "budgets": r["budgets"], "calibration": r["calibration"],
                   "baseline_window_t": r["baseline_window_t"],
                   "decision_log_1": r["decision_log_1"],
                   "timeline": r["timeline"]}
        with open(path, "w") as f:  # keep what a replay needs
            json.dump(kept[i], f)
        print(json.dumps(s) + f" [{label}]", flush=True)
    split_runs = [s["run"] for s in runs
                  if s.get("after_baseline_generation")]
    if kept:
        # the run to pin: a baseline split, else the nearest miss
        pick = split_runs[0] if split_runs else max(kept, key=lambda i: (
            kept[i]["summary"]["baseline_decisions"]["max_queue_depth"] or 0,
            kept[i]["summary"]["baseline_decisions"]["max_p99_ms"] or 0))
        with open(os.path.join(args.out_dir, "trace.json"), "w") as f:
            json.dump(trace_fixture(kept[pick], (
                f"tools/torch_autopilot_baseline.py --device {args.device}, "
                f"run {pick} of {RUNS} at seed {SEED}, on an {label}")), f,
                indent=0, sort_keys=True)
    summary = {"card": label, "device": args.device, "seed": SEED,
               "runs": len(runs), "baseline_splits": split_runs,
               "per_run": runs}
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "per_run"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
