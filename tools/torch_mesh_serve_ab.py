#!/usr/bin/env python3
"""Run chip_smoke.py's phase 13d (the lane-sharded serve node: ``serve
--ingest --mesh-devices 4`` and ``2x2 --sched auto`` at E = 2^20, A = 16)
from two trees of the repo, in turns on one GPU.

    git archive <commit> | tar -x -C D        # D listed in .gitignore
    python3 tools/torch_mesh_serve_ab.py --other D

Each turn is a fresh process started in its tree (its own package, its
own kernel builds, its own ``chip_smoke.py``), in the order other, this,
this, other.  A turn runs the tree's whole phase,
checks included, and fails the tool if they fail.  Prints each turn's
per-node numbers (acked ops/s, ms a batch applied, ack p50/p99) as they
come, then one JSON line with every turn (with the K10 slot timings of a
tree whose phase keeps them), the card's name and power limit.  Needs a
CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MARK = "MESH_SERVE_AB "
# one turn: the tree's phase 13d in process, its result and the timings
# it kept (the K10 slot timings, from this tree on) on one marked line
TURN = f"""
import inspect, json, sys
sys.path.insert(0, ".")
import chip_smoke as cs
smi = cs.nvidia_smi_line()
fn, timings = cs.phase_mesh_serve, {{}}
args = ((cs.Counters(), timings, smi)
        if "timings" in inspect.signature(fn).parameters
        else (cs.Counters(), smi))
out = fn(*args)
print({MARK!r} + json.dumps({{"nodes": out, "timings": timings}}),
      flush=True)
"""
ORDER = ("other", "this", "this", "other")
KEYS = ("ops_per_s", "batch_apply_ms", "ack_p50_ms", "ack_p99_ms",
        "batches", "wall_s", "batch_split")


def run_turn(tree: Path, timeout: int) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", TURN], cwd=tree,
                          capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(MARK)]
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"{tree}: rc {proc.returncode}\n"
                         f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    out = json.loads(lines[-1][len(MARK):])
    return {"wall_s": time.perf_counter() - t0,
            "nodes": {label: {k: leg[k] for k in KEYS if k in leg}
                      for label, leg in out["nodes"].items()
                      if label in ("4", "2x2")},
            "k10_slot": out["timings"].get("K10 slot")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other tree (e.g. the parent commit)")
    ap.add_argument("--timeout", type=int, default=600,
                    help="seconds a turn may take")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    smi = chip_smoke.nvidia_smi_line()
    trees = {"other": args.other.resolve(), "this": ROOT}
    turns = []
    for which in ORDER:
        got = run_turn(trees[which], args.timeout)
        got["tree"] = which
        turns.append(got)
        for label, leg in got["nodes"].items():
            print(f"{got['tree']} --mesh-devices {label}: "
                  f"{leg['ops_per_s']:.1f} acked ops/s, "
                  f"{leg['batch_apply_ms']:.3f} ms a batch applied, ack "
                  f"p50 {leg['ack_p50_ms']:.3f} ms p99 "
                  f"{leg['ack_p99_ms']:.3f} ms, {leg['batches']} batches "
                  f"(turn {got['wall_s']:.1f} s) [{smi}]", flush=True)
    print(json.dumps({"card": smi, "other": str(trees["other"]),
                      "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
