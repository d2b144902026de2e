#!/usr/bin/env python3
"""Phase walls of chip_smoke.py for two trees on one card.

Runs chosen phases of another tree's chip_smoke.py (``--other``, e.g.
the parent commit unpacked with ``git archive``) and then of this
tree's, each tree in a process of its own started from that tree's
root: phase 1 (the environment and the kernels' build) first, then
``--phases`` in the script's order, each with fresh launch counters and
the arguments the script's ``run_phases`` gives it.  Per phase it
prints its wall and, with ``--profile``, writes the main thread's
``cProfile`` (cumulative, top 40 functions) to
``--out-dir/<dir>-<phase>.txt`` (``<dir>`` the tree root's name): where
two trees' walls differ, the profiles say in which functions.  Each
tree's output is kept in ``--out-dir/other.log`` and ``this.log``.  A
phase that raises is recorded with its error and the next phase runs.
The last line is one JSON object:
``{"card": ..., "walls": {tree: {phase: seconds}}, "errors": ...}``.

Usage:
    python tools/torch_smoke_walls.py --other build/parent
        [--phases 2b,13d] [--profile] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each phase's function and arguments, as chip_smoke.run_phases calls it
# (c: the launch counters, e: the errors, t: the timings, s: the card's
# nvidia-smi line)
PHASES = {
    "2": ("phase_kernels", "e"),
    "2b": ("phase_ingest_kernel", "e"),
    "2c": ("phase_digest_kernel", "e"),
    "2 packed": ("phase_packed_kernels", "e"),
    "10b soak": ("phase_serve_soak", "s"),
    "13c": ("phase_multihost", "c"),
    "13d": ("phase_mesh_serve", "cts"),
    "14": ("phase_bridge", "cets"),
    "16": ("phase_tools", "cs"),
    "17": ("phase_fault_soaks", "cs"),
}


def run_tree(phases, profile_dir) -> dict:
    """In the tree whose root is the working directory: phase 1, then
    ``phases``; returns their walls and errors."""
    sys.path.insert(0, os.getcwd())
    sys.argv = ["chip_smoke.py"]
    import chip_smoke as cs

    walls, errors = {}, {}
    t0 = time.perf_counter()
    smi = cs.phase_environment()
    walls["1"] = time.perf_counter() - t0
    counters, errs, timings = cs.Counters(), {}, {}
    given = {"c": counters, "e": errs, "t": timings, "s": smi}
    for name in phases:
        fn, keys = PHASES[name]
        prof = cProfile.Profile() if profile_dir else None
        t0 = time.perf_counter()
        try:
            if prof:
                prof.enable()
            getattr(cs, fn)(*(given[k] for k in keys))
        except Exception as e:  # recorded; the next phase still runs
            errors[name] = f"{type(e).__name__}: {str(e)[:500]}"
        finally:
            if prof:
                prof.disable()
        walls[name] = time.perf_counter() - t0
        print(f"phase {name}: {walls[name]:.1f} s wall", flush=True)
        if prof:
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats(
                "cumulative").print_stats(40)
            tag = os.path.basename(os.getcwd().rstrip("/")) or "tree"
            path = os.path.join(profile_dir,
                                f"{tag}-{name.replace(' ', '_')}.txt")
            with open(path, "w") as f:
                f.write(out.getvalue())
    return {"walls": {k: round(v, 1) for k, v in walls.items()},
            "errors": errors, "smi": smi}


def main() -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--other", required=True,
                    help="the other tree's root (its chip_smoke.py)")
    ap.add_argument("--phases", default="2b,13d",
                    help="comma-separated: " + ", ".join(PHASES))
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out-dir", default=os.path.join(REPO, "chiprun_out",
                                                      "walls"))
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    os.makedirs(args.out_dir, exist_ok=True)
    if args.one:
        res = run_tree(phases, args.out_dir if args.profile else None)
        print("RESULT " + json.dumps(res), flush=True)
        return 0
    walls, errors, smi = {}, {}, None
    for tag, root in (("other", os.path.abspath(args.other)),
                      ("this", REPO)):
        cmd = [sys.executable, os.path.abspath(__file__), "--one",
               "--other", root, "--phases", args.phases,
               "--out-dir", os.path.abspath(args.out_dir)]
        if args.profile:
            cmd.append("--profile")
        proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        try:
            out, err = proc.communicate()
        finally:
            try:  # whatever the tree's phases left in its session
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        with open(os.path.join(args.out_dir, f"{tag}.log"), "w") as f:
            f.write(out + err)
        lines = [x for x in out.splitlines() if x.startswith("RESULT ")]
        if proc.returncode or not lines:
            errors[tag] = f"rc {proc.returncode}: {err[-2000:]}"
            continue
        res = json.loads(lines[-1][len("RESULT "):])
        walls[tag], smi = res["walls"], res["smi"]
        if res["errors"]:
            errors[tag] = res["errors"]
        print(f"{tag} ({root}): " + json.dumps(res["walls"])
              + f" [{smi}]", flush=True)
    print(json.dumps({"card": smi, "phases": phases, "walls": walls,
                      "errors": errors}))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
