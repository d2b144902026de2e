#!/usr/bin/env python3
"""Where a serve worker's admission goes under overload: the open-loop
legs of tools/torch_serve_soak.py against one ``serve --ingest`` worker
that samples its own threads.

First tools/torch_serve_soak.py --quick runs at seed SEED once for
each of the variants' devices (CUDA and CPU workers), unsampled: its
open-loop legs, the fused leg's ops a batch and WAL bytes an op, and
its failed checks are printed.  Then, for each variant (``cuda``: the
replica on the card; ``cuda-omp1``: the same with ``OMP_NUM_THREADS=1``
in the worker; ``cpu``: the replica on the host) a worker at the soak's
settings (E = 192, batches of up to 32, a 2 ms flush, queue 128,
durable) takes the quick open-loop legs (200, 1,000, 6,000 ops/s for 3
s each, every 10th op a delete).
During the top leg a sampler thread in the worker wakes every
millisecond and records

* how late it woke (the interpreter lock's and the scheduler's wait:
  a thread that holds the lock without blocking delays every wake),
* each Python thread's innermost frames (``sys._current_frames``),
  counted by the thread's role (reader, writer, batcher, ...),
* every OS thread's CPU seconds over the leg (``/proc/self/task``),
  Python's threads by name and the rest (torch's, the CUDA runtime's)
  by their kernel name.

Printed per variant: each leg's offered and achieved offer rate,
goodput, typed sheds, ops the server admitted by the offering's end,
client p50/p99, the server's ingest p99, ops a batch and apply ms; then
the sampler's summary.

Usage:
    python tools/torch_serve_admission.py [--variants cuda,cuda-omp1,cpu]
        [--out FILE]

The sampler perturbs what it samples (it takes the lock 1,000 times a
second); compare variants with each other, and take rates from the
soak's unsampled runs.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import runpy
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

SEED = 23
RATES = (200.0, 1000.0, 6000.0)
LEG_S = 3.0
ELEMENTS = 192
SAMPLE_HZ = 1000.0
VARIANTS = {"cuda": ("cuda", {}), "cuda-omp1": ("cuda", {"OMP_NUM_THREADS":
                                                          "1"}),
            "cpu": ("cpu", {})}


# ---------------------------------------------------------------------------
# the sampler, inside the worker process
# ---------------------------------------------------------------------------


def _task_cpu() -> Dict[int, float]:
    """CPU seconds (user + system) of every OS thread of this process."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                rest = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue  # the thread ended
        out[int(tid)] = (int(rest[11]) + int(rest[12])) / tick
    return out


def _task_name(tid: int, py_names: Dict[int, str]) -> str:
    if tid in py_names:
        return py_names[tid]
    try:
        with open(f"/proc/self/task/{tid}/comm") as f:
            return "os:" + f.read().strip()
    except OSError:
        return f"os:{tid}"


def _role(name: str) -> str:
    for key, role in (("(_reader)", "reader"), ("session-writer", "writer"),
                      ("serve-batcher", "batcher"), ("-accept", "accept"),
                      ("MainThread", "main")):
        if key in name:
            return role
    return name


def _frame_key(frame, depth: int = 4) -> str:
    """The innermost ``depth`` frames, innermost first."""
    parts = []
    while frame is not None and len(parts) < depth:
        code = frame.f_code
        parts.append(f"{os.path.basename(code.co_filename)}:"
                     f"{code.co_name}:{frame.f_lineno}")
        frame = frame.f_back
    return " < ".join(parts)


def _pct(xs: List[float], q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * (len(xs) - 1) + 0.5))] if xs else 0.0


def sample(out_path: str) -> None:
    """Wait for ``out_path.start``, sample every thread at SAMPLE_HZ
    until ``out_path.stop`` appears, then write the summary to
    ``out_path``."""
    me = threading.get_ident()
    while not os.path.exists(out_path + ".start"):
        time.sleep(0.01)
    period = 1.0 / SAMPLE_HZ
    late: List[float] = []
    stacks: Dict[str, collections.Counter] = collections.defaultdict(
        collections.Counter)
    # threads that end inside the window (a leg's readers) keep the CPU
    # time last read: every 50 ticks
    cpu0, t0 = _task_cpu(), time.perf_counter()
    seen, names_seen = dict(cpu0), {}
    t_next, ticks = t0, 0
    while True:
        t_next += period
        wait = t_next - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        now = time.perf_counter()
        late.append(now - t_next)
        t_next = max(t_next, now - period)  # no burst to catch up
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in sys._current_frames().items():
            if ident != me:
                stacks[_role(names.get(ident, "?"))][_frame_key(frame)] += 1
        ticks += 1
        if ticks % 50 == 0:
            seen.update(_task_cpu())
            py_names = {t.native_id: t.name for t in threading.enumerate()}
            for tid in seen:
                names_seen.setdefault(tid, _task_name(tid, py_names))
            if os.path.exists(out_path + ".stop"):
                break
    wall = time.perf_counter() - t0
    by_thread = collections.Counter()
    for tid, sec in seen.items():
        by_thread[names_seen.get(tid, f"os:{tid}")] += sec - cpu0.get(tid,
                                                                        0.0)
    by_role = collections.Counter()
    for name, sec in by_thread.items():
        by_role[_role(name) if not name.startswith("os:") else name] += sec
    import torch

    summary = {
        "wall_s": round(wall, 3), "ticks": ticks,
        "late_ms": {q: round(_pct(late, v) * 1e3, 3) for q, v in
                    (("p50", 0.5), ("p90", 0.9), ("p99", 0.99),
                     ("max", 1.0))},
        "late_mean_ms": round(sum(late) / max(1, len(late)) * 1e3, 3),
        "torch_threads": torch.get_num_threads(),
        "omp_num_threads": os.environ.get("OMP_NUM_THREADS"),
        "cpu_s_by_role": {k: round(v, 3) for k, v in by_role.most_common()},
        "cpu_s_total": round(sum(by_role.values()), 3),
        "stacks": {role: [[n, key] for key, n in c.most_common(8)]
                   for role, c in sorted(stacks.items())},
    }
    with open(out_path + ".tmp", "w") as f:
        json.dump(summary, f)
    os.replace(out_path + ".tmp", out_path)


def sampled_worker(out_path: str, argv: List[str]) -> None:
    """Run ``python -m <argv>`` in this process with the sampler on."""
    threading.Thread(target=sample, args=(out_path,), daemon=True,
                     name="admission-sampler").start()
    sys.argv = [argv[0], *argv[1:]]
    runpy.run_module(argv[0], run_name="__main__", alter_sys=True)


# ---------------------------------------------------------------------------
# the load legs and the soak runs
# ---------------------------------------------------------------------------


def profile_variant(name: str, root: str) -> Dict[str, object]:
    """One sampled worker through the open-loop legs; the top leg
    sampled."""
    import torch_serve_soak as soak

    device, env = VARIANTS[name]
    out_path = os.path.join(root, f"{name}.sample.json")
    plain_argv = soak.worker_argv

    def wrapped(*args, **kw):
        argv = plain_argv(*args, **kw)
        assert argv[1] == "-m"
        return [argv[0], os.path.abspath(__file__), "--sampled-worker",
                out_path, "--", *argv[2:]]

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    soak.worker_argv = wrapped
    try:
        w = soak.Worker(os.path.join(root, name), soak.free_port(),
                        ELEMENTS, device, queue_depth=128, max_batch=32,
                        flush_ms=2.0)
    finally:
        soak.worker_argv = plain_argv
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    ledger = soak.Ledger()
    legs = []
    try:
        for rate in RATES:
            top = rate == RATES[-1]
            if top:
                open(out_path + ".start", "w").close()
            leg = soak.open_loop_leg(w.addr, rate, LEG_S, ELEMENTS, ledger)
            if top:
                open(out_path + ".stop", "w").close()
            st = soak.server_stats(w.addr)
            leg.update(server_ingest_p99_ms=st["ingest_p99_ms"],
                       ops_per_batch=st["ops_per_batch"],
                       apply_ms_mean=st["apply_ms_mean"])
            legs.append(leg)
        t0 = time.monotonic()
        while not os.path.exists(out_path):
            if time.monotonic() - t0 > 60:
                raise RuntimeError(f"{name}: the sampler wrote nothing")
            time.sleep(0.05)
        with open(out_path) as f:
            sampled = json.load(f)
    except BaseException:
        w.kill()
        raise
    fin = soak.finish(w, ledger)
    return {"variant": name, "device": device, "env": env, "legs": legs,
            "sampler": sampled, "lost_acked_ops": fin["lost_acked_ops"],
            "phantom_members": fin["phantom_members"],
            "drained": fin["drained"]}


def soak_runs(root: str, devices) -> Dict[str, object]:
    """tools/torch_serve_soak.py --quick with the workers on each of
    ``devices`` at seed SEED: the open-loop legs, the ingest comparison,
    the failed checks."""
    out = {}
    for device in devices:
        path = os.path.join(root, f"soak-{device}.json")
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, os.path.join(REPO, "tools",
                                          "torch_serve_soak.py"),
             "--quick", "--device", device, "--seed", str(SEED), "--out",
             path], capture_output=True, text=True, timeout=900, cwd=REPO)
        if not os.path.exists(path):
            raise RuntimeError(f"serve soak ({device}) rc {run.returncode}:"
                               f" {run.stdout[-2000:]} {run.stderr[-2000:]}")
        with open(path) as f:
            res = json.load(f)
        ic = res["ingest_compare"]
        out[device] = {
            "rc": run.returncode, "wall_s": round(time.perf_counter() - t0,
                                                  1),
            "open_loop": [{k: leg[k] for k in (
                "offered_rate", "achieved_offer_rate", "goodput", "acked",
                "overloaded", "p50_ms", "p99_ms", "server_ingest_p99_ms",
                "window_end")} for leg in res["load"]["open_loop"]],
            "ingest_compare": {m: {k: ic[m][k] for k in (
                "goodput", "ops_per_batch", "wal_bytes_per_acked_op",
                "wal_bytes_per_record", "dispatches_per_batch")}
                for m in ("seed", "fused")},
            "failures": res["failures"],
            "guarantee_failures": res["guarantee_failures"]}
    return out


def main(argv: List[str] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--sampled-worker"]:
        sampled_worker(argv[1], argv[3:])
        return 0
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--variants", default="cuda,cuda-omp1,cpu")
    ap.add_argument("--out", default=None, help="write the results here")
    args = ap.parse_args(argv)
    from torch_soak_util import device_label

    names = args.variants.split(",")
    label = device_label("cuda" if any(VARIANTS[n][0] == "cuda"
                                       for n in names) else "cpu")
    results: Dict[str, object] = {"card": label, "seed": SEED}
    root = tempfile.mkdtemp(prefix="torch-serve-admission-")
    try:
        devices = dict.fromkeys(VARIANTS[n][0] for n in names)
        results["soak"] = soak_runs(root, devices)
        print(json.dumps({"soak": results["soak"]}), flush=True)
        for name in names:
            res = profile_variant(name, root)
            results[name] = res
            for leg in res["legs"]:
                print(f"{name}: offered {leg['offered_rate']:g}/s, achieved "
                      f"{leg['achieved_offer_rate']:g}/s, goodput "
                      f"{leg['goodput']:g}/s, shed {leg['overloaded']}, "
                      f"admitted by the offering's end "
                      f"{leg['window_end']['admitted']}, client p50 "
                      f"{leg['p50_ms']} p99 {leg['p99_ms']} ms, server p99 "
                      f"{leg['server_ingest_p99_ms']} ms, "
                      f"{leg['ops_per_batch']} ops a batch, apply "
                      f"{leg['apply_ms_mean']} ms [{label}]", flush=True)
            print(json.dumps({name: res["sampler"]}), flush=True)
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
