#!/usr/bin/env python3
"""Phase 12b of chip_smoke.py, run again and again: does the autopilot
leg hold, and on what readings?

Each call runs 12b RUNS times; run it for a parent tree (``--tree``)
and for this one in the same call to compare them.  Each run executes
12b as the tree's chip_smoke.py does: its
``FLEET_SOAK_MODES`` one after another (the sweep, ``--shard-repl``,
``--router-ha``, then ``--autopilot``), each
``tools/torch_fleet_serve_soak.py --quick --device D`` of that tree,
run as chip_smoke.run_tool runs a tool (a session of its own, its
process group killed once it exits).  For each run it records:

* each mode's exit code, wall and failed checks;
* leftovers: the processes a mode left alive when it exited (this
  tool makes itself its descendants' subreaper, so an orphan becomes
  its child and is read from its own ``/proc`` entries only), those
  alive after its group was killed, and any alive when the next mode
  starts;
* the autopilot leg: its calibration as the soak prints it (the
  measured capacity, its windows, their spread and the ramp; each
  leg's hottest shard's planned load in units of it), the baseline's
  decisions (views with a hot shard, worst p99 and queue), and the
  first split and its time against the baseline's end; where the
  tree's soak reads them, the calibration's readings with their ages
  after the fleet's start (``readings``) and what the router carried
  (``carry``), s1 in the burn as the controller saw it (``burn_s1``:
  deepest queue, highest shed rate, heated or not) and s1's onset read
  again after the checks (the soak's ``--second-reading``, which the
  autopilot leg gets where the tree's soak has it) over the
  calibration's, with s1's planned burn over each (``drift``).

Each run's result is written to ``--out-dir/run-<i>.json`` (its
summary line under ``run``; the autopilot's summary, decision log,
timeline and budgets; the other modes' results), one summary line a
run is printed, and the totals go to
``--out-dir/summary.json`` and a last ``runs:`` line (runs, runs with a
failed mode, failures by check, the capacities and their spread,
and each leg's second reading over its calibration, planned burn over
the second reading and heated burn).
``--out-dir/trace.json`` keeps the first run that split in its
baseline, or else the run whose baseline came nearest to the watermark,
as a replay test reads it (tests/fixtures/torch_autopilot_trace.json,
tests/test_torch_control.py).

``--side-by-side`` runs the sweep, ``--shard-repl`` and ``--router-ha``
together instead (``SIDE_BY_SIDE``, the layout in which ROADMAP queue 3
item 13 was seen), RUNS times: for each run the modes' exit codes
and failed checks, ``--shard-repl``'s promotion seconds and shard and
router epochs, ``--router-ha``'s promotion seconds and router epochs,
the ports every descendant listened on (sampled each second), any
port two modes' processes listened on and how many lay in the kernel's
ephemeral range (where a connection's source port may take one), and
the processes left alive;
``side-<i>.json`` a run and ``side-summary.json``.

Usage:
    python tools/torch_autopilot_baseline.py [--device cuda] --out-dir DIR
        [--tree DIR] [--side-by-side]
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from torch_soak_util import (own_children, reap, reap_zombies,  # noqa: E402
                             set_subreaper)

# runs of each tree a call: a parent and this tree, RUNS each, fit one
# call to the card (about 5 minutes a run)
RUNS = 3
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


def _median(xs: List[float]) -> Optional[float]:
    return sorted(xs)[len(xs) // 2] if xs else None


# what a run keeps of the soak's calibration (a tree from before the
# measured capacity prints none of them; its own is in run-<i>.json)
CALIBRATION_KEYS = ("capacity_ops_s", "window_acked_ops_s", "window_shed",
                    "acked_spread", "below_onset_acked_ops_s", "ramp",
                    "rates_ops_s", "planned_load", "age_s", "readings",
                    "onset_ops_s", "carry")


def summarize_autopilot(res: Dict) -> Dict:
    """The autopilot leg's readings (module docstring)."""
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
        "after_baseline_generation": r["rings"]["after_baseline_generation"],
        "calibration": {k: r["calibration"].get(k) for k in CALIBRATION_KEYS},
        "baseline_leg": {k: leg.get(k) for k in (
            "goodput", "acked", "shed_overloaded", "unresolved", "p99_ms")},
        "baseline_decisions": {
            "n": len(base),
            "actions": dict(collections.Counter(x["action"] for x in base)),
            "hot_views": len(hot_views),
            "max_p99_ms": max(p99s, default=None),
            "max_queue_depth": max(queues, default=None)},
        "first_split": first_split,
        # a tree from before the second reading has none of these
        "burn_s1": r.get("burn_s1"),
        "drift": r.get("drift"),
    }


def start_mode(tool: str, flags, device: str, out: str):
    """Start one mode's tool as chip_smoke.run_tool runs it (a session
    of its own), its output into files beside ``out``."""
    logs = [open(f"{out}.{name}", "w+") for name in ("stdout", "stderr")]
    proc = subprocess.Popen(
        [sys.executable, tool, "--device", device, *flags, "--out", out],
        stdout=logs[0], stderr=logs[1], text=True, start_new_session=True)
    return proc, time.perf_counter(), logs


def finish_mode(started, out: str, others=()) -> Dict:
    """Wait for a started mode's tool, note the processes it leaves
    behind (its own group's and orphans, not ``others``' groups), kill
    its group.  Returns its record and, under ``result``, its ``--out``
    JSON (None when it wrote none)."""
    proc, t0, logs = started
    record: Dict[str, object] = {}
    try:
        proc.wait(timeout=max(1.0, 900 - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        record["timed_out"] = True
    record["wall_s"] = round(time.perf_counter() - t0, 1)
    record["rc"] = proc.returncode
    left = {pid: cmd for pid, cmd in own_children().items()
            if _pgid(pid) not in others}
    record["left_at_exit"] = [
        {"pid": pid, "pgid_is_tool": _pgid(pid) == proc.pid, "cmd": cmd}
        for pid, cmd in left.items()]
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    record["left_after_group_kill"] = [pid for pid in left if _alive(pid)]
    reap(left)
    record["result"] = None
    if os.path.exists(out):
        with open(out) as f:
            record["result"] = json.load(f)
        record.update({k: record["result"][k] for k in (
            "failures", "guarantee_failures")})
    else:
        record["failures"] = ["no_result"]
        tails = []
        for f in logs:
            f.seek(0)
            tails.append(f.read()[-1500:])
        record["tail"] = tails
    for f in logs:
        f.close()
    return record


def run_mode(tool: str, flags, device: str, out: str) -> Dict:
    """One mode's tool alone (start_mode, finish_mode)."""
    record = finish_mode(start_mode(tool, flags, device, out), out)
    reap_zombies()
    return record


def _pgid(pid: int) -> Optional[int]:
    try:
        return os.getpgid(pid)
    except ProcessLookupError:
        return None


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def fleet_soak_modes(tree: str):
    """The tree's chip_smoke.py ``FLEET_SOAK_MODES`` (its 12b order),
    read without running its main."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_of_tree", os.path.join(tree, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.FLEET_SOAK_MODES


def second_reading_flag(tree: str) -> Tuple[str, ...]:
    """``--second-reading`` where the tree's soak has it, else nothing."""
    with open(os.path.join(tree, "tools", "torch_fleet_serve_soak.py")) as f:
        return ("--second-reading",) if '"--second-reading"' in f.read() \
            else ()


def run_12b(tree: str, device: str, tmp: str) -> Dict[str, object]:
    """One run of 12b (module docstring)."""
    tool = os.path.join(tree, "tools", "torch_fleet_serve_soak.py")
    modes, alive = {}, []
    t0 = time.perf_counter()
    for mode, flags in fleet_soak_modes(tree):
        before = own_children()
        alive.append({"before": mode, "alive": list(before.values())})
        reap(before)
        if mode == "autopilot":
            flags = (*flags, *second_reading_flag(tree))
        modes[mode] = run_mode(tool, flags, device,
                               os.path.join(tmp, f"{mode}.json"))
    return {"wall_s": round(time.perf_counter() - t0, 1),
            "alive_before_mode": alive, "modes": modes}


# 12b's modes run together: the layout in which ROADMAP queue 3 item 13
# (--shard-repl's s0 standby promoting after 58.9 s at shard epoch 408)
# was seen; the autopilot leg keeps to itself
SIDE_BY_SIDE = ("sweep", "shard_repl", "router_ha")


def listening_ports() -> Dict[int, tuple]:
    """The TCP ports each descendant listens on, with its process group
    and command line read in the same pass (a process that exits before
    the next read is still attributed): LISTEN rows of /proc/net/tcp by
    socket inode, matched to the descendants' fds.  ``{pid: (ports,
    pgid, cmd)}``."""
    inodes: Dict[str, int] = {}
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(table) as f:
                rows = f.read().splitlines()[1:]
        except OSError:
            continue
        for row in rows:
            cols = row.split()
            if len(cols) > 9 and cols[3] == "0A":  # TCP_LISTEN
                inodes[cols[9]] = int(cols[1].rsplit(":", 1)[1], 16)
    out: Dict[int, tuple] = {}
    for pid, cmd in own_children().items():
        pgid = _pgid(pid)
        try:
            fds = os.listdir(f"/proc/{pid}/fd")
        except OSError:
            continue
        ports = set()
        for fd in fds:
            try:
                link = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if link.startswith("socket:[") and link[8:-1] in inodes:
                ports.add(inodes[link[8:-1]])
        if ports:
            out[pid] = (sorted(ports), pgid, cmd)
    return out


def side_by_side_readings(res: Optional[Dict]) -> Dict:
    """Promotion seconds and epochs of a --shard-repl or --router-ha
    result (None where the mode wrote none)."""
    r = (res or {}).get("result") or {}
    legs = r.get("legs") or {}
    fo = legs.get("failover") or {}
    out = {"promote_s": fo.get("promote_s"),
           "promote_budget_s": fo.get("promote_budget_s")}
    if "shard_epochs" in fo:
        out.update(
            shard_epochs=fo.get("shard_epochs"),
            bitwise_promote_s=(legs.get("bitwise") or {}).get("promote_s"),
            bitwise_shard_epochs=(legs.get("bitwise") or {}).get(
                "shard_epochs"),
            router_shard_epochs=(legs.get("resurrection") or {}).get(
                "router_shard_epochs"))
    elif "ring_after" in fo:
        out.update(router_epoch_before=fo["ring_before"].get("router_epoch"),
                   router_epoch_after=fo["ring_after"].get("router_epoch"))
    return out


def run_side_by_side(tree: str, device: str, tmp: str) -> Dict[str, object]:
    """SIDE_BY_SIDE's modes started together; the ports every
    descendant listened on, sampled each second while they run."""
    tool = os.path.join(tree, "tools", "torch_fleet_serve_soak.py")
    modes = dict(fleet_soak_modes(tree))
    reap(own_children())
    t0 = time.perf_counter()
    started = {m: start_mode(tool, modes[m], device,
                             os.path.join(tmp, f"{m}.json"))
               for m in SIDE_BY_SIDE}
    groups = {m: st[0].pid for m, st in started.items()}
    seen: Dict[int, Dict[str, object]] = {}
    while any(st[0].poll() is None for st in started.values()):
        for pid, (ports, pgid, cmd) in listening_ports().items():
            rec = seen.setdefault(pid, {"ports": set(), "mode": next(
                (m for m, g in groups.items() if pgid == g), None),
                "cmd": cmd[:160]})
            rec["ports"].update(ports)
        if time.perf_counter() - t0 > 900:
            break
        time.sleep(1.0)
    records = {}
    for m, st in started.items():
        others = {g for k, g in groups.items() if k != m and
                  started[k][0].poll() is None}
        records[m] = finish_mode(st, os.path.join(tmp, f"{m}.json"),
                                 others)
    left = own_children()
    reap(left)
    reap_zombies()
    by_port: Dict[int, Dict[int, str]] = collections.defaultdict(dict)
    for pid, rec in seen.items():
        for port in rec["ports"]:
            by_port[port][pid] = rec["mode"]
    return {
        "wall_s": round(time.perf_counter() - t0, 1),
        "modes": {m: {k: rec[k] for k in (
            "rc", "wall_s", "failures", "left_at_exit",
            "left_after_group_kill", "tail") if k in rec}
            for m, rec in records.items()},
        "readings": {m: side_by_side_readings(records[m]["result"])
                     for m in ("shard_repl", "router_ha")},
        "ports": [{"pid": pid, "mode": rec["mode"], "cmd": rec["cmd"],
                   "ports": sorted(rec["ports"])}
                  for pid, rec in sorted(seen.items())],
        # a port two modes' processes listened on
        "ports_shared": {port: pids for port, pids in by_port.items()
                         if len(set(pids.values())) > 1},
        "left_after_all": left}


def side_by_side_main(args, label: str, tree: str) -> int:
    """--side-by-side: RUNS runs of run_side_by_side, a JSON line each,
    then a ``runs:`` line (runs failed, failures by check, promotion
    seconds and epochs, shared ports, leftover processes)."""
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        lo, hi = (int(x) for x in f.read().split())
    runs = []
    for i in range(RUNS):
        with tempfile.TemporaryDirectory(prefix="ap-side-") as tmp:
            one = run_side_by_side(tree, args.device, tmp)
        failures = [f for m in one["modes"].values()
                    for f in m.get("failures", [])]
        s = {"run": i, "failures": failures, **one}
        with open(os.path.join(args.out_dir, f"side-{i}.json"), "w") as f:
            json.dump(s, f)
        runs.append(s)
        print(json.dumps({k: s[k] for k in (
            "run", "wall_s", "failures", "readings", "ports_shared",
            "left_after_all")}) + f" [{label}]", flush=True)
    totals = {
        "card": label, "device": args.device, "tree": tree,
        "mode": "side-by-side " + ",".join(SIDE_BY_SIDE),
        "runs": len(runs),
        "runs_failed": [s["run"] for s in runs if s["failures"]],
        "failures_by_check": dict(collections.Counter(
            f for s in runs for f in s["failures"])),
        "shard_repl_promote_s": [s["readings"]["shard_repl"]["promote_s"]
                                 for s in runs],
        "shard_repl_s0_epochs": [
            (s["readings"]["shard_repl"].get("shard_epochs") or {}).get("s0")
            for s in runs],
        "router_ha_promote_s": [s["readings"]["router_ha"]["promote_s"]
                                for s in runs],
        "ports_shared": sum(len(s["ports_shared"]) for s in runs),
        # listener ports a connection's source port could have taken
        "ephemeral_range": [lo, hi],
        "listen_ports": sum(len(x["ports"]) for s in runs
                            for x in s["ports"]),
        "listen_ports_in_ephemeral_range": sum(
            lo <= port <= hi for s in runs for x in s["ports"]
            for port in x["ports"]),
        "leftover_processes": sum(
            len(m["left_at_exit"] or []) for s in runs
            for m in s["modes"].values()) + sum(
            len(s["left_after_all"]) for s in runs)}
    with open(os.path.join(args.out_dir, "side-summary.json"), "w") as f:
        json.dump({**totals, "per_run": runs}, f, indent=1)
    print("runs: " + json.dumps(totals), flush=True)
    return 0


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--tree", default=REPO,
                    help="the checkout whose chip_smoke.py order and "
                         "fleet soak tool to run (default this one)")
    ap.add_argument("--side-by-side", action="store_true",
                    help="run the sweep, --shard-repl and --router-ha "
                         "together (queue 3 item 13's repro) instead of "
                         "12b one mode after another")
    args = ap.parse_args(argv)
    from torch_soak_util import device_label

    set_subreaper()
    # the modes' processes share one registry of handed-out listener
    # ports (a tree whose fleet.py has one)
    from go_crdt_playground_tpu_torch.shard.fleet import port_registry
    port_registry()
    label = device_label(args.device)
    tree = os.path.abspath(args.tree)
    os.makedirs(args.out_dir, exist_ok=True)
    if args.side_by_side:
        return side_by_side_main(args, label, tree)
    runs, kept = [], {}
    for i in range(RUNS):
        with tempfile.TemporaryDirectory(prefix="ap-12b-") as tmp:
            one = run_12b(tree, args.device, tmp)
        failures = [f for m in one["modes"].values()
                    for f in m.get("failures", [])]
        s = {"run": i, "wall_s": one["wall_s"], "failures": failures,
             "modes": {m: {k: rec[k] for k in (
                 "rc", "wall_s", "failures", "left_at_exit",
                 "left_after_group_kill", "tail") if k in rec}
                 for m, rec in one["modes"].items()},
             "alive_before_mode": one["alive_before_mode"]}
        ap_res = one["modes"].get("autopilot", {}).get("result")
        if ap_res is not None and ap_res.get("result"):
            s["autopilot"] = summarize_autopilot(ap_res)
            r = ap_res["result"]
            kept[i] = {"summary": s["autopilot"],
                       "failures": ap_res["failures"],
                       "budgets": r["budgets"],
                       "calibration": r["calibration"],
                       "baseline_window_t": r["baseline_window_t"],
                       "decision_log_1": r["decision_log_1"],
                       "timeline": r["timeline"]}
        with open(os.path.join(args.out_dir, f"run-{i}.json"), "w") as f:
            json.dump({**kept.get(i, {}), "run": s,
                       "results": {m: rec["result"] for m, rec
                                   in one["modes"].items()
                                   if m != "autopilot"}}, f)
        runs.append(s)
        print(json.dumps(s) + f" [{label}]", flush=True)
    split_runs = [s["run"] for s in runs if s.get("autopilot", {}).get(
        "after_baseline_generation")]
    if kept:
        # the run to pin: a baseline split, else the nearest miss
        pick = split_runs[0] if split_runs else max(kept, key=lambda i: (
            kept[i]["summary"]["baseline_decisions"]["max_queue_depth"] or 0,
            kept[i]["summary"]["baseline_decisions"]["max_p99_ms"] or 0))
        with open(os.path.join(args.out_dir, "trace.json"), "w") as f:
            json.dump(trace_fixture(kept[pick], (
                f"tools/torch_autopilot_baseline.py --device {args.device}, "
                f"run {pick} of {RUNS} at seed {SEED}, on an {label}")),
                f, indent=0, sort_keys=True)
    caps = [s["autopilot"]["calibration"]["capacity_ops_s"]
            for s in runs if "autopilot" in s]
    caps = [c for c in caps if c is not None]
    totals = {
        "card": label, "device": args.device, "tree": tree, "seed": SEED,
        "runs": len(runs),
        "runs_failed": [s["run"] for s in runs if s["failures"]],
        "failures_by_check": dict(collections.Counter(
            f for s in runs for f in s["failures"])),
        "baseline_splits": split_runs,
        "leftover_processes": sum(
            len(m["left_at_exit"] or []) for s in runs
            for m in s["modes"].values()),
        "capacity_ops_s": caps,
        "capacity_spread": (round((max(caps) - min(caps))
                                  / _median(caps), 4) if caps else None),
        # per autopilot leg: the second reading over the calibration,
        # s1's planned burn over the second reading, and whether s1
        # shed or reached the watermark in the burn
        "second_over_onset": [
            (s["autopilot"]["drift"] or {}).get("second_over_onset")
            for s in runs if "autopilot" in s],
        "planned_burn_of_second": [
            (s["autopilot"]["drift"] or {}).get("planned_burn_of_second")
            for s in runs if "autopilot" in s],
        "burn_s1_heated": [(s["autopilot"]["burn_s1"] or {}).get("heated")
                           for s in runs if "autopilot" in s],
        "wall_s": [s["wall_s"] for s in runs]}
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump({**totals, "per_run": runs}, f, indent=1)
    print("runs: " + json.dumps(totals), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
