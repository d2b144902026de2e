#!/usr/bin/env python3
"""Process-kill crash soak for the port: recovery rounds to convergence
under SIGKILL, tools/crash_soak.py on torch nodes.

A supervisor runs a fleet of real node processes (each the port's
``net.peer.Node`` on ``--device`` plus a ``SyncSupervisor`` with a
``durable_dir``: generational verified checkpoints and the CRC-framed δ
WAL), SIGKILLs them mid-sync at a per-tick kill rate, corrupts their
on-disk state through ``net.faults.StorageFaults`` (torn WAL tails, a
bit-flipped newest checkpoint generation), restarts them from disk, and
asserts that the fleet still converges to the no-fault fixed point over
the CRDT's observable state (membership, tombstones, version vectors;
``CONVERGENT_FIELDS``).

The durability contract, per restarted process (``delta_loss``):

* an acknowledged local add (in ``progress.txt`` only after the add's
  WAL append fsync'd) survives restart, unless that incarnation's
  restore reports a torn WAL tail, a checkpoint-generation fallback, bad
  records or a causally refused replay suffix (``wal.future_records``).
  Loss with no window open is δ loss and fails the run; the violating
  incarnation's status and directory listing land in the artifact
  (``violation_reports``).
* a corrupt newest checkpoint never aborts recovery: restore falls back
  to generation K-1 (``restore.fallbacks``) and the run still converges.

Workers publish an atomically replaced ``status.json`` every round
(members, vv, the convergence digest, restore counters); the parent
adjudicates from those files alone, so a SIGKILL can land at any
instant.  The shapes, ticks, timeouts, seeds and artifact fields are
the reference's; the artifact names the card (``device``) where the
reference writes its platform.  A worker's device path (construction,
a δ exchange both ways) runs once before it serves, so no first launch
lands inside a peer's HELLO deadline.

Usage:
    python tools/torch_crash_soak.py [--quick] [--device cuda|cpu]
        [--detect-races] [--out FILE]   # default CRASH_CURVE_TORCH.json

Exits nonzero unless every run converged with zero δ loss outside the
windows, the faulted runs killed and took the checkpoint fallback, both
WAL record modes were written and replayed, and (with --detect-races)
the lockset detector stayed silent.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import zlib
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from go_crdt_playground_tpu_torch.shard.fleet import (  # noqa: E402
    free_port as _free_port, free_ports)
from torch_soak_util import device_label, warm_delta_path  # noqa: E402

# the observable fixed point: membership, tombstones, version vectors.
# Dot arrays are excluded: a replica that regressed re-issues its lost
# adds under already-seen counters, and per-element dot metadata can
# stay heterogeneous while membership and vv converge
CONVERGENT_FIELDS = ("vv", "present", "deleted")

_COUNTER_PREFIXES = ("wal.", "restore.", "sync.checkpoints")

RECORD_MODE_COUNTERS = ("wal.compact_records", "wal.dense_records",
                        "wal.replayed_compact", "wal.replayed_dense")


# ---------------------------------------------------------------------------
# worker process
# ---------------------------------------------------------------------------


def _read_progress(path: str) -> set:
    try:
        with open(path) as f:
            return {int(line) for line in f if line.strip()}
    except FileNotFoundError:
        return set()


def _append_progress(path: str, element: int) -> None:
    with open(path, "a") as f:
        f.write(f"{element}\n")
        f.flush()
        os.fsync(f.fileno())


def _rewrite_progress(path: str, acked: set) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for e in sorted(acked):
            f.write(f"{e}\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def convergence_digest(state) -> int:
    """CRC32 chain of ``array_digest`` over CONVERGENT_FIELDS (int32
    storage read as its uint32 bits): the JAX package's number for the
    same state."""
    from go_crdt_playground_tpu_torch.models.digest import array_digest

    digest = 0
    for name in CONVERGENT_FIELDS:
        digest = zlib.crc32(
            array_digest(getattr(state, name)).to_bytes(4, "little"), digest)
    return digest


def _write_status(dirpath: str, node, rec, rounds: int,
                  lost_acks: int, detector=None) -> None:
    snap = rec.snapshot()
    status = {
        "actor": node.actor,
        "pid": os.getpid(),
        "rounds": rounds,
        "lost_acks": lost_acks,
        "members": [int(e) for e in node.members()],
        "vv": [int(v) for v in node.vv()],
        "digest": convergence_digest(node.state_slice()),
        "generation": node.generation,
        "counters": {k: v for k, v in snap["counters"].items()
                     if k.startswith(_COUNTER_PREFIXES)},
        "races": ([] if detector is None
                  else [f.render() for f in detector.findings]),
    }
    tmp = os.path.join(dirpath, ".status-tmp")
    with open(tmp, "w") as f:
        json.dump(status, f)
    os.replace(tmp, os.path.join(dirpath, "status.json"))


def worker_main(args: argparse.Namespace, warm: bool = True) -> int:
    """One crash-soak replica: restore from disk, serve, add my element
    slice one per round, sync, checkpoint, until SIGKILLed (the point)
    or SIGTERMed (teardown at the scenario's end).  ``warm=False`` when
    this process warmed its δ path already (a spare)."""
    from go_crdt_playground_tpu_torch.net.antientropy import SyncSupervisor
    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.obs import Recorder
    from go_crdt_playground_tpu_torch.utils.backoff import BackoffPolicy

    d = args.dir
    rec = Recorder()
    node = Node.restore_durable(
        d, recorder=rec, device=args.device,
        fallback_init=lambda: Node(
            args.actor, args.elements, args.nodes, recorder=rec,
            conn_timeout_s=10.0, hello_timeout_s=0.5, device=args.device))
    if warm:
        warm_delta_path(args.elements, args.nodes, args.device)
    detector = None
    if args.detect_races:
        # lockset tracking on this incarnation's Node, instrumented
        # before serve() so the accept loop and handler threads are
        # traced from their first access; the WAL after the supervisor
        # attaches it (fallback_init incarnations have none until then)
        from go_crdt_playground_tpu_torch.analysis.locksets import \
            RaceDetector

        detector = RaceDetector()
        detector.instrument(node, label=f"Node#{args.actor}")
    node.serve("127.0.0.1", args.port)
    peers = [("127.0.0.1", int(p))
             for p in args.peer_ports.split(",") if p]
    sup = SyncSupervisor(
        node, peers,
        policy=BackoffPolicy(base_s=0.005, cap_s=0.05, max_retries=1),
        sync_timeout_s=2.0, hello_timeout_s=0.5,
        breaker_threshold=3, breaker_cooldown_s=0.2,
        fanout=1, interval_s=0.0,
        durable_dir=d, checkpoint_every=args.checkpoint_every,
        recorder=rec, seed=args.seed)
    if detector is not None:
        detector.instrument(sup, label=f"SyncSupervisor#{args.actor}")
        # the WAL exists on every path by now: restore_durable attached
        # one, or SyncSupervisor(durable_dir=...) just did
        if node.wal is not None:
            detector.instrument(node.wal, label=f"DeltaWal#{args.actor}")

    # the zero-δ-loss ledger: an element is recorded here only after
    # node.add returned, i.e. after its δ hit the WAL's fsync
    progress = os.path.join(d, "progress.txt")
    acked = _read_progress(progress)
    present = {int(e) for e in node.members()}
    lost = sorted(acked - present)
    if lost:
        # the documented window (the parent reads the restore counters)
        # or δ loss (the parent fails the run); re-queued either way
        acked -= set(lost)
        _rewrite_progress(progress, acked)

    per = args.elements // args.nodes
    mine = list(range(args.actor * per, (args.actor + 1) * per))
    rounds = 0
    # the first status goes out before any round, so this incarnation's
    # restore counters and lost_acks are published even if it is killed
    # at once
    _write_status(d, node, rec, rounds, len(lost), detector)

    stopping = []
    signal.signal(signal.SIGTERM, lambda *_: stopping.append(True))
    while not stopping:
        members = {int(e) for e in node.members()}
        missing = [e for e in mine if e not in members]
        if missing:
            e = missing[0]
            node.add(e)              # durable (WAL fsync) on return
            acked.add(e)
            _append_progress(progress, e)
        sup.sync_round()
        rounds += 1
        _write_status(d, node, rec, rounds, len(lost), detector)
        time.sleep(args.tick_s)
    node.close()
    return 0


def spare_main(args: argparse.Namespace) -> int:
    """A warm spare worker process: the start-up a worker pays before its
    first exchange (torch, the port's modules, the device's context, the
    δ path warmed) done ahead, a ``spare-<pid>.ready`` file written into
    ``--dir``, then one worker command line (a JSON list) read from stdin
    and run with its output in that node's ``worker.log``.  An empty
    line (teardown) exits.  The node's state comes from its durable dir
    alone, as in a fresh process."""
    import go_crdt_playground_tpu_torch.analysis.locksets  # noqa: F401
    import go_crdt_playground_tpu_torch.net.antientropy  # noqa: F401

    warm_delta_path(args.elements, args.nodes, args.device)
    with open(os.path.join(args.dir, f"spare-{os.getpid()}.ready"), "w"):
        pass
    line = sys.stdin.readline()
    if not line.strip():
        return 0
    wargs = _parser().parse_args(json.loads(line))
    fd = os.open(os.path.join(wargs.dir, "worker.log"),
                 os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    sys.stdout.flush()
    sys.stderr.flush()
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    return worker_main(wargs, warm=False)


# ---------------------------------------------------------------------------
# parent supervisor
# ---------------------------------------------------------------------------

# warm spares kept beside the live workers: a worker process takes
# seconds to start on a card (torch, the context), longer than the kill
# window's ticks, so a restart is handed to a spare that started earlier
SPARES = 2
SPARE_READY_TIMEOUT_S = 300.0


def worker_argv(dirpath: str, actor: int, n_nodes: int, n_elements: int,
                port: int, peer_ports: str, device: str, *,
                checkpoint_every: int = 3, seed: int = 0,
                tick_s: float = 0.05, detect_races: bool = False) -> list:
    """The command line of one worker process."""
    cmd = [sys.executable, os.path.abspath(__file__), "--worker",
           "--dir", dirpath, "--actor", str(actor),
           "--nodes", str(n_nodes), "--elements", str(n_elements),
           "--port", str(port), "--peer-ports", peer_ports,
           "--checkpoint-every", str(checkpoint_every),
           "--seed", str(seed), "--tick-s", str(tick_s),
           "--device", device]
    if detect_races:
        cmd.append("--detect-races")
    return cmd


def spare_argv(root: str, n_nodes: int, n_elements: int,
               device: str) -> list:
    """The command line of one warm spare (``spare_main``)."""
    return [sys.executable, os.path.abspath(__file__), "--spare",
            "--dir", root, "--nodes", str(n_nodes),
            "--elements", str(n_elements), "--device", device]


def spare_ready(root: str, pid: int) -> bool:
    return os.path.exists(os.path.join(root, f"spare-{pid}.ready"))


class _Fleet:
    """Spawns, kills, corrupts, restarts, and reads the worker fleet."""

    def __init__(self, n_nodes: int, n_elements: int, root: str,
                 seed: int, checkpoint_every: int, worker_tick_s: float,
                 detect_races: bool = False, device: str = "cuda"):
        self.n = n_nodes
        self.elements = n_elements
        self.root = root
        self.seed = seed
        self.checkpoint_every = checkpoint_every
        self.worker_tick_s = worker_tick_s
        self.detect_races = detect_races
        self.device = device
        self.dirs = [os.path.join(root, f"node-{i}") for i in range(n_nodes)]
        self.ports = free_ports(n_nodes)
        self.procs: List[Optional[subprocess.Popen]] = [None] * n_nodes
        self.spares: List[subprocess.Popen] = []
        self.logs = []
        self.restarted: set = set()
        self.killed_pids: set = set()
        self.unexpected_exits = 0
        for d in self.dirs:
            os.makedirs(d, exist_ok=True)

    def _start_spare(self) -> None:
        log = open(os.path.join(self.root, "spares.log"), "ab")
        self.logs.append(log)
        # the parent's environment as it is: nothing hides the card
        self.spares.append(subprocess.Popen(
            spare_argv(self.root, self.n, self.elements, self.device),
            stdin=subprocess.PIPE, stdout=log, stderr=log, cwd=REPO))

    def start(self) -> None:
        """Start the spares, wait (bounded) until one is warm for each
        node, and hand each node to one."""
        for _ in range(self.n + SPARES):
            self._start_spare()
        deadline = time.time() + SPARE_READY_TIMEOUT_S
        while time.time() < deadline and sum(
                spare_ready(self.root, p.pid) for p in self.spares) < self.n:
            time.sleep(0.05)
        for i in range(self.n):
            self.spawn(i)

    def _take_spare(self) -> subprocess.Popen:
        """A live spare, warm ones first; a spare that died before its
        turn counts as an unexpected exit."""
        while True:
            if not self.spares:
                self._start_spare()
            ready = [p for p in self.spares
                     if spare_ready(self.root, p.pid)]
            p = (ready or self.spares)[0]
            self.spares.remove(p)
            if p.poll() is None:
                return p
            self.unexpected_exits += 1

    def spawn(self, i: int) -> None:
        peer_ports = ",".join(str(self.ports[j]) for j in range(self.n)
                              if j != i)
        cmd = worker_argv(self.dirs[i], i, self.n, self.elements,
                          self.ports[i], peer_ports, self.device,
                          checkpoint_every=self.checkpoint_every,
                          seed=self.seed * 100 + i,
                          tick_s=self.worker_tick_s,
                          detect_races=self.detect_races)
        p = self._take_spare()
        p.stdin.write((json.dumps(cmd[2:]) + "\n").encode())
        p.stdin.close()
        self.procs[i] = p
        self._start_spare()

    def kill(self, i: int) -> None:
        p = self.procs[i]
        if p is None or p.poll() is not None:
            return
        self.killed_pids.add(p.pid)
        os.kill(p.pid, signal.SIGKILL)
        p.wait()
        self.restarted.add(i)

    def reap_unexpected(self) -> None:
        """A worker that died without us killing it is a bug signal:
        count it, keep its log, restart it so the run can still
        finish."""
        for i, p in enumerate(self.procs):
            if p is not None and p.poll() is not None \
                    and p.pid not in self.killed_pids:
                self.unexpected_exits += 1
                self.restarted.add(i)
                self.spawn(i)

    def status(self, i: int) -> Optional[Dict]:
        try:
            with open(os.path.join(self.dirs[i], "status.json")) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def generation_files(self, i: int) -> List[str]:
        try:
            names = sorted(n for n in os.listdir(self.dirs[i])
                           if n.startswith("gen-") and n.endswith(".ckpt"))
        except OSError:
            return []
        return [os.path.join(self.dirs[i], n) for n in names]

    def newest_wal_segment(self, i: int) -> Optional[str]:
        wal_dir = os.path.join(self.dirs[i], "wal")
        try:
            names = sorted(n for n in os.listdir(wal_dir)
                           if n.startswith("wal-") and n.endswith(".log"))
        except OSError:
            return None
        return os.path.join(wal_dir, names[-1]) if names else None

    def teardown(self) -> None:
        for p in self.spares:
            try:
                p.stdin.close()
            except OSError:
                pass
        live = [p for p in self.procs + self.spares if p is not None]
        for p in live:
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + 10.0
        for p in live:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()


def delta_loss(status: Dict) -> bool:
    """The per-incarnation verdict of the zero-δ-loss contract on one
    ``status.json``: acknowledged adds survive restart except inside the
    documented windows (the discarded suffix after a WAL tear, a
    checkpoint-generation fallback, bad records, or a causally refused
    replay suffix).  True when acked adds were lost with no window
    open."""
    c = status["counters"]
    windows = ("restore.fallbacks", "wal.torn_tail", "wal.bad_records",
               "wal.future_records")
    return status["lost_acks"] > 0 and all(c.get(k, 0) == 0
                                           for k in windows)


def run_scenario(n_nodes: int, n_elements: int, kill_rate: float,
                 seed: int, *, kill_ticks: int, max_ticks: int,
                 tick_s: float = 0.5, checkpoint_every: int = 3,
                 worker_tick_s: float = 0.05,
                 torn_writes: bool = True,
                 corrupt_checkpoint: bool = True,
                 detect_races: bool = False,
                 root_dir: Optional[str] = None,
                 device: str = "cuda") -> Dict[str, object]:
    """One seeded crash-soak run; returns convergence and the census.

    Ticks 0..kill_ticks are the kill window (per-tick SIGKILL probability
    ``kill_rate``, at least one kill forced for any faulted run); after
    it the fleet has until ``max_ticks`` to converge to the no-fault
    fixed point (every replica holds every element, identical vv,
    identical convergence digest).  ``root_dir`` keeps the durable dirs
    for the caller."""
    from go_crdt_playground_tpu_torch.net.faults import (StorageFaults,
                                                         StorageScenario)

    rng = random.Random(seed)
    owns_root = root_dir is None
    root = root_dir or tempfile.mkdtemp(prefix="crash-soak-")
    faults = StorageFaults(
        StorageScenario(bit_flip_rate=0.25 if kill_rate > 0 else 0.0,
                        zero_fill_rate=0.15 if kill_rate > 0 else 0.0),
        seed=seed)
    fleet = _Fleet(n_nodes, n_elements, root, seed, checkpoint_every,
                   worker_tick_s, detect_races=detect_races, device=device)
    per = n_elements // n_nodes
    expected = list(range(per * n_nodes))
    kills = 0
    corruption_injected = False
    delta_loss_violations = 0
    violation_reports: List[Dict] = []   # full status of each violator
    races: set = set()   # lockset findings across incarnations
    adjudicated: set = set()   # (actor, pid) incarnations already judged
    counters_by_inc: Dict = {}  # (actor, pid) -> latest counters
    converged_tick = None
    recovery_rounds = None

    def poll_statuses() -> List[Optional[Dict]]:
        nonlocal delta_loss_violations
        out = []
        for i in range(n_nodes):
            st = fleet.status(i)
            out.append(st)
            if st is None:
                continue
            inc = (st["actor"], st["pid"])
            counters_by_inc[inc] = st["counters"]
            races.update(st.get("races") or [])
            if inc not in adjudicated:
                adjudicated.add(inc)
                if delta_loss(st):
                    delta_loss_violations += 1
                    try:
                        listing = sorted(os.listdir(fleet.dirs[i]))
                    except OSError:
                        listing = []
                    violation_reports.append(
                        {"status": st, "dir": listing})
        return out

    def corrupt_victim(i: int) -> None:
        nonlocal corruption_injected
        seg = fleet.newest_wal_segment(i)
        if torn_writes and seg:
            # a cut of 1..8 bytes is shorter than one framed record, so
            # it tears the final record rather than landing on a
            # boundary
            faults.torn_write(seg, cut_bytes=rng.randint(1, 8))
        gens = fleet.generation_files(i)
        if corrupt_checkpoint and not corruption_injected and len(gens) >= 2:
            # a bit inside the newest generation's array data: restore
            # must fall back to K-1 (restore.fallbacks), never abort
            faults.bit_flip_array(gens[-1])
            corruption_injected = True
        elif gens:
            faults.inject(gens[-1])
        if seg:
            faults.inject(seg)

    t0 = t_started = time.time()
    try:
        fleet.start()
        t_started = time.time()
        for tick in range(max_ticks):
            time.sleep(tick_s)
            fleet.reap_unexpected()
            statuses = poll_statuses()
            in_kill_window = tick < kill_ticks
            if in_kill_window and kill_rate > 0:
                force = (tick == kill_ticks - 1 and kills == 0)
                if force or rng.random() < kill_rate:
                    victim = rng.randrange(n_nodes)
                    fleet.kill(victim)
                    kills += 1
                    corrupt_victim(victim)
                    fleet.spawn(victim)
            elif not in_kill_window:
                # a status counts only if the current incarnation wrote
                # it: a killed process's last file must not stand for
                # fleet state while its successor is still restoring
                live = [st for i, st in enumerate(statuses)
                        if st is not None and fleet.procs[i] is not None
                        and fleet.procs[i].poll() is None
                        and st["pid"] == fleet.procs[i].pid]
                if len(live) == n_nodes and all(
                        st["members"] == expected for st in live):
                    vvs = {tuple(st["vv"]) for st in live}
                    digests = {st["digest"] for st in live}
                    if len(vvs) == 1 and len(digests) == 1:
                        converged_tick = tick
                        rounds_pool = [st["rounds"] for st in live
                                       if st["actor"] in fleet.restarted] \
                            or [st["rounds"] for st in live]
                        recovery_rounds = max(rounds_pool)
                        break
            if fleet.unexpected_exits > 3 * n_nodes:
                break  # a restart loop: abort instead of spinning
    finally:
        fleet.teardown()

    final_statuses = None
    if converged_tick is None:
        # the non-convergence post-mortem: each replica's last word
        final_statuses = []
        for i in range(n_nodes):
            st = fleet.status(i)
            p = fleet.procs[i]
            final_statuses.append(None if st is None else {
                "actor": i, "rounds": st["rounds"],
                "n_members": len(st["members"]),
                "missing": sorted(set(expected) - set(st["members"]))[:16],
                "vv": st["vv"], "digest": st["digest"],
                "generation": st["generation"],
                "pid_current": bool(p is not None and p.poll() is None
                                    and st["pid"] == p.pid),
            })
    totals: Dict[str, int] = {}
    for c in counters_by_inc.values():
        for k, v in c.items():
            totals[k] = totals.get(k, 0) + v
    result = {
        "kill_rate": kill_rate,
        "converged": converged_tick is not None,
        "ticks_to_converge": converged_tick,
        "recovery_rounds": recovery_rounds,
        "kills": kills,
        "corruption_injected": corruption_injected,
        "delta_loss_violations": delta_loss_violations,
        "unexpected_exits": fleet.unexpected_exits,
        "storage_faults": faults.counters(),
        "counters": totals,
        "races": sorted(races),
        "elapsed_s": round(time.time() - t0, 1),
        "start_s": round(t_started - t0, 1),
    }
    if violation_reports:
        result["violation_reports"] = violation_reports
    if final_statuses is not None:
        result["final_statuses"] = final_statuses
    if owns_root:
        shutil.rmtree(root, ignore_errors=True)
    return result


# ---------------------------------------------------------------------------
# sweep
# ---------------------------------------------------------------------------


def sweep_ok(artifact: Dict, detect_races: bool) -> bool:
    """The reference's exit rule: every run converged, zero δ loss
    beyond the windows, the faulted runs killed and took the corrupt-
    newest-checkpoint fallback, both WAL record modes were written and
    records replayed, and with detection on no lockset race."""
    curve = artifact["curve"]
    record_modes = artifact["wal_record_modes"]
    ok = all(e["converged_runs"] == e["seeds"] for e in curve)
    ok = ok and all(e["delta_loss_violations"] == 0 for e in curve)
    if detect_races:
        ok = ok and not artifact["race_detection"]["races"]
    faulted = [e for e in curve if e["kill_rate"] > 0]
    ok = ok and all(e["kills"] > 0 for e in faulted)
    ok = ok and any(
        e["corruption_injected"]
        and e["restore_counters"].get("restore.fallbacks", 0) > 0
        for e in faulted)
    ok = ok and record_modes.get("wal.compact_records", 0) > 0
    ok = ok and record_modes.get("wal.dense_records", 0) > 0
    ok = ok and (record_modes.get("wal.replayed_compact", 0)
                 + record_modes.get("wal.replayed_dense", 0)) > 0
    return ok


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true",
                    help="the CI-sized sweep (3 nodes x 24 elements, kill "
                         "rates 0 and 0.25, one seed)")
    ap.add_argument("--nodes", type=int, default=None)
    ap.add_argument("--elements", type=int, default=None)
    ap.add_argument("--seeds", type=int, default=None)
    ap.add_argument("--max-ticks", type=int, default=None)
    ap.add_argument("--detect-races", dest="detect_races",
                    action="store_true",
                    help="run every worker under the lockset race "
                         "detector (analysis/locksets.py); findings land "
                         "in the artifact and fail the sweep")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the worker nodes (default cuda, "
                         "which raises without a GPU)")
    ap.add_argument("--out",
                    default=os.path.join(REPO, "CRASH_CURVE_TORCH.json"))
    # worker-mode flags (the parent spawns `torch_crash_soak.py --worker`)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--dir", help=argparse.SUPPRESS)
    ap.add_argument("--actor", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--peer-ports", dest="peer_ports",
                    help=argparse.SUPPRESS)
    ap.add_argument("--checkpoint-every", dest="checkpoint_every", type=int,
                    default=3, help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--tick-s", dest="tick_s", type=float, default=0.05,
                    help=argparse.SUPPRESS)
    ap.add_argument("--spare", action="store_true", help=argparse.SUPPRESS)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if args.worker:
        return worker_main(args)
    if args.spare:
        return spare_main(args)

    device = device_label(args.device)
    if args.quick:
        n_nodes = args.nodes or 3
        n_elements = args.elements or 24
        n_seeds = args.seeds or 1
        kill_rates = [0.0, 0.25]
        kill_ticks, max_ticks = 20, args.max_ticks or 180
    else:
        n_nodes = args.nodes or 4
        n_elements = args.elements or 48
        n_seeds = args.seeds or 2
        kill_rates = [0.0, 0.2, 0.4]
        kill_ticks, max_ticks = 30, args.max_ticks or 300

    t0 = time.time()
    curve = []
    for rate in kill_rates:
        runs = []
        for s in range(n_seeds):
            r = run_scenario(
                n_nodes, n_elements, rate, seed=23 + s,
                kill_ticks=kill_ticks if rate > 0 else 0,
                max_ticks=max_ticks, detect_races=args.detect_races,
                device=args.device)
            runs.append(r)
            print(json.dumps({"kill_rate": rate, "seed": 23 + s, **{
                k: r[k] for k in ("converged", "recovery_rounds", "kills",
                                  "delta_loss_violations",
                                  "unexpected_exits", "elapsed_s",
                                  "start_s")}}),
                  flush=True)
        rec_rounds = [r["recovery_rounds"] for r in runs if r["converged"]]
        storage: Dict[str, int] = {}
        counters: Dict[str, int] = {}
        for r in runs:
            for k, v in r["storage_faults"].items():
                storage[k] = storage.get(k, 0) + v
            for k, v in r["counters"].items():
                counters[k] = counters.get(k, 0) + v
        curve.append({
            "kill_rate": rate,
            "seeds": n_seeds,
            "converged_runs": sum(1 for r in runs if r["converged"]),
            "kills": sum(r["kills"] for r in runs),
            "recovery_rounds_min": min(rec_rounds) if rec_rounds else None,
            "recovery_rounds_median": (int(statistics.median(rec_rounds))
                                       if rec_rounds else None),
            "recovery_rounds_max": max(rec_rounds) if rec_rounds else None,
            "corruption_injected": any(r["corruption_injected"]
                                       for r in runs),
            "delta_loss_violations": sum(r["delta_loss_violations"]
                                         for r in runs),
            "unexpected_exits": sum(r["unexpected_exits"] for r in runs),
            "storage_faults": storage,
            "restore_counters": {k: v for k, v in counters.items()
                                 if k.startswith(("restore.", "wal."))},
            **({"races": sorted({x for r in runs for x in r["races"]})}
               if args.detect_races else {}),
            **({"violation_reports": [v for r in runs for v in
                                      r.get("violation_reports", [])]}
               if any(r.get("violation_reports") for r in runs) else {}),
        })

    # the WAL record-mode census: local δs are compact index-lane
    # records, applied peer payloads dense ones; a healthy sweep writes
    # and replays both
    record_modes: Dict[str, int] = {}
    for e in curve:
        for k, v in e["restore_counters"].items():
            if k in RECORD_MODE_COUNTERS:
                record_modes[k] = record_modes.get(k, 0) + v

    artifact = {
        "metric": ("recovery rounds to the no-fault fixed point vs per-tick "
                   f"SIGKILL rate ({n_nodes}-process durable Node fleet: "
                   "CRC-framed delta WAL + verified checkpoint generations, "
                   "torn-write/bit-flip storage faults on kill)"),
        "value": next((e["recovery_rounds_median"] for e in curve
                       if e["kill_rate"] > 0), None),
        "unit": "worker rounds (at the lowest faulted kill rate)",
        "fleet": {"nodes": n_nodes, "elements": n_elements,
                  "quick": bool(args.quick)},
        "wal_record_modes": record_modes,
        "curve": curve,
        "elapsed_s": round(time.time() - t0, 1),
        "device": device,
    }
    if args.detect_races:
        artifact["race_detection"] = {
            "enabled": True,
            "races": sorted({x for e in curve
                             for x in e.get("races", [])}),
        }
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
        f.write("\n")
    print(f"wrote {args.out}")
    return 0 if sweep_ok(artifact, args.detect_races) else 1


if __name__ == "__main__":
    sys.exit(main())
