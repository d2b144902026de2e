#!/usr/bin/env python3
"""Serve-frontend load soak for the port: the quick legs of
tools/serve_soak.py against ``python -m go_crdt_playground_tpu_torch
serve --ingest --device D`` workers (real subprocesses, not imports).

* **open loop** — a paced generator offers ops (every 10th a delete,
  keys cycling through the universe) at fixed rates; goodput scales
  with the offered load, every submitted op is accounted for (acked, or
  shed typed), and past capacity the excess is shed with typed
  ``Overloaded`` replies while the server-side ingest p99 stays under
  2 s.  Where the offered ops stand when the offering stops (admitted,
  shed, acked by the server) is read off the worker's counters.
* **closed loop** — synchronous submitters at increasing concurrency.
* **ingest compare** — the same add-only offered load against a seed
  worker (``--no-fused-ingest``: two steps a batch, dense WAL records)
  and a fused one (one step, compact records), read off the workers'
  own counters.
* **compaction** — ``--compact-interval``: light add+delete traffic
  during which deletion-record GC must run, then saturating traffic
  during which it must back off.
* **crash** — an add-only ledgered workload across two SIGKILLs (the
  ``CRDT_SERVE_CRASH_AFTER_BATCHES`` hook between a batch's WAL fsync
  and its acks, then a parent-timed kill mid-stream) and restarts.
* **chaos** — the same ledger under wire faults: a seeded
  ``net/faults.ChaosProxy`` on the ingest port tears frames, delays
  acks, drops dials and holds a partition; ambiguous outcomes resubmit.

The adjudication is tools/serve_soak.py's, check for check (``failures``),
and every leg is also held to the ledger of what was submitted and acked
against the worker's final ``members()``: zero acked-op loss (an acked
add no later op could have undone is a member) and zero phantom members
(every member was submitted as an add).  Each failure line starts
with its check's name (``check_name``).

Usage:
    python tools/torch_serve_soak.py --quick [--device cuda|cpu]
        [--out FILE]

Exits nonzero when any check fails.  Prints one JSON line per leg and,
with ``--out``, writes them all to FILE with the failed checks
(``failures``) and, among them, those of the guarantees
(``guarantee_failures``).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from go_crdt_playground_tpu_torch.serve import protocol  # noqa: E402
from go_crdt_playground_tpu_torch.serve.client import \
    ServeClient  # noqa: E402

Addr = Tuple[str, int]
_ADDR_RE = re.compile(rb"listening on (\S+):(\d+)")
DEL_EVERY = 10


from go_crdt_playground_tpu_torch.shard.fleet import \
    free_port  # noqa: E402,F401  (a listener port no connection is given)


def worker_argv(device: str, port: int, elements: int, state_dir: str, *,
                queue_depth: int, max_batch: int, flush_ms: float,
                extra_args: Tuple[str, ...] = ()) -> List[str]:
    """The worker's command line: the port's ``serve --ingest`` verb."""
    return [sys.executable, "-m", "go_crdt_playground_tpu_torch", "serve",
            "--ingest", "--device", device, "--port", str(port),
            "--elements", str(elements), "--actors", "4", "--actor", "0",
            "--durable-dir", state_dir, "--queue-depth", str(queue_depth),
            "--max-batch", str(max_batch), "--flush-ms", str(flush_ms),
            "--checkpoint-every", "0", *extra_args]


class Worker:
    """One ``serve --ingest`` subprocess, ready (its banner read) once
    constructed; stderr goes to ``dirpath/worker.log``."""

    def __init__(self, dirpath: str, port: int, elements: int, device: str,
                 *, queue_depth: int, max_batch: int, flush_ms: float,
                 crash_after_batches: Optional[int] = None,
                 extra_args: Tuple[str, ...] = (),
                 start_timeout_s: float = 180.0):
        os.makedirs(dirpath, exist_ok=True)
        env = dict(os.environ)
        env.pop("CRDT_SERVE_CRASH_AFTER_BATCHES", None)
        if crash_after_batches is not None:
            env["CRDT_SERVE_CRASH_AFTER_BATCHES"] = str(crash_after_batches)
        self.log = open(os.path.join(dirpath, "worker.log"), "ab")
        self.proc = subprocess.Popen(
            worker_argv(device, port, elements,
                        os.path.join(dirpath, "state"),
                        queue_depth=queue_depth, max_batch=max_batch,
                        flush_ms=flush_ms, extra_args=extra_args),
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=self.log)
        self.addr: Optional[Addr] = None
        self._banner = threading.Event()
        self._out: List[bytes] = []
        threading.Thread(target=self._pump, daemon=True).start()
        if not self._banner.wait(start_timeout_s) or self.addr is None:
            self.kill()
            self.log.close()
            with open(self.log.name, "rb") as f:
                tail = f.read()[-2000:].decode(errors="replace")
            raise RuntimeError(f"worker gave no banner within "
                               f"{start_timeout_s} s (rc "
                               f"{self.proc.returncode}): {tail}")

    def _pump(self) -> None:
        for line in iter(self.proc.stdout.readline, b""):
            self._out.append(line)
            m = _ADDR_RE.search(line)
            if m and self.addr is None:
                self.addr = (m.group(1).decode(), int(m.group(2)))
                self._banner.set()
        self._banner.set()  # exited: wake the constructor

    def output(self) -> str:
        return b"".join(self._out).decode(errors="replace")

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGKILL)
        self.proc.wait()

    def terminate(self) -> int:
        """SIGTERM: the worker drains and prints its ``drained:`` line."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                return self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.kill()
        return self.proc.returncode

    def close(self) -> None:
        self.terminate()
        self.log.close()


def _pctl(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    xs = sorted(values)
    return round(xs[min(len(xs) - 1, int(q * (len(xs) - 1) + 0.5))] * 1e3,
                 3)


class Ledger:
    """What one worker was sent and what it acked: adds and deletes by
    key.  ``adjudicate`` reads the final members against it."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.added: Set[int] = set()      # guarded-by: lock
        self.deleted: Set[int] = set()    # guarded-by: lock
        self.acked_adds: Set[int] = set()  # guarded-by: lock

    def submit(self, kind: int, key: int) -> None:
        with self.lock:
            (self.deleted if kind == protocol.OP_DEL else self.added).add(key)

    def ack(self, kind: int, key: int) -> None:
        if kind == protocol.OP_ADD:
            with self.lock:
                self.acked_adds.add(key)

    def adjudicate(self, members) -> Dict[str, List[int]]:
        """Lost: an acked add of a key no delete was ever submitted for,
        missing from the members.  Phantom: a member never submitted as
        an add."""
        members = set(int(m) for m in members)
        with self.lock:
            lost = sorted((self.acked_adds - self.deleted) - members)
            phantom = sorted(members - self.added)
        return {"lost_acked_ops": lost, "phantom_members": phantom}


def open_loop_leg(addr: Addr, rate: float, duration_s: float, elements: int,
                  ledger: Ledger, n_conns: int = 4, deadline_s: float = 1.0,
                  del_every: int = DEL_EVERY) -> Dict[str, object]:
    """Offer ops at ``rate`` for ``duration_s`` (pipelined, paced), keys
    ``i % E``, every ``del_every``-th op a delete (0: add-only); goodput,
    typed sheds and client-side latency, every op accounted for."""
    tally = {"acked": 0, "overloaded": 0, "expired": 0, "other": 0}
    latencies: List[float] = []
    clients = [ServeClient(addr, timeout=30.0) for _ in range(n_conns)]
    submitted = send_errors = 0
    ops = []
    before = server_counts(addr)
    t0 = time.monotonic()
    try:
        i = 0
        while time.monotonic() - t0 < duration_s:
            target = t0 + i / rate
            now = time.monotonic()
            if target > now:
                time.sleep(target - now)
            kind = (protocol.OP_DEL
                    if del_every and i % del_every == del_every - 1
                    else protocol.OP_ADD)
            key = i % elements
            ledger.submit(kind, key)
            try:
                ops.append((kind, key, clients[i % n_conns].submit_async(
                    kind, [key], deadline_s=deadline_s)))
                submitted += 1
            except (OSError, ConnectionError):
                send_errors += 1
            i += 1
        elapsed = time.monotonic() - t0
        # where this leg's ops stand when the offering stops: admitted
        # (or shed) by the server, or still in front of its admission
        window_end = {k: v - before[k]
                      for k, v in server_counts(addr).items()}
        grace = time.monotonic() + 120.0
        for kind, key, op in ops:
            try:
                op.wait(max(0.0, grace - time.monotonic()))
            except (protocol.ServeError, OSError, ConnectionError,
                    socket.timeout):
                pass
    finally:
        for c in clients:
            c.close()
    unresolved = 0
    for kind, key, op in ops:
        if op.acked:
            tally["acked"] += 1
            latencies.append(op.latency_s)
            ledger.ack(kind, key)
        elif not op.done:
            unresolved += 1
        elif isinstance(op.error, protocol.Overloaded):
            tally["overloaded"] += 1
        elif isinstance(op.error, protocol.DeadlineExceeded):
            tally["expired"] += 1
        else:
            tally["other"] += 1
    return {"offered_rate": rate, "submitted": submitted,
            "achieved_offer_rate": round(submitted / elapsed, 1),
            "goodput": round(tally["acked"] / elapsed, 1), **tally,
            "send_errors": send_errors, "unresolved": unresolved,
            "p50_ms": _pctl(latencies, 0.50),
            "p99_ms": _pctl(latencies, 0.99), "window_end": window_end}


def closed_loop_leg(addr: Addr, concurrency: int, duration_s: float,
                    elements: int, ledger: Ledger) -> Dict[str, object]:
    """``concurrency`` synchronous submitters, one add in flight each."""
    stop = threading.Event()
    lock = threading.Lock()
    latencies: List[float] = []
    failures = [0]

    def run(worker_id: int) -> None:
        try:
            with ServeClient(addr, timeout=30.0) as c:
                i = worker_id
                while not stop.is_set():
                    key = i % elements
                    ledger.submit(protocol.OP_ADD, key)
                    try:
                        lat = c.add(key)
                    except protocol.ServeError:
                        with lock:
                            failures[0] += 1
                        continue
                    ledger.ack(protocol.OP_ADD, key)
                    with lock:
                        latencies.append(lat)
                    i += concurrency
        except (OSError, ConnectionError):
            with lock:
                failures[0] += 1

    threads = [threading.Thread(target=run, args=(w,), daemon=True)
               for w in range(concurrency)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    time.sleep(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=30.0)
    elapsed = time.monotonic() - t0
    with lock:
        return {"concurrency": concurrency,
                "goodput": round(len(latencies) / elapsed, 1),
                "acked": len(latencies), "failures": failures[0],
                "p50_ms": _pctl(latencies, 0.50),
                "p99_ms": _pctl(latencies, 0.99)}


def server_counts(addr: Addr) -> Dict[str, int]:
    """The worker's cumulative admitted, shed and acked op counts."""
    with ServeClient(addr, timeout=30.0) as c:
        cnt = c.stats()["counters"]
    return {"admitted": cnt.get("serve.ops.admitted", 0),
            "shed_overload": cnt.get("serve.shed.overload", 0),
            "acked": cnt.get("serve.ops.acked", 0)}


def server_stats(addr: Addr) -> Dict[str, object]:
    """The worker's own counters over the wire."""
    with ServeClient(addr, timeout=30.0) as c:
        snap = c.stats()
    cnt = snap["counters"]
    batches = max(1, cnt.get("serve.batches", 0))
    records = max(1, cnt.get("wal.compact_records", 0)
                  + cnt.get("wal.dense_records", 0))
    lat = snap["observations"].get("serve.ingest_latency_s", {})
    apply_s = snap["observations"].get("serve.batch.apply_s", {})
    return {"acked": cnt.get("serve.ops.acked", 0),
            "batches": cnt.get("serve.batches", 0),
            "ops_per_batch": round(
                cnt.get("serve.ops.acked", 0) / batches, 2),
            "apply_ms_mean": (round(apply_s["mean"] * 1e3, 3)
                              if apply_s else None),
            "dispatches_per_batch": round(
                cnt.get("ingest.dispatches", 0) / batches, 2),
            "wal_bytes_per_acked_op": round(
                cnt.get("wal.appended_bytes", 0)
                / max(1, cnt.get("serve.ops.acked", 0)), 1),
            "wal_bytes_per_record": round(
                cnt.get("wal.appended_bytes", 0) / records, 1),
            "wal_compact_records": cnt.get("wal.compact_records", 0),
            "wal_dense_records": cnt.get("wal.dense_records", 0),
            "ingest_p99_ms": _pctl([lat["p99"]], 0.5) if lat else None,
            "compact": {k: v for k, v in cnt.items()
                        if k.startswith("compact.")},
            "deleted_lanes": snap["gauges"].get("compact.deleted_lanes")}


def finish(worker: Worker, ledger: Ledger) -> Dict[str, object]:
    """Read the worker's members, drain it (SIGTERM), adjudicate."""
    with ServeClient(worker.addr, timeout=60.0) as c:
        members, _vv = c.members()
    rc = worker.terminate()
    worker.log.close()
    out = ledger.adjudicate(members)
    out["members"] = len(members)
    out["drained"] = rc == 0 and "drained:" in worker.output()
    return out


def load_legs(root: str, cfg: dict) -> Dict[str, object]:
    ledger = Ledger()
    w = Worker(os.path.join(root, "load"), free_port(), cfg["elements"],
               cfg["device"], **cfg["serve"])
    try:
        open_curve = []
        for rate in cfg["rates"]:
            leg = open_loop_leg(w.addr, rate, cfg["duration_s"],
                                cfg["elements"], ledger)
            # cumulative since the worker started, as tools/serve_soak.py
            # reads it
            leg["server_ingest_p99_ms"] = server_stats(w.addr)[
                "ingest_p99_ms"]
            open_curve.append(leg)
        closed_curve = [closed_loop_leg(w.addr, conc, cfg["closed_s"],
                                        cfg["elements"], ledger)
                        for conc in cfg["concurrencies"]]
    except BaseException:
        w.kill()
        raise
    return {"open_loop": open_curve, "closed_loop": closed_curve,
            **finish(w, ledger)}


def ingest_compare_leg(root: str, cfg: dict) -> Dict[str, object]:
    out = {}
    for mode, extra in (("seed", ("--no-fused-ingest",)), ("fused", ())):
        ledger = Ledger()
        w = Worker(os.path.join(root, f"ingest-{mode}"), free_port(),
                   cfg["elements"], cfg["device"], extra_args=extra,
                   **cfg["serve"])
        try:
            leg = open_loop_leg(w.addr, 400.0, cfg["compare_s"],
                                cfg["elements"], ledger, del_every=0)
            stats = server_stats(w.addr)
        except BaseException:
            w.kill()
            raise
        out[mode] = {"goodput": leg["goodput"], "p99_ms": leg["p99_ms"],
                     "unresolved": leg["unresolved"], **stats,
                     **finish(w, ledger)}
    return out


def compaction_leg(root: str, cfg: dict) -> Dict[str, object]:
    ledger = Ledger()
    w = Worker(os.path.join(root, "compaction"), free_port(),
               cfg["elements"], cfg["device"],
               extra_args=("--compact-interval", "0.05",
                           "--compact-p99-budget-ms", "50"),
               **cfg["serve"])
    try:
        light = light_stats = None
        for _ in range(3):
            light = open_loop_leg(w.addr, 200.0, cfg["compare_s"],
                                  cfg["elements"], ledger, del_every=5)
            light_stats = server_stats(w.addr)
            if light_stats["compact"].get("compact.gc_dropped_lanes", 0):
                break
        heavy = open_loop_leg(w.addr, 6000.0, cfg["compare_s"],
                              cfg["elements"], ledger, del_every=5)
        heavy_stats = server_stats(w.addr)
    except BaseException:
        w.kill()
        raise
    lc, hc = light_stats["compact"], heavy_stats["compact"]
    return {"light_goodput": light["goodput"],
            "light_server_p99_ms": light_stats["ingest_p99_ms"],
            "light_unresolved": light["unresolved"],
            "heavy_unresolved": heavy["unresolved"],
            "gc_runs_under_traffic": lc.get("compact.gc_runs", 0),
            "gc_dropped_lanes_under_traffic": lc.get(
                "compact.gc_dropped_lanes", 0),
            "deleted_lanes_after_gc": light_stats["deleted_lanes"],
            "heavy_goodput": heavy["goodput"],
            "heavy_shed_overloaded": heavy["overloaded"],
            "backoffs_during_heavy": (hc.get("compact.backoffs", 0)
                                      - lc.get("compact.backoffs", 0)),
            **finish(w, ledger)}


def crash_leg(root: str, cfg: dict, seed: int) -> Dict[str, object]:
    """Add-only ledgered workload across the two SIGKILL flavours."""
    rng = random.Random(seed)
    port = free_port()
    dirpath = os.path.join(root, "crash")
    elements = cfg["elements"]
    acked: Set[int] = set()
    submitted: Set[int] = set()
    kills = {"window_hook": 0, "parent_sigkill": 0}

    def submit_all(worker: Worker, todo: List[int],
                   kill_at: Optional[int] = None) -> bool:
        try:
            client = ServeClient(worker.addr, timeout=30.0)
        except (OSError, ConnectionError):
            return False
        try:
            for n, e in enumerate(todo):
                if kill_at is not None and n == kill_at:
                    kills["parent_sigkill"] += 1
                    worker.kill()
                submitted.add(e)
                try:
                    client.add(e, deadline_s=5.0)
                except (protocol.ServeError, OSError, ConnectionError,
                        socket.timeout):
                    return False  # outcome unknown: stays un-acked
                acked.add(e)
            return True
        finally:
            client.close()

    todo = list(range(elements))
    rng.shuffle(todo)
    w = Worker(dirpath, port, elements, cfg["device"],
               crash_after_batches=cfg["window_batches"], **cfg["serve"])
    finished = submit_all(w, todo)
    if finished and w.proc.poll() is None:
        w.terminate()  # the hook never fired: adjudicated below
    w.proc.wait()
    w.log.close()
    window_fired = (not finished) and w.proc.returncode == -signal.SIGKILL
    kills["window_hook"] += int(window_fired)

    remaining = [e for e in todo if e not in acked]
    w = Worker(dirpath, port, elements, cfg["device"], **cfg["serve"])
    kill_at = (rng.randrange(max(1, len(remaining) // 2)) + 1
               if remaining else None)
    submit_all(w, remaining, kill_at=kill_at)
    if w.proc.poll() is None:
        kills["parent_sigkill"] += 1
        w.kill()
    w.log.close()

    w = Worker(dirpath, port, elements, cfg["device"], **cfg["serve"])
    submit_all(w, [e for e in todo if e not in acked])
    with ServeClient(w.addr, timeout=60.0) as c:
        members, _vv = c.members()
        counters = c.stats()["counters"]
    rc = w.terminate()
    w.log.close()
    members = set(int(m) for m in members)
    return {"kills": kills, "window_kill_landed": window_fired,
            "acked_ops": len(acked), "members": len(members),
            "record_modes": {k: counters.get(k, 0) for k in (
                "wal.compact_records", "wal.dense_records",
                "wal.replayed_compact", "wal.replayed_dense")},
            "lost_acked_ops": sorted(acked - members),
            "phantom_members": sorted(members - submitted),
            "unfinished": sorted(set(todo) - acked),
            "drained": rc == 0 and "drained:" in w.output()}


def chaos_leg(root: str, cfg: dict, seed: int,
              reconnect_every: int = 8) -> Dict[str, object]:
    """Durable acks under wire faults (tools/serve_soak.py's chaos leg):
    a seeded ``net/faults.ChaosProxy`` on the ingest port tears OP
    frames, delays acks, drops dials and holds a client-side partition
    while a ledgered add-only workload submits through it.  A transport
    failure is an ambiguous outcome, resolved by idempotent resubmit;
    the final membership is read from the worker directly, not through
    the proxy."""
    from go_crdt_playground_tpu_torch.net.faults import (ChaosProxy,
                                                         ChaosScenario)

    rng = random.Random(seed)
    elements = cfg["elements"]
    w = Worker(os.path.join(root, "chaos"), free_port(), elements,
               cfg["device"], **cfg["serve"])
    scenario = ChaosScenario(
        drop_rate=0.15, truncate_rate=0.2, truncate_window=(1, 48),
        delay_rate=0.3, delay_s=0.01)
    proxy = ChaosProxy(w.addr, seed=seed, scenario=scenario)
    addr = ("127.0.0.1", proxy.port)
    acked: Set[int] = set()
    submitted: Set[int] = set()
    transport_failures = typed_rejects = partition_refusals = 0
    give_ups: List[int] = []
    client: Optional[ServeClient] = None
    ops_on_conn = 0
    try:
        todo = list(range(elements))
        rng.shuffle(todo)
        partition_at = len(todo) // 2
        partitioned = False
        for n, e in enumerate(todo):
            if n == partition_at:
                # every new dial refused until the refusal registers;
                # closing the live client forces the stream to redial
                proxy.partition()
                partitioned = True
                if client is not None:
                    client.close()
                    client = None
            submitted.add(e)
            done = False
            for _ in range(50):
                if partitioned and proxy.counters()["refused"] >= 1:
                    partition_refusals = proxy.counters()["refused"]
                    proxy.heal()
                    partitioned = False
                if client is None or ops_on_conn >= reconnect_every:
                    if client is not None:
                        client.close()
                        client = None
                    try:
                        client = ServeClient(addr, timeout=10.0)
                        ops_on_conn = 0
                    except (OSError, ConnectionError):
                        transport_failures += 1
                        time.sleep(0.01)
                        continue
                try:
                    client.add(e, deadline_s=5.0)
                    acked.add(e)
                    ops_on_conn += 1
                    done = True
                    break
                except protocol.ServeError:
                    typed_rejects += 1
                    ops_on_conn += 1
                    time.sleep(0.01)
                except (OSError, ConnectionError, socket.timeout):
                    transport_failures += 1
                    client.close()
                    client = None
                    time.sleep(0.01)
            if not done:
                give_ups.append(e)
        with ServeClient(w.addr, timeout=60.0) as direct:
            members, _vv = direct.members()
    finally:
        if client is not None:
            client.close()
        proxy.close()
        rc = w.terminate()
        w.log.close()
    members_set = set(int(m) for m in members)
    return {"elements": elements,
            "scenario": {"drop_rate": scenario.drop_rate,
                         "truncate_rate": scenario.truncate_rate,
                         "delay_rate": scenario.delay_rate,
                         "delay_s": scenario.delay_s,
                         "partition_window": True},
            "proxy_counters": proxy.counters(),
            "transport_failures": transport_failures,
            "typed_rejects": typed_rejects,
            "partition_refusals": partition_refusals,
            "acked_ops": len(acked), "final_members": len(members_set),
            "lost_acked_ops": sorted(acked - members_set),
            "phantom_members": sorted(members_set - submitted),
            "gave_up": give_ups,
            "drained": rc == 0 and "drained:" in w.output()}


def check_name(line: str) -> str:
    """The named check a failure line reports (the text before its first
    colon)."""
    return line.split(":", 1)[0]


def guarantee_failures(results: Dict[str, object]) -> List[str]:
    """What the serve tier guarantees, whatever the hardware: zero lost
    acked ops, zero phantom members and a drain on SIGTERM in every leg,
    every submitted op resolved (an ack or a typed reject), both crash
    kills landed, recovery replayed compact records, and every element
    acked in the end.  Each line starts with its check's name."""
    bad = []
    legs = {"load": results["load"], "compaction": results["compaction"],
            "crash": results["crash"], "chaos": results["chaos"],
            **{f"ingest_{m}": results["ingest_compare"][m]
               for m in ("seed", "fused")}}
    for name, leg in legs.items():
        if leg["lost_acked_ops"] or leg["phantom_members"]:
            bad.append(f"{name}/ledger: lost {leg['lost_acked_ops'][:10]} "
                       f"phantom {leg['phantom_members'][:10]}")
        if not leg["drained"]:
            bad.append(f"{name}/drained: the worker did not drain on "
                       f"SIGTERM")
    for leg in results["load"]["open_loop"]:
        if leg["unresolved"] or leg["send_errors"]:
            bad.append(f"open_loop/unresolved: {leg['offered_rate']}/s: "
                       f"unresolved ops")
    if any(results["ingest_compare"][m]["unresolved"]
           for m in ("seed", "fused")):
        bad.append("ingest_compare/unresolved: unresolved ops")
    comp = results["compaction"]
    if comp["light_unresolved"] or comp["heavy_unresolved"]:
        bad.append("compaction/unresolved: unresolved ops")
    crash = results["crash"]
    kills = crash["kills"]
    if kills["window_hook"] != 1 or kills["parent_sigkill"] < 1:
        bad.append(f"crash/kills: kills {kills}")
    if not crash["record_modes"]["wal.replayed_compact"] > 0:
        bad.append(f"crash/replayed: no compact record replayed "
                   f"{crash['record_modes']}")
    if crash["unfinished"]:
        bad.append(f"crash/unfinished: never acked "
                   f"{crash['unfinished'][:10]}")
    if results["chaos"]["gave_up"]:
        bad.append(f"chaos/gave_up: never acked "
                   f"{results['chaos']['gave_up'][:10]}")
    return bad


def failures(results: Dict[str, object]) -> List[str]:
    """The adjudication of tools/serve_soak.py, check for check:
    ``guarantee_failures`` and the shape of the load curves, the ingest
    comparison, compaction and the chaos leg's fault census.  Each line
    starts with its check's name."""
    bad = guarantee_failures(results)
    curve = results["load"]["open_loop"]
    # (a) goodput scales with offered load below the admission limit
    low, top = curve[0], curve[-1]
    if not top["goodput"] > 1.5 * low["goodput"]:
        bad.append(f"open_loop/scaling: goodput {low['goodput']} -> "
                   f"{top['goodput']} does not scale")
    if not low["goodput"] >= 0.8 * low["achieved_offer_rate"]:
        bad.append(f"open_loop/goodput_floor: goodput {low['goodput']} "
                   f"under 0.8 x the offered {low['achieved_offer_rate']}")
    # (b) past the limit the frontend sheds typed Overloaded and the
    # server-side ingest p99 stays bounded
    if not top["overloaded"] > 0:
        bad.append(f"open_loop/shed: nothing shed at "
                   f"{top['offered_rate']}/s ({top['submitted']} sent; at "
                   f"the offering's end {top['window_end']}; client p50 "
                   f"{top['p50_ms']} ms)")
    if top["server_ingest_p99_ms"] is None or \
            top["server_ingest_p99_ms"] >= 2000.0:
        bad.append(f"open_loop/server_p99: server-side ingest p99 "
                   f"{top['server_ingest_p99_ms']} ms under overload")
    # (b2) fused ingest one step a batch where the seed took two, compact
    # records smaller per acked op, goodput no worse
    seed, fused = (results["ingest_compare"][m] for m in ("seed", "fused"))
    if fused["dispatches_per_batch"] != 1.0 or \
            seed["dispatches_per_batch"] <= 1.5:
        bad.append(f"ingest_compare/steps: {seed['dispatches_per_batch']} "
                   f"/ {fused['dispatches_per_batch']} steps a batch")
    if not fused["wal_bytes_per_acked_op"] < \
            0.7 * seed["wal_bytes_per_acked_op"]:
        bad.append(
            f"ingest_compare/wal_bytes: WAL bytes an acked op, fused "
            f"{fused['wal_bytes_per_acked_op']} against seed "
            f"{seed['wal_bytes_per_acked_op']} (ops a batch "
            f"{fused['ops_per_batch']} / {seed['ops_per_batch']}, bytes a "
            f"record {fused['wal_bytes_per_record']} / "
            f"{seed['wal_bytes_per_record']})")
    if not (fused["wal_compact_records"] > 0
            and seed["wal_compact_records"] == 0):
        bad.append(f"ingest_compare/compact_records: compact records "
                   f"{fused['wal_compact_records']} / "
                   f"{seed['wal_compact_records']}")
    if not fused["goodput"] >= 0.8 * seed["goodput"]:
        bad.append(f"ingest_compare/goodput: goodput {fused['goodput']} "
                   f"against seed {seed['goodput']}")
    if fused["ingest_p99_ms"] is None or fused["ingest_p99_ms"] >= 2000.0:
        bad.append(f"ingest_compare/p99: fused ingest p99 "
                   f"{fused['ingest_p99_ms']} ms")
    # (b3) GC under light traffic with the server p99 bounded, backoff
    # under heavy traffic
    comp = results["compaction"]
    if comp["gc_dropped_lanes_under_traffic"] == 0:
        bad.append("compaction/gc: no GC under light traffic")
    if comp["light_server_p99_ms"] is None or \
            comp["light_server_p99_ms"] >= 2000.0:
        bad.append(f"compaction/light_p99: light server p99 "
                   f"{comp['light_server_p99_ms']} ms")
    if comp["backoffs_during_heavy"] == 0:
        bad.append("compaction/backoff: no backoff under heavy traffic")
    # (d) the chaos leg's wire faults fired: a green leg with no injected
    # fault proves nothing
    pc = results["chaos"]["proxy_counters"]
    if not (pc["dropped"] + pc["truncated"] >= 1 and pc["delayed"] >= 1
            and pc["refused"] >= 1):
        bad.append(f"chaos/faults_fired: proxy counters {pc}")
    return bad


def run(device: str, quick: bool, seed: int = 23) -> Dict[str, object]:
    cfg = {"device": device,
           "serve": {"queue_depth": 128, "max_batch": 32, "flush_ms": 2.0},
           "elements": 192 if quick else 384,
           "rates": [200.0, 1000.0, 6000.0] if quick
           else [200.0, 800.0, 2500.0, 8000.0],
           "duration_s": 3.0 if quick else 6.0,
           "concurrencies": [1, 4] if quick else [1, 4, 16],
           "closed_s": 2.0 if quick else 4.0,
           "compare_s": 3.0 if quick else 5.0,
           "window_batches": 6 if quick else 10}
    t0 = time.time()
    root = tempfile.mkdtemp(prefix="torch-serve-soak-")
    results: Dict[str, object] = {"device": device, "quick": quick,
                                  "elements": cfg["elements"]}
    try:
        for name, leg in (("load", lambda: load_legs(root, cfg)),
                          ("ingest_compare",
                           lambda: ingest_compare_leg(root, cfg)),
                          ("compaction", lambda: compaction_leg(root, cfg)),
                          ("crash", lambda: crash_leg(root, cfg, seed)),
                          ("chaos", lambda: chaos_leg(root, cfg, seed))):
            results[name] = leg()
            print(json.dumps({name: results[name]}), flush=True)
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    results["elapsed_s"] = round(time.time() - t0, 1)
    return results


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true",
                    help="the CI-sized legs (as tools/serve_soak.py "
                         "--quick)")
    ap.add_argument("--device", default="cuda",
                    help="the workers' device (default cuda)")
    ap.add_argument("--out", default=None, help="write the results here")
    ap.add_argument("--seed", type=int, default=23)
    args = ap.parse_args(argv)
    results = run(args.device, args.quick, args.seed)
    bad = failures(results)
    results["failures"] = bad
    results["guarantee_failures"] = guarantee_failures(results)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
            f.write("\n")
    for line in bad:
        print(f"FAIL: {line}", flush=True)
    print(json.dumps({"ok": not bad, "elapsed_s": results["elapsed_s"]}),
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
