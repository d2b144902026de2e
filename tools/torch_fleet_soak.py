#!/usr/bin/env python3
"""Host-fleet soak for the port: node processes gossiping over real TCP
through lossy proxies, tests/test_fleet_soak.py's fleet on torch nodes.

The parent runs one lossy TCP proxy per worker (``LossyProxy``): a
seeded 20% of proxied connections are cut after forwarding a random
prefix (torn frames, connections closed mid-exchange).  Workers (this
file with ``--worker``, each one ``net.peer.Node`` on ``--device``)
also duplicate about 15% of their exchanges and reshuffle their peer
order every sweep.  Phase 2 sweeps every pair directly once the fleet
is quiescent, after which every replica must hold the same global union
and the same vv.

Protocol on the workers' stdio:
  -> "PORT <p>"            after the node's server is up
  <- "ADDRS <2n ports>"    n proxy ports, then n direct ports
  -> "PHASE1"              after the lossy sweeps
  <- "PHASE2"              every worker finished phase 1
  -> "PHASE2DONE"          after the clean all-pairs sweep
  <- "REPORT"              every worker finished phase 2
  -> one JSON line {"members": [...], "vv": [...], "lost": n}

The workers, elements, sweeps, seeds (proxies 7000 + j, workers
1000 + idx), timeouts and phase-2 retries are the test's.  The result
(``--out``) holds every worker's members and vv, the lost exchanges,
the proxies' dropped and total connections, the wall time and the
failed checks (``failures``): the test's assertions.

Usage:
    python tools/torch_fleet_soak.py [--device cuda|cpu] [--out FILE]

Exits nonzero when any check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import random
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from torch_soak_util import device_label, warm_delta_path  # noqa: E402

N_WORKERS = 8
NUM_ELEMENTS = 64
SWEEPS = 4
PER_WORKER = 4
# the parent's wait for any one protocol line; workers on a card start
# in seconds, a hung one is killed
LINE_TIMEOUT_S = 300.0


class LossyProxy:
    """Forwards TCP connections to ``target_port``; a seeded fraction
    are cut after a random forwarded prefix (both directions pumped; the
    cut closes both ends abruptly)."""

    def __init__(self, target_port: int, seed: int, drop_rate: float = 0.2):
        self.target_port = target_port
        self.rng_lock = threading.Lock()
        self.rng = random.Random(seed)
        self.drop_rate = drop_rate
        self.total = 0
        self.dropped = 0
        self._closing = False
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(64)
        self.port = self.sock.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            with self.rng_lock:
                self.total += 1
                cut = self.rng.random() < self.drop_rate
                cut_after = self.rng.randint(0, 40) if cut else None
                if cut:
                    self.dropped += 1
            threading.Thread(target=self._pump_pair, daemon=True,
                             args=(conn, cut_after)).start()

    def _pump_pair(self, conn: socket.socket, cut_after) -> None:
        try:
            upstream = socket.create_connection(
                ("127.0.0.1", self.target_port), timeout=5.0)
        except OSError:
            conn.close()
            return

        def pump(src, dst, budget):
            forwarded = 0
            try:
                while True:
                    take = 4096 if budget is None else min(
                        4096, budget - forwarded)
                    if take <= 0:
                        break
                    data = src.recv(take)
                    if not data:
                        break
                    dst.sendall(data)
                    forwarded += len(data)
            except OSError:
                pass
            finally:
                # abrupt close of both ends: the peer sees a torn frame
                for s in (src, dst):
                    try:
                        s.close()
                    except OSError:
                        pass

        threading.Thread(target=pump, daemon=True,
                         args=(conn, upstream, cut_after)).start()
        pump(upstream, conn, cut_after)

    def close(self) -> None:
        self._closing = True
        try:
            self.sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# worker process
# ---------------------------------------------------------------------------


def worker_main(idx: int, n: int, num_elements: int, device: str) -> int:
    """One replica through the lossy schedule: phase 1 syncs through the
    parent's proxies (a cut surfaces as a failed exchange, which anti-
    entropy heals), phase 2 sweeps every peer directly."""
    from go_crdt_playground_tpu_torch.net.peer import Node

    node = Node(idx, num_elements, n, conn_timeout_s=5.0, device=device)
    node.add(*range(idx * PER_WORKER, idx * PER_WORKER + PER_WORKER))
    warm_delta_path(num_elements, n, device)
    _, port = node.serve()
    print(f"PORT {port}", flush=True)

    parts = sys.stdin.readline().split()
    if not parts or parts[0] != "ADDRS":
        raise RuntimeError(f"expected ADDRS, got {parts}")
    ports = [int(p) for p in parts[1:]]
    proxy, direct = ports[:n], ports[n:]

    rng = random.Random(1000 + idx)
    lost = 0
    for _sweep in range(SWEEPS):
        order = [j for j in range(n) if j != idx]
        rng.shuffle(order)  # reordering: every sweep hits peers anew
        for j in order:
            # duplication: a repeated exchange must be idempotent
            dials = 2 if rng.random() < 0.15 else 1
            for _ in range(dials):
                try:
                    node.sync_with(("127.0.0.1", proxy[j]), timeout=4.0)
                except Exception:  # noqa: BLE001 — any cut is one loss
                    lost += 1  # a lost exchange, never lost data
    print("PHASE1", flush=True)
    if sys.stdin.readline().strip() != "PHASE2":
        raise RuntimeError("expected PHASE2")

    # the clean direct sweep: after every pair exchanged at least once
    # after quiescence, every replica holds the global union
    for j in range(n):
        if j == idx:
            continue
        for _attempt in range(40):
            try:
                node.sync_with(("127.0.0.1", direct[j]), timeout=4.0)
                break
            except Exception:  # noqa: BLE001 — retried, then reported
                time.sleep(0.1)
        else:
            print(f"FAIL unreachable {j}", flush=True)
            return 1
    print("PHASE2DONE", flush=True)
    if sys.stdin.readline().strip() != "REPORT":
        raise RuntimeError("expected REPORT")
    print(json.dumps({
        "members": [int(e) for e in node.members()],
        "vv": [int(v) for v in node.vv()],
        "lost": lost,
    }), flush=True)
    node.close()
    return 0


# ---------------------------------------------------------------------------
# parent
# ---------------------------------------------------------------------------


class _Worker:
    """One worker process, its stdout read into a queue by a thread and
    its stderr kept in a file."""

    def __init__(self, idx: int, n: int, num_elements: int, device: str,
                 logdir: str):
        self.err_path = os.path.join(logdir, f"worker-{idx}.err")
        self._err = open(self.err_path, "wb")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             str(idx), str(n), str(num_elements), "--device", device],
            cwd=REPO, text=True, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self._err)
        self.lines: "queue.Queue[Optional[str]]" = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def send(self, line: str) -> None:
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def read_until(self, prefix: str) -> str:
        deadline = time.monotonic() + LINE_TIMEOUT_S
        while True:
            try:
                line = self.lines.get(
                    timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                raise TimeoutError(f"no {prefix!r} line in "
                                   f"{LINE_TIMEOUT_S} s") from None
            if line is None:
                raise RuntimeError(f"worker exited early: {self.stderr()}")
            if line.startswith(prefix):
                return line.strip()

    def stderr(self) -> str:
        self._err.flush()
        with open(self.err_path, errors="replace") as f:
            return f.read()[-2000:]

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._err.close()


def run(device: str = "cuda", n_workers: int = N_WORKERS,
        num_elements: int = NUM_ELEMENTS) -> Dict[str, object]:
    """One soak; returns the result with its failed checks."""
    label = device_label(device)
    t0 = time.monotonic()
    logdir = tempfile.mkdtemp(prefix="torch-fleet-soak-")
    workers: List[_Worker] = []
    proxies: List[LossyProxy] = []
    try:
        for i in range(n_workers):
            workers.append(_Worker(i, n_workers, num_elements, device,
                                   logdir))
        direct = [int(w.read_until("PORT").split()[1]) for w in workers]
        t_up = time.monotonic() - t0
        proxies = [LossyProxy(p, seed=7000 + j)
                   for j, p in enumerate(direct)]
        addrs = " ".join(str(p.port) for p in proxies) + " " + " ".join(
            str(p) for p in direct)
        for w in workers:
            w.send(f"ADDRS {addrs}")
        for w in workers:
            w.read_until("PHASE1")
        dropped = sum(p.dropped for p in proxies)
        total = sum(p.total for p in proxies)
        for w in workers:
            w.send("PHASE2")
        for w in workers:
            w.read_until("PHASE2DONE")
        for w in workers:
            w.send("REPORT")
        reports = [json.loads(w.read_until("{")) for w in workers]
        rcs = [w.proc.wait(timeout=30) for w in workers]
    finally:
        for p in proxies:
            p.close()
        for w in workers:
            w.close()
        for name in os.listdir(logdir):
            os.unlink(os.path.join(logdir, name))
        os.rmdir(logdir)
    wall = time.monotonic() - t0

    expected = sorted(e for i in range(n_workers)
                      for e in range(i * PER_WORKER, (i + 1) * PER_WORKER))
    lost = sum(r["lost"] for r in reports)
    failures = []
    if dropped < 10:
        failures.append(f"dropped: {dropped} connections cut, want >= 10")
    if total < 100:
        failures.append(f"total: {total} proxied connections, want >= 100")
    if lost < 10:
        failures.append(f"lost: {lost} lost exchanges, want >= 10 (proxy "
                        "cuts must surface as lost exchanges)")
    for i, r in enumerate(reports):
        if r["members"] != expected:
            failures.append(f"members: worker {i} diverged")
        if r["vv"] != reports[0]["vv"]:
            failures.append(f"vv: worker {i} VV diverged")
    if any(rcs):
        failures.append(f"exit: worker exit codes {rcs}")
    return {"workers": n_workers, "elements": num_elements,
            "device": label, "expected": expected,
            "members": [r["members"] for r in reports],
            "vv": [r["vv"] for r in reports],
            "lost": lost, "dropped": dropped, "total": total,
            "workers_up_s": round(t_up, 3), "wall_s": round(wall, 3),
            "failures": failures}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the worker nodes (default cuda, "
                         "which raises without a GPU)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", nargs=3, type=int, metavar=("IDX", "N", "E"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker_main(*args.worker, args.device)
    res = run(args.device)
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("members", "expected")}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
            f.write("\n")
    return 0 if not res["failures"] else 1


if __name__ == "__main__":
    sys.exit(main())
