#!/usr/bin/env python3
"""Socket-level chaos soak for the port: the digest-regime chaos leg of
tools/chaos_soak.py on torch nodes.

An in-process fleet of the port's ``net.peer.Node`` replicas (on
``--device``), each serving behind a seeded ``net.faults.ChaosProxy``
(drops before HELLO, mid-frame truncations, duplicate deliveries, an
asymmetric partition of node 0 for rounds 0-2 that then heals), each
driven by a ``SyncSupervisor`` on the digest regime (net/digestsync.py:
K11's summaries on the card) in lockstep rounds.  The fleet, seed (11),
severity (0.25) and supervisor settings are those of the chaos leg of
``tools/chaos_soak.py --sync-curve``, whose CPU census SYNC_CURVE.json
records; ``--quick`` takes the sizes of its quick mode.

The leg passes when the fleet converges (every node the same members
and vv) within ``--max-rounds``, every fault kind the JAX leg's census
shows also fired here, and, for the full fleet, the census
(connections, refused, dropped, truncated, ...) equals the JAX leg's
(``census_equal``): the proxies plan the same fault stream per
connection for the seed.  The quick fleet has no JAX census of its own
and is held to the fault kinds only.  A missing or unreadable
``--reference`` fails the leg.

Usage:
    python tools/torch_chaos_soak.py [--quick] [--device cuda|cpu]
        [--sync-mode digest|delta] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FAULT_KINDS = ("refused", "dropped", "truncated", "duplicated")


def run_scenario(n_nodes: int, n_elements: int, drop_rate: float,
                 truncate_rate: float, duplicate_rate: float, seed: int,
                 max_rounds: int,
                 partition_rounds: Optional[Tuple[int, int]] = None,
                 sync_mode: str = "digest",
                 device: str = "cuda") -> Dict[str, object]:
    """One seeded fleet run (tools/chaos_soak.run_scenario's); returns
    rounds to convergence, the fault census, breaker transitions and
    retries."""
    import numpy as np

    from go_crdt_playground_tpu_torch.net import digestsync
    from go_crdt_playground_tpu_torch.net.antientropy import SyncSupervisor
    from go_crdt_playground_tpu_torch.net.faults import (ChaosScenario,
                                                         fleet_proxies)
    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.obs import Recorder
    from go_crdt_playground_tpu_torch.utils.backoff import BackoffPolicy

    recorders = [Recorder() for _ in range(n_nodes)]
    nodes = [Node(i, n_elements, n_nodes, recorder=recorders[i],
                  conn_timeout_s=10.0, hello_timeout_s=0.5, device=device)
             for i in range(n_nodes)]
    supervisors: List[SyncSupervisor] = []
    proxies = []
    per_node = n_elements // n_nodes
    try:
        if sync_mode == "digest":
            # build and launch the digest path before any timed exchange:
            # a 1 s sync deadline must measure the protocol, not the load
            digestsync.warm(nodes[0])
        addrs = [n.serve() for n in nodes]
        for i, n in enumerate(nodes):
            n.add(*range(i * per_node, (i + 1) * per_node))
        scenario = ChaosScenario(drop_rate=drop_rate,
                                 truncate_rate=truncate_rate,
                                 duplicate_rate=duplicate_rate)
        proxies = fleet_proxies(addrs, seed=seed, scenario=scenario)
        policy = BackoffPolicy(base_s=0.005, cap_s=0.05, max_retries=2)
        for i in range(n_nodes):
            peer_addrs = [("127.0.0.1", proxies[j].port)
                          for j in range(n_nodes) if j != i]
            supervisors.append(SyncSupervisor(
                nodes[i], peer_addrs, policy=policy,
                sync_timeout_s=1.0, hello_timeout_s=0.4,
                breaker_threshold=2, breaker_cooldown_s=0.1,
                fanout=1, interval_s=0.0, sync_mode=sync_mode,
                recorder=recorders[i], seed=seed * 100 + i))
        expected = set(range(per_node * n_nodes))

        def converged() -> bool:
            vv0 = nodes[0].vv()
            return all(set(n.members()) == expected
                       and np.array_equal(n.vv(), vv0) for n in nodes)

        rounds = None
        t0 = time.monotonic()
        for rnd in range(max_rounds):
            if partition_rounds is not None:
                if rnd == partition_rounds[0]:
                    proxies[0].partition()
                elif rnd == partition_rounds[1]:
                    proxies[0].heal()
            for sup in supervisors:
                sup.sync_round()
            in_partition = (partition_rounds is not None
                            and partition_rounds[0] <= rnd
                            < partition_rounds[1])
            if not in_partition and converged():
                rounds = rnd + 1
                break
        wall_s = time.monotonic() - t0
        faults: Dict[str, int] = {}
        for p in proxies:
            for k, v in p.counters().items():
                faults[k] = faults.get(k, 0) + v
        breaker: Dict[str, int] = {}
        retries = 0
        digest_exchanges = 0
        for r in recorders:
            for k, v in r.snapshot()["counters"].items():
                if k.startswith("breaker.to_"):
                    breaker[k] = breaker.get(k, 0) + v
                elif k.startswith("sync.retries."):
                    retries += v
                elif k == "digest.exchanges":
                    digest_exchanges += v
        return {"rounds": rounds, "converged": rounds is not None,
                "faults": faults, "breaker": breaker, "retries": retries,
                "digest_exchanges": digest_exchanges,
                "wall_s": round(wall_s, 3)}
    finally:
        for sup in supervisors:
            sup.stop(timeout=1.0)
        for p in proxies:
            p.close()
        for n in nodes:
            n.close()


def reference_census(path: str) -> Optional[Dict[str, object]]:
    """The JAX leg's chaos record from SYNC_CURVE.json; None when the
    file is missing or unreadable or holds no census."""
    try:
        with open(path) as f:
            ref = json.load(f).get("chaos")
    except (OSError, ValueError, AttributeError):
        return None
    if not isinstance(ref, dict) or \
            not isinstance(ref.get("faults_injected"), dict):
        return None
    return ref


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true",
                    help="the quick mode's fleet (4 nodes, 32 elements)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the nodes (default cuda; cpu "
                         "runs the kernels' plain versions)")
    ap.add_argument("--sync-mode", dest="sync_mode", default="digest",
                    choices=("digest", "delta"))
    ap.add_argument("--max-rounds", dest="max_rounds", type=int,
                    default=60)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--reference",
                    default=os.path.join(REPO, "SYNC_CURVE.json"),
                    help="the JAX leg's artifact (its `chaos` census)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    severity = 0.25
    n_nodes, n_elements = (4, 32) if args.quick else (6, 60)
    run = run_scenario(n_nodes, n_elements, drop_rate=severity,
                       truncate_rate=severity / 2, duplicate_rate=0.1,
                       seed=args.seed, max_rounds=args.max_rounds,
                       partition_rounds=(0, 2), sync_mode=args.sync_mode,
                       device=args.device)
    ref = reference_census(args.reference)
    want_kinds = [k for k in FAULT_KINDS
                  if ref is not None and ref["faults_injected"].get(k, 0) > 0]
    missing = [k for k in want_kinds if run["faults"].get(k, 0) == 0]
    # the JAX leg ran the full fleet: only then is its census the same
    # run's
    census_equal = (None if args.quick else
                    ref is not None
                    and {k: v for k, v in run["faults"].items()
                         if k != "severed"} == ref["faults_injected"])
    result = {"nodes": n_nodes, "elements": n_elements,
              "severity": severity, "seed": args.seed,
              "sync_mode": args.sync_mode, "device": args.device,
              **run,
              "reference": (None if ref is None else {
                  "rounds": ref.get("rounds"),
                  "faults_injected": ref.get("faults_injected")}),
              "fault_kinds_expected": want_kinds,
              "fault_kinds_missing": missing,
              "census_equal": census_equal}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
            f.write("\n")
    ok = (run["converged"] and ref is not None and not missing
          and census_equal is not False)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
