#!/usr/bin/env python3
"""Socket-level chaos soak for the port: rounds to convergence under
injected faults, tools/chaos_soak.py on torch nodes.

An in-process fleet of the port's ``net.peer.Node`` replicas (on
``--device``), each serving behind a seeded ``net.faults.ChaosProxy``
(drops before HELLO, mid-frame truncations, duplicate deliveries, an
asymmetric partition episode that later heals), each driven by a
``net.antientropy.SyncSupervisor`` (bounded retries, jittered backoff,
per-peer circuit breakers).  One round is one supervisor pass over the
peer set for every node, driven in lockstep.

Three modes, the reference's shapes, seeds and artifact fields; each
artifact names the card (``device``) where the reference writes its
platform:

* the severity curve (default; ``CHAOS_CURVE_TORCH.json``): rounds to
  convergence per fault severity (min/median/max over seeds), the
  injected-fault census and the breaker transitions;
* ``--sync-curve`` (``SYNC_CURVE_TORCH.json``): the digest regime's
  bytes on the wire against the δ ladder on the same seeded op stream
  (``run_traffic_leg``: quiescent and divergent legs), and the digest
  regime's convergence behind the fault proxy (the chaos leg);
* ``--chaos-leg``: that chaos leg alone, its census held against the
  JAX leg's in ``--reference`` (SYNC_CURVE.json): every fault kind the
  JAX census shows fired here and, for the full fleet, the census is
  equal (``census_equal``).  The quick fleet has no JAX census of its
  own and is held to the fault kinds only; a missing or unreadable
  reference fails the leg.

Usage:
    python tools/torch_chaos_soak.py [--quick] [--device cuda|cpu]
        [--detect-races] [--out FILE]
    python tools/torch_chaos_soak.py --sync-curve [--quick] ...
    python tools/torch_chaos_soak.py --chaos-leg [--quick]
        [--sync-mode digest|delta] [--reference FILE] ...

Exits nonzero when a run fails to converge, a sync-curve leg misses its
byte comparison, the chaos leg's census departs from the reference's,
or, with --detect-races, the lockset detector reports a race.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import Dict, List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from torch_soak_util import device_label  # noqa: E402

FAULT_KINDS = ("refused", "dropped", "truncated", "duplicated")
# the chaos leg's severity, in --sync-curve and --chaos-leg
CHAOS_SEVERITY = 0.25


def run_scenario(n_nodes: int, n_elements: int, drop_rate: float,
                 truncate_rate: float, duplicate_rate: float, seed: int,
                 max_rounds: int,
                 partition_rounds: Optional[Tuple[int, int]] = None,
                 detect_races: bool = False,
                 sync_mode: str = "delta",
                 device: str = "cuda") -> Dict[str, object]:
    """One seeded fleet run; returns rounds to convergence, the fault
    census, breaker transitions and retries.

    ``partition_rounds=(a, b)`` partitions node 0 (its proxy refuses all
    inbound; it still dials out) from round a until round b, then heals.
    ``detect_races`` runs the fleet under the lockset detector
    (analysis/locksets.py): every Node and SyncSupervisor instrumented,
    any shared write with an empty candidate lockset in ``races``.
    ``sync_mode="digest"`` drives the fleet on the digest regime
    (net/digestsync.py, K11 on the card): the sync curve's chaos leg."""
    import numpy as np

    from go_crdt_playground_tpu_torch.net import digestsync
    from go_crdt_playground_tpu_torch.net.antientropy import SyncSupervisor
    from go_crdt_playground_tpu_torch.net.faults import (ChaosScenario,
                                                         fleet_proxies)
    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.obs import Recorder
    from go_crdt_playground_tpu_torch.utils.backoff import BackoffPolicy

    if sync_mode == "digest":
        # build and launch the digest path for this fleet shape before
        # any timed exchange: a 1 s sync deadline must measure the
        # protocol, not the first launch
        digestsync.warm(Node(0, n_elements, n_nodes, device=device))
    recorders = [Recorder() for _ in range(n_nodes)]
    nodes = [Node(i, n_elements, n_nodes, recorder=recorders[i],
                  conn_timeout_s=10.0, hello_timeout_s=0.5, device=device)
             for i in range(n_nodes)]
    detector = None
    if detect_races:
        from go_crdt_playground_tpu_torch.analysis.locksets import \
            RaceDetector

        detector = RaceDetector()
        for i, n in enumerate(nodes):
            detector.instrument(n, label=f"Node#{i}")
    supervisors: List[SyncSupervisor] = []
    proxies = []
    per_node = n_elements // n_nodes
    try:
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
            # fanout 1: one partner per node per round
            sup = SyncSupervisor(
                nodes[i], peer_addrs, policy=policy,
                sync_timeout_s=1.0, hello_timeout_s=0.4,
                breaker_threshold=2, breaker_cooldown_s=0.1,
                fanout=1, interval_s=0.0, sync_mode=sync_mode,
                recorder=recorders[i], seed=seed * 100 + i)
            if detector is not None:
                detector.instrument(sup, label=f"SyncSupervisor#{i}")
            supervisors.append(sup)
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
            # never converged while the partition still holds a node
            # dark: the healed fleet must re-converge
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
        races = ([] if detector is None
                 else [f.render() for f in detector.findings])
        return {"rounds": rounds, "converged": rounds is not None,
                "faults": faults, "breaker": breaker, "retries": retries,
                "races": races,
                "race_detector": (None if detector is None
                                  else detector.stats()),
                "digest_exchanges": digest_exchanges,
                "wall_s": round(wall_s, 3)}
    finally:
        for sup in supervisors:
            sup.stop(timeout=1.0)
        for p in proxies:
            p.close()
        for n in nodes:
            n.close()
        if detector is not None:
            for obj in supervisors + nodes:
                try:
                    detector.uninstall(obj)
                except Exception:  # noqa: BLE001 — best-effort teardown
                    pass


# ---------------------------------------------------------------------------
# the sync curve: digest-sync bytes on the wire against the δ ladder
# ---------------------------------------------------------------------------


def wait_served(nodes, timeout: float = 10.0) -> None:
    """Wait until no node is serving an exchange.  A server records its
    counters after its last send, so a count read as soon as the client
    returns could miss the server's half."""
    deadline = time.monotonic() + timeout
    while any(n._conn_slots._value < n._conn_slots._initial_value
              for n in nodes):
        if time.monotonic() > deadline:
            raise AssertionError("a served exchange did not finish")
        time.sleep(0.0005)


def run_traffic_leg(sync_mode: str, n_nodes: int, n_elements: int,
                    ops_per_round: int, traffic_rounds: int, seed: int,
                    quiescent_rounds: int = 4, settle_rounds: int = 20,
                    device: str = "cuda"):
    """One clean-network fleet under a seeded op stream, each node
    serving on 127.0.0.1 and driven by a ``SyncSupervisor`` (fanout 1,
    no pacing) in lockstep rounds, measuring bytes on the wire.  The same
    seed replays the same op stream under either regime.

    Phases: seed state and converge (first-contact FULLs land here,
    outside the measured window), DIVERGENT (``ops_per_round`` ops
    before each of ``traffic_rounds`` rounds), SETTLE (rounds until
    converged; their bytes count toward the divergence), QUIESCENT
    (``quiescent_rounds`` rounds of a converged fleet: the digest regime
    ships no state lanes).  Each round ends once every served exchange
    has recorded its counters.  Returns the reference's numbers and
    every node's final state (on the CPU)."""
    import numpy as np

    from go_crdt_playground_tpu_torch.net import digestsync
    from go_crdt_playground_tpu_torch.net.antientropy import SyncSupervisor
    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.obs import Recorder
    from go_crdt_playground_tpu_torch.utils.backoff import BackoffPolicy

    if sync_mode == "digest":
        digestsync.warm(Node(0, n_elements, n_nodes, device=device))
    recorders = [Recorder() for _ in range(n_nodes)]
    nodes = [Node(i, n_elements, n_nodes, recorder=recorders[i],
                  device=device) for i in range(n_nodes)]
    supervisors = []
    rng = np.random.default_rng(seed)

    def total(*names):
        return sum(r.counter(n) for r in recorders for n in names)

    def fleet_bytes():
        # every byte once, at its sender
        return total("sync.bytes_sent", "digest.bytes_sent")

    try:
        addrs = [n.serve() for n in nodes]
        policy = BackoffPolicy(base_s=0.005, cap_s=0.05, max_retries=2)
        for i in range(n_nodes):
            supervisors.append(SyncSupervisor(
                nodes[i], [addrs[j] for j in range(n_nodes) if j != i],
                policy=policy, sync_timeout_s=5.0, fanout=1, interval_s=0.0,
                sync_mode=sync_mode, recorder=recorders[i],
                seed=seed * 100 + i))

        def lockstep():
            for sup in supervisors:
                sup.sync_round()
            wait_served(nodes)

        def converged():
            m0 = set(nodes[0].members().tolist())
            vv0 = nodes[0].vv()
            return all(set(n.members().tolist()) == m0
                       and np.array_equal(n.vv(), vv0) for n in nodes[1:])

        def inject(n_ops):
            for _ in range(n_ops):
                node = nodes[int(rng.integers(n_nodes))]
                if rng.random() < 0.35:
                    members = node.members()
                    if len(members):
                        node.delete(int(rng.choice(members)))
                        continue
                node.add(int(rng.integers(n_elements)))

        inject(2 * n_nodes)
        for _ in range(settle_rounds):
            lockstep()
            if converged():
                break
        if not converged():
            raise AssertionError(f"sync fleet ({sync_mode}, {device}) failed "
                                 "to converge on its seed state")
        b0 = fleet_bytes()
        measured = 0
        for _ in range(traffic_rounds):
            inject(ops_per_round)
            lockstep()
            measured += 1
        settle = 0
        while not converged() and settle < settle_rounds:
            lockstep()
            measured += 1
            settle += 1
        conv = converged()
        divergent_bytes = fleet_bytes() - b0
        # every quiescent number is a window delta
        bq, lanes0 = fleet_bytes(), total("digest.lanes_sent")
        q0, fb0 = total("digest.quiescent"), total("digest.fallback_delta")
        for _ in range(quiescent_rounds):
            lockstep()
        stats = {
            "sync_mode": sync_mode, "converged": conv, "rounds": measured,
            "settle_rounds": settle, "bytes": divergent_bytes,
            "bytes_per_round": round(divergent_bytes / max(1, measured), 1),
            "quiescent_bytes_per_round": round(
                (fleet_bytes() - bq) / max(1, quiescent_rounds), 1),
            "quiescent_state_lanes": total("digest.lanes_sent") - lanes0,
            "quiescent_exchanges": total("digest.quiescent") - q0,
            "delta_fallbacks": total("digest.fallback_delta") - fb0,
        }
        states = [type(s)(*(x.cpu() for x in s))
                  for s in (n.state_slice() for n in nodes)]
        return stats, states
    finally:
        for sup in supervisors:
            sup.stop(timeout=1.0)
        for n in nodes:
            n.close()


def chaos_leg(quick: bool, max_rounds: int, detect_races: bool,
              device: str, sync_mode: str = "digest",
              seed: int = 11) -> Dict[str, object]:
    """The sync curve's chaos leg: the digest regime behind the fault
    proxy at CHAOS_SEVERITY, node 0 partitioned for rounds 0-2."""
    return run_scenario(
        n_nodes=4 if quick else 6, n_elements=32 if quick else 60,
        drop_rate=CHAOS_SEVERITY, truncate_rate=CHAOS_SEVERITY / 2,
        duplicate_rate=0.1, seed=seed, max_rounds=max_rounds,
        partition_rounds=(0, 2), detect_races=detect_races,
        sync_mode=sync_mode, device=device)


def run_sync_curve(args) -> int:
    """The sync-curve sweep: the quiescent and divergent legs at each
    op rate in both regimes (the digest regime's bytes below the δ
    ladder's, no state lanes while quiescent), then the chaos leg
    (converged, race-free with --detect-races)."""
    if args.quick:
        n_nodes, n_elements = 4, 256
        rates = [4]
        traffic_rounds, quiescent_rounds = 5, 4
    else:
        n_nodes, n_elements = 5, 512
        rates = [2, 8]
        traffic_rounds, quiescent_rounds = 8, 6
    device = device_label(args.device)

    t0 = time.time()
    legs = []
    ok = True
    for rate in rates:
        pair = {}
        for mode in ("digest", "delta"):
            pair[mode], _ = run_traffic_leg(
                mode, n_nodes, n_elements, rate, traffic_rounds,
                seed=17, quiescent_rounds=quiescent_rounds,
                device=args.device)
            print(json.dumps({"rate": rate, **{
                k: pair[mode][k] for k in
                ("sync_mode", "converged", "bytes_per_round",
                 "quiescent_bytes_per_round",
                 "quiescent_state_lanes")}}), flush=True)
        win = (pair["digest"]["bytes_per_round"]
               < pair["delta"]["bytes_per_round"])
        q_win = (pair["digest"]["quiescent_bytes_per_round"]
                 < pair["delta"]["quiescent_bytes_per_round"])
        leg_ok = (pair["digest"]["converged"]
                  and pair["delta"]["converged"] and win and q_win
                  and pair["digest"]["quiescent_state_lanes"] == 0)
        ok = ok and leg_ok
        legs.append({
            "ops_per_round": rate,
            "digest": pair["digest"],
            "delta": pair["delta"],
            "digest_bytes_below_delta": win,
            "quiescent_bytes_below_delta": q_win,
            "ok": leg_ok,
        })

    chaos = chaos_leg(args.quick, args.max_rounds, args.detect_races,
                      args.device)
    ok = ok and chaos["converged"]
    if args.detect_races:
        ok = ok and not chaos["races"]
    print(json.dumps({"chaos": {
        "converged": chaos["converged"], "rounds": chaos["rounds"],
        "races": len(chaos["races"])}}), flush=True)

    quiescent_leg = legs[0]
    artifact = {
        "metric": ("digest-sync bytes-on-the-wire per converged round "
                   "vs the δ ladder at the same seeded divergence "
                   f"rate ({n_nodes}-node Node fleet, lockstep "
                   "supervisor rounds; plus convergence under "
                   "ChaosProxy faults with the digest regime active)"),
        "value": quiescent_leg["digest"]["quiescent_bytes_per_round"],
        "unit": "bytes/quiescent round (digest regime, fleet-wide)",
        "fleet": {"nodes": n_nodes, "elements": n_elements,
                  "group_lanes": 64, "quick": bool(args.quick)},
        "quiescent": {
            "digest_bytes_per_round":
                quiescent_leg["digest"]["quiescent_bytes_per_round"],
            "delta_bytes_per_round":
                quiescent_leg["delta"]["quiescent_bytes_per_round"],
            "digest_state_lanes":
                quiescent_leg["digest"]["quiescent_state_lanes"],
            "digest_exchanges":
                quiescent_leg["digest"]["quiescent_exchanges"],
        },
        "divergent": legs,
        "chaos": {
            "severity": CHAOS_SEVERITY,
            "converged": chaos["converged"],
            "rounds": chaos["rounds"],
            "faults_injected": chaos["faults"],
            "breaker_transitions": chaos["breaker"],
            "retries": chaos["retries"],
        },
        "elapsed_s": round(time.time() - t0, 1),
        "device": device,
    }
    if args.detect_races:
        artifact["race_detection"] = {
            "enabled": True,
            "races": sorted(chaos["races"]),
        }
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
        f.write("\n")
    print(f"wrote {args.out}")
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# the chaos leg alone, held to the JAX leg's census
# ---------------------------------------------------------------------------


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


def census_equal(faults: Dict[str, int], ref: Dict[str, int]) -> bool:
    """The census against a reference census: every count the reference
    records equal, and no fault kind beyond them fired (its artifact
    predates the proxy's ``severed`` count)."""
    return all(faults.get(k, 0) == v for k, v in ref.items()) and all(
        v == 0 for k, v in faults.items() if k not in ref)


def run_chaos_leg(args) -> int:
    run = chaos_leg(args.quick, args.max_rounds, args.detect_races,
                    args.device, sync_mode=args.sync_mode, seed=args.seed)
    ref = reference_census(args.reference)
    want_kinds = [k for k in FAULT_KINDS
                  if ref is not None and ref["faults_injected"].get(k, 0) > 0]
    missing = [k for k in want_kinds if run["faults"].get(k, 0) == 0]
    # the JAX leg ran the full fleet: only then is its census the same
    # run's
    equal = (None if args.quick else
             ref is not None and census_equal(run["faults"],
                                              ref["faults_injected"]))
    n_nodes, n_elements = (4, 32) if args.quick else (6, 60)
    result = {"nodes": n_nodes, "elements": n_elements,
              "severity": CHAOS_SEVERITY, "seed": args.seed,
              "sync_mode": args.sync_mode,
              "device": device_label(args.device),
              **run,
              "reference": (None if ref is None else {
                  "rounds": ref.get("rounds"),
                  "faults_injected": ref.get("faults_injected")}),
              "fault_kinds_expected": want_kinds,
              "fault_kinds_missing": missing,
              "census_equal": equal}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
            f.write("\n")
    ok = (run["converged"] and ref is not None and not missing
          and equal is not False)
    if args.detect_races:
        ok = ok and not run["races"]
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# the severity curve
# ---------------------------------------------------------------------------


def severity_curve(n_nodes: int, n_elements: int, n_seeds: int,
                   severities, max_rounds: int, detect_races: bool,
                   device: str) -> List[Dict[str, object]]:
    """One curve entry per severity over ``n_seeds`` seeded runs (seed
    11 + s): severity drives the drop and truncation odds, and every
    faulted severity also gets duplicates and a partition episode."""
    curve = []
    for sev in severities:
        runs = [run_scenario(
            n_nodes, n_elements, drop_rate=sev, truncate_rate=sev / 2,
            duplicate_rate=0.1 if sev > 0 else 0.0, seed=11 + s,
            max_rounds=max_rounds,
            partition_rounds=(0, 2) if sev > 0 else None,
            detect_races=detect_races, device=device)
            for s in range(n_seeds)]
        rounds = [r["rounds"] for r in runs if r["converged"]]
        faults: Dict[str, int] = {}
        breaker: Dict[str, int] = {}
        for r in runs:
            for k, v in r["faults"].items():
                faults[k] = faults.get(k, 0) + v
            for k, v in r["breaker"].items():
                breaker[k] = breaker.get(k, 0) + v
        entry = {
            "drop_rate": sev,
            "truncate_rate": sev / 2,
            "converged_runs": len(rounds),
            "seeds": n_seeds,
            "rounds_min": min(rounds) if rounds else None,
            "rounds_median": (int(statistics.median(rounds))
                              if rounds else None),
            "rounds_max": max(rounds) if rounds else None,
            "faults_injected": faults,
            "breaker_transitions": breaker,
            "retries": sum(r["retries"] for r in runs),
        }
        if detect_races:
            entry["races"] = sorted({race for r in runs
                                     for race in r["races"]})
        curve.append(entry)
        print(json.dumps({"severity": sev, **{
            k: entry[k] for k in ("rounds_median", "converged_runs",
                                  "retries")},
            "wall_s": [r["wall_s"] for r in runs]}), flush=True)
    return curve


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true",
                    help="the CI-sized sweep (4 nodes x 32 elements, "
                         "severities 0 and 0.25, one seed)")
    ap.add_argument("--nodes", type=int, default=None)
    ap.add_argument("--elements", type=int, default=None)
    ap.add_argument("--seeds", type=int, default=None)
    ap.add_argument("--max-rounds", dest="max_rounds", type=int,
                    default=60)
    ap.add_argument("--detect-races", dest="detect_races",
                    action="store_true",
                    help="run the fleet under the lockset race detector "
                         "(analysis/locksets.py); findings land in the "
                         "artifact and fail the sweep")
    ap.add_argument("--sync-curve", dest="sync_curve", action="store_true",
                    help="the digest-sync bytes-on-the-wire sweep instead "
                         "of the severity curve: quiescent and divergent "
                         "digest-vs-δ legs plus the digest chaos leg")
    ap.add_argument("--chaos-leg", dest="chaos_leg", action="store_true",
                    help="the digest chaos leg alone, its census held "
                         "against --reference")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the nodes (default cuda, which "
                         "raises without a GPU; cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("--sync-mode", dest="sync_mode", default="digest",
                    choices=("digest", "delta"),
                    help="--chaos-leg: the fleet's sync regime")
    ap.add_argument("--seed", type=int, default=11,
                    help="--chaos-leg: the proxies' and supervisors' seed")
    ap.add_argument("--reference",
                    default=os.path.join(REPO, "SYNC_CURVE.json"),
                    help="--chaos-leg: the JAX leg's artifact (its "
                         "`chaos` census)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.chaos_leg:
        return run_chaos_leg(args)
    if args.out is None:
        args.out = os.path.join(
            REPO, "SYNC_CURVE_TORCH.json" if args.sync_curve
            else "CHAOS_CURVE_TORCH.json")
    if args.sync_curve:
        return run_sync_curve(args)

    if args.quick:
        n_nodes = args.nodes or 4
        n_elements = args.elements or 32
        n_seeds = args.seeds or 1
        severities = [0.0, 0.25]
    else:
        n_nodes = args.nodes or 6
        n_elements = args.elements or 60
        n_seeds = args.seeds or 3
        severities = [0.0, 0.1, 0.2, 0.3, 0.4]
    device = device_label(args.device)

    t0 = time.time()
    curve = severity_curve(n_nodes, n_elements, n_seeds, severities,
                           args.max_rounds, args.detect_races, args.device)
    artifact = {
        "metric": ("socket-level rounds-to-convergence vs fault severity "
                   f"({n_nodes}-node Node fleet behind ChaosProxy, "
                   "SyncSupervisor retries+breakers, lockstep rounds)"),
        "value": next((e["rounds_median"] for e in curve
                       if e["drop_rate"] == 0.0), None),
        "unit": "rounds (at severity 0)",
        "fleet": {"nodes": n_nodes, "elements": n_elements,
                  "quick": bool(args.quick)},
        "curve": curve,
        "elapsed_s": round(time.time() - t0, 1),
        "device": device,
    }
    if args.detect_races:
        artifact["race_detection"] = {
            "enabled": True,
            "races": sorted({race for e in curve
                             for race in e.get("races", [])}),
        }
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
        f.write("\n")
    print(f"wrote {args.out}")
    # a sweep where any severity failed to converge (or, with detection
    # on, any lockset race) is a failure, not a curve
    ok = all(e["converged_runs"] == e["seeds"] for e in curve)
    if args.detect_races:
        ok = ok and not artifact["race_detection"]["races"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
