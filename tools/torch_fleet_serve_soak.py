#!/usr/bin/env python3
"""Sharded-fleet soak for the port: the legs of tools/fleet_serve_soak.py
against the port's processes — N ``python -m go_crdt_playground_tpu_torch
serve --ingest --device D`` shards behind a ``router --serve`` of the same
package (real subprocesses, not imports), driven through an unmodified
``ServeClient``.

* **default sweep** — fixed offered load through the router at each
  shard count (goodput, p99, typed sheds; every submitted op resolves
  ack-or-typed-reject), then the **kill leg** (SIGKILL one shard
  mid-stream: its keyspace rejects typed ``ShardUnavailable`` while the
  others ack; restart, resubmit, zero acked-op loss, zero phantoms), the
  **reshard leg** (a join whose recipient dies mid-handoff aborts typed
  with the old ring serving; the ``reshard`` CLI's join moves exactly
  ``ring.remap_fraction``'s slice; a leave restores the digest) and the
  **chaos leg** (a seeded ``ChaosProxy`` on one router↔shard link: torn
  frames, a partition, heal).
* ``--router-ha`` — SIGKILL the primary router mid-stream: the warm
  standby promotes within its budget onto the committed ring under a
  bumped router epoch; an autopilot rides the failover; the resurrected
  old primary is refused typed ``StaleRouterEpoch``.
* ``--shard-repl`` — two replication groups (primary + WAL-tailing warm
  standby): chaos on the replication link, a mid-stream primary SIGKILL
  with no restart, a quiesced kill whose promoted replica equals the
  ``restore_durable`` of the dead primary's disk byte for byte, and a
  resurrected old primary that boots self-fenced.
* ``--autopilot`` — a real ``autopilot`` subprocess splits a
  flash-crowded keyspace onto standby shards, survives its own SIGKILL,
  resumes from the router's committed ring and drains cold.

The legs, seeds (29), sizes and budgets are tools/fleet_serve_soak.py's,
and so is the adjudication, check for check: each check is named, and
those of the guarantees (zero lost acked ops, zero phantoms, every op
resolved, typed aborts with the old ring serving, bounded promotion, the
epoch fences, the bitwise promotion) are told apart from the load-shape
checks; a name is ``<leg>/<check>`` (goodput floors, an outage or a split really observed, fence
windows).  One departure: the autopilot's shards batch one op, and
its rates scale by the offered rate that saturates one such shard
(``heat_rate``), so that the flash crowd heats a shard on either
device, as the reference's rates heat its 250 ops/s shards.
* ``--mesh`` — ``serve --mesh-devices N`` (1-D) and ``DPxMP`` (2-D)
  workers behind the router: goodput and p99 per width, the dp ladder's
  rows per dispatch, a worker and a reference worker fed one op log
  bitwise equal after a drain (1-D against a plain worker, 2-D against
  1-D), and a SIGKILL + ``restore_durable`` crash leg per flavor.
* ``--zipf`` — the admission scheduler under hot-key skew: scheduled
  dp-ladder legs at zipf exponents 0.99 and 1.2, an unscheduled
  (``--sched off``) baseline at the widest dp, cuts per super-batch
  at least 5x fewer with the scheduler, and a SIGKILL replay leg whose
  durable log replays bitwise through a plain node and the mesh class.
Shards run on ``--device`` (default cuda); the router, its standby and
the autopilot are host-only.  A mesh worker's slots follow the device
(mesh.take_devices); given ``cuda`` they all take card 0, so on one
card every slot of a worker shares it, and the result says so
(``slots_device``).

Usage:
    python tools/torch_fleet_serve_soak.py [--quick] [--device cuda|cpu]
        [--router-ha | --shard-repl | --autopilot | --mesh | --zipf]
        [--out FILE]

Prints one JSON line per leg and, at the end, one ``checks`` line.
Exits nonzero when any check fails; ``--out`` writes the result with
the failed checks (``failures``) and, among them, those of the
guarantees (``guarantee_failures``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import socket
import sys
import tempfile
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Set, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import workloads  # noqa: E402  (tools/workloads.py: named seeded pickers)

from go_crdt_playground_tpu_torch.serve import protocol  # noqa: E402
from go_crdt_playground_tpu_torch.serve.client import \
    ServeClient  # noqa: E402
from go_crdt_playground_tpu_torch.shard.fleet import (  # noqa: E402
    FleetSpec, ShardFleet)

# torch device of every shard the soak spawns (``--device``)
DEVICE = "cuda"


def _spec(**kw) -> FleetSpec:
    return FleetSpec(device=DEVICE, **kw)


# ---------------------------------------------------------------------------
# open-loop load (tools/serve_soak.py's generator)
# ---------------------------------------------------------------------------


def _pctl(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    xs = sorted(values)
    return xs[min(len(xs) - 1, int(q * (len(xs) - 1) + 0.5))]


def _r(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v * 1e3, 2)


class _Tally:
    """Thread-safe completion tally for one load leg."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.latencies: List[float] = []  # guarded-by: lock
        self.acked = 0  # guarded-by: lock
        self.overloaded = 0  # guarded-by: lock
        self.expired = 0  # guarded-by: lock
        self.other = 0  # guarded-by: lock

    def on_result(self, op) -> None:
        with self.lock:
            if op.acked:
                self.acked += 1
                self.latencies.append(op.latency_s)
            elif isinstance(op.error, protocol.Overloaded):
                self.overloaded += 1
            elif isinstance(op.error, protocol.DeadlineExceeded):
                self.expired += 1
            else:
                self.other += 1


def open_loop_leg(addr, rate: float, duration_s: float, elements: int,
                  n_conns: int = 4, deadline_s: float = 1.0,
                  del_every: int = 10,
                  keys: Optional[workloads.KeyPicker] = None,
                  ledgered: bool = False) -> Dict[str, object]:
    """Offer ops at ``rate`` for ``duration_s`` (pipelined, paced), keys
    from ``keys`` (default ``uniform-cycle``); goodput, typed sheds and
    client-side latency.  ``ledgered`` adds the per-element ack ledger
    (``submitted_elements`` / ``acked_elements``), walked after every op
    resolved."""
    if keys is None:
        keys = workloads.CycleKeys(elements)
    ledger: List[Tuple[int, int, object]] = []  # (kind, element, op)
    tally = _Tally()
    clients = [ServeClient(addr, timeout=30.0, on_result=tally.on_result)
               for _ in range(n_conns)]
    submitted = 0
    send_errors = 0
    t0 = time.monotonic()
    try:
        i = 0
        while True:
            now = time.monotonic()
            if now - t0 >= duration_s:
                break
            target_t = t0 + i / rate
            if target_t > now:
                time.sleep(target_t - now)
            kind = (protocol.OP_DEL
                    if del_every and i % del_every == del_every - 1
                    else protocol.OP_ADD)
            e = keys.pick(i, (now - t0) / duration_s)
            try:
                op = clients[i % n_conns].submit_async(
                    kind, [e], deadline_s=deadline_s)
                submitted += 1
                if ledgered:
                    ledger.append((kind, e, op))
            except (OSError, ConnectionError):
                send_errors += 1
            i += 1
        elapsed = time.monotonic() - t0  # offer window (goodput basis)
        # grace: let every in-flight op resolve while the server makes
        # progress, so the next leg starts against an idle fleet
        grace_cap = time.monotonic() + 120.0
        last_done, last_progress = -1, time.monotonic()
        while time.monotonic() < grace_cap:
            with tally.lock:
                done = (tally.acked + tally.overloaded + tally.expired
                        + tally.other)
            if done >= submitted:
                break
            if done > last_done:
                last_done, last_progress = done, time.monotonic()
            elif time.monotonic() - last_progress > 10.0:
                break  # stalled: count the remainder as unresolved
            time.sleep(0.05)
    finally:
        for c in clients:
            c.close()
    server = None
    try:
        with ServeClient(addr, timeout=30.0) as sc:
            snap = sc.stats()
        lat = snap["observations"].get("serve.ingest_latency_s", {})
        server = {
            "ingest_p50_ms": _r(lat.get("p50")),
            "ingest_p99_ms": _r(lat.get("p99")),
            "acked_total": snap["counters"].get("serve.ops.acked", 0),
            "shed_overload_total": snap["counters"].get(
                "serve.shed.overload", 0),
            "batch_occupancy_mean": round(
                snap["observations"].get("serve.batch.occupancy", {})
                .get("mean", 0.0), 2),
        }
    except (OSError, ConnectionError):
        pass
    extra: Dict[str, object] = {}
    if ledgered:
        extra["submitted_elements"] = sorted(
            {e for k, e, _ in ledger if k == protocol.OP_ADD})
        extra["acked_elements"] = sorted(
            {e for k, e, op in ledger
             if k == protocol.OP_ADD and op.acked})
        extra["acked_deletes"] = sorted(
            {e for k, e, op in ledger
             if k == protocol.OP_DEL and op.acked})
    with tally.lock:
        shed = tally.overloaded
        resolved = tally.acked + shed + tally.expired + tally.other
        return {
            "workload": keys.name,
            **extra,
            "offered_rate": rate,
            "achieved_offer_rate": round(submitted / elapsed, 1),
            "submitted": submitted,
            "goodput": round(tally.acked / elapsed, 1),
            "acked": tally.acked,
            "shed_overloaded": shed,
            "shed_expired": tally.expired,
            "other_failures": tally.other,
            "send_errors": send_errors,
            "unresolved": submitted - resolved,
            "shed_rate": round(shed / submitted, 4) if submitted else 0.0,
            "p50_ms": _r(_pctl(tally.latencies, 0.50)),
            "p95_ms": _r(_pctl(tally.latencies, 0.95)),
            "p99_ms": _r(_pctl(tally.latencies, 0.99)),
            "server": server,  # cumulative-since-start SLO snapshot
        }


# ---------------------------------------------------------------------------
# shard sweep
# ---------------------------------------------------------------------------


def sweep_leg(root: str, n_shards: int, elements: int, rate: float,
              duration_s: float, seed: int) -> Dict[str, object]:
    """One shard count's open-loop point, driven through the router."""
    spec = _spec(n_shards=n_shards, elements=elements, seed=seed)
    fleet = ShardFleet(REPO, os.path.join(root, f"sweep-{n_shards}"), spec)
    try:
        addr = fleet.start()
        leg = open_loop_leg(addr, rate, duration_s, elements)
        leg["shards"] = n_shards
        return leg
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# kill leg
# ---------------------------------------------------------------------------


def kill_leg(root: str, n_shards: int, elements: int,
             seed: int) -> Dict[str, object]:
    """Ledgered workload across a SIGKILL+restart of one shard (module
    docstring).  Returns the adjudication."""
    import random

    rng = random.Random(seed)
    spec = _spec(n_shards=n_shards, elements=elements, seed=seed)
    fleet = ShardFleet(REPO, os.path.join(root, "kill"), spec)
    acked: Set[int] = set()
    submitted: Set[int] = set()
    outage = {"acked_survivor": 0, "typed_unavailable": 0,
              "typed_other": 0, "unresolved": 0}
    victim = 1 % n_shards
    try:
        addr = fleet.start()
        victim_owned = set(fleet.owned_elements(victim))
        todo = workloads.shuffled_universe(elements, seed, rng=rng)
        # phase 1: ~40% of the keyspace lands before the kill, so the
        # ledger holds acks the victim must NOT lose across SIGKILL
        n_pre = int(0.4 * len(todo))
        kill_at = n_pre + 1 + rng.randrange(max(1, len(todo) // 10))
        client = ServeClient(addr, timeout=30.0)
        killed = False
        try:
            for n, e in enumerate(todo):
                if n == kill_at:
                    fleet.kill_shard(victim)
                    t_kill = time.monotonic()
                    killed = True
                submitted.add(e)
                try:
                    client.add(e, deadline_s=5.0)
                    acked.add(e)
                    if killed:
                        outage["acked_survivor"] += 1
                except protocol.ShardUnavailable:
                    outage["typed_unavailable"] += 1
                except protocol.ServeError:
                    outage["typed_other"] += 1
                except (OSError, ConnectionError, socket.timeout):
                    # through the router this must not happen (it
                    # relays typed rejects even for in-flight deaths);
                    # counted, adjudicated to zero
                    outage["unresolved"] += 1
        finally:
            client.close()
        victim_acked_before_kill = sorted(acked & victim_owned)

        # restart the victim on its original port/durable dir, then
        # resubmit everything un-acked until the whole keyspace is in
        fleet.restart_shard(victim)
        t_restarted = time.monotonic()
        t_victim_back = None
        retry_deadline = time.monotonic() + 60.0
        remaining = [e for e in todo if e not in acked]
        retries = 0
        while remaining and time.monotonic() < retry_deadline:
            client = ServeClient(addr, timeout=30.0)
            try:
                still: List[int] = []
                for e in remaining:
                    try:
                        client.add(e, deadline_s=5.0)
                        acked.add(e)
                        if t_victim_back is None and e in victim_owned:
                            t_victim_back = time.monotonic()
                    except (protocol.ServeError, OSError, ConnectionError,
                            socket.timeout):
                        still.append(e)
                remaining = still
            finally:
                client.close()
            if remaining:
                retries += 1
                time.sleep(0.25)  # breaker half-open probe cadence

        # final read: the fleet union through the router
        with ServeClient(addr, timeout=60.0) as c:
            members, vv = c.members()
        members_set = set(members)
        return {
            "shards": n_shards,
            "elements": elements,
            "workload": workloads.SHUFFLED_UNIVERSE,
            "victim": fleet.sid(victim),
            "victim_keyspace": len(victim_owned),
            "victim_acked_before_kill": len(victim_acked_before_kill),
            "outage": outage,
            # the victim's keyspace dark: SIGKILL to the restart's
            # banner, and to its first ack through the router
            "outage_s": {"to_restart": round(t_restarted - t_kill, 3),
                         "to_first_ack": (None if t_victim_back is None
                                          else round(t_victim_back
                                                     - t_kill, 3))},
            "resubmit_rounds": retries,
            "acked_ops": len(acked),
            "submitted_ops": len(submitted),
            "final_members": len(members_set),
            # MUST be []: an op acked (fsync'd on its shard) vanished —
            # acked ⊇ the pre-restart ledger, so this covers the kill
            "lost_acked_ops": sorted(acked - members_set),
            # MUST be []: a member nobody submitted
            "phantom_members": sorted(members_set - submitted),
            "unfinished": sorted(set(todo) - acked),
        }
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# reshard leg (live resharding, DESIGN.md §18)
# ---------------------------------------------------------------------------


class _Traffic(threading.Thread):
    """Ledgered add-only load through the router while the ring
    reshapes: every element is submitted until acked; typed rejects
    requeue (the protocol contract), transport errors count as
    UNRESOLVED (through the router they must never happen) and requeue
    so the leg still finishes."""

    def __init__(self, addr, elements: int, seed: int):
        super().__init__(daemon=True)
        from collections import deque

        todo = workloads.shuffled_universe(elements, seed)
        self.addr = addr
        self.todo = deque(todo)
        self.acked: Set[int] = set()
        self.submitted: Set[int] = set()
        self.counts = {"typed_moving": 0, "typed_unavailable": 0,
                       "typed_other": 0, "unresolved": 0}
        self.stop_when_drained = threading.Event()

    def run(self) -> None:
        client = ServeClient(self.addr, timeout=30.0)
        try:
            while True:
                if not self.todo:
                    if self.stop_when_drained.is_set():
                        return
                    time.sleep(0.01)
                    continue
                e = self.todo.popleft()
                self.submitted.add(e)
                try:
                    client.add(e, deadline_s=5.0)
                    self.acked.add(e)
                except protocol.KeyspaceMoving:
                    self.counts["typed_moving"] += 1
                    self.todo.append(e)
                    time.sleep(0.01)  # the fence is brief; back off a tick
                except protocol.ShardUnavailable:
                    self.counts["typed_unavailable"] += 1
                    self.todo.append(e)
                    time.sleep(0.05)
                except protocol.ServeError:
                    self.counts["typed_other"] += 1
                    self.todo.append(e)
                    time.sleep(0.01)  # never hot-spin a persistent reject
                except (OSError, ConnectionError, socket.timeout):
                    self.counts["unresolved"] += 1
                    self.todo.append(e)
                    try:
                        client.close()
                    except Exception:  # noqa: BLE001
                        pass
                    client = ServeClient(self.addr, timeout=30.0)
        finally:
            client.close()

    def drain(self, timeout_s: float) -> bool:
        self.stop_when_drained.set()
        self.join(timeout=timeout_s)
        return not self.is_alive() and not self.todo


def _ring_info(addr) -> Dict[str, object]:
    with ServeClient(addr, timeout=30.0) as c:
        return c.stats()["ring"]


def _cli_reshard(repo: str, addr, args: List[str]) -> Dict[str, object]:
    """Run the OPERATOR surface — the ``reshard`` CLI subprocess — and
    parse its JSON verdict."""
    import subprocess

    argv = [sys.executable, "-m", "go_crdt_playground_tpu_torch", "reshard",
            "--router", f"{addr[0]}:{addr[1]}"] + args
    proc = subprocess.run(argv, cwd=repo, capture_output=True,
                          text=True, timeout=300)
    try:
        out = json.loads(proc.stdout)
    except ValueError:
        out = {"ok": False,
               "detail": {"reason": f"CLI emitted no JSON "
                                    f"(rc={proc.returncode}): "
                                    f"{proc.stdout[:200]!r} "
                                    f"{proc.stderr[-200:]!r}"}}
    out["cli_rc"] = proc.returncode
    return out


def reshard_leg(root: str, elements: int, seed: int,
                quick: bool) -> Dict[str, object]:
    """Live join/leave under traffic with kill-mid-handoff fault
    injection (module docstring).  Returns the adjudication."""
    from go_crdt_playground_tpu_torch.shard.ring import HashRing, remap_fraction

    # actors=4: lanes for the 2 initial shards + the joiner (index 2)
    spec = _spec(n_shards=2, elements=elements, seed=seed, actors=4)
    fleet = ShardFleet(REPO, os.path.join(root, "reshard"), spec,
                       router_state_dir=os.path.join(root, "reshard",
                                                     "router-state"))
    events: List[Dict[str, object]] = []
    try:
        addr = fleet.start()
        traffic = _Traffic(addr, elements, seed)
        traffic.start()
        # let a baseline land before the first membership change
        while len(traffic.acked) < elements // 4:
            time.sleep(0.05)
        ring0 = _ring_info(addr)

        # (1) kill-mid-handoff: the RECIPIENT dies on the first slice
        # push -> the join must abort typed and the old ring keep
        # serving (same generation + digest)
        fleet.launch_shard(2, crash_on_slice="push")
        with ServeClient(addr, timeout=120.0) as c:
            ok, detail = c.reshard(
                protocol.RESHARD_JOIN, fleet.sid(2),
                ("127.0.0.1", fleet.shard_ports[2]), timeout=120.0)
        joiner = fleet.shards[2]
        joiner.proc.wait(timeout=30)  # the hook SIGKILLed it
        ring_after_abort = _ring_info(addr)
        events.append({
            "event": "join_recipient_killed_mid_handoff",
            "ok": ok, "detail": detail,
            "joiner_died": joiner.proc.poll() is not None,
            "ring_unchanged": (
                ring_after_abort["generation"] == ring0["generation"]
                and ring_after_abort["digest"] == ring0["digest"]),
        })
        joiner.close()
        fleet.shards[2] = None

        # (2) the real join, via the CLI admin verb (operator surface);
        # cross-process remap prediction from the ring math
        fleet.launch_shard(2)
        before_ring = HashRing([fleet.sid(i) for i in range(2)], seed=seed)
        after_ring = before_ring.with_shard(fleet.sid(2))
        predicted = remap_fraction(
            before_ring.owner_map(elements), after_ring.owner_map(elements),
            before_ring.shards, after_ring.shards)["fraction"]
        verdict = _cli_reshard(
            REPO, addr,
            ["--join",
             f"{fleet.sid(2)}=127.0.0.1:{fleet.shard_ports[2]}"])
        detail = verdict.get("detail", {})
        ring1 = _ring_info(addr)
        events.append({
            "event": "join_committed_via_cli",
            "ok": verdict.get("ok", False),
            "cli_rc": verdict.get("cli_rc"),
            "observed_fraction": detail.get("fraction"),
            "predicted_fraction": predicted,
            "fence_s": detail.get("fence_s"),
            "moved": detail.get("moved"),
            "generation": ring1["generation"],
            "digest_changed": ring1["digest"] != ring0["digest"],
        })

        if not quick:
            # (3) donor death mid-handoff: restart shard 0 armed to die
            # on the next slice pull, attempt a leave of the joiner
            # (s0 is a recipient then — so arm the DONOR instead: the
            # joiner leave pulls from s2 only; use a second join/leave
            # cycle where s0 donates).  Simplest forced-donor case:
            # leave s0 itself — every transfer pulls FROM s0.
            ring_before_kill = _ring_info(addr)
            fleet.kill_shard(0)
            fleet.restart_shard(0, crash_on_slice="pull")
            with ServeClient(addr, timeout=120.0) as c:
                ok, detail = c.reshard(protocol.RESHARD_LEAVE,
                                       fleet.sid(0), timeout=120.0)
            donor = fleet.shards[0]
            donor.proc.wait(timeout=30)
            ring_after = _ring_info(addr)
            events.append({
                "event": "leave_donor_killed_mid_handoff",
                "ok": ok, "detail": detail,
                "donor_died": donor.proc.poll() is not None,
                "ring_unchanged": (
                    ring_after["generation"]
                    == ring_before_kill["generation"]
                    and ring_after["digest"]
                    == ring_before_kill["digest"]),
            })
            donor.close()
            fleet.shards[0] = None
            # s0's keyspace recovers from its WAL/checkpoints
            fleet.restart_shard(0)
            events.append({"event": "donor_restarted"})

        # (4) leave the joiner again — the slice transfers back
        with ServeClient(addr, timeout=120.0) as c:
            ok, detail = c.reshard(protocol.RESHARD_LEAVE, fleet.sid(2),
                                   timeout=120.0)
        ring2 = _ring_info(addr)
        events.append({
            "event": "leave_committed",
            "ok": ok, "fence_s": detail.get("fence_s"),
            "moved": detail.get("moved"),
            "generation": ring2["generation"],
            # same membership as birth => same owner map => same digest
            "digest_restored": ring2["digest"] == ring0["digest"],
        })

        # drain: every element must end acked through whatever ring
        finished = traffic.drain(timeout_s=120.0)
        with ServeClient(addr, timeout=60.0) as c:
            members, _ = c.members()
        members_set = set(members)
        return {
            "elements": elements,
            "events": events,
            "traffic": dict(traffic.counts),
            "acked_ops": len(traffic.acked),
            "finished": finished,
            "final_members": len(members_set),
            # MUST be []: an op acked (fsync'd on its then-owner)
            # vanished across a handoff
            "lost_acked_ops": sorted(traffic.acked - members_set),
            # MUST be []: a member nobody submitted
            "phantom_members": sorted(members_set - traffic.submitted),
            "unfinished": sorted(set(range(elements)) - traffic.acked),
        }
    finally:
        fleet.close()



# ---------------------------------------------------------------------------
# chaos leg: ChaosProxy on one router↔shard downstream link
# ---------------------------------------------------------------------------


def chaos_leg(root: str, elements: int, seed: int) -> Dict[str, object]:
    """Deterministic wire chaos on the DOWNSTREAM serve dialect: a
    ``ChaosProxy`` interposed between the router and one shard (the
    router's ``--shard`` flag points at the proxy).  Three phases over
    a ledgered add-only sweep: torn frames (every connection truncated
    mid-frame), asymmetric partition (inbound dials refused while the
    shard itself is healthy), heal.  The chaos legs before this one
    covered only the node-sync and client-ingest ports — the
    router↔shard link is the last un-injected hop.

    Adjudication: during chaos the victim keyspace degrades to typed
    ``ShardUnavailable`` (never silence — ``unresolved == 0``) while
    the other shard's keyspace keeps acking; after ``heal()`` the
    breaker's half-open probe re-admits the link and the resubmit
    sweep drains — zero acked-op loss, zero phantoms, whole keyspace
    in."""
    import random

    from go_crdt_playground_tpu_torch.net.faults import ChaosProxy
    from go_crdt_playground_tpu_torch.shard.fleet import (RouterProc, ShardProc,
                                                    free_port)

    rng = random.Random(seed + 5)
    spec = _spec(n_shards=2, elements=elements, seed=seed)
    base = os.path.join(root, "chaos")
    shards: List[ShardProc] = []
    proxy = None
    router = None
    acked: Set[int] = set()
    submitted: Set[int] = set()
    counts = {"typed_unavailable": 0, "typed_other": 0, "unresolved": 0,
              "acked_survivor_during_chaos": 0}
    try:
        ports = [free_port(), free_port()]
        for i in range(2):
            shards.append(ShardProc(
                REPO, os.path.join(base, f"s{i}"), spec, i, ports[i]))
        for s in shards:
            s.await_address()
        proxy = ChaosProxy(("127.0.0.1", ports[1]), seed=seed)
        addrs = {"s0": ("127.0.0.1", ports[0]),
                 "s1": ("127.0.0.1", proxy.port)}
        router = RouterProc(REPO, os.path.join(base, "router"), spec,
                            addrs, free_port())
        addr = router.await_address()

        todo = workloads.shuffled_universe(elements, seed, rng=rng)
        n = len(todo)
        torn_at, partition_at, heal_at = (int(0.25 * n), int(0.5 * n),
                                          int(0.75 * n))
        chaos_window = False
        client = ServeClient(addr, timeout=30.0)
        try:
            for i, e in enumerate(todo):
                if i == torn_at:
                    # sever AFTER the flip: the router's long-lived
                    # pipelined link re-dials into the new scenario
                    # (plans are drawn at accept)
                    proxy.set_scenario(truncate_rate=1.0)
                    proxy.sever()
                    chaos_window = True
                elif i == partition_at:
                    proxy.set_scenario(truncate_rate=0.0)
                    proxy.partition()
                    proxy.sever()
                    # hold the partition past the link's breaker
                    # cooldown AND its backoff cap (2s): the phases
                    # are op-index-anchored, and on a fast machine the
                    # window would otherwise close before a single
                    # half-open probe dial can land refused — the
                    # adjudication requires the partition to have
                    # REALLY refused someone, not merely been armed
                    time.sleep(2.5)
                elif i == heal_at:
                    proxy.heal()
                    chaos_window = False
                submitted.add(e)
                try:
                    client.add(e, deadline_s=5.0)
                    acked.add(e)
                    if chaos_window:
                        counts["acked_survivor_during_chaos"] += 1
                except protocol.ShardUnavailable:
                    counts["typed_unavailable"] += 1
                except protocol.ServeError:
                    counts["typed_other"] += 1
                except (OSError, ConnectionError, socket.timeout):
                    # through the router this must never happen — even
                    # chaos-torn downstream links relay typed rejects
                    counts["unresolved"] += 1
        finally:
            client.close()

        # breaker recovery: resubmit until the whole keyspace is in
        # (the half-open probe re-admits the healed link)
        retry_deadline = time.monotonic() + 60.0
        remaining = [e for e in todo if e not in acked]
        retries = 0
        while remaining and time.monotonic() < retry_deadline:
            client = ServeClient(addr, timeout=30.0)
            try:
                still: List[int] = []
                for e in remaining:
                    try:
                        client.add(e, deadline_s=5.0)
                        acked.add(e)
                    except (protocol.ServeError, OSError, ConnectionError,
                            socket.timeout):
                        still.append(e)
                remaining = still
            finally:
                client.close()
            if remaining:
                retries += 1
                time.sleep(0.25)  # breaker half-open probe cadence

        with ServeClient(addr, timeout=60.0) as c:
            members, _vv = c.members()
        members_set = set(members)
        return {
            "elements": elements,
            "outage": counts,
            "proxy": proxy.counters(),
            "resubmit_rounds": retries,
            "acked_ops": len(acked),
            # MUST be []: an acked op vanished across wire chaos
            "lost_acked_ops": sorted(acked - members_set),
            # MUST be []: a member nobody submitted (e.g. a duplicated
            # or garbled frame applied as a phantom op)
            "phantom_members": sorted(members_set - submitted),
            "unfinished": sorted(set(todo) - acked),
            "final_members": len(members_set),
        }
    finally:
        if router is not None:
            router.close()
        if proxy is not None:
            proxy.close()
        for s in shards:
            s.close()



# ---------------------------------------------------------------------------
# autopilot legs (fleet autopilot, DESIGN.md §21) — `--autopilot` mode
# ---------------------------------------------------------------------------


class _AutopilotProc:
    """One ``autopilot`` CLI subprocess (the REAL controller an
    operator runs) with its own banner handshake."""

    _ENGAGED_RE = re.compile(
        rb"autopilot engaged over router .*ring gen=(\d+).*"
        rb"adopted=(\[[^\]]*\])")

    def __init__(self, repo: str, dirpath: str, router_addr, standbys,
                 log_path: str, seed: int, flags: Dict[str, object]):
        from go_crdt_playground_tpu_torch.shard.fleet import _Proc

        os.makedirs(dirpath, exist_ok=True)
        # router_addr: one (host, port), or an ORDERED failover list
        # (primary first, then warm standbys — DESIGN.md §22)
        routers = (list(router_addr)
                   if isinstance(router_addr[0], (list, tuple))
                   else [router_addr])
        argv = [sys.executable, "-m", "go_crdt_playground_tpu_torch",
                "autopilot",
                "--decision-log", log_path, "--seed", str(seed)]
        for host, port in routers:
            argv += ["--router", f"{host}:{port}"]
        for sid, (host, port) in standbys:
            argv += ["--standby", f"{sid}={host}:{port}"]
        for flag, value in sorted(flags.items()):
            argv += [flag, str(value)]
        self.proc = _Proc(argv, cwd=repo,
                          log_path=os.path.join(dirpath, "autopilot.log"))
        self.banner: Dict[str, object] = {}

    def await_engaged(self, timeout_s: float = 60.0) -> Dict[str, object]:
        """Wait for the engagement banner (the shared ``_Proc``
        handshake, deadline enforced on non-matching lines too);
        returns the parsed resume facts (ring generation + adopted
        standbys) — what the controller-restart leg adjudicates
        resumption with."""
        m = self.proc.await_match(self._ENGAGED_RE, timeout_s)
        self.banner = {
            "generation": int(m.group(1)),
            "adopted": m.group(2).decode(),
        }
        return self.banner

    def sigkill(self) -> None:
        self.proc.sigkill()

    def close(self) -> None:
        self.proc.close()


# the per-shard capacity the reference's autopilot rates assume
REF_SHARD_CAPACITY = 250.0


def heat_rate(dirpath: str, spec: FleetSpec, watermark: float,
              start: float = REF_SHARD_CAPACITY / 2, factor: float = 1.25,
              steps: int = 12, step_s: float = 1.5) -> Dict[str, object]:
    """The lowest offered rate at which one shard of ``spec`` saturates:
    a throwaway one-shard fleet behind its router takes open-loop adds
    (the burn's path) at ``start`` ops/s, raised by ``factor`` a step,
    while a STATS client samples the shard's admission queue every
    0.1 s; the first step whose median depth reaches ``watermark`` (the
    controller's hot signal, held) names the rate.  Returns the rate
    and the ramp."""
    ramp: List[Dict[str, object]] = []
    fleet = ShardFleet(REPO, dirpath, dataclasses.replace(spec, n_shards=1))
    try:
        addr = fleet.start()
        shard = fleet.shard_addr_map()[fleet.sid(0)]
        rate = start
        for _ in range(steps):
            depths: List[float] = []
            halt = threading.Event()

            def sample() -> None:
                with ServeClient(shard, timeout=10.0) as c:
                    while not halt.wait(0.1):
                        depths.append(float(c.stats()["gauges"].get(
                            "serve.queue.depth", 0.0)))

            sampler = threading.Thread(target=sample, daemon=True)
            sampler.start()
            leg = open_loop_leg(addr, rate, step_s, spec.elements,
                                del_every=0, deadline_s=2.0)
            halt.set()
            sampler.join(timeout=10.0)
            depth = sorted(depths)[len(depths) // 2] if depths else 0.0
            ramp.append({"offered": round(rate, 1),
                         "goodput": leg["goodput"],
                         "shed": leg["shed_overloaded"],
                         "median_queue_depth": depth,
                         "max_queue_depth": max(depths, default=0.0)})
            if depth >= watermark:
                return {"heat_rate_ops_s": rate, "ramp": ramp}
            rate *= factor
    finally:
        fleet.close()
    raise RuntimeError(f"no offered rate up to {rate / factor:.0f} ops/s "
                       f"saturated one shard: {ramp}")


class _SignalSampler(threading.Thread):
    """Harness-side timeline: the SAME windowed-signal recipe the
    controller runs (control/signals.FleetSignals) against its own
    STATS client, one sample per ``interval_s`` — the convergence
    adjudication reads this record, not the controller's word."""

    def __init__(self, addr, interval_s: float = 1.0):
        super().__init__(daemon=True)
        from go_crdt_playground_tpu_torch.control.signals import FleetSignals

        self.addr = addr
        self.interval_s = interval_s
        self.signals = FleetSignals()
        self.samples: List[Dict] = []
        self._lock = threading.Lock()
        # NOT named _stop: threading.Thread has a private _stop METHOD
        # and shadowing it breaks join()
        self._halt = threading.Event()

    def run(self) -> None:
        client = None
        t0 = time.monotonic()
        while not self._halt.wait(self.interval_s):
            try:
                if client is None or client.closed:
                    client = ServeClient(self.addr, timeout=10.0,
                                         connect_timeout=2.0)
                view = self.signals.poll(client, time.monotonic() - t0)
                with self._lock:
                    self.samples.append(view.to_record())
            except (OSError, ConnectionError, socket.timeout):
                if client is not None:
                    client.close()
                    client = None
        if client is not None:
            client.close()

    def window(self, since_idx: int = 0) -> List[Dict]:
        with self._lock:
            return list(self.samples[since_idx:])

    def mark(self) -> int:
        with self._lock:
            return len(self.samples)

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=10.0)


def _converged(samples: List[Dict], *, p99_budget_ms: float,
               imbalance_budget: float, last_k: int = 6,
               need: int = 4) -> Dict[str, object]:
    """The convergence verdict over the LAST ``last_k`` samples: a
    sample is INSIDE when every reachable shard's windowed p99 is
    inside the budget and the offered op-rate imbalance inside its
    band; convergence needs ``need`` of the last ``last_k`` inside —
    sustained, but tolerant of the single-window fsync hiccups this
    filesystem is documented to throw (a one-poll spike is weather,
    not a burn: the policy itself needs ``hot_windows`` consecutive
    ones before it calls it heat).  Idle shards (p99 None) are inside
    by definition — no admitted ops is not a burn."""
    tail = samples[-last_k:] if len(samples) >= last_k else samples
    if not tail:
        return {"converged": False, "reason": "no samples"}
    verdicts = []
    worst_p99 = 0.0
    worst_imb = 0.0
    for s in tail:
        p99s = [sh["p99_ms"] for sh in s["per_shard"].values()
                if sh["reachable"] and sh["p99_ms"] is not None]
        imb = s["imbalance"]
        if p99s:
            worst_p99 = max(worst_p99, max(p99s))
        if imb is not None:
            worst_imb = max(worst_imb, imb)
        verdicts.append(
            all(p <= p99_budget_ms for p in p99s)
            and (imb is None or imb <= imbalance_budget))
    return {
        "converged": sum(verdicts) >= min(need, len(tail)),
        "samples": len(tail),
        "inside": sum(verdicts),
        "need": min(need, len(tail)),
        "worst_p99_ms": round(worst_p99, 2),
        "worst_imbalance": round(worst_imb, 3),
        "p99_budget_ms": p99_budget_ms,
        "imbalance_budget": imbalance_budget,
    }


def run_autopilot_mode(args) -> Dict[str, object]:
    """``--autopilot``: the closed-loop acceptance soak.  One real
    fleet (2 initial shards + 2 standby shard processes) behind a real
    router with a REAL ``autopilot`` CLI subprocess watching it:

    1. **baseline** — zipf traffic inside capacity: the controller
       must HOLD (no action at a healthy fleet);
    2. **burn** — a flash crowd lands on one initial shard's keyspace
       at a rate that saturates it: the controller must SPLIT the hot
       keyspace onto standby shard(s) through real fenced handoffs,
       under continuous ledgered traffic;
    3. **converge** — the same adversarial workload keeps running: the
       harness's own windowed signal timeline must come back inside
       the DECLARED budgets (per-shard windowed ingest p99, offered
       op-rate imbalance) after the controller's splits;
    4. **controller SIGKILL** — kill the autopilot mid-watch: the
       fleet must keep serving (acks flow, unresolved == 0 — the
       controller is an operator, never a dependency); a restarted
       controller must RESUME from the router's persisted committed
       ring (its banner adopts the deployed standbys; it never
       re-joins one);
    5. **cold drain** — traffic drops to a trickle: the restarted
       controller must MERGE (drain a standby its PREDECESSOR
       deployed — the resumption proof with teeth) via a live leave.

    Throughout: every submitted op resolves ack-or-typed-reject
    (unresolved == 0), zero acked-op loss, zero phantoms, and every
    ring-generation bump is present in the decision logs as a
    committed action WITH its triggering signals.

    Returns the result (checks_autopilot adjudicates it).
    """
    from go_crdt_playground_tpu_torch.control.controller import \
        read_decision_log
    from go_crdt_playground_tpu_torch.shard.ring import HashRing

    # Rate calibration: the burn must be a PER-SHARD bottleneck (queue
    # + fsync cadence), never a box-wide CPU one — more shard processes
    # on the same cores add no CPU, so a CPU-bound burn could never
    # converge no matter what the controller does.  The reference's
    # rates below assume a shard capped at ~REF_SHARD_CAPACITY ops/s
    # (max_batch=4 / flush_ms=5, 4 ops per ~15ms batch cycle on its
    # 2-core box); the burn aims the flash crowd's share of one shard
    # WELL past that while the fleet total stays inside the 4-shard
    # post-split capacity.  A torch shard at max_batch=4 on the card
    # absorbed the flash crowd's whole share (about 570 ops/s) with its
    # queue empty while the clients waited seconds in front of the
    # router, so no shard ever heated: the shards batch ONE op (the
    # batch bottleneck the reference chose, nearest its cap on either
    # device), and the rates scale by the offered rate that saturates
    # one such shard through a router (heat_rate), which keeps every
    # ratio the reference chose.
    if args.quick:
        elements = 192
        base_rate, burn_rate, cold_rate = 180.0, 400.0, 40.0
        baseline_s, burn_s, converge_s, outage_s, cold_s = \
            5.0, 16.0, 12.0, 6.0, 24.0
    else:
        elements = 288
        base_rate, burn_rate, cold_rate = 180.0, 430.0, 40.0
        baseline_s, burn_s, converge_s, outage_s, cold_s = \
            8.0, 22.0, 16.0, 8.0, 28.0

    # the declared budgets (checks_autopilot adjudicates against THESE).
    # The p99 budget is environment-honest: acks are fsync-backed and
    # this CI filesystem's fsync weather runs hundreds of ms at ANY
    # load (the serve soak's gate bounds server p99 at 2000ms for the
    # same reason) — 1500ms cleanly separates a real burn (queue-full
    # windowed p99 measured at 1.5-8s) from weather (calm-fleet
    # windows at 0.1-1s); the queue watermark is the crisp signal
    # (saturated shards sit at depth 50-60, calm ones at 0-12)
    p99_budget_ms = 1500.0
    queue_watermark = 32.0
    imbalance_budget = 2.5
    pilot_flags = {
        "--poll-interval": 0.5,
        "--p99-budget-ms": p99_budget_ms,
        "--queue-watermark": queue_watermark,
        "--hot-windows": 3,
        "--cold-windows": 6,
        "--cooldown": 4.0,
        "--abort-cooldown": 8.0,
        "--min-shards": 2,
        "--max-shards": 4,
        "--cold-rate": 150.0,
        "--reshard-timeout": 60.0,
    }

    t0 = time.time()
    root = tempfile.mkdtemp(prefix="autopilot-soak-")
    spec = _spec(n_shards=2, elements=elements, seed=args.seed,
                 actors=4, queue_depth=64, max_batch=1, flush_ms=5.0)
    fleet = ShardFleet(REPO, os.path.join(root, "fleet"), spec,
                       router_state_dir=os.path.join(root, "fleet",
                                                     "router-state"))
    result: Dict[str, object] = {}
    pilot = None
    sampler = None
    try:
        calibration = heat_rate(os.path.join(root, "calibrate"), spec,
                                queue_watermark)
        scale = calibration["heat_rate_ops_s"] / REF_SHARD_CAPACITY
        base_rate, burn_rate, cold_rate = (
            base_rate * scale, burn_rate * scale, cold_rate * scale)
        pilot_flags["--cold-rate"] = round(150.0 * scale, 1)
        calibration.update({
            "reference_capacity_ops_s": REF_SHARD_CAPACITY,
            "scale": scale,
            "rates_ops_s": {"base": base_rate, "burn": burn_rate,
                            "cold": cold_rate}})
        print(json.dumps({"calibration": calibration}), flush=True)
        addr = fleet.start()
        # standby shard PROCESSES: serving their ports, no keyspace
        standby_addrs = [(fleet.sid(i), fleet.launch_shard(i))
                         for i in (2, 3)]

        # the flash crowd aims at ONE keyspace: keys the initial ring
        # assigns to shard s1.  Among s1's keys, pick a hot set that
        # the POST-SPLIT ring spreads (round-robin over each key's
        # owner under the full 4-shard ring): the crowd lands on one
        # shard today, and the controller's splits can actually carry
        # it away — deterministic for the seed, like everything here
        ring0 = HashRing([fleet.sid(0), fleet.sid(1)], seed=args.seed)
        ring4 = ring0.with_shard(fleet.sid(2)).with_shard(fleet.sid(3))
        s1_owned = [e for e in range(elements)
                    if ring0.owner(e) == fleet.sid(1)]
        by_owner4: Dict[str, List[int]] = {}
        for e in s1_owned:
            by_owner4.setdefault(ring4.owner(e), []).append(e)
        hot_keys = []
        pools = [by_owner4[sid] for sid in sorted(by_owner4)]
        i = 0
        while len(hot_keys) < 12 and any(pools):
            pool = pools[i % len(pools)]
            if pool:
                hot_keys.append(pool.pop(0))
            i += 1

        zipf = workloads.ZipfKeys(elements, s=1.0, seed=args.seed)
        flash = workloads.FlashCrowd(
            workloads.ZipfKeys(elements, s=1.0, seed=args.seed),
            hot_keys, start_frac=0.0, stop_frac=1.0, hot_prob=0.5,
            seed=args.seed + 1)

        sampler = _SignalSampler(addr, interval_s=1.0)
        sampler.start()

        log1 = os.path.join(root, "decisions-1.jsonl")
        pilot = _AutopilotProc(REPO, os.path.join(root, "pilot-1"),
                               addr, standby_addrs, log1, args.seed,
                               pilot_flags)
        banner1 = pilot.await_engaged()

        acked_elements: Set[int] = set()
        submitted_elements: Set[int] = set()
        legs: Dict[str, Dict] = {}

        def traffic(name: str, rate: float, duration: float, keys,
                    deadline_s: float = 2.0) -> Dict:
            leg = open_loop_leg(
                addr, rate, duration, elements, del_every=0,
                deadline_s=deadline_s, keys=keys, ledgered=True)
            acked_elements.update(leg.pop("acked_elements"))
            submitted_elements.update(leg.pop("submitted_elements"))
            leg.pop("acked_deletes", None)
            legs[name] = leg
            print(json.dumps({name: {k: leg[k] for k in
                                     ("workload", "goodput", "acked",
                                      "shed_overloaded", "unresolved",
                                      "p99_ms")}}), flush=True)
            return leg

        # 1. baseline: healthy fleet, controller must hold
        t_baseline = time.monotonic()
        traffic("baseline", base_rate, baseline_s, zipf)
        gen_after_baseline = _ring_info(addr)["generation"]
        # the window on the controller's clock (its decision records'
        # signals.t is time.monotonic() of the same host)
        baseline_window_t = [t_baseline, time.monotonic()]

        # 2-3. burn + converge: flash crowd on s1's keyspace
        mark_burn = sampler.mark()
        traffic("burn", burn_rate, burn_s, flash)
        traffic("converge", burn_rate, converge_s, flash)
        ring_converged = _ring_info(addr)
        convergence = _converged(
            sampler.window(mark_burn),
            p99_budget_ms=p99_budget_ms,
            imbalance_budget=imbalance_budget)

        # 4. controller SIGKILL: the fleet serves on without it
        pilot.sigkill()
        pilot.close()
        outage = traffic("controller_down", base_rate, outage_s, zipf)
        ring_after_outage = _ring_info(addr)

        log2 = os.path.join(root, "decisions-2.jsonl")
        pilot = _AutopilotProc(REPO, os.path.join(root, "pilot-2"),
                               addr, standby_addrs, log2,
                               args.seed + 7, pilot_flags)
        banner2 = pilot.await_engaged()

        # 5. cold drain: the RESTARTED controller merges a standby its
        # predecessor deployed (resumption with teeth)
        gen_before_cold = _ring_info(addr)["generation"]
        traffic("cold", cold_rate, cold_s, zipf)
        ring_final = _ring_info(addr)

        pilot.proc.terminate()
        pilot.close()
        pilot = None
        sampler.stop()

        # final read: the fleet union through the router
        with ServeClient(addr, timeout=60.0) as c:
            members, _vv = c.members()
        members_set = set(members)

        recs1 = read_decision_log(log1)
        recs2 = read_decision_log(log2)
        committed = [r for r in recs1 + recs2
                     if r.get("record") == "outcome"
                     and r.get("outcome") == "committed"]
        splits = [r for r in committed if r.get("action") == "join"]
        merges = [r for r in committed if r.get("action") == "leave"]
        # every committed action must trace to a decision WITH signals
        actions_with_signals = 0
        for rs in (recs1, recs2):
            decs = {r["seq"]: r for r in rs
                    if r.get("record") == "decision"}
            for o in rs:
                if (o.get("record") == "outcome"
                        and o.get("outcome") == "committed"):
                    d = decs.get(o.get("decision_seq"))
                    if d and d.get("signals", {}).get("per_shard"):
                        actions_with_signals += 1

        result = {
            "elements": elements,
            "calibration": calibration,
            "budgets": {"p99_budget_ms": p99_budget_ms,
                        "queue_watermark": queue_watermark,
                        "imbalance_budget": imbalance_budget,
                        "pilot_flags": {k.lstrip("-"): v for k, v
                                        in pilot_flags.items()}},
            "hot_keys": hot_keys,
            "legs": legs,
            "baseline_window_t": baseline_window_t,
            "rings": {
                "after_baseline_generation": gen_after_baseline,
                "converged": ring_converged,
                "after_outage": ring_after_outage,
                "final": ring_final,
            },
            "convergence": convergence,
            "controller_kill": {
                "acked_during_outage": outage["acked"],
                "unresolved_during_outage": outage["unresolved"],
                "ring_generation_stable": (
                    ring_after_outage["generation"]
                    == ring_converged["generation"]),
                "resume_banner": banner2,
                "resumed_generation_matches": (
                    banner2["generation"]
                    == ring_after_outage["generation"]),
                "adopted_nonempty": banner2["adopted"] not in ("[]", ""),
            },
            "first_banner": banner1,
            "actions": {
                "splits_committed": len(splits),
                "merges_committed": len(merges),
                "committed_total": len(committed),
                "final_generation": ring_final["generation"],
                "committed_matches_generation": (
                    len(committed) == ring_final["generation"]),
                "with_trigger_signals": actions_with_signals,
                "merge_after_restart": bool(
                    [r for r in recs2
                     if r.get("record") == "outcome"
                     and r.get("action") == "leave"
                     and r.get("outcome") == "committed"]),
                "gen_before_cold": gen_before_cold,
            },
            "decision_log_1": recs1,
            "decision_log_2": recs2,
            "timeline": sampler.samples,
            "acked_ops": len(acked_elements),
            "submitted_ops": len(submitted_elements),
            "final_members": len(members_set),
            # MUST be []: an acked (fsync'd on its then-owner) element
            # vanished across the controller's live handoffs
            "lost_acked_ops": sorted(acked_elements - members_set),
            # MUST be []: a member nobody submitted
            "phantom_members": sorted(members_set - submitted_elements),
        }
    finally:
        if sampler is not None and sampler.is_alive():
            sampler.stop()
        if pilot is not None:
            pilot.close()
        fleet.close()
        import shutil

        shutil.rmtree(root, ignore_errors=True)

    return {
        "metric": (
            "fleet autopilot: a closed-loop controller (real `autopilot` "
            "CLI subprocess) watching the router STATS fan-out drives "
            "reshard --join/--leave itself — an adversarial zipf + "
            "flash-crowd workload converges (windowed per-shard ingest "
            "p99 and offered op-rate imbalance back inside the declared "
            "budgets after the controller's splits) with zero acked-op "
            "loss and zero phantoms; a controller SIGKILL leaves the "
            "fleet serving and a restarted controller resumes from the "
            "router's persisted committed ring, then drains a standby "
            "its predecessor deployed; every committed action is in the "
            "decision log with its triggering signals"),
        "value": result.get("actions", {}).get("splits_committed", 0),
        "unit": "committed autopilot splits under the adversarial leg",
        "fleet": {"elements": result.get("elements"),
                  "initial_shards": 2, "standbys": 2,
                  "burn_rate": burn_rate, "base_rate": base_rate,
                  "cold_rate": cold_rate, "seed": args.seed,
                  "quick": bool(args.quick)},
        "device": DEVICE,
        "elapsed_s": round(time.time() - t0, 1),
        **result,
    }



# ---------------------------------------------------------------------------
# router-HA legs (warm-standby failover, DESIGN.md §22) — `--router-ha`
# ---------------------------------------------------------------------------


class _HATraffic(threading.Thread):
    """Ledgered add-only load through an ORDERED router address list
    (primary first, standby second) while the primary is SIGKILLed:
    typed rejects requeue, ``AmbiguousOp`` (in-flight ops whose ack
    died with the old router) is counted separately and requeued —
    never silently resent, which is what keeps zero-phantom
    adjudicable — and dial failures during the promotion window
    requeue as transport retries.  True UNRESOLVED (a reply that never
    came on a live connection) is counted and adjudicated to zero."""

    def __init__(self, addrs, elements: int, seed: int):
        super().__init__(daemon=True)
        from collections import deque

        self.addrs = list(addrs)
        self.elements = elements
        self.seed = seed
        self._cycle = 0
        self.todo = deque(workloads.shuffled_universe(elements, seed))
        self.acked: Set[int] = set()
        self.submitted: Set[int] = set()
        self.counts = {"typed_moving": 0, "typed_unavailable": 0,
                       "typed_stale_epoch": 0, "typed_other": 0,
                       "ambiguous": 0, "transport_retries": 0,
                       "unresolved": 0}
        self._ack_log: List[Tuple[float, int]] = []
        self._log_lock = threading.Lock()
        self.stop_when_drained = threading.Event()

    def acked_since(self, t: float) -> int:
        with self._log_lock:
            return sum(1 for ts, _ in self._ack_log if ts >= t)

    def run(self) -> None:
        from go_crdt_playground_tpu_torch.serve.client import AmbiguousOp

        client = None
        try:
            while True:
                if not self.todo:
                    if self.stop_when_drained.is_set():
                        return
                    # keep offering load (idempotent re-adds of the
                    # same universe): the autopilot leg needs live
                    # heat long after the first pass lands — the
                    # ledger sets (acked/submitted) are unchanged by
                    # resubmission, so every invariant stays exact
                    self._cycle += 1
                    self.todo.extend(workloads.shuffled_universe(
                        self.elements, self.seed + self._cycle))
                e = self.todo.popleft()
                self.submitted.add(e)
                try:
                    if client is None or client.closed:
                        if client is not None:
                            client.close()
                        client = ServeClient(self.addrs, timeout=30.0,
                                             connect_timeout=2.0)
                    client.add(e, deadline_s=5.0)
                    self.acked.add(e)
                    with self._log_lock:
                        self._ack_log.append((time.monotonic(), e))
                except AmbiguousOp:
                    # outcome unknown — the op may be durably applied
                    # behind the dead router's ack; resubmit (idempotent)
                    self.counts["ambiguous"] += 1
                    self.todo.append(e)
                    time.sleep(0.05)
                except protocol.KeyspaceMoving:
                    self.counts["typed_moving"] += 1
                    self.todo.append(e)
                    time.sleep(0.01)
                except protocol.ShardUnavailable:
                    self.counts["typed_unavailable"] += 1
                    self.todo.append(e)
                    time.sleep(0.05)
                except protocol.StaleRouterEpoch:
                    # a deposed router answered: the client rotates on
                    # this code — requeue and resubmit via the successor
                    self.counts["typed_stale_epoch"] += 1
                    self.todo.append(e)
                    time.sleep(0.05)
                except protocol.ServeError:
                    self.counts["typed_other"] += 1
                    self.todo.append(e)
                    time.sleep(0.01)
                except socket.timeout:
                    # sent on a live connection, no reply inside the
                    # client timeout: genuinely unresolved
                    self.counts["unresolved"] += 1
                    self.todo.append(e)
                except (ConnectionError, OSError):
                    # never-sent (dial refused mid-promotion) or
                    # send-failed: requeue through the failover list
                    self.counts["transport_retries"] += 1
                    self.todo.append(e)
                    time.sleep(0.05)
        finally:
            if client is not None:
                client.close()

    def drain(self, timeout_s: float) -> bool:
        self.stop_when_drained.set()
        self.join(timeout=timeout_s)
        return not self.is_alive() and not self.todo


def run_router_ha_mode(args) -> Dict[str, object]:
    """``--router-ha``: the warm-standby failover soak (DESIGN.md
    §22), three legs over one real fleet:

    1. **failover** — SIGKILL the primary router mid-stream under
       continuous ledgered traffic: the standby must promote within
       the declared budget (its promotion banner IS the handshake),
       adopt the primary's exact committed ring (same generation +
       digest) under router epoch 2, and traffic must keep acking
       through the promoted router — in-flight ops surface typed-
       ambiguous and resubmit, ``unresolved == 0``.
    2. **autopilot** — a real ``autopilot`` CLI subprocess holding the
       ORDERED router list rides through the failover (its poll
       client rotates) and commits a SPLIT through the promoted
       router; its decision log records the epoch bump (resume +
       decision signals carry ``router_epoch == 2``).
    3. **resurrection** — restart the old primary on its original
       port/state_dir (old persisted epoch 1): its startup announce
       discovers the promoted epoch from the shards' durable fence
       and it comes back SELF-FENCED — a RESHARD against it refuses
       typed with the StaleRouterEpoch reason, its data plane sheds
       typed (the stale-ring containment), and the promoted router's
       ring digest is untouched.

    Throughout: zero acked-op loss, zero phantoms, whole keyspace in.
    Returns the result (checks_router_ha adjudicates it).
    """
    from go_crdt_playground_tpu_torch.control.controller import \
        read_decision_log
    from go_crdt_playground_tpu_torch.shard.fleet import (StandbyRouterProc,
                                                    free_port)

    if args.quick:
        elements = 144
        promote_budget_s = 20.0
    else:
        elements = 288
        promote_budget_s = 15.0

    t0 = time.time()
    root = tempfile.mkdtemp(prefix="router-ha-soak-")
    # actors=4: lanes for the 2 initial shards + the autopilot's
    # standby shard (index 2)
    spec = _spec(n_shards=2, elements=elements, seed=args.seed,
                     actors=4, queue_depth=64, max_batch=8, flush_ms=2.0)
    fleet = ShardFleet(
        REPO, os.path.join(root, "fleet"), spec,
        router_state_dir=os.path.join(root, "fleet", "router-state"),
        router_extra_args=("--router-epoch", "1",
                           "--router-id", "router-a"))
    result: Dict[str, object] = {}
    standby = None
    pilot = None
    traffic = None
    try:
        primary_addr = fleet.start()
        standby_port = free_port()
        standby_addr = ("127.0.0.1", standby_port)
        standby = StandbyRouterProc(
            REPO, os.path.join(root, "standby"), spec,
            fleet.shard_addr_map(), standby_port, primary_addr,
            os.path.join(root, "standby-state"), standby_id="router-b",
            poll_interval_s=0.25, failure_threshold=3)
        standby.await_engaged()
        # only a TAILED standby promotes (the epoch-collision guard):
        # the kill must not race the first tail poll
        standby.await_tailed()
        addrs = [primary_addr, standby_addr]

        ring0 = _ring_info(primary_addr)
        traffic = _HATraffic(addrs, elements, args.seed)
        traffic.start()
        baseline_deadline = time.monotonic() + 60.0
        while (len(traffic.acked) < elements // 4
               and time.monotonic() < baseline_deadline):
            time.sleep(0.05)
        acked_before_kill = len(traffic.acked)

        # ---- leg 1: failover ------------------------------------------
        t_kill = time.monotonic()
        fleet.kill_router()
        promoted_listen = standby.await_address(
            timeout_s=promote_budget_s + 60.0)
        t_promoted = time.monotonic()
        ring1 = _ring_info(standby_addr)
        # first ledgered ack THROUGH the promoted router
        ack_deadline = time.monotonic() + 60.0
        while (traffic.acked_since(t_promoted) < 10
               and time.monotonic() < ack_deadline):
            time.sleep(0.05)
        leg_failover = {
            "promote_s": round(t_promoted - t_kill, 3),
            "promote_budget_s": promote_budget_s,
            "promoted_listen": list(promoted_listen),
            "acked_before_kill": acked_before_kill,
            "acked_after_promotion": traffic.acked_since(t_promoted),
            "ring_before": {k: ring0[k] for k in
                            ("generation", "digest", "router_epoch")},
            "ring_after": {k: ring1[k] for k in
                           ("generation", "digest", "router_epoch",
                            "router_id")},
        }
        print(json.dumps({"failover": leg_failover}), flush=True)

        # ---- leg 2: autopilot through the promoted router -------------
        s2_addr = fleet.launch_shard(2)
        log_path = os.path.join(root, "decisions.jsonl")
        # hair-trigger heat: the leg's claim is "a split COMMITS
        # through the PROMOTED router with the epoch in the log" —
        # convergence quality is the --autopilot mode's job.  cold-rate
        # 0 disables merges so the generation accounting stays crisp.
        pilot = _AutopilotProc(
            REPO, os.path.join(root, "pilot"), addrs,
            [(fleet.sid(2), s2_addr)], log_path, args.seed,
            {"--poll-interval": 0.5, "--p99-budget-ms": 1.0,
             "--queue-watermark": 1.0, "--hot-windows": 2,
             "--cold-windows": 1000, "--cooldown": 2.0,
             "--abort-cooldown": 4.0, "--min-shards": 2,
             "--max-shards": 3, "--cold-rate": 0.0,
             "--reshard-timeout": 60.0})
        banner = pilot.await_engaged()
        split_deadline = time.monotonic() + 90.0
        committed_join = None
        while time.monotonic() < split_deadline:
            recs = read_decision_log(log_path)
            joins = [r for r in recs
                     if r.get("record") == "outcome"
                     and r.get("action") == "join"
                     and r.get("outcome") == "committed"]
            if joins:
                committed_join = joins[0]
                break
            time.sleep(0.5)
        pilot.proc.terminate()
        pilot.close()
        pilot = None
        recs = read_decision_log(log_path)
        resume = next((r for r in recs if r.get("record") == "resume"),
                      {})
        decs = {r["seq"]: r for r in recs
                if r.get("record") == "decision"}
        join_decision = (decs.get(committed_join.get("decision_seq"))
                         if committed_join else None)
        ring2 = _ring_info(standby_addr)
        leg_autopilot = {
            "banner": banner,
            "resume_router_epoch": resume.get("router_epoch"),
            "resume_generation": resume.get("generation"),
            "split_committed": committed_join is not None,
            "split_sid": (committed_join or {}).get("sid"),
            "decision_signals_router_epoch": (
                (join_decision or {}).get("signals", {})
                .get("router_epoch")),
            "generation_after": ring2["generation"],
            "shards_after": ring2["shards"],
        }
        print(json.dumps({"autopilot": leg_autopilot}), flush=True)

        # drain the ledger BEFORE resurrecting the old primary (a
        # deposed router sheds typed, but the ledger should finish on
        # the promoted one)
        finished = traffic.drain(timeout_s=180.0)

        # ---- leg 3: deposed-primary resurrection ----------------------
        old_addr = fleet.restart_router()
        # the resurrected primary discovered the promoted epoch at its
        # startup announce (the shards persist the fence): a RESHARD
        # against it must refuse typed, its data plane must shed typed
        with ServeClient(old_addr, timeout=30.0) as c:
            ok_reshard, detail = c.reshard(protocol.RESHARD_LEAVE,
                                           fleet.sid(2), timeout=30.0)
            op_shed_typed = False
            try:
                c.add(0, deadline_s=5.0)
            except protocol.StaleRouterEpoch:
                op_shed_typed = True
            except protocol.ServeError:
                pass
            old_stats = c.stats()
        ring3 = _ring_info(standby_addr)
        old_counters = old_stats.get("counters", {})
        leg_resurrection = {
            "reshard_refused": not ok_reshard,
            "reshard_reason": str(detail.get("reason", "")),
            "op_shed_typed": op_shed_typed,
            "old_router_epoch": old_stats.get("ring", {})
            .get("router_epoch"),
            "old_router_deposed_noted": int(
                old_counters.get("router.epoch.noted", 0)),
            "old_router_shed_deposed": int(
                old_counters.get("router.shed.deposed", 0)),
            "promoted_ring_unchanged": (
                ring3["generation"] == ring2["generation"]
                and ring3["digest"] == ring2["digest"]),
        }
        print(json.dumps({"resurrection": leg_resurrection}),
              flush=True)

        # ---- final ledger adjudication (via the promoted router) ------
        with ServeClient(standby_addr, timeout=60.0) as c:
            members, _vv = c.members()
            promoted_stats = c.stats()
        members_set = set(members)
        result = {
            "elements": elements,
            "legs": {"failover": leg_failover,
                     "autopilot": leg_autopilot,
                     "resurrection": leg_resurrection},
            "traffic": dict(traffic.counts),
            "finished": finished,
            "acked_ops": len(traffic.acked),
            "submitted_ops": len(traffic.submitted),
            "final_members": len(members_set),
            # MUST be []: an acked op vanished across the failover
            "lost_acked_ops": sorted(traffic.acked - members_set),
            # MUST be []: a member nobody submitted — the typed-
            # ambiguous surfacing (never silent resend) keeps this
            # adjudicable
            "phantom_members": sorted(members_set - traffic.submitted),
            "unfinished": sorted(set(range(elements)) - traffic.acked),
            "promoted_ha_counters": {
                k: v for k, v in
                promoted_stats.get("counters", {}).items()
                if k.startswith("router.ha.")
                or k.startswith("router.epoch.")},
        }
    finally:
        if traffic is not None and traffic.is_alive():
            traffic.stop_when_drained.set()
        if pilot is not None:
            pilot.close()
        if standby is not None:
            standby.close()
        fleet.close()
        import shutil

        shutil.rmtree(root, ignore_errors=True)

    return {
        "metric": (
            "router high availability: a warm-standby router tails the "
            "primary's committed RouteState over RING_SYNC and promotes "
            "on its SIGKILL under a monotone fenced router epoch — "
            "promotion inside the declared budget with the exact "
            "committed ring (generation+digest) adopted, continuous "
            "ledgered traffic rides through with in-flight ops surfaced "
            "typed-ambiguous (zero unresolved, zero acked-op loss, zero "
            "phantoms), a real autopilot re-resolves the promoted "
            "router and commits a split with the epoch bump in its "
            "decision log, and a resurrected deposed primary is "
            "contained: stale RESHARD refused typed StaleRouterEpoch, "
            "data plane shed typed, promoted ring digest untouched"),
        "value": result.get("legs", {}).get("failover", {})
        .get("promote_s"),
        "unit": "seconds from primary SIGKILL to standby promotion",
        "fleet": {"elements": result.get("elements"),
                  "initial_shards": 2, "autopilot_standby_shards": 1,
                  "seed": args.seed, "quick": bool(args.quick),
                  "ha_poll_interval_s": 0.25,
                  "ha_failure_threshold": 3},
        "device": DEVICE,
        "elapsed_s": round(time.time() - t0, 1),
        **result,
    }



# ---------------------------------------------------------------------------
# shard-replication mode (`--shard-repl`, DESIGN.md §23)
# ---------------------------------------------------------------------------


class _ReplTraffic(threading.Thread):
    """Ledgered add-only load through the (single, never-killed) router
    while SHARD primaries die under it: typed rejects requeue,
    transport ambiguity requeues counted, true unresolved adjudicated
    to zero.  ``pause()`` stops submissions without ending the thread
    (the bitwise leg needs a quiesced fleet mid-soak).  The ack log
    carries (t, element) so legs can ask about one keyspace's acks in
    one time window."""

    def __init__(self, addr, elements: int, seed: int):
        super().__init__(daemon=True)
        from collections import deque

        self.addr = addr
        self.elements = elements
        self.seed = seed
        self._cycle = 0
        self.todo = deque(workloads.shuffled_universe(elements, seed))
        self.acked: Set[int] = set()
        self.submitted: Set[int] = set()
        self.counts = {"typed_unavailable": 0, "typed_moving": 0,
                       "typed_storage": 0, "typed_stale_shard": 0,
                       "typed_other": 0, "transport_retries": 0,
                       "unresolved": 0}
        self._ack_log: List[Tuple[float, int]] = []
        self._log_lock = threading.Lock()
        self._paused = threading.Event()
        self._halt = threading.Event()

    def acks_in(self, t0: float, t1: float, owned=None) -> int:
        with self._log_lock:
            return sum(1 for ts, e in self._ack_log
                       if t0 <= ts <= t1
                       and (owned is None or e in owned))

    def pause(self) -> None:
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    def run(self) -> None:
        client = None
        try:
            while not self._halt.is_set():
                if self._paused.is_set():
                    time.sleep(0.02)
                    continue
                if not self.todo:
                    # keep offering idempotent re-adds of the same
                    # universe: the failover legs need live heat long
                    # after the first pass lands; the ledger sets are
                    # unchanged by resubmission
                    self._cycle += 1
                    self.todo.extend(workloads.shuffled_universe(
                        self.elements, self.seed + self._cycle))
                e = self.todo.popleft()
                self.submitted.add(e)
                try:
                    if client is None or client.closed:
                        if client is not None:
                            client.close()
                        client = ServeClient(self.addr, timeout=30.0,
                                             connect_timeout=2.0)
                    client.add(e, deadline_s=5.0)
                    self.acked.add(e)
                    with self._log_lock:
                        self._ack_log.append((time.monotonic(), e))
                except protocol.ShardUnavailable:
                    self.counts["typed_unavailable"] += 1
                    self.todo.append(e)
                    time.sleep(0.02)
                except protocol.KeyspaceMoving:
                    self.counts["typed_moving"] += 1
                    self.todo.append(e)
                    time.sleep(0.01)
                except protocol.StorageDegraded:
                    self.counts["typed_storage"] += 1
                    self.todo.append(e)
                    time.sleep(0.02)
                except protocol.StaleShardEpoch:
                    # a deposed member answered (the router should
                    # never relay this post-swap; counted loudly)
                    self.counts["typed_stale_shard"] += 1
                    self.todo.append(e)
                    time.sleep(0.02)
                except protocol.ServeError:
                    self.counts["typed_other"] += 1
                    self.todo.append(e)
                    time.sleep(0.01)
                except socket.timeout:
                    self.counts["unresolved"] += 1
                    self.todo.append(e)
                except (ConnectionError, OSError):
                    self.counts["transport_retries"] += 1
                    self.todo.append(e)
                    time.sleep(0.02)
        finally:
            if client is not None:
                client.close()

    def drain(self, timeout_s: float) -> bool:
        """Finish the CURRENT universe pass (everything acked at least
        once), then stop."""
        self.resume()
        deadline = time.monotonic() + timeout_s
        while (len(self.acked) < self.elements
               and time.monotonic() < deadline):
            time.sleep(0.05)
        self._halt.set()
        self.join(timeout=10.0)
        return len(self.acked) >= self.elements and not self.is_alive()


def _shard_stats(router_addr, sid: str) -> Tuple[dict, dict, dict]:
    """(shard counters, shard gauges, ring info) from one STATS poll."""
    with ServeClient(router_addr, timeout=15.0) as c:
        stats = c.stats()
    snap = (stats.get("shards") or {}).get(sid) or {}
    return (snap.get("counters", {}) or {},
            snap.get("gauges", {}) or {},
            stats.get("ring", {}) or {})


def _await_repl(router_addr, sid: str, pred, timeout_s: float,
                what: str) -> Tuple[dict, dict]:
    deadline = time.monotonic() + timeout_s
    counters: dict = {}
    gauges: dict = {}
    while time.monotonic() < deadline:
        try:
            counters, gauges, _ = _shard_stats(router_addr, sid)
            if pred(counters, gauges):
                return counters, gauges
        except (OSError, ConnectionError, socket.timeout):
            pass
        time.sleep(0.25)
    raise RuntimeError(f"timed out waiting for {what}: "
                       f"counters={counters} gauges={gauges}")


def run_shard_repl_mode(args) -> Dict[str, object]:
    """``--shard-repl``: the shard-replication acceptance soak
    (DESIGN.md §23), four legs over ONE real fleet of two replication
    groups (s0 + warm standby through a ChaosProxy on the replication
    link, s1 + warm standby direct) behind one router:

    1. **chaos** — torn frames, then an asymmetric partition +
       ``sever()`` on the PRIMARY↔STANDBY link while s0 checkpoints
       rotate its WAL: replication degrades TYPED to async
       (``repl.degraded_windows`` ≥ 1) and s0's keyspace keeps acking
       above the floor; on heal the standby digest-catches-up
       (``repl.catchups`` ≥ 1, ``repl.lag_records`` back to 0).
    2. **failover** — SIGKILL s0's primary MID-STREAM under the
       continuous ledger, NO restart: the standby promotes within the
       budget, the router swaps the keyspace under shard epoch 2, and
       s0-owned elements ack again through the promoted member.
    3. **bitwise** — quiesce (s1 ``repl.lag_records == 0``), SIGKILL
       s1's primary, promote, and BEFORE any new traffic pull the
       promoted standby's full-universe slice: byte-identical to an
       in-process ``restore_durable`` of the dead primary's disk —
       promotion IS the restart path, bit for bit.
    4. **resurrection** — restart s0's OLD primary on its old
       port/disk: its announce learns the adjudicated epoch and it
       boots self-fenced (direct write typed-rejected and never
       applied; reads serve; router mapping untouched).

    Throughout: every op resolves ack-or-typed, zero acked-op loss,
    zero phantoms, whole keyspace in.  Returns the result
    (checks_shard_repl adjudicates it).
    """
    import numpy as np

    from go_crdt_playground_tpu_torch.net.faults import ChaosProxy
    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.shard.fleet import (RouterProc, ShardProc,
                                                    StandbyShardProc,
                                                    free_port)
    from go_crdt_playground_tpu_torch.shard.ring import HashRing

    if args.quick:
        elements = 96
        promote_budget_s = 30.0
    else:
        elements = 192
        promote_budget_s = 20.0
    t0 = time.time()
    root = tempfile.mkdtemp(prefix="shard-repl-soak-")
    spec = _spec(n_shards=2, elements=elements, seed=args.seed,
                     queue_depth=64, max_batch=8, flush_ms=2.0)
    procs: List[object] = []
    proxy = None
    traffic = None
    result: Dict[str, object] = {}
    try:
        p0_port, p1_port = free_port(), free_port()
        sb0_port, sb1_port = free_port(), free_port()
        router_port = free_port()
        router_addr = ("127.0.0.1", router_port)
        announce = f"127.0.0.1:{router_port}"

        # replication-group primaries: shard ids + epoch 1 + the
        # router announce; s0 additionally checkpoints on a cadence so
        # a partitioned standby's cursor gets TRUNCATED under it (the
        # digest catch-up trigger)
        s0 = ShardProc(REPO, os.path.join(root, "s0"), spec, 0, p0_port,
                       extra_args=("--shard-id", "s0",
                                   "--shard-epoch", "1",
                                   "--announce-to", announce,
                                   "--repl-ack-timeout-ms", "150",
                                   "--checkpoint-every", "40"))
        s1 = ShardProc(REPO, os.path.join(root, "s1"), spec, 1, p1_port,
                       extra_args=("--shard-id", "s1",
                                   "--shard-epoch", "1",
                                   "--announce-to", announce,
                                   "--repl-ack-timeout-ms", "150"))
        procs += [s0, s1]
        a0 = s0.await_address()
        a1 = s1.await_address()
        # the replication link under test rides the proxy: the standby
        # tails THROUGH it, so the chaos leg can tear/partition just
        # that hop while clients and the router stay clean
        proxy = ChaosProxy(a0, seed=args.seed)
        router = RouterProc(
            REPO, os.path.join(root, "router"), spec,
            {"s0": [a0, ("127.0.0.1", sb0_port)],
             "s1": [a1, ("127.0.0.1", sb1_port)]},
            router_port, state_dir=os.path.join(root, "router-state"))
        procs.append(router)
        router.await_address()
        # sb0's failure threshold must RIDE OUT the chaos leg: its
        # poll path IS the link under chaos, and a standby cannot
        # distinguish a partitioned link from a dead primary — the
        # fence makes a false-positive promotion SAFE, but this soak
        # wants the chaos leg to prove degradation, not failover.  The
        # cost is declared detection latency (~threshold x poll) inside
        # the promotion budget.
        sb0 = StandbyShardProc(REPO, os.path.join(root, "sb0"), spec, 0,
                               sb0_port, ("127.0.0.1", proxy.port),
                               "s0", announce_to=router_addr,
                               poll_interval_s=0.1,
                               failure_threshold=90)
        sb1 = StandbyShardProc(REPO, os.path.join(root, "sb1"), spec, 1,
                               sb1_port, a1, "s1",
                               announce_to=router_addr,
                               poll_interval_s=0.1, failure_threshold=5)
        procs += [sb0, sb1]
        for sb in (sb0, sb1):
            sb.await_engaged()
            # only a TAILED standby promotes: the kills must not race
            # the first tail poll
            sb.await_tailed()

        ring = HashRing(["s0", "s1"], seed=args.seed)
        owners = ring.owner_map(elements)
        s0_owned = {int(e) for e in
                    (owners == ring.shards.index("s0")).nonzero()[0]}
        s1_owned = set(range(elements)) - s0_owned

        traffic = _ReplTraffic(router_addr, elements, args.seed)
        traffic.start()
        base_deadline = time.monotonic() + 90.0
        while (len(traffic.acked) < elements // 3
               and time.monotonic() < base_deadline):
            time.sleep(0.05)

        # ---- leg 1: chaos on the replication link ---------------------
        # semi-sync is live before the chaos: the standby's cursor has
        # been covering the tail (lag drains to 0 under load)
        _await_repl(router_addr, "s0",
                    lambda c, g: c.get("repl.polls", 0) > 0
                    and g.get("repl.lag_records", 1) == 0,
                    60.0, "s0 semi-sync live")
        t_chaos0 = time.monotonic()
        proxy.set_scenario(truncate_rate=1.0)
        proxy.sever()
        time.sleep(2.0)
        proxy.set_scenario(truncate_rate=0.0)
        proxy.partition()
        proxy.sever()
        t_part0 = time.monotonic()
        time.sleep(4.0)  # s0's checkpoint cadence truncates its WAL
        t_part1 = time.monotonic()
        counters_mid = _shard_stats(router_addr, "s0")[0]
        proxy.heal()
        # on heal: typed degrade happened, the standby digest-catches-
        # up past the truncation, and the lag drains to zero
        counters_heal, gauges_heal = _await_repl(
            router_addr, "s0",
            lambda c, g: g.get("repl.lag_records", 1) == 0
            and c.get("repl.degraded_windows", 0) >= 1,
            60.0, "s0 heal + lag drain")
        leg_chaos = {
            "proxy": proxy.counters(),
            "degraded_windows": int(
                counters_heal.get("repl.degraded_windows", 0)),
            "heals": int(counters_heal.get("repl.heals", 0)),
            "ship_errors": int(counters_heal.get("repl.ship_errors", 0)),
            "acked_s0_during_partition": traffic.acks_in(
                t_part0, t_part1, s0_owned),
            "partition_s": round(t_part1 - t_part0, 2),
            "goodput_floor_ops_s": 1.0,
            "lag_records_after_heal": int(
                gauges_heal.get("repl.lag_records", -1)),
            "chaos_s": round(time.monotonic() - t_chaos0, 2),
            "catchups_served": int(
                counters_heal.get("repl.catchups_served", 0)),
            "repl_counters_mid_partition": {
                k: v for k, v in counters_mid.items()
                if k.startswith("repl.")},
        }
        print(json.dumps({"chaos": leg_chaos}), flush=True)

        # ---- leg 2: mid-stream primary SIGKILL, NO restart ------------
        t_kill = time.monotonic()
        s0.sigkill()
        s0.log.close()
        promoted0 = sb0.await_address(timeout_s=promote_budget_s + 60.0)
        t_promoted = time.monotonic()
        # the router adjudicated the claim and swapped the keyspace
        _, _, ring_info = _shard_stats(router_addr, "s0")
        ack_deadline = time.monotonic() + 60.0
        while (traffic.acks_in(t_promoted, time.monotonic(),
                               s0_owned) < 10
               and time.monotonic() < ack_deadline):
            time.sleep(0.05)
        leg_failover = {
            "promote_s": round(t_promoted - t_kill, 3),
            "promote_budget_s": promote_budget_s,
            "promoted_listen": list(promoted0),
            "shard_epochs": ring_info.get("shard_epochs"),
            "s0_active_addr": (ring_info.get("shard_addrs", {})
                               .get("s0", [[None, None]])[0]),
            "acked_s0_after_promotion": traffic.acks_in(
                t_promoted, time.monotonic(), s0_owned),
        }
        print(json.dumps({"failover": leg_failover}), flush=True)

        # ---- leg 3: quiesced SIGKILL — the bitwise pin ----------------
        traffic.pause()
        time.sleep(1.0)  # in-flight submissions resolve
        _await_repl(router_addr, "s1",
                    lambda c, g: g.get("repl.lag_records", 1) == 0,
                    60.0, "s1 quiesced lag 0")
        t_kill1 = time.monotonic()
        s1.sigkill()
        s1.log.close()
        promoted1 = sb1.await_address(timeout_s=promote_budget_s + 60.0)
        promote1_s = time.monotonic() - t_kill1
        # BEFORE any new traffic: the promoted standby's full-universe
        # slice must be byte-identical to what a restore_durable
        # restart of the dead primary would serve
        with ServeClient(tuple(promoted1), timeout=30.0) as c:
            standby_slice = c.slice_pull(list(range(elements)))
        # the restart-path counterfactual: checkpoint ⊔ WAL tail of
        # the DEAD primary's disk (fallback_init: a SIGKILLed shard
        # that never checkpointed recovers from the WAL alone)
        restored = Node.restore_durable(
            os.path.join(root, "s1", "state"),
            fallback_init=lambda: Node(1, elements, spec.actors,
                                       device="cpu"),
            device="cpu")
        restored_slice = restored.extract_slice(
            np.ones(elements, bool))
        _, _, ring_info3 = _shard_stats(router_addr, "s1")
        leg_bitwise = {
            "promote_s": round(promote1_s, 3),
            "promote_budget_s": promote_budget_s,
            "slices_bitwise_equal": standby_slice == restored_slice,
            "slice_bytes": len(standby_slice),
            "shard_epochs": ring_info3.get("shard_epochs"),
        }
        print(json.dumps({"bitwise": leg_bitwise}), flush=True)
        traffic.resume()

        # ---- leg 4: deposed-primary resurrection ----------------------
        s0b = ShardProc(REPO, os.path.join(root, "s0"), spec, 0, p0_port,
                        extra_args=("--shard-id", "s0",
                                    "--shard-epoch", "1",
                                    "--announce-to", announce,
                                    "--repl-ack-timeout-ms", "150"))
        procs.append(s0b)
        s0b.await_address()
        write_typed = False
        try:
            with ServeClient(a0, timeout=10.0) as c:
                try:
                    c.add(0, deadline_s=5.0)
                except protocol.StaleShardEpoch:
                    write_typed = True
                members_old, _vv = c.members()
                old_stats = c.stats()
        except (OSError, ConnectionError) as e:
            members_old, old_stats = [], {"error": str(e)}
        _, _, ring_info4 = _shard_stats(router_addr, "s0")
        old_counters = old_stats.get("counters", {})
        leg_resurrection = {
            "write_shed_typed": write_typed,
            "deposed_boot_counted": int(
                old_counters.get("serve.shard.deposed_boot", 0)),
            "shed_counted": int(
                old_counters.get("serve.shed.shard_deposed", 0)),
            "reads_served_members": len(members_old),
            "router_s0_active_addr": (ring_info4.get("shard_addrs", {})
                                      .get("s0", [[None, None]])[0]),
            "router_shard_epochs": ring_info4.get("shard_epochs"),
        }
        print(json.dumps({"resurrection": leg_resurrection}),
              flush=True)

        # ---- final ledger adjudication --------------------------------
        finished = traffic.drain(timeout_s=180.0)
        with ServeClient(router_addr, timeout=60.0) as c:
            members, _vv = c.members()
        members_set = set(int(m) for m in members)
        result = {
            "elements": elements,
            "s0_keyspace": len(s0_owned),
            "s1_keyspace": len(s1_owned),
            "workload": workloads.SHUFFLED_UNIVERSE,
            "legs": {"chaos": leg_chaos, "failover": leg_failover,
                     "bitwise": leg_bitwise,
                     "resurrection": leg_resurrection},
            "traffic": dict(traffic.counts),
            "finished": finished,
            "acked_ops": len(traffic.acked),
            "submitted_ops": len(traffic.submitted),
            "final_members": len(members_set),
            # MUST be []: an acked op vanished across a shard failover
            "lost_acked_ops": sorted(traffic.acked - members_set),
            # MUST be []: a member nobody submitted (e.g. the deposed
            # primary's rejected write applied anyway)
            "phantom_members": sorted(members_set - traffic.submitted),
            "unfinished": sorted(set(range(elements)) - traffic.acked),
        }
    finally:
        if traffic is not None and traffic.is_alive():
            traffic._halt.set()
        if proxy is not None:
            proxy.close()
        for pr in procs:
            try:
                pr.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        import shutil

        shutil.rmtree(root, ignore_errors=True)

    return {
        "metric": (
            "shard replication groups: a warm standby tails its "
            "primary's committed δ-WAL over WAL_SYNC under semi-"
            "synchronous group commit, degrades typed to async when "
            "the link is torn/partitioned (goodput floor held, digest "
            "catch-up on heal), promotes on a primary SIGKILL with NO "
            "restart inside the declared budget under a bumped fenced "
            "shard epoch (the router swaps the keyspace and persists "
            "the adjudication), the promoted replica is byte-identical "
            "to the restore_durable restart path when quiesced, and a "
            "resurrected old primary boots self-fenced (write typed-"
            "rejected, never applied) — zero acked-op loss, zero "
            "phantoms, unresolved == 0"),
        "value": result.get("legs", {}).get("bitwise", {})
        .get("promote_s"),
        "unit": "seconds from primary-shard SIGKILL to standby "
                "promotion (quiesced leg, default failure threshold "
                "5; the mid-stream leg's promote_s is dominated by "
                "its chaos-hardened threshold-90 detection window — "
                "both adjudicated against their declared budgets)",
        "fleet": {"elements": result.get("elements"),
                  "replication_groups": 2, "seed": args.seed,
                  "quick": bool(args.quick),
                  "ha_poll_interval_s": 0.1,
                  "ha_failure_threshold": {"s0-standby": 90,
                                           "s1-standby": 5},
                  "repl_ack_timeout_ms": 150.0},
        "device": DEVICE,
        "elapsed_s": round(time.time() - t0, 1),
        **result,
    }


# ---------------------------------------------------------------------------
# adjudication: tools/fleet_serve_soak.py's checks, each named
# ---------------------------------------------------------------------------


class Check(NamedTuple):
    name: str
    ok: bool
    guarantee: bool  # False: a load-shape check


def _g(name: str, ok) -> Check:
    return Check(name, bool(ok), True)


def _l(name: str, ok) -> Check:
    return Check(name, bool(ok), False)


def _ledger_checks(prefix: str, leg: Dict[str, object]) -> List[Check]:
    return [_g(f"{prefix}/lost_acked_ops", leg["lost_acked_ops"] == []),
            _g(f"{prefix}/phantom_members", leg["phantom_members"] == [])]


def checks_sweep(r: Dict[str, object], quick: bool) -> List[Check]:
    """The default sweep: the shard curve, the kill, reshard and chaos
    legs."""
    curve, kill = r["shard_curve"], r["kill_leg"]
    out = [_g("sweep/unresolved",
              all(leg["unresolved"] == 0 for leg in curve)),
           _l("sweep/goodput", all(leg["goodput"] > 0 for leg in curve)),
           _l("kill/typed_unavailable",
              kill["outage"]["typed_unavailable"] > 0),
           _l("kill/acked_survivor", kill["outage"]["acked_survivor"] > 0),
           _g("kill/unresolved", kill["outage"]["unresolved"] == 0),
           _l("kill/victim_acked_before_kill",
              kill["victim_acked_before_kill"] > 0),
           *_ledger_checks("kill", kill),
           _g("kill/unfinished", kill["unfinished"] == [])]
    leg = r["reshard_leg"]
    by_event = {e["event"]: e for e in leg["events"]}
    abort = by_event["join_recipient_killed_mid_handoff"]
    out.append(_g("reshard/join_abort_typed_old_ring_serving",
                  not abort["ok"] and abort["joiner_died"]
                  and abort["ring_unchanged"]))
    join = by_event["join_committed_via_cli"]
    out += [_g("reshard/join_committed",
               join["ok"] and join["cli_rc"] == 0),
            _g("reshard/join_moved", join["digest_changed"]
               and (join["moved"] or 0) > 0),
            _g("reshard/join_remap_fraction",
               join["observed_fraction"] is not None
               and abs(join["observed_fraction"]
                       - join["predicted_fraction"]) < 1e-6),
            _l("reshard/join_fence_s", join["fence_s"] is not None
               and join["fence_s"] < 15.0)]
    if not quick:
        donor = by_event["leave_donor_killed_mid_handoff"]
        out.append(_g("reshard/leave_abort_typed_old_ring_serving",
                      not donor["ok"] and donor["donor_died"]
                      and donor["ring_unchanged"]))
    leave = by_event["leave_committed"]
    out += [_g("reshard/leave_committed_digest_restored",
               leave["ok"] and leave["digest_restored"]),
            _l("reshard/leave_fence_s", leave["fence_s"] is not None
               and leave["fence_s"] < 15.0),
            _g("reshard/unfinished",
               leg["finished"] and leg["unfinished"] == []),
            _g("reshard/unresolved", leg["traffic"]["unresolved"] == 0),
            *_ledger_checks("reshard", leg)]
    chaos = r["chaos_leg"]
    out += [_l("chaos/proxy_faults", chaos["proxy"]["truncated"] > 0
               and chaos["proxy"]["refused"] > 0),
            _l("chaos/typed_unavailable",
               chaos["outage"]["typed_unavailable"] > 0),
            _l("chaos/acked_survivor",
               chaos["outage"]["acked_survivor_during_chaos"] > 0),
            _g("chaos/unresolved", chaos["outage"]["unresolved"] == 0),
            *_ledger_checks("chaos", chaos),
            _g("chaos/unfinished", chaos["unfinished"] == [])]
    return out


def checks_autopilot(r: Dict[str, object]) -> List[Check]:
    legs = r["legs"]
    ck, act = r["controller_kill"], r["actions"]
    return [
        _g("autopilot/unresolved",
           all(leg["unresolved"] == 0 for leg in legs.values())),
        _l("autopilot/goodput",
           all(leg["goodput"] > 0 for leg in legs.values())),
        _l("autopilot/held_at_baseline",
           r["rings"]["after_baseline_generation"] == 0),
        _l("autopilot/split_committed", act["splits_committed"] >= 1),
        _l("autopilot/converged", r["convergence"]["converged"]),
        _l("autopilot/acked_during_outage",
           ck["acked_during_outage"] > 0),
        _g("autopilot/unresolved_during_outage",
           ck["unresolved_during_outage"] == 0),
        _g("autopilot/ring_generation_stable",
           ck["ring_generation_stable"]),
        _g("autopilot/resumed_generation_matches",
           ck["resumed_generation_matches"]),
        _l("autopilot/adopted_nonempty", ck["adopted_nonempty"]),
        _l("autopilot/merge_after_restart", act["merge_after_restart"]),
        _g("autopilot/committed_matches_generation",
           act["committed_matches_generation"]),
        _g("autopilot/committed_with_signals",
           act["with_trigger_signals"] == act["committed_total"]),
        *_ledger_checks("autopilot", r)]


def checks_router_ha(r: Dict[str, object]) -> List[Check]:
    fo, ap, rz = (r["legs"]["failover"], r["legs"]["autopilot"],
                  r["legs"]["resurrection"])
    before, after = fo["ring_before"], fo["ring_after"]
    return [
        _g("router_ha/promotion_bounded",
           fo["promote_s"] <= fo["promote_budget_s"]),
        _g("router_ha/router_epoch_bumped",
           after["router_epoch"] == before["router_epoch"] + 1),
        _g("router_ha/same_ring",
           after["generation"] == before["generation"]
           and after["digest"] == before["digest"]),
        _l("router_ha/acked_before_kill", fo["acked_before_kill"] > 0),
        _l("router_ha/acked_after_promotion",
           fo["acked_after_promotion"] > 0),
        _l("router_ha/autopilot_split", ap["split_committed"]),
        _g("router_ha/autopilot_resumed_epoch",
           ap["resume_router_epoch"] == after["router_epoch"]),
        _l("router_ha/autopilot_decision_epoch",
           ap["decision_signals_router_epoch"] == after["router_epoch"]),
        _l("router_ha/autopilot_generation",
           ap["generation_after"] > after["generation"]
           and ap["split_sid"] in ap["shards_after"]),
        _g("router_ha/deposed_reshard_refused_typed",
           rz["reshard_refused"]
           and "StaleRouterEpoch" in rz["reshard_reason"]),
        _g("router_ha/deposed_op_shed_typed", rz["op_shed_typed"]),
        _g("router_ha/deposed_counted",
           rz["old_router_deposed_noted"] >= 1
           and rz["old_router_shed_deposed"] >= 1),
        _g("router_ha/promoted_ring_unchanged",
           rz["promoted_ring_unchanged"]),
        _g("router_ha/unresolved", r["traffic"]["unresolved"] == 0),
        _g("router_ha/unfinished", r["finished"] and r["unfinished"] == []),
        *_ledger_checks("router_ha", r)]


def checks_shard_repl(r: Dict[str, object]) -> List[Check]:
    ch, fo, bw, rz = (r["legs"][k] for k in
                      ("chaos", "failover", "bitwise", "resurrection"))
    return [
        _l("shard_repl/proxy_faults", ch["proxy"]["truncated"] > 0
           and ch["proxy"]["refused"] > 0),
        _l("shard_repl/degraded_windows", ch["degraded_windows"] >= 1),
        _l("shard_repl/goodput_floor",
           ch["acked_s0_during_partition"]
           >= ch["goodput_floor_ops_s"] * ch["partition_s"]),
        _g("shard_repl/caught_up_after_heal",
           ch["lag_records_after_heal"] == 0),
        _l("shard_repl/catchups_served", ch["catchups_served"] >= 1),
        _g("shard_repl/failover_promotion_bounded",
           fo["promote_s"] <= fo["promote_budget_s"]),
        _g("shard_repl/failover_epoch",
           fo["shard_epochs"].get("s0") == 2
           and bool(list(map(str, fo["s0_active_addr"][:1])))),
        _l("shard_repl/acked_after_promotion",
           fo["acked_s0_after_promotion"] >= 10),
        _g("shard_repl/bitwise_promotion_bounded",
           bw["promote_s"] <= bw["promote_budget_s"]),
        _g("shard_repl/slices_bitwise_equal", bw["slices_bitwise_equal"]),
        _g("shard_repl/bitwise_epoch", bw["shard_epochs"].get("s1") == 2),
        _g("shard_repl/deposed_write_shed_typed",
           rz["write_shed_typed"] and rz["shed_counted"] >= 1),
        _g("shard_repl/router_epoch_kept",
           rz["router_shard_epochs"].get("s0") == 2),
        _g("shard_repl/unresolved", r["traffic"]["unresolved"] == 0),
        _g("shard_repl/unfinished",
           r["finished"] and r["unfinished"] == []),
        *_ledger_checks("shard_repl", r)]


# ---------------------------------------------------------------------------
# the default sweep and main
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# mesh legs (the device-mesh replica tier): `--mesh` mode
# ---------------------------------------------------------------------------


def _mesh_slots(spec) -> int:
    """Slots a ``--mesh-devices`` spec needs: N, or dp * mp (the
    package's own parser)."""
    from go_crdt_playground_tpu_torch.parallel.meshtarget2d import \
        parse_mesh_spec

    parsed = parse_mesh_spec(str(spec))
    return parsed if isinstance(parsed, int) else parsed[0] * parsed[1]


def mesh_device() -> str:
    """The device of a mesh worker's slots: ``--device`` when it names
    one device (``cuda:0``, ``cpu``: every slot on it), card 0 for
    ``cuda``."""
    return "cuda:0" if DEVICE == "cuda" else DEVICE


def _mesh_spec(devices, elements: int, seed: int, sched: str = None,
               **kw) -> FleetSpec:
    """A 1-shard fleet whose worker runs ``serve --mesh-devices N`` or
    ``DPxMP``; ``sched`` its ``--sched`` flag (None: the CLI's auto)."""
    _mesh_slots(devices)  # a malformed spec fails here
    extra_args = ("--mesh-devices", str(devices))
    if sched is not None:
        extra_args += ("--sched", sched)
    return FleetSpec(n_shards=1, elements=elements, seed=seed,
                     extra_args=extra_args, device=mesh_device(), **kw)


def _worker_banner(fleet: ShardFleet, field: str = "mesh") -> str:
    """A field of the worker's own serve banner (``mesh``, ``sched``)."""
    proc = fleet.shards[0]
    with proc._line_cond:
        lines = list(proc._lines)
    for ln in lines:
        m = re.search(field.encode() + rb"=(\w+)", ln)
        if m:
            return m.group(1).decode()
    return ""


def mesh_sweep_leg(root: str, devices, elements: int, rate: float,
                   duration_s: float, seed: int, keys=None,
                   sched: str = None, leg_dir: str = None,
                   **fleet_kw) -> Dict[str, object]:
    """One mesh spec's open-loop point through the router, with the
    worker's dispatch census (rows a dispatch, stripe cuts a
    super-batch, the scheduler's counters)."""
    spec = _mesh_spec(devices, elements, seed, sched=sched, **fleet_kw)
    fleet = ShardFleet(REPO, os.path.join(root, leg_dir or
                                          f"mesh-{devices}"), spec)
    try:
        addr = fleet.start()
        leg = open_loop_leg(addr, rate, duration_s, elements, keys=keys)
        leg["mesh_devices"] = devices
        leg["worker_banner_mesh"] = _worker_banner(fleet)
        if sched is not None:
            leg["worker_banner_sched"] = _worker_banner(fleet, "sched")
        try:
            with ServeClient(addr, timeout=10.0) as c:
                counters = c.stats()["aggregate"]["counters"]
            dispatches = counters.get("ingest.dispatches", 0)
            rows = counters.get("mesh.stripe.rows",
                                counters.get("serve.ops.acked", 0))
            cuts = counters.get("mesh.stripe.cuts", 0)
            batches = counters.get("serve.batches", 0)
            leg["server_mesh"] = {
                "dispatches": dispatches, "stripe_cuts": cuts,
                "cuts_per_super_batch": (round(cuts / batches, 3)
                                         if batches else 0.0),
                "rows_per_dispatch": (round(rows / dispatches, 2)
                                      if dispatches else 0.0),
                "sched": {k: counters[k] for k in
                          ("sched.keyruns", "sched.coalesced_rows",
                           "sched.deferred_rows") if k in counters}}
        except Exception as e:  # noqa: BLE001 — the census is evidence
            leg["server_mesh"] = {"error": str(e)}
        return leg
    finally:
        fleet.close()


def _restore_state(durable: str, elements: int):
    from go_crdt_playground_tpu_torch.net.peer import Node

    node = Node.restore_durable(
        durable, device="cpu",
        fallback_init=lambda: Node(0, elements, 1, device="cpu"))
    try:
        return node.state_slice(), set(node.members().tolist())
    finally:
        node.close()


def _mismatched(a, b) -> List[str]:
    import torch

    return [name for name, x, y in zip(a._fields, a, b)
            if not torch.equal(x, y)]


def mesh_parity_leg(root: str, devices, elements: int, seed: int,
                    vs=None) -> Dict[str, object]:
    """A mesh worker and a reference worker (plain, or the mesh spec
    ``vs``) fed the SAME op log serially through their routers land on
    byte-identical durable state after a graceful drain (both stores
    restored in-process and diffed field by field)."""
    import random

    specs = {"mesh": _mesh_spec(devices, elements, seed, flush_ms=1.0),
             "plain": (_spec(n_shards=1, elements=elements, seed=seed,
                             flush_ms=1.0) if vs is None
                       else _mesh_spec(vs, elements, seed, flush_ms=1.0))}
    roots = {k: os.path.join(root, f"parity-{k}") for k in specs}
    rng = random.Random(seed + 1)
    order = list(range(elements))
    rng.shuffle(order)
    ops: List = []
    added: List[int] = []
    for e in order:
        ops.append((protocol.OP_ADD, e))
        added.append(e)
        if len(added) % 5 == 0:
            ops.append((protocol.OP_DEL, added[rng.randrange(len(added))]))
    retries = 0
    banner = ""
    for name in ("mesh", "plain"):
        fleet = ShardFleet(REPO, roots[name], specs[name])
        try:
            addr = fleet.start()
            if name == "mesh":
                banner = _worker_banner(fleet)
            with ServeClient(addr, timeout=60.0) as c:
                for kind, e in ops:
                    while True:
                        try:
                            c.submit_async(kind, [e],
                                           deadline_s=30.0).wait(60.0)
                            break
                        except protocol.ServeError:
                            retries += 1
                            time.sleep(0.05)
        finally:
            fleet.close()  # graceful SIGTERM: drain + save_durable
    states = {k: _restore_state(os.path.join(r, "s0", "state"),
                                elements)[0] for k, r in roots.items()}
    mismatched = _mismatched(states["mesh"], states["plain"])
    return {"mesh_devices": devices, "vs": vs or "plain",
            "worker_banner_mesh": banner, "elements": elements,
            "ops": len(ops), "retries": retries,
            "bitwise_equal": not mismatched,
            "mismatched_fields": mismatched}


def mesh_crash_leg(root: str, devices, elements: int,
                   seed: int) -> Dict[str, object]:
    """Ledgered add-only traffic through the router; SIGKILL the mesh
    worker mid-stream (its keyspace rejects typed ShardUnavailable),
    restart it on its durable dir (``restore_durable`` re-placed onto
    the slots), resubmit: zero acked-op loss, zero phantoms."""
    import random

    rng = random.Random(seed + 2)
    spec = _mesh_spec(devices, elements, seed, flush_ms=1.0)
    fleet = ShardFleet(REPO, os.path.join(root, "mesh-crash"), spec)
    acked: Set[int] = set()
    submitted: Set[int] = set()
    outage = {"typed_unavailable": 0, "typed_other": 0, "unresolved": 0}
    try:
        addr = fleet.start()
        todo = workloads.shuffled_universe(elements, seed, rng=rng)
        n_pre = int(0.4 * len(todo))
        kill_at = n_pre + 1 + rng.randrange(max(1, len(todo) // 10))
        client = ServeClient(addr, timeout=30.0)
        try:
            for n, e in enumerate(todo):
                if n == kill_at:
                    fleet.kill_shard(0)
                submitted.add(e)
                try:
                    client.add(e, deadline_s=5.0)
                    acked.add(e)
                except protocol.ShardUnavailable:
                    outage["typed_unavailable"] += 1
                except protocol.ServeError:
                    outage["typed_other"] += 1
                except (OSError, ConnectionError, socket.timeout):
                    outage["unresolved"] += 1
        finally:
            client.close()
        acked_before_kill = len(acked)
        fleet.restart_shard(0)
        retry_deadline = time.monotonic() + 60.0
        remaining = [e for e in todo if e not in acked]
        retries = 0
        while remaining and time.monotonic() < retry_deadline:
            client = ServeClient(addr, timeout=30.0)
            try:
                still: List[int] = []
                for e in remaining:
                    try:
                        client.add(e, deadline_s=5.0)
                        acked.add(e)
                    except (protocol.ServeError, OSError,
                            ConnectionError, socket.timeout):
                        still.append(e)
                remaining = still
            finally:
                client.close()
            if remaining:
                retries += 1
                time.sleep(0.25)  # breaker half-open probe cadence
        with ServeClient(addr, timeout=60.0) as c:
            members, _ = c.members()
        members_set = set(members)
        return {
            "mesh_devices": devices, "elements": elements,
            "victim_acked_before_kill": acked_before_kill,
            "outage": outage, "resubmit_rounds": retries,
            "acked_ops": len(acked), "submitted_ops": len(submitted),
            "final_members": len(members_set),
            "lost_acked_ops": sorted(acked - members_set),
            "phantom_members": sorted(members_set - submitted),
            "unfinished": sorted(set(todo) - acked)}
    finally:
        fleet.close()


def run_mesh_mode(args) -> Dict[str, object]:
    """``--mesh``: the reference's ladders (quick: E = 144, 1 and 2
    slots, dp ``1x2`` and ``2x2``), the parity legs and the crash legs."""
    if args.quick:
        elements, device_counts = 144, [1, 2]
        dp_ladder = ["1x2", "2x2"]
        rate, duration_s = 400.0, 3.0
    else:
        elements, device_counts = 288, [1, 2, 4]
        dp_ladder = ["1x2", "2x2", "4x2"]
        rate, duration_s = 800.0, 6.0
    rate_2d = 1600.0
    deep, deep2d = device_counts[-1], dp_ladder[-1]
    # the dp ladder is batch-bottlenecked (max_batch 4, flush 10 ms):
    # goodput and rows a dispatch scale with dp, the effect under test
    ladder_kw = dict(max_batch=4, flush_ms=10.0)
    t0 = time.time()
    root = tempfile.mkdtemp(prefix="torch-mesh-soak-")
    curve: List[Dict] = []
    curve_2d: List[Dict] = []
    try:
        for n in device_counts:
            leg = mesh_sweep_leg(root, n, elements, rate, duration_s,
                                 args.seed)
            curve.append(leg)
            print(json.dumps(leg), flush=True)
        for spec in dp_ladder:
            leg = mesh_sweep_leg(root, spec, elements, rate_2d, duration_s,
                                 args.seed, **ladder_kw)
            curve_2d.append(leg)
            print(json.dumps(leg), flush=True)
        parity = mesh_parity_leg(root, deep, elements, args.seed)
        print(json.dumps({"mesh_parity": parity}), flush=True)
        parity_2d = mesh_parity_leg(os.path.join(root, "p2d"), deep2d,
                                    elements, args.seed + 7, vs=str(deep))
        print(json.dumps({"mesh_parity_2d": parity_2d}), flush=True)
        crash = mesh_crash_leg(root, deep, elements, args.seed)
        crash_2d = mesh_crash_leg(os.path.join(root, "c2d"), deep2d,
                                  elements, args.seed + 11)
        for name, leg in (("mesh_crash", crash), ("mesh_crash_2d",
                                                  crash_2d)):
            print(json.dumps({name: {k: leg[k] for k in (
                "outage", "acked_ops", "victim_acked_before_kill",
                "lost_acked_ops", "phantom_members",
                "resubmit_rounds")}}), flush=True)
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    return {
        "fleet": {"elements": elements, "offered_rate": rate,
                  "duration_s": duration_s, "seed": args.seed,
                  "quick": bool(args.quick)},
        "fleet_2d": {"elements": elements, "offered_rate": rate_2d,
                     "duration_s": duration_s, **ladder_kw},
        "device": DEVICE, "slots_device": mesh_device(),
        "serve_curve": curve, "serve_curve_2d": curve_2d,
        "parity": parity, "parity_2d": parity_2d,
        "crash": crash, "crash_2d": crash_2d,
        "elapsed_s": round(time.time() - t0, 1)}


def _crash_checks(prefix: str, leg: Dict[str, object]) -> List[Check]:
    return [_l(f"{prefix}/typed_unavailable",
               leg["outage"]["typed_unavailable"] > 0),
            _g(f"{prefix}/unresolved", leg["outage"]["unresolved"] == 0),
            _l(f"{prefix}/victim_acked_before_kill",
               leg["victim_acked_before_kill"] > 0),
            *_ledger_checks(prefix, leg),
            _g(f"{prefix}/unfinished", leg["unfinished"] == [])]


def checks_mesh(r: Dict[str, object]) -> List[Check]:
    """The reference's adjudication: every op resolved, each worker's
    banner its spec, the widest dp committing over 1.5x the rows a
    dispatch of dp = 1 without losing goodput, both parity pins and
    both crash legs."""
    legs = r["serve_curve"] + r["serve_curve_2d"]
    c2d = r["serve_curve_2d"]

    def rpd(leg):
        return leg.get("server_mesh", {}).get("rows_per_dispatch", 0.0)

    return [
        _g("mesh/unresolved", all(leg["unresolved"] == 0 for leg in legs)),
        _l("mesh/goodput", all(leg["goodput"] > 0 for leg in legs)),
        _l("mesh/worker_banner",
           all(leg["worker_banner_mesh"] == str(leg["mesh_devices"])
               for leg in legs)),
        _l("mesh/dp_rows_per_dispatch",
           rpd(c2d[0]) > 0 and rpd(c2d[-1]) > 1.5 * rpd(c2d[0])),
        _l("mesh/dp_goodput", c2d[-1]["goodput"] > 0.9 * c2d[0]["goodput"]),
        _g("mesh/parity_bitwise",
           r["parity"]["bitwise_equal"] and r["parity"]["ops"] > 0),
        _g("mesh/parity_2d_bitwise",
           r["parity_2d"]["bitwise_equal"] and r["parity_2d"]["ops"] > 0),
        *_crash_checks("mesh/crash", r["crash"]),
        *_crash_checks("mesh/crash_2d", r["crash_2d"])]


# ---------------------------------------------------------------------------
# zipf hot-key legs (the admission scheduler): `--zipf` mode
# ---------------------------------------------------------------------------


def zipf_replay_leg(root: str, devices, elements: int, seed: int,
                    s: float = 1.2, rate: float = 800.0,
                    duration_s: float = 3.0,
                    **fleet_kw) -> Dict[str, object]:
    """A scheduled mesh worker takes concurrent zipf traffic, is
    SIGKILLed with no final checkpoint, and its durable log (written in
    the scheduler's emitted order) must replay to one state through a
    plain sequential node (on a copy) and through the worker's own mesh
    restore (its drain checkpoint restored again), bitwise; every acked
    add a member, every member submitted.  Deletes off, so the ledger's
    membership algebra stays exact under retries."""
    import shutil as _shutil

    spec = _mesh_spec(devices, elements, seed, sched="on", **fleet_kw)
    fleet = ShardFleet(REPO, os.path.join(root, "zipf-replay"), spec)
    try:
        addr = fleet.start()
        keys = workloads.ZipfKeys(elements, s=s, seed=seed)
        leg = open_loop_leg(addr, rate, duration_s, elements, keys=keys,
                            del_every=0, ledgered=True)
        banner_sched = _worker_banner(fleet, "sched")
        fleet.kill_shard(0)
        durable = os.path.join(root, "zipf-replay", "s0", "state")
        seq_copy = os.path.join(root, "zipf-replay", "seq-copy")
        _shutil.copytree(durable, seq_copy)
        seq_state, seq_members = _restore_state(seq_copy, elements)
        fleet.restart_shard(0)
        with ServeClient(addr, timeout=30.0) as c:
            members, _vv = c.members()
        mesh_members = set(members)
        fleet.close()  # graceful: the mesh-restored state's checkpoint
        mesh_state, _ = _restore_state(durable, elements)
        mismatched = _mismatched(seq_state, mesh_state)
        acked = set(leg.get("acked_elements", []))
        submitted = set(leg.get("submitted_elements", []))
        return {
            "mesh_devices": devices, "workload": keys.name,
            "worker_banner_sched": banner_sched, "elements": elements,
            "acked_adds": len(acked),
            "traffic": {k: leg[k] for k in
                        ("submitted", "acked", "goodput", "unresolved",
                         "shed_overloaded", "p99_ms")},
            "bitwise_equal": not mismatched,
            "mismatched_fields": mismatched,
            "members_agree": seq_members == mesh_members,
            "lost_acked_ops": sorted(acked - seq_members),
            "phantom_members": sorted(seq_members - submitted)}
    finally:
        fleet.close()


def run_zipf_mode(args) -> Dict[str, object]:
    """``--zipf``: scheduled dp-ladder legs at s in {0.99, 1.2} (quick:
    ``1x2``, ``4x2``), the unscheduled baseline at the widest dp and the
    harshest exponent, and the SIGKILL replay leg."""
    if args.quick:
        elements, dp_ladder, duration_s = 144, ["1x2", "4x2"], 3.0
    else:
        elements, dp_ladder, duration_s = 288, ["1x2", "2x2", "4x2"], 6.0
    exponents = [0.99, 1.2]
    rate = 1600.0
    deep2d = dp_ladder[-1]
    # batch-bottlenecked at max_batch 8: wide super-batches are where
    # arrival-order stripe packing degenerates under skew
    ladder_kw = dict(max_batch=8, flush_ms=10.0)
    t0 = time.time()
    root = tempfile.mkdtemp(prefix="torch-zipf-soak-")
    curve: List[Dict] = []
    try:
        for s in exponents:
            for spec in dp_ladder:
                keys = workloads.ZipfKeys(elements, s=s, seed=args.seed)
                leg = mesh_sweep_leg(
                    root, spec, elements, rate, duration_s, args.seed,
                    keys=keys, sched="on",
                    leg_dir=f"zipf-{spec}-s{s:g}-on", **ladder_kw)
                leg["zipf_s"], leg["sched"] = s, "on"
                curve.append(leg)
                print(json.dumps(leg), flush=True)
        baseline = mesh_sweep_leg(
            root, deep2d, elements, rate, duration_s, args.seed,
            keys=workloads.ZipfKeys(elements, s=exponents[-1],
                                    seed=args.seed),
            sched="off", leg_dir=f"zipf-{deep2d}-s{exponents[-1]:g}-off",
            **ladder_kw)
        baseline["zipf_s"], baseline["sched"] = exponents[-1], "off"
        print(json.dumps(baseline), flush=True)
        replay = zipf_replay_leg(root, deep2d, elements, args.seed + 3,
                                 s=exponents[-1], **ladder_kw)
        print(json.dumps({"zipf_replay": replay}), flush=True)
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    return {
        "fleet": {"elements": elements, "offered_rate": rate,
                  "duration_s": duration_s, "seed": args.seed,
                  "exponents": exponents, "dp_ladder": dp_ladder,
                  "quick": bool(args.quick), **ladder_kw},
        "device": DEVICE, "slots_device": mesh_device(),
        "zipf_curve": curve, "zipf_baseline": baseline,
        "zipf_replay": replay, "elapsed_s": round(time.time() - t0, 1)}


def checks_zipf(r: Dict[str, object]) -> List[Check]:
    """The reference's adjudication on one worker's own counters: at
    the harshest exponent and the widest dp, cuts a super-batch at
    least 5x fewer than the unscheduled baseline (which must cut), rows
    a dispatch over 1.5x the dp = 1 leg's; the replay leg bitwise."""
    curve, base, rep = r["zipf_curve"], r["zipf_baseline"], r["zipf_replay"]
    harsh_s = max(leg["zipf_s"] for leg in curve)
    harsh = [leg for leg in curve if leg["zipf_s"] == harsh_s]
    deep, dp1 = harsh[-1], harsh[0]

    def census(leg, key, default=None):
        return leg.get("server_mesh", {}).get(key, default)

    sched_cps = census(deep, "cuts_per_super_batch")
    base_cps = census(base, "cuts_per_super_batch")
    legs = curve + [base]
    return [
        _g("zipf/unresolved", all(leg["unresolved"] == 0 for leg in legs)),
        _l("zipf/goodput", all(leg["goodput"] > 0 for leg in legs)),
        _l("zipf/worker_banner",
           all(leg["worker_banner_mesh"] == str(leg["mesh_devices"])
               and leg["worker_banner_sched"] == leg["sched"]
               for leg in legs)),
        _l("zipf/cuts_reduced_5x",
           sched_cps is not None and base_cps is not None
           and base_cps > 0 and base_cps >= 5 * sched_cps),
        _l("zipf/rows_per_dispatch",
           census(dp1, "rows_per_dispatch", 0.0) > 0
           and census(deep, "rows_per_dispatch", 0.0)
           > 1.5 * census(dp1, "rows_per_dispatch", 0.0)),
        _g("zipf/replay_bitwise",
           rep["bitwise_equal"] and rep["members_agree"]),
        _l("zipf/replay_acked", rep["acked_adds"] > 0),
        *_ledger_checks("zipf/replay", rep),
        _g("zipf/replay_unresolved", rep["traffic"]["unresolved"] == 0)]


def run_sweep(args) -> Dict[str, object]:
    if args.quick:
        elements = 144
        shard_counts = [1, 3]
        rate, duration_s = 600.0, 3.0
        kill_shards = 3
    else:
        elements = 288
        shard_counts = [1, 2, 3, 4]
        rate, duration_s = 1200.0, 6.0
        kill_shards = 3
    t0 = time.time()
    root = tempfile.mkdtemp(prefix="torch-fleet-soak-")
    curve: List[Dict] = []
    try:
        for n in shard_counts:
            leg = sweep_leg(root, n, elements, rate, duration_s,
                            args.seed)
            curve.append(leg)
            print(json.dumps(leg), flush=True)
        kill = kill_leg(root, kill_shards, elements, args.seed)
        print(json.dumps({"kill": {k: kill[k] for k in
                                   ("outage", "outage_s", "acked_ops",
                                    "lost_acked_ops", "phantom_members",
                                    "resubmit_rounds")}}), flush=True)
        reshard = reshard_leg(root, elements, args.seed, args.quick)
        print(json.dumps({"reshard": {k: reshard[k] for k in
                                      ("events", "traffic", "acked_ops",
                                       "lost_acked_ops",
                                       "phantom_members")}}), flush=True)
        chaos = chaos_leg(root, elements, args.seed)
        print(json.dumps({"chaos": {k: chaos[k] for k in
                                    ("outage", "proxy", "acked_ops",
                                     "lost_acked_ops", "phantom_members",
                                     "resubmit_rounds")}}), flush=True)
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    return {
        "fleet": {"elements": elements, "offered_rate": rate,
                  "duration_s": duration_s, "seed": args.seed,
                  "quick": bool(args.quick)},
        "device": DEVICE,
        "shard_curve": curve,
        "kill_leg": kill,
        "reshard_leg": reshard,
        "chaos_leg": chaos,
        "elapsed_s": round(time.time() - t0, 1),
    }


MODES = {
    "sweep": (run_sweep, lambda r, a: checks_sweep(r, a.quick)),
    "router_ha": (run_router_ha_mode, lambda r, a: checks_router_ha(r)),
    "shard_repl": (run_shard_repl_mode, lambda r, a: checks_shard_repl(r)),
    "autopilot": (run_autopilot_mode, lambda r, a: checks_autopilot(r)),
    "mesh": (run_mesh_mode, lambda r, a: checks_mesh(r)),
    "zipf": (run_zipf_mode, lambda r, a: checks_zipf(r)),
}


def main(argv: Optional[List[str]] = None) -> int:
    global DEVICE
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true",
                    help="the reference's CI-sized legs")
    modes = ap.add_mutually_exclusive_group()
    modes.add_argument("--router-ha", dest="router_ha",
                       action="store_true",
                       help="router warm-standby failover soak")
    modes.add_argument("--shard-repl", dest="shard_repl",
                       action="store_true",
                       help="shard replication-group soak")
    modes.add_argument("--autopilot", action="store_true",
                       help="fleet-autopilot soak")
    modes.add_argument("--mesh", action="store_true",
                       help="device-mesh replica soak")
    modes.add_argument("--zipf", action="store_true",
                       help="admission scheduler under zipf hot keys")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every shard (default cuda; cpu "
                         "runs the kernels' plain versions)")
    ap.add_argument("--out", default=None,
                    help="write the result, its checks and failures here")
    ap.add_argument("--seed", type=int, default=29)
    args = ap.parse_args(argv)
    DEVICE = args.device
    mode = ("router_ha" if args.router_ha else
            "shard_repl" if args.shard_repl else
            "autopilot" if args.autopilot else
            "mesh" if args.mesh else "zipf" if args.zipf else "sweep")
    run, checks_of = MODES[mode]
    t0 = time.monotonic()
    result = run(args)
    checks = checks_of(result, args) if result else [
        _g(f"{mode}/ran", False)]
    failed = [c.name for c in checks if not c.ok]
    guarantee_failed = [c.name for c in checks
                        if not c.ok and c.guarantee]
    summary = {"mode": mode, "device": DEVICE, "quick": bool(args.quick),
               "wall_s": round(time.monotonic() - t0, 3),
               "checks": len(checks), "failures": failed,
               "guarantee_failures": guarantee_failed}
    print(json.dumps({"checks": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**summary, "result": result}, f, indent=2)
            f.write("\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
