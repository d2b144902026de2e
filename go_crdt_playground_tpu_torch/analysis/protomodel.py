"""Exhaustive protocol model checking for the fenced-epoch ladder
(DESIGN.md §26; E003/E004).

The promotion/fencing protocols — router HA promotion (§22), shard
replication failover (§23), keyspace handoff (§18) — are exactly the
code whose bugs unit tests miss: the hazard lives in one interleaving
of promote vs resurrect vs crash that no scripted test schedules.
This module holds EXECUTABLE MODELS of the three protocols at small
scope (one primary, one standby, bounded epochs/ops/rounds) and an
explicit-state explorer that enumerates EVERY interleaving, crash
injection included, checking the protocol invariants on each
transition.  Small-scope exhaustiveness over large-scope sampling: the
bug classes here (persist/announce swapped, ack without standby
coverage, swap before the committed record) all bite within two
actors and two rounds.

Explorer.  A model is three methods: ``initial() -> dict`` (the start
state; values must be hashable), ``actions(state) -> [(label, next)]``
(every enabled transition — crash and restart are ordinary actions),
``invariants(prev, label, state) -> [violation strings]``.  The
explorer runs breadth-first with state-hash dedup, keeps parent
pointers for shortest-trace reconstruction, and reports complete=True
iff the frontier drained below the state cap — a cap hit is reported,
never silently truncated into "verified".

Each model also takes a ``bug=`` constructor flag that re-introduces a
real bug class (the swapped persist/announce twin, the gate-less ack,
the swap-before-persist commit).  Those are not dead weight: the
planted-violation tests promote them to proof that the checker can
still FAIL — a gate that cannot fail proves nothing.

Deliberate abstractions (checked elsewhere or out of scope): the
semi-sync degrade window (its async acks are typed non-covered, so
they are outside the zero-acked-op-loss contract), WAL truncation
byte-level catch-up, and the false-positive-promotion write window on
an undeposed primary (those writes can never semi-sync ack — the gate
blocks without a tailing standby — so they shed typed, §23).

E003 keeps the models honest: every model pins the source segments it
mirrors (MODEL_MIRRORS, F001-style short hashes).  Editing a mirrored
protocol function without re-verifying the model fails the gate with
MODEL_STALE; ``python -m go_crdt_playground_tpu_torch.analysis.protomodel``
prints the refreshed table to paste after re-verification.
"""

from __future__ import annotations

import hashlib
import os
from collections import deque
from typing import (Callable, Dict, Iterable, List, NamedTuple, Optional,
                    Sequence, Tuple)

from go_crdt_playground_tpu_torch.analysis.epoch_order import _find_function
from go_crdt_playground_tpu_torch.analysis.loader import (
    SourceLoader, ensure_loader)
from go_crdt_playground_tpu_torch.analysis.report import (
    MODEL_STALE, MODEL_VIOLATION, SEVERITY_ERROR, Finding)

# -- the explorer -----------------------------------------------------------


class Violation(NamedTuple):
    message: str
    trace: Tuple[str, ...]   # action labels, initial state to violation


class Result(NamedTuple):
    states: int
    transitions: int
    violations: Tuple[Violation, ...]
    complete: bool           # False iff the state cap cut exploration


def _freeze(state: Dict) -> Tuple:
    return tuple(sorted(state.items()))


def explore(model, max_states: int = 100000,
            max_violations: int = 8) -> Result:
    """Exhaust the model's state graph.  Invariants run on the initial
    state and on every TRANSITION (prev, label, next) — including
    re-entries to already-seen states, so transition-shaped invariants
    (e.g. monotonicity) see every edge, deduped by message."""
    init = dict(model.initial())
    f0 = _freeze(init)
    parents: Dict[Tuple, Tuple[Optional[Tuple], Optional[str]]] = {
        f0: (None, None)}
    seen = {f0}
    queue = deque([init])
    violations: List[Violation] = []
    reported = set()

    def _trace(fz: Tuple, last: Optional[str]) -> Tuple[str, ...]:
        labels: List[str] = [] if last is None else [last]
        while fz in parents:
            fz, label = parents[fz]
            if label is None:
                break
            labels.append(label)
        return tuple(reversed(labels))

    for msg in model.invariants(None, None, init):
        if msg not in reported:
            reported.add(msg)
            violations.append(Violation(msg, ()))
    transitions = 0
    complete = True
    while queue:
        state = queue.popleft()
        fz = _freeze(state)
        for label, nxt in model.actions(state):
            transitions += 1
            nfz = _freeze(nxt)
            if nfz not in seen:
                if len(seen) >= max_states:
                    complete = False
                    continue
                seen.add(nfz)
                parents[nfz] = (fz, label)
                queue.append(nxt)
            for msg in model.invariants(state, label, nxt):
                if (msg not in reported
                        and len(violations) < max_violations):
                    reported.add(msg)
                    base = _trace(fz, None)
                    violations.append(Violation(msg, base + (label,)))
    return Result(len(seen), transitions, tuple(violations), complete)


# -- model 1: router HA promotion (§22) -------------------------------------


class RouterHAModel:
    """RouterStandby promotion vs primary resurrection, one durable
    shard as the adjudication tier.  Mirrors ``shard/ha.py``'s
    ``_promote_locked`` spine: claim epoch = max(tailed, disk)+1,
    persist it, announce to the shard (which adjudicates the max and
    thereafter refuses lower-epoch routers), best-effort RING_SYNC
    deposition of the old primary (optional — network blip or dead
    primary skips it), then serve.  A resurrected primary probes the
    shard and self-fences iff a higher epoch was adjudicated
    (``ShardRouter.deposed`` / serve()-time announce).

    bug="announce_before_persist" reorders steps 1 and 3: the claimed
    epoch reaches the shard before it is durable, so a crash between
    the two re-promotes at the SAME epoch — the E001 bug class,
    demonstrated here as an actual two-incarnations-one-epoch run."""

    name = "router_ha"
    MAX_ROUNDS = 2

    def __init__(self, bug: Optional[str] = None) -> None:
        assert bug in (None, "announce_before_persist"), bug
        self.bug = bug

    def initial(self) -> Dict:
        return {"shard": 0,        # adjudicated router epoch (durable)
                "disk": 0,         # standby state_dir epoch (durable)
                "p": "up", "p_epoch": 0,
                "s": "idle", "s_epoch": 0,
                "rounds": 0,
                # (round, epoch) pairs that reached the announce step
                "claims": frozenset()}

    def actions(self, st: Dict) -> List[Tuple[str, Dict]]:
        out: List[Tuple[str, Dict]] = []

        def step(label: str, **upd) -> None:
            nxt = dict(st)
            nxt.update(upd)
            out.append((label, nxt))

        s, p = st["s"], st["p"]
        if s == "idle" and st["rounds"] < self.MAX_ROUNDS:
            epoch = max(st["p_epoch"], st["disk"]) + 1
            step("s:claim", s="claimed", s_epoch=epoch,
                 rounds=st["rounds"] + 1)
        announced = {"shard": max(st["shard"], st["s_epoch"]),
                     "claims": st["claims"]
                     | {(st["rounds"], st["s_epoch"])}}
        if self.bug == "announce_before_persist":
            if s == "claimed":
                step("s:announce", s="announced", **announced)
            if s == "announced":
                step("s:persist", s="ready", disk=st["s_epoch"])
        else:
            if s == "claimed":
                step("s:persist", s="persisted", disk=st["s_epoch"])
            if s == "persisted":
                step("s:announce", s="ready", **announced)
        if s == "ready":
            if p == "up":
                # best-effort RING_SYNC deposition (3b) — serve below
                # stays enabled without it (blip / dead primary)
                step("s:notice", p="fenced")
            step("s:serve", s="serving")
        if s in ("claimed", "persisted", "announced", "ready"):
            step("s:crash", s="crashed")
        if s == "crashed":
            step("s:restart", s="idle")
        if p == "up":
            step("p:crash", p="crashed")
        if p == "crashed":
            # restart probe: the shards remember the adjudicated epoch
            step("p:restart",
                 p="fenced" if st["shard"] > st["p_epoch"] else "up")
        return out

    def invariants(self, prev: Optional[Dict], label: Optional[str],
                   st: Dict) -> List[str]:
        out: List[str] = []
        if (st["p"] == "up" and st["p_epoch"] >= st["shard"]
                and st["s"] == "serving"
                and st["s_epoch"] >= st["shard"]):
            out.append("single-writer: primary and promoted standby "
                       "can both commit through the shard tier")
        epochs = [e for _, e in st["claims"]]
        if len(set(epochs)) < len(epochs):
            out.append("epoch-uniqueness: two promotion incarnations "
                       "announced the same router epoch (a crash "
                       "between announce and persist resurrects the "
                       "epoch)")
        if prev is not None and st["shard"] < prev["shard"]:
            out.append("epoch-monotonicity: the shard-adjudicated "
                       "router epoch went backwards")
        return out


# -- model 2: shard replication failover (§23) ------------------------------


class ShardReplModel:
    """Semi-sync replication plus standby failover: the contract is
    ZERO ACKED-OP LOSS — every op acked under the semi-sync gate is on
    the member the router reads after any crash/failover sequence.
    Mirrors ``ReplicationPublisher.gate`` (ack only once the standby
    cursor covers the WAL tail), ``ShardStandby._promote_locked``
    (persist shard epoch, announce to the router, serve), and
    ``ShardRouter.failover_shard`` (adjudicate max epoch, depose
    lower-epoch resurrections via the stale check).

    bug="ack_without_coverage" drops the gate's coverage condition —
    the crash-then-promote run then serves with acked records missing,
    which is precisely the loss the gate exists to prevent."""

    name = "shard_repl"
    MAX_WAL = 2
    MAX_ROUNDS = 2

    def __init__(self, bug: Optional[str] = None) -> None:
        assert bug in (None, "ack_without_coverage"), bug
        self.bug = bug

    def initial(self) -> Dict:
        return {"wal": 0,      # primary WAL length
                "acked": 0,    # semi-sync acked prefix
                "cursor": 0,   # standby's replicated prefix (durable)
                "p": "up", "s": "idle", "s_epoch": 0,
                "disk": 0,     # standby durable shard epoch
                "adjud": 0,    # router-adjudicated shard epoch
                "rounds": 0}

    def actions(self, st: Dict) -> List[Tuple[str, Dict]]:
        out: List[Tuple[str, Dict]] = []

        def step(label: str, **upd) -> None:
            nxt = dict(st)
            nxt.update(upd)
            out.append((label, nxt))

        if st["p"] == "up":
            if st["wal"] < self.MAX_WAL:
                step("client:op", wal=st["wal"] + 1)
            if st["s"] == "idle" and st["cursor"] < st["wal"]:
                # WAL shipping: the standby tails while unpromoted
                step("repl:ship", cursor=st["cursor"] + 1)
            if st["acked"] < st["wal"] and (
                    self.bug == "ack_without_coverage"
                    or st["cursor"] >= st["wal"]):
                step("p:ack", acked=st["wal"])
            step("p:crash", p="crashed")
        if st["p"] == "crashed":
            # resurrection announce: the router's stale check deposes
            # a member below the adjudicated epoch
            step("p:restart",
                 p="deposed" if st["adjud"] > 0 else "up")
        if st["s"] == "idle" and st["rounds"] < self.MAX_ROUNDS:
            epoch = st["disk"] + 1
            step("s:promote_persist", s="persisted", s_epoch=epoch,
                 disk=epoch, rounds=st["rounds"] + 1)
        if st["s"] == "persisted":
            step("s:announce", s="announced",
                 adjud=max(st["adjud"], st["s_epoch"]))
        if st["s"] == "announced":
            if st["p"] == "up":
                # best-effort WAL_SYNC deposition; serving never
                # waits on it
                step("s:notice", p="deposed")
            step("s:serve", s="serving")
        if st["s"] in ("persisted", "announced"):
            step("s:crash", s="crashed")
        if st["s"] == "crashed":
            step("s:restart", s="idle")
        return out

    def invariants(self, prev: Optional[Dict], label: Optional[str],
                   st: Dict) -> List[str]:
        out: List[str] = []
        if st["s"] == "serving" and st["cursor"] < st["acked"]:
            out.append("acked-op-loss: the promoted standby serves "
                       "without records the primary acked under the "
                       "semi-sync gate")
        if prev is not None and st["adjud"] < prev["adjud"]:
            out.append("epoch-monotonicity: the router-adjudicated "
                       "shard epoch went backwards")
        return out


# -- model 3: keyspace handoff commit (§18) ---------------------------------


class HandoffModel:
    """The FENCED -> COMMITTED | ABORTED spine of
    ``HandoffCoordinator._run`` with a SIGKILL available at every
    transition: stage, fence, drain, transfer, persist the COMMITTED
    record, then the atomic in-memory route swap
    (``ShardRouter.commit_route``); every pre-commit failure funnels
    through clear_fence + ABORTED.  A crash loses all in-memory state;
    restart recovery adopts the durable record (committed -> new ring,
    anything else -> old ring, fence gone either way).

    Invariants: the in-memory ring never swaps before the COMMITTED
    record is durable; an ABORTED record is only ever written while
    the old ring is provably the active route; the fence never blocks
    reads; recovery lands on the ring the durable record names.

    bug="swap_before_persist" commits in-memory first — the persist
    failure then funnels to the abort arm AFTER the irreversible swap,
    the exact hazard the ordering comment in ``_run`` documents.
    bug="fence_blocks_reads" makes the fence reject reads, violating
    the fences-never-block-reads contract (the fence covers moved-
    element WRITES only)."""

    name = "handoff"

    def __init__(self, bug: Optional[str] = None) -> None:
        assert bug in (None, "swap_before_persist",
                       "fence_blocks_reads"), bug
        self.bug = bug

    def initial(self) -> Dict:
        return {"phase": "idle", "durable": "none", "route": "old",
                "fence": False, "reads_blocked": False}

    def actions(self, st: Dict) -> List[Tuple[str, Dict]]:
        out: List[Tuple[str, Dict]] = []

        def step(label: str, **upd) -> None:
            nxt = dict(st)
            nxt.update(upd)
            out.append((label, nxt))

        ph = st["phase"]
        if ph == "idle":
            step("c:stage", phase="staged", durable="staged")
        if ph == "staged":
            step("c:fence", phase="fenced", fence=True,
                 reads_blocked=(self.bug == "fence_blocks_reads"))
        if ph == "fenced":
            step("c:drain", phase="drained")
        if ph == "drained":
            step("c:transfer", phase="transferred")
        if self.bug == "swap_before_persist":
            if ph == "transferred":
                step("c:swap", phase="swapped", route="new",
                     fence=False, reads_blocked=False)
            if ph == "swapped":
                step("c:persist_committed", phase="done",
                     durable="committed")
        else:
            if ph == "transferred":
                step("c:persist_committed", phase="committed",
                     durable="committed")
            if ph == "committed":
                step("c:swap", phase="done", route="new",
                     fence=False, reads_blocked=False)
        abortable = ("staged", "fenced", "drained", "transferred")
        if self.bug == "swap_before_persist":
            # the persist failure now lands AFTER the swap and still
            # funnels through the abort arm — the modeled hazard
            abortable += ("swapped",)
        if ph in abortable:
            step("c:fail", phase="aborting", fence=False,
                 reads_blocked=False)
        if ph == "aborting":
            step("c:persist_aborted", phase="aborted",
                 durable="aborted")
        if ph not in ("crashed", "recovered"):
            # SIGKILL: in-memory fence state dies with the process
            step("crash", phase="crashed", fence=False,
                 reads_blocked=False)
        if ph == "crashed":
            step("restart", phase="recovered",
                 route=("new" if st["durable"] == "committed"
                        else "old"))
        return out

    def invariants(self, prev: Optional[Dict], label: Optional[str],
                   st: Dict) -> List[str]:
        out: List[str] = []
        if st["reads_blocked"]:
            out.append("fence-blocks-reads: the handoff fence rejected "
                       "a read (it covers moved-element writes only)")
        if (st["route"] == "new" and st["durable"] != "committed"
                and st["phase"] != "crashed"):
            out.append("swap-before-durable: the in-memory ring "
                       "swapped before the COMMITTED record persisted "
                       "(a crash or abort here misreports the active "
                       "ring)")
        if st["durable"] == "aborted" and st["route"] == "new":
            out.append("abort-inconsistency: an ABORTED record was "
                       "written while the new ring is the active "
                       "route — 'aborted' must prove the old ring "
                       "serves")
        if (st["phase"] == "recovered"
                and (st["durable"] == "committed")
                != (st["route"] == "new")):
            out.append("recovery-mismatch: restart landed on a ring "
                       "the durable record does not name")
        return out


# factories, not instances: every exploration starts from a fresh
# bug-free model
MODELS: Tuple[Tuple[str, Callable[[], object]], ...] = (
    ("router_ha", RouterHAModel),
    ("shard_repl", ShardReplModel),
    ("handoff", HandoffModel),
)


# -- E003: model freshness --------------------------------------------------


class MirrorSpec(NamedTuple):
    model: str
    path: str        # package-relative file
    qualname: str    # "Class.method"
    sha: str         # 16-hex sha256 prefix of the pinned segment


def _segment_hash(source: str, node) -> str:
    lines = source.splitlines()[node.lineno - 1:node.end_lineno]
    blob = "\n".join(ln.rstrip() for ln in lines)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


# THE mirror table: each model pins the source segments it abstracts —
# the port's own.  Each segment was held against the reference's pinned
# one; the four that differ (router_ha's _promote_locked and
# _handle_ring_sync, shard_repl's _promote_locked and _handle_wal_sync)
# differ only in the package named by their function-scope imports, so
# the models' transitions are the reference's.
# Refresh (after re-verifying the model against the changed protocol):
#     python -m go_crdt_playground_tpu_torch.analysis.protomodel
MODEL_MIRRORS: Tuple[MirrorSpec, ...] = (
    MirrorSpec('router_ha', 'shard/ha.py',
               'RouterStandby._promote_locked', 'c35e3d7508f6c069'),
    MirrorSpec('router_ha', 'shard/router.py',
               'ShardRouter.deposed', 'bd8bfc7a7ef5a869'),
    MirrorSpec('router_ha', 'serve/frontend.py',
               'ServeFrontend._handle_ring_sync', '3d430dfabe3d614e'),
    MirrorSpec('shard_repl', 'shard/replica.py',
               'ShardStandby._promote_locked', '54684f297f0a773a'),
    MirrorSpec('shard_repl', 'shard/replica.py',
               'ReplicationPublisher.gate', '869653ab50148e17'),
    MirrorSpec('shard_repl', 'shard/router.py',
               'ShardRouter.failover_shard', '107054f3de950252'),
    MirrorSpec('shard_repl', 'serve/frontend.py',
               'ServeFrontend._handle_wal_sync', '9996c9814c76b987'),
    MirrorSpec('handoff', 'shard/handoff.py',
               'HandoffCoordinator._run', '66c8fe8ced76e461'),
    MirrorSpec('handoff', 'shard/router.py',
               'ShardRouter.commit_route', '8319007e8f48365f'),
    MirrorSpec('handoff', 'shard/router.py',
               'ShardRouter.set_fence', '9a008dfe56ffd536'),
)


def check_freshness(root: str,
                    mirrors: Sequence[MirrorSpec] = MODEL_MIRRORS,
                    loader: Optional[SourceLoader] = None
                    ) -> Tuple[List[Finding], Dict]:
    loader = ensure_loader(loader)
    findings: List[Finding] = []
    fresh = 0
    for spec in mirrors:
        path = os.path.join(root, spec.path)
        pf = loader.load(path)
        fn = _find_function(pf.tree, spec.qualname)
        if fn is None:
            findings.append(Finding(
                analyzer="protomodel", code=MODEL_STALE,
                severity=SEVERITY_ERROR, path=path,
                symbol=spec.qualname,
                message=(f"model {spec.model!r} mirrors "
                         f"{spec.qualname}, which no longer exists in "
                         f"{spec.path} — re-verify the model against "
                         "the refactored protocol and re-pin the "
                         "mirror (python -m go_crdt_playground_tpu_torch."
                         "analysis.protomodel prints the table)")))
            continue
        cur = _segment_hash(pf.source, fn)
        if cur != spec.sha:
            findings.append(Finding(
                analyzer="protomodel", code=MODEL_STALE,
                severity=SEVERITY_ERROR, path=path, line=fn.lineno,
                symbol=spec.qualname,
                message=(f"model {spec.model!r} is stale against "
                         f"{spec.qualname} ({spec.path}): pinned "
                         f"segment {spec.sha}, current {cur} — the "
                         "protocol changed under the model; re-verify "
                         "the model's transitions, then refresh the "
                         "pin (python -m go_crdt_playground_tpu_torch."
                         "analysis.protomodel)")))
        else:
            fresh += 1
    return findings, {"mirrored_symbols": len(mirrors), "fresh": fresh}


# -- the gate pass ----------------------------------------------------------


def analyze(root: str,
            models: Iterable[Tuple[str, Callable[[], object]]] = MODELS,
            mirrors: Sequence[MirrorSpec] = MODEL_MIRRORS,
            loader: Optional[SourceLoader] = None,
            max_states: int = 100000) -> Tuple[List[Finding], Dict]:
    """Freshness first, then exhaust each model.  ``models`` is
    injectable so tests can run the gate over a bug-flagged twin and
    prove E004 fires."""
    findings, stats = check_freshness(root, mirrors, loader)
    model_stats: Dict[str, Dict] = {}
    total_states = 0
    for name, factory in models:
        res = explore(factory(), max_states=max_states)
        total_states += res.states
        model_stats[name] = {"states": res.states,
                             "transitions": res.transitions,
                             "complete": res.complete,
                             "violations": len(res.violations)}
        if not res.complete:
            findings.append(Finding(
                analyzer="protomodel", code=MODEL_VIOLATION,
                severity=SEVERITY_ERROR, symbol=name,
                message=(f"model {name!r} hit the {max_states}-state "
                         "cap before draining: the scope grew past "
                         "exhaustiveness — shrink the model bounds "
                         "(a sampled 'verified' is not verified)")))
        for v in res.violations:
            trace = " -> ".join(v.trace) or "<initial>"
            findings.append(Finding(
                analyzer="protomodel", code=MODEL_VIOLATION,
                severity=SEVERITY_ERROR, symbol=name,
                message=(f"model {name!r} violates [{v.message}] via: "
                         f"{trace}")))
    stats.update({"models": model_stats, "total_states": total_states})
    return findings, stats


def _print_mirror_table(root: str) -> None:
    loader = ensure_loader(None)
    print("MODEL_MIRRORS: Tuple[MirrorSpec, ...] = (")
    for spec in MODEL_MIRRORS:
        pf = loader.load(os.path.join(root, spec.path))
        fn = _find_function(pf.tree, spec.qualname)
        sha = "<MISSING>" if fn is None else _segment_hash(pf.source, fn)
        print(f"    MirrorSpec({spec.model!r}, {spec.path!r},\n"
              f"               {spec.qualname!r}, {sha!r}),")
    print(")")


if __name__ == "__main__":
    _print_mirror_table(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
