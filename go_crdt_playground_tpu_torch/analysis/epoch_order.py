"""E001 — epoch-persist-before-announce ordering lint (DESIGN.md §26).

Every fenced-epoch protocol in the tree (router HA §22, shard
replication §23, keyspace handoff §18) rests on the same two-step
contract: the claimed epoch is DURABLE before any other member can
hear it.  Persist-then-announce is what makes a crash mid-promotion
re-promote at an equal-or-higher epoch instead of resurrecting a
lower one; swapping the two steps is precisely the bug class that
cost the reference rounds of hand review (and that the protomodel
explorer demonstrates ends in two writers on one epoch).

This pass extends ``durability.py``'s source-order dominance machinery
from fsync/rename pairs to REGISTERED ordered call pairs: for each
``OrderSpec``, every call to an ``after`` name inside the named
function must be preceded — earlier source line, same function — by a
call to a ``before`` name.  The approximation is the same one D001
documents: these promotion paths are straight-line persist-then-act
sequences where source order and execution order agree; exotic control
flow belongs in review (and in the model checker), not in this lint.

A registered function that has disappeared (renamed, refactored away)
is itself an E001 finding — an ordering contract silently un-checked
is exactly the drift this ladder exists to catch.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from go_crdt_playground_tpu_torch.analysis.loader import (
    SourceLoader, ensure_loader)
from go_crdt_playground_tpu_torch.analysis.report import (
    EPOCH_ORDER, SEVERITY_ERROR, Finding)


class OrderSpec(NamedTuple):
    """One ordered-call-pair contract: inside ``path``:``qualname``,
    every call to a name in ``after`` must be dominated (earlier
    source line) by a call to a name in ``before``."""

    name: str                 # short label for findings/stats
    path: str                 # package-relative file
    qualname: str             # "Class.method" or module-level "fn"
    before: Tuple[str, ...]   # trailing callee names that persist
    after: Tuple[str, ...]    # trailing callee names that announce/act


# THE registry (DESIGN.md §26): the persist→announce spine of each
# fenced-epoch protocol.  ``before`` names are trailing callee names
# (``persist_router_epoch(...)`` however it is imported), so a rename
# of the persistence helper fails loud (function-missing arm) rather
# than silently matching nothing.
ORDER_SPECS: Tuple[OrderSpec, ...] = (
    # router HA promotion (§22): durable router epoch before the
    # announce fan-out, the deposition notice, and the listener bind
    OrderSpec("router-ha-promote", "shard/ha.py",
              "RouterStandby._promote_locked",
              before=("persist_router_epoch",),
              after=("announce_epoch", "ring_sync", "serve")),
    # shard replication failover (§23): durable shard epoch before the
    # frontend claim, the router announce, the old-primary deposition,
    # and serving
    OrderSpec("shard-repl-promote", "shard/replica.py",
              "ShardStandby._promote_locked",
              before=("persist_shard_epoch",),
              after=("claim_shard_epoch", "_announce_router", "wal_sync",
                     "serve")),
    # the router's adjudication half of the same protocol: the epoch
    # map persists before the link swap and the roster rewrite
    OrderSpec("router-failover-adjudicate", "shard/router.py",
              "ShardRouter.failover_shard",
              before=("persist_shard_epochs",),
              after=("_new_link", "_persist_addr_roster")),
    # keyspace handoff (§18): the COMMITTED record persists before the
    # atomic in-memory route swap (a crash between the two restarts
    # onto the persisted new ring; swapping them can report "aborted"
    # for a ring that irreversibly swapped)
    OrderSpec("handoff-commit", "shard/handoff.py",
              "HandoffCoordinator._run",
              before=("_persist",),
              after=("commit_route",)),
)


def _call_name(node: ast.Call) -> Optional[str]:
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    if isinstance(node.func, ast.Name):
        return node.func.id
    return None


def _find_function(tree: ast.Module, qualname: str
                   ) -> Optional[ast.FunctionDef]:
    if "." in qualname:
        cls_name, meth = qualname.split(".", 1)
        for node in tree.body:
            if isinstance(node, ast.ClassDef) and node.name == cls_name:
                for sub in node.body:
                    if (isinstance(sub, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                            and sub.name == meth):
                        return sub
        return None
    for node in tree.body:
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name == qualname):
            return node
    return None


def check_spec(spec: OrderSpec, tree: ast.Module, path: str
               ) -> Tuple[List[Finding], int]:
    """Findings plus the number of dominance points checked."""
    findings: List[Finding] = []
    fn = _find_function(tree, spec.qualname)
    if fn is None:
        findings.append(Finding(
            analyzer="epoch_order", code=EPOCH_ORDER,
            severity=SEVERITY_ERROR, path=path, symbol=spec.qualname,
            message=(f"registered ordering contract {spec.name!r} names "
                     f"{spec.qualname}, which no longer exists in "
                     f"{spec.path} — re-register the contract on the "
                     "renamed promotion path (an un-checked persist→"
                     "announce ordering is silent drift)")))
        return findings, 0
    persist_lines: List[int] = []
    act_sites: List[Tuple[int, str]] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name in spec.before:
            persist_lines.append(node.lineno)
        elif name in spec.after:
            act_sites.append((node.lineno, name))
    if not persist_lines:
        findings.append(Finding(
            analyzer="epoch_order", code=EPOCH_ORDER,
            severity=SEVERITY_ERROR, path=path, line=fn.lineno,
            symbol=spec.qualname,
            message=(f"{spec.qualname} contains no call to any of "
                     f"{sorted(spec.before)} — the {spec.name} protocol "
                     "acts on an epoch that was never persisted")))
    checked = 0
    for line, name in sorted(act_sites):
        checked += 1
        if not any(p < line for p in persist_lines):
            findings.append(Finding(
                analyzer="epoch_order", code=EPOCH_ORDER,
                severity=SEVERITY_ERROR, path=path, line=line,
                symbol=f"{spec.qualname}:{name}",
                message=(f"{name}() at line {line} is not dominated by "
                         f"any of {sorted(spec.before)} in "
                         f"{spec.qualname}: the {spec.name} protocol "
                         "announces/acts on an epoch before it is "
                         "durable — a crash here resurrects a lower "
                         "epoch and two writers can share one "
                         "adjudicated epoch")))
    return findings, checked


def analyze(root: str,
            specs: Sequence[OrderSpec] = ORDER_SPECS,
            loader: Optional[SourceLoader] = None,
            sources: Optional[Dict[str, str]] = None
            ) -> Tuple[List[Finding], Dict]:
    """Check every registered ordering contract.  ``specs`` and
    ``sources`` (path -> planted text) are injectable so tests can
    plant a swapped persist/announce twin — a gate that cannot fail
    proves nothing."""
    loader = ensure_loader(loader)
    findings: List[Finding] = []
    checked = 0
    for spec in specs:
        path = os.path.join(root, spec.path)
        planted = (sources or {}).get(spec.path)
        tree = loader.load(path, planted).tree
        f, n = check_spec(spec, tree, path)
        findings.extend(f)
        checked += n
    stats = {"specs": len(specs), "ordered_points": checked,
             "spec_names": sorted(s.name for s in specs)}
    return findings, stats
