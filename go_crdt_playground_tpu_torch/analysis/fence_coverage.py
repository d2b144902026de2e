"""E002 — fence-coverage lint: no write verb ships unfenced (§26).

The serving tiers self-fence on two predicates: the ROUTER refuses to
act once a shard adjudicates a higher router epoch (``deposed``, plus
the per-key handoff fence ``RouteState.fenced``), and the FRONTEND
refuses once its keyspace's shard epoch moved past it
(``shard_deposed``) or a router-epoch fence is armed
(``_epoch_fenced``).  Every dispatcher arm that can MUTATE state —
accept an op, push a slice, run GC, swap a ring — must consult one of
those predicates before acting, or a resurrected deposed member
silently accepts writes the surviving fleet never sees (the
acked-writes-stranded hazard of DESIGN.md §22/§23).

This pass walks each registered dispatcher, resolves every write-verb
arm to its handler method(s), and requires the handler (or the arm
itself) to reference a fence predicate symbol.  The two legitimate
exceptions — RING_SYNC and WAL_SYNC, the epoch-adjudication verbs that
ARE the fence mechanism (persist-then-adopt; they must answer even on
a deposed member so it can learn its own deposition) — carry a
``# fence-ok: <reason>`` annotation on their handler's ``def`` line.
A fence-ok on a handler that DOES consult the predicate is stale and
fails the gate: an annotation that can never matter proves nothing.

New write verbs hit this pass by registration: the verb lists below
are part of the contract, and ``test_gate_fast`` pins their census so
a verb added to the dialect without a fence decision fails tier-1.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from go_crdt_playground_tpu_torch.analysis.annotations import KIND_FENCE_OK
from go_crdt_playground_tpu_torch.analysis.loader import (
    SourceLoader, ensure_loader)
from go_crdt_playground_tpu_torch.analysis.report import (
    FENCE_UNCOVERED, SEVERITY_ERROR, Finding)


class FenceSpec(NamedTuple):
    """One dispatcher's fence contract: each verb in ``write_verbs``
    must resolve to a handler that references one of ``predicates`` or
    carries a fence-ok annotation."""

    name: str
    path: str
    qualname: str                 # "Class._dispatch"
    write_verbs: Tuple[str, ...]  # MSG_* constants that mutate state
    predicates: Tuple[str, ...]   # fence predicate attribute names


# THE registry (DESIGN.md §26).  Read verbs (QUERY/STATS/DSUM) are
# deliberately absent: fences must never block reads — that invariant
# is the model checker's, not this lint's.
FENCE_SPECS: Tuple[FenceSpec, ...] = (
    FenceSpec("frontend", "serve/frontend.py", "ServeFrontend._dispatch",
              write_verbs=("MSG_OP", "MSG_SLICE_PUSH", "MSG_GC",
                           "MSG_RING_SYNC", "MSG_WAL_SYNC"),
              predicates=("_epoch_fenced", "shard_deposed")),
    FenceSpec("router", "shard/router.py", "ShardRouter._dispatch",
              write_verbs=("MSG_OP", "MSG_RESHARD", "MSG_RING_SYNC",
                           "MSG_SHARD_FAILOVER"),
              predicates=("deposed", "fenced")),
)


def _find_method(tree: ast.Module, cls_name: str, meth: str
                 ) -> Optional[ast.FunctionDef]:
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls_name:
            for sub in node.body:
                if (isinstance(sub, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))
                        and sub.name == meth):
                    return sub
    return None


def _references_any(fn: ast.AST, symbols: Sequence[str]) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and node.id in symbols:
            return True
        if isinstance(node, ast.Attribute) and node.attr in symbols:
            return True
    return False


def _arm_for_verb(dispatch: ast.FunctionDef, verb: str
                  ) -> Optional[ast.If]:
    """The ``if msg_type == protocol.MSG_X:`` arm comparing to
    ``verb`` (by trailing attribute or bare name)."""
    for node in ast.walk(dispatch):
        if not isinstance(node, ast.If):
            continue
        for sub in ast.walk(node.test):
            if ((isinstance(sub, ast.Name) and sub.id == verb)
                    or (isinstance(sub, ast.Attribute)
                        and sub.attr == verb)):
                return node
    return None


def _handlers_called(arm_body: List[ast.stmt]) -> List[str]:
    """``self._handle_*``-shaped method names called in the arm body."""
    out: List[str] = []
    for stmt in arm_body:
        for node in ast.walk(stmt):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self"):
                out.append(node.func.attr)
    return out


def check_spec(spec: FenceSpec, tree: ast.Module, annots, path: str
               ) -> Tuple[List[Finding], Dict]:
    findings: List[Finding] = []
    covered = 0
    annotated = 0
    cls_name = spec.qualname.split(".", 1)[0]
    dispatch = _find_method(tree, cls_name,
                            spec.qualname.split(".", 1)[1])
    if dispatch is None:
        findings.append(Finding(
            analyzer="fence_coverage", code=FENCE_UNCOVERED,
            severity=SEVERITY_ERROR, path=path, symbol=spec.qualname,
            message=f"registered dispatcher {spec.qualname} not found "
                    f"in {spec.path}"))
        return findings, {"verbs": 0, "covered": 0, "fence_ok": 0}
    for verb in spec.write_verbs:
        arm = _arm_for_verb(dispatch, verb)
        if arm is None:
            findings.append(Finding(
                analyzer="fence_coverage", code=FENCE_UNCOVERED,
                severity=SEVERITY_ERROR, path=path, line=dispatch.lineno,
                symbol=f"{spec.name}:{verb}",
                message=(f"registered write verb {verb} has no arm in "
                         f"{spec.qualname} — if the verb left the "
                         "dialect, drop it from FENCE_SPECS; an "
                         "unresolvable registration checks nothing")))
            continue
        handlers = _handlers_called(arm.body)
        handler_fns = [(h, _find_method(tree, cls_name, h))
                       for h in handlers]
        handler_fns = [(h, f) for h, f in handler_fns if f is not None]
        # the arm may fence inline (rare) or in any called handler
        fenced = _references_any(arm, spec.predicates) or any(
            _references_any(f, spec.predicates) for _, f in handler_fns)
        ann = None
        for _, f in handler_fns:
            ann = annots.on_lines(f.lineno, f.body[0].lineno - 1,
                                  KIND_FENCE_OK)
            if ann is not None:
                break
        if fenced and ann is not None:
            findings.append(Finding(
                analyzer="fence_coverage", code=FENCE_UNCOVERED,
                severity=SEVERITY_ERROR, path=path, line=ann.line,
                symbol=f"{spec.name}:{verb}",
                message=(f"stale fence-ok: the {verb} handler DOES "
                         f"reference a fence predicate "
                         f"({'/'.join(spec.predicates)}) — drop the "
                         "annotation so the lint keeps checking it")))
            continue
        if fenced:
            covered += 1
            continue
        if ann is not None:
            annotated += 1
            continue
        handler_names = ", ".join(h for h, _ in handler_fns) or "<inline>"
        findings.append(Finding(
            analyzer="fence_coverage", code=FENCE_UNCOVERED,
            severity=SEVERITY_ERROR, path=path, line=arm.lineno,
            symbol=f"{spec.name}:{verb}",
            message=(f"write verb {verb} ({handler_names}) consults no "
                     f"fence predicate ({'/'.join(spec.predicates)}) "
                     "and carries no fence-ok annotation: a deposed "
                     "member would accept this mutation after the "
                     "fleet moved on — fence it or annotate the "
                     "handler's def line with the reason")))
    return findings, {"verbs": len(spec.write_verbs), "covered": covered,
                      "fence_ok": annotated}


def analyze(root: str,
            specs: Sequence[FenceSpec] = FENCE_SPECS,
            loader: Optional[SourceLoader] = None,
            sources: Optional[Dict[str, str]] = None
            ) -> Tuple[List[Finding], Dict]:
    """``specs``/``sources`` are injectable for planted-violation
    tests, protocol_contract-style."""
    loader = ensure_loader(loader)
    findings: List[Finding] = []
    stats: Dict = {"dispatchers": {}, "write_verbs": 0, "covered": 0,
                   "fence_ok": 0}
    for spec in specs:
        path = os.path.join(root, spec.path)
        planted = (sources or {}).get(spec.path)
        pf = loader.load(path, planted)
        f, s = check_spec(spec, pf.tree, pf.annotations, path)
        findings.extend(f)
        stats["dispatchers"][spec.name] = s
        stats["write_verbs"] += s["verbs"]
        stats["covered"] += s["covered"]
        stats["fence_ok"] += s["fence_ok"]
    return findings, stats
