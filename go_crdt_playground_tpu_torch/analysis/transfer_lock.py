"""D002 — blocking device→host transfer while a lock is held (§26).

A device->host copy (``.cpu()``, ``.item()``, ``.tolist()``,
``.numpy()``, and the port's host pulls ``to_host`` /
``payload_to_host``) and ``synchronize`` (``torch.cuda.synchronize``,
an event's or a stream's) wait for the card: milliseconds of stall
when the transfer is one bounded pull, tens of milliseconds when a
loop sneaks per-field pulls onto a hot path.  Under the node lock that
stall is SERIALIZED against every reader and writer — the reference's
fused ingest path once made ~10 sequential per-field pulls under the
node lock.  This pass makes that class gate-time: a blocking transfer that
executes while a lock is held must carry a ``# transfer-ok: <reason>``
annotation stating why it is one sanctioned bounded pull.

"While a lock is held" is computed three ways, compounding:

1. lexically inside a ``with <...>.<lock>:`` block (any context
   manager whose trailing attribute name contains ``lock`` or
   ``cond`` — the repo's mutex naming discipline);
2. anywhere in a function annotated ``# requires-lock: <lock>`` (the
   caller holds the lock for the whole body);
3. anywhere in a function REACHABLE from (1) or (2) through the swept
   files' call graph, matched by trailing callee name (one fixpoint —
   how ``framing.encode_delta_wal_record``'s single compact pull,
   called under the node lock from ``Node._append_delta_record``, is
   found in a different module from any ``with`` block).

The trailing-name propagation over-approximates (any same-named
function anywhere in the sweep joins the lock context), which is the
conservative direction for this lint: blocking transfers are rare and
deliberate, so a false lock-context attribution costs one honest
annotation, while a missed one hides a hot-path stall.  A transfer-ok
on a site the propagation does NOT currently reach is allowed and
counted (``annotated_unflagged``, not a finding): it documents a pull
whose callers hold locks beyond the swept graph — there is no stale-
annotation check here because "no swept caller holds a lock today"
does not prove no caller ever does.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

from go_crdt_playground_tpu_torch.analysis.annotations import (
    KIND_REQUIRES_LOCK, KIND_TRANSFER_OK)
from go_crdt_playground_tpu_torch.analysis.loader import (
    SourceLoader, ensure_loader)
from go_crdt_playground_tpu_torch.analysis.report import (
    SEVERITY_ERROR, TRANSFER_UNDER_LOCK, Finding)

# trailing call names that block on the card: tensor -> host copies,
# the waits, and the port's own host pulls (_u32.to_host and
# parallel/meshtarget.payload_to_host, whose bodies copy in modules the
# sweep does not cover)
_TRANSFER_NAMES = {"cpu", "item", "tolist", "numpy", "synchronize",
                   "to_host", "payload_to_host"}


def _trailing(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_lockish(expr: ast.expr) -> bool:
    name = _trailing(expr)
    if name is None and isinstance(expr, ast.Call):
        name = _trailing(expr.func)
    if name is None:
        return False
    low = name.lower()
    return "lock" in low or "cond" in low


class _FnScan(NamedTuple):
    qual: str
    path: str
    fn: ast.AST
    requires_lock: bool
    transfers: List[Tuple[int, int, str, bool]]  # (line,end,name,in_with)
    calls_in_lock: Set[str]       # trailing names called under a with-lock
    calls_all: Set[str]           # every trailing callee name


def _scan_function(fn, qual: str, path: str, annots) -> _FnScan:
    requires = annots.on_lines(fn.lineno, fn.body[0].lineno - 1,
                               KIND_REQUIRES_LOCK) is not None
    transfers: List[Tuple[int, int, str, bool]] = []
    calls_in_lock: Set[str] = set()
    calls_all: Set[str] = set()

    def walk(node: ast.AST, in_lock: bool) -> None:
        for child in ast.iter_child_nodes(node):
            child_lock = in_lock
            if isinstance(child, (ast.With, ast.AsyncWith)):
                if any(_is_lockish(item.context_expr)
                       for item in child.items):
                    child_lock = True
            if isinstance(child, ast.Call):
                name = _trailing(child.func)
                if name is not None:
                    calls_all.add(name)
                    if child_lock:
                        calls_in_lock.add(name)
                    if name in _TRANSFER_NAMES:
                        end = getattr(child, "end_lineno", child.lineno)
                        transfers.append((child.lineno, end, name,
                                          child_lock))
            walk(child, child_lock)

    walk(fn, False)
    return _FnScan(qual, path, fn, requires, transfers, calls_in_lock,
                   calls_all)


def _scan_file(pf) -> List[_FnScan]:
    out: List[_FnScan] = []
    for node in pf.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(_scan_function(node, node.name, pf.path,
                                      pf.annotations))
        elif isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.append(_scan_function(
                        m, f"{node.name}.{m.name}", pf.path,
                        pf.annotations))
    return out


def analyze_paths(paths: Sequence[str],
                  loader: Optional[SourceLoader] = None,
                  sources: Optional[Dict[str, str]] = None
                  ) -> Tuple[List[Finding], Dict]:
    """Sweep ``paths`` as one call graph.  ``sources`` (abs or given
    path -> planted text) lets tests plant a locked transfer."""
    loader = ensure_loader(loader)
    scans: List[_FnScan] = []
    annot_sets = {}
    for p in paths:
        pf = loader.load(p, (sources or {}).get(p))
        annot_sets[pf.path] = pf.annotations
        scans.extend(_scan_file(pf))

    # lock-context fixpoint over trailing names: seeds are requires-lock
    # bodies and with-lock regions; closure follows every call a
    # lock-context function makes (its whole body may run under the
    # caller's lock)
    by_name: Dict[str, List[_FnScan]] = {}
    for sc in scans:
        by_name.setdefault(sc.qual.rsplit(".", 1)[-1], []).append(sc)
    lock_ctx: Set[str] = {sc.qual.rsplit(".", 1)[-1] for sc in scans
                          if sc.requires_lock}
    pending: Set[str] = set(lock_ctx)
    for sc in scans:
        for callee in sc.calls_in_lock:
            if callee in by_name and callee not in lock_ctx:
                lock_ctx.add(callee)
                pending.add(callee)
    while pending:
        name = pending.pop()
        for sc in by_name.get(name, ()):
            for callee in sc.calls_all:
                if callee in by_name and callee not in lock_ctx:
                    lock_ctx.add(callee)
                    pending.add(callee)

    findings: List[Finding] = []
    n_transfers = n_locked = n_ok = n_ok_unflagged = 0
    for sc in scans:
        fn_locked = sc.qual.rsplit(".", 1)[-1] in lock_ctx
        for line, end, name, in_with in sc.transfers:
            n_transfers += 1
            ann = annot_sets[sc.path].on_lines(line, end,
                                               KIND_TRANSFER_OK)
            if not (in_with or fn_locked):
                if ann is not None:
                    n_ok_unflagged += 1
                continue
            n_locked += 1
            if ann is not None:
                n_ok += 1
                continue
            how = ("inside a with-lock block" if in_with else
                   "in a lock-context function (requires-lock or "
                   "called under a lock)")
            findings.append(Finding(
                analyzer="transfer_lock", code=TRANSFER_UNDER_LOCK,
                severity=SEVERITY_ERROR, path=sc.path, line=line,
                symbol=sc.qual,
                message=(f"blocking {name}() {how}: the device stall "
                         "serializes every reader/writer on that lock "
                         "(the fused-hot-path bug class) — hoist "
                         "the pull outside the lock, or annotate the "
                         "statement '# transfer-ok: <reason>' if it is "
                         "one sanctioned bounded pull")))
    stats = {"files": len(paths), "functions": len(scans),
             "transfer_calls": n_transfers, "lock_held": n_locked,
             "transfer_ok": n_ok, "annotated_unflagged": n_ok_unflagged,
             "lock_context_fns": len(lock_ctx)}
    return findings, stats


def analyze(root: str, rel_paths: Sequence[str],
            loader: Optional[SourceLoader] = None
            ) -> Tuple[List[Finding], Dict]:
    return analyze_paths([os.path.join(root, p) for p in rel_paths],
                         loader=loader)
