"""T001: Thread-subclass attribute shadowing (DESIGN.md §15).

A soak's debugging once lost an afternoon to one line: a
``threading.Thread`` subclass named its stop flag ``self._stop`` —
which silently REPLACED ``Thread._stop`` (the method the runtime calls
to mark the thread finished), so ``join()`` hung forever on an exited
thread.  Nothing crashes at assignment time; CPython's Thread keeps
its internals as plain attributes with no protection.  The failure is
invisible until a teardown path deadlocks, usually in a soak.

This pass makes the trap gate-time: every class in the tree whose base
list names ``Thread`` (``threading.Thread`` or an imported ``Thread``)
is checked for

* **instance-attribute assignments** ``self.<name> = ...`` where
  ``<name>`` collides with a ``threading.Thread`` internal (method or
  state slot).  ``daemon`` and ``name`` are excluded — they are
  PROPERTIES whose setters exist exactly for this; assigning them is
  the documented API.
* **method definitions** overriding a Thread internal other than
  ``run`` (the documented override point) — ``def _stop(self)`` is the
  same bug wearing a def.

The blocklist is derived from the RUNNING interpreter's
``threading.Thread`` (non-dunder attributes), so a CPython that grows
a new internal is covered without a code change here.

Scope: the package, ``tools/``, and ``tests/`` — that offender
lived in a tool, and a test harness thread that cannot ``join()``
wedges CI just as hard as a runtime one.
"""

from __future__ import annotations

import ast
import os
import threading
from typing import Dict, List, Optional, Tuple

from go_crdt_playground_tpu_torch.analysis.loader import (
    SourceLoader, ensure_loader)
from go_crdt_playground_tpu_torch.analysis.report import (
    SEVERITY_ERROR, THREAD_SHADOW, Finding)

# assignable-by-design properties on threading.Thread: setting them is
# the documented API, never a shadow
_PROPERTY_NAMES = frozenset(
    name for name in dir(threading.Thread)
    if isinstance(getattr(threading.Thread, name, None), property))

# the documented override point — subclassing Thread to define run()
# is the whole point of subclassing Thread
_OVERRIDE_OK = frozenset({"run"})


def thread_internal_names() -> frozenset:
    """Every non-dunder attribute of the running interpreter's
    ``threading.Thread`` that is NOT an assignable property: methods
    (``_stop``, ``start``, ``join``, ``is_alive`` ...) and state slots
    — assigning any of these on an instance shadows the runtime's."""
    return frozenset(
        name for name in dir(threading.Thread)
        if not (name.startswith("__") and name.endswith("__"))
        and name not in _PROPERTY_NAMES)


def _is_thread_base(base: ast.expr) -> bool:
    """``class X(Thread)`` / ``class X(threading.Thread)``."""
    if isinstance(base, ast.Name):
        return base.id == "Thread"
    if isinstance(base, ast.Attribute):
        return base.attr == "Thread"
    return False


def check_file(path: str, internals: frozenset,
               loader: Optional[SourceLoader] = None
               ) -> Tuple[List[Finding], int]:
    """Returns (findings, thread_subclass_count) from ONE parse."""
    try:
        tree = ensure_loader(loader).load(path).tree
    except SyntaxError as e:
        return [Finding(
            analyzer="thread_shadow", code=THREAD_SHADOW,
            severity=SEVERITY_ERROR, path=path, line=e.lineno,
            message=f"unparseable file: {e.msg}")], 0
    findings: List[Finding] = []
    n_subclasses = 0
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        if not any(_is_thread_base(b) for b in node.bases):
            continue
        n_subclasses += 1
        # method definitions shadowing a Thread internal (run is the
        # documented override point; dunders like __init__ are not
        # in the internals set by construction)
        for sub in node.body:
            if (isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and sub.name in internals
                    and sub.name not in _OVERRIDE_OK):
                findings.append(Finding(
                    analyzer="thread_shadow", code=THREAD_SHADOW,
                    severity=SEVERITY_ERROR, path=path, line=sub.lineno,
                    symbol=f"{node.name}.{sub.name}",
                    message=(f"Thread subclass {node.name} defines "
                             f"{sub.name}() — it overrides "
                             f"threading.Thread.{sub.name} (an "
                             "internal the runtime calls); rename it "
                             "(only run() is a documented override)")))
        # self.<name> = ... assignments anywhere in the class body
        for meth in [n for n in node.body
                     if isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))]:
            for sub in ast.walk(meth):
                if isinstance(sub, ast.Assign):
                    targets = sub.targets
                elif isinstance(sub, ast.AnnAssign):
                    targets = [sub.target]
                else:
                    continue
                for tgt in targets:
                    if (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"
                            and tgt.attr in internals):
                        findings.append(Finding(
                            analyzer="thread_shadow", code=THREAD_SHADOW,
                            severity=SEVERITY_ERROR, path=path,
                            line=sub.lineno,
                            symbol=f"{node.name}.{tgt.attr}",
                            message=(
                                f"Thread subclass {node.name} assigns "
                                f"self.{tgt.attr} — it shadows "
                                f"threading.Thread.{tgt.attr} and "
                                "silently breaks the thread runtime "
                                "(the _stop-breaks-join() bug "
                                "class); rename the attribute")))
    return findings, n_subclasses


def analyze(root: str,
            extra_dirs: Tuple[str, ...] = ("tools", "tests"),
            loader: Optional[SourceLoader] = None
            ) -> Tuple[List[Finding], Dict]:
    loader = ensure_loader(loader)
    """Sweep the package at ``root`` plus the repo's ``tools/`` and
    ``tests/`` siblings (explicit args so tests can plant violations
    in a tmp tree)."""
    internals = thread_internal_names()
    paths: List[str] = []
    scan_roots = [root] + [os.path.join(os.path.dirname(root), d)
                           for d in extra_dirs]
    for scan in scan_roots:
        if not os.path.isdir(scan):
            continue
        for dirpath, _dirnames, filenames in os.walk(scan):
            if "__pycache__" in dirpath:
                continue
            for fn in filenames:
                if fn.endswith(".py"):
                    paths.append(os.path.join(dirpath, fn))
    paths.sort()
    findings: List[Finding] = []
    n_subclasses = 0
    for path in paths:
        file_findings, n = check_file(path, internals, loader=loader)
        findings.extend(file_findings)
        n_subclasses += n
    return findings, {"files_scanned": len(paths),
                      "thread_subclasses": n_subclasses,
                      "internals_checked": len(internals)}
