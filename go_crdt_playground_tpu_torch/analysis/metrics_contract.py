"""M001 metrics contract (DESIGN.md §15): the names the soaks
adjudicate and the docs promise must be names the code actually emits.

Three name sets, all derived mechanically:

* **emitted** — every literal (or f-string pattern) passed to an
  ``obs.Recorder`` emission call in the package: ``count`` /
  ``count_many`` (dict-literal keys) / ``observe`` / ``set_gauge``,
  plus the ``_count`` wrapper convention every subsystem uses.
  F-string segments become ``*`` wildcards (``sync.failures.{cls}`` →
  ``sync.failures.*``), so classified counters stay checkable.
* **referenced** — dotted metric-shaped string literals in
  ``tools/torch_*_soak.py``, the port's adjudication layer (the
  reference's ``tools/*_soak.py`` adjudicate the reference).  A
  referenced name no emission site can produce is an ERROR: the soak
  would adjudicate a counter that is always zero/absent — the "phantom
  metric" failure mode where a rename quietly turns an assertion into
  a no-op.
* **documented** — backtick-quoted metric-shaped names in DESIGN.md
  (``<placeholder>`` segments become wildcards).  An emitted name no
  documentation covers is a WARNING-severity finding: dashboards are
  written from the docs, so an undocumented counter is invisible
  operational surface.  (The gate fails on errors only, but the
  committed report must be clean — document new names in the
  DESIGN.md catalog as they land.)

Entry points take explicit file lists so tests can plant a phantom
reference or an undocumented emission.
"""

from __future__ import annotations

import ast
import fnmatch
import glob
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from go_crdt_playground_tpu_torch.analysis.loader import (
    SourceLoader, ensure_loader)
from go_crdt_playground_tpu_torch.analysis.report import (
    METRICS_CONTRACT, SEVERITY_ERROR, SEVERITY_WARNING, Finding)

# a metric name: dotted lowercase segments (underscores ok); segments
# may be (or contain) ``*`` wildcard stubs from f-string holes — a
# leading hole (the ConnHost counter-prefix convention) included
_NAME_RE = re.compile(r"^([a-z][a-z0-9_]*|\*)(\.[a-z0-9_*:]+)+\*?$")
# path-ish literals that match the dotted shape but are not metrics
_NOT_METRIC_RE = re.compile(
    r"\.(json|jsonl|py|sh|log|md|txt|ckpt|tmp|wal|proto|cpp|go|toml)$|/")

_EMIT_METHODS = {"count", "observe", "set_gauge", "_count"}


def _patterns_of(node: ast.AST) -> List[str]:
    """Every metric-name pattern inside an expression: string literals
    (whole), f-strings (holes become ``*``), and the strings inside
    conditional expressions (``"a.x" if c else "a.y"``).  A plain
    variable yields nothing — the dict-building convention is handled
    by the function-scoped ``count_many`` sweep below."""
    out: List[str] = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            out.append(sub.value)
        elif isinstance(sub, ast.JoinedStr):
            parts = []
            for v in sub.values:
                if isinstance(v, ast.Constant):
                    parts.append(str(v.value))
                else:
                    parts.append("*")
            out.append("".join(parts))
    # JoinedStr's inner Constants were also walked; drop fragments that
    # are substrings of a collected f-string pattern
    joined = [p for p in out if "*" in p]
    return [p for p in out
            if "*" in p or not any(p in j for j in joined)]


def emitted_patterns(paths: Iterable[str],
                     loader: Optional[SourceLoader] = None
                     ) -> Dict[str, List[str]]:
    loader = ensure_loader(loader)
    """pattern -> [path:line, ...] of every Recorder emission site.

    Two collection scopes: the direct argument of an emission call,
    and — for ``count_many``, whose dict is conventionally built up a
    few lines above the call — every metric-shaped string in a
    function that calls ``count_many`` (the ``_record`` dict
    shape: nothing but metric names lives in those functions)."""
    out: Dict[str, List[str]] = {}

    def record(pats: List[str], path: str, lineno: int) -> None:
        for p in pats:
            if _NAME_RE.match(p) and not _NOT_METRIC_RE.search(p):
                out.setdefault(p, []).append(f"{path}:{lineno}")

    for path in paths:
        tree = loader.load(path).tree
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                calls_count_many = any(
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr == "count_many"
                    for sub in ast.walk(node))
                if calls_count_many:
                    record(_patterns_of(node), path, node.lineno)
                continue
            if not isinstance(node, ast.Call):
                continue
            fname = (node.func.attr
                     if isinstance(node.func, ast.Attribute)
                     else node.func.id
                     if isinstance(node.func, ast.Name) else None)
            if fname in _EMIT_METHODS and node.args:
                record(_patterns_of(node.args[0]), path, node.lineno)
            elif fname == "count_many" and node.args:
                record(_patterns_of(node.args[0]), path, node.lineno)
    return out


def referenced_names(paths: Iterable[str],
                     loader: Optional[SourceLoader] = None
                     ) -> Dict[str, List[str]]:
    loader = ensure_loader(loader)
    """name -> [path:line, ...] of every metric-shaped string literal
    in the adjudication tools."""
    out: Dict[str, List[str]] = {}
    for path in paths:
        tree = loader.load(path).tree
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and _NAME_RE.match(node.value)
                    and not _NOT_METRIC_RE.search(node.value)):
                out.setdefault(node.value, []).append(
                    f"{path}:{node.lineno}")
    return out


_BACKTICK_RE = re.compile(r"`([^`\s]+)`")


def documented_patterns(doc_paths: Iterable[str]) -> Set[str]:
    """Backtick-quoted metric-shaped names in the docs;
    ``<placeholder>`` segments normalize to ``*``."""
    out: Set[str] = set()
    for path in doc_paths:
        with open(path) as f:
            text = f.read()
        for m in _BACKTICK_RE.finditer(text):
            name = re.sub(r"<[^>]*>", "*", m.group(1))
            if _NAME_RE.match(name) and not _NOT_METRIC_RE.search(name):
                out.add(name)
    return out


def _covers(pattern: str, name: str) -> bool:
    """Does an emitted/documented pattern cover a (possibly wildcarded)
    name?  Exact match, glob match of a literal name, or equal
    normalized wildcard shapes (``sync.failures.*`` covers the
    f-string pattern ``sync.failures.*``).  A literal reference that
    is itself a PREFIX probe (``breaker.to_``) matches via glob."""
    if pattern == name:
        return True
    if fnmatch.fnmatchcase(name, pattern):
        return True
    if "*" in name and fnmatch.fnmatchcase(pattern, name):
        return True
    return False


def check(package_files: Iterable[str], tool_files: Iterable[str],
          doc_files: Iterable[str],
          loader: Optional[SourceLoader] = None
          ) -> Tuple[List[Finding], Dict]:
    emitted = emitted_patterns(package_files, loader=loader)
    referenced = referenced_names(tool_files, loader=loader)
    documented = documented_patterns(doc_files)
    findings: List[Finding] = []
    for name, sites in sorted(referenced.items()):
        if not any(_covers(p, name) or _covers(name + "*", p)
                   for p in emitted):
            findings.append(Finding(
                analyzer="metrics_contract", code=METRICS_CONTRACT,
                severity=SEVERITY_ERROR, symbol=name,
                path=sites[0].rsplit(":", 1)[0],
                line=int(sites[0].rsplit(":", 1)[1]),
                message=f"soak adjudicates metric {name!r} but no "
                        "Recorder emission site produces it — the "
                        "assertion reads an always-absent counter "
                        "(phantom metric; renamed or never wired?)"))
    undocumented = []
    for pattern, sites in sorted(emitted.items()):
        if not any(_covers(doc, pattern) or _covers(pattern, doc)
                   for doc in documented):
            undocumented.append(pattern)
            findings.append(Finding(
                analyzer="metrics_contract", code=METRICS_CONTRACT,
                severity=SEVERITY_WARNING, symbol=pattern,
                path=sites[0].rsplit(":", 1)[0],
                line=int(sites[0].rsplit(":", 1)[1]),
                message=f"metric {pattern!r} is emitted but appears "
                        "nowhere in the DESIGN.md metric catalog — "
                        "dashboards are written from the docs; add it "
                        "to the §15 catalog"))
    return findings, {
        "emitted": len(emitted), "referenced": len(referenced),
        "documented": len(documented),
        "undocumented": sorted(undocumented),
    }


def analyze(root: str, loader: Optional[SourceLoader] = None
            ) -> Tuple[List[Finding], Dict]:
    """Default scopes: the package for emissions,
    ``tools/torch_*_soak.py`` for adjudication references, DESIGN.md
    for the catalog."""
    pkg_files = []
    for dirpath, _dirnames, filenames in os.walk(root):
        if "__pycache__" in dirpath:
            continue
        for fn in filenames:
            if fn.endswith(".py"):
                pkg_files.append(os.path.join(dirpath, fn))
    repo = os.path.dirname(root)
    tool_files = sorted(glob.glob(os.path.join(repo, "tools",
                                               "torch_*_soak.py")))
    doc_files = [p for p in (os.path.join(repo, "DESIGN.md"),)
                 if os.path.exists(p)]
    return check(sorted(pkg_files), tool_files, doc_files,
                 loader=loader)
