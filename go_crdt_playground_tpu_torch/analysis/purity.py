"""Kernel-purity lint: what defines a kernel must be side-effect free.

Every CUDA kernel of the port is held bitwise against its plain PyTorch
version (the ``*_plain`` functions, and the entries' plain branches),
and the launcher that feeds the kernel decides what the kernel sees.
Either one with a host side effect — wall-clock reads, RNG draws,
printing, file or socket I/O, global mutation — is no longer a function
of its inputs: the plain version and the kernel then disagree on some
call, or agree only on the calls the tests happened to make, and the
bitwise parity the whole port rests on breaks silently.  This pass
(P001):

* finds ROOTS in each ``ops/`` module: every ``*_plain`` function (the
  plain versions), and every function that launches through the
  module's ctypes library — one that calls ``_lib()`` or a ``crdt_*``
  entry of a library handle (``lib.crdt_merge_round(...)``);
* walks the same-module call graph from those roots; a reachable
  function's calls into another scanned module (``merge_kernel``
  imported from ``ops/merge.py``, ``delta_ops.delta_merge_pairwise``)
  make the callee a root there, to a fixpoint over the scanned files —
  the plain versions are built from those modules' algebra;
* flags calls to banned host APIs and ``global``/``nonlocal``
  declarations inside reachable functions.

Allowed by design: ``import`` statements inside a function (cached,
idempotent) and ``numpy`` host math — only the named effectful APIs are
banned, because telling a shape computation from a data-dependent one
needs type inference a lint does not have.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from go_crdt_playground_tpu_torch.analysis.loader import (
    SourceLoader, ensure_loader)
from go_crdt_playground_tpu_torch.analysis.report import (
    PURITY_VIOLATION, SEVERITY_ERROR, Finding)

# dotted-call prefixes that are host effects inside traced code
_BANNED_PREFIXES = (
    "time.", "datetime.", "random.", "np.random.", "numpy.random.",
    "os.", "sys.", "socket.", "subprocess.", "threading.",
)
_BANNED_NAMES = {"print", "open", "input", "exec", "eval"}
# the root shapes: a plain version by name, a launch by its library
_PLAIN_SUFFIX = "_plain"
_LIB_LOADER = "_lib"
_LIB_ENTRY_PREFIX = "crdt_"


def _dotted(node: ast.expr) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _launches(fn: ast.FunctionDef) -> bool:
    """Does ``fn`` launch through a ctypes library: a ``_lib()`` call or
    a call of a ``crdt_*`` entry on a library handle?"""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Name) and node.func.id == _LIB_LOADER:
            return True
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr.startswith(_LIB_ENTRY_PREFIX)):
            return True
    return False


def _module_functions(tree: ast.Module) -> Dict[str, ast.FunctionDef]:
    """Top-level functions (the call-graph nodes).  Methods are included
    under ``Class.name`` AND bare name for same-module resolution."""
    out: Dict[str, ast.FunctionDef] = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, ast.FunctionDef):
                    out.setdefault(m.name, m)
    return out


def _kernel_roots(fns: Dict[str, ast.FunctionDef]) -> Set[str]:
    return {name for name, fn in fns.items()
            if name.endswith(_PLAIN_SUFFIX) or _launches(fn)}


def _local_calls(fn: ast.FunctionDef,
                 fns: Dict[str, ast.FunctionDef]) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            d = _dotted(node.func)
            if d is not None and d in fns:
                out.add(d)
        elif isinstance(node, ast.Name) and node.id in fns:
            # bare function references (partial(f, ...), callbacks)
            out.add(node.id)
    return out


def _check_function(fn: ast.FunctionDef, qual: str, path: str
                    ) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(fn):
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            findings.append(Finding(
                analyzer="purity", code=PURITY_VIOLATION,
                severity=SEVERITY_ERROR, path=path, line=node.lineno,
                symbol=qual,
                message=(f"{type(node).__name__.lower()} declaration in "
                         "kernel-reachable code: host mutation makes the "
                         "plain version or the launch depend on more "
                         "than its inputs")))
        if not isinstance(node, ast.Call):
            continue
        d = _dotted(node.func)
        if d is None:
            continue
        if d in _BANNED_NAMES:
            findings.append(Finding(
                analyzer="purity", code=PURITY_VIOLATION,
                severity=SEVERITY_ERROR, path=path, line=node.lineno,
                symbol=qual,
                message=(f"call to {d}() in kernel-reachable code: "
                         "host I/O in a plain version or a launcher")))
            continue
        for prefix in _BANNED_PREFIXES:
            if d.startswith(prefix):
                findings.append(Finding(
                    analyzer="purity", code=PURITY_VIOLATION,
                    severity=SEVERITY_ERROR, path=path, line=node.lineno,
                    symbol=qual,
                    message=(f"call to {d} in kernel-reachable code: "
                             "wall-clock/RNG/OS state breaks the kernel's "
                             "bitwise parity with its plain version "
                             "(hoist it to the host caller)")))
                break
    return findings


def _reachable(fns: Dict[str, ast.FunctionDef], roots: Set[str]
               ) -> Set[str]:
    """Reachability over the same-module call graph."""
    reachable: Set[str] = set()
    frontier = list(roots)
    while frontier:
        name = frontier.pop()
        if name in reachable:
            continue
        reachable.add(name)
        for callee in _local_calls(fns[name], fns):
            if callee not in reachable:
                frontier.append(callee)
    return reachable


def analyze_file(path: str, source: Optional[str] = None,
                 loader: Optional[SourceLoader] = None,
                 extra_roots: Set[str] = frozenset()
                 ) -> Tuple[List[Finding], Dict]:
    tree = ensure_loader(loader).load(path, source).tree
    fns = _module_functions(tree)
    roots = _kernel_roots(fns) | (set(extra_roots) & set(fns))
    reachable = _reachable(fns, roots)
    findings: List[Finding] = []
    for name in sorted(reachable):
        findings.extend(_check_function(fns[name], name, path))
    stats = {"kernel_roots": sorted(roots),
             "reachable_checked": len(reachable)}
    return findings, stats


def _module_key(path: str) -> str:
    """``.../ops/merge.py`` -> ``ops.merge`` (package-relative enough to
    match an import's trailing module path)."""
    return ".".join(os.path.normpath(path).split(os.sep)[-2:])[:-3]


def _imported_targets(tree: ast.Module, keys: Set[str]
                      ) -> Tuple[Dict[str, str], Dict[str, Tuple[str, str]]]:
    """(module aliases -> scanned module key, imported function names ->
    (module key, name)) for every import of a scanned module, function
    scope included (the port imports lazily)."""
    aliases: Dict[str, str] = {}
    names: Dict[str, Tuple[str, str]] = {}

    def key_of(dotted: str) -> Optional[str]:
        return next((k for k in keys
                     if dotted == k or dotted.endswith("." + k)), None)

    for node in ast.walk(tree):
        if not isinstance(node, ast.ImportFrom) or not node.module:
            continue
        for a in node.names:
            mod = key_of(f"{node.module}.{a.name}")
            if mod is not None:
                aliases[a.asname or a.name] = mod
                continue
            mod = key_of(node.module)
            if mod is not None:
                names[a.asname or a.name] = (mod, a.name)
    return aliases, names


def analyze_files(paths: List[str],
                  loader: Optional[SourceLoader] = None
                  ) -> Tuple[List[Finding], Dict]:
    loader = ensure_loader(loader)
    keys = {_module_key(p): p for p in paths}
    extra: Dict[str, Set[str]] = {k: set() for k in keys}
    # cross-module fixpoint: what a root reaches in another scanned
    # module becomes a root there
    changed = True
    while changed:
        changed = False
        for key, p in keys.items():
            tree = loader.load(p).tree
            fns = _module_functions(tree)
            aliases, names = _imported_targets(tree, set(keys) - {key})
            reach = _reachable(fns, _kernel_roots(fns)
                               | (extra[key] & set(fns)))
            for name in reach:
                for node in ast.walk(fns[name]):
                    if not isinstance(node, ast.Call):
                        continue
                    d = _dotted(node.func)
                    if d is None:
                        continue
                    head, _, tail = d.rpartition(".")
                    if head in aliases:
                        target = (aliases[head], tail)
                    elif not head and d in names:
                        target = names[d]
                    else:
                        continue
                    if target[1] not in extra[target[0]]:
                        extra[target[0]].add(target[1])
                        changed = True
    findings: List[Finding] = []
    stats: Dict = {"files": len(paths), "kernel_roots": 0,
                   "cross_module_roots": 0, "reachable_checked": 0}
    for key, p in keys.items():
        f, s = analyze_file(p, loader=loader, extra_roots=extra[key])
        findings.extend(f)
        stats["kernel_roots"] += len(s["kernel_roots"])
        stats["cross_module_roots"] += len(
            extra[key] & set(s["kernel_roots"]))
        stats["reachable_checked"] += s["reachable_checked"]
    return findings, stats
