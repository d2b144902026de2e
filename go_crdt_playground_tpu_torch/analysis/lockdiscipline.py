"""AST lock-discipline lint: ``# guarded-by:`` enforcement + lock-order
cycles.

What it checks (grammar in ``analysis.annotations``; DESIGN.md §15):

* **L001 — unguarded access.**  A field annotated ``# guarded-by: L`` on
  its ``__init__`` assignment may only be read or written while ``L`` is
  held: lexically inside ``with self.L:`` (or ``with <var>.L:`` for the
  same object via another name), or inside a method annotated
  ``# requires-lock: L`` (whose call sites are then checked instead).
  ``__init__`` holds every lock implicitly — the object is not shared
  yet.  Writes through OTHER names (``node._state = ...`` in a
  classmethod constructor) are checked against a global registry of
  guarded fields, so alternate-constructor mutation is not a blind spot.
* **L002 — lock-order cycle.**  Every observed "holding A, acquire B"
  pair (lexical ``with`` nesting, plus calls into methods whose
  summaries say they acquire) becomes an edge ``A → B`` in a
  class-qualified lock graph; any cycle is an ERROR (two threads taking
  the locks in opposite orders can deadlock).
* **L003 — inconsistently locked.**  A field accessed at least once
  inside an explicit ``with``-lock block and at least once outside,
  with no ``guarded-by``/``race-ok`` annotation: either the annotation
  or one of the accesses is missing.

This is a LINT, not a verifier: aliasing beyond simple names, locks
passed across objects, and dynamic dispatch are out of scope — the
runtime lockset detector (``analysis.locksets``) covers the dynamic
residue.  Severities: L001/L002 error, L003 error (the tree is kept
clean; silence it per-field with ``# race-ok: <reason>``).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from go_crdt_playground_tpu_torch.analysis.annotations import (
    KIND_GUARDED_BY, KIND_RACE_OK, KIND_REQUIRES_LOCK, AnnotationSet)
from go_crdt_playground_tpu_torch.analysis.loader import (
    SourceLoader, ensure_loader)
from go_crdt_playground_tpu_torch.analysis.report import (
    LOCK_ORDER_CYCLE, SEVERITY_ERROR, UNANNOTATED_SHARED, UNGUARDED_ACCESS,
    Finding)

# threading constructors whose instance attributes count as locks
_LOCK_CTORS = {"Lock", "RLock", "Semaphore", "BoundedSemaphore",
               "Condition"}
# lock types that provide mutual exclusion (semaphores with capacity > 1
# do not, but for guarded-by purposes holding the with-block is still
# the declared discipline, so all count here)


@dataclass
class ClassModel:
    """One class's lock contract, extracted from source + annotations."""

    name: str
    path: str
    locks: Set[str] = field(default_factory=set)
    guarded: Dict[str, str] = field(default_factory=dict)   # field -> lock
    race_ok: Set[str] = field(default_factory=set)
    requires: Dict[str, str] = field(default_factory=dict)  # method -> lock
    methods: Set[str] = field(default_factory=set)
    # method -> self-locks it may acquire (with-blocks, transitive
    # through same-class self-calls); feeds cross-class lock-order edges
    acquires: Dict[str, Set[str]] = field(default_factory=dict)


def _attr_chain(node: ast.AST) -> Optional[List[str]]:
    """``self.wal.seal`` -> ["self", "wal", "seal"]; None when the base
    is not a simple name chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return None


def _with_lock_target(item: ast.withitem) -> Optional[Tuple[str, str]]:
    """``with <base>.<lock>:`` -> (base, lock)."""
    chain = _attr_chain(item.context_expr)
    if chain is not None and len(chain) == 2:
        return chain[0], chain[1]
    return None


def build_class_models(tree: ast.Module, annots: AnnotationSet,
                       path: str) -> Dict[str, ClassModel]:
    models: Dict[str, ClassModel] = {}
    for cls in [n for n in tree.body if isinstance(n, ast.ClassDef)]:
        model = ClassModel(name=cls.name, path=path)
        for meth in [n for n in cls.body
                     if isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))]:
            model.methods.add(meth.name)
            req = annots.on_lines(meth.lineno, meth.body[0].lineno - 1,
                                  KIND_REQUIRES_LOCK)
            if req is not None:
                model.requires[meth.name] = req.arg
            for node in ast.walk(meth):
                # plain AND type-annotated assignments (``self.x: T = v``
                # is an ast.AnnAssign) both declare fields and carry
                # annotations
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AnnAssign):
                    targets, value = [node.target], node.value
                else:
                    continue
                for tgt in targets:
                    chain = _attr_chain(tgt)
                    if chain is None or len(chain) != 2 \
                            or chain[0] != "self":
                        continue
                    fname = chain[1]
                    if meth.name == "__init__" \
                            and isinstance(value, ast.Call):
                        ctor = _attr_chain(value.func)
                        if ctor and ctor[-1] in _LOCK_CTORS:
                            model.locks.add(fname)
                    end = getattr(node, "end_lineno", node.lineno)
                    g = annots.on_lines(node.lineno, end, KIND_GUARDED_BY)
                    if g is not None:
                        model.guarded[fname] = g.arg
                    r = annots.on_lines(node.lineno, end, KIND_RACE_OK)
                    if r is not None:
                        model.race_ok.add(fname)
        # direct lock acquisitions per method, then one transitive pass
        # through same-class self-calls (depth is tiny in practice)
        direct: Dict[str, Set[str]] = {}
        calls: Dict[str, Set[str]] = {}
        for meth in [n for n in cls.body if isinstance(n, ast.FunctionDef)]:
            acq: Set[str] = set()
            callees: Set[str] = set()
            for node in ast.walk(meth):
                if isinstance(node, ast.With):
                    for item in node.items:
                        t = _with_lock_target(item)
                        if t and t[0] == "self" and t[1] in model.locks:
                            acq.add(t[1])
                if isinstance(node, ast.Call):
                    chain = _attr_chain(node.func)
                    if chain and len(chain) == 2 and chain[0] == "self":
                        callees.add(chain[1])
            direct[meth.name] = acq
            calls[meth.name] = callees
        changed = True
        while changed:
            changed = False
            for m, callees in calls.items():
                for c in callees:
                    extra = direct.get(c, set()) - direct[m]
                    if extra:
                        direct[m] |= extra
                        changed = True
        model.acquires = direct
        models[cls.name] = model
    return models


class _MethodLinter(ast.NodeVisitor):
    """Walks one method body tracking lexically-held locks."""

    def __init__(self, lint: "LockLint", model: ClassModel,
                 method: ast.FunctionDef):
        self.lint = lint
        self.model = model
        self.method = method
        # held locks as (base_name, lock_name); __init__ holds all of
        # self's locks implicitly (pre-sharing), and a requires-lock
        # method holds its declared lock.  Implicit holds satisfy
        # guarded-by checks but do NOT create lock-order edges — nothing
        # is actually acquired.
        self.held: Set[Tuple[str, str]] = set()
        self.implicit: Set[Tuple[str, str]] = set()
        if method.name == "__init__":
            self.implicit |= {("self", lk) for lk in model.locks}
        req = model.requires.get(method.name)
        if req is not None:
            self.implicit.add(("self", req))
        self.held |= self.implicit

    # -- lock tracking -----------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        entered: List[Tuple[str, str]] = []
        for item in node.items:
            t = _with_lock_target(item)
            if t is not None and self.lint.is_lock_name(t[1]):
                self.lint.note_acquisition(self.model,
                                           self.held - self.implicit, t)
                if t not in self.held:
                    self.held.add(t)
                    entered.append(t)
            # non-lock with-items (files, sockets) still get visited
            self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        for t in entered:
            self.held.discard(t)

    # -- access checking ---------------------------------------------------

    def visit_Attribute(self, node: ast.Attribute) -> None:
        chain = _attr_chain(node)
        if chain is not None and len(chain) >= 2:
            base, fname = chain[0], chain[1]
            is_store = isinstance(node.ctx, (ast.Store, ast.Del))
            if base == "self":
                self._check_self_access(node, fname, is_store)
            elif is_store:
                self._check_foreign_store(node, base, fname)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        if chain is not None and len(chain) == 2 and chain[0] == "self":
            callee = chain[1]
            req = self.model.requires.get(callee)
            if req is not None and ("self", req) not in self.held:
                self.lint.findings.append(Finding(
                    analyzer="lockdiscipline", code=UNGUARDED_ACCESS,
                    severity=SEVERITY_ERROR, path=self.model.path,
                    line=node.lineno,
                    symbol=f"{self.model.name}.{callee}",
                    message=(f"call to requires-lock method {callee!r} "
                             f"without holding self.{req} "
                             f"(in {self.method.name})")))
            # cross-class acquisition edges: self.<attr>.<meth>() — or
            # <localname>.<meth>() for hinted names — where the target
            # class summary says <meth> acquires
        explicit = self.held - self.implicit
        if chain is not None and explicit:
            if len(chain) == 3 and chain[0] == "self":
                self.lint.note_call_edges(self.model, explicit,
                                          chain[1], chain[2], node.lineno)
            elif len(chain) == 2 and chain[0] in self.lint.attr_classes:
                self.lint.note_call_edges(self.model, explicit,
                                          chain[0], chain[1], node.lineno)
        self.generic_visit(node)

    def _check_self_access(self, node: ast.Attribute, fname: str,
                           is_store: bool) -> None:
        lock = self.model.guarded.get(fname)
        if lock is not None:
            if ("self", lock) not in self.held:
                what = "write" if is_store else "read"
                self.lint.findings.append(Finding(
                    analyzer="lockdiscipline", code=UNGUARDED_ACCESS,
                    severity=SEVERITY_ERROR, path=self.model.path,
                    line=node.lineno,
                    symbol=f"{self.model.name}.{fname}",
                    message=(f"{what} of guarded field {fname!r} without "
                             f"holding self.{lock} "
                             f"(in {self.method.name})")))
            return
        if fname in self.model.race_ok or fname in self.model.locks \
                or fname in self.model.methods:
            return
        # evidence for the L003 inconsistent-locking heuristic; fields
        # never WRITTEN outside __init__ are immutable and cannot race,
        # so only mutated fields can fire (reads of config fields inside
        # a with-block are coincidence, not discipline)
        if self.method.name == "__init__":
            return
        key = (self.model.name, fname)
        if is_store:
            self.lint.mutated.add(key)
        inside = any(b == "self" and lk in self.model.locks
                     for (b, lk) in self.held)
        ev = self.lint.evidence.setdefault(
            key, {"inside": None, "outside": None})
        slot = "inside" if inside else "outside"
        if ev[slot] is None:
            ev[slot] = (self.model.path, node.lineno, self.method.name)

    def _check_foreign_store(self, node: ast.Attribute, base: str,
                             fname: str) -> None:
        """A write like ``node._state = ...``: check the global guarded
        registry (alternate constructors mutate through other names).
        The owner class is resolved via the ``attr_classes`` hint for
        ``base`` when available; with several same-named owners and no
        hint, the check runs only when they all agree on the lock name
        (ambiguity must not assert the WRONG class's contract)."""
        owners = self.lint.global_guarded.get(fname)
        if not owners:
            return
        hinted = self.lint.attr_classes.get(base)
        if hinted is not None:
            if hinted not in owners:
                return  # hinted class doesn't guard this field
            owner_cls, lock = hinted, owners[hinted]
        elif len(set(owners.values())) == 1:
            owner_cls, lock = next(iter(owners.items()))
        else:
            return  # ambiguous owners with differing locks: can't check
        if (base, lock) in self.held:
            return
        self.lint.findings.append(Finding(
            analyzer="lockdiscipline", code=UNGUARDED_ACCESS,
            severity=SEVERITY_ERROR, path=self.model.path,
            line=node.lineno, symbol=f"{owner_cls}.{fname}",
            message=(f"write of {owner_cls}-guarded field {fname!r} "
                     f"through name {base!r} without holding "
                     f"{base}.{lock} (in "
                     f"{self.model.name}.{self.method.name})")))


class LockLint:
    """Whole-run state: class models, lock-order graph, findings."""

    def __init__(self, attr_classes: Optional[Dict[str, str]] = None,
                 loader: Optional[SourceLoader] = None):
        # hints mapping attribute names to the class of the object they
        # hold, for cross-class acquisition edges (self.wal.seal())
        self.attr_classes = attr_classes or {}
        self.loader = ensure_loader(loader)
        self.models: Dict[str, ClassModel] = {}
        # field name -> {owner class: lock}: same-named guarded fields
        # in different classes must not clobber each other's contract
        self.global_guarded: Dict[str, Dict[str, str]] = {}
        self.findings: List[Finding] = []
        # (class, field) -> {"inside": loc|None, "outside": loc|None}
        self.evidence: Dict = {}
        # (class, field) written outside __init__ — L003 candidates
        self.mutated: Set[Tuple[str, str]] = set()
        # lock-order edges: (qualified_from, qualified_to) -> first loc
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self._lock_names: Set[str] = set()
        # files loaded but not yet linted (run() is two-phase so the
        # cross-file guarded registry is complete before checking)
        self._pending: List[Tuple[str, ast.Module]] = []

    def is_lock_name(self, name: str) -> bool:
        return name in self._lock_names

    def qualify(self, model: ClassModel, base: str, lock: str) -> str:
        """Class-qualified lock node name for the order graph."""
        if base == "self":
            return f"{model.name}.{lock}"
        cls = self.attr_classes.get(base)
        return f"{cls}.{lock}" if cls else f"?{base}.{lock}"

    def note_acquisition(self, model: ClassModel,
                         held: Set[Tuple[str, str]],
                         new: Tuple[str, str]) -> None:
        tgt = self.qualify(model, new[0], new[1])
        for b, lk in held:
            src = self.qualify(model, b, lk)
            if src != tgt:
                self.edges.setdefault((src, tgt), (model.path, 0))

    def note_call_edges(self, model: ClassModel,
                        held: Set[Tuple[str, str]], attr: str, meth: str,
                        line: int) -> None:
        """``self.<attr>.<meth>()`` (or ``<attr>.<meth>()`` for a hinted
        local name) while holding locks: if <attr>'s hinted class
        summary says <meth> acquires, add edges."""
        cls_name = self.attr_classes.get(attr)
        target = self.models.get(cls_name) if cls_name else None
        if target is None:
            return
        for lk in target.acquires.get(meth, set()):
            tgt = f"{target.name}.{lk}"
            for b, hlk in held:
                src = self.qualify(model, b, hlk)
                if src != tgt:
                    self.edges.setdefault((src, tgt), (model.path, line))

    # -- driving -----------------------------------------------------------

    def load_file(self, path: str, source: Optional[str] = None) -> None:
        pf = self.loader.load(path, source)
        tree, annots = pf.tree, pf.annotations
        for msg in annots.malformed:
            self.findings.append(Finding(
                analyzer="lockdiscipline", code=UNGUARDED_ACCESS,
                severity=SEVERITY_ERROR, path=path,
                message=f"malformed annotation: {msg}"))
        models = build_class_models(tree, annots, path)
        self.models.update(models)
        for m in models.values():
            self._lock_names |= m.locks
            for fname, lock in m.guarded.items():
                self.global_guarded.setdefault(fname, {})[m.name] = lock
        self._pending.append((path, tree))

    def run(self) -> List[Finding]:
        """Lint every loaded file (two-phase so cross-file guarded
        fields and acquisition summaries are complete before checking)."""
        for path, tree in self._pending:
            for cls in [n for n in tree.body
                        if isinstance(n, ast.ClassDef)]:
                model = self.models[cls.name]
                for meth in [n for n in cls.body
                             if isinstance(n, ast.FunctionDef)]:
                    _MethodLinter(self, model, meth).visit(meth)
        for (cname, fname), ev in sorted(self.evidence.items()):
            if (cname, fname) not in self.mutated:
                continue
            if ev["inside"] and ev["outside"]:
                path, line, meth = ev["outside"]
                self.findings.append(Finding(
                    analyzer="lockdiscipline", code=UNANNOTATED_SHARED,
                    severity=SEVERITY_ERROR, path=path, line=line,
                    symbol=f"{cname}.{fname}",
                    message=(f"field {fname!r} is accessed under a lock "
                             f"elsewhere but bare in {meth!r}; annotate "
                             "it '# guarded-by: <lock>' (and fix the "
                             "bare accesses) or '# race-ok: <reason>'")))
        self.findings.extend(self._check_cycles())
        return self.findings

    def _check_cycles(self) -> List[Finding]:
        graph: Dict[str, Set[str]] = {}
        for (a, b) in self.edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        out: List[Finding] = []
        color: Dict[str, int] = {}
        stack: List[str] = []

        def dfs(v: str) -> Optional[List[str]]:
            color[v] = 1
            stack.append(v)
            for w in sorted(graph[v]):
                if color.get(w, 0) == 1:
                    return stack[stack.index(w):] + [w]
                if color.get(w, 0) == 0:
                    cyc = dfs(w)
                    if cyc:
                        return cyc
            stack.pop()
            color[v] = 2
            return None

        for v in sorted(graph):
            if color.get(v, 0) == 0:
                cyc = dfs(v)
                if cyc:
                    path, line = self.edges.get(
                        (cyc[0], cyc[1]), (None, None))
                    out.append(Finding(
                        analyzer="lockdiscipline", code=LOCK_ORDER_CYCLE,
                        severity=SEVERITY_ERROR, path=path,
                        line=line or None,
                        message=("lock acquisition cycle: "
                                 + " -> ".join(cyc))))
                    break
        return out

    def stats(self) -> Dict:
        return {
            "classes": len(self.models),
            "classes_by_name": sorted(self.models),
            "locks": sorted(self._lock_names),
            "guarded_fields": sum(len(m.guarded)
                                  for m in self.models.values()),
            "requires_lock_methods": sum(len(m.requires)
                                         for m in self.models.values()),
            "lock_order_edges": sorted(f"{a} -> {b}"
                                       for a, b in self.edges),
        }


def analyze_files(paths: List[str],
                  attr_classes: Optional[Dict[str, str]] = None,
                  loader: Optional[SourceLoader] = None
                  ) -> Tuple[List[Finding], Dict]:
    lint = LockLint(attr_classes=attr_classes, loader=loader)
    for p in paths:
        lint.load_file(p)
    findings = lint.run()
    return findings, lint.stats()
