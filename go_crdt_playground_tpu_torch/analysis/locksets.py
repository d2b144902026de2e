"""Eraser-style runtime lockset race detector (Savage et al., 1997).

The static lint (``analysis.lockdiscipline``) proves what it can see
lexically; this detector catches the dynamic residue: aliased objects,
locks handed across threads, and fields nobody thought to annotate.  It
is OPT-IN instrumentation — ``instrument(obj)`` swaps the object onto a
tracing subclass and wraps its mutex attributes — wired into the chaos
and crash soaks behind ``--detect-races`` and exercised briefly by the
analysis CLI gate so ANALYSIS_REPORT_TORCH.json always covers the pass.

Algorithm, per (object, field):

    virgin -> exclusive(t)    first access; single-thread warm-up is free
    exclusive(t) -> shared            second thread READS
    exclusive(t) -> shared_modified   second thread WRITES
    shared -> shared_modified         any later WRITE

From the first second-thread access on, the field's candidate lockset
``C(v)`` (initially "every lock") is intersected with the locks the
accessing thread holds; an empty ``C(v)`` while shared_modified is a
race report (R001): some write to the field is ordered only by luck.

Two project-specific twists:

* **container reads count as writes.**  ``self._done.add(x)`` mutates
  through a field READ — attribute tracing cannot see the mutation, so
  reads that yield a set/dict/list are treated as writes.  Guard your
  single-owner containers with ``# race-ok:`` if that is too strict.
* **annotation-aware.**  Fields annotated ``# race-ok: <reason>`` in the
  class source are excluded (the annotation grammar is shared with the
  static lint), as are the lock fields themselves and anything in
  ``_ALWAYS_IGNORE``.

``instrument`` refuses a second installation on the same object via
``utils.guards.SHIM_GUARD`` — a doubled shim would intersect locksets
against phantom wrappers and report nonsense.
"""

from __future__ import annotations

import ast
import inspect
import threading
import weakref
from typing import Any, Dict, List, Optional, Set, Tuple

from go_crdt_playground_tpu_torch.analysis.annotations import KIND_RACE_OK
from go_crdt_playground_tpu_torch.analysis.loader import (
    SourceLoader, ensure_loader)
from go_crdt_playground_tpu_torch.analysis.report import (
    RACE_EMPTY_LOCKSET, SEVERITY_ERROR, Finding)
from go_crdt_playground_tpu_torch.utils.guards import SHIM_GUARD

_VIRGIN = 0
_EXCLUSIVE = 1
_SHARED = 2
_SHARED_MODIFIED = 3

_STATE_NAMES = {_VIRGIN: "virgin", _EXCLUSIVE: "exclusive",
                _SHARED: "shared", _SHARED_MODIFIED: "shared_modified"}

# interpreter/bookkeeping names never worth tracking
_ALWAYS_IGNORE = {"__dict__", "__class__", "__weakref__"}

_MUTEX_TYPES = (type(threading.Lock()), type(threading.RLock()))


def _release_shim_key(key) -> None:
    """weakref.finalize callback: return a shim key whose object died
    uninstalled (tolerant — an explicit uninstall already released it)."""
    if SHIM_GUARD.installed(key):
        SHIM_GUARD.uninstall(key)


class TrackedLock:
    """Wraps a mutex; registers itself in the owning detector's
    per-thread held set while held.  Duck-compatible with the
    ``threading.Lock`` surface the codebase uses (acquire / release /
    context manager)."""

    def __init__(self, detector: "RaceDetector", name: str, inner):
        self._detector = detector
        self._name = name
        self._inner = inner

    def acquire(self, *args, **kwargs) -> bool:
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._detector._held_set().add(id(self))
        return got

    def release(self) -> None:
        self._detector._held_set().discard(id(self))
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TrackedLock {self._name}>"


class _FieldState:
    __slots__ = ("state", "owner", "lockset", "reported", "last_writer")

    def __init__(self) -> None:
        self.state = _VIRGIN
        self.owner: Optional[int] = None
        self.lockset: Optional[Set[int]] = None  # None = every lock (⊤)
        self.reported = False
        self.last_writer: Optional[str] = None


_RACE_OK_CACHE: Dict[type, Set[str]] = {}


def _race_ok_fields(cls: type,
                    loader: Optional[SourceLoader] = None) -> Set[str]:
    """``# race-ok:``-annotated fields of ``cls`` (and bases), read from
    source via the shared annotation grammar; unreadable source (REPL,
    frozen) degrades to no exclusions.  Cached per class — a soak
    instruments dozens of same-class objects and the source never
    changes under it.  The file parse rides the gate's shared loader
    (one parse per file per run, not per instrumented class)."""
    cached = _RACE_OK_CACHE.get(cls)
    if cached is not None:
        return set(cached)
    loader = ensure_loader(loader)
    out: Set[str] = set()
    for klass in cls.__mro__:
        if klass is object:
            continue
        try:
            path = inspect.getfile(klass)
            pf = loader.load(path)
        except (OSError, TypeError, SyntaxError):
            continue
        # every ClassDef matching the runtime name (nested classes in
        # test files included) — a same-named sibling merely widens the
        # exclusion set, the conservative direction for a detector
        name = getattr(klass, "__name__", None)
        for cnode in ast.walk(pf.tree):
            if not (isinstance(cnode, ast.ClassDef)
                    and cnode.name == name):
                continue
            for node in ast.walk(cnode):
                # both plain and TYPE-ANNOTATED assignments carry
                # contracts (``self.x: Optional[T] = None
                # # race-ok: ...`` is an ast.AnnAssign, not Assign)
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, ast.AnnAssign):
                    targets = [node.target]
                else:
                    continue
                end = getattr(node, "end_lineno", node.lineno)
                a = pf.annotations.on_lines(node.lineno, end,
                                            KIND_RACE_OK)
                if a is None:
                    continue
                for tgt in targets:
                    if isinstance(tgt, ast.Attribute):
                        out.add(tgt.attr)
    _RACE_OK_CACHE[cls] = set(out)
    return out


class RaceDetector:
    """One detector instance owns the traced objects, the lock registry,
    and the findings.  Thread-safe; meant to be shared by a whole fleet
    (one detector per soak process)."""

    def __init__(self, loader: Optional[SourceLoader] = None) -> None:
        self._loader = ensure_loader(loader)
        self._tls = threading.local()
        self._next_tid = iter(range(1, 1 << 62))
        self._mu = threading.Lock()
        self._fields: Dict[Tuple[int, str], _FieldState] = {}
        self._objects: Dict[int, Any] = {}   # strong refs: id() stability
        self._labels: Dict[int, str] = {}
        self._excluded: Dict[int, Set[str]] = {}
        self._traced_classes: Dict[type, type] = {}
        self._finalizers: Dict[int, "weakref.finalize"] = {}
        self.findings: List[Finding] = []

    # -- lock plumbing ------------------------------------------------------

    def _held_set(self) -> Set[int]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = set()
        return held

    def _thread_id(self) -> int:
        """A thread id NEVER reused across the detector's lifetime.
        ``threading.get_ident()`` recycles pthread ids the moment a
        thread exits, which aliases a dead thread's accesses onto a live
        one and silently keeps fields in the exclusive state — the
        classic Eraser implementation trap."""
        tid = getattr(self._tls, "tid", None)
        if tid is None:
            with self._mu:
                tid = self._tls.tid = next(self._next_tid)
        return tid

    # -- instrumentation ----------------------------------------------------

    def instrument(self, obj: Any, label: Optional[str] = None,
                   extra_exclude: Tuple[str, ...] = ()) -> Any:
        """Start tracing ``obj``: wrap its mutex attributes and swap it
        onto a tracing subclass.  Returns ``obj``.  Raises
        ``utils.guards.AlreadyInstalledError`` when ``obj`` is already
        instrumented (by this or any detector)."""
        SHIM_GUARD.install(("race-detector", id(obj)),
                           owner=type(obj).__name__)
        cls = type(obj)
        excl = set(_ALWAYS_IGNORE) | _race_ok_fields(cls, self._loader) \
            | set(extra_exclude)
        lock_names = []
        for name, value in list(obj.__dict__.items()):
            if isinstance(value, _MUTEX_TYPES):
                wrapped = TrackedLock(self, f"{cls.__name__}.{name}",
                                      value)
                object.__setattr__(obj, name, wrapped)
                excl.add(name)
                lock_names.append(name)
            elif isinstance(value, TrackedLock):
                excl.add(name)
        with self._mu:
            self._objects[id(obj)] = obj
            self._labels[id(obj)] = label or f"{cls.__name__}#{id(obj):x}"
            self._excluded[id(obj)] = excl
        traced = self._traced_class(cls)
        object.__setattr__(obj, "__class__", traced)
        # a detector dropped WITHOUT uninstall() must not pin the shim
        # key forever: id() values are recycled, so a leaked key would
        # make instrument() spuriously refuse an unrelated later object.
        # The finalizer fires when obj is collected (which implies this
        # detector released its strong ref) and returns the key.
        self._finalizers[id(obj)] = weakref.finalize(
            obj, _release_shim_key, ("race-detector", id(obj)))
        return obj

    def uninstall(self, obj: Any) -> None:
        """Stop tracing ``obj``: restore its class and raw locks.
        Refuses (KeyError, side-effect free) objects this detector never
        instrumented — demoting a live object's class first and raising
        after would corrupt it."""
        with self._mu:
            if id(obj) not in self._objects:
                raise KeyError(
                    f"{type(obj).__name__} object is not instrumented by "
                    "this detector (unbalanced uninstall)")
        traced = type(obj)
        base = traced.__bases__[0]
        object.__setattr__(obj, "__class__", base)
        for name, value in list(obj.__dict__.items()):
            if isinstance(value, TrackedLock):
                object.__setattr__(obj, name, value._inner)
        with self._mu:
            self._objects.pop(id(obj), None)
            self._excluded.pop(id(obj), None)
            fin = self._finalizers.pop(id(obj), None)
        if fin is not None:
            fin.detach()
        SHIM_GUARD.uninstall(("race-detector", id(obj)))

    def _traced_class(self, cls: type) -> type:
        cached = self._traced_classes.get(cls)
        if cached is not None:
            return cached
        detector = self

        class Traced(cls):  # type: ignore[misc, valid-type]
            def __getattribute__(self, name):
                value = object.__getattribute__(self, name)
                # trace INSTANCE fields only: a property/descriptor
                # resolves at class level and hands back a fresh value
                # AFTER its getter released any lock it took — tracing
                # that result would misread a correctly-locked property
                # returning a container as an unlocked shared write
                if name in object.__getattribute__(self, "__dict__"):
                    detector._on_access(self, name, value, is_write=False)
                return value

            def __setattr__(self, name, value):
                object.__setattr__(self, name, value)
                detector._on_access(self, name, value, is_write=True)

        Traced.__name__ = f"Traced{cls.__name__}"
        Traced.__qualname__ = Traced.__name__
        self._traced_classes[cls] = Traced
        return Traced

    # -- the Eraser state machine -------------------------------------------

    def _on_access(self, obj: Any, name: str, value: Any,
                   is_write: bool) -> None:
        if name.startswith("__") or callable(value) \
                or isinstance(value, TrackedLock):
            return
        oid = id(obj)
        excl = self._excluded.get(oid)
        if excl is None or name in excl:
            return
        # container mutation is invisible to attribute tracing: a read
        # that hands back a mutable container counts as a write
        if not is_write and isinstance(value, (set, dict, list)):
            is_write = True
        tid = self._thread_id()
        held = frozenset(self._held_set())
        with self._mu:
            fs = self._fields.setdefault((oid, name), _FieldState())
            if fs.state == _VIRGIN:
                fs.state, fs.owner = _EXCLUSIVE, tid
                return
            if fs.state == _EXCLUSIVE:
                if fs.owner == tid:
                    return
                fs.state = _SHARED_MODIFIED if is_write else _SHARED
                fs.lockset = set(held)
            else:
                if is_write and fs.state == _SHARED:
                    fs.state = _SHARED_MODIFIED
                fs.lockset = (set(held) if fs.lockset is None
                              else fs.lockset & held)
            if is_write:
                fs.last_writer = f"thread-{tid}"
            if (fs.state == _SHARED_MODIFIED and not fs.lockset
                    and not fs.reported):
                fs.reported = True
                label = self._labels.get(oid, "?")
                self.findings.append(Finding(
                    analyzer="locksets", code=RACE_EMPTY_LOCKSET,
                    severity=SEVERITY_ERROR,
                    symbol=f"{type(obj).__bases__[0].__name__}.{name}",
                    message=(f"empty lockset on shared field {name!r} of "
                             f"{label}: a write is ordered by no common "
                             "lock (guard it, or annotate '# race-ok: "
                             "<reason>' with the safety argument)")))

    # -- results ------------------------------------------------------------

    def stats(self) -> Dict:
        with self._mu:
            states: Dict[str, int] = {}
            for fs in self._fields.values():
                key = _STATE_NAMES[fs.state]
                states[key] = states.get(key, 0) + 1
            return {
                "objects_traced": len(self._objects),
                "fields_tracked": len(self._fields),
                "field_states": states,
                "races": len(self.findings),
            }

    def race_summaries(self) -> List[str]:
        return [f.render() for f in self.findings]
