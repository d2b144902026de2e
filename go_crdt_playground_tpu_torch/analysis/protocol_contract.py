"""Wire-contract passes W001/W002/W004 (DESIGN.md §15).

The serve dialect grew by hand across five PRs — msg types 16..33, six
reject codes, per-verb frame caps — and none of it was machine-checked:
a missed dispatch arm, an unregistered reject code, or a bare
``recv_frame`` only ever surfaced (if ever) in a slow soak.  These
passes make the contract gate-time:

* **W001 dispatch exhaustiveness** — every ``MSG_*`` constant of a
  dialect module must have a handler arm in every registered server
  dispatcher, or carry an explicit ``# protocol-ignore`` annotation
  (definition-scoped ``reply``/``internal`` direction, or a
  dispatcher-scoped exclusion with the constant's name).  Constants
  marked ``reply`` must instead have an arm in the registered CLIENT
  reader — the reciprocal check, so a new reply verb cannot land
  half-wired.  Each dispatcher must also keep its typed unknown-frame
  fallthrough (the ``MSG_ERROR`` reply / ``ProtocolError`` close).
* **W002 reject-code discipline** — ``REJECT_EXCEPTIONS`` and
  ``REJECT_CODES`` must be exact inverses over distinct typed
  ``ServeError`` subclasses, every ``REJECT_*`` integer constant must
  be registered, every ``ServeError`` subclass must be mapped (a typed
  exception no code can produce is dead wire surface), and no
  ``encode_reject`` call site may pass a bare numeric literal — named
  registered constants only (dynamic relay variables are allowed; the
  encoder's own ``ValueError`` is the runtime backstop).
* **W004 frame-cap discipline** — every ``framing.recv_frame`` call
  site in the package must pass an explicit ``max_body`` (the 1MB DoS
  bound, made per-verb; a bare read silently inherits the 1GB
  peer-payload ceiling).  Call-site resolution is import-aware, so
  ``bridge/service.py``'s own struct-framed ``recv_frame`` is not
  confused with the armored one.

All entry points take explicit file/dispatcher arguments so the tests
can plant violations (a gate that cannot fail proves nothing).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

from go_crdt_playground_tpu_torch.analysis.annotations import (
    KIND_PROTOCOL_IGNORE)
from go_crdt_playground_tpu_torch.analysis.loader import (
    SourceLoader, ensure_loader)
from go_crdt_playground_tpu_torch.analysis.report import (
    DISPATCH_HOLE, FRAME_CAP_MISSING, REJECT_UNDISCIPLINED, SEVERITY_ERROR,
    Finding)

# definition-scoped direction keywords (# protocol-ignore: <kw> — why)
DIR_REPLY = "reply"        # client-inbound: armed in the client reader
DIR_INTERNAL = "internal"  # consumed below dispatch (e.g. MSG_ERROR)


class DispatcherSpec(NamedTuple):
    """One registered frame dispatcher.

    ``path`` is package-relative; ``qualname`` is ``Class.method``;
    ``dialects`` the package-relative wire modules whose ``MSG_*``
    constants this dispatcher must cover; ``role`` is ``server``
    (covers non-ignored constants) or ``client`` (covers the
    ``reply``-annotated ones); ``fallthrough`` names the symbol the
    typed unknown-frame path must reference (``MSG_ERROR`` for servers,
    ``ProtocolError`` for the client reader)."""

    name: str
    path: str
    qualname: str
    dialects: Tuple[str, ...]
    role: str
    fallthrough: str


# THE registry (DESIGN.md §15): every serve/peer-dialect frame reader.
DISPATCHERS: Tuple[DispatcherSpec, ...] = (
    DispatcherSpec("frontend", "serve/frontend.py",
                   "ServeFrontend._dispatch", ("serve/protocol.py",),
                   "server", "MSG_ERROR"),
    DispatcherSpec("router", "shard/router.py",
                   "ShardRouter._dispatch", ("serve/protocol.py",),
                   "server", "MSG_ERROR"),
    DispatcherSpec("peer", "net/peer.py",
                   "Node._serve_conn", ("net/framing.py",),
                   "server", "MSG_ERROR"),
    DispatcherSpec("serve-client", "serve/client.py",
                   "ServeClient._read_loop", ("serve/protocol.py",),
                   "client", "ProtocolError"),
)


# ---------------------------------------------------------------------------
# W001: dispatch exhaustiveness
# ---------------------------------------------------------------------------


class _DialectInfo(NamedTuple):
    constants: Dict[str, int]            # MSG_* name -> def line
    ignored: Dict[str, Tuple[str, str]]  # name -> (direction, reason)
    malformed: List[str]


def _load_dialect(path: str, loader: Optional[SourceLoader] = None
                  ) -> _DialectInfo:
    pf = ensure_loader(loader).load(path)
    tree = pf.tree
    consts: Dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id.startswith("MSG_"):
                    consts[t.id] = node.lineno
    anns = pf.annotations
    ignored: Dict[str, Tuple[str, str]] = {}
    malformed = list(anns.malformed)
    for ann in anns.every:
        if ann.kind != KIND_PROTOCOL_IGNORE:
            continue
        owners = [n for n, ln in consts.items() if ln == ann.line]
        if not owners:
            continue  # an in-function annotation; dispatcher-scoped
        parts = (ann.arg or "").split(None, 1)
        direction = parts[0].rstrip(":—-") if parts else ""
        reason = parts[1].strip(" —-:") if len(parts) > 1 else ""
        if direction not in (DIR_REPLY, DIR_INTERNAL) or not reason:
            malformed.append(
                f"{path}:{ann.line}: definition-scoped protocol-ignore "
                f"must read '# protocol-ignore: reply|internal — "
                f"<reason>', got {ann.arg!r}")
            continue
        for name in owners:
            ignored[name] = (direction, reason)
    return _DialectInfo(consts, ignored, malformed)


def _find_function(tree: ast.Module, qualname: str
                   ) -> Optional[ast.FunctionDef]:
    cls_name, meth = qualname.split(".", 1)
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls_name:
            for sub in node.body:
                if (isinstance(sub, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))
                        and sub.name == meth):
                    return sub
    return None


def _compared_msg_names(fn: ast.AST) -> set:
    """MSG_* names that appear inside a comparison in ``fn`` — the
    dispatcher's handler arms (``msg_type == protocol.MSG_OP``,
    ``msg_type != MSG_HELLO``, membership tests)."""
    out: set = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Compare):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and sub.id.startswith("MSG_"):
                out.add(sub.id)
            elif (isinstance(sub, ast.Attribute)
                  and sub.attr.startswith("MSG_")):
                out.add(sub.attr)
    return out


def _references_symbol(fn: ast.AST, symbol: str) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and node.id == symbol:
            return True
        if isinstance(node, ast.Attribute) and node.attr == symbol:
            return True
    return False


def check_dispatchers(root: str,
                      dispatchers: Iterable[DispatcherSpec] = DISPATCHERS,
                      loader: Optional[SourceLoader] = None
                      ) -> Tuple[List[Finding], Dict]:
    loader = ensure_loader(loader)
    findings: List[Finding] = []
    stats: Dict = {"dispatchers": {}}
    dialect_cache: Dict[str, _DialectInfo] = {}

    def dialect(rel: str) -> _DialectInfo:
        if rel not in dialect_cache:
            dialect_cache[rel] = _load_dialect(os.path.join(root, rel),
                                               loader)
        return dialect_cache[rel]

    for spec in dispatchers:
        path = os.path.join(root, spec.path)
        pf = loader.load(path)
        tree = pf.tree
        fn = _find_function(tree, spec.qualname)
        if fn is None:
            findings.append(Finding(
                analyzer="protocol_contract", code=DISPATCH_HOLE,
                severity=SEVERITY_ERROR, path=path,
                symbol=spec.qualname,
                message=f"registered dispatcher {spec.qualname} not "
                        f"found in {spec.path}"))
            continue
        handled = _compared_msg_names(fn)
        # dispatcher-scoped ignores: protocol-ignore annotations whose
        # line falls inside the function span, first token = MSG_*
        anns = pf.annotations
        local_ignored: Dict[str, str] = {}
        constants: Dict[str, int] = {}
        ignored_global: Dict[str, Tuple[str, str]] = {}
        malformed: List[str] = []
        for rel in spec.dialects:
            info = dialect(rel)
            constants.update(info.constants)
            ignored_global.update(info.ignored)
            malformed.extend(info.malformed)
        for ann in anns.every:
            if (ann.kind != KIND_PROTOCOL_IGNORE
                    or not fn.lineno <= ann.line <= fn.end_lineno):
                continue
            parts = (ann.arg or "").split(None, 1)
            name = parts[0].rstrip(":—-") if parts else ""
            reason = parts[1].strip(" —-:") if len(parts) > 1 else ""
            if name not in constants or not reason:
                findings.append(Finding(
                    analyzer="protocol_contract", code=DISPATCH_HOLE,
                    severity=SEVERITY_ERROR, path=path, line=ann.line,
                    symbol=spec.name,
                    message=f"dispatcher protocol-ignore must name a "
                            f"dialect MSG_* constant with a reason, "
                            f"got {ann.arg!r}"))
                continue
            if name in handled:
                findings.append(Finding(
                    analyzer="protocol_contract", code=DISPATCH_HOLE,
                    severity=SEVERITY_ERROR, path=path, line=ann.line,
                    symbol=spec.name,
                    message=f"stale protocol-ignore: {name} HAS a "
                            f"handler arm in {spec.qualname} — drop "
                            "the annotation or the arm"))
                continue
            local_ignored[name] = reason
        if spec.role == "server":
            required = [n for n in constants if n not in ignored_global
                        and n not in local_ignored]
        else:
            required = [n for n, (d, _) in ignored_global.items()
                        if d == DIR_REPLY and n not in local_ignored]
        missing = sorted(n for n in required if n not in handled)
        for name in missing:
            findings.append(Finding(
                analyzer="protocol_contract", code=DISPATCH_HOLE,
                severity=SEVERITY_ERROR, path=path, line=fn.lineno,
                symbol=f"{spec.name}:{name}",
                message=f"{spec.qualname} has no handler arm for "
                        f"{name} and no protocol-ignore annotation — "
                        "a frame of this type hits the unknown-frame "
                        "fallthrough (or worse, a stale arm)"))
        if not _references_symbol(fn, spec.fallthrough):
            findings.append(Finding(
                analyzer="protocol_contract", code=DISPATCH_HOLE,
                severity=SEVERITY_ERROR, path=path, line=fn.lineno,
                symbol=spec.name,
                message=f"{spec.qualname} lost its typed unknown-frame "
                        f"fallthrough (no {spec.fallthrough} "
                        "reference): an unexpected frame must be "
                        "answered typed, never silently dropped"))
        stats["dispatchers"][spec.name] = {
            "role": spec.role,
            "required": sorted(required),
            "handled": sorted(handled & set(constants)),
            "ignored": sorted(local_ignored),
        }
        for msg in malformed:
            findings.append(Finding(
                analyzer="protocol_contract", code=DISPATCH_HOLE,
                severity=SEVERITY_ERROR, message=msg))
        # malformed dialect annotations are reported once per gate run
        for rel in spec.dialects:
            dialect_cache[rel] = dialect_cache[rel]._replace(malformed=[])
    # NOT "constants": check_reject_registry's stats carry an integer
    # count under that name, and analyze() merges both dicts
    stats["dialect_constants"] = {
        rel: sorted(info.constants) for rel, info in dialect_cache.items()}
    return findings, stats


# ---------------------------------------------------------------------------
# W002: reject-code discipline
# ---------------------------------------------------------------------------


def check_reject_registry() -> Tuple[List[Finding], Dict]:
    """Runtime half: the REJECT_EXCEPTIONS/REJECT_CODES bijection over
    distinct typed ServeError subclasses, with every REJECT_* integer
    constant registered and every ServeError subclass mapped."""
    import inspect

    from go_crdt_playground_tpu_torch.serve import protocol

    findings: List[Finding] = []
    path = inspect.getfile(protocol)

    def err(msg: str, symbol: Optional[str] = None) -> None:
        findings.append(Finding(
            analyzer="protocol_contract", code=REJECT_UNDISCIPLINED,
            severity=SEVERITY_ERROR, path=path, symbol=symbol,
            message=msg))

    exc_map = protocol.REJECT_EXCEPTIONS
    seen_excs = set()
    for code, exc in exc_map.items():
        if not isinstance(code, int):
            err(f"REJECT_EXCEPTIONS key {code!r} is not an int")
            continue
        if not (isinstance(exc, type)
                and issubclass(exc, protocol.ServeError)):
            err(f"REJECT_EXCEPTIONS[{code}] = {exc!r} is not a typed "
                "ServeError subclass", symbol=str(code))
            continue
        if exc in seen_excs:
            err(f"exception {exc.__name__} mapped by two reject codes "
                "— the client cannot classify the shed", exc.__name__)
        seen_excs.add(exc)
    inverse = {exc: code for code, exc in exc_map.items()}
    if protocol.REJECT_CODES != inverse:
        err("REJECT_CODES is not the exact inverse of "
            "REJECT_EXCEPTIONS — the router's relay direction would "
            "re-encode a different code than the shard sent")
    n_consts = 0
    for name in dir(protocol):
        if not name.startswith("REJECT_") or name in (
                "REJECT_EXCEPTIONS", "REJECT_CODES"):
            continue
        val = getattr(protocol, name)
        if isinstance(val, int):
            n_consts += 1
            if val not in exc_map:
                err(f"reject code {name}={val} is not registered in "
                    "REJECT_EXCEPTIONS — a frontend can send a code "
                    "the client decodes as a protocol error", name)
    n_subclasses = 0
    for name in dir(protocol):
        obj = getattr(protocol, name)
        if (isinstance(obj, type) and issubclass(obj, protocol.ServeError)
                and obj is not protocol.ServeError):
            n_subclasses += 1
            if obj not in inverse:
                err(f"typed exception {name} has no reject code — no "
                    "wire frame can ever produce it", name)
    return findings, {"codes": len(exc_map), "constants": n_consts,
                      "exception_classes": n_subclasses}


def check_reject_call_sites(paths: Iterable[str],
                            loader: Optional[SourceLoader] = None
                            ) -> Tuple[List[Finding], Dict]:
    """Static half: every ``encode_reject`` call site passes a NAMED
    registered code (bare numeric literals drift silently when codes
    renumber; unknown ``REJECT_*`` names are typos the encoder would
    only catch at serve time)."""
    from go_crdt_playground_tpu_torch.serve import protocol

    registered = {name for name in dir(protocol)
                  if name.startswith("REJECT_")
                  and isinstance(getattr(protocol, name), int)}
    loader = ensure_loader(loader)
    findings: List[Finding] = []
    n_sites = 0
    for path in paths:
        tree = loader.load(path).tree
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fname = (node.func.attr if isinstance(node.func, ast.Attribute)
                     else node.func.id if isinstance(node.func, ast.Name)
                     else None)
            if fname != "encode_reject":
                continue
            n_sites += 1
            # the code may ride positionally or as code=... — a
            # keyword-form literal must not slip past the lint
            code_arg = (node.args[1] if len(node.args) >= 2
                        else next((kw.value for kw in node.keywords
                                   if kw.arg == "code"), None))
            if code_arg is None:
                continue
            if isinstance(code_arg, ast.Constant):
                findings.append(Finding(
                    analyzer="protocol_contract",
                    code=REJECT_UNDISCIPLINED, severity=SEVERITY_ERROR,
                    path=path, line=node.lineno,
                    message=f"encode_reject called with bare literal "
                            f"{code_arg.value!r} — use a registered "
                            "REJECT_* constant"))
            else:
                name = (code_arg.attr
                        if isinstance(code_arg, ast.Attribute)
                        else code_arg.id
                        if isinstance(code_arg, ast.Name) else None)
                if (name is not None and name.startswith("REJECT_")
                        and name not in registered):
                    findings.append(Finding(
                        analyzer="protocol_contract",
                        code=REJECT_UNDISCIPLINED,
                        severity=SEVERITY_ERROR, path=path,
                        line=node.lineno,
                        message=f"encode_reject called with "
                                f"unregistered code name {name}"))
    return findings, {"reject_sites": n_sites}


# ---------------------------------------------------------------------------
# W004: frame-cap discipline
# ---------------------------------------------------------------------------


def _framing_recv_aliases(tree: ast.Module) -> Tuple[set, set]:
    """(module_aliases, direct_names) under which this file can reach
    ``net.framing.recv_frame`` — import-aware so a module defining its
    OWN recv_frame (bridge/service.py) is never misattributed.
    Relative forms count too (``from ..net import framing``,
    ``from .framing import recv_frame``): the match is on the LAST
    module-path segment, so a refactor to relative imports cannot
    silently exempt a file from the pass."""
    mod_aliases: set = set()
    direct: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            last = (node.module or "").split(".")[-1]
            if last == "framing":
                for a in node.names:
                    if a.name == "recv_frame":
                        direct.add(a.asname or a.name)
            elif last == "net":
                for a in node.names:
                    if a.name == "framing":
                        mod_aliases.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.endswith("net.framing"):
                    mod_aliases.add((a.asname or a.name).split(".")[0])
    return mod_aliases, direct


def check_frame_caps(paths: Iterable[str],
                     loader: Optional[SourceLoader] = None
                     ) -> Tuple[List[Finding], Dict]:
    loader = ensure_loader(loader)
    findings: List[Finding] = []
    n_sites = 0
    for path in paths:
        tree = loader.load(path).tree
        mod_aliases, direct = _framing_recv_aliases(tree)
        if not mod_aliases and not direct:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            is_target = False
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "recv_frame"):
                base = node.func.value
                if isinstance(base, ast.Name) and base.id in mod_aliases:
                    is_target = True
                elif (isinstance(base, ast.Attribute)
                      and base.attr == "framing"):
                    # fully-dotted chain (pkg.net.framing.recv_frame)
                    is_target = True
            elif (isinstance(node.func, ast.Name)
                  and node.func.id in direct):
                is_target = True
            if not is_target:
                continue
            n_sites += 1
            explicit = (len(node.args) >= 3
                        or any(kw.arg == "max_body"
                               for kw in node.keywords))
            if not explicit:
                findings.append(Finding(
                    analyzer="protocol_contract", code=FRAME_CAP_MISSING,
                    severity=SEVERITY_ERROR, path=path, line=node.lineno,
                    message="recv_frame without an explicit max_body "
                            "inherits the 1GB peer-payload ceiling — "
                            "pass the dialect's cap (the per-verb DoS "
                            "bound, DESIGN.md §16/§18)"))
    return findings, {"recv_frame_sites": n_sites}


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def analyze(root: str, loader: Optional[SourceLoader] = None
            ) -> Tuple[List[Finding], Dict]:
    """Run all three passes over the installed package at ``root``."""
    loader = ensure_loader(loader)
    findings, stats = check_dispatchers(root, loader=loader)
    py_files = []
    for dirpath, _dirnames, filenames in os.walk(root):
        if "__pycache__" in dirpath:
            continue
        for fn in filenames:
            if fn.endswith(".py"):
                py_files.append(os.path.join(dirpath, fn))
    py_files.sort()
    f2, s2 = check_reject_registry()
    findings.extend(f2)
    f3, s3 = check_reject_call_sites(py_files, loader=loader)
    findings.extend(f3)
    f4, s4 = check_frame_caps(py_files, loader=loader)
    findings.extend(f4)
    stats.update(s2)
    stats.update(s3)
    stats.update(s4)
    stats["files_scanned"] = len(py_files)
    return findings, stats
