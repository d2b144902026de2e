"""The annotation grammar shared by every analyzer pass.

Annotations are structured comments — the code already carried the
contracts in prose ("Caller holds the lock."); this makes them machine-
checkable without changing any runtime behavior.  Grammar (DESIGN.md
§15; one annotation per line, attached to the statement that spans the
comment's line):

    # guarded-by: <lock>        field annotation, on the ``self.f = ...``
                                line (usually in ``__init__``): every
                                later access to ``f`` must hold ``<lock>``
                                (a ``with self.<lock>:`` block or a
                                ``requires-lock`` method).
    # requires-lock: <lock>     method annotation, on the ``def`` line:
                                the CALLER must hold ``<lock>``; the body
                                may then touch guarded fields freely, and
                                every call site of the method is checked
                                instead.
    # race-ok: <reason>         field annotation: excluded from both the
                                static lint and the runtime lockset
                                detector, with the reason on record
                                (benign flags, owner-thread-only fields).
    # durable-on-return         function annotation: the durability lint
                                requires an fsync to dominate the end of
                                this function (its return IS the ack).
    # protocol-ignore: <what> — <reason>
                                wire-contract annotation (W001, analysis/
                                protocol_contract.py).  On a ``MSG_*``
                                constant's definition line, ``<what>`` is
                                a direction keyword: ``reply`` (client-
                                inbound — must have an arm in the client
                                reader instead of the servers) or
                                ``internal`` (consumed below dispatch,
                                e.g. MSG_ERROR raised inside recv_frame).
                                Inside a dispatcher function, ``<what>``
                                names the MSG_* constant this dispatcher
                                deliberately does not serve.  The reason
                                is required either way — an unexplained
                                hole in dispatch coverage is exactly the
                                drift the pass exists to catch.
    # fence-ok: <reason>        handler annotation (E002, analysis/
                                fence_coverage.py), on the handler's
                                ``def`` line: this write-verb handler
                                deliberately serves without consulting
                                the fence predicate — legitimate only
                                for the epoch-adjudication verbs that
                                ARE the fence mechanism (RING_SYNC /
                                WAL_SYNC persist-then-adopt).  The
                                reason is on record; an unexplained
                                unfenced write verb fails the gate.
    # transfer-ok: <reason>     statement annotation (D002, analysis/
                                transfer_lock.py): this blocking
                                device→host transfer (``.cpu()``,
                                ``.item()``, ``.tolist()``, ``.numpy()``,
                                ``synchronize``, ``to_host`` /
                                ``payload_to_host`` /
                                ``record_to_host``) is sanctioned
                                under (or reachable from) a held lock —
                                the reason states why it is one bounded
                                pull, not a per-field sweep.

``<lock>`` names an attribute of the same object (``_lock``,
``_conn_slots``).  Parsing is tokenize-based so annotations survive any
formatting; attachment is by line coverage of the enclosing statement
(multi-line statements carry the annotation on any of their lines,
conventionally the first).  A STANDALONE annotation comment (its own
line) attaches to the next STATEMENT line — continuation comment lines
and blank lines below it are skipped — so long reasons can wrap without
fighting the line-length limit.
"""

from __future__ import annotations

import io
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_ANNOT_RE = re.compile(
    r"#\s*(guarded-by|requires-lock|race-ok|durable-on-return"
    r"|protocol-ignore|fence-ok|transfer-ok)\s*"
    r"(?::\s*(?P<arg>\S[^#]*?))?\s*$")

KIND_GUARDED_BY = "guarded-by"
KIND_REQUIRES_LOCK = "requires-lock"
KIND_RACE_OK = "race-ok"
KIND_DURABLE_ON_RETURN = "durable-on-return"
KIND_PROTOCOL_IGNORE = "protocol-ignore"
KIND_FENCE_OK = "fence-ok"
KIND_TRANSFER_OK = "transfer-ok"

_ARG_REQUIRED = {KIND_GUARDED_BY, KIND_REQUIRES_LOCK, KIND_RACE_OK,
                 KIND_PROTOCOL_IGNORE, KIND_FENCE_OK, KIND_TRANSFER_OK}


@dataclass
class Annotation:
    kind: str
    arg: Optional[str]   # lock name / reason; None for durable-on-return
    line: int


@dataclass
class AnnotationSet:
    """All annotations of one source file, indexed by line.

    ``every`` keeps all annotations in source order and is what
    ``on_lines`` searches — a statement can carry annotations of
    different kinds (a guarded-by plus a trailing protocol-ignore),
    and the wire-contract pass reads stacked ``protocol-ignore``
    comments that attach to the same statement.  ``by_line`` keeps the
    LAST annotation per line, retained for diagnostics only."""

    by_line: Dict[int, Annotation] = field(default_factory=dict)
    every: List[Annotation] = field(default_factory=list)
    malformed: List[str] = field(default_factory=list)

    def on_lines(self, first: int, last: int,
                 kind: Optional[str] = None) -> Optional[Annotation]:
        """The annotation attached to a statement spanning [first, last]
        (earliest line wins; statements conventionally annotate their
        first line).  Searches ``every``, not the single-slot
        ``by_line``: a statement can legitimately carry annotations of
        DIFFERENT kinds (a guarded-by above it plus a trailing
        protocol-ignore), and a kind-filtered lookup must never be
        shadowed by the other kind landing on the same line."""
        best: Optional[Annotation] = None
        for a in self.every:
            if (first <= a.line <= last
                    and (kind is None or a.kind == kind)
                    and (best is None or a.line < best.line)):
                best = a
        return best


def parse_annotations(source: str, path: str = "<string>") -> AnnotationSet:
    """Extract every analyzer annotation from ``source``.  Unknown
    comment shapes are ignored (they are just comments); a RECOGNIZED
    keyword with a missing required argument is recorded as malformed so
    the lint can surface the typo instead of silently skipping the
    contract."""
    out = AnnotationSet()
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [(t.start[0], t.start[1], t.line, t.string)
                    for t in tokens if t.type == tokenize.COMMENT]
    except tokenize.TokenError:
        return out
    standalone_lines = {ln for ln, col, srcline, _ in comments
                        if srcline[:col].strip() == ""}
    src_lines = source.splitlines()

    def _skippable(ln: int) -> bool:
        # comment-only continuation lines and blank separator lines sit
        # between a standalone annotation and the statement it means
        return (ln in standalone_lines
                or (ln - 1 < len(src_lines)
                    and not src_lines[ln - 1].strip()))

    for line, col, srcline, text in comments:
        # a standalone comment line annotates the statement BELOW it —
        # skipping further comment-only and blank lines first, so an
        # annotation whose reason wraps (or that sits a blank line
        # above its statement) still lands on the statement
        if srcline[:col].strip() == "":
            line += 1
            while line <= len(src_lines) and _skippable(line):
                line += 1
        m = _ANNOT_RE.search(text)
        if not m:
            # a comment that STARTS with an annotation keyword but fails
            # the strict grammar (missing colon, empty argument) is a
            # typo'd contract — silent skip would un-check the very
            # invariant the author tried to state.  Prose merely
            # mentioning a keyword mid-comment is left alone.
            if re.match(r"#\s*(guarded-by|requires-lock|race-ok"
                        r"|protocol-ignore|fence-ok|transfer-ok)\b",
                        text):
                out.malformed.append(
                    f"{path}:{line}: malformed annotation {text.strip()!r}"
                    " (expected '# <kind>: <arg>')")
            continue
        kind = m.group(1)
        arg = m.group("arg")
        arg = arg.strip() if arg else None
        if kind in _ARG_REQUIRED and not arg:
            out.malformed.append(
                f"{path}:{line}: annotation '# {kind}:' needs an argument")
            continue
        ann = Annotation(kind=kind, arg=arg, line=line)
        out.by_line[line] = ann
        out.every.append(ann)
    return out
