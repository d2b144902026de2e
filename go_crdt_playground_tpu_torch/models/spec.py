"""Executable specification of the reference CRDT semantics.

The counterpart of the JAX package's ``models/spec.py``, line for line:
a small, dependency-free, pure-Python model of the reference's OR-SWOT
(add-wins, tombstone-free observed-remove set) with dotted version
vectors, plus the δ-state prototype.  It is the conformance oracle of the
port's packed tensors (ops/merge.py, ops/delta.py) and the host-side
vehicle of the Merger bridge (bridge/), whose canonical rendering
(``str``) a Go client compares byte for byte.

Reference anchors (cited as file:line into the reference repository):

* ``Actor``       — crdt-misc.go:9      (0-based replica/client id)
* ``Dot``         — crdt-misc.go:12-19  ((actor, counter) event stamp)
* ``VersionVector`` — crdt-misc.go:23-74
* ``AWSet``       — awset.go:55-171
* ``AWSetDelta``  — awset-delta_test.go:9-105
* ``AWSet.deltaMerge`` — awset-delta_test.go:107-166

Deliberate deviations from the reference (documented quirk fixes; each is
exercised by a dedicated test):

1. ``VersionVector.has_dot`` / ``counter`` use a ``>=`` bounds guard.  The
   reference's guard is ``Actor(len(vv)) < d.Actor`` (crdt-misc.go:29, :37),
   which panics (index out of range) when ``d.Actor == len(vv)``.  We return
   False / 0 for *any* out-of-range actor, which is the semantically intended
   behavior ("never seen this actor").
2. ``AWSet.reset`` restores a version vector of the original length rather
   than hard-coding length 1 (awset.go:73 shrinks the VV to ``{0}``
   regardless of actor count — latent bug, method is never called by the
   reference's tests).
3. No ``os.Exit(0)`` mid-suite (awset_test.go:153 kills the Go test binary
   before TestVersionVector can run; our port runs everything).

Reference quirks that ARE preserved (they are semantics, not bugs):

* ``AWSet.del_`` does NOT tick the actor's clock (awset.go:97 — the
  increment is commented out in the reference).
* ``AWSetDelta.del_`` DOES tick the clock, exactly once per call (not per
  key), and stamps every key deleted in that call with the same dot
  (awset-delta_test.go:15-16, 26).
* Merge phase 1 *unconditionally overwrites* the destination dot when the
  element is present on both sides (awset.go:142), so per-entry dots can
  diverge across replicas after a simultaneous snapshot exchange even though
  membership and VVs converge.  Convergence is therefore defined on
  (membership, VV) — see ``AWSet.converged_with``.
* ``AWSetDelta.merge`` with an empty δ payload returns early WITHOUT joining
  version vectors (awset-delta_test.go:60-64): entries converge before
  clocks do.  Controlled by ``strict_reference_semantics``.
* δ-merge phase 2 logs a no-op "remove" for keys absent on the receiver
  (awset-delta_test.go:160-162).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

__all__ = [
    "Actor",
    "Dot",
    "VersionVector",
    "AWSet",
    "AWSetDelta",
    "TraceEvent",
    "TraceFn",
]

# Actor is a 0-based identifier for a specific actor (crdt-misc.go:9).
Actor = int


class Dot(NamedTuple):
    """One event on one actor's clock (crdt-misc.go:12-15)."""

    actor: Actor
    counter: int

    def __str__(self) -> str:
        # "(A 1)" — crdt-misc.go:17-19
        return f"({chr(ord('A') + self.actor)} {self.counter})"


class TraceEvent(NamedTuple):
    """One merge decision, mirroring the reference's ``logOutcome`` printf
    tracing (awset.go:109-119, awset-delta_test.go:113-123).

    ``outcome`` is one of the reference's five labels:
    ``update | keep | skip | add | remove``.
    """

    phase: int
    key: str
    dst_dot: Optional[Dot]
    src_dot: Optional[Dot]
    outcome: str


# Optional trace sink; replaces the reference's unconditional fmt.Printf.
TraceFn = Callable[[TraceEvent], None]


class VersionVector:
    """Per-actor max counter — the causal-context lattice (crdt-misc.go:23).

    Backed by a plain list indexed by actor.  Unlike the packed-tensor
    representation (fixed actor axis ``A``), the spec keeps the reference's
    variable-length growth semantics (crdt-misc.go:50-52: merge appends
    unseen actor slots).
    """

    __slots__ = ("v",)

    def __init__(self, counters: Optional[List[int]] = None):
        self.v: List[int] = list(counters) if counters else []

    def has_dot(self, d: Dot) -> bool:
        """True iff ``d`` is within this causal context (crdt-misc.go:28-34).

        Out-of-range actors were never seen → False.  (Bounds guard fixed
        relative to the reference; see module docstring, deviation 1.)
        """
        if d.actor >= len(self.v) or d.actor < 0:
            return False
        return self.v[d.actor] >= d.counter

    def counter(self, a: Actor) -> int:
        """Max counter seen for actor ``a`` (crdt-misc.go:36-41)."""
        if a >= len(self.v) or a < 0:
            return 0
        return self.v[a]

    def merge(self, src: "VersionVector") -> None:
        """Elementwise max join, extending with src's extra slots
        (crdt-misc.go:43-55)."""
        for i, n in enumerate(src.v):
            if i < len(self.v):
                if self.v[i] < n:
                    self.v[i] = n
            else:
                self.v.append(n)

    def clone(self) -> "VersionVector":
        return VersionVector(self.v)  # crdt-misc.go:70-74

    def __eq__(self, other: object) -> bool:
        return isinstance(other, VersionVector) and self.v == other.v

    def __len__(self) -> int:
        return len(self.v)

    def __getitem__(self, a: Actor) -> int:
        return self.v[a]

    def __setitem__(self, a: Actor, n: int) -> None:
        self.v[a] = n

    def __str__(self) -> str:
        # "[(A 1), (B 2)]" — crdt-misc.go:57-68
        inner = ", ".join(
            f"({chr(ord('A') + i)} {n})" for i, n in enumerate(self.v)
        )
        return f"[{inner}]"

    def __repr__(self) -> str:
        return f"VersionVector({self.v!r})"


def _go_quote(s: str) -> str:
    """Go's ``%q`` for the subset of strings the tests use (printable ASCII).

    Canonical rendering is the de-facto state-equality format of the
    reference (awset.go:163-171); keeping it byte-compatible lets conformance
    tests compare serialized states across spec and tensor paths.
    """
    out = ['"']
    for ch in s:
        if ch in ('"', "\\"):
            out.append("\\" + ch)
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\t":
            out.append("\\t")
        elif 0x20 <= ord(ch) < 0x7F or (ord(ch) > 0x7F and ch.isprintable()):
            # Go's strconv.Quote keeps printable runes literal.
            out.append(ch)
        elif ord(ch) > 0xFFFF:
            out.append(f"\\U{ord(ch):08x}")
        else:
            out.append(f"\\u{ord(ch):04x}")
    out.append('"')
    return "".join(out)


class AWSet:
    """OR-SWOT: tombstone-free observed-remove set, concurrent add wins
    (awset.go:55-59 and the algorithm doc at awset.go:9-53).

    One instance = one replica.  "Network exchange" is ``dst.merge(src)``
    with direct access to src's state, exactly as in the reference's
    simulation harness (awset_test.go:16-17).
    """

    def __init__(
        self,
        actor: Actor = 0,
        version_vector: Optional[VersionVector] = None,
        entries: Optional[Dict[str, Dot]] = None,
        trace: Optional[TraceFn] = None,
    ):
        self.actor: Actor = actor
        self.version_vector: VersionVector = (
            version_vector if version_vector is not None else VersionVector()
        )
        self.entries: Dict[str, Dot] = entries if entries is not None else {}
        self.trace: Optional[TraceFn] = trace

    # -- observers ---------------------------------------------------------

    def sorted_values(self) -> List[str]:
        """Sorted live membership (awset.go:61-70)."""
        return sorted(self.entries)

    def has(self, k: str) -> bool:
        """Membership test (awset.go:87)."""
        return k in self.entries

    # -- lifecycle ---------------------------------------------------------

    def reset(self) -> None:
        """Reinitialize (awset.go:72-75; VV length preserved — deviation 2)."""
        self.version_vector = VersionVector([0] * max(1, len(self.version_vector)))
        self.entries = {}

    def clone(self) -> "AWSet":
        """Deep copy; used by tests to fork timelines (awset.go:77-85)."""
        return AWSet(
            actor=self.actor,
            version_vector=self.version_vector.clone(),
            entries=dict(self.entries),
            trace=self.trace,
        )

    # -- mutators ----------------------------------------------------------

    def add(self, *keys: str) -> None:
        """Add/update: tick own clock per key, stamp birth dot (awset.go:89-94).

        Invariant established: every entry's dot is covered by its own
        replica's VV (merge phase 2 relies on this).
        """
        for k in keys:
            self.version_vector[self.actor] += 1
            self.entries[k] = Dot(self.actor, self.version_vector[self.actor])

    def del_(self, *keys: str) -> None:
        """Remove without tombstone and WITHOUT ticking the clock
        (awset.go:96-101; the increment is commented out at awset.go:97)."""
        for k in keys:
            self.entries.pop(k, None)

    # -- sync --------------------------------------------------------------

    def merge(self, src: "AWSet") -> None:
        """Full-state anti-entropy: ``dst <- src`` (awset.go:103-105)."""
        self._merge(src.version_vector, src.entries)

    def _log(self, phase: int, k: str, dst_dot, src_dot, outcome: str) -> None:
        if self.trace is not None:
            self.trace(TraceEvent(phase, k, dst_dot, src_dot, outcome))

    def _merge(self, src_vv: VersionVector, src_entries: Dict[str, Dot]) -> None:
        """The two-phase merge (awset.go:107-161).  THE hot loop that the
        tensor kernel in ops/merge.py vectorizes."""
        dst = self
        # PHASE 1: walk src entries (awset.go:122-143).
        for k, src_dot in src_entries.items():
            dst_dot = dst.entries.get(k)
            if dst_dot is not None:
                # Present on both sides: unconditional dot overwrite
                # (awset.go:123-129, 142).  This is why per-entry dots may
                # diverge across replicas; see module docstring.
                self._log(1, k, dst_dot, src_dot,
                          "update" if dst_dot != src_dot else "keep")
            else:
                # Absent locally: if our clock already covers the dot we saw
                # this add and deleted it — skip; else it's a new add
                # (awset.go:131-141).
                if dst.version_vector.has_dot(src_dot):
                    self._log(1, k, None, src_dot, "skip")
                    continue
                self._log(1, k, None, src_dot, "add")
            dst.entries[k] = src_dot
        # PHASE 2: walk dst entries; remove what src has witnessed-and-dropped
        # (awset.go:145-159).
        for k in list(dst.entries):
            dst_dot = dst.entries[k]
            src_dot = src_entries.get(k)
            if src_dot is not None:
                self._log(2, k, dst_dot, src_dot, "keep")
            elif src_vv.has_dot(dst_dot):
                self._log(2, k, dst_dot, None, "remove")
                del dst.entries[k]
            else:
                self._log(2, k, dst_dot, None, "keep")
        # VV join (awset.go:160).
        dst.version_vector.merge(src_vv)

    # -- equality / rendering ---------------------------------------------

    def converged_with(self, other: "AWSet") -> bool:
        """Convergence is (membership, VV) equality — per-entry dots may
        legitimately diverge (SURVEY §3.2 [verified] semantics)."""
        return (
            self.sorted_values() == other.sorted_values()
            and self.version_vector == other.version_vector
        )

    def __str__(self) -> str:
        # Canonical sorted rendering (awset.go:163-171):
        #   [(A 1), (B 2)]\n  (A 1)  "Alice"\n  ...
        parts = [str(self.version_vector)]
        for value in self.sorted_values():
            parts.append(f"\n  {self.entries[value]}  {_go_quote(value)}")
        return "".join(parts)


class AWSetDelta(AWSet):
    """δ-state AWSet: tracks a deletion log so only changed/deleted entries
    ship on subsequent merges (awset-delta_test.go:9-12).

    Two δ semantics are offered via ``delta_semantics``:

    ``"reference"`` (default) — byte-faithful to the reference prototype:

      * The payload ships only the sender's OWN-origin deletion records
        (``Deleted`` is written only by local ``Del``,
        awset-delta_test.go:14-33; ``deltaMerge`` never writes the
        receiver's log).  Deletions therefore propagate on the δ path only
        pairwise-directly from their originator; a third replica that never
        syncs with the originator keeps the entry forever.
      * Deletion arbitration at the receiver checks the receiver's VV
        against the DELETION dot (awset-delta_test.go:153): remove iff
        ``not dst.vv.has_dot(deletion_dot)``.  In 3+ actor topologies this
        can delete an entry whose live dot came from a concurrent add the
        deleter never observed — i.e. it can violate add-wins, unlike the
        full-state merge whose phase 2 checks the sender's VV against the
        LIVE dot (awset.go:152).  Both behaviors are pinned by tests.
      * An all-empty payload returns early WITHOUT joining VVs
        (awset-delta_test.go:60-64) when ``strict_reference_semantics``.
      * No GC (the reference's gcDeleted is an empty stub,
        awset-delta_test.go:67-77); ``gc_enabled=True`` adds a pairwise ack
        frontier that is sound for the 2-replica topology the reference
        exercises (and only there — see gc_deleted).

    ``"v2"`` — the principled δ-ORSWOT this framework actually ships for
    scale (cf. Almeida/Shoker/Baquero delta-state CRDTs, PAPERS.md):

      * Deletion arbitration is EXACTLY full-merge phase 2 restricted to
        the payload's key set: remove a live entry iff the sender's VV
        covers its LIVE dot (and it is absent at the sender).  δ-merge and
        full merge therefore agree in every topology; add-wins holds.
      * Received deletion records are absorbed into the receiver's own log
        and re-gossip transitively, so deletions reach replicas that never
        talk to the originator.
      * Each replica maintains a ``processed`` vector — for each origin
        actor, the highest deletion counter whose effects its state
        reflects — advertised with the VV.  It is joined only on exchanges
        that actually transfer those effects (never inferred from VV joins,
        which propagate counters without deletion records).
      * GC by causal stability: a record (k, (a, c)) is dropped once every
        known peer's advertised ``processed[a] >= c``.
      * Clocks always join (no empty-δ quirk) and GC runs on every
        exchange.

    The v2 receiver rule being "full merge masked to a key set" is also
    what makes it the TPU-friendly variant: the dense kernel is the same
    boolean algebra as the full merge with a payload mask (ops/delta.py).
    """

    def __init__(self, *args, gc_enabled: bool = False,
                 strict_reference_semantics: bool = True,
                 delta_semantics: str = "reference", **kwargs):
        super().__init__(*args, **kwargs)
        if delta_semantics not in ("reference", "v2"):
            raise ValueError(f"unknown delta_semantics {delta_semantics!r}")
        self.delta_semantics = delta_semantics
        self.deleted: Dict[str, Dot] = {}
        # reference-mode GC: peer actor -> highest counter for OUR actor's
        # clock that the peer has directly advertised.
        self.peer_acked: Dict[Actor, int] = {}
        # v2: origin actor -> highest deletion counter whose effects this
        # replica's state reflects.  Invariant: processed[self] == vv[self].
        self.processed: Dict[Actor, int] = {}
        # v2: peer actor -> that peer's last advertised processed vector.
        self.peer_processed: Dict[Actor, Dict[Actor, int]] = {}
        self.gc_enabled = gc_enabled
        # When True, an all-empty δ payload skips the VV join exactly like
        # awset-delta_test.go:60-64.  When False, VVs are always joined
        # (clocks converge with entries).  Reference mode only.
        self.strict_reference_semantics = strict_reference_semantics

    def clone(self) -> "AWSetDelta":
        c = AWSetDelta(
            actor=self.actor,
            version_vector=self.version_vector.clone(),
            entries=dict(self.entries),
            trace=self.trace,
            gc_enabled=self.gc_enabled,
            strict_reference_semantics=self.strict_reference_semantics,
            delta_semantics=self.delta_semantics,
        )
        c.deleted = dict(self.deleted)  # awset-delta_test.go:35-49
        c.peer_acked = dict(self.peer_acked)
        c.processed = dict(self.processed)
        c.peer_processed = {a: dict(p) for a, p in self.peer_processed.items()}
        return c

    def add(self, *keys: str) -> None:
        super().add(*keys)
        # Invariant: a replica has trivially processed its own events.
        self.processed[self.actor] = self.version_vector[self.actor]

    def del_(self, *keys: str) -> None:
        """δ-Del ticks the clock ONCE PER CALL and stamps all keys deleted in
        this call with that one shared dot (awset-delta_test.go:14-33).
        Note the clock ticks even if no key is present."""
        self.version_vector[self.actor] += 1
        dot2 = Dot(self.actor, self.version_vector[self.actor])
        for k in keys:
            if k in self.entries:
                self.deleted[k] = dot2
                del self.entries[k]
        self.processed[self.actor] = self.version_vector[self.actor]

    def merge(self, src: "AWSetDelta") -> None:  # type: ignore[override]
        """δ-dispatch (awset-delta_test.go:51-65): first contact → full
        merge; otherwise sender compresses a δ payload against our VV."""
        if self.version_vector.counter(src.actor) <= 0:
            # Never seen src's actor: full merge.  Reference mode does NOT
            # transfer src.deleted (deletions propagate via the VV in
            # phase 2); v2 additionally absorbs the log and processed
            # vector, since the merged state reflects every deletion src's
            # state reflected.
            self._merge(src.version_vector, src.entries)
            if self.delta_semantics == "v2":
                self._absorb_records(src.deleted)
                self._join_processed(src)
                self._note_peer_processed(src)
                self.gc_deleted(src.actor, src.version_vector)
            return
        changed, deleted = src.make_delta_merge_data(self.version_vector)
        if changed is None and deleted is None:
            # Empty δ: reference mode EARLY-RETURNS — VV not merged and no
            # GC pass (the reference's gcDeleted call sits inside the
            # non-empty branch, awset-delta_test.go:60-64).  Entries
            # converge before clocks.  Non-strict/v2 join clocks and still
            # count the ack.
            if self.delta_semantics == "v2":
                self.version_vector.merge(src.version_vector)
                self._join_processed(src)
                self._note_peer_processed(src)
                self.gc_deleted(src.actor, src.version_vector)
            elif not self.strict_reference_semantics:
                self.version_vector.merge(src.version_vector)
                self.gc_deleted(src.actor, src.version_vector)
            return
        self.delta_merge(src.version_vector, changed or {}, deleted or {})
        if self.delta_semantics == "v2":
            self._absorb_records(deleted or {})
            self._join_processed(src)
            self._note_peer_processed(src)
        self.gc_deleted(src.actor, src.version_vector)

    # -- v2 bookkeeping ----------------------------------------------------

    def _absorb_records(self, records: Dict[str, Dot]) -> None:
        """v2: received deletion records enter our own log so they re-gossip
        transitively (reference mode never does this — that is why its
        deletions only travel originator→peer).

        The retained record is the lexicographic MAX on (counter,
        actor): counter ties between records from DIFFERENT actors are
        broken by actor id, never by arrival order — without the
        tie-break the absorb is not a join (two replicas receiving the
        same tied records in opposite orders keep different ones
        forever), which the digest-sync regime (DESIGN.md §19) would
        read as permanent lane divergence."""
        for k, d in records.items():
            cur = self.deleted.get(k)
            if cur is None or (d.counter, d.actor) > (cur.counter,
                                                     cur.actor):
                self.deleted[k] = d

    def _join_processed(self, src: "AWSetDelta") -> None:
        """v2: join src's processed vector.  Sound because the exchange that
        carries it also carries (changed, deleted-records) — after applying
        them our state reflects every deletion src's state reflected.  The
        sender's own-origin log is always complete in the payload, so its
        own slot advances to its clock."""
        for a, c in src.processed.items():
            if self.processed.get(a, 0) < c:
                self.processed[a] = c
        own = src.version_vector.counter(src.actor)
        if self.processed.get(src.actor, 0) < own:
            self.processed[src.actor] = own

    def _note_peer_processed(self, src: "AWSetDelta") -> None:
        adv = dict(src.processed)
        adv[src.actor] = src.version_vector.counter(src.actor)
        cur = self.peer_processed.setdefault(src.actor, {})
        for a, c in adv.items():
            if cur.get(a, 0) < c:
                cur[a] = c

    def make_delta_merge_data(
        self, dst_vv: VersionVector
    ) -> Tuple[Optional[Dict[str, Dot]], Optional[Dict[str, Dot]]]:
        """SENDER-side δ-computation (awset-delta_test.go:79-105): the
        receiver advertises its VV; we ship only entries it can't have seen
        plus deletions not masked by a later re-add.

        Returns (changed, deleted); each is None when empty — the None-ness
        (not just emptiness) drives the early-return quirk upstream."""
        changed: Optional[Dict[str, Dot]] = None
        deleted: Optional[Dict[str, Dot]] = None
        for k, dot in self.entries.items():
            if not dst_vv.has_dot(dot):
                if changed is None:
                    changed = {}
                changed[k] = dot
        for k, dot in self.deleted.items():
            mdot = self.entries.get(k)
            if mdot is not None and (mdot.actor != dot.actor or mdot.counter > dot.counter):
                # deleted then re-added; the deletion is obsolete — skip
                # (awset-delta_test.go:93-97).
                continue
            if deleted is None:
                deleted = {}
            deleted[k] = dot
        return changed, deleted

    def delta_merge(
        self,
        src_vv: VersionVector,
        src_changes: Dict[str, Dot],
        src_deleted: Dict[str, Dot],
    ) -> None:
        """Receiver-side δ-apply (awset-delta_test.go:107-166).

        In the reference this is a method on AWSet (not AWSetDelta) — it only
        touches (entries, VV), never the receiver's own deletion log."""
        dst = self
        # PHASE 1 over changes: identical decision table to full-merge
        # phase 1 (awset-delta_test.go:126-147).
        for k, src_dot in src_changes.items():
            dst_dot = dst.entries.get(k)
            if dst_dot is not None:
                self._log(1, k, dst_dot, src_dot,
                          "update" if dst_dot != src_dot else "keep")
            else:
                if dst.version_vector.has_dot(src_dot):
                    self._log(1, k, None, src_dot, "skip")
                    continue
                self._log(1, k, None, src_dot, "add")
            dst.entries[k] = src_dot
        # PHASE 2 over the deletion payload (awset-delta_test.go:149-164).
        # The HasDot checks use dst's PRE-JOIN VV (the join happens below).
        for k, src_dot in src_deleted.items():
            dst_dot = dst.entries.get(k)
            if dst_dot is not None:
                if getattr(self, "delta_semantics", "reference") == "v2":
                    # v2 arbitration == full-merge phase 2 (awset.go:152)
                    # restricted to this key: remove iff the SENDER's VV
                    # covers our LIVE dot (sender witnessed that very add
                    # and still says gone).  Keeps add-wins in any topology.
                    if src_vv.has_dot(dst_dot):
                        self._log(2, k, dst_dot, None, "remove")
                        del dst.entries[k]
                    else:
                        self._log(2, k, dst_dot, src_dot, "keep")
                elif dst.version_vector.has_dot(src_dot):
                    # Reference arbitration (awset-delta_test.go:153-155):
                    # our VV covers the DELETION dot — we already knew a
                    # state at/after it and the entry is (re-)present
                    # locally: keep.  (Can violate add-wins with 3+ actors;
                    # pinned by test_reference_delta_add_wins_violation.)
                    self._log(2, k, None, src_dot, "keep")
                else:
                    self._log(2, k, dst_dot, None, "remove")
                    del dst.entries[k]
            else:
                # No-op delete; the reference logs it with a zero-value Dot
                # (awset-delta_test.go:160-162) — cosmetic; we log None.
                self._log(2, k, None, None, "remove")
        dst.version_vector.merge(src_vv)

    def _known_peers(self) -> set:
        known = {
            a
            for a in range(len(self.version_vector))
            if a != self.actor and self.version_vector.counter(a) > 0
        }
        known |= set(self.peer_acked)
        known |= set(self.peer_processed)
        known.discard(self.actor)
        return known

    def gc_deleted(self, src_actor: Actor, src_vv: VersionVector) -> None:
        """δ-log GC.  Reference: EMPTY STUB (awset-delta_test.go:67-77) whose
        comments sketch two designs (per-actor refcounts, or one Deleted map
        per known actor).  Disabled by default for strict conformance with
        the stub (the reference's log grows forever).

        Reference mode (``gc_enabled=True``): an ack frontier over peers'
        advertised VV counters for our actor.  This is sound ONLY for the
        pairwise 2-replica topology the reference prototype exercises: with
        3+ replicas, VV counters propagate transitively through VV joins
        WITHOUT the deletion records (reference δ payloads carry only the
        sender's own-origin log), so a peer's vv[us] >= c does not imply it
        processed our deletion c.  Matching the prototype's scope, we keep
        it for 2-replica use; general topologies must use v2.

        v2 mode: causal stability over ``processed`` vectors.  ``processed``
        advances only on exchanges that actually transfer deletion effects
        (payload apply / full merge / transitive record absorption), never
        by bare VV joins, so a record (k, (a, c)) is dropped exactly when
        every known peer has advertised ``processed[a] >= c`` — i.e. every
        known peer's state reflects the deletion.  Peers that never sync
        block the frontier; that is inherent to causal stability and the
        price of a sound distributed GC."""
        if not self.gc_enabled:
            return
        if self.delta_semantics == "v2":
            known = self._known_peers()
            if not known:
                return

            def stable(d: Dot) -> bool:
                return all(
                    self.peer_processed.get(p, {}).get(d.actor, 0) >= d.counter
                    for p in known
                )

            self.deleted = {
                k: d for k, d in self.deleted.items() if not stable(d)
            }
            return
        # reference mode: pairwise VV ack frontier (2-replica sound only).
        prev = self.peer_acked.get(src_actor, 0)
        self.peer_acked[src_actor] = max(prev, src_vv.counter(self.actor))
        known = self._known_peers()
        if not known:
            return
        frontier = min(self.peer_acked.get(a, 0) for a in known)
        self.deleted = {
            k: d
            for k, d in self.deleted.items()
            if d.actor != self.actor or d.counter > frontier
        }
