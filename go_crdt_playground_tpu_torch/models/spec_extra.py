"""Executable specs for the additional CRDT families.

The reference implements exactly one CRDT (the AWSet) plus its δ variant;
its version vector is itself a G-Counter-shaped lattice (crdt-misc.go:43-55
is an elementwise max join).  The BASELINE config ladder requires more
families (G-Counter at config 2, 2P-Set at config 5), and a framework
replacing the reference should cover the standard state-based menagerie.
These dict/list models are the conformance oracles of the lattice
kernels, the role models/spec.py plays for the AWSet kernels (the
counterpart of the JAX package's ``models/spec_extra.py``).

All follow the reference's design language: actor-indexed arrays, join =
pairwise monotone merge, ops tick per-actor slots (cf. the Shapiro et al.
"comprehensive study" the reference cites at awset.go:43-44).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "GCounter",
    "PNCounter",
    "TwoPSet",
    "LWWMap",
    "MVRegister",
    "ORMap",
]


class GCounter:
    """Grow-only counter: per-actor monotone counts, value = sum, join =
    elementwise max — the lattice the reference's VersionVector.Merge
    already implements (crdt-misc.go:43-55)."""

    def __init__(self, actor: int, num_actors: int):
        self.actor = actor
        self.counts: List[int] = [0] * num_actors

    def inc(self, amount: int = 1) -> None:
        if amount < 0:
            raise ValueError("GCounter only grows")
        self.counts[self.actor] += amount

    def value(self) -> int:
        return sum(self.counts)

    def merge(self, src: "GCounter") -> None:
        self.counts = [max(a, b) for a, b in zip(self.counts, src.counts)]


class PNCounter:
    """Increment/decrement counter: two G-Counters (P - N)."""

    def __init__(self, actor: int, num_actors: int):
        self.p = GCounter(actor, num_actors)
        self.n = GCounter(actor, num_actors)

    def inc(self, amount: int = 1) -> None:
        self.p.inc(amount)

    def dec(self, amount: int = 1) -> None:
        self.n.inc(amount)

    def value(self) -> int:
        return self.p.value() - self.n.value()

    def merge(self, src: "PNCounter") -> None:
        self.p.merge(src.p)
        self.n.merge(src.n)


class TwoPSet:
    """Two-phase set: add-set + remove-set, remove wins forever (an element
    can never be re-added).  The tombstone-ful contrast to the reference's
    tombstone-free AWSet (awset.go:9-35 discusses exactly this trade)."""

    def __init__(self):
        self.added: Set[str] = set()
        self.removed: Set[str] = set()

    def add(self, *keys: str) -> None:
        self.added.update(keys)

    def del_(self, *keys: str) -> None:
        # only observed elements can be removed (classic 2P rule)
        for k in keys:
            if k in self.added:
                self.removed.add(k)

    def has(self, k: str) -> bool:
        return k in self.added and k not in self.removed

    def values(self) -> List[str]:
        return sorted(self.added - self.removed)

    def merge(self, src: "TwoPSet") -> None:
        self.added |= src.added
        self.removed |= src.removed


class LWWMap:
    """Last-writer-wins map: per key (timestamp, actor, value); join keeps
    the lexicographically larger (ts, actor) — actor id breaks timestamp
    ties deterministically.  Timestamps are caller-supplied logical clocks
    (the framework never reads wall clocks; determinism is a design rule).
    Deletes are LWW tombstones (value None)."""

    def __init__(self, actor: int):
        self.actor = actor
        # key -> (ts, actor, value | None)
        self.cells: Dict[str, Tuple[int, int, Optional[int]]] = {}

    def put(self, k: str, value: Optional[int], ts: int) -> None:
        if ts < 1:
            raise ValueError("logical timestamps start at 1 (0 = unwritten)")
        cur = self.cells.get(k)
        cand = (ts, self.actor, value)
        if cur is None or cand[:2] > cur[:2]:
            self.cells[k] = cand

    def delete(self, k: str, ts: int) -> None:
        self.put(k, None, ts)

    def get(self, k: str) -> Optional[int]:
        cur = self.cells.get(k)
        return cur[2] if cur is not None else None

    def items(self) -> Dict[str, int]:
        return {k: v for k, (ts, a, v) in sorted(self.cells.items())
                if v is not None}

    def merge(self, src: "LWWMap") -> None:
        for k, cand in src.cells.items():
            cur = self.cells.get(k)
            if cur is None or cand[:2] > cur[:2]:
                self.cells[k] = cand


class ORMap:
    """Observed-remove map: key membership follows the AWSet's add-wins
    semantics exactly (delegation to models/spec.AWSet — same dots, same
    two-phase merge), with one LWW cell per key for the value.

    Value lifetime is INDEPENDENT of key membership: deleting a key hides
    it, but a later re-add shows the latest value ever written (the cells
    lattice never forgets).  This is the pragmatic LWW-value OR-Map; a
    causally-reset value (Riak-map style) would need per-cell causal
    contexts and is future work — documented so users aren't surprised."""

    def __init__(self, actor: int, num_actors: int):
        from go_crdt_playground_tpu_torch.models.spec import AWSet, VersionVector

        self.keys = AWSet(actor=actor,
                          version_vector=VersionVector([0] * num_actors))
        self.cells = LWWMap(actor=actor)

    def put(self, k: str, value: int, ts: int) -> None:
        self.keys.add(k)
        self.cells.put(k, value, ts)

    def delete(self, k: str) -> None:
        """Observed-remove of the key (awset.go:96-101 semantics: no clock
        tick, no tombstone); the value cell is untouched."""
        self.keys.del_(k)

    def get(self, k: str) -> Optional[int]:
        if not self.keys.has(k):
            return None
        return self.cells.get(k)

    def items(self) -> Dict[str, int]:
        out = {}
        for k in self.keys.sorted_values():
            v = self.cells.get(k)
            if v is not None:
                out[k] = v
        return out

    def merge(self, src: "ORMap") -> None:
        self.keys.merge(src.keys)
        self.cells.merge(src.cells)


class MVRegister:
    """Multi-value register (optimized, per-actor slots): a write replaces
    all currently-visible values; concurrent writes all survive until
    causally dominated.  State per actor: latest (counter, value) write
    plus a causal-context VV; an entry survives a join iff present on both
    sides or newer than the other side's context — the same
    presence/causality arbitration pattern as the AWSet (awset.go:28-35),
    specialized to one slot per actor."""

    def __init__(self, actor: int, num_actors: int):
        self.actor = actor
        self.ctx: List[int] = [0] * num_actors          # causal context
        self.live: List[bool] = [False] * num_actors
        self.cnt: List[int] = [0] * num_actors
        self.val: List[int] = [0] * num_actors

    def write(self, value: int) -> None:
        self.ctx[self.actor] += 1
        for a in range(len(self.live)):
            # dead slots are zeroed — canonical form shared with the packed
            # tensor state so bitwise conformance checks are meaningful
            self.live[a] = False
            self.cnt[a] = 0
            self.val[a] = 0
        self.live[self.actor] = True
        self.cnt[self.actor] = self.ctx[self.actor]
        self.val[self.actor] = value

    def read(self) -> List[int]:
        """All concurrent values, ordered by actor id."""
        return [self.val[a] for a in range(len(self.live)) if self.live[a]]

    def merge(self, src: "MVRegister") -> None:
        for a in range(len(self.live)):
            if self.live[a] and src.live[a]:
                # same actor's writes: the higher counter is newer
                if src.cnt[a] > self.cnt[a]:
                    self.cnt[a], self.val[a] = src.cnt[a], src.val[a]
            elif src.live[a] and src.cnt[a] > self.ctx[a]:
                # news we haven't seen: adopt
                self.live[a] = True
                self.cnt[a], self.val[a] = src.cnt[a], src.val[a]
            elif self.live[a] and not src.live[a] and self.cnt[a] <= src.ctx[a]:
                # src witnessed this write and no longer shows it: overwritten
                self.live[a] = False
                self.cnt[a] = 0
                self.val[a] = 0
        self.ctx = [max(a, b) for a, b in zip(self.ctx, src.ctx)]
