"""Seeded rendezvous (HRW) consistent hashing over element ids.

The ring decides ONE thing: which shard owns element ``e``.  Rendezvous
hashing (highest-random-weight) is used instead of a vnode ring because
its minimal-remap property is exact, not statistical: ``owner(e)`` is
the shard maximizing a keyed hash score of ``(seed, shard_id, e)``, so

* removing a shard moves ONLY the keys it owned (every other key's
  argmax is untouched), and
* adding a shard moves ONLY the keys the newcomer now wins — an
  expected ``1/(n+1)`` fraction, the information-theoretic floor.

Balance is multinomial: with ``E >> n`` the max/mean shard load
concentrates near 1 (bound pinned by tests/test_shard_ring.py).

Scores come from ``hashlib.blake2b`` over the raw ``(seed, shard_id,
element)`` bytes — never Python's ``hash()``, which is salted per
process: two processes building a ring from the same (shards, seed)
MUST route identically, or a router restart would strand keys on the
wrong replicas.  ``digest()`` condenses the whole owner map into one
hex string so that cross-process determinism is a one-line assertion
(the ``router`` CLI's dry-run mode prints it).

The ring is immutable; membership change is a NEW ring
(``with_shard``/``without_shard``) so a router swap is atomic by
construction — there is no half-updated routing state to lock.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class HashRing:
    """Immutable seeded rendezvous hash over a fixed shard set."""

    def __init__(self, shards: Sequence[str], seed: int = 0):
        if not shards:
            raise ValueError("a ring needs at least one shard")
        if len(set(shards)) != len(shards):
            raise ValueError(f"duplicate shard ids in {list(shards)!r}")
        for sid in shards:
            if not isinstance(sid, str) or not sid:
                raise ValueError(f"shard id must be a non-empty str, "
                                 f"got {sid!r}")
        # sorted: ownership must depend on the shard SET, not the order
        # the operator happened to list it in (two routers configured
        # with permuted --shard flags must agree)
        self.shards: Tuple[str, ...] = tuple(sorted(shards))
        self.seed = int(seed)

    # -- scores -------------------------------------------------------------

    def _score(self, sid: str, element_id: int) -> int:
        h = hashlib.blake2b(digest_size=8)
        h.update(struct.pack("<qQ", self.seed, int(element_id)))
        h.update(sid.encode("utf-8"))
        return int.from_bytes(h.digest(), "little")

    def owner(self, element_id: int) -> str:
        """The shard id owning ``element_id`` (ties broken by shard id,
        which blake2b makes a ~2^-64 event — the break just keeps the
        function total)."""
        return max(self.shards,
                   key=lambda sid: (self._score(sid, element_id), sid))

    def owner_index(self, element_id: int) -> int:
        """``owner()`` as an index into ``self.shards`` (what a router
        hot path caches)."""
        return self.shards.index(self.owner(element_id))

    # -- bulk views ---------------------------------------------------------

    def owner_map(self, num_elements: int) -> np.ndarray:
        """``(E,)`` int32 array of owner indices into ``self.shards`` —
        computed once at router start, then every OP routes by one array
        lookup."""
        if num_elements < 1:
            raise ValueError("num_elements must be >= 1")
        out = np.empty(num_elements, np.int32)
        for e in range(num_elements):
            out[e] = self.owner_index(e)
        return out

    def partition(self, num_elements: int) -> Dict[str, np.ndarray]:
        """shard id -> sorted element ids it owns (the fleet soak's
        keyspace ledger)."""
        owners = self.owner_map(num_elements)
        return {sid: np.nonzero(owners == i)[0]
                for i, sid in enumerate(self.shards)}

    def digest(self, num_elements: int,
               owners: Optional[np.ndarray] = None) -> str:
        """Hex digest of the full owner map: equal (shards, seed, E) ⇒
        equal digest in ANY process — the cross-process routing
        determinism probe.  Pass a precomputed ``owner_map`` result as
        ``owners`` to avoid hashing the universe twice."""
        if owners is None:
            owners = self.owner_map(num_elements)
        h = hashlib.blake2b(digest_size=16)
        h.update(("|".join(self.shards) + f"#{self.seed}").encode())
        h.update(np.ascontiguousarray(owners, np.int32).tobytes())
        return h.hexdigest()

    # -- membership change (new ring, old one untouched) --------------------

    def with_shard(self, sid: str) -> "HashRing":
        return HashRing(self.shards + (sid,), seed=self.seed)

    def without_shard(self, sid: str) -> "HashRing":
        if sid not in self.shards:
            raise ValueError(f"shard {sid!r} not in ring {self.shards}")
        if len(self.shards) == 1:
            raise ValueError("cannot remove the last shard")
        return HashRing([s for s in self.shards if s != sid],
                        seed=self.seed)

    def __repr__(self) -> str:
        return f"HashRing(shards={list(self.shards)}, seed={self.seed})"


def load_stats(owners: np.ndarray, num_shards: int) -> Dict[str, float]:
    """Balance summary of an owner map: per-shard loads plus the
    max/mean ratio the balance-bound test pins."""
    loads = np.bincount(owners, minlength=num_shards)
    mean = float(loads.mean())
    return {
        "loads": [int(x) for x in loads],
        "max_over_mean": float(loads.max()) / mean if mean else 0.0,
        "min_over_mean": float(loads.min()) / mean if mean else 0.0,
    }


def handoff_plan(before: np.ndarray, after: np.ndarray,
                 shards_before: Sequence[str],
                 shards_after: Sequence[str]
                 ) -> List[Tuple[str, str, List[int]]]:
    """The keyspace-handoff work list between two owner maps: one
    ``(donor_sid, recipient_sid, element_ids)`` entry per directed pair
    whose ownership changed — exactly the slices a live reshard must
    transfer before the ring swap (shard/handoff.py).  Sorted for
    deterministic transfer order; under HRW minimal remap a join's
    recipients are all the joiner and a leave's donors all the
    leaver."""
    pairs: Dict[Tuple[str, str], List[int]] = {}
    for e in range(len(before)):
        src = shards_before[before[e]]
        dst = shards_after[after[e]]
        if src != dst:
            pairs.setdefault((src, dst), []).append(e)
    return [(src, dst, elems)
            for (src, dst), elems in sorted(pairs.items())]


def remap_fraction(before: np.ndarray, after: np.ndarray,
                   shards_before: Sequence[str],
                   shards_after: Sequence[str]) -> Dict[str, object]:
    """How much of the keyspace moved between two owner maps, and
    whether every move was FORCED by the membership change (into a
    joining shard / out of a leaving one) — the minimal-remap property
    as data, adjudicated by tests/test_shard_ring.py."""
    before_ids = [shards_before[i] for i in before]
    after_ids = [shards_after[i] for i in after]
    moved = [e for e in range(len(before_ids))
             if before_ids[e] != after_ids[e]]
    joined = set(shards_after) - set(shards_before)
    left = set(shards_before) - set(shards_after)
    gratuitous: List[int] = [
        e for e in moved
        if after_ids[e] not in joined and before_ids[e] not in left]
    return {
        "moved": len(moved),
        "fraction": len(moved) / max(1, len(before_ids)),
        "gratuitous": gratuitous,  # MUST be [] — a move neither into a
                                   # joiner nor out of a leaver
    }
