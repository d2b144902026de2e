"""Host-side codec: string dictionary + pack/unpack between the dict-model
spec and packed tensor states.

The counterpart of the JAX package's ``utils/codec.py``, with the same
arrays out of ``pack_*`` (numpy uint32 and bool: callers move them with
``models.awset.from_arrays``) and the same spec replicas out of
``unpack_*``, which read numpy arrays or the port's int32-bit tensors
alike.  The reference keys entries by Go strings in a map (awset.go:58);
tensors need a fixed element universe, so elements are dictionary-encoded
once on the host to ids ``0..E-1``; the dictionary is append-only and
grow-and-repack handles overflow.  Version vectors are padded to a fixed
actor axis ``A`` — exact, since a zero counter means "never seen"
(crdt-misc.go:29-41).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from go_crdt_playground_tpu_torch._host import host
from go_crdt_playground_tpu_torch.models.layout import (
    ACTOR_AXIS_FIELDS as _ACTOR_AXIS_FIELDS,
    REPLICA_ONLY_FIELDS as _REPLICA_ONLY_FIELDS,
)
from go_crdt_playground_tpu_torch.models.spec import (AWSet, AWSetDelta, Dot,
                                                      VersionVector)


class ElementDict:
    """Append-only string<->id dictionary for the element universe.

    ``encode`` assigns the next free id on first sight.  ``capacity`` is the
    packed element axis ``E``; ``grow`` doubles it (callers then re-pack
    states to the larger universe — the overflow policy of SURVEY §7.5.1).
    """

    def __init__(self, capacity: int = 16,
                 values: Optional[Iterable[str]] = None):
        self.capacity = capacity
        self._to_id: Dict[str, int] = {}
        self._to_str: List[str] = []
        if values:
            for v in values:
                self.encode(v)

    def __len__(self) -> int:
        return len(self._to_str)

    def __contains__(self, value: str) -> bool:
        return value in self._to_id

    def encode(self, value: str) -> int:
        eid = self._to_id.get(value)
        if eid is None:
            if len(self._to_str) >= self.capacity:
                raise OverflowError(
                    f"element dictionary full (capacity {self.capacity}); "
                    "grow() and re-pack"
                )
            eid = len(self._to_str)
            self._to_id[value] = eid
            self._to_str.append(value)
        return eid

    def encode_many(self, values: Iterable[str]) -> List[int]:
        return [self.encode(v) for v in values]

    def decode(self, eid: int) -> str:
        return self._to_str[eid]

    def grow(self, factor: int = 2) -> None:
        self.capacity *= factor

    def state_dict(self) -> dict:
        return {"capacity": self.capacity, "values": list(self._to_str)}

    @classmethod
    def from_state_dict(cls, d: dict) -> "ElementDict":
        return cls(capacity=d["capacity"], values=d["values"])


def pack_awsets(
    replicas: Sequence[AWSet],
    dictionary: ElementDict,
    num_actors: int,
) -> Dict[str, np.ndarray]:
    """Pack spec replicas into the canonical dense arrays.

    Returns numpy arrays (host-side; ``models.awset.from_arrays`` moves
    them to a device):
      vv:          uint32[R, A]
      present:     bool[R, E]
      dot_actor:   uint32[R, E]   (0 where absent — canonical form)
      dot_counter: uint32[R, E]
      actor:       uint32[R]      (each replica's own actor id, awset.go:56)
    """
    R, E, A = len(replicas), dictionary.capacity, num_actors
    vv = np.zeros((R, A), np.uint32)
    present = np.zeros((R, E), bool)
    dot_actor = np.zeros((R, E), np.uint32)
    dot_counter = np.zeros((R, E), np.uint32)
    actor = np.zeros((R,), np.uint32)
    for r, rep in enumerate(replicas):
        if len(rep.version_vector) > A:
            raise ValueError(f"replica {r} VV length "
                             f"{len(rep.version_vector)} > A={A}")
        if rep.actor >= A:
            raise ValueError(f"replica {r} actor {rep.actor} >= A={A}")
        actor[r] = rep.actor
        for a, c in enumerate(rep.version_vector.v):
            vv[r, a] = c
        for k, d in rep.entries.items():
            e = dictionary.encode(k)
            present[r, e] = True
            dot_actor[r, e] = d.actor
            dot_counter[r, e] = d.counter
    return {
        "vv": vv,
        "present": present,
        "dot_actor": dot_actor,
        "dot_counter": dot_counter,
        "actor": actor,
    }


def unpack_awsets(
    arrays: Dict[str, np.ndarray],
    dictionary: ElementDict,
) -> List[AWSet]:
    """Inverse of pack_awsets (up to VV length: unpacked VVs carry the full
    fixed actor axis, zero-padded — an exact representation per
    crdt-misc.go:29-41)."""
    vv = host(arrays["vv"])
    present = host(arrays["present"])
    dot_actor = host(arrays["dot_actor"])
    dot_counter = host(arrays["dot_counter"])
    actor = host(arrays["actor"])
    out: List[AWSet] = []
    for r in range(vv.shape[0]):
        rep = AWSet(
            actor=int(actor[r]),
            version_vector=VersionVector([int(c) for c in vv[r]]),
        )
        for e in np.nonzero(present[r])[0]:
            rep.entries[dictionary.decode(int(e))] = Dot(
                int(dot_actor[r, e]), int(dot_counter[r, e])
            )
        out.append(rep)
    return out


def _pad_last(x, amount: int):
    """Zero-pad the trailing axis of a tensor by ``amount``."""
    import torch.nn.functional as F

    return F.pad(x, (0, amount))


def grow_elements(state, new_num_elements: int):
    """Grow-and-repack, element axis (the overflow policy of SURVEY
    §7.5.1): pad every element-shaped field of an AWSetState /
    AWSetDeltaState to the new universe size.  Exact — padded lanes are
    absent (present/deleted False, zero dots), the canonical encoding of
    keys no replica has seen."""
    if not hasattr(state, "present"):
        raise TypeError(
            f"grow_elements supports the AWSet state family; "
            f"{type(state).__name__} has no element-presence field")
    num_e = state.present.shape[-1]
    if new_num_elements < num_e:
        raise ValueError(
            f"cannot shrink element axis {num_e} -> {new_num_elements}")
    pad = new_num_elements - num_e
    if pad == 0:
        return state
    return type(state)(**{
        name: (val if name in _ACTOR_AXIS_FIELDS
               or name in _REPLICA_ONLY_FIELDS
               else _pad_last(val, pad))
        for name, val in zip(state._fields, state)
    })


def grow_actors(state, new_num_actors: int):
    """Grow-and-repack, actor axis: pad vv/processed to more actor slots.
    Exact — a zero counter means "never seen" (crdt-misc.go:29-41)."""
    num_a = state.vv.shape[-1]
    if new_num_actors < num_a:
        raise ValueError(
            f"cannot shrink actor axis {num_a} -> {new_num_actors}")
    pad = new_num_actors - num_a
    if pad == 0:
        return state
    return type(state)(**{
        name: (_pad_last(val, pad) if name in _ACTOR_AXIS_FIELDS else val)
        for name, val in zip(state._fields, state)
    })


def grow_universe(dictionary: ElementDict, state, factor: int = 2):
    """The full overflow move: double the dictionary capacity and repack
    the packed state to match (callers re-bind both)."""
    dictionary.grow(factor)
    return grow_elements(state, dictionary.capacity)


def render_packed(arrays: Dict[str, np.ndarray],
                  dictionary: ElementDict) -> List[str]:
    """Canonical per-replica rendering of a packed state, byte-identical to
    the reference's ``AWSet.String`` format (awset.go:163-171) — the
    conformance serialization."""
    return [str(rep) for rep in unpack_awsets(arrays, dictionary)]


def pack_awset_deltas(
    replicas: Sequence[AWSetDelta],
    dictionary: ElementDict,
    num_actors: int,
) -> Dict[str, np.ndarray]:
    """Pack δ-state replicas: the AWSet arrays plus the deletion log
    (``Deleted`` map, awset-delta_test.go:11) and the v2 ``processed``
    vector (zeroed for reference-mode replicas)."""
    base = pack_awsets(replicas, dictionary, num_actors)
    R, E, A = base["present"].shape[0], dictionary.capacity, num_actors
    deleted = np.zeros((R, E), bool)
    del_dot_actor = np.zeros((R, E), np.uint32)
    del_dot_counter = np.zeros((R, E), np.uint32)
    processed = np.zeros((R, A), np.uint32)
    for r, rep in enumerate(replicas):
        for k, d in rep.deleted.items():
            e = dictionary.encode(k)
            deleted[r, e] = True
            del_dot_actor[r, e] = d.actor
            del_dot_counter[r, e] = d.counter
        for a, c in rep.processed.items():
            if a < A:
                processed[r, a] = c
    base.update(
        deleted=deleted,
        del_dot_actor=del_dot_actor,
        del_dot_counter=del_dot_counter,
        processed=processed,
    )
    return base


def unpack_awset_deltas(
    arrays: Dict[str, np.ndarray],
    dictionary: ElementDict,
    delta_semantics: str = "v2",
) -> List[AWSetDelta]:
    out: List[AWSetDelta] = []
    base = unpack_awsets(arrays, dictionary)
    deleted = host(arrays["deleted"])
    del_dot_actor = host(arrays["del_dot_actor"])
    del_dot_counter = host(arrays["del_dot_counter"])
    processed = host(arrays["processed"])
    for r, rep in enumerate(base):
        drep = AWSetDelta(
            actor=rep.actor,
            version_vector=rep.version_vector,
            entries=rep.entries,
            delta_semantics=delta_semantics,
        )
        for e in np.nonzero(deleted[r])[0]:
            drep.deleted[dictionary.decode(int(e))] = Dot(
                int(del_dot_actor[r, e]), int(del_dot_counter[r, e])
            )
        for a in range(processed.shape[1]):
            if processed[r, a]:
                drep.processed[int(a)] = int(processed[r, a])
        out.append(drep)
    return out
