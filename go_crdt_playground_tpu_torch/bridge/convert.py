"""Proto <-> spec-model conversions for the Merger bridge.

The counterpart of the JAX package's ``bridge/convert.py``, over the
hand codec of ``messages.py``.  ReplicaState is an AWSet snapshot
(awset.go:55-59) plus the δ Deleted log (awset-delta_test.go:9-12) and the
v2 processed vector.  Wire counters are uint64 like Go's uint; the packed
states hold uint32, so ``check_uint32`` rejects what cannot be
represented instead of silently truncating.
"""

from __future__ import annotations

from typing import Union

from go_crdt_playground_tpu_torch.bridge import messages as pb
from go_crdt_playground_tpu_torch.models.spec import (AWSet, AWSetDelta, Dot,
                                                      VersionVector)
from go_crdt_playground_tpu_torch.utils.guards import UINT32_MAX


def check_uint32(state: pb.ReplicaState, label: str) -> None:
    too_big = [c for c in state.version_vector if c > UINT32_MAX]
    too_big += [e.dot.counter for e in state.entries
                if e.dot.counter > UINT32_MAX]
    too_big += [e.dot.counter for e in state.deleted
                if e.dot.counter > UINT32_MAX]
    too_big += [c for c in state.processed if c > UINT32_MAX]
    if too_big:
        raise OverflowError(
            f"{label}: counter {max(too_big)} exceeds the packed kernels' "
            f"uint32 range ({UINT32_MAX})")


def replica_from_proto(state: pb.ReplicaState,
                       delta: bool = False,
                       delta_semantics: str = "reference",
                       strict_reference_semantics: bool = True,
                       ) -> Union[AWSet, AWSetDelta]:
    vv = VersionVector(list(state.version_vector))
    if delta:
        rep: Union[AWSet, AWSetDelta] = AWSetDelta(
            actor=int(state.actor), version_vector=vv,
            delta_semantics=delta_semantics,
            strict_reference_semantics=strict_reference_semantics,
        )
        for e in state.deleted:
            rep.deleted[e.key] = Dot(int(e.dot.actor), int(e.dot.counter))
        for a, c in enumerate(state.processed):
            if c:
                rep.processed[a] = int(c)
    else:
        rep = AWSet(actor=int(state.actor), version_vector=vv)
    for e in state.entries:
        rep.entries[e.key] = Dot(int(e.dot.actor), int(e.dot.counter))
    return rep


def replica_to_proto(rep: Union[AWSet, AWSetDelta]) -> pb.ReplicaState:
    out = pb.ReplicaState(
        actor=rep.actor,
        version_vector=list(rep.version_vector.v),
    )
    for key in sorted(rep.entries):
        d = rep.entries[key]
        out.entries.append(pb.Entry(key=key, dot=pb.Dot(
            actor=d.actor, counter=d.counter)))
    if isinstance(rep, AWSetDelta):
        for key in sorted(rep.deleted):
            d = rep.deleted[key]
            out.deleted.append(pb.Entry(key=key, dot=pb.Dot(
                actor=d.actor, counter=d.counter)))
        if rep.processed:
            width = max(rep.processed) + 1
            out.processed.extend(
                rep.processed.get(a, 0) for a in range(width))
    return out
