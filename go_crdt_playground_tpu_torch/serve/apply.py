"""The batcher's pluggable apply target (the sharded-fleet unlock).

``MicroBatcher`` used to be hard-wired to a local ``net/peer.Node``;
everything it actually NEEDS is this protocol: the element universe (to
shape the packed ``(B, E)`` selector pair), an actor id (thread
naming/diagnostics), and one durable group-commit apply.  With the
dependency narrowed to the protocol, the whole serving frontend —
listener, admission queue, batcher, drain sequence — is reusable
unchanged in front of ANY replica flavor: the local node it fronts
today (each shard of the fleet runs one, shard/fleet.py), a
mesh-sharded replica driven over ``NamedSharding`` next, or a remote
shard proxy.

The durability contract RIDES the protocol: ``ingest_batch`` must not
return until the batch's effects are as durable as the deployment
claims (for a WAL-backed node: state applied AND the batch δ fsync'd),
because the batcher sends acks immediately after it returns —
DESIGN.md §16's fsync-before-ack, hinged here.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class ApplyTarget(Protocol):
    """What the micro-batcher requires of the replica it feeds.
    ``net/peer.Node`` satisfies it as-is (the local target).

    Optional attribute ``ingest_stripes`` (int, default 1): how many
    micro-batches the target applies CONCURRENTLY per durable group
    commit.  The batcher multiplies its drain watermark by it, so a
    target with replicated ingest stripes (the 2-D dp×mp mesh replica,
    parallel/meshtarget2d.py — ``ingest_stripes == dp``) receives
    stripes × max_batch rows per ``ingest_batch`` call; the target
    owns striping them (key-disjoint planning, counter parity) — the
    batcher only widens the packed arrays.

    A striped target's ``ingest_batch`` additionally accepts a keyword
    ``stripe_hint`` (int per batch row, negatives = unhinted): the
    conflict-aware admission scheduler's pre-striping
    (serve/scheduler.py).  The hint is ADVISORY — the target still
    enforces key-disjointness and stripe capacity itself — and the
    batcher only passes it when a scheduler is attached, so plain
    targets never see the keyword."""

    num_elements: int
    actor: int

    def ingest_batch(self, add_rows: np.ndarray, del_rows: np.ndarray,
                     live: np.ndarray) -> None:
        """Apply one packed ``(B, E)`` op-batch; row ``b`` is request
        b's Add/Del key selector, ``live`` masks padding rows.
        durable-on-return: the batcher acks the batch's ops the moment
        this returns."""
        ...


@runtime_checkable
class HandoffTarget(ApplyTarget, Protocol):
    """The live-resharding seam (DESIGN.md §18): what a replica must
    additionally offer for its frontend to serve keyspace-handoff
    SLICE_PULL/SLICE_PUSH requests.  ``net/peer.Node`` satisfies it
    as-is; a mesh-sharded or remote replica plugs in here exactly like
    it plugs into the batcher."""

    def extract_slice(self, element_mask: np.ndarray) -> bytes:
        """The donor half: the replica's complete state for the masked
        elements as an anti-entropy PAYLOAD body (delta-framed — the
        recipient's apply must be additive outside the slice)."""
        ...

    def apply_payload_body(self, body: bytes) -> None:
        """The recipient half.  durable-on-return, like
        ``ingest_batch``: the frontend acks the push the moment this
        returns, and the handoff's ring swap trusts that ack."""
        ...
