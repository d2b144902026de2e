"""The serving fleet's shard-side pieces: the seeded consistent-hash
ring (shard/ring.py), the durable epoch records of live resharding and
router HA (shard/handoff.py), and shard replication (shard/replica.py:
the primary's ``ReplicationPublisher``, the ``ShardStandby``).

A serving frontend builds a ``ReplicationPublisher``, loads its epochs
from its durable directory and answers the handoff, replication and GC
verbs with these.  The router tier, its HA and the fleet runner are not
part of the port yet.
"""

from go_crdt_playground_tpu_torch.shard.ring import HashRing  # noqa: F401
