"""Sharded serving fleet.

A seeded consistent-hash ring (shard/ring.py) partitions the element
universe across N ``serve --ingest`` frontends, and a thin router tier
(shard/router.py) speaks the serve dialect on both sides: clients dial
the router with an unmodified ``ServeClient``, the router forwards each
op to the owning shard and fans QUERY/MEMBERS/STATS out across the
fleet.  Live resharding (shard/handoff.py), the warm-standby router
(shard/ha.py), shard replication (shard/replica.py) and the fleet
runner (shard/fleet.py) complete it.

A dead shard degrades, never silently drops: ops owned by its keyspace
get a typed ``ShardUnavailable`` reject while every surviving shard's
keyspace keeps serving.  The router, its standby and the fleet runner
are host-only and import no torch; the shards are torch frontends.
"""

from go_crdt_playground_tpu_torch.shard.fleet import (FleetSpec,  # noqa: F401
                                                      RouterProc,
                                                      ShardFleet, ShardProc)
from go_crdt_playground_tpu_torch.shard.ha import RouterStandby  # noqa: F401
from go_crdt_playground_tpu_torch.shard.handoff import (  # noqa: F401
    HandoffCoordinator, HandoffError, RouteState)
from go_crdt_playground_tpu_torch.shard.ring import HashRing  # noqa: F401
from go_crdt_playground_tpu_torch.shard.router import ShardRouter  # noqa: F401
