"""Fleet autopilot: the closed control loop over the sharded fleet
(DESIGN.md §21).

Everything needed for autoscaling existed as MANUAL verbs — fenced
zero-loss resharding (shard/handoff.py), ``ring.load_stats``, per-shard
breakers, the serve STATS surface — but a human still ran ``reshard
--join/--leave``.  This package closes the loop:

* ``signals``  — observe: poll the router STATS fan-out, maintain
  per-shard WINDOWED signals (op-rate, queue depth, ingest p99, shed)
  plus keyspace heat;
* ``policy``   — decide: a deterministic, seeded, hysteresis-banded
  policy emitting structured replayable decision records;
* ``actuator`` — actuate: drive the existing ``reshard`` verbs through
  ``ServeClient`` with jittered backoff, treating a typed abort as the
  SAFE path (old ring provably serving → cool down);
* ``controller`` — the loop + standby pool + decision log + restart
  resumption from the router's persisted committed ring.
"""

from go_crdt_playground_tpu_torch.control.actuator import (ActionOutcome,
                                                     ReshardActuator)
from go_crdt_playground_tpu_torch.control.controller import (FleetAutopilot,
                                                       StandbyPool)
from go_crdt_playground_tpu_torch.control.policy import (AutopilotPolicy,
                                                   Decision, PolicyConfig)
from go_crdt_playground_tpu_torch.control.signals import (FleetSignals,
                                                    FleetView,
                                                    ShardSignals)

__all__ = [
    "ActionOutcome", "ReshardActuator", "FleetAutopilot", "StandbyPool",
    "AutopilotPolicy", "Decision", "PolicyConfig", "FleetSignals",
    "FleetView", "ShardSignals",
]
