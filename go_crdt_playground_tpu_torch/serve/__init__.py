"""Op-ingest serving frontend (DESIGN.md §16 "Serving ladder").

The client→replica hot path: a TCP frontend accepts add/del ops against
a keyed AWSet replica, micro-batches them into packed ``(B, E)`` tensor
applies through the merge kernels, WAL-fsyncs the batch δ before acking
(group commit), and hands the merged state to the existing anti-entropy
runtime for dissemination.  Admission is bounded and sheds with typed
``Overloaded`` replies; shutdown is a graceful drain; SLO numbers
(p50/p95/p99 ingest latency, batch occupancy, queue depth) flow through
``obs.Recorder``.

The counterpart of the JAX package's ``serve/``: the same protocol,
replies, WAL records and counters, over a torch replica (one K10 launch
a micro-batch on CUDA), the mesh-sharded replica flavors and the
conflict-aware admission scheduler included.

The names below load on first use: the router tier imports the client,
the protocol and the connection host and must not load torch, which the
frontend does.
"""

import importlib

_EXPORTS = {
    "AdmissionQueue": "admission",
    "OpRequest": "admission",
    "ApplyTarget": "apply",
    "HandoffTarget": "apply",
    "MicroBatcher": "batcher",
    "PendingOp": "client",
    "ServeClient": "client",
    "CompactionScheduler": "compaction",
    "ServeFrontend": "frontend",
    "ConnHost": "host",
    "DeadlineExceeded": "protocol",
    "Draining": "protocol",
    "InvalidOp": "protocol",
    "KeyspaceMoving": "protocol",
    "Overloaded": "protocol",
    "ServeError": "protocol",
    "ShardUnavailable": "protocol",
    "Session": "session",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
