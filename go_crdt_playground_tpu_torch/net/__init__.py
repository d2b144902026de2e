"""The networked replica node (net/peer.py), its message framing
(net/framing.py), digest-driven anti-entropy (net/digestsync.py), the
sync supervisor (net/antientropy.py) and seeded fault injection
(net/faults.py).

The names below load on first use: the router tier imports
``net.framing`` and ``net.breaker`` and must not load torch, which
``net.peer`` does.
"""

import importlib

_EXPORTS = {
    "CircuitBreaker": "breaker",
    "SyncSupervisor": "antientropy",
    "classify_failure": "antientropy",
    "ChaosProxy": "faults",
    "ChaosScenario": "faults",
    "StorageFaults": "faults",
    "StorageScenario": "faults",
    "ConnectFailed": "peer",
    "Node": "peer",
    "PeerProtocolError": "peer",
    "PeerReset": "peer",
    "PeerTimeout": "peer",
    "SyncError": "peer",
    "SyncStats": "peer",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
