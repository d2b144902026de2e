"""The networked replica node (net/peer.py), its message framing
(net/framing.py), digest-driven anti-entropy (net/digestsync.py) and the
sync supervisor (net/antientropy.py)."""

from go_crdt_playground_tpu_torch.net.antientropy import (  # noqa: F401
    CircuitBreaker, SyncSupervisor, classify_failure)
from go_crdt_playground_tpu_torch.net.peer import (  # noqa: F401
    ConnectFailed, Node, PeerProtocolError, PeerReset, PeerTimeout,
    SyncError, SyncStats)
