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
a micro-batch on CUDA).  The mesh flavors and the admission scheduler
are not ported yet (``NotYetPorted``).
"""

from go_crdt_playground_tpu_torch.serve.admission import (AdmissionQueue,  # noqa: F401
                                                    OpRequest)
from go_crdt_playground_tpu_torch.serve.apply import (ApplyTarget,  # noqa: F401
                                                HandoffTarget)
from go_crdt_playground_tpu_torch.serve.batcher import MicroBatcher  # noqa: F401
from go_crdt_playground_tpu_torch.serve.client import (PendingOp,  # noqa: F401
                                                 ServeClient)
from go_crdt_playground_tpu_torch.serve.compaction import \
    CompactionScheduler  # noqa: F401
from go_crdt_playground_tpu_torch.serve.frontend import (  # noqa: F401
    NotYetPorted, ServeFrontend)
from go_crdt_playground_tpu_torch.serve.host import ConnHost  # noqa: F401
from go_crdt_playground_tpu_torch.serve.protocol import (DeadlineExceeded,  # noqa: F401
                                                   Draining, InvalidOp,
                                                   KeyspaceMoving,
                                                   Overloaded, ServeError,
                                                   ShardUnavailable)
from go_crdt_playground_tpu_torch.serve.session import Session  # noqa: F401
