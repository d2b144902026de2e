"""Merger bridge: the port's merges as a service.

The counterpart of the JAX package's ``bridge/``: the proto schema in
``merger.proto`` (unchanged), its five messages encoded by hand in
``messages.py`` (no protobuf), the always-available TCP transport and
optional gRPC serving in ``service``.
"""

from go_crdt_playground_tpu_torch.bridge.service import (  # noqa: F401
    MergerClient,
    MergerServer,
    execute_merge,
    serve_grpc,
)
