"""Observability: the metrics recorder (obs/metrics.py).

The reference package's merge-decision tracing (``obs/trace.py``) needs
the spec model and merge tracing, which the port does not have yet; this
package exports the recorder and the payload metrics only.
"""

from go_crdt_playground_tpu_torch.obs.metrics import (  # noqa: F401
    Recorder, payload_metrics)

__all__ = ["Recorder", "payload_metrics"]
