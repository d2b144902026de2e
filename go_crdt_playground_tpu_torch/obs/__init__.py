"""Observability: the metrics recorder (obs/metrics.py) and merge-decision
trace rendering (obs/trace.py).

The trace names load on first use: obs/trace.py reads the merge's
outcome codes from ops/merge.py, which imports torch, and the host-only
tiers that import the recorder load no torch.
"""

from go_crdt_playground_tpu_torch.obs.metrics import (  # noqa: F401
    Recorder, payload_metrics)

_TRACE_NAMES = ("format_event", "render_spec_trace", "render_tensor_trace",
                "render_delta_tensor_trace", "format_delta_extract",
                "format_delta_extract_tensor", "printstate", "trace_counts")

__all__ = ["Recorder", "payload_metrics", *_TRACE_NAMES]


def __getattr__(name):
    if name in _TRACE_NAMES:
        from go_crdt_playground_tpu_torch.obs import trace

        return getattr(trace, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
