"""Device selection for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  Asking
for CUDA on a machine without a GPU raises: the port never falls back to
the CPU on its own.  Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA GPU is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev
