"""uint32 arithmetic on int32 storage.

Every uint32 field of the JAX states is stored here as ``torch.int32``
holding the same bits (torch's ``uint32`` lacks ``<``, ``maximum``, ``+``
and shifts).  The plain code widens to int64 with ``& 0xFFFFFFFF`` for
every unsigned compare and every wrapping add or multiply, and narrows
back to int32 bits on the way out.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF


def widen(x: torch.Tensor) -> torch.Tensor:
    """int32 bits (or any integer tensor) -> int64 unsigned value."""
    return x.to(torch.int64) & MASK


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 holding the low 32 bits (two's complement)."""
    x = x & MASK
    return (x - ((x >> 31) << 32)).to(torch.int32)


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 operands in [0, 2^32), exact: b is
    split into 16-bit halves so no partial product exceeds 2^48."""
    lo = b & 0xFFFF
    hi = b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK


def from_numpy_u32(a, device) -> torch.Tensor:
    """numpy uint32 array -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> numpy uint32 array (a copy) with the same bits."""
    return t.detach().cpu().numpy().view(np.uint32).copy()
