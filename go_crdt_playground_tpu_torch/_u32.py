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
    a = np.array(a, dtype=np.uint32, order="C")  # a copy; keeps 0-d
    return torch.from_numpy(a.view(np.int32)).to(device)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> numpy uint32 array (a copy) with the same bits."""
    return t.detach().cpu().numpy().view(np.uint32).copy()


def host(x) -> np.ndarray:
    """A tensor (int32 bits or bool) or an array -> numpy: uint32 for an
    integer tensor, bool for a bool one, ``np.asarray`` otherwise."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bool:
            return x.detach().cpu().numpy().copy()
        return to_numpy_u32(x)
    return np.asarray(x)


def to_host(tup):
    """A NamedTuple of tensors (int32 bits or bool, any shapes, on one
    device) -> the same NamedTuple of numpy arrays (uint32 or bool),
    through ONE device->host copy of all its tensors together; fields
    that are not tensors pass through."""
    tensors = [x for x in tup if isinstance(x, torch.Tensor)]
    if not tensors:
        return tup
    flat = torch.cat([x.reshape(-1).to(torch.int32) for x in tensors])
    flat = flat.cpu().numpy()
    out, pos = [], 0
    for x in tup:
        if not isinstance(x, torch.Tensor):
            out.append(x)
            continue
        a = flat[pos:pos + x.numel()].reshape(tuple(x.shape))
        pos += x.numel()
        out.append(a.astype(bool) if x.dtype == torch.bool
                   else a.view(np.uint32).copy())
    return type(tup)(*out)
