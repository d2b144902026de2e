"""Host copies of tensors, without importing torch.

The host-only tiers (the router, its standby, the autopilot) encode
frames through ``net/framing.py`` and ``utils/wire.py`` but never hold a
tensor, so they must not load torch.  A tensor exists only once some
module has imported torch, so these helpers look torch up in
``sys.modules`` instead of importing it: with torch absent every input
is an array or a scalar.
"""

from __future__ import annotations

import sys

import numpy as np


def _tensor_type():
    torch = sys.modules.get("torch")
    return None if torch is None else torch.Tensor


def host(x) -> np.ndarray:
    """A tensor or an array -> numpy: uint32 for an int32 tensor (the
    port's uint32 bits), the tensor's own dtype for any other (bool, the
    uint8 trace codes), ``np.asarray`` for a non-tensor."""
    tensor = _tensor_type()
    if tensor is not None and isinstance(x, tensor):
        a = x.detach().cpu().numpy()
        return a.view(np.uint32).copy() if a.dtype == np.int32 else a.copy()
    return np.asarray(x)


def to_host(tup):
    """A NamedTuple of tensors (int32 bits or bool, any shapes, on one
    device) -> the same NamedTuple of numpy arrays (uint32 or bool),
    through ONE device->host copy of all its tensors together; fields
    that are not tensors pass through."""
    tensor = _tensor_type()
    if tensor is None:
        return tup
    tensors = [x for x in tup if isinstance(x, tensor)]
    if not tensors:
        return tup
    import torch

    flat = torch.cat([x.reshape(-1).to(torch.int32) for x in tensors])
    flat = flat.cpu().numpy()
    out, pos = [], 0
    for x in tup:
        if not isinstance(x, tensor):
            out.append(x)
            continue
        a = flat[pos:pos + x.numel()].reshape(tuple(x.shape))
        pos += x.numel()
        out.append(a.astype(bool) if x.dtype == torch.bool
                   else a.view(np.uint32).copy())
    return type(tup)(*out)
