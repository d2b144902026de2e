"""Version-vector primitives, tensorized.

``vv`` is int32[..., A] holding uint32 counters; zero padding is exact
because counter 0 means "never seen".
"""

from __future__ import annotations

import torch

from go_crdt_playground_tpu_torch._u32 import narrow, widen


def clock_at(vv: torch.Tensor, actor: torch.Tensor) -> torch.Tensor:
    """``vv[..., actor]`` as int64 unsigned values.  vv: int32[A] or
    int32[R, A]; actor: int32 ids shaped [...] or [R, ...].  Ids are
    clipped to [0, A) the way ``jnp.take(mode="clip")`` clips the
    int32 view of a uint32 id (ids >= 2^31 read slot 0); callers keep
    ids < A by construction."""
    num_a = vv.shape[-1]
    idx = actor.to(torch.int64).clamp(0, num_a - 1)
    vvw = widen(vv)
    if vv.dim() == 1:
        return vvw[idx]
    return torch.gather(vvw, -1, idx)


def has_dot(vv: torch.Tensor, dot_actor: torch.Tensor,
            dot_counter: torch.Tensor) -> torch.Tensor:
    """Vectorized ``VersionVector.HasDot``: vv[dot_actor] >= dot_counter
    as bool[...], compared unsigned."""
    return clock_at(vv, dot_actor) >= widen(dot_counter)


def vv_join(vv_dst: torch.Tensor, vv_src: torch.Tensor) -> torch.Tensor:
    """Elementwise unsigned max (``VersionVector.Merge``)."""
    return narrow(torch.maximum(widen(vv_dst), widen(vv_src)))


def set_clock(vv: torch.Tensor, actor: torch.Tensor,
              value: torch.Tensor) -> torch.Tensor:
    """``vv.at[actor].set(value)`` on one vv[A]: ``value`` (any integer,
    reduced mod 2^32) in the actor's slot; an id outside [0, A) sets
    nothing, as the JAX scatter drops it."""
    own = torch.arange(vv.shape[-1], device=vv.device) == widen(actor)
    return torch.where(own, narrow(value), vv)
