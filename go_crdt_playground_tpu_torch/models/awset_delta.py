"""Packed-tensor δ-AWSet replica state.

The AWSet tensors (models/awset.py) plus the δ-state machinery, in the
field order of the JAX package's ``AWSetDeltaState``:

  deleted:         bool[R, E]   deletion log membership
  del_dot_actor:   int32[R, E]  deletion dots (uint32 bits)
  del_dot_counter: int32[R, E]
  processed:       int32[R, A]  v2 causal-stability vector: per origin
                                actor, the highest deletion counter whose
                                effects this replica's state reflects
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from go_crdt_playground_tpu_torch._u32 import (
    from_numpy_u32, narrow, widen)
from go_crdt_playground_tpu_torch.device import resolve_device
from go_crdt_playground_tpu_torch.models import awset as awset_mod
from go_crdt_playground_tpu_torch.models.awset import AWSetState


class AWSetDeltaState(NamedTuple):
    vv: torch.Tensor               # int32[R, A]
    present: torch.Tensor          # bool[R, E]
    dot_actor: torch.Tensor        # int32[R, E]
    dot_counter: torch.Tensor      # int32[R, E]
    actor: torch.Tensor            # int32[R]
    deleted: torch.Tensor          # bool[R, E]
    del_dot_actor: torch.Tensor    # int32[R, E]
    del_dot_counter: torch.Tensor  # int32[R, E]
    processed: torch.Tensor        # int32[R, A]

    @property
    def num_replicas(self) -> int:
        return self.vv.shape[0]

    @property
    def num_actors(self) -> int:
        return self.vv.shape[-1]

    @property
    def num_elements(self) -> int:
        return self.present.shape[-1]

    def base(self) -> AWSetState:
        return AWSetState(vv=self.vv, present=self.present,
                          dot_actor=self.dot_actor,
                          dot_counter=self.dot_counter, actor=self.actor)


def _extend(base: AWSetState, deleted, del_da, del_dc,
            processed) -> AWSetDeltaState:
    return AWSetDeltaState(*base, deleted=deleted, del_dot_actor=del_da,
                           del_dot_counter=del_dc, processed=processed)


def init(num_replicas: int, num_elements: int, num_actors: int,
         actors=None, device="cuda") -> AWSetDeltaState:
    base = awset_mod.init(num_replicas, num_elements, num_actors, actors,
                          device=device)
    return _extend(
        base,
        deleted=torch.zeros_like(base.present),
        del_da=torch.zeros_like(base.dot_actor),
        del_dc=torch.zeros_like(base.dot_counter),
        processed=torch.zeros_like(base.vv),
    )


def from_arrays(arrays: Dict[str, np.ndarray],
                device="cuda") -> AWSetDeltaState:
    """The numpy dict of the JAX ``awset_delta.to_arrays`` -> a state on
    ``device``, bit for bit."""
    dev = resolve_device(device)
    base = awset_mod.from_arrays(arrays, device=dev)
    return _extend(
        base,
        deleted=torch.from_numpy(
            np.asarray(arrays["deleted"], dtype=bool).copy()).to(dev),
        del_da=from_numpy_u32(arrays["del_dot_actor"], dev),
        del_dc=from_numpy_u32(arrays["del_dot_counter"], dev),
        processed=from_numpy_u32(arrays["processed"], dev),
    )


to_arrays = awset_mod.to_arrays


# ---------------------------------------------------------------------------
# Local mutations (host-driven scenario ops)
# ---------------------------------------------------------------------------


def add_element(state: AWSetDeltaState, replica,
                element) -> AWSetDeltaState:
    """δ-state ``Add``: the plain AWSet add plus the v2 invariant
    processed[self] == vv[self]."""
    r = int(replica)
    a = int(widen(state.actor[r]))
    base = awset_mod.add_element(state.base(), replica, element)
    processed = state.processed.clone()
    processed[r, a] = base.vv[r, a]
    return state._replace(vv=base.vv, present=base.present,
                          dot_actor=base.dot_actor,
                          dot_counter=base.dot_counter, processed=processed)


def add_elements(state: AWSetDeltaState, replica, elements,
                 count=None) -> AWSetDeltaState:
    """Batched ``Add(k...)`` with the per-key loop semantics: the clock
    ticks once per key occurrence (position i gets counter vv[r,a]+1+i)
    and a key appearing twice keeps its LAST occurrence's dot.

    elements: K element ids.  count: only the first ``count`` positions
    are real, the rest padding."""
    r = int(replica)
    a = int(widen(state.actor[r]))
    dev = state.vv.device
    elements = torch.as_tensor(np.asarray(elements, dtype=np.int64),
                               device=dev)
    k = elements.shape[0]
    pos = torch.arange(1, k + 1, dtype=torch.int64, device=dev)
    if count is None:
        count = k
    else:
        count = int(count) & 0xFFFFFFFF
        pos = torch.where(pos <= count, pos, 0)
    # last-occurrence position (1-based) per touched element lane
    pos1 = torch.zeros(state.num_elements, dtype=torch.int64, device=dev)
    pos1 = pos1.scatter_reduce(0, elements, pos, reduce="amax")
    touched = pos1 > 0
    base = widen(state.vv[r, a])
    new_vv = narrow(base + count)
    vv, processed = state.vv.clone(), state.processed.clone()
    vv[r, a] = new_vv
    processed[r, a] = new_vv
    present, da, dc = (state.present.clone(), state.dot_actor.clone(),
                       state.dot_counter.clone())
    present[r] |= touched
    da[r] = torch.where(touched, state.actor[r], da[r])
    dc[r] = torch.where(touched, narrow(base + pos1), dc[r])
    return state._replace(vv=vv, present=present, dot_actor=da,
                          dot_counter=dc, processed=processed)


def del_elements(state: AWSetDeltaState, replica,
                 selector) -> AWSetDeltaState:
    """δ-state ``Del``: ticks the clock ONCE PER CALL, even when nothing
    selected is present, and stamps every present selected key with that
    one shared deletion dot.

    selector: bool[E], the key set of one Del(k...) call."""
    r = int(replica)
    a = int(widen(state.actor[r]))
    selector = torch.as_tensor(np.asarray(selector, dtype=bool),
                               device=state.vv.device)
    vv, new = awset_mod._tick(state, r, a)
    processed = state.processed.clone()
    processed[r, a] = new
    hit = selector & state.present[r]
    present, da, dc = (state.present.clone(), state.dot_actor.clone(),
                       state.dot_counter.clone())
    deleted, dda, ddc = (state.deleted.clone(), state.del_dot_actor.clone(),
                         state.del_dot_counter.clone())
    present[r] &= ~hit
    da[r] = torch.where(hit, 0, da[r])
    dc[r] = torch.where(hit, 0, dc[r])
    deleted[r] |= hit
    dda[r] = torch.where(hit, state.actor[r], dda[r])
    ddc[r] = torch.where(hit, new, ddc[r])
    return state._replace(vv=vv, present=present, dot_actor=da,
                          dot_counter=dc, deleted=deleted,
                          del_dot_actor=dda, del_dot_counter=ddc,
                          processed=processed)
