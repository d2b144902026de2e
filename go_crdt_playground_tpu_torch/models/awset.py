"""Packed-tensor AWSet replica state and host-driven local ops.

One replica per row of four dense tensors (the layout of the JAX
package's ``models/awset.py``):

  vv:          int32[R, A]  version vectors (uint32 bits)
  present:     bool[R, E]   set membership
  dot_actor:   int32[R, E]  birth-dot actor (uint32 bits)
  dot_counter: int32[R, E]  birth-dot counter (uint32 bits)
  actor:       int32[R]     each replica's own actor id (uint32 bits)

Canonical form: dot tensors are zero where ``present`` is false, so
states are bitwise-comparable.  The local ops return new states and
leave their input untouched, as the JAX ones do.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from go_crdt_playground_tpu_torch._u32 import (
    from_numpy_u32, narrow, to_numpy_u32, widen)
from go_crdt_playground_tpu_torch.device import resolve_device


class AWSetState(NamedTuple):
    """A batch of R replica states."""

    vv: torch.Tensor           # int32[R, A]
    present: torch.Tensor      # bool[R, E]
    dot_actor: torch.Tensor    # int32[R, E]
    dot_counter: torch.Tensor  # int32[R, E]
    actor: torch.Tensor        # int32[R]

    @property
    def num_replicas(self) -> int:
        return self.vv.shape[0]

    @property
    def num_actors(self) -> int:
        return self.vv.shape[-1]

    @property
    def num_elements(self) -> int:
        return self.present.shape[-1]


def init(num_replicas: int, num_elements: int, num_actors: int,
         actors=None, device="cuda") -> AWSetState:
    """Fresh empty replicas; replica r is actor r unless ``actors`` is
    given.  An actor id must never be ticked by two replicas, so the
    default needs A >= R; pass ``actors`` for observer topologies whose
    extra replicas only merge."""
    dev = resolve_device(device)
    if actors is None:
        if num_actors < num_replicas:
            raise ValueError(
                f"default actor assignment needs num_actors ({num_actors}) "
                f">= num_replicas ({num_replicas}); pass explicit actors= "
                "for an observer topology (replicas that never add)")
        actors = np.arange(num_replicas, dtype=np.uint32)
    shape_e = (num_replicas, num_elements)
    return AWSetState(
        vv=torch.zeros((num_replicas, num_actors), dtype=torch.int32,
                       device=dev),
        present=torch.zeros(shape_e, dtype=torch.bool, device=dev),
        dot_actor=torch.zeros(shape_e, dtype=torch.int32, device=dev),
        dot_counter=torch.zeros(shape_e, dtype=torch.int32, device=dev),
        actor=from_numpy_u32(actors, dev),
    )


def from_arrays(arrays: Dict[str, np.ndarray], device="cuda") -> AWSetState:
    """The numpy dict of the JAX ``awset.to_arrays`` -> a state on
    ``device``, bit for bit."""
    dev = resolve_device(device)
    return AWSetState(
        vv=from_numpy_u32(arrays["vv"], dev),
        present=torch.from_numpy(
            np.asarray(arrays["present"], dtype=bool).copy()).to(dev),
        dot_actor=from_numpy_u32(arrays["dot_actor"], dev),
        dot_counter=from_numpy_u32(arrays["dot_counter"], dev),
        actor=from_numpy_u32(arrays["actor"], dev),
    )


def to_arrays(state) -> Dict[str, np.ndarray]:
    """A state -> the numpy dict the JAX ``from_arrays`` takes (uint32
    and bool arrays), for either state class."""
    return {name: (getattr(state, name).cpu().numpy().copy()
                   if getattr(state, name).dtype == torch.bool
                   else to_numpy_u32(getattr(state, name)))
            for name in state._fields}


# ---------------------------------------------------------------------------
# Local mutations (host-driven scenario ops; the bulk path is ops/merge.py)
# ---------------------------------------------------------------------------


def _tick(state, r: int, a: int):
    """A copy of vv with replica r's slot for actor a advanced by one
    (wrapping uint32); returns (vv, the new counter as int32 bits)."""
    vv = state.vv.clone()
    new = narrow(widen(vv[r, a]) + 1)
    vv[r, a] = new
    return vv, new


def add_element(state: AWSetState, replica, element) -> AWSetState:
    """``AWSet.Add`` for one key on one replica: tick own clock, stamp
    the birth dot (a re-add updates the dot)."""
    r, e = int(replica), int(element)
    a = int(widen(state.actor[r]))
    vv, new = _tick(state, r, a)
    present, da, dc = (state.present.clone(), state.dot_actor.clone(),
                       state.dot_counter.clone())
    present[r, e] = True
    da[r, e] = state.actor[r]
    dc[r, e] = new
    return state._replace(vv=vv, present=present, dot_actor=da,
                          dot_counter=dc)


def del_element(state: AWSetState, replica, element) -> AWSetState:
    """``AWSet.Del``: pure removal with no clock tick.  Dots are zeroed
    to keep the canonical form."""
    r, e = int(replica), int(element)
    present, da, dc = (state.present.clone(), state.dot_actor.clone(),
                       state.dot_counter.clone())
    present[r, e] = False
    da[r, e] = 0
    dc[r, e] = 0
    return state._replace(present=present, dot_actor=da, dot_counter=dc)


def has_element(state: AWSetState, replica: int, element: int) -> bool:
    """``AWSet.Has``."""
    return bool(state.present[replica, element])


def reset(state: AWSetState) -> AWSetState:
    """``AWSet.Reset``, with the VV keeping its actor axis."""
    return state._replace(
        vv=torch.zeros_like(state.vv),
        present=torch.zeros_like(state.present),
        dot_actor=torch.zeros_like(state.dot_actor),
        dot_counter=torch.zeros_like(state.dot_counter),
    )


def clone(state):
    """``AWSet.Clone``: an independent copy of every tensor."""
    return type(state)(*(t.clone() for t in state))
