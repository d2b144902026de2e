"""The replica fleets the entry points and the chip smoke run, built on
the device in bulk, bit for bit the JAX package's fleets:

  build_state  <- bench.build_state: R replicas, the first W writers
                  (unique actors) each added a row-dependent slice of the
                  element universe in element order, the rest observers;
  delta_fleet  <- bench._delta_fleet: build_state as a δ fleet with an
                  empty deletion log and processed == vv;
  demo_state   <- __graft_entry__._demo_state: every replica a writer of
                  its own slice (A == R).
"""

from __future__ import annotations

import torch

from go_crdt_playground_tpu_torch._u32 import MASK, narrow
from go_crdt_playground_tpu_torch.device import resolve_device
from go_crdt_playground_tpu_torch.models.awset import AWSetState
from go_crdt_playground_tpu_torch.models.awset_delta import AWSetDeltaState


def _counters(present: torch.Tensor) -> torch.Tensor:
    """Per-row running count of present lanes, zero on absent lanes
    (int64): the counter each add got in element order."""
    return torch.cumsum(present.to(torch.int64), dim=1) * present


def build_state(num_replicas: int, num_elements: int, num_writers: int,
                device="cuda") -> AWSetState:
    dev = resolve_device(device)
    R, E, W = num_replicas, num_elements, num_writers
    r = torch.arange(R, dtype=torch.int64, device=dev)[:, None]
    e = torch.arange(E, dtype=torch.int64, device=dev)[None, :]
    actors = torch.arange(R, dtype=torch.int64, device=dev) % W
    # uint32 wrapping product, exact in int64 before the mask
    mixed = (e * 2654435761 + r * 40503) & MASK
    present = (r < W) & (mixed % 5 < 2)
    counter = _counters(present)
    vv = torch.zeros((R, W), dtype=torch.int64, device=dev)
    vv = vv.scatter_reduce(1, actors[:, None], counter.max(dim=1,
                                                           keepdim=True)
                           .values, reduce="amax")
    return AWSetState(
        vv=narrow(vv), present=present,
        dot_actor=narrow(torch.where(present, r % W, 0)),
        dot_counter=narrow(counter), actor=narrow(actors))


def delta_fleet(num_replicas: int, num_elements: int, num_writers: int,
                device="cuda") -> AWSetDeltaState:
    base = build_state(num_replicas, num_elements, num_writers, device)
    return AWSetDeltaState(
        *base, deleted=torch.zeros_like(base.present),
        del_dot_actor=torch.zeros_like(base.dot_actor),
        del_dot_counter=torch.zeros_like(base.dot_counter),
        processed=base.vv.clone())


def demo_state(num_replicas: int, num_elements: int, delta: bool = False,
               device="cuda"):
    dev = resolve_device(device)
    R, E = num_replicas, num_elements
    r = torch.arange(R, dtype=torch.int64, device=dev)[:, None]
    e = torch.arange(E, dtype=torch.int64, device=dev)[None, :]
    present = (e % (r % 7 + 2)) == 0
    counter = _counters(present)
    vv = torch.diag(counter.max(dim=1).values)
    state = AWSetState(
        vv=narrow(vv), present=present,
        dot_actor=narrow(torch.where(present, r, 0)),
        dot_counter=narrow(counter),
        actor=torch.arange(R, dtype=torch.int32, device=dev))
    if not delta:
        return state
    return AWSetDeltaState(
        *state, deleted=torch.zeros_like(present),
        del_dot_actor=torch.zeros_like(state.dot_actor),
        del_dot_counter=torch.zeros_like(state.dot_counter),
        processed=state.vv.clone())
