"""The flagship forward step: one batched full-state AWSet ring round
plus the convergence digest, on the 256 x 256 demo fleet (the
counterpart of ``__graft_entry__.entry()``)."""

from __future__ import annotations

import numpy as np

from go_crdt_playground_tpu_torch import fleet
from go_crdt_playground_tpu_torch.parallel import collectives, gossip


def forward(state, offset):
    """(merged_state, converged_scalar) after one ring round at
    ``offset``; runs the ring kernel on CUDA tensors."""
    merged = gossip.ring_gossip_round(state, offset)
    return merged, collectives.converged(merged.present, merged.vv)


def entry(device="cuda"):
    """Returns (fn, example_args): fn(state, offset) -> (merged_state,
    converged_scalar), with the 256 x 256 demo fleet on ``device``."""
    state = fleet.demo_state(num_replicas=256, num_elements=256,
                             device=device)
    return forward, (state, np.uint32(1))
