"""The replica fleets the entry points and the chip smoke run, built on
the device in bulk, bit for bit the JAX package's fleets:

  build_state  <- bench.build_state: R replicas, the first W writers
                  (unique actors) each added a row-dependent slice of the
                  element universe in element order, the rest observers;
  delta_fleet  <- bench._delta_fleet: build_state as a δ fleet with an
                  empty deletion log and processed == vv;
  demo_state   <- __graft_entry__._demo_state: every replica a writer of
                  its own slice (A == R);
  delta_scenario  δ states and partner perms (numpy, for both packages)
                  that reach every branch of a δ round split over blocks:
                  the strict empty-δ skip with its one payload lane in
                  the first or the last chunk of a row, first contact,
                  the bridge's [dst; src] pair.
"""

from __future__ import annotations

import numpy as np
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


# delta_scenario's names
DELTA_SCENARIOS = ("mixed", "empty", "payload_first", "payload_last",
                   "first_contact", "pair")


def delta_scenario(name: str, num_r: int, num_e: int, num_a: int,
                   seed: int = 0):
    """A δ state's arrays (numpy: bool membership, uint32 words) and the
    partner perm (int64[R], repeats and self-partners allowed) of one of
    DELTA_SCENARIOS:

      mixed          adds, deletions, re-adds, unseen dots, zero clocks;
      pair           mixed, every row absorbing row 1 (the bridge's
                     [dst; src] batch with perm [1, 1]; row 0 at R = 1);
      empty          quiet rows: every dot covered by every clock, no
                     deletion record, clocks >= 1 (no first contact) and
                     apart (a join would move them), so each δ is empty;
      payload_first  empty, with one deletion record on lane min(5, E-1)
                     of every row: the only payload lies in chunk 0;
      payload_last   the same on lane E - 1: in a row's last chunk;
      first_contact  empty, with each even row's clock for its partner's
                     actor zeroed.
    """
    if name not in DELTA_SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}")
    R, E, A = num_r, num_e, num_a
    rng = np.random.default_rng(seed)
    actor = np.arange(R) % A
    perm = (np.full(R, min(1, R - 1)) if name == "pair"
            else rng.integers(0, R, R))
    da = rng.integers(0, A, (R, E))
    if name in ("mixed", "pair"):
        present = rng.random((R, E)) < 0.5
        deleted = rng.random((R, E)) < 0.3
        dc = rng.integers(1, 10, (R, E))
        xa = rng.integers(0, A, (R, E))
        xc = rng.integers(1, 10, (R, E))
        vv = rng.integers(0, 10, (R, A))
    else:
        present = rng.random((R, E)) < 0.5
        deleted = np.zeros((R, E), bool)
        dc = np.ones((R, E), np.int64)
        xa = np.zeros((R, E), np.int64)
        xc = np.zeros((R, E), np.int64)
        vv = 1 + rng.integers(0, 3, (R, A))
        vv[np.arange(R), actor] += 1 + np.arange(R)
        if name in ("payload_first", "payload_last") and E:
            lane = min(5, E - 1) if name == "payload_first" else E - 1
            present[:, lane] = False
            deleted[:, lane] = True
            xa[:, lane] = rng.integers(0, A, R)
            xc[:, lane] = 1
        if name == "first_contact":
            even = np.arange(0, R, 2)
            vv[even, actor[perm[even]]] = 0
    arrays = {
        "vv": vv, "present": present,
        "dot_actor": np.where(present, da, 0),
        "dot_counter": np.where(present, dc, 0),
        "actor": actor,
        "deleted": deleted,
        "del_dot_actor": np.where(deleted, xa, 0),
        "del_dot_counter": np.where(deleted, xc, 0),
        "processed": rng.integers(0, 10, (R, A)),
    }
    return ({k: v if v.dtype == bool else v.astype(np.uint32)
             for k, v in arrays.items()}, perm.astype(np.int64))
