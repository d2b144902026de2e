"""Anti-entropy gossip: pairing schedules, merge rounds, fault injection,
convergence loops.

One gossip round is a single batched tensor op: every replica r absorbs
replica ``perm[r]`` (or ``(r + offset) mod R`` on a ring).  On CUDA
tensors each round is one launch of a merge kernel (ops/cuda_merge.py,
ops/cuda_delta.py); on CPU tensors it runs the kernels' plain versions.

Schedules:
  * ring (offset 1)        -- neighbour gossip; O(R) rounds.
  * dissemination (offsets 1, 2, 4, ...) -- ceil(log2 R) rounds.
  * butterfly (XOR pairs)  -- symmetric exchanges, R a power of two.
  * random pairing         -- uniform gossip for fault-injection studies.

Fault injection: a dropped exchange is a masked lane; the replica keeps
its old state for the round.  Drop masks and random pairings are drawn
on the host from threefry keys (utils/prng.py), bit for bit the draws of
``jax.random``: round ``rnd`` of a run seeded with S drops
``bernoulli(fold_in(key(S), 2 rnd + 1), rate, (R,))`` and pairs by
``permutation(fold_in(key(S), 2 rnd), R)``, as the JAX package's loop
does, so a seed gives the JAX package's rounds and states.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from go_crdt_playground_tpu_torch.device import resolve_device
from go_crdt_playground_tpu_torch.models.awset import AWSetState
from go_crdt_playground_tpu_torch.models.awset_delta import AWSetDeltaState
from go_crdt_playground_tpu_torch.ops import cuda_delta, cuda_merge
from go_crdt_playground_tpu_torch.parallel import collectives
from go_crdt_playground_tpu_torch.utils import prng

# ---------------------------------------------------------------------------
# Pairing schedules (permutations of the replica axis)
# ---------------------------------------------------------------------------


def ring_perm(num_replicas: int, offset: int = 1,
              device="cuda") -> torch.Tensor:
    """Partner of r is (r + offset) mod R."""
    return cuda_merge.ring_index(num_replicas, offset,
                                 resolve_device(device))


def butterfly_perm(num_replicas: int, stage: int,
                   device="cuda") -> torch.Tensor:
    """Partner of r is r XOR 2^stage (symmetric pairs; R a power of two)."""
    if num_replicas & (num_replicas - 1):
        raise ValueError("butterfly needs a power-of-two replica count")
    if stage < 0 or (1 << stage) >= num_replicas:
        raise ValueError(
            f"butterfly stage {stage} out of range for R={num_replicas} "
            "(need 1 << stage < R)")
    return (torch.arange(num_replicas, dtype=torch.int64,
                         device=resolve_device(device)) ^ (1 << stage))


def random_perm(key: np.ndarray, num_replicas: int,
                device="cuda") -> torch.Tensor:
    """A uniform pairing drawn on the host from a threefry ``key``
    (utils/prng.py), equal to ``jax.random.permutation(key, R)``."""
    return torch.from_numpy(prng.permutation(key, num_replicas)).to(
        resolve_device(device))


def dissemination_offsets(num_replicas: int):
    """Doubling offsets 1, 2, 4, ... -- ceil(log2 R) rounds to full
    convergence on any replica count."""
    offs, o = [], 1
    while o < num_replicas:
        offs.append(o)
        o *= 2
    return offs


# ---------------------------------------------------------------------------
# Gossip rounds
# ---------------------------------------------------------------------------


def _as_mask(mask, device) -> torch.Tensor:
    """A bool[R] tensor on ``device`` from a tensor or a numpy array."""
    if not isinstance(mask, torch.Tensor):
        mask = torch.from_numpy(np.asarray(mask, dtype=bool))
    return mask.to(device=device, dtype=torch.bool)


def _select_rows(mask_r, new, old):
    """Per-replica select between two states (mask True -> new)."""
    mask_r = _as_mask(mask_r, old.vv.device)
    return type(old)(*(
        torch.where(mask_r.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
        for n, o in zip(new, old)))


def _keep_dropped(merged, state, drop_mask):
    """Rows whose exchange was dropped keep their old state."""
    if drop_mask is None:
        return merged
    return _select_rows(~_as_mask(drop_mask, state.vv.device), merged,
                        state)


def gossip_round(state: AWSetState, perm,
                 drop_mask: Optional[torch.Tensor] = None,
                 kernel: str = "auto") -> AWSetState:
    """One full-state anti-entropy round: r <- perm[r] for all r.

    drop_mask: bool[R], True = this replica's exchange is lost this round
    (it keeps its old state).  kernel: "auto" (the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors), "cuda" or "torch"."""
    merged = cuda_merge.gossip_round_rows(state, perm, kernel=kernel)
    return _keep_dropped(merged, state, drop_mask)


def ring_gossip_round(state: AWSetState, offset,
                      drop_mask: Optional[torch.Tensor] = None,
                      kernel: str = "auto") -> AWSetState:
    """One full-state ring round: r <- (r + offset) mod R, partner rows
    read in place.  Equal to ``gossip_round(state, ring_perm(R,
    offset))``."""
    merged = cuda_merge.ring_round_rows(state, offset, kernel=kernel)
    return _keep_dropped(merged, state, drop_mask)


def delta_gossip_round(state: AWSetDeltaState, perm,
                       drop_mask: Optional[torch.Tensor] = None,
                       delta_semantics: str = "v2",
                       strict_reference_semantics: bool = True,
                       kernel: str = "auto") -> AWSetDeltaState:
    """One δ anti-entropy round: r absorbs the δ of perm[r]."""
    merged = cuda_delta.delta_gossip_round(
        state, perm, delta_semantics=delta_semantics,
        strict_reference_semantics=strict_reference_semantics,
        kernel=kernel)
    return _keep_dropped(merged, state, drop_mask)


def delta_ring_gossip_round(state: AWSetDeltaState, offset,
                            drop_mask: Optional[torch.Tensor] = None,
                            delta_semantics: str = "v2",
                            strict_reference_semantics: bool = True,
                            kernel: str = "auto") -> AWSetDeltaState:
    """One δ ring round: r absorbs the δ of (r + offset) mod R.  Equal to
    ``delta_gossip_round(state, ring_perm(R, offset), ...)``."""
    merged = cuda_delta.delta_ring_round(
        state, offset, delta_semantics=delta_semantics,
        strict_reference_semantics=strict_reference_semantics,
        kernel=kernel)
    return _keep_dropped(merged, state, drop_mask)


def all_pairs_converge(state, delta: bool = False,
                       delta_semantics: str = "v2"):
    """The all-pairs exchange realized as ceil(log2 R) doubling-offset
    ring rounds instead of O(R^2) work."""
    for off in dissemination_offsets(state.vv.shape[0]):
        if delta:
            state = delta_ring_gossip_round(
                state, off, delta_semantics=delta_semantics)
        else:
            state = ring_gossip_round(state, off)
    return state


def rounds_to_convergence(
    state,
    seed: Optional[int] = None,
    drop_rate: float = 0.0,
    max_rounds: int = 10_000,
    delta: bool = False,
    delta_semantics: str = "v2",
    schedule: str = "dissemination",
    check_every: int = 8,
) -> Tuple[int, object]:
    """Gossip until every replica agrees on (membership, VV); returns
    (rounds, final state).

    With drop_rate > 0 each replica's exchange is lost independently per
    round, and the random schedule draws its pairings; both need
    ``seed``.  The draws are ``jax.random``'s for ``key(seed)``, made
    on the host, so a seed gives the JAX package's rounds and states on
    every device.

    check_every: rounds between convergence digests.  A digest reads
    the whole fleet and syncs the host, so it is read once per chunk of
    rounds.  The returned count is still exact: when a chunk lands
    converged, the first converged round is found by bisection,
    replaying rounds from the chunk-start state.  Replays reproduce the
    same rounds because each round's randomness derives from its index,
    and a converged fleet stays converged (merge is idempotent).  The
    chunk-start state stays live for the replay: one extra fleet copy on
    the device; check_every=1 gives it back."""
    R = state.vv.shape[0]
    dev = state.vv.device
    offsets = dissemination_offsets(R) or [1]
    if schedule not in ("dissemination", "ring", "random", "butterfly"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule == "random" and seed is None:
        raise ValueError("random schedule requires a seed")
    if schedule == "butterfly" and R & (R - 1):
        raise ValueError(
            f"butterfly schedule needs a power-of-two replica count "
            f"(R={R})")
    if drop_rate > 0.0 and seed is None:
        raise ValueError("drop_rate requires a seed")
    kw = {"delta_semantics": delta_semantics} if delta else {}
    key = None if seed is None else prng.key(seed)
    round_fn = delta_gossip_round if delta else gossip_round
    ring_fn = delta_ring_gossip_round if delta else ring_gossip_round

    def one_round(s, rnd: int):
        drop = None
        if drop_rate > 0.0:
            drop = prng.bernoulli(prng.fold_in(key, 2 * rnd + 1),
                                  drop_rate, R)
        if schedule == "random":
            perm = random_perm(prng.fold_in(key, 2 * rnd), R, dev)
            return round_fn(s, perm, drop, **kw)
        if schedule == "butterfly":
            stage = rnd % (R.bit_length() - 1)
            return round_fn(s, butterfly_perm(R, stage, dev), drop, **kw)
        off = 1 if schedule == "ring" else offsets[rnd % len(offsets)]
        return ring_fn(s, off, drop, **kw)

    def advance(s, start: int, n: int):
        """n rounds from round ``start``, then one digest (one sync)."""
        for rnd in range(start, start + n):
            s = one_round(s, rnd)
        return s, bool(collectives.converged(s.present, s.vv))

    if bool(collectives.converged(state.present, state.vv)):
        return 0, state
    rnd = 0
    while rnd < max_rounds:
        k = min(max(1, check_every), max_rounds - rnd)
        chunk_start = state
        state, chunk_conv = advance(state, rnd, k)
        if chunk_conv:
            # not converged after lo rounds, converged after hi; each probe
            # resumes from the last unconverged prefix, so the bisection
            # replays O(k) rounds in all
            lo, hi = 0, k
            lo_state, hi_state = chunk_start, state
            while lo + 1 < hi:
                mid = (lo + hi) // 2
                s_mid, mid_conv = advance(lo_state, rnd + lo, mid - lo)
                if mid_conv:
                    hi, hi_state = mid, s_mid
                else:
                    lo, lo_state = mid, s_mid
            return rnd + hi, hi_state
        rnd += k
    raise RuntimeError(
        f"no convergence within {max_rounds} rounds "
        f"(schedule={schedule!r}, drop_rate={drop_rate}); refusing to "
        "report an exhausted budget as a measured rounds-to-convergence")
