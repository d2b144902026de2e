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

Sharded rounds (the JAX package's ``shard_map`` rounds): the state is
cut over a mesh (parallel/mesh.py), each slot runs the single-device
kernel on its block (K2, K5, K6-K9 on CUDA), and whole blocks or rows
move between slots through parallel/shardmap.py.  Each keeps the JAX
function's guards, also where the port's kernels would take the input.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from go_crdt_playground_tpu_torch.device import resolve_device
from go_crdt_playground_tpu_torch.models.awset import AWSetState
from go_crdt_playground_tpu_torch.models.awset_delta import AWSetDeltaState
from go_crdt_playground_tpu_torch._u32 import MASK, narrow, widen
from go_crdt_playground_tpu_torch.models import packed as packed_mod
from go_crdt_playground_tpu_torch.ops import compact as compact_ops
from go_crdt_playground_tpu_torch.ops import cuda_delta, cuda_merge
from go_crdt_playground_tpu_torch.ops import delta as delta_ops
from go_crdt_playground_tpu_torch.ops.vv import clock_at
from go_crdt_playground_tpu_torch.parallel import collectives
from go_crdt_playground_tpu_torch.parallel import mesh as mesh_mod
from go_crdt_playground_tpu_torch.parallel import shardmap
from go_crdt_playground_tpu_torch.parallel.mesh import (ELEMENT_AXIS,
                                                        REPLICA_AXIS, Mesh,
                                                        ShardedState)
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


def _ormap_cells(state, keys: AWSetState, index: torch.Tensor):
    """An OR-Map round's result: the merged keys, and the LWW cells
    joined against the partner rows ``index`` (a row gather, one
    partner copy of each plane)."""
    from go_crdt_playground_tpu_torch.ops.lattices import (ORMapState,
                                                           _lww_newer)

    src_ts, src_wa = state.ts[index], state.wr_actor[index]
    take = _lww_newer(src_ts, src_wa, state.ts, state.wr_actor)
    return ORMapState(
        *keys, ts=torch.where(take, src_ts, state.ts),
        wr_actor=torch.where(take, src_wa, state.wr_actor),
        val=torch.where(take, state.val[index], state.val))


def ormap_gossip_round(state, perm, kernel: str = "auto"):
    """One OR-Map anti-entropy round: the key membership is the AWSet
    round (K2 on CUDA tensors, as ``gossip_round``), the cells join with
    the elementwise LWW rule.  Bitwise
    ``lattices.gossip_round(lattices.ormap_join, state, perm)``."""
    from go_crdt_playground_tpu_torch.ops.lattices import ormap_keys

    index = cuda_merge.as_index(perm, state.vv.shape[0], state.vv.device)
    keys = gossip_round(ormap_keys(state), index, kernel=kernel)
    return _ormap_cells(state, keys, index)


def ormap_ring_gossip_round(state, offset, kernel: str = "auto"):
    """OR-Map ring round: the key membership on the ring round (K1 on
    CUDA tensors, partner rows read in place), the cells against the
    partner rows by a row gather.  Bitwise ``ormap_gossip_round(state,
    ring_perm(R, offset))``."""
    from go_crdt_playground_tpu_torch.ops.lattices import ormap_keys

    keys = ring_gossip_round(ormap_keys(state), offset, kernel=kernel)
    index = cuda_merge.ring_index(state.vv.shape[0], offset,
                                  state.vv.device)
    return _ormap_cells(state, keys, index)


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


# ---------------------------------------------------------------------------
# Unsharded δ rounds the sharded ones are checked against
# ---------------------------------------------------------------------------


def _rows(state, index):
    return type(state)(*(x[index] for x in state))


def _apply_v2(state: AWSetDeltaState, payload) -> AWSetDeltaState:
    return delta_ops.delta_apply(state, payload, delta_semantics="v2")


def _extract_round(state: AWSetDeltaState, perm):
    """Batched sender-side δ extraction for one round's pairing: replica
    r will absorb perm[r], so extract perm[r]'s payload against r's
    vv."""
    perm = cuda_merge.as_index(perm, state.num_replicas, state.vv.device)
    return delta_ops.delta_extract(_rows(state, perm), state.vv)


def pipelined_delta_gossip(state: AWSetDeltaState,
                           perms) -> AWSetDeltaState:
    """δ gossip with the extract -> apply pipeline staged across rounds
    by a double-buffered payload: round i applies the payload extracted
    during round i - 1, and round i + 1's payload is extracted from the
    PRE-apply state, so the two stages have no data dependence.  The
    price is one round of staleness (a stale receiver vv only enlarges
    a payload; δ-apply is idempotent), so the schedule stays
    convergent.  v2 semantics; perms: [n_rounds, R] (a Python loop
    where the JAX package scans)."""
    n = len(perms)
    payload = _extract_round(state, perms[0])
    for i in range(n - 1):
        state, payload = (_apply_v2(state, payload),
                          _extract_round(state, perms[i + 1]))
    return _apply_v2(state, payload)


def compact_delta_gossip_round(state: AWSetDeltaState, perm,
                               k_changed: int = 64,
                               k_deleted: int = 64) -> AWSetDeltaState:
    """One δ round through the fixed-K compact payload form
    (ops/compact.py): extract -> compact to K index/value lanes ->
    expand -> apply (v2).  A pair whose payload exceeds K degrades to a
    safe partial exchange (no clock advance)."""
    num_e = state.present.shape[-1]
    comp = compact_ops.compact_payload_batch(
        _extract_round(state, perm), k_changed, k_deleted)
    return _apply_v2(state, compact_ops.expand_payload_batch(comp, num_e))


# ---------------------------------------------------------------------------
# Sharded rounds (the JAX package's shard_map rounds)
# ---------------------------------------------------------------------------


def _as_sharded(state, mesh: Mesh, shard_actors: bool = False
                ) -> ShardedState:
    """A sharded state on ``mesh`` in the wanted layout; a plain state (or
    one in another layout) is placed first, as jit reshards its input."""
    if (isinstance(state, ShardedState) and state.mesh == mesh
            and state.shard_actors == shard_actors):
        return state
    return mesh_mod.shard_state(state, mesh, shard_actors)


def _stack(a, b):
    return type(a)(*(torch.cat([x, y], dim=0) for x, y in zip(a, b)))


def _head(state, n: int):
    """The first n rows, as fresh tensors (a view would keep the whole
    stacked output alive)."""
    return type(state)(*(x[:n].clone() for x in state))


def ring_round_shardmap(state, mesh: Mesh, kernel: str = "auto"
                        ) -> ShardedState:
    """One ring round with the exchange pinned: each replica slot
    ppermutes its whole block to the next slot, then every row merges
    with the row of the same index in the received block (K2 per slot,
    ``merge_pairwise_rows``).  Equal to ``gossip_round`` at the
    permutation r -> (r - blk) mod R.  Full-state AWSet only: the merge
    has no reduction over E, so an element-sharded block is
    self-contained."""
    sh = _as_sharded(state, mesh)
    n = mesh.shape[REPLICA_AXIS]
    recv = shardmap.ppermute(mesh, sh.blocks, REPLICA_AXIS,
                             [(i, (i + 1) % n) for i in range(n)])
    return sh.with_blocks(shardmap.map_slots(
        mesh, lambda idx, local, got: cuda_merge.merge_pairwise_rows(
            local, got, kernel=kernel), sh.blocks, recv))


def ep_ring_round_shardmap(state, mesh: Mesh) -> ShardedState:
    """One ring round under the EP layout (``shard_actors=True``): vv
    slots are owned per actor shard, all-gathered over the element axis
    for the round's HasDot reads, and the joined vv is sliced back to
    this slot's actors.  Equal to ``ring_round_shardmap``; the merge is
    the plain version, as the JAX package's is XLA."""
    mesh_mod.validate_ep_layout(state, mesh)
    sh = _as_sharded(state, mesh, shard_actors=True)
    n_r, n_e = mesh.shape[REPLICA_AXIS], mesh.shape[ELEMENT_AXIS]
    vv_full = shardmap.all_gather(
        mesh, shardmap.map_slots(mesh, lambda idx, b: b.vv, sh.blocks),
        ELEMENT_AXIS, dim=1)
    full = shardmap.map_slots(mesh, lambda idx, b, v: b._replace(vv=v),
                              sh.blocks, vv_full)
    recv = shardmap.ppermute(mesh, full, REPLICA_AXIS,
                             [(i, (i + 1) % n_r) for i in range(n_r)])
    eidx = shardmap.axis_index(mesh, ELEMENT_AXIS)

    def body(idx, local, got, e):
        merged = cuda_merge.merge_rows_plain(local, got)
        a = merged.vv.shape[1] // n_e
        return merged._replace(
            vv=merged.vv[:, e * a:(e + 1) * a].contiguous())

    return sh.with_blocks(shardmap.map_slots(mesh, body, full, recv, eidx))


def butterfly_round_shardmap(state, mesh: Mesh, stage: int,
                             kernel: str = "auto") -> ShardedState:
    """One butterfly stage (partner r XOR 2^stage) with the replica axis
    sharded; equal to ``gossip_round(state, butterfly_perm(R, stage))``.
    With global row r = d blk + i: a stage below the block size is
    block-local (K2 ``gossip_round_rows`` on the slot's rows, no
    exchange); a stage at or above it swaps whole blocks between slots
    d and d XOR (2^stage / blk) (K2 ``merge_pairwise_rows``)."""
    num_r = state.vv.shape[0] if not isinstance(state, ShardedState) \
        else _global_rows(state)
    n = mesh.shape[REPLICA_AXIS]
    if num_r & (num_r - 1):
        raise ValueError(f"butterfly needs a power-of-two replica count "
                         f"(R={num_r})")
    if num_r % n:
        raise ValueError(f"R={num_r} not divisible by replica mesh dim {n}")
    blk = num_r // n
    if blk & (blk - 1):
        raise ValueError(
            f"per-device block {blk} must be a power of two for the XOR "
            "pairing to decompose into block-local and block-swap stages")
    if not 0 <= stage or (1 << stage) >= num_r:
        raise ValueError(
            f"butterfly stage {stage} out of range for R={num_r} "
            "(need 1 << stage < R)")
    sh = _as_sharded(state, mesh)
    s = 1 << stage
    if s < blk:
        def local_round(idx, local):
            perm = torch.arange(blk, dtype=torch.int64,
                                device=local.vv.device) ^ s
            return cuda_merge.gossip_round_rows(local, perm, kernel=kernel)

        return sh.with_blocks(shardmap.map_slots(mesh, local_round,
                                                 sh.blocks))
    recv = shardmap.ppermute(mesh, sh.blocks, REPLICA_AXIS,
                             [(d, d ^ (s // blk)) for d in range(n)])
    return sh.with_blocks(shardmap.map_slots(
        mesh, lambda idx, local, got: cuda_merge.merge_pairwise_rows(
            local, got, kernel=kernel), sh.blocks, recv))


def compact_ring_round_shardmap(state, mesh: Mesh, k_changed: int = 64,
                                k_deleted: int = 64) -> ShardedState:
    """One compact-payload ring round: slot i's replica block syncs into
    slot i + 1's, and only the fixed-K payload lanes (forward) and the
    receiver's vv advertisement (backward) cross between slots.  Equal
    to ``compact_delta_gossip_round`` at the block-shift permutation;
    needs the element axis unsharded (compaction scans E locally).
    Plain torch per slot, as the JAX round is XLA."""
    if mesh.shape[ELEMENT_AXIS] != 1:
        raise ValueError(
            "compact ring needs the element axis unsharded "
            f"(mesh element dim {mesh.shape[ELEMENT_AXIS]}): lane "
            "compaction is a scan over the full element axis")
    sh = _as_sharded(state, mesh)
    n = mesh.shape[REPLICA_AXIS]
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    # 1. the receiver advertises its vv to its ring sender
    recv_vv = shardmap.ppermute(
        mesh, shardmap.map_slots(mesh, lambda idx, b: b.vv, sh.blocks),
        REPLICA_AXIS, bwd)
    # 2. sender-side extract + compact against the advertised vv
    comp = shardmap.map_slots(
        mesh, lambda idx, b, v: compact_ops.compact_payload_batch(
            delta_ops.delta_extract(b, v), k_changed, k_deleted),
        sh.blocks, recv_vv)
    # 3. only the compact payload crosses the ring
    shipped = shardmap.ppermute(mesh, comp, REPLICA_AXIS, fwd)
    # 4. receiver-side expand + apply
    return sh.with_blocks(shardmap.map_slots(
        mesh, lambda idx, b, c: _apply_v2(
            b, compact_ops.expand_payload_batch(c, b.present.shape[-1])),
        sh.blocks, shipped))


_PACKED_ROUNDS = {
    packed_mod.PackedAWSetDeltaState: cuda_delta.delta_ring_round_packed,
    packed_mod.DotPackedAWSetDeltaState:
        cuda_delta.delta_ring_round_dotpacked,
    packed_mod.PackedAWSetState: cuda_merge.ring_round_rows_packed,
    packed_mod.DotPackedAWSetState: cuda_merge.ring_round_rows_dotpacked,
}


def _global_rows(sh: ShardedState) -> int:
    return mesh_mod.global_shape(sh, "vv")[0]


def packed_block_ring_plan(num_r: int, mesh: Mesh, offset):
    """``(blk, shift, kernel_offset)`` of a packed block-ring round, with
    the JAX function's guards: the element axis unsharded, R divisible
    by the replica dim, a block whose 2 blk stack the ring kernel tiles
    (a multiple of 64 rows, at least 128), offset 0 refused, and an
    offset either intra-block or block-aligned."""
    if mesh.shape[ELEMENT_AXIS] != 1:
        raise ValueError(
            "packed block ring needs the element axis unsharded (mesh "
            f"element dim {mesh.shape[ELEMENT_AXIS]}): packed words are "
            "not element-shardable")
    n = mesh.shape[REPLICA_AXIS]
    if num_r % n:
        raise ValueError(f"R={num_r} not divisible by replica mesh dim {n}")
    blk = num_r // n
    if (2 * blk) % 64 or 2 * blk < 128:
        raise ValueError(
            f"per-device block {blk} (R={num_r} / {n} devices) stacks to a "
            f"{2 * blk}-row kernel block, which the packed ring kernel "
            "cannot tile (needs a multiple of 64 rows, at least 128)")
    offset = int(offset) % num_r
    if offset == 0:
        raise ValueError("offset 0 is a no-op round")
    if offset % blk == 0:
        return blk, offset // blk, blk
    if offset < blk:
        return blk, 0, blk + offset
    raise ValueError(
        f"offset {offset} is neither intra-block (< {blk}) nor "
        f"block-aligned (multiple of {blk})")


def packed_block_ring_round_shardmap(state, mesh: Mesh, offset,
                                     kernel: str = "auto") -> ShardedState:
    """One packed-layout ring round with the replica axis sharded, for
    any of the four packed layouts (models/packed.py): K8 / K9 for the
    δ states, K6 / K7 for the full-state ones, per slot.

    With ``blk = R / n`` rows a slot: an offset that is a multiple of
    blk is the global ring (slot d's rows absorb slot (d + offset/blk)'s
    rows pairwise; equal to the single-device ring round); an offset
    below blk wraps within each block (row i absorbs (i + offset) mod
    blk).  Both run the ring kernel on the stacked [local; recv] (or
    [local; local]) 2 blk block at ``kernel_offset`` and keep the first
    half."""
    num_r = (_global_rows(state) if isinstance(state, ShardedState)
             else state.vv.shape[0])
    blk, shift, kernel_offset = packed_block_ring_plan(num_r, mesh, offset)
    sh = _as_sharded(state, mesh)
    round_fn = _PACKED_ROUNDS[sh.state_cls]
    n = mesh.shape[REPLICA_AXIS]
    if shift:
        recv = shardmap.ppermute(mesh, sh.blocks, REPLICA_AXIS,
                                 [((i + shift) % n, i) for i in range(n)])
    else:
        recv = sh.blocks
    return sh.with_blocks(shardmap.map_slots(
        mesh, lambda idx, local, got: _head(round_fn(
            _stack(local, got), kernel_offset, kernel=kernel), blk),
        sh.blocks, recv))


def _gather_rows(mesh: Mesh, sh: ShardedState, perm: np.ndarray):
    """Each slot's partner rows ``state[perm[r]]`` for its own rows r,
    moved from the replica slots that hold them (same element slot);
    a grid of blocks."""
    blk = next(b for _, b in sh.local_blocks()).vv.shape[0]
    n_r = mesh.shape[REPLICA_AXIS]
    rax = mesh.axis(REPLICA_AXIS)
    want = {}
    moves = []
    for idx in mesh.slots():
        rows = perm[idx[rax] * blk:(idx[rax] + 1) * blk]
        for s in range(n_r):
            pos = np.nonzero(rows // blk == s)[0]
            if pos.size:
                src = idx[:rax] + (s,) + idx[rax + 1:]
                want[(src, idx)] = (pos, rows[pos] - s * blk)
                moves.append((src, idx))

    def payload(src, dst):
        local = torch.from_numpy(want[(src, dst)][1]).to(
            mesh.device(src))
        return [x.index_select(0, local) for x in sh.blocks[src]]

    def spec(src, dst):
        k = want[(src, dst)][0].size
        return [((k,) + tuple(x.shape[1:]), x.dtype)
                for x in sh.blocks[dst]]

    got = shardmap.exchange(mesh, moves, payload, spec)
    out = mesh_mod.empty_grid(mesh)
    for idx, local in sh.local_blocks():
        fields = [torch.empty_like(x) for x in local]
        for (src, dst), leaves in got.items():
            if dst != idx:
                continue
            pos = torch.from_numpy(want[(src, dst)][0]).to(local.vv.device)
            for f, leaf in zip(fields, leaves):
                f.index_copy_(0, pos, leaf)
        out[idx] = type(local)(*fields)
    return out


def delta_gossip_round_shardmap(state, mesh: Mesh, perm,
                                delta_semantics: str = "v2",
                                strict_reference_semantics: bool = True,
                                kernel: str = "auto") -> ShardedState:
    """One δ round for any pairing on a (replica x element) mesh: row r
    absorbs the δ of row perm[r].  The partner rows move from the replica
    slots that hold them; each slot then runs K5 on its stacked [local;
    partners] block and keeps the first half.  Equal to
    ``delta_gossip_round``.

    The strict reference semantics skip the vv join of an empty δ, a
    reduction over E: on an element-sharded mesh each slot runs the
    loose mode and the join is undone where no element slot's δ was
    non-empty (an OR over the element axis), never a per-slot skip."""
    sh = _as_sharded(state, mesh)
    num_r = _global_rows(sh)
    perm = cuda_merge.as_index(perm, num_r, "cpu").numpy()
    mode = cuda_delta.kernel_mode(delta_semantics,
                                  strict_reference_semantics)
    split = mesh.shape[ELEMENT_AXIS] > 1 and mode == "reference"
    partners = _gather_rows(mesh, sh, perm)

    sem, strict = cuda_delta._SEMANTICS["reference_loose" if split
                                        else mode]

    def body(idx, local, src):
        # row r < blk of the stack absorbs row blk + r (its partner);
        # the partner rows absorb themselves and are dropped
        blk = local.vv.shape[0]
        index = torch.arange(blk, 2 * blk, dtype=torch.int64,
                             device=local.vv.device).repeat(2)
        return _head(cuda_delta.delta_gossip_round(
            _stack(local, src), index, delta_semantics=sem,
            strict_reference_semantics=strict, kernel=kernel), blk)

    merged = shardmap.map_slots(mesh, body, sh.blocks, partners)
    if not split:
        return sh.with_blocks(merged)
    # the strict skip over the whole E: any element slot non-empty
    nonempty = shardmap.map_slots(
        mesh, lambda idx, local, src: _nonempty(local, src).to(torch.int64),
        sh.blocks, partners)
    nonempty = shardmap.pmax(mesh, nonempty, ELEMENT_AXIS)

    def fix(idx, local, src, out, ne):
        first = clock_at(local.vv, src.actor[:, None]) == 0
        keep_join = first | (ne[:, None] > 0)
        return out._replace(vv=torch.where(keep_join, out.vv, local.vv))

    return sh.with_blocks(shardmap.map_slots(mesh, fix, sh.blocks,
                                             partners, merged, nonempty))


def _nonempty(local: AWSetDeltaState, src: AWSetDeltaState) -> torch.Tensor:
    """bool[rows]: the δ of each partner row against the local row's vv
    claims a lane of this slot."""
    p = delta_ops.delta_extract(src, local.vv)
    return p.changed.any(dim=-1) | p.deleted.any(dim=-1)


def gc_shardmap(state, mesh: Mesh) -> ShardedState:
    """Deletion-log GC on a sharded δ state: the frontier is the unsigned
    min of ``processed`` over every replica (a pmin over the replica
    axis), then each slot drops its stable records (ops/delta.py)."""
    sh = _as_sharded(state, mesh)
    local_min = shardmap.map_slots(
        mesh, lambda idx, b: widen(b.processed).min(dim=0).values,
        sh.blocks)
    frontier = shardmap.pmin(mesh, local_min, REPLICA_AXIS)
    return sh.with_blocks(shardmap.map_slots(
        mesh, lambda idx, b, f: delta_ops.gc_apply(b, narrow(f)),
        sh.blocks, frontier))


def state_digest_shardmap(state, mesh: Mesh) -> np.ndarray:
    """``collectives.state_digest`` of a sharded state, per slot: the
    membership hash of each element slot mixes its GLOBAL lane ids (a
    lane base) and the partial sums add mod 2^32 over the element axis;
    an EP vv hashes its global actor ids the same way.  A grid of
    int64 [rows] digests."""
    sh = _as_sharded(state, mesh)
    n_e = mesh.shape[ELEMENT_AXIS]
    eax = mesh.axis(ELEMENT_AXIS)

    def part(idx, b):
        e_loc = b.present.shape[-1]
        mh = widen(collectives.membership_hash(
            b.present, lane_base=idx[eax] * e_loc))
        return mh

    mh = shardmap.psum(mesh, shardmap.map_slots(mesh, part, sh.blocks),
                       ELEMENT_AXIS)

    def vv_part(idx, b):
        a_loc = b.vv.shape[-1]
        base = idx[eax] * a_loc if sh.shard_actors else 0
        return collectives._vv_hash(b.vv, lane_base=base)

    vvh = shardmap.map_slots(mesh, vv_part, sh.blocks)
    if sh.shard_actors and n_e > 1:
        vvh = shardmap.psum(mesh, vvh, ELEMENT_AXIS)
    return shardmap.map_slots(mesh, lambda idx, m, v: (m ^ v) & MASK,
                              mh, vvh)


def converged_shardmap(state, mesh: Mesh) -> bool:
    """``collectives.converged`` of a sharded state: every replica's
    digest equal, the min and max over all slots compared."""
    digests = state_digest_shardmap(state, mesh)
    lo = shardmap.map_slots(mesh, lambda idx, d: d.min(), digests)
    hi = shardmap.map_slots(mesh, lambda idx, d: d.max(), digests)
    for axis in mesh.axis_names:
        lo = shardmap.pmin(mesh, lo, axis)
        hi = shardmap.pmax(mesh, hi, axis)
    idx = mesh.local_slots()[0]
    return bool(lo[idx] == hi[idx])


def lane_diff(candidate, base, lane_fields) -> torch.Tensor:
    """bool lanes where any lane field of ``candidate`` differs from
    ``base``."""
    d = None
    for f in lane_fields:
        neq = getattr(candidate, f) != getattr(base, f)
        d = neq if d is None else (d | neq)
    return d


def disjoint_update_join(mesh: Mesh, local, base, axis_name: str,
                         num_shards: int):
    """Converge per-slot copies of a REPLICATED state whose slots applied
    KEY-DISJOINT updates (the 2-D serve mesh's dp axis,
    parallel/meshtarget2d.py): ceil(log2 n) ring rounds over
    ``axis_name`` at the dissemination offsets, each a ppermute, leave
    every slot holding the exact join.  Every lane was written by at
    most one slot (the batcher's key-disjoint stripes), so "the
    partner's lane differs from the shared pre-update ``base``" names
    the unique writer and a select rebuilds the sequential result
    bitwise, dots included; the clocks join by unsigned max.
    ``local`` and ``base`` are grids of single-replica slices."""
    from go_crdt_playground_tpu_torch.models.layout import (
        ACTOR_AXIS_FIELDS, REPLICA_ONLY_FIELDS)

    if num_shards == 1:
        return local
    some = next(local[idx] for idx in mesh.local_slots())
    clock_fields = set(ACTOR_AXIS_FIELDS) | set(REPLICA_ONLY_FIELDS)
    lane_fields = [f for f in type(some)._fields if f not in clock_fields]

    def join(idx, mine, partner, b):
        take = lane_diff(partner, b, lane_fields)
        updates = {f: torch.where(take, getattr(partner, f),
                                  getattr(mine, f)) for f in lane_fields}
        for f in ACTOR_AXIS_FIELDS:
            if f in type(mine)._fields:
                updates[f] = narrow(torch.maximum(
                    widen(getattr(mine, f)), widen(getattr(partner, f))))
        return mine._replace(**updates)

    for off in dissemination_offsets(num_shards):
        pairs = [((d + off) % num_shards, d) for d in range(num_shards)]
        partner = shardmap.ppermute(mesh, local, axis_name, pairs)
        local = shardmap.map_slots(mesh, join, local, partner, base)
    return local
