"""Batched lattice joins for the non-AWSet CRDT families, on tensors.

The counterpart of the JAX package's ``ops/lattices.py``, with its names
and semantics: every family is a NamedTuple of tensors batched over the
replica axis R with an elementwise monotone join, so any ``join(dst,
src) -> merged`` plugs into a permutation round (``gossip_round`` below,
``src = state[perm]``).  The G-Counter join is the reference's
VersionVector.Merge batched; BASELINE config 2 runs it at 1,000 replicas.

Every uint32 field is stored as ``torch.int32`` holding the same bits, as
everywhere in the port.  So the joins never compare or take maxima on
the int32 values: ``_umax`` and ``_ugt`` flip the sign bit first, which
turns the unsigned order of the bits into the signed order of the
flipped values (a counter or stamp of 2^31 or more beats a small one, as
uint32 does), and every add wraps mod 2^32.  Every operation is
functional: it returns new tensors and never writes its input's.

The OR-Map's key membership is the AWSet merge: ``ormap_join`` runs it
through K2 (``cuda_merge.merge_pairwise_rows``) for CUDA tensors and
through its plain version (ops/merge.merge_kernel) for CPU tensors; the
LWW cells are plain torch either way, as XLA computes them in the
reference.  The model-merging joins are float32, one IEEE operation a
lane, as the reference's.

The registry (``JOIN_REGISTRY``) holds each family's join with a seeded
sampler of reachable states, which draws from a numpy ``Generator``
exactly as the reference's samplers draw, so a seed gives the same
states in both packages.  ops/merge.py registers the AWSet join.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from go_crdt_playground_tpu_torch._u32 import (MASK, from_numpy_u32, host,
                                               narrow, widen)
from go_crdt_playground_tpu_torch.device import resolve_device
from go_crdt_playground_tpu_torch.models import awset
from go_crdt_playground_tpu_torch.models.awset import AWSetState

# int32 with only the sign bit set: x ^ _SIGN orders as x's uint32 bits
_SIGN = -(1 << 31)


def _umax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise uint32 maximum of int32 bits."""
    return torch.maximum(a ^ _SIGN, b ^ _SIGN) ^ _SIGN


def _ugt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise uint32 ``a > b`` of int32 bits."""
    return (a ^ _SIGN) > (b ^ _SIGN)


def _u32(x) -> int:
    """A scalar argument's uint32 value (a Python or numpy integer, or a
    0-d tensor of int32 bits)."""
    return int(x) & MASK


def _i32(x) -> int:
    """A scalar argument as an int32 value (two's complement wrap): an
    index, or the int32 bits that store a uint32 value."""
    return ((int(x) + (1 << 31)) & MASK) - (1 << 31)


def _add_at(t: torch.Tensor, r: int, a: int, amount: int) -> torch.Tensor:
    """A copy of ``t`` with ``t[r, a]`` advanced by ``amount`` mod 2^32."""
    out = t.clone()
    out[r, a] = narrow(widen(t[r, a]) + amount)
    return out


def _set_at(t: torch.Tensor, r: int, e: int, value) -> torch.Tensor:
    out = t.clone()
    out[r, e] = value
    return out


def _default_actors(num_replicas: int, num_actors: int, actors):
    if actors is None:
        if num_actors < num_replicas:
            raise ValueError("need num_actors >= num_replicas by default")
        actors = np.arange(num_replicas, dtype=np.uint32)
    return actors


# ---------------------------------------------------------------------------
# G-Counter / PN-Counter
# ---------------------------------------------------------------------------


class GCounterState(NamedTuple):
    counts: torch.Tensor   # int32[R, A] (uint32 bits)
    actor: torch.Tensor    # int32[R]


def gcounter_init(num_replicas: int, num_actors: int, actors=None,
                  device="cuda") -> GCounterState:
    dev = resolve_device(device)
    actors = _default_actors(num_replicas, num_actors, actors)
    return GCounterState(
        counts=torch.zeros((num_replicas, num_actors), dtype=torch.int32,
                           device=dev),
        actor=from_numpy_u32(actors, dev))


def gcounter_inc(state: GCounterState, replica, amount) -> GCounterState:
    """Replica r's own slot grows by ``amount`` (uint32, wrapping mod
    2^32 as the reference's ``.at[].add``)."""
    r = _i32(replica)
    a = int(state.actor[r])
    return state._replace(counts=_add_at(state.counts, r, a, _u32(amount)))


def gcounter_value(state: GCounterState) -> np.ndarray:
    """uint64[R] host array: the sums can exceed uint32."""
    return host(state.counts).astype(np.uint64).sum(axis=-1)


def gcounter_join(dst: GCounterState, src: GCounterState) -> GCounterState:
    """Elementwise unsigned max (VersionVector.Merge batched)."""
    return dst._replace(counts=_umax(dst.counts, src.counts))


class PNCounterState(NamedTuple):
    p: torch.Tensor        # int32[R, A] (uint32 bits)
    n: torch.Tensor        # int32[R, A] (uint32 bits)
    actor: torch.Tensor    # int32[R]


def pncounter_init(num_replicas: int, num_actors: int, actors=None,
                   device="cuda") -> PNCounterState:
    g = gcounter_init(num_replicas, num_actors, actors, device)
    return PNCounterState(p=g.counts, n=torch.zeros_like(g.counts),
                          actor=g.actor)


def pncounter_add(state: PNCounterState, replica, amount) -> PNCounterState:
    """``amount`` an int32: positive increments P, negative increments N
    (its int32 negation, so -2^31 adds nothing, as in the reference)."""
    r = _i32(replica)
    a = int(state.actor[r])
    amount = _i32(amount)
    return state._replace(
        p=_add_at(state.p, r, a, max(amount, 0)),
        n=_add_at(state.n, r, a, max(_i32(-amount), 0)))


def pncounter_value(state: PNCounterState) -> np.ndarray:
    """int64[R] host array."""
    return (host(state.p).astype(np.int64).sum(axis=-1)
            - host(state.n).astype(np.int64).sum(axis=-1))


def pncounter_join(dst: PNCounterState,
                   src: PNCounterState) -> PNCounterState:
    return dst._replace(p=_umax(dst.p, src.p), n=_umax(dst.n, src.n))


# ---------------------------------------------------------------------------
# 2P-Set
# ---------------------------------------------------------------------------


class TwoPSetState(NamedTuple):
    added: torch.Tensor     # bool[R, E]
    removed: torch.Tensor   # bool[R, E]


def twopset_init(num_replicas: int, num_elements: int,
                 device="cuda") -> TwoPSetState:
    dev = resolve_device(device)
    shape = (num_replicas, num_elements)
    return TwoPSetState(added=torch.zeros(shape, dtype=torch.bool,
                                          device=dev),
                        removed=torch.zeros(shape, dtype=torch.bool,
                                            device=dev))


def twopset_add(state: TwoPSetState, replica, element) -> TwoPSetState:
    r, e = _i32(replica), _i32(element)
    return state._replace(added=_set_at(state.added, r, e, True))


def twopset_del(state: TwoPSetState, replica, element) -> TwoPSetState:
    """Remove-wins tombstone; only observed elements can be removed."""
    r, e = _i32(replica), _i32(element)
    return state._replace(removed=_set_at(
        state.removed, r, e, state.removed[r, e] | state.added[r, e]))


def twopset_member(state: TwoPSetState) -> torch.Tensor:
    return state.added & ~state.removed


def twopset_join(dst: TwoPSetState, src: TwoPSetState) -> TwoPSetState:
    """Pairwise OR joins: remove wins forever."""
    return TwoPSetState(added=dst.added | src.added,
                        removed=dst.removed | src.removed)


# ---------------------------------------------------------------------------
# LWW-Map (last-writer-wins cells; LWW-Register is the E == 1 case)
# ---------------------------------------------------------------------------


class LWWMapState(NamedTuple):
    ts: torch.Tensor        # int32[R, E] caller-supplied stamps (uint32
                            #             bits), >= 1; 0: never written
    wr_actor: torch.Tensor  # int32[R, E] tie-break (higher actor wins)
    val: torch.Tensor       # int32[R, E]
    live: torch.Tensor      # bool[R, E]  False: tombstone / never written
    actor: torch.Tensor     # int32[R]


def lwwmap_init(num_replicas: int, num_elements: int, actors=None,
                device="cuda") -> LWWMapState:
    dev = resolve_device(device)
    if actors is None:
        actors = np.arange(num_replicas, dtype=np.uint32)
    shape = (num_replicas, num_elements)
    return LWWMapState(
        ts=torch.zeros(shape, dtype=torch.int32, device=dev),
        wr_actor=torch.zeros(shape, dtype=torch.int32, device=dev),
        val=torch.zeros(shape, dtype=torch.int32, device=dev),
        live=torch.zeros(shape, dtype=torch.bool, device=dev),
        actor=from_numpy_u32(actors, dev))


def _lww_newer(ts_a: torch.Tensor, actor_a: torch.Tensor,
               ts_b: torch.Tensor, actor_b: torch.Tensor) -> torch.Tensor:
    """Lexicographic (ts, actor) comparison a > b, unsigned."""
    return _ugt(ts_a, ts_b) | ((ts_a == ts_b) & _ugt(actor_a, actor_b))


def _cell_take(state, r: int, e: int, ts: int) -> Tuple[bool, int]:
    """Whether a write stamped (ts, actor of r) beats cell (r, e), and
    that actor's bits."""
    a = int(state.actor[r])
    cur = (_u32(state.ts[r, e]), _u32(state.wr_actor[r, e]))
    return (ts, _u32(a)) > cur, a


def lwwmap_put(state: LWWMapState, replica, element, value, ts,
               live) -> LWWMapState:
    """Write (or tombstone with live=False) if (ts, actor) beats the
    cell.  ts must be >= 1: unwritten cells are (0, 0)."""
    r, e = _i32(replica), _i32(element)
    take, a = _cell_take(state, r, e, _u32(ts))
    if not take:
        return state._replace()
    return LWWMapState(
        ts=_set_at(state.ts, r, e, _i32(ts)),
        wr_actor=_set_at(state.wr_actor, r, e, a),
        val=_set_at(state.val, r, e, _i32(value)),
        live=_set_at(state.live, r, e, bool(live)),
        actor=state.actor)


def lwwmap_join(dst: LWWMapState, src: LWWMapState) -> LWWMapState:
    """Per-cell lexicographic (ts, actor) max; deterministic in any merge
    order."""
    take = _lww_newer(src.ts, src.wr_actor, dst.ts, dst.wr_actor)
    return LWWMapState(
        ts=torch.where(take, src.ts, dst.ts),
        wr_actor=torch.where(take, src.wr_actor, dst.wr_actor),
        val=torch.where(take, src.val, dst.val),
        live=torch.where(take, src.live, dst.live),
        actor=dst.actor)


# ---------------------------------------------------------------------------
# MV-Register (multi-value; per-actor slots)
# ---------------------------------------------------------------------------


class MVRegisterState(NamedTuple):
    ctx: torch.Tensor    # int32[R, A] causal context (uint32 bits)
    live: torch.Tensor   # bool[R, A]  slot holds a visible value
    cnt: torch.Tensor    # int32[R, A] write counter per slot
    val: torch.Tensor    # int32[R, A]
    actor: torch.Tensor  # int32[R]


def mvregister_init(num_replicas: int, num_actors: int, actors=None,
                    device="cuda") -> MVRegisterState:
    dev = resolve_device(device)
    actors = _default_actors(num_replicas, num_actors, actors)
    shape = (num_replicas, num_actors)
    return MVRegisterState(
        ctx=torch.zeros(shape, dtype=torch.int32, device=dev),
        live=torch.zeros(shape, dtype=torch.bool, device=dev),
        cnt=torch.zeros(shape, dtype=torch.int32, device=dev),
        val=torch.zeros(shape, dtype=torch.int32, device=dev),
        actor=from_numpy_u32(actors, dev))


def mvregister_write(state: MVRegisterState, replica,
                     value) -> MVRegisterState:
    """A write observes (and so replaces) every currently visible
    value; the own slot's context ticks (wrapping mod 2^32)."""
    r = _i32(replica)
    a = int(state.actor[r])
    new_c = narrow(widen(state.ctx[r, a]) + 1)
    onehot = (torch.arange(state.ctx.shape[-1], device=state.ctx.device)
              == widen(state.actor[r]))
    live, cnt, val = (state.live.clone(), state.cnt.clone(),
                      state.val.clone())
    live[r] = onehot
    cnt[r] = torch.where(onehot, new_c, 0)
    val[r] = torch.where(onehot, _i32(value), 0)
    return MVRegisterState(ctx=_set_at(state.ctx, r, a, new_c), live=live,
                           cnt=cnt, val=val, actor=state.actor)


def mvregister_join(dst: MVRegisterState,
                    src: MVRegisterState) -> MVRegisterState:
    """Per-actor-slot arbitration (spec_extra.MVRegister.merge): both
    live -> newer counter; src-only live -> adopt iff beyond our
    context; dst-only live -> drop iff src's context covers it."""
    both = dst.live & src.live
    take_src = (both & _ugt(src.cnt, dst.cnt)) | (
        src.live & ~dst.live & _ugt(src.cnt, dst.ctx))
    drop_dst = dst.live & ~src.live & ~_ugt(dst.cnt, src.ctx)
    live = (dst.live & ~drop_dst) | take_src
    cnt = torch.where(take_src, src.cnt, dst.cnt)
    val = torch.where(take_src, src.val, dst.val)
    return MVRegisterState(
        ctx=_umax(dst.ctx, src.ctx), live=live,
        cnt=torch.where(live, cnt, 0), val=torch.where(live, val, 0),
        actor=dst.actor)


# ---------------------------------------------------------------------------
# OR-Map (AWSet key membership + LWW value cells)
# ---------------------------------------------------------------------------


class ORMapState(NamedTuple):
    """Keys follow the AWSet tensors exactly (models/awset.py); cells
    are an LWWMapState without its own actor row or live mask."""

    vv: torch.Tensor           # int32[R, A]
    present: torch.Tensor      # bool[R, E]
    dot_actor: torch.Tensor    # int32[R, E]
    dot_counter: torch.Tensor  # int32[R, E]
    actor: torch.Tensor        # int32[R]
    ts: torch.Tensor           # int32[R, E]
    wr_actor: torch.Tensor     # int32[R, E]
    val: torch.Tensor          # int32[R, E]


def ormap_keys(state: ORMapState) -> AWSetState:
    """The key membership as the AWSet state it is (the same tensors)."""
    return AWSetState(vv=state.vv, present=state.present,
                      dot_actor=state.dot_actor,
                      dot_counter=state.dot_counter, actor=state.actor)


def ormap_init(num_replicas: int, num_elements: int, num_actors: int,
               actors=None, device="cuda") -> ORMapState:
    base = awset.init(num_replicas, num_elements, num_actors, actors,
                      device=device)
    zeros = torch.zeros_like(base.dot_counter)
    return ORMapState(*base, ts=zeros, wr_actor=zeros.clone(),
                      val=zeros.clone())


def ormap_put(state: ORMapState, replica, element, value,
              ts) -> ORMapState:
    """Add the key (an AWSet add on replica r) and write its cell if (ts,
    actor) beats it."""
    r, e = _i32(replica), _i32(element)
    base = awset.add_element(ormap_keys(state), r, e)
    take, a = _cell_take(state, r, e, _u32(ts))
    out = ORMapState(*base, ts=state.ts, wr_actor=state.wr_actor,
                     val=state.val)
    if not take:
        return out
    return out._replace(ts=_set_at(state.ts, r, e, _i32(ts)),
                        wr_actor=_set_at(state.wr_actor, r, e, a),
                        val=_set_at(state.val, r, e, _i32(value)))


def ormap_delete(state: ORMapState, replica, element) -> ORMapState:
    base = awset.del_element(ormap_keys(state), _i32(replica),
                             _i32(element))
    return ORMapState(*base, ts=state.ts, wr_actor=state.wr_actor,
                      val=state.val)


def ormap_join(dst: ORMapState, src: ORMapState,
               kernel: str = "auto") -> ORMapState:
    """The AWSet merge for the keys (K2 for CUDA tensors, its plain
    version for CPU tensors or ``kernel="torch"``) and the LWW join for
    the cells.  Rows or batches of rows alike."""
    from go_crdt_playground_tpu_torch.ops import cuda_merge

    one_row = dst.vv.dim() == 1
    d, s = ormap_keys(dst), ormap_keys(src)
    if one_row:
        d, s = (AWSetState(*(x.unsqueeze(0) for x in st)) for st in (d, s))
    keys = cuda_merge.merge_pairwise_rows(d, s, kernel=kernel)
    if one_row:
        keys = AWSetState(*(x.squeeze(0) for x in keys))
    take = _lww_newer(src.ts, src.wr_actor, dst.ts, dst.wr_actor)
    return ORMapState(
        vv=keys.vv, present=keys.present, dot_actor=keys.dot_actor,
        dot_counter=keys.dot_counter, actor=dst.actor,
        ts=torch.where(take, src.ts, dst.ts),
        wr_actor=torch.where(take, src.wr_actor, dst.wr_actor),
        val=torch.where(take, src.val, dst.val))


# ---------------------------------------------------------------------------
# Model-merging joins over float weight lanes
# ---------------------------------------------------------------------------
#
# A parameter tensor as CRDT state, a merge strategy as the join; each
# registers with the laws it really has (JoinSpec.laws): elementwise max
# is a lattice join (all three laws, exact); the pairwise mean is
# commutative only (a merge STEP, not anti-entropy); the weighted average
# in running-sum form is commutative and associative up to IEEE rounding
# (checked at atol) and not idempotent (a state joined with itself counts
# every contribution twice).


class TensorMergeState(NamedTuple):
    w: torch.Tensor  # float32[R, D] weight lanes


def tensormerge_init(num_replicas: int, dim: int,
                     device="cuda") -> TensorMergeState:
    return TensorMergeState(w=torch.zeros(
        (num_replicas, dim), dtype=torch.float32,
        device=resolve_device(device)))


def tensor_max_join(dst: TensorMergeState,
                    src: TensorMergeState) -> TensorMergeState:
    """Elementwise max over weight lanes: a lattice join."""
    return dst._replace(w=torch.maximum(dst.w, src.w))


def tensor_mean_join(dst: TensorMergeState,
                     src: TensorMergeState) -> TensorMergeState:
    """Pairwise elementwise mean: a merge step, commutative only."""
    return dst._replace(w=(dst.w + src.w) * 0.5)


class WeightedMergeState(NamedTuple):
    """Weighted-average merging in running-sum form: ``acc`` carries the
    sum of weight x lanes, ``weight`` the sum of weights per replica."""

    acc: torch.Tensor     # float32[R, D]
    weight: torch.Tensor  # float32[R, 1]


def weightedmerge_init(num_replicas: int, dim: int,
                       device="cuda") -> WeightedMergeState:
    dev = resolve_device(device)
    return WeightedMergeState(
        acc=torch.zeros((num_replicas, dim), dtype=torch.float32,
                        device=dev),
        weight=torch.zeros((num_replicas, 1), dtype=torch.float32,
                           device=dev))


def weighted_mean_join(dst: WeightedMergeState,
                       src: WeightedMergeState) -> WeightedMergeState:
    return WeightedMergeState(acc=dst.acc + src.acc,
                              weight=dst.weight + src.weight)


def weighted_mean_value(state: WeightedMergeState) -> np.ndarray:
    """The merged model, acc / weight per lane, on the host in float64
    (zero-weight replicas read as zero, not NaN)."""
    acc = host(state.acc).astype(np.float64)
    w = host(state.weight).astype(np.float64)
    return np.where(w > 0, acc / np.maximum(w, 1e-30), 0.0)


# ---------------------------------------------------------------------------
# Generic batched rounds (any of the joins above)
# ---------------------------------------------------------------------------


def _rows(state, index: torch.Tensor):
    return type(state)(*(x[index] for x in state))


def _as_rows(perm, device) -> torch.Tensor:
    if not isinstance(perm, torch.Tensor):
        perm = torch.from_numpy(np.asarray(perm, dtype=np.int64))
    return perm.to(device=device, dtype=torch.int64)


def join_pairwise(join_fn, dst, src):
    """Batched ``dst[r] <- join(dst[r], src[r])``: the joins are
    elementwise, so one call on the batches is the per-row join."""
    return join_fn(dst, src)


def gossip_round(join_fn, state, perm):
    """One round of any join: row r joins row ``perm[r]``."""
    return join_pairwise(join_fn, state,
                         _rows(state, _as_rows(perm, state[0].device)))


# ---------------------------------------------------------------------------
# Join registry
# ---------------------------------------------------------------------------


ALL_LAWS = ("commutativity", "associativity", "idempotence")


class JoinSpec(NamedTuple):
    """One registered join, packaged for property checking (the
    reference's ``JoinSpec``): ``sample(rng, n_rows, n_ops, device=)``
    returns a batch of reachable rows (seeded random ops of the family
    and gossip mixing through the join itself); ``project`` maps a
    state to the dict of observable numpy arrays the laws are checked
    on (uint32, bool or float32, the reference's dtypes); ``laws`` is
    the family's declared law subset and ``atol`` the float tolerance of
    the comparison (0: exact)."""

    name: str
    sample: Callable[..., Any]
    join: Callable[[Any, Any], Any]
    project: Callable[[Any], Dict[str, np.ndarray]]
    laws: Tuple[str, ...] = ALL_LAWS
    atol: float = 0.0


JOIN_REGISTRY: Dict[str, JoinSpec] = {}


def register_join(spec: JoinSpec) -> JoinSpec:
    """Idempotent by name (re-import safe)."""
    JOIN_REGISTRY[spec.name] = spec
    return spec


def mix_rows(join_fn, state, rng: np.random.Generator, p: float = 0.5):
    """One gossip-style mixing step of the samplers: each row joins a
    permuted partner row with probability ``p`` (the draws of the
    reference's ``mix_rows``: a permutation, then R uniforms)."""
    n = int(state[0].shape[0])
    dev = state[0].device
    src = _rows(state, _as_rows(rng.permutation(n), dev))
    merged = join_fn(state, src)
    mask = torch.from_numpy(rng.random(n) < p).to(dev)
    return type(state)(*(
        torch.where(mask.reshape((n,) + (1,) * (m.dim() - 1)), m, o)
        for m, o in zip(merged, state)))


_SAMPLE_ELEMS = 8  # element universe of the set/map family samplers


def _sample_gcounter(rng: np.random.Generator, n: int, n_ops: int,
                     device="cuda"):
    state = gcounter_init(n, n, device=device)
    for _ in range(n_ops):
        if rng.random() < 0.6:
            state = gcounter_inc(state, rng.integers(n),
                                 rng.integers(1, 5))
        else:
            state = mix_rows(gcounter_join, state, rng)
    return state


def _sample_pncounter(rng: np.random.Generator, n: int, n_ops: int,
                      device="cuda"):
    state = pncounter_init(n, n, device=device)
    for _ in range(n_ops):
        if rng.random() < 0.6:
            state = pncounter_add(state, rng.integers(n),
                                  rng.integers(-4, 5))
        else:
            state = mix_rows(pncounter_join, state, rng)
    return state


def _sample_twopset(rng: np.random.Generator, n: int, n_ops: int,
                    device="cuda"):
    state = twopset_init(n, _SAMPLE_ELEMS, device=device)
    for _ in range(n_ops):
        roll = rng.random()
        r = rng.integers(n)
        e = rng.integers(_SAMPLE_ELEMS)
        if roll < 0.4:
            state = twopset_add(state, r, e)
        elif roll < 0.6:
            state = twopset_del(state, r, e)
        else:
            state = mix_rows(twopset_join, state, rng)
    return state


def _sample_lwwmap(rng: np.random.Generator, n: int, n_ops: int,
                   device="cuda"):
    state = lwwmap_init(n, _SAMPLE_ELEMS, device=device)
    ts = 0
    for _ in range(n_ops):
        if rng.random() < 0.6:
            ts += 1  # globally unique stamps: the caller's contract
            state = lwwmap_put(
                state, rng.integers(n), rng.integers(_SAMPLE_ELEMS),
                rng.integers(1000), ts, bool(rng.random() < 0.8))
        else:
            state = mix_rows(lwwmap_join, state, rng)
    return state


def _sample_mvregister(rng: np.random.Generator, n: int, n_ops: int,
                       device="cuda"):
    state = mvregister_init(n, n, device=device)
    val = 0
    for _ in range(n_ops):
        if rng.random() < 0.6:
            val += 1
            state = mvregister_write(state, rng.integers(n), val)
        else:
            state = mix_rows(mvregister_join, state, rng)
    return state


def _sample_ormap(rng: np.random.Generator, n: int, n_ops: int,
                  device="cuda"):
    state = ormap_init(n, _SAMPLE_ELEMS, n, device=device)
    # one put per element: re-adding a live element exercises the AWSet
    # merge's documented stale-dot overwrite, out of model for the laws
    unput = list(range(_SAMPLE_ELEMS))
    ts = 0
    for _ in range(n_ops):
        roll = rng.random()
        if roll < 0.35 and unput:
            e = unput.pop(int(rng.integers(len(unput))))
            ts += 1
            state = ormap_put(state, e % n, e, rng.integers(1000), ts)
        elif roll < 0.55:
            state = ormap_delete(state, rng.integers(n),
                                 rng.integers(_SAMPLE_ELEMS))
        else:
            state = mix_rows(ormap_join, state, rng)
    return state


_SAMPLE_DIM = 16  # weight-lane universe of the model-merging samplers


def _sample_tensor_merge(join_fn):
    """The float-lane families' sampler: seeded local steps (row
    perturbations) interleaved with gossip mixing through the join."""

    def sample(rng: np.random.Generator, n: int, n_ops: int,
               device="cuda"):
        dev = resolve_device(device)
        state = TensorMergeState(w=torch.from_numpy(
            rng.normal(0.0, 1.0, (n, _SAMPLE_DIM)).astype(np.float32)
        ).to(dev))
        for _ in range(n_ops):
            if rng.random() < 0.6:
                r = int(rng.integers(n))
                step = torch.from_numpy(rng.normal(
                    0.0, 0.5, _SAMPLE_DIM).astype(np.float32)).to(dev)
                w = state.w.clone()
                w[r] = w[r] + step
                state = TensorMergeState(w=w)
            else:
                state = mix_rows(join_fn, state, rng)
        return state

    return sample


def _sample_weighted_merge(rng: np.random.Generator, n: int, n_ops: int,
                           device="cuda"):
    # one weighted contribution per replica, then more contributions
    # (acc += w x, weight += w) and mixing
    dev = resolve_device(device)
    w0 = rng.uniform(0.1, 2.0, (n, 1)).astype(np.float32)
    x0 = rng.normal(0.0, 1.0, (n, _SAMPLE_DIM)).astype(np.float32)
    state = WeightedMergeState(acc=torch.from_numpy(w0 * x0).to(dev),
                               weight=torch.from_numpy(w0).to(dev))
    for _ in range(n_ops):
        if rng.random() < 0.6:
            r = int(rng.integers(n))
            w = float(rng.uniform(0.1, 2.0))
            x = rng.normal(0.0, 1.0, _SAMPLE_DIM).astype(np.float32)
            acc, weight = state.acc.clone(), state.weight.clone()
            acc[r] = acc[r] + torch.from_numpy(
                (w * x).astype(np.float32)).to(dev)
            weight[r, 0] = weight[r, 0] + np.float32(w)
            state = WeightedMergeState(acc=acc, weight=weight)
        else:
            state = mix_rows(weighted_mean_join, state, rng)
    return state


def _np_fields(state, names) -> Dict[str, np.ndarray]:
    """Fields as numpy: uint32 for the int32 bits, bool and float32 as
    they are."""
    return {f: host(getattr(state, f)) for f in names}


register_join(JoinSpec(
    "gcounter", _sample_gcounter, gcounter_join,
    lambda s: _np_fields(s, ("counts",))))
register_join(JoinSpec(
    "pncounter", _sample_pncounter, pncounter_join,
    lambda s: _np_fields(s, ("p", "n"))))
register_join(JoinSpec(
    "twopset", _sample_twopset, twopset_join,
    lambda s: _np_fields(s, ("added", "removed"))))
register_join(JoinSpec(
    "lwwmap", _sample_lwwmap, lwwmap_join,
    lambda s: _np_fields(s, ("ts", "wr_actor", "val", "live"))))
register_join(JoinSpec(
    "mvregister", _sample_mvregister, mvregister_join,
    lambda s: _np_fields(s, ("ctx", "live", "cnt", "val"))))
register_join(JoinSpec(
    "ormap", _sample_ormap, ormap_join,
    # membership and cells; dot metadata excluded (the AWSet overwrite
    # quirk)
    lambda s: _np_fields(s, ("vv", "present", "ts", "wr_actor", "val"))))
register_join(JoinSpec(
    "tensor_max", _sample_tensor_merge(tensor_max_join),
    tensor_max_join, lambda s: _np_fields(s, ("w",))))
register_join(JoinSpec(
    "tensor_mean", _sample_tensor_merge(tensor_mean_join),
    tensor_mean_join, lambda s: _np_fields(s, ("w",)),
    laws=("commutativity",)))
register_join(JoinSpec(
    "weighted_mean", _sample_weighted_merge, weighted_mean_join,
    lambda s: _np_fields(s, ("acc", "weight")),
    laws=("commutativity", "associativity"), atol=1e-3))
