"""The port's collectives and gossip schedules against the JAX package:
digests, schedules, whole convergence runs and their round counts, drop
masks, and R not a multiple of 64.  Bitwise."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from go_crdt_playground_tpu.parallel import collectives as jax_coll
from go_crdt_playground_tpu.parallel import gossip as jax_gossip
from go_crdt_playground_tpu_torch._u32 import from_numpy_u32, to_numpy_u32
from go_crdt_playground_tpu_torch.parallel import collectives, gossip
from go_crdt_playground_tpu_torch.utils import prng
from tests.test_torch_models import assert_same, scenario, to_torch


def _u32(rng, shape, big):
    hi = 1 << 32 if big else 16
    return rng.integers(0, hi, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("big", [False, True])
def test_collectives_digests_match(big):
    import jax.numpy as jnp

    rng = np.random.default_rng(3 + big)
    present = rng.random((9, 70)) < 0.5
    vv = _u32(rng, (9, 11), big)
    x = _u32(rng, (50,), True)
    tp = torch.from_numpy(present)
    tv = from_numpy_u32(vv, "cpu")
    pairs = [
        (jax_coll._mix32(jnp.asarray(x)),
         collectives._mix32(from_numpy_u32(x, "cpu"))),
        (jax_coll.membership_hash(jnp.asarray(present)),
         collectives.membership_hash(tp)),
        (jax_coll._vv_hash(jnp.asarray(vv)), collectives._vv_hash(tv)),
        (jax_coll.state_digest(jnp.asarray(present), jnp.asarray(vv)),
         collectives.state_digest(tp, tv)),
        (jax_coll.global_vv_join(jnp.asarray(vv)),
         collectives.global_vv_join(tv)),
    ]
    for want, got in pairs:
        got = got.numpy().astype(np.uint64) & 0xFFFFFFFF
        assert np.array_equal(np.asarray(want).astype(np.uint64), got)
    same = np.repeat(present[:1], 9, axis=0)
    same_vv = np.repeat(vv[:1], 9, axis=0)
    for p, v in ((present, vv), (same, same_vv)):
        assert bool(collectives.converged(
            torch.from_numpy(p), from_numpy_u32(v, "cpu"))) == bool(
            jax_coll.converged(jnp.asarray(p), jnp.asarray(v)))


def test_schedules_match():
    for R in (1, 7, 64, 100):
        assert gossip.dissemination_offsets(R) == \
            jax_gossip.dissemination_offsets(R)
        for off in (0, 1, 5, 3 * R + 1):
            assert np.array_equal(gossip.ring_perm(R, off, "cpu").numpy(),
                                  np.asarray(jax_gossip.ring_perm(R, off)))
    for stage in range(4):
        assert np.array_equal(gossip.butterfly_perm(16, stage, "cpu").numpy(),
                              np.asarray(jax_gossip.butterfly_perm(16, stage)))
    with pytest.raises(ValueError):
        gossip.butterfly_perm(12, 1, "cpu")
    with pytest.raises(ValueError):
        gossip.butterfly_perm(16, 4, "cpu")
    p1 = gossip.random_perm(prng.key(5), 20, device="cpu")
    p2 = gossip.random_perm(prng.key(5), 20, device="cpu")
    assert torch.equal(p1, p2)
    assert sorted(p1.tolist()) == list(range(20))
    want = jax_gossip.random_perm(jax.random.key(5), 20)
    assert np.array_equal(p1.numpy(), np.asarray(want))


@pytest.mark.parametrize("delta", [False, True])
def test_all_pairs_converge_matches(delta):
    st = __graft_entry__._demo_state(24, 40, delta=delta)
    want = jax_gossip.all_pairs_converge(st, delta=delta)
    got = gossip.all_pairs_converge(to_torch(st), delta=delta)
    assert_same(want, got)
    assert bool(collectives.converged(got.present, got.vv))


@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("schedule", ["dissemination", "ring", "butterfly"])
def test_rounds_to_convergence_counts_match(schedule, delta):
    """Deterministic schedules: the same round count and the same final
    state as the JAX loop (which bisects inside its chunks)."""
    st = scenario(41, 16, 24, 16)
    if not delta:
        st = st.base()
    n_j, s_j = jax_gossip.rounds_to_convergence(st, delta=delta,
                                                schedule=schedule)
    n_t, s_t = gossip.rounds_to_convergence(to_torch(st), delta=delta,
                                            schedule=schedule)
    assert n_t == n_j
    assert_same(s_j, s_t, schedule)


@pytest.mark.parametrize("check_every", [1, 3, 5, 64])
@pytest.mark.parametrize("schedule", ["dissemination", "ring"])
def test_rounds_to_convergence_chunking_keeps_exact_count(schedule,
                                                          check_every):
    """Digests read every k rounds, the first converged round found by
    bisection: the same count and state as the JAX loop at the same k."""
    st = scenario(61, 24, 16, 12)
    n_j, s_j = jax_gossip.rounds_to_convergence(
        st, delta=True, schedule=schedule, check_every=check_every)
    n_t, s_t = gossip.rounds_to_convergence(
        to_torch(st), delta=True, schedule=schedule,
        check_every=check_every)
    assert n_t == n_j > 1
    assert_same(s_j, s_t, f"{schedule} k={check_every}")


def test_rounds_to_convergence_chunking_with_drops_reproduces():
    """Replayed rounds redraw the same drops and pairings: the count is
    the same at every chunk size."""
    st = to_torch(scenario(67, 16, 24, 16))
    runs = [gossip.rounds_to_convergence(st, seed=4, drop_rate=0.4,
                                         delta=True, schedule="random",
                                         check_every=k)
            for k in (1, 2, 7, 32)]
    assert len({n for n, _ in runs}) == 1
    for _, s in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0][1], s))


@pytest.mark.parametrize("check_every", [1, 8])
@pytest.mark.parametrize("schedule,drop_rate", [
    ("dissemination", 0.3), ("random", 0.0), ("random", 0.4)])
@pytest.mark.parametrize("delta", [False, True])
def test_seeded_rounds_match_jax(delta, schedule, drop_rate, check_every):
    """Drop masks and random pairings are jax.random's draws: a seed
    gives the JAX loop's round count and final state."""
    st = scenario(73, 16, 24, 16)
    if not delta:
        st = st.base()
    n_j, s_j = jax_gossip.rounds_to_convergence(
        st, key=jax.random.key(11), drop_rate=drop_rate, delta=delta,
        schedule=schedule, check_every=check_every)
    n_t, s_t = gossip.rounds_to_convergence(
        to_torch(st), seed=11, drop_rate=drop_rate, delta=delta,
        schedule=schedule, check_every=check_every)
    assert n_t == n_j > 1
    assert_same(s_j, s_t, f"{schedule} drop={drop_rate} k={check_every}")


def test_out_of_range_perm_raises():
    st = to_torch(scenario(71, 8, 16, 8)).base()
    for bad in (np.arange(8) + 1, torch.arange(8) - 1):
        with pytest.raises(ValueError, match="must lie in"):
            gossip.gossip_round(st, bad)
    with pytest.raises(ValueError, match="shape"):
        gossip.gossip_round(st, np.arange(7))


def test_rounds_to_convergence_seeded_schedules_reproduce():
    st = to_torch(scenario(43, 16, 24, 16))
    runs = [gossip.rounds_to_convergence(st, seed=9, drop_rate=0.3,
                                         delta=True, schedule="random")
            for _ in range(2)]
    assert runs[0][0] == runs[1][0] > 0
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    with pytest.raises(ValueError):
        gossip.rounds_to_convergence(st, drop_rate=0.3)
    with pytest.raises(ValueError):
        gossip.rounds_to_convergence(st, schedule="random")
    with pytest.raises(ValueError):
        gossip.rounds_to_convergence(to_torch(scenario(43, 12, 8, 12)),
                                     schedule="butterfly")


@pytest.mark.parametrize("delta", [False, True])
def test_drop_masks_from_numpy_keep_old_rows(delta):
    st = scenario(47, 70, 32, 8)          # R = 70: not a multiple of 64
    if not delta:
        st = st.base()
    drop = np.random.default_rng(0).random(70) < 0.3
    perm = np.random.default_rng(1).permutation(70).astype(np.uint32)
    jround = jax_gossip.delta_gossip_round if delta else \
        jax_gossip.gossip_round
    tround = gossip.delta_gossip_round if delta else gossip.gossip_round
    tring = gossip.delta_ring_gossip_round if delta else \
        gossip.ring_gossip_round
    ported = to_torch(st)
    want = jround(st, perm, drop, kernel="xla")
    assert_same(want, tround(ported, perm, drop))
    assert_same(want, tround(ported, perm, torch.from_numpy(drop)))
    want = jround(st, jax_gossip.ring_perm(70, 9), drop, kernel="xla")
    got = tring(ported, 9, drop)
    assert_same(want, got)
    for name in got._fields:
        assert torch.equal(getattr(got, name)[torch.from_numpy(drop)],
                           getattr(ported, name)[torch.from_numpy(drop)])


def test_ring_round_not_multiple_of_64_matches_pallas():
    from go_crdt_playground_tpu.ops import pallas_merge

    st = scenario(53, 70, 64, 8).base()
    for off in (1, 64, 69, 140):
        want = pallas_merge.pallas_ring_round_rows(st, off)
        assert_same(want, gossip.ring_gossip_round(to_torch(st), off))


def test_round_outputs_keep_uint32_bits():
    st = scenario(59, 8, 16, 8)
    st = st._replace(vv=st.vv | np.uint32(0x80000000))
    got = gossip.delta_ring_gossip_round(to_torch(st), 1)
    assert got.vv.dtype == torch.int32
    assert (to_numpy_u32(got.vv) >= 0x80000000).all()
