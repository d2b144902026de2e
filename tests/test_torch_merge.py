"""The port's full-state merge (plain versions of kernels K1/K2) against
the JAX package: the XLA merge and the Pallas kernels in interpret mode,
as the JAX package's own tests run them on the CPU.  Bitwise."""

import numpy as np
import pytest
import torch

from go_crdt_playground_tpu.ops import merge as jax_merge
from go_crdt_playground_tpu.ops import pallas_merge
from go_crdt_playground_tpu.parallel import gossip as jax_gossip
from go_crdt_playground_tpu_torch.ops import cuda_merge, merge
from tests.test_torch_models import assert_same, to_torch


def rand_state(rng, num_r, num_e, num_a, max_counter=7):
    from tests.test_pallas_merge import rand_state as jax_rand_state

    return jax_rand_state(rng, num_r, num_e, num_a, max_counter)


def big_counters(rng, state):
    """Counters near the top of uint32 (signed int32 compares break)."""
    import jax.numpy as jnp

    big = np.asarray(state.vv, dtype=np.uint64)
    vv = jnp.asarray(((big * 97003) + 0xFFFF0000) % (1 << 32),
                     dtype=jnp.uint32)
    dc = jnp.where(state.present,
                   jnp.asarray(rng.integers(0xFFFE0000, 0xFFFFFFFF,
                                            state.dot_counter.shape,
                                            dtype=np.uint32)), 0)
    return state._replace(vv=vv, dot_counter=dc)


@pytest.mark.parametrize("num_r,num_e,num_a",
                         [(8, 16, 2), (7, 300, 5), (5, 640, 3)])
def test_merge_pairwise_matches_xla(num_r, num_e, num_a):
    rng = np.random.default_rng(11)
    dst, src = (rand_state(rng, num_r, num_e, num_a) for _ in range(2))
    want, _ = jax_merge.merge_pairwise(dst, src)
    got, _ = merge.merge_pairwise(to_torch(dst), to_torch(src))
    assert_same(want, got)
    assert_same(want, cuda_merge.merge_pairwise_rows(to_torch(dst),
                                                     to_torch(src)))


def test_merge_pairwise_rows_matches_pallas():
    rng = np.random.default_rng(12)
    dst, src = (rand_state(rng, 6, 200, 3) for _ in range(2))
    want = pallas_merge.pallas_merge_pairwise_rows(dst, src)
    assert_same(want, cuda_merge.merge_pairwise_rows(to_torch(dst),
                                                     to_torch(src)))


@pytest.mark.parametrize("offset", [0, 1, 63, 64, 65, 500])
def test_ring_round_rows_matches_pallas_ring(offset):
    """K1's plain version vs the ring-fused Pallas kernel: aligned,
    misaligned, zero and >= R offsets."""
    rng = np.random.default_rng(7)
    num_r = 2 * pallas_merge._BLOCK_R
    state = rand_state(rng, num_r, 128, 5)
    want = pallas_merge.pallas_ring_round_rows(state, offset)
    got = cuda_merge.ring_round_rows(to_torch(state), offset)
    assert_same(want, got, f"offset {offset}")


def test_ring_round_rows_unaligned_rows_matches_pallas_fallback():
    rng = np.random.default_rng(8)
    state = rand_state(rng, 70, 128, 3)
    want = pallas_merge.pallas_ring_round_rows(state, 9)
    assert_same(want, cuda_merge.ring_round_rows(to_torch(state), 9))


@pytest.mark.parametrize("num_r,num_e,num_a",
                         [(8, 16, 2), (7, 300, 5), (12, 640, 64)])
def test_gossip_round_rows_matches_pallas(num_r, num_e, num_a):
    rng = np.random.default_rng(23)
    state = rand_state(rng, num_r, num_e, num_a)
    perm = rng.permutation(num_r).astype(np.uint32)
    want = pallas_merge.pallas_gossip_round_rows(state, perm)
    assert_same(want, cuda_merge.gossip_round_rows(to_torch(state), perm))
    xla = jax_gossip.gossip_round(state, perm, kernel="xla")
    assert_same(xla, cuda_merge.gossip_round_rows(to_torch(state), perm))


def test_large_counters_exact():
    rng = np.random.default_rng(31)
    state = big_counters(rng, rand_state(rng, 9, 128, 3))
    perm = jax_gossip.ring_perm(9, 1)
    want = jax_gossip.gossip_round(state, perm, kernel="xla")
    assert_same(want, cuda_merge.gossip_round_rows(
        to_torch(state), np.asarray(perm)))
    assert_same(pallas_merge.pallas_gossip_round_rows(state, perm),
                cuda_merge.ring_round_rows(to_torch(state), 1))


def test_with_trace_outcome_codes_match():
    rng = np.random.default_rng(5)
    dst, src = (rand_state(rng, 6, 64, 3) for _ in range(2))
    want, wtrace = jax_merge.merge_pairwise(dst, src, with_trace=True)
    got, gtrace = merge.merge_pairwise(to_torch(dst), to_torch(src),
                                       with_trace=True)
    assert_same(want, got)
    for name in ("phase1", "phase2"):
        w = np.asarray(getattr(wtrace, name))
        g = getattr(gtrace, name).numpy()
        assert g.dtype == w.dtype == np.uint8
        assert np.array_equal(g, w), name
    # every outcome label occurs, so each branch of the codes is pinned
    assert set(np.unique(np.asarray(wtrace.phase1))) >= {0, 1, 2, 3, 4}
    assert set(np.unique(np.asarray(wtrace.phase2))) >= {0, 2, 5}


def test_merge_one_into_matches_jax():
    rng = np.random.default_rng(9)
    dst, src = (rand_state(rng, 4, 32, 3) for _ in range(2))
    want, wtrace = jax_merge.merge_one_into(dst, 2, src, 1, with_trace=True)
    got, gtrace = merge.merge_one_into(to_torch(dst), 2, to_torch(src), 1,
                                       with_trace=True)
    assert_same(want, got)
    assert np.array_equal(np.asarray(wtrace.phase1), gtrace.phase1.numpy())


def test_canonical_zeroing_of_absent_lanes():
    """Removed and never-present lanes carry zero dots after a merge."""
    rng = np.random.default_rng(4)
    dst, src = (rand_state(rng, 8, 64, 4) for _ in range(2))
    got = cuda_merge.merge_pairwise_rows(to_torch(dst), to_torch(src))
    absent = ~got.present
    assert int(got.dot_actor[absent].abs().sum()) == 0
    assert int(got.dot_counter[absent].abs().sum()) == 0
    removed = np.asarray(dst.present) & ~got.present.numpy()
    assert removed.any()


def test_kernel_dispatch_rules():
    rng = np.random.default_rng(1)
    st = to_torch(rand_state(rng, 4, 8, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_merge.ring_round_rows(st, 1, kernel="cuda")
    with pytest.raises(ValueError, match="kernel must be"):
        cuda_merge.ring_round_rows(st, 1, kernel="pallas")
    with pytest.raises(ValueError, match="perm entries"):
        cuda_merge.gossip_round_rows(st, np.array([0, 1, 2, 4]))
    wide = to_torch(rand_state(rng, 2, 8, cuda_merge.MAX_FUSED_ACTORS + 1))
    with pytest.raises(ValueError, match="kernel='torch'"):
        cuda_merge.check_state(wide)
    cuda_merge.check_state(st)
    # the plain version runs for CPU tensors and is what "torch" names
    assert_same(jax_gossip.gossip_round(
        rand_state(np.random.default_rng(1), 4, 8, 2),
        jax_gossip.ring_perm(4, 1), kernel="xla"),
        cuda_merge.ring_round_rows(st, 1, kernel="torch"))


def _k3_bad(st, how):
    """One way for a K3 batch to be malformed."""
    if how == "dtype":
        return st._replace(dot_counter=st.dot_counter.to(torch.int64))
    if how == "shape":
        return st._replace(present=st.present[:, :-1])
    return st._replace(vv=st.vv.t().contiguous().t())  # strided


@pytest.mark.parametrize("how", ["dtype", "shape", "layout"])
def test_k3_check_rejects_malformed_batches(how):
    """K3's one check pass (``cuda_merge._k3_check``) over both batches:
    the well-formed pair passes and names its shape, a malformed dst or
    src raises ValueError before anything launches."""
    rng = np.random.default_rng(7)
    dst = to_torch(rand_state(rng, 4, 8, 3))
    src = to_torch(rand_state(rng, 4, 8, 3))
    assert cuda_merge._k3_check(dst, src)[:3] == (4, 8, 3)
    assert cuda_merge._k3_check(dst, dst)[:3] == (4, 8, 3)
    for pair in ((_k3_bad(dst, how), src), (dst, _k3_bad(src, how))):
        with pytest.raises(ValueError):
            cuda_merge._k3_check(*pair)
