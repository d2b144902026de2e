"""The port's δ round (plain versions of kernels K4/K5) against the JAX
package in all three δ modes: the XLA δ round and the Pallas δ kernels
in interpret mode.  Bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest

from go_crdt_playground_tpu.models import awset_delta as jax_delta
from go_crdt_playground_tpu.ops import pallas_delta
from go_crdt_playground_tpu.parallel import gossip as jax_gossip
from go_crdt_playground_tpu_torch.ops import cuda_delta
from tests.test_torch_models import assert_same, scenario, to_torch

MODES = [("v2", True), ("reference", True), ("reference", False)]


def xla_round(st, perm, sem, strict):
    return jax_gossip.delta_gossip_round(
        st, perm, delta_semantics=sem, strict_reference_semantics=strict,
        kernel="xla")


def port_round(st, perm, sem, strict):
    return cuda_delta.delta_gossip_round(
        to_torch(st), np.asarray(perm), delta_semantics=sem,
        strict_reference_semantics=strict)


@pytest.mark.parametrize("sem,strict", MODES)
@pytest.mark.parametrize("R,E,A", [(8, 16, 8), (7, 300, 5), (12, 640, 16)])
def test_delta_round_matches_xla(R, E, A, sem, strict):
    """Iterated so first-contact, δ and empty-payload rounds all occur."""
    st = scenario(101, R, E, A)
    for offset in (1, 2, 3, 1):
        perm = jax_gossip.ring_perm(R, offset)
        want = xla_round(st, perm, sem, strict)
        assert_same(want, port_round(st, perm, sem, strict),
                    f"offset {offset} {sem} strict={strict}")
        st = want


@pytest.mark.parametrize("sem,strict", MODES)
@pytest.mark.parametrize("offset", [1, 64, 65])
def test_delta_ring_round_matches_pallas_ring(offset, sem, strict):
    num_r = 128
    st = scenario(111, num_r, 64, 8)
    want = pallas_delta.pallas_delta_ring_round(
        st, offset, delta_semantics=sem,
        strict_reference_semantics=strict)
    got = cuda_delta.delta_ring_round(
        to_torch(st), offset, delta_semantics=sem,
        strict_reference_semantics=strict)
    assert_same(want, got, f"offset {offset}")


@pytest.mark.parametrize("sem,strict", MODES)
def test_delta_gossip_round_matches_pallas(sem, strict):
    st = scenario(113, 12, 64, 5)
    perm = np.random.default_rng(3).permutation(12).astype(np.uint32)
    want = pallas_delta.pallas_delta_gossip_round(
        st, jnp.asarray(perm), delta_semantics=sem,
        strict_reference_semantics=strict)
    assert_same(want, port_round(st, perm, sem, strict))


def test_unaligned_ring_matches_pallas_fallback():
    st = scenario(112, 12, 64, 5)
    want = pallas_delta.pallas_delta_ring_round(st, 5)
    assert_same(want, cuda_delta.delta_ring_round(to_torch(st), 5))


def test_first_contact_rows_take_the_full_branch():
    st = scenario(103, 8, 32, 8)
    perm = jax_gossip.ring_perm(8, 1)
    for sem, strict in MODES:
        assert_same(xla_round(st, perm, sem, strict),
                    port_round(st, perm, sem, strict), sem)


@pytest.mark.parametrize("sem,strict", MODES)
def test_large_counters_exact(sem, strict):
    st = jax_delta.init(6, 64, 6)
    big = jnp.uint32(0xFFFE0007)
    st = st._replace(
        vv=st.vv.at[0, 0].set(big).at[1, 1].set(big + 8)
        .at[2, 0].set(jnp.uint32(0x7FFFFFFF)),
        present=st.present.at[0, 3].set(True).at[2, 5].set(True),
        dot_actor=st.dot_actor.at[0, 3].set(0),
        dot_counter=st.dot_counter.at[0, 3].set(big)
        .at[2, 5].set(jnp.uint32(0x80000001)),
        processed=st.processed.at[0, 0].set(big),
    )
    perm = jax_gossip.ring_perm(6, 1)
    assert_same(xla_round(st, perm, sem, strict),
                port_round(st, perm, sem, strict))


def test_equal_counter_deletion_tiebreak():
    """Equal-counter deletion records from different actors take the
    (counter, actor) lexicographic max, whatever the arrival order."""
    E = 32
    st = jax_delta.init(4, E, 4)
    for row, actor in ((0, 0), (1, 1)):
        st = st._replace(
            vv=st.vv.at[row, actor].set(5),
            deleted=st.deleted.at[row, 7].set(True),
            del_dot_actor=st.del_dot_actor.at[row, 7].set(actor),
            del_dot_counter=st.del_dot_counter.at[row, 7].set(5))
    for order in ((1, 2, 3), (3, 2, 1)):
        cur_j, cur_t = st, to_torch(st)
        for offset in order:
            cur_j = xla_round(cur_j, jax_gossip.ring_perm(4, offset),
                              "v2", True)
            cur_t = cuda_delta.delta_ring_round(cur_t, offset)
            assert_same(cur_j, cur_t, f"order {order} offset {offset}")
        assert (cur_t.del_dot_actor[:, 7] == 1).all()
        assert (cur_t.del_dot_counter[:, 7] == 5).all()


def test_strict_empty_delta_skips_vv_join():
    """Entries converged, clocks divergent, every payload empty: strict
    reference keeps dst's vv, loose joins it."""
    st = jax_delta.init(8, 16, 8)
    vv = np.ones((8, 8), np.uint32)
    vv[np.arange(8), np.arange(8)] += np.arange(8).astype(np.uint32)
    st = st._replace(
        vv=jnp.asarray(vv), present=st.present.at[:, 0].set(True),
        dot_actor=st.dot_actor.at[:, 0].set(0),
        dot_counter=st.dot_counter.at[:, 0].set(1))
    perm = jax_gossip.ring_perm(8, 1)
    strict = port_round(st, perm, "reference", True)
    assert_same(xla_round(st, perm, "reference", True), strict)
    assert np.array_equal(strict.vv.numpy().view(np.uint32), vv)
    loose = port_round(st, perm, "reference", False)
    assert_same(xla_round(st, perm, "reference", False), loose)
    assert not np.array_equal(loose.vv.numpy().view(np.uint32), vv)


def test_v2_remove_uses_post_phase1_dots():
    """A deletion record removes a lane only if the SENDER's clock covers
    the dot the lane holds after phase 1; a changed lane whose dot the
    sender's clock does not cover survives."""
    st = jax_delta.init(2, 4, 2)
    # row 1 (sender) ships lane 0 present with dot (1, 9) but its clock
    # stops at 3, and a deletion record for lane 0 it does not cover
    st = st._replace(
        vv=st.vv.at[0, 1].set(1).at[1, 1].set(3),
        present=st.present.at[1, 0].set(True),
        dot_actor=st.dot_actor.at[1, 0].set(1),
        dot_counter=st.dot_counter.at[1, 0].set(9),
        deleted=st.deleted.at[1, 0].set(True),
        del_dot_actor=st.del_dot_actor.at[1, 0].set(1),
        del_dot_counter=st.del_dot_counter.at[1, 0].set(9))
    perm = jax_gossip.ring_perm(2, 1)
    want = xla_round(st, perm, "v2", True)
    got = port_round(st, perm, "v2", True)
    assert_same(want, got)
    assert bool(got.present[0, 0])


def test_processed_join_matches_xla():
    """processed joins elementwise, and the sender's own slot advances to
    its clock; halving processed makes both cases occur."""
    st = scenario(7, 6, 24, 6)
    st = st._replace(processed=st.processed // 2)
    perm = jax_gossip.ring_perm(6, 2)
    want = xla_round(st, perm, "v2", True)
    got = port_round(st, perm, "v2", True)
    assert_same(want, got)
    proc = np.asarray(st.processed)
    joined = np.maximum(proc, proc[np.asarray(perm)])
    assert (joined != proc).any()
    assert (got.processed.numpy().view(np.uint32) != joined).any()


def test_unknown_semantics_rejected():
    st = to_torch(jax_delta.init(4, 8, 4))
    with pytest.raises(ValueError):
        cuda_delta.delta_gossip_round(st, np.arange(4),
                                      delta_semantics="v3")
