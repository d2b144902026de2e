"""The PyTorch port's state models against the JAX package's, bitwise.

The same numpy inputs go through both packages (the port on the CPU);
every field is compared with ``np.array_equal``: the states are integer
and bool, so the tolerance is exact equality.
"""

import random

import numpy as np
import pytest

from go_crdt_playground_tpu.models import awset as jax_awset
from go_crdt_playground_tpu.models import awset_delta as jax_delta
from go_crdt_playground_tpu_torch.models import awset, awset_delta


def to_torch(jax_state):
    """A JAX state -> the port's state on the CPU, through the numpy
    arrays bridge."""
    if hasattr(jax_state, "processed"):
        return awset_delta.from_arrays(jax_delta.to_arrays(jax_state),
                                       device="cpu")
    return awset.from_arrays(jax_awset.to_arrays(jax_state), device="cpu")


def assert_same(jax_state, torch_state, ctx=""):
    """Every field of the two states bitwise equal (dtype included)."""
    want = {name: np.asarray(getattr(jax_state, name))
            for name in jax_state._fields}
    got = awset.to_arrays(torch_state)
    assert list(got) == list(want), ctx
    for name in want:
        assert got[name].dtype == want[name].dtype, f"{ctx}:{name} dtype"
        assert np.array_equal(got[name], want[name]), f"{ctx}:{name}"


def scenario(seed, R, E, A):
    """The JAX tests' mixed-history δ scenario (adds, deletions,
    re-adds, silent rows)."""
    from tests.test_pallas_delta import _scenario_state

    return _scenario_state(random.Random(seed), R, E, A)


def _big_counters(st):
    """Push every nonzero counter past 2^31 (uint32 wrap territory)."""
    import jax.numpy as jnp

    def lift(x):
        return jnp.where(x > 0, x + jnp.uint32(0xFFFFFF00), x)

    return st._replace(vv=lift(st.vv), dot_counter=lift(st.dot_counter),
                       del_dot_counter=lift(st.del_dot_counter),
                       processed=lift(st.processed))


@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("big", [False, True])
def test_round_trip_jax_torch_jax(delta, big):
    st = scenario(5, 6, 40, 6)
    if big:
        st = _big_counters(st)
    if not delta:
        st = st.base()
    mod, jmod = (awset_delta, jax_delta) if delta else (awset, jax_awset)
    ported = to_torch(st)
    assert_same(st, ported, "jax->torch")
    back = jmod.from_arrays(mod.to_arrays(ported))
    assert_same(st, to_torch(back), "torch->jax")
    for name in st._fields:
        assert np.array_equal(np.asarray(getattr(st, name)),
                              np.asarray(getattr(back, name))), name


def test_awset_add_del_match_jax():
    rng = random.Random(11)
    R, E = 4, 8
    js = jax_awset.init(R, E, R)
    ts = awset.init(R, E, R, device="cpu")
    for step in range(40):
        r, e = rng.randrange(R), rng.randrange(E)
        if rng.random() < 0.7:
            js = jax_awset.add_element(js, np.uint32(r), np.uint32(e))
            ts = awset.add_element(ts, r, e)
        else:
            js = jax_awset.del_element(js, np.uint32(r), np.uint32(e))
            ts = awset.del_element(ts, r, e)
        assert_same(js, ts, f"step {step}")
    for r in range(R):
        for e in range(E):
            assert awset.has_element(ts, r, e) == \
                jax_awset.has_element(js, r, e)
    assert_same(jax_awset.reset(js), awset.reset(ts), "reset")
    copy = awset.clone(ts)
    assert copy.vv is not ts.vv
    assert_same(js, copy, "clone")


def test_awset_add_wraps_uint32_counter():
    js = jax_awset.init(2, 4, 2)
    js = js._replace(vv=js.vv.at[1, 1].set(np.uint32(0xFFFFFFFF)))
    ts = to_torch(js)
    js = jax_awset.add_element(js, np.uint32(1), np.uint32(2))
    ts = awset.add_element(ts, 1, 2)
    assert_same(js, ts, "wrap")
    assert int(np.asarray(js.vv)[1, 1]) == 0


def test_delta_ops_match_jax():
    """add_element, add_elements (duplicates keep the LAST occurrence's
    dot; ``count`` pads) and del_elements (one tick per call, even when
    nothing selected is present) against the JAX model."""
    rng = random.Random(17)
    nrng = np.random.default_rng(17)
    R, E, A = 5, 12, 5
    js = jax_delta.init(R, E, A)
    ts = awset_delta.init(R, E, A, device="cpu")
    for step in range(30):
        r = rng.randrange(R)
        roll = rng.random()
        if roll < 0.3:
            e = rng.randrange(E)
            js = jax_delta.add_element(js, np.uint32(r), np.uint32(e))
            ts = awset_delta.add_element(ts, r, e)
        elif roll < 0.6:
            k = rng.randrange(1, 6)
            elements = nrng.integers(0, E, k).astype(np.uint32)
            count = rng.randrange(1, k + 1) if rng.random() < 0.5 else None
            jcount = None if count is None else np.uint32(count)
            js = jax_delta.add_elements(js, np.uint32(r), elements, jcount)
            ts = awset_delta.add_elements(ts, r, elements, count)
        else:
            sel = nrng.random(E) < 0.3
            js = jax_delta.del_elements(js, np.uint32(r), sel)
            ts = awset_delta.del_elements(ts, r, sel)
        assert_same(js, ts, f"step {step}")


def test_delta_scenario_built_by_port_matches_jax():
    """The JAX scenario builder's op sequence replayed on the port."""
    rng_j, rng_t = random.Random(23), random.Random(23)
    from tests.test_pallas_delta import _scenario_state

    want = _scenario_state(rng_j, 6, 20, 4)
    st = awset_delta.init(6, 20, 4, actors=np.arange(6) % 4, device="cpu")
    writers = min(4, max(1, 6 - 2))
    for _ in range(5 * 6):
        r = rng_t.randrange(writers)
        e = rng_t.randrange(20)
        if rng_t.random() < 0.6:
            st = awset_delta.add_element(st, r, e)
        else:
            sel = np.zeros(20, bool)
            sel[e] = True
            if rng_t.random() < 0.3:
                sel[rng_t.randrange(20)] = True
            st = awset_delta.del_elements(st, r, sel)
    assert_same(want, st, "scenario")


@pytest.mark.parametrize("mod", [awset, awset_delta])
def test_default_actors_need_a_writer_per_replica(mod):
    with pytest.raises(ValueError):
        mod.init(4, 8, 2, device="cpu")
    st = mod.init(4, 8, 2, actors=[0, 1, 0, 1], device="cpu")
    assert st.num_replicas == 4 and st.num_actors == 2
    assert st.num_elements == 8
