"""The port's packed layouts (models/packed.py, converged_packed) and the
plain versions of kernels K3 and K6-K9 against the JAX package: its
packed models and its Pallas kernels in interpret mode, as
tests/test_packed.py runs them on the CPU.  Every field is compared with
``np.array_equal``, dtype included: zero tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest

from go_crdt_playground_tpu.models import packed as jax_packed
from go_crdt_playground_tpu.ops import pallas_delta, pallas_merge
from go_crdt_playground_tpu.parallel import collectives as jax_collectives
from go_crdt_playground_tpu.parallel import gossip as jax_gossip
from go_crdt_playground_tpu_torch.models import packed
from go_crdt_playground_tpu_torch.ops import cuda_delta, cuda_merge
from go_crdt_playground_tpu_torch.parallel import collectives, gossip
from tests.test_packed import rand_state
from tests.test_torch_models import assert_same, scenario, to_torch

R = 128
MODES = [("v2", True), ("reference", True), ("reference", False)]

# (JAX pack, JAX unpack, port pack, port unpack, δ state?)
LAYOUTS = {
    "bits": (jax_packed.pack_awset, jax_packed.unpack_awset,
             packed.pack_awset, packed.unpack_awset, False),
    "dots": (jax_packed.pack_awset_dots, jax_packed.unpack_awset_dots,
             packed.pack_awset_dots, packed.unpack_awset_dots, False),
    "delta_bits": (jax_packed.pack_awset_delta,
                   jax_packed.unpack_awset_delta, packed.pack_awset_delta,
                   packed.unpack_awset_delta, True),
    "delta_dots": (jax_packed.pack_awset_delta_dots,
                   jax_packed.unpack_awset_delta_dots,
                   packed.pack_awset_delta_dots,
                   packed.unpack_awset_delta_dots, True),
}


def to_torch_packed(jax_state):
    """A JAX packed state -> the port's, through the numpy bridge."""
    return packed.from_arrays({name: np.asarray(getattr(jax_state, name))
                               for name in jax_state._fields}, device="cpu")


@pytest.fixture(scope="module")
def delta_state():
    return scenario(71, R, 128, 8)


@pytest.mark.parametrize("num_e", [1, 31, 32, 33, 200, 4100])
def test_pack_bits_round_trip_matches_jax(num_e):
    import torch

    mask = np.random.default_rng(num_e).random((6, num_e)) < 0.5
    mask[0] = True                     # every word's bit 31 set
    want = np.asarray(pallas_merge.pack_bits(jnp.asarray(mask)))
    got = packed.pack_bits(torch.from_numpy(mask))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert np.array_equal(packed.unpack_bits(got, num_e).numpy(), mask)
    # the tail bits past E are zero
    tail = packed.packed_width(num_e) * 32 - num_e
    top = want[:, -1].astype(np.uint64) >> np.uint64(32 - tail)
    assert tail == 0 or not top.any()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pack_unpack_and_bridge_match_jax(layout, delta_state):
    jpack, junpack, pack, unpack, is_delta = LAYOUTS[layout]
    st = (delta_state if is_delta
          else rand_state(np.random.default_rng(3), R, 200, 5))
    want = jpack(st)
    got = pack(to_torch(st))
    assert type(got).__name__ == type(want).__name__
    assert_same(want, got, layout)
    num_e = st.present.shape[-1]
    assert_same(junpack(want, num_e), unpack(got, num_e), "unpack")
    assert_same(st, unpack(got, num_e), "round trip")
    # the numpy bridge is lossless both ways
    arrays = packed.to_arrays(got)
    assert all(a.dtype == np.uint32 for a in arrays.values())
    back = type(want)(**{k: jnp.asarray(v) for k, v in arrays.items()})
    assert_same(back, to_torch_packed(want), "bridge")


def test_bridge_keeps_words_with_bit_31():
    st = rand_state(np.random.default_rng(4), R, 64, 3)
    big = st._replace(dot_counter=jnp.where(
        st.present, st.dot_counter + jnp.uint32(0xFFFFFF00), 0))
    want = jax_packed.pack_awset(big)
    got = packed.pack_awset(to_torch(big))
    assert int(got.dot_counter.min()) < 0     # stored as negative int32
    assert_same(want, got)
    assert_same(want, to_torch_packed(want))
    with pytest.raises(ValueError, match="no packed state"):
        packed.from_arrays({"vv": np.zeros((1, 1), np.uint32)}, "cpu")


def test_dot_cap_guards_match_jax():
    st = rand_state(np.random.default_rng(29), R, 32, 8)
    for counter in (packed.DOT_MAX_COUNTER + 1, 0x80000000, 0xFFFFFFFF):
        big = st._replace(dot_counter=st.dot_counter.at[0, 0].set(
            jnp.uint32(counter)))
        with pytest.raises(ValueError, match="counter"):
            jax_packed.pack_awset_dots(big)
        # a counter >= 2^31 is a negative int32: a signed max misses it
        with pytest.raises(ValueError, match="counter"):
            packed.pack_awset_dots(to_torch(big))
    at_cap = st._replace(dot_counter=st.dot_counter.at[0, 0].set(
        jnp.uint32(packed.DOT_MAX_COUNTER)))
    assert_same(jax_packed.pack_awset_dots(at_cap),
                packed.pack_awset_dots(to_torch(at_cap)))
    wide = rand_state(np.random.default_rng(30), 4, 32,
                      packed.DOT_MAX_ACTORS + 1)
    with pytest.raises(ValueError, match="actor bits"):
        jax_packed.pack_awset_dots(wide)
    with pytest.raises(ValueError, match="actor bits"):
        packed.pack_awset_dots(to_torch(wide))


def test_delta_dot_cap_guard_matches_jax():
    st = scenario(79, 16, 32, 8)
    big = st._replace(del_dot_counter=st.del_dot_counter.at[0, 0].set(
        jnp.uint32(0x80000001)))
    with pytest.raises(ValueError, match="counter"):
        jax_packed.pack_awset_delta_dots(big)
    with pytest.raises(ValueError, match="counter"):
        packed.pack_awset_delta_dots(to_torch(big))


@pytest.mark.parametrize("offset", [1, 64, 65, 127])
@pytest.mark.parametrize("layout", ["bits", "dots"])
def test_ring_round_rows_packed_matches_pallas(layout, offset):
    """K6 / K7 plain versions against the Pallas packed ring kernels."""
    jpack, _, pack, _, _ = LAYOUTS[layout]
    st = rand_state(np.random.default_rng(21), R, 256, 5)
    if layout == "bits":
        want = pallas_merge.pallas_ring_round_rows_packed(jpack(st), offset)
        got = cuda_merge.ring_round_rows_packed(pack(to_torch(st)), offset)
    else:
        want = pallas_merge.pallas_ring_round_rows_dotpacked(jpack(st),
                                                             offset)
        got = cuda_merge.ring_round_rows_dotpacked(pack(to_torch(st)),
                                                   offset)
    assert_same(want, got, f"{layout} offset {offset}")


def test_dotpacked_ring_round_ragged_word_tail():
    """E = 4100: 129 words, the last one holding 4 lanes."""
    st = rand_state(np.random.default_rng(27), R, 4100, 7)
    want = pallas_merge.pallas_ring_round_rows_dotpacked(
        jax_packed.pack_awset_dots(st), 3)
    got = cuda_merge.ring_round_rows_dotpacked(
        packed.pack_awset_dots(to_torch(st)), 3)
    assert got.present_bits.shape == (R, 129)
    assert_same(want, got)


@pytest.mark.parametrize("sem,strict", MODES)
@pytest.mark.parametrize("offset", [1, 64])
@pytest.mark.parametrize("layout", ["delta_bits", "delta_dots"])
def test_delta_ring_round_packed_matches_pallas(layout, offset, sem, strict,
                                                delta_state):
    """K8 / K9 plain versions against the Pallas packed δ ring kernels,
    in the three δ modes."""
    jpack, _, pack, _, _ = LAYOUTS[layout]
    kw = dict(delta_semantics=sem, strict_reference_semantics=strict)
    if layout == "delta_bits":
        jax_fn = pallas_delta.pallas_delta_ring_round_packed
        port_fn = cuda_delta.delta_ring_round_packed
    else:
        jax_fn = pallas_delta.pallas_delta_ring_round_dotpacked
        port_fn = cuda_delta.delta_ring_round_dotpacked
    want = jax_fn(jpack(delta_state), offset, **kw)
    got = port_fn(pack(to_torch(delta_state)), offset, **kw)
    assert_same(want, got, f"{layout} offset {offset} {sem}/{strict}")


@pytest.mark.parametrize("sem,strict", MODES)
def test_delta_packed_on_converged_fleet_matches_pallas(sem, strict):
    """A converged fleet: every δ is empty, so the strict mode skips the
    vv join."""
    st = scenario(83, R, 64, 8)
    for off in jax_gossip.dissemination_offsets(R):
        st = pallas_delta.pallas_delta_ring_round(st, off)
    kw = dict(delta_semantics=sem, strict_reference_semantics=strict)
    want = pallas_delta.pallas_delta_ring_round_dotpacked(
        jax_packed.pack_awset_delta_dots(st), 1, **kw)
    got = cuda_delta.delta_ring_round_dotpacked(
        packed.pack_awset_delta_dots(to_torch(st)), 1, **kw)
    assert_same(want, got)
    want = pallas_delta.pallas_delta_ring_round_packed(
        jax_packed.pack_awset_delta(st), 1, **kw)
    got = cuda_delta.delta_ring_round_packed(
        packed.pack_awset_delta(to_torch(st)), 1, **kw)
    assert_same(want, got)


@pytest.mark.parametrize("num_r,num_e,num_a",
                         [(8, 16, 2), (7, 300, 5), (12, 200, 16)])
def test_k3_entries_match_pallas(num_r, num_e, num_a):
    """K3: the one-row Pallas kernel's entries."""
    rng = np.random.default_rng(num_r)
    st, other = (rand_state(rng, num_r, num_e, num_a) for _ in range(2))
    perm = rng.permutation(num_r).astype(np.int32)
    assert_same(pallas_merge.pallas_gossip_round(st, jnp.asarray(perm)),
                cuda_merge.gossip_round(to_torch(st), perm), "gossip")
    assert_same(pallas_merge.pallas_merge_pairwise(st, other),
                cuda_merge.merge_pairwise(to_torch(st), to_torch(other)),
                "pairwise")


def test_converged_packed_matches_jax():
    st = rand_state(np.random.default_rng(5), R, 300, 4)
    conv = st
    for off in jax_gossip.dissemination_offsets(R):
        conv = pallas_merge.pallas_ring_round_rows(conv, off)
    for s, expect in ((st, False), (conv, True)):
        jp = jax_packed.pack_awset(s)
        want = bool(jax_collectives.converged_packed(jp.present_bits, jp.vv))
        tp = packed.pack_awset(to_torch(s))
        got = collectives.converged_packed(tp.present_bits, tp.vv)
        assert bool(got) == want == expect


def test_converged_packed_hashes_word_lanes_like_jax():
    """Two fleets that differ in one word: the port's digest answer
    follows the reference's hash, not just equality."""
    import torch

    bits = torch.from_numpy(np.random.default_rng(6).integers(
        0, 2**32, (4, 10), dtype=np.uint64).astype(np.uint32).view(np.int32))
    bits[1:] = bits[0]
    vv = torch.ones((4, 3), dtype=torch.int32)
    assert bool(collectives.converged_packed(bits, vv))
    bits[2, 9] ^= 1 << 31
    jbits = jnp.asarray(bits.numpy().view(np.uint32))
    want = bool(jax_collectives.converged_packed(jbits, jnp.ones((4, 3),
                                                                 jnp.uint32)))
    assert bool(collectives.converged_packed(bits, vv)) == want is False


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_packed_schedule_matches_jax_and_converges(layout):
    """A whole R = 256 dissemination schedule in the packed domain, equal
    to the JAX package's packed schedule and converged."""
    jpack, _, pack, unpack, is_delta = LAYOUTS[layout]
    num_r, num_e = 256, 96
    st = (scenario(73, num_r, num_e, 8) if is_delta
          else rand_state(np.random.default_rng(5), num_r, num_e, 4))
    jax_fn, port_fn = {
        "bits": (pallas_merge.pallas_ring_round_rows_packed,
                 cuda_merge.ring_round_rows_packed),
        "dots": (pallas_merge.pallas_ring_round_rows_dotpacked,
                 cuda_merge.ring_round_rows_dotpacked),
        "delta_bits": (pallas_delta.pallas_delta_ring_round_packed,
                       cuda_delta.delta_ring_round_packed),
        "delta_dots": (pallas_delta.pallas_delta_ring_round_dotpacked,
                       cuda_delta.delta_ring_round_dotpacked),
    }[layout]
    want, got = jpack(st), pack(to_torch(st))
    for off in gossip.dissemination_offsets(num_r):
        want, got = jax_fn(want, off), port_fn(got, off)
    assert_same(want, got, layout)
    assert bool(collectives.converged_packed(got.present_bits, got.vv))
    full = unpack(got, num_e)
    assert bool(collectives.converged(full.present, full.vv))


@pytest.mark.parametrize("num_r", [64, 1000])
def test_ring_guard_raises_on_both_sides(num_r):
    st = rand_state(np.random.default_rng(9), num_r, 32, 3)
    with pytest.raises(ValueError):
        pallas_merge.pallas_ring_round_rows_packed(
            jax_packed.pack_awset(st), 1)
    with pytest.raises(ValueError):
        pallas_merge.pallas_ring_round_rows_dotpacked(
            jax_packed.pack_awset_dots(st), 1)
    tst = to_torch(st)
    for fn, pack in ((cuda_merge.ring_round_rows_packed, packed.pack_awset),
                     (cuda_merge.ring_round_rows_dotpacked,
                      packed.pack_awset_dots)):
        for kernel in ("auto", "torch"):
            with pytest.raises(ValueError, match="R % 64"):
                fn(pack(tst), 1, kernel=kernel)
    dst = scenario(9, num_r, 32, 4)
    with pytest.raises(ValueError):
        pallas_delta.pallas_delta_ring_round_packed(
            jax_packed.pack_awset_delta(dst), 1)
    for fn, pack in ((cuda_delta.delta_ring_round_packed,
                      packed.pack_awset_delta),
                     (cuda_delta.delta_ring_round_dotpacked,
                      packed.pack_awset_delta_dots)):
        with pytest.raises(ValueError, match="R % 64"):
            fn(pack(to_torch(dst)), 1)


def test_packed_kernel_dispatch_rules():
    """No silent fallback: kernel='cuda' on a CPU tensor raises, A above
    the kernels' cap raises on the kernel path, and the checks know the
    packed shapes."""
    import torch

    st = rand_state(np.random.default_rng(1), R, 40, 3)
    bits, dots = packed.pack_awset(to_torch(st)), packed.pack_awset_dots(
        to_torch(st))
    for fn, s in ((cuda_merge.ring_round_rows_packed, bits),
                  (cuda_merge.ring_round_rows_dotpacked, dots)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(s, 1, kernel="cuda")
        cuda_merge.check_state(s)
    with pytest.raises(ValueError, match="present_bits"):
        cuda_merge.check_state(bits._replace(
            present_bits=torch.zeros((R, 1), dtype=torch.int32)))
    with pytest.raises(ValueError, match="dots"):
        cuda_merge.check_state(dots._replace(dots=dots.dots.to(torch.int64)))
    wide = to_torch(rand_state(np.random.default_rng(2), R, 8, 2049))
    cuda_merge.check_state(packed.pack_awset(wide))
    # dot words: up to 4,096 actors (the 12-bit actor field), as packing
    # enforces; a wider dot-word state never reaches a kernel
    at_cap = to_torch(rand_state(np.random.default_rng(2), R, 8,
                                 packed.DOT_MAX_ACTORS))
    cuda_merge.check_state(packed.pack_awset_dots(at_cap))
    over = packed.pack_awset_dots(at_cap)
    over = over._replace(vv=torch.zeros((R, packed.DOT_MAX_ACTORS + 1),
                                        dtype=torch.int32))
    with pytest.raises(ValueError, match="at most 4096 actors"):
        cuda_merge.check_state(over)
    dst = packed.pack_awset_delta(to_torch(scenario(3, R, 16, 4)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_delta.delta_ring_round_packed(dst, 1, kernel="cuda")
    cuda_merge.check_state(dst)
    assert cuda_merge.layout_of(dst) == cuda_merge.LAYOUT_BITS
    assert (cuda_merge.layout_of(packed.pack_awset_delta_dots(
        packed.unpack_awset_delta(dst, 16))) == cuda_merge.LAYOUT_DOTWORD)
