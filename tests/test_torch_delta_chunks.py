"""K4/K5/K8's split-row geometry (``cuda_delta.row_chunks``) and the δ
round on the scenarios that split rows reach, against the JAX package.

On the card a batch of few, long rows is cut into chunks of whole
32-lane words, a block a chunk, and strict reference ORs the chunks'
payload bits before a row's vv epilogue.  Here the geometry is pinned,
and the plain version the card's kernel is held against runs the
scenarios (fleet.delta_scenario: an empty δ, its only payload lane in
the first or the last chunk, first contact, the bridge's [dst; src]
pair) against ``pallas_delta_gossip_round`` in interpret mode, whose
grid takes E in steps of 512 lanes (17 at E = 8,193) and carries the
strict empty-δ bit across them.  Bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest

from go_crdt_playground_tpu.models import awset_delta as jax_delta
from go_crdt_playground_tpu.ops import pallas_delta
from go_crdt_playground_tpu_torch import fleet
from go_crdt_playground_tpu_torch.models import awset_delta
from go_crdt_playground_tpu_torch.ops import cuda_delta
from tests.test_torch_models import assert_same

MODES = [("v2", True), ("reference", True), ("reference", False)]
H100_SMS = 132


@pytest.mark.parametrize("R,E", [
    (1 << 20, 256), (528, 65_536), (4096, 1 << 20), (128, 256),
    (2, 1024), (1, 1000), (5, 31), (2, 0)])
def test_one_block_a_row_at_fleet_and_serve_shapes(R, E):
    """R at or past four blocks an SM, or a row of at most 1,024 lanes (the
    serve tier's pairs): a block per row, today's launch."""
    assert cuda_delta.row_chunks(R, E, H100_SMS) == (1, E)


@pytest.mark.parametrize("R,E,sms", [
    (2, 65_536, H100_SMS), (2, 65_537, H100_SMS), (1, 65_536, H100_SMS),
    (8, 65_536, H100_SMS), (32, 65_536, H100_SMS), (128, 65_536, H100_SMS),
    (128, 65_537, H100_SMS), (2, 1 << 20, H100_SMS), (3, 4097, H100_SMS),
    (2, 8193, H100_SMS), (2, 1025, H100_SMS), (527, 1 << 20, H100_SMS),
    (1, 65_536, 1), (5, 100_003, 7)])
def test_split_rows_cover_e_in_whole_words(R, E, sms):
    geom = cuda_delta.row_chunks(R, E, sms)
    assert geom.chunks > 1
    bounds = [c * geom.lanes for c in range(geom.chunks)] + [E]
    assert bounds[0] == 0 and bounds[-1] == E
    assert all(b % 32 == 0 for b in bounds[:-1])
    assert all(lo < hi for lo, hi in zip(bounds, bounds[1:]))
    assert geom.lanes % 32 == 0 and geom.lanes >= cuda_delta.MIN_CHUNK_LANES
    assert geom.chunks * geom.lanes >= E > (geom.chunks - 1) * geom.lanes
    # the fewest chunks (the longest whole-word chunk, at least the
    # floor) that reach FILL_BLOCKS_PER_SM blocks an SM over R rows
    want = -(-cuda_delta.FILL_BLOCKS_PER_SM * sms // R)
    assert geom.chunks <= want
    assert (geom.lanes == cuda_delta.MIN_CHUNK_LANES
            or -(-E // (geom.lanes - 32)) > want)


def test_split_geometry_at_the_bridge_pair():
    """The bridge's pair on an H100: 128 chunks of 512 lanes a row at E =
    65,536, one more of one lane at 65,537; a node's universe in 263."""
    assert cuda_delta.row_chunks(2, 65_536, H100_SMS) == (128, 512)
    assert cuda_delta.row_chunks(2, 65_537, H100_SMS) == (129, 512)
    assert cuda_delta.row_chunks(2, 1 << 20, H100_SMS) == (263, 4000)


def test_row_chunks_rejects_empty_shapes():
    with pytest.raises(ValueError):
        cuda_delta.row_chunks(0, 10, H100_SMS)
    with pytest.raises(ValueError):
        cuda_delta.row_chunks(2, 10, 0)


@pytest.mark.parametrize("name", fleet.DELTA_SCENARIOS)
@pytest.mark.parametrize("sem,strict", MODES)
@pytest.mark.parametrize("E", [4097, 8193])
@pytest.mark.parametrize("R", [1, 2, 3])
def test_scenarios_match_the_pallas_round(R, E, sem, strict, name):
    arrays, perm = fleet.delta_scenario(name, R, E, 5, seed=R * E)
    st = jax_delta.AWSetDeltaState(
        **{k: jnp.asarray(v) for k, v in arrays.items()})
    want = pallas_delta.pallas_delta_gossip_round(
        st, jnp.asarray(perm.astype(np.int32)), delta_semantics=sem,
        strict_reference_semantics=strict)
    got = cuda_delta.delta_gossip_round(
        awset_delta.from_arrays(arrays, device="cpu"), perm,
        delta_semantics=sem, strict_reference_semantics=strict)
    assert_same(want, got, f"{name} R={R} E={E} {sem} strict={strict}")


@pytest.mark.parametrize("name,joined", [
    ("empty", False), ("payload_first", True), ("payload_last", True)])
def test_scenarios_reach_the_strict_skip_as_named(name, joined):
    """Strict reference keeps every row's vv on the empty δ and joins it
    when one lane (first or last chunk) carries payload; loose joins
    always; the first-contact rows join."""
    R, E = 3, 4097
    arrays, perm = fleet.delta_scenario(name, R, E, 5, seed=1)
    st = awset_delta.from_arrays(arrays, device="cpu")
    vv = arrays["vv"]
    joined_vv = np.maximum(vv, vv[perm])
    assert not np.array_equal(joined_vv, vv)
    strict = cuda_delta.delta_gossip_round(st, perm,
                                           delta_semantics="reference")
    got = strict.vv.numpy().view(np.uint32)
    assert np.array_equal(got, joined_vv if joined else vv)
    loose = cuda_delta.delta_gossip_round(
        st, perm, delta_semantics="reference",
        strict_reference_semantics=False)
    assert np.array_equal(loose.vv.numpy().view(np.uint32), joined_vv)
    arrays, perm = fleet.delta_scenario("first_contact", R, E, 5, seed=1)
    got = cuda_delta.delta_gossip_round(
        awset_delta.from_arrays(arrays, device="cpu"), perm,
        delta_semantics="reference").vv.numpy().view(np.uint32)
    vv = arrays["vv"]
    for r in range(R):
        want = np.maximum(vv[r], vv[perm[r]]) if r % 2 == 0 else vv[r]
        assert np.array_equal(got[r], want), r
