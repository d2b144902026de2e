"""The port's mesh, collectives and sharded rounds against the JAX
package's on the 8 forced CPU devices (tests/conftest.py): the port runs
an 8-slot mesh whose slots share the CPU.  Every state is compared
bitwise (``np.array_equal``, dtype included); the guards raise
``ValueError`` where the JAX functions do."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from go_crdt_playground_tpu.models import awset_delta as jax_awset_delta
from go_crdt_playground_tpu.models import packed as jax_packed
from go_crdt_playground_tpu.ops import pallas_delta, pallas_merge
from go_crdt_playground_tpu.parallel import collectives as jax_coll
from go_crdt_playground_tpu.parallel import gossip as jg
from go_crdt_playground_tpu.parallel import mesh as jm
from go_crdt_playground_tpu_torch.entry import dryrun_multichip
from go_crdt_playground_tpu_torch.models import packed
from go_crdt_playground_tpu_torch.parallel import collectives, gossip
from go_crdt_playground_tpu_torch.parallel import mesh as tm
from go_crdt_playground_tpu_torch.parallel import shardmap
from tests.test_compact import _random_delta_state
from tests.test_gossip import _random_state
from tests.test_torch_models import scenario, to_torch


def _mesh(shape):
    return tm.make_mesh(shape, devices=["cpu"] * (shape[0] * shape[1]))


def _gathered(st):
    return tm.gather_state(st) if isinstance(st, tm.ShardedState) else st


def _same(want, got, ctx=""):
    """JAX state (any sharding) against a port state, bitwise."""
    got = _gathered(got)
    want = jax.tree.map(np.asarray, want)
    for name in want._fields:
        w = getattr(want, name)
        g = getattr(got, name)
        g = (g.numpy() if g.dtype == torch.bool
             else g.numpy().view(np.uint32))
        assert g.dtype == w.dtype and np.array_equal(g, w), f"{ctx}:{name}"


def _torch_packed(jax_state):
    return packed.from_arrays(
        {f: np.asarray(getattr(jax_state, f)) for f in jax_state._fields},
        device="cpu")


# ---------------------------------------------------------------------------
# The mesh and its collectives
# ---------------------------------------------------------------------------


def test_mesh_layout_and_round_trip(monkeypatch):
    st = to_torch(_random_state(random.Random(3), R=16, E=32, A=16,
                                delta=True))
    for shape, ep in (((8, 1), False), ((4, 2), False), ((2, 4), True)):
        m = _mesh(shape)
        sh = tm.shard_state(st, m, shard_actors=ep)
        blk = sh.block((1, 1 if shape[1] > 1 else 0))
        assert blk.vv.shape == (16 // shape[0],
                                16 // (shape[1] if ep else 1))
        assert blk.present.shape == (16 // shape[0], 32 // shape[1])
        back = tm.gather_state(sh)
        assert all(torch.equal(a, b) for a, b in zip(st, back))
        assert tm.partition_specs(type(st), ep).vv == (
            (tm.REPLICA_AXIS, tm.ELEMENT_AXIS) if ep
            else (tm.REPLICA_AXIS, None))
    assert tm.take_devices(3, "cpu") == [torch.device("cpu")] * 3
    # the default takes distinct cards (two, as far as torch can tell)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tm.take_devices() == [torch.device("cuda", 0),
                                 torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="mesh wants 99 devices; 2 visible"):
        tm.take_devices(99)
    with pytest.raises(ValueError, match="!= #devices"):
        tm.make_mesh((3, 2), devices=["cpu"] * 4)


def test_ppermute_never_aliases_the_sender():
    """Two slots on one device: the received block is a fresh buffer, so
    an in-place update of the sender's block after the ppermute does not
    show through on the receiver."""
    m = _mesh((2, 1))
    grid = shardmap.map_slots(
        m, lambda idx, _: torch.full((4,), idx[0] + 1, dtype=torch.int32),
        tm.empty_grid(m))
    got = shardmap.ppermute(m, grid, tm.REPLICA_AXIS, [(0, 1), (1, 0)])
    assert got[(1, 0)].data_ptr() != grid[(0, 0)].data_ptr()
    grid[(0, 0)].add_(100)
    assert got[(1, 0)].tolist() == [1] * 4
    assert got[(0, 0)].tolist() == [2] * 4
    # a slot no pair names receives zeros, as jax.lax.ppermute
    one_way = shardmap.ppermute(m, grid, tm.REPLICA_AXIS, [(0, 1)])
    assert one_way[(0, 0)].tolist() == [0] * 4
    # all_gather and the reductions
    g = shardmap.all_gather(m, grid, tm.REPLICA_AXIS)
    assert g[(1, 0)].tolist() == [101] * 4 + [2] * 4
    s = shardmap.psum(m, shardmap.map_slots(
        m, lambda idx, x: x.to(torch.int64), grid), tm.REPLICA_AXIS)
    assert s[(0, 0)].tolist() == [103] * 4


def test_membership_hash_across_element_slots():
    """Each element slot mixes its GLOBAL lane ids, so the partial sums
    over the element axis add up to the whole membership hash."""
    rng = np.random.default_rng(7)
    present = rng.random((6, 64)) < 0.4
    want = np.asarray(jax_coll.membership_hash(jnp.asarray(present)))
    total = np.zeros(6, np.uint64)
    for j in range(4):
        part = collectives.membership_hash(
            torch.from_numpy(present[:, j * 16:(j + 1) * 16].copy()),
            lane_base=j * 16)
        total = (total + part.numpy().view(np.uint32)) % (1 << 32)
    assert np.array_equal(total.astype(np.uint32), want)
    # the lane base matters: the local-id partial sums differ
    local = sum(collectives.membership_hash(torch.from_numpy(
        present[:, j * 16:(j + 1) * 16].copy())).numpy().view(
            np.uint32).astype(np.uint64) for j in range(4)) % (1 << 32)
    assert not np.array_equal(local.astype(np.uint32), want)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_sharded_digest_and_converged(shape):
    st = _random_state(random.Random(9), R=16, E=32, A=16, delta=True)
    m = _mesh(shape)
    sh = tm.shard_state(to_torch(st), m)
    digests = gossip.state_digest_shardmap(sh, m)
    want = np.asarray(jax_coll.state_digest(st.present, st.vv))
    blk = 16 // shape[0]
    for idx in m.slots():
        assert np.array_equal(
            digests[idx].numpy(),
            want[idx[0] * blk:(idx[0] + 1) * blk].astype(np.int64))
    assert gossip.converged_shardmap(sh, m) == bool(
        jax_coll.converged(st.present, st.vv))
    one = jax.tree.map(lambda x: jnp.repeat(x[:1], 16, axis=0), st)
    assert gossip.converged_shardmap(tm.shard_state(to_torch(one), m), m)


# ---------------------------------------------------------------------------
# Unsharded δ rounds (tests/test_gossip.py:134, 155; test_compact.py:89, 129)
# ---------------------------------------------------------------------------


def test_pipelined_delta_gossip_matches_and_converges():
    R = 16
    st = _random_state(random.Random(37), R=R, E=32, A=16, delta=True)
    offsets = jg.dissemination_offsets(R)
    perms = jnp.stack([jg.ring_perm(R, o) for o in offsets] * 3)
    want = jg.pipelined_delta_gossip(st, perms)
    got = gossip.pipelined_delta_gossip(to_torch(st), np.asarray(perms))
    _same(want, got)
    assert bool(collectives.converged(got.present, got.vv))
    ref = gossip.all_pairs_converge(to_torch(st), delta=True)
    assert torch.equal(got.present, ref.present)
    assert torch.equal(got.vv, ref.vv)


def test_pipelined_round_lag_is_exactly_one():
    st = jax_awset_delta.add_element(jax_awset_delta.init(4, 8, 4),
                                     np.uint32(0), np.uint32(3))
    perms = jnp.stack([jg.ring_perm(4, 1)])
    want = jg.pipelined_delta_gossip(st, perms)
    got = gossip.pipelined_delta_gossip(to_torch(st), np.asarray(perms))
    _same(want, got)
    assert bool(got.present[3, 3]) and not bool(got.present[2, 3])


def test_compact_round_matches_dense_steady_state():
    st = _random_delta_state(random.Random(59))
    R, E = st.present.shape
    st = jg.delta_gossip_round(st, jg.ring_perm(R, 1), delta_semantics="v2")
    for off in (2, 1, 4):
        perm = jg.ring_perm(R, off)
        want = jg.compact_delta_gossip_round(st, perm, E, E)
        got = gossip.compact_delta_gossip_round(to_torch(st),
                                                np.asarray(perm), E, E)
        _same(want, got, f"off {off}")
        dense = gossip.delta_gossip_round(to_torch(st), np.asarray(perm))
        assert all(torch.equal(a, b) for a, b in zip(dense, got))
        st = jg.delta_gossip_round(st, perm, delta_semantics="v2")


def test_tiny_k_rounds_match_and_stay_safe():
    st = _random_delta_state(random.Random(61))
    R = st.present.shape[0]
    lossy, tlossy = st, to_torch(st)
    for off in (1, 2, 4, 1):
        perm = jg.ring_perm(R, off)
        lossy = jg.compact_delta_gossip_round(lossy, perm, 2, 2)
        tlossy = gossip.compact_delta_gossip_round(tlossy, np.asarray(perm),
                                                   2, 2)
        _same(lossy, tlossy, f"off {off}")
    done = gossip.all_pairs_converge(tlossy, delta=True)
    ref = gossip.all_pairs_converge(to_torch(st), delta=True)
    assert bool(collectives.converged(done.present, done.vv))
    assert torch.equal(done.present, ref.present)
    assert torch.equal(done.vv, ref.vv)


# ---------------------------------------------------------------------------
# Sharded rounds (tests/test_gossip.py:169-547, test_compact.py:143)
# ---------------------------------------------------------------------------


def test_ring_shardmap_matches_gather_round_and_jax():
    R = 16
    st = _random_state(random.Random(23), R=R, E=32)
    for shape in ((8, 1), (4, 2)):
        m = jm.make_mesh(shape)
        want = jg.ring_round_shardmap(jm.shard_state(st, m), m)
        for kernel in ("auto", "torch"):
            got = gossip.ring_round_shardmap(to_torch(st), _mesh(shape),
                                             kernel=kernel)
            _same(want, got, f"{shape} {kernel}")
        perm = (np.arange(R) - R // shape[0]) % R
        _same(want, gossip.gossip_round(to_torch(st), perm))


def test_ep_ring_matches_replicated_ring_and_jax():
    st = _random_state(random.Random(29), R=16, E=32, A=16)
    for shape in ((4, 2), (2, 4)):
        m = jm.make_mesh(shape)
        want = jg.ep_ring_round_shardmap(
            jm.shard_state(st, m, shard_actors=True), m)
        pm = _mesh(shape)
        got = gossip.ep_ring_round_shardmap(to_torch(st), pm)
        assert got.shard_actors
        _same(want, got, str(shape))
        _same(want, gossip.ring_round_shardmap(to_torch(st), pm))


def test_ep_ring_rejects_indivisible_actor_axis():
    from go_crdt_playground_tpu.models import awset as jax_awset

    st = jax_awset.init(16, 32, 12, actors=np.arange(16) % 12)
    with pytest.raises(ValueError):
        jg.ep_ring_round_shardmap(st, jm.make_mesh((1, 8)))
    with pytest.raises(ValueError, match="EP layout needs A=12"):
        gossip.ep_ring_round_shardmap(to_torch(st), _mesh((1, 8)))
    with pytest.raises(ValueError, match="EP layout needs A=12"):
        tm.shard_state(to_torch(st), _mesh((1, 8)), shard_actors=True)


def test_butterfly_perm_guard():
    for args in ((8, 3), (12, 1)):
        with pytest.raises(ValueError):
            jg.butterfly_perm(*args)
        with pytest.raises(ValueError):
            gossip.butterfly_perm(*args, device="cpu")


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_butterfly_shardmap_bitwise_and_converges(shape):
    R = 16
    st = _random_state(random.Random(41), R=R, E=32, A=16)
    m, pm = jm.make_mesh(shape), _mesh(shape)
    for stage in range(4):
        want = jg.butterfly_round_shardmap(jm.shard_state(st, m), m, stage)
        for kernel in ("auto", "torch"):
            _same(want, gossip.butterfly_round_shardmap(
                to_torch(st), pm, stage, kernel=kernel),
                f"stage {stage} {kernel}")
    sh = tm.shard_state(to_torch(st), pm)
    for stage in range(4):
        sh = gossip.butterfly_round_shardmap(sh, pm, stage)
    assert gossip.converged_shardmap(sh, pm)


def test_butterfly_shardmap_validation():
    rng = random.Random(43)
    m = _mesh((8, 1))
    jax_st = _random_state(rng, R=24, A=24)
    with pytest.raises(ValueError, match="power-of-two replica"):
        jg.butterfly_round_shardmap(jax_st, jm.make_mesh((8, 1)), 1)
    with pytest.raises(ValueError, match="power-of-two replica"):
        gossip.butterfly_round_shardmap(to_torch(jax_st), m, 1)
    st = to_torch(_random_state(rng, R=16))
    with pytest.raises(ValueError, match="out of range"):
        gossip.butterfly_round_shardmap(st, m, 4)
    with pytest.raises(ValueError, match="not divisible"):
        gossip.butterfly_round_shardmap(st, _mesh((3, 1)), 0)


def test_butterfly_schedule_converges_in_log2_rounds():
    st = _random_state(random.Random(53), R=16, E=32, A=16)
    rounds, out = gossip.rounds_to_convergence(to_torch(st),
                                               schedule="butterfly")
    want_rounds, want = jg.rounds_to_convergence(st, schedule="butterfly")
    assert rounds == want_rounds == 4
    _same(want, out)
    with pytest.raises(ValueError, match="power-of-two"):
        gossip.rounds_to_convergence(
            to_torch(_random_state(random.Random(1), R=12, A=12)),
            schedule="butterfly")


def test_compact_ring_shardmap_matches_jax_and_jit_round():
    st = _random_delta_state(random.Random(67), R=16, E=32, A=16)
    m = jm.make_mesh((8, 1))
    want = jg.compact_ring_round_shardmap(jm.shard_state(st, m), m, 32, 32)
    got = gossip.compact_ring_round_shardmap(to_torch(st), _mesh((8, 1)),
                                             32, 32)
    _same(want, got)
    perm = (np.arange(16) - 2) % 16
    _same(want, gossip.compact_delta_gossip_round(to_torch(st), perm, 32, 32))
    with pytest.raises(ValueError, match="element axis unsharded"):
        gossip.compact_ring_round_shardmap(
            to_torch(_random_delta_state(random.Random(71), R=8, E=32, A=8)),
            _mesh((4, 2)))


def _packed_case(layout, seed):
    n, blk = 8, 64
    R, E, A = n * blk, 96, 8
    st = scenario(seed, R, E, A)
    pack = {"bits": jax_packed.pack_awset_delta,
            "dots": jax_packed.pack_awset_delta_dots,
            "full_bits": lambda s: jax_packed.pack_awset(s.base()),
            "full_dots": lambda s: jax_packed.pack_awset_dots(s.base())}[
                layout]
    ring = {"bits": pallas_delta.pallas_delta_ring_round_packed,
            "dots": pallas_delta.pallas_delta_ring_round_dotpacked,
            "full_bits": pallas_merge.pallas_ring_round_rows_packed,
            "full_dots": pallas_merge.pallas_ring_round_rows_dotpacked}[
                layout]
    return pack(st), ring, blk, E


@pytest.mark.parametrize("layout", ["bits", "dots", "full_bits",
                                    "full_dots"])
def test_packed_block_ring_block_aligned_matches_jax(layout):
    """Block-aligned offsets equal the single-device packed ring round
    (the JAX kernels in interpret mode) in all four packed layouts."""
    jp, ring, blk, _ = _packed_case(layout, 11)
    want = ring(jp, blk)
    got = gossip.packed_block_ring_round_shardmap(_torch_packed(jp),
                                                  _mesh((8, 1)), blk)
    _same(want, got)


def test_packed_block_ring_intra_offset_and_schedule():
    """An intra offset equals the packed round per block (the stacked
    form on one device, the JAX kernel in interpret mode); the composed
    dissemination schedule converges in both delta layouts."""
    jp, ring, blk, E = _packed_case("bits", 11)
    m = _mesh((8, 1))
    got = tm.gather_state(gossip.packed_block_ring_round_shardmap(
        _torch_packed(jp), m, 3))
    for b in (0, 5):
        sl = slice(b * blk, (b + 1) * blk)
        block = jax.tree.map(lambda x: x[sl], jp)
        stacked = jax.tree.map(lambda x: jnp.concatenate([x, x]), block)
        want_b = jax.tree.map(lambda x: x[:blk], ring(stacked, blk + 3))
        _same(want_b, type(got)(*(x[sl] for x in got)), f"block {b}")
    for layout in ("bits", "dots"):
        jp, _, blk, E = _packed_case(layout, 83)
        st, o = _torch_packed(jp), 1
        while o < 8 * blk:
            st = gossip.packed_block_ring_round_shardmap(st, m, o)
            o *= 2
        out = tm.gather_state(st)
        full = (packed.unpack_awset_delta(out, E) if layout == "bits"
                else packed.unpack_awset_delta_dots(out, E))
        assert bool(collectives.converged(full.present, full.vv))


def test_packed_block_ring_guards():
    pst = packed.pack_awset_delta(to_torch(jax_awset_delta.init(64, 96,
                                                                64)))
    with pytest.raises(ValueError, match="stacks to a 16-row"):
        gossip.packed_block_ring_round_shardmap(pst, _mesh((8, 1)), 8)
    big = packed.pack_awset_delta(to_torch(jax_awset_delta.init(
        512, 96, 8, actors=np.arange(512) % 8)))
    with pytest.raises(ValueError, match="no-op"):
        gossip.packed_block_ring_round_shardmap(big, _mesh((8, 1)), 512)
    with pytest.raises(ValueError, match="neither intra-block"):
        gossip.packed_block_ring_round_shardmap(big, _mesh((8, 1)), 96)
    with pytest.raises(ValueError, match="element axis unsharded"):
        gossip.packed_block_ring_round_shardmap(big, _mesh((4, 2)), 64)
    with pytest.raises(ValueError, match="not divisible"):
        gossip.packed_block_ring_round_shardmap(big, _mesh((3, 1)), 64)


# ---------------------------------------------------------------------------
# The sharded δ round (the dry run's path 1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sem,strict", [("v2", True), ("reference", True),
                                        ("reference", False)])
@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_sharded_delta_round_matches_jax(shape, sem, strict):
    st = _random_state(random.Random(17), R=16, E=32, A=16, delta=True)
    m = jm.make_mesh(shape)
    perm = jg.ring_perm(16, 5)
    want = jg.delta_gossip_round_jit(
        jm.shard_state(st, m), perm, delta_semantics=sem,
        strict_reference_semantics=strict)
    got = gossip.delta_gossip_round_shardmap(
        to_torch(st), _mesh(shape), np.asarray(perm), delta_semantics=sem,
        strict_reference_semantics=strict)
    _same(want, got)
    gc = gossip.gc_shardmap(got, _mesh(shape))
    from go_crdt_playground_tpu.ops import delta as jax_delta

    _same(jax_delta.gc_apply(want, jax_delta.gc_frontier(want.processed)),
          gc, "gc")


def test_strict_skip_ors_nonempty_across_element_slots():
    """A strict-reference δ whose lanes lie in ONE element slot only: the
    vv join must happen on every element slot (a per-slot skip would
    leave the other slots' vv behind)."""
    R, E, A = 4, 32, 4
    st = jax_awset_delta.init(R, E, A)
    # replica 1 knows replica 0's actor (no first contact), then replica
    # 0 adds lanes inside the first element half only
    st = jax_awset_delta.add_element(st, np.uint32(0), np.uint32(2))
    st = jg.delta_gossip_round_jit(st, jnp.asarray([0, 0, 2, 3],
                                                   jnp.uint32),
                                   delta_semantics="reference")
    st = jax_awset_delta.add_element(st, np.uint32(0), np.uint32(5))
    perm = jnp.asarray([0, 0, 2, 3], jnp.uint32)
    want = jg.delta_gossip_round_jit(st, perm, delta_semantics="reference")
    assert int(np.asarray(want.vv)[1, 0]) == 2
    got = gossip.delta_gossip_round_shardmap(
        to_torch(st), _mesh((2, 2)), np.asarray(perm),
        delta_semantics="reference")
    _same(want, got)
    for j in (0, 1):
        assert int(got.block((0, j)).vv[1, 0]) == 2


# ---------------------------------------------------------------------------
# The dry run (tests/test_entry.py:44, 59)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 3])
def test_dryrun_prints_the_jax_summary(n, capsys):
    __graft_entry__._dryrun_inproc(n)
    want = capsys.readouterr().out.strip().splitlines()
    out = dryrun_multichip(n, device="cpu")
    got = capsys.readouterr().out.strip().splitlines()
    assert got == want
    assert got[-1].startswith("dryrun_multichip ok: 5/5 sharded paths")
    assert all(r["converged"] and r["bitwise"] for r in out)
