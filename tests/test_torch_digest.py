"""The port's digest pass (ops/digest.py, K11's plain version in
ops/cuda_digest.py) against the JAX package, bitwise.

The same numpy-seeded replica slices go through both packages (the port
on the CPU): lane fingerprints and group digests against the XLA pass
(``ops/digest.py``) and the Pallas kernel in interpret mode
(``ops/pallas_digest.py``), over ragged and aligned E, the group sizes
the chip check uses and occupancy extremes, with deletion dots whose bit
31 is set.  Every comparison is ``np.array_equal`` with the dtype
checked, so the tolerance is exact.  The laws of
tests/test_digest_kernel.py are replayed on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_crdt_playground_tpu.models import awset_delta as jax_awset_delta
from go_crdt_playground_tpu.ops import delta as jax_delta_ops
from go_crdt_playground_tpu.ops import digest as jdg
from go_crdt_playground_tpu.ops.pallas_digest import (
    pallas_lane_fingerprints, pallas_state_group_digests)
from go_crdt_playground_tpu_torch._u32 import from_numpy_u32, host
from go_crdt_playground_tpu_torch.ops import cuda_digest
from go_crdt_playground_tpu_torch.ops import delta as delta_ops
from go_crdt_playground_tpu_torch.ops import digest as dg
from tests.test_torch_ingest import to_port

A = 4
ELEMENTS = (1, 48, 64, 65, 200, 512, 1000)
GROUP_SIZES = (1, 3, 8, 16, 32, 48, 64, 128, 256)
# deletion-dot counters and actors with bit 31 set, up to 2^32 - 1
HIGH = np.array([0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE,
                 0xFFFFFFFF], np.uint32)
CASES = ("empty", "all present", "all deleted", "all present and deleted",
         "random", "random, high dots")


def jax_slice(e, seed, case="random"):
    """One seeded single-replica JAX slice: live entries, deletion
    records and re-adds (``random``), the occupancy extremes, or random
    lanes whose deletion dots sit at and past 2^31."""
    rng = np.random.default_rng(seed)
    row = jax.tree.map(lambda x: x[0], jax_awset_delta.init(1, e, A))
    present = rng.random(e) < 0.5
    deleted = rng.random(e) < 0.3
    if case != "random" and case != "random, high dots":
        present = np.full(e, "present" in case)
        deleted = np.full(e, "deleted" in case)
    da = rng.integers(0, A, e).astype(np.uint32)
    dc = rng.integers(1, 50, e).astype(np.uint32)
    dda = rng.integers(0, A, e).astype(np.uint32)
    ddc = rng.integers(1, 50, e).astype(np.uint32)
    if case == "random, high dots":
        dda = rng.choice(HIGH, e)
        ddc = rng.choice(HIGH, e)
    vv = rng.integers(50, 100, A).astype(np.uint32)
    return row._replace(
        vv=jnp.asarray(vv), present=jnp.asarray(present),
        dot_actor=jnp.asarray(np.where(present, da, 0)),
        dot_counter=jnp.asarray(np.where(present, dc, 0)),
        deleted=jnp.asarray(deleted),
        del_dot_actor=jnp.asarray(np.where(deleted, dda, 0)),
        del_dot_counter=jnp.asarray(np.where(deleted, ddc, 0)),
        processed=jnp.asarray(vv))


def assert_u32_equal(port, ref, ctx=""):
    """A port int32-bits tensor against a JAX uint32 array: same values,
    and the port's uint32 view has the reference's dtype and shape."""
    got = host(port)
    want = np.asarray(ref)
    assert port.dtype == torch.int32, ctx
    assert got.dtype == want.dtype == np.uint32, ctx
    assert np.array_equal(got, want), ctx


# pallas_state_group_digests is group_fold over pallas_lane_fingerprints;
# the fold runs jitted here, so each (E, gs) compiles once instead of
# once per eager op
_pallas_fold = jax.jit(jdg.group_fold, static_argnums=1)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("e", ELEMENTS)
def test_fingerprints_and_group_digests_match_jax(e, case):
    js = jax_slice(e, 100 + e, case)
    ts = to_port(js)
    want_fp = jdg.lane_fingerprints(js)
    pallas_fp = pallas_lane_fingerprints(js)
    assert np.array_equal(np.asarray(want_fp), np.asarray(pallas_fp))
    assert np.array_equal(np.asarray(jdg.state_group_digests(js, 64)),
                          np.asarray(pallas_state_group_digests(js, 64)))
    assert_u32_equal(dg.lane_fingerprints(ts), want_fp, "fingerprints")
    assert_u32_equal(cuda_digest.lane_fingerprints(ts), want_fp,
                     "K11 fingerprints, plain arm")
    for gs in GROUP_SIZES:
        want = jdg.state_group_digests(js, gs)
        assert np.array_equal(np.asarray(want),
                              np.asarray(_pallas_fold(pallas_fp, gs)))
        got = dg.state_group_digests(ts, gs)
        assert got.shape == (dg.num_groups(e, gs),)
        assert_u32_equal(got, want, f"gs={gs}")
        assert_u32_equal(cuda_digest.state_group_digests(ts, gs), want,
                         f"K11 gs={gs}, plain arm")
        assert_u32_equal(dg.group_fold(dg.lane_fingerprints(ts), gs), want,
                         f"fold gs={gs}")


def test_fingerprint_algebra_at_high_lane_ids():
    """Lane ids and components with bit 31 set (E itself cannot reach
    them here): the raw algebra and the padding lanes of a universe
    ending at 2^32 - 1."""
    rng = np.random.default_rng(31)
    ids = np.concatenate([np.arange(0x7FFFFFFC, 0x80000004),
                          np.arange(0xFFFFFFF8, 0x100000000)]).astype(np.uint32)
    n = ids.size
    present = rng.random(n) < 0.5
    deleted = rng.random(n) < 0.5
    dda, ddc = rng.choice(HIGH, n), rng.choice(HIGH, n)
    want = jdg.lane_fingerprint_arrays(
        jnp.asarray(ids), jnp.asarray(present), jnp.asarray(deleted),
        jnp.asarray(dda), jnp.asarray(ddc))
    got = dg.lane_fingerprint_arrays(
        torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(present),
        torch.from_numpy(deleted), from_numpy_u32(dda, "cpu"),
        from_numpy_u32(ddc, "cpu"))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))
    for e, gs in ((0xFFFFFFFB, 8), (0x80000001, 64), (0x7FFFFFFF, 3)):
        pad = (-e) % gs
        z = jnp.zeros(pad, jnp.uint32)
        want = jdg.lane_fingerprint_arrays(
            jnp.arange(e, e + pad, dtype=jnp.uint32), z, z, z, z)
        assert_u32_equal(dg.pad_fingerprints(e, gs, "cpu"), want,
                         f"pad E={e} gs={gs}")


@pytest.mark.parametrize("e,gs", [(256, 64), (100, 64), (1000, 48),
                                  (65, 8), (200, 1)])
def test_digest_diff_payload_matches_jax(e, gs):
    """The mismatched-group extraction, field by field, against the JAX
    pass: own digests as a tensor, the peer's as numpy, as the protocol
    passes them; only lanes of mismatched groups ship, the full vv
    rides along, and a self-comparison ships nothing."""
    a = jax_slice(e, 7 * e + gs)
    b = jax_slice(e, 7 * e + gs + 1)
    ta = to_port(a)
    d_a = jdg.state_group_digests(a, gs)
    d_b = jdg.state_group_digests(b, gs)
    own = dg.state_group_digests(ta, gs)
    peer = np.asarray(d_b).copy()
    peer[::2] = np.asarray(d_a)[::2]   # every other group matches
    for peer_digests in (peer, np.asarray(d_a)):
        want = jdg.digest_diff_payload(a, d_a, peer_digests, gs)
        got = dg.digest_diff_payload(ta, own, peer_digests, gs)
        for name, x, y in zip(want._fields, want, got):
            x = np.asarray(x)
            y = host(y)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
    mism = np.repeat(peer != np.asarray(d_a), gs)[:e]
    got = dg.digest_diff_payload(ta, own, peer, gs)
    assert not (host(got.changed) & ~mism).any()
    assert not (host(got.deleted) & ~mism).any()
    assert np.array_equal(host(got.src_vv), np.asarray(a.vv))
    empty = dg.digest_diff_payload(ta, own, host(own), gs)
    assert not host(empty.changed).any() and not host(empty.deleted).any()
    assert dg.mismatched_group_count(host(own), peer) == \
        jdg.mismatched_group_count(np.asarray(d_a), peer)
    assert dg.num_groups(e, gs) == jdg.num_groups(e, gs)


def test_digest_regime_follows_the_device():
    assert dg.digest_regime(128, "cpu") is dg.state_group_digests
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            dg.digest_regime(128)


def test_k11_wrappers_take_the_plain_version_only_for_cpu_tensors():
    ts = to_port(jax_slice(130, 5))
    before = (cuda_digest.lane_fingerprints.launches,
              cuda_digest.state_group_digests.launches)
    fp = cuda_digest.lane_fingerprints(ts)
    gd = cuda_digest.state_group_digests(ts, 32)
    assert torch.equal(fp, dg.lane_fingerprints(ts))
    assert torch.equal(gd, dg.state_group_digests(ts, 32))
    assert (cuda_digest.lane_fingerprints.launches,
            cuda_digest.state_group_digests.launches) == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cuda_digest.lane_fingerprints(ts, kernel="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cuda_digest.state_group_digests(ts, 64, kernel="cuda")
    with pytest.raises(ValueError, match="group size"):
        cuda_digest.state_group_digests(ts, 0)
    with pytest.raises(ValueError, match="group size"):
        dg.state_group_digests(ts, 0)


# ---------------------------------------------------------------------------
# the laws of tests/test_digest_kernel.py, on the port
# ---------------------------------------------------------------------------


def test_equal_lanes_equal_fingerprints_deterministic():
    s = to_port(jax_slice(96, 1))
    f1 = dg.lane_fingerprints(s)
    assert torch.equal(f1, dg.lane_fingerprints(s))
    fresh = type(s)(*(x.clone() for x in s))
    assert torch.equal(f1, dg.lane_fingerprints(fresh))


def test_mismatch_implies_lane_differs_soundness():
    a = to_port(jax_slice(256, 2))
    b = to_port(jax_slice(256, 3))
    merged = delta_ops.delta_apply(a, delta_ops.delta_extract(b, a.vv), "v2")
    gs = 64
    d_a = host(dg.state_group_digests(a, gs))
    d_m = host(dg.state_group_digests(merged, gs))
    changed = np.zeros(256, bool)
    for name in ("present", "deleted", "del_dot_actor", "del_dot_counter"):
        changed |= host(getattr(a, name)) != host(getattr(merged, name))
    assert (d_a != d_m).any()
    for g in range(d_a.size):
        assert (d_a[g] != d_m[g]) == changed[g * gs:(g + 1) * gs].any(), g


def test_ragged_group_padding_stability():
    js = jax_slice(100, 4)
    s = to_port(js)
    d1 = dg.state_group_digests(s, 64)
    assert d1.shape == (2,)
    assert torch.equal(d1, dg.group_fold(dg.lane_fingerprints(s), 64))
    assert_u32_equal(d1, pallas_state_group_digests(js, 64))
    present = s.present.clone()
    present[99] = ~present[99]
    d2 = dg.state_group_digests(s._replace(present=present), 64)
    assert d2[1] != d1[1] and d2[0] == d1[0]


def test_live_dot_divergence_is_digest_invisible():
    s = to_port(jax_slice(128, 7))
    swapped = s._replace(
        dot_actor=torch.where(s.present, (s.dot_actor + 1) % A, s.dot_actor),
        dot_counter=torch.where(s.present, s.dot_counter + 5, s.dot_counter))
    assert torch.equal(dg.state_group_digests(s, 64),
                       dg.state_group_digests(swapped, 64))


def test_lane_id_folded_in():
    s = to_port(jax_slice(8, 8, "all present"))
    same = s._replace(dot_actor=torch.ones_like(s.dot_actor),
                      dot_counter=torch.full_like(s.dot_counter, 7))
    assert len(set(dg.lane_fingerprints(same).tolist())) == 8


def test_single_lane_perturbations_never_collide_in_sweep():
    e = 64
    s = to_port(jax_slice(e, 5))
    base = int(dg.state_group_digests(s, 64)[0])
    seen = {base}
    for lane in range(0, e, 2):
        for field, delta in (("del_dot_counter", 1), ("del_dot_counter", 1000),
                             ("del_dot_counter", 3), ("del_dot_actor", 1)):
            arr = getattr(s, field).clone()
            arr[lane] += delta
            d = int(dg.state_group_digests(s._replace(**{field: arr}), 64)[0])
            assert d != base
            seen.add(d)
    assert len(seen) == 1 + (e // 2) * 4


def test_soundness_matches_the_jax_merge():
    """The merged slice of the soundness law, computed by both packages,
    digests equal at every group size (the two merges agree bitwise)."""
    a, b = jax_slice(256, 2), jax_slice(256, 3)
    merged = jax_delta_ops.delta_apply(a, jax_delta_ops.delta_extract(
        b, a.vv), "v2")
    ta, tb = to_port(a), to_port(b)
    tmerged = delta_ops.delta_apply(ta, delta_ops.delta_extract(tb, ta.vv),
                                    "v2")
    for gs in (8, 64, 128):
        assert_u32_equal(dg.state_group_digests(tmerged, gs),
                         jdg.state_group_digests(merged, gs), f"gs={gs}")
