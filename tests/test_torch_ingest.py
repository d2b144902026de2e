"""The port's serving write path (ops/ingest.py, the K10 plain version in
ops/cuda_ingest.py, ops/delta.py, ops/compact.py) against the JAX
package, bitwise.

The same numpy-seeded inputs go through both packages (the port on the
CPU); every output field is compared with ``np.array_equal``, dtype
included, so the tolerance is exact.  Two regimes, as the node picks
them: the CPU arm (plain ``ingest_rows_delta``, K = 0) against the XLA
``ops/ingest.ingest_rows_delta``, and the CUDA arm (K10's plain version,
K = min(128, E)) against ``pallas_ingest_rows_delta`` in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_crdt_playground_tpu.ops import compact as jax_compact
from go_crdt_playground_tpu.ops import delta as jax_delta_ops
from go_crdt_playground_tpu.ops import ingest as jax_ingest
from go_crdt_playground_tpu.ops.pallas_ingest import pallas_ingest_rows_delta
from go_crdt_playground_tpu_torch._u32 import from_numpy_u32
from go_crdt_playground_tpu_torch.models.awset_delta import AWSetDeltaState
from go_crdt_playground_tpu_torch.ops import compact, cuda_ingest, delta
from go_crdt_playground_tpu_torch.ops import ingest
from tests.test_ingest_fused import A, CASES, E, _batch, _seeded_row

MODES = [("v2", True), ("reference", True), ("reference", False)]


def to_port(jax_tuple, cls=None):
    """A JAX NamedTuple of arrays (a replica slice, payload or compact
    form) -> the port's NamedTuple of CPU tensors, bit for bit."""
    cls = cls or type(jax_tuple)
    fields = []
    for x in jax_tuple:
        a = np.asarray(x)
        fields.append(torch.from_numpy(a.copy()) if a.dtype == bool
                      else from_numpy_u32(a, "cpu"))
    return cls(*fields)


def assert_same(want, got, ctx=""):
    """Every field of the JAX tuple and the port's tuple bitwise equal,
    uint32 against the int32 bits, dtype included."""
    assert want._fields == got._fields, ctx
    for name, w, g in zip(want._fields, want, got):
        w = np.asarray(w)
        g = g.numpy()
        if g.dtype != bool:
            g = g.view(np.uint32)
        assert g.dtype == w.dtype, f"{ctx}:{name} dtype {g.dtype}/{w.dtype}"
        assert g.shape == w.shape, f"{ctx}:{name} shape"
        assert np.array_equal(g, w), f"{ctx}:{name}"


def port_row(jrow):
    return to_port(jrow, AWSetDeltaState)


def _lift(jrow, base):
    """Every nonzero counter of a slice moved by one offset (uint32,
    wrapping) that puts the replica's own clock at ``base``: with base
    0x7FFFFFF0 or 0xFFFFFFF0 the batch's prefix sums cross 2^31 or wrap
    at 2^32."""
    own = int(np.asarray(jrow.vv)[int(jrow.actor)])
    off = jnp.uint32((base - own) % (1 << 32))

    def up(x):
        return jnp.where(x > 0, x + off, x)

    return jrow._replace(vv=up(jrow.vv), dot_counter=up(jrow.dot_counter),
                         del_dot_counter=up(jrow.del_dot_counter),
                         processed=up(jrow.processed))


def _row(seed, base=0):
    jrow = _seeded_row(seed)
    return _lift(jrow, base) if base else jrow


# -- the CPU arm: plain ingest_rows_delta vs the XLA path ---------------------


@pytest.mark.parametrize("b,density,live_pattern", CASES)
@pytest.mark.parametrize("base", [0, 0x7FFFFFF0, 0xFFFFFFF0])
def test_plain_ingest_matches_xla(b, density, live_pattern, base):
    jrow = _row(11, base)
    add, dl, live = _batch(29 + b, b, density, live_pattern)
    want = jax_ingest.ingest_rows_delta(
        jrow, jnp.asarray(add), jnp.asarray(dl), jnp.asarray(live),
        k_changed=0, k_deleted=0)
    got = ingest.ingest_rows_delta(port_row(jrow), add, dl, live,
                                   k_changed=0, k_deleted=0)
    assert want[2] is None and got[2] is None
    assert_same(want[0], got[0], "state")
    assert_same(want[1], got[1], "payload")
    # ingest_rows alone is the same fold
    assert_same(want[0], ingest.ingest_rows(
        port_row(jrow), torch.from_numpy(add), torch.from_numpy(dl),
        torch.from_numpy(live)), "ingest_rows")


def test_cpu_regime_is_the_plain_path_with_host_compaction():
    assert ingest.ingest_delta_regime(E, "cpu") == (
        ingest.ingest_rows_delta, 0)
    fn, k = ingest.ingest_delta_regime(E, torch.device("cuda"))
    assert fn is cuda_ingest.ingest_rows_delta_fused and k == E
    assert ingest.ingest_delta_regime(4096, "cuda")[1] == \
        ingest.WAL_COMPACT_K == 128


# -- the CUDA arm: K10's plain version vs the Pallas kernel -------------------


@pytest.mark.parametrize("b,density,live_pattern", CASES)
@pytest.mark.parametrize("k", [min(ingest.WAL_COMPACT_K, E), 16])
def test_k10_plain_matches_pallas(b, density, live_pattern, k):
    """All 12 lane outputs, vv/processed and the compact form; K = 16
    overflows on the dense case."""
    jrow = _row(11)
    add, dl, live = _batch(29 + b, b, density, live_pattern)
    want = pallas_ingest_rows_delta(
        jrow, jnp.asarray(add), jnp.asarray(dl), jnp.asarray(live),
        k_changed=k, k_deleted=k, interpret=True)
    got = cuda_ingest.ingest_rows_delta_fused(
        port_row(jrow), add, dl, live, k_changed=k, k_deleted=k)
    assert_same(want[0], got[0], "state")
    assert_same(want[1], got[1], "payload")
    assert_same(want[2], got[2], "compact")


@pytest.mark.parametrize("base", [0x7FFFFFF0, 0xFFFFFFF0])
@pytest.mark.parametrize("b,density", [(8, 0.15), (4, 0.9)])
def test_k10_plain_counters_cross_2_31_and_wrap(base, b, density):
    jrow = _row(23, base)
    vv0 = int(np.asarray(jrow.vv)[2])
    add, dl, live = _batch(41 + b, b, density, "all")
    steps = int(add.sum()) + int(dl.any(axis=1).sum())
    assert vv0 == base
    assert vv0 + steps > (0x80000000 if base < 0x80000000 else 0xFFFFFFFF)
    want = pallas_ingest_rows_delta(
        jrow, jnp.asarray(add), jnp.asarray(dl), jnp.asarray(live),
        k_changed=E, k_deleted=E, interpret=True)
    got = cuda_ingest.ingest_rows_delta_fused(
        port_row(jrow), add, dl, live, k_changed=E, k_deleted=E)
    for w, g, what in zip(want, got, ("state", "payload", "compact")):
        assert_same(w, g, what)


def test_k10_plain_at_the_serve_shape():
    """E = 1,024, A = 16, B = 32 with padding rows, K = 128: the shape
    ``serve --ingest`` runs (one replica with history first)."""
    from go_crdt_playground_tpu.models import awset_delta as jax_awd

    e, a = 1024, 16
    rng = np.random.default_rng(7)
    jrow = jax.tree.map(lambda x: x[0], jax_awd.init(
        1, e, a, actors=np.asarray([3], np.uint32)))
    jrow = jax_ingest.ingest_rows(
        jrow, jnp.asarray(rng.random((4, e)) < 0.05),
        jnp.asarray(rng.random((4, e)) < 0.005), jnp.ones(4, bool))
    add = np.zeros((32, e), bool)
    for i in range(24):
        add[i, rng.integers(0, e, 1 + 3 * (i % 2))] = True
    dl = np.zeros((32, e), bool)
    dl[np.arange(0, 24, 5), rng.integers(0, e, 5)] = True
    live = np.arange(32) < 24
    want = pallas_ingest_rows_delta(
        jrow, jnp.asarray(add), jnp.asarray(dl), jnp.asarray(live),
        k_changed=128, k_deleted=128, interpret=True)
    got = cuda_ingest.ingest_rows_delta_fused(
        port_row(jrow), add, dl, live, k_changed=128, k_deleted=128)
    for w, g, what in zip(want, got, ("state", "payload", "compact")):
        assert_same(w, g, what)
    assert not bool(got[2].overflow)


def test_both_arms_ship_uncovered_preexisting_lanes():
    """The δ against the pre-batch vv carries a pre-existing lane whose
    dot that vv does not cover (tests/test_ingest_fused.py:129)."""
    jrow = _seeded_row(19)
    jrow = jrow._replace(
        present=jrow.present.at[7].set(True),
        dot_actor=jrow.dot_actor.at[7].set(jnp.uint32(4)),
        dot_counter=jrow.dot_counter.at[7].set(jnp.uint32(90)))
    add = np.zeros((2, E), bool)
    add[0, 3] = True
    dl = np.zeros((2, E), bool)
    live = np.ones(2, bool)
    want = jax_ingest.ingest_rows_delta(
        jrow, jnp.asarray(add), jnp.asarray(dl), jnp.asarray(live),
        k_changed=16, k_deleted=16)
    assert bool(np.asarray(want[1].changed)[7])
    for fn in (ingest.ingest_rows_delta,
               cuda_ingest.ingest_rows_delta_fused):
        got = fn(port_row(jrow), add, dl, live, k_changed=16, k_deleted=16)
        for w, g, what in zip(want, got, ("state", "payload", "compact")):
            assert_same(w, g, f"{fn.__name__} {what}")


def test_k10_wrapper_guards():
    row = port_row(_seeded_row(3))
    add = np.zeros((2, E), bool)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cuda_ingest.ingest_rows_delta_fused(
            row, add, add, np.ones(2, bool), k_changed=8, k_deleted=8,
            kernel="cuda")
    with pytest.raises(ValueError, match="do not match"):
        cuda_ingest.ingest_rows_delta_fused(
            row, add, add[:, :5], np.ones(2, bool), k_changed=8,
            k_deleted=8)
    with pytest.raises(ValueError, match="do not match"):
        cuda_ingest.ingest_rows_delta_fused(
            row, add, add, np.ones(3, bool), k_changed=8, k_deleted=8)
    # any actor axis A >= 1 reaches the kernel (past the card's shared
    # memory it reads the vv from device memory)
    for num_a in (2049, 60000):
        cuda_ingest.check_slice(row._replace(
            vv=torch.zeros(num_a, dtype=torch.int32),
            processed=torch.zeros(num_a, dtype=torch.int32)))
    with pytest.raises(ValueError, match="A >= 1"):
        cuda_ingest.check_slice(row._replace(
            vv=torch.zeros(0, dtype=torch.int32),
            processed=torch.zeros(0, dtype=torch.int32)))
    before = cuda_ingest.ingest_rows_delta_fused.launches
    cuda_ingest.ingest_rows_delta_fused(row, add, add, np.ones(2, bool),
                                        k_changed=0, k_deleted=0)
    assert cuda_ingest.ingest_rows_delta_fused.launches == before, \
        "the plain version must not count as a launch"


# -- payloads, compaction and GC ----------------------------------------------


def _pair(seed):
    """Two slices with history, of two actors, and the δ of the second
    against the first's vv."""
    d = _seeded_row(seed)
    s = _seeded_row(seed + 100)
    s = s._replace(actor=jnp.uint32(3))
    return d, s


@pytest.mark.parametrize("sem,strict", MODES)
@pytest.mark.parametrize("seed", [1, 2])
def test_delta_extract_and_apply_match(seed, sem, strict):
    d, s = _pair(seed)
    jp = jax_delta_ops.delta_extract(s, d.vv)
    tp = delta.delta_extract(port_row(s), port_row(d).vv)
    assert_same(jp, tp, "extract")
    assert_same(jax_delta_ops.delta_apply(d, jp, sem, strict),
                delta.delta_apply(port_row(d), tp, sem, strict), "apply")
    empty = jax_delta_ops.delta_extract(d, d.vv)
    assert_same(jax_delta_ops.delta_apply(d, empty, sem, strict),
                delta.delta_apply(port_row(d), to_port(
                    empty, delta.DeltaPayload), sem, strict), "empty δ")


@pytest.mark.parametrize("sem", ["v2", "reference"])
def test_full_merge_delta_and_slice_apply_match(sem):
    d, s = _pair(5)
    assert_same(jax_delta_ops.full_merge_delta(d, s, sem),
                delta.full_merge_delta(port_row(d), port_row(s), sem))
    jp = jax_delta_ops.delta_extract(s, jnp.zeros(A, jnp.uint32))
    mask = np.random.default_rng(5).random(E) < 0.5
    jp = jp._replace(changed=jp.changed & mask, deleted=jp.deleted & mask)
    assert_same(jax_delta_ops.slice_apply(d, jp),
                delta.slice_apply(port_row(d), to_port(jp)))


def test_delta_apply_rejects_unknown_semantics():
    d, s = _pair(6)
    p = delta.delta_extract(port_row(s), port_row(d).vv)
    with pytest.raises(ValueError, match="unknown delta_semantics"):
        delta.delta_apply(port_row(d), p, "v3")


@pytest.mark.parametrize("k", [0, 1, 4, 16, E])
def test_compact_and_expand_match(k):
    d, s = _pair(8)
    jp = jax_delta_ops.delta_extract(s, jnp.zeros(A, jnp.uint32))
    jc = jax_compact.compact_payload(jp, k, k)
    tc = compact.compact_payload(to_port(jp), k, k)
    assert_same(jc, tc, "compact")
    assert_same(jax_compact.expand_payload(jc, E),
                compact.expand_payload(tc, E), "expand")


def test_gc_frontier_and_apply_match():
    from tests.test_torch_models import assert_same as assert_state
    from tests.test_torch_models import scenario, to_torch

    st = scenario(9, 6, 40, 6)
    for part in (None, np.asarray([True, False, True, True, False, True])):
        jf = jax_delta_ops.gc_frontier(
            st.processed, None if part is None else jnp.asarray(part))
        tf = delta.gc_frontier(to_torch(st).processed,
                               None if part is None else torch.from_numpy(part))
        assert np.array_equal(tf.numpy().view(np.uint32), np.asarray(jf))
        assert_state(jax_delta_ops.gc_apply(st, jf),
                     delta.gc_apply(to_torch(st), tf))
    # a frontier that covers every record drops the whole log
    top = jnp.full(6, 0xFFFFFFFF, jnp.uint32)
    gone = delta.gc_apply(to_torch(st), from_numpy_u32(np.asarray(top), "cpu"))
    assert not bool(gone.deleted.any())
    assert_state(jax_delta_ops.gc_apply(st, top), gone)
