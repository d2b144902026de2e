"""K10 with the counter bases passed in (ops/cuda_ingest.ingest_slot_rows,
the lane-sharded node's write path) against the JAX package's slot-local
mesh algebra, and the three counterparts the port added last.

The same numpy-seeded inputs go through both packages (the port on the
CPU, where the wrapper runs its plain version).  The JAX side is the
body of ``parallel/meshtarget.build_mesh_ingest`` (``_mesh_add_row`` /
``_mesh_del_row`` scanned over the rows) and of
``meshtarget2d.build_mesh2d_ingest`` (the ``base=`` override), then
``ops/delta.delta_extract`` and ``ops/compact.compact_payload``.  Every
field is compared with ``np.array_equal``, dtype included (int32 bits
read as uint32): the tolerance is exact.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_crdt_playground_tpu import config as jax_config
from go_crdt_playground_tpu.models import awset_delta as jax_awd
from go_crdt_playground_tpu.ops import compact as jax_compact
from go_crdt_playground_tpu.ops import delta as jax_delta
from go_crdt_playground_tpu.parallel import meshtarget as jmt
from go_crdt_playground_tpu.utils import codec as jax_codec
from go_crdt_playground_tpu_torch import config
from go_crdt_playground_tpu_torch.ops import cuda_ingest
from go_crdt_playground_tpu_torch.ops.compact import CompactDeltaPayload
from go_crdt_playground_tpu_torch.parallel import meshtarget
from tests.test_torch_ingest import assert_same, port_row, to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "go_crdt_playground_tpu_torch")
# own clocks: below 2^31 so the batch's counters cross it, below 2^32 so
# they wrap
CLOCKS = (0x7FFFFFF0, 0xFFFFFFF0)


def slot_row(rng, e, a, clock, actor=1):
    """One replica slice with history (foreign dots, deletion records,
    re-adds, dots its vv does not cover) and its own clock at ``clock``:
    a JAX AWSetDeltaState of [E] / [A] / [] fields."""
    present = rng.random(e) < 0.4
    deleted = rng.random(e) < 0.3
    base = 0x7FFFFFFB

    def counters(shape):
        return (rng.integers(1, 12, shape) + base).astype(np.uint32)

    vv = np.where(rng.random(a) < 0.7, counters(a), 0).astype(np.uint32)
    vv[min(actor, a - 1)] = clock
    arrays = {
        "vv": vv,
        "present": present,
        "dot_actor": np.where(present, rng.integers(0, a, e), 0),
        "dot_counter": np.where(present, counters(e), 0),
        "actor": np.uint32(actor),
        "deleted": deleted,
        "del_dot_actor": np.where(deleted, rng.integers(0, a, e), 0),
        "del_dot_counter": np.where(deleted, counters(e), 0),
        "processed": np.where(rng.random(a) < 0.5, counters(a), 0),
    }
    return jax_awd.AWSetDeltaState(**{
        k: jnp.asarray(v if k in ("present", "deleted")
                       else np.asarray(v).astype(np.uint32))
        for k, v in arrays.items()})


def slot_batch(rng, b, e, padding):
    """B op-rows on one slot's lanes with the row's global facts: the
    lanes it adds left of this slot (``lane_off``), its global add count
    (``total``: those, this slot's and some right of it) and its Del
    tick (global: a Del that selects lanes of other slots only ticks
    too).  The last ``padding`` rows are not live."""
    add = rng.random((b, e)) < 0.08
    dl = rng.random((b, e)) < 0.05
    dl[b // 2] |= add[b // 2]  # a row that deletes what it adds
    live = np.arange(b) < b - padding
    lane_off = rng.integers(5, 40, b).astype(np.uint32)
    right = rng.integers(5, 40, b).astype(np.uint32)
    total = (lane_off + (add & live[:, None]).sum(axis=1) + right).astype(
        np.uint32)
    tick = ((dl & live[:, None]).any(axis=1) | (rng.random(b) < 0.3))
    return add, dl, live, lane_off, total, tick.astype(np.uint32)


def jax_slot_fold(jrow, add, dl, live, lane_off, total, tick, k):
    """``build_mesh_ingest``'s body on one slot: the rows scanned with
    ``_mesh_add_row`` / ``_mesh_del_row`` (padding rows masked), then the
    δ against the pre-batch vv and, with k > 0, its fixed-K form."""
    pre_vv = jrow.vv

    def step(s, x):
        add_row, del_row, is_live, base, a_tot, d_tick = x
        s = jmt._mesh_add_row(s, add_row & is_live,
                              jnp.where(is_live, base, 0),
                              jnp.where(is_live, a_tot, 0))
        s = jmt._mesh_del_row(s, del_row & is_live,
                              jnp.where(is_live, d_tick, 0))
        return s, None

    merged, _ = jax.lax.scan(step, jrow, tuple(jnp.asarray(x) for x in (
        add, dl, live, lane_off, total, tick)))
    payload = jax_delta.delta_extract(merged, pre_vv)
    return merged, payload, (jax_compact.compact_payload(payload, k, k)
                             if k else None)


def port_bases(c0, live, lane_off, total, tick):
    """The 1-D node's counters for the same rows: each live row's
    pre-row counter (the clock plus the steps of the rows before it), its
    deletion counter and the final clock, as int64 (not reduced)."""
    steps = np.where(live, total.astype(np.int64) + tick, 0)
    row_base = c0 + np.cumsum(steps) - steps
    return (row_base, np.where(live, lane_off, 0), row_base + steps,
            c0 + steps.sum())


def check_fold(want, got, k):
    assert_same(want[0], got[0], "state")
    assert_same(want[1], got[1], "payload")
    if k:
        assert_same(want[2], got[2], "compact")
    else:
        assert got[2] is None


@pytest.mark.parametrize("clock", CLOCKS)
@pytest.mark.parametrize("b", [1, 7, 33])
@pytest.mark.parametrize("a", [3, 16])
@pytest.mark.parametrize("e", [64, 4100])
def test_slot_rows_plain_matches_the_jax_mesh_algebra(e, a, b, clock):
    """E_loc in {64, 4,100} x A in {3, 16} x B in {1, 7, 33}, nonzero
    lane offsets, padding rows, own clocks whose counters cross 2^31 or
    wrap 2^32; K = 32 and K = 0."""
    rng = np.random.default_rng(e + 7 * a + 31 * b + (clock >> 28))
    jrow = slot_row(rng, e, a, clock)
    add, dl, live, lane_off, total, tick = slot_batch(
        rng, b, e, padding=b // 4)
    row_base, offs, del_ctr, final = port_bases(clock, live, lane_off,
                                                total, tick)
    assert final > (0x80000000 if clock < 0x80000000 else 0xFFFFFFFF)
    for k in (32, 0):
        want = jax_slot_fold(jrow, add, dl, live, lane_off, total, tick, k)
        got = cuda_ingest.ingest_slot_rows(
            port_row(jrow), add, dl, live, row_base, offs, del_ctr, final,
            k_changed=k, k_deleted=k)
        check_fold(want, got, k)


@pytest.mark.parametrize("clock", CLOCKS)
def test_stripe_with_absolute_bases_matches_the_jax_2d_body(clock):
    """``build_mesh2d_ingest``'s body on one (dp, mp) slot: the stripe's
    rows interleaved with other stripes' in the chunk's order (absolute
    prefixes with gaps), padding rows at the end-of-chunk prefix, the
    final clock the stripe's last deletion counter."""
    rng = np.random.default_rng(11 + (clock >> 28))
    e, a, cap, n_chunk = 4100, 16, 9, 20
    jrow = slot_row(rng, e, a, clock)
    # the chunk's rows in global order; this stripe owns some of them
    _, _, _, g_off, g_total, g_tick = slot_batch(rng, n_chunk, e, 0)
    steps = g_total.astype(np.int64) + g_tick
    g_prefix = np.cumsum(steps) - steps
    mine = np.sort(rng.choice(n_chunk, cap - 3, replace=False))
    used = np.arange(cap) < mine.size
    add, dl, _, _, _, _ = slot_batch(rng, cap, e, 0)
    add[~used] = dl[~used] = False
    prefix = np.full(cap, steps.sum(), np.int64)
    lane_off = np.zeros(cap, np.uint32)
    total = np.zeros(cap, np.uint32)
    tick = np.zeros(cap, np.uint32)
    prefix[used] = g_prefix[mine]
    lane_off[used] = g_off[mine]
    total[used] = g_off[mine] + add[used].sum(axis=1) + 7
    tick[used] = dl[used].any(axis=1) | (rng.random(used.sum()) < 0.5)

    pre_ctr = jrow.vv[jrow.actor.astype(jnp.int32)]

    def step(s, x):
        add_row, del_row, pre, base_off, a_tot, d_tick = x
        s = jmt._mesh_add_row(s, add_row, base_off, a_tot,
                              base=pre_ctr + pre)
        s = jmt._mesh_del_row(s, del_row, d_tick,
                              base=pre_ctr + pre + a_tot)
        return s, None

    merged, _ = jax.lax.scan(step, jrow, tuple(jnp.asarray(x) for x in (
        add, dl, prefix.astype(np.uint32), lane_off, total, tick)))
    want = (merged, jax_delta.delta_extract(merged, jrow.vv))
    row_base = clock + prefix
    del_ctr = row_base + total + tick
    got = cuda_ingest.ingest_slot_rows(
        port_row(jrow), add, dl, used, row_base, lane_off, del_ctr,
        del_ctr[-1], k_changed=0, k_deleted=0)
    assert got[2] is None
    assert_same(want[0], got[0], "state")
    assert_same(want[1], got[1], "payload")
    assert int(np.asarray(merged.vv)[1]) == (clock + steps.sum()) % 2**32


@pytest.mark.parametrize("actor", [1, 19])
@pytest.mark.parametrize("k", [0, 8, 128])
@pytest.mark.parametrize("e,b", [(64, 7), (4100, 33), (300, 0)])
def test_one_slot_equals_the_fused_entry(e, b, k, actor):
    """One slot (lane_off = 0, the bases from ``row_counters``): the
    based entry's plain version equals ``ingest_rows_delta_fused``'s,
    compact form included (K = 8 overflows); with an own actor id >= A
    (19 of 16) the bases count from the clipped slot and no clock is
    written."""
    rng = np.random.default_rng(e + b + k)
    row = port_row(slot_row(rng, e, 16, CLOCKS[b % 2], actor=actor))
    add = torch.from_numpy(rng.random((b, e)) < 0.05)
    dl = torch.from_numpy(rng.random((b, e)) < 0.03)
    live = torch.from_numpy(np.arange(b) % 5 != 3)
    arow, drow, _, del_ctr, final = cuda_ingest.row_counters(row, add, dl,
                                                             live)
    steps = arow.sum(dim=1) + drow.any(dim=1)
    row_base = del_ctr.to(torch.int64) - steps
    want = cuda_ingest.ingest_rows_delta_fused(row, add, dl, live,
                                               k_changed=k, k_deleted=k)
    got = cuda_ingest.ingest_slot_rows(
        row, add, dl, live, row_base, torch.zeros(b, dtype=torch.int64),
        del_ctr, final, k_changed=k, k_deleted=k)
    for w, g in zip(want, got):
        if w is None:
            assert g is None
            continue
        for name, x, y in zip(w._fields, w, g):
            assert x.dtype == y.dtype and torch.equal(x, y), name
    if actor >= 16:
        assert torch.equal(got[0].vv, row.vv)


def test_slot_rows_guards():
    rng = np.random.default_rng(3)
    row = port_row(slot_row(rng, 16, 4, 5))
    add = np.zeros((2, 16), bool)
    live = np.ones(2, bool)
    with pytest.raises(ValueError, match="row_base holds 3"):
        cuda_ingest.ingest_slot_rows(row, add, add, live, [1, 2, 3],
                                     [0, 0], [1, 2], 3, k_changed=0,
                                     k_deleted=0)
    for a, lv in ((add[:, :8], live), (add, live[:1])):
        with pytest.raises(ValueError, match="do not match"):
            cuda_ingest.ingest_slot_rows(row, a, a, lv, [1, 2], [0, 0],
                                         [1, 2], 3, k_changed=0,
                                         k_deleted=0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cuda_ingest.ingest_slot_rows(row, add, add, live, [1, 2], [0, 0],
                                     [1, 2], 3, k_changed=0, k_deleted=0,
                                     kernel="cuda")


def _mesh_nodes(tmp_path, e, k):
    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.parallel.meshtarget2d import \
        Mesh2DApplyTarget
    from go_crdt_playground_tpu_torch.utils.wal import DeltaWal

    nodes = {
        "one": Node(0, e, 4, device="cpu",
                    wal=DeltaWal(str(tmp_path / "one"))),
        "4": meshtarget.MeshApplyTarget(
            0, e, 4, mesh_devices=4, device="cpu",
            wal=DeltaWal(str(tmp_path / "m4"))),
        "2x2": Mesh2DApplyTarget(0, e, 4, mesh_shape="2x2", device="cpu",
                                 wal=DeltaWal(str(tmp_path / "m22"))),
    }
    for n in nodes.values():  # the CUDA regime: K10 compacts to K
        n._fused_regime = (cuda_ingest.ingest_rows_delta_fused, k)
    return nodes


def test_mesh_nodes_fold_once_a_slot_and_log_the_one_slot_records(
        tmp_path, monkeypatch):
    """Each slot of the 1-D node folds a batch in one call of the based
    entry (n a batch), each stripe slot of the 2-D node one a chunk (dp x
    mp), no plain fold is called outside it, and the records equal the
    one-slot node's: below K, where no slot holds K lanes but the slots
    together claim more, and where one slot alone claims more (the record
    is then the dense δ's)."""
    e, b, k = 256, 8, 24
    nodes = _mesh_nodes(tmp_path, e, k)
    calls = []
    based = cuda_ingest.ingest_slot_rows
    monkeypatch.setattr(cuda_ingest, "ingest_slot_rows",
                        lambda *a, **kw: (calls.append(kw["k_changed"]),
                                          based(*a, **kw))[1])
    rng = np.random.default_rng(21)
    band = e // b
    # claimed lanes a slot: 4 / 16 / 40 in all, then 30 in slot 0 or 2
    # alone
    plan = ((1,) * 4, (4,) * 4, (10,) * 4, (30, 1, 1, 1), (1, 1, 30, 1))
    for per_slot in plan:
        add = np.zeros((b, e), bool)
        for s in range(4):  # rows 2s, 2s + 1 write slot s's lanes only
            lanes = s * 64 + rng.choice(64, per_slot[s], replace=False)
            add[2 * s, lanes] = True
        dl = np.zeros((b, e), bool)
        dl[1, 3 * band] = True
        for name, n in nodes.items():
            calls.clear()
            n.ingest_batch(add, dl, np.ones(b, bool))
            assert calls == {"one": [], "4": [k] * 4,
                             "2x2": [0] * 4}[name], name
    recs = {name: [bytes(r) for r in n.wal.records()]
            for name, n in nodes.items()}
    assert len(recs["one"]) == len(plan)
    assert recs["4"] == recs["one"] and recs["2x2"] == recs["one"]
    for n in nodes.values():
        n.wal.close()


def test_tile_scratch_tags_each_call_and_is_zeroed_once(monkeypatch):
    """The based entry's look-back scratch (csrc/ingest.cu ingest_tiles):
    one buffer a device and stream, zeroed when made or grown, a new tag
    each call; past the last tag a new zeroed buffer; none wanted, none
    made."""
    monkeypatch.setattr(cuda_ingest, "_scratch", {})
    dev = torch.device("cpu")
    assert cuda_ingest._tile_scratch(dev, 7, 0) == (None, 0)
    assert cuda_ingest._scratch == {}
    got = [cuda_ingest._tile_scratch(dev, 7, 1000) for _ in range(3)]
    assert [tag for _, tag in got] == [1, 2, 3]
    assert len({ptr for ptr, _ in got}) == 1
    buf = cuda_ingest._scratch[(None, 7)][0]
    assert buf.numel() >= 1000 and not buf.any()
    assert cuda_ingest._tile_scratch(dev, 8, 1000)[1] == 1  # another stream
    ptr, tag = cuda_ingest._tile_scratch(dev, 7, 5000)  # grown, zeroed
    grown = cuda_ingest._scratch[(None, 7)][0]
    assert tag == 1 and grown.numel() >= 5000 and not grown.any()
    assert ptr == grown.data_ptr()
    assert cuda_ingest._tile_scratch(dev, 7, 1000)[1] == 2  # kept
    cuda_ingest._scratch[(None, 7)][1] = cuda_ingest._TAG_END - 1
    ptr, tag = cuda_ingest._tile_scratch(dev, 7, 1000)
    assert tag == 1 and cuda_ingest._scratch[(None, 7)][0] is not grown


def test_ep_ring_round_on_k2_matches_the_plain_round():
    """The EP round merges on the gathered vv through K2's wrapper: on
    the CPU with ``kernel="torch"`` and ``"auto"`` the same state."""
    from go_crdt_playground_tpu_torch import fleet
    from go_crdt_playground_tpu_torch.parallel import gossip
    from go_crdt_playground_tpu_torch.parallel import mesh as mesh_mod

    m = mesh_mod.make_mesh((2, 2), devices=["cpu"] * 4)
    st = fleet.demo_state(4, 32, device="cpu")
    a = gossip.ep_ring_round_shardmap(st, m)
    b = gossip.ep_ring_round_shardmap(st, m, kernel="torch")
    for x, y in zip(mesh_mod.gather_state(a), mesh_mod.gather_state(b)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="kernel must be one of"):
        gossip.ep_ring_round_shardmap(st, m, kernel="pallas")


def _plain_calls(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            if name.endswith("_plain"):
                yield node.lineno, name


def test_no_plain_version_is_called_outside_the_kernel_modules():
    """A kernel's plain version runs only behind its wrapper, which takes
    it for a CPU tensor or ``kernel="torch"``: no module of the port
    outside ``ops/cuda_*.py`` calls a ``*_plain`` function."""
    found, scanned = [], 0
    for root, _, files in os.walk(PKG):
        for name in files:
            path = os.path.join(root, name)
            rel = os.path.relpath(path, PKG)
            if not name.endswith(".py") or (
                    rel.startswith("ops" + os.sep + "cuda_")):
                continue
            scanned += 1
            found += [(rel, line, fn) for line, fn in _plain_calls(path)]
    assert scanned > 80 and not found, found
    inside = [fn for name in ("cuda_ingest", "cuda_merge")
              for _, fn in _plain_calls(os.path.join(PKG, "ops",
                                                     name + ".py"))]
    assert "ingest_slot_rows_plain" in inside
    assert "merge_rows_plain" in inside


def test_config_counterparts_match_the_jax_config():
    """``Config.element_dict`` and ``Config.make_mesh`` against the JAX
    package's (the JAX mesh over that many of its CPU devices)."""
    jcfg = jax_config.Config(num_elements=8, mesh_shape=(2, 2))
    cfg = config.Config(num_elements=8, mesh_shape=(2, 2))
    jd = jcfg.element_dict(["x", "y"])
    d = cfg.element_dict(["x", "y"])
    assert isinstance(jd, jax_codec.ElementDict)
    assert d.capacity == jd.capacity == 8
    assert [d.encode(v) for v in ("y", "z", "x")] == \
        [jd.encode(v) for v in ("y", "z", "x")]
    assert d.state_dict() == jd.state_dict()
    assert config.Config().element_dict().capacity == 16
    jm = jcfg.make_mesh(jax.devices()[:4])
    m = cfg.make_mesh(device="cpu")
    assert dict(m.shape) == dict(jm.shape)
    assert m.axis_names == tuple(jm.axis_names)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert dict(config.Config().make_mesh(device="cpu").shape) == {
        "replica": 1, "element": 1}
    with pytest.raises(ValueError, match="mesh_shape"):
        cfg.make_mesh(devices=["cpu"] * 3)


def test_compact_payload_nbytes_wire_matches_jax():
    rng = np.random.default_rng(4)
    jrow = slot_row(rng, 128, 6, 40)
    payload = jax_delta.delta_extract(jrow, jnp.zeros(6, jnp.uint32))
    for k in (1, 16, 200):
        jc = jax_compact.compact_payload(payload, k, k)
        pc = to_port(jc, CompactDeltaPayload)
        assert pc.nbytes_wire() == jc.nbytes_wire()
        assert pc.nbytes_wire() == 2 * 4 * 6 + k * 2 * (4 + 1 + 4 + 4) + 5
