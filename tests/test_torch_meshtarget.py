"""The port's mesh serving targets (parallel/meshtarget.py,
meshtarget2d.py) against the JAX package's mesh nodes and the port's
one-device node: every scenario of tests/test_meshtarget.py.  The port's
slots share the CPU; the JAX nodes run on the 8 forced CPU devices.
States are compared field by field (``np.array_equal``, dtype
included), WAL records, slice payloads and summaries byte for byte."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from go_crdt_playground_tpu.net.peer import Node as JaxNode
from go_crdt_playground_tpu.ops import digest as jax_digest
from go_crdt_playground_tpu.parallel import meshtarget as jmt
from go_crdt_playground_tpu.parallel import meshtarget2d as jmt2
from go_crdt_playground_tpu.utils.checkpoint import \
    CheckpointStore as JaxStore
from go_crdt_playground_tpu.utils.wal import DeltaWal as JaxWal
from go_crdt_playground_tpu_torch.net import digestsync
from go_crdt_playground_tpu_torch.net.peer import Node
from go_crdt_playground_tpu_torch.ops import cuda_digest
from go_crdt_playground_tpu_torch.ops import digest as digest_ops
from go_crdt_playground_tpu_torch.parallel.meshtarget import (
    BATCH_AXIS, MeshApplyTarget, make_batch_mesh)
from go_crdt_playground_tpu_torch.parallel.meshtarget2d import (
    DP_AXIS, MP_AXIS, Mesh2DApplyTarget, parse_mesh_spec, plan_stripes)
from go_crdt_playground_tpu_torch.utils.checkpoint import CheckpointStore
from go_crdt_playground_tpu_torch.utils.wal import DeltaWal
from tests.test_torch_ingest import assert_same
from tests.test_torch_net import prompt_jax_close  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, A, B = 1024, 4, 8


def _random_batches(rng, n, e=E, add_p=0.01, del_p=0.005):
    for _ in range(n):
        yield (rng.random((B, e)) < add_p,
               rng.random((B, e)) < del_p,
               rng.random(B) < 0.85)


def _disjoint_batches(rng, n, e=E, bands=B, keys=4):
    """Key-disjoint op batches (row b draws only from its own band): the
    striping planner packs them with zero cuts."""
    band = e // bands
    for _ in range(n):
        add = np.zeros((B, e), bool)
        dl = np.zeros((B, e), bool)
        for b in range(B):
            lanes = b * band + rng.choice(band, size=keys, replace=False)
            add[b, lanes[:keys - 1]] = True
            dl[b, lanes[keys - 1:]] = True
        yield add, dl, np.ones(B, bool)


def _mesh(actor, e=E, n=2, **kw):
    return MeshApplyTarget(actor, e, A, mesh_devices=n, device="cpu", **kw)


def _mesh2d(actor, shape, e=E, **kw):
    return Mesh2DApplyTarget(actor, e, A, mesh_shape=shape, device="cpu",
                             **kw)


def _plain(actor, e=E, **kw):
    return Node(actor, e, A, device="cpu", **kw)


def _port_same(a, b, ctx=""):
    for name, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{ctx}:{name}"


def _records(node):
    with node._lock:
        return list(node.wal.records())


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------


def test_make_batch_mesh_shapes_and_bounds(monkeypatch):
    assert make_batch_mesh(1, "cpu").shape[BATCH_AXIS] == 1
    assert make_batch_mesh(4, "cpu").shape[BATCH_AXIS] == 4
    assert make_batch_mesh(None, "cpu").shape[BATCH_AXIS] == 1
    with pytest.raises(ValueError):
        make_batch_mesh(0, "cpu")
    # the default wants distinct cards (one, as far as torch can tell)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="mesh wants 2 devices; 1 visible"):
        make_batch_mesh(2)
    monkeypatch.undo()
    with pytest.raises(ValueError):
        _mesh(0, e=1023)


def test_state_actually_sharded():
    node = _mesh(0, n=4)
    slots = node._slots
    assert slots.shape == (4,)
    for m in range(4):
        assert slots[(m,)].present.shape == (1, E // 4)
        assert slots[(m,)].vv.shape == (1, A)
    assert len({slots[(m,)].present.data_ptr() for m in range(4)}) == 4


# ---------------------------------------------------------------------------
# bitwise parity against the JAX mesh node and the one-device node
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("devices", [1, 2, 4, 8])
def test_ingest_bitwise_parity(devices):
    rng = np.random.default_rng(11)
    plain = _plain(0)
    mesh = _mesh(0, n=devices)
    jax_mesh = jmt.MeshApplyTarget(0, E, A, mesh_devices=devices)
    for add, dl, live in _random_batches(rng, 5):
        for n in (plain, mesh, jax_mesh):
            n.ingest_batch(add, dl, live)
    _port_same(plain.state_slice(), mesh.state_slice(), f"{devices}")
    assert_same(jax_mesh.state_slice(), mesh.state_slice(), f"{devices}")


def test_wal_records_bitwise_identical(tmp_path):
    from go_crdt_playground_tpu_torch.obs import Recorder

    rng = np.random.default_rng(12)
    plain = _plain(0, wal=DeltaWal(str(tmp_path / "wp")))
    mesh = _mesh(0, n=8, wal=DeltaWal(str(tmp_path / "wm")))
    jax_mesh = jmt.MeshApplyTarget(0, E, A, mesh_devices=8,
                                   wal=JaxWal(str(tmp_path / "wj")))
    for add, dl, live in _random_batches(rng, 4, add_p=0.02):
        for n in (plain, mesh, jax_mesh):
            n.ingest_batch(add, dl, live)
    rp, rm, rj = _records(plain), _records(mesh), _records(jax_mesh)
    assert rp == rm == rj and len(rm) == 4
    rec = Recorder()
    m2 = _mesh(0, n=8, recorder=rec, wal=DeltaWal(str(tmp_path / "w2")))
    add, dl, live = next(_random_batches(rng, 1))
    m2.ingest_batch(add, dl, live)
    assert rec.snapshot()["counters"]["ingest.dispatches"] == 1


def test_cuda_regime_mesh_records_match_the_one_slot_node(tmp_path):
    """In the CUDA regime (K = min(128, E): a node compacts its δ on the
    device) the mesh nodes compact each slot's part and merge the forms,
    and their WAL records equal a one-slot node's in that regime, byte
    for byte: below K, in the window where the host's break-even would
    pick the dense form, and past K (the fallback), through the plain
    arithmetic on the CPU."""
    from go_crdt_playground_tpu_torch.ops import cuda_ingest, ingest

    e = 256
    k = min(ingest.WAL_COMPACT_K, e)
    nodes = {
        "one": _plain(0, e=e, wal=DeltaWal(str(tmp_path / "one"))),
        "1d": _mesh(0, e=e, n=4, wal=DeltaWal(str(tmp_path / "m1"))),
        "2x2": _mesh2d(0, "2x2", e=e, wal=DeltaWal(str(tmp_path / "m22"))),
    }
    for n in nodes.values():
        n._fused_regime = (cuda_ingest.ingest_rows_delta_fused, k)
    rng = np.random.default_rng(33)
    band = e // B
    for p_add, p_del in ((0.01, 0.005), (0.05, 0.02), (0.3, 0.1),
                         (0.02, 0.01), (0.9, 0.05)):
        add = np.zeros((B, e), bool)
        dl = np.zeros((B, e), bool)
        for b in range(B):  # key-disjoint rows: one record a batch
            lanes = slice(b * band, (b + 1) * band)
            add[b, lanes] = rng.random(band) < p_add
            dl[b, lanes] = rng.random(band) < p_del
        for n in nodes.values():
            n.ingest_batch(add, dl, np.ones(B, bool))
    recs = {name: _records(n) for name, n in nodes.items()}
    assert len(recs["one"]) == 5
    assert recs["1d"] == recs["one"] and recs["2x2"] == recs["one"]
    for name in ("1d", "2x2"):
        _port_same(nodes["one"].state_slice(), nodes[name].state_slice(),
                   name)


def test_digest_summary_parity_and_collective_kernel():
    rng = np.random.default_rng(13)
    plain = _plain(0)
    mesh = _mesh(0, n=8)
    jax_mesh = jmt.MeshApplyTarget(0, E, A, mesh_devices=8)
    for add, dl, live in _random_batches(rng, 3):
        for n in (plain, mesh, jax_mesh):
            n.ingest_batch(add, dl, live)
    sp, sm = plain.state_slice(), mesh.state_slice()
    for gs in (64, 128):
        want = digest_ops.state_group_digests(sp, gs)
        assert torch.equal(want, mesh._digest_fn(sm, gs)), gs
        assert np.array_equal(
            want.numpy().view(np.uint32),
            np.asarray(jax_mesh._digest_fn(jax_mesh.state_slice(), gs)))
        assert np.array_equal(mesh.digest_summary_arrays(gs).digests,
                              want.numpy().view(np.uint32))
    # misaligned: 8 slots over E = 256 leave 32-lane slots under 64-lane
    # groups, and the whole-state read must still match
    p2, m2 = _plain(0, e=256), _mesh(0, e=256, n=8)
    for add, dl, live in _random_batches(rng, 2, e=256, add_p=0.05):
        p2.ingest_batch(add, dl, live)
        m2.ingest_batch(add, dl, live)
    assert torch.equal(digest_ops.state_group_digests(p2.state_slice(), 64),
                       m2._digest_fn(m2.state_slice(), 64))
    assert digestsync.node_summary(m2) == digestsync.node_summary(p2)
    # the summary frame: the JAX mesh node's bytes
    body = digestsync.node_summary(mesh)
    assert body == jax_mesh.digest_summary()
    assert mesh.digest_summary() == jax_mesh.digest_summary()
    actor, gs, vv, processed, digests = digestsync.decode_summary(body, E, A)
    assert actor == 0 and gs == 64
    assert np.array_equal(vv, sm.vv.numpy().view(np.uint32))


@pytest.mark.parametrize("case", [
    ("1d", 1024, 8, 64), ("1d", 1024, 8, 128), ("1d", 1024, 8, None),
    ("1d", 256, 8, 64), ("1d", 256, 8, None),
    ("2x2", 1024, 4, 64), ("2x2", 1024, 4, 128), ("2x2", 1024, 4, None)],
    ids=lambda c: "-".join(map(str, c)))
def test_mesh_digest_summary_equals_the_jax_mesh_nodes(case):
    """``digest_summary`` (the reference's ``meshtarget.py:469``): the
    summary frame body, byte for byte the JAX mesh node's, on aligned
    slots, on 32-lane slots under 64-lane groups (E = 256 over 8 slots:
    the whole-state read), and on the 2 x 2 node that inherits it."""
    kind, e, n, gs = case
    rng = np.random.default_rng(41)
    if kind == "1d":
        mesh = _mesh(0, e=e, n=n)
        jax_mesh = jmt.MeshApplyTarget(0, e, A, mesh_devices=n)
    else:
        mesh = _mesh2d(0, kind, e=e)
        jax_mesh = jmt2.Mesh2DApplyTarget(0, e, A, mesh_shape=kind)
    plain = _plain(0, e=e)
    for add, dl, live in _random_batches(rng, 3, e=e, add_p=0.05):
        for node in (plain, mesh, jax_mesh):
            node.ingest_batch(add, dl, live)
    got = mesh.digest_summary(gs)
    assert got == jax_mesh.digest_summary(gs)
    assert got == digestsync.node_summary(plain, gs or 64)
    if gs is None:
        assert got == mesh.digest_summary(64) == digestsync.node_summary(mesh)


def test_k11_lane_base_plain_matches_jax_offset_ids():
    """K11's plain version with a lane base hashes the global ids the
    JAX mesh summary hashes (``axis_index * e_loc + arange``)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(31)
    e = 192
    present = rng.random(e) < 0.5
    deleted = ~present & (rng.random(e) < 0.5)
    xa = np.where(deleted, rng.integers(0, A, e), 0).astype(np.uint32)
    xc = np.where(deleted, rng.integers(1, 1 << 32, e, dtype=np.uint64),
                  0).astype(np.uint32)
    from go_crdt_playground_tpu_torch.models import awset_delta

    st = awset_delta.init(1, e, A, device="cpu")
    row = type(st)(*(x[0] for x in st))._replace(
        present=torch.from_numpy(present), deleted=torch.from_numpy(deleted),
        del_dot_actor=torch.from_numpy(xa.view(np.int32)),
        del_dot_counter=torch.from_numpy(xc.view(np.int32)))
    for base in (0, 192, 5 * 192, (1 << 31) + 7):
        ids = jnp.arange(e, dtype=jnp.uint32) + jnp.uint32(base & 0xFFFFFFFF)
        want = np.asarray(jax_digest.lane_fingerprint_arrays(
            ids, jnp.asarray(present), jnp.asarray(deleted), jnp.asarray(xa),
            jnp.asarray(xc)))
        got = cuda_digest.lane_fingerprints(row, lane_base=base)
        assert np.array_equal(got.numpy().view(np.uint32), want), base
        for gs in (64, 50):
            fold = np.asarray(jax_digest.group_fold(jnp.asarray(want), gs))
            got_g = cuda_digest.state_group_digests(row, gs, lane_base=base)
            if e % gs == 0:
                assert np.array_equal(got_g.numpy().view(np.uint32), fold)
            assert got_g.shape == (-(-e // gs),)
    # a lane base of 0 is the existing call, bitwise
    assert torch.equal(cuda_digest.state_group_digests(row, 64),
                       digest_ops.state_group_digests(row, 64))


def test_slice_extract_and_apply_parity():
    rng = np.random.default_rng(14)
    plain, mesh = _plain(0), _mesh(0, n=8)
    jax_mesh = jmt.MeshApplyTarget(0, E, A, mesh_devices=8)
    for add, dl, live in _random_batches(rng, 3, add_p=0.03):
        for n in (plain, mesh, jax_mesh):
            n.ingest_batch(add, dl, live)
    mask = np.zeros(E, bool)
    mask[rng.choice(E, 100, replace=False)] = True
    body = mesh.extract_slice(mask)
    assert body == plain.extract_slice(mask) == jax_mesh.extract_slice(mask)
    rp, rm = _plain(1), _mesh(1, n=8)
    rp.apply_payload_body(body)
    rm.apply_payload_body(body)
    _port_same(rp.state_slice(), rm.state_slice(), "recipient")
    assert rm._slots[(3,)].present.shape == (1, E // 8)


def test_sync_exchange_between_mesh_and_plain():
    """Anti-entropy runs unchanged against the mesh target: the port's
    mesh node and the JAX package's plain node converge over a real
    socket in the delta and the digest regimes."""
    from go_crdt_playground_tpu_torch.net import digestsync as port_ds

    mesh = _mesh(0, n=8)
    plain = JaxNode(1, E, A)
    mesh.add(1, 2, 3)
    plain.add(500, 501)
    plain.delete(501)
    addr = plain.serve()
    try:
        mesh.sync_with(addr)
        mesh.sync_with(addr)
        assert mesh.members().tolist() == [1, 2, 3, 500]
        assert plain.members().tolist() == [1, 2, 3, 500]
        mesh.add(7)
        stats = port_ds.sync_digest(mesh, addr)
        assert stats.groups_mismatched >= 1
        stats = port_ds.sync_digest(mesh, addr)
        assert stats.quiescent
    finally:
        plain.close()


def test_single_device_frontend_degenerates_bitwise(tmp_path):
    from go_crdt_playground_tpu_torch.serve.client import ServeClient
    from go_crdt_playground_tpu_torch.serve.frontend import ServeFrontend

    fes = {}
    for name, mesh_devices in (("plain", None), ("mesh1", 1)):
        fe = ServeFrontend(256, A, actor=0, durable_dir=str(tmp_path / name),
                           mesh_devices=mesh_devices, flush_ms=1.0,
                           device="cpu")
        fes[name] = (fe, fe.serve())
    try:
        for name, (fe, addr) in fes.items():
            with ServeClient(addr) as c:
                c.add(3, 9, 27)
                c.add(81)
                c.delete(9)
                assert c.members()[0] == [3, 27, 81], name
        pulls = {}
        for name, (fe, addr) in fes.items():
            with ServeClient(addr) as c:
                pulls[name] = c.slice_pull([3, 9, 27, 81, 100])
        assert pulls["plain"] == pulls["mesh1"]
        for name, (fe, addr) in fes.items():
            with ServeClient(addr) as c:
                c.slice_push(pulls["plain"])
        _port_same(fes["plain"][0].node.state_slice(),
                   fes["mesh1"][0].node.state_slice(), "post-push")
    finally:
        for fe, _ in fes.values():
            fe.close()
    r_plain = Node.restore_durable(str(tmp_path / "mesh1"), device="cpu")
    r_mesh = MeshApplyTarget.restore_durable(
        str(tmp_path / "plain"), device="cpu",
        node_kwargs={"mesh_devices": 1})
    _port_same(r_plain.state_slice(), r_mesh.state_slice(), "cross")
    # and the JAX package's classes restore the port's stores alike
    j_mesh = jmt.MeshApplyTarget.restore_durable(
        str(tmp_path / "mesh1"), node_kwargs={"mesh_devices": 2})
    assert_same(j_mesh.state_slice(), r_plain.state_slice(), "jax")


# ---------------------------------------------------------------------------
# the 2-D dp x mp tier
# ---------------------------------------------------------------------------


def test_parse_mesh_spec_matches_jax():
    for good in ("8", 4, "2x4", (2, 2), "1x4", " 2X2 "):
        assert parse_mesh_spec(good) == jmt2.parse_mesh_spec(good)
    for bad in ("", "x", "2x", "x4", "0", "0x4", "2x0", "axb", "2x4x2",
                (0, 4), (2,)):
        with pytest.raises(ValueError):
            jmt2.parse_mesh_spec(bad)
        with pytest.raises(ValueError):
            parse_mesh_spec(bad)


def _plans_equal(got, want):
    (gp, gc), (wp, wc) = got, want
    assert gc == wc and len(gp) == len(wp)
    for g, w in zip(gp, wp):
        for f in ("add", "dl", "prefix", "add_total", "del_tick"):
            x, y = getattr(g, f), getattr(w, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert (g.rows, g.stripes_used) == (w.rows, w.stripes_used)


def test_plan_stripes_disjoint_and_cuts_match_jax():
    e = 64
    add = np.zeros((4, e), bool)
    for b in range(4):
        add[b, b * 16] = True
    dl = np.zeros((4, e), bool)
    live = np.ones(4, bool)
    plans, cuts = plan_stripes(add, dl, live, dp=2, cap=2)
    assert len(plans) == 1 and cuts == 0 and plans[0].stripes_used == 2
    add3 = np.zeros((3, e), bool)
    add3[0, 0] = add3[1, 16] = add3[2, 0] = add3[2, 16] = True
    plans, cuts = plan_stripes(add3, np.zeros((3, e), bool),
                               np.ones(3, bool), dp=2, cap=4)
    assert cuts == 1 and [p.rows for p in plans] == [2, 1]
    rng = np.random.default_rng(5)
    for _ in range(20):
        a = rng.random((12, e)) < 0.05
        d = rng.random((12, e)) < 0.03
        lv = rng.random(12) < 0.8
        hint = rng.integers(-1, 3, 12).astype(np.int32)
        for dp, cap in ((2, 6), (3, 4), (4, 2)):
            for h in (None, hint):
                _plans_equal(plan_stripes(a, d, lv, dp, cap, assign=h),
                             jmt2.plan_stripes(a, d, lv, dp, cap, assign=h))


@pytest.mark.parametrize("shape", ["1x2", "2x1", "2x2", "4x2", "2x4",
                                   "8x1", "1x8"])
def test_mesh2d_bitwise_parity(shape):
    rng = np.random.default_rng(21)
    plain, mesh = _plain(0), _mesh2d(0, shape)
    dp = int(shape.split("x")[0])
    assert mesh.ingest_stripes == dp
    for add, dl, live in _random_batches(rng, 4, add_p=0.02):
        plain.ingest_batch(add, dl, live)
        mesh.ingest_batch(add, dl, live)
    for add, dl, live in _disjoint_batches(rng, 2):
        plain.ingest_batch(add, dl, live)
        mesh.ingest_batch(add, dl, live)
    _port_same(plain.state_slice(), mesh.state_slice(), shape)


def test_mesh2d_wal_byte_identity(tmp_path):
    rng = np.random.default_rng(22)
    nodes = {
        "plain": _plain(0, wal=DeltaWal(str(tmp_path / "p"))),
        "1d": _mesh(0, n=4, wal=DeltaWal(str(tmp_path / "m1"))),
        "2x2": _mesh2d(0, "2x2", wal=DeltaWal(str(tmp_path / "m22"))),
        "4x1": _mesh2d(0, "4x1", wal=DeltaWal(str(tmp_path / "m41"))),
        "jax2x2": jmt2.Mesh2DApplyTarget(
            0, E, A, mesh_shape="2x2", wal=JaxWal(str(tmp_path / "j22"))),
    }
    for add, dl, live in _disjoint_batches(rng, 3):
        for n in nodes.values():
            n.ingest_batch(add, dl, live)
    recs = {name: _records(n) for name, n in nodes.items()}
    for name in nodes:
        assert recs[name] == recs["plain"], name
    assert len(recs["plain"]) == 3
    # a conflicted batch: records may split by chunk, the state may not
    add = np.zeros((B, E), bool)
    add[:, 5] = True
    add[0, 100] = add[3, 200] = True
    for n in nodes.values():
        n.ingest_batch(add, np.zeros((B, E), bool), np.ones(B, bool))
    ref = nodes["plain"].state_slice()
    for name, n in nodes.items():
        if name == "jax2x2":
            assert_same(n.state_slice(), ref, name)
            assert _records(n) == _records(nodes["2x2"])
        else:
            _port_same(ref, n.state_slice(), f"post-conflict {name}")
    for name, sub in (("plain", "p"), ("1d", "m1"), ("2x2", "m22"),
                      ("4x1", "m41")):
        with nodes[name]._lock:
            nodes[name].wal.close()
        fresh = _plain(0)
        out = fresh.replay_wal(DeltaWal(str(tmp_path / sub)))
        assert out["bad"] == 0 and out["future"] == 0
        _port_same(ref, fresh.state_slice(), f"replay {name}")


@pytest.mark.parametrize("hinted", [False, True])
def test_mesh2d_cut_chunks_replay_to_the_same_records(tmp_path, hinted):
    """A cut batch writes one WAL record a chunk: a one-slot node fed the
    chunks (``chip_smoke.cut_chunks``, the check the card's serve phase
    runs) appends the same records, byte for byte, and lands in the same
    state."""
    import chip_smoke

    rng = np.random.default_rng(23)
    mesh = _mesh2d(0, "2x2", wal=DeltaWal(str(tmp_path / "m")))
    plain = _plain(0, wal=DeltaWal(str(tmp_path / "p")))
    cuts = 0
    for add, dl, live in _random_batches(rng, 6, add_p=0.004):
        add[:, 5] = True  # every row shares a lane: the planner cuts
        hint = (rng.integers(-1, 2, B).astype(np.int32) if hinted
                else None)
        mesh.ingest_batch(add, dl, live, stripe_hint=hint)
        chunks, c = chip_smoke.cut_chunks(add, dl, live, 2, hint)
        cuts += c
        for chunk in chunks:
            plain.ingest_batch(*chunk)
    assert cuts >= 6
    assert _records(mesh) == _records(plain)
    assert len(_records(plain)) == 6 + cuts
    _port_same(plain.state_slice(), mesh.state_slice(), "cut replay")


def test_mesh2d_sharding_layout():
    mesh = _mesh2d(0, "2x2")
    assert mesh._mesh.shape == {DP_AXIS: 2, MP_AXIS: 2}
    for d in range(2):
        for m in range(2):
            assert mesh._slots[(d, m)].present.shape == (1, E // 2)
            assert mesh._slots[(d, m)].vv.shape == (1, A)
    plain = _plain(0)
    rng = np.random.default_rng(23)
    for add, dl, live in _disjoint_batches(rng, 2):
        plain.ingest_batch(add, dl, live)
        mesh.ingest_batch(add, dl, live)
    # the dp replicas hold one joined state
    for m in range(2):
        _port_same(mesh._slots[(0, m)], mesh._slots[(1, m)], f"mp {m}")
    assert digestsync.node_summary(mesh) == digestsync.node_summary(plain)


def test_mesh2d_slice_and_cross_restore(tmp_path):
    rng = np.random.default_rng(24)
    dirs = {name: tmp_path / name for name in ("plain", "2x2", "jax")}
    nodes = {
        "plain": _plain(0, wal=DeltaWal(str(dirs["plain"] / "wal"))),
        "2x2": _mesh2d(0, (2, 2), wal=DeltaWal(str(dirs["2x2"] / "wal"))),
        "jax": jmt2.Mesh2DApplyTarget(
            0, E, A, mesh_shape=(2, 2),
            wal=JaxWal(str(dirs["jax"] / "wal"))),
    }
    for add, dl, live in _disjoint_batches(rng, 3):
        for n in nodes.values():
            n.ingest_batch(add, dl, live)
    mask = np.zeros(E, bool)
    mask[rng.choice(E, 64, replace=False)] = True
    assert nodes["plain"].extract_slice(mask) == \
        nodes["2x2"].extract_slice(mask) == nodes["jax"].extract_slice(mask)
    for name, n in nodes.items():
        store = (JaxStore if name == "jax" else CheckpointStore)(
            str(dirs[name]))
        n.save_durable(store)
        with n._lock:
            n.wal.close()
    r_plain = Node.restore_durable(str(dirs["2x2"]), device="cpu")
    r_mesh = Mesh2DApplyTarget.restore_durable(
        str(dirs["plain"]), device="cpu", node_kwargs={"mesh_shape": "2x2"})
    _port_same(r_plain.state_slice(), r_mesh.state_slice(), "cross")
    # across the packages, both ways
    r_from_jax = Mesh2DApplyTarget.restore_durable(
        str(dirs["jax"]), device="cpu", node_kwargs={"mesh_shape": "2x2"})
    _port_same(r_plain.state_slice(), r_from_jax.state_slice(), "from jax")
    j_from_port = jmt2.Mesh2DApplyTarget.restore_durable(
        str(dirs["2x2"]), node_kwargs={"mesh_shape": "2x2"})
    assert_same(j_from_port.state_slice(), r_plain.state_slice(), "to jax")
    add, dl, live = next(_disjoint_batches(np.random.default_rng(25), 1))
    r_plain.ingest_batch(add, dl, live)
    r_mesh.ingest_batch(add, dl, live)
    _port_same(r_plain.state_slice(), r_mesh.state_slice(), "post-restore")


def test_mesh2d_requires_v2_semantics():
    with pytest.raises(ValueError, match="v2"):
        _mesh2d(0, "1x1", delta_semantics="reference")


def test_mesh2d_frontend_stripe_width(tmp_path):
    from go_crdt_playground_tpu_torch.serve.client import ServeClient
    from go_crdt_playground_tpu_torch.serve.frontend import ServeFrontend
    from go_crdt_playground_tpu_torch.serve.scheduler import \
        ConflictScheduler

    fe = ServeFrontend(256, A, actor=0, durable_dir=str(tmp_path / "s"),
                       mesh_devices="2x2", flush_ms=1.0, max_batch=8,
                       device="cpu")
    assert fe.batcher.width == 16
    assert isinstance(fe.scheduler, ConflictScheduler)
    addr = fe.serve()
    try:
        with ServeClient(addr) as c:
            for e in range(0, 64, 2):
                c.add(e)
            c.delete(4)
            members, _ = c.members()
            assert members == sorted(set(range(0, 64, 2)) - {4})
    finally:
        fe.close()
    restored = Node.restore_durable(str(tmp_path / "s"), device="cpu")
    assert restored.members().tolist() == sorted(set(range(0, 64, 2)) - {4})


def test_mesh_frontend_crash_on_slice_hook_subprocess(tmp_path):
    """``serve --mesh-devices 2`` armed with ``CRDT_SERVE_CRASH_ON_SLICE
    =pull`` dies at the donor read without shipping state; its durable
    restart serves every acked op."""
    from go_crdt_playground_tpu_torch.serve.client import ServeClient
    from go_crdt_playground_tpu_torch.shard.fleet import _Proc, free_port

    port = free_port()
    argv = [sys.executable, "-m", "go_crdt_playground_tpu_torch", "serve",
            "--ingest", "--port", str(port), "--elements", "256",
            "--actors", "2", "--mesh-devices", "2", "--device", "cpu",
            "--durable-dir", str(tmp_path / "state"), "--flush-ms", "1"]
    proc = _Proc(argv, cwd=REPO, log_path=str(tmp_path / "w.log"),
                 env={"CRDT_SERVE_CRASH_ON_SLICE": "pull"})
    try:
        addr = proc.await_address()
        with ServeClient(addr) as c:
            c.add(1, 2, 3)
            c.add(42)
        with pytest.raises((ConnectionError, OSError)):
            with ServeClient(addr) as c:
                c.slice_pull([1, 2])
        proc.proc.wait(timeout=30)
    finally:
        proc.close()
    proc2 = _Proc(argv, cwd=REPO, log_path=str(tmp_path / "w2.log"),
                  env_drop=("CRDT_SERVE_CRASH_ON_SLICE",))
    try:
        addr = proc2.await_address()
        with ServeClient(addr) as c:
            members, _ = c.members()
            assert members == [1, 2, 3, 42]
            assert len(c.slice_pull([1, 2])) > 0
        banner = b"".join(proc2._lines).decode()
        assert "mesh=2 sched=auto" in banner
    finally:
        proc2.close()
