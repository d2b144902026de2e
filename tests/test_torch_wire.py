"""The port's host modules (utils/wire.py, net/framing.py, utils/wal.py,
utils/checkpoint.py, models/digest.py) against the JAX package's, byte
for byte.

Inputs come from numpy seeds and go through both packages; bytes are
compared with ``==`` and arrays with ``np.array_equal``, dtype included:
the tolerance is exact.  Checkpoints are compared by their arrays and
manifest, not their zip bytes (numpy stamps the time into the zip).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_crdt_playground_tpu.models import awset_delta as jax_awd
from go_crdt_playground_tpu.models import digest as jax_digest
from go_crdt_playground_tpu.models import packed as jax_packed
from go_crdt_playground_tpu.net import framing as jax_framing
from go_crdt_playground_tpu.obs import Recorder
from go_crdt_playground_tpu.ops import compact as jax_compact
from go_crdt_playground_tpu.ops import delta as jax_delta_ops
from go_crdt_playground_tpu.ops import ingest as jax_ingest
from go_crdt_playground_tpu.ops.pallas_ingest import pallas_ingest_rows_delta
from go_crdt_playground_tpu.utils import checkpoint as jax_ckpt
from go_crdt_playground_tpu.utils import wal as jax_wal
from go_crdt_playground_tpu.utils import wire as jax_wire
from go_crdt_playground_tpu_torch.models import digest
from go_crdt_playground_tpu_torch.net import framing
from go_crdt_playground_tpu_torch.ops import cuda_ingest, ingest
from go_crdt_playground_tpu_torch.ops.delta import DeltaPayload
from go_crdt_playground_tpu_torch.utils import checkpoint as ckpt
from go_crdt_playground_tpu_torch.utils import wal, wire
from tests.test_ingest_fused import A, E, _batch, _seeded_row
from tests.test_torch_ingest import _lift, assert_same, port_row, to_port

MODES = [jax_framing.MODE_DELTA, jax_framing.MODE_FULL,
         jax_framing.MODE_SLICE, jax_framing.MODE_DIGEST]


def _payload(seed, base=0):
    """A δ payload with history (foreign dots, deletion records) from a
    seeded slice, against a partly-covering vv."""
    jrow = _seeded_row(seed)
    if base:
        jrow = _lift(jrow, base)
    half = jnp.asarray(np.asarray(jrow.vv) // 2)
    return jax_delta_ops.delta_extract(jrow, half)


def _assert_np_payload(want, got, ctx=""):
    """A JAX payload against a decoded numpy payload of the port."""
    assert want._fields == got._fields
    for name, w, g in zip(want._fields, want, got):
        w, g = np.asarray(w), np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, f"{ctx}:{name}"
        assert np.array_equal(g, w), f"{ctx}:{name}"


# -- utils/wire.py ------------------------------------------------------------


@pytest.mark.parametrize("base", [0, 0x7FFFFFF0, 0xFFFFFFF0])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_payload_bytes_match(seed, base):
    jp = _payload(seed, base)
    want = jax_wire.encode_payload(jp, prefer_native=False)
    assert wire.encode_payload(to_port(jp, DeltaPayload)) == want
    assert wire.encode_payload(jp) == want   # numpy fields encode too
    _assert_np_payload(
        jax_wire.decode_payload(want, E, A, src_actor=2, prefer_native=False),
        wire.decode_payload(want, E, A, src_actor=2), "decode")


@pytest.mark.parametrize("seed", [1, 4])
def test_lane_payload_bytes_match(seed):
    jp = _payload(seed)
    want = jax_wire.encode_payload_lanes(jp, E)
    assert wire.encode_payload_lanes(to_port(jp, DeltaPayload), E) == want
    _assert_np_payload(jax_wire.decode_payload_lanes(want, E, A, 1),
                       wire.decode_payload_lanes(want, E, A, 1), "decode")


def test_compact_wal_body_bytes_match():
    rng = np.random.default_rng(3)
    args = (rng.integers(0, 1 << 32, A, dtype=np.uint64).astype(np.uint32),
            2, rng.integers(0, 1 << 32, A, dtype=np.uint64).astype(np.uint32),
            rng.integers(0, 1 << 32, A, dtype=np.uint64).astype(np.uint32),
            [3, 9, 70], [0, 4, 2], [1, 0xFFFFFFFF, 0x80000000],
            [5], [2], [77], E)
    body = jax_wire.encode_compact_wal_body(*args)
    assert wire.encode_compact_wal_body(*args) == body
    jguard, jp = jax_wire.decode_compact_wal_body(body, E, A)
    guard, p = wire.decode_compact_wal_body(body, E, A)
    assert np.array_equal(guard, jguard) and guard.dtype == jguard.dtype
    _assert_np_payload(jp, p, "decode")


def _corruptions():
    jp = _payload(5)
    dense = jax_wire.encode_payload(jp, prefer_native=False)
    comp = jax_wire.encode_compact_wal_body(
        np.zeros(A, np.uint32), 0, np.ones(A, np.uint32),
        np.ones(A, np.uint32), [3], [0], [1], [], [], [], E)
    return [
        ("payload", dense[:-1]), ("payload", dense + b"\x00"),
        ("payload", b"\x05" + dense[1:]), ("payload", b""),
        ("compact", comp[:-1]), ("compact", comp + b"\x00"),
        ("compact", comp[:1] + b"\x02" + comp[2:]),
        ("compact", b"\x01" + comp[1:]),
        ("compact", comp.replace(bytes([E]), bytes([E + 1]), 1)),
        ("lanes", b"\x07"), ("lanes", b"\xff" * 12),
    ]


@pytest.mark.parametrize("case", range(len(_corruptions())))
def test_malformed_input_raises_value_error_in_both(case):
    kind, buf = _corruptions()[case]
    jfn, fn = {
        "payload": (lambda b: jax_wire.decode_payload(
            b, E, A, prefer_native=False),
            lambda b: wire.decode_payload(b, E, A, prefer_native=False)),
        "compact": (lambda b: jax_wire.decode_compact_wal_body(b, E, A),
                    lambda b: wire.decode_compact_wal_body(b, E, A)),
        "lanes": (lambda b: jax_wire.decode_payload_lanes(b, E, A),
                  lambda b: wire.decode_payload_lanes(b, E, A)),
    }[kind]
    with pytest.raises(ValueError) as jerr:
        jfn(buf)
    with pytest.raises(ValueError) as err:
        fn(buf)
    assert str(err.value) == str(jerr.value)


# -- net/framing.py -----------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_payload_msg_bytes_match(mode):
    jp = _payload(6, 0x7FFFFFF0)
    proc = np.asarray(jp.src_processed)
    want = jax_framing.encode_payload_msg(mode, 2, proc, jp)
    got = framing.encode_payload_msg(mode, 2, torch.from_numpy(
        proc.view(np.int32).copy()), to_port(jp, DeltaPayload))
    assert got == want
    jmode, jdec = jax_framing.decode_payload_msg(want, E, A)
    tmode, tdec = framing.decode_payload_msg(want, E, A)
    assert tmode == jmode == mode
    _assert_np_payload(jdec, tdec, "decode")


@pytest.mark.parametrize("body", [b"", b"\x09\x00", b"\x00\x07",
                                  b"\x00\x01\x05\x00"])
def test_payload_msg_protocol_errors(body):
    with pytest.raises(jax_framing.ProtocolError) as jerr:
        jax_framing.decode_payload_msg(body, E, A)
    with pytest.raises(framing.ProtocolError) as err:
        framing.decode_payload_msg(body, E, A)
    assert str(err.value) == str(jerr.value)


def test_frame_cap_and_constants_match():
    assert framing.peer_frame_cap(1024, 16) == \
        jax_framing.peer_frame_cap(1024, 16)
    for name in ("MSG_HELLO", "MSG_PAYLOAD", "MSG_ERROR", "MSG_DIGEST",
                 "MODE_DELTA", "MODE_FULL", "MODE_SLICE", "MODE_DIGEST"):
        assert getattr(framing, name) == getattr(jax_framing, name), name


def _record_inputs(regime, b, density, base=0):
    """One batch through both packages in one regime: "cpu" (the XLA
    path and the port's plain path, K = 0) or "cuda" (the Pallas kernel
    in interpret mode and K10's plain version, K = min(128, E))."""
    jrow = _seeded_row(31)
    if base:
        jrow = _lift(jrow, base)
    add, dl, live = _batch(50 + b, b, density, "holes")
    args = (jnp.asarray(add), jnp.asarray(dl), jnp.asarray(live))
    if regime == "cpu":
        jout = jax_ingest.ingest_rows_delta(jrow, *args, k_changed=0,
                                            k_deleted=0)
        tout = ingest.ingest_rows_delta(port_row(jrow), add, dl, live,
                                        k_changed=0, k_deleted=0)
    else:
        k = min(ingest.WAL_COMPACT_K, E)
        jout = pallas_ingest_rows_delta(jrow, *args, k_changed=k,
                                        k_deleted=k, interpret=True)
        tout = cuda_ingest.ingest_rows_delta_fused(
            port_row(jrow), add, dl, live, k_changed=k, k_deleted=k)
    return np.asarray(jrow.vv), jout, tout


@pytest.mark.parametrize("regime", ["cpu", "cuda"])
@pytest.mark.parametrize("b,density", [(1, 0.02), (3, 0.05), (6, 0.2),
                                       (8, 0.6)])
@pytest.mark.parametrize("compact_records", [True, False])
def test_delta_wal_record_bytes_match(regime, b, density, compact_records):
    """The record policy picks the same form and writes the same bytes:
    fixed-K compact (cuda regime), host-compact, dense; the deletion
    filter in each."""
    pre_vv, jout, tout = _record_inputs(regime, b, density,
                                        base=0xFFFFFFF0 * (b == 3))
    want = jax_framing.encode_delta_wal_record(
        pre_vv, 2, jout[1], jout[2], compact_records=compact_records)
    got = framing.encode_delta_wal_record(
        torch.from_numpy(pre_vv.view(np.int32).copy()), 2, tout[1],
        tout[2], compact_records=compact_records)
    assert got == want


def test_delta_wal_record_covers_every_form():
    """The parametrized cases above reach all three forms: compact from
    the fixed-K form, host-side compact, dense."""
    seen = set()
    for regime in ("cpu", "cuda"):
        for b, density in ((1, 0.02), (8, 0.6)):
            pre_vv, _, tout = _record_inputs(regime, b, density)
            body, is_compact = framing.encode_delta_wal_record(
                pre_vv, 2, tout[1], tout[2])
            seen.add((regime, is_compact, tout[2] is not None
                      and bool(tout[2].overflow)))
    assert ("cuda", True, False) in seen     # the fixed-K form
    assert ("cpu", True, False) in seen      # host-side compaction
    assert ("cpu", False, False) in seen     # dense


def test_fixed_k_overflow_falls_back_to_the_dense_record():
    """E = 300 > K = 128: a δ of more lanes overflows the fixed-K form
    and the record falls back to the dense form, in both packages."""
    import jax

    e = 300
    jrow = jax.tree.map(lambda x: x[0], jax_awd.init(
        1, e, A, actors=np.asarray([2], np.uint32)))
    add = np.random.default_rng(8).random((2, e)) < 0.4
    dl = np.zeros((2, e), bool)
    live = np.ones(2, bool)
    k = min(ingest.WAL_COMPACT_K, e)
    jout = pallas_ingest_rows_delta(
        jrow, jnp.asarray(add), jnp.asarray(dl), jnp.asarray(live),
        k_changed=k, k_deleted=k, interpret=True)
    tout = cuda_ingest.ingest_rows_delta_fused(
        port_row(jrow), add, dl, live, k_changed=k, k_deleted=k)
    assert bool(tout[2].overflow) and bool(jout[2].overflow)
    pre_vv = np.asarray(jrow.vv)
    want = jax_framing.encode_delta_wal_record(pre_vv, 2, jout[1], jout[2])
    got = framing.encode_delta_wal_record(pre_vv, 2, tout[1], tout[2])
    assert got == want and got[1] is False


def test_delta_wal_record_filters_guard_covered_deletions():
    """A deletion dot the guard covers is left out of every form."""
    jrow = _seeded_row(33)
    jp = jax_delta_ops.delta_extract(jrow, jnp.zeros(A, jnp.uint32))
    assert int(np.asarray(jp.deleted).sum()) > 0
    for guard in (np.zeros(A, np.uint32), np.asarray(jrow.vv)):
        for jc in (None, jax_compact.compact_payload(jp, E, E)):
            want = jax_framing.encode_delta_wal_record(guard, 2, jp, jc)
            tc = None if jc is None else to_port(jc)
            got = framing.encode_delta_wal_record(
                guard, 2, to_port(jp, DeltaPayload), tc)
            assert got == want


# -- utils/wal.py -------------------------------------------------------------


def _bodies(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(1, 90)),
                         dtype=np.uint8).tobytes() for _ in range(n)]


def test_record_framing_and_scan_match():
    data = b"".join(wal.encode_record(b) for b in _bodies(6))
    assert data == b"".join(jax_wal.encode_record(b) for b in _bodies(6))
    for cut in (0, 1, 3, len(data) // 2, len(data) - 1, len(data)):
        for blob in (data[:cut], data[:cut] + b"\x00junk"):
            assert wal.scan_records(blob) == jax_wal.scan_records(blob)
    flipped = bytearray(data)
    flipped[len(data) // 3] ^= 0x10
    assert wal.scan_records(bytes(flipped)) == \
        jax_wal.scan_records(bytes(flipped))


def _dir_bytes(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


def _drive(mod, path, bodies):
    """One script of log operations: appends across segment rotation,
    seal, drop, a torn tail repaired at reopen, truncate, appends."""
    rec = Recorder()
    w = mod.DeltaWal(path, segment_bytes=200, fsync=False, recorder=rec)
    for b in bodies[:8]:
        w.append(b)
    sealed = w.seal()
    for b in bodies[8:11]:
        w.append(b)
    w.drop_segments(sealed[:-1])
    streamed = list(w.stream_from(w.min_seq()))
    w.close()
    seg = os.path.join(path, sorted(os.listdir(path))[-1])
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) - 3)
    w = mod.DeltaWal(path, segment_bytes=200, fsync=False, recorder=rec)
    repaired = w.torn_tail_repaired
    after_repair = list(w.records())
    mid = _dir_bytes(path)
    w.truncate()
    for b in bodies[11:]:
        w.append(b)
    out = (streamed, repaired, after_repair, mid, list(w.records()),
           w.record_count(), w.next_seq(), w.min_seq(), _dir_bytes(path),
           rec.snapshot()["counters"])
    w.close()
    return out


def test_wal_segments_and_bytes_match(tmp_path):
    bodies = _bodies(16, seed=4)
    got = _drive(wal, str(tmp_path / "port"), bodies)
    want = _drive(jax_wal, str(tmp_path / "jax"), bodies)
    assert got == want
    assert len(got[3]) >= 2      # rotation happened before the truncate


def test_wal_truncated_cursor_raises(tmp_path):
    w = wal.DeltaWal(str(tmp_path / "w"), fsync=False)
    for b in _bodies(3):
        w.append(b)
    w.truncate()
    with pytest.raises(wal.WalTruncated) as err:
        list(w.stream_from(1))
    assert (err.value.wanted, err.value.min_seq, err.value.next_seq) == \
        (1, 4, 4)
    with pytest.raises(ValueError):
        w.stream_from(0)
    w.close()
    with pytest.raises(ValueError, match="closed"):
        w.append(b"x")


def test_each_package_replays_the_others_log(tmp_path):
    bodies = _bodies(9, seed=7)
    for writer, reader, name in ((wal, jax_wal, "a"), (jax_wal, wal, "b")):
        w = writer.DeltaWal(str(tmp_path / name), segment_bytes=160)
        for b in bodies:
            w.append(b)
        w.close()
        r = reader.DeltaWal(str(tmp_path / name))
        assert list(r.records()) == bodies
        r.close()


# -- models/digest.py and utils/checkpoint.py ---------------------------------


def _states():
    """One state of every type the port restores, with history."""
    st = jax_awd.init(4, 96, 4)
    st = jax_awd.add_element(st, np.uint32(1), np.uint32(7))
    st = jax_awd.add_element(st, np.uint32(2), np.uint32(40))
    st = jax_awd.del_elements(st, np.uint32(1), np.eye(96, dtype=bool)[7])
    aw = st.base()
    return [aw, st, jax_packed.pack_awset(aw), jax_packed.pack_awset_delta(st),
            jax_packed.pack_awset_dots(aw),
            jax_packed.pack_awset_delta_dots(st)]


def _port_state(jst):
    return to_port(jst, ckpt.STATE_TYPES[type(jst).__name__])


@pytest.mark.parametrize("i", range(6))
def test_digests_match(i):
    jst = _states()[i]
    tst = _port_state(jst)
    assert digest.state_digest(tst) == jax_digest.state_digest(jst)
    for name in jst._fields:
        assert digest.array_digest(getattr(tst, name)) == \
            jax_digest.array_digest(getattr(jst, name))
    # the uint32 view is hashed, never the int32 storage
    a = np.arange(8, dtype=np.uint32)
    assert digest.array_digest(torch.arange(8, dtype=torch.int32)) == \
        jax_digest.array_digest(a) != jax_digest.array_digest(
            a.astype(np.int32))
    with pytest.raises(TypeError):
        digest.state_digest({"not": "a state"})


def _load(path):
    with np.load(path) as z:
        manifest = json.loads(z["__manifest__"].tobytes().decode("utf-8"))
        arrays = {k: z[k] for k in z.files if k != "__manifest__"}
    return manifest, arrays


@pytest.mark.parametrize("i", range(6))
def test_checkpoint_arrays_and_manifest_match(tmp_path, i):
    jst = _states()[i]
    meta = {"actor": 1, "note": "x"}
    jax_ckpt.save_checkpoint(str(tmp_path / "j"), jst, step=3, metadata=meta,
                             generation=5)
    ckpt.save_checkpoint(str(tmp_path / "t"), _port_state(jst), step=3,
                         metadata=meta, generation=5)
    jm, ja = _load(str(tmp_path / "j"))
    tm, ta = _load(str(tmp_path / "t"))
    assert tm == jm
    assert list(ta) == list(ja)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype and np.array_equal(ta[k], ja[k]), k


@pytest.mark.parametrize("i", range(6))
def test_checkpoints_cross_restore(tmp_path, i):
    jst = _states()[i]
    jax_ckpt.save_checkpoint(str(tmp_path / "j"), jst, step=9)
    got = ckpt.restore_checkpoint(str(tmp_path / "j"), device="cpu")
    assert type(got.state).__name__ == type(jst).__name__
    assert_same(jst, got.state, "jax -> port")
    assert got.step == 9 and got.generation is None
    ckpt.save_checkpoint(str(tmp_path / "t"), _port_state(jst))
    back = jax_ckpt.restore_checkpoint(str(tmp_path / "t"))
    for name in jst._fields:
        assert np.array_equal(np.asarray(getattr(back.state, name)),
                              np.asarray(getattr(jst, name))), name


def test_bit_flip_refused(tmp_path):
    p = str(tmp_path / "ck")
    ckpt.save_checkpoint(p, _port_state(_states()[1]))
    with open(p, "r+b") as f:
        f.seek(os.path.getsize(p) // 2)
        b = f.read(1)
        f.seek(os.path.getsize(p) // 2)
        f.write(bytes([b[0] ^ 1]))
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.restore_checkpoint(p, device="cpu")
    with open(p, "wb") as f:
        f.write(b"PK\x03\x04 torn")
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.restore_checkpoint(p, device="cpu")


def test_unknown_type_warns_and_dictionary_raises(tmp_path):
    from go_crdt_playground_tpu.ops import lattices as L
    from go_crdt_playground_tpu.utils.codec import ElementDict

    p = str(tmp_path / "g")
    jax_ckpt.save_checkpoint(p, L.gcounter_init(4, 4))
    rec = Recorder()
    with pytest.warns(RuntimeWarning, match="unknown"):
        got = ckpt.restore_checkpoint(p, device="cpu", recorder=rec)
    assert isinstance(got.state, dict)
    assert rec.snapshot()["counters"]["restore.unknown_type"] == 1

    # a manifest with an element dictionary restores it beside the state
    d = ElementDict(capacity=16)
    d.encode("Anne")
    store = jax_ckpt.CheckpointStore(str(tmp_path / "s"))
    store.save(jax_awd.init(1, 16, 2), dictionary=d)
    gen, ck = ckpt.CheckpointStore(str(tmp_path / "s")).restore(device="cpu")
    assert gen == 1 and ck.dictionary.state_dict() == d.state_dict()


def test_store_generations_fallback_fence_and_spoof(tmp_path):
    rec = Recorder()
    store = ckpt.CheckpointStore(str(tmp_path), keep=2, recorder=rec)
    st = _port_state(_states()[1])
    for _ in range(3):
        store.save(st, metadata={"k": 1})
    assert store.generations() == [2, 3]
    with open(store.path_for(3), "wb") as f:
        f.write(b"rot")
    gen, ck = store.restore(device="cpu")
    assert gen == 2 and rec.snapshot()["counters"]["restore.fallbacks"] == 1
    assert rec.snapshot()["gauges"]["restore.generation"] == 2
    with pytest.raises(ckpt.GenerationRegression):
        store.restore(min_generation=3, device="cpu")
    os.replace(store.path_for(2), store.path_for(4))  # a renamed old file
    with pytest.raises(ckpt.CheckpointCorrupt):
        store.restore(device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.CheckpointStore(str(tmp_path / "empty")).restore(device="cpu")
    open(os.path.join(str(tmp_path), ".ckpt-tmp-stray"), "w").close()
    assert ckpt.sweep_tmp_files(str(tmp_path)) == 1
