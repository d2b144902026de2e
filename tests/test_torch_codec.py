"""The port's host codec (utils/codec.py), native codec (native/) and
element-dictionary checkpoints against the JAX package's: pack, unpack,
grow and render bitwise, dictionaries by state dict, wire bytes byte for
byte, checkpoints restored across the packages both ways."""

import random

import numpy as np
import pytest
import torch

from go_crdt_playground_tpu.models import awset as jax_awset
from go_crdt_playground_tpu.models import awset_delta as jax_awd
from go_crdt_playground_tpu.models import spec as jax_spec
from go_crdt_playground_tpu.ops import delta as jax_delta_ops
from go_crdt_playground_tpu.utils import checkpoint as jax_ckpt
from go_crdt_playground_tpu.utils import codec as jax_codec
from go_crdt_playground_tpu.utils import wire as jax_wire
from go_crdt_playground_tpu_torch import native
from go_crdt_playground_tpu_torch.models import awset, awset_delta, spec
from go_crdt_playground_tpu_torch.ops import delta as delta_ops
from go_crdt_playground_tpu_torch.utils import checkpoint as ckpt
from go_crdt_playground_tpu_torch.utils import codec, wire
from tests.test_torch_models import assert_same, to_torch
from tests.test_torch_spec import _state

KEYS = [f"k{i}" for i in range(9)] + ["ümlaut", "日本", "q\"uote"]


def _histories(mod, seed, n=3, delta=True, sem="v2"):
    """n replicas of ``mod``'s spec after a seeded add/del/merge history
    (the same ops for either package)."""
    rng = random.Random(seed)
    reps = [mod.AWSetDelta(actor=a, version_vector=mod.VersionVector(
        [0] * n), delta_semantics=sem) if delta else
        mod.AWSet(actor=a, version_vector=mod.VersionVector([0] * n))
        for a in range(n)]
    for _ in range(60):
        r = rng.randrange(n)
        roll = rng.random()
        if roll < 0.45:
            reps[r].add(*rng.sample(KEYS, rng.randint(1, 2)))
        elif roll < 0.65:
            reps[r].del_(rng.choice(KEYS))
        else:
            reps[r].merge(reps[rng.randrange(n)])
    return reps


def _arrays_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_unpack_render_match_jax(delta, seed):
    ours, theirs = _histories(spec, seed, delta=delta), \
        _histories(jax_spec, seed, delta=delta)
    d, jd = codec.ElementDict(capacity=16), jax_codec.ElementDict(capacity=16)
    A = 4
    if delta:
        got = codec.pack_awset_deltas(ours, d, A)
        want = jax_codec.pack_awset_deltas(theirs, jd, A)
    else:
        got = codec.pack_awsets(ours, d, A)
        want = jax_codec.pack_awsets(theirs, jd, A)
    _arrays_equal(got, want)
    assert d.state_dict() == jd.state_dict()
    assert codec.render_packed(got, d) == jax_codec.render_packed(want, jd)
    # unpack reads numpy arrays or the port's int32-bit tensors alike
    mod = awset_delta if delta else awset
    tensors = mod.from_arrays(got, device="cpu")._asdict()
    for arrays in (got, tensors):
        if delta:
            back = codec.unpack_awset_deltas(arrays, d, "v2")
            jback = jax_codec.unpack_awset_deltas(want, jd, "v2")
        else:
            back = codec.unpack_awsets(arrays, d)
            jback = jax_codec.unpack_awsets(want, jd)
        assert [_state(r) for r in back] == [_state(r) for r in jback]


def test_pack_unpack_counters_past_2_31():
    a = spec.AWSetDelta(actor=1, version_vector=spec.VersionVector(
        [0xFFFFFFFF, 0x80000000]), delta_semantics="v2")
    a.entries["x"] = spec.Dot(1, 0x80000000)
    a.deleted["y"] = spec.Dot(0, 0xFFFFFFFF)
    a.processed = {0: 0xFFFFFFF0, 1: 0x80000000}
    d = codec.ElementDict(capacity=2)
    arrays = codec.pack_awset_deltas([a], d, 2)
    state = awset_delta.from_arrays(arrays, device="cpu")
    back = codec.unpack_awset_deltas(state._asdict(), d)[0]
    assert str(back) == str(a) and back.deleted == a.deleted
    assert back.processed == a.processed


def test_element_dict_matches_jax():
    ours, theirs = codec.ElementDict(capacity=4), jax_codec.ElementDict(4)
    for k in ("b", "a", "b", "c"):
        assert ours.encode(k) == theirs.encode(k)
    assert len(ours) == len(theirs) == 3 and "a" in ours
    with pytest.raises(OverflowError) as e1:
        ours.encode_many(["d", "e"])
    with pytest.raises(OverflowError) as e2:
        theirs.encode_many(["d", "e"])
    assert str(e1.value) == str(e2.value)
    ours.grow()
    theirs.grow()
    assert ours.state_dict() == theirs.state_dict()
    back = codec.ElementDict.from_state_dict(theirs.state_dict())
    assert back.state_dict() == theirs.state_dict()
    assert [back.decode(i) for i in range(len(back))] == ["b", "a", "c", "d"]


@pytest.mark.parametrize("delta", [False, True])
def test_grow_matches_jax(delta):
    jst = jax_awd.init(3, 8, 3) if delta else jax_awset.init(3, 8, 3)
    mod = jax_awd if delta else jax_awset
    for r, e in ((0, 1), (1, 5), (2, 7), (0, 5)):
        jst = mod.add_element(jst, np.uint32(r), np.uint32(e))
    st = to_torch(jst)
    assert_same(jax_codec.grow_elements(jst, 20),
                codec.grow_elements(st, 20))
    assert_same(jax_codec.grow_actors(jst, 7), codec.grow_actors(st, 7))
    assert codec.grow_elements(st, 8) is st
    jd, d = jax_codec.ElementDict(capacity=8), codec.ElementDict(capacity=8)
    assert_same(jax_codec.grow_universe(jd, jst, 4),
                codec.grow_universe(d, st, 4))
    assert d.capacity == jd.capacity == 32
    for fn, arg, msg in ((codec.grow_elements, 4, "cannot shrink element"),
                         (codec.grow_actors, 2, "cannot shrink actor")):
        with pytest.raises(ValueError, match=msg):
            fn(st, arg)
    with pytest.raises(TypeError, match="AWSet state family"):
        codec.grow_elements(type("NoPresence", (), {})(), 9)


# -- native codec -------------------------------------------------------------


@pytest.fixture
def natives():
    """The port's native library, or a skip where g++ is missing.  The
    JAX side is its Python path, which its own tests hold byte for byte
    against its native one (building the JAX library here could race
    tests/test_native_codec.py's build of it in another worker)."""
    if not native.available():
        pytest.skip(f"native codec unavailable: {native.build_error()}")


def test_native_element_dict_matches_jax_and_python(natives):
    values = ["", "a", "ümlaut", "日本", "a", "x" * 40]
    ours = native.NativeElementDict(capacity=8)
    theirs = jax_codec.ElementDict(capacity=8)
    plain = codec.ElementDict(capacity=8)
    assert (ours.encode_many(values) == theirs.encode_many(values)
            == plain.encode_many(values))
    assert ours.state_dict() == theirs.state_dict() == plain.state_dict()
    assert ours.decode_many([3, 0, 2]) == [plain.decode(i)
                                           for i in (3, 0, 2)]
    with pytest.raises(OverflowError):
        ours.encode_many([f"n{i}" for i in range(10)])
    assert len(ours) == 8 and ours.encode("n0") == 5
    ours.grow()
    assert ours.capacity == 16
    back = native.NativeElementDict.from_state_dict(ours.state_dict())
    assert back.state_dict() == ours.state_dict()
    assert isinstance(native.make_element_dict(4, prefer_native=False),
                      codec.ElementDict)
    assert isinstance(native.make_element_dict(4), native.NativeElementDict)
    # the library lives in the package's build directory, not the sources
    assert "/build/" in native._lib_path()


def _payload(rng, e, a):
    st = jax_awd.init(1, e, a)
    present = rng.random(e) < 0.3
    deleted = ~present & (rng.random(e) < 0.2)
    big = rng.integers(0, 1 << 32, e, dtype=np.uint64).astype(np.uint32)
    st = st._replace(
        vv=np.asarray(rng.integers(0, 1 << 32, (1, a), dtype=np.uint64),
                      np.uint32),
        present=present[None],
        dot_actor=np.where(present, rng.integers(0, a, e), 0).astype(
            np.uint32)[None],
        dot_counter=np.where(present, big, 0).astype(np.uint32)[None],
        deleted=deleted[None],
        del_dot_actor=np.where(deleted, rng.integers(0, a, e), 0).astype(
            np.uint32)[None],
        del_dot_counter=np.where(deleted, big, 0).astype(np.uint32)[None])
    row = type(st)(*(np.asarray(x)[0] for x in st))
    dst_vv = rng.integers(0, 5, a).astype(np.uint32)
    jp = jax_delta_ops.delta_extract(row, dst_vv)
    port_row = awset_delta.from_arrays(
        {k: np.asarray(v)[None] for k, v in row._asdict().items()},
        device="cpu")
    p = delta_ops.delta_extract(type(port_row)(*(x[0] for x in port_row)),
                                torch.from_numpy(dst_vv.view(np.int32)))
    return jp, p


@pytest.mark.parametrize("e,a", [(1, 1), (40, 5), (130, 7), (1000, 16)])
def test_native_wire_bytes_match_jax_and_python(natives, e, a):
    rng = np.random.default_rng(e)
    for _ in range(3):
        jp, p = _payload(rng, e, a)
        want = jax_wire.encode_payload(jp, prefer_native=False)
        assert wire.encode_payload(p) == want
        assert wire.encode_payload(p, prefer_native=False) == want
        for prefer in (True, False):
            q = wire.decode_payload(want, e, a, src_actor=3,
                                    prefer_native=prefer)
            jq = jax_wire.decode_payload(want, e, a, src_actor=3,
                                         prefer_native=False)
            for name in jq._fields:
                assert np.array_equal(np.asarray(getattr(q, name)),
                                      np.asarray(getattr(jq, name))), name


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_native_codec_at_the_serve_shape_matches_jax(natives, kind):
    """chip_smoke.py phase 1's check at one serve node's shape (E =
    1,024, A = 16) on its seeded sparse and dense δ: the native bytes
    equal the Python codec's and the JAX package's, and the payload
    decodes back both ways."""
    import chip_smoke

    from go_crdt_playground_tpu_torch._host import host

    p = chip_smoke.codec_payloads()[kind]
    jp = jax_delta_ops.DeltaPayload(*(host(x) for x in p))
    body = wire.encode_payload(p, prefer_native=True)
    assert body == wire.encode_payload(p, prefer_native=False)
    assert body == jax_wire.encode_payload(jp, prefer_native=False)
    for prefer in (True, False):
        back = wire.decode_payload(body, chip_smoke.CODEC_E,
                                   chip_smoke.CODEC_A, src_actor=3,
                                   prefer_native=prefer)
        for name, x, y in zip(p._fields, p, back):
            assert np.array_equal(host(x), np.asarray(y)), name
    assert chip_smoke.check_native_codec()["available"]


def test_native_wire_rejects_what_the_jax_codec_rejects(natives):
    rng = np.random.default_rng(9)
    jp, p = _payload(rng, 40, 5)
    buf = wire.encode_payload(p)
    for bad, e in ((buf[:-1], 40), (buf + b"\x00", 40), (buf, 41),
                   (b"", 40), (b"\x05" + buf[1:], 40)):
        with pytest.raises(ValueError):
            jax_wire.decode_payload(bad, e, 5, prefer_native=False)
        for prefer in (True, False):
            with pytest.raises(ValueError):
                wire.decode_payload(bad, e, 5, prefer_native=prefer)


# -- checkpoints carrying an element dictionary -------------------------------


def test_dictionary_checkpoints_restore_across_packages(tmp_path):
    reps = _histories(jax_spec, 4)
    jd = jax_codec.ElementDict(capacity=16)
    jst = jax_awd.from_arrays(jax_codec.pack_awset_deltas(reps, jd, 3))
    d = codec.ElementDict.from_state_dict(jd.state_dict())
    # JAX -> port, through the store
    jax_ckpt.CheckpointStore(str(tmp_path / "j")).save(jst, dictionary=jd,
                                                       step=4)
    gen, ck = ckpt.CheckpointStore(str(tmp_path / "j")).restore(device="cpu")
    assert gen == 1 and ck.step == 4
    assert ck.dictionary.state_dict() == jd.state_dict()
    assert_same(jst, ck.state)
    # port -> JAX, single file and store
    ckpt.save_checkpoint(str(tmp_path / "t.ckpt"), to_torch(jst),
                         dictionary=d, metadata={"m": 1})
    jck = jax_ckpt.restore_checkpoint(str(tmp_path / "t.ckpt"))
    assert jck.dictionary.state_dict() == d.state_dict()
    assert jck.metadata == {"m": 1}
    assert_same(jck.state, to_torch(jst))
    ckpt.CheckpointStore(str(tmp_path / "t")).save(to_torch(jst),
                                                   dictionary=d)
    _, jck = jax_ckpt.CheckpointStore(str(tmp_path / "t")).restore()
    assert jck.dictionary.state_dict() == d.state_dict()
    # a dictionary-free checkpoint restores with None
    ckpt.save_checkpoint(str(tmp_path / "n.ckpt"), to_torch(jst))
    assert ckpt.restore_checkpoint(str(tmp_path / "n.ckpt"),
                                   device="cpu").dictionary is None
