"""The port's merge-decision traces (ops/merge.py with_trace,
ops/delta.delta_apply_traced) and their renderings (obs/trace.py)
against the JAX package's: the decision tensors bitwise, the lines, the
boxed dump and the outcome counts byte for byte."""

import random

import numpy as np
import pytest

from go_crdt_playground_tpu import obs as jax_obs
from go_crdt_playground_tpu.models import awset as jax_awset
from go_crdt_playground_tpu.models import awset_delta as jax_awd
from go_crdt_playground_tpu.models import spec as jax_spec
from go_crdt_playground_tpu.ops import delta as jax_delta
from go_crdt_playground_tpu.ops import merge as jax_merge
from go_crdt_playground_tpu.utils import codec as jax_codec
from go_crdt_playground_tpu_torch import obs
from go_crdt_playground_tpu_torch.models import awset, spec
from go_crdt_playground_tpu_torch.ops import delta as delta_ops
from go_crdt_playground_tpu_torch.ops import merge as merge_ops
from go_crdt_playground_tpu_torch.utils import codec
from tests.test_torch_codec import _histories
from tests.test_torch_models import assert_same, to_torch

MODES = [("v2", True), ("reference", True), ("reference", False)]


def _row(state, r):
    return type(state)(*(x[r] for x in state))


def _packed(seed, delta, n=3, sem="v2"):
    reps = _histories(jax_spec, seed, n=n, delta=delta, sem=sem)
    d = jax_codec.ElementDict(capacity=16)
    if delta:
        return jax_awd.from_arrays(jax_codec.pack_awset_deltas(reps, d, n)), d
    return jax_awset.from_arrays(jax_codec.pack_awsets(reps, d, n)), d


def _same_trace(jtrace, trace):
    for name in ("phase1", "phase2"):
        want = np.asarray(getattr(jtrace, name))
        got = getattr(trace, name).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), name


@pytest.mark.parametrize("seed", range(4))
def test_merge_trace_and_rendering_match_jax(seed):
    jst, d = _packed(seed, delta=False)
    st = to_torch(jst)
    for r_dst, r_src in ((0, 1), (1, 2), (2, 0), (1, 1)):
        jout, jtrace = jax_merge.merge_one_into(jst, r_dst, jst, r_src,
                                                with_trace=True)
        out, trace = merge_ops.merge_one_into(st, r_dst, st, r_src,
                                              with_trace=True)
        assert_same(jout, out)
        _same_trace(jtrace, trace)
        jdst, jsrc = _row(jst, r_dst), _row(jst, r_src)
        args = dict(key_of=d.decode)
        assert obs.render_tensor_trace(
            trace, _row(st, r_dst), _row(st, r_src), **args) == \
            jax_obs.render_tensor_trace(jtrace, jdst, jsrc, **args)
        assert obs.trace_counts(trace) == jax_obs.trace_counts(jtrace)
    # batched traces count alike
    _, jtrace = jax_merge.merge_pairwise(jst, jst, with_trace=True)
    _, trace = merge_ops.merge_pairwise(st, st, with_trace=True)
    assert obs.trace_counts(trace) == jax_obs.trace_counts(jtrace)
    with pytest.raises(ValueError, match="single-replica"):
        obs.render_tensor_trace(trace, st, st)


@pytest.mark.parametrize("sem,strict", MODES)
@pytest.mark.parametrize("seed", range(3))
def test_delta_apply_traced_matches_jax(seed, sem, strict):
    jst, d = _packed(seed + 10, delta=True, sem=sem)
    st = to_torch(jst)
    for r_dst, r_src in ((0, 1), (2, 1), (1, 0)):
        jsrc, jdst = _row(jst, r_src), _row(jst, r_dst)
        src, dst = _row(st, r_src), _row(st, r_dst)
        jp = jax_delta.delta_extract(jsrc, jdst.vv)
        p = delta_ops.delta_extract(src, dst.vv)
        jout, jtrace = jax_delta.delta_apply_traced(jdst, jp, sem, strict)
        out, trace = delta_ops.delta_apply_traced(dst, p, sem, strict)
        assert_same(jout, out)
        _same_trace(jtrace, trace)
        # untraced apply agrees with the traced one
        assert_same(jout, delta_ops.delta_apply(dst, p, sem, strict))
        assert obs.render_delta_tensor_trace(
            trace, dst, p, key_of=d.decode, delta_semantics=sem) == \
            jax_obs.render_delta_tensor_trace(
                jtrace, jdst, jp, key_of=d.decode, delta_semantics=sem)
        assert obs.format_delta_extract_tensor(p, key_of=d.decode) == \
            jax_obs.format_delta_extract_tensor(jp, key_of=d.decode)
        assert obs.trace_counts(trace) == jax_obs.trace_counts(jtrace)


def test_spec_traces_render_alike():
    """The port's spec model logs the events the JAX spec logs, and the
    two renderers print them alike (awset.go:120's format)."""
    rng = random.Random(3)
    for delta in (False, True):
        ours = _histories(spec, 7, delta=delta)
        theirs = _histories(jax_spec, 7, delta=delta)
        ev, jev = [], []
        ours[0].trace, theirs[0].trace = ev.append, jev.append
        for _ in range(20):
            src = rng.randrange(1, 3)
            ours[0].merge(ours[src])
            theirs[0].merge(theirs[src])
            ours[src].add("k1")
            theirs[src].add("k1")
        assert [tuple(e) for e in ev] == [tuple(e) for e in jev]
        assert obs.render_spec_trace(ev) == jax_obs.render_spec_trace(jev)
        assert [obs.format_event(e) for e in jev] == \
            [jax_obs.format_event(e) for e in jev]
        changed, deleted = theirs[1].make_delta_merge_data(
            theirs[0].version_vector) if delta else ({}, None)
        assert obs.format_delta_extract(changed, deleted) == \
            jax_obs.format_delta_extract(changed, deleted)


def test_printstate_matches_jax():
    reps = _histories(spec, 2)
    jreps = _histories(jax_spec, 2)
    assert obs.printstate(reps) == jax_obs.printstate(jreps)
    assert obs.printstate(reps[:2], names=["X", "Y"]) == \
        jax_obs.printstate(jreps[:2], names=["X", "Y"])
    d = codec.ElementDict(capacity=16)
    rendered = codec.render_packed(codec.pack_awset_deltas(reps, d, 3), d)
    assert obs.printstate(rendered) == jax_obs.printstate(jreps)
    with pytest.raises(ValueError, match="never silently drop"):
        obs.printstate(reps, names=["A"])


def test_trace_exports_load_lazily_and_the_kernel_cannot_trace():
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys\n"
            "import go_crdt_playground_tpu_torch.obs as o\n"
            "assert 'torch' not in sys.modules\n"
            "o.printstate\n"
            "assert 'torch' in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parent.parent)
    st = awset.init(2, 4, 2, device="cpu")
    with pytest.raises(ValueError, match="no kernel emits"):
        merge_ops.merge_one_into(st, 0, st, 1, with_trace=True,
                                 kernel="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        merge_ops.merge_one_into(st, 0, st, 1, kernel="cuda")
