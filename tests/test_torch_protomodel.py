"""The port's protocol model checker (go_crdt_playground_tpu_torch/
analysis/protomodel.py) against the JAX package's.

The three models (router HA, shard replication, handoff) are pure
Python and come over as they are: every model and every bug-flagged
twin explores to the reference's state and transition counts and
violations.  The mirror table is pinned against the port's own
segments; each differs from the reference's pinned segment at most in
the package its function-scope imports name, and a drifted segment
fails the gate with MODEL_STALE."""

import os
import shutil

import pytest

from go_crdt_playground_tpu.analysis import protomodel as jax_protomodel
from go_crdt_playground_tpu_torch.analysis import protomodel
from go_crdt_playground_tpu_torch.analysis.epoch_order import _find_function
from go_crdt_playground_tpu_torch.analysis.loader import SourceLoader
from go_crdt_playground_tpu_torch.analysis.protomodel import (
    HandoffModel, MirrorSpec, RouterHAModel, ShardReplModel, explore)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_ROOT = os.path.join(REPO, "go_crdt_playground_tpu_torch")
JAX_ROOT = os.path.join(REPO, "go_crdt_playground_tpu")

MODELS = {"router_ha": (RouterHAModel, jax_protomodel.RouterHAModel),
          "shard_repl": (ShardReplModel, jax_protomodel.ShardReplModel),
          "handoff": (HandoffModel, jax_protomodel.HandoffModel)}
TWINS = [("router_ha", "announce_before_persist"),
         ("shard_repl", "ack_without_coverage"),
         ("handoff", "swap_before_persist"),
         ("handoff", "fence_blocks_reads")]


def _summary(result):
    return (result.states, result.transitions, result.complete,
            sorted((v.message, v.trace) for v in result.violations))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_models_explore_like_the_reference(name):
    port, ref = MODELS[name]
    got, want = explore(port()), explore(ref())
    assert _summary(got) == _summary(want)
    assert got.complete and got.violations == ()
    assert got.states >= 10 and got.transitions >= got.states


@pytest.mark.parametrize("name,bug", TWINS)
def test_bug_twins_caught_like_the_reference(name, bug):
    port, ref = MODELS[name]
    got, want = explore(port(bug)), explore(ref(bug))
    assert got.violations, (name, bug)
    assert _summary(got) == _summary(want)


def test_gate_pass_counts_equal_the_reference():
    f, s = protomodel.analyze(PKG_ROOT)
    jf, js = jax_protomodel.analyze(JAX_ROOT)
    assert not f and not jf, [x.render() for x in f + jf]
    assert s["models"] == js["models"]
    assert s["total_states"] == js["total_states"]


def test_mirror_table_names_the_reference_symbols():
    got = [(m.model, m.path, m.qualname) for m in protomodel.MODEL_MIRRORS]
    want = [(m.model, m.path, m.qualname)
            for m in jax_protomodel.MODEL_MIRRORS]
    assert got == want


@pytest.mark.parametrize("spec", protomodel.MODEL_MIRRORS,
                         ids=lambda m: m.qualname)
def test_mirrored_segment_is_the_reference_segment(spec):
    """The re-verification behind each pin: the port's segment is the
    reference's, line for line, apart from the package its imports
    name, so the model's transitions mirror it as they mirror the
    reference."""
    loader = SourceLoader()
    segs = []
    for root in (JAX_ROOT, PKG_ROOT):
        pf = loader.load(os.path.join(root, spec.path))
        fn = _find_function(pf.tree, spec.qualname)
        assert fn is not None, (root, spec.qualname)
        segs.append(pf.source.splitlines()[fn.lineno - 1:fn.end_lineno])
    ref, port = segs
    assert [ln.replace("go_crdt_playground_tpu_torch",
                       "go_crdt_playground_tpu") for ln in port] == ref


def test_mirrors_fresh_against_the_port_tree():
    f, s = protomodel.check_freshness(PKG_ROOT)
    assert not f, [x.render() for x in f]
    assert s["fresh"] == s["mirrored_symbols"] >= 10


def test_drifted_segment_raises_model_stale(tmp_path):
    """Edit one mirrored protocol function in a copy of the port: the
    freshness check fails with E003 on that symbol alone."""
    root = tmp_path / "pkg"
    shutil.copytree(PKG_ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    path = root / "shard" / "router.py"
    src = path.read_text()
    needle = "    def set_fence(self"
    assert src.count(needle) == 1
    path.write_text(src.replace(needle, needle + ", *_drift", 1))
    f, s = protomodel.check_freshness(str(root))
    assert [x.symbol for x in f] == ["ShardRouter.set_fence"]
    assert f[0].code == "E003" and "stale" in f[0].message
    assert s["fresh"] == s["mirrored_symbols"] - 1


def test_stale_mirror_hash_detected():
    bad = (MirrorSpec("router_ha", "shard/ha.py",
                      "RouterStandby._promote_locked",
                      "deadbeefdeadbeef"),)
    f, _ = protomodel.check_freshness(PKG_ROOT, mirrors=bad)
    assert len(f) == 1 and f[0].code == "E003"
    assert "stale" in f[0].message
    assert "go_crdt_playground_tpu_torch.analysis.protomodel" in f[0].message


def test_vanished_mirror_symbol_detected():
    bad = (MirrorSpec("router_ha", "shard/ha.py",
                      "RouterStandby._promote_differently",
                      "deadbeefdeadbeef"),)
    f, _ = protomodel.check_freshness(PKG_ROOT, mirrors=bad)
    assert len(f) == 1 and f[0].code == "E003"
    assert "no longer exists" in f[0].message


def test_state_cap_is_loud_not_silent():
    r = explore(ShardReplModel(), max_states=20)
    assert not r.complete
    f, s = protomodel.analyze(
        PKG_ROOT, models=(("shard_repl", ShardReplModel),),
        mirrors=(), max_states=20)
    assert any(x.code == "E004" and "cap" in x.message for x in f)
    assert s["models"]["shard_repl"]["complete"] is False
