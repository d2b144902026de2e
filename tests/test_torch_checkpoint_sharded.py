"""The port's sharded checkpoints (utils/checkpoint_sharded.py: one file
a slot plus a manifest) against the JAX package's orbax checkpoints:
the same state saved by each package restores to the same arrays,
bitwise (the scenarios of tests/test_checkpoint.py:139, 166)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from go_crdt_playground_tpu.models import awset as jax_awset
from go_crdt_playground_tpu.models import awset_delta as jax_awset_delta
from go_crdt_playground_tpu.parallel import mesh as jm
from go_crdt_playground_tpu.utils import checkpoint_sharded as jcs
from go_crdt_playground_tpu_torch.parallel import mesh as tm
from go_crdt_playground_tpu_torch.utils import checkpoint_sharded as cs
from go_crdt_playground_tpu_torch.utils.checkpoint import (
    GenerationRegression, UnsupportedCheckpoint)
from tests.test_torch_models import to_torch


def _assert_restored_equal(jax_state, port_state):
    for name in jax_state._fields:
        w = np.asarray(getattr(jax_state, name))
        g = getattr(port_state, name)
        g = g.numpy() if g.dtype == torch.bool else g.numpy().view(np.uint32)
        assert g.dtype == w.dtype and np.array_equal(g, w), name


def test_sharded_checkpoint_roundtrip_on_mesh(tmp_path):
    st = jax_awset_delta.init(16, 32, 16)
    st = jax_awset_delta.add_element(st, np.uint32(3), np.uint32(7))
    m = jm.make_mesh((4, 2))
    jpath = jcs.save_checkpoint_sharded(str(tmp_path / "jax"),
                                        jm.shard_state(st, m), step=5,
                                        metadata={"round": 1})
    want = jcs.restore_checkpoint_sharded(jpath,
                                          target=jm.shard_state(st, m))
    pm = tm.make_mesh((4, 2), devices=["cpu"] * 8)
    sharded = tm.shard_state(to_torch(st), pm)
    path = cs.save_checkpoint_sharded(str(tmp_path / "ck"), sharded, step=5,
                                      metadata={"round": 1}, generation=3)
    assert sorted(os.listdir(path)) == sorted(
        ["manifest.json"] + [f"slot-{i}-{j}.npz" for i in range(4)
                             for j in range(2)])
    ck = cs.restore_checkpoint_sharded(path, target=sharded, device="cpu")
    assert ck.step == want.step == 5
    assert ck.metadata == want.metadata == {"round": 1}
    assert isinstance(ck.state, tm.ShardedState) and ck.state.mesh == pm
    assert ck.state.state_cls.__name__ == type(want.state).__name__ \
        == "AWSetDeltaState"
    for idx in pm.slots():
        assert all(torch.equal(a, b) for a, b in zip(
            ck.state.block(idx), sharded.block(idx)))
    _assert_restored_equal(want.state, tm.gather_state(ck.state))
    # the generation fence
    with pytest.raises(GenerationRegression):
        cs.restore_checkpoint_sharded(path, target=sharded,
                                      min_generation=4, device="cpu")
    # a layout the checkpoint was not written in is refused
    with pytest.raises(ValueError, match="target mesh"):
        cs.restore_checkpoint_sharded(
            path, target=tm.shard_state(to_torch(st), tm.make_mesh(
                (8, 1), devices=["cpu"] * 8)), device="cpu")


def test_sharded_checkpoint_restore_without_target(tmp_path):
    st = jax_awset.init(4, 8, 4)
    st = jax_awset.add_element(st, np.uint32(1), np.uint32(5))
    want = jcs.restore_checkpoint_sharded(
        jcs.save_checkpoint_sharded(str(tmp_path / "jax"), st))
    path = cs.save_checkpoint_sharded(str(tmp_path / "ck2"), to_torch(st))
    ck = cs.restore_checkpoint_sharded(path, device="cpu")
    _assert_restored_equal(want.state, ck.state)
    # a manifest with an element dictionary is refused, typed
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["dictionary"] = {"capacity": 8, "values": ["a"]}
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(UnsupportedCheckpoint):
        cs.restore_checkpoint_sharded(path, device="cpu")
