"""The port's admission scheduler (serve/scheduler.py) against the JAX
package's: key-runs, the single-chunk placement and the scheduler's
emission on seeded zipf key lists, equal element for element; and the
durable-order contract on the port's 2-D mesh (a scheduled stream lands
bitwise where a plain node fed the emitted log lands)."""

import numpy as np
import pytest
import torch

from go_crdt_playground_tpu.serve import scheduler as jax_sched
from go_crdt_playground_tpu_torch.net.peer import Node
from go_crdt_playground_tpu_torch.obs import Recorder
from go_crdt_playground_tpu_torch.parallel.meshtarget2d import (
    Mesh2DApplyTarget, plan_stripes)
from go_crdt_playground_tpu_torch.serve.scheduler import (ConflictScheduler,
                                                          key_runs,
                                                          plan_emit)

E2, A2 = 256, 4


class _Op:
    def __init__(self, req_id, elements):
        self.req_id = req_id
        self.elements = list(elements)


def _zipf_lists(rng, n, s, keys_per_op=(1, 3)):
    p = np.arange(1, E2 + 1, dtype=np.float64) ** -s
    p /= p.sum()
    return [[int(k) for k in rng.choice(
        E2, size=int(rng.integers(*keys_per_op)), p=p)] for _ in range(n)]


@pytest.mark.parametrize("s", [0.99, 1.2])
def test_key_runs_and_plan_emit_match_jax_on_zipf(s):
    rng = np.random.default_rng(7 if s < 1 else 8)
    for _ in range(40):
        lists = _zipf_lists(rng, int(rng.integers(1, 33)), s)
        if rng.random() < 0.2:
            lists[int(rng.integers(len(lists)))] = []
        assert key_runs(lists) == jax_sched.key_runs(lists)
        for dp, cap in ((1, 8), (2, 4), (4, 2), (4, 8)):
            assert plan_emit(lists, dp, cap) == jax_sched.plan_emit(
                lists, dp, cap)
    for bad in ((0, 4), (2, 0)):
        with pytest.raises(ValueError):
            plan_emit([[1]], *bad)
        with pytest.raises(ValueError):
            jax_sched.plan_emit([[1]], *bad)


def test_scheduler_emission_and_metrics_match_jax():
    rng = np.random.default_rng(9)
    from go_crdt_playground_tpu.obs import Recorder as JaxRecorder

    mine, ref = Recorder(), JaxRecorder()
    ours = ConflictScheduler(4, recorder=mine)
    theirs = jax_sched.ConflictScheduler(4, recorder=ref)
    for _ in range(10):
        batch = [_Op(i, ks) for i, ks in enumerate(
            _zipf_lists(rng, int(rng.integers(2, 33)), 1.2))]
        e1, h1, c1 = ours.schedule(batch, 32)
        e2, h2, c2 = theirs.schedule(batch, 32)
        assert [r.req_id for r in e1] == [r.req_id for r in e2]
        assert h1.dtype == h2.dtype and np.array_equal(h1, h2)
        assert [r.req_id for r in c1] == [r.req_id for r in c2]
    a, b = mine.snapshot(), ref.snapshot()
    assert a["counters"] == b["counters"]
    assert a["gauges"] == b["gauges"]
    with pytest.raises(ValueError):
        ConflictScheduler(0)


@pytest.mark.parametrize("shape", ["2x2", "4x2"])
def test_mesh2d_scheduled_stream_bitwise_parity(shape):
    """The scheduler's emission and hints, batch after batch with
    carryover, plan with zero cuts, and the port's dp x mp mesh lands
    bitwise where a plain node fed the emitted log lands."""
    dp = int(shape.split("x")[0])
    rng = np.random.default_rng(31)
    mb = 2
    width = dp * mb
    sched = ConflictScheduler(dp)
    plain = Node(0, E2, A2, device="cpu")
    mesh = Mesh2DApplyTarget(0, E2, A2, mesh_shape=shape, device="cpu")
    next_id, carry, total_cuts = 0, [], 0
    p = np.arange(1, E2 + 1, dtype=np.float64) ** -1.2
    p /= p.sum()
    for _ in range(8):
        n = int(rng.integers(1, width + 1))
        fresh = [_Op(next_id + i, [int(k)])
                 for i, k in enumerate(rng.choice(E2, size=n, p=p))]
        fresh = fresh[:max(0, width - len(carry))]
        next_id += len(fresh)
        emitted, assign, carry = sched.schedule(carry + fresh, width)
        if not emitted:
            continue
        add = np.zeros((width, E2), bool)
        live = np.zeros(width, bool)
        hint = np.full(width, -1, np.int32)
        for j, r in enumerate(emitted):
            add[j, r.elements] = True
            live[j] = True
            hint[j] = assign[j]
        dl = np.zeros((width, E2), bool)
        total_cuts += plan_stripes(add, dl, live, dp, mb, assign=hint)[1]
        plain.ingest_batch(add, dl, live)
        mesh.ingest_batch(add, dl, live, stripe_hint=hint)
    assert total_cuts == 0
    for name, x, y in zip(plain.state_slice()._fields, plain.state_slice(),
                          mesh.state_slice()):
        assert torch.equal(x, y), name


def test_mesh2d_adversarial_hint_is_safe():
    rng = np.random.default_rng(32)
    plain = Node(0, E2, A2, device="cpu")
    mesh = Mesh2DApplyTarget(0, E2, A2, mesh_shape="2x2", device="cpu")
    B = 8
    for trial in range(3):
        add = rng.random((B, E2)) < 0.02
        dl = rng.random((B, E2)) < 0.01
        live = rng.random(B) < 0.9
        hint = np.asarray([0] * B if trial == 0
                          else rng.integers(0, 2, B), np.int32)
        plain.ingest_batch(add, dl, live)
        mesh.ingest_batch(add, dl, live, stripe_hint=hint)
    for name, x, y in zip(plain.state_slice()._fields, plain.state_slice(),
                          mesh.state_slice()):
        assert torch.equal(x, y), name
    with pytest.raises(ValueError, match="stripe hint"):
        mesh.ingest_batch(add, dl, live, stripe_hint=np.zeros(3, np.int32))
