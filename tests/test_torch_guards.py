"""The port's utils/guards.py against the JAX package's: uint32 headroom
read unsigned from int32 bits (clocks at 2^31 and 2^32 - 1 included), the
overflow error, and the shim install registry."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_crdt_playground_tpu.utils import guards as jax_guards
from go_crdt_playground_tpu_torch._u32 import widen
from go_crdt_playground_tpu_torch.models import awset
from go_crdt_playground_tpu_torch.utils import guards

CLOCKS = [0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001,
          0xFFFFFFFF - (1 << 20) - 1, 0xFFFFFFFF - (1 << 20),
          0xFFFFFFFF - (1 << 20) + 1, 0xFFFFFFFE, 0xFFFFFFFF]


def _vv(top: int) -> np.ndarray:
    vv = np.zeros((3, 4), np.uint32)
    vv[1, 2] = top
    vv[2, 0] = top // 2
    return vv


@pytest.mark.parametrize("top", CLOCKS)
@pytest.mark.parametrize("margin", [0, 10, 1 << 20])
def test_headroom_matches_jax(top, margin):
    vv = _vv(top)
    port = torch.from_numpy(vv.view(np.int32))
    want = int(jax_guards.counter_headroom(jnp.asarray(vv)))
    assert int(widen(guards.counter_headroom(port))) == want
    assert bool(guards.overflow_risk(port, margin)) == bool(
        jax_guards.overflow_risk(jnp.asarray(vv), margin))
    state = awset.init(3, 2, 4, device="cpu")._replace(vv=port)
    jstate = type("S", (), {"vv": jnp.asarray(vv)})()
    try:
        jax_guards.check_headroom(jstate, margin)
    except OverflowError as exc:
        with pytest.raises(OverflowError) as ours:
            guards.check_headroom(state, margin)
        assert str(ours.value) == str(exc)
    else:
        assert guards.check_headroom(state, margin) is state


def test_headroom_at_2_31_reads_unsigned():
    vv = torch.tensor([[0, -(1 << 31)]], dtype=torch.int32)   # 2^31
    assert int(widen(guards.counter_headroom(vv))) == (1 << 31) - 1
    assert not bool(guards.overflow_risk(vv))
    full = torch.tensor([[-1]], dtype=torch.int32)             # 2^32 - 1
    assert int(widen(guards.counter_headroom(full))) == 0
    assert bool(guards.overflow_risk(full))
    assert guards.overflow_risk(full).device == full.device
    assert guards.UINT32_MAX == jax_guards.UINT32_MAX
    assert guards.DEFAULT_MARGIN == jax_guards.DEFAULT_MARGIN


def test_install_guard_matches_jax():
    for mod in (guards, jax_guards):
        g = mod.InstallGuard()
        g.install("k", owner="first-owner")
        with pytest.raises(mod.AlreadyInstalledError) as ei:
            g.install("k", owner="second")
        assert "first-owner" in str(ei.value)
        g.uninstall("k")
        assert not g.installed("k")
        with pytest.raises(KeyError):
            g.uninstall("k")
    assert isinstance(guards.SHIM_GUARD, guards.InstallGuard)


def test_install_guard_is_thread_safe():
    g = guards.InstallGuard()
    wins, losses = [], []

    def claim():
        try:
            g.install("contended")
            wins.append(1)
        except guards.AlreadyInstalledError:
            losses.append(1)

    ts = [threading.Thread(target=claim) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(wins) == 1 and len(losses) == 7
