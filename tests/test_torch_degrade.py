"""The port's utils/degrade.DegradeWindow: the scenarios of
tests/test_degrade.py run on the port's class (each JAX test function
rebound to it, so the scenarios are the reference's own code), plus the
port's window and the reference's driven side by side through one
random arm/clear/advance schedule to the same states."""

import types

import numpy as np
import pytest

import tests.test_degrade as reference
from go_crdt_playground_tpu.utils.degrade import \
    DegradeWindow as JaxDegradeWindow
from go_crdt_playground_tpu_torch.utils.degrade import DegradeWindow

SCENARIOS = sorted(name for name in vars(reference)
                   if name.startswith("test_"))


@pytest.mark.parametrize("name", SCENARIOS)
def test_reference_scenario_on_the_port(name):
    fn = getattr(reference, name)
    rebound = types.FunctionType(
        fn.__code__, dict(vars(reference), DegradeWindow=DegradeWindow),
        fn.__name__, fn.__defaults__, fn.__closure__)
    rebound()


def test_port_and_reference_windows_agree():
    rng = np.random.default_rng(4)
    clk = reference.FakeClock()
    port, ref = DegradeWindow(0.7, clk), JaxDegradeWindow(0.7, clk)
    for _ in range(300):
        step = rng.integers(3)
        if step == 0:
            assert port.arm() == ref.arm()
        elif step == 1:
            port.clear()
            ref.clear()
        else:
            clk.t += float(rng.random())
        assert (port.active(), port.armed_ever(), port.windows) == \
            (ref.active(), ref.armed_ever(), ref.windows)
