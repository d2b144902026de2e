"""tools/torch_soak_differential.py on the CPU: the port's plain versions
held bitwise against the JAX package's XLA rounds and Pallas kernels
(interpret mode) at fixed seeds, the draws equal to
tools/soak_differential.py's (a failing seed replays in both
packages), and a planted divergence reported with its seed, field and
lane.  On the card the soak holds the kernels against the plain
versions (tests/test_torch_cuda.py, chip_smoke.py phase 16b)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import soak_differential as jax_soak  # noqa: E402
import torch_soak_differential as soak  # noqa: E402


def _reference_draw(seed):
    """tools/soak_differential.py's one_iteration, up to its first
    kernel call: the shapes and states it draws from ``seed``."""
    rng = np.random.default_rng(seed)
    if rng.random() < 0.12:
        num_r, num_e = 128, int(rng.integers(4097, 8200))
    else:
        num_r = 64 * int(rng.integers(2, 7))
        num_e = int(rng.integers(8, 520))
    num_a = int(rng.integers(2, 257))
    offset = int(rng.integers(1, num_r))
    state = jax_soak.rand_state(rng, num_r, num_e, num_a)
    perm = np.asarray(rng.permutation(num_r).astype(np.uint32))
    stage = None
    if num_r & (num_r - 1) == 0:
        stage = int(rng.integers(0, num_r.bit_length() - 1))
    dstate = jax_soak.rand_delta_state(rng, num_r, num_e, num_a)
    return num_r, num_e, num_a, offset, state, perm, stage, dstate


@pytest.mark.parametrize("seed", range(0, 40, 3))
def test_draws_are_the_reference_tools(seed):
    num_r, num_e, num_a, offset, state, perm, stage, dstate = \
        _reference_draw(seed)
    d = soak.draw(seed)
    assert (d["R"], d["E"], d["A"], d["offset"], d["stage"]) == \
        (num_r, num_e, num_a, offset, stage)
    assert np.array_equal(d["perm"], perm)
    for name in state._fields:
        assert np.array_equal(d["full"][name],
                              np.asarray(getattr(state, name))), name
    for name in dstate._fields:
        assert np.array_equal(d["delta"][name],
                              np.asarray(getattr(dstate, name))), name


def test_cli_holds_the_plain_versions_against_jax(capsys):
    """One iteration through the CLI at a power-of-two R (butterfly
    included): exit 0, the summary line."""
    assert soak.main(["5", "--device", "cpu", "--seed", "2",
                      "--iterations", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])
    assert "0 divergences" in out[-2]
    assert summary["iterations"] == 1 and summary["divergence"] is None
    assert summary["R"] == [128, 128] and summary["kernels"] == []
    assert summary["against"] == "JAX XLA and Pallas (interpret)"


def test_run_holds_the_plain_versions_against_jax():
    """A second fixed seed: R = 192 (no butterfly), E = 513."""
    res = soak.run(5.0, device="cpu", seed0=8, iterations=1,
                   log=lambda m: None)
    assert res["divergence"] is None and res["iterations"] == 1
    assert res["R"] == [192, 192] and res["E"] == [513, 513]


@pytest.mark.slow
def test_run_crosses_the_pack_chunk_against_jax():
    """E past 4,096 (two pack chunks; about 25 s on one CPU worker,
    hence slow)."""
    res = soak.run(5.0, device="cpu", seed0=3, iterations=1,
                   log=lambda m: None)
    assert res["divergence"] is None and res["E"] == [4833, 4833]


def test_planted_divergence_names_seed_field_and_lane(monkeypatch,
                                                      capsys):
    from go_crdt_playground_tpu_torch.ops import cuda_merge

    real = cuda_merge.ring_round_rows

    def off_by_one_lane(state, offset, kernel="auto"):
        out = real(state, offset, kernel=kernel)
        present = out.present.clone()
        present[1, 2] = ~present[1, 2]
        return out._replace(present=present)

    monkeypatch.setattr(cuda_merge, "ring_round_rows", off_by_one_lane)
    with pytest.raises(soak.Divergence,
                       match="bool-ring plain: field present diverged "
                             "at row 1, lane 2"):
        soak.one_iteration(11, "cpu")
    monkeypatch.setattr(soak, "_jax_side", lambda: None)
    assert soak.main(["5", "--device", "cpu", "--seed", "11",
                      "--iterations", "3"]) == 1
    out = capsys.readouterr().out
    assert "DIVERGENCE at seed=11: bool-ring plain: field present " \
           "diverged at row 1, lane 2" in out
    assert json.loads(out.strip().splitlines()[-1])["divergence"][
        "seed"] == 11


def test_cuda_is_the_default_and_needs_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is served")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        soak.main(["1", "--iterations", "1"])


@pytest.mark.parametrize("seed", range(0, 40, 5))
def test_k5_leg_draws_few_long_rows_of_its_own(seed):
    """The card's K5 leg draws R 1-8, E 8-70,000, A 2-256 and a perm of
    rows in range, the same from the same seed, from a stream that
    leaves the reference draws (``draw``) as they were."""
    before = soak.draw(seed)
    k = soak.draw_k5(seed)
    assert 1 <= k["R"] <= 8 and 8 <= k["E"] <= 70_000 and 2 <= k["A"] <= 256
    assert k["perm"].shape == (k["R"],)
    assert ((k["perm"] >= 0) & (k["perm"] < k["R"])).all()
    assert k["delta"]["present"].shape == (k["R"], k["E"])
    again = soak.draw_k5(seed)
    for name, v in k["delta"].items():
        assert np.array_equal(v, again["delta"][name]), name
    after = soak.draw(seed)
    assert np.array_equal(before["perm"], after["perm"])
    for name, v in before["delta"].items():
        assert np.array_equal(v, after["delta"][name]), name
