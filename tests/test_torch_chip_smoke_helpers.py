"""chip_smoke.py's own helpers that shorten its run without changing what
it checks, held on the CPU against the plain forms they replace: phase 2
packed's states made one shape ahead (``made_ahead``) and 13d's WAL
replay cut by the striping planner from the rows' set entries alone
(``cut_chunks``, ``flat_nonzero``)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from go_crdt_playground_tpu_torch.parallel.meshtarget2d import (  # noqa: E402
    _row_keys, plan_rows)


def test_states_made_ahead_draw_as_without_the_thread():
    """The same seeded draws in the same order as a plain loop, every
    state equal."""
    shapes = [(64, 16, 5), (128, 300, 256), (64, 640, 5)]

    def maker(rng):
        return lambda i: cs.random_delta_state(rng, *shapes[i], 7, "cpu")

    plain = maker(np.random.default_rng(5))
    want = [plain(i) for i in range(len(shapes))]
    got = list(cs.made_ahead(maker(np.random.default_rng(5)), len(shapes)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(g, w))
    assert list(cs.made_ahead(plain, 0)) == []


def plain_cut_chunks(add, dl, live, dp, hint=None):
    """cut_chunks as the dense masks give it."""
    eff_add, eff_del = add & live[:, None], dl & live[:, None]
    num_b = add.shape[0]
    plans, cuts = plan_rows(
        _row_keys(*np.nonzero(eff_add | eff_del), num_b),
        eff_add.sum(axis=1, dtype=np.int64), eff_del.any(axis=1),
        add.shape[1], dp, max(1, -(-num_b // dp)), hint)
    if len(plans) == 1:
        return [(add, dl, live)], cuts
    out = []
    for p in plans:
        rows = np.sort(p.index[p.index >= 0])
        out.append((eff_add[rows], eff_del[rows], np.ones(rows.size, bool)))
    return out, cuts


@pytest.mark.parametrize("E", [1024, 1027, 4096 + 5])
@pytest.mark.parametrize("dp", [1, 2])
def test_cut_chunks_equal_the_dense_form(E, dp):
    """Rows of one or two keys (some shared, so the 2-stripe planner
    cuts), Dels, padding rows holding keys, with and without a hint: the
    same chunks and cut count as the dense masks give."""
    rng = np.random.default_rng(E * 10 + dp)
    for trial in range(20):
        B = int(rng.integers(1, 65))
        add = np.zeros((B, E), bool)
        dl = np.zeros((B, E), bool)
        pool = rng.integers(0, E, 6)  # few keys: rows share them
        for b in range(B):
            add[b, rng.choice(pool, int(rng.integers(0, 3)))] = True
            if rng.random() < 0.3:
                dl[b, rng.choice(pool, int(rng.integers(1, 3)))] = True
        add[rng.integers(0, B), E - 1] = True  # the last lane (a tail)
        live = rng.random(B) < 0.8
        hint = rng.integers(-1, dp, B) if trial % 2 else None
        assert np.array_equal(cs.flat_nonzero(add), np.flatnonzero(add))
        got, got_cuts = cs.cut_chunks(add, dl, live, dp, hint)
        want, want_cuts = plain_cut_chunks(add, dl, live, dp, hint)
        assert got_cuts == want_cuts and len(got) == len(want)
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                assert x.dtype == y.dtype and np.array_equal(x, y)
