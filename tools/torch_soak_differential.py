#!/usr/bin/env python
"""Randomized kernel-vs-plain differential soak of the port.

The port's twin of tools/soak_differential.py.  The test suites pin the
kernels against their plain versions at FIXED shapes and seeds; this soak
draws fresh random shapes, states and schedules every iteration and
re-asserts the same equalities, hunting the rare divergence a fixed seed
cannot reach.  The draws are the reference tool's, draw for draw (R =
64·k or 128, E from 8 to 8,200, A from 2 to 256, the ring offset, a
random permutation and a butterfly stage, the δ states), so a failing
seed replays in both packages.

On a CUDA device each iteration

  * holds the plain versions against each other, as the reference holds
    XLA against its Pallas paths: the general-permutation round (r
    absorbs perm[r]) over the ring permutation against the ring round on
    the bool, bitpacked and dot-word layouts, full-state and δ (v2), and
    the strict reference δ mode;
  * holds every kernel against its plain version, bitwise: K1
    ``ring_round_rows``, K6 ``ring_round_rows_packed``, K7
    ``ring_round_rows_dotpacked``, K2 ``gossip_round_rows`` (random and
    butterfly permutations), K4 ``delta_ring_round`` (v2 and strict), K8
    ``delta_ring_round_packed`` and K9 ``delta_ring_round_dotpacked``.

On the CPU (``--device cpu``) the same plain versions are held against
the JAX package's XLA rounds and its Pallas kernels in interpret mode;
only that mode imports JAX.

Run:  python tools/torch_soak_differential.py [minutes] [--device cpu]
      [--seed S] [--iterations N]
(default 30 minutes on ``cuda``, which raises without a GPU).  Progress
goes to stdout, then one summary JSON line; the first divergence prints
its seed, the check, the field and the lane, and exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# the kernels an iteration holds against their plain versions on CUDA
KERNELS = ("K1", "K2", "K4", "K6", "K7", "K8", "K9")


class Divergence(AssertionError):
    """Two results that must be bitwise equal differ."""


# ---------------------------------------------------------------------------
# The draws (tools/soak_differential.py's, in the same order)
# ---------------------------------------------------------------------------


def _rand_state(rng, num_r, num_e, num_a) -> dict:
    present = rng.random((num_r, num_e)) < rng.uniform(0.1, 0.9)
    da = np.where(present, rng.integers(0, num_a, (num_r, num_e)),
                  0).astype(np.uint32)
    dc = np.where(present, rng.integers(1, 9, (num_r, num_e)),
                  0).astype(np.uint32)
    return {"vv": rng.integers(0, 10, (num_r, num_a)).astype(np.uint32),
            "present": present, "dot_actor": da, "dot_counter": dc,
            "actor": np.arange(num_r, dtype=np.uint32) % num_a}


def _rand_delta_state(rng, num_r, num_e, num_a) -> dict:
    base = _rand_state(rng, num_r, num_e, num_a)
    deleted = rng.random((num_r, num_e)) < rng.uniform(0.05, 0.3)
    dda = np.where(deleted, rng.integers(0, num_a, (num_r, num_e)),
                   0).astype(np.uint32)
    ddc = np.where(deleted, rng.integers(0, 5, (num_r, num_e)),
                   0).astype(np.uint32)
    return dict(base, deleted=deleted, del_dot_actor=dda,
                del_dot_counter=ddc, processed=base["vv"])


def draw(seed: int) -> dict:
    """One iteration's shapes, states and schedules from ``seed``."""
    rng = np.random.default_rng(seed)
    # the ring kernels' packed entries need R % 64 == 0, R >= 128
    if rng.random() < 0.12:
        # cross the 4,096-element pack chunk now and then
        num_r, num_e = 128, int(rng.integers(4097, 8200))
    else:
        num_r = 64 * int(rng.integers(2, 7))
        num_e = int(rng.integers(8, 520))
    num_a = int(rng.integers(2, 257))
    offset = int(rng.integers(1, num_r))
    full = _rand_state(rng, num_r, num_e, num_a)
    perm = rng.permutation(num_r).astype(np.uint32)
    stage = None
    if num_r & (num_r - 1) == 0:   # butterfly needs a power of two
        stage = int(rng.integers(0, num_r.bit_length() - 1))
    delta = _rand_delta_state(rng, num_r, num_e, num_a)
    return {"R": num_r, "E": num_e, "A": num_a, "offset": offset,
            "full": full, "perm": perm, "stage": stage, "delta": delta}


# ---------------------------------------------------------------------------
# Comparison
# ---------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    """A tensor (int32 lanes as their uint32 bits), a JAX array or a
    numpy array as numpy."""
    from go_crdt_playground_tpu_torch._host import host

    return host(x)


def assert_equal(want, got, tag: str) -> None:
    """Every field bitwise; a difference names the field and the first
    differing (row, lane)."""
    for name in want._fields:
        a, b = _host(getattr(want, name)), _host(getattr(got, name))
        if a.shape != b.shape:
            raise Divergence(f"{tag}: field {name} shape {b.shape}, "
                             f"expected {a.shape}")
        diff = np.argwhere(a != b)
        if diff.size:
            where = tuple(int(i) for i in diff[0])
            lane = (f"row {where[0]}" if len(where) == 1
                    else f"row {where[0]}, lane {where[1]}")
            raise Divergence(f"{tag}: field {name} diverged at {lane} "
                             f"(expected {a[where]}, got {b[where]})")


# ---------------------------------------------------------------------------
# One iteration
# ---------------------------------------------------------------------------


def _jax_side():
    """The JAX package's rounds, for the CPU mode only (JAX pinned to the
    CPU unless the process already chose its platform)."""
    if "jax" not in sys.modules:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from go_crdt_playground_tpu.models import awset_delta as j_awset_delta
    from go_crdt_playground_tpu.models import packed as j_packed
    from go_crdt_playground_tpu.models.awset import AWSetState
    from go_crdt_playground_tpu.ops import pallas_delta, pallas_merge
    from go_crdt_playground_tpu.parallel import gossip as j_gossip

    def full(a):
        return AWSetState(**{k: jnp.asarray(v) for k, v in a.items()})

    def delta(a):
        return j_awset_delta.AWSetDeltaState(
            **{k: jnp.asarray(v) for k, v in a.items()})

    return {"jax": jax, "jnp": jnp, "full": full, "delta": delta,
            "packed": j_packed, "merge": pallas_merge,
            "pdelta": pallas_delta, "gossip": j_gossip}


def one_iteration(seed: int, device, jx=None) -> dict:
    """Draw ``seed``, run every check and return the shapes; raises
    ``Divergence`` on the first difference.  ``device`` cuda runs the
    kernels against the plain versions; with ``jx`` (``_jax_side()``) the
    plain versions are also held against the JAX package."""
    import torch

    from go_crdt_playground_tpu_torch.models import awset, awset_delta, packed
    from go_crdt_playground_tpu_torch.ops import cuda_delta, cuda_merge
    from go_crdt_playground_tpu_torch.parallel import gossip

    d = draw(seed)
    num_r, num_e, offset = d["R"], d["E"], d["offset"]
    on_card = torch.device(device).type == "cuda"
    st = awset.from_arrays(d["full"], device=device)
    ring = gossip.ring_perm(num_r, offset, device=device)

    # -- full state: the plain versions against each other -----------------
    want = cuda_merge.gossip_round_rows(st, ring, kernel="torch")
    ring_p = cuda_merge.ring_round_rows(st, offset, kernel="torch")
    assert_equal(want, ring_p, "bool-ring plain")
    bits = packed.pack_awset(st)
    bits_p = cuda_merge.ring_round_rows_packed(bits, offset, kernel="torch")
    assert_equal(want, packed.unpack_awset(bits_p, num_e),
                 "bitpacked-ring plain")
    dots = packed.pack_awset_dots(st)
    dots_p = cuda_merge.ring_round_rows_dotpacked(dots, offset,
                                                  kernel="torch")
    assert_equal(want, packed.unpack_awset_dots(dots_p, num_e),
                 "dotword-ring plain")
    perms = [("random-perm", d["perm"])]
    if d["stage"] is not None:
        perms.append(("butterfly-perm", gossip.butterfly_perm(
            num_r, d["stage"], device=device)))
    perm_p = {tag: cuda_merge.gossip_round_rows(st, p, kernel="torch")
              for tag, p in perms}
    if on_card:
        assert_equal(ring_p, cuda_merge.ring_round_rows(
            st, offset, kernel="cuda"), "K1 bool-ring")
        assert_equal(bits_p, cuda_merge.ring_round_rows_packed(
            bits, offset, kernel="cuda"), "K6 bitpacked-ring")
        assert_equal(dots_p, cuda_merge.ring_round_rows_dotpacked(
            dots, offset, kernel="cuda"), "K7 dotword-ring")
        for tag, p in perms:
            assert_equal(perm_p[tag], cuda_merge.gossip_round_rows(
                st, p, kernel="cuda"), f"K2 {tag}")

    # -- δ: v2 on every layout, then strict reference -----------------------
    dst = awset_delta.from_arrays(d["delta"], device=device)
    dwant = cuda_delta.delta_gossip_round(dst, ring, kernel="torch")
    dring_p = cuda_delta.delta_ring_round(dst, offset, kernel="torch")
    assert_equal(dwant, dring_p, "delta-ring plain")
    dbits = packed.pack_awset_delta(dst)
    dbits_p = cuda_delta.delta_ring_round_packed(dbits, offset,
                                                 kernel="torch")
    assert_equal(dwant, packed.unpack_awset_delta(dbits_p, num_e),
                 "delta-bitpacked-ring plain")
    ddots = packed.pack_awset_delta_dots(dst)
    ddots_p = cuda_delta.delta_ring_round_dotpacked(ddots, offset,
                                                    kernel="torch")
    assert_equal(dwant, packed.unpack_awset_delta_dots(ddots_p, num_e),
                 "delta-dotword-ring plain")
    strict = {"delta_semantics": "reference",
              "strict_reference_semantics": True}
    swant = cuda_delta.delta_gossip_round(dst, ring, kernel="torch", **strict)
    sring_p = cuda_delta.delta_ring_round(dst, offset, kernel="torch",
                                          **strict)
    assert_equal(swant, sring_p, "delta-strict-reference-ring plain")
    if on_card:
        assert_equal(dring_p, cuda_delta.delta_ring_round(
            dst, offset, kernel="cuda"), "K4 delta-ring v2")
        assert_equal(sring_p, cuda_delta.delta_ring_round(
            dst, offset, kernel="cuda", **strict),
            "K4 delta-strict-reference-ring")
        assert_equal(dbits_p, cuda_delta.delta_ring_round_packed(
            dbits, offset, kernel="cuda"), "K8 delta-bitpacked-ring")
        assert_equal(ddots_p, cuda_delta.delta_ring_round_dotpacked(
            ddots, offset, kernel="cuda"), "K9 delta-dotword-ring")

    if jx is not None:
        _against_jax(jx, d, want, ring_p, bits_p, dots_p, perm_p, dring_p,
                     dbits_p, ddots_p, swant)
    return {"R": num_r, "E": num_e, "A": d["A"]}


def _against_jax(jx, d, want, ring_p, bits_p, dots_p, perm_p, dring_p,
                 dbits_p, ddots_p, swant) -> None:
    """The port's plain results against the JAX package's XLA rounds and
    Pallas kernels (interpret mode) on the same draws."""
    jnp, jg, jm, jd, jp = (jx["jnp"], jx["gossip"], jx["merge"],
                           jx["pdelta"], jx["packed"])
    num_r, offset = d["R"], d["offset"]
    st = jx["full"](d["full"])
    assert_equal(jg.gossip_round(st, jg.ring_perm(num_r, offset),
                                 kernel="xla"), want, "bool-ring vs XLA")
    assert_equal(jm.pallas_ring_round_rows(st, offset), ring_p,
                 "bool-ring vs Pallas")
    assert_equal(jm.pallas_ring_round_rows_packed(jp.pack_awset(st), offset),
                 bits_p, "bitpacked-ring vs Pallas")
    assert_equal(jm.pallas_ring_round_rows_dotpacked(
        jp.pack_awset_dots(st), offset), dots_p, "dotword-ring vs Pallas")
    perms = {"random-perm": jnp.asarray(d["perm"])}
    if d["stage"] is not None:
        perms["butterfly-perm"] = jg.butterfly_perm(num_r, d["stage"])
    for tag, p in perms.items():
        assert_equal(jg.gossip_round(st, p, kernel="xla"), perm_p[tag],
                     f"{tag} vs XLA")
        assert_equal(jm.pallas_gossip_round_rows(st, p), perm_p[tag],
                     f"{tag} vs Pallas")
    dst = jx["delta"](d["delta"])
    assert_equal(jd.pallas_delta_ring_round(dst, offset), dring_p,
                 "delta-ring vs Pallas")
    assert_equal(jd.pallas_delta_ring_round_packed(
        jp.pack_awset_delta(dst), offset), dbits_p,
        "delta-bitpacked-ring vs Pallas")
    assert_equal(jd.pallas_delta_ring_round_dotpacked(
        jp.pack_awset_delta_dots(dst), offset), ddots_p,
        "delta-dotword-ring vs Pallas")
    strict = {"delta_semantics": "reference",
              "strict_reference_semantics": True}
    assert_equal(jg.delta_gossip_round(dst, jg.ring_perm(num_r, offset),
                                       kernel="xla", **strict), swant,
                 "delta-strict-reference vs XLA")
    assert_equal(jd.pallas_delta_ring_round(dst, offset, **strict), swant,
                 "delta-strict-reference-ring vs Pallas")


# ---------------------------------------------------------------------------
# The soak
# ---------------------------------------------------------------------------


def run(minutes: float, device="cuda", seed0=None, iterations=None,
        log=print) -> dict:
    """Iterate fresh seeds for ``minutes`` (or ``iterations``, whichever
    ends first).  Returns the summary: iterations, seeds, the shape
    ranges reached, the kernels covered, and ``divergence`` (None, or
    the first one's seed and message)."""
    from go_crdt_playground_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    jx = _jax_side() if dev.type == "cpu" else None
    if seed0 is None:
        seed0 = int(time.time()) % (1 << 30)
    deadline = time.monotonic() + minutes * 60
    n, shapes, divergence = 0, [], None
    t0 = time.monotonic()
    while time.monotonic() < deadline and (iterations is None
                                           or n < iterations):
        seed = seed0 + n
        try:
            shapes.append(one_iteration(seed, dev, jx))
        except Divergence as exc:
            divergence = {"seed": seed, "message": str(exc)}
            log(f"DIVERGENCE at seed={seed}: {exc}")
            break
        n += 1
        if n % 10 == 0:
            if jx is not None:
                # fresh shapes mean fresh executables on the JAX side:
                # drop its compile cache before it grows without bound
                jx["jax"].clear_caches()
            log(f"{n} iterations clean (last seed {seed})")
    summary = {
        "device": str(dev), "iterations": n, "seeds": [seed0, seed0 + n - 1],
        "wall_s": round(time.monotonic() - t0, 3),
        "R": [min(s["R"] for s in shapes), max(s["R"] for s in shapes)]
        if shapes else None,
        "E": [min(s["E"] for s in shapes), max(s["E"] for s in shapes)]
        if shapes else None,
        "A": [min(s["A"] for s in shapes), max(s["A"] for s in shapes)]
        if shapes else None,
        "kernels": list(KERNELS) if dev.type == "cuda" else [],
        "against": ("plain versions" if dev.type == "cuda"
                    else "JAX XLA and Pallas (interpret)"),
        "bitwise": True,
        "divergence": divergence,
    }
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("minutes", nargs="?", type=float, default=30.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; kernels against plain versions) "
                         "or cpu (plain versions against the JAX package)")
    ap.add_argument("--seed", type=int, default=None,
                    help="first seed (default: from the clock); a "
                         "reported seed replays with --seed S "
                         "--iterations 1")
    ap.add_argument("--iterations", type=int, default=None,
                    help="stop after this many iterations")
    args = ap.parse_args(argv)
    summary = run(args.minutes, args.device, args.seed, args.iterations,
                  log=lambda m: print(m, flush=True))
    if summary["divergence"] is None:
        print(f"soak complete: {summary['iterations']} iterations, 0 "
              f"divergences (seeds {summary['seeds'][0]}.."
              f"{summary['seeds'][1]})", flush=True)
    print(json.dumps(summary), flush=True)
    return 1 if summary["divergence"] is not None else 0


if __name__ == "__main__":
    sys.exit(main())
