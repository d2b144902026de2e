#!/usr/bin/env python3
"""Time the port's K4/K5/K8 kernels (csrc/delta.cu: ``delta_rows``, a
block per row, and ``delta_rows_split``, a row's lanes over several
blocks) built from two source trees, in turns on one GPU.

    git archive <commit> go_crdt_playground_tpu_torch/csrc | tar -x -C D
    python3 tools/torch_delta_ab.py \
        --other D/go_crdt_playground_tpu_torch/csrc [--legs fleet,pair]

The other tree is driven through its ``crdt_delta_round`` (a block per
row); this tree through the package's launch path
(``cuda_delta._launch``: ``row_chunks`` picks one block a row or split
rows), so a tree from before the split kernel compares directly.

  fleet  the 1,048,576 x 256 north-star δ fleet (A = 256) in the bool,
         bitpacked and dot-word layouts, v2: K4 and K8 over the 20
         dissemination offsets, K5 at butterfly stage 3, the dot-word
         layout on the block-per-row kernel; ms a launch by CUDA events,
         in the order other, this, this, other.
  pair   few, long rows, v2 and strict reference: the Merger bridge's
         two-row [dst; src] pair (perm [1, 1]) at E = 65,536 and 2^20,
         A = 256, and R in {1, 8, 32, 128} at E = 65,536 (mixed
         histories, random perms with repeats).  Device us a launch
         (calls queued behind a sleeping stream, so the host's launch
         gaps fall outside the window) and us a call through the wrapper
         by CUDA events, in the same order; then, on this tree alone,
         the pairs at E = 65,536 and 2^20 and R = 32 and 128 at each
         geometry of ``--sweep`` (fill blocks an SM x the fewest lanes
         a chunk).

Each leg first holds the two builds' outputs (and this one against the
plain version) bitwise.  Prints each build's ptxas report for the
kernels, one line per case and a JSON line.  Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the pair leg's shapes: (R, E, A, the bridge's [dst; src] pair?)
PAIR_SHAPES = ((2, 1 << 16, 256, True), (2, 1 << 20, 256, True),
               (1, 1 << 16, 256, False), (8, 1 << 16, 256, False),
               (32, 1 << 16, 256, False), (128, 1 << 16, 256, False))
PAIR_MODES = ("v2", "reference")
# --sweep's default geometries (blocks an SM x the fewest lanes a chunk)
# and the pair leg's shapes it times them at
SWEEP = ((1, 512), (2, 512), (2, 1024), (4, 256), (4, 512), (6, 512),
         (8, 256), (8, 512))
SWEEP_SHAPES = (0, 1, 4, 5)


def build(csrc: Path, out_dir: Path, tag: str):
    """nvcc ``csrc/delta.cu`` with the package's flags; returns the loaded
    library (``crdt_delta_round_split`` bound where the tree has it) and
    the compiler's report."""
    from go_crdt_playground_tpu_torch.ops import _build

    lib = out_dir / f"libdelta-{tag}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
           str(lib), str(csrc / "delta.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True, check=True)
    handle = ctypes.CDLL(str(lib))
    P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    handle.crdt_delta_round.argtypes = (
        [P] * 10 + [I64, I32, I32] + [P] * 8 + [I64, I64, I32, I32, P])
    handle.crdt_delta_round.restype = ctypes.c_int
    handle.crdt_error_string.argtypes = [I32]
    handle.crdt_error_string.restype = ctypes.c_char_p
    if hasattr(handle, "crdt_delta_round_split"):
        handle.crdt_delta_round_split.argtypes = (
            [P] * 10 + [I64, I32, I32] + [P] * 8
            + [I64, I64, I32, I32, I64, I64, P, P])
        handle.crdt_delta_round_split.restype = ctypes.c_int
    return handle, done.stdout + done.stderr


def launch_rows(lib, state, perm, offset: int, partner_mode: int,
                mode: str = "v2"):
    """One block per row through a build's ``crdt_delta_round``."""
    from go_crdt_playground_tpu_torch.models import packed
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd
    from go_crdt_playground_tpu_torch.ops.cuda_merge import (
        layout_of, out_like, ptr, stream_of)

    num_r, num_a = state.vv.shape
    outs = out_like(state)
    rc = lib.crdt_delta_round(
        ptr(state.vv), ptr(state.processed),
        *map(ptr, cd._delta_lanes(state)), ptr(state.actor), ptr(perm),
        offset, partner_mode, cd.MODES[mode], ptr(outs.vv),
        ptr(outs.processed), *map(ptr, cd._delta_lanes(outs)), num_r,
        packed.num_elements(state), num_a, layout_of(state),
        stream_of(state.vv))
    if rc:
        raise RuntimeError(f"crdt_delta_round failed ({rc})")
    return outs


def launchers(libs):
    """tag -> f(state, perm, offset, partner_mode, mode, geom=None)."""
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd

    return {
        "other": lambda st, perm, off, pm, mode, geom=None: launch_rows(
            libs["other"], st, perm, off, pm, mode),
        "this": lambda st, perm, off, pm, mode, geom=None: cd._launch(
            st, perm, off, pm, mode, lib=libs["this"], geom=geom),
    }


def same(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def fleet_leg(run, reps: int, smi: str) -> dict:
    import torch

    import chip_smoke
    from go_crdt_playground_tpu_torch import fleet
    from go_crdt_playground_tpu_torch.models import packed
    from go_crdt_playground_tpu_torch.ops.cuda_merge import (
        PARTNER_GATHER, PARTNER_RING)
    from go_crdt_playground_tpu_torch.parallel import gossip

    R, E, A = chip_smoke.FLEET_R, chip_smoke.FLEET_E, chip_smoke.FLEET_W
    base = fleet.delta_fleet(R, E, A, "cuda")
    offsets = gossip.dissemination_offsets(R)
    perm = gossip.butterfly_perm(R, 3, "cuda")
    cases = (("K4", base, False), ("K5", base, True),
             ("K8", packed.pack_awset_delta(base), False),
             ("K9 rows", packed.pack_awset_delta_dots(base), False))
    rows = {}
    for key, state, gather in cases:
        def args(off):
            return ((perm, 0, PARTNER_GATHER) if gather
                    else (None, off, PARTNER_RING))

        def call(tag, it=iter(range(10 ** 9))):
            return lambda: run[tag](
                state, *args(offsets[next(it) % len(offsets)]), "v2")

        for off in (offsets[0], offsets[-1]):
            if not same(run["other"](state, *args(off), "v2"),
                        run["this"](state, *args(off), "v2")):
                raise AssertionError(f"{key}: the two builds differ")
        t = {"other": [], "this": []}
        for tag in ("other", "this", "this", "other"):
            t[tag].append(chip_smoke.cuda_time_ms(call(tag), reps))
        rows[key] = t
        print(f"{key}: other {t['other'][0]:.4f} / {t['other'][1]:.4f} ms, "
              f"this {t['this'][0]:.4f} / {t['this'][1]:.4f} ms a launch "
              f"[{smi}]", flush=True)
        del state
        torch.cuda.empty_cache()
    return rows


def pair_state(R: int, E: int, A: int, bridge: bool):
    """The bridge's timed pair (chip_smoke.bridge_timed_arrays) with perm
    [1, 1], or a mixed δ batch with a random perm."""
    import torch

    import chip_smoke
    from go_crdt_playground_tpu_torch import fleet
    from go_crdt_playground_tpu_torch.models import awset_delta

    if bridge:
        arrays, perm = chip_smoke.bridge_timed_arrays(E, A), [1, 1]
    else:
        arrays, perm = fleet.delta_scenario("mixed", R, E, A, seed=R)
    return (awset_delta.from_arrays(arrays, "cuda"),
            torch.as_tensor(perm, dtype=torch.int64).cuda())


def pair_leg(run, reps: int, smi: str, sweep) -> dict:
    import torch

    import chip_smoke
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd
    from go_crdt_playground_tpu_torch.ops.cuda_merge import PARTNER_GATHER

    sms = cd.sm_count(torch.cuda.current_device())
    out = {}
    for R, E, A, bridge in PAIR_SHAPES:
        st, perm = pair_state(R, E, A, bridge)
        geom = cd.row_chunks(R, E, sms)
        # bridge_bound: the pair merge reads two rows and writes one; a
        # batch of R rows reads each once and writes each once
        bound_ms, bound_by, _ = chip_smoke.bridge_bound("delta", E, A)
        bound_ms *= (3 if bridge else 2 * R) / 3
        for mode in PAIR_MODES:
            a = run["other"](st, perm, 0, PARTNER_GATHER, mode)
            b = run["this"](st, perm, 0, PARTNER_GATHER, mode)
            plain = cd.delta_round_plain(st, perm, mode)
            if not (same(a, b) and same(b, plain)):
                raise AssertionError(f"pair R={R} E={E} {mode}: the builds "
                                     "or the plain version differ")
            del a, b, plain
            dev, call = {"other": [], "this": []}, {"other": [], "this": []}
            for tag in ("other", "this", "this", "other"):
                fn = (lambda tag=tag: run[tag](st, perm, 0, PARTNER_GATHER,
                                               mode))
                dev[tag].append(chip_smoke.queued_device_ms(fn, reps) * 1e3)
                call[tag].append(chip_smoke.cuda_time_ms(fn, reps) * 1e3)
            key = f"R={R} E={E} A={A} {mode}"
            out[key] = {"chunks": geom.chunks, "lanes": geom.lanes,
                        "device_us": dev, "call_us": call,
                        "bound_us": bound_ms * 1e3, "bound_by": bound_by}
            print(f"pair {key} ({'bridge pair' if bridge else 'mixed'}, "
                  f"{geom.chunks} x {geom.lanes} lanes a row): device "
                  f"other {dev['other'][0]:.3f} / {dev['other'][1]:.3f} us, "
                  f"this {dev['this'][0]:.3f} / {dev['this'][1]:.3f} us a "
                  f"launch; a call other {call['other'][0]:.3f} / "
                  f"{call['other'][1]:.3f}, this {call['this'][0]:.3f} / "
                  f"{call['this'][1]:.3f} us; bound {bound_ms * 1e3:.4f} us "
                  f"({bound_by}) [{smi}]", flush=True)
        del st
        torch.cuda.empty_cache()
    out["sweep"] = {}
    for i in (SWEEP_SHAPES if sweep else ()):
        R, E, A, bridge = PAIR_SHAPES[i]
        st, perm = pair_state(R, E, A, bridge)
        for fill, min_lanes in sweep:
            geom = cd.row_chunks(R, E, sms, fill, min_lanes)
            row = {}
            for mode in PAIR_MODES:
                fn = (lambda: run["this"](st, perm, 0, PARTNER_GATHER, mode,
                                          geom))
                if not same(fn(), cd.delta_round_plain(st, perm, mode)):
                    raise AssertionError(f"sweep {fill} x {min_lanes} "
                                         f"{mode}: differs from plain")
                row[mode] = chip_smoke.queued_device_ms(fn, reps) * 1e3
            out["sweep"][f"R={R} E={E} {fill}x{min_lanes}"] = {
                "chunks": geom.chunks, "lanes": geom.lanes, "device_us": row}
            print(f"sweep R={R} E={E} A={A} fill {fill} min lanes "
                  f"{min_lanes} ({geom.chunks} x {geom.lanes}): "
                  + ", ".join(f"{m} {v:.3f} us" for m, v in row.items())
                  + f" [{smi}]", flush=True)
        del st
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the other tree's csrc directory")
    ap.add_argument("--this", type=Path, default=None, dest="this",
                    help="this tree's csrc directory (default: the "
                    "package's own)")
    ap.add_argument("--legs", default="fleet",
                    help="comma-separated: fleet, pair (default fleet)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--pair-reps", type=int, default=200)
    ap.add_argument("--sweep", default=",".join(f"{f}x{m}" for f, m in SWEEP),
                    help="pair leg geometries FILLxMIN_LANES, comma-"
                    "separated ('' for none)")
    args = ap.parse_args()
    legs = [x for x in args.legs.split(",") if x]
    if not set(legs) <= {"fleet", "pair"}:
        ap.error(f"unknown legs {legs}")
    sweep = [tuple(int(v) for v in g.split("x"))
             for g in args.sweep.split(",") if g]

    import torch

    import chip_smoke
    from go_crdt_playground_tpu_torch.ops._build import CSRC

    if not torch.cuda.is_available():
        print("torch_delta_ab: no CUDA GPU available", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi_line()
    print(smi, flush=True)
    result = {"device": smi}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for tag, csrc in (("other", args.other.resolve()),
                          ("this", (args.this or CSRC).resolve())):
            libs[tag], report = build(csrc, Path(tmp), tag)
            for line in chip_smoke.ptxas_report(report, "delta_rows"):
                print(f"  ptxas [{tag}]: {line}", flush=True)
        run = launchers(libs)
        if "pair" in legs:
            result["pair"] = pair_leg(run, args.pair_reps, smi, sweep)
        if "fleet" in legs:
            result["ms"] = fleet_leg(run, args.reps, smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
