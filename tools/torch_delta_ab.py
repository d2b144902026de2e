#!/usr/bin/env python3
"""Time the port's block-per-row δ kernel (csrc/delta.cu
``crdt_delta_round``: K4, K5, K8 and the dot-word layout) built from two
source trees, in turns on one GPU.

    git archive <commit> go_crdt_playground_tpu_torch/csrc | tar -x -C D
    python3 tools/torch_delta_ab.py \
        --other D/go_crdt_playground_tpu_torch/csrc

Both libraries take the same C interface and the same state tensors (the
1,048,576 x 256 north-star δ fleet, A = 256, in the bool, bitpacked and
dot-word layouts).  Each kernel is timed over the 20 dissemination
offsets (the butterfly stage 3 for the gather round) in the order other,
this, this, other, and the outputs of the two builds are compared
bitwise.  Prints each build's ptxas report for ``delta_rows``, one line
per kernel and a JSON line.  Needs a CUDA GPU and nvcc.
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


def build(csrc: Path, out_dir: Path, tag: str):
    """nvcc ``csrc/delta.cu`` with the package's flags; returns the loaded
    library and the compiler's report."""
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
    return handle, done.stdout + done.stderr


def launch(lib, state, perm, offset: int, partner_mode: int):
    """``cuda_delta._launch`` on a given build of the library (v2)."""
    from go_crdt_playground_tpu_torch.models import packed
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd
    from go_crdt_playground_tpu_torch.ops.cuda_merge import (
        layout_of, out_like, ptr, stream_of)

    num_r, num_a = state.vv.shape
    outs = out_like(state)
    rc = lib.crdt_delta_round(
        ptr(state.vv), ptr(state.processed),
        *map(ptr, cd._delta_lanes(state)), ptr(state.actor), ptr(perm),
        offset, partner_mode, cd.MODES["v2"], ptr(outs.vv),
        ptr(outs.processed), *map(ptr, cd._delta_lanes(outs)), num_r,
        packed.num_elements(state), num_a, layout_of(state),
        stream_of(state.vv))
    if rc:
        raise RuntimeError(f"crdt_delta_round failed ({rc})")
    return outs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the other tree's csrc directory")
    ap.add_argument("--this", type=Path, default=None, dest="this",
                    help="this tree's csrc directory (default: the "
                    "package's own)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    import chip_smoke
    from go_crdt_playground_tpu_torch import fleet
    from go_crdt_playground_tpu_torch.models import packed
    from go_crdt_playground_tpu_torch.ops.cuda_merge import (
        PARTNER_GATHER, PARTNER_RING)
    from go_crdt_playground_tpu_torch.ops._build import CSRC
    from go_crdt_playground_tpu_torch.parallel import gossip

    if not torch.cuda.is_available():
        print("torch_delta_ab: no CUDA GPU available", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi_line()
    print(smi, flush=True)
    R, E, A = chip_smoke.FLEET_R, chip_smoke.FLEET_E, chip_smoke.FLEET_W
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for tag, csrc in (("other", args.other.resolve()),
                          ("this", (args.this or CSRC).resolve())):
            libs[tag], report = build(csrc, Path(tmp), tag)
            for line in chip_smoke.ptxas_report(report, "delta_rows"):
                print(f"  ptxas [{tag}]: {line}", flush=True)
        base = fleet.delta_fleet(R, E, A, "cuda")
        offsets = gossip.dissemination_offsets(R)
        perm = gossip.butterfly_perm(R, 3, "cuda")
        cases = (("K4", base, False), ("K5", base, True),
                 ("K8", packed.pack_awset_delta(base), False),
                 ("K9 rows", packed.pack_awset_delta_dots(base), False))
        rows = {}
        for key, state, gather in cases:
            def call(tag, it=iter(range(10 ** 9))):
                lib = libs[tag]
                if gather:
                    return lambda: launch(lib, state, perm, 0,
                                          PARTNER_GATHER)
                return lambda: launch(
                    lib, state, None, offsets[next(it) % len(offsets)],
                    PARTNER_RING)

            for off in (offsets[0], offsets[-1]):
                a = launch(libs["other"], state, perm if gather else None,
                           0 if gather else off,
                           PARTNER_GATHER if gather else PARTNER_RING)
                b = launch(libs["this"], state, perm if gather else None,
                           0 if gather else off,
                           PARTNER_GATHER if gather else PARTNER_RING)
                if not all(torch.equal(x, y) for x, y in zip(a, b)):
                    raise AssertionError(f"{key}: the two builds differ")
                del a, b
            t = {"other": [], "this": []}
            for tag in ("other", "this", "this", "other"):
                t[tag].append(chip_smoke.cuda_time_ms(call(tag), args.reps))
            rows[key] = t
            print(f"{key}: other {t['other'][0]:.4f} / {t['other'][1]:.4f}"
                  f" ms, this {t['this'][0]:.4f} / {t['this'][1]:.4f} ms "
                  f"a launch [{smi}]", flush=True)
            del state
            torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "ms": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
