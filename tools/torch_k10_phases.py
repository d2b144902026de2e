#!/usr/bin/env python3
"""Where K10's based entry spends its time on its tile path
(csrc/ingest.cu ``ingest_tiles``): the phases of every tile, timed on
the card by ``%globaltimer``.

The tool builds a copy of csrc/ingest.cu with a timestamp written by
each tile's first thread at each phase boundary (start, rows staged,
rows folded, the rows' prefix, the lanes finished, the δ's prefix, the
end), into the entry's own status-word scratch past the status words,
then calls the entry at 13d's slot shapes (E = 262,144 and 524,288, A =
16, B = 32 one-key rows and a delete, K = 128, as
chip_smoke.time_k10_slot) and at B = 0, and prints for each phase the
min / median / max over the tiles in µs from the first tile's start,
and each phase's median length.  The marks cost a few registers, which
can change how many tiles share an SM: read the phases, not the total,
and take the entry's time from ``tools/torch_kernel_ab.py --legs
k10slot``.

    python3 tools/torch_k10_phases.py

Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

# where the marks go: 8-byte words from this word of the scratch, 16 a tile
TS_WORD = 1 << 22
PHASES = ("start", "rows staged", "rows folded", "rows' prefix",
          "finished", "δ prefix", "end")


def mark(k: int) -> str:
    return ("{ if (threadIdx.x == 0) { unsigned long long t_; asm volatile("
            "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
            f"p.scratch[{TS_WORD} + tile * 16 + {k}] = t_; }} }}")


# (source line, where the mark goes): each must occur once in the kernel
MARKS = (
    ("  // 1. the rows, read once", 0, "before"),
    ("      stage_rows(p, b0, n, nst, e_tile, s_rows);\n", 1, "after"),
    ("  // 2. a thread per row: its adds before each warp's chunk", 2,
     "before"),
    ("              p.seq, tagg, tpre, tgrp);\n", 3, "after"),
    ("  // 4. the compaction: the tile's δ counts", 4, "before"),
    ("                s_dpre, s_dgrp);\n", 5, "after"),
    ("    write_clocks(p, actor, *p.final_ctr, overflow, threadIdx.x,\n"
     "                 kTileThreads);\n  }\n", 6, "after"),
)


def marked_source(src: str) -> str:
    for line, k, where in MARKS:
        if src.count(line) != 1:
            raise RuntimeError(f"csrc/ingest.cu changed: {line!r}")
        src = src.replace(line, line + mark(k) + "\n" if where == "after"
                          else mark(k) + "\n" + line)
    return src


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    import torch_kernel_ab as ab
    from go_crdt_playground_tpu_torch._u32 import narrow
    from go_crdt_playground_tpu_torch.ops import cuda_ingest as ci
    from go_crdt_playground_tpu_torch.ops._build import CSRC

    if not torch.cuda.is_available():
        print("torch_k10_phases: no CUDA GPU available", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi_line()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp) / "csrc"
        d.mkdir()
        for f in CSRC.glob("*.cuh"):
            shutil.copy(f, d)
        (d / "ingest.cu").write_text(marked_source(
            (CSRC / "ingest.cu").read_text()))
        proc, path = ab.build(d, "ingest", Path(tmp), "marked")
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc:\n{report}")
        lib = ab.bind(path, "ingest", "this")
        rng = np.random.default_rng(15)
        for E, B in ((1 << 18, 32), (1 << 18, 0), (1 << 19, 32)):
            A, K = 16, 128
            row = chip_smoke.ingest_slice(rng, E, A, 0x7FFFFFFB,
                                          0xFFFFFFF0, False, "cuda")
            add = np.zeros((B, E), bool)
            add[np.arange(B), rng.integers(0, E, B)] = True
            dl = np.zeros((B, E), bool)
            if B:
                dl[B // 2, rng.integers(0, E)] = True
            add = torch.from_numpy(add).cuda()
            dl = torch.from_numpy(dl).cuda()
            live = torch.ones(B, dtype=torch.bool, device="cuda")
            based = chip_smoke.based_inputs(rng, 0xFFFFFFF0, add, dl, live)
            bases = [narrow(torch.from_numpy(np.asarray(x, np.int64)))
                     .cuda() for x in based[3:]]
            ntiles = (E + 1023) // 1024
            # the stream's scratch, large enough for the marks
            key = (torch.cuda.current_device(),
                   torch.cuda.current_stream().cuda_stream)
            ci._scratch[key] = [torch.zeros(
                8 * (TS_WORD + 16 * ntiles), dtype=torch.uint8,
                device="cuda"), 0]
            want = ci.ingest_slot_rows(row, add, dl, live, *bases,
                                       k_changed=K, k_deleted=K,
                                       kernel="torch")
            for _ in range(5):
                got = ci._launch(row, add, dl, live, K, K, lib, bases=bases)
            if not ab.equal(got, want):
                raise AssertionError(f"E={E} B={B}: the marked build "
                                     "differs from plain")
            torch.cuda.synchronize()
            ts = (ci._scratch[key][0].view(torch.int64)
                  [TS_WORD:TS_WORD + 16 * ntiles].view(ntiles, 16)
                  [:, :len(PHASES)].cpu().numpy().astype(np.float64))
            if not B:
                ts[:, 1] = ts[:, 0]  # nothing staged
            rel = (ts - ts[:, 0].min()) / 1e3
            print(f"K10 based tiles E={E} A={A} B={B} K={K} "
                  f"({ntiles} tiles), µs from the first tile's start, "
                  f"min / median / max over tiles [{smi}]:", flush=True)
            for k, name in enumerate(PHASES):
                print(f"  {name:13s} {rel[:, k].min():8.2f} "
                      f"{np.median(rel[:, k]):8.2f} {rel[:, k].max():8.2f}")
            print("  median phase lengths: " + ", ".join(
                f"{PHASES[k + 1]} {x:.2f}" for k, x in
                enumerate(np.median(np.diff(rel, axis=1), axis=0))),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
