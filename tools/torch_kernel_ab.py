#!/usr/bin/env python3
"""Time the port's one-row merge entries (K3, csrc/merge.cu), digest
kernel (K11, csrc/digest.cu) and ingest entry (K10, csrc/ingest.cu)
built from two source trees, in turns on one GPU.

    git archive <commit> go_crdt_playground_tpu_torch/csrc | tar -x -C D
    python3 tools/torch_kernel_ab.py --legs k3 \
        --other D/go_crdt_playground_tpu_torch/csrc

``--legs`` picks the legs (default ``k3,k10,k11``); each leg wants its
own kind of ``--other`` tree:

  * k3: a tree whose K3 is K2's block-per-row kernel behind the shared
    ``crdt_merge_round`` (before ``crdt_merge_rows_k3``), timed through
    that wrapper's host path (``as_index``'s device range check, a check
    pass per batch, five outputs, the device context) at the gossip
    verb's fleet (64 x 128, A = 64: ``gossip_round`` over a ring perm
    and ``merge_pairwise``), at a wide row (64 x 1,000, A = 16) and at
    4,096 x 128 (A = 64);
  * k10, k11: a tree whose K10 is the fold-only kernel
    (``crdt_ingest_fold``: the rows' prefix sums, the clocks and the
    compaction in torch around it) and whose K11 has the fingerprint-
    per-thread design (before the whole-entry K10); this tree's K10 is
    the whole entry in one launch (``crdt_ingest``).  Both K11 builds have
    the C entry ``crdt_group_digests``; this tree's takes a lane base
    before the stream (passed as 0).

Each design is timed as a whole call (host path included, CUDA events
around back-to-back calls) with its kernel time, its device busy time
(every device operation of the call) and device operations a call from
torch.profiler, in the order other, this, this, other, and the outputs
of the two designs are compared bitwise:

  * K11 at E = 2^20, gs = 64 (one node's universe) and E = 8,192, gs =
    64 (bench.measure_mesh's digest read), the other design through its
    own host path (four-lane check, allocation, device context, lock);
  * K10 at the four bench.measure_ingest legs (E = 1,024, A = 8), the
    other design as its whole entry: ``row_counters``, ``clock_outputs``,
    the fold launch and ``compact_payload``.

Prints each build's ptxas lines, one line per case and a JSON line.
Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def build(csrc: Path, name: str, out_dir: Path, tag: str):
    """Start nvcc on ``csrc/<name>.cu`` with the package's flags; returns
    (process, library path)."""
    from go_crdt_playground_tpu_torch.ops import _build

    lib = out_dir / f"lib{name}-{tag}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
           str(lib), str(csrc / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def bind(path: Path, name: str, tag: str):
    lib = ctypes.CDLL(str(path))
    lib.crdt_error_string.argtypes = [I32]
    lib.crdt_error_string.restype = ctypes.c_char_p
    if name == "merge":
        lib.crdt_merge_round.argtypes = (
            [P] * 9 + [I64, I32] + [P] * 4 + [I64, I64, I32, I32, P])
        lib.crdt_merge_round.restype = I32
        if tag == "this":
            lib.crdt_merge_rows_k3.argtypes = (
                [P] * 9 + [I32] + [P] * 4 + [I64, I64, I32, P])
            lib.crdt_merge_rows_k3.restype = I32
    elif name == "digest":
        lib.crdt_group_digests.argtypes = (
            [P] * 5 + ([I64, I64, I64, P] if tag == "this"
                       else [I64, I64, P]))
        lib.crdt_group_digests.restype = I32
    elif tag == "this":
        lib.crdt_ingest.argtypes = [P] * 13 + [I64, I64, I32, I32, I32, P]
        lib.crdt_ingest.restype = I32
        lib.crdt_ingest_regions.restype = I32
        lib.crdt_ingest_layout.argtypes = [I64] * 5 + [P]
        lib.crdt_ingest_layout.restype = None
    else:
        lib.crdt_ingest_fold.argtypes = [P] * 24 + [I64, I64, I32, P]
        lib.crdt_ingest_fold.restype = I32
    return lib


_lock = threading.Lock()


def old_k11(lib, state, gs: int):
    """The other design's K11 call as its wrapper made it: a check pass
    over the four lanes, one allocation, the device context, the stream,
    the launch and a locked count."""
    import torch

    from go_crdt_playground_tpu_torch.ops import digest as digest_ops
    from go_crdt_playground_tpu_torch.ops.cuda_merge import ptr, stream_of

    lanes = [state.present, state.deleted, state.del_dot_actor,
             state.del_dot_counter]
    (num_e,) = lanes[0].shape
    for t, dtype in zip(lanes, (torch.bool, torch.bool, torch.int32,
                                torch.int32)):
        if t.dtype != dtype or tuple(t.shape) != (num_e,):
            raise ValueError("lane dtype or shape")
        if t.device != lanes[0].device:
            raise ValueError("lane device")
        if not t.is_contiguous():
            raise ValueError("lane contiguity")
    out = torch.empty(digest_ops.num_groups(num_e, gs), dtype=torch.int32,
                      device=lanes[0].device)
    with torch.cuda.device(out.device):
        rc = lib.crdt_group_digests(*map(ptr, lanes), ptr(out), num_e, gs,
                                    stream_of(out))
    if rc:
        raise RuntimeError(f"crdt_group_digests failed ({rc})")
    with _lock:
        old_k11.calls += 1
    return out


old_k11.calls = 0


def old_k3(lib, dst, src, perm):
    """The other design's K3 call as its wrapper made it:
    ``as_index`` (a device perm range-checked by five device operations
    and an asynchronous assert), ``check_state`` over each batch, five
    outputs, the device context, a 20-argument call to K2's kernel, an
    unlocked count."""
    import torch

    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm
    from go_crdt_playground_tpu_torch.ops.cuda_merge import ptr, stream_of

    mode = cm.PARTNER_PAIRWISE
    if perm is not None:
        perm = cm.as_index(perm, dst.num_replicas, dst.vv.device)
        mode = cm.PARTNER_GATHER
    cm.check_state(dst)
    if src is not dst:
        cm.check_state(src)
        if (type(src) is not type(dst)
                or any(s.shape != d.shape for s, d in zip(src, dst))
                or src.vv.device != dst.vv.device):
            raise ValueError("dst and src batches must match")
    num_r, num_a = dst.vv.shape
    outs = cm.out_like(dst)
    with torch.cuda.device(dst.vv.device):
        rc = lib.crdt_merge_round(
            ptr(dst.vv), *map(ptr, cm._merge_lanes(dst)),
            ptr(src.vv), *map(ptr, cm._merge_lanes(src)),
            ptr(perm), 0, mode, ptr(outs.vv), *map(ptr, cm._merge_lanes(outs)),
            num_r, dst.present.shape[1], num_a, cm.LAYOUT_BOOL,
            stream_of(dst.vv))
    if rc:
        raise RuntimeError(f"crdt_merge_round failed ({rc})")
    old_k3.calls += 1
    return outs


old_k3.calls = 0


def old_k10(lib, state, add, dl, live, k: int):
    """The other design's whole K10 entry: the row prefix sums and the
    clocks in torch, the fold launch (its 9-field check, 12 allocations,
    28 arguments), then ``compact_payload``."""
    import torch

    from go_crdt_playground_tpu_torch.models.awset_delta import \
        AWSetDeltaState
    from go_crdt_playground_tpu_torch.ops import cuda_ingest as ci
    from go_crdt_playground_tpu_torch.ops.compact import compact_payload
    from go_crdt_playground_tpu_torch.ops.cuda_merge import ptr, stream_of
    from go_crdt_playground_tpu_torch.ops.delta import DeltaPayload

    arow, drow, add_dc, del_ctr, final = ci.row_counters(state, add, dl,
                                                         live)
    vv, processed = ci.clock_outputs(state, final, add.shape[0])
    ci.check_slice(state)
    names = ("present", "dot_actor", "dot_counter", "deleted",
             "del_dot_actor", "del_dot_counter")
    lanes = [getattr(state, n) for n in names]
    outs = [torch.empty_like(x) for x in lanes + lanes]
    with torch.cuda.device(state.vv.device):
        rc = lib.crdt_ingest_fold(
            ptr(state.vv), ptr(state.actor), *map(ptr, lanes), ptr(arow),
            ptr(drow), ptr(add_dc), ptr(del_ctr), *map(ptr, outs),
            arow.shape[0], state.present.shape[0], state.vv.shape[0],
            stream_of(state.vv))
    if rc:
        raise RuntimeError(f"crdt_ingest_fold failed ({rc})")
    p, da, dc, d, xa, xc, ch, chda, chdc, dm, dlda, dldc = outs
    merged = AWSetDeltaState(
        vv=vv, present=p, dot_actor=da, dot_counter=dc, actor=state.actor,
        deleted=d, del_dot_actor=xa, del_dot_counter=xc,
        processed=processed)
    payload = DeltaPayload(
        src_vv=vv, changed=ch, ch_da=chda, ch_dc=chdc, deleted=dm,
        del_da=dlda, del_dc=dldc, src_actor=state.actor,
        src_processed=processed)
    return merged, payload, compact_payload(payload, k, k)


def equal(a, b) -> bool:
    import torch

    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return all(equal(x, y) for x, y in zip(a, b))


def in_turns(calls: dict, names, reps: int):
    """Time each design other, this, this, other: ms per call (CUDA
    events), device ms and device operations per call (profiler)."""
    import chip_smoke

    out = {tag: {"ms": [], "device_ms": [], "device_busy_ms": [],
                 "device_ops": []}
           for tag in calls}
    for tag in ("other", "this", "this", "other"):
        fn = calls[tag]
        out[tag]["ms"].append(chip_smoke.cuda_time_ms(fn, reps))
        _, rep = chip_smoke.trace_run(lambda: [fn() for _ in range(50)],
                                      names[tag])
        out[tag]["device_ms"].append(None if rep is None
                                     else rep["kernel_ms"] / 50)
        out[tag]["device_busy_ms"].append(None if rep is None
                                          else rep["device_busy_ms"] / 50)
        out[tag]["device_ops"].append(None if rep is None
                                      else rep["device_ops"] / 50)
    return out


def fmt(t: dict) -> str:
    def us(key):
        return ", ".join("not measured" if x is None else f"{x * 1e3:.3f}"
                         for x in t[key])

    ops = ", ".join("-" if x is None else f"{x:g}" for x in t["device_ops"])
    return (f"{t['ms'][0]:.4f} / {t['ms'][1]:.4f} ms a call (kernel "
            f"{us('device_ms')} us, device busy {us('device_busy_ms')} us "
            f"in {ops} device ops a call)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the other tree's csrc directory")
    ap.add_argument("--this", type=Path, default=None, dest="this",
                    help="this tree's csrc directory (default: the "
                    "package's own)")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--legs", default="k3,k10,k11",
                    help="comma-separated legs: k3, k10, k11")
    args = ap.parse_args()
    legs = set(args.legs.split(","))
    if not legs <= {"k3", "k10", "k11"}:
        ap.error(f"unknown legs in {args.legs!r}")
    sources = ([n for leg, n in (("k3", "merge"), ("k11", "digest"),
                                 ("k10", "ingest")) if leg in legs])

    import numpy as np
    import torch

    import chip_smoke
    from go_crdt_playground_tpu_torch.ops import cuda_digest as cg
    from go_crdt_playground_tpu_torch.ops import cuda_ingest as ci
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm
    from go_crdt_playground_tpu_torch.ops._build import CSRC

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA GPU available", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi_line()
    print(smi, flush=True)
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        trees = {"other": args.other.resolve(),
                 "this": (args.this or CSRC).resolve()}
        started = {(tag, name): build(csrc, name, Path(tmp), tag)
                   for tag, csrc in trees.items()
                   for name in sources}
        libs = {}
        for (tag, name), (proc, path) in started.items():
            report, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc {tag} {name}:\n{report}")
            kernel = {"digest": "group_digests", "ingest": "ingest",
                      "merge": "merge_rows"}[name]
            for line in chip_smoke.ptxas_report(report, kernel):
                print(f"  ptxas [{tag} {name}]: {line}", flush=True)
            libs[tag, name] = bind(path, name, tag)

        rng = np.random.default_rng(31)
        k3_cases = ((*chip_smoke.CLI_SHAPE, True),
                    (*chip_smoke.CLI_SHAPE, False), (64, 1000, 16, True),
                    (4096, 128, 64, True))
        for R, E, A, gather in (k3_cases if "k3" in legs else ()):
            dst = chip_smoke.random_delta_state(rng, R, E, A, 0x7FFFFFF8,
                                                "cuda").base()
            src = dst
            perm = None
            if gather:
                perm = torch.from_numpy(rng.permutation(R)).cuda()
            else:
                src = chip_smoke.random_delta_state(rng, R, E, A, 7,
                                                    "cuda").base()
            calls = {
                "other": lambda: old_k3(libs["other", "merge"], dst, src,
                                        perm),
                "this": lambda: cm._k3_launch(dst, src, perm,
                                              libs["this", "merge"]),
            }
            want = (cm.gossip_round(dst, perm, kernel="torch") if gather
                    else cm.merge_pairwise(dst, src, kernel="torch"))
            for tag in ("other", "this"):
                if not equal(calls[tag](), want):
                    raise AssertionError(f"K3 R={R} E={E} A={A}: the {tag} "
                                         "design differs from plain")
            names = {"other": ("merge_rows",), "this": ("merge_rows",)}
            t = in_turns(calls, names, args.reps)
            key = (f"K3 {'gossip_round' if gather else 'merge_pairwise'} "
                   f"R={R} E={E} A={A}")
            rows[key] = t
            print(f"{key}: other {fmt(t['other'])}; this {fmt(t['this'])} "
                  f"[{smi}]", flush=True)

        for E, gs in ((1 << 20, 64), (8192, 64)) if "k11" in legs else ():
            st = chip_smoke.random_delta_state(rng, 1, E, 16, 0x7FFFFFF8,
                                               "cuda")
            row = type(st)(*(x[0] for x in st))
            calls = {
                "other": lambda: old_k11(libs["other", "digest"], row, gs),
                "this": lambda: cg._launch(row, gs, libs["this", "digest"]),
            }
            if not equal(calls["other"](), calls["this"]()):
                raise AssertionError(f"K11 E={E}: the two designs differ")
            if not equal(calls["this"](), cg.state_group_digests(
                    row, gs, kernel="torch")):
                raise AssertionError(f"K11 E={E}: differs from plain")
            names = {"other": ("group_digests",),
                     "this": ("group_digests",)}
            t = in_turns(calls, names, args.reps)
            key = f"K11 E={E} gs={gs}"
            rows[key] = t
            print(f"{key}: other {fmt(t['other'])}; this {fmt(t['this'])} "
                  f"[{smi}]", flush=True)

        E, A = chip_smoke.INGEST_E, chip_smoke.INGEST_A
        for B, keys in chip_smoke.INGEST_LEGS if "k10" in legs else ():
            k = min(128, E)
            row = chip_smoke.ingest_slice(rng, E, A, 0, 40, False, "cuda")
            add = np.zeros((B, E), bool)
            for b in range(B):
                add[b, rng.choice(E, size=keys, replace=False)] = True
            dl = np.zeros((B, E), bool)
            dl[B // 2, rng.integers(E)] = True
            add, dl = torch.from_numpy(add).cuda(), torch.from_numpy(dl).cuda()
            live = torch.ones(B, dtype=torch.bool, device="cuda")
            calls = {
                "other": lambda: old_k10(libs["other", "ingest"], row, add,
                                         dl, live, k),
                "this": lambda: ci._launch(row, add, dl, live, k, k,
                                           libs["this", "ingest"]),
            }
            want = ci.ingest_rows_delta_fused(row, add, dl, live,
                                              k_changed=k, k_deleted=k,
                                              kernel="torch")
            for tag in ("other", "this"):
                if not equal(calls[tag](), want):
                    raise AssertionError(f"K10 B={B} keys={keys}: the "
                                         f"{tag} design differs from plain")
            names = {"other": ("ingest_fold",),
                     "this": ("ingest_block", "ingest_grid")}
            t = in_turns(calls, names, args.reps)
            key = f"K10 entry E={E} A={A} B={B} keys={keys}"
            rows[key] = t
            print(f"{key}: other {fmt(t['other'])}; this {fmt(t['this'])} "
                  f"[{smi}]", flush=True)
    print(json.dumps({"device": smi, "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
