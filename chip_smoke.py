#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases (any failure exits nonzero; nothing is caught and passed over):
  1. environment: torch/CUDA versions, the card's name and power limit
     from nvidia-smi, the kernel build (one nvcc per source, in parallel)
     and ptxas's registers and shared memory for K9's kernel;
  2. kernels: every CUDA entry against its plain PyTorch version on the
     card, bitwise, over R x E x A shapes (the gossip verb's among
     them), offsets and scenario states; the packed entries (K6-K9) over
     their own shapes, in every δ mode, with counters near 2^31 and 2^32
     (bitpacked) or at the dot-word cap, and the R % 64 guard; K9 also at
     offsets whose cycles are whole segments (1-16 rows) or whose gcd
     with R is not a power of two (R = 192, 320);
  3. entry: ``entry()`` at 256 x 256 against the plain round, bitwise;
  4. full-state: the 1,048,576 x 256 fleet (A = 256 writers) through the
     dissemination schedule and the butterfly schedule, converged, with
     the kernel launches counted; then rounds of both schedules at that
     size again, the kernel against the plain version on the same input,
     bitwise; one butterfly run traced with torch.profiler (device idle
     share); per-launch times beside their bounds;
  5. packed full-state: the same fleet packed in the bitpacked and the
     dot-word layout through the dissemination schedule (K6, K7),
     converged, bitwise equal to the packed bool-layout result of phase
     4, every round against the plain version, times beside bounds;
  6. δ north star: phase 4 for the v2 δ fleet; phases 4 and 6 also hold
     the whole schedule at R = 16,384 against the plain schedule;
  7. packed δ north star: phase 5 for the δ fleet (K8, K9); then K9
     and the block-per-row design it replaced timed in turns at every
     offset of the schedule;
  8. one-row merge entries (K3): the gossip verb's fleet converged by
     ``gossip_round`` over ring permutations, then ``merge_pairwise``
     with a second fleet, against the plain versions;
  9. the gossip CLI verb on the card;
 10. the serve write path on one node (``serve --ingest`` defaults:
     E = 1,024, A = 16, batches of 32): 200 client micro-batches, adds,
     deletes and a peer's PAYLOAD body through ``Node``, durable
     checkpoints every 50 batches, ``restore_durable`` bitwise equal to
     the live node, every WAL record byte-identical to the plain K10's,
     the same op log on a CPU node to an equal state, K10 launched once
     per batch; then the K10 entry and ``ingest_batch`` timed on the
     legs of the JAX package's ``bench.measure_ingest``, each batch at
     most 5 device operations (torch.profiler);
 11. digest anti-entropy between nodes serving on 127.0.0.1: (a) the
     sync curve's fleet of tools/chaos_soak.py (5 nodes, E = 512, one
     ``SyncSupervisor`` each, lockstep rounds, 2 and 8 ops a round) in
     both sync modes, converged, no state lanes and no δ fallback in the
     digest regime's quiescent rounds, numbers and final states equal to
     the same legs on CPU nodes; (b) bench.measure_mesh's digest-read
     shape (E = 8,192, A = 8): ``node_summary`` and K11 timed on a
     quiescent pair; (c) one node's universe (E = 2^20, A = 16, 100,000
     members a node): digest rounds after 1, 16 and 1,024 changed lanes
     and at quiescence timed beside the δ ladder's bytes, K11 and
     ``digest_diff_payload`` timed, final states equal to a CPU replay;
and, after phase 2, phase 2b: the ingest kernel (K10, the whole entry in
one launch) against its plain version over E x A x B x K (one block up
to E = 4,096, the cooperative grid above), densities, padding patterns,
states with history and own clocks whose prefix sums cross 2^31 and wrap
at 2^32, with the one-copy WAL record read; and phase 2c: the digest
kernel (K11), both entries, against its plain version over 17 E x 2 lane
offsets x 11 group sizes x 6 states;
then one JSON line with every kernel (launches on the main path, error
against the plain version, times and bounds), and a last line
``{"ok": true, "device": {...}}``.  Without a CUDA GPU it exits nonzero
and prints no result.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet; at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
# 32-bit scalar ALU rate: the float32 non-tensor peak, used as the rate
# of the merges' 32-bit integer and logic operations
ALU_OPS_PER_S = 67e12
# integer/logic operations per element lane and per vv slot, counted from
# the algebra in csrc/merge.cu and csrc/delta.cu
OPS_PER_LANE = {"merge": 20, "delta": 60}
OPS_PER_SLOT = {"merge": 2, "delta": 6}
# csrc/ingest.cu: operations per lane and row of the fold, and per lane
# of the δ extraction after it
INGEST_OPS_PER_ROW_LANE, INGEST_OPS_PER_LANE = 10, 30

FLEET_R, FLEET_E, FLEET_W = 1 << 20, 256, 256
CHECK_R = 16_384
# the gossip verb's fleet: 64 replicas, 128 elements, one actor each
CLI_SHAPE = (64, 128, 64)
# ``serve --ingest`` as users start it (go_crdt_playground_tpu/__main__.py
# defaults): E elements, A actors, micro-batches of up to B rows
SERVE_E, SERVE_A, SERVE_B = 1024, 16, 32
# the legs of the JAX package's bench.measure_ingest: E, A and
# (B, keys per op)
INGEST_E, INGEST_A = 1024, 8
INGEST_LEGS = ((8, 1), (32, 1), (128, 1), (32, 16))
# K10's cases: element counts (one block up to 4,096 lanes, the
# cooperative grid above), actor counts (1, serve's 16, the kernel's cap),
# batch sizes and Ks
INGEST_CHECK_E = (1, 255, 1024, 4096, 4097, 1 << 20)
INGEST_CHECK_A = (1, 16, 2048)
INGEST_CHECK_B = (0, 1, 32, 128)
INGEST_CHECK_K = (128, 0)
# csrc/digest.cu: integer operations per lane of the fingerprint and fold
DIGEST_OPS_PER_LANE = 48
# K11's cases: element counts (ragged, aligned, quads cut by E and the
# 2^20 universe), group sizes (the protocol's ladder 8-128, the other
# powers of two to 256 and sizes that take the strided path) and lane
# offsets of the slice (1: pointers off the 4- and 16-byte alignment)
DIGEST_CHECK_E = (1, 5, 7, 63, 64, 65, 127, 128, 129, 512, 1000, 1023,
                  1024, 8192, 65_537, 1 << 20, (1 << 20) + 3)
DIGEST_CHECK_GS = (1, 3, 8, 16, 32, 48, 64, 100, 128, 256, 257)
DIGEST_CHECK_OFFSETS = (0, 1)
# tools/chaos_soak.py's sync curve at full size: nodes, elements, op rates
# per round, traffic, quiescent and settle rounds, seed
SYNC_NODES, SYNC_E, SYNC_RATES = 5, 512, (2, 8)
SYNC_TRAFFIC, SYNC_QUIESCENT, SYNC_SETTLE, SYNC_SEED = 8, 6, 20, 17
# bench.measure_mesh's digest-read shape
DIGEST_READ_E, DIGEST_READ_A = 8192, 8
# one node's universe: elements, actors, members seeded on each node
UNIVERSE_E, UNIVERSE_A, UNIVERSE_MEMBERS = 1 << 20, 16, 100_000


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def max_abs_err(got, want, what: str) -> int:
    """Largest unsigned difference over every field; raises unless 0."""
    import torch

    from go_crdt_playground_tpu_torch._u32 import widen

    err = 0
    for name, g, w in zip(want._fields, got, want):
        if torch.equal(g, w):
            continue
        if g.dtype == torch.bool:
            d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        else:
            d = (widen(g) - widen(w)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: field {name} differs from the "
                                 f"plain version (max abs err {err})")
    return err


def random_delta_state(rng, R, E, A, base, device):
    """A random δ state: deletions, re-adds (present lanes with a
    deletion record), ~20% silent rows (never wrote: empty, zero clocks),
    counters offset by ``base`` (straddling 2^31 when base is near it)."""
    from go_crdt_playground_tpu_torch.models import awset_delta

    maxc = 8
    present = rng.random((R, E)) < 0.5
    deleted = rng.random((R, E)) < 0.3
    silent = rng.random(R) < 0.2
    present[silent] = False
    deleted[silent] = False

    def counters(shape, lo):
        return rng.integers(lo, maxc + 2, shape).astype(np.uint64)

    vv, proc = counters((R, A), 0), counters((R, A), 0)
    vv[silent] = 0
    proc[silent] = 0
    vv = np.where(vv > 0, vv + base, 0)
    proc = np.where(proc > 0, proc + base, 0)
    da = rng.integers(0, A, (R, E))
    xa = rng.integers(0, A, (R, E))
    dc = counters((R, E), 1) + base
    xc = counters((R, E), 1) + base
    arrays = {
        "vv": vv, "present": present,
        "dot_actor": np.where(present, da, 0),
        "dot_counter": np.where(present, dc, 0),
        "actor": rng.integers(0, A, R),
        "deleted": deleted,
        "del_dot_actor": np.where(deleted, xa, 0),
        "del_dot_counter": np.where(deleted, xc, 0),
        "processed": proc,
    }
    arrays = {k: (v if v.dtype == bool else (v % (1 << 32)).astype(np.uint32))
              for k, v in arrays.items()}
    return awset_delta.from_arrays(arrays, device=device)


def checksum(state) -> int:
    """A device->host scalar that depends on every field."""
    import torch

    return int(sum(x.to(torch.int64).sum() for x in state))


def cuda_time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events around ``reps`` calls,
    after two warm calls whose results are alive together, as in the
    loop: the allocator then holds both output sets before the clock
    starts, and no device allocation falls inside the window."""
    import torch

    keep = fn()
    out = fn()
    del keep
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    del out
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_rounds(step, state, partners, key: str, errs: dict, what: str):
    """Replay a schedule round by round: each round's kernel output
    against the plain version on the same input, bitwise; the kernel's
    output feeds the next round.  Returns the final state."""
    for i, partner in enumerate(partners):
        got = step(state, partner, kernel="cuda")
        want = step(state, partner, kernel="torch")
        errs[key] = max(errs.get(key, 0),
                        max_abs_err(got, want, f"{what} round {i}"))
        del want
        state = got
    return state


def trace_run(fn, kernel_names):
    """Run ``fn`` once under torch.profiler; returns (result, report)
    where report holds the host wall, the device time of the named
    kernels and of every other device op, and the device's idle share
    of the wall (1 - the union of device intervals / wall) and the count
    of device operations.  The report is None when the profiler records
    no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, kern_us, other_us = [], 0.0, 0.0
    for ev in prof.events():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        if any(k in ev.name for k in kernel_names):
            kern_us += end - start
        else:
            other_us += end - start
    if not spans:
        return result, None
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return result, {"wall_ms": wall_us / 1e3, "kernel_ms": kern_us / 1e3,
                    "other_device_ms": other_us / 1e3,
                    "device_busy_ms": busy / 1e3,
                    "idle_share": max(0.0, 1.0 - busy / wall_us),
                    "device_ops": len(spans)}


class Counters:
    """The wrappers' launch counts, reset and read around one path."""

    def __init__(self):
        from go_crdt_playground_tpu_torch.ops import (cuda_delta, cuda_digest,
                                                      cuda_ingest, cuda_merge)

        self.wrappers = {
            "ring_round_rows": cuda_merge.ring_round_rows,
            "gossip_round_rows": cuda_merge.gossip_round_rows,
            "merge_pairwise_rows": cuda_merge.merge_pairwise_rows,
            "gossip_round": cuda_merge.gossip_round,
            "merge_pairwise": cuda_merge.merge_pairwise,
            "ring_round_rows_packed": cuda_merge.ring_round_rows_packed,
            "ring_round_rows_dotpacked":
                cuda_merge.ring_round_rows_dotpacked,
            "delta_ring_round": cuda_delta.delta_ring_round,
            "delta_gossip_round": cuda_delta.delta_gossip_round,
            "delta_ring_round_packed": cuda_delta.delta_ring_round_packed,
            "delta_ring_round_dotpacked":
                cuda_delta.delta_ring_round_dotpacked,
            "ingest_rows_delta_fused": cuda_ingest.ingest_rows_delta_fused,
            "lane_fingerprints": cuda_digest.lane_fingerprints,
            "state_group_digests": cuda_digest.state_group_digests,
        }
        self.main_path = {name: 0 for name in self.wrappers}

    def reset(self):
        for fn in self.wrappers.values():
            fn.launches = 0

    def read(self, path: str, exact: dict = None, at_least: dict = None):
        """Counts since reset; adds them to the main-path totals and
        fails unless each named kernel launched exactly ``exact[name]``
        times, or at least ``at_least[name]`` times."""
        counts = {n: fn.launches for n, fn in self.wrappers.items()}
        for name, want in (exact or {}).items():
            if counts[name] != want:
                raise AssertionError(f"{path}: {name} launched "
                                     f"{counts[name]} times, expected {want}")
        for name, want in (at_least or {}).items():
            if counts[name] < want:
                raise AssertionError(f"{path}: {name} launched "
                                     f"{counts[name]} times, expected at "
                                     f"least {want}")
        for name, got in counts.items():
            self.main_path[name] += got
        log(f"  launches [{path}]: "
            + ", ".join(f"{n}={c}" for n, c in counts.items() if c))
        return counts


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_environment():
    import torch

    from go_crdt_playground_tpu_torch.ops import _build

    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    smi = nvidia_smi_line()
    log(smi)
    t0 = time.perf_counter()
    libs = _build.build_all(["merge", "delta", "ingest", "digest"])
    log(f"kernel build: {time.perf_counter() - t0:.3f} s "
        f"({', '.join(p.name for p in libs.values())})")
    for name, kernel in (("delta", "delta_ring_walk"), ("ingest", "ingest_"),
                         ("digest", "group_digests")):
        for line in ptxas_report(_build.build_log(name), kernel):
            log(f"  ptxas: {line}")
    return smi


def ptxas_report(text: str, kernel: str):
    """The lines of an ``nvcc -Xptxas -v`` log about the kernels whose
    name holds ``kernel``: each entry's stack, spills, registers and
    shared memory."""
    lines, take = [], False
    for line in text.splitlines():
        if "Compiling entry function" in line:
            take = kernel in line
        if take:
            lines.append(line.replace("ptxas info    : ", "").strip())
    if not lines:
        raise AssertionError(f"the build log names no kernel {kernel}")
    return lines


def phase_kernels(errs: dict, shapes=None):
    """Every entry against its plain version, bitwise, on the card."""
    import torch

    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm
    from go_crdt_playground_tpu_torch.parallel import gossip

    if shapes is None:
        shapes = [(R, E, A) for R in (7, 128, 1000, 4096)
                  for E in (16, 300, 640) for A in (5, 256, 2048)]
        shapes.append(CLI_SHAPE)
    modes = [("v2", True), ("reference", True), ("reference", False)]
    rng = np.random.default_rng(2024)
    n_checks = 0

    def check(key, got, want, what):
        nonlocal n_checks
        errs[key] = max(errs.get(key, 0), max_abs_err(got, want, what))
        n_checks += 1

    t0 = time.perf_counter()
    for i, (R, E, A) in enumerate(shapes):
        base = (0x7FFFFFFB, 0, 0xFFFFFFF0 - 10)[i % 3]
        st = random_delta_state(rng, R, E, A, base, "cuda")
        other = random_delta_state(rng, R, E, A, base, "cuda").base()
        full = st.base()
        offsets = [0, 1, 63, 64, 65, 128, R + 5, 3 * R + 64]
        perms = [torch.from_numpy(rng.permutation(R)).cuda(),
                 gossip.ring_perm(R, 65, "cuda")]
        tag = f"R={R} E={E} A={A} base={base:#x}"
        for off in offsets:
            check("K1", cm.ring_round_rows(full, off, kernel="cuda"),
                  cm.ring_round_rows(full, off, kernel="torch"),
                  f"ring_round_rows {tag} offset={off}")
            for sem, strict in modes:
                kw = dict(delta_semantics=sem,
                          strict_reference_semantics=strict)
                check("K4", cd.delta_ring_round(st, off, kernel="cuda", **kw),
                      cd.delta_ring_round(st, off, kernel="torch", **kw),
                      f"delta_ring_round {tag} offset={off} {kw}")
        for perm in perms:
            check("K2", cm.gossip_round_rows(full, perm, kernel="cuda"),
                  cm.gossip_round_rows(full, perm, kernel="torch"),
                  f"gossip_round_rows {tag}")
            check("K3", cm.gossip_round(full, perm, kernel="cuda"),
                  cm.gossip_round(full, perm, kernel="torch"),
                  f"gossip_round {tag}")
            for sem, strict in modes:
                kw = dict(delta_semantics=sem,
                          strict_reference_semantics=strict)
                check("K5", cd.delta_gossip_round(st, perm, kernel="cuda",
                                                  **kw),
                      cd.delta_gossip_round(st, perm, kernel="torch", **kw),
                      f"delta_gossip_round {tag} {kw}")
        check("K2", cm.merge_pairwise_rows(full, other, kernel="cuda"),
              cm.merge_pairwise_rows(full, other, kernel="torch"),
              f"merge_pairwise_rows {tag}")
        check("K3", cm.merge_pairwise(full, other, kernel="cuda"),
              cm.merge_pairwise(full, other, kernel="torch"),
              f"merge_pairwise {tag}")
        # a converged fleet: every later δ is empty, so strict reference
        # rounds exercise the vv-skip
        conv = st
        for off in gossip.dissemination_offsets(R):
            conv = cd.delta_ring_round(conv, off, kernel="torch")
        for sem, strict in modes:
            kw = dict(delta_semantics=sem, strict_reference_semantics=strict)
            check("K4", cd.delta_ring_round(conv, 1, kernel="cuda", **kw),
                  cd.delta_ring_round(conv, 1, kernel="torch", **kw),
                  f"delta_ring_round converged {tag} {kw}")
    torch.cuda.synchronize()
    log(f"kernels: {n_checks} kernel-vs-plain checks over {len(shapes)} "
        f"shapes bitwise equal ({time.perf_counter() - t0:.1f} s)")


def ingest_slice(rng, E, A, dot_base, own_clock, wild_actors, device):
    """One replica slice with history (``random_delta_state``'s lanes:
    foreign dots, deletion records, re-adds, dots its vv does not cover)
    and its own clock at ``own_clock``; with ``wild_actors`` a tenth of
    the present lanes carry a dot actor outside [0, A) (the clip rule)."""
    import torch

    st = random_delta_state(rng, 1, E, A, dot_base, device)
    row = type(st)(*(x[0] for x in st))
    own = torch.arange(A, device=row.vv.device) == row.actor.to(torch.int64)
    clock = own_clock - (1 << 32 if own_clock >= 1 << 31 else 0)
    row = row._replace(vv=torch.where(own, clock, row.vv).to(torch.int32))
    if wild_actors:
        wild = torch.from_numpy(rng.random(E) < 0.1).to(row.vv.device)
        row = row._replace(dot_actor=torch.where(
            row.present & wild, A + 3, row.dot_actor).to(torch.int32))
    return row


def phase_ingest_kernel(errs: dict):
    """K10 against its plain version on the card, bitwise: the 12 lanes,
    vv, processed and the compact form, over E x A x B (one block up to
    E = 4,096, the cooperative grid above), densities, padding patterns,
    states with history, own clocks whose prefix sums cross 2^31 or wrap
    at 2^32, K = 128 and K = 0 (no compact form), and the compact form's
    one-copy host read.  B = 0 launches the kernel; A = 2049 raises."""
    import torch

    from go_crdt_playground_tpu_torch._u32 import host, to_host
    from go_crdt_playground_tpu_torch.ops import cuda_ingest as ci

    rng = np.random.default_rng(2026)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2026)
    n_checks = n_overflow = n_cross31 = n_wrap32 = 0

    def check(got, want, what):
        nonlocal n_checks
        errs["K10"] = max(errs.get("K10", 0), max_abs_err(got, want, what))
        n_checks += 1

    t0 = time.perf_counter()
    for i, E in enumerate(INGEST_CHECK_E):
        for j, A in enumerate(INGEST_CHECK_A):
            dot_base = (0x7FFFFFFB, 0, 0xFFFFFFF0 - 10)[(i + j) % 3]
            for bi, B in enumerate(INGEST_CHECK_B):
                clock = (0x7FFFFFF0, 0xFFFFFFF0, 0)[(i + j + bi) % 3]
                row = ingest_slice(rng, E, A, dot_base, clock, E == 1024,
                                   "cuda")
                for density in (0.0, 0.15, 0.9):
                    for pattern in ("all", "holes", "none"):
                        add = torch.rand((B, E), generator=gen,
                                         device="cuda") < density
                        dl = torch.rand((B, E), generator=gen,
                                        device="cuda") < density / 2
                        live = {"all": torch.ones(B, dtype=torch.bool),
                                "holes": torch.arange(B) % 3 != 1,
                                "none": torch.zeros(B, dtype=torch.bool),
                                }[pattern].cuda()
                        tag = (f"K10 E={E} A={A} B={B} density={density} "
                               f"live={pattern} clock={clock:#x}")
                        for kk in INGEST_CHECK_K:
                            want = ci.ingest_rows_delta_fused(
                                row, add, dl, live, k_changed=kk,
                                k_deleted=kk, kernel="torch")
                            before = ci.ingest_rows_delta_fused.launches
                            got = ci.ingest_rows_delta_fused(
                                row, add, dl, live, k_changed=kk,
                                k_deleted=kk, kernel="cuda")
                            if ci.ingest_rows_delta_fused.launches != \
                                    before + 1:
                                raise AssertionError(f"{tag}: no launch")
                            check(got[0], want[0], f"{tag} k={kk} state")
                            check(got[1], want[1], f"{tag} k={kk} payload")
                            if not kk:
                                if got[2] is not None:
                                    raise AssertionError(
                                        f"{tag}: k=0 gave a compact form")
                                continue
                            check(got[2], want[2], f"{tag} compact")
                            pre, dense, rec = ci.record_to_host(
                                row.vv, got[1], got[2])
                            if bool(want[2].overflow):
                                dense_ok = all(
                                    np.array_equal(g, w) for g, w in
                                    zip(dense, to_host(want[1])))
                            else:
                                dense_ok = dense is got[1]
                            if not (dense_ok
                                    and np.array_equal(pre, host(row.vv))
                                    and all(np.array_equal(g, w) for g, w
                                            in zip(rec, to_host(want[2])))):
                                raise AssertionError(
                                    f"{tag}: the one-copy record read "
                                    "differs")
                            n_overflow += bool(want[2].overflow)
                        steps = int((add & live[:, None]).sum()
                                    + (dl & live[:, None]).any(1).sum())
                        n_cross31 += clock < 1 << 31 <= clock + steps
                        n_wrap32 += clock + steps >= 1 << 32
    if not (n_overflow and n_cross31 and n_wrap32):
        raise AssertionError(
            f"K10 cases missed a regime: {n_overflow} overflowing, "
            f"{n_cross31} crossing 2^31, {n_wrap32} wrapping 2^32")
    wide = ingest_slice(rng, 64, 2049, 0, 5, False, "cuda")
    rows = torch.zeros((2, 64), dtype=torch.bool, device="cuda")
    try:
        ci.ingest_rows_delta_fused(wide, rows, rows, rows[:, 0],
                                   k_changed=8, k_deleted=8)
    except ValueError:
        pass
    else:
        raise AssertionError("K10 with A = 2049 did not raise")
    torch.cuda.synchronize()
    n_shapes = len(INGEST_CHECK_E) * len(INGEST_CHECK_A) * len(INGEST_CHECK_B)
    log(f"ingest kernel: {n_checks} K10-vs-plain checks over {n_shapes} "
        f"(E, A, B) shapes x 9 batch kinds x K in {INGEST_CHECK_K} bitwise "
        f"equal, one-copy record reads equal, B = 0 launched, "
        f"{n_overflow} overflowing batches, {n_cross31} crossing 2^31, "
        f"{n_wrap32} wrapping 2^32; A = 2049 raises "
        f"({time.perf_counter() - t0:.1f} s)")


def digest_slices(rng, E: int, device, offset: int = 0):
    """K11's cases at one E: two random slices, their deletion dots
    straddling 2^31 and reaching 2^32 - 1, and the occupancy extremes
    (empty, all present, all deleted, all present and deleted).  With
    ``offset`` the lanes are views starting ``offset`` lanes into tensors
    of E + offset lanes."""
    import torch

    out = {}
    lanes = ("present", "dot_actor", "dot_counter", "deleted",
             "del_dot_actor", "del_dot_counter")
    for name, base in (("random near 2^31", 0x7FFFFFF8),
                       ("random to 2^32 - 1", 0xFFFFFFF6)):
        st = random_delta_state(rng, 1, E + offset, 8, base, device)
        row = type(st)(*(x[0] for x in st))
        out[name] = row._replace(**{n: getattr(row, n)[offset:]
                                    for n in lanes})
    row = out["random to 2^32 - 1"]
    yes = torch.ones(E + offset, dtype=torch.bool, device=device)[offset:]
    no = torch.zeros_like(yes)
    zero = torch.zeros(E + offset, dtype=torch.int32, device=device)[offset:]
    out["empty"] = row._replace(present=no, deleted=no, del_dot_actor=zero,
                                del_dot_counter=zero)
    out["all present"] = row._replace(present=yes)
    out["all deleted"] = row._replace(deleted=yes)
    out["all present and deleted"] = row._replace(present=yes, deleted=yes)
    return out


def phase_digest_kernel(errs: dict):
    """K11 against its plain version on the card, bitwise: both entries
    (the lane fingerprints, and the group digests at every group size)
    over every E of ``DIGEST_CHECK_E``, both lane offsets and the cases
    of ``digest_slices``; each call must launch the kernel once."""
    import torch

    from go_crdt_playground_tpu_torch._u32 import widen
    from go_crdt_playground_tpu_torch.ops import cuda_digest as cg

    rng = np.random.default_rng(2027)
    n_checks = 0

    def check(fn, row, what, *args):
        nonlocal n_checks
        before = fn.launches
        got = fn(row, *args, kernel="cuda")
        if fn.launches != before + 1:
            raise AssertionError(f"{what}: no launch")
        want = fn(row, *args, kernel="torch")
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                                 f"{want.dtype}{tuple(want.shape)}")
        err = int((widen(got) - widen(want)).abs().max()) if got.numel() \
            else 0
        errs["K11"] = max(errs.get("K11", 0), err)
        if err:
            raise AssertionError(f"{what}: differs from the plain version "
                                 f"(max abs err {err})")
        n_checks += 1

    t0 = time.perf_counter()
    for E in DIGEST_CHECK_E:
        for off in DIGEST_CHECK_OFFSETS:
            for case, row in digest_slices(rng, E, "cuda", off).items():
                tag = f"E={E} offset={off} {case}"
                check(cg.lane_fingerprints, row, f"K11 fingerprints {tag}")
                for gs in DIGEST_CHECK_GS:
                    check(cg.state_group_digests, row,
                          f"K11 group digests {tag} gs={gs}", gs)
    torch.cuda.synchronize()
    log(f"digest kernel: {n_checks} K11-vs-plain checks over "
        f"{len(DIGEST_CHECK_E)} E x lane offsets {DIGEST_CHECK_OFFSETS} x 6 "
        f"cases (fingerprints, and group digests at gs in "
        f"{DIGEST_CHECK_GS}) bitwise equal, 0 mismatches "
        f"({time.perf_counter() - t0:.1f} s)")


def phase_packed_kernels(errs: dict, shapes=None):
    """The packed entries (K6-K9) against their plain versions, bitwise,
    on the card: every offset of phase 2, every δ mode, converged fleets
    (empty δ).  Bitpacked states take phase 2's counter bases (across
    2^31, near 2^32); dot-word states a base whose counters reach the
    20-bit cap.  R = 1000 must raise, as the reference does."""
    import torch

    from go_crdt_playground_tpu_torch._u32 import widen
    from go_crdt_playground_tpu_torch.models import packed
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm
    from go_crdt_playground_tpu_torch.parallel import gossip

    if shapes is None:
        shapes = [(R, E, A) for R in (128, 192, 320, 1024, 4096)
                  for E in (16, 300, 640, 4100) for A in (5, 256, 2048)]
    modes = [("v2", True), ("reference", True), ("reference", False)]
    rng = np.random.default_rng(2025)
    n_checks = 0

    def check(key, fn, state, off, what, **kw):
        nonlocal n_checks
        errs[key] = max(errs.get(key, 0), max_abs_err(
            fn(state, off, kernel="cuda", **kw),
            fn(state, off, kernel="torch", **kw), what))
        n_checks += 1

    def converge(st):
        for off in gossip.dissemination_offsets(st.num_replicas):
            st = cd.delta_ring_round(st, off, kernel="torch")
        return st

    t0 = time.perf_counter()
    for i, (R, E, A) in enumerate(shapes):
        bits_base = (0x7FFFFFFB, 0, 0xFFFFFFF0 - 10)[i % 3]
        dots_base = (packed.DOT_MAX_COUNTER - 9, 0)[i % 2]
        st = random_delta_state(rng, R, E, A, bits_base, "cuda")
        std = random_delta_state(rng, R, E, A, dots_base, "cuda")
        if dots_base and int(widen(std.dot_counter).max()) != \
                packed.DOT_MAX_COUNTER:
            raise AssertionError("no dot counter at the 20-bit cap")
        tag = f"R={R} E={E} A={A}"
        layouts = (
            ("K6", cm.ring_round_rows_packed, packed.pack_awset(st.base())),
            ("K7", cm.ring_round_rows_dotpacked,
             packed.pack_awset_dots(std.base())),
            ("K8", cd.delta_ring_round_packed, packed.pack_awset_delta(st)),
            ("K9", cd.delta_ring_round_dotpacked,
             packed.pack_awset_delta_dots(std)))
        if E >= 32 and int(layouts[0][2].present_bits.min()) >= 0:
            raise AssertionError("no membership word has bit 31 set")
        common = [0, 1, 63, 64, 65, 128, R + 5, 3 * R + 64]
        for off in sorted(set(common) | set(walk_offsets(R))):
            for key, fn, state in layouts:
                if key != "K9" and off not in common:
                    continue
                if key in ("K6", "K7"):
                    check(key, fn, state, off, f"{key} {tag} offset={off}")
                    continue
                for sem, strict in modes:
                    check(key, fn, state, off,
                          f"{key} {tag} offset={off} {sem}/{strict}",
                          delta_semantics=sem,
                          strict_reference_semantics=strict)
        # converged fleets: every δ is empty (the strict vv skip)
        conv = (("K8", cd.delta_ring_round_packed,
                 packed.pack_awset_delta(converge(st))),
                ("K9", cd.delta_ring_round_dotpacked,
                 packed.pack_awset_delta_dots(converge(std))))
        for key, fn, state in conv:
            for off in ((1, R // 2) if key == "K9" else (1,)):
                for sem, strict in modes:
                    check(key, fn, state, off,
                          f"{key} converged {tag} offset={off} "
                          f"{sem}/{strict}", delta_semantics=sem,
                          strict_reference_semantics=strict)
    bad = packed.pack_awset(random_delta_state(rng, 1000, 16, 5, 0,
                                               "cuda").base())
    try:
        cm.ring_round_rows_packed(bad, 1)
    except ValueError:
        pass
    else:
        raise AssertionError("a packed state with R = 1000 did not raise")
    torch.cuda.synchronize()
    log(f"packed kernels: {n_checks} kernel-vs-plain checks over "
        f"{len(shapes)} shapes bitwise equal; R = 1000 raises "
        f"({time.perf_counter() - t0:.1f} s)")


def walk_offsets(R: int):
    """Offsets for K9's cycle walk at R rows: whole cycles of one (0),
    two, four and sixteen rows, segments cut from cycles of R rows, and
    (at R = 192, 320) cycles whose count gcd(offset, R) is not a power of
    two: 45, 72 and 100 give 3, 24 and 4 cycles at 192, 5, 8 and 20 at
    320."""
    return sorted({0, 1, 5, 45, 64, 72, 100, R // 2, R // 4, R // 16,
                   3 * R // 16, R - 1, 3 * R + 64})


def phase_entry(counters: Counters, errs: dict):
    from go_crdt_playground_tpu_torch.entry import entry
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm
    from go_crdt_playground_tpu_torch.parallel import collectives

    fn, (state, offset) = entry()
    counters.reset()
    merged, conv = fn(state, offset)
    counters.read("entry", exact={"ring_round_rows": 1})
    want = cm.ring_round_rows(state, offset, kernel="torch")
    errs["K1"] = max(errs.get("K1", 0),
                     max_abs_err(merged, want, "entry() vs plain round"))
    if bool(conv) != bool(collectives.converged(want.present, want.vv)):
        raise AssertionError("entry(): converged flag differs")
    log(f"entry: 256 x 256 ring round bitwise equal to the plain round, "
        f"converged={bool(conv)}")


def _schedule_bytes(kind: str, R: int, E: int, A: int, gather: bool,
                    layout: str = "bool"):
    """Least bytes of one round: each input read once, each output
    written once (the partner rows are rows of the same input).  Per
    row, W = ceil(E/32): full-state bool 4A+9E, bitpacked 4A+4W+8E,
    dot-word 4A+4W+4E; δ twice that (processed, the deletion log), plus
    the actor column."""
    w = (E + 31) // 32
    lanes = {"bool": 9 * E, "bits": 4 * w + 8 * E, "dots": 4 * w + 4 * E}
    if kind == "merge":
        state = R * (4 * A + lanes[layout])
        extra = 0
    else:
        state = R * 2 * (4 * A + lanes[layout])
        extra = 4 * R                          # the actor column
    return 2 * state + extra + (8 * R if gather else 0)


def bounds(kind: str, R: int, E: int, A: int, gather: bool,
           layout: str = "bool"):
    nbytes = _schedule_bytes(kind, R, E, A, gather, layout)
    ops = R * (E * OPS_PER_LANE[kind] + A * OPS_PER_SLOT[kind])
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ALU_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes)


def phase_fleet(kind: str, counters: Counters, errs: dict, timings: dict,
                smi: str):
    """The 1M-replica fleet through the dissemination schedule (ring
    kernel) and the butterfly schedule (gather kernel), converged; every
    round of both at 1M and the R = 16,384 schedule against the plain
    version, bitwise.  Returns the dissemination schedule's final
    state."""
    import torch

    from go_crdt_playground_tpu_torch import fleet as fleet_mod
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm
    from go_crdt_playground_tpu_torch.parallel import collectives, gossip

    delta = kind == "delta"
    R, E, W = FLEET_R, FLEET_E, FLEET_W
    build = fleet_mod.delta_fleet if delta else fleet_mod.build_state
    ring_name = "delta_ring_round" if delta else "ring_round_rows"
    gather_name = "delta_gossip_round" if delta else "gossip_round_rows"
    ring_k, gather_k = ("K4", "K5") if delta else ("K1", "K2")
    label = "δ v2" if delta else "full-state"

    # whole schedule at R = 16,384: kernel vs plain, bitwise
    small = build(CHECK_R, E, W, "cuda")
    ring = cd.delta_ring_round if delta else cm.ring_round_rows
    got, want = small, small
    for off in gossip.dissemination_offsets(CHECK_R):
        got = ring(got, off, kernel="cuda")
        want = ring(want, off, kernel="torch")
    errs[ring_k] = max(errs.get(ring_k, 0), max_abs_err(
        got, want, f"{label} schedule at R={CHECK_R}"))
    if not bool(collectives.converged(got.present, got.vv)):
        raise AssertionError(f"{label} schedule at R={CHECK_R} not "
                             "converged")
    log(f"{label}: R={CHECK_R} dissemination schedule on the kernel "
        "bitwise equal to the plain schedule, converged")
    del small, got, want

    t0 = time.perf_counter()
    state = build(R, E, W, "cuda")
    torch.cuda.synchronize()
    log(f"{label}: fleet {R} x {E}, A={W} built in "
        f"{time.perf_counter() - t0:.2f} s "
        f"({sum(x.numel() * x.element_size() for x in state) / 1e9:.3f} GB)")
    offsets = gossip.dissemination_offsets(R)

    # warm once, then the counted and timed main-path run
    warm = gossip.all_pairs_converge(state, delta=delta)
    del warm
    torch.cuda.synchronize()
    counters.reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = gossip.all_pairs_converge(state, delta=delta)
    end.record()
    total = checksum(out)
    sched_ms = start.elapsed_time(end)
    counters.read(f"{label} dissemination", exact={ring_name: len(offsets)})
    conv = bool(collectives.converged(out.present, out.vv))
    if not conv:
        raise AssertionError(f"{label} fleet not converged after the "
                             "dissemination schedule")
    final = out   # phases 5 and 7 hold the packed schedules against it
    del out
    bound_ms, _, nbytes = bounds("delta" if delta else "merge", R, E, W,
                                 False)
    log(f"{label}: {len(offsets)} dissemination rounds, converged={conv}, "
        f"schedule {sched_ms:.3f} ms, {sched_ms / len(offsets):.4f} "
        f"ms/round (least bytes {nbytes / 1e9:.3f} GB/round -> bound "
        f"{bound_ms:.4f} ms/round at 3.35 TB/s; checksum {total}) "
        f"[{smi}]")

    # the same schedule again, every round's kernel output against the
    # plain version on the same input (not counted as main path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    replay = check_rounds(ring, state, offsets, ring_k, errs,
                          f"{label} {R}x{E} dissemination")
    if checksum(replay) != total:
        raise AssertionError(f"{label}: the replayed schedule differs from "
                             "the counted run")
    del replay
    log(f"{label}: all {len(offsets)} dissemination rounds at {R} x {E} "
        f"bitwise equal to the plain version "
        f"({time.perf_counter() - t0:.1f} s)")

    # the butterfly schedule through rounds_to_convergence: gather kernel,
    # a digest every check_every rounds and bisection to the exact count
    torch.cuda.empty_cache()
    counters.reset()
    start.record()
    t0 = time.perf_counter()
    rounds, out = gossip.rounds_to_convergence(state, delta=delta,
                                               schedule="butterfly")
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counters.read(f"{label} butterfly",
                             at_least={gather_name: rounds})[gather_name]
    if rounds != len(offsets):
        raise AssertionError(f"{label} butterfly: {rounds} rounds, "
                             f"expected {len(offsets)}")
    total = checksum(out)
    del out
    log(f"{label}: butterfly schedule converged in {rounds} rounds, "
        f"{launched} launches with the bisection replay; "
        f"{wall * 1e3:.3f} ms host wall, {start.elapsed_time(end):.3f} ms "
        f"between CUDA events [{smi}]")

    # one more run of it under torch.profiler: where the time goes
    torch.cuda.empty_cache()
    (_, traced), report = trace_run(
        lambda: gossip.rounds_to_convergence(state, delta=delta,
                                             schedule="butterfly"),
        ("merge_rows", "delta_rows"))
    del traced
    if report is None:
        log(f"{label}: butterfly trace: the profiler recorded no device "
            "activity; idle share not measured")
    else:
        log(f"{label}: butterfly trace (torch.profiler): " + ", ".join(
            f"{k} {v:.4f}" for k, v in report.items()) + f" [{smi}]")

    # the butterfly rounds again, kernel against plain version
    torch.cuda.empty_cache()
    stages = R.bit_length() - 1
    replay = check_rounds(
        cd.delta_gossip_round if delta else cm.gossip_round_rows, state,
        [gossip.butterfly_perm(R, rnd % stages, "cuda")
         for rnd in range(rounds)],
        gather_k, errs, f"{label} {R}x{E} butterfly")
    if checksum(replay) != total:
        raise AssertionError(f"{label}: the replayed butterfly schedule "
                             "differs from rounds_to_convergence's")
    del replay
    log(f"{label}: all {rounds} butterfly rounds at {R} x {E} bitwise "
        "equal to the plain version")

    # per-launch times at the fleet's shapes (not counted as main path)
    torch.cuda.empty_cache()
    kind_k = "delta" if delta else "merge"
    perm = gossip.butterfly_perm(R, 3, "cuda")
    rounds_iter = iter(range(10 ** 9))

    def ring_call(kernel):
        return lambda: ring(state, offsets[next(rounds_iter) % len(offsets)],
                            kernel=kernel)

    gather = cd.delta_gossip_round if delta else cm.gossip_round_rows
    for key, call, plain_call, gathered in (
            (ring_k, ring_call("cuda"), ring_call("torch"), False),
            (gather_k, lambda: gather(state, perm, kernel="cuda"),
             lambda: gather(state, perm, kernel="torch"), True)):
        ms = cuda_time_ms(call, 20)
        torch.cuda.empty_cache()
        plain_ms = cuda_time_ms(plain_call, 2)
        torch.cuda.empty_cache()
        bound_ms, bound_by, nbytes = bounds(kind_k, R, E, W, gathered)
        timings[key] = {"ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"{label} {key}: {ms:.4f} ms/launch, plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e9:.3f} GB) "
            f"-> {bound_ms / ms:.1%} of bound [{smi}]")
    del state
    torch.cuda.empty_cache()
    return final


def phase_packed_fleet(kind: str, final, counters: Counters, errs: dict,
                       timings: dict, smi: str):
    """The 1M-replica fleet packed in the bitpacked and the dot-word
    layout through the dissemination schedule on the packed kernels:
    launches counted, converged, bitwise equal to ``pack(final)`` (the
    bool-layout schedule's result), every round against the plain
    version, each launch timed beside its layout's bound."""
    import torch

    from go_crdt_playground_tpu_torch import fleet as fleet_mod
    from go_crdt_playground_tpu_torch.models import packed
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm
    from go_crdt_playground_tpu_torch.parallel import collectives, gossip

    delta = kind == "delta"
    R, E, W = FLEET_R, FLEET_E, FLEET_W
    offsets = gossip.dissemination_offsets(R)
    if delta:
        build = fleet_mod.delta_fleet
        layouts = (
            ("K8", "bits", "delta_ring_round_packed",
             cd.delta_ring_round_packed, packed.pack_awset_delta,
             packed.unpack_awset_delta),
            ("K9", "dots", "delta_ring_round_dotpacked",
             cd.delta_ring_round_dotpacked, packed.pack_awset_delta_dots,
             packed.unpack_awset_delta_dots))
    else:
        build = fleet_mod.build_state
        layouts = (
            ("K6", "bits", "ring_round_rows_packed",
             cm.ring_round_rows_packed, packed.pack_awset,
             packed.unpack_awset),
            ("K7", "dots", "ring_round_rows_dotpacked",
             cm.ring_round_rows_dotpacked, packed.pack_awset_dots,
             packed.unpack_awset_dots))
    label = "δ v2" if delta else "full-state"
    for key, layout, name, step, pack, unpack in layouts:
        what = f"{label} {layout}"
        t0 = time.perf_counter()
        state = pack(build(R, E, W, "cuda"))
        torch.cuda.synchronize()
        log(f"{what}: fleet {R} x {E}, A={W} built and packed in "
            f"{time.perf_counter() - t0:.2f} s ("
            f"{sum(x.numel() * x.element_size() for x in state) / 1e9:.3f}"
            " GB)")

        def schedule(s):
            for off in offsets:
                s = step(s, off)
            return s

        warm = schedule(state)
        del warm
        torch.cuda.synchronize()
        counters.reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = schedule(state)
        end.record()
        total = checksum(out)
        sched_ms = start.elapsed_time(end)
        counters.read(what, exact={name: len(offsets)})
        if layout == "bits":
            conv = bool(collectives.converged_packed(out.present_bits,
                                                     out.vv))
        else:
            full = unpack(out, E)
            conv = bool(collectives.converged(full.present, full.vv))
            del full
        if not conv:
            raise AssertionError(f"{what} fleet not converged")
        want = pack(final)
        for field, g, w in zip(want._fields, out, want):
            if not torch.equal(g, w):
                raise AssertionError(f"{what}: field {field} differs from "
                                     "pack() of the bool-layout schedule")
        del out, want
        bound_ms, _, nbytes = bounds(kind, R, E, W, False, layout)
        log(f"{what}: {len(offsets)} dissemination rounds, converged, "
            f"bitwise equal to pack() of the bool-layout result; schedule "
            f"{sched_ms:.3f} ms, {sched_ms / len(offsets):.4f} ms/round "
            f"(least bytes {nbytes / 1e9:.3f} GB/round -> bound "
            f"{bound_ms:.4f} ms/round at 3.35 TB/s; checksum {total}) "
            f"[{smi}]")

        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        replay = check_rounds(step, state, offsets, key, errs,
                              f"{what} {R}x{E} dissemination")
        if checksum(replay) != total:
            raise AssertionError(f"{what}: the replayed schedule differs "
                                 "from the counted run")
        del replay
        log(f"{what}: all {len(offsets)} rounds at {R} x {E} bitwise equal "
            f"to the plain version ({time.perf_counter() - t0:.1f} s)")

        torch.cuda.empty_cache()
        rounds_iter = iter(range(10 ** 9))

        def call(kernel):
            return lambda: step(
                state, offsets[next(rounds_iter) % len(offsets)],
                kernel=kernel)

        ms = cuda_time_ms(call("cuda"), 20)
        torch.cuda.empty_cache()
        plain_ms = cuda_time_ms(call("torch"), 2)
        torch.cuda.empty_cache()
        timings[key] = {"ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": "bytes"}
        log(f"{what} {key}: {ms:.4f} ms/launch, plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.4f} ms (bytes, {nbytes / 1e9:.3f} GB) -> "
            f"{bound_ms / ms:.1%} of bound [{smi}]")
        if key == "K9":
            timings[key].update(compare_k9_designs(state, offsets, bound_ms,
                                                   smi))
        del state
        torch.cuda.empty_cache()


def compare_k9_designs(state, offsets, bound_ms: float, smi: str,
                       reps: int = 5) -> dict:
    """K9's cycle walk and the block-per-row design it replaced, at
    every offset of the schedule: first a check that both give the same
    round at each offset, then each offset timed in turns on this card
    (walk, rows, rows, walk; ``reps`` launches each).  Not counted as
    main path."""
    import torch

    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd

    for off in offsets:
        walk = cd.delta_ring_round_dotpacked(state, off)
        rows = cd._delta_ring_round_dotpacked_rowwise(state, off)
        for field, w, r in zip(walk._fields, walk, rows):
            if not torch.equal(w, r):
                raise AssertionError(f"K9 offset {off}: field {field} of "
                                     "the two designs differs")
        del walk, rows
    walk_ms, rows_ms = [], []
    for off in offsets:
        t = {"walk": [], "rows": []}
        for which in ("walk", "rows", "rows", "walk"):
            fn = (cd.delta_ring_round_dotpacked if which == "walk" else
                  cd._delta_ring_round_dotpacked_rowwise)
            t[which].append(cuda_time_ms(lambda: fn(state, off), reps))
        walk_ms.append(sum(t["walk"]) / 2)
        rows_ms.append(sum(t["rows"]) / 2)
    torch.cuda.empty_cache()

    def mean(xs, keep):
        picked = [x for x, off in zip(xs, offsets) if keep(off)]
        return sum(picked) / len(picked)

    out = {}
    for name, keep in (("all", lambda o: True),
                       ("small", lambda o: o <= 1 << 13),
                       ("large", lambda o: o > 1 << 13)):
        w, r = mean(walk_ms, keep), mean(rows_ms, keep)
        out[f"walk_ms_{name}"], out[f"rows_ms_{name}"] = w, r
        log(f"  K9 designs, offsets {name} "
            f"({sum(map(keep, offsets))}): cycle walk {w:.4f} ms "
            f"({bound_ms / w:.1%} of bound), block per row {r:.4f} ms "
            f"({bound_ms / r:.1%}) [{smi}]")
    log("  K9 designs per offset: " + json.dumps(
        {"offsets": offsets, "walk_ms": walk_ms, "rows_ms": rows_ms}))
    return {"row_per_block_ms": out["rows_ms_all"]}


def phase_k3(counters: Counters, errs: dict, timings: dict, smi: str):
    """The one-row merge entries (K3) on the gossip verb's fleet: the
    fleet converged by ``gossip_round`` over the ring permutations of
    the dissemination schedule, then ``merge_pairwise`` with a second
    fleet; both against the plain versions, and timed."""
    import torch

    from go_crdt_playground_tpu_torch import fleet as fleet_mod
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm
    from go_crdt_playground_tpu_torch.parallel import collectives, gossip

    R, E, W = CLI_SHAPE
    state = fleet_mod.build_state(R, E, W, "cuda")
    other = fleet_mod.demo_state(R, E, device="cuda")
    perms = [gossip.ring_perm(R, off, "cuda")
             for off in gossip.dissemination_offsets(R)]
    counters.reset()
    out = state
    for perm in perms:
        out = cm.gossip_round(out, perm)
    merged = cm.merge_pairwise(out, other)
    torch.cuda.synchronize()
    counters.read("one-row merge entries",
                  exact={"gossip_round": len(perms), "merge_pairwise": 1})
    if not bool(collectives.converged(out.present, out.vv)):
        raise AssertionError("K3: the gossip verb's fleet not converged")
    want = state
    for perm in perms:
        want = cm.gossip_round(want, perm, kernel="torch")
    errs["K3"] = max(errs.get("K3", 0), max_abs_err(
        out, want, "K3 gossip_round schedule"))
    errs["K3"] = max(errs["K3"], max_abs_err(
        merged, cm.merge_pairwise(want, other, kernel="torch"),
        "K3 merge_pairwise"))
    ms = cuda_time_ms(lambda: cm.gossip_round(state, perms[0]), 20)
    plain_ms = cuda_time_ms(
        lambda: cm.gossip_round(state, perms[0], kernel="torch"), 2)
    bound_ms, bound_by, nbytes = bounds("merge", R, E, W, True)
    timings["K3"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by}
    log(f"K3: {R} x {E} fleet converged in {len(perms)} gossip_round "
        f"launches, merge_pairwise with a second fleet, both bitwise "
        f"equal to the plain versions; {ms:.4f} ms/launch, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.6f} ms ({bound_by}, "
        f"{nbytes} B) [{smi}]")


def phase_cli(counters: Counters):
    """The gossip verb on the card, in process."""
    from go_crdt_playground_tpu_torch.__main__ import main

    counters.reset()
    if main(["gossip", "--device", "cuda"]) != 0:
        raise AssertionError("gossip verb failed")
    counters.read("cli gossip", at_least={"ring_round_rows": 1})
    counters.reset()
    if main(["gossip", "--device", "cuda", "--delta", "--drop-rate", "0.3",
             "--schedule", "random", "--seed", "3"]) != 0:
        raise AssertionError("gossip verb (delta, random, drops) failed")
    counters.read("cli gossip delta random",
                  at_least={"delta_gossip_round": 1})


class Tally:
    """A recorder for nodes, their WAL and supervisors (``count``,
    ``count_many``), keeping totals."""

    def __init__(self):
        self.counts = {}
        self._lock = threading.Lock()  # server threads count too

    def count(self, name, n=1):
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n

    def count_many(self, counts):
        for name, n in counts.items():
            self.count(name, n)

    def counter(self, name):
        with self._lock:
            return self.counts.get(name, 0)


def full_payload_body(node) -> bytes:
    """A node's whole state as a dense FULL PAYLOAD body (what it ships
    on first contact)."""
    from go_crdt_playground_tpu_torch.net import framing
    from go_crdt_playground_tpu_torch.ops.delta import DeltaPayload

    me = node.state_slice()
    p = DeltaPayload(
        src_vv=me.vv, changed=me.present, ch_da=me.dot_actor,
        ch_dc=me.dot_counter, deleted=me.deleted, del_da=me.del_dot_actor,
        del_dc=me.del_dot_counter, src_actor=me.actor,
        src_processed=me.processed)
    return framing.encode_payload_msg(framing.MODE_FULL, node.actor,
                                      me.processed, p)


def serve_op_log(seed: int, E: int, B: int, n_batches: int):
    """The serve phase's op log: micro-batches of B rows (keys per op 1
    and 16 in turn, deletes, padding rows), an add and a delete call
    after every 10th batch, the peer's body at the middle and a durable
    checkpoint every 50 batches."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n_batches):
        keys = 16 if i % 2 else 1
        add = np.zeros((B, E), bool)
        for b in range(B):
            add[b, rng.choice(E, size=keys, replace=False)] = True
        dl = np.zeros((B, E), bool)
        dl[rng.random(B) < 0.2, rng.integers(E)] = True
        live = rng.random(B) < 0.85
        ops.append(("batch", (add, dl, live)))
        if i % 10 == 9:
            ops.append(("add", [int(x) for x in rng.integers(0, E, 3)]))
            ops.append(("delete", [int(x) for x in rng.integers(0, E, 2)]))
        if i == n_batches // 2:
            ops.append(("peer", ()))
        if i % 50 == 49:
            ops.append(("save", ()))
    return ops


def drive_node(node, ops, peer_body: bytes, store=None):
    for kind, args in ops:
        if kind == "batch":
            node.ingest_batch(*args)
        elif kind == "add":
            node.add(*args)
        elif kind == "delete":
            node.delete(*args)
        elif kind == "peer":
            node.apply_payload_body(peer_body)
        elif store is not None:
            node.save_durable(store)


def ingest_bounds(E: int, A: int, B: int, K: int):
    """K10's least time for the whole entry: bytes (vv, processed and the
    actor, the 6 state lanes and the two row masks and live flags of B
    rows read; the 12 output lanes, vv and processed, and the head: the
    pre-batch vv, the compact form's clocks, actor and K slots a
    section) over the memory rate, and operations over the scalar rate;
    the larger."""
    nbytes = (8 * A + 4 + 18 * E + 2 * B * E + B
              + 36 * E + 8 * A + 12 * A + 4 + 26 * K + 1)
    ops = E * (B * INGEST_OPS_PER_ROW_LANE + INGEST_OPS_PER_LANE)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ALU_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes)


# torch.profiler's names of K10's kernels
K10_KERNELS = ("ingest_block", "ingest_grid")
# device operations an ``ingest_batch`` may take on the K10 path: the
# rows' copy in, the launch, the record's copy out (and slack for two)
INGEST_BATCH_MAX_DEVICE_OPS = 5


def time_k10(E: int, A: int, B: int, keys: int, tmp: str, smi: str):
    """One leg: the K10 entry per call (``ingest_rows_delta_fused``, the
    whole entry in one launch: CUDA events, device time from the
    profiler), its plain version, and ``Node.ingest_batch`` wall per
    batch with the WAL's fsync and without, with the WAL bytes per batch
    and the device operations per batch (one K10 launch and at most
    ``INGEST_BATCH_MAX_DEVICE_OPS``, or the leg fails).  The batch is
    bench.measure_ingest's: B ops of ``keys`` distinct keys, one delete
    in the middle row."""
    import torch

    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.ops import cuda_ingest as ci
    from go_crdt_playground_tpu_torch.utils.wal import DeltaWal

    rng = np.random.default_rng(7)
    add = np.zeros((B, E), bool)
    for b in range(B):
        add[b, rng.choice(E, size=keys, replace=False)] = True
    dl = np.zeros((B, E), bool)
    dl[B // 2, rng.integers(E)] = True
    live = np.ones(B, bool)
    k = min(128, E)
    fresh = Node(0, E, A, device="cuda").state_slice()
    add_t, dl_t, live_t = (torch.from_numpy(x).cuda() for x in (add, dl, live))

    def entry():
        return ci.ingest_rows_delta_fused(fresh, add_t, dl_t, live_t,
                                          k_changed=k, k_deleted=k)

    ms = cuda_time_ms(entry, 200)
    _, report = trace_run(lambda: [entry() for _ in range(50)], K10_KERNELS)
    device_ms = None if report is None else report["kernel_ms"] / 50
    entry_ops = None if report is None else report["device_ops"] / 50
    plain_ms = cuda_time_ms(lambda: ci.ingest_rows_delta_fused(
        fresh, add_t, dl_t, live_t, k_changed=k, k_deleted=k,
        kernel="torch"), 10)
    bound_ms, bound_by, nbytes = ingest_bounds(E, A, B, k)
    walls, trace = {}, None
    for fsync in (True, False):
        tally = Tally()
        node = Node(0, E, A, recorder=tally, device="cuda", wal=DeltaWal(
            tempfile.mkdtemp(dir=tmp), fsync=fsync, recorder=tally))
        node.ingest_batch(add, dl, live)
        before = dict(tally.counts)
        reps = 40
        t0 = time.perf_counter()
        for _ in range(reps):
            node.ingest_batch(add, dl, live)
        walls[fsync] = (time.perf_counter() - t0) * 1e3 / reps
        wal_bytes = (tally.counts["wal.appended_bytes"]
                     - before["wal.appended_bytes"]) / reps
        compact = tally.counts.get("wal.compact_records", 0) > 0
        if fsync:
            # where a batch's time goes: device busy time and operations
            launched = ci.ingest_rows_delta_fused.launches
            _, trace = trace_run(lambda: [node.ingest_batch(add, dl, live)
                                          for _ in range(20)], K10_KERNELS)
            launched = ci.ingest_rows_delta_fused.launches - launched
            if launched != 20:
                raise AssertionError(f"serve leg B={B}: {launched} K10 "
                                     "launches in 20 ingest_batch calls")
            if trace is not None and (trace["device_ops"] / 20
                                      > INGEST_BATCH_MAX_DEVICE_OPS):
                raise AssertionError(
                    f"serve leg B={B}: {trace['device_ops'] / 20} device "
                    f"operations a batch (at most "
                    f"{INGEST_BATCH_MAX_DEVICE_OPS})")
        node.wal.close()
    leg = {"E": E, "A": A, "B": B, "keys_per_op": keys, "k10_ms": ms,
           "k10_device_ms": device_ms, "k10_device_ops": entry_ops,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_bytes": nbytes, "ingest_batch_ms": walls[True],
           "ingest_batch_ms_no_fsync": walls[False],
           "wal_bytes_per_batch": wal_bytes, "compact_records": compact,
           "ingest_batch_trace": None if trace is None else {
               "device_busy_ms_per_batch": trace["device_busy_ms"] / 20,
               "device_ops_per_batch": trace["device_ops"] / 20,
               "idle_share": trace["idle_share"]}}
    device = ("not measured" if device_ms is None
              else f"{device_ms:.6f} ms in {entry_ops:g} device ops")
    ops = ("not measured" if trace is None else
           f"{trace['device_ops'] / 20:g} device ops and "
           f"{trace['device_busy_ms'] / 20:.6f} ms device busy a batch, "
           f"idle share {trace['idle_share']:.4f}")
    log(f"serve leg B={B} keys/op={keys} (E={E}, A={A}): K10 entry "
        f"{ms:.4f} ms/call (device time {device}), plain {plain_ms:.3f} "
        f"ms, bound {bound_ms:.6f} ms ({bound_by}, {nbytes} B); "
        f"ingest_batch {walls[True]:.4f} ms/batch with fsync, "
        f"{walls[False]:.4f} without ({ops}); WAL {wal_bytes:.1f} B/batch "
        f"({'compact' if compact else 'dense'}) [{smi}]")
    return leg


def phase_serve(counters: Counters, errs: dict, timings: dict, smi: str):
    """The serve write path on one node at ``serve --ingest``'s shape:
    the op log through ``Node`` on the card (K10 once per batch, counted
    on the main path), durable checkpoints, ``restore_durable`` bitwise
    equal to the live node, the WAL records byte-identical to those of
    the plain K10 with the same K, the same op log on a CPU node (plain
    regime, K = 0) to an equal state; then the bench.measure_ingest legs
    timed."""
    import functools

    import torch

    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.ops import cuda_ingest as ci
    from go_crdt_playground_tpu_torch.utils.checkpoint import CheckpointStore
    from go_crdt_playground_tpu_torch.utils.wal import DeltaWal

    class TeeWal(DeltaWal):
        """A DeltaWal that also keeps every appended body."""

        def __init__(self, path, **kw):
            super().__init__(path, **kw)
            self.bodies = []

        def append(self, body):
            self.bodies.append(body)
            super().append(body)

    E, A, B, n_batches = SERVE_E, SERVE_A, SERVE_B, 200
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        ops = serve_op_log(11, E, B, n_batches)
        peer = Node(1, E, A, device="cuda")
        peer.add(*range(100, 140))
        peer.delete(*range(100, 105))
        body = full_payload_body(peer)
        durable = f"{tmp}/durable"
        tally = Tally()
        node = Node(0, E, A, recorder=tally, device="cuda",
                    wal=TeeWal(f"{durable}/wal", recorder=tally))
        store = CheckpointStore(durable, recorder=tally)
        torch.cuda.synchronize()
        counters.reset()
        t0 = time.perf_counter()
        drive_node(node, ops, body, store)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counters.read("serve write path",
                      exact={"ingest_rows_delta_fused": n_batches})
        live = node.state_slice()
        node.wal.close()
        back = Node.restore_durable(durable, device="cuda")
        for name, x, y in zip(live._fields, live, back.state_slice()):
            if not torch.equal(x, y):
                raise AssertionError(f"serve: restore_durable differs from "
                                     f"the live node in {name}")
        back.wal.close()

        plain = Node(0, E, A, device="cuda", wal=TeeWal(
            f"{tmp}/plain", fsync=False))
        plain._fused_regime = (functools.partial(
            ci.ingest_rows_delta_fused, kernel="torch"), min(128, E))
        drive_node(plain, ops, body)
        if plain.wal.bodies != node.wal.bodies:
            raise AssertionError("serve: WAL records differ from the plain "
                                 "K10's")
        plain.wal.close()
        cpu = Node(0, E, A, device="cpu", wal=TeeWal(f"{tmp}/cpu",
                                                     fsync=False))
        drive_node(cpu, ops, body)
        for name, x, y in zip(live._fields, live, cpu.state_slice()):
            if not torch.equal(x.cpu(), y):
                raise AssertionError(f"serve: the CPU node's {name} differs")
        cpu.wal.close()
        log(f"serve: {n_batches} batches of {B} (E={E}, A={A}) + adds, "
            f"deletes, a peer's FULL body, {n_batches // 50} checkpoints in "
            f"{wall:.3f} s ({wall * 1e3 / n_batches:.3f} ms/batch incl. "
            f"fsync); restore_durable bitwise equal to the live node; "
            f"{len(node.wal.bodies)} WAL records byte-identical to the "
            f"plain K10's ({tally.counts.get('wal.compact_records', 0)} "
            f"compact, {tally.counts.get('wal.dense_records', 0)} dense, "
            f"{tally.counts['wal.appended_bytes']} bytes); the CPU node's "
            f"state equal [{smi}]")

        legs = [time_k10(INGEST_E, INGEST_A, b, keys, tmp, smi)
                for b, keys in INGEST_LEGS]
        main = time_k10(E, A, B, 1, tmp, smi)
        timings["K10"] = {"ms": main["k10_ms"],
                          "device_ms": main["k10_device_ms"],
                          "plain_ms": main["plain_ms"],
                          "bound_ms": main["bound_ms"],
                          "bound_by": main["bound_by"]}
        log("serve legs: " + json.dumps(legs + [main]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def wait_served(nodes, timeout: float = 10.0) -> None:
    """Wait until no node is serving an exchange.  A server records its
    counters after its last send, so a count read as soon as the client
    returns could miss the server's half."""
    deadline = time.monotonic() + timeout
    while any(n._conn_slots._value < n._conn_slots._initial_value
              for n in nodes):
        if time.monotonic() > deadline:
            raise AssertionError("a served exchange did not finish")
        time.sleep(0.0005)


def sync_traffic_leg(sync_mode: str, n_nodes: int, n_elements: int,
                     ops_per_round: int, traffic_rounds: int, seed: int,
                     quiescent_rounds: int = 4, settle_rounds: int = 20,
                     device="cuda"):
    """tools/chaos_soak.py's ``run_traffic_leg`` on the port's nodes: a
    clean-network fleet, each node serving on 127.0.0.1 and driven by a
    ``SyncSupervisor`` (fanout 1, no pacing) in lockstep rounds, under a
    seeded op stream.  Phases: seed state and converge (first-contact
    FULLs land here), ``traffic_rounds`` rounds each after
    ``ops_per_round`` ops, settle rounds until converged, then
    ``quiescent_rounds`` rounds of a converged fleet.  Returns the tool's
    numbers and every node's final state (on the CPU)."""
    from go_crdt_playground_tpu_torch.net import digestsync
    from go_crdt_playground_tpu_torch.net.antientropy import SyncSupervisor
    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.utils.backoff import BackoffPolicy

    if sync_mode == "digest":
        digestsync.warm(Node(0, n_elements, n_nodes, device=device))
    tallies = [Tally() for _ in range(n_nodes)]
    nodes = [Node(i, n_elements, n_nodes, recorder=tallies[i], device=device)
             for i in range(n_nodes)]
    supervisors = []
    rng = np.random.default_rng(seed)

    def total(*names):
        return sum(t.counter(n) for t in tallies for n in names)

    def fleet_bytes():
        # every byte once, at its sender
        return total("sync.bytes_sent", "digest.bytes_sent")

    try:
        addrs = [n.serve() for n in nodes]
        policy = BackoffPolicy(base_s=0.005, cap_s=0.05, max_retries=2)
        for i in range(n_nodes):
            supervisors.append(SyncSupervisor(
                nodes[i], [addrs[j] for j in range(n_nodes) if j != i],
                policy=policy, sync_timeout_s=5.0, fanout=1, interval_s=0.0,
                sync_mode=sync_mode, recorder=tallies[i],
                seed=seed * 100 + i))

        def lockstep():
            for sup in supervisors:
                sup.sync_round()
            wait_served(nodes)

        def converged():
            m0 = set(nodes[0].members().tolist())
            vv0 = nodes[0].vv()
            return all(set(n.members().tolist()) == m0
                       and np.array_equal(n.vv(), vv0) for n in nodes[1:])

        def inject(n_ops):
            for _ in range(n_ops):
                node = nodes[int(rng.integers(n_nodes))]
                if rng.random() < 0.35:
                    members = node.members()
                    if len(members):
                        node.delete(int(rng.choice(members)))
                        continue
                node.add(int(rng.integers(n_elements)))

        inject(2 * n_nodes)
        for _ in range(settle_rounds):
            lockstep()
            if converged():
                break
        if not converged():
            raise AssertionError(f"sync fleet ({sync_mode}, {device}) failed "
                                 "to converge on its seed state")
        b0 = fleet_bytes()
        measured = 0
        for _ in range(traffic_rounds):
            inject(ops_per_round)
            lockstep()
            measured += 1
        settle = 0
        while not converged() and settle < settle_rounds:
            lockstep()
            measured += 1
            settle += 1
        conv = converged()
        divergent_bytes = fleet_bytes() - b0
        bq, lanes0 = fleet_bytes(), total("digest.lanes_sent")
        q0, fb0 = total("digest.quiescent"), total("digest.fallback_delta")
        for _ in range(quiescent_rounds):
            lockstep()
        stats = {
            "sync_mode": sync_mode, "converged": conv, "rounds": measured,
            "settle_rounds": settle, "bytes": divergent_bytes,
            "bytes_per_round": round(divergent_bytes / max(1, measured), 1),
            "quiescent_bytes_per_round": round(
                (fleet_bytes() - bq) / max(1, quiescent_rounds), 1),
            "quiescent_state_lanes": total("digest.lanes_sent") - lanes0,
            "quiescent_exchanges": total("digest.quiescent") - q0,
            "delta_fallbacks": total("digest.fallback_delta") - fb0,
        }
        states = [type(s)(*(x.cpu() for x in s))
                  for s in (n.state_slice() for n in nodes)]
        return stats, states
    finally:
        for sup in supervisors:
            sup.stop(timeout=1.0)
        for n in nodes:
            n.close()


def digest_bounds(E: int, gs: int, fingerprints: bool = False):
    """K11's least time: bytes (two bool bytes and two uint32 words read
    a lane; a uint32 written a group, or a lane for the fingerprints
    entry) over the memory rate, and operations over the scalar rate;
    the larger."""
    num_g = -(-E // gs)
    nbytes = 14 * E if fingerprints else 10 * E + 4 * num_g
    ops = DIGEST_OPS_PER_LANE * (E if fingerprints else num_g * gs)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ALU_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes)


def time_k11(row, gs: int, fingerprints: bool = False) -> dict:
    """One K11 entry on one state: ms per call by CUDA events (the
    wrapper, its checks and allocation included), the kernel's device
    time from torch.profiler, the plain version, the bound."""
    import functools

    from go_crdt_playground_tpu_torch.ops import cuda_digest as cg

    if fingerprints:
        fn = cg.lane_fingerprints
    else:
        fn = functools.partial(cg.state_group_digests, group_size=gs)
    launches = (cg.lane_fingerprints.launches,
                cg.state_group_digests.launches)
    ms = cuda_time_ms(lambda: fn(row, kernel="cuda"), 200)
    _, report = trace_run(lambda: [fn(row, kernel="cuda") for _ in range(50)],
                          ("group_digests",))
    plain_ms = cuda_time_ms(lambda: fn(row, kernel="torch"), 10)
    # timing launches are not the main path's
    cg.lane_fingerprints.launches, cg.state_group_digests.launches = launches
    E = int(row.present.shape[-1])
    bound_ms, bound_by, nbytes = digest_bounds(E, gs, fingerprints)
    return {"ms": ms, "device_ms": (None if report is None
                                    else report["kernel_ms"] / 50),
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": nbytes}


def fmt_device(t: dict) -> str:
    return ("not measured" if t["device_ms"] is None
            else f"{t['device_ms'] * 1e3:.3f} us")


def seed_members(node, rng, n_members: int, n_deletes: int) -> None:
    """``n_members`` adds in one client micro-batch row, then one row
    deleting ``n_deletes`` of them."""
    E = node.num_elements
    add = np.zeros((1, E), bool)
    ids = rng.choice(E, size=n_members, replace=False)
    add[0, ids] = True
    node.ingest_batch(add, np.zeros_like(add))
    dl = np.zeros_like(add)
    dl[0, rng.choice(ids, size=n_deletes, replace=False)] = True
    node.ingest_batch(np.zeros_like(add), dl)


def states_equal(a, b) -> bool:
    """Every field equal, dtype included."""
    import torch

    return all(x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
               for x, y in zip(a, b))


def pair_converged(a, b) -> bool:
    """Two replicas agree on membership, clocks and the deletion log
    (live dots may differ between converged replicas, ops/digest.py)."""
    import torch

    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in ("vv", "present", "deleted", "del_dot_actor",
                         "del_dot_counter"))


def phase_sync_fleet(counters: Counters, smi: str):
    """Phase 11a: the sync curve's fleet (tools/chaos_soak.py, full
    size) on CUDA nodes in both sync modes at both op rates, and the same
    legs on CPU nodes: converged, no state lanes and no δ fallback in the
    quiescent rounds of the digest regime, the same numbers and final
    states as the CPU fleet."""
    legs = []
    for rate in SYNC_RATES:
        pair = {}
        for mode in ("digest", "delta"):
            args = (mode, SYNC_NODES, SYNC_E, rate, SYNC_TRAFFIC, SYNC_SEED,
                    SYNC_QUIESCENT, SYNC_SETTLE)
            counters.reset()
            t0 = time.perf_counter()
            gpu, gpu_states = sync_traffic_leg(*args, device="cuda")
            wall = time.perf_counter() - t0
            counters.read(f"sync fleet {mode} {rate} ops/round",
                          at_least={"state_group_digests": 1}
                          if mode == "digest" else None)
            cpu, cpu_states = sync_traffic_leg(*args, device="cpu")
            if not gpu["converged"]:
                raise AssertionError(f"sync fleet {mode} {rate}: not "
                                     "converged")
            if mode == "digest" and (gpu["quiescent_state_lanes"]
                                     or gpu["delta_fallbacks"]
                                     or not gpu["quiescent_exchanges"]):
                raise AssertionError(f"sync fleet digest {rate}: quiescent "
                                     f"rounds not quiescent: {gpu}")
            if gpu != cpu:
                raise AssertionError(f"sync fleet {mode} {rate}: CUDA "
                                     f"{gpu} vs CPU {cpu}")
            for i, (g, c) in enumerate(zip(gpu_states, cpu_states)):
                if not states_equal(g, c):
                    raise AssertionError(f"sync fleet {mode} {rate}: node "
                                         f"{i} differs from the CPU fleet")
            pair[mode] = {**gpu, "wall_s": wall}
        legs.append({"ops_per_round": rate, **pair})
        log(f"sync fleet {SYNC_NODES} nodes x E={SYNC_E}, {rate} ops/round: "
            f"digest {pair['digest']['bytes_per_round']} B/round, "
            f"{pair['digest']['quiescent_bytes_per_round']} B/quiescent "
            f"round ({pair['digest']['quiescent_state_lanes']} state lanes, "
            f"{pair['digest']['quiescent_exchanges']} quiescent exchanges, "
            f"{pair['digest']['delta_fallbacks']} δ fallbacks, "
            f"{pair['digest']['rounds']} rounds, "
            f"{pair['digest']['wall_s']:.2f} s); δ "
            f"{pair['delta']['bytes_per_round']} B/round, "
            f"{pair['delta']['quiescent_bytes_per_round']} B/quiescent "
            f"round ({pair['delta']['rounds']} rounds, "
            f"{pair['delta']['wall_s']:.2f} s); converged, equal to the CPU "
            f"fleet's numbers and final states [{smi}]")
    log("sync fleet legs: " + json.dumps(legs))
    return legs


def converge_digest(node, addr, what: str, rounds: int = 4):
    from go_crdt_playground_tpu_torch.net import digestsync

    for _ in range(rounds):
        if digestsync.sync_digest(node, addr, timeout=120.0).quiescent:
            return
    raise AssertionError(f"{what}: no quiescent digest round")


def phase_digest_read(counters: Counters, timings: dict, smi: str):
    """Phase 11b: bench.measure_mesh's digest-read shape (E = 8,192,
    A = 8): a node pair converged to quiescence over sockets, then the
    summary read (``node_summary``) and K11 timed."""
    from go_crdt_playground_tpu_torch.net import digestsync
    from go_crdt_playground_tpu_torch.net.peer import Node

    E, A = DIGEST_READ_E, DIGEST_READ_A
    rng = np.random.default_rng(8192)
    a = Node(0, E, A, device="cuda")
    b = Node(1, E, A, device="cuda")
    counters.reset()
    try:
        seed_members(a, rng, 2000, 200)
        seed_members(b, rng, 2000, 200)
        addr = b.serve()
        a.sync_with(addr)
        converge_digest(a, addr, "digest read pair")
        counters.read("digest read pair", at_least={"state_group_digests": 2})
        digestsync.node_summary(a)
        reps = 30
        t0 = time.perf_counter()
        for _ in range(reps):
            body = digestsync.node_summary(a)
        summary_ms = (time.perf_counter() - t0) * 1e3 / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            st = digestsync.sync_digest(a, addr)
        round_ms = (time.perf_counter() - t0) * 1e3 / reps
        if not st.quiescent:
            raise AssertionError("digest read pair: not quiescent")
        k11 = time_k11(a.state_slice(), 64)
    finally:
        b.close()
    timings["K11 read"] = k11
    log(f"digest read E={E} A={A}: node_summary {summary_ms:.4f} ms "
        f"({len(body)} B), quiescent digest round {round_ms:.4f} ms; K11 "
        f"{k11['ms']:.4f} ms/call, device {fmt_device(k11)}, plain "
        f"{k11['plain_ms']:.4f} ms, bound {k11['bound_ms'] * 1e3:.4f} us "
        f"({k11['bound_by']}, {k11['bound_bytes']} B) [{smi}]")
    return {"E": E, "A": A, "summary_ms": summary_ms,
            "summary_bytes": len(body), "quiescent_round_ms": round_ms,
            "k11": k11}


def universe_leg(device, timed: bool):
    """Phase 11c's op and exchange sequence at E = 2^20, A = 16: two
    nodes seeded with ``UNIVERSE_MEMBERS`` members each (a tenth of them
    deleted), converged by first contact (untimed), then digest rounds
    after 1, 16 and 1,024 lanes changed on one side, quiescent digest
    rounds, and a δ-ladder exchange at the same state.  With ``timed``
    the rounds are measured and K11 and ``digest_diff_payload`` are
    timed on the state.  Returns (rows, final states)."""
    import torch

    from go_crdt_playground_tpu_torch.net import digestsync
    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.ops import digest as digest_ops

    E, A = UNIVERSE_E, UNIVERSE_A
    rng = np.random.default_rng(1 << 20)
    a = Node(0, E, A, device=device)
    b = Node(1, E, A, device=device)
    rows = {}
    try:
        for n in (a, b):
            seed_members(n, rng, UNIVERSE_MEMBERS, UNIVERSE_MEMBERS // 10)
        addr = b.serve()
        t0 = time.perf_counter()
        first = a.sync_with(addr, timeout=300.0)
        rows["first_contact"] = {
            "s": time.perf_counter() - t0,
            "bytes": first.bytes_sent + first.bytes_received}
        converge_digest(a, addr, "universe pair")
        for k in (1, 16, 1024, 0):
            members = set(a.members().tolist())
            fresh = [int(x) for x in rng.permutation(E)[:4 * k + 8]
                     if int(x) not in members][:k]
            if k:
                a.add(*fresh)
            if timed:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = digestsync.sync_digest(a, addr, timeout=120.0)
            wall_ms = (time.perf_counter() - t0) * 1e3
            row = {"round_ms": wall_ms, "bytes": st.bytes_sent
                   + st.bytes_received, "lanes_sent": st.lanes_sent,
                   "groups_mismatched": st.groups_mismatched,
                   "quiescent": st.quiescent}
            if k:
                # the pair's next round is quiescent
                if not digestsync.sync_digest(a, addr).quiescent:
                    raise AssertionError(f"universe: {k} lanes left the "
                                         "pair unconverged")
            elif not st.quiescent:
                raise AssertionError("universe: quiescent round shipped")
            if timed and k:
                # the mismatched-group extraction on this state, against
                # peer digests that differ in k groups
                with a._lock:
                    me = a._row()
                own = a._digest_fn(me, 64)
                peer = own.cpu().numpy().view(np.uint32).copy()
                flip = np.random.default_rng(k).choice(len(peer), size=k,
                                                       replace=False)
                peer[flip] ^= 1
                row["diff_payload_ms"] = cuda_time_ms(
                    lambda: digest_ops.digest_diff_payload(me, own, peer),
                    10)
            rows[f"{k} lanes"] = row

        def traced(fn):
            if not timed:
                fn()
                return None
            return trace_run(fn, ("group_digests",))[1]

        # where a round's time goes: a round after 16 more changed lanes,
        # then three quiescent rounds, under torch.profiler
        members = set(a.members().tolist())
        a.add(*[int(x) for x in rng.permutation(E)[:80]
                if int(x) not in members][:16])
        rows["trace_16_lanes"] = traced(
            lambda: digestsync.sync_digest(a, addr, timeout=120.0))
        rows["trace_3_quiescent"] = traced(
            lambda: [digestsync.sync_digest(a, addr) for _ in range(3)])
        t0 = time.perf_counter()
        ladder = a.sync_with(addr, timeout=120.0)
        rows["delta_ladder_quiescent"] = {
            "round_ms": (time.perf_counter() - t0) * 1e3,
            "bytes": ladder.bytes_sent + ladder.bytes_received}
        rows["summary_bytes"] = len(digestsync.node_summary(a))
        if timed:
            rows["k11"] = time_k11(a.state_slice(), 64)
            rows["k11_fingerprints"] = time_k11(a.state_slice(), 64,
                                                fingerprints=True)
        states = [type(s)(*(x.cpu() for x in s))
                  for s in (a.state_slice(), b.state_slice())]
        if not pair_converged(*states):
            raise AssertionError("universe: the pair did not converge")
        return rows, states
    finally:
        b.close()


def phase_universe(counters: Counters, timings: dict, smi: str):
    """Phase 11c: one node's universe at 2^20 on CUDA nodes, timed; the
    same sequence on CPU nodes (the plain versions throughout) to equal
    final states."""
    counters.reset()
    rows, states = universe_leg("cuda", timed=True)
    counters.read("universe pair", at_least={"state_group_digests": 10})
    _, cpu_states = universe_leg("cpu", timed=False)
    for g, c in zip(states, cpu_states):
        if not states_equal(g, c):
            raise AssertionError("universe: CUDA pair differs from the "
                                 "plain-version replay")
    k11 = rows["k11"]
    timings["K11"] = {key: k11[key] for key in
                      ("ms", "device_ms", "plain_ms", "bound_ms",
                       "bound_by")}
    log(f"universe E={UNIVERSE_E} A={UNIVERSE_A}: first contact "
        f"{rows['first_contact']['s']:.2f} s, "
        f"{rows['first_contact']['bytes']} B (untimed); summary "
        f"{rows['summary_bytes']} B")
    for k in (1, 16, 1024, 0):
        r = rows[f"{k} lanes"]
        diff = (f"digest_diff_payload {r['diff_payload_ms']:.4f} ms" if k
                else "quiescent, no extraction")
        log(f"  digest round, {k} lanes changed: {r['round_ms']:.3f} ms, "
            f"{r['bytes']} B, {r['lanes_sent']} lanes shipped, "
            f"{r['groups_mismatched']} groups mismatched, {diff} [{smi}]")
    for key, what in (("trace_16_lanes", "a 16-lane round"),
                      ("trace_3_quiescent", "3 quiescent rounds")):
        t = rows[key]
        log(f"  traced {what}: " + ("no device activity recorded"
                                    if t is None else
                                    f"wall {t['wall_ms']:.3f} ms, device "
                                    f"busy {t['device_busy_ms']:.3f} ms in "
                                    f"{t['device_ops']} device ops (K11 "
                                    f"{t['kernel_ms']:.4f} ms), idle share "
                                    f"{t['idle_share']:.4f} [{smi}]"))
    lad = rows["delta_ladder_quiescent"]
    log(f"  δ ladder at quiescence: {lad['bytes']} B, "
        f"{lad['round_ms']:.3f} ms; K11 group digests {k11['ms']:.4f} "
        f"ms/call, device {fmt_device(k11)} vs bound "
        f"{k11['bound_ms'] * 1e3:.3f} us ({k11['bound_bytes']} B), plain "
        f"{k11['plain_ms']:.4f} ms; fingerprints entry device "
        f"{fmt_device(rows['k11_fingerprints'])} vs bound "
        f"{rows['k11_fingerprints']['bound_ms'] * 1e3:.3f} us; converged, "
        f"bitwise equal to the CPU replay [{smi}]")
    log("universe: " + json.dumps(rows))
    return rows


KERNELS = [
    ("K1", "ring_round_rows", "csrc/merge.cu", "pallas_merge.py:832",
     ("ring_round_rows",)),
    ("K2", "gossip_round_rows + merge_pairwise_rows", "csrc/merge.cu",
     "pallas_merge.py:413", ("gossip_round_rows", "merge_pairwise_rows")),
    ("K3", "gossip_round + merge_pairwise", "csrc/merge.cu",
     "pallas_merge.py:210", ("gossip_round", "merge_pairwise")),
    ("K4", "delta_ring_round", "csrc/delta.cu", "pallas_delta.py:460",
     ("delta_ring_round",)),
    ("K5", "delta_gossip_round", "csrc/delta.cu", "pallas_delta.py:291",
     ("delta_gossip_round",)),
    ("K6", "ring_round_rows_packed", "csrc/merge.cu", "pallas_merge.py:832",
     ("ring_round_rows_packed",)),
    ("K7", "ring_round_rows_dotpacked", "csrc/merge.cu",
     "pallas_merge.py:956", ("ring_round_rows_dotpacked",)),
    ("K8", "delta_ring_round_packed", "csrc/delta.cu", "pallas_delta.py:460",
     ("delta_ring_round_packed",)),
    ("K9", "delta_ring_round_dotpacked", "csrc/delta.cu",
     "pallas_delta.py:460", ("delta_ring_round_dotpacked",)),
    ("K10", "ingest_rows_delta_fused", "csrc/ingest.cu",
     "pallas_ingest.py:165", ("ingest_rows_delta_fused",)),
    ("K11", "lane_fingerprints + state_group_digests", "csrc/digest.cu",
     "pallas_digest.py:64", ("lane_fingerprints", "state_group_digests")),
]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = phase_environment()
    counters = Counters()
    errs, timings = {}, {}
    phase_kernels(errs)
    phase_ingest_kernel(errs)
    phase_digest_kernel(errs)
    phase_packed_kernels(errs)
    phase_entry(counters, errs)
    final = phase_fleet("merge", counters, errs, timings, smi)
    phase_packed_fleet("merge", final, counters, errs, timings, smi)
    del final
    final = phase_fleet("delta", counters, errs, timings, smi)
    phase_packed_fleet("delta", final, counters, errs, timings, smi)
    del final
    phase_k3(counters, errs, timings, smi)
    phase_cli(counters)
    phase_serve(counters, errs, timings, smi)
    phase_sync_fleet(counters, smi)
    phase_digest_read(counters, timings, smi)
    phase_universe(counters, timings, smi)

    kernels = []
    for key, name, src, replaces, wrappers in KERNELS:
        launches = sum(counters.main_path[w] for w in wrappers)
        if launches < 1:
            raise AssertionError(f"{key} never launched on the main path")
        kernels.append({
            "name": f"{key} {name}", "route": "cuda",
            "source": f"go_crdt_playground_tpu_torch/{src}",
            "replaces": f"go_crdt_playground_tpu/ops/{replaces}",
            "launches": launches, "max_abs_err": errs[key],
            "bitwise": errs[key] == 0, **timings[key],
            "library_ms": None,
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
