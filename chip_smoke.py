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
     with R is not a power of two (R = 192, 320); K4, K5 and K8 on few,
     long rows split over blocks (the strict skip's scenarios, the
     bridge's pair, a node's universe as a pair);
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
  8. one-row merge entries (K3, whose path is the Merger bridge of phase
     14): the gossip verb's fleet converged by ``gossip_round`` over
     ring permutations, then ``merge_pairwise`` with a second fleet,
     against the plain versions; both entries at the edge shapes; an
     out-of-range device perm failing the launch in a child process; the
     calls timed (ms, kernel µs, device operations);
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
 10b. the serve tier on the card: a torch ``ServeFrontend`` at the
     ``serve --ingest`` defaults with a durable dir, 4 client sessions
     (adds and deletes, the serve soak's key mix), members and vv equal
     to the acked ops' set algebra, every WAL record equal to the plain
     K10's, one K10 launch and at most 5 device operations a batch, the
     durable dir restored bitwise on the card and on the CPU; the CLI
     verb spawned once (banner, a round trip, SIGTERM, ``drained:``);
     then tools/torch_serve_soak.py --quick against CUDA workers: every
     guarantee held, and no failed check outside SERVE_SOAK_MAY_FAIL;
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
 12. the sharded fleet: (a) 3 torch frontends on the card at the
     ``serve --ingest`` defaults behind a torch ``ShardRouter`` (seed 5),
     phase 10b's sessions through the router: members and vv equal to
     the acked ops' set algebra, each shard bitwise equal to its batches
     replayed on a CPU node (every key its ring owner's), WAL records
     equal to the plain K10's, K10 once a shard batch; a live join of a
     fourth shard moving remap_fraction's slice and a leave back to the
     old digest, members byte-identical throughout; a ``ShardStandby``
     of s0 on the card catching up by digest (K11), tailing, promoting
     when s0 closes, its universe slice equal to ``restore_durable`` of
     s0's dir on the card and the CPU; (b) tools/torch_fleet_serve_soak.py
     --device cuda --quick in its default sweep and its --shard-repl,
     --router-ha and --autopilot modes: every guarantee and every
     check held (the autopilot measures the burn's shard's capacity,
     splits the flash crowd's shard and merges back);
 13. the multi-device tier, every slot on cuda:0: (a) the port's
     ``dryrun_multichip`` at 4 and 8 slots, 5 of 5 sharded paths
     converged and bitwise equal to the unsharded replay, each kernel
     path's first round against its plain version; (b) the north-star
     fleet on a 4-slot mesh: v2 δ in dot words (K9) and bitpacked (K8)
     through the packed block ring over the composed schedule (18
     intra-block offsets, 2 block-aligned), the full-state butterfly
     (20 stages, K2 a slot) and 3 ring rounds, every round bitwise
     equal to the unsharded port, ms a round, bytes ppermuted and
     bounds beside the unsharded round's time; (c) two gloo processes
     with two slots each, exchanges staged through host memory, equal
     digests on both ranks and the one-process mesh; (d) ``serve
     --ingest --mesh-devices 4`` and ``--mesh-devices 2x2 --sched auto``
     at E = 2^20, A = 16 as subprocesses under phase 10b's session mix:
     the set algebra, WAL records equal to a one-slot node's fed the same
     batches, a bitwise restore, K11 once a lane slot a summary read;
     every phase's wall time is printed;
 14. the Merger bridge on the card: (a) a torch ``MergerServer`` on cuda
     on 127.0.0.1 answering the Go client's T1-T3 and T6 byte streams,
     the BASELINE ladder's config 1 (3 replicas, E = 16, A = 3, 120 seeded
     ops) and 200 seeded pairs at the serve node's scale (E <= 1,024
     keys, A = 16) in full-state, δ v2, δ strict reference and δ loose
     reference merges, every reply byte-equal to ``execute_merge`` on
     the CPU and agreeing with the spec merge, and the ``scenario`` verb
     in process on the card and the CPU (the same output), K3 or K5
     launched once a merge; (b) a pair at A = 8,193 through the bridge,
     and K3 and K5 at A = 8,193 and 29,057 against their plain versions;
     (c) one pair at E = 65,536 keys, A = 256, full-state and δ v2: the
     request's wall through the server and its parts (decode, spec to
     pack, host to device, the merge entry, device to host, unpack,
     encode), the kernel's time by CUDA events beside its bound (K5
     also its device time queued behind a sleep, in its mode and strict
     reference, and its chunks); (d) the
     ``serve`` verb spawned once (banner, a ping and a merge, SIGTERM);
     (e) the δ state checkpointed with its ElementDict, restored on the
     CPU and the card bitwise;
 15. the other lattice families and the wide actor axes: (a) the OR-Map
     fleet (phase 4's fleet with three seeded LWW planes, 6,400 B a
     row): the 20 dissemination ring offsets through
     ``ormap_ring_gossip_round`` (keys on K1) and a butterfly pass
     through ``ormap_gossip_round`` (keys on K2), counted, timed beside
     their bound and converged, every round against
     ``lattices.gossip_round(ormap_join)`` on the plain versions,
     bitwise, and ``ormap_join`` on K2; (b) BASELINE config 2 (GCounter,
     1,000 replicas, 256 actors): its dissemination rounds equal to the
     CPU's, converged, merges a second; (c) K1, K2, K4, K6 and K8 at A
     in {2,049, 8,193, 29,057}, K7 and K9 at A in {2,049, 4,096}, K10 at
     A in {2,049, 12,289, 60,000} against their plain versions, one
     launch each timed, and at A = 2,049 the gossip rounds,
     ``rounds_to_convergence`` and ``Node.ingest_batch`` on the card;
 16. the port's tools on the card: (a) the static gate over the port
     (``go_crdt_playground_tpu_torch.analysis``, all 14 passes, in full,
     ``--device cuda``): exit 0 and 0 errors, the lattice laws over the
     registry (the AWSet and OR-Map joins on K2) and the lockset
     exercise over a CUDA ``Node`` (K10 from racing threads) counted,
     its wall and each protocol model's state count printed; (b)
     tools/torch_soak_differential.py for SOAK_MINUTES: fresh random
     shapes every iteration, K1, K2, K4, K6-K9 bitwise against their
     plain versions and the plain versions against each other, the
     iterations, shape ranges and kernels covered printed, any
     divergence failing the run; (c) examples/torch_quickstart.py and
     examples/torch_tcp_sync.py run as a user runs them (``OK``);
 17. the fault soaks on the card: (a) tools/torch_crash_soak.py --quick
     --device cuda --detect-races (3 CUDA worker processes with durable
     dirs, SIGKILLed at kill rates 0 and 0.25, torn WAL tails and a
     bit-flipped newest checkpoint, restarts handed to warm spares):
     every run converged, no δ loss outside the documented windows,
     kills, the checkpoint fallback, both WAL record modes written and
     records replayed, no lockset race and no unexpected worker exit;
     then one restart on a checkpoint and a WAL tail timed from the spawn
     of a fresh process and from the hand-off to a warm spare; (b)
     tools/torch_chaos_soak.py's severity curve (--quick --detect-races)
     on CUDA nodes, converged at each severity with no race, and its
     digest chaos leg at the full fleet (6 x 60) with the fault census
     equal to SYNC_CURVE.json's, K11 counted; (c) tools/torch_fleet_soak.py
     --device cuda: 8 CUDA worker processes through lossy proxies on one
     union and one vv, with lost exchanges and cut connections;
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
import os
import shutil
import signal
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
# cooperative grid above), actor counts (1, serve's 16, 2,048),
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


def load_tool(name: str):
    """Import ``tools/<name>.py`` of this checkout as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kill_group(proc) -> None:
    """SIGKILL the session a child was started in (``start_new_session``:
    the child and every process it started that stayed in its group),
    then collect the child's exit."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def run_tool(argv, timeout: int):
    """Run a tool in a session of its own; on timeout kill the whole
    group (the tool and the worker processes it spawned).  Returns the
    completed process, its output captured."""
    proc = subprocess.Popen([sys.executable, *argv], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"{argv[0]} timed out after {timeout} s: "
                             f"{out[-3000:]} {err[-3000:]}") from None
    finally:
        # a worker left behind by a tool that died is killed too
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


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
            "ingest_slot_rows": cuda_ingest.ingest_slot_rows,
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
    native = check_native_codec()
    log(f"native codec: available {native['available']}, build error "
        f"{native['build_error']}, built in {native['build_s']:.3f} s; "
        f"E = {CODEC_E}, A = {CODEC_A}: " + ", ".join(
            f"{kind} δ ({n['lanes']} lanes) {n['bytes']} B" for kind, n
            in native["payloads"].items())
        + ", encode_payload equal with prefer_native True and False, "
        "decode_payload equal both ways")
    return smi


# the native codec's check: one serve node's shape (E, A), a sparse and a
# dense δ (the share of lanes each section marks), their seed
CODEC_E, CODEC_A = 1024, 16
CODEC_DENSITY = {"sparse": 0.01, "dense": 0.6}
CODEC_SEED = 16


def codec_payloads() -> dict:
    """Seeded host ``DeltaPayload``s at (CODEC_E, CODEC_A), one for each
    CODEC_DENSITY: that share of the lanes changed, as many again of the
    rest deleted, dots anywhere in uint32 (past 2^31 included), zeros on
    unmarked lanes as the codec decodes them, ``src_processed`` zero (it
    is not shipped)."""
    import torch

    from go_crdt_playground_tpu_torch.ops.delta import DeltaPayload

    E, A = CODEC_E, CODEC_A
    rng = np.random.default_rng(CODEC_SEED)

    def u32(x):
        return torch.from_numpy(np.asarray(x, np.uint32).view(np.int32))

    def dots(mask):
        return (u32(np.where(mask, rng.integers(0, A, E), 0)),
                u32(np.where(mask, rng.integers(1, 1 << 32, E,
                                                dtype=np.uint64), 0)))

    out = {}
    for kind, density in CODEC_DENSITY.items():
        changed = rng.random(E) < density
        deleted = ~changed & (rng.random(E) < density)
        ch_da, ch_dc = dots(changed)
        del_da, del_dc = dots(deleted)
        out[kind] = DeltaPayload(
            src_vv=u32(rng.integers(0, 1 << 32, A, dtype=np.uint64)),
            changed=torch.from_numpy(changed), ch_da=ch_da, ch_dc=ch_dc,
            deleted=torch.from_numpy(deleted), del_da=del_da,
            del_dc=del_dc, src_actor=torch.tensor(3, dtype=torch.int32),
            src_processed=torch.zeros(A, dtype=torch.int32))
    return out


def check_native_codec() -> dict:
    """The C++ codec (``native/``) builds here, and on ``codec_payloads``'
    sparse and dense δ ``utils/wire.encode_payload`` gives the same bytes
    with ``prefer_native`` True and False and ``decode_payload`` gives
    back the payload both ways.  Raises on any failure."""
    from go_crdt_playground_tpu_torch import native
    from go_crdt_playground_tpu_torch._host import host
    from go_crdt_playground_tpu_torch.utils import wire

    t0 = time.perf_counter()
    available = native.available()
    out = {"available": available, "build_error": native.build_error(),
           "build_s": time.perf_counter() - t0, "payloads": {}}
    if not available:
        raise AssertionError(f"native codec did not build: "
                             f"{out['build_error']}")
    for kind, p in codec_payloads().items():
        body = wire.encode_payload(p, prefer_native=True)
        if body != wire.encode_payload(p, prefer_native=False):
            raise AssertionError(f"native codec: {kind} δ bytes differ "
                                 "from the Python codec's")
        for prefer in (True, False):
            back = wire.decode_payload(body, CODEC_E, CODEC_A, src_actor=3,
                                       prefer_native=prefer)
            for name, x, y in zip(p._fields, p, back):
                x, y = host(x), np.asarray(y)
                if x.dtype != y.dtype or not np.array_equal(x, y):
                    raise AssertionError(f"native codec: {kind} δ decoded "
                                         f"(prefer_native={prefer}) "
                                         f"differs in {name}")
        out["payloads"][kind] = {"bytes": len(body), "lanes": int(
            p.changed.sum() + p.deleted.sum())}
    return out


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
    split_row_checks(errs)


# few, long rows, where K4, K5 and K8 split a row's lanes over blocks
# (ops/cuda_delta.row_chunks): the bridge's pair and small batches at E
# past one chunk, ragged (4,097, 65,537) and a node's universe (2^20)
SPLIT_CHECK_R = (1, 2, 3, 5)
SPLIT_CHECK_E = (4097, 65_537)
SPLIT_CHECK_A = (256, 8193)
SPLIT_UNIVERSE = (2, 1 << 20, 256)
SPLIT_RING = (128, 65_537, 8)


def split_row_checks(errs: dict) -> None:
    """K5 on every fleet.delta_scenario (the strict skip's empty δ, its
    one payload lane in the first or the last chunk, first contact, the
    bridge's [1, 1] pair, mixed) in the three modes at SPLIT_CHECK_R x
    SPLIT_CHECK_E x SPLIT_CHECK_A and SPLIT_UNIVERSE, K4 alongside; K4
    and K8 at SPLIT_RING; each bitwise to its plain version."""
    import torch

    from go_crdt_playground_tpu_torch import fleet
    from go_crdt_playground_tpu_torch.models import awset_delta, packed
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd

    modes = [("v2", True), ("reference", True), ("reference", False)]
    sms = cd.sm_count(torch.cuda.current_device())
    t0, n, geoms = time.perf_counter(), 0, set()

    def check(key, fn, *args):
        nonlocal n
        for sem, strict in modes:
            kw = dict(delta_semantics=sem, strict_reference_semantics=strict)
            errs[key] = max(errs.get(key, 0), max_abs_err(
                fn(*args, kernel="cuda", **kw), fn(*args, kernel="torch",
                                                   **kw),
                f"{key} split rows {args[0].vv.shape[0]} x "
                f"{packed.num_elements(args[0])} {kw}"))
            n += 1

    shapes = [(R, E, A) for R in SPLIT_CHECK_R for E in SPLIT_CHECK_E
              for A in SPLIT_CHECK_A] + [SPLIT_UNIVERSE]
    for R, E, A in shapes:
        geoms.add((R, E) + tuple(cd.row_chunks(R, E, sms)))
        for name in fleet.DELTA_SCENARIOS:
            arrays, perm = fleet.delta_scenario(name, R, E, A, seed=R + E)
            st = awset_delta.from_arrays(arrays, "cuda")
            check("K5", cd.delta_gossip_round, st,
                  torch.from_numpy(perm).cuda())
            if name in ("mixed", "payload_last"):
                check("K4", cd.delta_ring_round, st, 1)
    R, E, A = SPLIT_RING
    geoms.add((R, E) + tuple(cd.row_chunks(R, E, sms)))
    for name in ("mixed", "empty", "payload_last"):
        st = awset_delta.from_arrays(
            fleet.delta_scenario(name, R, E, A, seed=5)[0], "cuda")
        bits = packed.pack_awset_delta(st)
        for off in (1, 64):
            check("K4", cd.delta_ring_round, st, off)
            check("K8", cd.delta_ring_round_packed, bits, off)
    torch.cuda.synchronize()
    log(f"split rows: {n} K4/K5/K8-vs-plain checks bitwise equal, "
        f"geometries (R, E, chunks, lanes) {sorted(geoms)} on {sms} SMs "
        f"({time.perf_counter() - t0:.1f} s)")


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


def based_inputs(rng, clock: int, add, dl, live):
    """A lane slot's view of a batch for K10's based entry: the rows and
    ``live`` (the kernel folds it in), each live row's lanes left of the
    slot (up to 2^20), its pre-row counter from ``clock`` (its steps: its
    adds here and left of the slot, one if its Del ticks, some right of
    the slot), its deletion counter and the final clock, int64 (not
    reduced)."""
    add_m, dl_m = add & live[:, None], dl & live[:, None]
    on = live.cpu().numpy()
    num_b = on.shape[0]
    lane_off = np.where(on, rng.integers(0, 1 << 20, num_b), 0)
    steps = (add_m.sum(dim=1).cpu().numpy() + lane_off
             + np.where(on, rng.integers(0, 64, num_b), 0)
             + (dl_m.any(dim=1).cpu().numpy() | (on & (rng.random(num_b)
                                                      < 0.3))))
    row_base = clock + np.cumsum(steps) - steps
    return (add, dl, live, row_base, lane_off, row_base + steps,
            clock + int(steps.sum()))


def phase_ingest_kernel(errs: dict):
    """K10 against its plain version on the card, bitwise: the 12 lanes,
    vv, processed and the compact form, over E x A x B (one block up to
    E = 4,096, the cooperative grid above), densities, padding patterns,
    states with history, own clocks whose prefix sums cross 2^31 or wrap
    at 2^32, K = 128 and K = 0 (no compact form), and the compact form's
    one-copy host read.  B = 0 launches the kernel (A past the shared
    memory: phase 15).  The based entry (``crdt_ingest_based``, a mesh
    slot's fold) the same way on the same slices and the padded batches
    (a third of the rows padding) at each density, with lane offsets to
    2^20 and counters from the same clocks."""
    import torch

    from go_crdt_playground_tpu_torch._u32 import host, to_host
    from go_crdt_playground_tpu_torch.ops import cuda_ingest as ci

    rng = np.random.default_rng(2026)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2026)
    n_checks = n_overflow = n_cross31 = n_wrap32 = 0
    n_based = b_cross31 = b_wrap32 = 0

    def check(got, want, what):
        nonlocal n_checks
        errs["K10"] = max(errs.get("K10", 0), max_abs_err(got, want, what))
        n_checks += 1

    def check_record(tag, row, got, want):
        pre, dense, rec = ci.record_to_host(row.vv, got[1], got[2])
        if bool(want[2].overflow):
            dense_ok = all(np.array_equal(g, w) for g, w in
                           zip(dense, to_host(want[1])))
        else:
            dense_ok = dense is got[1]
        if not (dense_ok and np.array_equal(pre, host(row.vv))
                and all(np.array_equal(g, w) for g, w
                        in zip(rec, to_host(want[2])))):
            raise AssertionError(f"{tag}: the one-copy record read "
                                 "differs")

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
                            check_record(tag, row, got, want)
                            n_overflow += bool(want[2].overflow)
                        steps = int((add & live[:, None]).sum()
                                    + (dl & live[:, None]).any(1).sum())
                        n_cross31 += clock < 1 << 31 <= clock + steps
                        n_wrap32 += clock + steps >= 1 << 32
                        if pattern != "holes":
                            continue  # the based entry: padded batches
                        based = based_inputs(rng, clock, add, dl, live)
                        for kk in INGEST_CHECK_K:
                            kw = dict(k_changed=kk, k_deleted=kk)
                            want = ci.ingest_slot_rows(row, *based, **kw,
                                                       kernel="torch")
                            before = ci.ingest_slot_rows.launches
                            got = ci.ingest_slot_rows(row, *based, **kw,
                                                      kernel="cuda")
                            if ci.ingest_slot_rows.launches != before + 1:
                                raise AssertionError(f"{tag}: no based "
                                                     "launch")
                            for part in (0, 1, 2) if kk else (0, 1):
                                check(got[part], want[part],
                                      f"{tag} k={kk} based part {part}")
                            if kk:
                                check_record(f"{tag} based", row, got, want)
                            elif got[2] is not None:
                                raise AssertionError(
                                    f"{tag}: based k=0 gave a compact form")
                            n_based += 1
                        b_cross31 += clock < 1 << 31 <= based[-1]
                        b_wrap32 += based[-1] >= 1 << 32
    if not (n_overflow and n_cross31 and n_wrap32 and b_cross31
            and b_wrap32):
        raise AssertionError(
            f"K10 cases missed a regime: {n_overflow} overflowing, "
            f"{n_cross31} / {b_cross31} crossing 2^31, {n_wrap32} / "
            f"{b_wrap32} wrapping 2^32 (fused / based)")
    torch.cuda.synchronize()
    n_shapes = len(INGEST_CHECK_E) * len(INGEST_CHECK_A) * len(INGEST_CHECK_B)
    log(f"ingest kernel: {n_checks} K10-vs-plain checks over {n_shapes} "
        f"(E, A, B) shapes x 9 batch kinds x K in {INGEST_CHECK_K} bitwise "
        f"equal, one-copy record reads equal, B = 0 launched, "
        f"{n_overflow} overflowing batches, {n_cross31} crossing 2^31, "
        f"{n_wrap32} wrapping 2^32; {n_based} crdt_ingest_based-vs-plain "
        f"entries on the same slices and padded rows bitwise equal "
        f"({b_cross31} "
        f"crossing 2^31, {b_wrap32} wrapping 2^32) "
        f"({time.perf_counter() - t0:.1f} s)")
    ingest_tile_cases(check)


# K10's based entry on its tile path (csrc/ingest.cu ingest_tiles, 1,024
# lanes a tile): the slot the boundary cases run at, and the shapes of
# the calls queued back to back on one stream (E, B)
TILE_CHECK_E = 8 * 1024
TILE_REPEATS = ((1 << 18, 32), (1 << 18, 32), (1 << 19, 32), (4097, 1),
                (1 << 19, 64))


def ingest_tile_cases(check) -> None:
    """The based entry's tile path: K changed lanes ending on a tile's
    last lane or straddling two tiles (fits) and one lane more, the first
    of the next tile (overflows), each with one deletion-mask lane; then
    calls of several shapes queued back to back on one stream, three
    times, without a synchronize between them (each call tags its own
    look-back words, so none reads an earlier call's).  ``check`` holds
    each part bitwise against the plain version."""
    import torch

    from go_crdt_playground_tpu_torch.ops import cuda_ingest as ci

    rng = np.random.default_rng(2027)
    E, K = TILE_CHECK_E, 128
    row = ingest_slice(rng, E, 16, 0, 0, False, "cuda")
    row = row._replace(**{f: torch.zeros_like(getattr(row, f)) for f in (
        "present", "dot_actor", "dot_counter", "deleted", "del_dot_actor",
        "del_dot_counter")})
    n_bound = 0
    for first in (1024 - K, 1024 - K // 2):
        for n in (K, K + 1):
            add = torch.zeros((2, E), dtype=torch.bool, device="cuda")
            add[0, first:first + n] = True
            add[0, E - 1] = True
            dl = torch.zeros_like(add)
            dl[1, E - 1] = True
            live = torch.ones(2, dtype=torch.bool, device="cuda")
            based = (add, dl, live, [5, n + 15], [9, 0], [n + 15, n + 16],
                     n + 17)
            got, want = (ci.ingest_slot_rows(row, *based, k_changed=K,
                                             k_deleted=K, kernel=kernel)
                         for kernel in ("cuda", "torch"))
            if bool(want[2].overflow) != (n > K):
                raise AssertionError(f"K10 tile boundary {first}+{n}: "
                                     "overflow not as planted")
            for part in range(3):
                check(got[part], want[part],
                      f"K10 tile boundary {first}+{n} part {part}")
            n_bound += 1
    calls = []
    for i, (E, B) in enumerate(TILE_REPEATS):
        clock = (0x7FFFFFF0, 0xFFFFFFF0)[i % 2]
        r = ingest_slice(rng, E, 16, 0x7FFFFFFB, clock, False, "cuda")
        add = torch.rand((B, E), device="cuda") < 0.01
        dl = torch.rand((B, E), device="cuda") < 0.005
        live = torch.arange(B, device="cuda") % 5 != 2
        calls.append((r, based_inputs(rng, clock, add, dl, live)))
    wants = [ci.ingest_slot_rows(r, *b, k_changed=128, k_deleted=128,
                                 kernel="torch") for r, b in calls]
    for _ in range(3):
        gots = [ci.ingest_slot_rows(r, *b, k_changed=128, k_deleted=128,
                                    kernel="cuda") for r, b in calls]
        for j, (got, want) in enumerate(zip(gots, wants)):
            for part in range(3):
                check(got[part], want[part],
                      f"K10 tiles repeated call {j} part {part}")
    torch.cuda.synchronize()
    log(f"ingest tiles: {n_bound} tile-boundary batches (K = {K} changed "
        f"lanes ending on a tile's last lane or straddling two, and one "
        f"more: overflow) and {3 * len(calls)} calls queued back to back "
        f"on one stream ({', '.join(f'E={e} B={b}' for e, b in TILE_REPEATS)}"
        f", three times) bitwise equal to the plain version")


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

    def states(i):
        # shape i's two states, from rng in shape order
        R, E, A = shapes[i]
        bits_base = (0x7FFFFFFB, 0, 0xFFFFFFF0 - 10)[i % 3]
        dots_base = (packed.DOT_MAX_COUNTER - 9, 0)[i % 2]
        return (random_delta_state(rng, R, E, A, bits_base, "cuda"),
                random_delta_state(rng, R, E, A, dots_base, "cuda"),
                dots_base)

    t0 = time.perf_counter()
    for i, (st, std, dots_base) in enumerate(made_ahead(states,
                                                        len(shapes))):
        R, E, A = shapes[i]
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


def made_ahead(make, n: int):
    """``make(0)``, ..., ``make(n - 1)`` in order, each made on one
    worker thread while the caller works on the one before (the same
    calls in the same order, so a seeded generator draws as it would
    without the thread)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=1) as pool:
        ahead = pool.submit(make, 0) if n else None
        for i in range(n):
            out = ahead.result()
            ahead = pool.submit(make, i + 1) if i + 1 < n else None
            yield out
            del out


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


K3_EDGE_E = (1, 31, 32, 128, 200, 1000)
K3_EDGE_R = (1, 63, 64, 1000, 4096)
K3_EDGE_A = (1, 16, 2048)
# torch.profiler's name of K3's kernel
K3_KERNELS = ("merge_rows",)
# a K3 call in a child process with one perm entry out of range: the
# launch must fail and the next synchronizing call raise
K3_BAD_PERM = """
import numpy as np, torch
from go_crdt_playground_tpu_torch.models import awset
from go_crdt_playground_tpu_torch.ops import cuda_merge as cm
st = awset.init({R}, {E}, 16, actors=np.arange({R}) % 16, device="cuda")
perm = torch.arange({R}, device="cuda")
perm[40] = {R}
cm.gossip_round(st, perm)
torch.cuda.synchronize()
print("no error")
"""


def k3_call_report(fn, reps: int = 200) -> dict:
    """ms a call (CUDA events), kernel µs and device operations a call
    (torch.profiler over 50 calls)."""
    ms = cuda_time_ms(fn, reps)
    _, rep = trace_run(lambda: [fn() for _ in range(50)], K3_KERNELS)
    return {"ms": ms,
            "device_ms": None if rep is None else rep["kernel_ms"] / 50,
            "device_ops": None if rep is None else rep["device_ops"] / 50}


def phase_k3(counters: Counters, errs: dict, timings: dict, smi: str):
    """The one-row merge entries (K3; the bridge of phase 14 is their
    path).  This phase drives them on the gossip verb's fleet
    (``gossip_round`` over the ring permutations of the dissemination
    schedule, then ``merge_pairwise`` with a second fleet), both against
    the plain versions; then both kernels at the edge shapes (E in
    K3_EDGE_E x R in K3_EDGE_R, A up to 2,048; int64 and int32 device
    perms, a host perm, pairwise); an out-of-range device perm in a
    child process; the calls timed (ms, kernel µs, device operations)."""
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
    counters.read("one-row merge entries (the smoke's own K3 path)",
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

    rng = np.random.default_rng(77)
    n_checks = 0
    for i, e in enumerate(K3_EDGE_E):
        for j, r in enumerate(K3_EDGE_R):
            a = K3_EDGE_A[(i + j) % 3]
            dst = random_delta_state(rng, r, e, a, 0x7FFFFFFB, "cuda").base()
            src = random_delta_state(rng, r, e, a, 0xFFFFFFF0, "cuda").base()
            for perm in (torch.from_numpy(rng.permutation(r)).cuda(),
                         torch.from_numpy(rng.integers(0, r, r)).to(
                             torch.int32).cuda(),
                         rng.permutation(r)):
                errs["K3"] = max(errs["K3"], max_abs_err(
                    cm.gossip_round(dst, perm, kernel="cuda"),
                    cm.gossip_round(dst, perm, kernel="torch"),
                    f"K3 gossip_round R={r} E={e} A={a}"))
                n_checks += 1
            errs["K3"] = max(errs["K3"], max_abs_err(
                cm.merge_pairwise(dst, src, kernel="cuda"),
                cm.merge_pairwise(dst, src, kernel="torch"),
                f"K3 merge_pairwise R={r} E={e} A={a}"))
            n_checks += 1
    for r, e in ((4096, 128), (64, 1000)):  # many rows, few wide rows
        child = subprocess.run(
            [sys.executable, "-c", K3_BAD_PERM.format(R=r, E=e)],
            capture_output=True, text=True, timeout=300)
        if (child.returncode == 0 or "no error" in child.stdout
                or "device-side assert" not in child.stderr):
            raise AssertionError(f"K3: an out-of-range device perm (R={r},"
                                 f" E={e}) did not fail the launch: {child}")
    log(f"K3: {R} x {E} fleet converged in {len(perms)} gossip_round "
        f"launches and merge_pairwise with a second fleet, bitwise equal "
        f"to the plain versions; {n_checks} edge checks bitwise (E in "
        f"{K3_EDGE_E}, R in {K3_EDGE_R}, A in {K3_EDGE_A}); an "
        f"out-of-range device perm fails the launch (4,096 x 128 and "
        f"64 x 1,000)")

    bound_ms, bound_by, nbytes = bounds("merge", R, E, W, True)
    gather = k3_call_report(lambda: cm.gossip_round(state, perms[0]))
    pairwise = k3_call_report(lambda: cm.merge_pairwise(state, other))
    plain_ms = cuda_time_ms(
        lambda: cm.gossip_round(state, perms[0], kernel="torch"), 20)
    timings["K3"] = {"ms": gather["ms"], "device_ms": gather["device_ms"],
                     "device_ops": gather["device_ops"],
                     "pairwise": pairwise, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by}

    def fmt(t):
        dev = ("device not measured" if t["device_ms"] is None else
               f"kernel {t['device_ms'] * 1e3:.3f} us in "
               f"{t['device_ops']:g} device ops")
        return f"{t['ms']:.4f} ms a call ({dev})"

    log(f"K3 calls at {R} x {E}, A = {W}: "
        f"gossip_round {fmt(gather)}, "
        f"merge_pairwise {fmt(pairwise)}, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by}, {nbytes} B) [{smi}]")


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
K10_KERNELS = ("ingest_block", "ingest_grid", "ingest_tiles")
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


# the serve-frontend cell: client sessions, ops a session, pipelined ops
# a session, every DEL_EVERY-th op a delete (tools/serve_soak.py's
# open-loop mix: keys cycle through the universe, here each session on
# its own residue class mod FRONTEND_SESSIONS)
FRONTEND_SESSIONS, FRONTEND_OPS, FRONTEND_WINDOW, DEL_EVERY = 4, 600, 16, 10
# the device operations a batch may take on the K10 path
FRONTEND_MAX_DEVICE_OPS = INGEST_BATCH_MAX_DEVICE_OPS


def frontend_session_ops(session: int, n_ops: int, num_e: int):
    """Session ``session``'s op stream: (kind, key) with kind 0 = add,
    1 = delete."""
    ops = []
    for i in range(n_ops):
        kind = 1 if i % DEL_EVERY == DEL_EVERY - 1 else 0
        ops.append((kind, (FRONTEND_SESSIONS * i + session) % num_e))
    return ops


def drive_frontend_sessions(addr, n_ops: int, num_e: int):
    """FRONTEND_SESSIONS client sessions, each pipelining
    FRONTEND_WINDOW ops of its stream.  Returns (per-session lists of
    (kind, key, acked), ack latencies in seconds, wall seconds, typed
    rejects by class name).  An op that ends in anything but an ack or
    a typed reject (a timeout, a lost connection) fails the run."""
    from go_crdt_playground_tpu_torch.serve import protocol
    from go_crdt_playground_tpu_torch.serve.client import ServeClient

    results = [[] for _ in range(FRONTEND_SESSIONS)]
    latencies = [[] for _ in range(FRONTEND_SESSIONS)]
    rejects = {}
    errors = []
    lock = threading.Lock()

    def run(s):
        try:
            with ServeClient(addr, timeout=60.0) as c:
                inflight = []
                for kind, key in frontend_session_ops(s, n_ops, num_e):
                    inflight.append((kind, key,
                                     c.submit_async(kind, [key])))
                    if len(inflight) >= FRONTEND_WINDOW:
                        settle(s, inflight.pop(0))
                for op in inflight:
                    settle(s, op)
        except Exception as e:  # noqa: BLE001 — reported below
            with lock:
                errors.append(e)

    def settle(s, item):
        kind, key, op = item
        try:
            latencies[s].append(op.wait(60.0))
            results[s].append((kind, key, True))
        except protocol.ServeError as e:  # a typed reject: not applied
            results[s].append((kind, key, False))
            with lock:
                name = type(e).__name__
                rejects[name] = rejects.get(name, 0) + 1

    threads = [threading.Thread(target=run, args=(s,))
               for s in range(FRONTEND_SESSIONS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300.0)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"frontend sessions failed: {errors}")
    return results, [x for lat in latencies for x in lat], wall, rejects


def drive_frontend_child(addr, n_ops: int, num_e: int):
    """``drive_frontend_sessions`` in a child process, as remote clients
    would drive the frontend (the client threads do not share the
    server's interpreter lock).  Returns what it returns."""
    from pathlib import Path

    src = ("import json, sys\n"
           f"sys.path.insert(0, {str(Path(__file__).resolve().parent)!r})\n"
           "import chip_smoke\n"
           f"out = chip_smoke.drive_frontend_sessions("
           f"({addr[0]!r}, {addr[1]}), {n_ops}, {num_e})\n"
           "print(json.dumps(out))\n")
    run = subprocess.run([sys.executable, "-c", src], capture_output=True,
                         text=True, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"frontend client process failed: "
                             f"{run.stderr[-3000:]}")
    res, lat, wall, rejects = json.loads(
        run.stdout.strip().splitlines()[-1])
    return [[tuple(op) for op in ops] for ops in res], lat, wall, rejects


def expected_members(results) -> set:
    """The set algebra of the acked ops: each session's keys are its
    own, and a session's ops apply in the order it sent them."""
    members = set()
    for ops in results:
        for kind, key, acked in ops:
            if acked:
                (members.discard if kind else members.add)(key)
    return members


def record_batches(fe, hints: list = None):
    """Wrap a frontend's ingest and WAL append: returns the lists they
    fill (each batch's rows, each WAL body) and a one-element list of
    the seconds spent in WAL appends (write + fsync).  ``hints``, when
    given, receives each batch's ``stripe_hint``."""
    node = fe.node
    batches, bodies, append_s = [], [], [0.0]
    ingest, append = node.ingest_batch, node.wal.append

    def recording_ingest(add, dl, live=None, **kw):
        batches.append((add.copy(), dl.copy(), live.copy()))
        if hints is not None:
            hint = kw.get("stripe_hint")
            hints.append(None if hint is None else np.array(hint))
        return ingest(add, dl, live, **kw)

    def timed_append(body):
        t = time.perf_counter()
        append(body)
        append_s[0] += time.perf_counter() - t
        bodies.append(body)

    node.ingest_batch = recording_ingest
    node.wal.append = timed_append
    return batches, bodies, append_s


def flat_nonzero(x: np.ndarray) -> np.ndarray:
    """``np.flatnonzero`` of a bool array whose set entries are few, read
    eight bytes at a time (a mesh batch's rows hold a key or two of
    2^20 lanes each)."""
    flat = np.ascontiguousarray(x).reshape(-1)
    whole = flat.size // 8 * 8
    words = np.flatnonzero(flat[:whole].view(np.uint64))
    at = np.concatenate([(words[:, None] * 8 + np.arange(8)).reshape(-1),
                         np.arange(whole, flat.size)])
    return at[flat[at]]


def cut_chunks(add, dl, live, dp: int, hint=None):
    """The batches whose WAL records a dp-stripe mesh node
    (``Mesh2DApplyTarget``) writes for one op-batch: the batch itself
    when the striping planner keeps it whole, else each chunk's rows in
    batch order (padding rows masked), as successive batches.  The
    planner's inputs come from the live rows' set entries alone.
    Returns (batches, cuts)."""
    from go_crdt_playground_tpu_torch.parallel.meshtarget2d import (
        _row_keys, plan_rows)

    num_b, num_e = add.shape
    a_at, d_at = flat_nonzero(add), flat_nonzero(dl)
    a_at, d_at = a_at[live[a_at // num_e]], d_at[live[d_at // num_e]]
    at = np.union1d(a_at, d_at)
    plans, cuts = plan_rows(
        _row_keys(at // num_e, at % num_e, num_b),
        np.bincount(a_at // num_e, minlength=num_b),
        np.bincount(d_at // num_e, minlength=num_b) > 0,
        num_e, dp, max(1, -(-num_b // dp)), hint)
    if len(plans) == 1:
        return [(add, dl, live)], cuts
    out = []
    for p in plans:
        rows = np.sort(p.index[p.index >= 0])
        keep = live[rows][:, None]
        out.append((add[rows] & keep, dl[rows] & keep,
                    np.ones(rows.size, bool)))
    return out, cuts


def replay_batches(batches, actor: int, device: str, wal_dir: str = None,
                   plain: bool = False):
    """A fresh node on ``device`` fed ``batches`` in order (the plain K10
    when ``plain``); returns (node, WAL bodies it appended)."""
    import functools

    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.ops import cuda_ingest as ci
    from go_crdt_playground_tpu_torch.utils.wal import DeltaWal

    wal = DeltaWal(wal_dir, fsync=False) if wal_dir else None
    node = Node(actor, SERVE_E, SERVE_A, device=device, wal=wal)
    if plain:
        node._fused_regime = (functools.partial(
            ci.ingest_rows_delta_fused, kernel="torch"),
            min(128, SERVE_E))
    bodies = []
    if wal is not None:
        append = wal.append
        wal.append = lambda b: (bodies.append(b), append(b))
    for add, dl, lv in batches:
        node.ingest_batch(add, dl, lv)
    if wal is not None:
        wal.close()
    return node, bodies


def same_state(a, b, what: str) -> None:
    import torch

    for name, x, y in zip(a._fields, a, b):
        if not torch.equal(x.cpu(), y.cpu()):
            at = (x.cpu() != y.cpu()).nonzero().flatten()[:8].tolist()
            raise AssertionError(f"{what}: {name} differs at {at}")


def phase_frontend(counters: Counters, smi: str):
    """The serve tier on the card: a torch ``ServeFrontend`` at the
    ``serve --ingest`` defaults (E = 1,024, A = 16, batches of up to 32,
    2 ms flush, queue 256) with a durable dir, FRONTEND_SESSIONS client
    sessions over 127.0.0.1; members and vv equal to the acked ops' set
    algebra; every WAL record equal to the plain K10's for the same
    batch; K10 launched once a batch; device operations a batch traced
    (the sessions run in a child process, as remote clients do);
    the durable dir restored bitwise on the card and on the CPU; then
    the CLI verb spawned once (banner, a round trip, SIGTERM, the
    ``drained:`` line).  Prints ops/s, ack p50/p99, mean batch and the
    WAL append's share of batch apply time."""
    import torch

    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.ops import cuda_ingest as ci
    from go_crdt_playground_tpu_torch.serve import ServeFrontend
    from go_crdt_playground_tpu_torch.serve.client import ServeClient

    E, A, B = SERVE_E, SERVE_A, SERVE_B
    tmp = tempfile.mkdtemp(prefix="chip_smoke_frontend_")
    try:
        durable = f"{tmp}/durable"
        fe = ServeFrontend(E, A, durable_dir=durable, max_batch=B,
                           flush_ms=2.0, queue_depth=256, device="cuda")
        node = fe.node
        batches, bodies, append_s = record_batches(fe)
        addr = fe.serve()
        torch.cuda.synchronize()
        counters.reset()
        results, lat, wall, rejects = drive_frontend_child(
            addr, FRONTEND_OPS, E)
        launched = ci.ingest_rows_delta_fused.launches
        snap = fe.recorder.snapshot()
        counters.read("serve frontend",
                      exact={"ingest_rows_delta_fused": len(batches)})
        if snap["counters"]["serve.batches"] != len(batches) or launched \
                != len(batches):
            raise AssertionError(
                f"frontend: {launched} K10 launches, {len(batches)} "
                f"batches, serve.batches {snap['counters']['serve.batches']}")
        acked = sum(ok for ops in results for _, _, ok in ops)
        if acked != snap["counters"]["serve.ops.acked"] or acked < 2000:
            raise AssertionError(f"frontend: {acked} acked ops, the "
                                 f"server counted "
                                 f"{snap['counters']['serve.ops.acked']}"
                                 f", typed rejects {rejects}")
        if snap["counters"].get("serve.batch_errors", 0):
            raise AssertionError(
                f"frontend: {snap['counters']['serve.batch_errors']} "
                f"batch errors")
        with ServeClient(addr) as c:
            members, vv = c.members()
        want = expected_members(results)
        if set(members) != want:
            raise AssertionError(
                f"frontend: members differ from the acked ops' set "
                f"algebra ({len(set(members) ^ want)} keys)")
        want_vv = np.zeros(A, np.uint32)
        want_vv[0] = acked  # one key an op: each op ticks once
        if not np.array_equal(vv, want_vv):
            raise AssertionError(f"frontend: vv {vv} != {want_vv}")
        apply_s = snap["observations"]["serve.batch.apply_s"]
        fsync_share = append_s[0] / apply_s["sum"]
        server_lat = snap["observations"]["serve.ingest_latency_s"]
        occupancy = snap["observations"]["serve.batch.occupancy"]["mean"]

        # device operations a batch, traced over one more burst
        before = fe.recorder.snapshot()["counters"]["serve.batches"]
        _, trace = trace_run(lambda: drive_frontend_child(addr, 100, E),
                             K10_KERNELS)
        traced_batches = (fe.recorder.snapshot()["counters"]
                          ["serve.batches"] - before)
        ops_a_batch = (None if trace is None
                       else trace["device_ops"] / traced_batches)
        if ops_a_batch is not None and ops_a_batch > FRONTEND_MAX_DEVICE_OPS:
            raise AssertionError(f"frontend: {ops_a_batch} device "
                                 f"operations a batch")
        live = node.state_slice()
        fe.close()

        # every WAL record against the plain K10's for the same batch
        plain, plain_bodies = replay_batches(batches, 0, "cuda",
                                             wal_dir=f"{tmp}/plain",
                                             plain=True)
        if plain_bodies != bodies:
            raise AssertionError("frontend: WAL records differ from the "
                                 "plain K10's")
        same_state(live, plain.state_slice(),
                   "frontend: against the plain K10's replay")
        for dev in ("cuda", "cpu"):
            back = Node.restore_durable(durable, device=dev)
            for name, x, y in zip(live._fields, live, back.state_slice()):
                if not torch.equal(x.to(dev), y):
                    raise AssertionError(f"frontend: restore on {dev} "
                                         f"differs in {name}")
            back.wal.close()
        p50 = float(np.percentile(lat, 50)) * 1e3
        p99 = float(np.percentile(lat, 99)) * 1e3
        trace_txt = ("not measured" if trace is None else
                     f"{ops_a_batch:g} device ops a batch, idle share "
                     f"{trace['idle_share']:.4f}")
        log(f"serve frontend (E={E}, A={A}, batch<={B}, flush 2 ms, queue "
            f"256, durable, {FRONTEND_SESSIONS} sessions x {FRONTEND_OPS} "
            f"ops, {FRONTEND_WINDOW} in flight a session, clients in a "
            f"child process): {acked} acked (typed rejects "
            f"{rejects or 'none'}, 0 batch errors) in "
            f"{wall:.3f} s = {acked / wall:.1f} ops/s, ack p50 {p50:.3f} "
            f"ms p99 {p99:.3f} ms, {len(batches)} batches of "
            f"{occupancy:.2f} ops, batch apply {apply_s['mean'] * 1e3:.3f} "
            f"ms, WAL append (write + fsync) {fsync_share:.4f} of it, "
            f"server-side ingest p50 {server_lat['p50'] * 1e3:.3f} ms p99 "
            f"{server_lat['p99'] * 1e3:.3f} ms, {trace_txt}; members "
            f"and vv equal to the acked ops' set algebra; {len(bodies)} WAL "
            f"records equal to the plain K10's; restored bitwise on the "
            f"card and on the CPU [{smi}]")
        log("serve frontend: " + json.dumps({
            "ops_per_s": acked / wall, "acked": acked, "wall_s": wall,
            "rejects": rejects,
            "ack_p50_ms": p50, "ack_p99_ms": p99, "batches": len(batches),
            "batch_mean": occupancy, "batch_apply_ms": apply_s["mean"] * 1e3,
            "server_ingest_p50_ms": server_lat["p50"] * 1e3,
            "server_ingest_p99_ms": server_lat["p99"] * 1e3,
            "wal_append_share": fsync_share,
            "device_ops_per_batch": ops_a_batch,
            "idle_share": None if trace is None else trace["idle_share"],
            "card": smi}))
        cli_round_trip(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def cli_round_trip(tmp: str):
    """``python -m go_crdt_playground_tpu_torch serve --ingest`` as a
    user starts it (the card is its default device): the banner, one
    client round trip, SIGTERM, the ``drained:`` line."""
    import re
    import signal

    from go_crdt_playground_tpu_torch.serve.client import ServeClient

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "go_crdt_playground_tpu_torch", "serve",
         "--ingest", "--durable-dir", f"{tmp}/cli"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        banner = proc.stdout.readline()
        m = re.search(r"listening on (\S+):(\d+) \(E=1024 A=16 actor=0 "
                      r"batch<=32 flush=2.0ms queue=256 durable=yes "
                      r"fused=yes sync=delta mesh=off", banner)
        if m is None:
            raise AssertionError(f"serve CLI banner: {banner!r}")
        with ServeClient((m.group(1), int(m.group(2)))) as c:
            c.add(7, 9)
            c.delete(9)
            members, _ = c.members()
        if list(members) != [7]:
            raise AssertionError(f"serve CLI members {members}")
        up = time.perf_counter() - t0
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        kill_group(proc)
    if proc.returncode != 0 or "drained: 2 ops acked" not in out:
        raise AssertionError(f"serve CLI drain: rc={proc.returncode} "
                             f"{out!r} {err[-2000:]!r}")
    log(f"serve CLI: banner after {up:.1f} s, a round trip, SIGTERM -> "
        f"{out.strip().splitlines()[-1]!r}")


# the checks of tools/torch_serve_soak.py that may fail on the card, by
# name (PERF.md section 7): the overload leg's shed check (b) and the WAL
# bytes comparison (b2).  Any other failed check fails phase 10b.
SERVE_SOAK_MAY_FAIL = ("open_loop/shed", "ingest_compare/wal_bytes")


def phase_serve_soak(smi: str):
    """tools/torch_serve_soak.py --quick on the card: its legs (open and
    closed loop, fused against seed ingest, compaction, the two crash
    kills, wire chaos) against ``serve --ingest --device cuda`` workers.
    The phase fails unless every guarantee holds (zero lost acked ops,
    zero phantom members, drains, every op resolved, both kills, compact
    records replayed, every element acked) and every failed load-shape
    check is one of SERVE_SOAK_MAY_FAIL's; those are printed with their
    readings, and an allowed check that passes is logged."""
    from pathlib import Path

    tool = Path(__file__).resolve().parent / "tools" / "torch_serve_soak.py"
    res = run_checked_tool([str(tool), "--quick", "--device", "cuda"], 900,
                           "serve soak")
    failed = [f.split(":", 1)[0] for f in res["failures"]]
    check_allowed("serve soak", failed, SERVE_SOAK_MAY_FAIL,
                  res["guarantee_failures"])
    load, ic = res["load"], res["ingest_compare"]

    def admitted(leg) -> float:
        """The readers' admitted rate: ops the server admitted by the
        offering's end over the offering's span."""
        span = leg["submitted"] / max(leg["achieved_offer_rate"], 1e-9)
        return leg["window_end"]["admitted"] / max(span, 1e-9)

    curve = ", ".join(f"{leg['offered_rate']:g}/s -> {leg['goodput']:g}/s "
                      f"p99 {leg['p99_ms']} ms shed {leg['overloaded']} "
                      f"admitted {admitted(leg):.1f}/s"
                      for leg in load["open_loop"])
    log(f"serve soak (--quick, cuda workers, {res['elapsed_s']} s): open "
        f"loop {curve}; closed loop "
        + ", ".join(f"{leg['concurrency']} -> {leg['goodput']:g}/s p99 "
                    f"{leg['p99_ms']} ms" for leg in load["closed_loop"])
        + f"; ingest seed/fused {ic['seed']['dispatches_per_batch']:g}/"
        f"{ic['fused']['dispatches_per_batch']:g} steps a batch, "
        f"{ic['seed']['ops_per_batch']:g}/{ic['fused']['ops_per_batch']:g}"
        f" ops a batch, "
        f"{ic['seed']['wal_bytes_per_acked_op']:g}/"
        f"{ic['fused']['wal_bytes_per_acked_op']:g} WAL B an op; "
        f"compaction dropped {res['compaction']['gc_dropped_lanes_under_traffic']}"
        f" lanes, {res['compaction']['backoffs_during_heavy']} backoffs "
        f"under load; crash kills {res['crash']['kills']}, "
        f"{res['crash']['acked_ops']} acked; 0 lost acked ops, 0 phantom "
        f"members in every leg; chaos proxy "
        f"{res['chaos']['proxy_counters']}; tools/serve_soak.py's checks "
        f"not met on this card: {res['failures'] or 'none'} [{smi}]")
    log("serve soak: " + json.dumps(res))


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
    states as the CPU fleet.  The legs are the tool's
    (tools/torch_chaos_soak.run_traffic_leg)."""
    soak = load_tool("torch_chaos_soak")
    legs = []
    for rate in SYNC_RATES:
        pair = {}
        for mode in ("digest", "delta"):
            args = (mode, SYNC_NODES, SYNC_E, rate, SYNC_TRAFFIC, SYNC_SEED,
                    SYNC_QUIESCENT, SYNC_SETTLE)
            counters.reset()
            t0 = time.perf_counter()
            gpu, gpu_states = soak.run_traffic_leg(*args, device="cuda")
            wall = time.perf_counter() - t0
            counters.read(f"sync fleet {mode} {rate} ops/round",
                          at_least={"state_group_digests": 1}
                          if mode == "digest" else None)
            cpu, cpu_states = soak.run_traffic_leg(*args, device="cpu")
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


# ---------------------------------------------------------------------------
# phase 12: the sharded fleet
# ---------------------------------------------------------------------------

FLEET_SHARDS, FLEET_SEED = 3, 5


def members_reply(addr) -> bytes:
    """One QUERY through ``addr`` on a raw connection: the MEMBERS reply
    frame's bytes."""
    import socket

    from go_crdt_playground_tpu_torch.net import framing
    from go_crdt_playground_tpu_torch.serve import protocol

    with socket.create_connection(addr, timeout=60.0) as conn:
        framing.send_frame(conn, protocol.MSG_QUERY,
                           protocol.encode_query(1))
        msg_type, body = framing.recv_frame(conn, timeout=60.0)
    if msg_type != protocol.MSG_MEMBERS:
        raise AssertionError(f"QUERY answered with frame type {msg_type}")
    return body


def phase_fleet_serve(counters: Counters, smi: str) -> dict:
    """12a: FLEET_SHARDS torch frontends on the card at the ``serve
    --ingest`` defaults behind a torch ``ShardRouter`` (seed 5), phase
    10b's sessions through the router, a live join and leave of a fourth
    shard, and a ``ShardStandby`` of s0 on the card that catches up by
    digest, tails, and promotes when s0 closes."""
    import torch

    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.serve import ServeFrontend, protocol
    from go_crdt_playground_tpu_torch.serve.client import ServeClient
    from go_crdt_playground_tpu_torch.shard.fleet import free_port
    from go_crdt_playground_tpu_torch.shard.replica import (POLL_CAUGHT_UP,
                                                            ShardStandby)
    from go_crdt_playground_tpu_torch.shard.ring import remap_fraction
    from go_crdt_playground_tpu_torch.shard.router import ShardRouter

    E, A, B = SERVE_E, SERVE_A, SERVE_B
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    fes, router, standby, joiner = [], None, None, None
    out = {"card": smi}
    try:
        def frontend(i, **kw):
            return ServeFrontend(E, A, actor=i, durable_dir=f"{tmp}/s{i}",
                                 max_batch=B, flush_ms=2.0, queue_depth=256,
                                 device="cuda", **kw)

        fes = [frontend(i, shard_id=f"s{i}", shard_epoch=1)
               for i in range(FLEET_SHARDS)]
        recorded = [record_batches(fe)[:2] for fe in fes]
        addrs = {f"s{i}": fe.serve() for i, fe in enumerate(fes)}
        standby_port = free_port()
        roster = dict(addrs)
        roster["s0"] = [addrs["s0"], ("127.0.0.1", standby_port)]
        router = ShardRouter(roster, E, seed=FLEET_SEED,
                             state_dir=f"{tmp}/router-state")
        raddr = router.serve()
        owner = router.route()

        # -- sessions through the router ---------------------------------
        torch.cuda.synchronize()
        counters.reset()
        results, lat, wall, rejects = drive_frontend_child(
            raddr, FRONTEND_OPS, E)
        n_batches = [len(b) for b, _ in recorded]
        counters.read("sharded fleet",
                      exact={"ingest_rows_delta_fused": sum(n_batches)})
        acked = sum(ok for ops in results for _, _, ok in ops)
        snaps = [fe.recorder.snapshot() for fe in fes]
        if acked != sum(s["counters"]["serve.ops.acked"] for s in snaps) \
                or acked < 2000:
            raise AssertionError(f"fleet: {acked} acked, typed rejects "
                                 f"{rejects}")
        with ServeClient(raddr) as c:
            members, vv = c.members()
        if set(members) != expected_members(results):
            raise AssertionError("fleet: routed members differ from the "
                                 "acked ops' set algebra")
        want_vv = np.zeros(A, np.uint32)
        for ops in results:
            for _, key, ok in ops:
                # shard s<i> ticks its own actor lane i, once an op
                want_vv[int(owner.owner_sid(key)[1:])] += bool(ok)
        if not np.array_equal(np.asarray(vv, np.uint32), want_vv):
            raise AssertionError(f"fleet: routed vv {vv} != {want_vv}")

        # -- each shard against CPU replays and the plain K10 -------------
        for i, (batches, bodies) in enumerate(recorded):
            sid = f"s{i}"
            for add, dl, _ in batches:
                keys = np.unique(np.nonzero(np.atleast_2d(add | dl))[1])
                if any(owner.owner_sid(int(k)) != sid for k in keys):
                    raise AssertionError(f"fleet: {sid} ingested a key "
                                         f"the ring assigns elsewhere")
            cpu, _ = replay_batches(batches, i, "cpu")
            same_state(fes[i].node.state_slice(), cpu.state_slice(),
                       f"fleet {sid} against its CPU replay")
            plain, plain_bodies = replay_batches(
                batches, i, "cuda", wal_dir=f"{tmp}/plain{i}", plain=True)
            if plain_bodies != bodies:
                raise AssertionError(f"fleet: {sid} WAL records differ "
                                     "from the plain K10's")
        apply = [s["observations"]["serve.batch.apply_s"] for s in snaps]
        occupancy = [s["observations"]["serve.batch.occupancy"]["mean"]
                     for s in snaps]
        before = sum(len(b) for b, _ in recorded)
        _, k10_trace = trace_run(
            lambda: drive_frontend_child(raddr, 100, E), K10_KERNELS)
        if k10_trace is not None:
            k10_trace["batches"] = sum(len(b) for b, _ in recorded) - before
        out.update({
            "ops_per_s": acked / wall, "acked": acked, "wall_s": wall,
            "rejects": rejects,
            "ack_p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "ack_p99_ms": float(np.percentile(lat, 99)) * 1e3,
            "batches": n_batches, "batch_mean": occupancy,
            "batch_apply_ms": [a["mean"] * 1e3 for a in apply],
            "k10_device_ms_per_batch": (
                None if not k10_trace or not k10_trace["batches"]
                else k10_trace["kernel_ms"] / k10_trace["batches"]),
            "fleet_idle_share": (None if not k10_trace
                                 else k10_trace["idle_share"])})

        # -- a live join of a fourth shard, then a leave -------------------
        joiner = frontend(FLEET_SHARDS)
        jaddr = joiner.serve()
        before_bytes = members_reply(raddr)
        ring0 = router.route()
        with ServeClient(raddr, timeout=120.0) as c:
            ok, join = c.reshard(protocol.RESHARD_JOIN, f"s{FLEET_SHARDS}",
                                 jaddr, timeout=120.0)
            if not ok:
                raise AssertionError(f"fleet: join aborted: {join}")
            ring1 = router.route()
            rm = remap_fraction(ring0.owner, ring1.owner,
                                ring0.ring.shards, ring1.ring.shards)
            if join["moved"] != rm["moved"] or \
                    join["moved_transferred"] != rm["moved"] or \
                    abs(join["fraction"] - rm["fraction"]) > 1e-12:
                raise AssertionError(f"fleet: join moved {join['moved']}, "
                                     f"remap_fraction {rm['moved']}")
            if members_reply(raddr) != before_bytes:
                raise AssertionError("fleet: members changed across the "
                                     "join")
            ok, leave = c.reshard(protocol.RESHARD_LEAVE, f"s{FLEET_SHARDS}",
                                  timeout=120.0)
            if not ok or router.route().digest != ring0.digest:
                raise AssertionError(f"fleet: leave {leave}, digest "
                                     f"{router.route().digest} != "
                                     f"{ring0.digest}")
            if members_reply(raddr) != before_bytes:
                raise AssertionError("fleet: members changed across the "
                                     "leave")
        out.update({"join_fence_s": join["fence_s"],
                    "join_moved": join["moved"],
                    "join_fraction": join["fraction"],
                    "leave_fence_s": leave["fence_s"],
                    "leave_moved": leave["moved"]})

        # -- a standby of s0: digest catch-up, tail, promotion ------------
        fes[0].supervisor.checkpoint()  # truncates the WAL under cursor 1
        sfe = ServeFrontend(E, A, actor=0, durable_dir=f"{tmp}/s0-standby",
                            max_batch=B, flush_ms=2.0, queue_depth=256,
                            device="cuda", shard_id="s0")
        standby = ShardStandby(addrs["s0"], sfe, sid="s0",
                               standby_id="s0-standby",
                               listen_addr=("127.0.0.1", standby_port),
                               announce_to=raddr, poll_interval_s=0.05,
                               failure_threshold=2, wait_ms=50)
        counters.reset()
        # the truncated tail, then the catch-up: K11 on each side
        verdicts = [standby.poll_once() for _ in range(2)]
        counters.read("standby catch-up",
                      at_least={"state_group_digests": 1})
        if POLL_CAUGHT_UP not in verdicts:
            raise AssertionError(f"fleet: standby polls {verdicts}, no "
                                 "digest catch-up")
        # K11 a call at the fleet's shape, on the standby's replica
        k11 = time_k11(sfe.node.state_slice(), 64)
        # more traffic through the router, then s0 dies
        s0_keys = [e for e in range(E) if owner.owner_sid(e) == "s0"][:40]
        with ServeClient(raddr) as c:
            c.add(*s0_keys)
            c.delete(*s0_keys[::4])
        standby.start()
        deadline = time.monotonic() + 60.0
        while standby.cursor < fes[0].node.wal.next_seq():
            if time.monotonic() > deadline:
                raise AssertionError("fleet: the standby never caught up "
                                     "with s0's WAL")
            time.sleep(0.02)
        t_kill = time.monotonic()
        fes[0].close()
        if not standby.await_promoted(60.0):
            raise AssertionError("fleet: the standby never promoted")
        promote_s = time.monotonic() - t_kill
        # the reference's pin: the promoted replica's whole-universe slice
        # (members with their dots, un-resurrected deletion records, vv
        # and processed) equals that of restore_durable of the dead
        # primary's disk, byte for byte
        universe = np.ones(E, bool)
        live = sfe.node.extract_slice(universe)
        for dev in ("cuda", "cpu"):
            back = Node.restore_durable(f"{tmp}/s0", device=dev)
            if back.extract_slice(universe) != live:
                raise AssertionError(f"fleet: the promoted standby's slice "
                                     f"differs from restore_durable on "
                                     f"{dev}")
            back.wal.close()
        with ServeClient(raddr) as c:
            for _ in range(100):  # the router's link redials the claim
                try:
                    c.add(s0_keys[1])
                    break
                except protocol.ShardUnavailable:
                    time.sleep(0.1)
            if s0_keys[1] not in c.members()[0]:
                raise AssertionError("fleet: the promoted standby does "
                                     "not serve s0's keyspace")
        out.update({
            "standby_promote_s": promote_s,
            "standby_poll_verdicts": verdicts,
            "standby_announce": standby.announce_result,
            "k11_ms": k11["ms"], "k11_device_ms": k11["device_ms"]})
    finally:
        if standby is not None:
            standby.close()
        if router is not None:
            router.close()
        for fe in fes + ([joiner] if joiner is not None else []):
            fe.close()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"sharded fleet ({FLEET_SHARDS} torch shards on cuda, E={SERVE_E}, "
        f"A={SERVE_A}, batch<={SERVE_B}, flush 2 ms, durable, torch router "
        f"seed {FLEET_SEED}, {FRONTEND_SESSIONS} sessions x {FRONTEND_OPS} "
        f"ops, {FRONTEND_WINDOW} in flight a session): {out['acked']} acked "
        f"in {out['wall_s']:.3f} s = {out['ops_per_s']:.1f} ops/s through the "
        f"router, ack p50 {out['ack_p50_ms']:.3f} ms p99 "
        f"{out['ack_p99_ms']:.3f} ms; batches {out['batches']} of "
        + "/".join(f"{b:.2f}" for b in out["batch_mean"]) + " ops, apply "
        + "/".join(f"{a:.3f}" for a in out["batch_apply_ms"]) + " ms; K10 "
        + ("not measured" if out["k10_device_ms_per_batch"] is None else
           f"{out['k10_device_ms_per_batch'] * 1e3:.3f} us")
        + " device time a batch; members and vv equal to the set algebra, "
        f"each shard bitwise equal to its CPU replay, WAL records equal to "
        f"the plain K10's; join of s{FLEET_SHARDS} moved {out['join_moved']} "
        f"(= remap_fraction) with fence {out['join_fence_s']} s, leave fence "
        f"{out['leave_fence_s']} s, members byte-identical; the s0 standby "
        f"caught up by digest (K11 at E = {SERVE_E}, groups of 64: "
        f"{out['k11_ms']:.4f} ms a call, device "
        f"{fmt_device({'device_ms': out['k11_device_ms']})}), promoted {out['standby_promote_s']:.3f} s after s0 "
        f"closed, bitwise equal to restore_durable on the card and the "
        f"CPU [{smi}]")
    log("sharded fleet: " + json.dumps(out))
    return out


# the checks of tools/torch_fleet_serve_soak.py that may fail on the
# card, in any mode: none (every check, and every guarantee, must hold)
FLEET_SOAK_MAY_FAIL = ()
# the default sweep runs --quick to keep the script inside its time
FLEET_SOAK_MODES = (("sweep", ("--quick",)),
                    ("shard_repl", ("--shard-repl", "--quick")),
                    ("router_ha", ("--router-ha", "--quick")),
                    ("autopilot", ("--autopilot", "--quick")))


def run_checked_tool(argv, timeout: int, what: str) -> dict:
    """Run a soak tool with ``--out``; returns its JSON result.  Exit
    codes other than 0 and 1 fail."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tool_")
    try:
        out = f"{tmp}/out.json"
        t0 = time.perf_counter()
        run = run_tool([*argv, "--out", out], timeout)
        wall = time.perf_counter() - t0
        if run.returncode not in (0, 1) or not os.path.exists(out):
            raise AssertionError(f"{what} failed (rc {run.returncode}): "
                                 f"{run.stdout[-3000:]} "
                                 f"{run.stderr[-3000:]}")
        with open(out) as f:
            res = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if (run.returncode == 0) != (not res["failures"]):
        raise AssertionError(f"{what}: rc {run.returncode} but failures "
                             f"{res['failures']}")
    res["tool_wall_s"] = wall
    return res


def check_allowed(what: str, failed, allowed, guarantees) -> None:
    """Fail on any guarantee, or on any failed check outside the named
    allow-list; log the allowed checks that passed this time."""
    if guarantees:
        raise AssertionError(f"{what}: guarantees failed: {guarantees}")
    outside = [f for f in failed if f not in allowed]
    if outside:
        raise AssertionError(f"{what}: checks failed outside the allow-"
                             f"list {list(allowed)}: {outside}")
    passing = [name for name in allowed if name not in failed]
    if passing:
        log(f"{what}: allowed checks passing on this card now: {passing}")


def phase_fleet_soak(smi: str) -> dict:
    """12b: tools/torch_fleet_serve_soak.py against CUDA shards in each
    of its modes.  Every guarantee must hold, and every check outside
    FLEET_SOAK_MAY_FAIL (none)."""
    from pathlib import Path

    tool = str(Path(__file__).resolve().parent / "tools"
               / "torch_fleet_serve_soak.py")
    walls = {}
    for mode, flags in FLEET_SOAK_MODES:
        res = run_checked_tool([tool, "--device", "cuda", *flags], 900,
                               f"fleet soak {mode}")
        if res["failures"]:
            # the readings behind a failed check (a rate calibration,
            # the rings), before it fails the phase
            log(f"fleet soak {mode}: " + json.dumps(
                {k: v for k, v in (res["result"] or {}).items()
                 if k not in ("decision_log_1", "decision_log_2",
                              "timeline")}, default=str)[:20000])
        check_allowed(f"fleet soak {mode}", res["failures"],
                      FLEET_SOAK_MAY_FAIL, res["guarantee_failures"])
        walls[mode] = res["tool_wall_s"]
        r = res["result"]
        if mode == "sweep":
            detail = "; ".join(
                f"{leg['shards']} shards {leg['goodput']:g}/s p50 "
                f"{leg['p50_ms']} p99 {leg['p99_ms']} ms"
                for leg in r["shard_curve"])
            ev = {e["event"]: e for e in r["reshard_leg"]["events"]}
            detail += (f"; kill outage {r['kill_leg']['outage']}, dark "
                       f"{r['kill_leg']['outage_s']} s; join "
                       f"fence {ev['join_committed_via_cli']['fence_s']} s, "
                       f"leave fence {ev['leave_committed']['fence_s']} s; "
                       f"chaos proxy {r['chaos_leg']['proxy']}")
        elif mode == "shard_repl":
            detail = (f"failover promote {r['legs']['failover']['promote_s']}"
                      f" s, quiesced promote "
                      f"{r['legs']['bitwise']['promote_s']} s, "
                      f"catch-ups {r['legs']['chaos']['catchups_served']}")
        elif mode == "router_ha":
            detail = (f"router promote {r['legs']['failover']['promote_s']}"
                      f" s")
        else:
            cal, plan = r["calibration"], r["calibration"]["planned_load"]
            carry = cal["carry"]
            detail = (f"{cal['shard']} sheds from "
                      f"{cal['onset_ops_s']:.1f} ops/s offered, the "
                      f"last of {len(cal['readings'])} onsets (" +
                      ", ".join(f"{w['capacity_ops_s']} at "
                                f"{w['age_s'][0]} s"
                                for w in cal['readings']) +
                      f" after the fleet's start; its 3 windows acked "
                      f"{cal['window_acked_ops_s']}, shed "
                      f"{cal['window_shed']}, spread "
                      f"{cal['acked_spread']}; "
                      f"{cal['below_onset_acked_ops_s']} acked a step "
                      f"below; read by {cal['age_s'][1]} s); the router "
                      f"carried {carry['window_carried_ops_s']} of "
                      f"{carry['offered_ops_s']} ops/s, a bound of "
                      f"{carry['bound_ops_s']}; sized from "
                      f"{cal['capacity_ops_s']:.1f}, planned baseline "
                      f"{plan['baseline']['of_capacity']} on "
                      f"{plan['baseline']['shard']} and burn "
                      f"{plan['burn']['of_capacity']} on "
                      f"{plan['burn']['shard']} of it, burn "
                      f"{cal['rates_ops_s']['burn']:.1f}; s1 in the burn "
                      f"from {r['burn_s1']['age_s']} s: queue to "
                      f"{r['burn_s1']['max_queue_depth']}, shed to "
                      f"{r['burn_s1']['max_shed_rate']} ops/s, heated "
                      f"{r['burn_s1']['heated']}; "
                      f"splits {r['actions']['splits_committed']}, merges "
                      f"{r['actions']['merges_committed']}, converged "
                      f"{r['convergence']['converged']}")
        log(f"fleet soak {mode} ({'quick' if res['quick'] else 'full'}, "
            f"{res['checks']} checks, cuda shards sharing one card): "
            f"{res['tool_wall_s']:.1f} s wall; {detail}; 0 lost acked ops, "
            f"0 phantoms, every op resolved; checks not met on this card: "
            f"{res['failures'] or 'none'} [{smi}]")
        log(f"fleet soak {mode}: " + json.dumps(
            {k: res[k] for k in ("mode", "quick", "checks", "failures",
                                 "guarantee_failures", "tool_wall_s")}))
    return walls


# ---------------------------------------------------------------------------
# phase 13: the multi-device tier on one card (slots share cuda:0)
# ---------------------------------------------------------------------------

# the full-width mesh cell: the north-star fleet on a 4-slot mesh
MESH_SLOTS = 4
# the mesh serving cell: one node's universe (E = 2^20, A = 16) lane-
# sharded over 4 slots, and 2 x 2 with the admission scheduler
MESH_SERVE = (("4", ("--mesh-devices", "4")),
              ("2x2", ("--mesh-devices", "2x2", "--sched", "auto")))
MESH_SERVE_READS = 3
MESH_CUT_SEED = 13
# 13c: two processes, two slots each on the card, R x E, A = R
MULTIHOST_R, MULTIHOST_E = 2048, 256


def state_bytes(state) -> int:
    return sum(x.numel() * x.element_size() for x in state)


def phase_mesh_dryrun(counters: Counters) -> dict:
    """13a: the port's ``dryrun_multichip`` with 4 and 8 slots on
    cuda:0, 5 of 5 paths converged and every round bitwise equal to the
    unsharded replay on the kernels' plain versions; the per-slot
    launches counted exactly (the replay launches none): K5 a slot a δ
    round, K8 and K9 a slot a packed ring round, K2 a slot an EP ring
    round (n_r - 1 of them)."""
    from go_crdt_playground_tpu_torch.entry import dryrun_multichip
    from go_crdt_playground_tpu_torch.parallel import gossip

    out = {}
    for n in (4, 8):
        shape = (n // 2, 2)
        rounds1 = len(gossip.dissemination_offsets(4 * shape[0]))
        rounds_p = len(gossip.dissemination_offsets(64 * n))
        counters.reset()
        res = dryrun_multichip(n, device="cuda:0")
        # one launch a slot a round, and no other kernel
        want = dict.fromkeys(counters.wrappers, 0)
        want.update(delta_gossip_round=n * rounds1,
                    delta_ring_round_packed=n * rounds_p,
                    delta_ring_round_dotpacked=n * rounds_p,
                    merge_pairwise_rows=n * max(shape[0] - 1, 1))
        counters.read(f"13a dryrun_multichip({n})", exact=want)
        if any(not (r["converged"] and r["bitwise"]) for r in res):
            raise AssertionError(f"13a: {n} slots: {res}")
        out[n] = [r["name"] for r in res]
        log(f"13a dryrun_multichip({n}) on cuda:0: 5/5 paths converged, "
            f"every round bitwise equal to the replay on the plain "
            f"versions ({', '.join(out[n])})")
    return out


def _same_rows(sh, ref, what: str) -> None:
    """Every slot block of a sharded state against its rows of the
    unsharded state, bitwise."""
    import torch

    blk = ref.vv.shape[0] // sh.mesh.shape["replica"]
    for idx, b in sh.local_blocks():
        rows = slice(idx[0] * blk, (idx[0] + 1) * blk)
        for name, x, y in zip(b._fields, b, ref):
            if not torch.equal(x, y[rows]):
                raise AssertionError(f"{what}: slot {idx} {name} differs "
                                     "from the unsharded round")


def _time_ms(fn):
    """(result, device ms) of one call, CUDA events around it."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _mesh_leg(label, sh, ref, schedule, sharded_round, plain_round,
              counters, wrapper, moved_bytes, bound_bytes):
    """One 13b leg: every round of ``schedule`` on the sharded state
    (timed, launches counted) and on the unsharded one through the
    kernels' plain versions (``plain_round``), bitwise equal after each
    round.  Returns (sharded state, unsharded state, report)."""
    import torch

    times, ppermuted, plain_times = [], 0, []
    for step in schedule:
        counters.reset()
        sh, ms = _time_ms(lambda: sharded_round(sh, step))
        counters.read(f"13b {label} round {step}",
                      exact={wrapper: sh.mesh.size})
        times.append(ms)
        ppermuted += moved_bytes(step)
        ref, pms = _time_ms(lambda: plain_round(ref, step))
        plain_times.append(pms)
        _same_rows(sh, ref, f"13b {label} round {step}")
    report = {
        "rounds": len(schedule), "ms_per_round": sum(times) / len(times),
        "ms_rounds": times, "plain_replay_ms_per_round":
            sum(plain_times) / len(plain_times),
        "bytes_ppermuted_per_round": ppermuted / len(schedule),
        "bound_ms_per_round": bound_bytes / HBM_BYTES_PER_S * 1e3,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    return sh, ref, report


def phase_mesh_fleet(counters: Counters, smi: str) -> dict:
    """13b: the north-star fleet (1,048,576 x 256, A = 256) on a 4-slot
    mesh on cuda:0 (blk = 262,144).  Full-state and v2 δ in dot words
    (K7, K9) and bitpacked (K6, K8) through
    ``packed_block_ring_round_shardmap`` over the composed schedule (18
    intra-block offsets, then 2 block-aligned, 20 rounds), each
    converged and every round bitwise equal to the unsharded port
    replaying it on the kernels' plain versions; full-state bool
    through the butterfly (20 stages, K2 per slot, converged) and 3
    rounds of ``ring_round_shardmap``, each round equal to the plain
    unsharded ``gossip_round`` at the same permutation.  Each leg also
    times the unsharded kernel round at its offsets.  The legs run
    smallest state first, each leg's tensors freed before the next."""
    import functools

    import torch

    from go_crdt_playground_tpu_torch import fleet as fleet_mod
    from go_crdt_playground_tpu_torch.entry import _packed_reference_round
    from go_crdt_playground_tpu_torch.models import packed
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm
    from go_crdt_playground_tpu_torch.parallel import collectives, gossip
    from go_crdt_playground_tpu_torch.parallel import mesh as mesh_mod

    R, E, W, n = FLEET_R, FLEET_E, FLEET_W, MESH_SLOTS
    blk = R // n
    mesh = mesh_mod.make_mesh((n, 1), devices=["cuda:0"] * n)
    reports = {}

    def kernel_ms(round_fn, ref, steps):
        """The unsharded kernel round's device ms at each step, after
        one untimed call."""
        _time_ms(lambda: round_fn(ref, steps[0]))
        return [_time_ms(lambda: round_fn(ref, o))[1] for o in steps]

    # full-state bool: the butterfly (K2 gossip_round_rows per slot for
    # the 18 block-local stages, merge_pairwise_rows for the 2 swaps)
    torch.cuda.reset_peak_memory_stats()
    ref = fleet_mod.build_state(R, E, W, "cuda")
    sb = state_bytes(ref)
    sh = mesh_mod.shard_state(ref, mesh)
    stages = list(range(R.bit_length() - 1))
    local = [s for s in stages if (1 << s) < blk]
    swap = [s for s in stages if (1 << s) >= blk]
    def butterfly(kernel):
        return lambda st, s: gossip.gossip_round(
            st, gossip.butterfly_perm(R, s, "cuda"), kernel=kernel)

    sh_loc, ref, rep_loc = _mesh_leg(
        "butterfly local", sh, ref, local,
        lambda st, s: gossip.butterfly_round_shardmap(st, mesh, s),
        butterfly("torch"), counters, "gossip_round_rows", lambda s: 0,
        3 * sb)
    sh, ref, rep_swap = _mesh_leg(
        "butterfly swap", sh_loc, ref, swap,
        lambda st, s: gossip.butterfly_round_shardmap(st, mesh, s),
        butterfly("torch"), counters, "merge_pairwise_rows", lambda s: sb,
        5 * sb)
    del sh_loc
    if not (gossip.converged_shardmap(sh, mesh)
            and bool(collectives.converged(ref.present, ref.vv))):
        raise AssertionError("13b butterfly: not converged in 20 stages")
    del sh
    ms = kernel_ms(butterfly("auto"), ref, stages)
    reports["butterfly"] = {"local": rep_loc, "swap": rep_swap,
                            "state_gb": sb / 1e9,
                            "unsharded_kernel_ms_per_round":
                                sum(ms) / len(ms)}
    del ref
    # three ring rounds (the ring merges rows of one index a block, so it
    # is not expected to converge)
    ref = fleet_mod.build_state(R, E, W, "cuda")
    sh = mesh_mod.shard_state(ref, mesh)
    ring_perm = (torch.arange(R, device="cuda") - blk) % R
    sh, ref, rep_ring = _mesh_leg(
        "ring", sh, ref, [1, 2, 3],
        lambda st, _: gossip.ring_round_shardmap(st, mesh),
        lambda st, _: gossip.gossip_round(st, ring_perm, kernel="torch"),
        counters, "merge_pairwise_rows", lambda _: sb, 5 * sb)
    del sh
    ms = kernel_ms(lambda st, _: gossip.gossip_round(st, ring_perm), ref,
                   [1, 2, 3])
    reports["ring"] = dict(rep_ring, unsharded_kernel_ms_per_round=sum(ms)
                           / len(ms))
    del ref
    torch.cuda.empty_cache()

    # the packed layouts (full-state K7, K6; v2 δ K9, K8) over the
    # composed schedule
    # the composed dissemination schedule: every power of two below the
    # block (18 at blk = 2^18), then the block-aligned offsets
    schedule = gossip.dissemination_offsets(blk) + [
        blk * o for o in gossip.dissemination_offsets(n)]
    for label, build, pack, ring, wrapper in (
            ("full_dots", fleet_mod.build_state, packed.pack_awset_dots,
             cm.ring_round_rows_dotpacked, "ring_round_rows_dotpacked"),
            ("full_bits", fleet_mod.build_state, packed.pack_awset,
             cm.ring_round_rows_packed, "ring_round_rows_packed"),
            ("delta_dots", fleet_mod.delta_fleet,
             packed.pack_awset_delta_dots, cd.delta_ring_round_dotpacked,
             "delta_ring_round_dotpacked"),
            ("delta_bits", fleet_mod.delta_fleet, packed.pack_awset_delta,
             cd.delta_ring_round_packed, "delta_ring_round_packed")):
        torch.cuda.reset_peak_memory_stats()
        plain_ring = functools.partial(ring, kernel="torch")
        ref = pack(build(R, E, W, "cuda"))
        sb = state_bytes(ref)
        sh = mesh_mod.shard_state(ref, mesh)
        intra = [o for o in schedule if o < blk]
        aligned = [o for o in schedule if o >= blk]
        # a round moves: the stack (read 2 blk, write 2 blk a slot), the
        # kernel on it (read and write 2 blk), the kept half's copy
        # (blk, blk), and on an aligned round the received block (blk,
        # blk): 10 or 12 x the state's bytes
        sh, ref, rep_i = _mesh_leg(
            f"{label} intra", sh, ref, intra,
            lambda st, o: gossip.packed_block_ring_round_shardmap(
                st, mesh, o),
            lambda st, o: _packed_reference_round(st, o, blk, plain_ring),
            counters, wrapper, lambda o: 0, 10 * sb)
        sh, ref, rep_a = _mesh_leg(
            f"{label} aligned", sh, ref, aligned,
            lambda st, o: gossip.packed_block_ring_round_shardmap(
                st, mesh, o),
            lambda st, o: _packed_reference_round(st, o, blk, plain_ring),
            counters, wrapper, lambda o: sb, 12 * sb)
        if not bool(collectives.converged_packed(ref.present_bits, ref.vv)):
            raise AssertionError(f"13b {label}: not converged in 20 "
                                 "rounds")
        del sh
        # the unsharded layout's ring round at the same offsets, same run
        ms = kernel_ms(ring, ref, schedule)
        reports[label] = {
            "intra": rep_i, "aligned": rep_a, "state_gb": sb / 1e9,
            "unsharded_global_ring_ms_per_round": sum(ms) / len(ms),
            "kernel_bound_ms_per_round_stacked":
                4 * sb / HBM_BYTES_PER_S * 1e3,
            "unsharded_bound_ms_per_round": 2 * sb / HBM_BYTES_PER_S * 1e3}
        del ref
        torch.cuda.empty_cache()

    for name, rep in reports.items():
        log(f"13b {name} ({R} x {E}, A={W}, {n} slots on cuda:0): "
            + json.dumps(rep) + f" [{smi}]")
    return reports


def multihost_rows(lo: int, hi: int, delta: bool, device):
    """Replica rows [lo, hi) of 13c's fleet (A = R: every replica a
    writer of a replica-dependent slice of the universe)."""
    import torch

    from go_crdt_playground_tpu_torch._u32 import from_numpy_u32
    from go_crdt_playground_tpu_torch.models.awset import AWSetState
    from go_crdt_playground_tpu_torch.models.awset_delta import \
        AWSetDeltaState

    R, E = MULTIHOST_R, MULTIHOST_E
    e = np.arange(E, dtype=np.uint32)[None, :]
    r = np.arange(lo, hi, dtype=np.uint32)[:, None]
    present = (e % (r % 7 + 2)) == 0
    counter = np.cumsum(present, axis=1, dtype=np.uint32) * present
    vv = np.zeros((hi - lo, R), np.uint32)
    vv[np.arange(hi - lo), np.arange(lo, hi)] = counter.max(axis=1)
    u = lambda a: from_numpy_u32(a, device)  # noqa: E731
    base = AWSetState(vv=u(vv), present=torch.from_numpy(present).to(device),
                      dot_actor=u(np.where(present, r, 0)),
                      dot_counter=u(counter),
                      actor=u(np.arange(lo, hi, dtype=np.uint32)))
    if not delta:
        return base
    zero = torch.zeros_like(base.dot_actor)
    return AWSetDeltaState(*base, deleted=torch.zeros_like(base.present),
                           del_dot_actor=zero, del_dot_counter=zero,
                           processed=base.vv.clone())


def multihost_rounds(mesh, lo: int, hi: int):
    """13c's rounds on a mesh (this process's rows [lo, hi)): one ring
    round (K2 a slot), then v2 δ rounds (K5 a slot) with the collective
    GC over the dissemination schedule.  Returns (ring digest, δ digest,
    converged): each digest the sum mod 2^32 of every replica's state
    digest, reduced over the mesh."""
    from go_crdt_playground_tpu_torch.parallel import gossip, multihost
    from go_crdt_playground_tpu_torch.parallel import shardmap

    def fleet_digest(sh):
        d = gossip.state_digest_shardmap(sh, mesh)
        part = shardmap.map_slots(mesh, lambda i, x: x.sum() & 0xFFFFFFFF,
                                  d)
        return int(shardmap.psum(mesh, part, "replica")[
            mesh.local_slots()[0]])

    dev = mesh.device(mesh.local_slots()[0])
    sh = multihost.shard_local_rows(multihost_rows(lo, hi, False, dev),
                                    mesh)
    ring = fleet_digest(gossip.ring_round_shardmap(sh, mesh))
    st = multihost.shard_local_rows(multihost_rows(lo, hi, True, dev), mesh)
    for off in gossip.dissemination_offsets(MULTIHOST_R):
        st = gossip.delta_gossip_round_shardmap(
            st, mesh, gossip.ring_perm(MULTIHOST_R, off, "cpu"))
        st = gossip.gc_shardmap(st, mesh)
    return ring, fleet_digest(st), gossip.converged_shardmap(st, mesh)


def multihost_worker(pid: int, init: str) -> None:
    """One rank of 13c (run as ``chip_smoke.py --multihost-worker PID
    INIT``): gloo, two slots on cuda:0, every exchange between the
    ranks staged through host memory."""
    from go_crdt_playground_tpu_torch.ops import cuda_delta, cuda_merge
    from go_crdt_playground_tpu_torch.parallel import multihost, shardmap

    multihost.initialize(init, num_processes=2, process_id=pid,
                         backend="gloo")
    mesh = multihost.global_mesh(local_devices=["cuda:0", "cuda:0"])
    assert shardmap.host_staged() and mesh.multiprocess()
    lo, hi = multihost.process_replica_block(MULTIHOST_R)
    t0 = time.perf_counter()
    ring, delta, conv = multihost_rounds(mesh, lo, hi)
    print(json.dumps({
        "pid": pid, "ring": ring, "delta": delta, "converged": conv,
        "wall_s": time.perf_counter() - t0,
        "merge_pairwise_rows": cuda_merge.merge_pairwise_rows.launches,
        "delta_gossip_round": cuda_delta.delta_gossip_round.launches}),
        flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()


def phase_multihost(counters: Counters) -> dict:
    """13c: the 2-process multihost rounds over gloo, each rank's two
    slots on cuda:0 and its exchanges staged through host memory: both
    ranks print the same digests, equal to the one-process 4-slot mesh
    on the card.  Multi-rank NCCL needs one card a rank and is not run
    here."""
    from pathlib import Path

    from go_crdt_playground_tpu_torch.parallel import mesh as mesh_mod

    one = mesh_mod.make_mesh((4, 1), devices=["cuda:0"] * 4)
    counters.reset()
    want = multihost_rounds(one, 0, MULTIHOST_R)
    counters.read("13c one-process mesh", at_least={
        "merge_pairwise_rows": 4, "delta_gossip_round": 4})
    if not want[2]:
        raise AssertionError("13c: the one-process mesh did not converge")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_multihost_")
    try:
        init = f"file://{tmp}/rendezvous"
        me = str(Path(__file__).resolve())
        procs = [subprocess.Popen(
            [sys.executable, me, "--multihost-worker", str(pid), init],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True)
            for pid in (0, 1)]
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=300)
                if p.returncode != 0:
                    raise AssertionError(f"13c worker: {err[-3000:]}")
                outs.append(json.loads(out.strip().splitlines()[-1]))
        finally:
            for p in procs:
                kill_group(p)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for o in outs:
        if (o["ring"], o["delta"], o["converged"]) != want:
            raise AssertionError(f"13c: rank {o['pid']} {o} != the "
                                 f"one-process mesh {want}")
        for name in ("merge_pairwise_rows", "delta_gossip_round"):
            counters.main_path[name] += o[name]
    log(f"13c multihost: 2 gloo ranks x 2 slots on cuda:0 ({MULTIHOST_R} "
        f"x {MULTIHOST_E}), ring digest {want[0]:#x}, δ digest "
        f"{want[1]:#x}, converged, equal on both ranks and to the "
        f"one-process mesh; walls "
        f"{[round(o['wall_s'], 3) for o in outs]} s; multi-rank NCCL not "
        "run (one card)")
    return {"ring": want[0], "delta": want[1],
            "walls_s": [o["wall_s"] for o in outs]}


def count_plain_on_card():
    """Patch K10's plain fold and the δ compaction (where the port
    defines them and where the ingest wrappers call them) to count the
    calls made on CUDA tensors; returns the counts (a dict, updated in
    place)."""
    from go_crdt_playground_tpu_torch.ops import compact, cuda_ingest

    counts = {"fold": 0, "compact": 0}
    fold, comp = cuda_ingest.ingest_fold_plain, compact.compact_payload

    def counted_fold(state, *args):
        counts["fold"] += state.vv.is_cuda
        return fold(state, *args)

    def counted_compact(payload, *args):
        counts["compact"] += payload.changed.is_cuda
        return comp(payload, *args)

    cuda_ingest.ingest_fold_plain = counted_fold
    cuda_ingest.compact_payload = compact.compact_payload = counted_compact
    return counts


def serve_child(dump: str, argv) -> int:
    """``serve --ingest ARGV`` as a process whose frontend records every
    batch and WAL body (``chip_smoke.py --serve-child DUMP ARGV``); at
    the drain it writes them, the recorder's counters, the K11 launches,
    the K10 launches of both entries and the plain folds and
    compactions made on the card to DUMP (a pickle)."""
    import pickle

    import go_crdt_playground_tpu_torch.__main__ as cli
    from go_crdt_playground_tpu_torch.ops import cuda_digest, cuda_ingest

    build, held = cli._build_frontend, {}
    hints = []
    plain = count_plain_on_card()

    def recording_build(args):
        fe = build(args)
        held["fe"], held["rec"] = fe, record_batches(fe, hints)
        return fe

    cli._build_frontend = recording_build
    rc = cli.main(["serve", "--ingest", *argv])
    batches, bodies, append_s = held["rec"]
    snap = held["fe"].recorder.snapshot()
    with open(dump, "wb") as f:
        pickle.dump({
            "batches": [(np.nonzero(a), np.nonzero(d), lv)
                        for a, d, lv in batches], "hints": hints,
            "bodies": bodies, "append_s": append_s[0],
            "counters": snap["counters"],
            "apply_s": snap["observations"].get("serve.batch.apply_s"),
            "k11": cuda_digest.state_group_digests.launches,
            "k10_based": cuda_ingest.ingest_slot_rows.launches,
            "k10_fused": cuda_ingest.ingest_rows_delta_fused.launches,
            "plain_on_card": plain}, f)
    return rc


def ingest_slot_bounds(E: int, A: int, B: int, K: int):
    """The based entry's least time: K10's whole-entry bytes
    (``ingest_bounds``) with three counter words a row and the final
    clock read in place of the live flags; the larger of that over the
    memory rate and the operations over the scalar rate."""
    _, _, nbytes = ingest_bounds(E, A, B, K)
    nbytes += 11 * B + 4
    ops = E * (B * INGEST_OPS_PER_ROW_LANE + INGEST_OPS_PER_LANE)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ALU_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes)


def time_k10_slot(E: int, A: int, B: int, smi: str) -> dict:
    """The based entry at a mesh slot's shape (E lanes of a slot, B rows
    of one key each and a delete, K = 128 as a CUDA node's): bitwise
    against its plain version, ms a call through the wrapper (CUDA
    events), device ms a call (queued behind a sleeping stream), the
    plain version's ms, against the bound."""
    import torch

    from go_crdt_playground_tpu_torch._u32 import narrow
    from go_crdt_playground_tpu_torch.ops import cuda_ingest as ci

    rng = np.random.default_rng(15)
    row = ingest_slice(rng, E, A, 0x7FFFFFFB, 0xFFFFFFF0, False, "cuda")
    add = np.zeros((B, E), bool)
    add[np.arange(B), rng.integers(0, E, B)] = True
    dl = np.zeros((B, E), bool)
    dl[B // 2, rng.integers(0, E)] = True
    based = based_inputs(rng, 0xFFFFFFF0, torch.from_numpy(add).cuda(),
                         torch.from_numpy(dl).cuda(),
                         torch.ones(B, dtype=torch.bool, device="cuda"))
    # the counters on the card as the mesh node hands them over
    dev_counters = [narrow(torch.from_numpy(np.asarray(x, np.int64))).cuda()
                    for x in based[3:]]
    args = (row, *based[:3], *dev_counters)

    def call(kernel):
        return ci.ingest_slot_rows(*args, k_changed=128, k_deleted=128,
                                   kernel=kernel)

    got, want = call("cuda"), call("torch")
    err = max(max_abs_err(got[p], want[p], f"K10 slot E={E} part {p}")
              for p in range(3))
    del got, want
    ms = cuda_time_ms(lambda: call("cuda"), 200)
    device_ms = queued_device_ms(lambda: call("cuda"), WIDE_QUEUED)
    plain_ms = cuda_time_ms(lambda: call("torch"), 5)
    bound_ms, bound_by, nbytes = ingest_slot_bounds(E, A, B, 128)
    out = {"E": E, "A": A, "B": B, "ms": ms, "device_ms": device_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_bytes": nbytes, "max_abs_err": err}
    log(f"K10 based entry at a mesh slot (E={E}, A={A}, B={B}, K=128): "
        f"{ms:.4f} ms a call, device {device_ms * 1e3:.3f} µs a call, "
        f"plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.3f} µs "
        f"({bound_by}, {nbytes} B); bitwise equal to the plain version "
        f"[{smi}]")
    return out


MESH_SPLIT_BATCHES = 6


def mesh_batch_split(label: str, E: int, A: int, B: int, tmp: str,
                     smi: str) -> dict:
    """Where a mesh node's batch goes, in process on cuda:0: the node of
    ``serve --mesh-devices LABEL`` with a WAL (no fsync) takes
    MESH_SPLIT_BATCHES batches of B one-key rows (13d's op mix, a delete
    every tenth row): ``ingest_batch`` wall a batch (host clock, ending
    in a synchronize), the rows' copy to the card alone
    (``meshtarget.rows_to_device``, the same arrays), and the device's
    busy time, operations and idle share a batch (torch.profiler)."""
    import torch

    from go_crdt_playground_tpu_torch.parallel.meshtarget import (
        MeshApplyTarget, rows_to_device)
    from go_crdt_playground_tpu_torch.parallel.meshtarget2d import \
        Mesh2DApplyTarget
    from go_crdt_playground_tpu_torch.utils.wal import DeltaWal

    klass, kw = ((Mesh2DApplyTarget, {"mesh_shape": label}) if "x" in label
                 else (MeshApplyTarget, {"mesh_devices": int(label)}))
    node = klass(0, E, A, device="cuda:0",
                 wal=DeltaWal(tempfile.mkdtemp(dir=tmp), fsync=False), **kw)
    rng = np.random.default_rng(17)
    batches = []
    for _ in range(MESH_SPLIT_BATCHES):
        add = np.zeros((B, E), bool)
        dl = np.zeros((B, E), bool)
        keys = rng.choice(E, B, replace=False)
        add[np.arange(B), keys] = np.arange(B) % 10 != 9
        dl[np.arange(B), keys] = np.arange(B) % 10 == 9
        batches.append((add, dl, np.ones(B, bool)))

    def run():
        for batch in batches:
            node.ingest_batch(*batch)
        torch.cuda.synchronize()

    run()  # warm
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / MESH_SPLIT_BATCHES
    t0 = time.perf_counter()
    for batch in batches:
        rows_to_device(*batch, "cuda:0")
    torch.cuda.synchronize()
    rows_ms = (time.perf_counter() - t0) * 1e3 / MESH_SPLIT_BATCHES
    _, trace = trace_run(run, K10_KERNELS)
    node.wal.close()
    n = MESH_SPLIT_BATCHES
    out = {"B": B, "ingest_batch_ms": wall_ms, "rows_to_device_ms": rows_ms,
           "device_busy_ms": None if trace is None
           else trace["device_busy_ms"] / n,
           "k10_ms": None if trace is None else trace["kernel_ms"] / n,
           "device_ops": None if trace is None else trace["device_ops"] / n,
           "idle_share": None if trace is None else trace["idle_share"]}
    dev = ("device not measured" if trace is None else
           f"device busy {out['device_busy_ms']:.3f} ms (K10 "
           f"{out['k10_ms']:.3f} ms) in {out['device_ops']:g} device ops, "
           f"idle share {out['idle_share']:.4f}")
    log(f"13d {label} batch split (E={E}, B={B} one-key rows, WAL without "
        f"fsync): ingest_batch {wall_ms:.3f} ms a batch, the rows' copy "
        f"to the card alone {rows_ms:.3f} ms; {dev} [{smi}]")
    return out


def mesh_digest_summary(node, want: bytes, lane_slots: int,
                        what: str) -> dict:
    """A mesh node's ``digest_summary()``: equal to
    ``digestsync.node_summary(node)`` and to ``want`` (a one-slot
    node's body after the same batches), read with one K11 launch a
    lane slot.  Returns the body's size and the launches of one read."""
    from go_crdt_playground_tpu_torch.net import digestsync
    from go_crdt_playground_tpu_torch.ops import cuda_digest

    before = cuda_digest.state_group_digests.launches
    body = node.digest_summary()
    k11 = cuda_digest.state_group_digests.launches - before
    if k11 != lane_slots:
        raise AssertionError(f"{what}: digest_summary() launched K11 "
                             f"{k11} times for {lane_slots} lane slots")
    if body != digestsync.node_summary(node):
        raise AssertionError(f"{what}: digest_summary() differs from "
                             "node_summary()")
    if body != want:
        raise AssertionError(f"{what}: digest_summary() differs from the "
                             "one-slot node's summary")
    return {"bytes": len(body), "k11": k11}


def phase_mesh_serve(counters: Counters, timings: dict, smi: str) -> dict:
    """13d: ``serve --ingest --mesh-devices 4`` and ``--mesh-devices 2x2
    --sched auto`` on cuda:0 as subprocesses at one node's universe (E =
    2^20, A = 16), driven by phase 10b's session mix from a child
    process: members and vv equal to the acked ops' set algebra; every
    WAL record byte-identical to a one-slot torch node's fed the same
    batches; the durable dir restored bitwise with the mesh class and
    the plain one; every digest summary read K11 once a slot (counted
    in the server; a 2-D mesh reads its dp row 0) and equal to the
    one-slot node's summary; every batch one K10 based launch a slot (a
    chunk one a stripe slot), no fused K10 launch, no plain fold on the
    card and no compaction there but the 2 x 2 node's joined δ.  Then
    the based entry alone at each node's slot shape (``time_k10_slot``)
    and where a batch's time goes on each node (``mesh_batch_split``)."""
    import pickle
    import re
    import signal
    from pathlib import Path

    import torch

    from go_crdt_playground_tpu_torch.net import digestsync
    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.parallel.meshtarget import \
        MeshApplyTarget
    from go_crdt_playground_tpu_torch.parallel.meshtarget2d import \
        Mesh2DApplyTarget
    from go_crdt_playground_tpu_torch.serve.client import ServeClient
    from go_crdt_playground_tpu_torch.utils.wal import DeltaWal

    E, A = UNIVERSE_E, UNIVERSE_A
    summary_reads = {}

    def recorded_node(klass, wal_dir):
        """(a node on the card with a WAL, the bodies it appends)."""
        node = klass(0, E, A, device="cuda:0",
                     wal=DeltaWal(wal_dir, fsync=False))
        bodies, append = [], node.wal.append
        node.wal.append = lambda b: (bodies.append(b), append(b))
        return node, bodies

    out = {}
    for label, flags in MESH_SERVE:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_serve_")
        try:
            dump = f"{tmp}/dump.pkl"
            argv = ["--elements", str(E), "--actors", str(A),
                    "--durable-dir", f"{tmp}/durable", "--device",
                    "cuda:0", *flags]
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--serve-child", dump,
                 *argv], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, start_new_session=True)
            try:
                banner = proc.stdout.readline()
                m = re.search(r"listening on (\S+):(\d+) .*mesh=(\S+) "
                              r"sched=(\S+)", banner)
                if m is None:
                    raise AssertionError(f"13d {label}: banner {banner!r} "
                                         f"{proc.stderr.read()[-2000:]}")
                if m.group(3) != label:
                    raise AssertionError(f"13d banner mesh={m.group(3)}")
                addr = (m.group(1), int(m.group(2)))
                up = time.perf_counter() - t0
                results, lat, wall, rejects = drive_frontend_child(
                    addr, FRONTEND_OPS, E)
                bodies_read = []
                with ServeClient(addr) as c:
                    members, vv = c.members()
                    for _ in range(MESH_SERVE_READS):
                        bodies_read.append(c.digest_summary())
                proc.send_signal(signal.SIGTERM)
                stdout, err = proc.communicate(timeout=300)
            finally:
                kill_group(proc)
            if proc.returncode != 0:
                raise AssertionError(f"13d {label}: rc {proc.returncode} "
                                     f"{err[-3000:]}")
            with open(dump, "rb") as f:
                rec = pickle.load(f)
            acked = sum(ok for ops in results for _, _, ok in ops)
            if acked != rec["counters"]["serve.ops.acked"] or acked < 2000:
                raise AssertionError(f"13d {label}: {acked} acked, server "
                                     f"{rec['counters']['serve.ops.acked']}"
                                     f", rejects {rejects}")
            if set(members) != expected_members(results):
                raise AssertionError(f"13d {label}: members differ from "
                                     "the acked ops' set algebra")
            want_vv = np.zeros(A, np.uint32)
            want_vv[0] = acked
            if not np.array_equal(vv, want_vv):
                raise AssertionError(f"13d {label}: vv {vv}")
            # one K11 launch a lane slot a read (the dp replicas of a
            # 2-D mesh hold the same lanes; reads take dp row 0)
            lane_slots = 2 if "x" in label else 4
            if rec["k11"] != lane_slots * MESH_SERVE_READS:
                raise AssertionError(f"13d {label}: {rec['k11']} K11 "
                                     f"launches for {MESH_SERVE_READS} "
                                     f"reads of {lane_slots} lane slots")
            counters.main_path["state_group_digests"] += rec["k11"]
            # one based K10 launch a slot a dispatch (dp x mp = 4 slots
            # a chunk on 2 x 2), the frontend's warm-up batch on a scratch
            # node of the same class (serve/frontend._warmup) one more;
            # nothing else folds on the card, and nothing compacts there
            # but the 2 x 2 node's joined δ, a lane slot a record
            # (meshtarget2d: no kernel computes that δ)
            dispatches = rec["counters"]["ingest.dispatches"]
            if "x" in label:
                if dispatches != rec["counters"]["mesh.stripe.dispatches"]:
                    raise AssertionError(f"13d {label}: {rec['counters']}")
            elif dispatches != len(rec["batches"]):
                raise AssertionError(f"13d {label}: {dispatches} "
                                     f"dispatches for "
                                     f"{len(rec['batches'])} batches")
            compactions = 2 * (dispatches + 1) if "x" in label else 0
            if (rec["k10_based"] != MESH_SLOTS * (dispatches + 1)
                    or rec["k10_fused"] != 0
                    or rec["plain_on_card"] != {"fold": 0,
                                                "compact": compactions}):
                raise AssertionError(
                    f"13d {label}: {rec['k10_based']} based and "
                    f"{rec['k10_fused']} fused K10 launches for "
                    f"{dispatches} dispatches and the warm-up on "
                    f"{MESH_SLOTS} slots, plain on the card "
                    f"{rec['plain_on_card']}")
            counters.main_path["ingest_slot_rows"] += rec["k10_based"]
            # the same batches on a one-slot node on the card
            batches = []
            for a_nz, d_nz, lv in rec["batches"]:
                add = np.zeros((lv.shape[0], E), bool)
                dl = np.zeros((lv.shape[0], E), bool)
                add[a_nz] = True
                dl[d_nz] = True
                batches.append((add, dl, lv))
            # (a batch the 2-D node's planner cut is replayed chunk by
            # chunk: one record a chunk)
            one, one_bodies = recorded_node(Node, f"{tmp}/one")
            dp = int(label.split("x")[0]) if "x" in label else 0
            cuts = 0
            for (add, dl, lv), hint in zip(batches, rec["hints"]):
                chunks, c = (cut_chunks(add, dl, lv, dp, hint) if dp
                             else ([(add, dl, lv)], 0))
                cuts += c
                for chunk in chunks:
                    one.ingest_batch(*chunk)
            if cuts != rec["counters"].get("mesh.stripe.cuts", 0):
                raise AssertionError(f"13d {label}: the replay cut {cuts} "
                                     "times, the server "
                                     f"{rec['counters']}")
            if one_bodies != rec["bodies"]:
                raise AssertionError(f"13d {label}: WAL records differ "
                                     "from the one-slot node's")
            live = one.state_slice()
            cls, kw = ((Mesh2DApplyTarget, {"mesh_shape": "2x2"})
                       if "x" in label else
                       (MeshApplyTarget, {"mesh_devices": 4}))
            one_body = digestsync.node_summary(one)
            for klass, nk in ((cls, kw), (Node, None)):
                back = klass.restore_durable(f"{tmp}/durable",
                                             device="cuda:0",
                                             node_kwargs=nk)
                same_state(live, back.state_slice(),
                           f"13d {label}: restore as {klass.__name__}")
                if klass is cls:
                    summary_reads[label] = mesh_digest_summary(
                        back, one_body, lane_slots, f"13d {label}")
                    counters.main_path["state_group_digests"] += \
                        summary_reads[label]["k11"]
                back.wal.close()
            if bodies_read[-1] != one_body:
                raise AssertionError(f"13d {label}: the summary differs "
                                     "from the one-slot node's")
            one.wal.close()
            p50 = float(np.percentile(lat, 50)) * 1e3
            p99 = float(np.percentile(lat, 99)) * 1e3
            apply_s = rec["apply_s"]
            out[label] = {
                "ops_per_s": acked / wall, "acked": acked, "wall_s": wall,
                "ack_p50_ms": p50, "ack_p99_ms": p99,
                "batches": len(batches),
                "batch_apply_ms": apply_s["mean"] * 1e3,
                "wal_append_share": rec["append_s"] / apply_s["sum"],
                "stripe_cuts": cuts, "k11_launches": rec["k11"],
                "digest_summary": summary_reads[label],
                "k10_based_launches": rec["k10_based"],
                "dispatches": dispatches, "startup_s": up, "card": smi}
            log(f"13d serve --mesh-devices {label} (E={E}, A={A}, 4 slots "
                f"on cuda:0, {FRONTEND_SESSIONS} sessions x {FRONTEND_OPS}"
                f" ops): {acked} acked in {wall:.3f} s = "
                f"{acked / wall:.1f} ops/s, ack p50 {p50:.3f} ms p99 "
                f"{p99:.3f} ms, {len(batches)} batches, "
                f"{apply_s['mean'] * 1e3:.3f} ms a batch, stripe cuts "
                f"{cuts}; members and vv equal to the set algebra; WAL "
                f"records equal to the one-slot node's fed the same "
                f"batches (cut ones chunk by chunk); restored bitwise; "
                f"K11 {rec['k11']} launches for {MESH_SERVE_READS} summary "
                f"reads; K10 based {rec['k10_based']} launches for "
                f"{dispatches} dispatches and the warm-up, no fused K10 "
                f"launch, no plain fold on the card, "
                f"{rec['plain_on_card']['compact']} compactions of a joined "
                f"δ; the restored node's digest_summary() equal to "
                f"node_summary() and to the one-slot node's body "
                f"({summary_reads[label]['bytes']} B, K11 "
                f"{summary_reads[label]['k11']} launches for one read of "
                f"{lane_slots} lane slots) [{smi}]")
            log(f"13d {label}: " + json.dumps(out[label]))
            if dp:
                out[f"{label} cut"] = forced_cuts(label, dp, tmp,
                                                  recorded_node)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    # the based entry alone at each node's slot shape: 4 slots of 2^18
    # lanes (B <= 32), 2 lane slots of 2^19 (32 rows a stripe); then a
    # batch's split on each node (B = 32, 64 on 2 x 2: its batcher's
    # width)
    timings["K10 slot"] = {
        label: time_k10_slot(E // (2 if "x" in label else MESH_SLOTS), A,
                             32, smi)
        for label, _ in MESH_SERVE}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_split_")
    try:
        for label, _ in MESH_SERVE:
            out[label]["batch_split"] = mesh_batch_split(
                label, E, A, 64 if "x" in label else 32, tmp, smi)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def forced_cuts(label: str, dp: int, tmp: str, recorded_node) -> dict:
    """The 2-D mesh node's cut path on the card, in process: batches
    whose rows all touch one lane (so the planner cuts them) go into a
    ``Mesh2DApplyTarget`` on cuda:0; its WAL records equal a one-slot
    node's fed the chunks, and the states are bitwise equal."""
    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.obs.metrics import Recorder
    from go_crdt_playground_tpu_torch.parallel.meshtarget2d import \
        Mesh2DApplyTarget

    E, A, B = UNIVERSE_E, UNIVERSE_A, 32
    rng = np.random.default_rng(MESH_CUT_SEED)
    mesh, mesh_bodies = recorded_node(
        lambda *a, **kw: Mesh2DApplyTarget(*a, mesh_shape=label,
                                           recorder=Recorder(), **kw),
        f"{tmp}/cut_mesh")
    one, one_bodies = recorded_node(Node, f"{tmp}/cut_one")
    cuts = 0
    for _ in range(4):
        add = rng.random((B, E)) < 16 / E
        dl = rng.random((B, E)) < 4 / E
        add[:, 5] = True
        live = np.ones(B, bool)
        mesh.ingest_batch(add, dl, live)
        chunks, c = cut_chunks(add, dl, live, dp)
        cuts += c
        for chunk in chunks:
            one.ingest_batch(*chunk)
    if cuts < 4 or cuts != mesh.recorder.snapshot()["counters"].get(
            "mesh.stripe.cuts"):
        raise AssertionError(f"13d {label} cut: {cuts} cuts")
    if mesh_bodies != one_bodies:
        raise AssertionError(f"13d {label} cut: WAL records differ from "
                             "the one-slot node's fed the chunks")
    same_state(one.state_slice(), mesh.state_slice(), f"13d {label} cut")
    mesh.wal.close()
    one.wal.close()
    log(f"13d {label} cut path: 4 batches of {B} rows cut {cuts} times; "
        f"{len(mesh_bodies)} WAL records equal to the one-slot node's fed "
        "the chunks; states bitwise equal")
    return {"cuts": cuts, "records": len(mesh_bodies)}


# ---------------------------------------------------------------------------
# phase 14: the Merger bridge on the card
# ---------------------------------------------------------------------------

# seeded pairs at the serve node's scale (SERVE_E keys at most, SERVE_A
# actors), the pair past both shared-memory limits, the timed pair (the
# north star's 256 writers)
BRIDGE_PAIRS = 200
BRIDGE_WIDE_A = 8193
BRIDGE_TIMED_E, BRIDGE_TIMED_A = 1 << 16, 256
# (label, delta, delta_semantics, strict_reference_semantics)
BRIDGE_KINDS = (("full-state", False, "reference", True),
                ("δ v2", True, "v2", True),
                ("δ reference", True, "reference", True),
                ("δ reference loose", True, "reference", False))


def _pb_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _pb_tag(field: int, wire: int) -> bytes:
    return _pb_varint(field << 3 | wire)


def _pb_len(field: int, payload: bytes) -> bytes:
    return _pb_tag(field, 2) + _pb_varint(len(payload)) + payload


def go_request(dst, src, delta: bool) -> bytes:
    """The MergeRequest bytes of the JAX package's Go client
    (bridge/client/main.go): fields in tag order, entries sorted by key,
    proto3 zero values omitted, repeated uint64 packed; a δ request adds
    the Deleted log, delta = true, "reference" and the strict quirk."""
    def dot(d):
        return ((_pb_tag(1, 0) + _pb_varint(d.actor) if d.actor else b"")
                + (_pb_tag(2, 0) + _pb_varint(d.counter) if d.counter
                   else b""))

    def entries(field, m):
        return b"".join(_pb_len(field, _pb_len(1, k.encode())
                                + _pb_len(2, dot(m[k])))
                        for k in sorted(m))

    def replica(rep):
        vv = list(rep.version_vector.v)
        return ((_pb_tag(1, 0) + _pb_varint(rep.actor) if rep.actor else b"")
                + (_pb_len(2, b"".join(map(_pb_varint, vv))) if vv else b"")
                + entries(3, rep.entries)
                + (entries(4, rep.deleted) if delta else b""))

    body = _pb_len(1, replica(dst)) + _pb_len(2, replica(src))
    if delta:
        body += (_pb_tag(3, 0) + _pb_varint(1) + _pb_len(4, b"reference")
                 + _pb_tag(5, 0) + _pb_varint(1))
    return body


class BridgeCheck:
    """A client of the CUDA Merger server: every reply held against
    ``execute_merge`` on the CPU (the same bytes) and against the port's
    spec merge of the request (zero-padded to the packed actor axis);
    counts the merges by kind and times each round trip."""

    def __init__(self, addr):
        import socket

        self.sock = socket.create_connection(addr, timeout=300)
        self.counts = {"full": 0, "delta": 0}
        self.walls = []

    def close(self):
        self.sock.close()

    def request(self, body: bytes, checked: bool = True):
        """One merge through the server; ``checked``: against the CPU
        reply's bytes and the spec merge (the timed pair skips both)."""
        from go_crdt_playground_tpu_torch.bridge import messages, service

        t0 = time.perf_counter()
        service.send_frame(self.sock, service.METHOD_MERGE, body)
        method, reply = service.recv_frame(self.sock)
        self.walls.append(time.perf_counter() - t0)
        req = messages.MergeRequest.FromString(body)
        if method != service.METHOD_MERGE or (checked and reply != (
                service.execute_merge(req, "cpu").SerializeToString())):
            raise AssertionError("bridge: the CUDA reply differs from the "
                                 "CPU reply's bytes")
        resp = messages.MergeResponse.FromString(reply)
        if resp.error:
            raise AssertionError(f"bridge: error reply {resp.error!r}")
        self.counts["delta" if req.delta else "full"] += 1
        if checked:
            dst, src = service.request_replicas(req)
            num_a = service._dimensions(dst, src)[1]
            for rep in (dst, src):
                rep.version_vector.v += [0] * (num_a
                                               - len(rep.version_vector))
            dst.merge(src)
            if (resp.canonical != str(dst)
                    or list(resp.sorted_values) != dst.sorted_values()):
                raise AssertionError("bridge: the reply disagrees with the "
                                     "spec merge")
        return resp

    def _install(self, dst, resp, delta: bool):
        """What main.go does with a reply: the merged state into dst,
        then its canonical rendering and sorted values checked."""
        from go_crdt_playground_tpu_torch.models.spec import (Dot,
                                                              VersionVector)

        dst.version_vector = VersionVector(list(resp.merged.version_vector))
        dst.entries = {e.key: Dot(e.dot.actor, e.dot.counter)
                       for e in resp.merged.entries}
        if delta:
            dst.deleted = {e.key: Dot(e.dot.actor, e.dot.counter)
                           for e in resp.merged.deleted}
        if str(dst) != resp.canonical or \
                list(resp.sorted_values) != dst.sorted_values():
            raise AssertionError("bridge: installed state renders apart")

    def merge(self, dst, src):
        self._install(dst, self.request(go_request(dst, src, False)), False)

    def delta_merge(self, dst, src):
        self._install(dst, self.request(go_request(dst, src, True)), True)


def _expect(rep, *values):
    if rep.sorted_values() != sorted(values):
        raise AssertionError(f"bridge scenario: {rep.sorted_values()} != "
                             f"{sorted(values)}")


def go_client_scenarios(c: BridgeCheck) -> None:
    """The Go client's replays over the bridge: T1-T3 (awset_test.go:
    10-122) and T6 (awset-delta_test.go:168-189), each merge computed by
    the server, with the client's membership assertions."""
    from go_crdt_playground_tpu_torch.models.spec import (AWSet, AWSetDelta,
                                                          VersionVector)

    def pair(cls=AWSet):
        return (cls(actor=0, version_vector=VersionVector([0, 0])),
                cls(actor=1, version_vector=VersionVector([0, 0])))

    a, b = pair()                                            # T1
    a.add("A", "B", "C")
    b.add("A", "B", "C")
    c.merge(a, b)
    c.merge(b, a)
    a.del_("B")
    b.add("B")
    c.merge(b, a)
    c.merge(a, b)
    _expect(a, "A", "B", "C")
    _expect(b, "A", "B", "C")

    a, b = pair()                                            # T2
    a.add("Shelly")
    c.merge(b, a)
    _expect(b, "Shelly")
    b.add("Bob", "Phil", "Pete")
    c.merge(a, b)
    _expect(a, "Shelly", "Bob", "Phil", "Pete")
    a.del_("Phil")
    a.add("Bob")
    a.add("Anna")
    c.merge(b, a)
    _expect(a, "Shelly", "Bob", "Pete", "Anna")
    _expect(b, "Shelly", "Bob", "Pete", "Anna")
    a.del_("Bob", "Pete")
    b.del_("Bob", "Shelly")
    c.merge(a, b)
    c.merge(b, a)
    _expect(a, "Anna")
    _expect(b, "Anna")
    a.add("A", "B", "C")
    a.del_("A")
    a.add("A")
    c.merge(b, a)
    _expect(b, "Anna", "A", "B", "C")

    a, b = pair()                                            # T3
    a.add("Anne", "Bob")
    b.add("Anne")
    a2, b2 = a.clone(), b.clone()
    b2.add("Bob")
    a2.del_("Bob")
    c.merge(b2, a2)
    c.merge(a2, b2)
    _expect(b2, "Anne", "Bob")
    _expect(a2, "Anne", "Bob")
    b.add("Bob")
    c.merge(b, a)
    a.del_("Bob")
    c.merge(b, a)
    c.merge(a, b)
    _expect(b, "Anne")
    _expect(a, "Anne")

    a, b = pair(AWSetDelta)                                  # T6
    a.add("A", "B")
    b.add("A", "C")
    c.delta_merge(a, b)
    c.delta_merge(b, a)
    a.del_("B")
    a.add("D", "E")
    b.add("E")
    c.delta_merge(b, a)
    _expect(b, "A", "C", "D", "E")
    c.delta_merge(a, b)
    _expect(a, "A", "C", "D", "E")
    if (a.version_vector.v, b.version_vector.v) != ([5, 2], [5, 3]):
        raise AssertionError("bridge T6: the strict empty-δ quirk lost")


def bridge_config1(c: BridgeCheck, num_ops: int = 120, seed: int = 11):
    """BASELINE ladder config 1 (the JAX package's bench.measure_config1:
    3 replicas, E = 16, A = 3, 120 seeded ops) with every merge answered
    by the bridge: the bridged replicas render as the spec replicas."""
    import random

    from go_crdt_playground_tpu_torch.models.spec import AWSet, VersionVector

    rng = random.Random(seed)
    R, E, A = 3, 16, 3
    spec = [AWSet(actor=r, version_vector=VersionVector([0] * A))
            for r in range(R)]
    bridged = [s.clone() for s in spec]
    for _ in range(num_ops):
        r = rng.randrange(R)
        op = rng.random()
        if op < 0.55:
            k = f"e{rng.randrange(E)}"
            spec[r].add(k)
            bridged[r].add(k)
        elif op < 0.75 and spec[r].entries:
            k = rng.choice(sorted(spec[r].entries))
            spec[r].del_(k)
            bridged[r].del_(k)
        else:
            src = rng.randrange(R)
            if src != r:
                spec[r].merge(spec[src])
                c.merge(bridged[r], bridged[src])
    if [str(s) for s in spec] != [str(b) for b in bridged]:
        raise AssertionError("bridge config 1: renderings differ")


def bridge_pair(rng, kind, num_keys: int, num_actors: int):
    """A seeded request: three writers (distinct actors of num_actors)
    through adds, deletes and merges over num_keys keys; two of them."""
    from go_crdt_playground_tpu_torch.bridge import convert, messages
    from go_crdt_playground_tpu_torch.models.spec import (AWSet, AWSetDelta,
                                                          VersionVector)

    _, delta, sem, strict = kind
    reps = [(AWSetDelta(actor=a, version_vector=VersionVector(
        [0] * num_actors), delta_semantics=sem,
        strict_reference_semantics=strict) if delta else
        AWSet(actor=a, version_vector=VersionVector([0] * num_actors)))
        for a in rng.sample(range(num_actors), 3)]
    for _ in range(rng.randint(10, 300)):
        r = reps[rng.randrange(3)]
        roll = rng.random()
        if roll < 0.5:
            r.add(*(f"k{rng.randrange(num_keys)}"
                    for _ in range(rng.randint(1, 4))))
        elif roll < 0.7:
            r.del_(f"k{rng.randrange(num_keys)}")
        else:
            r.merge(reps[rng.randrange(3)])
    dst, src = rng.sample(reps, 2)
    return messages.MergeRequest(
        dst=convert.replica_to_proto(dst), src=convert.replica_to_proto(src),
        delta=delta, delta_semantics=sem,
        strict_reference_semantics=strict).SerializeToString()


def bridge_bound(kind: str, E: int, A: int):
    """The least time of one pair merge: two rows read, one written;
    a row is 4A + 9E bytes (full-state), twice that plus the actor for δ."""
    row = 4 * A + 9 * E if kind == "merge" else 2 * (4 * A + 9 * E) + 4
    nbytes = 3 * row
    ops = E * OPS_PER_LANE[kind] + A * OPS_PER_SLOT[kind]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ALU_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes)


def bridge_wide_requests(c: BridgeCheck) -> int:
    """A full-state and a δ v2 pair at A = BRIDGE_WIDE_A (past K3's old
    cap and past 48 KB of shared memory for K5) through the bridge."""
    from go_crdt_playground_tpu_torch.bridge import convert, messages
    from go_crdt_playground_tpu_torch.models.spec import (AWSet, AWSetDelta,
                                                          VersionVector)

    A = BRIDGE_WIDE_A
    for label, delta, sem, strict in BRIDGE_KINDS[:2]:
        cls = AWSetDelta if delta else AWSet
        kw = dict(delta_semantics=sem) if delta else {}
        a = cls(actor=A - 1, version_vector=VersionVector([0] * A), **kw)
        b = cls(actor=7, version_vector=VersionVector([0] * A), **kw)
        a.add(*(f"w{i}" for i in range(64)))
        b.merge(a)
        b.add("w1", "x")
        a.del_("w2", "w3")
        c.request(messages.MergeRequest(
            dst=convert.replica_to_proto(a), src=convert.replica_to_proto(b),
            delta=delta, delta_semantics=sem,
            strict_reference_semantics=strict).SerializeToString())
    return 2


def bridge_wide_kernels(errs: dict) -> int:
    """K3 and K5 on random pairs at A = BRIDGE_WIDE_A and past the card's
    opt-in shared memory (A = 29,057: the vv rows from device memory),
    bitwise to the plain versions."""
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm

    rng = np.random.default_rng(14)
    n = 0
    for A in (BRIDGE_WIDE_A, 29_057):
        for E in (1, 1000):
            st = random_delta_state(rng, 2, E, A, 0x7FFFFFFB, "cuda")
            base = st.base()
            d = type(base)(*(x[:1] for x in base))
            s = type(base)(*(x[1:] for x in base))
            errs["K3"] = max(errs.get("K3", 0), max_abs_err(
                cm.merge_pairwise(d, s, kernel="cuda"),
                cm.merge_pairwise(d, s, kernel="torch"),
                f"K3 one-row pair A={A} E={E}"))
            for _, _, sem, strict in BRIDGE_KINDS[1:]:
                kw = dict(delta_semantics=sem,
                          strict_reference_semantics=strict)
                errs["K5"] = max(errs.get("K5", 0), max_abs_err(
                    cd.delta_gossip_round(st, [1, 1], kernel="cuda", **kw),
                    cd.delta_gossip_round(st, [1, 1], kernel="torch", **kw),
                    f"K5 pair A={A} E={E} {sem} strict={strict}"))
            n += 4
    return n


def bridge_timed_arrays(E: int, A: int, seed: int = 65) -> dict:
    """The timed pair's packed arrays: dst holds 60% of the E keys, src
    the rest and a third of dst's (every key in the union), dots of A
    writers, clocks covering each row's own dots, deletion records on a
    tenth of each row's absent keys."""
    rng = np.random.default_rng(seed)
    u = rng.random(E)
    present = np.stack([u < 0.6, (u >= 0.6) | (rng.random(E) < 0.3)])
    deleted = ~present & (rng.random((2, E)) < 0.1)
    da = rng.integers(0, A, (2, E))
    dc = rng.integers(1, 1000, (2, E))
    vv = np.zeros((2, A), np.int64)
    for r in range(2):
        np.maximum.at(vv[r], da[r][present[r]], dc[r][present[r]])
    arrays = {
        "vv": vv, "present": present,
        "dot_actor": np.where(present, da, 0),
        "dot_counter": np.where(present, dc, 0),
        "actor": np.array([3, 200]),
        "deleted": deleted,
        "del_dot_actor": np.where(deleted, rng.integers(0, A, (2, E)), 0),
        "del_dot_counter": np.where(deleted, rng.integers(1, 1000, (2, E)),
                                    0),
        "processed": vv // 2,
    }
    return {k: v if v.dtype == bool else v.astype(np.uint32)
            for k, v in arrays.items()}


def bridge_timed(c: BridgeCheck, smi: str, tmp: str) -> dict:
    """One pair at E = BRIDGE_TIMED_E keys, A = BRIDGE_TIMED_A, full-state
    and δ v2: one request's wall through the server, then its parts in
    process on the card (the server's path, step by step; the reply
    bytes equal the server's), the kernel's time by CUDA events; then
    the δ state checkpointed with its ElementDict and restored on the
    CPU and the card."""
    import torch

    from go_crdt_playground_tpu_torch.bridge import convert, messages, service
    from go_crdt_playground_tpu_torch.models import awset, awset_delta
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm
    from go_crdt_playground_tpu_torch.ops import delta as delta_ops
    from go_crdt_playground_tpu_torch.ops import merge as merge_ops
    from go_crdt_playground_tpu_torch.utils import checkpoint, codec

    E, A = BRIDGE_TIMED_E, BRIDGE_TIMED_A
    keys = codec.ElementDict(capacity=E, values=[f"key-{i:05d}"
                                                 for i in range(E)])
    pair = awset_delta.from_arrays(bridge_timed_arrays(E, A), "cpu")
    reps = codec.unpack_awset_deltas(awset_delta.to_arrays(pair), keys)
    out = {}
    for label, delta, sem, strict in BRIDGE_KINDS[:2]:
        dst, src = reps if delta else codec.unpack_awsets(
            awset.to_arrays(pair.base()), keys)
        body = messages.MergeRequest(
            dst=convert.replica_to_proto(dst),
            src=convert.replica_to_proto(src), delta=delta,
            delta_semantics=sem,
            strict_reference_semantics=strict).SerializeToString()
        served = c.request(body, checked=False).SerializeToString()
        wall_ms = c.walls[-1] * 1e3
        parts, t = {}, time.perf_counter()

        def lap(name):
            nonlocal t
            now = time.perf_counter()
            parts[name] = (now - t) * 1e3
            t = now

        req = messages.MergeRequest.FromString(body)
        d_rep, s_rep = service.request_replicas(req)
        lap("decode")
        num_e, num_a = service._dimensions(d_rep, s_rep)
        d = codec.ElementDict(capacity=num_e)
        arrays = (codec.pack_awset_deltas if delta else codec.pack_awsets)(
            [d_rep, s_rep], d, num_a)
        lap("spec->pack")
        state = (awset_delta if delta else awset).from_arrays(arrays, "cuda")
        torch.cuda.synchronize()
        lap("host->device")
        if delta:
            merged = delta_ops.delta_merge_one_into(state, 0, state, 1, sem,
                                                    strict)
        else:
            merged, _ = merge_ops.merge_one_into(state, 0, state, 1)
        torch.cuda.synchronize()
        lap("merge entry")
        row = type(merged)(*(x[:1] for x in merged))
        host = awset.to_arrays(row)
        lap("device->host")
        rep = (codec.unpack_awset_deltas(host, d, sem)[0] if delta else
               codec.unpack_awsets(host, d)[0])
        lap("unpack")
        reply = messages.MergeResponse(
            merged=convert.replica_to_proto(rep),
            sorted_values=rep.sorted_values(),
            canonical=str(rep)).SerializeToString()
        lap("encode")
        if reply != served:
            raise AssertionError(f"bridge timed {label}: the step-by-step "
                                 "reply differs from the server's")
        split = ""
        if delta:
            kernel_ms = cuda_time_ms(lambda: cd.delta_gossip_round(
                state, [1, 1], delta_semantics=sem,
                strict_reference_semantics=strict), 20)
            # the kernel alone, this kind's mode and strict reference:
            # launches queued behind a sleeping stream
            perm = torch.tensor([1, 1], device="cuda")
            device_ms = {mode: queued_device_ms(
                lambda mode=mode: cd._launch(state, perm, 0,
                                             cm.PARTNER_GATHER, mode), 200)
                for mode in (cd.kernel_mode(sem, strict), "reference")}
            geom = cd.row_chunks(2, num_e, cd.sm_count(
                torch.cuda.current_device()))
            split = (", on the device (queued) " + ", ".join(
                f"{m} {v * 1e3:.3f} us" for m, v in device_ms.items())
                + f", {geom.chunks} chunks of {geom.lanes} lanes a row")
        else:
            one = type(state)(*(x[:1] for x in state))
            two = type(state)(*(x[1:] for x in state))
            kernel_ms = cuda_time_ms(lambda: cm.merge_pairwise(one, two), 20)
            device_ms, geom = None, None
        kind = "delta" if delta else "merge"
        bound_ms, bound_by, nbytes = bridge_bound(kind, num_e, num_a)
        out[label] = {"request_ms": wall_ms, "parts_ms": parts,
                      "kernel_ms": kernel_ms, "device_ms": device_ms,
                      "chunks": geom and list(geom),
                      "bound_ms": bound_ms,
                      "bound_by": bound_by, "request_bytes": len(body),
                      "reply_bytes": len(served)}
        log(f"bridge request at E = {num_e} keys, A = {num_a}, {label} "
            f"({len(body)} B in, {len(served)} B out): {wall_ms:.3f} ms "
            f"through the server; parts in process "
            + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
            + f" ms; {'K5' if delta else 'K3'} {kernel_ms * 1e3:.3f} us "
            f"a call (CUDA events){split}, bound {bound_ms * 1e3:.3f} us "
            f"({bound_by}, {nbytes} B) [{smi}]")
        if delta:   # (e): the state checkpointed with its dictionary
            path = os.path.join(tmp, "bridge.ckpt")
            checkpoint.save_checkpoint(path, merged, dictionary=d)
            for device in ("cpu", "cuda"):
                ck = checkpoint.restore_checkpoint(path, device)
                if ck.dictionary.state_dict() != d.state_dict() or any(
                        not torch.equal(x.cpu(), y.cpu())
                        for x, y in zip(ck.state, merged)):
                    raise AssertionError(f"bridge checkpoint restore on "
                                         f"{device} differs")
    log(f"bridge checkpoint: the E = {E} δ state saved from the card with "
        f"its ElementDict ({E} keys), restored on the CPU and the card "
        f"bitwise")
    return out


def bridge_cli_start():
    """``python -m go_crdt_playground_tpu_torch serve`` as a user starts
    it (the card is its default device)."""
    return subprocess.Popen(
        [sys.executable, "-m", "go_crdt_playground_tpu_torch", "serve"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)


def bridge_cli_finish(proc) -> str:
    """The spawned bridge: its banner, a ping and a merge, SIGTERM."""
    import re
    import signal

    from go_crdt_playground_tpu_torch.bridge import MergerClient
    from go_crdt_playground_tpu_torch.models.spec import AWSet, VersionVector

    try:
        banner = proc.stdout.readline()
        m = re.fullmatch(r"Merger bridge listening on (\S+):(\d+) \(method "
                         r"0x01 = Merge, 0x02 = Ping; 5-byte header \+ "
                         r"proto body\)\n", banner)
        if m is None:
            raise AssertionError(f"bridge serve CLI banner: {banner!r}")
        a = AWSet(actor=0, version_vector=VersionVector([0, 0]))
        b = AWSet(actor=1, version_vector=VersionVector([0, 0]))
        a.add("Anne")
        b.add("Bob")
        with MergerClient(m.group(1), int(m.group(2))) as client:
            if not client.ping() or client.merge(a, b).sorted_values() != [
                    "Anne", "Bob"]:
                raise AssertionError("bridge serve CLI: ping or merge")
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=60)
    finally:
        kill_group(proc)
    if proc.returncode != 0:
        raise AssertionError(f"bridge serve CLI exit {proc.returncode}")
    return banner.strip()


def phase_bridge(counters: Counters, errs: dict, timings: dict, smi: str):
    """The Merger bridge on the card.  (a) A torch ``MergerServer`` on
    cuda on 127.0.0.1 answers the Go client's T1-T3 and T6 streams, the
    BASELINE ladder's config 1 and BRIDGE_PAIRS seeded pairs at the serve
    node's scale in every merge kind; every reply byte-equal to
    ``execute_merge`` on the CPU and agreeing with the spec merge; the
    ``scenario`` verb in process on the card and on the CPU, the same
    output; K3 or K5 once a merge, counted.  (b) The pair past the
    shared-memory limits, through the bridge and on the kernels.  (c)
    The timed pair at E = 65,536 keys, A = 256.  (d) The ``serve`` verb
    spawned once.  (e) A checkpoint with its ElementDict."""
    import contextlib
    import io
    import random

    from go_crdt_playground_tpu_torch.__main__ import main as cli
    from go_crdt_playground_tpu_torch.bridge import MergerServer

    child = bridge_cli_start()
    server = MergerServer(device="cuda")
    c = BridgeCheck(server.serve())
    tmp = tempfile.mkdtemp(prefix="bridge-")
    try:
        counters.reset()
        go_client_scenarios(c)
        n_go = sum(c.counts.values())
        bridge_config1(c)
        n_config1 = sum(c.counts.values()) - n_go
        rng = random.Random(1400)
        t0 = time.perf_counter()
        for i in range(BRIDGE_PAIRS):
            c.request(bridge_pair(rng, BRIDGE_KINDS[i % len(BRIDGE_KINDS)],
                                  rng.choice((16, 128, SERVE_E)), SERVE_A))
        pairs_s = time.perf_counter() - t0
        pair_walls = sorted(c.walls[-BRIDGE_PAIRS:])
        outputs = []
        for device in ("cuda", "cpu"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                if cli(["scenario", "--device", device]) != 0:
                    raise AssertionError(f"scenario verb on {device}")
            outputs.append(buf.getvalue())
        if outputs[0] != outputs[1] or "add-wins holds: True" not in \
                outputs[0]:
            raise AssertionError("scenario verb: cuda and cpu differ")
        n_wide = bridge_wide_requests(c)
        counts = counters.read("bridge", exact={
            "merge_pairwise": c.counts["full"] + 1,       # + the scenario
            "delta_gossip_round": c.counts["delta"], "gossip_round": 0})
        log(f"bridge: {n_go} Go-client merges (T1-T3, T6), config 1's "
            f"{n_config1} merges, {BRIDGE_PAIRS} seeded pairs at E <= "
            f"{SERVE_E} keys, A = {SERVE_A} in {len(BRIDGE_KINDS)} kinds "
            f"({pairs_s:.2f} s; a request p50 "
            f"{pair_walls[len(pair_walls) // 2] * 1e3:.3f} ms, p99 "
            f"{pair_walls[int(len(pair_walls) * 0.99)] * 1e3:.3f} ms through "
            f"the server), every reply byte-equal to the CPU's and to the "
            f"spec merge; K3 {counts['merge_pairwise']} and K5 "
            f"{counts['delta_gossip_round']} launches, one a merge (the "
            f"scenario verb's absorb among K3's) [{smi}]")
        n_kernel = bridge_wide_kernels(errs)
        timings["bridge"] = bridge_timed(c, smi, tmp)
        timings["bridge_launches"] = counts
        timings["bridge_pair_ms"] = {
            "p50": pair_walls[len(pair_walls) // 2] * 1e3,
            "p99": pair_walls[int(len(pair_walls) * 0.99)] * 1e3}
        log(f"bridge at A = {BRIDGE_WIDE_A}: {n_wide} requests through the "
            f"server and {n_kernel} K3/K5 pairs at A in ({BRIDGE_WIDE_A}, "
            f"29057) bitwise to the plain versions")
    finally:
        c.close()
        server.close()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"bridge serve CLI: {bridge_cli_finish(child)!r}, a ping and a "
        f"merge, SIGTERM -> exit 0")


# ---------------------------------------------------------------------------
# phase 15: the other lattice families and the wide actor axes
# ---------------------------------------------------------------------------

# BASELINE config 2 (the JAX package's bench.measure_config2): GCounter,
# 1,000 replicas, 256 actors, through the dissemination ring offsets;
# passes of the schedule timed
CONFIG2_R, CONFIG2_A = 1000, 256
CONFIG2_PASSES = 50
# operations a lane of the OR-Map's LWW cells: two sign flips a compare,
# two compares and an equality, their and/or, three selects
LWW_OPS_PER_LANE = 12
# wide actor axes: the merge and δ rows stage 2 x A x 4 B, so A = 2,049
# fits the default 48 KB, 8,193 opts in and 29,057 is past the card's
# 227 KB (device memory); dot words hold at most 4,096 actors; K10 stages
# A x 4 B (12,289 opts in, 60,000 reads device memory)
WIDE_A = (2049, 8193, 29057)
WIDE_DOT_A = (2049, 4096)
WIDE_INGEST_A = (2049, 12289, 60000)
WIDE_R, WIDE_E = 128, 300
# K10's wide checks: one block (E = 1,024) and the cooperative grid
WIDE_INGEST_E, WIDE_INGEST_B = (1024, 8192), 32
# calls queued behind a sleeping stream for a wide launch's device time
WIDE_QUEUED = 20


def queued_device_ms(fn, n: int, cycles: int = 50_000_000) -> float:
    """Device ms a call: ``n`` calls queued on the stream behind
    ``torch.cuda._sleep``, CUDA events around them, so the host's launch
    gaps fall inside the sleep and the events time the device's work
    back to back.  The sleep grows until it still holds the stream when
    the last call is queued."""
    import torch

    out = fn()
    del out
    torch.cuda.synchronize()
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            out = fn()
        end.record()
        held = not start.query()
        del out
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / n
        cycles *= 4
    raise AssertionError("the host could not queue the calls behind a "
                         "sleeping stream")


def config2_state(R: int, A: int, device):
    """BASELINE config 2's fleet as bench.measure_config2 seeds it: counts
    from default_rng(0) in [0, 2^20), replica r writing as actor r mod A."""
    from go_crdt_playground_tpu_torch._u32 import from_numpy_u32
    from go_crdt_playground_tpu_torch.ops import lattices

    counts = np.random.default_rng(0).integers(
        0, 1 << 20, (R, A)).astype(np.uint32)
    return lattices.GCounterState(
        counts=from_numpy_u32(counts, device),
        actor=from_numpy_u32(np.arange(R, dtype=np.uint32) % A, device))


def ormap_fleet(R: int, E: int, W: int, device):
    """The full-state fleet (fleet.build_state: W writers, the rest
    observers) as an OR-Map whose every present key holds a cell: a
    seeded stamp in [1, 1,000], the key's writer and a value; absent keys
    hold (0, 0, 0).  One row writes as each actor, so equal (stamp,
    writer) pairs carry equal values."""
    import torch

    from go_crdt_playground_tpu_torch import fleet as fleet_mod
    from go_crdt_playground_tpu_torch._u32 import MASK, narrow
    from go_crdt_playground_tpu_torch.ops import lattices

    base = fleet_mod.build_state(R, E, W, device)
    dev = base.vv.device
    r = torch.arange(R, dtype=torch.int64, device=dev)[:, None]
    e = torch.arange(E, dtype=torch.int64, device=dev)[None, :]
    h = (e * 2246822519 + r * 3266489917 + 374761393) & MASK
    return lattices.ORMapState(
        *base, ts=narrow(torch.where(base.present, 1 + h % 1000, 0)),
        wr_actor=torch.where(base.present, base.dot_actor, 0),
        val=narrow(torch.where(base.present, h, 0)))


def ormap_converged(state) -> bool:
    """Membership and clocks agree (the AWSet digest) and every row holds
    the same cells."""
    from go_crdt_playground_tpu_torch.parallel import collectives

    return bool(collectives.converged(state.present, state.vv)) and all(
        bool((x == x[:1]).all()) for x in (state.ts, state.wr_actor,
                                           state.val))


def ormap_bounds(R: int, E: int, A: int, gathered: bool):
    """Least time of an OR-Map round: the AWSet round's bytes, and the
    three cell planes read once and written once; its operations."""
    nbytes = _schedule_bytes("merge", R, E, A, gathered) + 2 * 3 * 4 * R * E
    ops = R * (E * (OPS_PER_LANE["merge"] + LWW_OPS_PER_LANE)
               + A * OPS_PER_SLOT["merge"])
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ALU_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes)


def phase_ormap_fleet(counters: Counters, errs: dict, timings: dict,
                      smi: str):
    """The OR-Map fleet at the north star's width: the 20 dissemination
    ring offsets through ``ormap_ring_gossip_round`` (keys on K1), then
    a butterfly pass through ``ormap_gossip_round`` (keys on K2), each
    from the fresh fleet, counted and timed, converged; then every round
    again, its whole state against ``lattices.gossip_round(ormap_join,
    ...)`` on the kernels' plain versions on the card, bitwise; and
    ``ormap_join`` on K2 against its plain version."""
    import functools

    import torch

    from go_crdt_playground_tpu_torch.ops import lattices
    from go_crdt_playground_tpu_torch.parallel import gossip

    R, E, W = FLEET_R, FLEET_E, FLEET_W
    t0 = time.perf_counter()
    state = ormap_fleet(R, E, W, "cuda")
    torch.cuda.synchronize()
    log(f"OR-Map fleet: {R} x {E}, A={W}, three LWW planes, built in "
        f"{time.perf_counter() - t0:.2f} s ({state_bytes(state) / 1e9:.3f} "
        "GB)")
    plain_join = functools.partial(lattices.ormap_join, kernel="torch")
    stages = R.bit_length() - 1
    legs = (("ring", gossip.ormap_ring_gossip_round,
             gossip.dissemination_offsets(R), "ring_round_rows", "K1",
             False),
            ("butterfly", gossip.ormap_gossip_round,
             [gossip.butterfly_perm(R, st, "cuda") for st in range(stages)],
             "gossip_round_rows", "K2", True))
    report = {}
    for label, round_fn, partners, wrapper, key, gathered in legs:
        warm = round_fn(state, partners[0])
        del warm
        torch.cuda.synchronize()
        counters.reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cur = state
        for partner in partners:
            cur = round_fn(cur, partner)
        end.record()
        total = checksum(cur)
        sched_ms = start.elapsed_time(end)
        launched = counters.read(f"OR-Map {label}",
                                 exact={wrapper: len(partners)})[wrapper]
        if not ormap_converged(cur):
            raise AssertionError(f"OR-Map {label}: fleet not converged")
        del cur
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        cur = state
        for i, partner in enumerate(partners):
            got = round_fn(cur, partner, kernel="cuda")
            perm = partner if gathered else gossip.ring_perm(R, partner,
                                                             "cuda")
            want = lattices.gossip_round(plain_join, cur, perm)
            errs[key] = max(errs.get(key, 0), max_abs_err(
                got, want, f"OR-Map {label} round {i}"))
            del want
            cur = got
        if checksum(cur) != total:
            raise AssertionError(f"OR-Map {label}: the replay differs from "
                                 "the counted run")
        del cur, got
        torch.cuda.empty_cache()
        bound_ms, bound_by, nbytes = ormap_bounds(R, E, W, gathered)
        per = sched_ms / len(partners)
        report[label] = {"rounds": len(partners), "kernel": key,
                         "wrapper": wrapper, "launches": launched,
                         "schedule_ms": sched_ms, "ms_per_round": per,
                         "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"OR-Map {label}: {len(partners)} rounds ({key} {wrapper} "
            f"for the keys), converged, schedule {sched_ms:.3f} ms, "
            f"{per:.4f} ms/round against a bound of {bound_ms:.4f} ms "
            f"({bound_by}, {nbytes / 1e9:.3f} GB) -> {bound_ms / per:.1%}; "
            f"every round bitwise equal to lattices.gossip_round(ormap_join)"
            f" on the plain versions ({time.perf_counter() - t1:.1f} s) "
            f"[{smi}]")
    perm = gossip.butterfly_perm(R, 3, "cuda")
    got = lattices.gossip_round(lattices.ormap_join, state, perm)
    want = lattices.gossip_round(plain_join, state, perm)
    errs["K2"] = max(errs.get("K2", 0), max_abs_err(
        got, want, "ormap_join on K2"))
    del got, want, state
    torch.cuda.empty_cache()
    log("OR-Map: ormap_join on K2 (merge_pairwise_rows) bitwise equal to "
        "its plain version at the fleet's width")
    timings["ormap"] = report


def phase_config2(timings: dict, smi: str):
    """BASELINE config 2 on the card: the GCounter fleet through its
    dissemination ring rounds (``lattices.gossip_round(gcounter_join,
    ...)``), every round bitwise equal to the same rounds on the CPU,
    converged; passes of the schedule timed, merges a second."""
    import torch

    from go_crdt_playground_tpu_torch.ops import lattices
    from go_crdt_playground_tpu_torch.parallel import gossip

    R, A = CONFIG2_R, CONFIG2_A
    offsets = gossip.dissemination_offsets(R)
    perms = [gossip.ring_perm(R, o, "cuda") for o in offsets]

    def schedule(st, rounds):
        for p in rounds:
            st = lattices.gossip_round(lattices.gcounter_join, st, p)
        return st

    state = config2_state(R, A, "cuda")
    got, want = state, config2_state(R, A, "cpu")
    for p in perms:
        got = schedule(got, [p])
        want = schedule(want, [p.cpu()])
        for g, w in zip(got, want):
            if not torch.equal(g.cpu(), w):
                raise AssertionError("config 2: a round differs from the "
                                     "CPU's")
    if not bool((got.counts == got.counts[:1]).all()):
        raise AssertionError("config 2: the fleet did not converge")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(CONFIG2_PASSES):
        out = schedule(state, perms)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del out
    n = CONFIG2_PASSES * len(offsets)
    per_ms = start.elapsed_time(end) / n
    rate = R / (per_ms / 1e3)
    timings["config2"] = {"replicas": R, "actors": A, "rounds": n,
                          "ms_per_round": per_ms,
                          "host_ms_per_round": wall * 1e3 / n,
                          "merges_per_s": rate}
    log(f"config 2: GCounter {R} replicas x {A} actors, {len(offsets)} "
        f"dissemination rounds converged and bitwise equal to the CPU's; "
        f"{n} rounds timed: {per_ms:.4f} ms/round (CUDA events), "
        f"{wall * 1e3 / n:.4f} host, {rate:.1f} merges/s [{smi}]")


def phase_wide_actors(errs: dict, timings: dict, smi: str):
    """Every entry past the 2,048 actors the kernels once refused, each
    bitwise against its plain version and one launch timed: K1, K2, K4
    (three modes), K6 and K8 (three modes) at WIDE_A; K7 and K9 (three
    modes) at WIDE_DOT_A; K10 at WIDE_INGEST_A on one block and on the
    cooperative grid, and at A = 16 beside A = 60,000.  Then the entry
    points at A = 2,049 on the card: the gossip rounds, the convergence
    loop and a ``Node``'s ``ingest_batch``."""
    import torch

    from go_crdt_playground_tpu_torch.models import packed
    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd
    from go_crdt_playground_tpu_torch.ops import cuda_ingest as ci
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm
    from go_crdt_playground_tpu_torch.parallel import collectives, gossip

    rng = np.random.default_rng(2049)
    modes = [("v2", True), ("reference", True), ("reference", False)]
    wide = {}
    t0 = time.perf_counter()

    def timed(key, what, A, call):
        """ms a call (CUDA events around the wrapper, the host's launch
        included) and the device's µs a call (queued_device_ms)."""
        ms = cuda_time_ms(lambda: call("cuda"), 3)
        dev = queued_device_ms(lambda: call("cuda"), WIDE_QUEUED)
        wide.setdefault(key, {}).setdefault(what, {})[A] = {
            "ms": ms, "device_us": dev * 1e3}

    def held(key, what, A, call):
        got, want = call("cuda"), call("torch")
        errs[key] = max(errs.get(key, 0), max_abs_err(
            got, want, f"{what} A={A}"))
        del got, want
        timed(key, what, A, call)

    for A in WIDE_A:
        st = random_delta_state(rng, WIDE_R, WIDE_E, A, 0x7FFFFFFB, "cuda")
        full = st.base()
        other = random_delta_state(rng, WIDE_R, WIDE_E, A, 0x7FFFFFFB,
                                   "cuda").base()
        perm = torch.from_numpy(rng.permutation(WIDE_R)).cuda()
        bits, dbits = packed.pack_awset(full), packed.pack_awset_delta(st)
        held("K1", "ring_round_rows", A,
             lambda k: cm.ring_round_rows(full, 65, kernel=k))
        held("K2", "gossip_round_rows", A,
             lambda k: cm.gossip_round_rows(full, perm, kernel=k))
        held("K2", "merge_pairwise_rows", A,
             lambda k: cm.merge_pairwise_rows(full, other, kernel=k))
        held("K6", "ring_round_rows_packed", A,
             lambda k: cm.ring_round_rows_packed(bits, 65, kernel=k))
        for sem, strict in modes:
            kw = dict(delta_semantics=sem, strict_reference_semantics=strict)
            tag = "" if sem == "v2" else f" {sem}{'' if strict else ' loose'}"
            held("K4", "delta_ring_round" + tag, A,
                 lambda k: cd.delta_ring_round(st, 65, kernel=k, **kw))
            held("K8", "delta_ring_round_packed" + tag, A,
                 lambda k: cd.delta_ring_round_packed(dbits, 65, kernel=k,
                                                      **kw))
    for A in WIDE_DOT_A:
        st = random_delta_state(rng, WIDE_R, WIDE_E, A, 0, "cuda")
        dots = packed.pack_awset_dots(st.base())
        ddots = packed.pack_awset_delta_dots(st)
        held("K7", "ring_round_rows_dotpacked", A,
             lambda k: cm.ring_round_rows_dotpacked(dots, 65, kernel=k))
        for sem, strict in modes:
            kw = dict(delta_semantics=sem, strict_reference_semantics=strict)
            tag = "" if sem == "v2" else f" {sem}{'' if strict else ' loose'}"
            for off in (1, 65):
                held("K9", f"delta_ring_round_dotpacked offset {off}" + tag,
                     A, lambda k: cd.delta_ring_round_dotpacked(
                         ddots, off, kernel=k, **kw))
    try:
        cm.check_state(ddots._replace(
            vv=torch.zeros((WIDE_R, packed.DOT_MAX_ACTORS + 1),
                           dtype=torch.int32, device="cuda"),
            processed=torch.zeros((WIDE_R, packed.DOT_MAX_ACTORS + 1),
                                  dtype=torch.int32, device="cuda")))
    except ValueError:
        pass
    else:
        raise AssertionError("a dot-word state with A = 4,097 passed")

    def k10(row, E, B):
        add = torch.from_numpy(rng.random((B, E)) < 0.1).cuda()
        dl = torch.from_numpy(rng.random((B, E)) < 0.05).cuda()
        live = torch.from_numpy(np.arange(B) % 5 != 3).cuda()
        return lambda k: ci.ingest_rows_delta_fused(
            row, add, dl, live, k_changed=128, k_deleted=128, kernel=k)

    for A in (16,) + WIDE_INGEST_A:
        for E in WIDE_INGEST_E:
            if A == 16 and E != WIDE_INGEST_E[0]:
                continue
            row = ingest_slice(rng, E, A, 0x7FFFFFFB, 0xFFFFFFF0, False,
                               "cuda")
            call = k10(row, E, WIDE_INGEST_B)
            got, want = call("cuda"), call("torch")
            for part in range(3):
                errs["K10"] = max(errs.get("K10", 0), max_abs_err(
                    got[part], want[part], f"K10 E={E} A={A} part {part}"))
            del got, want
            timed("K10", f"ingest_rows_delta_fused E={E} B={WIDE_INGEST_B}",
                  A, call)

    # the entry points at A = 2,049 on the card, against the plain rounds
    A = WIDE_A[0]
    st = random_delta_state(rng, WIDE_R, 64, A, 5, "cuda")
    full = st.base()
    perm = gossip.ring_perm(WIDE_R, 3, "cuda")
    for what, got, want in (
            ("ring_gossip_round", gossip.ring_gossip_round(full, 1),
             gossip.ring_gossip_round(full, 1, kernel="torch")),
            ("gossip_round", gossip.gossip_round(full, perm),
             gossip.gossip_round(full, perm, kernel="torch")),
            ("delta_ring_gossip_round", gossip.delta_ring_gossip_round(st, 1),
             gossip.delta_ring_gossip_round(st, 1, kernel="torch")),
            ("delta_gossip_round", gossip.delta_gossip_round(st, perm),
             gossip.delta_gossip_round(st, perm, kernel="torch"))):
        max_abs_err(got, want, f"{what} at A={A}")
    rounds, out = gossip.rounds_to_convergence(full)
    if not bool(collectives.converged(out.present, out.vv)):
        raise AssertionError("rounds_to_convergence at A = 2,049 did not "
                             "converge")
    E = 256
    gpu, cpu = (Node(0, E, A, device=d) for d in ("cuda", "cpu"))
    cpu._fused_regime = (ci.ingest_rows_delta_fused, min(128, E))
    before = ci.ingest_rows_delta_fused.launches
    for i in range(4):
        add = rng.random((8, E)) < 0.05
        dl = rng.random((8, E)) < 0.02
        for node in (gpu, cpu):
            node.ingest_batch(add, dl, np.ones(8, bool))
    if ci.ingest_rows_delta_fused.launches != before + 4:
        raise AssertionError("Node.ingest_batch at A = 2,049: K10 not "
                             "launched once a batch")
    for g, c in zip(gpu.state_slice(), cpu.state_slice()):
        if not torch.equal(g.cpu(), c):
            raise AssertionError("Node.ingest_batch at A = 2,049 differs "
                                 "from the CPU node")
    for node in (gpu, cpu):
        node.close()
    torch.cuda.synchronize()
    timings["wide"] = wide
    for key in sorted(wide, key=lambda k: int(k[1:])):
        for what, by_a in wide[key].items():
            log(f"  wide {key} {what}: " + ", ".join(
                f"A={a} {t['ms']:.4f} ms (device {t['device_us']:.3f} µs)"
                for a, t in by_a.items()))
    log(f"wide actors: K1, K2, K4, K6, K8 at A in {WIDE_A}, K7, K9 at "
        f"{WIDE_DOT_A}, K10 at {WIDE_INGEST_A} (E in {WIDE_INGEST_E}) "
        "bitwise equal to their plain versions, a dot-word state at A = "
        "4,097 refused; at A = 2,049 the gossip rounds, "
        f"rounds_to_convergence ({rounds} rounds) and Node.ingest_batch"
        f" return on the card ({time.perf_counter() - t0:.1f} s) [{smi}]")


def phase_lattices(counters: Counters, errs: dict, timings: dict, smi: str):
    phase_ormap_fleet(counters, errs, timings, smi)
    phase_config2(timings, smi)
    phase_wide_actors(errs, timings, smi)


# the bridge's kernels: the path that calls them (phase 14)
BRIDGE_PATHS = {
    "K3": "Merger bridge full-state merges (bridge/service.execute_merge -> "
          "ops/merge.merge_one_into), the scenario verb; phase 8's gossip "
          "verb fleet besides",
    "K5": "Merger bridge δ merges (bridge/service.execute_merge -> "
          "ops/delta.delta_merge_one_into, [dst; src] with perm [1, 1])",
}
BRIDGE_WRAPPERS = {"K3": "merge_pairwise", "K5": "delta_gossip_round"}
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
    ("K10", "ingest_rows_delta_fused + ingest_slot_rows", "csrc/ingest.cu",
     "pallas_ingest.py:165", ("ingest_rows_delta_fused", "ingest_slot_rows")),
    ("K11", "lane_fingerprints + state_group_digests", "csrc/digest.cu",
     "pallas_digest.py:64", ("lane_fingerprints", "state_group_digests")),
]


# ---------------------------------------------------------------------------
# phase 16: the static gate, the differential soak and the examples
# ---------------------------------------------------------------------------

# the soak's time on the card (minutes): half a minute since the fault
# soaks joined (phase 17), to keep the script within its budget; every
# kernel the soak covers still launches in each iteration
SOAK_MINUTES = 0.5
# the examples a switching user runs first, each printing "OK"
EXAMPLES = ("examples/torch_quickstart.py", "examples/torch_tcp_sync.py")


def phase_static_gate(counters: Counters, smi: str) -> dict:
    """16a: the port's analysis gate in full on cuda, in process (the
    CLI's ``main``), to a temporary report; exit 0, 0 errors, every
    registered pass reported, K2 and K10 launched by its runtime
    passes."""
    from go_crdt_playground_tpu_torch.analysis import __main__ as gate

    tmp = tempfile.mkdtemp(prefix="chip_smoke_gate_")
    try:
        out = os.path.join(tmp, "report.json")
        counters.reset()
        t0 = time.perf_counter()
        rc = gate.main(["--device", "cuda", "--json", "--out", out])
        wall = time.perf_counter() - t0
        counters.read("static gate", at_least={
            "merge_pairwise_rows": 1, "ingest_rows_delta_fused": 1})
        with open(out) as f:
            report = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    passes = sorted(report["passes"])
    if rc != 0 or report["n_errors"] or not report["ok"]:
        raise AssertionError(f"static gate: rc {rc}, "
                             f"{report['n_errors']} errors")
    if passes != sorted(gate.REGISTERED_PASSES):
        raise AssertionError(f"static gate reported passes {passes}")
    models = report["passes"]["protomodel"]["stats"]["models"]
    laws = report["passes"]["lattice_laws"]["stats"]["per_family"]
    locksets = report["passes"]["locksets"]["stats"]
    log(f"static gate (cuda, full): rc 0, {report['n_findings']} "
        f"findings, 0 errors, {len(passes)} passes, wall {wall:.2f} s "
        f"(report meta {report['meta']['wall_time_s']} s); models: "
        + ", ".join(f"{n} {m['states']} states / {m['transitions']} "
                    "transitions" for n, m in sorted(models.items()))
        + f"; laws checked {sum(laws.values())} over {len(laws)} joins; "
        f"lockset races {locksets['races']} [{smi}]")
    return {"wall_s": wall, "models": models}


def phase_soak_differential(counters: Counters, smi: str) -> dict:
    """16b: tools/torch_soak_differential.py in process for
    SOAK_MINUTES on the card; every kernel it covers launched, no
    divergence."""
    soak = load_tool("torch_soak_differential")
    counters.reset()
    res = soak.run(SOAK_MINUTES, device="cuda", log=lambda m: None)
    counts = counters.read("differential soak", at_least={
        w: 1 for w in ("ring_round_rows", "gossip_round_rows",
                       "delta_ring_round", "delta_gossip_round",
                       "ring_round_rows_packed",
                       "ring_round_rows_dotpacked",
                       "delta_ring_round_packed",
                       "delta_ring_round_dotpacked")})
    if res["divergence"] is not None:
        raise AssertionError(f"differential soak diverged: "
                             f"{res['divergence']}")
    if res["iterations"] < 1:
        raise AssertionError("differential soak ran no iteration")
    log(f"differential soak (cuda, {SOAK_MINUTES} min): "
        f"{res['iterations']} iterations, seeds {res['seeds'][0]}.."
        f"{res['seeds'][1]}, R {res['R']}, E {res['E']}, A {res['A']} "
        f"(K5's split rows: R {res['k5_R']}, E {res['k5_E']}), "
        f"kernels {', '.join(res['kernels'])} bitwise against their "
        f"plain versions, 0 divergences, {res['wall_s']} s; launches "
        + json.dumps({k: v for k, v in counts.items() if v})
        + f" [{smi}]")
    return res


def phase_examples(smi: str) -> dict:
    """16c: both examples as a user runs them, on the card (their
    default device); each must exit 0 and print OK."""
    root = os.path.dirname(os.path.abspath(__file__))
    walls = {}
    t0 = time.perf_counter()
    # both at once, each in a session of its own
    procs = {ex: subprocess.Popen(
        [sys.executable, os.path.join(root, ex)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=root, start_new_session=True)
        for ex in EXAMPLES}
    try:
        for ex, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            walls[ex] = time.perf_counter() - t0
            last = out.strip().splitlines()[-1:] or [""]
            if proc.returncode != 0 or not last[0].endswith("OK"):
                raise AssertionError(f"{ex} failed (rc {proc.returncode}):"
                                     f" {out[-2000:]} {err[-2000:]}")
            log(f"example {ex}: {last[0]} ({walls[ex]:.1f} s wall since "
                f"both started) [{smi}]")
    finally:
        for proc in procs.values():
            kill_group(proc)
    return walls


def phase_tools(counters: Counters, smi: str) -> None:
    walls = {}
    timed_phase(walls, "16a", phase_static_gate, counters, smi)
    timed_phase(walls, "16b", phase_soak_differential, counters, smi)
    timed_phase(walls, "16c", phase_examples, smi)


# ---------------------------------------------------------------------------
# phase 17: the fault soaks on the card
# ---------------------------------------------------------------------------

# the restart leg's durable dir: tools/torch_crash_soak.py --quick's node
# shape, acked adds before and after its one checkpoint
RESTART_NODES, RESTART_ELEMENTS = 3, 24
RESTART_CHECKPOINTED, RESTART_TAIL = (0, 1, 2), (3, 4)


def crash_sweep_checks(art: dict) -> list:
    """17a's verdict on the crash soak's artifact: each check that fails,
    by name.  The tool's own exit rule, and no unexpected worker exit (a
    worker dead of a CUDA fault and respawned must not pass)."""
    curve = art["curve"]
    faulted = [e for e in curve if e["kill_rate"] > 0]
    modes = art["wal_record_modes"]
    checks = {
        "converged": all(e["converged_runs"] == e["seeds"] for e in curve),
        "delta_loss": all(e["delta_loss_violations"] == 0 for e in curve),
        "kills": bool(faulted) and all(e["kills"] > 0 for e in faulted),
        "fallback": any(e["corruption_injected"]
                        and e["restore_counters"].get("restore.fallbacks",
                                                      0) > 0
                        for e in faulted),
        "compact_records": modes.get("wal.compact_records", 0) > 0,
        "dense_records": modes.get("wal.dense_records", 0) > 0,
        "replays": (modes.get("wal.replayed_compact", 0)
                    + modes.get("wal.replayed_dense", 0)) > 0,
        "races": art.get("race_detection", {}).get("races") == [],
        "unexpected_exits": all(e["unexpected_exits"] == 0 for e in curve),
    }
    return [name for name, ok in checks.items() if not ok]


def first_status(proc, status_path: str, what: str) -> dict:
    """Poll for ``status.json`` written by ``proc``; fails if the worker
    exits or two minutes pass first."""
    t0 = time.perf_counter()
    while True:
        try:
            with open(status_path) as f:
                st = json.load(f)
            if st["pid"] == proc.pid:
                return st
        except (OSError, ValueError):
            pass
        if proc.poll() is not None:
            raise AssertionError(f"{what}: worker exited rc "
                                 f"{proc.returncode}")
        if time.perf_counter() - t0 > 120:
            raise AssertionError(f"{what}: no status in 120 s")
        time.sleep(0.005)


def stop_worker(proc) -> None:
    """SIGTERM a worker, then kill its group (a worker and a spare start
    in a session of their own)."""
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        pass
    kill_group(proc)


def restart_seconds(device: str = "cuda") -> dict:
    """A crash-soak worker restarted on a durable dir that holds a
    checkpoint and a WAL tail (RESTART_CHECKPOINTED in generation 1,
    RESTART_TAIL after it, all acked): seconds to the restored
    incarnation's first ``status.json`` from the spawn of a fresh
    process (``cold_s``) and from the hand-off to a warm spare
    (``spare_s``, how the soak restarts).  Each status must show the
    checkpoint's generation, the tail replayed, every acked add a member
    and none lost."""
    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.utils.checkpoint import CheckpointStore

    soak = load_tool("torch_crash_soak")
    root = tempfile.mkdtemp(prefix="chip_smoke_restart_")
    d = os.path.join(root, "node-0")
    procs = []
    out = {}
    try:
        node = Node.restore_durable(
            d, device=device, fallback_init=lambda: Node(
                0, RESTART_ELEMENTS, RESTART_NODES, device=device))
        for e in RESTART_CHECKPOINTED:
            node.add(e)
        node.save_durable(CheckpointStore(d))
        for e in RESTART_TAIL:
            node.add(e)
        node.wal.close()
        node.close()
        acked = [*RESTART_CHECKPOINTED, *RESTART_TAIL]
        with open(os.path.join(d, "progress.txt"), "w") as f:
            f.writelines(f"{e}\n" for e in acked)
        snapshot = os.path.join(root, "snapshot")
        shutil.copytree(d, snapshot)
        argv = soak.worker_argv(d, 0, RESTART_NODES, RESTART_ELEMENTS,
                                soak._free_port(), "", device)
        spare = subprocess.Popen(
            soak.spare_argv(root, RESTART_NODES, RESTART_ELEMENTS, device),
            stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
            start_new_session=True)
        procs.append(spare)
        t0 = time.perf_counter()
        cold = subprocess.Popen(argv, stdout=subprocess.DEVNULL,
                                start_new_session=True)
        procs.append(cold)
        out["cold"] = first_status(cold, os.path.join(d, "status.json"),
                                   "cold restart")
        out["cold_s"] = time.perf_counter() - t0
        stop_worker(cold)
        shutil.rmtree(d)
        shutil.copytree(snapshot, d)
        while not soak.spare_ready(root, spare.pid):
            if spare.poll() is not None or time.perf_counter() - t0 > 120:
                raise AssertionError("restart: the spare never got warm")
            time.sleep(0.01)
        t0 = time.perf_counter()
        spare.stdin.write((json.dumps(argv[2:]) + "\n").encode())
        spare.stdin.close()
        out["spare"] = first_status(spare, os.path.join(d, "status.json"),
                                    "spare restart")
        out["spare_s"] = time.perf_counter() - t0
    finally:
        for proc in procs:
            stop_worker(proc)
        shutil.rmtree(root, ignore_errors=True)
    for key in ("cold", "spare"):
        st = out[key]
        if (st["generation"] < 1
                or st["counters"].get("wal.records", 0) != len(RESTART_TAIL)
                or st["lost_acks"] or not set(acked) <= set(st["members"])):
            raise AssertionError(f"restart ({key}): restored incarnation "
                                 f"{st}")
    return {"cold_s": out["cold_s"], "spare_s": out["spare_s"],
            "replayed": len(RESTART_TAIL)}


def phase_crash_soak(smi: str) -> dict:
    """17a: tools/torch_crash_soak.py --quick --device cuda --detect-races
    (3 CUDA worker processes, SIGKILLs, storage faults, restarts): every
    check of crash_sweep_checks; then one restart timed."""
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tools", "torch_crash_soak.py")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_crash_")
    try:
        out = os.path.join(tmp, "crash.json")
        t0 = time.perf_counter()
        run = run_tool([tool, "--quick", "--device", "cuda",
                        "--detect-races", "--out", out], 900)
        wall = time.perf_counter() - t0
        if not os.path.exists(out):
            raise AssertionError(f"crash soak failed (rc {run.returncode}):"
                                 f" {run.stdout[-3000:]} "
                                 f"{run.stderr[-3000:]}")
        with open(out) as f:
            art = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    runs = [json.loads(line) for line in run.stdout.splitlines()
            if line.startswith("{")]
    failed = crash_sweep_checks(art)
    if failed or run.returncode != 0:
        raise AssertionError(f"crash soak (rc {run.returncode}): checks "
                             f"failed {failed}: " + json.dumps(art))
    restart = restart_seconds()
    for e in art["curve"]:
        walls = [(r["elapsed_s"], r["start_s"]) for r in runs
                 if r["kill_rate"] == e["kill_rate"]]
        log(f"crash soak kill rate {e['kill_rate']:g} ({e['seeds']} seed, "
            f"{art['fleet']['nodes']} CUDA workers x "
            f"{art['fleet']['elements']} elements): recovery rounds "
            f"{e['recovery_rounds_median']}, kills {e['kills']}, unexpected "
            f"exits {e['unexpected_exits']}, δ-loss violations "
            f"{e['delta_loss_violations']}, storage faults "
            f"{json.dumps(e['storage_faults'])}, restore counters "
            f"{json.dumps(e['restore_counters'])}, run wall (and the "
            f"spares' start) {walls} s [{smi}]")
    log(f"crash soak (--quick --detect-races, cuda): converged at every "
        f"rate, WAL record modes {json.dumps(art['wal_record_modes'])}, "
        f"races {art['race_detection']['races']}, artifact device "
        f"{art['device']!r}, tool wall {wall:.1f} s; one restart (gen 1 + "
        f"{restart['replayed']} WAL records) {restart['cold_s']:.3f} s from "
        f"the spawn of a fresh process to its first status, "
        f"{restart['spare_s']:.3f} s from the hand-off to a warm spare "
        f"[{smi}]")
    return {"wall_s": wall, "restart": restart, "curve": art["curve"]}


def phase_chaos_soak(counters: Counters, smi: str) -> dict:
    """17b: tools/torch_chaos_soak.py on CUDA nodes, in process: the
    severity curve (--quick --detect-races), converged at each severity
    with no race; then the digest chaos leg at its full fleet (6 x 60),
    converged with the fault census equal to SYNC_CURVE.json's and K11
    launched."""
    soak = load_tool("torch_chaos_soak")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
    try:
        curve_out = os.path.join(tmp, "curve.json")
        t0 = time.perf_counter()
        rc = soak.main(["--quick", "--device", "cuda", "--detect-races",
                        "--out", curve_out])
        curve_wall = time.perf_counter() - t0
        with open(curve_out) as f:
            art = json.load(f)
        leg_out = os.path.join(tmp, "leg.json")
        counters.reset()
        t0 = time.perf_counter()
        leg_rc = soak.main(["--chaos-leg", "--device", "cuda",
                            "--out", leg_out])
        leg_wall = time.perf_counter() - t0
        counts = counters.read("digest chaos leg",
                               at_least={"state_group_digests": 1})
        with open(leg_out) as f:
            leg = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = [e for e in art["curve"]
           if e["converged_runs"] != e["seeds"] or e["races"]]
    if rc != 0 or bad or art["race_detection"]["races"]:
        raise AssertionError(f"severity curve (rc {rc}): " + json.dumps(art))
    if leg_rc != 0 or not leg["converged"] or leg["census_equal"] is not True:
        raise AssertionError(f"digest chaos leg (rc {leg_rc}): "
                             + json.dumps(leg))
    for e in art["curve"]:
        log(f"chaos severity {e['drop_rate']:g} ({art['fleet']['nodes']} "
            f"CUDA nodes x {art['fleet']['elements']}, detect races): "
            f"rounds {e['rounds_median']}, census "
            f"{json.dumps(e['faults_injected'])}, breaker "
            f"{json.dumps(e['breaker_transitions'])}, retries "
            f"{e['retries']}, races {e['races']} [{smi}]")
    log(f"severity curve wall {curve_wall:.2f} s; digest chaos leg "
        f"(6 x 60, seed 11, severity {leg['severity']}): converged in "
        f"{leg['rounds']} rounds, census equal to SYNC_CURVE.json's "
        f"{json.dumps(leg['faults'])}, {leg['digest_exchanges']} digest "
        f"exchanges, K11 launches {counts['state_group_digests']} "
        f"(lane_fingerprints {counts['lane_fingerprints']}), rounds wall "
        f"{leg['wall_s']} s, leg wall {leg_wall:.2f} s [{smi}]")
    return {"curve_wall_s": curve_wall, "leg_wall_s": leg_wall,
            "leg_rounds": leg["rounds"]}


def phase_process_fleet(smi: str) -> dict:
    """17c: tools/torch_fleet_soak.py --device cuda: 8 CUDA worker
    processes gossiping through lossy proxies hold one union and one vv,
    with at least 10 lost exchanges, 10 cut and 100 proxied
    connections."""
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tools", "torch_fleet_soak.py")
    res = run_checked_tool([tool, "--device", "cuda"], 600, "process fleet")
    if res["failures"] or res["workers"] != 8 or res["lost"] < 10:
        raise AssertionError("process fleet: " + json.dumps(res))
    log(f"process fleet ({res['workers']} CUDA workers x {res['elements']} "
        f"elements, lossy proxies): one union ({len(res['expected'])} "
        f"members) and one vv {res['vv'][0]} on every worker; lost "
        f"exchanges {res['lost']}, cut {res['dropped']} of {res['total']} "
        f"connections; workers up in {res['workers_up_s']} s, soak wall "
        f"{res['wall_s']} s, tool wall {res['tool_wall_s']:.1f} s [{smi}]")
    return res


def phase_fault_soaks(counters: Counters, smi: str) -> None:
    walls = {}
    timed_phase(walls, "17a", phase_crash_soak, smi)
    timed_phase(walls, "17b", phase_chaos_soak, counters, smi)
    timed_phase(walls, "17c", phase_process_fleet, smi)


class ProcessGuard:
    """The parent run's process tree: the run is its descendants'
    subreaper (tools/torch_soak_util.py), so a process that outlives
    its parent is re-parented to it and seen.  ``check`` fails a phase
    that leaves any descendant alive; ``kill`` kills and reaps every one
    on the way out, whatever ended the run."""

    GRACE_S = 20.0

    def __init__(self):
        self.util = load_tool("torch_soak_util")
        self.util.set_subreaper()
        self.checked = 0
        # the checks' own time: in all, and the longest with its phase
        self.seconds = 0.0
        self.longest = (0.0, "")

    def check(self, phase: str) -> None:
        t0 = time.perf_counter()
        alive = self.util.settle(self.GRACE_S)
        took = time.perf_counter() - t0
        self.seconds += took
        self.longest = max(self.longest, (took, phase))
        if alive:
            self.util.kill_tree()
            raise AssertionError(
                f"phase {phase} left {len(alive)} process(es) alive: "
                + "; ".join(f"pid {pid}: {cmd}" for pid, cmd in alive.items()))
        self.checked += 1

    def kill(self) -> None:
        self.util.kill_tree()


# the parent run's guard (main); None in a child mode and when imported
GUARD = None


def timed_phase(walls: dict, name: str, fn, *args):
    """Run one phase, log its wall time, then fail it if it left a
    process alive (``GUARD``)."""
    t0 = time.perf_counter()
    out = fn(*args)
    walls[name] = time.perf_counter() - t0
    log(f"phase {name}: {walls[name]:.1f} s wall")
    if GUARD is not None:
        GUARD.check(name)
    return out


def run_phases(counters, errs: dict, timings: dict) -> str:
    """Every phase in order; returns the card's nvidia-smi line."""
    walls = {}
    smi = timed_phase(walls, "1", phase_environment)
    timed_phase(walls, "2", phase_kernels, errs)
    timed_phase(walls, "2b", phase_ingest_kernel, errs)
    timed_phase(walls, "2c", phase_digest_kernel, errs)
    timed_phase(walls, "2 packed", phase_packed_kernels, errs)
    timed_phase(walls, "3", phase_entry, counters, errs)
    final = timed_phase(walls, "4", phase_fleet, "merge", counters, errs,
                        timings, smi)
    timed_phase(walls, "5", phase_packed_fleet, "merge", final, counters,
                errs, timings, smi)
    del final
    final = timed_phase(walls, "6", phase_fleet, "delta", counters, errs,
                        timings, smi)
    timed_phase(walls, "7", phase_packed_fleet, "delta", final, counters,
                errs, timings, smi)
    del final
    timed_phase(walls, "8", phase_k3, counters, errs, timings, smi)
    timed_phase(walls, "9", phase_cli, counters)
    timed_phase(walls, "10", phase_serve, counters, errs, timings, smi)
    timed_phase(walls, "10b", phase_frontend, counters, smi)
    timed_phase(walls, "10b soak", phase_serve_soak, smi)
    timed_phase(walls, "11a", phase_sync_fleet, counters, smi)
    timed_phase(walls, "11b", phase_digest_read, counters, timings, smi)
    timed_phase(walls, "11c", phase_universe, counters, timings, smi)
    timed_phase(walls, "12a", phase_fleet_serve, counters, smi)
    timed_phase(walls, "12b", phase_fleet_soak, smi)
    timed_phase(walls, "13a", phase_mesh_dryrun, counters)
    timed_phase(walls, "13b", phase_mesh_fleet, counters, smi)
    timed_phase(walls, "13c", phase_multihost, counters)
    timed_phase(walls, "13d", phase_mesh_serve, counters, timings, smi)
    timed_phase(walls, "14", phase_bridge, counters, errs, timings, smi)
    timed_phase(walls, "15", phase_lattices, counters, errs, timings, smi)
    timed_phase(walls, "16", phase_tools, counters, smi)
    timed_phase(walls, "17", phase_fault_soaks, counters, smi)
    log("phase walls: " + json.dumps({k: round(v, 1)
                                      for k, v in walls.items()}))
    return smi


def kernel_entries(counters, errs: dict, timings: dict) -> list:
    """The ``kernels`` line's entries, one per kernel of KERNELS."""
    kernels = []
    for key, name, src, replaces, wrappers in KERNELS:
        launches = sum(counters.main_path[w] for w in wrappers)
        if launches < 1:
            raise AssertionError(f"{key} never launched on the main path")
        entry = {
            "name": f"{key} {name}", "route": "cuda",
            "source": f"go_crdt_playground_tpu_torch/{src}",
            "replaces": f"go_crdt_playground_tpu/ops/{replaces}",
            "launches": launches,
            "max_abs_err": errs[key], "bitwise": errs[key] == 0,
            **timings[key],
            "library_ms": None,
        }
        if key in BRIDGE_PATHS:
            label = "full-state" if key == "K3" else "δ v2"
            timed = timings["bridge"][label]
            entry.update(
                path=BRIDGE_PATHS[key],
                bridge_launches=timings["bridge_launches"][
                    BRIDGE_WRAPPERS[key]],
                bridge_shape=[BRIDGE_TIMED_E, BRIDGE_TIMED_A],
                bridge_ms=timed["kernel_ms"],
                bridge_device_ms=timed["device_ms"],
                bridge_chunks=timed["chunks"],
                bridge_bound_ms=timed["bound_ms"],
                bridge_request_ms=timed["request_ms"])
        for leg in timings["ormap"].values():
            if leg["kernel"] == key:
                entry.update(
                    ormap_path="OR-Map rounds (parallel/gossip.ormap_"
                               "ring_gossip_round / ormap_gossip_round: the "
                               "keys' AWSet round)",
                    ormap_launches=leg["launches"],
                    ormap_ms_per_round=leg["ms_per_round"],
                    ormap_bound_ms=leg["bound_ms"])
        if key in timings["wide"]:
            entry["wide_actor"] = timings["wide"][key]
        if key == "K10":
            # the based entry (crdt_ingest_based) on the mesh node's path
            entry.update(
                mesh_path="lane-sharded node's write path (parallel/"
                          "meshtarget.apply_slot_rows: serve --mesh-devices "
                          "4 and 2x2, phase 13d)",
                mesh_launches=counters.main_path["ingest_slot_rows"],
                mesh_slot=timings["K10 slot"])
        if key == "K2":
            entry["ep_path"] = ("EP ring round (parallel/gossip.ep_ring_"
                                "round_shardmap, phase 13a)")
        kernels.append(entry)
    return kernels


def main() -> int:
    global GUARD
    if len(sys.argv) > 1 and sys.argv[1] == "--multihost-worker":
        multihost_worker(int(sys.argv[2]), sys.argv[3])
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--serve-child":
        return serve_child(sys.argv[2], sys.argv[3:])
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    GUARD = ProcessGuard()
    # one registry of handed-out listener ports for every process the run
    # starts (shard/fleet.py free_ports)
    from go_crdt_playground_tpu_torch.shard.fleet import port_registry
    port_registry()
    try:
        counters = Counters()
        errs, timings = {}, {}
        smi = run_phases(counters, errs, timings)
        kernels = kernel_entries(counters, errs, timings)
        GUARD.check("end")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        log(smi)
        log(f"process checks: {GUARD.checked} in {GUARD.seconds:.3f} s, "
            f"the longest {GUARD.longest[0]:.3f} s (after phase "
            f"{GUARD.longest[1]})")
        log(f"processes: 0 alive after {GUARD.checked - 1} phases "
            f"(checked after each)")
        print(json.dumps({"kernels": kernels}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    finally:
        GUARD.kill()


if __name__ == "__main__":
    sys.exit(main())
