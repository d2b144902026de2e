"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test needs an NVIDIA GPU with nvcc and skips
without one (the CPU suite runs the plain versions against the JAX
package instead).  The file imports the port alone, so it runs on a GPU
machine that has no JAX; ``--noconftest`` skips the suite's conftest,
which pins JAX to the CPU:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from go_crdt_playground_tpu_torch.models import awset_delta

pytestmark = pytest.mark.cuda

MODES = [("v2", True), ("reference", True), ("reference", False)]


def random_state(seed, R, E, A):
    """A δ state from numpy: deletions, re-adds, silent rows, canonical
    zeros on absent lanes, counters straddling 2^31."""
    rng = np.random.default_rng(seed)
    present = rng.random((R, E)) < 0.5
    deleted = rng.random((R, E)) < 0.3
    silent = rng.random(R) < 0.2
    present[silent] = deleted[silent] = False
    base = 0x7FFFFFFB

    def counters(shape, lo):
        return rng.integers(lo, 10, shape).astype(np.uint64)

    vv, proc = counters((R, A), 0), counters((R, A), 0)
    vv[silent] = proc[silent] = 0
    arrays = {
        "vv": np.where(vv > 0, vv + base, 0),
        "present": present,
        "dot_actor": np.where(present, rng.integers(0, A, (R, E)), 0),
        "dot_counter": np.where(present, counters((R, E), 1) + base, 0),
        "actor": rng.integers(0, A, R),
        "deleted": deleted,
        "del_dot_actor": np.where(deleted, rng.integers(0, A, (R, E)), 0),
        "del_dot_counter": np.where(deleted, counters((R, E), 1) + base, 0),
        "processed": np.where(proc > 0, proc + base, 0),
    }
    arrays = {k: v if v.dtype == bool else v.astype(np.uint32)
              for k, v in arrays.items()}
    return awset_delta.from_arrays(arrays, device="cpu")


def _on_gpu(st):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return type(st)(*(x.cuda() for x in st))


@pytest.fixture
def gpu_state():
    return _on_gpu(random_state(61, 70, 300, 8))


@pytest.fixture
def gpu_ring_state():
    """R = 128, inside the packed ring entries' domain; dot counters
    within the dot-word layout's 20-bit cap."""
    st = random_state(67, 128, 300, 8)
    small = st._replace(dot_counter=st.dot_counter & 0xFFFFF,
                        del_dot_counter=st.del_dot_counter & 0xFFFFF)
    return _on_gpu(small)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_merge_kernel_matches_plain(gpu_state):
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm

    full = gpu_state.base()
    for off in (0, 1, 64, 65, 141):
        assert _equal(cm.ring_round_rows(full, off, kernel="cuda"),
                      cm.ring_round_rows(full, off, kernel="torch")), off
    perm = torch.from_numpy(np.random.default_rng(0).permutation(70)).cuda()
    assert _equal(cm.gossip_round_rows(full, perm, kernel="cuda"),
                  cm.gossip_round_rows(full, perm, kernel="torch"))
    other = cm.ring_round_rows(full, 3, kernel="torch")
    assert _equal(cm.merge_pairwise_rows(full, other, kernel="cuda"),
                  cm.merge_pairwise_rows(full, other, kernel="torch"))


@pytest.mark.parametrize("sem,strict", MODES)
def test_delta_kernel_matches_plain(gpu_state, sem, strict):
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd

    kw = dict(delta_semantics=sem, strict_reference_semantics=strict)
    for off in (0, 1, 64, 65, 141):
        assert _equal(cd.delta_ring_round(gpu_state, off, kernel="cuda", **kw),
                      cd.delta_ring_round(gpu_state, off, kernel="torch",
                                          **kw)), off
    perm = torch.from_numpy(np.random.default_rng(1).permutation(70)).cuda()
    assert _equal(cd.delta_gossip_round(gpu_state, perm, kernel="cuda", **kw),
                  cd.delta_gossip_round(gpu_state, perm, kernel="torch", **kw))


def test_k3_kernel_matches_plain(gpu_state):
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm

    full = gpu_state.base()
    perm = torch.from_numpy(np.random.default_rng(2).permutation(70)).cuda()
    assert _equal(cm.gossip_round(full, perm, kernel="cuda"),
                  cm.gossip_round(full, perm, kernel="torch"))
    other = cm.ring_round_rows(full, 5, kernel="torch")
    assert _equal(cm.merge_pairwise(full, other, kernel="cuda"),
                  cm.merge_pairwise(full, other, kernel="torch"))


@pytest.mark.parametrize("layout", ["bits", "dots"])
def test_packed_merge_kernels_match_plain(gpu_ring_state, layout):
    from go_crdt_playground_tpu_torch.models import packed
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm

    full = gpu_ring_state.base()
    if layout == "bits":
        st, fn = packed.pack_awset(full), cm.ring_round_rows_packed
    else:
        st, fn = packed.pack_awset_dots(full), cm.ring_round_rows_dotpacked
    for off in (0, 1, 63, 64, 65, 133):
        assert _equal(fn(st, off, kernel="cuda"),
                      fn(st, off, kernel="torch")), off


@pytest.mark.parametrize("sem,strict", MODES)
@pytest.mark.parametrize("layout", ["bits", "dots"])
def test_packed_delta_kernels_match_plain(gpu_ring_state, layout, sem,
                                          strict):
    from go_crdt_playground_tpu_torch.models import packed
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd

    kw = dict(delta_semantics=sem, strict_reference_semantics=strict)
    if layout == "bits":
        st = packed.pack_awset_delta(gpu_ring_state)
        fn = cd.delta_ring_round_packed
    else:
        st = packed.pack_awset_delta_dots(gpu_ring_state)
        fn = cd.delta_ring_round_dotpacked
    for off in (0, 1, 63, 64, 65, 133):
        assert _equal(fn(st, off, kernel="cuda", **kw),
                      fn(st, off, kernel="torch", **kw)), off


def _dot_state(seed, R, E, A):
    """A δ state within the dot-word layout's caps: actors < 4,096 (A is
    at most 2,048 here), counters of 20 bits."""
    st = random_state(seed, R, E, A)
    return st._replace(dot_counter=st.dot_counter & 0xFFFFF,
                       del_dot_counter=st.del_dot_counter & 0xFFFFF)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")


@pytest.mark.parametrize("sem,strict", MODES)
@pytest.mark.parametrize("R,E,A", [
    (192, 300, 8),      # staged rows, membership rows of 10 words
    (320, 256, 256),    # the north star's row
    (320, 33, 5),       # E and A not multiples of 4: word-wise copies
    (128, 4100, 256),   # wide rows: lanes read from device memory
    (192, 640, 2048)])  # the widest actor axis, staged
def test_k9_cycle_walk_matches_plain(card, R, E, A, sem, strict):
    """K9's cycle walk against its plain version at every kind of cycle
    (whole cycles of 1-16 rows, segments cut from longer ones), on a
    random fleet and on a converged one (every δ empty); the block-per-row
    design it replaced agrees too.  One launch counted per call."""
    from chip_smoke import walk_offsets
    from go_crdt_playground_tpu_torch.models import packed
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd
    from go_crdt_playground_tpu_torch.parallel import gossip

    kw = dict(delta_semantics=sem, strict_reference_semantics=strict)
    full = _dot_state(130 + R + E, R, E, A)
    conv = full
    for off in gossip.dissemination_offsets(R):
        conv = cd.delta_ring_round(conv, off)
    fn = cd.delta_ring_round_dotpacked
    for st, offs in ((full, walk_offsets(R)), (conv, (1, R // 2, R // 4))):
        st = _on_gpu(packed.pack_awset_delta_dots(st))
        for off in offs:
            before = fn.launches
            got = fn(st, off, kernel="cuda", **kw)
            assert fn.launches == before + 1
            want = fn(st, off, kernel="torch", **kw)
            assert _equal(got, want), off
            assert _equal(cd._delta_ring_round_dotpacked_rowwise(
                st, off, **kw), want), off


def _slice(seed, E, A, base):
    """One replica slice with history, its own clock at ``base`` so a
    batch's counters cross 2^31 or wrap at 2^32."""
    st = random_state(seed, 1, E, A)
    row = type(st)(*(x[0] for x in st))
    vv = row.vv.clone()
    vv[int(row.actor)] = base - (1 << 32 if base >= 1 << 31 else 0)
    return row._replace(vv=vv)


def _batch(seed, B, E, density, live):
    rng = np.random.default_rng(seed)
    add = torch.from_numpy(rng.random((B, E)) < density)
    dl = torch.from_numpy(rng.random((B, E)) < density / 2)
    mask = {"all": np.ones(B, bool), "none": np.zeros(B, bool),
            "holes": np.arange(B) % 3 != 1}[live]
    return add, dl, torch.from_numpy(mask)


@pytest.mark.parametrize("E,A", [(1, 5), (72, 5), (1000, 16), (4100, 2048)])
def test_ingest_kernel_matches_plain(E, A):
    from go_crdt_playground_tpu_torch.ops import cuda_ingest as ci

    for i, (B, density, live) in enumerate(
            [(0, 0.0, "all"), (1, 0.15, "all"), (8, 0.9, "holes"),
             (32, 0.15, "all"), (8, 0.15, "none")]):
        base = (0, 0x7FFFFFF0, 0xFFFFFFF0)[i % 3]
        row = _on_gpu(_slice(70 + i, E, A, base))
        add, dl, live_m = (x.cuda() for x in _batch(80 + i, B, E, density,
                                                    live))
        for k in (min(128, E), 0):
            got = ci.ingest_rows_delta_fused(row, add, dl, live_m,
                                             k_changed=k, k_deleted=k,
                                             kernel="cuda")
            want = ci.ingest_rows_delta_fused(row, add, dl, live_m,
                                              k_changed=k, k_deleted=k,
                                              kernel="torch")
            assert (got[2] is None) == (want[2] is None) == (k == 0)
            for g, w in zip(got, want):
                if g is not None:
                    assert _equal(g, w), (E, A, B, k)


@pytest.mark.parametrize("A", [2049, 12289, 60000])
def test_ingest_kernel_takes_a_wide_actor_axis(A):
    """K10 past the default 48 KB of shared memory (A = 12,289 opts in)
    and past the card's limit (A = 60,000 reads the vv from device
    memory), on one block and on the cooperative grid, bitwise."""
    for i, E in enumerate((64, 4097)):
        row = _on_gpu(_slice(90 + i, E, A, 0xFFFFFFF0))
        add, dl, live = (x.cuda() for x in _batch(91 + i, 32, E, 0.1,
                                                  "holes"))
        for k in (0, 128):
            _k10_check(row, add, dl, live, k)


def test_node_on_the_card_matches_the_plain_regime(tmp_path):
    """The same op log through a CUDA node (K10) and a CPU node running
    K10's plain version with the same K: byte-identical WAL records and
    equal states."""
    import os

    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.ops import cuda_ingest as ci
    from go_crdt_playground_tpu_torch.utils.wal import DeltaWal

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    E, A = 256, 16
    gpu = Node(0, E, A, wal=DeltaWal(os.path.join(tmp_path, "g")),
               device="cuda")
    cpu = Node(0, E, A, wal=DeltaWal(os.path.join(tmp_path, "c")),
               device="cpu")
    cpu._fused_regime = (ci.ingest_rows_delta_fused, min(128, E))
    before = ci.ingest_rows_delta_fused.launches
    for i in range(12):
        add, dl, live = _batch(100 + i, 16, E, 0.02 * (1 + i % 4), "holes")
        for n in (gpu, cpu):
            n.ingest_batch(add.numpy(), dl.numpy(), live.numpy())
            n.add(i, 3 * i)
            n.delete(2 * i)
    assert ci.ingest_rows_delta_fused.launches == before + 12
    assert list(gpu.wal.records()) == list(cpu.wal.records())
    assert _equal(tuple(x.cpu() for x in gpu.state_slice()),
                  cpu.state_slice())
    for n in (gpu, cpu):
        n.wal.close()


@pytest.mark.parametrize("E", [1, 65, 1000, 8192])
def test_digest_kernel_matches_plain(E):
    """K11, both entries, on a random slice (deletion dots straddling
    2^31) and the occupancy extremes, at every group size of the chip
    check."""
    from go_crdt_playground_tpu_torch.ops import cuda_digest as cg

    st = _on_gpu(random_state(120 + E, 1, E, 8))
    row = type(st)(*(x[0] for x in st))
    yes, no = torch.ones_like(row.present), torch.zeros_like(row.present)
    for r in (row, row._replace(present=yes, deleted=yes),
              row._replace(present=no, deleted=no)):
        assert torch.equal(cg.lane_fingerprints(r, kernel="cuda"),
                           cg.lane_fingerprints(r, kernel="torch"))
        for gs in (1, 3, 8, 16, 32, 48, 64, 128, 256):
            assert torch.equal(cg.state_group_digests(r, gs, kernel="cuda"),
                               cg.state_group_digests(r, gs, kernel="torch")
                               ), gs


def _digest_session(dev_a, dev_b):
    """A node pair on the given devices over a real socket: first
    contact on the ladder, then a digest round and its quiescent
    follow-up at each group size of the protocol's ladder.  Returns the
    exchanges' stats, both final states on the CPU and the K11 launches."""
    from go_crdt_playground_tpu_torch.net.digestsync import (
        ALLOWED_GROUP_SIZES, sync_digest)
    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.ops import cuda_digest as cg

    E, A = 512, 4
    a, b = Node(0, E, A, device=dev_a), Node(1, E, A, device=dev_b)
    a.add(1, 2, 300)
    a.delete(2)
    b.add(5, 400, 511)
    b.delete(400)
    addr = b.serve()
    before = cg.state_group_digests.launches
    try:
        stats = [tuple(a.sync_with(addr))]
        for gs in ALLOWED_GROUP_SIZES:
            a.add(gs)
            b.add(gs + 200)
            stats.append(tuple(sync_digest(a, addr, group_size=gs)))
            stats.append(tuple(sync_digest(a, addr, group_size=gs)))
    finally:
        b.close()
    states = [tuple(x.cpu() for x in n.state_slice()) for n in (a, b)]
    return stats, states, cg.state_group_digests.launches - before


@pytest.mark.parametrize("devices", [("cuda", "cuda"), ("cuda", "cpu"),
                                     ("cpu", "cuda")])
def test_node_pair_on_the_card_matches_a_cpu_pair(devices):
    """Digest sync with CUDA nodes (K11 in every summary) reports the
    exchanges of a CPU pair and ends in the same states."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    stats, states, launches = _digest_session(*devices)
    want_stats, want_states, cpu_launches = _digest_session("cpu", "cpu")
    assert stats == want_stats
    assert all(s[-1] for s in stats[2::2])  # each follow-up is quiescent
    for got, want in zip(states, want_states):
        assert _equal(got, want)
    assert cpu_launches == 0 and launches >= 10


# -- K10 and K11 redesigned: every path against the plain versions ----------

K10_SHAPES = [1, 255, 1024, 4096, 4097, 1 << 20]


def _k10_check(row, add, dl, live, k):
    """The kernel's whole entry against the plain entry, bitwise; with a
    compact form, the one-copy record read against the plain one."""
    from go_crdt_playground_tpu_torch.ops import cuda_ingest as ci
    from go_crdt_playground_tpu_torch._u32 import host, to_host

    before = ci.ingest_rows_delta_fused.launches
    got = ci.ingest_rows_delta_fused(row, add, dl, live, k_changed=k,
                                     k_deleted=k, kernel="cuda")
    assert ci.ingest_rows_delta_fused.launches == before + 1
    want = ci.ingest_rows_delta_fused(row, add, dl, live, k_changed=k,
                                      k_deleted=k, kernel="torch")
    assert (got[2] is None) == (want[2] is None) == (k == 0)
    for g, w in zip(got, want):
        if w is not None:
            assert all(x.dtype == y.dtype and x.shape == y.shape
                       for x, y in zip(g, w))
            assert _equal(g, w)
    if k:
        pre, payload, rec = ci.record_to_host(row.vv, got[1], got[2])
        assert np.array_equal(pre, host(row.vv))
        for g, w in zip(rec, to_host(want[2])):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        if bool(want[2].overflow):
            for g, w in zip(payload, to_host(want[1])):
                assert g.dtype == w.dtype and np.array_equal(g, w)
        else:
            assert payload is got[1]
    return want


@pytest.mark.parametrize("A", [1, 16, 2048])
@pytest.mark.parametrize("E", K10_SHAPES)
def test_k10_whole_entry_matches_plain(E, A):
    """One block (E <= 4,096) and the cooperative grid (E > 4,096), at B
    in {0, 1, 32, 128} and K in {0, 128}, sparse and dense batches, own
    clocks whose counters cross 2^31 and wrap 2^32."""
    for i, B in enumerate((0, 1, 32, 128)):
        base = (0x7FFFFFF0, 0xFFFFFFF0, 0)[(i + A) % 3]
        row = _on_gpu(_slice(200 + i, E, A, base))
        for density in (min(0.15, 8 / E), 0.15):
            add, dl, live = (x.cuda() for x in _batch(
                300 + i, B, E, density, "holes"))
            for k in (0, 128):
                _k10_check(row, add, dl, live, k)


@pytest.mark.parametrize("E", [4096, 1 << 20])
def test_k10_delta_overflowing_k(E):
    """A δ of more lanes than K: the first K of each section, overflow
    set, src_vv and src_processed zeroed, as the plain compaction."""
    row = _on_gpu(_slice(400, E, 16, 0xFFFFFFF0))
    add, dl, live = (x.cuda() for x in _batch(401, 4, E, 0.5, "all"))
    want = _k10_check(row, add, dl, live, 128)
    assert bool(want[2].overflow)


def test_k10_misaligned_lanes_and_rows():
    """A slice and a batch that start one byte or one lane into their
    tensors take the word loads."""
    E, A, B = 1023, 16, 8
    st = _on_gpu(_slice(410, E + 1, A, 0x7FFFFFF8))
    row = st._replace(**{n: getattr(st, n)[1:] for n in (
        "present", "dot_actor", "dot_counter", "deleted", "del_dot_actor",
        "del_dot_counter")})
    add, dl, live = _batch(411, B, E, 0.2, "holes")
    flat = torch.zeros(2 * B * E + 1, dtype=torch.bool)
    flat[1:1 + B * E] = add.reshape(-1)
    flat[1 + B * E:] = dl.reshape(-1)
    flat = flat.cuda()
    _k10_check(row, flat[1:1 + B * E].view(B, E), flat[1 + B * E:].view(B, E),
               live.cuda(), 128)
    for E in (4101, 8192 + 3):
        st = _on_gpu(_slice(412, E, A, 5))
        add, dl, live = (x.cuda() for x in _batch(413, 5, E, 0.01, "all"))
        _k10_check(st, add, dl, live, 128)


@pytest.mark.parametrize("E", [1, 5, 1023, 8192, 1 << 20, (1 << 20) + 3])
def test_k11_vector_paths_match_plain(E):
    """Both K11 entries at every path's group sizes (powers of two to 256,
    others strided), on a slice whose lanes start at lane 0 and one lane
    in (unaligned pointers, word loads), occupancy extremes included."""
    from go_crdt_playground_tpu_torch.ops import cuda_digest as cg

    st = _on_gpu(random_state(500 + E % 89, 1, E + 1, 8))
    lanes = ("present", "dot_actor", "dot_counter", "deleted",
             "del_dot_actor", "del_dot_counter")
    full = type(st)(*(x[0] for x in st))
    yes = torch.ones(E, dtype=torch.bool, device="cuda")
    for off in (0, 1):
        row = full._replace(**{n: getattr(full, n)[off:off + E]
                               for n in lanes})
        for r in (row, row._replace(present=yes, deleted=yes)):
            assert torch.equal(cg.lane_fingerprints(r, kernel="cuda"),
                               cg.lane_fingerprints(r, kernel="torch"))
            for gs in (1, 3, 8, 64, 100, 128, 256, 257):
                before = cg.state_group_digests.launches
                got = cg.state_group_digests(r, gs, kernel="cuda")
                assert cg.state_group_digests.launches == before + 1
                assert torch.equal(
                    got, cg.state_group_digests(r, gs, kernel="torch")), \
                    (E, off, gs)


# -- K3 redesigned: a lean launch, each perm entry checked by the kernel ----

K3_E = [1, 31, 32, 128, 200, 1000]
K3_R = [1, 63, 64, 1000, 4096]


def _k3_pair(seed, R, E, A):
    """Two full-state batches on the card: dst, and a partner batch
    with its own history."""
    dst = _on_gpu(random_state(seed, R, E, A).base())
    src = _on_gpu(random_state(seed + 1, R, E, A).base())
    return dst, src


@pytest.mark.parametrize("R", K3_R)
@pytest.mark.parametrize("E", K3_E)
def test_k3_edges_match_plain(E, R):
    """K3 at the ragged and whole edges of R and E, in gather mode
    (int64 and int32 perms, a random permutation and a many-to-one map)
    and pairwise; A cycles through 1, 16 and the 2,048 cap."""
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm

    A = (1, 16, 2048)[(K3_E.index(E) + K3_R.index(R)) % 3]
    dst, src = _k3_pair(1000 + E + R, R, E, A)
    rng = np.random.default_rng(E * 7 + R)
    before = cm.gossip_round.launches, cm.merge_pairwise.launches
    for perm in (rng.permutation(R), rng.integers(0, R, R)):
        for dtype in (torch.int64, torch.int32):
            p = torch.from_numpy(perm).to(dtype).cuda()
            assert _equal(cm.gossip_round(dst, p, kernel="cuda"),
                          cm.gossip_round(dst, p, kernel="torch")), dtype
    assert _equal(cm.gossip_round(dst, perm, kernel="cuda"),
                  cm.gossip_round(dst, perm, kernel="torch"))  # host perm
    assert _equal(cm.merge_pairwise(dst, src, kernel="cuda"),
                  cm.merge_pairwise(dst, src, kernel="torch"))
    assert (cm.gossip_round.launches - before[0],
            cm.merge_pairwise.launches - before[1]) == (5, 1)


def test_k3_out_of_range_device_perm_raises():
    """A device perm with an entry outside [0, R) fails the launch (the
    kernel's device-side assert) and the next synchronizing call raises.
    The failure poisons the CUDA context, so it runs in a child process;
    a host perm still raises ValueError before anything moves."""
    import subprocess
    import sys
    from pathlib import Path

    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm

    dst, _ = _k3_pair(5, 64, 128, 16)
    with pytest.raises(ValueError, match="must lie in"):
        cm.gossip_round(dst, np.arange(64) + 1)
    script = (
        "import numpy as np, torch\n"
        "from go_crdt_playground_tpu_torch.models import awset\n"
        "from go_crdt_playground_tpu_torch.ops import cuda_merge as cm\n"
        "st = awset.init({R}, {E}, 16, actors=np.arange({R}) % 16,\n"
        "                device='cuda')\n"
        "perm = torch.arange({R}, device='cuda', dtype={dtype})\n"
        "perm[40] = {bad}\n"
        "cm.gossip_round(st, perm)\n"
        "torch.cuda.synchronize()\n"
        "print('no error')\n")
    # many rows and an int64 perm, few wide rows and an int32 perm
    for R, E, dtype, bad in ((4096, 128, "torch.int64", 4096),
                             (64, 1000, "torch.int32", -1)):
        src = script.format(R=R, E=E, dtype=dtype, bad=bad)
        out = subprocess.run([sys.executable, "-c", src], capture_output=True,
                             text=True, timeout=300,
                             cwd=str(Path(__file__).resolve().parent.parent))
        assert out.returncode != 0 and "no error" not in out.stdout, out
        assert "device-side assert" in out.stderr, out.stderr[-2000:]
        assert f"perm[40] = {bad} outside [0, {R})" in out.stdout, out.stdout


def test_cuda_serve_frontend_acks_two_sessions_and_restores(tmp_path):
    """A torch ServeFrontend on the card (every micro-batch one K10
    launch, from the batcher's thread): a burst from two client
    sessions acks, members equal the sessions' set algebra, one launch a
    batch, and the durable dir restores bitwise on the card and on the
    CPU."""
    import threading

    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.ops import cuda_ingest as ci
    from go_crdt_playground_tpu_torch.serve import ServeClient, ServeFrontend

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    E, A = 256, 16
    d = str(tmp_path / "d")
    fe = ServeFrontend(E, A, durable_dir=d, max_batch=8, flush_ms=1.0,
                       device="cuda")
    fe.serve()
    before = ci.ingest_rows_delta_fused.launches
    want = [set(), set()]

    def session(s):
        with ServeClient(fe.addr) as c:
            ops = []
            for i in range(60):
                key = 2 * i + s
                if i % 7 == 6:
                    ops.append(c.submit_async(1, [key - 2]))
                    want[s].discard(key - 2)
                else:
                    ops.append(c.submit_async(0, [key]))
                    want[s].add(key)
            for op in ops:
                op.wait(60.0)

    threads = [threading.Thread(target=session, args=(s,)) for s in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    with ServeClient(fe.addr) as c:
        members, vv = c.members()
    snap = fe.recorder.snapshot()["counters"]
    live = fe.node.state_slice()
    fe.close()
    assert members == sorted(want[0] | want[1])
    assert snap["serve.ops.acked"] == 120 and int(vv[0]) == 120
    assert ci.ingest_rows_delta_fused.launches - before == \
        snap["serve.batches"]
    for dev in ("cuda", "cpu"):
        back = Node.restore_durable(d, device=dev)
        assert _equal(tuple(x.to(dev) for x in live), back.state_slice())
        back.wal.close()


def test_cuda_router_over_cuda_frontends(tmp_path):
    """Three torch ServeFrontends on the card behind a torch ShardRouter:
    a spanning op acks once, the routed members and vv are the ops' set
    algebra, each shard launched K10 once a batch, and each shard's
    replica equals a CPU node fed the sub-stream the ring assigns it."""
    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.ops import cuda_ingest as ci
    from go_crdt_playground_tpu_torch.serve import ServeClient, ServeFrontend
    from go_crdt_playground_tpu_torch.shard.router import ShardRouter

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    E, A = 256, 4
    fes = [ServeFrontend(E, A, actor=i, durable_dir=str(tmp_path / f"s{i}"),
                         max_batch=8, flush_ms=1.0, device="cuda")
           for i in range(3)]
    router = None
    try:
        addrs = {f"s{i}": fe.serve() for i, fe in enumerate(fes)}
        router = ShardRouter(addrs, E, seed=5)
        raddr = router.serve()
        before = ci.ingest_rows_delta_fused.launches
        stream = [(0, list(range(0, 40))), (1, [3, 9, 27]),
                  (0, [9, 100, 200]), (1, [100]), (0, [255, 0])]
        with ServeClient(raddr) as c:
            for kind, keys in stream:
                c.submit_async(kind, keys).wait(60.0)
            members, vv = c.members()
        want = set()
        for kind, keys in stream:
            (want.difference_update if kind else want.update)(keys)
        assert members == sorted(want)
        batches = sum(fe.recorder.snapshot()["counters"]["serve.batches"]
                      for fe in fes)
        assert ci.ingest_rows_delta_fused.launches - before == batches
        owner = router.route()
        for i, fe in enumerate(fes):
            ref = Node(i, E, A, device="cpu")
            for kind, keys in stream:
                mine = [k for k in keys if owner.owner_sid(k) == f"s{i}"]
                if mine:
                    (ref.delete if kind else ref.add)(*mine)
            assert _equal(tuple(x.cpu() for x in fe.node.state_slice()),
                          ref.state_slice())
            assert int(vv[i]) == int(ref.vv()[i])
    finally:
        if router is not None:
            router.close()
        for fe in fes:
            fe.close()


def test_cuda_shard_standby_catches_up_and_promotes(tmp_path):
    """A ShardStandby on the card: digest catch-up (K11) after the
    primary truncated its WAL, a tail, then promotion when the primary
    closes; its whole-universe slice equals restore_durable's."""
    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.ops import cuda_digest
    from go_crdt_playground_tpu_torch.serve import ServeClient, ServeFrontend
    from go_crdt_playground_tpu_torch.shard.fleet import free_port
    from go_crdt_playground_tpu_torch.shard.replica import (POLL_CAUGHT_UP,
                                                            POLL_PROMOTED,
                                                            ShardStandby)

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    E, A = 512, 4
    p_dir = str(tmp_path / "p0")
    fe = ServeFrontend(E, A, durable_dir=p_dir, max_batch=8, flush_ms=1.0,
                       device="cuda", shard_id="s0", shard_epoch=1)
    a0 = fe.serve()
    with ServeClient(a0) as c:
        c.add(*range(0, 300, 3))
        c.delete(*range(0, 90, 9))
    fe.supervisor.checkpoint()
    sfe = ServeFrontend(E, A, durable_dir=str(tmp_path / "sb"), max_batch=8,
                        flush_ms=1.0, device="cuda", shard_id="s0")
    sb = ShardStandby(a0, sfe, sid="s0", standby_id="s0-standby",
                      listen_addr=("127.0.0.1", free_port()),
                      poll_interval_s=0.02, failure_threshold=2, wait_ms=20)
    try:
        before = cuda_digest.state_group_digests.launches
        verdicts = [sb.poll_once(), sb.poll_once()]
        assert POLL_CAUGHT_UP in verdicts, verdicts
        assert cuda_digest.state_group_digests.launches > before
        with ServeClient(a0) as c:
            c.add(400, 401)
        assert sb.poll_once() == "tailed"
        fe.close()
        assert [sb.poll_once(), sb.poll_once()][-1] == POLL_PROMOTED
        universe = np.ones(E, bool)
        for dev in ("cuda", "cpu"):
            back = Node.restore_durable(p_dir, device=dev)
            assert back.extract_slice(universe) == \
                sfe.node.extract_slice(universe)
            back.wal.close()
    finally:
        sb.close()


@pytest.mark.parametrize("E", [65, 1000, 8192])
def test_digest_kernel_lane_base_matches_plain(E):
    """K11 with a lane base (a lane-sharded node's slot hashes global
    ids): both entries equal the plain version, and base 0 is the call
    without one."""
    from go_crdt_playground_tpu_torch.ops import cuda_digest as cg

    st = _on_gpu(random_state(150 + E, 1, E, 8))
    row = type(st)(*(x[0] for x in st))
    for base in (0, E, 7 * 1024, (1 << 31) + 3):
        assert torch.equal(
            cg.lane_fingerprints(row, kernel="cuda", lane_base=base),
            cg.lane_fingerprints(row, kernel="torch", lane_base=base))
        for gs in (1, 48, 64, 256):
            assert torch.equal(
                cg.state_group_digests(row, gs, kernel="cuda",
                                       lane_base=base),
                cg.state_group_digests(row, gs, kernel="torch",
                                       lane_base=base)), (base, gs)
    assert torch.equal(cg.state_group_digests(row, 64, kernel="cuda"),
                       cg.state_group_digests(row, 64, kernel="cuda",
                                              lane_base=0))


def test_per_slot_kernels_on_a_two_slot_card_mesh():
    """The sharded rounds on a 2-slot mesh whose slots share cuda:0:
    K2 (ring and butterfly), K8 and K9 (packed block ring) per slot
    equal the same rounds on their plain versions, and the launches are
    counted per slot."""
    from go_crdt_playground_tpu_torch.models import packed
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm
    from go_crdt_playground_tpu_torch.parallel import gossip
    from go_crdt_playground_tpu_torch.parallel import mesh as mesh_mod

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    m = mesh_mod.make_mesh((2, 1), devices=["cuda:0", "cuda:0"])
    st = random_state(171, 256, 96, 8)
    st = st._replace(dot_counter=st.dot_counter & 0xFFFFF,
                     del_dot_counter=st.del_dot_counter & 0xFFFFF)
    full = mesh_mod.shard_state(_on_gpu(st.base()), m)
    before = cm.merge_pairwise_rows.launches
    for run in (lambda s, k: gossip.ring_round_shardmap(s, m, kernel=k),
                lambda s, k: gossip.butterfly_round_shardmap(s, m, 7,
                                                             kernel=k)):
        assert _equal(mesh_mod.gather_state(run(full, "cuda")),
                      mesh_mod.gather_state(run(full, "torch")))
    assert cm.merge_pairwise_rows.launches == before + 4
    before = cm.gossip_round_rows.launches
    assert _equal(mesh_mod.gather_state(
        gossip.butterfly_round_shardmap(full, m, 2, kernel="cuda")),
        mesh_mod.gather_state(
            gossip.butterfly_round_shardmap(full, m, 2, kernel="torch")))
    assert cm.gossip_round_rows.launches == before + 2
    for pack, fn in ((packed.pack_awset_delta, cd.delta_ring_round_packed),
                     (packed.pack_awset_delta_dots,
                      cd.delta_ring_round_dotpacked)):
        sh = mesh_mod.shard_state(pack(type(st)(*(x.cuda() for x in st))),
                                  m)
        for off in (5, 128):
            before = fn.launches
            got = gossip.packed_block_ring_round_shardmap(sh, m, off,
                                                          kernel="cuda")
            assert fn.launches == before + 2
            want = gossip.packed_block_ring_round_shardmap(sh, m, off,
                                                           kernel="torch")
            assert _equal(mesh_mod.gather_state(got),
                          mesh_mod.gather_state(want)), (fn.__name__, off)


# -- the bridge's one-row merges (K3, K5) at any actor axis -------------------

WIDE_A = [2049, 6145, 8193, 29057]


@pytest.mark.parametrize("A", WIDE_A)
def test_k3_and_k5_take_any_actor_axis(A):
    """Past K3's old 2,048 cap, past the 48 KB of shared memory a launch
    gets without opting in (A = 6,145 for K5) and past the card's opt-in
    limit (A = 29,057: the vv rows from device memory), bitwise to the
    plain versions, on one-row pairs and on the bridge's two-row route."""
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm

    for E in (1, 300):
        st = _on_gpu(random_state(A + E, 2, E, A))
        base = st.base()
        d = type(base)(*(x[:1] for x in base))
        s = type(base)(*(x[1:] for x in base))
        assert _equal(cm.merge_pairwise(d, s, kernel="cuda"),
                      cm.merge_pairwise(d, s, kernel="torch"))
        assert _equal(cm.gossip_round(base, [1, 0], kernel="cuda"),
                      cm.gossip_round(base, [1, 0], kernel="torch"))
        for sem, strict in MODES:
            kw = dict(delta_semantics=sem, strict_reference_semantics=strict)
            assert _equal(cd.delta_gossip_round(st, [1, 1], kernel="cuda",
                                                **kw),
                          cd.delta_gossip_round(st, [1, 1], kernel="torch",
                                                **kw)), (E, sem, strict)
    torch.cuda.synchronize()


@pytest.mark.parametrize("sem,strict", MODES)
def test_one_into_entries_launch_k3_and_k5_once(sem, strict):
    """merge_one_into and delta_merge_one_into on CUDA tensors: one K3 or
    K5 launch each, bitwise to the CPU plain versions."""
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm
    from go_crdt_playground_tpu_torch.ops import delta as delta_ops
    from go_crdt_playground_tpu_torch.ops import merge as merge_ops

    cpu = random_state(77, 5, 200, 6)
    st = _on_gpu(cpu)
    before = cm.merge_pairwise.launches, cd.delta_gossip_round.launches
    for r_dst, r_src in ((0, 1), (3, 2), (4, 4)):
        got, _ = merge_ops.merge_one_into(st.base(), r_dst, st.base(), r_src)
        want, _ = merge_ops.merge_one_into(cpu.base(), r_dst, cpu.base(),
                                           r_src)
        assert _equal(got, type(want)(*(x.cuda() for x in want)))
        got = delta_ops.delta_merge_one_into(st, r_dst, st, r_src, sem,
                                             strict)
        want = delta_ops.delta_merge_one_into(cpu, r_dst, cpu, r_src, sem,
                                              strict)
        assert _equal(got, type(want)(*(x.cuda() for x in want)))
    assert (cm.merge_pairwise.launches - before[0],
            cd.delta_gossip_round.launches - before[1]) == (3, 3)
    with pytest.raises(ValueError, match="no kernel emits"):
        merge_ops.merge_one_into(st.base(), 0, st.base(), 1,
                                 with_trace=True, kernel="cuda")


def test_execute_merge_on_the_card_gives_the_cpu_bytes():
    """The bridge on CUDA and on the CPU: the same reply bytes for seeded
    full-state and δ requests, wide actor axes and an error reply."""
    import random

    from go_crdt_playground_tpu_torch.bridge import convert, messages, service
    from go_crdt_playground_tpu_torch.models import spec

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    rng = random.Random(4)
    for i in range(60):
        delta = i % 2 == 1
        sem = ("reference", "v2")[i % 4 // 2]
        n = 3 if i < 56 else 8193
        reps = [spec.AWSetDelta(actor=a, version_vector=spec.VersionVector(
            [0] * n), delta_semantics=sem) if delta else
            spec.AWSet(actor=a, version_vector=spec.VersionVector([0] * n))
            for a in range(2)]
        for _ in range(rng.randint(0, 12)):
            r = reps[rng.randrange(2)]
            roll = rng.random()
            if roll < 0.5:
                r.add(f"k{rng.randrange(6)}")
            elif roll < 0.7:
                r.del_(f"k{rng.randrange(6)}")
            else:
                r.merge(reps[0] if r is reps[1] else reps[1])
        req = messages.MergeRequest(
            dst=convert.replica_to_proto(reps[0]),
            src=convert.replica_to_proto(reps[1]), delta=delta,
            delta_semantics=sem, strict_reference_semantics=i % 3 == 0)
        if i == 59:
            req.dst.version_vector.append(1 << 32)
        got = service.execute_merge(req, device="cuda").SerializeToString()
        want = service.execute_merge(req, device="cpu").SerializeToString()
        assert got == want, i


# -- wide actor axes and the OR-Map rounds ------------------------------------


@pytest.mark.parametrize("A", [2049, 8193, 29057])
def test_wide_actor_rounds_match_plain(A):
    """K1, K2, K4, K6 and K8 past 2,048 actors: the vv rows in the
    default 48 KB (A = 2,049), opted in (8,193) and in device memory
    (29,057), every δ mode, bitwise; the gossip entry points return."""
    from go_crdt_playground_tpu_torch.models import packed
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm
    from go_crdt_playground_tpu_torch.parallel import collectives, gossip

    st = _on_gpu(random_state(A, 128, 100, A))
    full = st.base()
    other = _on_gpu(random_state(A + 1, 128, 100, A)).base()
    perm = torch.from_numpy(np.random.default_rng(A).permutation(128)).cuda()
    bits, dbits = packed.pack_awset(full), packed.pack_awset_delta(st)
    for off in (1, 65):
        for fn, s in ((cm.ring_round_rows, full),
                      (cm.ring_round_rows_packed, bits)):
            assert _equal(fn(s, off, kernel="cuda"),
                          fn(s, off, kernel="torch"))
        for sem, strict in MODES:
            kw = dict(delta_semantics=sem, strict_reference_semantics=strict)
            for fn, s in ((cd.delta_ring_round, st),
                          (cd.delta_ring_round_packed, dbits)):
                assert _equal(fn(s, off, kernel="cuda", **kw),
                              fn(s, off, kernel="torch", **kw)), (off, kw)
    assert _equal(cm.gossip_round_rows(full, perm, kernel="cuda"),
                  cm.gossip_round_rows(full, perm, kernel="torch"))
    assert _equal(cm.merge_pairwise_rows(full, other, kernel="cuda"),
                  cm.merge_pairwise_rows(full, other, kernel="torch"))
    assert _equal(gossip.ring_gossip_round(full, 3),
                  gossip.ring_gossip_round(full, 3, kernel="torch"))
    assert _equal(gossip.delta_ring_gossip_round(st, 3),
                  gossip.delta_ring_gossip_round(st, 3, kernel="torch"))
    rounds, out = gossip.rounds_to_convergence(st, delta=True)
    assert rounds >= 1 and bool(collectives.converged(out.present, out.vv))


@pytest.mark.parametrize("A", [2049, 4096])
def test_wide_actor_dot_words_match_plain(A):
    """K7 and K9 (the cycle walk, its wide rows at A = 4,096: one warp a
    block, 98 KB opted in) up to the dot word's 4,096 actors."""
    from go_crdt_playground_tpu_torch.models import packed
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm

    st = _on_gpu(random_state(A, 128, 100, A))
    st = st._replace(dot_counter=st.dot_counter & 0xFFFFF,
                     del_dot_counter=st.del_dot_counter & 0xFFFFF)
    dots = packed.pack_awset_dots(st.base())
    ddots = packed.pack_awset_delta_dots(st)
    for off in (0, 1, 64, 65):
        assert _equal(cm.ring_round_rows_dotpacked(dots, off, kernel="cuda"),
                      cm.ring_round_rows_dotpacked(dots, off,
                                                   kernel="torch"))
        for sem, strict in MODES:
            kw = dict(delta_semantics=sem, strict_reference_semantics=strict)
            assert _equal(
                cd.delta_ring_round_dotpacked(ddots, off, kernel="cuda",
                                              **kw),
                cd.delta_ring_round_dotpacked(ddots, off, kernel="torch",
                                              **kw)), (off, kw)


@pytest.mark.parametrize("A", [16, 2049])
def test_ormap_rounds_on_the_kernels(A):
    """The OR-Map rounds with their keys on K1 (ring) and K2 (perm), and
    ``ormap_join`` on K2, against their plain versions."""
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm
    from go_crdt_playground_tpu_torch.ops import lattices as L
    from go_crdt_playground_tpu_torch.parallel import gossip

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    rng = np.random.default_rng(A)
    base = _on_gpu(random_state(A, 128, 100, A)).base()
    cells = [torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (128, 100),
                                           dtype=np.int64)
                              .astype(np.int32)).cuda() for _ in range(3)]
    cells[0] = torch.where(base.present, cells[0] & 7, 0)  # stamp ties
    st = L.ORMapState(*base, *cells)
    perm = torch.from_numpy(rng.permutation(128)).cuda()
    ring0, gather0 = cm.ring_round_rows.launches, \
        cm.gossip_round_rows.launches
    pair0 = cm.merge_pairwise_rows.launches
    for off in (1, 65):
        assert _equal(gossip.ormap_ring_gossip_round(st, off),
                      gossip.ormap_ring_gossip_round(st, off,
                                                     kernel="torch"))
    assert _equal(gossip.ormap_gossip_round(st, perm),
                  L.gossip_round(lambda d, s: L.ormap_join(
                      d, s, kernel="torch"), st, perm))
    assert _equal(L.gossip_round(L.ormap_join, st, perm),
                  gossip.ormap_gossip_round(st, perm, kernel="torch"))
    row = L.ormap_join(L.ORMapState(*(x[3] for x in st)),
                       L.ORMapState(*(x[9] for x in st)))
    want = L.ormap_join(L.ORMapState(*(x[3] for x in st)),
                        L.ORMapState(*(x[9] for x in st)), kernel="torch")
    assert _equal(row, want)
    assert cm.ring_round_rows.launches == ring0 + 2
    assert cm.gossip_round_rows.launches == gather0 + 1
    assert cm.merge_pairwise_rows.launches == pair0 + 2


def test_node_ingests_with_a_wide_actor_axis():
    """``Node.ingest_batch`` at A = 2,049 on the card: K10 once a batch,
    the state equal to a CPU node's fed the same batches."""
    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.ops import cuda_ingest as ci

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    E, A = 256, 2049
    gpu, cpu = Node(0, E, A, device="cuda"), Node(0, E, A, device="cpu")
    cpu._fused_regime = (ci.ingest_rows_delta_fused, min(128, E))
    before = ci.ingest_rows_delta_fused.launches
    for i in range(6):
        add, dl, live = _batch(500 + i, 8, E, 0.05, "holes")
        for n in (gpu, cpu):
            n.ingest_batch(add.numpy(), dl.numpy(), live.numpy())
    assert ci.ingest_rows_delta_fused.launches == before + 6
    assert _equal(tuple(x.cpu() for x in gpu.state_slice()),
                  cpu.state_slice())
    for n in (gpu, cpu):
        n.close()


# -- the port's tools on the card -------------------------------------------


def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "full"])
def test_static_gate_on_cuda(fast, tmp_path):
    """The port's analysis gate on the card: exit 0, 0 errors, all 14
    passes, the lattice laws' AWSet and OR-Map joins on K2 and the
    lockset exercise's batches on K10."""
    import json

    from go_crdt_playground_tpu_torch.analysis import __main__ as gate
    from go_crdt_playground_tpu_torch.ops import cuda_ingest as ci
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm

    _needs_gpu()
    out = tmp_path / "report.json"
    pair0 = cm.merge_pairwise_rows.launches
    ingest0 = ci.ingest_rows_delta_fused.launches
    argv = ["--device", "cuda", "--out", str(out)] + (["--fast"] if fast
                                                      else [])
    assert gate.main(argv) == 0
    report = json.loads(out.read_text())
    assert report["ok"] and report["n_errors"] == 0
    assert sorted(report["passes"]) == sorted(gate.REGISTERED_PASSES)
    assert report["meta"]["device"].startswith("cuda")
    assert cm.merge_pairwise_rows.launches > pair0
    assert ci.ingest_rows_delta_fused.launches > ingest0


def _soak_module():
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).resolve().parent.parent / "tools"
            / "torch_soak_differential.py")
    spec = importlib.util.spec_from_file_location("torch_soak_differential",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed0", [0, 4242])
def test_soak_differential_on_cuda(seed0):
    """A short run of the differential soak on the card: every kernel it
    covers against its plain version, bitwise, at 12 fresh shapes."""
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm

    _needs_gpu()
    soak = _soak_module()
    wrappers = (cm.ring_round_rows, cm.gossip_round_rows,
                cm.ring_round_rows_packed, cm.ring_round_rows_dotpacked,
                cd.delta_ring_round, cd.delta_gossip_round,
                cd.delta_ring_round_packed, cd.delta_ring_round_dotpacked)
    before = [w.launches for w in wrappers]
    res = soak.run(10.0, device="cuda", seed0=seed0, iterations=12,
                   log=lambda m: None)
    assert res["divergence"] is None, res["divergence"]
    assert res["iterations"] == 12
    assert res["kernels"] == list(soak.KERNELS)
    assert all(w.launches > b for w, b in zip(wrappers, before))


@pytest.mark.parametrize("name", ["torch_quickstart.py",
                                  "torch_tcp_sync.py"])
def test_example_runs_on_cuda(name):
    """The examples as a user runs them: default device (the card)."""
    import pathlib
    import subprocess
    import sys

    _needs_gpu()
    repo = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, str(repo / "examples" / name)],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(repo))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
    assert "cuda" in proc.stdout


# -- K4, K5, K8 on few, long rows: the lanes split over blocks ----------------

SPLIT_E = [31, 4097, 65_536, 65_537, 1 << 20]
SPLIT_A = [5, 256, 8193, 29057]


def _scenario_on_gpu(name, R, E, A, seed):
    from go_crdt_playground_tpu_torch import fleet

    _needs_gpu()
    arrays, perm = fleet.delta_scenario(name, R, E, A, seed)
    return (awset_delta.from_arrays(arrays, device="cuda"),
            torch.from_numpy(perm).cuda())


@pytest.mark.parametrize("A", SPLIT_A)
@pytest.mark.parametrize("E", SPLIT_E)
def test_k5_split_rows_match_plain(E, A):
    """K5 at R in {1, 2, 3, 5} on every fleet.delta_scenario (the strict
    skip with an empty δ, its one payload lane in the first or the last
    chunk, first contact, the bridge's [1, 1] pair, mixed histories) in
    the three modes, bitwise to the plain version: rows split over
    blocks from E = 4,097, vv rows in shared memory, opted in (A =
    8,193) and in device memory (A = 29,057)."""
    from go_crdt_playground_tpu_torch import fleet
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd

    for R in (1, 2, 3, 5):
        for name in fleet.DELTA_SCENARIOS:
            st, perm = _scenario_on_gpu(name, R, E, A, seed=R + E + A)
            for sem, strict in MODES:
                kw = dict(delta_semantics=sem,
                          strict_reference_semantics=strict)
                assert _equal(
                    cd.delta_gossip_round(st, perm, kernel="cuda", **kw),
                    cd.delta_gossip_round(st, perm, kernel="torch", **kw)), \
                    (R, name, sem, strict)
    torch.cuda.synchronize()


def test_k4_k8_split_rows_match_plain():
    """K4 and K8 at R = 128, E = 65,537 (five chunks a row on an H100),
    three modes, three ring offsets, mixed, empty and last-chunk-payload
    states, bitwise to the plain versions."""
    from go_crdt_playground_tpu_torch.models import packed
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd

    R, E = 128, 65_537
    for name in ("mixed", "empty", "payload_last"):
        st, _ = _scenario_on_gpu(name, R, E, 8, seed=5)
        assert cd.row_chunks(R, E, cd.sm_count(0)).chunks > 1
        bits = packed.pack_awset_delta(st)
        for sem, strict in MODES:
            kw = dict(delta_semantics=sem, strict_reference_semantics=strict)
            for off in (1, 64, 127):
                assert _equal(
                    cd.delta_ring_round(st, off, kernel="cuda", **kw),
                    cd.delta_ring_round(st, off, kernel="torch", **kw)), \
                    ("K4", name, sem, off)
                assert _equal(
                    cd.delta_ring_round_packed(bits, off, kernel="cuda",
                                               **kw),
                    cd.delta_ring_round_packed(bits, off, kernel="torch",
                                               **kw)), ("K8", name, sem, off)
    torch.cuda.synchronize()


def test_k5_split_rows_raise_on_a_bad_geometry():
    """A geometry that leaves lanes uncovered is refused by the launch and
    raised through the wrapper: no path falls back."""
    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd
    from go_crdt_playground_tpu_torch.ops.cuda_merge import PARTNER_GATHER

    st, perm = _scenario_on_gpu("mixed", 2, 4097, 5, seed=1)
    for mode in cd.MODES:
        with pytest.raises(RuntimeError, match="crdt_delta_round_split"):
            cd._launch(st, perm, 0, PARTNER_GATHER, mode,
                       geom=cd.RowChunks(2, 512))


def test_k5_is_one_kernel_a_call_without_memset():
    """The bridge's pair (R = 2, E = 65,536) split over blocks: each K5
    call is one device kernel (delta_rows_split) in every mode, and no
    memset runs."""
    from torch.profiler import ProfilerActivity, profile

    from go_crdt_playground_tpu_torch.ops import cuda_delta as cd

    st, perm = _scenario_on_gpu("pair", 2, 65_536, 256, seed=3)
    for sem, strict in MODES:
        kw = dict(delta_semantics=sem, strict_reference_semantics=strict)
        cd.delta_gossip_round(st, perm, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                cd.delta_gossip_round(st, perm, **kw)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert sum("delta_rows_split" in n for n in names) == 4, names
        assert not any("delta_rows<" in n or "memset" in n.lower()
                       for n in names), names


def test_k5_from_two_threads_on_their_own_streams():
    """Two threads, each on its own stream, run the bridge's one-pair δ
    merge (strict reference, rows split) at once, 30 times each; every
    result equals the CPU plain version of its own pair."""
    import threading

    from go_crdt_playground_tpu_torch.ops import delta as delta_ops

    _needs_gpu()
    pairs = []
    for seed in (11, 12):
        st, _ = _scenario_on_gpu("mixed", 2, 65_536, 256, seed)
        cpu = type(st)(*(x.cpu() for x in st))
        want = delta_ops.delta_merge_one_into(cpu, 0, cpu, 1, "reference",
                                              True)
        pairs.append((st, type(want)(*(x.cuda() for x in want))))
    errors = []

    def run(st, want):
        stream = torch.cuda.Stream()
        try:
            with torch.cuda.stream(stream):
                for _ in range(30):
                    got = delta_ops.delta_merge_one_into(st, 0, st, 1,
                                                         "reference", True)
                    stream.synchronize()
                    if not _equal(got, want):
                        errors.append("differs")
        except Exception as exc:  # reported on the main thread
            errors.append(repr(exc))

    threads = [threading.Thread(target=run, args=p) for p in pairs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors


# -- elastic recovery on the card ----------------------------------------------


def test_cuda_crash_restore_resync(tmp_path):
    """tests/test_elastic.py's crash-restore-resync scenario on CUDA nodes
    beside CPU nodes driven through the same steps: node 1 checkpointed,
    crashed after one more write, restored on the card from its
    checkpoint and healed by exchanges; every check holds the spec
    world's members and the CPU fleet's members and vv."""
    _needs_gpu()
    from go_crdt_playground_tpu_torch.models.spec import (AWSetDelta,
                                                          VersionVector)
    from go_crdt_playground_tpu_torch.net.peer import Node

    E, A = 16, 3
    specs = [AWSetDelta(actor=i, version_vector=VersionVector([0] * A),
                        delta_semantics="v2") for i in range(A)]
    fleets = {dev: [Node(i, E, A, device=dev) for i in range(A)]
              for dev in ("cuda", "cpu")}
    addrs = {dev: [n.serve() for n in nodes] for dev, nodes in fleets.items()}

    def sync(dst, src):
        for dev, nodes in fleets.items():
            nodes[dst].sync_with(addrs[dev][src])
        specs[src].merge(specs[dst])
        specs[dst].merge(specs[src])

    def check():
        for i, s in enumerate(specs):
            want = sorted(int(k[1:]) for k in s.entries)
            gpu, cpu = fleets["cuda"][i], fleets["cpu"][i]
            if gpu is None:
                continue
            assert gpu.device.type == "cuda"
            assert gpu.members().tolist() == want == cpu.members().tolist()
            assert np.array_equal(gpu.vv(), cpu.vv())

    try:
        for dev, nodes in fleets.items():
            nodes[0].add(1, 2)
            nodes[1].add(3)
            nodes[2].add(4, 5)
        specs[0].add("e1", "e2")
        specs[1].add("e3")
        specs[2].add("e4", "e5")
        sync(0, 1)
        sync(2, 0)
        check()
        cks = {}
        for dev, nodes in fleets.items():
            cks[dev] = nodes[1].save(str(tmp_path / f"node1-{dev}.ckpt"))
            nodes[1].add(6)  # lost in the crash
            nodes[1].close()
            nodes[1] = None
        for dev, nodes in fleets.items():
            nodes[0].delete(2)
            nodes[2].add(7)
        specs[0].del_("e2")
        specs[2].add("e7")
        sync(0, 2)
        check()
        for dev, nodes in fleets.items():
            nodes[1] = Node.restore(cks[dev], device=dev)
            addrs[dev][1] = nodes[1].serve()
            assert nodes[1].members().tolist() == [1, 2, 3]
        for dst, src in ((1, 0), (0, 1), (1, 2), (2, 1), (0, 2)):
            sync(dst, src)
        check()
        gpu = fleets["cuda"]
        for n in gpu[1:]:
            assert np.array_equal(n.members(), gpu[0].members())
            assert np.array_equal(n.vv(), gpu[0].vv())
    finally:
        for nodes in fleets.values():
            for n in nodes:
                if n is not None:
                    n.close()


# -- K10 with the counter bases passed in: the lane-sharded write path -------

BASED_E = [4096, 4097, 1 << 18]
BASED_A = [16, 8193, 60000]


def _based_inputs(seed, E, B, clock):
    """A slot's rows and their live mask (a fifth of them padding, which
    the kernel folds in) and counters whose sums cross 2^31 or wrap 2^32 from ``clock``: each row's
    lanes left of the slot, its pre-row counter, deletion counter and the
    final clock, as int64 (the wrapper reduces them)."""
    rng = np.random.default_rng(seed)
    add, dl, live = _batch(seed, B, E, 0.05, "holes")
    lane_off = np.where(live.numpy(), rng.integers(0, 1 << 20, B), 0)
    steps = ((add & live[:, None]).sum(dim=1).numpy() + lane_off
             + (dl & live[:, None]).any(dim=1).numpy()
             + np.where(live.numpy(), rng.integers(0, 50, B), 0))
    row_base = clock + np.cumsum(steps) - steps
    return (add.cuda(), dl.cuda(), live.cuda(), row_base, lane_off,
            row_base + steps, clock + int(steps.sum()))


@pytest.mark.parametrize("A", BASED_A)
@pytest.mark.parametrize("E", BASED_E)
def test_k10_based_entry_matches_plain(E, A):
    """``crdt_ingest_based`` on one block (E = 4,096) and the cooperative
    grid (4,097 and a 4-slot node's slot at E = 2^20), the vv staged in
    shared memory, opted in past 48 KB and read from device memory (A =
    60,000), at B in {0, 1, 32, 64}, K in {128, 0}, nonzero lane offsets,
    padding rows, counters crossing 2^31 and wrapping 2^32: bitwise, and
    the compact form's one-copy record read."""
    from go_crdt_playground_tpu_torch._u32 import host, to_host
    from go_crdt_playground_tpu_torch.ops import cuda_ingest as ci

    for i, B in enumerate((0, 1, 32, 64)):
        clock = (0x7FFFFFF0, 0xFFFFFFF0, 0xFFFF0000, 7)[i]
        row = _on_gpu(_slice(300 + i, E, A, clock))
        rows = _based_inputs(310 + i, E, B, clock)
        for k in (128, 0):
            before = ci.ingest_slot_rows.launches
            got = ci.ingest_slot_rows(row, *rows, k_changed=k,
                                      k_deleted=k, kernel="cuda")
            assert ci.ingest_slot_rows.launches == before + 1
            want = ci.ingest_slot_rows(row, *rows, k_changed=k,
                                       k_deleted=k, kernel="torch")
            assert (got[2] is None) == (want[2] is None) == (k == 0)
            for g, w in zip(got, want):
                if w is not None:
                    assert all(x.dtype == y.dtype and x.shape == y.shape
                               for x, y in zip(g, w))
                    assert _equal(g, w), (E, A, B, k)
            if k:
                pre, _, rec = ci.record_to_host(row.vv, got[1], got[2])
                assert np.array_equal(pre, host(row.vv))
                for g, w in zip(rec, to_host(want[2])):
                    assert g.dtype == w.dtype and np.array_equal(g, w)


def _disjoint_rows(rng, B, E):
    """Op-rows whose keys no two rows share (the 2-D planner cuts
    nothing), some rows deleting earlier rows' keys."""
    perm = rng.permutation(E)
    add = np.zeros((B, E), bool)
    dl = np.zeros((B, E), bool)
    for b in range(B):
        keys = perm[8 * b:8 * b + 8]
        add[b, keys[:1 + b % 6]] = True
        if b % 3 == 2:
            dl[b, keys[6:]] = True
    return add, dl, np.arange(B) % 7 != 5


def test_mesh_nodes_on_the_card_fold_once_a_slot(tmp_path, monkeypatch):
    """A ``MeshApplyTarget`` on 4 slots of cuda:0 and a
    ``Mesh2DApplyTarget`` on 2 x 2: one ``crdt_ingest_based`` launch a
    slot a batch (a stripe slot a chunk), no plain fold on a CUDA tensor,
    WAL records byte-equal to a one-slot CUDA node's fed the same
    batches (compact; dense past K, where the slots only together claim
    more than K lanes and where one slot alone does, its dense δ then
    pulled with its head and the others' from the device), the states
    equal."""
    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.ops import cuda_ingest as ci
    from go_crdt_playground_tpu_torch.parallel.meshtarget import \
        MeshApplyTarget
    from go_crdt_playground_tpu_torch.parallel.meshtarget2d import \
        Mesh2DApplyTarget
    from go_crdt_playground_tpu_torch.utils.wal import DeltaWal

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    E, A, B = 1 << 15, 16, 32
    plain = []
    fold = ci.ingest_fold_plain
    monkeypatch.setattr(ci, "ingest_fold_plain", lambda st, *a: (
        plain.append(st.vv.device.type), fold(st, *a))[1])
    nodes = {
        "one": Node(0, E, A, device="cuda:0",
                    wal=DeltaWal(str(tmp_path / "one"))),
        "4": MeshApplyTarget(0, E, A, mesh_devices=4, device="cuda:0",
                             wal=DeltaWal(str(tmp_path / "m4"))),
        "2x2": Mesh2DApplyTarget(0, E, A, mesh_shape="2x2",
                                 device="cuda:0",
                                 wal=DeltaWal(str(tmp_path / "m22"))),
    }
    rng = np.random.default_rng(404)
    n_batches = 7
    # past K = 128: 200 claimed lanes over all slots (about 50 a slot),
    # then inside slot 0 alone, then inside slot 2 alone (of 4)
    past_k = {3: (0, E), 4: (0, E // 4), 5: (E // 2, 3 * E // 4)}
    for i in range(n_batches):
        add, dl, live = _disjoint_rows(rng, B, E)
        if i in past_k:
            lo, hi = past_k[i]
            add[:, :] = dl[:, :] = False
            add[0, lo + rng.choice(hi - lo, 200, replace=False)] = True
        for name, n in nodes.items():
            before = ci.ingest_slot_rows.launches
            n.ingest_batch(add, dl, live)
            assert ci.ingest_slot_rows.launches - before == \
                (0 if name == "one" else 4), name
    assert plain == []
    recs = {name: list(n.wal.records()) for name, n in nodes.items()}
    assert len(recs["one"]) == n_batches
    assert recs["4"] == recs["one"] and recs["2x2"] == recs["one"]
    want = nodes["one"].state_slice()
    for name in ("4", "2x2"):
        assert _equal(nodes[name].state_slice(), want), name
    for n in nodes.values():
        n.wal.close()


def test_ep_ring_round_on_k2_matches_plain():
    """The EP-layout ring round on a 2 x 2 mesh of cuda:0: K2 a slot on
    the gathered vv, bitwise against ``kernel="torch"``."""
    from go_crdt_playground_tpu_torch import fleet
    from go_crdt_playground_tpu_torch.ops import cuda_merge as cm
    from go_crdt_playground_tpu_torch.parallel import gossip
    from go_crdt_playground_tpu_torch.parallel import mesh as mesh_mod

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    m = mesh_mod.make_mesh((2, 2), devices=["cuda:0"] * 4)
    st = mesh_mod.shard_state(fleet.demo_state(4, 4096, device="cuda:0"),
                              m, shard_actors=True)
    before = cm.merge_pairwise_rows.launches
    got = gossip.ep_ring_round_shardmap(st, m)
    assert cm.merge_pairwise_rows.launches == before + 4
    want = gossip.ep_ring_round_shardmap(st, m, kernel="torch")
    assert _equal(mesh_mod.gather_state(got), mesh_mod.gather_state(want))


@pytest.mark.parametrize("shape", ["4", "2x2"])
def test_mesh_digest_summary_on_the_card(shape):
    """``digest_summary()`` of a mesh node on cuda:0 (4 slots, or 2 x 2
    reading its dp row 0): one K11 launch a lane slot, the bytes of
    ``node_summary`` and of a one-slot CUDA node fed the same batches."""
    from chip_smoke import mesh_digest_summary

    from go_crdt_playground_tpu_torch.net import digestsync
    from go_crdt_playground_tpu_torch.net.peer import Node
    from go_crdt_playground_tpu_torch.parallel.meshtarget import \
        MeshApplyTarget
    from go_crdt_playground_tpu_torch.parallel.meshtarget2d import \
        Mesh2DApplyTarget

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    E, A, B = 1 << 15, 16, 32
    one = Node(0, E, A, device="cuda:0")
    mesh = (Mesh2DApplyTarget(0, E, A, mesh_shape=shape, device="cuda:0")
            if "x" in shape else
            MeshApplyTarget(0, E, A, mesh_devices=int(shape),
                            device="cuda:0"))
    rng = np.random.default_rng(405)
    for _ in range(4):
        add, dl, live = _disjoint_rows(rng, B, E)
        one.ingest_batch(add, dl, live)
        mesh.ingest_batch(add, dl, live)
    mesh_digest_summary(mesh, digestsync.node_summary(one),
                        2 if "x" in shape else 4, shape)


def test_native_codec_on_the_card_machine():
    """The C++ codec builds on the card's machine, and on chip_smoke.py
    phase 1's sparse and dense δ (E = 1,024, A = 16) its bytes equal the
    Python codec's and decode back both ways."""
    from chip_smoke import check_native_codec

    if not torch.cuda.is_available():
        pytest.skip("needs the card's machine (a CUDA GPU)")
    out = check_native_codec()
    assert out["available"] and set(out["payloads"]) == {"sparse", "dense"}
