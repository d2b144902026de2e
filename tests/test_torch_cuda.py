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


def test_ingest_kernel_rejects_a_wide_actor_axis():
    from go_crdt_playground_tpu_torch.ops import cuda_ingest as ci

    row = _on_gpu(_slice(90, 64, 2049, 0))
    add = torch.zeros((2, 64), dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="shared-memory cap"):
        ci.ingest_rows_delta_fused(row, add, add, add[:, 0], k_changed=8,
                                   k_deleted=8)


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
    from go_crdt_playground_tpu_torch.ops.cuda_merge import MAX_FUSED_ACTORS

    assert A in (1, 16, MAX_FUSED_ACTORS)
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
