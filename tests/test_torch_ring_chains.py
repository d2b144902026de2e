"""K9's walk over the ring's cycles (ops/cuda_delta.ring_segments), on the
CPU: the segment geometry the wrapper hands the kernel, and the kernel's
row-buffer protocol (csrc/delta.cu ``delta_ring_walk``) modelled step by
step.  The kernel itself runs on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import pytest

from go_crdt_playground_tpu_torch.ops.cuda_delta import (
    SEGMENT_ROWS, ring_segments, segment_rows)

ROWS = (128, 192, 320, 1000, 4096)
SEG_LENS = (1, 2, 16)


def offsets(R):
    return (0, 1, 5, 63, 64, 96, R - 1, R + 5, 3 * R + 64)


CASES = [(R, off, L) for R in ROWS for off in offsets(R) for L in SEG_LENS]


def walk_model(geom, q):
    """The kernel's fetch order for segment q: rows c_0 .. c_last in
    order into three slots (row m into slot m % 3; a whole cycle of four
    or more rows keeps c_0 in slot 0 and turns the others over slots 1
    and 2), a slot refilled only after the step that read it as dst.
    Returns the (dst, partner) rows of each step and the rows fetched,
    asserting that each step finds its two rows in their slots."""
    rows = segment_rows(geom, q)
    length = len(rows) - 1
    whole = geom.per_cycle == 1
    pinned = whole and geom.cycle_len >= 4
    last = length - 1 if whole else length

    def slot(m):
        if pinned:
            return 0 if m == 0 else 1 + (m - 1) % 2
        return m % 3

    held, fetched, steps = {}, [], []
    for m in range(min(3, last + 1)):
        held[slot(m)] = m
        fetched.append(m)
    for i in range(length):
        pm = 0 if i + 1 > last else i + 1
        assert held[slot(i)] == i and held[slot(pm)] == pm, (q, i)
        steps.append((rows[i], rows[pm]))
        nxt = (i + 2 if i >= 1 else last + 1) if pinned else i + 3
        if nxt <= last:
            assert slot(nxt) == slot(i)
            held[slot(i)] = nxt
            fetched.append(nxt)
    return steps, fetched


@pytest.mark.parametrize("R,offset,L", CASES)
def test_segments_cover_every_row_once(R, offset, L):
    geom = ring_segments(R, offset, L)
    o = offset % R
    assert geom.offset == o and geom.cycles * geom.cycle_len == R
    assert geom.count == geom.cycles * -(-geom.cycle_len // L)
    dst_count = [0] * R
    reads = 0
    for q in range(geom.count):
        rows = segment_rows(geom, q)
        length = len(rows) - 1
        assert 1 <= length <= L
        for r, p in zip(rows, rows[1:]):
            dst_count[r] += 1
            assert p == (r + o) % R
        whole = geom.per_cycle == 1
        assert whole == (length == geom.cycle_len)
        if whole:
            assert rows[-1] == rows[0]
        reads += length if whole else length + 1
    assert dst_count == [1] * R
    # each row read once, plus the row past each segment that is not its
    # whole cycle
    assert reads == R + (0 if geom.per_cycle == 1 else geom.count)
    if geom.cycle_len % L == 0 and geom.per_cycle > 1:
        assert reads == R + R // L


@pytest.mark.parametrize("R,offset,L", CASES)
def test_walk_reads_each_row_from_its_slot(R, offset, L):
    geom = ring_segments(R, offset, L)
    seen = set()
    for q in range(geom.count):
        steps, fetched = walk_model(geom, q)
        rows = segment_rows(geom, q)
        last = len(rows) - 2 if geom.per_cycle == 1 else len(rows) - 1
        assert fetched == list(range(last + 1))
        for r, p in steps:
            assert p == (r + geom.offset) % R
            seen.add(r)
    assert seen == set(range(R))


@pytest.mark.parametrize("R,offset,n", [
    (1 << 20, 1 << 19, 2), (1 << 20, 1 << 16, 16), (1 << 20, 1, 1 << 20),
    (192, 64, 3), (192, 72, 8), (192, 45, 64), (320, 100, 16),
    (320, 35, 64), (320, 64, 5), (128, 0, 1)])
def test_cycle_geometry(R, offset, n):
    geom = ring_segments(R, offset)
    assert geom.seg_len == SEGMENT_ROWS
    assert geom.cycle_len == n and geom.cycles == R // n
    assert geom.per_cycle == -(-n // SEGMENT_ROWS)


@pytest.mark.parametrize("R,L", [(0, 16), (128, 0)])
def test_ring_segments_rejects_empty_shapes(R, L):
    with pytest.raises(ValueError):
        ring_segments(R, 1, L)
