"""Append-only δ write-ahead log: crash durability between checkpoints.

The counterpart of the JAX package's ``utils/wal.py``; segment file names
and record bytes are the same, so either package replays the other's
log.  The durability contract: a record is on disk (fsync'd) before the
mutation it describes is acknowledged, and recovery is ``checkpoint ⊔
replay(WAL tail)``, an idempotent merge.

Record framing (length-prefixed, CRC32-framed; varints are utils/wire.py's):

    MAGIC(2) | varint body_len | body | crc32(body, 4 bytes LE)

Bodies are opaque to the log; net/peer.Node writes a replay guard (the
vv the record's δ was computed against) followed by a PAYLOAD body of
net/framing.py, or the compact record form of utils/wire.py.

Segments: ``wal-<seq>.log`` files under one directory, rotated at
``segment_bytes``; sequence numbers only ever grow (even across
``truncate()``).  The recovery scan walks segments in order and STOPS at
the first torn or corrupt record (bad magic, truncated length/body, CRC
mismatch): everything before the tear is trusted, everything after is
discarded.  Opening a log repairs that tear in place (truncates the
segment to its valid prefix, drops any later segments) so appends land
on a clean tail.

Metrics (optional duck-typed ``recorder`` with ``.count``):
``wal.appends`` / ``wal.appended_bytes`` on the write path,
``wal.append_errors`` when the disk refuses one, ``wal.tail_repairs``
when the next append first had to truncate the partial record that
failure may have left, ``wal.torn_tail`` when a scan found a tear,
``wal.truncations`` on checkpoint-driven resets.
"""

from __future__ import annotations

import os
import threading
import zlib
from typing import Iterator, List, Tuple

from go_crdt_playground_tpu_torch.utils import wire
from go_crdt_playground_tpu_torch.utils.fsutil import fsync_dir as _fsync_dir

MAGIC = b"\xc7\xd2"  # sibling of net/framing's frame magic \xc7\xd1

_CRC_LEN = 4
_MAX_RECORD = 1 << 30


class WalTruncated(Exception):
    """A ``stream_from`` cursor points below the oldest RETAINED record:
    a checkpoint truncated (or ``drop_segments`` retired) the records
    the reader still wanted.  Typed, never a silent gap: a tailing
    reader must catch up out of band and resume from ``next_seq``."""

    def __init__(self, wanted: int, min_seq: int, next_seq: int):
        super().__init__(
            f"WAL records below seq {min_seq} are truncated "
            f"(wanted {wanted}; next append is {next_seq})")
        self.wanted = wanted
        self.min_seq = min_seq
        self.next_seq = next_seq


def encode_record(body: bytes) -> bytes:
    """One framed WAL record for ``body`` (see module docstring)."""
    if len(body) > _MAX_RECORD:
        raise ValueError(f"WAL record body too large ({len(body)} bytes)")
    out = bytearray(MAGIC)
    wire._put_varint(out, len(body))
    out += body
    out += zlib.crc32(body).to_bytes(_CRC_LEN, "little")
    return bytes(out)


def scan_records(data: bytes) -> Tuple[List[bytes], int, bool]:
    """Scan one segment's bytes.  Returns ``(bodies, valid_end, torn)``
    where ``valid_end`` is the byte offset just past the last intact
    record — the truncation point an open-time repair uses.  Never
    raises: a tear is a RESULT, not an error (the crash the log exists
    to survive produces one every time)."""
    bodies: List[bytes] = []
    pos = 0
    while pos < len(data):
        if data[pos:pos + len(MAGIC)] != MAGIC:
            return bodies, pos, True
        try:
            n, body_start = wire._get_varint(data, pos + len(MAGIC))
        except ValueError:
            return bodies, pos, True
        end = body_start + n
        if n > _MAX_RECORD or end + _CRC_LEN > len(data):
            return bodies, pos, True
        body = data[body_start:end]
        crc = int.from_bytes(data[end:end + _CRC_LEN], "little")
        if zlib.crc32(body) != crc:
            return bodies, pos, True
        bodies.append(body)
        pos = end + _CRC_LEN
    return bodies, pos, False


class DeltaWal:
    """One replica's delta write-ahead log (single-writer directory).

    ``append`` is durable-on-return (write + flush + fsync, unless
    ``fsync=False`` for tests/benchmarks); ``records()`` is the recovery
    scan; ``truncate()`` resets the log after a successful checkpoint
    (the checkpoint now owns everything the log described).  Thread-safe,
    though in the Node wiring every call already arrives serialized
    under the node lock.
    """

    def __init__(self, path: str, *, segment_bytes: int = 4 << 20,
                 fsync: bool = True, recorder=None):
        if segment_bytes < 64:
            raise ValueError("segment_bytes must be >= 64")
        self.path = os.path.abspath(path)
        self.segment_bytes = segment_bytes
        self.fsync = fsync
        self.recorder = recorder
        self._lock = threading.Lock()
        self._file = None  # guarded-by: _lock
        self._file_size = 0  # guarded-by: _lock
        # a failed append may have left a PARTIAL record on disk past
        # _file_size; no further byte may land until _heal_locked has
        # truncated the tail back to the last known-good end
        self._dirty = False  # guarded-by: _lock
        # (seq, valid_end) of tears already counted by records() — a
        # re-scan of the same physical tear must not re-count it
        self._post_open_tears: set = set()  # guarded-by: _lock
        os.makedirs(self.path, exist_ok=True)
        # race-ok: written only by construction-time repair, then frozen
        self.torn_tail_repaired = False
        # per-segment record counts, filled by the ONE construction
        # scan _repair already does (the seq numbering below reuses it
        # instead of re-reading every retained segment); deleted once
        # consumed — only construction needs it
        self._seg_counts: dict = {}
        segs = self._segments()
        if segs:
            self._repair(segs)
            segs = self._segments()
        self._seq = segs[-1] if segs else self._next_seq()  # guarded-by: _lock
        # record sequence numbering (a replication reader's cursor,
        # stream_from): every COMMITTED record gets a seq that is
        # monotone within this DeltaWal instance's lifetime — across
        # rotation, seal and truncate (a truncate advances the minimum
        # retained seq, it never reuses one).  _seg_first maps segment
        # -> the seq of its first record, so stream_from can skip whole
        # segments without scanning them.  Numbering restarts at 1 per
        # instance.
        self._seg_first: dict = {}  # guarded-by: _lock
        self._next_rec = 1  # guarded-by: _lock
        for seg in segs:
            self._seg_first[seg] = self._next_rec
            self._next_rec += self._seg_counts[seg]
        del self._seg_counts
        self._open_segment(self._seq, fresh=not segs)
        if not segs:
            self._seg_first[self._seq] = self._next_rec

    # -- segment bookkeeping -----------------------------------------------

    def _seg_path(self, seq: int) -> str:
        return os.path.join(self.path, f"wal-{seq:012d}.log")

    def _segments(self) -> List[int]:
        out = []
        for name in os.listdir(self.path):
            if name.startswith("wal-") and name.endswith(".log"):
                try:
                    out.append(int(name[4:-4]))
                except ValueError:
                    continue
        return sorted(out)

    def _next_seq(self) -> int:
        segs = self._segments()
        return (segs[-1] + 1) if segs else 1

    # requires-lock: _lock
    def _open_segment(self, seq: int, fresh: bool) -> None:
        self._file = open(self._seg_path(seq), "ab")
        self._file_size = self._file.tell()
        if fresh:
            _fsync_dir(self.path)

    def _count(self, name: str, n: int = 1) -> None:
        if self.recorder is not None:
            self.recorder.count(name, n)

    # -- recovery-time repair ----------------------------------------------

    def _repair(self, segs: List[int]) -> None:
        """Truncate the first torn segment to its valid prefix and drop
        every segment after it — the prefix property made physical, so
        later appends can never land beyond a tear.  Also records each
        surviving segment's record count (``_seg_counts``): this scan
        reads every retained byte anyway, and the record-seq numbering
        built right after construction would otherwise re-read it all."""
        for i, seq in enumerate(segs):
            p = self._seg_path(seq)
            with open(p, "rb") as f:
                data = f.read()
            bodies, valid_end, torn = scan_records(data)
            self._seg_counts[seq] = len(bodies)
            if not torn:
                continue
            self.torn_tail_repaired = True
            self._count("wal.torn_tail")
            with open(p, "r+b") as f:
                f.truncate(valid_end)
                f.flush()
                os.fsync(f.fileno())
            for later in segs[i + 1:]:
                try:
                    os.unlink(self._seg_path(later))
                except OSError:
                    pass
                self._seg_counts.pop(later, None)
            _fsync_dir(self.path)
            return

    # -- write path ---------------------------------------------------------

    # durable-on-return
    def append(self, body: bytes) -> None:
        """Durably append one record (see the fsync contract above).
        An ``OSError`` anywhere in the write/flush/fsync path (ENOSPC,
        a failing device) is counted as ``wal.append_errors`` and
        re-raised, so the caller never acks the mutation.  The failure
        also marks the tail dirty: the flush may have landed a PARTIAL
        record beyond ``_file_size``, and the next append first heals
        that tear (truncate back to the known-good end, reopen), so an
        acked record can never sit BEHIND a tear that recovery's prefix
        rule would truncate at (which would silently drop it, and every
        later acked record, on restart)."""
        rec = encode_record(body)
        try:
            with self._lock:
                if self._file is None and not self._dirty:
                    raise ValueError("WAL is closed")
                try:
                    if self._dirty:
                        self._heal_locked()
                    if self._file_size > 0 and \
                            self._file_size + len(rec) > self.segment_bytes:
                        self._rotate_locked()
                    self._file.write(rec)
                    self._file.flush()
                    if self.fsync:
                        os.fsync(self._file.fileno())
                except OSError:
                    self._dirty = True
                    raise
                self._file_size += len(rec)
                # committed (fsync returned): the record owns its seq —
                # a FAILED append never consumes one (the partial bytes
                # are healed away, so numbering matches the scan)
                self._next_rec += 1
        except OSError:
            self._count("wal.append_errors")
            raise
        self._count("wal.appends")
        self._count("wal.appended_bytes", len(rec))

    # requires-lock: _lock
    def _heal_locked(self) -> None:
        """Repair the tail a failed append poisoned: truncate the live
        segment back to ``_file_size`` (the end of the last record whose
        fsync returned) and reopen it, so no later byte can land beyond
        the partial record the failure may have left.  Raises the
        disk's ``OSError`` while the device still refuses — the tail
        stays dirty and the next append retries the heal."""
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass  # flushing the buffered partial can fail again;
                # the fd is closed either way and truncate trims it
            self._file = None
        try:
            with open(self._seg_path(self._seq), "r+b") as f:
                f.truncate(self._file_size)
                f.flush()
                os.fsync(f.fileno())
        except FileNotFoundError:
            pass  # a failed rotation never created the segment; the
            # reopen below starts it empty
        # fresh=True UNCONDITIONALLY: the failure that poisoned the
        # tail may have been the directory fsync right after the
        # segment was created (the file exists, its entry is not
        # durable) — a redundant dir fsync is harmless, a skipped one
        # re-opens the crash window that drops the whole segment of
        # acked records
        self._open_segment(self._seq, fresh=True)
        self._dirty = False
        self._count("wal.tail_repairs")

    # requires-lock: _lock
    def _rotate_locked(self) -> None:
        try:
            if self._dirty:
                # seal() can rotate while the tail is torn: heal FIRST,
                # or the tear would be frozen into a sealed segment and
                # the prefix scan would stop there — never reaching the
                # fresh segment's post-seal records
                self._heal_locked()
            self._file.flush()
            if self.fsync:
                os.fsync(self._file.fileno())
            self._file.close()
            self._seq += 1
            # known-good end of the NEW segment; set before the open so
            # a failed open leaves no stale size for _heal_locked to
            # trust
            self._file_size = 0
            self._open_segment(self._seq, fresh=True)
            self._seg_first[self._seq] = self._next_rec
        except OSError:
            # armed HERE, not only in append's wrapper: seal() rotates
            # too, and a failure must leave the log retryable-degraded
            # (next append heals), never half-closed
            self._dirty = True
            raise

    def truncate(self) -> None:
        """Drop every record: a successful checkpoint now owns them.
        The fresh segment continues the sequence (never reuses a seq)."""
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass  # a dirty buffer's implicit flush can
                    # re-raise (ENOSPC): every buffered byte is about
                    # to be unlinked anyway, and aborting here would
                    # keep a full disk full — truncate IS the reclaim
                self._file = None
            for seq in self._segments():
                try:
                    os.unlink(self._seg_path(seq))
                except OSError:
                    pass
            self._seq += 1
            self._file_size = 0
            # armed until the fresh segment is open: a transient
            # failure in the reopen must read as retryable-degraded
            # (the next append heals), not as a closed WAL — the
            # ValueError wedge would escape the serving layer's typed
            # OSError classification forever
            self._dirty = True
            self._open_segment(self._seq, fresh=True)
            # every retained record is gone: the minimum available
            # seq jumps to the next append's — a replication cursor
            # below it surfaces typed WalTruncated, never a silent gap
            self._seg_first = {self._seq: self._next_rec}
            self._post_open_tears.clear()
            self._dirty = False  # every poisoned byte was just unlinked
            _fsync_dir(self.path)
        self._count("wal.truncations")

    def seal(self) -> List[int]:
        """Rotate to a fresh segment and return the seqs of every sealed
        (pre-rotation) segment — the two-phase truncation used by
        ``Node.save_durable``: seal under the node lock (cheap), write
        the checkpoint OUTSIDE it, then ``drop_segments(sealed)`` once
        the checkpoint is durable.  Records appended after the seal land
        in the fresh segment and are never dropped.  A crash between
        seal and drop merely leaves pre-checkpoint segments behind;
        replay re-merges them idempotently."""
        with self._lock:
            sealed = self._segments()
            if self._file is not None:
                self._rotate_locked()
            return sealed

    def drop_segments(self, seqs: List[int]) -> None:
        """Unlink previously-sealed segments (their records are owned by
        a now-durable checkpoint).  Never touches the live segment."""
        with self._lock:
            for seq in seqs:
                if seq == self._seq:
                    continue
                try:
                    os.unlink(self._seg_path(seq))
                except OSError:
                    pass
                self._seg_first.pop(seq, None)
            _fsync_dir(self.path)
        self._count("wal.truncations")

    # -- recovery scan ------------------------------------------------------

    def records(self) -> Iterator[bytes]:
        """Yield record bodies oldest-first, stopping at the first torn
        or corrupt record (counts ``wal.torn_tail`` when that happens —
        corruption after open surfaces here rather than at
        construction)."""
        for seq in self._segments():
            with open(self._seg_path(seq), "rb") as f:
                data = f.read()
            bodies, valid_end, torn = scan_records(data)
            yield from bodies
            if torn:
                key = (seq, valid_end)
                with self._lock:
                    fresh = key not in self._post_open_tears
                    self._post_open_tears.add(key)
                if fresh:  # one physical tear counts once, not per scan
                    self._count("wal.torn_tail")
                return

    def record_count(self) -> int:
        return sum(1 for _ in self.records())

    # -- replication tail (seq-addressed reads) -------------------------------

    def next_seq(self) -> int:
        """The seq the NEXT committed append will get (== 1 + the last
        committed record's seq).  A fully-caught-up tail cursor equals
        this."""
        with self._lock:
            return self._next_rec

    def min_seq(self) -> int:
        """The seq of the oldest RETAINED record (== ``next_seq`` when
        the log is empty).  A cursor below this is typed-truncated."""
        with self._lock:
            return self._min_seq_locked()

    # requires-lock: _lock
    def _min_seq_locked(self) -> int:
        segs = sorted(self._seg_first)
        return self._seg_first[segs[0]] if segs else self._next_rec

    def stream_from(self, from_seq: int):
        """Tail-follow read: yield ``(seq, body)`` for every COMMITTED
        record with ``seq >= from_seq``, oldest first, across segment
        rotation, then stop at the tail — the caller re-invokes with
        its advanced cursor to follow new appends.  Stops silently at an
        unparsable record: a
        torn tail (to be healed by the next append) and a concurrent
        in-flight append look identical from here, and both resolve
        the same way — the next call resumes past the heal.  Never
        yields a record committed after the call started (a record's
        fsync may not have returned yet — shipping it would let a
        standby hold state the primary's restart path provably loses).

        Raises typed ``WalTruncated`` when ``from_seq`` predates the
        oldest retained record (a checkpoint truncated the log under
        the cursor): the reader must catch up out of band, never
        silently skip the gap."""
        if from_seq < 1:
            raise ValueError(f"stream_from wants a seq >= 1, "
                             f"got {from_seq}")
        with self._lock:
            segs = sorted(self._seg_first)
            first = dict(self._seg_first)
            limit = self._next_rec
            min_avail = self._min_seq_locked()
        if from_seq < min_avail:
            raise WalTruncated(from_seq, min_avail, limit)
        if from_seq >= limit:
            # caught up: nothing committed past the cursor — return
            # empty WITHOUT touching the disk (a polling reader spins on
            # this path)
            return iter(())

        def _iter():
            for i, seg in enumerate(segs):
                start = first[seg]
                if start >= limit:
                    return
                nxt = first[segs[i + 1]] if i + 1 < len(segs) else None
                if nxt is not None and nxt <= from_seq:
                    continue  # wholly below the cursor: skip the scan
                try:
                    with open(self._seg_path(seg), "rb") as f:
                        data = f.read()
                except FileNotFoundError:
                    # truncated under us after the snapshot: the NEXT
                    # call adjudicates the cursor against the new
                    # minimum (typed there, silence here would yield a
                    # gap only if we kept going — so stop)
                    return
                bodies, _, _ = scan_records(data)
                for j, body in enumerate(bodies):
                    seq = start + j
                    if seq >= limit:
                        return
                    if seq >= from_seq:
                        yield seq, body

        return _iter()

    def close(self) -> None:
        with self._lock:
            # a tear left dirty at close stays on disk; the next open's
            # construction-time _repair truncates it (clearing the flag
            # keeps append's closed-check authoritative: a closed WAL
            # must never self-heal back to life)
            dirty, self._dirty = self._dirty, False
            if self._file is not None:
                if not dirty:  # a dirty buffer re-raises on flush, and
                    # its bytes are past the known-good end anyway
                    self._file.flush()
                    if self.fsync:
                        try:
                            os.fsync(self._file.fileno())
                        except OSError:
                            pass
                try:
                    self._file.close()
                except OSError:
                    pass  # close's implicit flush of a dirty buffer
                self._file = None

    def __enter__(self) -> "DeltaWal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
