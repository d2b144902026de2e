"""Socket-level chaos injection: a deterministic TCP interposer.

The tensor layer already injects faults as masked lanes
(parallel/gossip.py drop masks), but that validates the ALGEBRA, not the
WIRE STACK.  ``ChaosProxy`` sits between real ``net.peer.Node``
processes/threads and injects the failure modes a production network
actually produces, so the idempotence/self-healing claim (SURVEY §5.3)
is exercised against framing, deadlines, and the apply path itself:

* **drop-before-HELLO** — the dial is accepted then closed before a
  byte moves (a peer crashing right after accept);
* **mid-frame truncation** — a random prefix is forwarded, then both
  ends are cut abruptly (torn frames; the receiver must treat the
  partial frame as all-or-nothing);
* **delay** — a sleep before forwarding (exercises HELLO/frame
  deadlines without violating protocol);
* **duplicate delivery** — the client→server byte stream is recorded
  and replayed on a fresh upstream connection after the original
  exchange finishes (the same PAYLOAD applied twice: idempotence on the
  actual wire bytes, not a simulated re-merge);
* **byte garbling** — one byte is flipped in flight (framing must
  reject, never half-apply);
* **asymmetric partition** — the proxy refuses all inbound dials while
  its node can still dial OUT to everyone else (one proxy per node
  makes the partition asymmetric by construction); ``heal()`` lifts it.

Determinism: every per-connection decision comes from one
``random.Random(seed)`` drawn in accept order, or — for tests that need
exact placement — from an explicit ``script`` of actions consumed
first-connection-first.  Counters for every injected fault are exposed
via ``counters()`` so tests can assert the chaos actually happened
(a green chaos test with zero injected faults is a broken test).

The ``storage`` namespace (``StorageScenario`` / ``StorageFaults``)
extends the same vocabulary to what DISKS do — torn writes, bit-flips,
zero-fills against WAL segments and checkpoint generations — seeded and
counter-exposed exactly like the socket faults, and consumable from the
same ``ChaosScenario`` config (its ``storage`` field).  The crash soak
(tools/crash_soak.py) is its primary driver.
"""

from __future__ import annotations

import dataclasses
import os
import random
import socket
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

# action verbs (script entries use these, with optional ":arg")
ACT_OK = "ok"
ACT_DROP = "drop"             # close before any byte (drop-before-HELLO)
ACT_TRUNCATE = "truncate"     # "truncate:<nbytes>" — cut mid-frame
ACT_DELAY = "delay"           # "delay:<seconds>"
ACT_DUPLICATE = "duplicate"   # replay the client bytes after the exchange
ACT_GARBLE = "garble"         # flip one byte of the client->server stream

# storage-namespace verbs (StorageFaults — file-level, for the
# durability layer's WAL segments and checkpoint generations)
STORAGE_TORN = "torn_write"   # truncate the file tail (a cut-short write)
STORAGE_BITFLIP = "bit_flip"  # flip one bit near the tail (bit rot)
STORAGE_ZERO = "zero_fill"    # zero a tail span (a lost-then-zeroed page)

_RECORD_CAP = 1 << 20  # duplicate-replay buffer bound per connection


def _validate_script_entry(entry: str) -> None:
    """Reject malformed script entries at construction time — the only
    other place they surface is inside the accept-loop thread, where a
    ValueError kills the proxy silently and the test hangs on its
    connect timeout instead of failing at the typo."""
    verb, _, arg = entry.partition(":")
    if verb not in (ACT_OK, ACT_DROP, ACT_TRUNCATE, ACT_DELAY,
                    ACT_DUPLICATE, ACT_GARBLE):
        raise ValueError(f"unknown chaos script entry {entry!r}")
    if arg:
        if verb in (ACT_TRUNCATE, ACT_GARBLE):
            int(arg)
        elif verb == ACT_DELAY:
            float(arg)


@dataclass
class StorageScenario:
    """File-level fault rates — the ``storage`` namespace of the fault
    vocabulary, covering what disks (not sockets) do to the durability
    layer: torn writes (a crash mid-append cuts the file short),
    bit-flips (media rot under a checkpoint that is never re-read until
    recovery), and zero-fills (a journaling filesystem replaying a
    metadata-only commit).  Rates are drawn per ``StorageFaults.inject``
    call in fixed order (torn, bit-flip, zero-fill; at most one fires),
    the same constant-draw-count determinism contract as the socket
    scenario above.  Faults target the last ``tail_window`` bytes of the
    file — the region recovery scans treat as the untrusted tail."""

    torn_write_rate: float = 0.0
    bit_flip_rate: float = 0.0
    zero_fill_rate: float = 0.0
    tail_window: int = 256
    max_zero_span: int = 64

    def __post_init__(self) -> None:
        for name in ("torn_write_rate", "bit_flip_rate", "zero_fill_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name}={v} outside [0, 1]")
        if self.tail_window < 1:
            raise ValueError(f"tail_window={self.tail_window} must be >= 1")
        if self.max_zero_span < 1:
            raise ValueError(
                f"max_zero_span={self.max_zero_span} must be >= 1")


@dataclass
class ChaosScenario:
    """Per-connection fault rates (each drawn independently, in this
    order: drop, truncate, garble, delay, duplicate — at most one of
    drop/truncate/garble fires per connection; delay and duplicate
    compose with any of them).  ``storage`` carries the file-level fault
    rates of the same chaos run (consumed by ``StorageFaults``, e.g. the
    crash soak's storage_faults hook) so one scenario object describes
    both the wire and the disk."""

    drop_rate: float = 0.0
    truncate_rate: float = 0.0
    truncate_window: Tuple[int, int] = (1, 48)
    garble_rate: float = 0.0
    delay_rate: float = 0.0
    delay_s: float = 0.02
    duplicate_rate: float = 0.0
    partitioned: bool = False
    storage: Optional[StorageScenario] = None

    def __post_init__(self) -> None:
        for name in ("drop_rate", "truncate_rate", "garble_rate",
                     "delay_rate", "duplicate_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name}={v} outside [0, 1]")
        lo, hi = self.truncate_window
        if not 0 <= lo <= hi:
            # an inverted window would only surface as randint blowing
            # up inside the accept-loop thread (silent proxy death)
            raise ValueError(
                f"truncate_window={self.truncate_window} needs 0 <= lo <= hi")


@dataclass
class _Plan:
    """One connection's resolved fault plan."""

    action: str = ACT_OK
    cut_after: Optional[int] = None
    delay_s: float = 0.0
    duplicate: bool = False
    garble: bool = False
    # byte index (into the first client->server chunk) whose low bit is
    # flipped; None = last byte.  Scripted garbles pin it so tests can
    # target the magic (rejected before decode) or a body field
    # (rejected by decode) deterministically.
    garble_offset: Optional[int] = None


class ChaosProxy:
    """Deterministic lossy/byzantine TCP interposer in front of one
    ``Node`` server.  Listens on an ephemeral localhost port
    (``.port``), forwards to ``target``; thread-per-connection, cheap
    enough for a dozen fleet members in one test process."""

    def __init__(self, target: Tuple[str, int], seed: int = 0,
                 scenario: Optional[ChaosScenario] = None,
                 script: Optional[Sequence[str]] = None):
        self.target = (target[0], int(target[1]))
        self.scenario = scenario if scenario is not None else ChaosScenario()
        self._script: List[str] = list(script or [])
        for entry in self._script:
            _validate_script_entry(entry)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {
            "connections": 0, "refused": 0, "dropped": 0, "truncated": 0,
            "garbled": 0, "delayed": 0, "duplicated": 0, "passed": 0,
            "severed": 0,
        }
        # live (client, upstream) socket pairs, so a mid-stream phase
        # flip (sever()) can cut ESTABLISHED pipes — per-connection
        # plans are drawn at accept, so a long-lived pipelined link
        # would otherwise never feel a scenario change
        self._active: set = set()  # guarded-by: _lock
        self._closing = False
        self._sock = socket.socket()
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(128)
        self.port: int = self._sock.getsockname()[1]
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"chaos-proxy-{self.port}")
        self._thread.start()

    # -- control -----------------------------------------------------------

    def partition(self) -> None:
        """Start refusing ALL inbound dials (asymmetric: the node behind
        this proxy can still dial out through other nodes' proxies)."""
        with self._lock:
            self.scenario.partitioned = True

    def heal(self) -> None:
        with self._lock:
            self.scenario.partitioned = False

    def sever(self) -> None:
        """Abruptly cut every ESTABLISHED proxied connection (both
        ends) without touching the listener: the peer behind a
        long-lived pipelined link re-dials and the CURRENT scenario
        adjudicates the fresh connection — how a mid-stream phase flip
        (torn-frame window, partition) actually reaches a connection
        that was planned clean at accept time."""
        with self._lock:
            pairs = list(self._active)
            self._counters["severed"] += len(pairs)
        for pair in pairs:
            for s in pair:
                # shutdown ONLY — the pump threads may be blocked in
                # recv()/sendall() on these very sockets, and close()
                # here would free the fd for reuse by a new accepted
                # connection while the old pump still reads it (cross-
                # connection corruption); shutdown wakes the pumps and
                # their own finally blocks close both ends safely
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    def set_scenario(self, **rates) -> None:
        """Mutate per-connection fault rates live (the fleet soak's
        router↔shard chaos leg flips torn-frame windows on and off
        mid-stream).  Unknown field names are refused at the call,
        not discovered as a silently-ineffective chaos phase."""
        for name, value in rates.items():
            if not hasattr(self.scenario, name):
                raise ValueError(f"unknown scenario field {name!r}")
        with self._lock:
            for name, value in rates.items():
                setattr(self.scenario, name, value)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def close(self) -> None:
        self._closing = True
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "ChaosProxy":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- per-connection planning (all RNG draws happen here, in accept
    # -- order, under the lock — the determinism contract) ------------------

    def _next_plan(self) -> Optional[_Plan]:
        """None = refuse (partition).  Called under the lock."""
        s = self.scenario
        self._counters["connections"] += 1
        if s.partitioned:
            self._counters["refused"] += 1
            return None
        if self._script:
            return self._plan_from_script(self._script.pop(0))
        plan = _Plan()
        lo, hi = s.truncate_window
        # one draw per fault axis EVERY connection, whether or not an
        # earlier axis already fired: the draw count per connection is
        # constant, so a scenario's stream stays aligned across runs
        # even when rates differ
        r_drop = self._rng.random()
        r_trunc = self._rng.random()
        cut = self._rng.randint(lo, hi)
        r_garble = self._rng.random()
        r_delay = self._rng.random()
        r_dup = self._rng.random()
        if r_drop < s.drop_rate:
            plan.action = ACT_DROP
            self._counters["dropped"] += 1
        elif r_trunc < s.truncate_rate:
            plan.action = ACT_TRUNCATE
            plan.cut_after = cut
            self._counters["truncated"] += 1
        elif r_garble < s.garble_rate:
            plan.action = ACT_GARBLE
            plan.garble = True
            self._counters["garbled"] += 1
        if r_delay < s.delay_rate:
            plan.delay_s = s.delay_s
            self._counters["delayed"] += 1
        if r_dup < s.duplicate_rate and plan.action == ACT_OK:
            plan.duplicate = True
            self._counters["duplicated"] += 1
        if plan.action == ACT_OK:
            self._counters["passed"] += 1
        return plan

    def _plan_from_script(self, entry: str) -> _Plan:
        verb, _, arg = entry.partition(":")
        plan = _Plan()
        if verb == ACT_DROP:
            plan.action = ACT_DROP
            self._counters["dropped"] += 1
        elif verb == ACT_TRUNCATE:
            plan.action = ACT_TRUNCATE
            plan.cut_after = int(arg) if arg else 16
            self._counters["truncated"] += 1
        elif verb == ACT_GARBLE:
            plan.action = ACT_GARBLE
            plan.garble = True
            plan.garble_offset = int(arg) if arg else None
            self._counters["garbled"] += 1
        elif verb == ACT_DELAY:
            plan.delay_s = float(arg) if arg else self.scenario.delay_s
            self._counters["delayed"] += 1
        elif verb == ACT_DUPLICATE:
            plan.duplicate = True
            self._counters["duplicated"] += 1
        elif verb == ACT_OK:
            self._counters["passed"] += 1
        else:
            raise ValueError(f"unknown chaos script entry {entry!r}")
        return plan

    # -- data path ----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with self._lock:
                plan = self._next_plan()
            if plan is None or plan.action == ACT_DROP:
                # refuse/drop-before-HELLO: abrupt close, zero bytes moved
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            threading.Thread(target=self._run_conn, args=(conn, plan),
                             daemon=True).start()

    def _run_conn(self, conn: socket.socket, plan: _Plan) -> None:
        if plan.delay_s > 0:
            time.sleep(plan.delay_s)
        try:
            upstream = socket.create_connection(self.target, timeout=5.0)
        except OSError:
            try:
                conn.close()
            except OSError:
                pass
            return
        pair = (conn, upstream)
        with self._lock:
            self._active.add(pair)
        recorded: Optional[List[bytes]] = [] if plan.duplicate else None

        def pump(src: socket.socket, dst: socket.socket,
                 budget: Optional[int], garble: bool,
                 garble_offset: Optional[int],
                 record: Optional[List[bytes]]) -> None:
            forwarded = 0
            first = True
            try:
                while True:
                    take = 4096 if budget is None else min(
                        4096, budget - forwarded)
                    if take <= 0:
                        break
                    data = src.recv(take)
                    if not data:
                        break
                    if garble and first:
                        # flip the low bit of one byte of the first
                        # chunk (default: the last byte — past the magic
                        # when the chunk spans a whole frame).  Note a
                        # flip can land on bytes where the frame still
                        # DECODES (e.g. inside a VV counter): that is
                        # the point — the stack must either reject the
                        # frame or absorb a semantically-valid one, and
                        # anti-entropy heals the skew either way.
                        i = (len(data) - 1 if garble_offset is None
                             else min(garble_offset, len(data) - 1))
                        data = (data[:i] + bytes([data[i] ^ 0x01])
                                + data[i + 1:])
                        first = False
                    if record is not None and sum(
                            len(c) for c in record) < _RECORD_CAP:
                        record.append(data)
                    dst.sendall(data)
                    forwarded += len(data)
            except OSError:
                pass
            finally:
                # abrupt close of BOTH ends on exit: a budget cut lands
                # as a torn frame on whichever side was mid-read
                for s in (src, dst):
                    try:
                        s.close()
                    except OSError:
                        pass

        cut = plan.cut_after if plan.action == ACT_TRUNCATE else None
        try:
            t = threading.Thread(
                target=pump, daemon=True,
                args=(conn, upstream, cut, plan.garble,
                      plan.garble_offset, recorded))
            t.start()
            pump(upstream, conn, cut, False, None, None)
            t.join(timeout=5.0)
        finally:
            with self._lock:
                self._active.discard(pair)
        if plan.duplicate and recorded:
            self._replay(b"".join(recorded))

    def _replay(self, payload: bytes) -> None:
        """Duplicate delivery: the recorded client→server bytes hit the
        server a second time on a fresh connection.  Replies are drained
        and discarded — the duplicate client is a ghost."""
        try:
            with socket.create_connection(self.target, timeout=5.0) as up:
                up.sendall(payload)
                up.settimeout(5.0)
                while up.recv(4096):
                    pass
        except OSError:
            pass  # the duplicate is best-effort by design


# ---------------------------------------------------------------------------
# Storage faults — the durability layer's chaos counterpart
# ---------------------------------------------------------------------------


class StorageFaults:
    """Deterministic file corruptor for WAL segments and checkpoint
    generations (the crash soak's ``storage_faults`` hook).  Seeded like
    ``ChaosProxy``: every ``inject`` makes the same fixed number of RNG
    draws whatever fires, so a scenario's fault stream stays aligned
    across runs even when rates differ.  The explicit verbs
    (``torn_write`` / ``bit_flip`` / ``zero_fill``) bypass the rates for
    tests and guaranteed-corruption placement, mirroring ChaosProxy's
    script entries.  Only ever point this at files you own — it mutates
    them in place."""

    def __init__(self, scenario: Optional[StorageScenario] = None,
                 seed: int = 0):
        self.scenario = (scenario if scenario is not None
                         else StorageScenario())
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {
            "inject_calls": 0, "torn_writes": 0, "bit_flips": 0,
            "zero_fills": 0, "skipped_empty": 0, "passed": 0,
        }

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    # -- rate-driven entry point -------------------------------------------

    def inject(self, path: str) -> Optional[str]:
        """Maybe corrupt ``path`` per the scenario rates; returns the
        storage verb that fired, or None.  Draw order (constant count):
        torn, cut-fraction, flip, flip-offset, flip-bit, zero,
        zero-offset, zero-span."""
        s = self.scenario
        with self._lock:
            self._counters["inject_calls"] += 1
            r_torn = self._rng.random()
            f_cut = self._rng.random()
            r_flip = self._rng.random()
            f_off = self._rng.random()
            bit = self._rng.randrange(8)
            r_zero = self._rng.random()
            f_zoff = self._rng.random()
            span = 1 + self._rng.randrange(s.max_zero_span)
            size = self._file_size(path)
            if size <= 0:
                self._counters["skipped_empty"] += 1
                return None
            window = min(s.tail_window, size)
            if r_torn < s.torn_write_rate:
                cut = 1 + int(f_cut * (window - 1))
                self._torn_write_locked(path, size, cut)
                return STORAGE_TORN
            if r_flip < s.bit_flip_rate:
                off = size - window + int(f_off * window)
                self._bit_flip_locked(path, min(off, size - 1), bit)
                return STORAGE_BITFLIP
            if r_zero < s.zero_fill_rate:
                off = size - window + int(f_zoff * window)
                self._zero_fill_locked(path, min(off, size - 1), span)
                return STORAGE_ZERO
            self._counters["passed"] += 1
            return None

    # -- explicit verbs (scripted placement) --------------------------------

    def torn_write(self, path: str, cut_bytes: Optional[int] = None) -> None:
        """Cut the last ``cut_bytes`` (default: a seeded draw inside the
        tail window) off the file — a write that never finished."""
        with self._lock:
            size = self._file_size(path)
            if size <= 0:
                self._counters["skipped_empty"] += 1
                return
            if cut_bytes is None:
                window = min(self.scenario.tail_window, size)
                cut_bytes = 1 + self._rng.randrange(window)
            self._torn_write_locked(path, size, min(cut_bytes, size))

    def bit_flip(self, path: str, offset: Optional[int] = None,
                 bit: Optional[int] = None) -> None:
        """Flip one bit (default: seeded position in the tail window)."""
        with self._lock:
            size = self._file_size(path)
            if size <= 0:
                self._counters["skipped_empty"] += 1
                return
            if offset is None:
                window = min(self.scenario.tail_window, size)
                offset = size - window + self._rng.randrange(window)
            if bit is None:
                bit = self._rng.randrange(8)
            self._bit_flip_locked(path, min(offset, size - 1), bit)

    def bit_flip_array(self, path: str, member: Optional[str] = None) -> None:
        """Flip one bit inside the DATA region of an ``.npz`` member
        (default: the largest non-manifest member, seeded offset within
        it) — guaranteed-meaningful checkpoint corruption.  A blind
        tail/middle flip on a small checkpoint often lands in zip or
        .npy framing bytes that loaders never re-read, silently passing;
        this verb parses the container so the flip always hits bytes the
        restore-time digest verification covers."""
        import zipfile

        with self._lock:
            try:
                with zipfile.ZipFile(path) as z:
                    infos = [i for i in z.infolist()
                             if (i.filename == member if member is not None
                                 else "manifest" not in i.filename)]
            except (OSError, zipfile.BadZipFile):
                self._counters["skipped_empty"] += 1
                return
            if not infos:
                self._counters["skipped_empty"] += 1
                return
            zi = max(infos, key=lambda i: i.file_size)
            with open(path, "r+b") as f:
                # local file header: 30 fixed bytes, name, extra field
                f.seek(zi.header_offset + 26)
                name_len = int.from_bytes(f.read(2), "little")
                extra_len = int.from_bytes(f.read(2), "little")
                data_start = (zi.header_offset + 30 + name_len + extra_len)
            offset = data_start + self._rng.randrange(max(1, zi.file_size))
            self._bit_flip_locked(path, offset, self._rng.randrange(8))

    def zero_fill(self, path: str, offset: Optional[int] = None,
                  span: Optional[int] = None) -> None:
        """Zero ``span`` bytes (default: seeded tail placement/length)."""
        with self._lock:
            size = self._file_size(path)
            if size <= 0:
                self._counters["skipped_empty"] += 1
                return
            if offset is None:
                window = min(self.scenario.tail_window, size)
                offset = size - window + self._rng.randrange(window)
            if span is None:
                span = 1 + self._rng.randrange(self.scenario.max_zero_span)
            self._zero_fill_locked(path, min(offset, size - 1), span)

    # -- primitives (caller holds the lock) ---------------------------------

    @staticmethod
    def _file_size(path: str) -> int:
        try:
            return os.path.getsize(path)
        except OSError:
            return -1

    def _torn_write_locked(self, path: str, size: int, cut: int) -> None:
        with open(path, "r+b") as f:
            f.truncate(max(0, size - cut))
        self._counters["torn_writes"] += 1

    def _bit_flip_locked(self, path: str, offset: int, bit: int) -> None:
        with open(path, "r+b") as f:
            f.seek(offset)
            b = f.read(1)
            f.seek(offset)
            f.write(bytes([b[0] ^ (1 << bit)]))
        self._counters["bit_flips"] += 1

    def _zero_fill_locked(self, path: str, offset: int, span: int) -> None:
        with open(path, "r+b") as f:
            f.seek(offset)
            f.write(b"\x00" * span)  # may extend past EOF; still a tear
        self._counters["zero_fills"] += 1


def fleet_proxies(addrs: Sequence[Tuple[str, int]], seed: int = 0,
                  scenario: Optional[ChaosScenario] = None
                  ) -> List[ChaosProxy]:
    """One ChaosProxy per fleet member, each with a seed derived from
    ``seed`` and its index (deterministic fleet-wide chaos), sharing a
    scenario TEMPLATE (each proxy gets its own copy so a partition on
    one node does not partition the fleet)."""
    out = []
    for i, addr in enumerate(addrs):
        sc = (dataclasses.replace(scenario) if scenario is not None
              else ChaosScenario())
        out.append(ChaosProxy(addr, seed=seed * 1000 + i, scenario=sc))
    return out
