"""Resilient anti-entropy runtime: retries, backoff, circuit breakers.

The counterpart of the JAX package's ``net/antientropy.py``.  A lost
exchange only delays convergence (merge is idempotent and commutative),
so the runtime's job is to retry, classify and degrade:

* ``classify_failure`` maps the typed ``SyncError`` hierarchy (and raw
  socket errors) onto failure classes: connect-refused, connect-timeout,
  frame-deadline, reset, protocol, remote.  Protocol and remote failures
  are deterministic and never retried in the round; a remote-reported
  incompatibility opens the peer's breaker at once.
* ``CircuitBreaker``: CLOSED until ``failure_threshold`` consecutive
  failed rounds, then OPEN (no dials) for ``cooldown_s``, then HALF_OPEN
  with one probe; the clock is injectable.
* ``SyncSupervisor`` drives one ``Node`` against a peer set on a jittered
  cadence with a per-round retry budget (utils/backoff.py), per-peer
  breakers, optional checkpoints, and the digest regime
  (net/digestsync.py) negotiated per peer: a pre-digest peer is pinned to
  the FULL/DELTA ladder, and a peer that refuses a non-default group size
  is pinned to the default one.

Metric names: ``sync.supervisor.rounds``, ``sync.successes``,
``sync.peer_failures``, ``sync.skipped_open``, ``sync.failures.<class>``,
``sync.retries.<class>``, ``breaker.to_<state>``, ``sync.checkpoints``,
``sync.digest.unsupported``, ``digest.group_<grow|shrink|pinned>``, and,
when the recorder has ``set_gauge``, ``breaker.state.<host>:<port>`` and
``digest.group_size``.  All randomness derives from the seed.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from go_crdt_playground_tpu_torch.net import digestsync, framing
from go_crdt_playground_tpu_torch.net.breaker import (  # noqa: F401
    _STATE_GAUGE, CLOSED, HALF_OPEN, OPEN, CircuitBreaker)
from go_crdt_playground_tpu_torch.net.peer import (ConnectFailed, Node,
                                                   PeerProtocolError,
                                                   PeerReset, PeerTimeout)
from go_crdt_playground_tpu_torch.utils.backoff import Backoff, BackoffPolicy
from go_crdt_playground_tpu_torch.utils.checkpoint import CheckpointStore
from go_crdt_playground_tpu_torch.utils.wal import DeltaWal

Addr = Tuple[str, int]

# -- failure classification -------------------------------------------------

CLASS_CONNECT_REFUSED = "connect_refused"
CLASS_CONNECT_TIMEOUT = "connect_timeout"
CLASS_FRAME_DEADLINE = "frame_deadline"
CLASS_RESET = "reset"
CLASS_PROTOCOL = "protocol"
CLASS_REMOTE = "remote"
CLASS_UNKNOWN = "unknown"

FAILURE_CLASSES = (
    CLASS_CONNECT_REFUSED, CLASS_CONNECT_TIMEOUT, CLASS_FRAME_DEADLINE,
    CLASS_RESET, CLASS_PROTOCOL, CLASS_REMOTE, CLASS_UNKNOWN,
)

# a deterministic function of the bytes exchanged: no in-round retry
NON_RETRYABLE_CLASSES = frozenset({CLASS_PROTOCOL, CLASS_REMOTE})

# the peer reported an incompatibility: its breaker opens at once
BREAKER_FATAL_CLASSES = frozenset({CLASS_REMOTE})


def classify_failure(exc: BaseException) -> str:
    """The failure class of one sync failure (typed or raw)."""
    if isinstance(exc, PeerTimeout):
        return (CLASS_CONNECT_TIMEOUT if exc.phase == "connect"
                else CLASS_FRAME_DEADLINE)
    if isinstance(exc, ConnectFailed):
        return CLASS_CONNECT_REFUSED
    if isinstance(exc, framing.RemoteError):
        return CLASS_REMOTE
    if isinstance(exc, framing.TruncatedFrame):
        return CLASS_RESET  # torn frame = transport loss, retryable
    if isinstance(exc, (PeerProtocolError, framing.ProtocolError)):
        return CLASS_PROTOCOL
    if isinstance(exc, (PeerReset, ConnectionError)):
        return CLASS_RESET
    if isinstance(exc, TimeoutError):
        return CLASS_FRAME_DEADLINE
    if isinstance(exc, OSError):
        return CLASS_CONNECT_REFUSED
    return CLASS_UNKNOWN


# -- supervisor -------------------------------------------------------------


class SyncSupervisor:
    """Drives one ``Node`` against a peer set with bounded retries,
    per-peer circuit breakers and periodic checkpoints.

    One ``sync_round()`` visits every peer once in a seeded shuffle
    (``fanout`` of them when set): a peer behind an OPEN breaker is
    skipped, the rest get one exchange plus up to ``policy.max_retries``
    in-round retries with jittered backoff, except for the non-retryable
    classes.  The breaker records one outcome per peer per round.

    ``sync_mode``: ``"delta"`` is the FULL/DELTA ladder (``Node.sync_with``);
    ``"digest"`` opens every exchange with a digest summary
    (net/digestsync.py) and needs v2 delta semantics (reference-mode
    deletion logs never converge bitwise, so their digests would mismatch
    forever).  A node healing a regressed restore rides the ladder until
    its epoch retires.

    Checkpoints: ``checkpoint_path`` is the single-file ``Node.save``
    dump; ``durable_dir`` is a generational ``CheckpointStore`` plus a
    ``DeltaWal`` attached to the node (if it has none).  ``sleep`` and
    ``clock`` are injectable; all randomness derives from ``seed``."""

    def __init__(self, node: Node, peers: Sequence[Addr], *,
                 policy: Optional[BackoffPolicy] = None,
                 sync_timeout_s: float = 5.0,
                 connect_timeout_s: Optional[float] = None,
                 hello_timeout_s: Optional[float] = None,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 1.0,
                 fanout: Optional[int] = None,
                 interval_s: float = 0.05,
                 interval_jitter: float = 0.2,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 0,
                 durable_dir: Optional[str] = None,
                 keep_generations: int = 3,
                 wal_fsync: bool = True,
                 sync_mode: str = "delta",
                 recorder=None, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        if durable_dir is not None and checkpoint_path is not None:
            raise ValueError(
                "durable_dir and checkpoint_path are alternative "
                "checkpoint regimes; pass one")
        if sync_mode not in ("delta", "digest"):
            raise ValueError(f"unknown sync_mode {sync_mode!r} "
                             "(expected 'delta' or 'digest')")
        if sync_mode == "digest" and node.delta_semantics != "v2":
            raise ValueError(
                "digest sync requires v2 (record-absorbing) delta "
                "semantics: reference-mode deletion logs never "
                "converge bitwise, so their digests mismatch forever")
        if fanout is not None and fanout < 1:
            raise ValueError("fanout must be >= 1 (or None for all peers)")
        self.sync_mode = sync_mode
        self._negotiator = None
        self._group_adapter = None
        if sync_mode == "digest":
            self._negotiator = digestsync.DigestNegotiator()
            self._group_adapter = digestsync.AdaptiveGroupSize(
                node.num_elements)
        self.node = node
        self.policy = policy if policy is not None else BackoffPolicy()
        self.sync_timeout_s = sync_timeout_s
        self.connect_timeout_s = connect_timeout_s
        self.hello_timeout_s = hello_timeout_s
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self.fanout = fanout
        self.interval_s = interval_s
        self.interval_jitter = interval_jitter
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.durable_dir = durable_dir
        self.recorder = recorder if recorder is not None else node.recorder
        self._store = None
        if durable_dir is not None:
            self._store = CheckpointStore(
                durable_dir, keep=keep_generations, recorder=self.recorder)
            with node._lock:
                if node.wal is None:
                    # every δ the rounds merge is durable between
                    # checkpoints
                    node.wal = DeltaWal(os.path.join(durable_dir, "wal"),
                                        fsync=wal_fsync,
                                        recorder=self.recorder)
        self.seed = seed
        self._sleep = sleep
        self._clock = clock
        # race-ok: rounds run from one thread at a time (the
        # run()/sync_round() caller XOR the start() loop)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        # serializes checkpoint() callers (one CheckpointStore writer)
        self._ckpt_lock = threading.Lock()
        self._peers: List[Addr] = []  # guarded-by: _lock
        self._breakers: Dict[Addr, CircuitBreaker] = {}  # guarded-by: _lock
        self._rounds_done = 0  # guarded-by: _lock
        self._stop = threading.Event()
        # race-ok: start()/stop() owner thread only
        self._thread: Optional[threading.Thread] = None
        # race-ok: post-mortem breadcrumb (loop thread writes, a
        # post-stop reader inspects); no control flow depends on it
        self.last_error: Optional[BaseException] = None
        for p in peers:
            self.add_peer(p)

    # -- peer set ----------------------------------------------------------

    def add_peer(self, addr: Addr) -> None:
        addr = (addr[0], int(addr[1]))
        with self._lock:
            if addr in self._breakers:
                return
            self._peers.append(addr)
            self._breakers[addr] = CircuitBreaker(
                failure_threshold=self.breaker_threshold,
                cooldown_s=self.breaker_cooldown_s,
                clock=self._clock,
                on_transition=lambda old, new, a=addr:
                    self._on_breaker_transition(a, old, new))

    def remove_peer(self, addr: Addr) -> None:
        addr = (addr[0], int(addr[1]))
        with self._lock:
            self._peers = [p for p in self._peers if p != addr]
            self._breakers.pop(addr, None)

    @property
    def peers(self) -> List[Addr]:
        with self._lock:
            return list(self._peers)

    def breaker(self, addr: Addr) -> CircuitBreaker:
        with self._lock:
            return self._breakers[(addr[0], int(addr[1]))]

    # -- metrics -----------------------------------------------------------

    def _count(self, name: str, n: int = 1) -> None:
        if self.recorder is not None:
            self.recorder.count(name, n)

    def _gauge(self, name: str, value) -> None:
        if self.recorder is not None and hasattr(self.recorder, "set_gauge"):
            self.recorder.set_gauge(name, value)

    def _on_breaker_transition(self, addr: Addr, old: str, new: str) -> None:
        self._count(f"breaker.to_{new}")
        self._gauge(f"breaker.state.{addr[0]}:{addr[1]}", _STATE_GAUGE[new])

    # -- rounds ------------------------------------------------------------

    def sync_round(self) -> Dict[str, int]:
        """One pass over the peer set (seeded shuffle, ``fanout`` peers
        when set).  Returns {"succeeded", "failed", "skipped"}."""
        peers = self.peers
        self._rng.shuffle(peers)
        if self.fanout is not None:
            peers = peers[:self.fanout]
        summary = {"succeeded": 0, "failed": 0, "skipped": 0}
        for addr in peers:
            try:
                breaker = self.breaker(addr)
            except KeyError:
                continue  # removed concurrently
            if not breaker.allow():
                self._count("sync.skipped_open")
                summary["skipped"] += 1
                continue
            ok = self._sync_peer(addr, breaker)
            summary["succeeded" if ok else "failed"] += 1
        if self.node.full_resync_is_pending():
            # the healing epoch retires once every peer served a
            # forced-FULL exchange
            all_peers = self.peers
            if all_peers and all(self.node.full_resync_done_for(p)
                                 for p in all_peers):
                self.node.clear_full_resync()
                self._count("sync.full_resync_complete")
        self._count("sync.supervisor.rounds")
        with self._lock:
            self._rounds_done += 1
            rounds = self._rounds_done
        if ((self.checkpoint_path or self._store is not None)
                and self.checkpoint_every > 0
                and rounds % self.checkpoint_every == 0):
            self.checkpoint()
        return summary

    def _sync_peer(self, addr: Addr, breaker: CircuitBreaker) -> bool:
        """One peer's exchange with the in-round retry budget (the
        caller already passed the breaker's gate)."""
        bo = Backoff(self.policy, seed=self._rng.getrandbits(32))
        while True:
            try:
                self._exchange(addr)
            except Exception as e:  # noqa: BLE001 — classified below
                cls = classify_failure(e)
                if cls == CLASS_UNKNOWN and not isinstance(
                        e, (OSError, RuntimeError)):
                    # a programming error: record the outcome first (a
                    # HALF_OPEN probe must not wedge), then surface it
                    breaker.record_failure()
                    self._count(f"sync.failures.{cls}")
                    self._count("sync.peer_failures")
                    raise
                self._count(f"sync.failures.{cls}")
                if cls in BREAKER_FATAL_CLASSES:
                    breaker.trip()
                    self._count("sync.peer_failures")
                    return False
                delay = (None if cls in NON_RETRYABLE_CLASSES
                         else bo.next_delay())
                if delay is None:
                    breaker.record_failure()
                    self._count("sync.peer_failures")
                    return False
                self._count(f"sync.retries.{cls}")
                self._sleep(delay)
            else:
                breaker.record_success()
                self._count("sync.successes")
                return True

    def _exchange(self, addr: Addr) -> None:
        """One exchange on the negotiated regime: digest first when the
        regime is on, the peer is not pinned legacy and no forced-FULL
        epoch is pending.  A peer answering "expected HELLO" is pinned
        legacy and the same attempt completes over the ladder; a peer
        refusing a non-default group size is pinned to the default and
        the same attempt completes at it."""
        if (self._negotiator is not None
                and self._negotiator.use_digest(addr)
                and not self.node.full_resync_is_pending()):
            gs = self._group_adapter.size(addr)
            try:
                try:
                    stats = digestsync.sync_digest(
                        self.node, addr, timeout=self.sync_timeout_s,
                        connect_timeout_s=self.connect_timeout_s,
                        group_size=gs)
                except (PeerProtocolError, framing.RemoteError) as e:
                    if (gs == digestsync.DIGEST_GROUP_LANES
                            or "group-size mismatch" not in str(e)):
                        raise
                    self._group_adapter.pin(addr,
                                            digestsync.DIGEST_GROUP_LANES)
                    self._count("digest.group_pinned")
                    stats = digestsync.sync_digest(
                        self.node, addr, timeout=self.sync_timeout_s,
                        connect_timeout_s=self.connect_timeout_s,
                        group_size=digestsync.DIGEST_GROUP_LANES)
                move = self._group_adapter.observe(addr, stats)
                if move != "hold":
                    self._count(f"digest.group_{move}")
                self._gauge("digest.group_size",
                            self._group_adapter.size(addr))
                return
            except digestsync.DigestUnsupported:
                self._negotiator.mark_legacy(addr)
                self._count("sync.digest.unsupported")
        self.node.sync_with(
            addr, timeout=self.sync_timeout_s,
            connect_timeout_s=self.connect_timeout_s,
            hello_timeout_s=self.hello_timeout_s)

    def run(self, max_rounds: Optional[int] = None,
            until: Optional[Callable[[], bool]] = None) -> int:
        """Run rounds on the jittered cadence until ``until()`` is true
        or ``max_rounds`` elapse; returns rounds run."""
        if max_rounds is None and until is None:
            raise ValueError("run() needs max_rounds and/or until: an "
                             "unbounded foreground loop is start()'s job")
        self._stop.clear()  # a stale stop() must not veto this run
        rounds = 0
        while not self._stop.is_set():
            self.sync_round()
            rounds += 1
            if until is not None and until():
                break
            if max_rounds is not None and rounds >= max_rounds:
                break
            self._pace()
        return rounds

    def _pace(self) -> None:
        if self.interval_s > 0:
            j = 1.0 + self.interval_jitter * self._rng.uniform(-1.0, 1.0)
            self._sleep(self.interval_s * j)

    # -- background operation ---------------------------------------------

    def start(self) -> None:
        """Run rounds on a daemon thread until ``stop()``.  The loop never
        dies on an exception: it counts ``sync.supervisor.errors`` and
        keeps the error on ``last_error``."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("supervisor already running")
        self._stop.clear()

        def loop() -> None:
            while not self._stop.is_set():
                try:
                    self.sync_round()
                except Exception as e:  # noqa: BLE001 — see docstring
                    self.last_error = e
                    self._count("sync.supervisor.errors")
                self._pace()

        self._thread = threading.Thread(
            target=loop, name=f"sync-supervisor-{self.node.actor}",
            daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            if not t.is_alive():
                self._thread = None
            # else keep the handle: a wedged round is still running, and
            # start() must not spawn a second loop over the same breakers

    def __enter__(self) -> "SyncSupervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- crash / recovery --------------------------------------------------

    def checkpoint(self) -> Optional[str]:
        """The periodic dump: with ``durable_dir`` the next verified
        generation plus the WAL segments it supersedes dropped
        (``Node.save_durable``), else the single-file ``Node.save``.
        Returns the written path."""
        with self._lock:
            meta = {"supervisor_rounds": self._rounds_done}
        with self._ckpt_lock:
            if self._store is not None:
                gen = self.node.save_durable(self._store, metadata=meta)
                self._count("sync.checkpoints")
                return self._store.path_for(gen)
            if not self.checkpoint_path:
                return None
            path = self.node.save(self.checkpoint_path, metadata=meta)
            self._count("sync.checkpoints")
            return path

    @classmethod
    def restore(cls, checkpoint_path: str, peers: Sequence[Addr],
                recorder=None, device="cuda", **kwargs) -> "SyncSupervisor":
        """Restart from a supervisor checkpoint: the node restored on
        ``device`` in a fresh supervisor over ``peers``; its first
        exchange with a peer that never saw it rides FULL state."""
        node = Node.restore(checkpoint_path, recorder=recorder,
                            device=device)
        kwargs.setdefault("checkpoint_path", checkpoint_path)
        return cls(node, peers, recorder=recorder, **kwargs)

    @classmethod
    def restore_durable(cls, durable_dir: str, peers: Sequence[Addr],
                        recorder=None, *, min_generation: int = 0,
                        keep_generations: int = 3, fallback_init=None,
                        device="cuda", **kwargs) -> "SyncSupervisor":
        """Crash recovery: the newest valid checkpoint generation plus the
        WAL tail (``Node.restore_durable`` on ``device``), in a fresh
        supervisor that keeps checkpointing into the same directory."""
        node = Node.restore_durable(
            durable_dir, recorder=recorder, min_generation=min_generation,
            keep=keep_generations, fallback_init=fallback_init,
            device=device)
        return cls(node, peers, recorder=recorder, durable_dir=durable_dir,
                   keep_generations=keep_generations, **kwargs)
