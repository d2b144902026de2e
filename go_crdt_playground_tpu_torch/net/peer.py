"""A networked δ-AWSet replica node: the serving write path, durable
recovery and anti-entropy with peers over TCP.

The counterpart of the JAX package's ``net/peer.Node``.  One ``Node``
owns a single-replica packed ``AWSetDeltaState`` (R = 1) on its device,
mutates it with client ops and applied payloads, and, with a
``utils/wal.DeltaWal`` attached, logs every mutation's δ durably BEFORE
the call returns: the group-commit point a serving frontend acks
against.

Anti-entropy (``serve`` answers, ``sync_with`` dials) is one push-pull
exchange per call:

    client                                server
      HELLO(actor, E, vv)  ------------->
                           <-------------  HELLO(actor, E, vv)
      PAYLOAD(δ vs server vv)  --------->  apply
                           <-------------  PAYLOAD(δ vs client vv)
      apply

FULL state on first contact (the receiver's advertised clock has never
seen the sender), δ against the advertised vv after.  The same listener
answers the digest exchange (net/digestsync.py), which opens with
MSG_DIGEST instead of HELLO and reads the node's lane digests through
``digest_summary_arrays`` (K11, ops/cuda_digest.py, on a CUDA node).
The server gives the HELLO frame a short whole-frame deadline
(``hello_timeout_s``), so idle or trickling dials release their slot in
seconds, and the PAYLOAD frame the longer ``conn_timeout_s``; at
``max_conns`` open connections new dials are shed (a lost gossip round,
which anti-entropy heals).  ``sync_with`` raises only the typed
``SyncError`` hierarchy below, plus ``framing.RemoteError`` for a
failure the server reported.

The write path of one client micro-batch (``ingest_batch``): the rows
cross to the device in one copy, K10 (ops/cuda_ingest.py) folds them into
the state, extracts the batch's δ and compacts it to K = min(128, E)
index lanes in one launch, ONE device->host copy brings the compact form
back with the record's guard (the pre-batch vv), and the WAL record
(net/framing.py's record policy) is appended with an fsync.  On the CPU the plain regime
runs (ops/ingest.py, host-side compaction), as the JAX package's CPU
backend does; the WAL records of the two packages are byte-identical for
the same op log and regime, and either restores the other's durable
directory (checkpoints in utils/checkpoint.py's format plus the WAL).

Recovery (``restore_durable``) is the newest valid checkpoint plus a
replay of the WAL tail under the replay guard: every record carries the
vv its δ was computed against, and a record whose guard the restored
state does not cover is refused with the rest of the log, which is then
reset (the "future record" rule of the reference).
"""

from __future__ import annotations

import os
import socket
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from go_crdt_playground_tpu_torch._u32 import from_numpy_u32, host, to_host
from go_crdt_playground_tpu_torch.device import resolve_device
from go_crdt_playground_tpu_torch.models import awset_delta
from go_crdt_playground_tpu_torch.models.awset_delta import AWSetDeltaState
from go_crdt_playground_tpu_torch.net import framing
from go_crdt_playground_tpu_torch.net.framing import (MODE_DELTA, MODE_FULL,
                                                      MODE_SLICE, MSG_HELLO,
                                                      MSG_PAYLOAD,
                                                      ProtocolError)
from go_crdt_playground_tpu_torch.ops import cuda_ingest
from go_crdt_playground_tpu_torch.ops import delta as delta_ops
from go_crdt_playground_tpu_torch.ops import digest as digest_ops
from go_crdt_playground_tpu_torch.ops import ingest as ingest_ops
from go_crdt_playground_tpu_torch.utils import wire
from go_crdt_playground_tpu_torch.utils.checkpoint import (
    CheckpointCorrupt, CheckpointStore, restore_checkpoint, save_checkpoint)
from go_crdt_playground_tpu_torch.utils.wal import DeltaWal


class SyncError(Exception):
    """Base of every client-side sync failure; each subclass also
    inherits the exception its call site would otherwise raise."""


class ConnectFailed(SyncError, ConnectionError):
    """The TCP dial itself failed (refused, unreachable, DNS)."""


class PeerTimeout(SyncError, socket.timeout):
    """A deadline expired; ``phase`` names the exchange step:
    "connect" | "hello" | "payload"."""

    def __init__(self, message: str, phase: str):
        super().__init__(message)
        self.phase = phase


class PeerReset(SyncError, ConnectionError):
    """The transport failed mid-exchange after the dial succeeded."""


class PeerProtocolError(SyncError, ProtocolError):
    """The peer spoke the protocol wrong (bad magic, unexpected frame
    type, malformed body, torn frame)."""


class SyncStats(NamedTuple):
    """One push-pull exchange, measured."""

    bytes_sent: int
    bytes_received: int
    mode_sent: int      # MODE_DELTA | MODE_FULL
    mode_received: int


class DigestSummary(NamedTuple):
    """The arrays of a digest summary (net/digestsync.py)."""

    vv: object
    processed: object
    digests: object


def _payload_to(p: delta_ops.DeltaPayload, device) -> delta_ops.DeltaPayload:
    """A decoded payload (numpy uint32 / bool) -> tensors on ``device``."""
    return delta_ops.DeltaPayload(*(
        torch.from_numpy(np.array(x, dtype=bool)).to(device)
        if np.asarray(x).dtype == bool else from_numpy_u32(x, device)
        for x in p))


class Node:
    """A single networked replica.  Thread-safe: one lock serializes
    local mutations, payload extraction and payload application."""

    # server bounds: a whole-frame deadline for the PAYLOAD frame, a much
    # shorter one for the opening HELLO (a real client sends it at once),
    # and a cap on connection threads (at capacity new dials are shed)
    CONN_TIMEOUT_S = 30.0
    HELLO_TIMEOUT_S = 2.0
    MAX_CONNS = 64

    def __init__(self, actor: int, num_elements: int, num_actors: int,
                 delta_semantics: str = "v2",
                 strict_reference_semantics: bool = True,
                 recorder=None, conn_timeout_s: Optional[float] = None,
                 hello_timeout_s: Optional[float] = None,
                 max_conns: Optional[int] = None, wal=None,
                 ingest_fused: bool = True,
                 wal_compact_records: bool = True, device="cuda"):
        """recorder: optional metrics sink with ``.count(name, n)`` and
        ``.count_many(dict)``; every exchange counts sync.exchanges,
        sync.bytes_sent, sync.bytes_received and sync.full_payloads
        (served and initiated alike), digest exchanges their digest.*
        names.

        conn_timeout_s / hello_timeout_s / max_conns: the server's
        PAYLOAD and HELLO frame deadlines (the HELLO one clamped to the
        PAYLOAD one) and its connection cap; defaults the class
        constants.

        wal: optional utils/wal.DeltaWal.  When attached (here or by plain
        assignment later), every applied PAYLOAD body and every local
        mutation's δ is durably logged BEFORE the call returns; see
        ``replay_wal`` / ``restore_durable`` for the recovery half.

        ingest_fused: ``ingest_batch`` applies a micro-batch and extracts
        its δ in one step (K10 on CUDA, one launch).  False runs the
        seed two-step path: the rows applied (ops/ingest.ingest_rows),
        then a separate δ extraction for the WAL record, as the
        reference's ``ingest_fused=False`` does; kept for the serve
        soak's fused-against-seed comparison.

        wal_compact_records: sparse δs are logged in the compact
        index-lane record form; False forces the dense form (both
        replay).

        device: where the replica state lives ("cuda" by default, which
        raises without a GPU); the ingest and digest regimes follow it."""
        if not 0 <= actor < num_actors:
            raise ValueError(f"actor {actor} outside actor axis {num_actors}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # pinned at construction: server, batcher and supervisor
            # threads copy rows to and launch on THIS card, whatever
            # device is current on the thread that calls
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.recorder = recorder
        self.wal = wal  # guarded-by: _lock
        # the device and E fix the regimes
        # race-ok: read-only configuration after __init__
        self._fused_regime = ingest_ops.ingest_delta_regime(num_elements,
                                                            self.device)
        # race-ok: read-only configuration after __init__
        self._digest_regime = digest_ops.digest_regime(num_elements,
                                                       self.device)
        # race-ok: read-only configuration after __init__
        self.wal_compact_records = wal_compact_records
        # race-ok: read-only configuration after __init__
        self.ingest_fused = ingest_fused
        # freshest causal-stability vector each peer actor advertised in
        # an applied payload: the peer half of deletion_frontier
        self._peer_processed: dict = {}  # guarded-by: _lock
        # last durably restored or saved store generation
        self.generation = 0  # guarded-by: _lock
        # regressed-restore healing epoch (see restore_durable)
        self.full_resync_pending = False  # guarded-by: _lock
        self._full_resync_done: set = set()  # guarded-by: _lock
        self._resync_flag_path: Optional[str] = None  # guarded-by: _lock
        self.actor = actor
        self.num_elements = num_elements
        self.num_actors = num_actors
        self.delta_semantics = delta_semantics
        self.strict_reference_semantics = strict_reference_semantics
        self._lock = threading.Lock()
        self._state = awset_delta.init(  # guarded-by: _lock
            1, num_elements, num_actors,
            actors=np.asarray([actor], np.uint32), device=self.device)
        # race-ok: serve()/close() owner thread; _accept_loop snapshots
        self._server_sock: Optional[socket.socket] = None
        # race-ok: serve()/close() owner thread only
        self._server_thread: Optional[threading.Thread] = None
        self._closing = False  # race-ok: benign monotonic stop flag
        self.conn_timeout_s = (self.CONN_TIMEOUT_S if conn_timeout_s is None
                               else conn_timeout_s)
        self.hello_timeout_s = min(
            self.HELLO_TIMEOUT_S if hello_timeout_s is None
            else hello_timeout_s, self.conn_timeout_s)
        # the body cap of every peer-dialect read: a hostile length
        # header cannot commit a reader past the largest legal FULL body
        # race-ok: read-only after __init__
        self._frame_cap = framing.peer_frame_cap(num_elements, num_actors)
        self._conn_slots = threading.BoundedSemaphore(
            self.MAX_CONNS if max_conns is None else max_conns)

    # -- the state as one row ------------------------------------------------

    # requires-lock: _lock
    def _row(self) -> AWSetDeltaState:
        return AWSetDeltaState(*(x[0] for x in self._state))

    # requires-lock: _lock
    def _set_row(self, row: AWSetDeltaState) -> None:
        self._state = AWSetDeltaState(*(x.unsqueeze(0) for x in row))

    # requires-lock: _lock
    def _host_vv(self) -> np.ndarray:
        return host(self._state.vv[0])

    # -- local ops (reference Add/Del, δ-variant) ----------------------------

    def _check_ids(self, element_ids) -> None:
        for e in element_ids:
            if not 0 <= e < self.num_elements:
                raise ValueError(f"element id {e} outside universe "
                                 f"{self.num_elements}")

    def add(self, *element_ids: int) -> None:
        """Add elements; each ticks the clock once (awset.go:89-94)."""
        self._check_ids(element_ids)
        if not element_ids:
            return
        with self._lock:
            pre_vv = self._host_vv() if self.wal is not None else None
            self._state = awset_delta.add_elements(self._state, 0,
                                                   list(element_ids))
            if pre_vv is not None:
                self._log_local_delta(pre_vv)

    def delete(self, *element_ids: int) -> None:
        """δ-Del: one clock tick per call, one shared deletion dot for all
        hit keys (awset-delta_test.go:14-33)."""
        self._check_ids(element_ids)
        selector = np.zeros(self.num_elements, bool)
        selector[list(element_ids)] = True
        with self._lock:
            pre_vv = self._host_vv() if self.wal is not None else None
            self._state = awset_delta.del_elements(self._state, 0, selector)
            if pre_vv is not None:
                self._log_local_delta(pre_vv)

    def ingest_batch(self, add_rows: np.ndarray, del_rows: np.ndarray,
                     live: Optional[np.ndarray] = None,
                     stripe_hint: Optional[np.ndarray] = None) -> None:
        """Apply one packed ``(B, E)`` micro-batch of client op-rows (row
        b's add selector is one Add(k...) call, its del selector one
        Del(k...) call, ``live`` masks padding rows) and WAL-log the
        batch's δ BEFORE returning: one fsync covers the whole batch.

        ``stripe_hint`` is the admission scheduler's per-row stripe
        assignment (serve/scheduler.py; int per row, negatives
        unhinted).  Only a target with replicated ingest stripes
        (parallel/meshtarget2d.Mesh2DApplyTarget) acts on it; here it is
        checked for shape and otherwise advisory."""
        add_rows = np.asarray(add_rows, bool)
        del_rows = np.asarray(del_rows, bool)
        if add_rows.shape != del_rows.shape or add_rows.ndim != 2 \
                or add_rows.shape[1] != self.num_elements:
            raise ValueError(
                f"op-batch shape {add_rows.shape}/{del_rows.shape} does "
                f"not match (B, {self.num_elements})")
        if live is None:
            live = np.ones(add_rows.shape[0], bool)
        live = np.asarray(live, bool)
        if live.shape != (add_rows.shape[0],):
            raise ValueError(f"live mask shape {live.shape} does not "
                             f"match batch axis {add_rows.shape[0]}")
        if stripe_hint is not None:
            stripe_hint = np.asarray(stripe_hint, np.int32)
            if stripe_hint.shape != (add_rows.shape[0],):
                raise ValueError(
                    f"stripe hint shape {stripe_hint.shape} does not "
                    f"match batch axis {add_rows.shape[0]}")
        prep = self._prepare_batch(add_rows, del_rows, live, stripe_hint)
        with self._lock:
            self._apply_batch_locked(add_rows, del_rows, live,
                                     stripe_hint=stripe_hint, prep=prep)

    def _prepare_batch(self, add_rows: np.ndarray, del_rows: np.ndarray,
                       live: np.ndarray, stripe_hint: Optional[np.ndarray]):
        """Work on a batch that reads no replica state, run before the
        node lock is taken; its result reaches ``_apply_batch_locked``
        as ``prep``.  None here: the sequential path has none."""
        return None

    # requires-lock: _lock
    def _apply_batch_locked(self, add_rows: np.ndarray, del_rows: np.ndarray,
                            live: np.ndarray,
                            stripe_hint: Optional[np.ndarray] = None,
                            prep=None) -> None:
        """The apply+log half of ``ingest_batch``: the rows reach the
        device in one copy, the node's regime applies them and returns
        the δ (compacted on the device when there is a record to write),
        and the record is appended.  On the K10 path the record's guard
        (the pre-batch vv) comes back with the compact form in one
        device->host copy, and the dense payload in one more only when
        the compact form overflowed (cuda_ingest.record_to_host).
        With ``ingest_fused`` off the rows are applied first and the δ
        extracted against the pre-batch vv after (two steps).  The
        replica flavors (parallel/meshtarget.py) override this seam;
        the sequential path ignores ``stripe_hint`` and ``prep``."""
        num_b, num_e = add_rows.shape
        rows = torch.from_numpy(np.concatenate(
            [add_rows.reshape(-1), del_rows.reshape(-1), live])).to(
                self.device)
        add_t = rows[:num_b * num_e].view(num_b, num_e)
        del_t = rows[num_b * num_e:2 * num_b * num_e].view(num_b, num_e)
        live_t = rows[2 * num_b * num_e:]
        if not self.ingest_fused:
            pre_vv = self._host_vv() if self.wal is not None else None
            self._set_row(ingest_ops.ingest_rows(self._row(), add_t, del_t,
                                                 live_t))
            self._count("ingest.dispatches")
            if pre_vv is not None:
                self._count("ingest.dispatches")  # the δ extraction
                self._log_local_delta(pre_vv)
            return
        fused_fn, k = self._fused_regime
        if self.wal is None:
            k = 0  # no record to write: skip the compaction
        pre = self._row()
        merged, payload, compact = fused_fn(pre, add_t, del_t, live_t,
                                            k_changed=k, k_deleted=k)
        self._set_row(merged)
        self._count("ingest.dispatches")
        if self.wal is not None:
            pre_vv, payload, compact = cuda_ingest.record_to_host(
                pre.vv, payload, compact)
            self._append_delta_record(pre_vv, payload, compact)

    def members(self) -> np.ndarray:
        """Sorted live element ids (SortedValues, awset.go:61-70, on ids)."""
        with self._lock:
            return np.nonzero(host(self._state.present[0]))[0]

    def members_vv(self) -> Tuple[np.ndarray, np.ndarray]:
        """Membership and vv under ONE lock hold (the serve QUERY read)."""
        with self._lock:
            present = host(self._state.present[0])
            vv = self._host_vv()
        return np.nonzero(present)[0], vv

    def vv(self) -> np.ndarray:
        with self._lock:
            return self._host_vv()

    def state_slice(self) -> AWSetDeltaState:
        """The single-replica state, one row of tensors."""
        with self._lock:
            return self._row()

    # -- payload plumbing ----------------------------------------------------

    # requires-lock: _lock
    def _extract_payload(self, peer_vv: np.ndarray):
        """The FULL/DELTA ladder's payload for a peer that advertised
        ``peer_vv``, before encoding: ``(mode, processed, payload)``, FULL
        (our whole state) when the peer's clock has never seen us, else
        the δ against its clock.  Split from ``_extract_msg`` so the
        digest tier's δ-fallback rung can count the lanes it ships."""
        me = self._row()
        if int(peer_vv[self.actor]) == 0:
            payload = delta_ops.DeltaPayload(
                src_vv=me.vv, changed=me.present, ch_da=me.dot_actor,
                ch_dc=me.dot_counter, deleted=me.deleted,
                del_da=me.del_dot_actor, del_dc=me.del_dot_counter,
                src_actor=me.actor, src_processed=me.processed)
            return MODE_FULL, me.processed, payload
        payload = delta_ops.delta_extract(
            me, from_numpy_u32(np.asarray(peer_vv, np.uint32), self.device))
        return MODE_DELTA, me.processed, payload

    # requires-lock: _lock
    def _extract_msg(self, peer_vv: np.ndarray) -> Tuple[int, bytes]:
        """The PAYLOAD frame body for a peer that advertised peer_vv."""
        mode, processed, payload = self._extract_payload(peer_vv)
        return mode, framing.encode_payload_msg(mode, self.actor,
                                                processed, payload)

    # requires-lock: _lock
    def _apply_msg(self, body: bytes) -> int:
        """Decode and apply a PAYLOAD frame body.  Write-ahead: the
        decoded-valid body is logged, prefixed with the replay guard (our
        pre-apply vv), before the state mutates; replay is an idempotent
        merge, so a logged-but-unapplied record is harmless."""
        mode, payload = framing.decode_payload_msg(
            body, self.num_elements, self.num_actors)
        if self.wal is not None:
            self.wal.append(self._guard_bytes() + body)
            self._count("wal.dense_records")
        self._apply_payload(mode, payload)
        return mode

    # requires-lock: _lock
    def _apply_payload(self, mode: int, payload) -> None:
        """Apply one decoded payload (no WAL side effects)."""
        me = self._row()
        p = _payload_to(payload, self.device)
        if mode == MODE_FULL:
            src = AWSetDeltaState(
                vv=p.src_vv, present=p.changed, dot_actor=p.ch_da,
                dot_counter=p.ch_dc, actor=p.src_actor, deleted=p.deleted,
                del_dot_actor=p.del_da, del_dot_counter=p.del_dc,
                processed=p.src_processed)
            merged = delta_ops.full_merge_delta(me, src, self.delta_semantics)
        elif mode == MODE_SLICE:
            # keyspace handoff: the fenced donor slice overwrites its lanes
            merged = delta_ops.slice_apply(me, p)
        else:
            # MODE_DELTA and MODE_DIGEST both apply by δ arbitration
            merged = delta_ops.delta_apply(me, p, self.delta_semantics,
                                           self.strict_reference_semantics)
        self._set_row(merged)
        # deletion-GC bookkeeping: the freshest processed vector this
        # origin actor advertised (a monotone join: replays under-claim)
        src_actor = int(payload.src_actor)
        if src_actor != self.actor:
            proc = np.asarray(payload.src_processed, np.uint32)
            prev = self._peer_processed.get(src_actor)
            self._peer_processed[src_actor] = (
                proc.copy() if prev is None else np.maximum(prev, proc))

    # requires-lock: _lock
    def _guard_bytes(self, vv: Optional[np.ndarray] = None) -> bytes:
        """The replay guard: the vv this record's δ was computed against
        (default: our current vv)."""
        if vv is None:
            vv = self._host_vv()
        return wire._encode_vv_py(np.asarray(vv, np.uint32))

    # requires-lock: _lock
    def _log_local_delta(self, pre_vv: np.ndarray) -> None:
        """WAL a local mutation as the δ it produced against the pre-op
        vv (which is also the record's guard)."""
        payload = delta_ops.delta_extract(
            self._row(), from_numpy_u32(pre_vv, self.device))
        self._append_delta_record(pre_vv, payload)

    # requires-lock: _lock
    def _append_delta_record(self, pre_vv: np.ndarray, payload,
                             compact=None,
                             num_elements: Optional[int] = None) -> None:
        """Append one δ record in the form framing.encode_delta_wal_record
        picks: the on-device fixed-K form when given and not overflowed,
        else host-side compaction or the dense record."""
        body, is_compact = framing.encode_delta_wal_record(
            pre_vv, self.actor, payload, compact,
            compact_records=self.wal_compact_records,
            num_elements=num_elements)
        self.wal.append(body)
        self._count("wal.compact_records" if is_compact
                    else "wal.dense_records")

    # -- keyspace handoff ----------------------------------------------------

    def extract_slice(self, element_mask: np.ndarray) -> bytes:
        """The keyspace-handoff transfer payload: this replica's complete
        state for the masked elements (live entries with their dots,
        un-resurrected deletion records with theirs, our vv and
        processed) as a MODE_SLICE PAYLOAD body, applied by overwrite."""
        mask = np.asarray(element_mask, bool)
        if mask.shape != (self.num_elements,):
            raise ValueError(f"slice mask shape {mask.shape} does not "
                             f"match universe ({self.num_elements},)")
        m = torch.from_numpy(mask.copy()).to(self.device)
        with self._lock:
            me = self._row()
            p = delta_ops.delta_extract(me, torch.zeros_like(me.vv))
            p = p._replace(
                changed=p.changed & m, ch_da=torch.where(m, p.ch_da, 0),
                ch_dc=torch.where(m, p.ch_dc, 0), deleted=p.deleted & m,
                del_da=torch.where(m, p.del_da, 0),
                del_dc=torch.where(m, p.del_dc, 0))
            return framing.encode_payload_msg(MODE_SLICE, self.actor,
                                              me.processed, p)

    def apply_payload_body(self, body: bytes) -> None:
        """Apply one PAYLOAD frame body delivered out of band (a handoff
        push, a peer's δ): WAL-logged with its replay guard before the
        state mutates."""
        with self._lock:
            self._apply_msg(body)

    # -- shard replication ---------------------------------------------------

    def apply_wal_record(self, body: bytes) -> str:
        """Apply ONE shipped WAL record body (a standby tailing its
        primary): decode it as ``replay_wal`` does, write the ORIGINAL
        bytes ahead to our own WAL, then apply.  Returns ``"applied"``,
        or ``"future"`` when the guard outruns our vv (a gap: the caller
        must catch up, never skip).  Raises ``ProtocolError`` or
        ``ValueError`` for an undecodable record."""
        if body[:1] == bytes((wire.WAL_COMPACT_TAG,)):
            guard, payload = wire.decode_compact_wal_body(
                body, self.num_elements, self.num_actors)
            mode = MODE_DELTA
        else:
            guard, pos = wire._decode_vv_py(body, 0, self.num_actors)
            mode, payload = framing.decode_payload_msg(
                body[pos:], self.num_elements, self.num_actors)
        with self._lock:
            if np.any(guard > self._host_vv()):
                return "future"
            if self.wal is not None:
                self.wal.append(body)
            self._apply_payload(mode, payload)
        return "applied"

    # -- digest-driven anti-entropy (net/digestsync.py) ---------------------

    def _digest_fn(self, state_slice: AWSetDeltaState,
                   group_size: int) -> torch.Tensor:
        """Group digests of a state slice on this node's regime (K11 on
        CUDA, the plain pass on the CPU; ops/digest.digest_regime)."""
        return self._digest_regime(state_slice, group_size)

    def digest_summary_arrays(self, group_size: int) -> DigestSummary:
        """``(vv, processed, digests)`` of a digest summary as numpy
        uint32: the state reference is snapshotted under the lock (states
        are replaced, never written in place), the digests are computed
        outside it, and the three reach the host in one copy."""
        with self._lock:
            me = self._row()
        # transfer-ok: deliberately OUTSIDE the lock block above (only
        # the state ref is read under it); one G-word summary pull —
        # callers in the digest-sync exchange may still hold theirs
        return to_host(DigestSummary(me.vv, me.processed,
                                     self._digest_fn(me, group_size)))

    def note_peer_processed(self, src_actor: int, processed) -> None:
        """Record a peer's advertised causal-stability vector without a
        payload (the ``_apply_payload`` bookkeeping): a quiescent digest
        exchange ships no state yet proves what the peer processed, and
        the deletion-GC frontier keeps moving.  Monotone join."""
        src_actor = int(src_actor)
        if src_actor == self.actor:
            return
        proc = np.asarray(processed, np.uint32)
        with self._lock:
            prev = self._peer_processed.get(src_actor)
            self._peer_processed[src_actor] = (
                proc.copy() if prev is None else np.maximum(prev, proc))

    # -- deletion-record GC --------------------------------------------------

    def deletion_frontier(self, participants=None) -> np.ndarray:
        """The causal-stability frontier this node can PROVE: the
        elementwise min of its own processed vector and the freshest
        processed vector each PARTICIPATING replica actor advertised.  A
        participant never heard from contributes zeros.  Membership is
        declared, never inferred: ``participants=None`` yields the
        all-zeros frontier (GC disabled); an empty set declares this
        replica the whole deployment."""
        if participants is None:
            return np.zeros(self.num_actors, np.uint32)
        with self._lock:
            own = host(self._state.processed[0])
            heard = dict(self._peer_processed)
        out = own
        zeros = np.zeros_like(own)
        for a in participants:
            a = int(a)
            if a == self.actor:
                continue
            out = np.minimum(out, heard.get(a, zeros))
        return out

    def gc_deletions(self, frontier: Optional[np.ndarray] = None,
                     participants=None) -> dict:
        """Drop causally-stable deletion records (ops/delta.gc_apply).
        v2 semantics only; no WAL record (a replay may resurrect dropped
        records and the next cycle re-drops them).  The frontier
        defaults to ``deletion_frontier(participants)``."""
        if self.delta_semantics != "v2":
            raise ValueError("deletion GC requires v2 (record-absorbing) "
                             "delta semantics")
        if frontier is None:
            frontier = self.deletion_frontier(participants)
        f = from_numpy_u32(np.asarray(frontier, np.uint32), self.device)
        with self._lock:
            before = int(self._state.deleted[0].sum())
            self._state = delta_ops.gc_apply(self._state, f)
            after = int(self._state.deleted[0].sum())
        return {"dropped": before - after, "remaining": after}

    def replay_wal(self, wal) -> dict:
        """Apply every intact, causally safe WAL record (oldest first)
        through the payload-apply path: state = checkpoint ⊔
        replay(tail).  One prefix rule for three stops: a CRC/framing
        tear (the scan), an undecodable record (``wal.bad_records``), a
        record whose replay guard the state does not cover
        (``wal.future_records``: on a regressed base it would
        fast-forward our vv past lanes delivered only in truncated
        records).  Idempotent.  Detaches ``self.wal`` for the duration
        so replay never re-logs its own records."""
        replayed = bad = future = 0
        compact_n = dense_n = 0
        with self._lock:
            saved, self.wal = self.wal, None
        try:
            for body in wal.records():
                try:
                    if body[:1] == bytes((wire.WAL_COMPACT_TAG,)):
                        guard, payload = wire.decode_compact_wal_body(
                            body, self.num_elements, self.num_actors)
                        with self._lock:
                            if np.any(guard > self._host_vv()):
                                future += 1
                                break
                            self._apply_payload(MODE_DELTA, payload)
                        compact_n += 1
                    else:
                        guard, pos = wire._decode_vv_py(body, 0,
                                                        self.num_actors)
                        with self._lock:
                            if np.any(guard > self._host_vv()):
                                future += 1
                                break
                            self._apply_msg(body[pos:])
                        dense_n += 1
                except (ProtocolError, ValueError):
                    # CRC-clean but unreadable: trust nothing after it
                    bad += 1
                    break
                replayed += 1
        finally:
            with self._lock:
                self.wal = saved
        if self.recorder is not None:
            # one literal call a name: the metrics contract reads the
            # names the soaks adjudicate off these call sites
            if replayed:
                self.recorder.count("wal.records", replayed)
            if compact_n:
                self.recorder.count("wal.replayed_compact", compact_n)
            if dense_n:
                self.recorder.count("wal.replayed_dense", dense_n)
            if bad:
                self.recorder.count("wal.bad_records", bad)
            if future:
                self.recorder.count("wal.future_records", future)
        return {"replayed": replayed, "bad": bad, "future": future,
                "compact": compact_n, "dense": dense_n}

    # -- crash / recovery ----------------------------------------------------

    def _node_metadata(self, metadata: Optional[dict]) -> dict:
        meta = dict(metadata or {})
        meta.update(
            actor=self.actor,
            delta_semantics=self.delta_semantics,
            strict_reference_semantics=self.strict_reference_semantics,
        )
        return meta

    def save(self, path: str, metadata: Optional[dict] = None) -> str:
        """Checkpoint this node's replica state (utils/checkpoint), with
        the actor and semantics switches in the metadata."""
        with self._lock:
            state = self._state
        return save_checkpoint(path, state,
                               metadata=self._node_metadata(metadata))

    @classmethod
    def _from_checkpoint(cls, ck, where: str, recorder, device,
                         node_kwargs: Optional[dict] = None) -> "Node":
        meta = ck.metadata
        missing = [k for k in ("actor", "delta_semantics",
                               "strict_reference_semantics")
                   if k not in meta]
        if missing:
            raise ValueError(
                f"checkpoint {where!r} lacks node metadata {missing}: a "
                "node restores only from checkpoints a node saved")
        node = cls(
            actor=int(meta["actor"]),
            num_elements=int(ck.state.present.shape[-1]),
            num_actors=int(ck.state.vv.shape[-1]),
            delta_semantics=meta["delta_semantics"],
            strict_reference_semantics=meta["strict_reference_semantics"],
            recorder=recorder, device=device, **(node_kwargs or {}))
        with node._lock:
            node._state = ck.state
        return node

    @classmethod
    def restore(cls, path: str, recorder=None, device="cuda") -> "Node":
        """Recover a node from a checkpoint written by ``save``: state,
        actor identity and semantics switches."""
        return cls._from_checkpoint(restore_checkpoint(path, device), path,
                                    recorder, device)

    def full_resync_is_pending(self) -> bool:
        """Locked read of the healing-epoch flag."""
        with self._lock:
            return self.full_resync_pending

    def full_resync_done_for(self, addr: Tuple[str, int]) -> bool:
        with self._lock:
            return (addr[0], int(addr[1])) in self._full_resync_done

    def clear_full_resync(self) -> None:
        """End the regressed-restore healing epoch and remove its durable
        flag."""
        with self._lock:
            self.full_resync_pending = False
            self._full_resync_done.clear()
            flag_path = self._resync_flag_path
        if flag_path is not None:
            try:
                os.unlink(flag_path)
            except OSError:
                pass

    def save_durable(self, store, metadata: Optional[dict] = None) -> int:
        """Checkpoint into a ``utils/checkpoint.CheckpointStore`` and
        retire the WAL records the dump contains.  Two-phase: under the
        lock the state reference is snapshotted (states are never
        mutated in place) and the WAL is sealed; the dump runs outside
        the lock; the sealed segments are dropped once the checkpoint is
        durable.  Returns the new generation."""
        meta = self._node_metadata(metadata)
        with self._lock:
            state = self._state
            wal = self.wal
            sealed = wal.seal() if wal is not None else None
        gen = store.save(state, metadata=meta)
        if sealed is not None and wal is not None:
            wal.drop_segments(sealed)
        with self._lock:
            self.generation = gen
        return gen

    @classmethod
    def restore_durable(cls, dirpath: str, *, recorder=None,
                        min_generation: int = 0, keep: int = 3,
                        fallback_init=None, device="cuda",
                        node_kwargs: Optional[dict] = None) -> "Node":
        """Crash recovery: the newest VALID checkpoint generation
        (fallback past corrupt ones, fenced by ``min_generation``) plus a
        replay of the WAL tail, with the WAL left attached.
        ``fallback_init`` (a zero-argument Node factory) covers the
        died-before-first-checkpoint case.  ``node_kwargs``: extra
        constructor arguments of ``cls`` (a mesh replica's
        ``mesh_devices``; placement is deployment configuration, so the
        checkpoint does not carry it).  A regressed restore (an older
        generation than the newest on disk, or a refused record) persists
        a ``resync-pending`` flag and arms the forced-FULL healing
        epoch."""
        device = resolve_device(device)
        store = CheckpointStore(dirpath, keep=keep, recorder=recorder)
        latest_on_disk = store.latest_generation()
        fell_back = False
        try:
            gen, ck = store.restore(min_generation=min_generation,
                                    device=device)
        except (FileNotFoundError, CheckpointCorrupt):
            if fallback_init is None:
                raise
            node = fallback_init()
            if node.recorder is None:
                node.recorder = recorder
            gen = 0
            fell_back = latest_on_disk > 0
        else:
            node = cls._from_checkpoint(ck, dirpath, recorder, device,
                                        node_kwargs)
        with node._lock:
            node.generation = gen
        wal = DeltaWal(os.path.join(dirpath, "wal"), recorder=recorder)
        stats = node.replay_wal(wal)
        if stats["bad"] or stats["future"]:
            # the refused suffix can never replay, and new acked records
            # must not land behind it: reset to a clean log
            wal.truncate()
        with node._lock:
            node.wal = wal
        regressed = (fell_back or (0 < gen < latest_on_disk)
                     or stats["future"] > 0)
        flag_path = os.path.join(dirpath, "resync-pending")
        with node._lock:
            node._resync_flag_path = flag_path
        if regressed:
            with open(flag_path, "w") as f:
                f.write("regressed restore: full resync pending\n")
                f.flush()
                os.fsync(f.fileno())
            if recorder is not None:
                recorder.count("restore.full_resync")
        pending = regressed or os.path.exists(flag_path)
        with node._lock:
            node.full_resync_pending = pending
        return node

    # -- server ------------------------------------------------------------

    def serve(self, host: str = "127.0.0.1",
              port: int = 0) -> Tuple[str, int]:
        """Start answering sync requests; returns the bound (host, port)."""
        if self._server_sock is not None:
            raise RuntimeError("already serving")
        sock = socket.create_server((host, port))
        self._server_sock = sock
        self._closing = False
        self._server_thread = threading.Thread(
            target=self._accept_loop, name=f"crdt-node-{self.actor}",
            daemon=True)
        self._server_thread.start()
        return sock.getsockname()[:2]

    def _accept_loop(self) -> None:
        sock = self._server_sock  # snapshot: close() may null the field
        assert sock is not None
        while not self._closing:
            try:
                conn, _ = sock.accept()
            except OSError:
                return  # socket closed
            if not self._conn_slots.acquire(blocking=False):
                conn.close()  # at capacity: shed the dial, do not queue
                continue
            # any failure to start the handler sheds the dial and returns
            # the slot, else capacity decays one leak at a time
            handed_off = False
            try:
                threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True).start()
                handed_off = True
            except RuntimeError:
                pass  # OS thread exhaustion: shed the dial, keep serving
            finally:
                if not handed_off:
                    conn.close()
                    self._conn_slots.release()

    def _handle(self, conn: socket.socket) -> None:
        try:
            self._serve_conn(conn)
        finally:
            self._conn_slots.release()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            with conn:
                # the base timeout covers the sends; each recv_frame sets
                # a whole-frame deadline and restores this afterwards
                conn.settimeout(self.conn_timeout_s)
                msg_type, body = framing.recv_frame(
                    conn, timeout=self.hello_timeout_s,
                    max_body=self._frame_cap)
                if msg_type == framing.MSG_DIGEST:
                    # the digest exchange answers on the same listener
                    from go_crdt_playground_tpu_torch.net import digestsync

                    digestsync.serve_digest_exchange(self, conn, body)
                    return
                if msg_type != MSG_HELLO:
                    framing.send_frame(conn, framing.MSG_ERROR,
                                       f"expected HELLO, got {msg_type}"
                                       .encode())
                    return
                recv = framing.frame_size(len(body))
                try:
                    _, peer_vv = framing.decode_hello(
                        body, self.num_elements, self.num_actors)
                except ProtocolError as e:
                    framing.send_frame(conn, framing.MSG_ERROR,
                                       str(e).encode())
                    return
                sent = framing.send_frame(
                    conn, MSG_HELLO, framing.encode_hello(
                        self.actor, self.num_elements, self.vv()))
                msg_type, body = framing.recv_frame(
                    conn, timeout=self.conn_timeout_s,
                    max_body=self._frame_cap)
                if msg_type != MSG_PAYLOAD:
                    framing.send_frame(conn, framing.MSG_ERROR,
                                       f"expected PAYLOAD, got {msg_type}"
                                       .encode())
                    return
                try:
                    with self._lock:
                        self._apply_msg(body)
                        # extract after absorbing the client's payload so
                        # transitively learned entries ride along
                        reply_mode, reply = self._extract_msg(peer_vv)
                except (ProtocolError, ValueError) as e:
                    # ValueError: the apply hit a closed WAL (a teardown
                    # race); the peer gets an error frame and retries
                    framing.send_frame(conn, framing.MSG_ERROR,
                                       str(e).encode())
                    return
                sent += framing.send_frame(conn, MSG_PAYLOAD, reply)
                recv += framing.frame_size(len(body))
                self._record(reply_mode, bytes_sent=sent,
                             bytes_received=recv)
        except (ProtocolError, framing.RemoteError, OSError):
            pass  # connection-scoped failure; anti-entropy self-heals

    def close(self) -> None:
        """Stop serving (the listener and its accept thread).  The node
        does not own its WAL, which the caller closes."""
        self._closing = True
        sock = self._server_sock
        if sock is not None:
            try:
                # wakes the accept thread (close alone leaves it blocked)
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            finally:
                self._server_sock = None
        if self._server_thread is not None:
            self._server_thread.join(timeout=5.0)
            self._server_thread = None

    def __enter__(self) -> "Node":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- client ------------------------------------------------------------

    def sync_with(self, addr: Tuple[str, int], timeout: float = 30.0, *,
                  connect_timeout_s: Optional[float] = None,
                  hello_timeout_s: Optional[float] = None) -> SyncStats:
        """One push-pull anti-entropy exchange with the peer at addr.

        ``timeout`` bounds the PAYLOAD reply (the server extracts it after
        applying ours), ``connect_timeout_s`` the dial (default
        ``timeout``) and ``hello_timeout_s`` the HELLO reply (default this
        node's own, clamped to ``timeout``).  While a regressed restore's
        healing epoch is pending, the first exchange with each peer
        advertises a zero vv so the peer ships FULL state."""
        connect_t = timeout if connect_timeout_s is None else \
            connect_timeout_s
        hello_t = min(self.hello_timeout_s if hello_timeout_s is None
                      else hello_timeout_s, timeout)
        try:
            sock = socket.create_connection(addr, timeout=connect_t)
        except socket.timeout as e:
            raise PeerTimeout(f"connect to {addr}: {e}",
                              phase="connect") from e
        except OSError as e:
            raise ConnectFailed(f"connect to {addr}: {e}") from e
        # sends ride the payload budget, not the dial's
        sock.settimeout(timeout)
        addr_key = (addr[0], int(addr[1]))
        with self._lock:
            forcing_full = (self.full_resync_pending
                            and addr_key not in self._full_resync_done)
            adv_vv = (np.zeros(self.num_actors, np.uint32) if forcing_full
                      else self._host_vv())
        with sock:
            phase = "hello"
            try:
                sent = framing.send_frame(
                    sock, MSG_HELLO, framing.encode_hello(
                        self.actor, self.num_elements, adv_vv))
                msg_type, body = framing.recv_frame(
                    sock, timeout=hello_t, max_body=self._frame_cap)
                if msg_type != MSG_HELLO:
                    raise ProtocolError(f"expected HELLO, got {msg_type}")
                _, peer_vv = framing.decode_hello(
                    body, self.num_elements, self.num_actors)
                recv = framing.frame_size(len(body))
                with self._lock:
                    mode_sent, out = self._extract_msg(peer_vv)
                phase = "payload"
                sent += framing.send_frame(sock, MSG_PAYLOAD, out)
                msg_type, body = framing.recv_frame(
                    sock, timeout=timeout, max_body=self._frame_cap)
                if msg_type != MSG_PAYLOAD:
                    raise ProtocolError(f"expected PAYLOAD, got {msg_type}")
                recv += framing.frame_size(len(body))
                with self._lock:
                    mode_recv = self._apply_msg(body)
            except SyncError:
                raise
            except framing.RemoteError:
                raise  # already typed; carries the server's message
            except socket.timeout as e:
                raise PeerTimeout(f"{phase} exchange with {addr}: {e}",
                                  phase=phase) from e
            except framing.TruncatedFrame as e:
                # a torn frame is transport loss: the retryable class
                raise PeerReset(f"{phase} exchange with {addr}: {e}") from e
            except ProtocolError as e:
                raise PeerProtocolError(str(e)) from e
            except OSError as e:
                raise PeerReset(f"{phase} exchange with {addr}: {e}") from e
        if forcing_full:
            with self._lock:
                self._full_resync_done.add(addr_key)
        self._record(mode_sent, bytes_sent=sent, bytes_received=recv)
        return SyncStats(bytes_sent=sent, bytes_received=recv,
                         mode_sent=mode_sent, mode_received=mode_recv)

    def _count(self, name: str, n: int = 1) -> None:
        if self.recorder is not None:
            self.recorder.count(name, n)

    def _record(self, mode_sent: int, bytes_sent: int,
                bytes_received: int) -> None:
        if self.recorder is None:
            return
        counts = {"sync.exchanges": 1, "sync.bytes_sent": bytes_sent,
                  "sync.bytes_received": bytes_received}
        if mode_sent == MODE_FULL:
            counts["sync.full_payloads"] = 1
        self.recorder.count_many(counts)
