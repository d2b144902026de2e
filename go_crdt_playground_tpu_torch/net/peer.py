"""A δ-AWSet replica node: the serving write path and durable recovery.

The counterpart of the JAX package's ``net/peer.Node``, without its
socket half (``serve``, ``sync_with`` and the digest summaries come with
the digest-sync slice).  One ``Node`` owns a single-replica packed
``AWSetDeltaState`` (R = 1) on its device, mutates it with client ops
and applied payloads, and, with a ``utils/wal.DeltaWal`` attached, logs
every mutation's δ durably BEFORE the call returns: the group-commit
point a serving frontend acks against.

The write path of one client micro-batch (``ingest_batch``): the rows
cross to the device in one copy, K10 (ops/cuda_ingest.py) folds them into
the state and extracts the batch's δ in one launch, the δ is compacted
to K = min(128, E) index lanes on the device, ONE device->host copy
brings the compact form back, and the WAL record (net/framing.py's
record policy) is appended with an fsync.  On the CPU the plain regime
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

from go_crdt_playground_tpu_torch._u32 import from_numpy_u32, host
from go_crdt_playground_tpu_torch.device import resolve_device
from go_crdt_playground_tpu_torch.models import awset_delta
from go_crdt_playground_tpu_torch.models.awset_delta import AWSetDeltaState
from go_crdt_playground_tpu_torch.net import framing
from go_crdt_playground_tpu_torch.net.framing import (MODE_DELTA, MODE_FULL,
                                                      MODE_SLICE,
                                                      ProtocolError)
from go_crdt_playground_tpu_torch.ops import delta as delta_ops
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


def _payload_to(p: delta_ops.DeltaPayload, device) -> delta_ops.DeltaPayload:
    """A decoded payload (numpy uint32 / bool) -> tensors on ``device``."""
    return delta_ops.DeltaPayload(*(
        torch.from_numpy(np.array(x, dtype=bool)).to(device)
        if np.asarray(x).dtype == bool else from_numpy_u32(x, device)
        for x in p))


class Node:
    """A single replica.  Thread-safe: one lock serializes local
    mutations, payload extraction and payload application."""

    def __init__(self, actor: int, num_elements: int, num_actors: int,
                 delta_semantics: str = "v2",
                 strict_reference_semantics: bool = True,
                 recorder=None, wal=None, wal_compact_records: bool = True,
                 device="cuda"):
        """recorder: optional metrics sink with ``.count(name, n)``.

        wal: optional utils/wal.DeltaWal.  When attached (here or by plain
        assignment later), every applied PAYLOAD body and every local
        mutation's δ is durably logged BEFORE the call returns; see
        ``replay_wal`` / ``restore_durable`` for the recovery half.

        wal_compact_records: sparse δs are logged in the compact
        index-lane record form; False forces the dense form (both
        replay).

        device: where the replica state lives ("cuda" by default, which
        raises without a GPU); the ingest regime follows it."""
        if not 0 <= actor < num_actors:
            raise ValueError(f"actor {actor} outside actor axis {num_actors}")
        self.device = resolve_device(device)
        self.recorder = recorder
        self.wal = wal  # guarded-by: _lock
        # read-only after __init__: the device and E fix the regime
        self._fused_regime = ingest_ops.ingest_delta_regime(num_elements,
                                                            self.device)
        self.wal_compact_records = wal_compact_records
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
                     live: Optional[np.ndarray] = None) -> None:
        """Apply one packed ``(B, E)`` micro-batch of client op-rows (row
        b's add selector is one Add(k...) call, its del selector one
        Del(k...) call, ``live`` masks padding rows) and WAL-log the
        batch's δ BEFORE returning: one fsync covers the whole batch."""
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
        with self._lock:
            pre_vv = self._host_vv() if self.wal is not None else None
            self._apply_batch_locked(add_rows, del_rows, live, pre_vv)

    # requires-lock: _lock
    def _apply_batch_locked(self, add_rows: np.ndarray, del_rows: np.ndarray,
                            live: np.ndarray,
                            pre_vv: Optional[np.ndarray]) -> None:
        """The apply+log half of ``ingest_batch``: the rows reach the
        device in one copy, the node's regime applies them and returns
        the δ (compacted on the device when there is a record to write),
        and the record is appended.  ``pre_vv`` is None iff no WAL is
        attached."""
        num_b, num_e = add_rows.shape
        rows = torch.from_numpy(np.concatenate(
            [add_rows.reshape(-1), del_rows.reshape(-1), live])).to(
                self.device)
        fused_fn, k = self._fused_regime
        if pre_vv is None:
            k = 0  # no record to write: skip the compaction
        merged, payload, compact = fused_fn(
            self._row(), rows[:num_b * num_e].view(num_b, num_e),
            rows[num_b * num_e:2 * num_b * num_e].view(num_b, num_e),
            rows[2 * num_b * num_e:], k_changed=k, k_deleted=k)
        self._set_row(merged)
        self._count("ingest.dispatches")
        if pre_vv is not None:
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
                             compact=None) -> None:
        """Append one δ record in the form framing.encode_delta_wal_record
        picks: the on-device fixed-K form when given and not overflowed,
        else host-side compaction or the dense record."""
        body, is_compact = framing.encode_delta_wal_record(
            pre_vv, self.actor, payload, compact,
            compact_records=self.wal_compact_records)
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

    def note_peer_processed(self, src_actor: int, processed) -> None:
        """Record a peer's advertised causal-stability vector without a
        payload (the ``_apply_payload`` bookkeeping).  Monotone join."""
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
            for name, n in (("wal.records", replayed),
                            ("wal.replayed_compact", compact_n),
                            ("wal.replayed_dense", dense_n),
                            ("wal.bad_records", bad),
                            ("wal.future_records", future)):
                if n:
                    self.recorder.count(name, n)
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
    def _from_checkpoint(cls, ck, where: str, recorder, device) -> "Node":
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
            recorder=recorder, device=device)
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
                        fallback_init=None, device="cuda") -> "Node":
        """Crash recovery: the newest VALID checkpoint generation
        (fallback past corrupt ones, fenced by ``min_generation``) plus a
        replay of the WAL tail, with the WAL left attached.
        ``fallback_init`` (a zero-argument Node factory) covers the
        died-before-first-checkpoint case.  A regressed restore (an older
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
            node = cls._from_checkpoint(ck, dirpath, recorder, device)
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

    def close(self) -> None:
        """Release the node.  It holds no socket or thread yet (the
        server half comes with the digest-sync slice) and does not own
        its WAL, which the caller closes."""

    def __enter__(self) -> "Node":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _count(self, name: str, n: int = 1) -> None:
        if self.recorder is not None:
            self.recorder.count(name, n)
