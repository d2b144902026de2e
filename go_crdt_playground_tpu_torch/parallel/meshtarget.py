"""Device-mesh replica tier: one frontend's state lane-sharded over a
mesh of slots.

The counterpart of the JAX package's ``parallel/meshtarget.py``.
``MeshApplyTarget`` is a ``net/peer.Node`` whose single-replica
``AWSetDeltaState`` lives lane-partitioned over a 1-D ``"batch"`` mesh
(parallel/mesh.py): slot m holds lanes [m E/n, (m + 1) E/n) of every
lane field, each on its slot's device, and a copy of the A-shaped
clocks (``vv``, ``processed``) and the actor id.

Write path (``ingest_batch``): the only cross-lane couplings of the row
algebra are each row's dot positions (a prefix count over its touched
lanes) and its clock ticks, and both are functions of the selector
masks alone.  So the batch's rows reach the node's device in one copy,
the per (row, slot) lane offsets and the per-row counters are computed
there once, and each slot applies its lanes with a local cumsum (plain
torch, as the JAX path is XLA): no traffic between slots, the dots
bitwise those of the single-device node.  The batch δ against the
pre-batch vv is extracted per slot in the same pass and reaches the
host in one copy a slot for the WAL record.

Read path: the digest summary runs K11 on every slot's lanes with the
slot's GLOBAL lane ids (``lane_base = m E/n``), so the group digests
equal the single-device node's when groups do not straddle slots (a
misaligned configuration reads the whole state instead).  Membership
reads pull the ``present`` lanes only; slice extraction gathers the
moving lanes by index on each slot.

Everything else (WAL and checkpoints, anti-entropy, compaction, the
serve frontend) runs unchanged against this class: the inherited code
reads ``_state``, which here is the whole state assembled from the
slots (cached until the next write), and every assignment to it (a
payload apply, a replay, a restore, GC) re-shards the result onto the
slots, so placement never drifts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from go_crdt_playground_tpu_torch._u32 import host, narrow, to_host, widen
from go_crdt_playground_tpu_torch.models.awset_delta import AWSetDeltaState
from go_crdt_playground_tpu_torch.models.layout import (ACTOR_AXIS_FIELDS,
                                                        REPLICA_ONLY_FIELDS)
from go_crdt_playground_tpu_torch.net import framing
from go_crdt_playground_tpu_torch.net.framing import MODE_SLICE
from go_crdt_playground_tpu_torch.net.peer import DigestSummary, Node
from go_crdt_playground_tpu_torch.ops import cuda_digest, cuda_ingest
from go_crdt_playground_tpu_torch.ops.compact import (CompactDeltaPayload,
                                                      compact_payload)
from go_crdt_playground_tpu_torch.ops.delta import DeltaPayload
from go_crdt_playground_tpu_torch.ops.vv import clock_at
from go_crdt_playground_tpu_torch.parallel.mesh import (Mesh, empty_grid,
                                                        fresh, take_devices)

BATCH_AXIS = "batch"


def make_batch_mesh(num_devices: Optional[int] = None,
                    device=None) -> Mesh:
    """A 1-D ``"batch"`` mesh of ``num_devices`` slots
    (``mesh.take_devices``: distinct devices in a stable order, or every
    slot on one device named with its index)."""
    devices = take_devices(num_devices, device)
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid, (BATCH_AXIS,))


def _lane_fields(state_cls):
    return [f for f in state_cls._fields
            if f not in ACTOR_AXIS_FIELDS and f not in REPLICA_ONLY_FIELDS]


# ---------------------------------------------------------------------------
# Slot-local row algebra (ops/ingest with the cross-lane reductions
# replaced by host-computed counters)
# ---------------------------------------------------------------------------


def rows_to_device(add_rows: np.ndarray, del_rows: np.ndarray,
                   live: np.ndarray, device):
    """A batch's selector rows on ``device`` in one host->device copy,
    ``live`` folded in: (add bool[B, E], del bool[B, E])."""
    num_b, num_e = add_rows.shape
    rows = torch.from_numpy(np.concatenate(
        [add_rows.reshape(-1), del_rows.reshape(-1), live])).to(device)
    live_t = rows[2 * num_b * num_e:]
    add = rows[:num_b * num_e].view(num_b, num_e) & live_t[:, None]
    dl = rows[num_b * num_e:2 * num_b * num_e].view(num_b, num_e) \
        & live_t[:, None]
    return add, dl


def lane_offsets(add: torch.Tensor, num_slots: int) -> torch.Tensor:
    """int64[B, n]: the lanes each row touches left of each of
    ``num_slots`` equal lane slots (an exclusive prefix over slots), the
    only cross-slot fact of an Add row's dot positions."""
    counts = add.view(add.shape[0], num_slots, -1).sum(
        dim=-1, dtype=torch.int64)
    return torch.cumsum(counts, dim=1) - counts


def apply_slot_rows(st: AWSetDeltaState, arow: torch.Tensor,
                    drow: torch.Tensor, row_base: torch.Tensor,
                    lane_off: torch.Tensor, del_ctr: torch.Tensor,
                    final: torch.Tensor, num_rows: int):
    """Rows applied to one slot's lanes of one replica slice (fields
    [E_loc] / [A]): row b's add dots count up from ``row_base[b] +
    lane_off[b]`` (its pre-row counter and the touched lanes left of
    this slot) in ascending lane order, its deletion dot is
    ``del_ctr[b]``, and the clock ends at ``final``.  Returns (merged,
    δ against the slot's pre-batch vv), the K10 plain version's fold
    (ops/cuda_ingest.ingest_fold_plain)."""
    add_dc = narrow(row_base[:, None] + lane_off[:, None]
                    + torch.cumsum(arow, dim=1, dtype=torch.int64))
    vv, processed = cuda_ingest.clock_outputs(st, final, num_rows)
    return cuda_ingest.ingest_fold_plain(st, arow, drow, add_dc,
                                         narrow(del_ctr), vv, processed)


def payload_to_host(parts) -> DeltaPayload:
    """Per-slot δ payloads (lane slices in slot order) -> one host
    payload over the whole universe, one device->host copy a slot."""
    host_parts = [to_host(p) for p in parts]
    first = host_parts[0]
    return DeltaPayload(**{
        f: (np.concatenate([getattr(p, f) for p in host_parts])
            if f in ("changed", "ch_da", "ch_dc", "deleted", "del_da",
                     "del_dc") else getattr(first, f))
        for f in DeltaPayload._fields})


def merge_compact(parts, k: int, lane_base) -> CompactDeltaPayload:
    """One fixed-K compact δ from the slots' fixed-K forms (host arrays,
    lane slices in slot order, none overflowed, at most k claimed lanes
    a section in all): each slot's claimed lanes with their global ids
    (``lane_base(m) + idx``), in slot order, so ascending element id as
    one compaction of the whole payload lists them."""
    first = parts[0]

    def section(idx, valid, *vals):
        take = [getattr(p, valid) for p in parts]
        ids = np.concatenate([
            getattr(p, idx)[t].astype(np.int64) + lane_base(m)
            for m, (p, t) in enumerate(zip(parts, take))])
        cols = [np.concatenate([getattr(p, v)[t] for p, t in
                                zip(parts, take)]) for v in vals]
        n = ids.size
        pad = lambda a: np.concatenate(  # noqa: E731
            [a, np.zeros(k - n, a.dtype)])
        return (pad(ids.astype(np.uint32)), pad(np.ones(n, bool)),
                *(pad(c) for c in cols))

    ch_idx, ch_valid, ch_da, ch_dc = section("ch_idx", "ch_valid",
                                             "ch_da", "ch_dc")
    del_idx, del_valid, del_da, del_dc = section("del_idx", "del_valid",
                                                 "del_da", "del_dc")
    return CompactDeltaPayload(
        src_vv=first.src_vv, ch_idx=ch_idx, ch_valid=ch_valid,
        ch_da=ch_da, ch_dc=ch_dc, del_idx=del_idx, del_valid=del_valid,
        del_da=del_da, del_dc=del_dc, overflow=np.False_,
        src_actor=first.src_actor, src_processed=first.src_processed)


def build_mesh_digests(mesh: Mesh, num_elements: int, group_size: int,
                       lane_axis: str = BATCH_AXIS):
    """The collective summary read: a function of the lane slots' rows
    (one per lane-axis position) that runs K11 on each slot with its
    global lane ids and concatenates the group digests (on the host).
    Equal to ``ops/digest.state_group_digests`` of the whole state;
    raises ``ValueError`` when a group would straddle two slots."""
    n = mesh.shape[lane_axis]
    e_loc = num_elements // n
    if e_loc % group_size or num_elements % n:
        raise ValueError("shard/group boundary mismatch")

    def fn(rows):
        return [cuda_digest.state_group_digests(
            row, group_size, lane_base=m * e_loc)
            for m, row in enumerate(rows)]

    return fn


def build_mesh_summary(mesh: Mesh, num_elements: int, group_size: int,
                       lane_axis: str = BATCH_AXIS):
    """The whole digest-summary read over the lane slots' rows: K11 per
    slot plus the clocks of slot 0, as one ``DigestSummary`` on the
    host."""
    digests_fn = build_mesh_digests(mesh, num_elements, group_size,
                                    lane_axis)

    def fn(rows):
        digests = digests_fn(rows)
        first = to_host(DigestSummary(rows[0].vv, rows[0].processed,
                                      digests[0]))
        rest = [host(d) for d in digests[1:]]
        return first._replace(
            digests=np.concatenate([first.digests] + rest))

    return fn


def _gather_slice_lanes(row: AWSetDeltaState, idx: torch.Tensor):
    """The moving lanes of a keyspace-handoff slice, by index:
    ``delta_extract(row, zero vv)`` restricted to ``idx`` (a present
    lane always carries a nonzero dot counter, so the zero-vv ``changed``
    filter is the present bit; the re-add filter is lanewise).  Returns
    (K,) tensors."""
    def take(x):
        return x.index_select(0, idx)

    pres, da, dc = take(row.present), take(row.dot_actor), take(
        row.dot_counter)
    dl, dda, ddc = take(row.deleted), take(row.del_dot_actor), take(
        row.del_dot_counter)
    resurrected = pres & ((da != dda) | (widen(dc) > widen(ddc)))
    deleted = dl & ~resurrected
    return (pres, torch.where(pres, da, 0), torch.where(pres, dc, 0),
            deleted, torch.where(deleted, dda, 0),
            torch.where(deleted, ddc, 0))


class MeshApplyTarget(Node):
    """A ``Node`` whose replica state is lane-sharded over a mesh of
    slots.  Drop-in for every Node role (serve frontend replica, sync
    peer, handoff donor and recipient); one slot is bitwise the plain
    node.  ``ingest_fused`` is ignored: the mesh write path is always
    the per-slot fused apply + δ."""

    LANE_AXIS = BATCH_AXIS

    def __init__(self, actor: int, num_elements: int, num_actors: int,
                 mesh_devices=None, **node_kwargs):
        self._whole = None
        self._slots = None
        self._mesh = self._build_mesh(mesh_devices,
                                      node_kwargs.get("device", "cuda"))
        # race-ok: read-only configuration after __init__
        self.mesh_devices = self._mesh.size
        # race-ok: read-only configuration after __init__
        self.lane_shards = self._mesh.shape[self.LANE_AXIS]
        if num_elements % self.lane_shards:
            raise ValueError(
                f"element universe E={num_elements} must divide over "
                f"the {self.lane_shards} lane shards (shards are "
                "equal-sized)")
        self._e_loc = num_elements // self.lane_shards
        node_kwargs["device"] = self._mesh.device(
            (0,) * len(self._mesh.axis_names))
        super().__init__(actor, num_elements, num_actors, **node_kwargs)
        # (group_size -> fn) collective summary reads, or False when
        # groups straddle slots
        self._mesh_summary = {}

    def _build_mesh(self, mesh_devices, device) -> Mesh:
        """The mesh-construction hook: the 1-D ``"batch"`` lane mesh;
        ``Mesh2DApplyTarget`` builds the ``("dp", "mp")`` serve mesh."""
        return make_batch_mesh(mesh_devices, device)

    # -- placement ----------------------------------------------------------

    def _lane_slice(self, m: int) -> slice:
        return slice(m * self._e_loc, (m + 1) * self._e_loc)

    def _read_slots(self):
        """The slots of lane positions 0..n-1 at index 0 of every other
        axis: the copy of the state reads take."""
        ax = self._mesh.axis(self.LANE_AXIS)
        base = [0] * len(self._mesh.axis_names)
        out = []
        for m in range(self.lane_shards):
            base[ax] = m
            out.append(tuple(base))
        return out

    def _shard(self, whole: AWSetDeltaState) -> np.ndarray:
        """Fresh per-slot copies of a whole ``(1, ...)`` state: each slot
        its lane slice and the replicated clocks."""
        lanes = set(_lane_fields(type(whole)))
        ax = self._mesh.axis(self.LANE_AXIS)
        slots = empty_grid(self._mesh)
        for idx in self._mesh.local_slots():
            dev = self._mesh.device(idx)
            sl = self._lane_slice(idx[ax])
            slots[idx] = type(whole)(*(
                fresh(x[:, sl] if f in lanes else x, dev)
                for f, x in zip(whole._fields, whole)))
        return slots

    def _gather(self, slots) -> AWSetDeltaState:
        rows = [slots[idx] for idx in self._read_slots()]
        lanes = set(_lane_fields(type(rows[0])))
        dev = self.device
        return type(rows[0])(*(
            torch.cat([r[k].to(dev) for r in rows], dim=-1) if f in lanes
            else rows[0][k].to(dev, copy=True)
            for k, f in enumerate(rows[0]._fields)))

    @property
    def _state(self) -> AWSetDeltaState:
        """The whole state, assembled from the slots on first read after
        a write and cached."""
        whole = self._whole
        if whole is None:
            whole = self._whole = self._gather(self._slots)
        return whole

    @_state.setter
    def _state(self, state: AWSetDeltaState) -> None:
        # every mutation outside the slot write path lands here: the
        # result is re-sharded at once
        self._whole = state
        self._slots = self._shard(state)

    def _set_slots(self, slots) -> None:
        self._slots = slots
        self._whole = None

    def _slot_rows(self, slots=None):
        slots = self._slots if slots is None else slots
        return [AWSetDeltaState(*(x[0] for x in slots[idx]))
                for idx in self._read_slots()]

    # -- write path ---------------------------------------------------------

    # requires-lock: _lock
    def _apply_batch_locked(self, add_rows: np.ndarray,
                            del_rows: np.ndarray, live: np.ndarray,
                            stripe_hint: Optional[np.ndarray] = None
                            ) -> None:
        # the whole batch is one stripe on the 1-D mesh: the hint is the
        # 2-D subclass's seam and is ignored here
        n = self.lane_shards
        num_b = add_rows.shape[0]
        add, dl = rows_to_device(add_rows, del_rows, live, self.device)
        lane_off = lane_offsets(add, n)
        # row b ticks its added keys plus one if its Del selects any key
        steps = lane_off[:, -1] + add[:, (n - 1) * self._e_loc:].sum(
            dim=1, dtype=torch.int64) + dl.any(dim=1)
        rows0 = self._slot_rows()
        pre_vv = host(rows0[0].vv) if self.wal is not None else None
        c0 = clock_at(rows0[0].vv.to(self.device),
                      rows0[0].actor.to(self.device))
        row_base = c0 + torch.cumsum(steps, dim=0) - steps
        del_ctr = row_base + steps
        final = c0 + steps.sum()
        slots = empty_grid(self._mesh)
        parts = {}
        ax = self._mesh.axis(self.LANE_AXIS)
        for idx in self._mesh.local_slots():
            m = idx[ax]
            dev = self._mesh.device(idx)
            st = AWSetDeltaState(*(x[0] for x in self._slots[idx]))
            sl = self._lane_slice(m)
            merged, payload = apply_slot_rows(
                st, add[:, sl].to(dev), dl[:, sl].to(dev), row_base.to(dev),
                lane_off[:, m].to(dev), del_ctr.to(dev), final.to(dev),
                num_b)
            slots[idx] = AWSetDeltaState(*(x.unsqueeze(0) for x in merged))
            parts[m] = payload
        self._set_slots(slots)
        self._count("ingest.dispatches")
        if self.wal is not None:
            self._append_slot_record(pre_vv, [parts[m] for m in range(n)])

    # requires-lock: _lock
    def _append_slot_record(self, pre_vv: np.ndarray, parts) -> None:
        """WAL-log a batch's δ from its per-slot parts (lane slices in
        slot order) in the one-slot node's record form: where that node
        compacts on the device (K = ``_fused_regime[1]`` > 0, a CUDA
        node), each slot compacts its part to K lanes and the forms are
        merged when at most K lanes a section are claimed in all (the
        same record as one compaction of the whole δ); else, or past K,
        the dense δ reaches the host and the encoder picks the form."""
        k = self._fused_regime[1] if self.wal_compact_records else 0
        if k:
            comps = [compact_payload(p, k, k) for p in parts]
            counts = torch.stack([torch.stack(
                [p.changed.sum(), p.deleted.sum()]).to(self.device)
                for p in parts]).sum(dim=0).cpu()
            if int(counts[0]) <= k and int(counts[1]) <= k:
                merged = merge_compact([to_host(c) for c in comps], k,
                                       lambda m: m * self._e_loc)
                self._append_delta_record(pre_vv, None, merged,
                                          num_elements=self.num_elements)
                return
        self._append_delta_record(pre_vv, payload_to_host(parts), None)

    # -- read path ----------------------------------------------------------

    def members(self) -> np.ndarray:
        with self._lock:
            rows = self._slot_rows()
        return np.nonzero(np.concatenate([host(r.present) for r in rows]))[0]

    def members_vv(self):
        with self._lock:
            rows = self._slot_rows()
        present = np.concatenate([host(r.present) for r in rows])
        return np.nonzero(present)[0], host(rows[0].vv)

    def _summary_fn(self, group_size: int):
        fn = self._mesh_summary.get(group_size)
        if fn is None:
            try:
                fn = build_mesh_summary(self._mesh, self.num_elements,
                                        group_size, self.LANE_AXIS)
            except ValueError:
                fn = False  # groups straddle slots: read the whole state
            self._mesh_summary[group_size] = fn
        return fn

    def _digest_fn(self, state_slice: AWSetDeltaState,
                   group_size: int) -> torch.Tensor:
        """Group digests of a whole state slice: K11 on each slot's lanes
        (moved to the slot's device) with their global ids, or the
        whole-slice read when groups straddle slots."""
        if self._summary_fn(group_size) is False:
            return super()._digest_fn(state_slice, group_size)
        lanes = set(_lane_fields(type(state_slice)))
        rows = []
        for m, idx in enumerate(self._read_slots()):
            dev = self._mesh.device(idx)
            sl = self._lane_slice(m)
            rows.append(type(state_slice)(*(
                x[sl].to(dev).contiguous() if f in lanes else x
                for f, x in zip(state_slice._fields, state_slice))))
        parts = build_mesh_digests(self._mesh, self.num_elements,
                                   group_size, self.LANE_AXIS)(rows)
        return torch.cat([p.to(state_slice.present.device) for p in parts])

    def digest_summary_arrays(self, group_size: int) -> DigestSummary:
        """The summary read over the slots: K11 once a lane slot, the
        clocks from slot 0, without assembling the whole state.  Groups
        that straddle slots take the base read."""
        fn = self._summary_fn(group_size)
        if fn is False:
            return super().digest_summary_arrays(group_size)
        with self._lock:
            rows = self._slot_rows()
        return fn(rows)

    # -- keyspace handoff ---------------------------------------------------

    def extract_slice(self, element_mask: np.ndarray) -> bytes:
        """The donor half of a keyspace handoff, pulling ONLY the moving
        lanes: an index gather on each slot, scattered into the dense
        wire sections on the host; the same bytes as
        ``Node.extract_slice``."""
        mask = np.asarray(element_mask, bool)
        if mask.shape != (self.num_elements,):
            raise ValueError(f"slice mask shape {mask.shape} does not "
                             f"match universe ({self.num_elements},)")
        idx = np.nonzero(mask)[0]
        num_e = self.num_elements
        sections = {f: np.zeros(num_e, bool if f in ("changed", "deleted")
                                else np.uint32)
                    for f in ("changed", "ch_da", "ch_dc", "deleted",
                              "del_da", "del_dc")}
        with self._lock:
            rows = self._slot_rows()
            for m, row in enumerate(rows):
                lo = m * self._e_loc
                mine = idx[(idx >= lo) & (idx < lo + self._e_loc)]
                if not mine.size:
                    continue
                lanes = _gather_slice_lanes(row, torch.from_numpy(
                    mine - lo).to(row.present.device))
                for f, x in zip(("changed", "ch_da", "ch_dc", "deleted",
                                 "del_da", "del_dc"), lanes):
                    sections[f][mine] = host(x)
            vv, processed = host(rows[0].vv), host(rows[0].processed)
        payload = DeltaPayload(src_vv=vv, src_actor=np.uint32(self.actor),
                               src_processed=processed, **sections)
        return framing.encode_payload_msg(MODE_SLICE, self.actor,
                                          processed, payload)
