"""2-D ``("dp", "mp")`` serve mesh: replicated ingest stripes over a
lane-sharded state in one process.

The counterpart of the JAX package's ``parallel/meshtarget2d.py``.
Lane fields cut their E over ``mp``; the ``dp`` axis holds REPLICATED
copies of that sharded state, and each dp replica applies its own
STRIPE of a super-batch, so one ``serve --mesh-devices DPxMP`` process
applies up to dp micro-batches a dispatch.  The result is bitwise the
1-D and single-device node's (state, dots, WAL record bytes) through
three mechanisms:

1. **Key-disjoint striping** (``plan_rows``): the host packs ops
   into up to dp stripes such that no key is touched by two stripes of
   one super-batch; an op whose keys span two stripes CUTS the
   super-batch (the remainder dispatches next, in order).  Each lane
   has at most ONE writer a dispatch.
2. **Absolute counter bases**: the host computes every row's pre-row
   counter offset over the super-batch, so rows interleaved across
   stripes assign the counters the sequential kernel assigns.
3. **Dissemination join over dp** (``gossip.disjoint_update_join``):
   after the stripes apply, ceil(log2 dp) ring rounds of ppermutes
   leave every dp replica holding the unique-writer select of all
   stripes, so reads see the joined replica with no reduce over dp.

Each stripe slot folds its rows in ONE K10 launch with the chunk's
absolute counters passed in (ops/cuda_ingest.ingest_slot_rows, K = 0).
The batch δ for the WAL record is extracted from the joined state
against the pre-batch vv and compacted to K on the device, both in plain
torch (``_apply_batch_locked`` says why): the same record bytes as the
1-D and single-device paths for an uncut batch; a cut batch logs one
record a chunk, which replays to the same state.  Requires v2
semantics.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from go_crdt_playground_tpu_torch._u32 import MASK, host, narrow
from go_crdt_playground_tpu_torch.models.awset_delta import AWSetDeltaState
from go_crdt_playground_tpu_torch.ops.compact import compact_payload
from go_crdt_playground_tpu_torch.ops.delta import delta_extract
from go_crdt_playground_tpu_torch.parallel import shardmap
from go_crdt_playground_tpu_torch.parallel.gossip import disjoint_update_join
from go_crdt_playground_tpu_torch.parallel.mesh import Mesh, take_devices
from go_crdt_playground_tpu_torch.parallel.meshtarget import (
    MeshApplyTarget, apply_slot_rows, lane_offsets, rows_to_device)

DP_AXIS = "dp"
MP_AXIS = "mp"

MeshSpec = Union[int, Tuple[int, int], str]


def parse_mesh_spec(spec: MeshSpec):
    """Normalize a ``--mesh-devices`` value: ``"N"``/``N`` stays an int
    (the 1-D lane mesh), ``"DPxMP"``/``(dp, mp)`` becomes a 2-tuple.
    Raises ``ValueError`` on anything else."""
    one_d = False
    if isinstance(spec, (tuple, list)):
        if len(spec) != 2:
            raise ValueError(
                f"mesh spec {spec!r}: expected (dp, mp)")
        dp, mp = int(spec[0]), int(spec[1])
    elif isinstance(spec, int):
        one_d, dp, mp = True, 1, int(spec)
    else:
        text = str(spec).strip().lower()
        head, sep, tail = text.partition("x")
        if not head.isdigit() or (sep and not tail.isdigit()):
            raise ValueError(
                f"mesh spec {spec!r}: expected N (1-D lane mesh) or "
                "DPxMP (2-D replicated-ingest mesh), e.g. 8 or 2x4")
        if not sep:
            one_d, dp, mp = True, 1, int(head)
        else:
            dp, mp = int(head), int(tail)
    if dp < 1 or mp < 1:
        raise ValueError(
            f"mesh spec {spec!r}: every mesh extent must be >= 1")
    return int(mp) if one_d else (dp, mp)


def make_serve_mesh(dp: int, mp: int, device=None) -> Mesh:
    """The 2-D ``("dp", "mp")`` serve mesh over ``dp * mp`` slots
    (``mesh.take_devices``), row-major."""
    devices = take_devices(dp * mp, device)
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(dp, mp), (DP_AXIS, MP_AXIS))


# ---------------------------------------------------------------------------
# Host-side striping: key-disjoint stripes with global counter prefixes
# ---------------------------------------------------------------------------


class StripePlan:
    """One dispatch's packed stripes (counter offsets ABSOLUTE over the
    chunk's global row order)."""

    __slots__ = ("add", "dl", "prefix", "add_total", "del_tick",
                 "rows", "stripes_used")

    def __init__(self, add, dl, prefix, add_total, del_tick, rows,
                 stripes_used):
        self.add = add                  # bool[dp, cap, E]
        self.dl = dl                    # bool[dp, cap, E]
        self.prefix = prefix            # uint32[dp, cap] pre-row ticks
        self.add_total = add_total      # uint32[dp, cap]
        self.del_tick = del_tick        # uint32[dp, cap]
        self.rows = rows                # keyed rows packed this chunk
        self.stripes_used = stripes_used


class RowPlan:
    """One chunk of the planner over a batch's rows: ``index[s, j]`` is
    the batch row in stripe s's slot j (-1: padding), with the chunk's
    ABSOLUTE counter offsets (see the module docstring)."""

    __slots__ = ("index", "prefix", "add_total", "del_tick", "rows",
                 "stripes_used")

    def __init__(self, index, prefix, add_total, del_tick, rows,
                 stripes_used):
        self.index = index              # int64[dp, cap]
        self.prefix = prefix            # uint32[dp, cap] pre-row ticks
        self.add_total = add_total      # uint32[dp, cap]
        self.del_tick = del_tick        # uint32[dp, cap]
        self.rows = rows                # keyed rows packed this chunk
        self.stripes_used = stripes_used


def plan_rows(row_keys, n_add: np.ndarray, any_del: np.ndarray,
              num_elements: int, dp: int, cap: int,
              assign: Optional[np.ndarray] = None
              ) -> Tuple[List[RowPlan], int]:
    """Greedy order-preserving striping of a batch given each row's
    touched keys (``row_keys[r]``, live rows' keys only), added-key
    count and Del flag, into chunks of <= dp key-disjoint stripes of <=
    ``cap`` rows each.

    Rows are taken in batch order.  A row lands in the stripe already
    owning one of its keys, or (keys unowned) the stripe its ``assign``
    hint names (entries outside [0, dp) are unhinted), else the
    least-loaded stripe.  A row whose keys span TWO stripes, or whose
    stripe is full, cuts the chunk: everything before it dispatches now,
    it and every later row re-stripe fresh.  Cutting (never reordering)
    keeps the counter prefixes, and so the dots, the sequential
    kernel's.  Rows without keys are padding.  Returns ``(plans,
    cuts)``; an all-padding batch yields one empty plan (one dispatch,
    one empty WAL record, as the single-device path)."""
    keyed = [r for r in range(len(row_keys)) if row_keys[r].size]
    plans: List[RowPlan] = []
    cuts = 0
    i = 0
    while True:
        key_owner = np.full(num_elements, -1, np.int32)
        loads = np.zeros(dp, np.int64)
        stripe_rows: List[List[int]] = [[] for _ in range(dp)]
        chunk: List[int] = []
        while i < len(keyed):
            r = keyed[i]
            keys = row_keys[r]
            owners = np.unique(key_owner[keys])
            owners = owners[owners >= 0]
            if owners.size > 1:
                cuts += 1
                break  # cross-stripe keys: serialize at the cut
            if owners.size:
                s = int(owners[0])  # ownership beats any hint
            elif assign is not None and 0 <= assign[r] < dp:
                s = int(assign[r])
            else:
                s = int(np.argmin(loads))
            if loads[s] >= cap:
                cuts += 1
                break  # stripe full: the remainder dispatches next
            stripe_rows[s].append(r)
            chunk.append(r)
            loads[s] += 1
            key_owner[keys] = s
            i += 1
        index = np.full((dp, cap), -1, np.int64)
        add_total = np.zeros((dp, cap), np.uint32)
        del_tick = np.zeros((dp, cap), np.uint32)
        row_prefix = {}
        run = 0
        for r in chunk:
            row_prefix[r] = run
            run += int(n_add[r]) + int(any_del[r])
        # padding slots carry the end-of-chunk prefix: their no-op clock
        # writes land at the chunk's final counter, which the join's max
        # recovers exactly
        prefix = np.full((dp, cap), run, np.uint32)
        for s, rlist in enumerate(stripe_rows):
            for j, r in enumerate(rlist):
                index[s, j] = r
                prefix[s, j] = row_prefix[r]
                add_total[s, j] = n_add[r]
                del_tick[s, j] = any_del[r]
        plans.append(RowPlan(index, prefix, add_total, del_tick,
                             len(chunk),
                             int(sum(1 for x in stripe_rows if x))))
        if i >= len(keyed):
            return plans, cuts


def _row_keys(rows_nz: np.ndarray, keys_nz: np.ndarray, num_rows: int):
    """Per-row key arrays from the (row, key) pairs of a selector matrix
    in row-major order."""
    return np.split(keys_nz, np.searchsorted(rows_nz,
                                             np.arange(1, num_rows)))


def plan_stripes(add_rows: np.ndarray, del_rows: np.ndarray,
                 live: np.ndarray, dp: int, cap: int,
                 assign: Optional[np.ndarray] = None
                 ) -> Tuple[List[StripePlan], int]:
    """``plan_rows`` of one ``(B, E)`` op-batch (``live`` masks padding
    rows), each chunk's stripes packed as dense ``(dp, cap, E)``
    selectors: the JAX package's planner, plan for plan."""
    num_b, num_e = add_rows.shape
    eff_add = add_rows & live[:, None]
    eff_del = del_rows & live[:, None]
    plans, cuts = plan_rows(
        _row_keys(*np.nonzero(eff_add | eff_del), num_b),
        eff_add.sum(axis=1, dtype=np.int64), eff_del.any(axis=1), num_e,
        dp, cap, assign)
    out = []
    for p in plans:
        used = p.index >= 0
        add = np.zeros((dp, cap, num_e), bool)
        dl = np.zeros((dp, cap, num_e), bool)
        add[used] = eff_add[p.index[used]]
        dl[used] = eff_del[p.index[used]]
        out.append(StripePlan(add, dl, p.prefix, p.add_total, p.del_tick,
                              p.rows, p.stripes_used))
    return out, cuts


def stripe_counters(plan: RowPlan, pre_ctr: int) -> np.ndarray:
    """uint32[dp, 2 cap + 1] as int32 bits: each stripe's absolute row
    bases, its deletion counters and its final clock (its last row's
    deletion counter; padding rows carry the end-of-chunk prefix, so a
    stripe with padding ends at the chunk's final counter, which the
    join's max recovers), all mod 2^32."""
    row_base = pre_ctr + plan.prefix.astype(np.int64)
    del_ctr = (row_base + plan.add_total.astype(np.int64)
               + plan.del_tick.astype(np.int64))
    words = np.concatenate([row_base, del_ctr, del_ctr[:, -1:]], axis=1)
    return (words & MASK).astype(np.uint32).view(np.int32)


def mesh2d_ingest(mesh: Mesh, slots, add: torch.Tensor, dl: torch.Tensor,
                  plan: RowPlan, pre_ctr: int, e_loc: int):
    """One chunk on the 2-D mesh: slot (d, m) applies stripe d's rows to
    lane shard m with the chunk's absolute counter bases (one K10 launch,
    ``apply_slot_rows`` with K = 0), then the dp dissemination join.
    ``add`` / ``dl``: the batch's live selector rows, bool[B, E] on the
    node's device, gathered into the chunk's stripes there.  Returns the
    joined slot grid."""
    dp, cap = plan.index.shape
    mp = mesh.shape[MP_AXIS]
    device = add.device
    index = torch.from_numpy(plan.index).to(device)
    live = index >= 0
    add = add[index.clamp(min=0)] & live[..., None]
    dl = dl[index.clamp(min=0)] & live[..., None]
    lane_off = lane_offsets(add.view(dp * cap, -1), mp).view(dp, cap, mp)
    # slot (d, m)'s rows and lane offsets as contiguous views
    rows = torch.stack([add, dl], dim=1).view(dp, 2, cap, mp, e_loc).permute(
        0, 3, 1, 2, 4).contiguous()
    offs = narrow(lane_off).permute(0, 2, 1).contiguous()
    words = torch.from_numpy(stripe_counters(plan, pre_ctr)).to(device)
    base = shardmap.map_slots(
        mesh, lambda idx, s: AWSetDeltaState(*(x[0] for x in s)), slots)

    def stripe(idx, st):
        d, m = idx
        merged, _, _ = apply_slot_rows(
            st, rows[d, m, 0], rows[d, m, 1], live[d], words[d, :cap],
            offs[d, m], words[d, cap:2 * cap], words[d, 2 * cap:], 0)
        return merged

    stripes = shardmap.map_slots(mesh, stripe, base)
    joined = disjoint_update_join(mesh, stripes, base, DP_AXIS, dp)
    return shardmap.map_slots(
        mesh, lambda idx, j: AWSetDeltaState(*(x.unsqueeze(0) for x in j)),
        joined)


class Mesh2DApplyTarget(MeshApplyTarget):
    """A ``Node`` serving dp replicated ingest stripes over mp lane
    shards (module docstring).  The ``(1, N)`` and ``(N, 1)`` meshes are
    bitwise the 1-D mesh and the single-device paths.  ``ingest_stripes``
    is the batcher's width multiplier: it packs up to ``dp * max_batch``
    admitted ops a super-batch (serve/batcher.py)."""

    LANE_AXIS = MP_AXIS

    def __init__(self, actor: int, num_elements: int, num_actors: int,
                 mesh_shape: MeshSpec = None, **node_kwargs):
        if node_kwargs.get("delta_semantics", "v2") != "v2":
            # the δ extraction and record composition lean on v2's
            # deletion-record join; refuse rather than diverge
            raise ValueError(
                "Mesh2DApplyTarget requires delta_semantics='v2'")
        super().__init__(actor, num_elements, num_actors,
                         mesh_devices=mesh_shape, **node_kwargs)
        # race-ok: read-only configuration after __init__
        self.dp = self._mesh.shape[DP_AXIS]
        # race-ok: read-only configuration after __init__
        self.mp = self._mesh.shape[MP_AXIS]
        # race-ok: read-only configuration after __init__
        self.ingest_stripes = self.dp

    def _build_mesh(self, mesh_devices, device) -> Mesh:
        spec = parse_mesh_spec(mesh_devices if mesh_devices is not None
                               else (1, 1))
        if isinstance(spec, int):
            spec = (1, spec)
        return make_serve_mesh(*spec, device=device)

    def _prepare_batch(self, add_rows: np.ndarray, del_rows: np.ndarray,
                       live: np.ndarray, stripe_hint: Optional[np.ndarray]):
        """The rows on the node's device and the planner's chunks, before
        the node lock is taken: the plan reads the batch and the mesh's
        shape, no replica state, so its device->host pull (the touched
        (row, key) pairs and two words a row, in one copy) never stalls
        the lock's other holders."""
        num_b = add_rows.shape[0]
        cap = max(1, -(-num_b // self.dp))
        # the rows reach the node's device once; the planner reads their
        # keys from there, and each chunk's stripes are gathered from
        # them on the device
        add, dl, _ = rows_to_device(add_rows, del_rows, live, self.device)
        nz = torch.nonzero(add | dl)
        # transfer-ok: taken before the node lock (ingest_batch calls this
        # outside its with-block; the batcher's loop holds no lock); the
        # sweep reaches it by trailing name only (close -> drain ->
        # ingest_batch).  One copy of the touched pairs and two words a row
        host_in = torch.cat([nz.reshape(-1),
                             add.sum(dim=1, dtype=torch.int64),
                             dl.any(dim=1).to(torch.int64)]).cpu().numpy()
        n_nz = nz.shape[0]
        rows_nz, keys_nz = host_in[:2 * n_nz].reshape(n_nz, 2).T
        plans, cuts = plan_rows(
            _row_keys(rows_nz, keys_nz, num_b),
            host_in[2 * n_nz:2 * n_nz + num_b],
            host_in[2 * n_nz + num_b:].astype(bool), self.num_elements,
            self.dp, cap, stripe_hint)
        return add, dl, plans, cuts

    # requires-lock: _lock
    def _apply_batch_locked(self, add_rows: np.ndarray,
                            del_rows: np.ndarray, live: np.ndarray,
                            stripe_hint: Optional[np.ndarray] = None,
                            prep=None) -> None:
        """Apply ``_prepare_batch``'s chunks (``prep``), each a striped
        launch and a WAL record."""
        add, dl, plans, cuts = prep
        if cuts:
            self._count("mesh.stripe.cuts", cuts)
        for plan in plans:
            # each chunk's record compresses against the post-previous-
            # chunk clock, as two successive batches would
            rows = self._slot_rows()
            pre_vv = host(rows[0].vv)
            slots = mesh2d_ingest(self._mesh, self._slots, add, dl, plan,
                                  int(pre_vv[self.actor]), self._e_loc)
            self._set_slots(slots)
            self._count("ingest.dispatches")
            self._count("mesh.stripe.dispatches")
            if plan.rows:
                self._count("mesh.stripe.rows", plan.rows)
                self._count("mesh.stripe.width", plan.stripes_used)
            if self.wal is not None:
                # the δ of the joined lanes: no stripe's K10 launch sees
                # them all, and no kernel of the JAX package computes it
                # (build_mesh2d_ingest's delta_extract is XLA).  Its
                # compaction stays on the device too: pulling the dense
                # δ to compact it on the host took a 2 x 2 node at E =
                # 2^20 from 190-216 to 229-244 ms a batch on an H100
                # (tools/torch_mesh_serve_ab.py)
                pre = torch.from_numpy(pre_vv.view(np.int32))
                k = self._record_k()
                parts = [delta_extract(r, pre.to(r.vv.device))
                         for r in self._slot_rows()]
                self._append_slot_record(
                    pre_vv, parts,
                    [compact_payload(p, k, k) for p in parts] if k
                    else None)
