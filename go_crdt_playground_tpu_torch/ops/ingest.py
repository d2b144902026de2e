"""Packed micro-batch op-apply: B client op-rows against one replica slice.

The counterpart of the JAX package's ``ops/ingest.py``.  ``add_rows[b]``
is the key set of request b's ``Add(k...)`` call, ``del_rows[b]`` of its
``Del(k...)`` call, ``live[b] = False`` masks padding row b.  Rows apply
in order, add before del within a row, with the semantics of the
reference (awset.go:89-101, awset-delta_test.go:14-33) and the
batching-specific rules:

* an Add row ticks the clock once per selected key, dots assigned in
  ascending element order;
* a Del row ticks the clock ONCE iff it selects at least one key (an
  all-empty row is padding and must not tick), and stamps every
  selected key that is present with that one deletion dot.

``ingest_rows`` is the plain path, a loop over rows; ``ingest_rows_delta``
adds the batch's δ against the pre-batch vv (the payload of the WAL
record) and its fixed-K compact form.  ``ingest_delta_regime`` picks the
fused path by device: the K10 kernel (ops/cuda_ingest.py) with the
on-device compaction on CUDA, this module's plain path with host-side
compaction (K = 0) on the CPU, as the JAX package picks its Pallas twin
on a TPU backend and the XLA path elsewhere.
"""

from __future__ import annotations

import torch

from go_crdt_playground_tpu_torch._u32 import narrow
from go_crdt_playground_tpu_torch.models.awset_delta import AWSetDeltaState
from go_crdt_playground_tpu_torch.ops import compact as compact_ops
from go_crdt_playground_tpu_torch.ops import delta as delta_ops
from go_crdt_playground_tpu_torch.ops.vv import clock_at, set_clock

# fixed-K capacity of the fused path's on-device δ compaction: a batch
# whose δ claims more lanes falls back to the dense WAL record, never
# dropped
WAL_COMPACT_K = 128


def ingest_delta_regime(num_elements: int, device):
    """The fused ingest+δ path for a node on ``device``: ``(fused_fn,
    k)``, the K10 kernel with ``k = min(WAL_COMPACT_K, E)`` on CUDA (the
    compaction shrinks the device->host pull), ``ingest_rows_delta``
    with ``k = 0`` (host-side compaction) on the CPU."""
    if torch.device(device).type == "cuda":
        from go_crdt_playground_tpu_torch.ops.cuda_ingest import \
            ingest_rows_delta_fused

        return ingest_rows_delta_fused, min(WAL_COMPACT_K, num_elements)
    return ingest_rows_delta, 0


def _apply_add_row(st: AWSetDeltaState, row: torch.Tensor):
    """One Add(k...) op-row on a replica slice.  row: bool[E]."""
    base = clock_at(st.vv, st.actor)
    # 1-based dot position per selected lane, ascending element order
    pos1 = torch.cumsum(row, dim=0, dtype=torch.int64) * row
    new_vv = base + pos1.max()
    return st._replace(
        vv=set_clock(st.vv, st.actor, new_vv),
        present=st.present | row,
        dot_actor=torch.where(row, st.actor, st.dot_actor),
        dot_counter=torch.where(row, narrow(base + pos1), st.dot_counter),
        processed=set_clock(st.processed, st.actor, new_vv))


def _apply_del_row(st: AWSetDeltaState, row: torch.Tensor):
    """One Del(k...) op-row on a replica slice.  row: bool[E]."""
    new_counter = clock_at(st.vv, st.actor) + row.any().to(torch.int64)
    hit = row & st.present
    return st._replace(
        vv=set_clock(st.vv, st.actor, new_counter),
        present=st.present & ~hit,
        dot_actor=torch.where(hit, 0, st.dot_actor),
        dot_counter=torch.where(hit, 0, st.dot_counter),
        deleted=st.deleted | hit,
        del_dot_actor=torch.where(hit, st.actor, st.del_dot_actor),
        del_dot_counter=torch.where(hit, narrow(new_counter),
                                    st.del_dot_counter),
        processed=set_clock(st.processed, st.actor, new_counter))


def ingest_rows(state: AWSetDeltaState, add_rows: torch.Tensor,
                del_rows: torch.Tensor,
                live: torch.Tensor) -> AWSetDeltaState:
    """Apply B op-rows to ONE replica slice (vv[A], lanes[E], actor[]):
    rows in order b = 0..B-1, add before del within a row.  add_rows /
    del_rows: bool[B, E]; live: bool[B]."""
    for b in range(add_rows.shape[0]):
        state = _apply_add_row(state, add_rows[b] & live[b])
        state = _apply_del_row(state, del_rows[b] & live[b])
    return state


def ingest_rows_delta(state: AWSetDeltaState, add_rows, del_rows, live, *,
                      k_changed: int, k_deleted: int):
    """Ingest plus δ: ``(merged, payload, compact)``, the merged slice,
    the batch's δ against the PRE-batch vv (which also carries any
    pre-existing lane whose dot that vv did not cover) and its fixed-K
    form; ``compact`` is None when either K is 0."""
    dev = state.vv.device
    merged = ingest_rows(
        state, torch.as_tensor(add_rows, dtype=torch.bool, device=dev),
        torch.as_tensor(del_rows, dtype=torch.bool, device=dev),
        torch.as_tensor(live, dtype=torch.bool, device=dev))
    payload = delta_ops.delta_extract(merged, state.vv)
    if k_changed == 0 or k_deleted == 0:
        return merged, payload, None
    return merged, payload, compact_ops.compact_payload(
        payload, k_changed, k_deleted)
