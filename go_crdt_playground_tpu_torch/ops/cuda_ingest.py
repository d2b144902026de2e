"""Fused ingest+δ on a hand-written CUDA kernel (csrc/ingest.cu).

Kernel and the Pallas kernel it replaces:

  K10 ``ingest_rows_delta_fused`` <- ``pallas_ingest_rows_delta``
      (go_crdt_playground_tpu/ops/pallas_ingest.py ``_fused_ingest`` +
      ``_ingest_kernel``): fold a packed micro-batch of B client op-rows
      into one replica slice and extract the batch's δ against the
      pre-batch vv, in one launch.

The same contract as ops/ingest.ingest_rows_delta: returns ``(merged,
payload, compact)``, with ``compact = None`` when either K is 0.  The
per-row counter bases are scalar prefix sums (uint32, wrapping mod 2^32)
computed here in int64 and narrowed, as the reference keeps them in XLA
outside its kernel; vv and processed are closed-form around the launch;
``compact_payload`` after it is plain torch (ops/compact.py).  Unlike
the reference, B = 0 launches the kernel too (an empty fold, the δ
only), and nothing is padded.

``kernel="auto"`` launches the kernel for CUDA tensors and runs the plain
version (``ingest_fold_plain``: the same fold as a torch loop over rows,
then ops/delta.delta_extract) for CPU tensors; ``kernel="cuda"`` insists
on the kernel and ``kernel="torch"`` asks for the plain version.  The
wrapper counts its launches in ``ingest_rows_delta_fused.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from go_crdt_playground_tpu_torch._u32 import narrow
from go_crdt_playground_tpu_torch.models.awset_delta import AWSetDeltaState
from go_crdt_playground_tpu_torch.ops import _build
from go_crdt_playground_tpu_torch.ops.compact import compact_payload
from go_crdt_playground_tpu_torch.ops.cuda_merge import (
    MAX_FUSED_ACTORS, ptr, stream_of, use_kernel)
from go_crdt_playground_tpu_torch.ops.delta import DeltaPayload, delta_extract
from go_crdt_playground_tpu_torch.ops.vv import clock_at, set_clock

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_LANES = ("present", "dot_actor", "dot_counter", "deleted", "del_dot_actor",
          "del_dot_counter")


def check_slice(state: AWSetDeltaState) -> None:
    """Device, dtype, shape and contiguity of one replica slice (vv[A],
    lanes[E], actor[]) before its pointers reach the kernel."""
    (num_a,) = state.vv.shape
    (num_e,) = state.present.shape
    if not 1 <= num_a <= MAX_FUSED_ACTORS:
        raise ValueError(
            f"actor axis A={num_a} outside the ingest kernel's range [1, "
            f"{MAX_FUSED_ACTORS}] (shared-memory cap); pass kernel='torch' "
            "to run the plain version")
    for name, t in zip(state._fields, state):
        want_dtype = torch.bool if name in ("present", "deleted") \
            else torch.int32
        want_shape = (() if name == "actor" else
                      (num_a,) if name in ("vv", "processed") else (num_e,))
        if t.dtype != want_dtype or tuple(t.shape) != want_shape:
            raise ValueError(f"{name}: expected {want_dtype}{want_shape}, "
                             f"got {t.dtype}{tuple(t.shape)}")
        if t.device != state.vv.device:
            raise ValueError(f"{name} lies on {t.device}, vv on "
                             f"{state.vv.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def row_counters(state: AWSetDeltaState, add_rows: torch.Tensor,
                 del_rows: torch.Tensor, live: torch.Tensor):
    """The batch's rows with ``live`` folded in and their counter bases
    (pallas_ingest.py:120-133): row b ticks once per added key plus once
    if its Del selects any key; its add dots count up from the exclusive
    prefix ``add_base[b]`` in ascending element order, its deletion dot
    is the post-row counter.  Returns (arow, drow, add_dc int32[B, E],
    del_ctr int32[B], final), ``final`` the post-batch counter as int64
    (not reduced mod 2^32)."""
    arow = add_rows & live[:, None]
    drow = del_rows & live[:, None]
    steps = (arow.sum(dim=1, dtype=torch.int64)
             + drow.any(dim=1).to(torch.int64))
    c0 = clock_at(state.vv, state.actor)
    add_base = c0 + torch.cumsum(steps, dim=0) - steps
    add_dc = narrow(add_base[:, None]
                    + torch.cumsum(arow, dim=1, dtype=torch.int64))
    return arow, drow, add_dc, narrow(add_base + steps), c0 + steps.sum()


def clock_outputs(state: AWSetDeltaState, final: torch.Tensor,
                  num_rows: int):
    """(vv, processed) after the batch: the replica's own slot set to the
    final counter.  An empty batch leaves processed as it was, as the
    reference's row scan does."""
    vv = set_clock(state.vv, state.actor, final)
    processed = (set_clock(state.processed, state.actor, final)
                 if num_rows else state.processed)
    return vv, processed


def ingest_fold_plain(state: AWSetDeltaState, arow, drow, add_dc, del_ctr,
                      vv, processed):
    """The kernel's plain version: the per-lane fold as a torch loop over
    rows, then the δ against the pre-batch vv (ops/delta.delta_extract).
    Returns (merged, payload)."""
    p, da, dc = state.present, state.dot_actor, state.dot_counter
    d, xa, xc = state.deleted, state.del_dot_actor, state.del_dot_counter
    actor = state.actor
    for b in range(arow.shape[0]):
        on = arow[b]
        p = p | on
        da = torch.where(on, actor, da)
        dc = torch.where(on, add_dc[b], dc)
        hit = drow[b] & p
        p = p & ~hit
        da = torch.where(hit, 0, da)
        dc = torch.where(hit, 0, dc)
        d = d | hit
        xa = torch.where(hit, actor, xa)
        xc = torch.where(hit, del_ctr[b], xc)
    merged = AWSetDeltaState(
        vv=vv, present=p, dot_actor=da, dot_counter=dc, actor=actor,
        deleted=d, del_dot_actor=xa, del_dot_counter=xc,
        processed=processed)
    return merged, delta_extract(merged, state.vv)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ingest")
    lib.crdt_ingest_fold.argtypes = [_P] * 24 + [_I64, _I64, _I32, _P]
    lib.crdt_ingest_fold.restype = ctypes.c_int
    return lib


def _launch(state: AWSetDeltaState, arow, drow, add_dc, del_ctr, vv,
            processed):
    check_slice(state)
    lanes = [getattr(state, name) for name in _LANES]
    outs = [torch.empty_like(x) for x in lanes + lanes]
    lib = _lib()
    with torch.cuda.device(state.vv.device):
        rc = lib.crdt_ingest_fold(
            ptr(state.vv), ptr(state.actor), *map(ptr, lanes),
            ptr(arow), ptr(drow), ptr(add_dc), ptr(del_ctr),
            *map(ptr, outs), arow.shape[0], state.present.shape[0],
            state.vv.shape[0], stream_of(state.vv))
    _build.check(lib, rc, "crdt_ingest_fold")
    p, da, dc, d, xa, xc, ch, chda, chdc, dm, dlda, dldc = outs
    merged = AWSetDeltaState(
        vv=vv, present=p, dot_actor=da, dot_counter=dc, actor=state.actor,
        deleted=d, del_dot_actor=xa, del_dot_counter=xc,
        processed=processed)
    payload = DeltaPayload(
        src_vv=vv, changed=ch, ch_da=chda, ch_dc=chdc, deleted=dm,
        del_da=dlda, del_dc=dldc, src_actor=state.actor,
        src_processed=processed)
    return merged, payload


def ingest_rows_delta_fused(state: AWSetDeltaState, add_rows, del_rows,
                            live, *, k_changed: int, k_deleted: int,
                            kernel: str = "auto"):
    """K10: apply B op-rows (``add_rows``/``del_rows`` bool[B, E], ``live``
    bool[B], padding rows masked) to one replica slice and return
    ``(merged, payload, compact)``: the merged slice, the batch's δ
    against the pre-batch vv, and that δ in fixed-K form (None when
    either K is 0)."""
    dev = state.vv.device
    add_rows = torch.as_tensor(add_rows, dtype=torch.bool, device=dev)
    del_rows = torch.as_tensor(del_rows, dtype=torch.bool, device=dev)
    live = torch.as_tensor(live, dtype=torch.bool, device=dev)
    num_e = state.present.shape[-1]
    if (add_rows.dim() != 2 or add_rows.shape[1] != num_e
            or del_rows.shape != add_rows.shape
            or tuple(live.shape) != (add_rows.shape[0],)):
        raise ValueError(
            f"op rows {tuple(add_rows.shape)}/{tuple(del_rows.shape)} and "
            f"live {tuple(live.shape)} do not match (B, {num_e}) and (B,)")
    arow, drow, add_dc, del_ctr, final = row_counters(
        state, add_rows, del_rows, live)
    vv, processed = clock_outputs(state, final, add_rows.shape[0])
    if use_kernel(kernel, state.vv):
        merged, payload = _launch(state, arow, drow, add_dc, del_ctr, vv,
                                  processed)
        ingest_rows_delta_fused.launches += 1
    else:
        merged, payload = ingest_fold_plain(state, arow, drow, add_dc,
                                            del_ctr, vv, processed)
    if k_changed == 0 or k_deleted == 0:
        return merged, payload, None
    return merged, payload, compact_payload(payload, k_changed, k_deleted)


ingest_rows_delta_fused.launches = 0
