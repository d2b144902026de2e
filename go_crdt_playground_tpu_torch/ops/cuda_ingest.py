"""Fused ingest+δ on a hand-written CUDA kernel (csrc/ingest.cu): the
whole entry in one launch.

Kernel and the Pallas kernel it replaces:

  K10 ``ingest_rows_delta_fused`` <- ``pallas_ingest_rows_delta``
      (go_crdt_playground_tpu/ops/pallas_ingest.py ``_fused_ingest`` +
      ``_ingest_kernel``): fold a packed micro-batch of B client op-rows
      into one replica slice and extract the batch's δ against the
      pre-batch vv.  The TPU ran the entry as one program: the rows'
      counter bases (prefix sums), the fold, the δ, the clocks and the
      fixed-K compaction.  So does one launch here.

The same contract as ops/ingest.ingest_rows_delta: returns ``(merged,
payload, compact)``, with ``compact = None`` when either K is 0.  On the
card every output is a view of one buffer (one allocation); its head
holds the compact form and the kernel's copy of the pre-batch vv, so
``record_to_host`` brings a WAL record's inputs back in one copy.  B = 0
launches the kernel too, and nothing is padded.

``kernel="auto"`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors: ``row_counters`` (the prefix sums, int64
narrowed mod 2^32), ``clock_outputs``, ``ingest_fold_plain`` (the fold as
a torch loop over rows, then ops/delta.delta_extract) and
ops/compact.compact_payload.  ``kernel="cuda"`` insists on the kernel and
``kernel="torch"`` asks for the plain version.  The wrapper counts its
launches in ``ingest_rows_delta_fused.launches`` (under a lock: a
serving node launches from its batcher's thread, peers and clients
from theirs).  The launch goes on the calling thread's current stream
of the state's device.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from go_crdt_playground_tpu_torch._u32 import host, narrow, to_host
from go_crdt_playground_tpu_torch.models.awset_delta import AWSetDeltaState
from go_crdt_playground_tpu_torch.ops import _build
from go_crdt_playground_tpu_torch.ops.compact import (CompactDeltaPayload,
                                                      compact_payload)
from go_crdt_playground_tpu_torch.ops.cuda_merge import (
    MAX_FUSED_ACTORS, device_guard, stream_of, use_kernel)
from go_crdt_playground_tpu_torch.ops.delta import DeltaPayload, delta_extract
from go_crdt_playground_tpu_torch.ops.vv import clock_at, set_clock

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
# nodes launch from their batcher and server threads: the count is a
# read-modify-write
_count_lock = threading.Lock()
# the output buffer's regions in csrc/ingest.cu's order, by group: the
# head's words and bools (the host-bound part), the device's words and
# bools; the scratch follows
_HEAD_WORDS = ("pre_vv", "src_vv", "src_processed", "src_actor", "ch_idx",
               "ch_da", "ch_dc", "del_idx", "del_da", "del_dc")
_HEAD_BOOLS = ("ch_valid", "del_valid", "overflow")
_WORDS = ("vv", "processed", "dot_actor", "dot_counter", "del_dot_actor",
          "del_dot_counter", "p_ch_da", "p_ch_dc", "p_del_da", "p_del_dc")
_BOOLS = ("present", "deleted", "changed", "p_deleted")
_GROUPS = ((_HEAD_WORDS, torch.int32), (_HEAD_BOOLS, torch.bool),
           (_WORDS, torch.int32), (_BOOLS, torch.bool))


def check_slice(state: AWSetDeltaState) -> None:
    """Device, dtype, shape and contiguity of one replica slice (vv[A],
    lanes[E], actor[]) before its pointers reach the kernel."""
    vv = state.vv
    dev = vv.device
    num_a = vv.shape[0] if vv.dim() == 1 else -1
    num_e = state.present.shape[0] if state.present.dim() == 1 else -1
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
        if t.dtype != want_dtype or t.shape != want_shape:
            raise ValueError(f"{name}: expected {want_dtype}{want_shape}, "
                             f"got {t.dtype}{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, vv on {dev}")
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
    lib.crdt_ingest.argtypes = [_P] * 13 + [_I64, _I64, _I32, _I32, _I32,
                                            _P]
    lib.crdt_ingest.restype = ctypes.c_int
    lib.crdt_ingest_regions.restype = ctypes.c_int
    lib.crdt_ingest_layout.argtypes = [_I64] * 5 + [_P]
    lib.crdt_ingest_layout.restype = None
    return lib


@functools.lru_cache(maxsize=256)
def _layout(num_e: int, num_a: int, num_b: int, k_changed: int,
            k_deleted: int, lib=None):
    """The output buffer of one shape, from the kernel's own layout
    (``crdt_ingest_layout``): its size in bytes, the head's size, and per
    group the byte range, the split sizes (each region, then its padding
    to 16 bytes where there is any, in the group's element type) and the
    regions' places among the pieces."""
    lib = lib or _lib()
    n = lib.crdt_ingest_regions()
    off = (ctypes.c_longlong * n)()
    lib.crdt_ingest_layout(num_e, num_a, num_b, k_changed, k_deleted,
                           ctypes.addressof(off))
    # element counts of each region, in order
    counts = ([num_a] * 3 + [1] + [k_changed] * 3 + [k_deleted] * 3
              + [k_changed, k_deleted, 1]
              + [num_a] * 2 + [num_e] * 8 + [num_e] * 4)
    groups, r = [], 0
    for names, dtype in _GROUPS:
        size = 4 if dtype == torch.int32 else 1
        lo, sizes, picks = off[r], [], []
        for i in range(r, r + len(names)):
            picks.append(len(sizes))
            sizes.append(counts[i])
            pad = (off[i + 1] - off[i]) // size - counts[i]
            if pad:
                sizes.append(pad)
        r += len(names)
        groups.append((lo, off[r], tuple(sizes), tuple(picks), dtype))
    return off[n - 1], off[len(_HEAD_WORDS) + len(_HEAD_BOOLS)], \
        tuple(groups)


def _views(buf: torch.Tensor, groups) -> dict:
    """Each region of ``buf`` as a view, by name: one slice, one dtype
    view and one split per group."""
    views = {}
    for (names, _), (lo, hi, sizes, picks, dtype) in zip(_GROUPS, groups):
        parts = buf[lo:hi].view(dtype).split_with_sizes(sizes)
        views.update(zip(names, (parts[i] for i in picks)))
    views["src_actor"] = views["src_actor"][0]
    views["overflow"] = views["overflow"][0]
    return views


def _check_rows(add_rows, del_rows, live, num_e: int) -> None:
    if (add_rows.dim() != 2 or add_rows.shape[1] != num_e
            or del_rows.shape != add_rows.shape
            or live.shape != (add_rows.shape[0],)):
        raise ValueError(
            f"op rows {tuple(add_rows.shape)}/{tuple(del_rows.shape)} and "
            f"live {tuple(live.shape)} do not match (B, {num_e}) and (B,)")


def _launch(state: AWSetDeltaState, add_rows, del_rows, live,
            k_changed: int, k_deleted: int, lib=None):
    """One K10 launch for the whole entry: ``(merged, payload, compact)``
    as views of one new buffer (``lib``: another build of csrc/ingest.cu
    with the same interface, for same-card comparisons)."""
    check_slice(state)
    dev = state.vv.device
    for name, t in (("add_rows", add_rows), ("del_rows", del_rows),
                    ("live", live)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
    num_b, num_e = add_rows.shape
    num_a = state.vv.shape[0]
    lib = lib or _lib()
    size, _, groups = _layout(num_e, num_a, num_b, k_changed, k_deleted,
                              lib)
    buf = torch.empty(size, dtype=torch.uint8, device=dev)
    with device_guard(dev):
        rc = lib.crdt_ingest(
            state.vv.data_ptr(), state.processed.data_ptr(),
            state.actor.data_ptr(), state.present.data_ptr(),
            state.dot_actor.data_ptr(), state.dot_counter.data_ptr(),
            state.deleted.data_ptr(), state.del_dot_actor.data_ptr(),
            state.del_dot_counter.data_ptr(), add_rows.data_ptr(),
            del_rows.data_ptr(), live.data_ptr(), buf.data_ptr(), num_b,
            num_e, num_a, k_changed, k_deleted, stream_of(buf))
    if rc:
        _build.check(lib, rc, "crdt_ingest")
    v = _views(buf, groups)
    merged = AWSetDeltaState(
        vv=v["vv"], present=v["present"], dot_actor=v["dot_actor"],
        dot_counter=v["dot_counter"], actor=state.actor,
        deleted=v["deleted"], del_dot_actor=v["del_dot_actor"],
        del_dot_counter=v["del_dot_counter"], processed=v["processed"])
    payload = DeltaPayload(
        src_vv=v["vv"], changed=v["changed"], ch_da=v["p_ch_da"],
        ch_dc=v["p_ch_dc"], deleted=v["p_deleted"], del_da=v["p_del_da"],
        del_dc=v["p_del_dc"], src_actor=state.actor,
        src_processed=v["processed"])
    if k_changed == 0 or k_deleted == 0:
        return merged, payload, None
    return merged, payload, CompactDeltaPayload(
        *(v[name] for name in CompactDeltaPayload._fields))


def _kernel_buffer(payload, compact):
    """The K10 buffer ``compact`` lies in, as (an int32 view of it from
    its start, its layout), or None when ``compact`` is not laid out as
    the kernel lays out its output (the plain version's tensors)."""
    src_vv, overflow = compact.src_vv, compact.overflow
    if not src_vv.is_cuda or src_vv.storage_offset() == 0:
        return None
    layout = _layout(payload.changed.shape[0], src_vv.shape[0], 0,
                     compact.ch_idx.shape[0], compact.del_idx.shape[0])
    words, bools = layout[2][0], layout[2][1]
    if (src_vv.storage_offset() != sum(words[2][:words[3][1]])
            or overflow.storage_offset()
            != bools[0] + sum(bools[2][:bools[3][2]])
            or overflow.untyped_storage().data_ptr()
            != src_vv.untyped_storage().data_ptr()):
        return None
    return src_vv.as_strided((layout[2][-1][1] // 4,), (1,), 0), layout


def _from_host(raw: np.ndarray, names_dtypes, groups, base: int = 0) -> dict:
    """The regions of ``groups`` (named by ``names_dtypes``, slices of
    ``_GROUPS``) as numpy views of ``raw``, the buffer's bytes from
    offset ``base``."""
    out = {}
    for (names, _), (lo, hi, sizes, picks, dtype) in zip(names_dtypes,
                                                          groups):
        part = raw[lo - base:hi - base].view(
            np.uint32 if dtype == torch.int32 else np.bool_)
        pieces = np.split(part, np.cumsum(sizes)[:-1])
        out.update(zip(names, (pieces[i] for i in picks)))
    return out


def record_to_host(pre_vv: torch.Tensor, payload, compact):
    """A WAL record's device inputs on the host: ``(pre_vv, payload,
    compact)``, ``pre_vv`` and ``compact`` as numpy (uint32 and bool),
    ``compact`` None when none was made.  A compact form made by the
    kernel comes back with the kernel's copy of the pre-batch vv in ONE
    device->host copy of its buffer's head, and the dense payload in one
    more copy only when the compact form overflowed (the record is then
    dense); any other (the plain version's) in a copy each, ``payload``
    as given."""
    found = None if compact is None else _kernel_buffer(payload, compact)
    if found is None:
        return (host(pre_vv), payload,
                None if compact is None else to_host(compact))
    words, (_, head, groups) = found
    out = _from_host(words[:head // 4].cpu().numpy().view(np.uint8),
                     _GROUPS[:2], groups[:2])
    out["src_actor"] = out["src_actor"].reshape(())
    out["overflow"] = out["overflow"].reshape(())
    compact = CompactDeltaPayload(
        *(out[name] for name in CompactDeltaPayload._fields))
    if bool(compact.overflow):
        lo, hi = groups[2][0], groups[3][1]
        out.update(_from_host(
            words[lo // 4:hi // 4].cpu().numpy().view(np.uint8),
            _GROUPS[2:], groups[2:], base=lo))
        payload = DeltaPayload(
            src_vv=out["vv"], changed=out["changed"], ch_da=out["p_ch_da"],
            ch_dc=out["p_ch_dc"], deleted=out["p_deleted"],
            del_da=out["p_del_da"], del_dc=out["p_del_dc"],
            src_actor=compact.src_actor, src_processed=out["processed"])
    return out["pre_vv"], payload, compact


def ingest_rows_delta_fused(state: AWSetDeltaState, add_rows, del_rows,
                            live, *, k_changed: int, k_deleted: int,
                            kernel: str = "auto"):
    """K10: apply B op-rows (``add_rows``/``del_rows`` bool[B, E], ``live``
    bool[B], padding rows masked) to one replica slice and return
    ``(merged, payload, compact)``: the merged slice, the batch's δ
    against the pre-batch vv, and that δ in fixed-K form (None when
    either K is 0)."""
    dev = state.vv.device
    add_rows, del_rows, live = (
        x if isinstance(x, torch.Tensor) and x.dtype == torch.bool
        and x.device == dev else torch.as_tensor(x, dtype=torch.bool,
                                                 device=dev)
        for x in (add_rows, del_rows, live))
    _check_rows(add_rows, del_rows, live, state.present.shape[-1])
    if use_kernel(kernel, state.vv):
        out = _launch(state, add_rows.contiguous(), del_rows.contiguous(),
                      live.contiguous(), k_changed, k_deleted)
        with _count_lock:
            ingest_rows_delta_fused.launches += 1
        return out
    arow, drow, add_dc, del_ctr, final = row_counters(
        state, add_rows, del_rows, live)
    vv, processed = clock_outputs(state, final, add_rows.shape[0])
    merged, payload = ingest_fold_plain(state, arow, drow, add_dc, del_ctr,
                                        vv, processed)
    if k_changed == 0 or k_deleted == 0:
        return merged, payload, None
    return merged, payload, compact_payload(payload, k_changed, k_deleted)


ingest_rows_delta_fused.launches = 0
