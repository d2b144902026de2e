"""Collectives over a mesh: the counterpart of ``shard_map`` and of the
``jax.lax`` collectives the sharded rounds use.

A *grid* is a numpy object array of the mesh's shape holding one value
per slot: a tensor, or a NamedTuple of tensors, on the slot's device
(None for a slot another process owns).  The body of a sharded round is
a plain function of one slot's local values, run per local slot by
``map_slots``; the exchanges between slots are the functions below.

Every value a slot receives is a FRESH buffer on its device: between
cards that is a peer copy, on one device a device-local copy.  It never
aliases the sender's block (JAX's values are immutable; a received
block that aliased the sender's would let a later in-place update show
through on another slot when slots share a device).

Across processes (parallel/multihost.py) the moves between slots of
different ranks are one ``torch.distributed.batch_isend_irecv`` per
exchange, every rank listing the moves in the same order, and the
reductions one ``all_reduce``.  gloo sends and receives host tensors
only, so under gloo a block that lives on a card is staged through host
memory on the way out and back (``host_staged``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from go_crdt_playground_tpu_torch._u32 import MASK
from go_crdt_playground_tpu_torch.parallel.mesh import Mesh, empty_grid, fresh


def _leaves(value) -> List[torch.Tensor]:
    return list(value) if isinstance(value, tuple) else [value]


def _rebuild(template, leaves):
    if isinstance(template, tuple):
        return type(template)(*leaves)
    return leaves[0]


def map_slots(mesh: Mesh, fn: Callable, *grids) -> np.ndarray:
    """Run ``fn(idx, *values)`` on every local slot; the grid of its
    results."""
    out = empty_grid(mesh)
    for idx in mesh.local_slots():
        out[idx] = fn(idx, *(g[idx] for g in grids))
    return out


def axis_index(mesh: Mesh, axis: str) -> np.ndarray:
    """Each slot's position along ``axis``."""
    out = empty_grid(mesh)
    ax = mesh.axis(axis)
    for idx in mesh.slots():
        out[idx] = idx[ax]
    return out


def _line_slots(mesh: Mesh, idx, axis: str) -> List[tuple]:
    """The slots of the line along ``axis`` through slot ``idx``."""
    ax = mesh.axis(axis)
    return [idx[:ax] + (k,) + idx[ax + 1:]
            for k in range(mesh.shape[axis])]


# ---------------------------------------------------------------------------
# Moves between slots
# ---------------------------------------------------------------------------


def host_staged() -> bool:
    """True when cross-process moves go through host memory (gloo)."""
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_backend() == "gloo"


def _wire(t: torch.Tensor, staged: bool) -> torch.Tensor:
    """The tensor a send hands to the process group: contiguous, bools as
    bytes, on the host under gloo."""
    t = t.contiguous()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return t.cpu() if staged else t


def exchange(mesh: Mesh, moves: Sequence[Tuple[tuple, tuple]],
             payload: Callable, spec: Callable) -> Dict[tuple, list]:
    """Move one list of tensors along each ``(src, dst)`` slot pair.
    ``payload(src, dst)`` builds the list at a local ``src``;
    ``spec(src, dst)`` gives ``[(shape, dtype), ...]`` of that list for
    a receiving process that cannot build it.  Returns ``{(src, dst):
    tensors on dst's device}`` for every local ``dst``.  Every rank must
    list ``moves`` in the same order."""
    out: Dict[tuple, list] = {}
    ops, pending = [], []
    staged = None
    for src, dst in moves:
        s_loc, d_loc = mesh.is_local(src), mesh.is_local(dst)
        if s_loc and d_loc:
            out[(src, dst)] = [fresh(t, mesh.device(dst))
                               for t in payload(src, dst)]
            continue
        if not (s_loc or d_loc):
            continue
        import torch.distributed as dist

        if staged is None:
            staged = host_staged()
        if s_loc:
            for t in payload(src, dst):
                ops.append(dist.P2POp(dist.isend, _wire(t, staged),
                                      int(mesh.owners[dst])))
        else:
            bufs = []
            for shape, dtype in spec(src, dst):
                wire_dtype = torch.uint8 if dtype == torch.bool else dtype
                dev = "cpu" if staged else mesh.device(dst)
                buf = torch.empty(shape, dtype=wire_dtype, device=dev)
                bufs.append((buf, dtype))
                ops.append(dist.P2POp(dist.irecv, buf,
                                      int(mesh.owners[src])))
            pending.append(((src, dst), bufs))
    if ops:
        import torch.distributed as dist

        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for key, bufs in pending:
        dev = mesh.device(key[1])
        out[key] = [buf.to(dev).to(dtype) for buf, dtype in bufs]
    return out


def _spec_of(value):
    return [(tuple(t.shape), t.dtype) for t in _leaves(value)]


def ppermute(mesh: Mesh, grid: np.ndarray, axis: str,
             pairs: Sequence[Tuple[int, int]]) -> np.ndarray:
    """``jax.lax.ppermute``: along every line of ``axis``, slot ``src``'s
    value goes to slot ``dst`` for each ``(src, dst)`` in ``pairs``; a
    slot no pair names receives zeros.  The blocks of a line share one
    shape (the receiver's own block gives the shape it expects)."""
    ax = mesh.axis(axis)
    moves = []
    for idx in mesh.slots():
        if idx[ax] != 0:
            continue
        for s, d in pairs:
            moves.append((idx[:ax] + (s,) + idx[ax + 1:],
                          idx[:ax] + (d,) + idx[ax + 1:]))
    got = exchange(mesh, moves, lambda s, d: _leaves(grid[s]),
                   lambda s, d: _spec_of(grid[d]))
    out = empty_grid(mesh)
    for (s, d), leaves in got.items():
        out[d] = _rebuild(grid[d], leaves)
    for idx in mesh.local_slots():
        if out[idx] is None:
            out[idx] = _rebuild(grid[idx], [torch.zeros_like(t)
                                            for t in _leaves(grid[idx])])
    return out


def all_gather(mesh: Mesh, grid: np.ndarray, axis: str,
               dim: int = 0) -> np.ndarray:
    """``jax.lax.all_gather(..., tiled=True)``: every slot of a line gets
    the line's tensors concatenated along ``dim`` in slot order."""
    moves = []
    for idx in mesh.slots():
        for src in _line_slots(mesh, idx, axis):
            moves.append((src, idx))
    got = exchange(mesh, moves, lambda s, d: _leaves(grid[s]),
                   lambda s, d: _spec_of(grid[d]))
    out = empty_grid(mesh)
    for idx in mesh.local_slots():
        parts = [got[(src, idx)][0] for src in _line_slots(mesh, idx, axis)]
        out[idx] = torch.cat(parts, dim=dim)
    return out


# ---------------------------------------------------------------------------
# Reductions over an axis
# ---------------------------------------------------------------------------

_IDENTITY = {"sum": 0, "min": MASK, "max": 0}


def _combine(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if op == "sum":
        return (a + b) & MASK
    return torch.minimum(a, b) if op == "min" else torch.maximum(a, b)


def _reduce(mesh: Mesh, grid: np.ndarray, axis: str, op: str) -> np.ndarray:
    """Reduce int64 values holding uint32 numbers (``_u32.widen``) over
    each line of ``axis``: every slot of a line gets the line's
    reduction (sums mod 2^32, min and max unsigned) on its device."""
    ax = mesh.axis(axis)
    lines = [idx for idx in mesh.slots() if idx[ax] == 0]
    template = next(grid[idx] for idx in mesh.local_slots())
    partial = []
    for head in lines:
        acc = None
        for idx in _line_slots(mesh, head, axis):
            if mesh.is_local(idx):
                v = grid[idx].to(template.device, torch.int64)
                acc = v if acc is None else _combine(op, acc, v)
        if acc is None:
            acc = torch.full_like(template, _IDENTITY[op], dtype=torch.int64)
        partial.append(acc)
    stacked = torch.stack(partial)
    if mesh.multiprocess():
        import torch.distributed as dist

        red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}[op]
        wire = stacked.cpu() if host_staged() else stacked
        dist.all_reduce(wire, op=red)
        stacked = wire.to(template.device)
        if op == "sum":
            stacked = stacked & MASK
    out = empty_grid(mesh)
    for k, head in enumerate(lines):
        for idx in _line_slots(mesh, head, axis):
            if mesh.is_local(idx):
                out[idx] = fresh(stacked[k], mesh.device(idx))
    return out


def psum(mesh: Mesh, grid: np.ndarray, axis: str) -> np.ndarray:
    """Sum mod 2^32 over ``axis`` (values: int64 uint32 numbers)."""
    return _reduce(mesh, grid, axis, "sum")


def pmin(mesh: Mesh, grid: np.ndarray, axis: str) -> np.ndarray:
    """Unsigned min over ``axis`` (values: int64 uint32 numbers)."""
    return _reduce(mesh, grid, axis, "min")


def pmax(mesh: Mesh, grid: np.ndarray, axis: str) -> np.ndarray:
    """Unsigned max over ``axis`` (values: int64 uint32 numbers)."""
    return _reduce(mesh, grid, axis, "max")
