"""Device mesh and sharding layout for packed CRDT states.

The counterpart of the JAX package's ``parallel/mesh.py``.  The scaling
axes are replicas ``R`` (each row one replica) and the element universe
``E`` (the merge is elementwise, so sharding E is clean).  The actor
axis ``A`` is replicated by default; ``shard_actors=True`` shards it
over the element axis (the EP layout: per-actor ownership of vv slots,
gathered once per merge round).

A ``Mesh`` is a grid of ``torch.device``s under named axes, one cell a
*slot*.  A sharded state (``ShardedState``) is the grid of per-slot
local states, each on its slot's device, cut as ``partition_specs``
cuts it:

  vv[R, A], processed[R, A]  -> (REPLICA_AXIS, None)   replicated over E
  present/dots[R, E]         -> (REPLICA_AXIS, ELEMENT_AXIS)
  actor[R]                   -> (REPLICA_AXIS,)
  EP layout: vv, processed   -> (REPLICA_AXIS, ELEMENT_AXIS)

One process drives every slot (one controller, as JAX's).  Slots may
name one device more than once (``make_mesh((4, 1), devices=["cuda:0"]
* 4)``): the counterpart of JAX's forced host device count, which is
how one card or the CPU runs a mesh.  Sharing is opt-in: ``take_devices``
enumerates distinct devices unless it is handed one device by name.
In a multi-process run (parallel/multihost.py) each slot also has an
owning rank, and a process holds the blocks of its own slots only.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from go_crdt_playground_tpu_torch.device import resolve_device
from go_crdt_playground_tpu_torch.models.layout import (ACTOR_AXIS_FIELDS,
                                                        REPLICA_ONLY_FIELDS)

REPLICA_AXIS = "replica"
ELEMENT_AXIS = "element"


class Mesh:
    """A grid of devices under named axes.  ``owners`` (same shape) gives
    each slot's process rank; ``rank`` is this process's."""

    def __init__(self, devices, axis_names: Sequence[str], owners=None,
                 rank: int = 0):
        given = np.asarray(devices, dtype=object)
        devs = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(devs.shape):
            devs[idx] = torch.device(given[idx])
        if devs.ndim != len(axis_names):
            raise ValueError(f"{devs.ndim}-D device grid, "
                             f"{len(axis_names)} axis names")
        self.devices = devs
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devs.shape))
        self.owners = (np.zeros(devs.shape, np.int64) if owners is None
                       else np.asarray(owners, np.int64).reshape(devs.shape))
        self.rank = int(rank)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def slots(self):
        return list(np.ndindex(self.devices.shape))

    def is_local(self, idx) -> bool:
        return int(self.owners[idx]) == self.rank

    def local_slots(self):
        return [idx for idx in self.slots() if self.is_local(idx)]

    def device(self, idx) -> torch.device:
        return self.devices[idx]

    def axis(self, name: str) -> int:
        return self.axis_names.index(name)

    def multiprocess(self) -> bool:
        return bool((self.owners != self.rank).any())

    def _key(self):
        return (tuple(str(d) for d in self.devices.flat), self.axis_names,
                self.devices.shape, tuple(self.owners.flat), self.rank)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())


def visible_devices(kind: str = "cuda") -> list:
    """Distinct devices in a stable order: every CUDA card (raising
    when none is visible), or the CPU when ``kind='cpu'``."""
    if kind == "cpu":
        return [torch.device("cpu")]
    resolve_device(kind)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def take_devices(num_devices: Optional[int] = None, device="cuda") -> list:
    """The devices of an ``num_devices``-slot mesh.  By default, or with
    ``"cuda"`` without an index, the first distinct cards in a stable
    order (restarts of one topology place shards identically), raising
    when too few are visible.  A device named with its index
    (``"cuda:0"``) or ``"cpu"`` puts every slot on it: the opt-in to
    slots that share a device."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        n = 1 if num_devices is None else int(num_devices)
        if n < 1:
            raise ValueError(f"mesh wants {n} devices")
        return [dev] * n
    devices = visible_devices(dev.type)
    n = len(devices) if num_devices is None else int(num_devices)
    if not 1 <= n <= len(devices):
        raise ValueError(
            f"mesh wants {n} devices; {len(devices)} visible (slots may "
            f"share one device when it is named: device='cuda:0' or "
            f"devices=['cuda:0'] * {n})")
    return devices[:n]


def make_mesh(mesh_shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (replica_shards, element_shards) mesh.  Default: every visible
    card on the replica axis (raising when none is visible)."""
    if devices is None:
        devices = take_devices()
    devices = list(devices)
    if mesh_shape is None:
        mesh_shape = (len(devices), 1)
    r, e = mesh_shape
    if r * e != len(devices):
        raise ValueError(f"mesh_shape {mesh_shape} != #devices {len(devices)}")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return Mesh(grid.reshape(r, e), (REPLICA_AXIS, ELEMENT_AXIS))


def partition_specs(state_cls, shard_actors: bool = False):
    """The layout of a state class: per field, the mesh axis each tensor
    dimension is cut over (None = replicated)."""
    actor_spec = ((REPLICA_AXIS, ELEMENT_AXIS) if shard_actors
                  else (REPLICA_AXIS, None))
    return state_cls(**{
        name: ((REPLICA_AXIS,) if name in REPLICA_ONLY_FIELDS
               else actor_spec if name in ACTOR_AXIS_FIELDS
               else (REPLICA_AXIS, ELEMENT_AXIS))
        for name in state_cls._fields})


def validate_ep_layout(state, mesh: Mesh) -> None:
    """EP layout precondition: the actor axis must divide evenly over the
    mesh element dim."""
    num_a = (global_shape(state, "vv")[-1]
             if isinstance(state, ShardedState) else state.vv.shape[-1])
    if num_a % mesh.shape[ELEMENT_AXIS]:
        raise ValueError(
            f"EP layout needs A={num_a} divisible by the mesh "
            f"element dim {mesh.shape[ELEMENT_AXIS]}")


def slot_index(spec, shape, mesh: Mesh, idx) -> tuple:
    """The index expression of slot ``idx``'s block of a tensor of
    ``shape`` cut by ``spec``."""
    out = []
    for dim, name in enumerate(spec):
        if name is None or name not in mesh.shape:
            out.append(slice(None))
            continue
        n = mesh.shape[name]
        if shape[dim] % n:
            raise ValueError(
                f"dimension {dim} of size {shape[dim]} does not divide "
                f"over the {n} slots of mesh axis {name!r}")
        step = shape[dim] // n
        k = idx[mesh.axis(name)]
        out.append(slice(k * step, (k + 1) * step))
    return tuple(out)


def fresh(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device`` that never aliases ``t``
    (also when ``device`` is ``t``'s own)."""
    return t.to(device, copy=True).contiguous()


class ShardedState:
    """A state cut over a mesh: ``blocks[idx]`` is slot idx's local state
    (a ``state_cls`` of tensors on the slot's device), None for a slot
    another process owns."""

    def __init__(self, mesh: Mesh, blocks: np.ndarray, state_cls, specs):
        self.mesh = mesh
        self.blocks = blocks
        self.state_cls = state_cls
        self.specs = specs

    @property
    def shard_actors(self) -> bool:
        return self.specs.vv == (REPLICA_AXIS, ELEMENT_AXIS)

    def block(self, idx):
        return self.blocks[idx]

    def with_blocks(self, blocks) -> "ShardedState":
        return ShardedState(self.mesh, blocks, self.state_cls, self.specs)

    def local_blocks(self):
        return [(idx, self.blocks[idx]) for idx in self.mesh.local_slots()]


def global_shape(sharded: ShardedState, field: str) -> tuple:
    """The whole shape of one field of a sharded state."""
    k = sharded.state_cls._fields.index(field)
    spec = sharded.specs[k]
    local = next(b for _, b in sharded.local_blocks())[k].shape
    return tuple(n * (sharded.mesh.shape[ax] if ax is not None else 1)
                 for n, ax in zip(local, list(spec) + [None] * len(local)))


def empty_grid(mesh: Mesh) -> np.ndarray:
    return np.empty(mesh.devices.shape, dtype=object)


def shard_state(state, mesh: Mesh, shard_actors: bool = False
                ) -> ShardedState:
    """Place a state (one tensor per field, any device) onto the mesh with
    the canonical layout: each local slot gets a fresh copy of its block
    on its device."""
    if isinstance(state, ShardedState):
        state = gather_state(state)
    if shard_actors:
        validate_ep_layout(state, mesh)
    cls = type(state)
    specs = partition_specs(cls, shard_actors)
    blocks = empty_grid(mesh)
    for idx in mesh.local_slots():
        dev = mesh.device(idx)
        blocks[idx] = cls(*(
            fresh(x[slot_index(spec, x.shape, mesh, idx)], dev)
            for x, spec in zip(state, specs)))
    return ShardedState(mesh, blocks, cls, specs)


def assemble(mesh: Mesh, spec, grid: np.ndarray, device=None
             ) -> torch.Tensor:
    """One tensor from a grid of per-slot blocks cut by ``spec``: blocks
    concatenated along each cut dimension, replicated axes read at slot
    0.  Every slot must be local."""
    pick = [0] * len(mesh.axis_names)
    cut = [(dim, mesh.axis(name)) for dim, name in enumerate(spec)
           if name is not None and name in mesh.shape]

    def build(k: int):
        if k == len(cut):
            blk = grid[tuple(pick)]
            if blk is None:
                raise ValueError("gather needs every slot on this process")
            return blk if device is None else blk.to(device)
        dim, ax = cut[k]
        parts = []
        for i in range(mesh.devices.shape[ax]):
            pick[ax] = i
            parts.append(build(k + 1))
        pick[ax] = 0
        return torch.cat(parts, dim=dim)

    return build(0)


def gather_state(sharded: ShardedState, device=None):
    """The inverse of ``shard_state``: one state with every field whole,
    on ``device`` (default: slot 0's device)."""
    mesh = sharded.mesh
    if device is None:
        device = mesh.device((0,) * len(mesh.axis_names))
    fields = []
    for k, spec in enumerate(sharded.specs):
        grid = empty_grid(mesh)
        for idx in mesh.slots():
            blk = sharded.blocks[idx]
            grid[idx] = None if blk is None else blk[k]
        fields.append(assemble(mesh, spec, grid, device))
    return sharded.state_cls(*fields)
