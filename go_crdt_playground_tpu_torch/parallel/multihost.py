"""Multi-process deployment: the same sharded gossip rounds over a mesh
whose slots belong to several processes (several hosts, or one process
a card).

The counterpart of the JAX package's ``parallel/multihost.py`` on
``torch.distributed``: ``initialize`` brings up the process group (gloo
on the CPU, nccl on cards), ``global_mesh`` builds one mesh over every
process's devices, each slot owned by the rank that contributed its
device, and the rounds of parallel/gossip.py run unchanged: moves
between slots of different ranks go through
``torch.distributed.batch_isend_irecv`` and reductions through
``all_reduce`` (parallel/shardmap.py).  A gloo group whose slots live
on a card stages each exchanged block through host memory.

The mesh axis order is the placement policy: the replica axis is
outermost, so contiguous replica blocks live in one process and ring
offsets smaller than a process's block stay inside it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from go_crdt_playground_tpu_torch.parallel import mesh as mesh_mod


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device="cuda") -> None:
    """Join the process group (one call per process, before any sharded
    round).  ``coordinator_address``: ``tcp://host:port`` (or
    ``host:port``) or ``file://path`` of a shared file; nothing on the
    machine tells a process of its cluster, so the address, the world
    size and the rank are the caller's.  ``backend``: default nccl for
    slots on cards (raising without a card), gloo for ``device='cpu'``."""
    import torch.distributed as dist

    if backend is None:
        dev = mesh_mod.resolve_device(device)
        backend = "nccl" if dev.type == "cuda" else "gloo"
    init = coordinator_address
    if init is not None and "://" not in init:
        init = f"tcp://{init}"
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(element_shards: int = 1,
                local_devices: Optional[Sequence] = None) -> mesh_mod.Mesh:
    """One (replica, element) mesh over the devices of every process,
    rank-major, each slot owned by the rank that contributed it.  Call
    after ``initialize``.  ``local_devices``: this process's slots
    (default every visible card, raising when none is visible; name one
    device more than once to give a process several slots on it)."""
    import torch.distributed as dist

    if local_devices is None:
        local_devices = mesh_mod.take_devices()
    local = [str(torch.device(d)) for d in local_devices]
    every = [local]
    if dist.is_initialized():
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, local)
    devices, owners = [], []
    for rank, devs in enumerate(every):
        devices += devs
        owners += [rank] * len(devs)
    if len(devices) % element_shards:
        raise ValueError(
            f"{len(devices)} devices not divisible by "
            f"element_shards={element_shards}")
    shape = (len(devices) // element_shards, element_shards)
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return mesh_mod.Mesh(grid.reshape(shape),
                         (mesh_mod.REPLICA_AXIS, mesh_mod.ELEMENT_AXIS),
                         owners=np.asarray(owners).reshape(shape),
                         rank=process_index())


def process_replica_block(num_replicas: int) -> Tuple[int, int]:
    """[start, stop) of the replica rows whose slots live in THIS process
    under the canonical layout (every process the same number of
    slots).  Requires even division."""
    n = process_count()
    if num_replicas % n:
        raise ValueError(
            f"num_replicas={num_replicas} not divisible by "
            f"process_count={n}; pad the replica axis (observer rows are "
            "free: they never tick a clock)")
    per = num_replicas // n
    start = process_index() * per
    return start, start + per


def shard_local_rows(rows, mesh: mesh_mod.Mesh) -> mesh_mod.ShardedState:
    """A sharded state from THIS process's replica rows (the
    ``process_replica_block`` slice of every field): each local slot
    takes its block of them, as JAX's
    ``make_array_from_process_local_data`` does."""
    start, stop = process_replica_block(
        rows.vv.shape[0] * process_count())
    cls = type(rows)
    specs = mesh_mod.partition_specs(cls)
    num_r = rows.vv.shape[0] * process_count()
    blocks = mesh_mod.empty_grid(mesh)
    for idx in mesh.local_slots():
        blk = []
        for x, spec in zip(rows, specs):
            full_shape = (num_r,) + tuple(x.shape[1:])
            sl = list(mesh_mod.slot_index(spec, full_shape, mesh, idx))
            sl[0] = slice(sl[0].start - start, sl[0].stop - start)
            blk.append(mesh_mod.fresh(x[tuple(sl)], mesh.device(idx)))
        blocks[idx] = cls(*blk)
    return mesh_mod.ShardedState(mesh, blocks, cls, specs)
