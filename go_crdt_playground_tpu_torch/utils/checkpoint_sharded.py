"""Sharded checkpoint / resume: one file a slot plus a manifest.

The counterpart of the JAX package's ``utils/checkpoint_sharded.py``,
which writes with orbax.  The port keeps a sharded state sharded on
disk in a format of its own: ``<path>/slot-<i>-<j>.npz``, each local
slot's block in the single-file format of utils/checkpoint.py (per-array
CRC digests, atomic replace, directory fsync), written by the process
that owns the slot, and ``<path>/manifest.json`` (state type, fields,
mesh shape and layout, step, metadata, element dictionary, generation)
written last by rank 0.  The restore verifies every slot file, fences
the generation (``GenerationRegression``) and places each block on the
target mesh's slot, or gathers one whole state without a target.  Compare restored
arrays across the packages, not files.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from go_crdt_playground_tpu_torch.parallel import mesh as mesh_mod
from go_crdt_playground_tpu_torch.utils.checkpoint import (
    STATE_TYPES, Checkpoint, GenerationRegression, restore_checkpoint,
    save_checkpoint)
from go_crdt_playground_tpu_torch.utils.codec import ElementDict
from go_crdt_playground_tpu_torch.utils.fsutil import fsync_dir

_FORMAT_VERSION = 1
_MANIFEST_TMP = ".manifest-tmp"


def _slot_file(path: str, idx) -> str:
    return os.path.join(path, "slot-" + "-".join(map(str, idx)) + ".npz")


def save_checkpoint_sharded(path: str, state,
                            dictionary: Optional[ElementDict] = None,
                            step: Optional[int] = None,
                            metadata: Optional[Dict[str, Any]] = None,
                            generation: Optional[int] = None) -> str:
    """Write a ``ShardedState`` (or a plain state, as a one-slot mesh)
    under directory ``path``: each local slot's block to its own file,
    then the manifest."""
    if not isinstance(state, mesh_mod.ShardedState):
        if getattr(state, "_fields", None) is None:
            raise TypeError(
                f"state must be a state NamedTuple, got {type(state)}")
        state = mesh_mod.shard_state(state, mesh_mod.make_mesh(
            (1, 1), devices=[state.vv.device]))
    mesh = state.mesh
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    for idx, blk in state.local_blocks():
        save_checkpoint(_slot_file(path, idx), blk)
    _barrier(mesh)
    if mesh.rank == 0:
        manifest = {
            "format_version": _FORMAT_VERSION,
            "state_type": state.state_cls.__name__,
            "fields": list(state.state_cls._fields),
            "mesh_shape": list(mesh.devices.shape),
            "axis_names": list(mesh.axis_names),
            "specs": [list(s) for s in state.specs],
            "step": step,
            "metadata": metadata or {},
            "dictionary": dictionary.state_dict() if dictionary else None,
            "generation": generation,
        }
        tmp = os.path.join(path, _MANIFEST_TMP)
        with open(tmp, "w") as f:
            json.dump(manifest, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(path, "manifest.json"))
        fsync_dir(path)  # the rename itself must be durable
    # no process may report the checkpoint done before the manifest is
    _barrier(mesh)
    return path


def _barrier(mesh) -> None:
    if mesh.multiprocess():
        import torch.distributed as dist

        dist.barrier()


def restore_checkpoint_sharded(path: str, target=None, *,
                               min_generation: int = 0,
                               device="cuda") -> Checkpoint:
    """Restore a sharded checkpoint.  ``target``: a ``ShardedState`` whose
    mesh and layout the blocks land on (each local slot reads its own
    file), or None for one whole state on ``device``.
    ``min_generation``: a manifest below it raises
    ``GenerationRegression``."""
    path = os.path.abspath(path)
    tmp = os.path.join(path, _MANIFEST_TMP)
    if os.path.exists(tmp):  # a crash mid-save left a half manifest
        try:
            os.unlink(tmp)
        except OSError:
            pass
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["format_version"] > _FORMAT_VERSION:
        raise ValueError(
            f"sharded checkpoint format {manifest['format_version']} is "
            f"newer than this framework understands ({_FORMAT_VERSION})")
    gen = manifest.get("generation")
    if gen is not None and gen < min_generation:
        raise GenerationRegression(
            f"sharded checkpoint at {path!r} is generation {gen}, older "
            f"than the fence ({min_generation}); refusing to regress")
    cls = STATE_TYPES[manifest["state_type"]]
    shape = tuple(manifest["mesh_shape"])
    specs = cls(*(tuple(s) for s in manifest["specs"]))
    if target is not None:
        mesh = target.mesh
        if tuple(mesh.devices.shape) != shape or tuple(target.specs) != \
                tuple(specs):
            raise ValueError(
                f"target mesh {mesh.devices.shape} / layout differs from "
                f"the checkpoint's {shape}")
        blocks = mesh_mod.empty_grid(mesh)
        for idx in mesh.local_slots():
            blocks[idx] = restore_checkpoint(
                _slot_file(path, idx), mesh.device(idx)).state
        state = mesh_mod.ShardedState(mesh, blocks, cls, specs)
    else:
        import numpy as np

        grid = np.empty(shape, dtype=object)
        grid[:] = "cpu"
        mesh = mesh_mod.Mesh(grid, tuple(manifest["axis_names"]))
        blocks = mesh_mod.empty_grid(mesh)
        for idx in mesh.slots():
            blocks[idx] = restore_checkpoint(_slot_file(path, idx),
                                             device).state
        state = mesh_mod.gather_state(
            mesh_mod.ShardedState(mesh, blocks, cls, specs), device)
    dictionary = manifest.get("dictionary")
    return Checkpoint(state=state,
                      dictionary=(None if dictionary is None else
                                  ElementDict.from_state_dict(dictionary)),
                      step=manifest["step"],
                      metadata=manifest["metadata"], generation=gen)
