"""Checkpoint / resume for packed CRDT states: verified and generational.

The counterpart of the JAX package's ``utils/checkpoint.py``, in the same
format, so either package restores the other's checkpoints: ONE ``.npz``
file holding the state's arrays (uint32 and bool, the JAX dtypes; the
port's int32 bits are saved through their uint32 view) plus a
``__manifest__`` entry (utf-8 JSON: state type name, field list, step,
element dictionary, user metadata, per-array CRC32 digests, optional
generation number).  A save writes a temp file in the target directory,
fsyncs it, ``os.replace``s it into place and fsyncs the DIRECTORY; stray
``.ckpt-tmp-*`` files from a crash mid-save are swept on the next save
or restore in that directory (single writer per directory).

Every array's digest is re-verified on restore (``CheckpointCorrupt`` on
a mismatch): a bit-rotted or torn checkpoint is refused, never loaded.
``CheckpointStore`` keeps generations: retention of the last K files,
newest-valid-wins restore with fallback past corrupt ones, and a
generation fence (``GenerationRegression``).

A checkpoint may carry the element dictionary (``utils/codec.
ElementDict``) of a dictionary-coded deployment in its manifest; restore
hands it back beside the state.  A state type neither package restores
typed restores as a plain dict of numpy arrays, with a warning and a
``restore.unknown_type`` count.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import warnings
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from go_crdt_playground_tpu_torch._u32 import from_numpy_u32, host
from go_crdt_playground_tpu_torch.device import resolve_device
from go_crdt_playground_tpu_torch.models.awset import AWSetState
from go_crdt_playground_tpu_torch.models.awset_delta import AWSetDeltaState
from go_crdt_playground_tpu_torch.models.digest import array_digest
from go_crdt_playground_tpu_torch.models.packed import (
    DotPackedAWSetDeltaState, DotPackedAWSetState, PackedAWSetDeltaState,
    PackedAWSetState)
from go_crdt_playground_tpu_torch.ops.lattices import (
    GCounterState, LWWMapState, MVRegisterState, ORMapState, PNCounterState,
    TwoPSetState)
from go_crdt_playground_tpu_torch.utils.codec import ElementDict
from go_crdt_playground_tpu_torch.utils.fsutil import fsync_dir

_MANIFEST_KEY = "__manifest__"
_FORMAT_VERSION = 2
_TMP_PREFIX = ".ckpt-tmp-"

# every state type the reference restores typed
STATE_TYPES = {
    cls.__name__: cls
    for cls in (AWSetState, AWSetDeltaState, PackedAWSetState,
                PackedAWSetDeltaState, DotPackedAWSetState,
                DotPackedAWSetDeltaState, GCounterState, PNCounterState,
                TwoPSetState, LWWMapState, MVRegisterState, ORMapState)
}


class CheckpointCorrupt(ValueError):
    """A checkpoint failed integrity verification (array digest mismatch,
    generation spoof, or unreadable container).  The generational store
    treats this as "fall back to the previous generation"."""


class GenerationRegression(RuntimeError):
    """Restore would hand back a generation older than the caller's
    fence."""


class Checkpoint(NamedTuple):
    state: Any
    dictionary: Optional[ElementDict]
    step: Optional[int]
    metadata: Dict[str, Any]
    generation: Optional[int] = None


def sweep_tmp_files(directory: str, keep: Optional[str] = None) -> int:
    """Remove stray ``.ckpt-tmp-*`` files a crashed save left behind;
    ``keep`` protects the save in progress.  Returns the count swept."""
    swept = 0
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    for name in names:
        if not name.startswith(_TMP_PREFIX):
            continue
        full = os.path.join(directory, name)
        if keep is not None and os.path.abspath(full) == os.path.abspath(keep):
            continue
        try:
            os.unlink(full)
            swept += 1
        except OSError:
            pass
    return swept


def save_checkpoint(path: str, state,
                    dictionary: Optional[ElementDict] = None,
                    step: Optional[int] = None,
                    metadata: Optional[Dict[str, Any]] = None,
                    generation: Optional[int] = None) -> str:
    """Atomically and durably write ``state`` (a state NamedTuple of
    tensors) and the optional element ``dictionary`` to the single-file
    checkpoint at ``path``; returns ``path``."""
    fields = getattr(state, "_fields", None)
    if fields is None:
        raise TypeError(
            f"state must be a state NamedTuple, got {type(state)}")
    arrays = {f: host(getattr(state, f)) for f in fields}
    if _MANIFEST_KEY in arrays:
        raise ValueError(f"state field may not be named {_MANIFEST_KEY}")
    manifest = {
        "format_version": _FORMAT_VERSION,
        "state_type": type(state).__name__,
        "fields": list(fields),
        "step": step,
        "metadata": metadata or {},
        "dictionary": dictionary.state_dict() if dictionary else None,
        "digests": {f: array_digest(a) for f, a in arrays.items()},
        "generation": generation,
    }
    blob = np.frombuffer(
        json.dumps(manifest, sort_keys=True).encode("utf-8"), np.uint8)
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=_TMP_PREFIX, dir=parent)
    sweep_tmp_files(parent, keep=tmp)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **{_MANIFEST_KEY: blob}, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic on POSIX
        # fsync the directory so the RENAME is durable too
        fsync_dir(parent)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype == bool:
        return torch.from_numpy(a.copy()).to(device)
    return from_numpy_u32(a, device)


def restore_checkpoint(path: str, device="cuda", *, verify: bool = True,
                       recorder=None) -> Checkpoint:
    """Load a checkpoint file into a state of tensors on ``device``.

    ``verify=True`` re-computes every array's CRC32 digest against the
    manifest and raises ``CheckpointCorrupt`` on any mismatch
    (digestless checkpoints load unverified); an unreadable container
    also raises ``CheckpointCorrupt``."""
    dev = resolve_device(device)
    sweep_tmp_files(os.path.dirname(os.path.abspath(path)) or ".")
    try:
        with np.load(path) as z:
            manifest = json.loads(z[_MANIFEST_KEY].tobytes().decode("utf-8"))
            arrays = {k: z[k] for k in z.files if k != _MANIFEST_KEY}
    except FileNotFoundError:
        raise
    except Exception as e:  # BadZipFile, zlib.error, KeyError, JSON, ...
        raise CheckpointCorrupt(f"unreadable checkpoint {path!r}: {e}") from e
    if manifest["format_version"] > _FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format {manifest['format_version']} is newer "
            f"than this framework understands ({_FORMAT_VERSION})")
    digests = manifest.get("digests")
    if verify and digests is not None:
        for name, expect in digests.items():
            if name not in arrays:
                raise CheckpointCorrupt(
                    f"checkpoint {path!r}: digested array {name!r} missing")
            got = array_digest(arrays[name])
            if got != expect:
                raise CheckpointCorrupt(
                    f"checkpoint {path!r}: array {name!r} digest mismatch "
                    f"(manifest {expect}, recomputed {got})")
    cls = STATE_TYPES.get(manifest["state_type"])
    if cls is not None:
        state = cls(**{f: _tensor(arrays[f], dev)
                       for f in manifest["fields"]})
    else:  # a state type this port lacks: hand back the arrays, loudly
        warnings.warn(
            f"checkpoint {path!r} holds state type "
            f"{manifest['state_type']!r} unknown to this build; restoring "
            "a plain array dict (typed ops will not accept it)",
            RuntimeWarning, stacklevel=2)
        if recorder is not None:
            recorder.count("restore.unknown_type")
        state = arrays
    dictionary = None
    if manifest["dictionary"] is not None:
        dictionary = ElementDict.from_state_dict(manifest["dictionary"])
    return Checkpoint(state=state, dictionary=dictionary,
                      step=manifest["step"], metadata=manifest["metadata"],
                      generation=manifest.get("generation"))


# ---------------------------------------------------------------------------
# Generational store
# ---------------------------------------------------------------------------

_GEN_RE = re.compile(r"^gen-(\d{12})\.ckpt$")


class CheckpointStore:
    """A directory of verified checkpoint generations, ``gen-<n>.ckpt``
    (12 digits).  ``save`` writes generation ``latest+1`` and prunes
    beyond the newest ``keep``; ``restore`` walks newest to oldest,
    skipping any generation that fails verification (each skip counts
    ``restore.fallbacks``), and refuses a generation below
    ``min_generation``.  A generation number is trusted only when the
    file name and the manifest agree.  The WAL conventionally lives in a
    ``wal/`` subdirectory, which the store never touches."""

    def __init__(self, path: str, *, keep: int = 3, recorder=None):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.path = os.path.abspath(path)
        self.keep = keep
        self.recorder = recorder
        os.makedirs(self.path, exist_ok=True)
        sweep_tmp_files(self.path)

    def _count(self, name: str, n: int = 1) -> None:
        if self.recorder is not None:
            self.recorder.count(name, n)

    def path_for(self, generation: int) -> str:
        return os.path.join(self.path, f"gen-{generation:012d}.ckpt")

    def generations(self) -> List[int]:
        """Existing generation numbers, ascending (unverified)."""
        out = []
        for name in os.listdir(self.path):
            m = _GEN_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_generation(self) -> int:
        gens = self.generations()
        return gens[-1] if gens else 0

    def save(self, state, *, dictionary: Optional[ElementDict] = None,
             step: Optional[int] = None,
             metadata: Optional[Dict[str, Any]] = None) -> int:
        """Write the next generation and prune old ones; returns the new
        generation number (monotonic past corrupt or pruned files)."""
        gen = self.latest_generation() + 1
        save_checkpoint(self.path_for(gen), state, dictionary=dictionary,
                        step=step, metadata=metadata, generation=gen)
        for old in self.generations()[:-self.keep]:
            try:
                os.unlink(self.path_for(old))
            except OSError:
                pass
        fsync_dir(self.path)
        return gen

    def restore(self, *, min_generation: int = 0, device="cuda"
                ) -> Tuple[int, Checkpoint]:
        """Newest-valid-wins restore with fallback: ``(generation,
        Checkpoint)``.  Raises ``FileNotFoundError`` when the store is
        empty, ``CheckpointCorrupt`` when every generation fails
        verification, ``GenerationRegression`` when the best valid
        generation sits below ``min_generation``."""
        device = resolve_device(device)  # raises here, never as a fallback
        sweep_tmp_files(self.path)
        gens = self.generations()
        if not gens:
            raise FileNotFoundError(f"no checkpoint generations in "
                                    f"{self.path!r}")
        last_err: Optional[Exception] = None
        for gen in reversed(gens):
            try:
                ck = restore_checkpoint(self.path_for(gen), device,
                                        verify=True, recorder=self.recorder)
                if ck.generation is not None and ck.generation != gen:
                    raise CheckpointCorrupt(
                        f"generation spoof: file gen-{gen} carries manifest "
                        f"generation {ck.generation}")
            except Exception as e:  # noqa: BLE001 — any unreadable
                # generation falls back, counted, never aborts recovery
                last_err = e
                self._count("restore.fallbacks")
                continue
            if gen < min_generation:
                raise GenerationRegression(
                    f"best valid generation {gen} in {self.path!r} is older "
                    f"than the fence ({min_generation}); refusing to regress")
            if self.recorder is not None and hasattr(self.recorder,
                                                     "set_gauge"):
                self.recorder.set_gauge("restore.generation", gen)
            return gen, ck
        raise CheckpointCorrupt(
            f"every generation in {self.path!r} failed verification "
            f"(last error: {last_err})")
