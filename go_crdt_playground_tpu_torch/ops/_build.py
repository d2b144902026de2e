"""Build the package's CUDA sources with ``nvcc`` at first use and load
them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes
``build/lib<name>-<hash>.so`` inside the package; the hash covers the
source, the shared headers and the flags, so an edited source is never
served from a stale build.  ``build_all`` starts one ``nvcc`` per source,
all at once, and waits for them together.  The compiler's report
(``-Xptxas -v``: registers, shared memory and spills of every kernel) is
kept beside the library as ``lib<name>-<hash>.log`` (``build_log``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``nvcc`` from $CUDA_HOME, else PATH, else the toolkit's default
    install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the package's CUDA kernels")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    return BUILD / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source into a temporary file beside the target
    (renamed into place on success, so concurrent builders never load a
    half-written library).  Returns (process, tmp, target) or None when
    the library is already built."""
    target = _library_path(name)
    if target.exists():
        return None
    nvcc = nvcc_path()
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, target = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(rc={proc.returncode}):\n{out}")
    target.with_suffix(".log").write_text(out)
    os.replace(tmp, target)


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Build every named source in parallel (one nvcc each)."""
    names = list(names)
    started = {name: _start(name) for name in names}
    for name in names:
        _finish(name, started[name])
    return {name: _library_path(name) for name in names}


def build_log(name: str) -> str:
    """The compiler's output for the built ``csrc/<name>.cu``."""
    return _library_path(name).with_suffix(".log").read_text()


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built ``csrc/<name>.cu`` as a loaded library (built first if
    needed).  Every library exports ``crdt_error_string`` (csrc/common.cuh)."""
    lib = ctypes.CDLL(str(build_all([name])[name]))
    lib.crdt_error_string.argtypes = [ctypes.c_int]
    lib.crdt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        msg = lib.crdt_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} ({rc})")
