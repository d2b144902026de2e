"""Native (C++) host-runtime bindings.

The counterpart of the JAX package's ``native/``.  ``codec.cpp``
implements the element-dictionary interning and the delta wire codec
behind a plain C ABI; this module builds it with g++ on first use into
the package's git-ignored ``build/`` (keyed by a hash of the source, the
compiler and the flags; a temporary file renamed into place, so
concurrent processes never load a half-written library) and binds it via
ctypes.  Without a toolchain ``available()`` is False and callers use the
pure-Python paths (utils/codec.py, utils/wire.py): the same observable
behavior and the same bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Iterable, List, Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "codec.cpp")
_BUILD = os.path.join(os.path.dirname(_HERE), "build")
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_LIB = None
_LIB_ERR: Optional[str] = None


def _lib_path() -> str:
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(_BUILD, f"_codec-{digest.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, u8p, u32p, i64p = (ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                            ctypes.POINTER(ctypes.c_uint32),
                            ctypes.POINTER(ctypes.c_int64))
    void_p, char_p = ctypes.c_void_p, ctypes.c_char_p
    sigs = {
        "ed_new": ([i64], void_p),
        "ed_free": ([void_p], None),
        "ed_len": ([void_p], i64),
        "ed_capacity": ([void_p], i64),
        "ed_set_capacity": ([void_p, i64], None),
        "ed_lookup": ([void_p, char_p, i64], i64),
        "ed_encode_batch": ([void_p, char_p, i64p, i64, i64p], i64),
        "ed_decode_size": ([void_p, i64p, i64], i64),
        "ed_decode_batch": ([void_p, i64p, i64, char_p, i64, i64p], i64),
        "delta_encode_bound": ([i64], i64),
        "delta_encode": ([u8p, u32p, u32p, i64, u8p, i64], i64),
        "delta_decode": ([u8p, i64, i64, u8p, u32p, u32p], i64),
        "vv_encode_bound": ([i64], i64),
        "vv_encode": ([u32p, i64, u8p, i64], i64),
        "vv_decode": ([u8p, i64, i64, u32p], i64),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the native library; None on failure."""
    global _LIB, _LIB_ERR
    with _LOCK:
        if _LIB is not None or _LIB_ERR is not None:
            return _LIB
        try:
            path = _lib_path()  # reads codec.cpp (may be absent/stripped)
            if not os.path.exists(path):
                _build(path)
            _LIB = _bind(ctypes.CDLL(path))
        except (OSError, subprocess.CalledProcessError,
                AttributeError) as e:
            _LIB_ERR = str(e)
        return _LIB


def available() -> bool:
    return load() is not None


def build_error() -> Optional[str]:
    load()
    return _LIB_ERR


def _flat_utf8(values: Sequence[str]):
    """Concatenated utf-8 buffer + int64 offsets[n+1] for a string batch."""
    encoded = [v.encode("utf-8") for v in values]
    offsets = np.zeros(len(encoded) + 1, np.int64)
    np.cumsum([len(b) for b in encoded], out=offsets[1:])
    return b"".join(encoded), offsets


class NativeElementDict:
    """Drop-in for utils/codec.ElementDict backed by the C++ interner.

    Same API and the same observable behavior (first-sight id
    assignment, OverflowError at capacity, state_dict roundtrip); the
    batch paths accept flat utf-8 buffers, which is where the native
    implementation earns its keep (wire/disk ingestion).
    """

    def __init__(self, capacity: int = 16,
                 values: Optional[Iterable[str]] = None):
        lib = load()
        if lib is None:
            raise RuntimeError(
                f"native codec unavailable: {build_error()}")
        self._lib = lib
        self._h = lib.ed_new(capacity)
        if values:
            self.encode_many(list(values))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ed_free(h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.ed_len(self._h))

    @property
    def capacity(self) -> int:
        return int(self._lib.ed_capacity(self._h))

    def __contains__(self, value: str) -> bool:
        raw = value.encode("utf-8")
        return int(self._lib.ed_lookup(self._h, raw, len(raw))) >= 0

    def encode(self, value: str) -> int:
        return int(self.encode_many([value])[0])

    def encode_many(self, values: Sequence[str]) -> List[int]:
        buf, offsets = _flat_utf8(values)
        ids = self.encode_flat(buf, offsets)
        if ids is None:
            raise OverflowError(
                f"element dictionary full (capacity {self.capacity}); "
                "grow() and re-pack")
        return [int(i) for i in ids]

    def encode_flat(self, buf: bytes,
                    offsets: np.ndarray) -> Optional[np.ndarray]:
        """Batch-encode a flat utf-8 buffer; returns ids or None on
        capacity overflow."""
        n = len(offsets) - 1
        out = np.empty(n, np.int64)
        rc = self._lib.ed_encode_batch(
            self._h, buf,
            np.ascontiguousarray(offsets).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int64)),
            n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if rc < 0:
            return None
        return out

    def decode(self, eid: int) -> str:
        return self.decode_many([eid])[0]

    def decode_many(self, ids: Sequence[int]) -> List[str]:
        arr = np.ascontiguousarray(ids, dtype=np.int64)
        idp = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        size = self._lib.ed_decode_size(self._h, idp, len(arr))
        if size < 0:
            raise IndexError("unknown element id in batch")
        out = ctypes.create_string_buffer(max(int(size), 1))
        offsets = np.empty(len(arr) + 1, np.int64)
        rc = self._lib.ed_decode_batch(
            self._h, idp, len(arr), out, size,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if rc < 0:
            raise IndexError("unknown element id in batch")
        raw = out.raw[:size]
        return [raw[offsets[i]:offsets[i + 1]].decode("utf-8")
                for i in range(len(arr))]

    def grow(self, factor: int = 2) -> None:
        self._lib.ed_set_capacity(self._h, self.capacity * factor)

    def state_dict(self) -> dict:
        return {"capacity": self.capacity,
                "values": self.decode_many(list(range(len(self))))}

    @classmethod
    def from_state_dict(cls, d: dict) -> "NativeElementDict":
        return cls(capacity=d["capacity"], values=d["values"])


def make_element_dict(capacity: int = 16,
                      values: Optional[Iterable[str]] = None,
                      prefer_native: bool = True):
    """Factory: native interner when the toolchain allows, else the
    pure-Python ElementDict — identical observable behavior."""
    if prefer_native and available():
        return NativeElementDict(capacity=capacity, values=values)
    from go_crdt_playground_tpu_torch.utils.codec import ElementDict

    return ElementDict(capacity=capacity, values=values)
