"""Native host-runtime library: build-on-first-use C++ ops with ctypes.

The compute path is JAX/XLA/Pallas on device; this module accelerates the
host-side ingest pipeline (batch FNV-1a hashing, HNSW level assignment,
sign-bit packing, packed-Hamming scans). The shared library compiles lazily
with the system g++ for a portable target of the host's architecture (no
``-march=native``: a checkout copied to another machine must not carry
instructions its CPU lacks) and caches next to the source under a name keyed
by that architecture; every op has a pure-Python fallback so the package
works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import platform
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "vettore_native.cpp")
_LIB = os.path.join(os.path.dirname(__file__),
                    f"_vettore_native.{platform.machine() or 'unknown'}.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", _LIB, _SRC],
                    check=True, capture_output=True, timeout=120,
                )
            lib = ctypes.CDLL(_LIB)
            lib.fnv1a64_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.levels_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
            ]
            lib.pack_signs_u64.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.hamming_scan.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p,
            ]
            _lib = lib
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def fnv1a64_batch(ids) -> np.ndarray:
    """FNV-1a hashes for a list of strings; None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    encoded = [s.encode("utf-8") for s in ids]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in encoded], out=offsets[1:])
    data = np.frombuffer(b"".join(encoded) or b"\x00", dtype=np.uint8)
    out = np.zeros(len(encoded), dtype=np.uint64)
    lib.fnv1a64_batch(
        data.ctypes.data, offsets.ctypes.data, len(encoded), out.ctypes.data
    )
    return out


def levels_batch(ids, max_level: int) -> np.ndarray:
    """Deterministic HNSW levels for a batch of external ids; None when the
    native library is unavailable (callers fall back to the Python loop)."""
    hashes = fnv1a64_batch(ids)
    if hashes is None:
        return None
    lib = _load()
    out = np.zeros(len(ids), dtype=np.int32)
    lib.levels_batch(hashes.ctypes.data, len(ids), max_level, out.ctypes.data)
    return out


def pack_signs_u64(matrix: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        return None
    m = np.ascontiguousarray(matrix, dtype=np.float32)
    rows, dims = m.shape
    words = (dims + 63) // 64
    out = np.zeros((rows, words), dtype=np.uint64)
    lib.pack_signs_u64(m.ctypes.data, rows, dims, out.ctypes.data)
    return out


def hamming_scan(rows: np.ndarray, query: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        return None
    r = np.ascontiguousarray(rows, dtype=np.uint64)
    q = np.ascontiguousarray(query, dtype=np.uint64)
    out = np.zeros(r.shape[0], dtype=np.float32)
    lib.hamming_scan(r.ctypes.data, q.ctypes.data, r.shape[0], r.shape[1], out.ctypes.data)
    return out
