"""ctypes bindings for the native host runtime, for the port.

The C++ source is the JAX package's ``orb_slam2_tpu/native/slamcore.cc``
(framework-free), compiled by path with g++ at first use into
``build/native/`` at the repository root (git-ignored) — importing
``orb_slam2_tpu.native`` would pull in jax.  Only the descriptor
functions the map store calls are bound; each has the pure-numpy
fallback of the JAX package for hosts without a compiler.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
SRC = os.path.join(_ROOT, "orb_slam2_tpu", "native", "slamcore.cc")
SO = os.path.join(_ROOT, "build", "native", "libslamcore.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _try_build() -> bool:
    os.makedirs(os.path.dirname(SO), exist_ok=True)
    tmp = f"{SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
             "-fPIC", SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, SO)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(SO) or os.path.getmtime(SO) < os.path.getmtime(SRC):
        if not _try_build() and not os.path.exists(SO):
            return None
    try:
        lib = ctypes.CDLL(SO)
    except OSError:
        return None
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    c_u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.hamming_matrix_u32.argtypes = [c_u32p, ctypes.c_int64, c_u32p,
                                       ctypes.c_int64, c_i32p]
    lib.hamming_matrix_u32.restype = None
    lib.hamming_min_median_index.argtypes = [c_u32p, ctypes.c_int64]
    lib.hamming_min_median_index.restype = ctypes.c_int32
    lib.hamming_min_median_batch.argtypes = [c_u32p, c_i64p,
                                             ctypes.c_int64, c_i32p]
    lib.hamming_min_median_batch.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def hamming_matrix(d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
    """(A, 8) x (B, 8) uint32 -> (A, B) int32 popcount distances."""
    d1 = np.ascontiguousarray(d1, np.uint32)
    d2 = np.ascontiguousarray(d2, np.uint32)
    lib = _load()
    if lib is None:
        x = np.bitwise_xor(d1[:, None, :], d2[None, :, :])
        return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).astype(np.int32)
    out = np.empty((len(d1), len(d2)), np.int32)
    lib.hamming_matrix_u32(_ptr(d1, ctypes.c_uint32), len(d1),
                           _ptr(d2, ctypes.c_uint32), len(d2),
                           _ptr(out, ctypes.c_int32))
    return out


def min_median_descriptor_index(descs: np.ndarray) -> int:
    """MapPoint::ComputeDistinctiveDescriptors selection."""
    descs = np.ascontiguousarray(descs, np.uint32)
    lib = _load()
    if lib is None:
        d = hamming_matrix(descs, descs)
        return int(np.argmin(np.median(d, axis=1)))
    return int(lib.hamming_min_median_index(
        _ptr(descs, ctypes.c_uint32), len(descs)))


def min_median_descriptor_batch(descs_flat: np.ndarray,
                                offsets: np.ndarray) -> np.ndarray:
    """Medoid descriptor index per group (CSR layout)."""
    descs_flat = np.ascontiguousarray(descs_flat, np.uint32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    n = len(offsets) - 1
    lib = _load()
    out = np.empty(n, np.int32)
    if lib is None:
        for g in range(n):
            a, b = offsets[g], offsets[g + 1]
            if b - a <= 0:
                out[g] = -1
            elif b - a == 1:
                out[g] = 0
            else:
                d = hamming_matrix(descs_flat[a:b], descs_flat[a:b])
                out[g] = int(np.argmin(np.median(d, axis=1)))
        return out
    lib.hamming_min_median_batch(
        _ptr(descs_flat, ctypes.c_uint32), _ptr(offsets, ctypes.c_int64),
        n, _ptr(out, ctypes.c_int32))
    return out
