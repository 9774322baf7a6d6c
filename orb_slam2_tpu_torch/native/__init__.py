"""ctypes bindings for the native host runtime, for the port.

Port of ``orb_slam2_tpu/native/__init__.py``.  The C++ source is the
port's own copy of the JAX package's framework-free ``slamcore.cc``,
beside this file, compiled with g++ at first use into ``build/native/``
at the repository root (git-ignored).  Bound: the descriptor functions
the map store calls and the BoW inverted file of the keyframe
database; each has the pure-numpy fallback of the JAX package for hosts
without a compiler.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "slamcore.cc")
SO = os.path.join(_ROOT, "build", "native", "libslamcore.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()   # the mapping and tracking threads both load


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
    with _lock:
        return _load_locked()


def _load_locked() -> Optional[ctypes.CDLL]:
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
    c_f32p = ctypes.POINTER(ctypes.c_float)
    lib.kfdb_create.restype = ctypes.c_void_p
    lib.kfdb_destroy.argtypes = [ctypes.c_void_p]
    lib.kfdb_add.argtypes = [ctypes.c_void_p, ctypes.c_int32, c_i64p,
                             c_f32p, ctypes.c_int64]
    lib.kfdb_erase.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.kfdb_size.argtypes = [ctypes.c_void_p]
    lib.kfdb_size.restype = ctypes.c_int64
    lib.kfdb_query.argtypes = [ctypes.c_void_p, c_i64p, c_f32p,
                               ctypes.c_int64, c_i32p, ctypes.c_int64,
                               ctypes.c_int64, c_i32p, c_i32p, c_f32p,
                               ctypes.c_int64]
    lib.kfdb_query.restype = ctypes.c_int64
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


# ----------------------------------------------------------------------
# Inverted-file database
# ----------------------------------------------------------------------
class NativeKfDatabase:
    """Native BoW inverted file; falls back to Python dicts when the
    shared library is unavailable."""

    def __init__(self):
        self._lib = _load()
        if self._lib is not None:
            self._h = self._lib.kfdb_create()
        else:
            self._h = None
            self._inv = {}
            self._entries = {}

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._h:
            self._lib.kfdb_destroy(self._h)
            self._h = None

    def add(self, kid: int, bow: dict):
        words = np.fromiter(bow.keys(), np.int64, len(bow))
        weights = np.fromiter(bow.values(), np.float32, len(bow))
        if self._h is not None:
            self._lib.kfdb_add(self._h, kid, _ptr(words, ctypes.c_int64),
                               _ptr(weights, ctypes.c_float), len(words))
        else:
            self._entries[kid] = bow
            for w in bow:
                self._inv.setdefault(w, []).append(kid)

    def erase(self, kid: int):
        if self._h is not None:
            self._lib.kfdb_erase(self._h, kid)
        else:
            bow = self._entries.pop(kid, None)
            if bow:
                for w in bow:
                    lst = self._inv.get(w)
                    if lst and kid in lst:
                        lst.remove(kid)

    def __len__(self) -> int:
        if self._h is not None:
            return int(self._lib.kfdb_size(self._h))
        return len(self._entries)

    def query(self, bow: dict, exclude=(), min_common: int = 1,
              max_out: int = 4096):
        """Returns (kids, shared_counts, l1_scores) for all KFs sharing
        >= min_common words with the query, minus the excluded set."""
        words = np.fromiter(bow.keys(), np.int64, len(bow))
        weights = np.fromiter(bow.values(), np.float32, len(bow))
        if self._h is not None:
            ex = np.sort(np.asarray(list(exclude), np.int32))
            out_k = np.empty(max_out, np.int32)
            out_c = np.empty(max_out, np.int32)
            out_s = np.empty(max_out, np.float32)
            m = self._lib.kfdb_query(
                self._h, _ptr(words, ctypes.c_int64),
                _ptr(weights, ctypes.c_float), len(words),
                _ptr(ex, ctypes.c_int32), len(ex), min_common,
                _ptr(out_k, ctypes.c_int32), _ptr(out_c, ctypes.c_int32),
                _ptr(out_s, ctypes.c_float), max_out)
            return out_k[:m].copy(), out_c[:m].copy(), out_s[:m].copy()
        exclude = set(exclude)
        counts, scores = {}, {}
        for w, a in bow.items():
            for kid in self._inv.get(w, ()):
                if kid in exclude:
                    continue
                counts[kid] = counts.get(kid, 0) + 1
                b = self._entries[kid].get(w, 0.0)
                scores[kid] = scores.get(kid, 0.0) + abs(a) + abs(b) - abs(a - b)
        kids = [k for k, c in counts.items() if c >= min_common]
        return (np.asarray(kids, np.int32),
                np.asarray([counts[k] for k in kids], np.int32),
                np.asarray([0.5 * scores[k] for k in kids], np.float32))
