"""Build, load and count the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with one ``nvcc`` call into a shared library with a
plain C interface, bound with ``ctypes``: no PyTorch headers, so the
build takes seconds.  The library is built at first use into
``build/cuda/`` at the repository root (git-ignored) and rebuilt when a
source is newer than it.  Nothing is compiled or loaded at import time.

Each kernel wrapper (``ops.fast.score_map``,
``matching.hamming_top2.masked_top2_mutual`` / ``masked_top2_epi``)
calls :func:`call`, which launches on PyTorch's current stream, raises
if the launch failed, and adds one to the kernel's entry in
:data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cuda")
LIB_PATH = os.path.join(BUILD_DIR, "liborb_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C entry point per kernel: argument ctypes after the leading pointers
_SIGNATURES = {
    "fast_score": ("orb_fast_score",
                   [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p]),
    "masked_top2_mutual": ("orb_masked_top2_mutual",
                           [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                           + [ctypes.c_void_p] * 4),
    "masked_top2_epi": ("orb_masked_top2_epi",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                        + [ctypes.c_void_p] * 4),
}

# launches per kernel since the last reset_launch_counts()
LAUNCHES = {name: 0 for name in _SIGNATURES}

_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(force: bool = False) -> dict:
    """Compile ``csrc/*.cu`` into ``LIB_PATH`` unless it is newer than
    every source.  Returns {"seconds", "ptxas", "built"}."""
    sources = sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))
    newest = max(os.path.getmtime(s) for s in sources)
    if (not force and os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= newest):
        return dict(seconds=0.0, ptxas="", built=False)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return dict(seconds=time.perf_counter() - t0,
                ptxas=(proc.stdout + proc.stderr).strip(), built=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIB_PATH)
        for cname, argtypes in _SIGNATURES.values():
            fn = getattr(lib, cname)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def call(name: str, *args) -> None:
    """Launch kernel ``name`` on the current CUDA stream.  Tensor
    arguments pass as device pointers, ints as C ints.  Raises
    RuntimeError when the launch is refused."""
    cname, _ = _SIGNATURES[name]
    fn = getattr(library(), cname)
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*cargs, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[name] += 1
