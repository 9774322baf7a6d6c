"""Build, load and count the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles in its own ``nvcc`` process, all started together,
and one more links the objects into a shared library with a plain C
interface, bound with ``ctypes``: no PyTorch headers, so the build takes
seconds.  The library is built at first use into
``build/cuda/`` at the repository root (git-ignored) and rebuilt when a
source is newer than it.  Nothing is compiled or loaded at import time.

Each kernel wrapper (``ops.fast.fast_score_levels``,
``matching.hamming_top2.masked_top2_mutual`` / ``masked_top2_epi`` /
``hamming_top2``) calls :func:`call`, which launches on PyTorch's
current stream, raises if the launch failed, and adds one to the
kernel's entry in :data:`LAUNCHES` (and, for a search, to its
(rows, columns) entry in :data:`SHAPES`).  The tracking thread and the
mapping thread both launch, so the lazy build and the counts are
guarded by one lock.  Inside :func:`recording` a thread's launches go
to a record of their own instead: ``graphs.py`` records what a CUDA
graph's capture launched and adds it again (:func:`add_launches`) at
every replay, which launches no wrapper.
"""
from __future__ import annotations

import contextlib
import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cuda")
LIB_PATH = os.path.join(BUILD_DIR, "liborb_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C entry point per kernel: argument ctypes after the leading pointers
_SIGNATURES = {
    "fast_score": ("orb_fast_score_levels",
                   [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]),
    "masked_top2_mutual": ("orb_masked_top2_mutual",
                           [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                           + [ctypes.c_void_p] * 5),
    "masked_top2_epi": ("orb_masked_top2_epi",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                        + [ctypes.c_void_p] * 5),
    "hamming_top2": ("orb_hamming_top2",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p] * 6),
}

# C entry points that launch nothing: argument ctypes
_HELPERS = {
    "orb_masked_top2_splits": [ctypes.c_int] * 3,
}

# launches per kernel since the last reset_launch_counts()
LAUNCHES = {name: 0 for name in _SIGNATURES}
# launches per (kernel, rows, columns) of the searches since then
SHAPES = {}

_lib = None
_lock = threading.Lock()
# this thread's open record (see recording()), if any
_local = threading.local()


def reset_launch_counts() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        SHAPES.clear()


@contextlib.contextmanager
def recording():
    """Count this thread's launches into a fresh dict (kernel name ->
    launches, (kernel, rows, columns) -> search launches) instead of
    LAUNCHES and SHAPES, until the block ends."""
    outer = getattr(_local, "record", None)
    _local.record = record = {}
    try:
        yield record
    finally:
        _local.record = outer


def add_launches(record: dict) -> None:
    """Add a record of :func:`recording` to LAUNCHES and SHAPES (or to
    this thread's open record)."""
    with _lock:
        _add(record)


def _add(record: dict) -> None:
    into = getattr(_local, "record", None)
    for key, n in record.items():
        if into is not None:
            into[key] = into.get(key, 0) + n
        elif isinstance(key, str):
            LAUNCHES[key] += n
        else:
            SHAPES[key] = SHAPES.get(key, 0) + n


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
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sources:
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    report = [proc.communicate()[0] for proc in procs]
    for src, proc, out in zip(sources, procs, report):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {os.path.basename(src)} "
                               f"({proc.returncode}):\n{out}")
    tmp = f"{LIB_PATH}.{tag}"
    proc = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs],
                          capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return dict(seconds=time.perf_counter() - t0,
                ptxas="\n".join(report).strip(), built=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIB_PATH)
            for cname, argtypes in (*_SIGNATURES.values(),
                                    *_HELPERS.items()):
                fn = getattr(lib, cname)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def call(name: str, *args, shape=None) -> None:
    """Launch kernel ``name`` on the current CUDA stream.  Tensor
    arguments pass as device pointers, ints as C ints, ctypes arrays as
    host pointers.  Raises RuntimeError when the launch is refused.
    ``shape`` (a search's (rows, columns)) is counted in SHAPES."""
    cname, _ = _SIGNATURES[name]
    fn = getattr(library(), cname)
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*cargs, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    with _lock:
        _add({name: 1} if shape is None else {name: 1, (name, *shape): 1})


def masked_top2_splits(device: int, n: int, m: int) -> int:
    """The column split count K2 and K3 launch with for an (n, m) search
    on CUDA device ``device``: the grid policy lives beside the kernel
    (``csrc/masked_top2.cu``), which sizes it by the card's SM count.
    The wrapper allocates scratch for that many splits."""
    s = library().orb_masked_top2_splits(device, n, m)
    if s < 1:
        raise RuntimeError(f"orb_masked_top2_splits({n}, {m}) failed: "
                           f"cudaError {-s}")
    return s
