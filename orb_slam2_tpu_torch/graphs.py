"""CUDA graphs for the compiled programs: the port's counterpart of the
JAX package's ``jax.jit``.

The JAX package runs each frame and each mapped keyframe as a few
compiled programs, each dispatched once (``ops/extractor.make_extractor``,
``FrameFactory._pipeline``, ``_track_prior_step`` and
``_track_prior_chain`` in ``pipeline/tracking.py``; the triangulation,
fuse and structure-BA chunks of ``pipeline/local_mapping.py`` and the
vocabulary descent; loop closing's searches, Sim3 RANSAC and the LM
iterations of its solvers, ``pipeline/loop_closing.py``).  Run eagerly, the same work is thousands of small
launches a frame or keyframe, and the host thread that issues them is
the bottleneck.  :func:`graphed` captures a function once per static
signature as a CUDA graph and replays it:

- the key is what ``jax.jit`` retraces on: every argument that is not a
  tensor, by value (the JAX package's ``static_argnames``), each
  tensor's shape and dtype, and the device;
- the first call for a key warms the function up with ``WARMUP`` eager
  calls on a side stream (lazy caches, the kernel library), then
  captures one call with ``capture_error_mode="thread_local"`` (the
  tracker and the asynchronous mapper each launch and capture from
  their own thread while the other captures) and keeps the captured
  call's input tensors as the graph's static inputs;
- every call copies its tensors into those static inputs, replays the
  graph, and returns fresh clones of the graph's outputs (aliasing
  between outputs kept).  A frame keeps its extraction arrays for the
  map's lifetime and the tracking chain feeds one step's outputs into
  the next, so the graph's own output buffers, which the next replay
  overwrites, are never handed out;
- at most ``MAXSIZE`` captures are kept per function, least recently
  used first out (the JAX package's ``lru_cache(maxsize=8)``).

On the CPU ``graphed`` calls the function: the caller asked for the CPU.
On the card a capture or replay that fails raises; nothing falls back
to the eager call.  A captured function must not synchronize with the
host (no ``.item()``, no boolean-mask indexing, no pageable host copy)
and must not read tensors that it creates from host data on each call:
such work is not replayed.

Launch counts (``kernels.LAUNCHES``, ``kernels.SHAPES``) count a replay
as the launches its capture recorded; the warm-up calls are not
counted.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from . import kernels

# eager calls on a side stream before a capture: one makes what the
# capture must find made (the cuBLAS handle and workspace of the
# matmuls, the caching allocator's blocks for the program's shapes, the
# constant tables cached per device), and loop closing's programs, which
# run once per signature, pay each warm-up call in full
WARMUP = 1
MAXSIZE = 8     # captures kept per function

# per function name: {"captures": n, "replays": n, "warmup_ms": t,
# "capture_ms": t}, the last two the host time of the captures' eager
# warm-up calls and of their capture and instantiation, summed
STATS = {}
_stats_lock = threading.Lock()


def reset_stats() -> None:
    with _stats_lock:
        STATS.clear()


def _count(name: str, what: str, n=1) -> None:
    with _stats_lock:
        s = STATS.setdefault(name, dict(captures=0, replays=0,
                                        warmup_ms=0.0, capture_ms=0.0))
        s[what] += n


def upload(a, device, dtype=None) -> torch.Tensor:
    """Host array -> tensor on ``device``.  On a CUDA device the array
    goes through pinned host memory and a non-blocking copy: a copy from
    pageable memory waits for the stream, every launch queued before it
    (the mapping thread's included).  PyTorch's pinned allocator keeps
    the staging block until the copy has run.  Elsewhere this is
    ``torch.as_tensor``."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    t = torch.as_tensor(np.asarray(a), dtype=dtype)
    return t.pin_memory().to(device, non_blocking=True)


class Readback:
    """Device outputs on their way to the host.  On the card they are
    queued as non-blocking copies into pinned host memory right after
    the launches that make them, followed by an event: a read waits on
    that event (not on the whole stream, which the other thread shares),
    and the copies overlap what the host does meanwhile.  A non-blocking
    copy into pageable memory would be synchronous and undo the overlap;
    the pinned tensors live here until they are read.  CPU tensors are
    read as they are."""

    def __init__(self, tensors):
        self.event = None
        self._arrays = None
        if tensors[0].is_cuda:
            self._host = tuple(
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                .copy_(t, non_blocking=True) for t in tensors)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self._host = tuple(tensors)

    def wait(self):
        if self.event is not None:
            self.event.synchronize()

    def arrays(self):
        """The outputs as numpy arrays (waits for the copies once)."""
        if self._arrays is None:
            self.wait()
            self._arrays = tuple(t.numpy() for t in self._host)
        return self._arrays


def _flatten(out, leaves: list):
    """The tensors of a tree of (named) tuples, in order, into
    ``leaves``; returns the function that rebuilds the tree from an
    iterator of tensors."""
    if isinstance(out, torch.Tensor):
        leaves.append(out)
        return lambda it: next(it)
    if isinstance(out, tuple):
        parts = [_flatten(o, leaves) for o in out]
        if hasattr(out, "_fields"):      # a NamedTuple
            return lambda it: type(out)(*[p(it) for p in parts])
        return lambda it: tuple(p(it) for p in parts)
    raise TypeError(f"graphed: an output must be a tensor or a tuple of "
                    f"them, got {type(out).__name__}")


class _Capture:
    """One captured call: the graph, its static inputs and outputs, and
    the kernel launches the capture recorded."""

    def __init__(self, fn, args, device, name):
        self.static = [a.clone() if isinstance(a, torch.Tensor) else a
                       for a in args]
        # warm-up and capture on a stream of this capture's own: a
        # capture that fails leaves that stream, and no other, unusable
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        t0 = time.perf_counter()
        with kernels.recording(), torch.cuda.stream(side):
            for _ in range(WARMUP):
                fn(*self.static)
        cur.wait_stream(side)
        t1 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        # capture_begin / capture_end, not the torch.cuda.graph context:
        # that also synchronizes the device and empties the device and
        # pinned-host caching allocators at every capture, so the next
        # allocations and pinned uploads of both threads would pay
        # cudaMalloc / cudaHostAlloc again
        with kernels.recording() as rec, torch.cuda.stream(side):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn(*self.static)
            finally:
                self.graph.capture_end()
        self.launches = dict(rec)
        self.outputs = []
        self.rebuild = _flatten(out, self.outputs)
        _count(name, "captures")
        _count(name, "warmup_ms", (t1 - t0) * 1e3)
        _count(name, "capture_ms", (time.perf_counter() - t1) * 1e3)

    def run(self, args):
        for s, a in zip(self.static, args):
            if isinstance(s, torch.Tensor):
                s.copy_(a)
        self.graph.replay()
        kernels.add_launches(self.launches)
        fresh = {}
        clones = [fresh.setdefault(id(t), t.clone()) for t in self.outputs]
        return self.rebuild(iter(clones))


class Graphed:
    """``fn`` replayed from CUDA graphs keyed by its static signature
    (see the module docstring).  Arguments are positional."""

    def __init__(self, fn, name: str):
        self.fn = fn
        self.name = name
        self._captures = collections.OrderedDict()
        self._lock = threading.Lock()

    def __call__(self, *args):
        devices = {a.device for a in args if isinstance(a, torch.Tensor)}
        if len(devices) != 1:
            raise ValueError(f"{self.name}: the tensor arguments must lie "
                             f"on one device, got {sorted(map(str, devices))}")
        device = devices.pop()
        if device.type != "cuda":
            return self.fn(*args)
        key = (device, *((tuple(a.shape), a.dtype) if isinstance(
            a, torch.Tensor) else a for a in args))
        with self._lock, torch.cuda.device(device):
            cap = self._captures.get(key)
            if cap is None:
                cap = _Capture(self.fn, args, device, self.name)
                self._captures[key] = cap
                if len(self._captures) > MAXSIZE:
                    self._captures.popitem(last=False)
            else:
                self._captures.move_to_end(key)
            out = cap.run(args)
        _count(self.name, "replays")
        return out

    def n_captures(self) -> int:
        return len(self._captures)


def graphed(fn, name: str) -> Graphed:
    """``fn`` as replays of CUDA graphs keyed by its static arguments
    (every non-tensor argument, by value), its tensors' shapes and
    dtypes, and the device; ``name`` keys its :data:`STATS`.  On the
    CPU, ``fn`` itself."""
    return Graphed(fn, name)
