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
  used first out (the JAX package's ``lru_cache(maxsize=8)``);
- the captures of one function on one card share one private memory
  pool and one capture stream, so a capture reuses what the earlier
  ones freed (their intermediates, an evicted capture's outputs): a
  function's graphs hold about its largest capture, not the sum of
  its captures.  Sharing is safe because a replay's outputs are cloned
  right after it on the caller's stream, under the function's lock,
  before another replay of the function can overwrite them.

On the CPU ``graphed`` calls the function: the caller asked for the CPU.
On the card a capture or replay that fails raises; nothing falls back
to the eager call.  A captured function must not synchronize with the
host (no ``.item()``, no boolean-mask indexing, no pageable host copy)
and must not read tensors that it creates from host data on each call:
such work is not replayed.

Launch counts (``kernels.LAUNCHES``, ``kernels.SHAPES``) count a replay
as the launches its capture recorded; the warm-up calls are not
counted.

The sharded solvers are ``jax.jit(shard_map(...))`` in the JAX package:
one program per shard, its collectives inside.  Here each shard's
solver is a phased program (steps and :class:`Collective` items)
replayed as a :class:`Chain` of graphs whose steps read and write the
chain's own buffers in place, so a replay copies nothing in or out.
Where the collective's hook can be captured (a NCCL process group:
``capturable``), the sums are steps inside the graphs, as in the JAX
package's program; elsewhere (gloo, whose sums go through host memory,
and a local mesh, whose shards take turns on threads) the chain is cut
at each collective, which runs eagerly between two replays.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import NamedTuple

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
        s[what] = s.get(what, 0) + n


def pad_bucket(n: int, minimum: int = 256) -> int:
    """Round up to a power-of-4 bucket: every size that rounds up to one
    bucket shares a capture."""
    m = minimum
    while m < n:
        m *= 4
    return m


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
        self.events = ()
        self._arrays = None
        if tensors[0].is_cuda:
            self._host = tuple(
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                .copy_(t, non_blocking=True) for t in tensors)
            # each copy runs on the current stream of its tensor's card,
            # which need not be this thread's current card: an event
            # recorded on the current card's stream would not cover it
            for dev in dict.fromkeys(t.device for t in tensors):
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
                self.events += (event,)
        else:
            self._host = tuple(tensors)

    def wait(self):
        for event in self.events:
            event.synchronize()

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
    the kernel launches the capture recorded.  ``side`` is the stream
    the warm-up and the capture run on and ``pool`` the private memory
    pool the capture allocates from (its function's, shared by its
    captures on the card: the caching allocator reuses a pool's free
    blocks only on the stream that freed them)."""

    def __init__(self, fn, args, device, name, side, pool):
        self.static = [a.clone() if isinstance(a, torch.Tensor) else a
                       for a in args]
        cur = torch.cuda.current_stream(device)
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
            self.graph.capture_begin(pool=pool,
                                     capture_error_mode="thread_local")
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
        # per card: the capture stream and the memory pool every capture
        # of fn shares (see the module docstring)
        self._side = {}
        self._pools = {}

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
                side = self._side.get(device)
                if side is None:
                    side = self._side[device] = torch.cuda.Stream(device)
                    self._pools[device] = torch.cuda.graph_pool_handle()
                try:
                    cap = _Capture(self.fn, args, device, self.name, side,
                                   self._pools[device])
                except BaseException:
                    # a failed capture leaves its stream unusable
                    del self._side[device], self._pools[device]
                    raise
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


# ----------------------------------------------------------------------
# Phased programs: a sharded solver as steps cut at its collectives
# ----------------------------------------------------------------------

class Collective(NamedTuple):
    """A sum over the shards inside a phased program: the hook named
    ``kind`` ("cam", "pt", ...) replaces the state entries ``names`` by
    their sums.  A hook takes and returns a tuple of tensors; ``None``
    is the identity (a shard that holds the whole sum)."""
    kind: str
    names: tuple


def capturable(hook, key):
    """``hook`` declared capturable: its sums launch on the current
    stream and wait for nothing on the host, so a :class:`Chain` runs
    them as steps inside its captures.  ``key`` names what a capture
    holds of the hook (the process group): chains are keyed on it."""
    def sums(x):
        return hook(x)
    sums.capture_key = key
    return sums


def capture_key(hook):
    """The key of a hook declared :func:`capturable`, else ``None``."""
    return getattr(hook, "capture_key", None)


class _Sum:
    """A collective as a step of a captured segment: the sums of its
    entries, which the segment writes back over them.  Steps compare by
    the collective alone, so every solve of a chain finds its segments
    (the chain is keyed on the hook's :func:`capture_key`)."""

    def __init__(self, item: Collective, hook):
        self.item, self.hook = item, hook
        self.__name__ = f"{item.kind}({','.join(item.names)})"

    def __eq__(self, other):
        return isinstance(other, _Sum) and self.item == other.item

    def __hash__(self):
        return hash(self.item)

    def __call__(self, st, cfg):
        return dict(zip(self.item.names,
                        self.hook(tuple(st[n] for n in self.item.names))))


def _dense(out: dict) -> dict:
    """State entries in one memory layout, contiguous: a reduction's
    order, and so its rounding, can follow its operand's strides, and a
    chain's buffers are contiguous, so every form hands every step the
    same layout."""
    return {k: v.contiguous() for k, v in out.items()}


def run_eager(program, st: dict, cfg, hooks: dict) -> dict:
    """Run a phased program eagerly: ``program`` yields steps ``fn(st,
    cfg) -> {name: tensor}``, each of whose results updates ``st``, and
    :class:`Collective` items; returns ``st``.  The single-device graphs
    run their programs so, inside one capture each, with identity
    hooks."""
    st.update(_dense(st))
    for item in program:
        if isinstance(item, Collective):
            hook = hooks[item.kind]
            if hook is not None:
                st.update(_dense(dict(zip(
                    item.names, hook(tuple(st[n] for n in item.names))))))
        else:
            st.update(_dense(item(st, cfg)))
    return st


def _apply(steps, bufs: dict, cfg) -> dict:
    """The entries that ``steps`` write, run on a view of ``bufs``."""
    st, out = dict(bufs), {}
    for fn in steps:
        new = _dense(fn(st, cfg))
        st.update(new)
        out.update(new)
    return out


def _commit(bufs: dict, out: dict) -> None:
    """Write a segment's results into the chain's buffers in place.  An
    output that is another entry's buffer is copied first, so no write
    lands before a read of it; an entry seen for the first time gets a
    buffer of its own (a step may return one tensor under two names)."""
    held = {id(b) for b in bufs.values()}
    out = {k: v.clone() if id(v) in held and bufs.get(k) is not v else v
           for k, v in out.items()}
    for k, v in out.items():
        if k not in bufs:
            bufs[k] = v.clone()
        elif bufs[k] is not v:
            bufs[k].copy_(v)


class _Segment:
    """The steps between two collectives of a :class:`Chain`, captured
    once as a CUDA graph that reads the chain's buffers and writes its
    results into them in place."""

    def __init__(self, chain: "Chain", steps: tuple, cfg):
        names = [fn.__name__.lstrip("_") for fn in steps]
        if len(names) > 8:          # a captured LM iteration
            names = [names[0], f"{len(names) - 2} steps", names[-1]]
        self.name = chain.name + ":" + "+".join(names)
        cur = torch.cuda.current_stream(chain.device)
        side = torch.cuda.Stream(chain.device)
        side.wait_stream(cur)
        t0 = time.perf_counter()
        # the warm-up's results are dropped; only their shapes are kept,
        # as the buffers of the entries this segment writes first
        with kernels.recording(), torch.cuda.stream(side):
            for _ in range(WARMUP):
                out = _apply(steps, chain.bufs, cfg)
        cur.wait_stream(side)
        for k, v in out.items():
            if k not in chain.bufs:
                chain.bufs[k] = torch.empty(v.shape, dtype=v.dtype,
                                            device=v.device)
        del out
        t1 = time.perf_counter()
        if chain.pool is None:
            chain.pool = torch.cuda.graph_pool_handle()
        self.graph = torch.cuda.CUDAGraph()
        with kernels.recording() as rec, torch.cuda.stream(side):
            self.graph.capture_begin(pool=chain.pool,
                                     capture_error_mode="thread_local")
            try:
                _commit(chain.bufs, _apply(steps, chain.bufs, cfg))
            finally:
                self.graph.capture_end()
        self.launches = dict(rec)
        _count(self.name, "captures")
        _count(self.name, "warmup_ms", (t1 - t0) * 1e3)
        _count(self.name, "capture_ms", (time.perf_counter() - t1) * 1e3)

    def replay(self) -> None:
        self.graph.replay()
        kernels.add_launches(self.launches)
        _count(self.name, "replays")


class Chain:
    """One shard's phased program (see :func:`run_eager`) as a chain of
    CUDA graphs: the port's counterpart of ``jax.jit(shard_map(...))``.

    The chain owns its state as named buffers (``bufs``).  Its program
    runs as segments of steps, each captured the first time it appears
    (after ``WARMUP`` eager calls on a side stream) and replayed
    whenever the same steps appear again.  A segment reads the buffers
    and writes its results into them in place, so no replay copies an
    input in or an output out.  A run takes one of two forms:

    - captured, where every hook of the run is :func:`capturable` (a
      NCCL process group): each collective is a step of its segment,
      whose sums the segment writes back over the entries, inside the
      capture.  Segments end only before the steps ``cut_before``
      names (a solver's LM iteration and its finish): a solver replays
      one graph an LM iteration.  A capture that fails raises;
    - cut, for every other hook (gloo, a local mesh): a segment ends at
      each collective, which sums its buffers eagerly between two
      replays and copies the sums back into them; the solver's PCG
      steps replay one segment.

    The collectives of an identity hook are no step and no cut.  A warm
    run launches only replays (and, cut, the collectives' sums and
    their copies) and waits for nothing.  The segments of one chain
    share one memory pool and replay in one order on one stream.
    :data:`STATS` counts the runs of each form under the chain's name
    ("captured", "cut") and the segments they ran ("segments").

    Every shard has chains of its own: two shards on one card with
    equal shapes must not share buffers.  On the CPU the segments run
    eagerly on the same buffers, in place, in the form's order."""

    def __init__(self, name: str, device):
        self.name = name
        self.device = torch.device(device)
        self.bufs = {}
        self.pool = None
        self._segments = {}

    def load(self, **arrays) -> None:
        """Host arrays into the buffers of their names (on the card
        through pinned memory, without a wait)."""
        for k, a in arrays.items():
            host = torch.from_numpy(np.array(a))      # a copy of its own
            if self.device.type != "cuda":
                self.bufs[k] = host
                continue
            buf = self.bufs.get(k)
            if buf is None:
                buf = self.bufs[k] = torch.empty(
                    host.shape, dtype=host.dtype, device=self.device)
            buf.copy_(host.pin_memory(), non_blocking=True)

    def run(self, program, cfg, hooks: dict, cut_before=()) -> dict:
        """Run ``program`` on the buffers; returns them."""
        live = [h for h in hooks.values() if h is not None]
        captured = bool(live) and all(capture_key(h) is not None
                                      for h in live)
        _count(self.name, "captured" if captured else "cut")
        steps = []
        for item in program:
            if captured and item in cut_before:
                self._run_steps(tuple(steps), cfg)
                steps = []
            if not isinstance(item, Collective):
                steps.append(item)
                continue
            hook = hooks[item.kind]
            if hook is None:
                continue
            if captured:
                steps.append(_Sum(item, hook))
                continue
            self._run_steps(tuple(steps), cfg)
            steps = []
            sums = hook(tuple(self.bufs[n] for n in item.names))
            for n, s in zip(item.names, sums):
                self.bufs[n].copy_(s)
        self._run_steps(tuple(steps), cfg)
        return self.bufs

    def _run_steps(self, steps: tuple, cfg) -> None:
        if not steps:
            return
        _count(self.name, "segments")
        if self.device.type != "cuda":
            _commit(self.bufs, _apply(steps, self.bufs, cfg))
            return
        seg = self._segments.get(steps)
        if seg is None:
            with torch.cuda.device(self.device):
                seg = self._segments[steps] = _Segment(self, steps, cfg)
        seg.replay()


# every ChainCache made, for clear_chains
_CACHES = []


def clear_chains() -> None:
    """Drop the chains of every solver, as ``jax.clear_caches`` drops
    compiled programs.  A chain's captured graphs keep their memory pool
    on the card for as long as the chain lives, so the chains of a few
    large problems can hold much of a card: a caller that moves on to
    other problem sizes can free them (with
    ``torch.cuda.empty_cache()``)."""
    for cache in _CACHES:
        cache.clear()


class ChainCache:
    """The chains of one solver: for each static signature (the
    caller's static arguments and shapes) one chain a shard that ran it,
    on that shard's device; at most ``MAXSIZE`` signatures, least
    recently used first out.  A signature is the JAX package's compiled
    ``shard_map`` program, which holds every shard's part, under its
    ``lru_cache(maxsize=8)``: the shards of one signature are kept and
    evicted together, so a mesh of any size keeps ``MAXSIZE`` of its
    problem sizes warm (were every shard's chain an entry of its own, a
    mesh of more than ``MAXSIZE`` shards would evict its own chains
    within a solve, and one of four shards would keep two sizes).  The
    CPU keeps none: a CPU chain has nothing to keep."""

    def __init__(self, name: str):
        self.name = name
        self._chains = collections.OrderedDict()
        self._lock = threading.Lock()
        _CACHES.append(self)

    def clear(self) -> None:
        with self._lock:
            self._chains.clear()

    def get(self, key, shard: int, device) -> Chain:
        device = torch.device(device)
        if device.type != "cuda":
            return Chain(self.name, device)
        with self._lock:
            shards = self._chains.get(key)
            if shards is None:
                shards = self._chains[key] = {}
                if len(self._chains) > MAXSIZE:
                    self._chains.popitem(last=False)
            else:
                self._chains.move_to_end(key)
            chain = shards.get((shard, device))
            if chain is None:
                chain = shards[(shard, device)] = Chain(self.name, device)
        return chain
