"""Meshes of shards for the distributed solvers, and their collective.

The JAX package runs one SPMD body per device of a ``jax.sharding.Mesh``
under ``shard_map``, with ``jax.lax.psum`` closing the sums.  Its torch
counterparts:

- :class:`LocalMesh`, one process: a list of torch devices (a device
  may repeat: two shards on one card, or N shards on the CPU).  Each
  shard's body runs on its own thread with its arrays on its own
  device; ``psum`` is a barrier at which every shard deposits its
  partial (a copy), then each shard sums the partials in shard order on
  its own device (so every shard gets the same bits, and runs repeat)
  and carries on.  A shard that raises aborts the barrier, so the others
  fail instead of waiting; every wait has a timeout.

  The shards take turns, in shard order, between two collectives: a
  turn passes to the next shard at each ``psum``.  The interpreter lock
  lets one thread run Python at a time anyway, and shards that all run
  at once spend their time handing it over at every operator; the
  device work each turn enqueues still runs asynchronously.
- :class:`ProcessGroupMesh`, one shard per process of a
  ``torch.distributed`` group (``parallel/multihost.py``): ``psum`` is
  ``all_reduce`` on a copy (through the host under gloo).  On NCCL
  with a card the mesh's ``psum`` is capturable (``graphs.capturable``):
  the graph chains run its sums inside their captures.

A ``psum`` takes a tensor or a tuple of tensors (as ``jax.lax.psum``
takes a pytree) and returns the same structure.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Sequence

import torch

from .. import graphs

# seconds a shard waits at a collective, or a caller for a shard thread,
# before the call fails
TIMEOUT_S = 600.0


def local_devices(device) -> List[torch.device]:
    """The runtime's local devices of ``device``'s type: every visible
    card for a CUDA device, the one CPU otherwise.  ``run_global_ba``
    shards when there are several."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _leaves(x):
    return (tuple(x), True) if isinstance(x, (tuple, list)) else ((x,), False)


class LocalMesh:
    """Shards on a list of devices of this process (see the module)."""

    def __init__(self, devices: Sequence, axis: str = "obs"):
        # a card named without an index is the caller's current card
        self.devices = [torch.device("cuda", torch.cuda.current_device())
                        if torch.device(d).type == "cuda"
                        and torch.device(d).index is None
                        else torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = (axis,)
        self.timeout = TIMEOUT_S

    @property
    def size(self) -> int:
        return len(self.devices)

    def local_shards(self) -> List[int]:
        return list(range(self.size))

    def device_of(self, shard: int) -> torch.device:
        return self.devices[shard]

    def run(self, body: Callable) -> Dict[int, object]:
        """``body(shard, device, psum)`` on every shard, each on its own
        thread; returns {shard: result}.  The first error of a shard (or
        a timeout) is raised here after every thread has ended."""
        n = self.size
        cond = threading.Condition()
        state = {"turn": 0, "broken": False}
        # round r deposits into bufs[r % 2]: a shard deposits round r + 1
        # only after every shard has read round r - 1
        bufs = [[None] * n, [None] * n]
        results: Dict[int, object] = {}
        errors: Dict[int, BaseException] = {}

        def abort():
            with cond:
                state["broken"] = True
                cond.notify_all()

        def wait_turn(d):
            with cond:
                ok = cond.wait_for(
                    lambda: state["turn"] == d or state["broken"],
                    timeout=self.timeout)
                if state["broken"]:
                    raise threading.BrokenBarrierError
                if not ok:
                    state["broken"] = True
                    cond.notify_all()
                    raise TimeoutError(
                        f"shard {d} waited past {self.timeout} s")

        def pass_turn(d):
            with cond:
                state["turn"] = (d + 1) % n
                cond.notify_all()

        def make_psum(d):
            dev = self.devices[d]
            rounds = [0]

            def psum(x):
                leaves, seq = _leaves(x)
                buf = bufs[rounds[0] % 2]
                rounds[0] += 1
                # a copy: a graph chain writes the sums back over its
                # partials, and replays write the next ones there,
                # before the shards after this one have read them
                buf[d] = [leaf.clone() for leaf in leaves]
                pass_turn(d)
                wait_turn(d)        # every shard has deposited
                out = []
                for k in range(len(leaves)):
                    acc = buf[0][k].to(dev)
                    for j in range(1, n):
                        acc = acc + buf[j][k].to(dev)
                    out.append(acc)
                return tuple(out) if seq else out[0]
            return psum

        def shard(d):
            dev = self.devices[d]
            try:
                if dev.type == "cuda":
                    torch.cuda.set_device(dev)
                wait_turn(d)
                results[d] = body(d, dev, make_psum(d))
                pass_turn(d)
            except BaseException as e:   # noqa: BLE001 - re-raised below
                errors[d] = e
                abort()

        threads = [threading.Thread(target=shard, args=(d,),
                                    name=f"mesh-shard-{d}", daemon=True)
                   for d in range(n)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + self.timeout
        for t in threads:
            t.join(max(deadline - time.monotonic(), 0.0))
        if any(t.is_alive() for t in threads):
            abort()
            raise TimeoutError(f"a mesh shard ran past {self.timeout} s")
        if errors:
            # the shard that failed first, not one its abort broke
            first = [e for e in errors.values()
                     if not isinstance(e, threading.BrokenBarrierError)]
            raise (first or list(errors.values()))[0]
        return results

    def all_gather(self, parts: Dict[int, torch.Tensor],
                   device) -> List[torch.Tensor]:
        """Every shard's tensor, in shard order, on ``device``."""
        return [parts[d].to(device) for d in range(self.size)]


class ProcessGroupMesh:
    """One shard per rank of the default ``torch.distributed`` group,
    on this rank's ``device``."""

    def __init__(self, device, axis: str = "obs"):
        import torch.distributed as dist
        self.dist = dist
        self.device = torch.device(device)
        self.axis_names = (axis,)
        self.rank = dist.get_rank()
        # NCCL sums on the card, on the current stream, and waits for
        # nothing on the host: a CUDA graph can hold the all-reduce.
        # Gloo's sums go through host memory and cannot be captured.
        self.capturable = (self.device.type == "cuda"
                           and dist.get_backend() == "nccl")

    @property
    def size(self) -> int:
        return self.dist.get_world_size()

    def local_shards(self) -> List[int]:
        return [self.rank]

    def device_of(self, shard: int) -> torch.device:
        return self.device

    def psum(self, x):
        """One ``all_reduce`` for the whole structure (its tensors share
        one dtype, as the solvers' do).  Gloo reduces host memory: a
        card's partials go down to the host (a wait for the card, one a
        collective) and the sums come back up without one; NCCL packs,
        reduces and unpacks on the card, on the current stream, with no
        host read (inside a capture, on the capturing stream)."""
        leaves, seq = _leaves(x)
        buf = torch.cat([leaf.reshape(-1) for leaf in leaves])
        if buf.is_cuda and self.dist.get_backend() != "nccl":
            host = buf.cpu()
            self.dist.all_reduce(host)
            buf = graphs.upload(host, buf.device)
        else:
            self.dist.all_reduce(buf)
        out = [part.reshape(leaf.shape) for part, leaf in zip(
            buf.split([leaf.numel() for leaf in leaves]), leaves)]
        return tuple(out) if seq else out[0]

    def run(self, body: Callable) -> Dict[int, object]:
        """``body(rank, device, psum)`` on this rank; ``psum`` is
        declared capturable where the mesh is, keyed on the group whose
        communicator a capture holds (a group made anew after
        ``destroy_process_group`` gets chains of its own)."""
        psum = self.psum
        if self.capturable:
            psum = graphs.capturable(self.psum, self.dist.group.WORLD)
        return {self.rank: body(self.rank, self.device, psum)}

    def all_gather(self, parts: Dict[int, torch.Tensor],
                   device) -> List[torch.Tensor]:
        local = parts[self.rank]
        dtype = local.dtype
        # gloo gathers host tensors; bools travel as bytes
        wire = local.to(torch.uint8) if dtype == torch.bool else local
        if self.dist.get_backend() != "nccl":
            wire = wire.cpu()
        out = [torch.empty_like(wire) for _ in range(self.size)]
        self.dist.all_gather(out, wire.contiguous())
        return [o.to(device=device, dtype=dtype) for o in out]
