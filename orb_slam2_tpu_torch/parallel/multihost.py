"""Multi-process launch helpers.

Port of ``orb_slam2_tpu/parallel/multihost.py``: where the JAX package
calls ``jax.distributed.initialize`` and builds one mesh over every
device of every process, the port joins a ``torch.distributed`` process
group and builds a :class:`~.mesh.ProcessGroupMesh` with one shard per
rank.  The solvers (``dist_ba`` / ``dist_pose_graph``) are the same at
any scale, because every sum already closes with the mesh's ``psum``.

Backend: NCCL, which needs a card for every rank of the host; the
number of ranks on this host is ``LOCAL_WORLD_SIZE`` (a launcher sets
it), else the world size, which must then fit the host's cards: a
world larger than the host's cards with ``LOCAL_WORLD_SIZE`` unset, or
no visible card, raises rather than falling back to gloo.  Gloo runs
only when the caller asks for it (``backend="gloo"``): CPU ranks, and
ranks that share a card (NCCL refuses two ranks on one GPU; gloo
reduces CUDA tensors through the host, and its sums cannot be
captured).  On NCCL the graph
chains of the solvers capture the all-reduce (``graphs.Chain``), so
``make_global_mesh`` creates the communicator with one eager collective:
NCCL creates it lazily at a group's first collective, which must not
happen inside a capture.

Before ``destroy_process_group`` on NCCL with several ranks, drop the
solvers' chains (``graphs.clear_chains()``: a captured graph holds NCCL
work of the communicator), synchronize, and let the group abort its
communicator (``TORCH_NCCL_ABORT_IN_DESTROY_PG=1`` before
``init_multihost``): four ranks whose graphs were alive hung in a plain
teardown on four H100s, and did not with both (which one is needed is
not measured).

One process needs nothing from here; call ``parallel.make_mesh()``.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

from . import mesh as mesh_mod
from .mesh import ProcessGroupMesh


def _local_rank() -> int:
    import torch.distributed as dist
    if os.environ.get("LOCAL_RANK"):
        return int(os.environ["LOCAL_RANK"])
    n = max(torch.cuda.device_count(), 1)
    return dist.get_rank() % n


def _backend(num_processes: int, backend: Optional[str] = None) -> str:
    """The process group's backend: ``backend`` where the caller names
    one, else NCCL, checked against the host's cards (see the module
    docstring)."""
    if backend is not None:
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"init_multihost: backend must be 'nccl' or "
                             f"'gloo', got {backend!r}")
        return backend
    if not torch.cuda.is_available():
        raise RuntimeError("init_multihost: no CUDA device is visible; "
                           "pass backend='gloo' for CPU ranks")
    cards = torch.cuda.device_count()
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if not local:
        if num_processes > cards:
            raise RuntimeError(
                f"init_multihost: a world of {num_processes} ranks exceeds "
                f"this host's {cards} card(s) and LOCAL_WORLD_SIZE is unset: "
                f"set LOCAL_WORLD_SIZE to the ranks on this host (NCCL, a "
                f"card a rank), or pass backend='gloo'")
        return "nccl"
    if int(local) > cards:
        raise RuntimeError(
            f"init_multihost: LOCAL_WORLD_SIZE={local} ranks on this host "
            f"but {cards} card(s): NCCL needs a card a rank; pass "
            f"backend='gloo' for ranks that share a card")
    return "nccl"


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None) -> None:
    """Join the process group from the arguments or the environment
    variables COORDINATOR_ADDRESS (host:port of rank 0's rendezvous,
    the ``tcp://`` init method), NUM_PROCESSES (the world size) and
    PROCESS_ID (this rank), on NCCL, or on ``backend`` where the caller
    names one ("gloo" for CPU ranks or ranks sharing a card).  The
    rendezvous and every collective time out after ``mesh.TIMEOUT_S``
    seconds, as a local mesh's shards do: a rank that is missing or
    stuck fails the others instead of holding them."""
    import torch.distributed as dist
    coordinator = coordinator or os.environ["COORDINATOR_ADDRESS"]
    if num_processes is None:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["PROCESS_ID"])
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(_backend(int(num_processes), backend),
                            init_method=coordinator,
                            world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=mesh_mod.TIMEOUT_S))


def make_global_mesh(axis: str = "obs", device=None) -> ProcessGroupMesh:
    """One mesh over every rank of the process group, each rank a shard
    on ``device``: by default the card at its local rank
    (``LOCAL_RANK``, else the rank modulo the visible cards), which must
    exist; the CPU only when asked for (``device="cpu"``).  Every rank
    calls it: on NCCL with a card it runs one all-reduce, which creates
    the communicator outside any capture."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_global_mesh: no CUDA device is "
                               "visible; pass device='cpu' for CPU ranks")
        device = torch.device("cuda", _local_rank())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = ProcessGroupMesh(device, axis)
    if mesh.capturable:
        # the communicator, before any capture holds the all-reduce
        mesh.psum(torch.zeros(1, device=device))
    return mesh
