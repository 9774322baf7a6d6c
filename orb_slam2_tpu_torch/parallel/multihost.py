"""Multi-process launch helpers.

Port of ``orb_slam2_tpu/parallel/multihost.py``: where the JAX package
calls ``jax.distributed.initialize`` and builds one mesh over every
device of every process, the port joins a ``torch.distributed`` process
group and builds a :class:`~.mesh.ProcessGroupMesh` with one shard per
rank.  The solvers (``dist_ba`` / ``dist_pose_graph``) are the same at
any scale, because every sum already closes with the mesh's ``psum``.

Backend: NCCL when every rank of the host has a card of its own, gloo
on the CPU and when ranks share a card (NCCL refuses two ranks on one
GPU; gloo reduces CUDA tensors through the host).  On NCCL the graph
chains of the solvers capture the all-reduce (``graphs.Chain``), so
``make_global_mesh`` creates the communicator with one eager collective:
NCCL creates it lazily at a group's first collective, which must not
happen inside a capture.

One process needs nothing from here; call ``parallel.make_mesh()``.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from .mesh import ProcessGroupMesh


def _local_rank() -> int:
    import torch.distributed as dist
    if os.environ.get("LOCAL_RANK"):
        return int(os.environ["LOCAL_RANK"])
    n = max(torch.cuda.device_count(), 1)
    return dist.get_rank() % n


def _backend(num_processes: int) -> str:
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    if torch.cuda.is_available() and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    """Join the process group from the arguments or the environment
    variables COORDINATOR_ADDRESS (host:port of rank 0's rendezvous,
    the ``tcp://`` init method), NUM_PROCESSES (the world size) and
    PROCESS_ID (this rank), on the backend the module names."""
    import torch.distributed as dist
    coordinator = coordinator or os.environ["COORDINATOR_ADDRESS"]
    if num_processes is None:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["PROCESS_ID"])
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(_backend(int(num_processes)),
                            init_method=coordinator,
                            world_size=int(num_processes),
                            rank=int(process_id))


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
