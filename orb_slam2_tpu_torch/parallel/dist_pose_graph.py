"""Distributed essential-graph (Sim3 pose-graph) optimization.

Port of ``orb_slam2_tpu/parallel/dist_pose_graph.py``.  Shards the EDGE
list over the mesh (edges are the big state of a pose graph: spanning
tree, covisibility and loop edges over a long trajectory); the Sim3
vertices are replicated.  The gradient, block-diagonal and Hessian
matvec sums of ``optim.pose_graph`` are closed with the mesh's ``psum``,
so every shard solves the same reduced system (the pattern of
``dist_ba``), and each shard replays the solver as a chain of CUDA
graphs (``pose_graph.pose_graph_shard``): on NCCL with every collective
inside them, elsewhere cut at each collective.
"""
from __future__ import annotations

import numpy as np

from .. import graphs
from ..geom import sim3 as sim3_mod
from ..optim import pose_graph
from .dist_ba import _first_device, make_mesh, pad_obs_to  # noqa: F401 (re-export mesh helper)


def distributed_pose_graph(
    mesh,
    sims0: np.ndarray,       # (K, 8)
    edge_i: np.ndarray,      # (E,)
    edge_j: np.ndarray,
    edge_meas: np.ndarray,   # (E, 8)
    edge_weight: np.ndarray,  # (E,)
    fixed: np.ndarray,       # (K,) bool
    iters: int = 20,
    cg_iters: int = 30,
    eager: bool = False,
) -> pose_graph.PoseGraphResult:
    """Same contract as ``optim.pose_graph.optimize_pose_graph``, edges
    sharded over the mesh (padded with identity measurements of weight
    0 to the mesh size times a power-of-4 bucket, as the single-device
    solve pads its edges).  ``eager=True`` runs the one-call
    ``optimize_pose_graph_core`` on every shard instead.  The result's
    tensors are on the mesh's first local device."""
    n_dev = mesh.size
    E = len(edge_i)
    per = graphs.pad_bucket(-(-max(E, n_dev) // n_dev), 16)
    pad = per * n_dev - E

    ident = sim3_mod.identity().numpy()
    edge_i = np.pad(np.asarray(edge_i, np.int32), (0, pad))
    edge_j = np.pad(np.asarray(edge_j, np.int32), (0, pad))
    edge_meas = np.concatenate(
        [np.asarray(edge_meas, np.float32).reshape(-1, 8),
         np.tile(ident, (pad, 1))]).astype(np.float32)
    edge_weight = np.pad(np.asarray(edge_weight, np.float32), (0, pad))
    sims0 = np.asarray(sims0, np.float32)
    fixed = np.asarray(fixed, bool)

    def body(d, dev, psum):
        sl = slice(d * per, (d + 1) * per)
        arrays = dict(sims=sims0, edge_i=edge_i[sl], edge_j=edge_j[sl],
                      edge_meas=edge_meas[sl], edge_weight=edge_weight[sl],
                      fixed=fixed)
        if not eager:
            return pose_graph.pose_graph_shard(d, dev, arrays, iters,
                                               cg_iters, psum)
        t = {k: graphs.upload(a, dev) for k, a in arrays.items()}
        return pose_graph.optimize_pose_graph_core(
            t["sims"], t["edge_i"], t["edge_j"], t["edge_meas"],
            t["edge_weight"], t["fixed"], iters=iters, cg_iters=cg_iters,
            psum=psum)

    res = mesh.run(body)
    first = res[mesh.local_shards()[0]]
    dev0 = _first_device(mesh)
    return pose_graph.PoseGraphResult(sims=first.sims.to(dev0),
                                      final_cost=first.final_cost.to(dev0))
