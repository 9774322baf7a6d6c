"""Essential-graph Sim3 pose-graph optimization — port of
``orb_slam2_tpu/optim/pose_graph.py`` (Optimizer::OptimizeEssentialGraph,
src/Optimizer.cc:654-983).

7-DoF Sim3 vertices per keyframe; edges from loop connections, the
spanning tree, past loop edges and strong covisibility; identity
information; LM.  Edge residual (g2o EdgeSim3): for edge (i -> j) with
measurement Sji, r = log(Sji * Si * Sj^-1), zero when Sj = Sji * Si.
The per-edge Jacobians on the exp chart of each endpoint come from one
batched central difference in float64 (:func:`_edge_jacobians`); the
normal equations are solved by block-Jacobi PCG with edge-list
scatter-add matvecs.  :func:`optimize_pose_graph_core` closes every
edge sum with a ``psum`` hook, so the edge list can be sharded
(``parallel/dist_pose_graph.py``); the vertex state is replicated.
:func:`optimize_pose_graph` runs on one device as a step program of
``ITER_CHUNK`` LM iterations replayed from a CUDA graph, (sims, lam)
threaded, and a program for the cost at the solution; its 7x7 preconditioner blocks are inverted by a Cholesky
factorization in tensor operations, so no step waits for the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import graphs
from ..geom import sim3, smallsolve
from . import segment
from .segment import IndexSum


class PoseGraphResult(NamedTuple):
    sims: torch.Tensor       # (K, 8) optimized Sim3 world->kf
    final_cost: torch.Tensor


def _edge_residual(xi_i, xi_j, Si, Sj, Sji):
    Si_new = sim3.compose(sim3.exp(xi_i), Si)
    Sj_new = sim3.compose(sim3.exp(xi_j), Sj)
    return sim3.log(sim3.compose(Sji, sim3.compose(Si_new, sim3.inv(Sj_new))))


_FD_STEP = 1e-4


def _edge_jacobians(Si, Sj, Sji):
    """(r (E, 7), Ji (E, 7, 7), Jj (E, 7, 7)) at xi_i = xi_j = 0, with
    J[e, a, b] = d r_a / d xi_b.

    The JAX package takes these by forward-mode autodiff in float32.
    Forward AD in PyTorch costs many residual evaluations per direction
    here, so the port takes central differences in float64 instead, all 28
    perturbed residuals in one batched evaluation: with a step of 1e-4
    the truncation error is ~1e-8 and the rounding error ~1e-12, below
    float32's resolution of the autodiff result."""
    E = Si.shape[0]
    zero = torch.zeros(E, 7, dtype=Si.dtype, device=Si.device)
    r = _edge_residual(zero, zero, Si, Sj, Sji)
    d = torch.eye(7, dtype=torch.float64, device=Si.device) * _FD_STEP
    steps = torch.cat([d, -d])                                 # (14, 7)
    z = torch.zeros_like(steps)
    xi_i = torch.cat([steps, z])[:, None, :].expand(28, E, 7)
    xi_j = torch.cat([z, steps])[:, None, :].expand(28, E, 7)

    def rep(S):
        return S.double()[None].expand(28, E, 8).reshape(28 * E, 8)

    rr = _edge_residual(xi_i.reshape(-1, 7), xi_j.reshape(-1, 7),
                        rep(Si), rep(Sj), rep(Sji)).reshape(28, E, 7)
    jac = (rr[:7] - rr[7:14]) / (2 * _FD_STEP)     # (7 dirs, E, 7)
    jac_j = (rr[14:21] - rr[21:]) / (2 * _FD_STEP)
    return (r, jac.permute(1, 2, 0).to(Si.dtype),
            jac_j.permute(1, 2, 0).to(Si.dtype))


def _identity_psum(x):
    return x


def _cost(sims, edge_i, edge_j, edge_meas, edge_weight, psum):
    zero = torch.zeros(edge_i.shape[0], 7, dtype=sims.dtype,
                       device=sims.device)
    r = _edge_residual(zero, zero, sims[edge_i], sims[edge_j], edge_meas)
    return psum((edge_weight * (r * r).sum(-1)).sum())


def _lm_iteration(sims, lam, edge_i, edge_j, edge_meas, edge_weight, free,
                  per_kf, cg_iters, psum):
    """One LM iteration with its ``cg_iters`` PCG steps (the body of the
    JAX package's ``fori_loop``): (sims, lam) -> the same."""
    K = sims.shape[0]
    dt, dev = sims.dtype, sims.device
    eye7 = torch.eye(7, dtype=dt, device=dev)

    def scatter(vals_i, vals_j):
        # the i-side rows, then the j-side rows, into their keyframes
        return per_kf(torch.cat([vals_i, vals_j]))

    r, Ji, Jj = _edge_jacobians(sims[edge_i], sims[edge_j], edge_meas)
    w = edge_weight[:, None, None]
    Jiw, Jjw = Ji * w, Jj * w

    # gradient g_k = sum_e J^T r
    g = psum(scatter(torch.einsum("eab,ea->eb", Jiw, r),
                     torch.einsum("eab,ea->eb", Jjw, r)))
    g = torch.where(free[:, None], g, torch.zeros_like(g))

    # block-diagonal preconditioner + damping
    diag = psum(scatter(torch.einsum("eab,eac->ebc", Jiw, Ji),
                        torch.einsum("eab,eac->ebc", Jjw, Jj)))
    damp = lam * eye7 * torch.clamp(
        torch.diagonal(diag, dim1=-2, dim2=-1).sum(-1)[:, None, None]
        / 7.0, min=1e-6)
    diag_d = diag + damp + 1e-8 * eye7
    M_inv = smallsolve.spd_inverse(torch.where(
        free[:, None, None], diag_d, eye7.expand_as(diag_d)))

    def H_matvec(x):
        xm = torch.where(free[:, None], x, torch.zeros_like(x))
        ri = torch.einsum("eab,eb->ea", Ji, xm[edge_i]) \
            + torch.einsum("eab,eb->ea", Jj, xm[edge_j])
        out = psum(scatter(torch.einsum("eab,ea->eb", Jiw, ri),
                           torch.einsum("eab,ea->eb", Jjw, ri)))
        out = out + (damp @ xm[..., None])[..., 0]
        return torch.where(free[:, None], out, x)

    b = -g
    x = torch.zeros((K, 7), dtype=dt, device=dev)
    rr = b - H_matvec(x)
    z = torch.einsum("kab,kb->ka", M_inv, rr)
    p = z
    for _ in range(cg_iters):
        Hp = H_matvec(p)
        rz = (rr * z).sum()
        alpha = rz / torch.clamp((p * Hp).sum(), min=1e-20)
        x = x + alpha * p
        rr = rr - alpha * Hp
        z_new = torch.einsum("kab,kb->ka", M_inv, rr)
        beta = (rr * z_new).sum() / torch.clamp(rz, min=1e-20)
        z = z_new
        p = z_new + beta * p
    dx = torch.where(free[:, None], x, torch.zeros_like(x))
    cand = sim3.compose(sim3.exp(dx), sims)
    ok = _cost(cand, edge_i, edge_j, edge_meas, edge_weight, psum) \
        < _cost(sims, edge_i, edge_j, edge_meas, edge_weight, psum)
    sims = torch.where(ok, cand, sims)
    lam = torch.where(ok, lam * 0.5, lam * 4.0)
    return sims, lam


def _lam0(sims):
    # a fill, not a copy of host data: a CUDA graph replays it
    return torch.full((), 1e-3, dtype=sims.dtype, device=sims.device)


def optimize_pose_graph_core(sims0, edge_i, edge_j, edge_meas, edge_weight,
                             fixed, iters: int = 20, cg_iters: int = 30,
                             psum=_identity_psum) -> PoseGraphResult:
    """LM over the Sim3 pose graph, in one call.  sims0 (K, 8) world ->
    kf; edge_i, edge_j (E,) int (may be a shard of the edges); edge_meas
    (E, 8) Sji; edge_weight (E,) (0 masks a padded edge); fixed (K,)
    bool.  ``psum`` closes the cost, the gradient, the block diagonal
    and the Hessian matvec over the shards of the edges."""
    edge_i, edge_j = edge_i.long(), edge_j.long()
    per_kf = IndexSum(torch.cat([edge_i, edge_j]), sims0.shape[0])
    sims, lam = sims0, _lam0(sims0)
    for _ in range(iters):
        sims, lam = _lm_iteration(sims, lam, edge_i, edge_j, edge_meas,
                                  edge_weight, ~fixed, per_kf, cg_iters,
                                  psum)
    return PoseGraphResult(sims=sims, final_cost=_cost(
        sims, edge_i, edge_j, edge_meas, edge_weight, psum))


# LM iterations per replay of the step program (one, as the BA's
# ba.ITER_CHUNK: the essential graph runs once per loop, so the first
# call's warm-up is most of its cost)
ITER_CHUNK = 1


def _pg_step(sims, lam, edge_i, edge_j, edge_meas, edge_weight, fixed,
             iters, cg_iters, longest):
    """``iters`` LM iterations from a threaded (sims, lam)."""
    edge_i, edge_j = edge_i.long(), edge_j.long()
    per_kf = IndexSum(torch.cat([edge_i, edge_j]), sims.shape[0],
                      longest=longest)
    for _ in range(iters):
        sims, lam = _lm_iteration(sims, lam, edge_i, edge_j, edge_meas,
                                  edge_weight, ~fixed, per_kf, cg_iters,
                                  _identity_psum)
    return sims, lam


def _pg_cost(sims, edge_i, edge_j, edge_meas, edge_weight):
    return _cost(sims, edge_i.long(), edge_j.long(), edge_meas, edge_weight,
                 _identity_psum)


# the JAX package's jitted optimize_pose_graph, as a step program and the
# cost at the solution, replayed from CUDA graphs on the card (on the CPU,
# the functions themselves)
_step_graph = graphs.graphed(lambda *a: _pg_step(*a), "pose_graph_step")
_cost_graph = graphs.graphed(lambda *a: _pg_cost(*a), "pose_graph_cost")


def optimize_pose_graph(sims0, edge_i, edge_j, edge_meas, edge_weight,
                        fixed, iters: int = 20, cg_iters: int = 30,
                        longest: int | None = None) -> PoseGraphResult:
    """Single-device entry point (see :func:`optimize_pose_graph_core`):
    ``ITER_CHUNK`` LM iterations a step, (sims, lam) threaded from step
    to step, then the cost at the solution, each a CUDA graph replay on
    the card; the iteration count and the op order are the one-call
    form's.  ``longest``: the most edge ends at one keyframe, from the
    host (``segment.longest_segment`` of both end lists), else read back
    here once."""
    K = sims0.shape[0]
    if longest is None:
        longest = segment.longest_segment(torch.cat(
            [edge_i, edge_j]).cpu().numpy(), K)
    longest = min(int(longest), segment.LONG_SEGMENTS + 1)
    sims, lam = sims0, _lam0(sims0)
    for done in range(0, iters, ITER_CHUNK):
        sims, lam = _step_graph(sims, lam, edge_i, edge_j, edge_meas,
                                edge_weight, fixed,
                                min(ITER_CHUNK, iters - done),
                                int(cg_iters), longest)
    return PoseGraphResult(sims=sims, final_cost=_cost_graph(
        sims, edge_i, edge_j, edge_meas, edge_weight))
