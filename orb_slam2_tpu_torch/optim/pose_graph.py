"""Essential-graph Sim3 pose-graph optimization — port of
``orb_slam2_tpu/optim/pose_graph.py`` (Optimizer::OptimizeEssentialGraph,
src/Optimizer.cc:654-983), single device.

7-DoF Sim3 vertices per keyframe; edges from loop connections, the
spanning tree, past loop edges and strong covisibility; identity
information; LM.  Edge residual (g2o EdgeSim3): for edge (i -> j) with
measurement Sji, r = log(Sji * Si * Sj^-1), zero when Sj = Sji * Si.
The per-edge Jacobians on the exp chart of each endpoint come from one
batched central difference in float64 (:func:`_edge_jacobians`); the
normal equations are solved by block-Jacobi PCG with edge-list
scatter-add matvecs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import sim3
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


def optimize_pose_graph(sims0, edge_i, edge_j, edge_meas, edge_weight,
                        fixed, iters: int = 20,
                        cg_iters: int = 30) -> PoseGraphResult:
    """LM over the Sim3 pose graph.  sims0 (K, 8) world -> kf; edge_i,
    edge_j (E,) int; edge_meas (E, 8) Sji; edge_weight (E,) (0 masks a
    padded edge); fixed (K,) bool."""
    K = sims0.shape[0]
    dt, dev = sims0.dtype, sims0.device
    edge_i, edge_j = edge_i.long(), edge_j.long()
    free = ~fixed
    eye7 = torch.eye(7, dtype=dt, device=dev)

    def cost(sims):
        zero = torch.zeros(edge_i.shape[0], 7, dtype=dt, device=dev)
        r = _edge_residual(zero, zero, sims[edge_i], sims[edge_j], edge_meas)
        return (edge_weight * (r * r).sum(-1)).sum()

    # the i-side rows, then the j-side rows, into their keyframes
    per_kf = IndexSum(torch.cat([edge_i, edge_j]), K)

    def scatter(vals_i, vals_j):
        return per_kf(torch.cat([vals_i, vals_j]))

    sims = sims0
    lam = torch.tensor(1e-3, dtype=dt, device=dev)
    for _ in range(iters):
        r, Ji, Jj = _edge_jacobians(sims[edge_i], sims[edge_j], edge_meas)
        w = edge_weight[:, None, None]
        Jiw, Jjw = Ji * w, Jj * w

        # gradient g_k = sum_e J^T r
        g = scatter(torch.einsum("eab,ea->eb", Jiw, r),
                    torch.einsum("eab,ea->eb", Jjw, r))
        g = torch.where(free[:, None], g, torch.zeros_like(g))

        # block-diagonal preconditioner + damping
        diag = scatter(torch.einsum("eab,eac->ebc", Jiw, Ji),
                       torch.einsum("eab,eac->ebc", Jjw, Jj))
        damp = lam * eye7 * torch.clamp(
            torch.diagonal(diag, dim1=-2, dim2=-1).sum(-1)[:, None, None]
            / 7.0, min=1e-6)
        diag_d = diag + damp + 1e-8 * eye7
        M_inv = torch.linalg.inv(torch.where(
            free[:, None, None], diag_d, eye7.expand_as(diag_d)))

        def H_matvec(x):
            xm = torch.where(free[:, None], x, torch.zeros_like(x))
            ri = torch.einsum("eab,eb->ea", Ji, xm[edge_i]) \
                + torch.einsum("eab,eb->ea", Jj, xm[edge_j])
            out = scatter(torch.einsum("eab,ea->eb", Jiw, ri),
                          torch.einsum("eab,ea->eb", Jjw, ri))
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
        ok = cost(cand) < cost(sims)
        sims = torch.where(ok, cand, sims)
        lam = torch.where(ok, lam * 0.5, lam * 4.0)
    return PoseGraphResult(sims=sims, final_cost=cost(sims))
