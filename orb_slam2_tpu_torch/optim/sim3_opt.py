"""Relative Sim3 optimization between two keyframes — port of
``orb_slam2_tpu/optim/sim3_opt.py`` (Optimizer::OptimizeSim3,
src/Optimizer.cc:985-1218).

Given matched map points of KF1 and KF2, optimize the similarity S12
(camera 2 -> camera 1) so that both reprojection directions agree:

  r1_i = proj(S12 . X2_i) - uv1_i,   r2_i = proj(S12^-1 . X1_i) - uv2_i

Huber(sqrt(10)), inlier pruning at chi2 > 10, then re-optimization.
Jacobians by forward-mode autodiff (``torch.func.jacfwd``) on the Sim3
exp chart: 7 parameters, one keyframe pair.  The Sim3 travels with a
leading batch axis of one inside the solver: under ``torch.func``,
0-dim tensors combined with Python floats are promoted to float64.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from ..geom import sim3

CHI2_SIM3 = 10.0
# Extra Levenberg damping on the log-scale coordinate: a pure sigma step
# scales s and t together, a flat valley when the two cameras are close;
# damping caps each sigma step without moving the optimum (see the JAX
# module for the measurement behind it).
SCALE_DAMPING_W = 2.0e4


class Sim3OptResult(NamedTuple):
    S12: torch.Tensor        # (8,) optimized similarity
    inliers1: torch.Tensor   # (N,) bool (reprojection into image 1 ok)
    inliers2: torch.Tensor   # (N,) bool
    n_inliers: torch.Tensor


def _residuals(S12, pts1_c, pts2_c, uv1, uv2, fx, fy, cx, cy):
    g = S12.reshape(1, 8)
    p2_in_1 = sim3.apply(g, pts2_c)[0]
    p1_in_2 = sim3.apply(sim3.inv(g), pts1_c)[0]

    def proj(pc):
        z = pc[:, 2]
        z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        return torch.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy],
                           -1)

    return (proj(p2_in_1) - uv1, proj(p1_in_2) - uv2,
            p2_in_1[:, 2], p1_in_2[:, 2])


def optimize_sim3(S12_init, pts1_cam, pts2_cam, uv1, uv2,
                  inv_sigma2_1, inv_sigma2_2, valid,
                  fx: float, fy: float, cx: float, cy: float,
                  iters: int = 10, fix_scale: bool = False) -> Sim3OptResult:
    def rho(c):
        return torch.where(c > CHI2_SIM3,
                           2 * torch.sqrt(c * CHI2_SIM3) - CHI2_SIM3, c)

    def cost_and_state(S12, active):
        r1, r2, _, _ = _residuals(S12, pts1_cam, pts2_cam, uv1, uv2,
                                  fx, fy, cx, cy)
        c1 = (r1 * r1).sum(-1) * inv_sigma2_1
        c2 = (r2 * r2).sum(-1) * inv_sigma2_2
        cost = torch.where(active, rho(c1) + rho(c2),
                           torch.zeros_like(c1)).sum()
        return cost, (c1, c2)

    def robust_w(c, isig, active):
        return torch.sqrt(isig * active * torch.where(
            c > CHI2_SIM3, torch.sqrt(CHI2_SIM3 / torch.clamp(c, min=1e-9)),
            torch.ones_like(c)))

    eye7 = torch.eye(7, dtype=S12_init.dtype, device=S12_init.device)

    def lm_rounds(S12, active, n_it):
        lam = torch.tensor(1e-3, dtype=S12.dtype, device=S12.device)
        activef = active.to(S12.dtype)
        for _ in range(n_it):
            # IRLS: robust weights frozen at the current iterate
            _, (c1c, c2c) = cost_and_state(S12, active)
            w1 = robust_w(c1c, inv_sigma2_1, activef)
            w2 = robust_w(c2c, inv_sigma2_2, activef)

            def rf(xi, S12=S12, w1=w1, w2=w2):
                S = sim3.compose(sim3.exp(xi), S12)
                r1, r2, _, _ = _residuals(S, pts1_cam, pts2_cam, uv1, uv2,
                                          fx, fy, cx, cy)
                return torch.cat([(r1 * w1[:, None]).reshape(-1),
                                  (r2 * w2[:, None]).reshape(-1)])

            xi0 = torch.zeros(1, 7, dtype=S12.dtype, device=S12.device)
            r0 = rf(xi0)
            J = jacfwd(rf)(xi0).reshape(-1, 7)     # (4N, 7)
            H = J.T @ J
            g = J.T @ r0
            H = H.clone()
            H[6, 6] += SCALE_DAMPING_W
            if fix_scale:
                H[6, :] = 0.0
                H[:, 6] = 0.0
                H[6, 6] = 1.0
                g = g.clone()
                g[6] = 0.0
            Hd = (H + lam * torch.diag(torch.diag(H))
                  + (1e-6 * torch.trace(H) / 7.0 + 1e-8) * eye7)
            dx = -torch.linalg.solve(Hd, g)
            S_new = sim3.compose(sim3.exp(dx[None]), S12)[0]
            c_new, _ = cost_and_state(S_new, active)
            c_old, _ = cost_and_state(S12, active)
            ok = c_new < c_old
            S12 = torch.where(ok, S_new, S12)
            lam = torch.where(ok, lam * 0.5, lam * 4.0)
        return S12

    S12 = lm_rounds(S12_init, valid, iters)
    # prune and re-optimize (src/Optimizer.cc:1126-1180)
    _, (c1, c2) = cost_and_state(S12, valid)
    active1 = valid & (c1 <= CHI2_SIM3) & (c2 <= CHI2_SIM3)
    S12 = lm_rounds(S12, active1, iters)
    _, (c1, c2) = cost_and_state(S12, active1)
    in1 = valid & (c1 <= CHI2_SIM3)
    in2 = valid & (c2 <= CHI2_SIM3)
    return Sim3OptResult(S12=S12, inliers1=in1, inliers2=in2,
                         n_inliers=(in1 & in2).sum())
