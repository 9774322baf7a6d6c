"""Motion-only pose optimization (Levenberg-Marquardt on SE3), in torch.

Port of ``orb_slam2_tpu/optim/pose_opt.py`` (upstream ORB-SLAM2's
Optimizer::PoseOptimization, which the reference fork deleted): 4 rounds
of 10 LM iterations, Huber(sqrt(5.991)) in the first two rounds, chi2
reclassification of inliers and outliers between rounds.

The accept and damping decisions stay on the device (``torch.where``),
the damping starts from a fill (no copy of host data) and the damped
6x6 system, symmetric positive definite, is solved by a Cholesky
factorization in tensor operations (``geom.smallsolve.spd_solve``), so
a call reads nothing back to the host: on the card the 40 iterations
are one program, replayed from a CUDA graph by the tracker and the
relocalizer (``pipeline.tracking._pose_opt_fused``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import se3, smallsolve
from . import reproj

CHI2_MONO = 5.991


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor       # (4, 4) optimized pose
    inliers: torch.Tensor   # (N,) bool: chi2 <= 5.991 at the solution
    n_inliers: torch.Tensor


def _cost(res, inv_sigma2, live, use_huber):
    c2 = reproj.chi2(res.r, inv_sigma2)
    rho = torch.where(c2 > CHI2_MONO,
                      2.0 * torch.sqrt(c2 * CHI2_MONO) - CHI2_MONO,
                      c2) if use_huber else c2
    return torch.where(live & (res.depth > 0), rho,
                       torch.zeros_like(rho)).sum()


def optimize_pose(Tcw0: torch.Tensor, pts_w: torch.Tensor, uv: torch.Tensor,
                  inv_sigma2: torch.Tensor, valid: torch.Tensor,
                  fx: float, fy: float, cx: float, cy: float,
                  n_rounds: int = 4,
                  iters_per_round: int = 10) -> PoseOptResult:
    """LM over one SE3 given 2D-3D correspondences.

    pts_w (N, 3), uv (N, 2), inv_sigma2 (N,), valid (N,): fixed-size
    padded arrays; invalid rows carry zero weight."""
    eye6 = torch.eye(6, dtype=pts_w.dtype, device=pts_w.device)
    Tcw = Tcw0
    inlier = valid
    for rd in range(n_rounds):
        use_huber = rd < 2  # upstream drops the robust kernel after 2 rounds
        live = inlier & valid
        lam = torch.full((), 1e-3, dtype=pts_w.dtype,
                         device=pts_w.device)
        for _ in range(iters_per_round):
            res = reproj.project_jacobians(Tcw, pts_w, uv, fx, fy, cx, cy)
            c2 = reproj.chi2(res.r, inv_sigma2)
            w = inv_sigma2 * (reproj.huber_weight(c2, CHI2_MONO)
                              if use_huber else 1.0)
            w = torch.where(live & (res.depth > 0), w, torch.zeros_like(w))
            Jw = res.J_pose * w[:, None, None]
            H = torch.einsum("nia,nib->ab", Jw, res.J_pose)
            g = torch.einsum("nia,ni->a", Jw, res.r)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
            delta = -smallsolve.spd_solve(Hd, g)
            T_new = se3.exp(delta) @ Tcw
            # accept iff the cost decreased (simple LM; adjust damping)
            new = reproj.project_jacobians(T_new, pts_w, uv, fx, fy, cx, cy)
            accept = (_cost(new, inv_sigma2, live, use_huber)
                      < _cost(res, inv_sigma2, live, use_huber))
            Tcw = torch.where(accept, T_new, Tcw)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
        # reclassify
        res = reproj.project_jacobians(Tcw, pts_w, uv, fx, fy, cx, cy)
        c2 = reproj.chi2(res.r, inv_sigma2)
        inlier = valid & (c2 <= CHI2_MONO) & (res.depth > 0)
    return PoseOptResult(Tcw=Tcw, inliers=inlier,
                         n_inliers=inlier.sum(dtype=torch.int32))
