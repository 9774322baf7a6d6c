"""Batched reprojection residuals + analytic Jacobians — port of
``orb_slam2_tpu/optim/reproj.py`` (g2o's EdgeSE3ProjectXYZ,
Thirdparty/g2o/g2o/types/types_six_dof_expmap.cpp).  Pose tangent:
left-multiplicative Tcw' = exp(delta) @ Tcw with delta = (upsilon,
omega), so d(pc)/d(upsilon) = I and d(pc)/d(omega) = -[pc]_x.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import se3


class Residuals(NamedTuple):
    r: torch.Tensor        # (N, 2) residual = proj(pc) - uv_obs
    J_pose: torch.Tensor   # (N, 2, 6)
    J_point: torch.Tensor  # (N, 2, 3)
    depth: torch.Tensor    # (N,) camera z


def duv_dpc(pc: torch.Tensor, fx: float, fy: float):
    """(u, v, d(uv)/d(pc) (N, 2, 3)) of camera-frame points (N, 3),
    without the principal point."""
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    inv_z = 1.0 / zs
    zero = torch.zeros_like(x)
    J = torch.stack([
        torch.stack([fx * inv_z, zero, -fx * x * inv_z * inv_z], -1),
        torch.stack([zero, fy * inv_z, -fy * y * inv_z * inv_z], -1),
    ], dim=-2)
    return fx * x * inv_z, fy * y * inv_z, J


def project_jacobians(Tcw, pts_w, uv_obs, fx: float, fy: float,
                      cx: float, cy: float) -> Residuals:
    """Tcw: (4, 4) or (N, 4, 4) per-observation poses; pts_w, uv_obs:
    (N, 3), (N, 2)."""
    R = Tcw[..., :3, :3]
    t = Tcw[..., :3, 3]
    if Tcw.dim() == 2:
        pc = pts_w @ R.T + t
    else:
        pc = (R @ pts_w[..., None])[..., 0] + t
    u, v, J = duv_dpc(pc, fx, fy)
    r = torch.stack([u + cx, v + cy], -1) - uv_obs
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape[0], 3, 3)
    J_pose = J @ torch.cat([eye, -se3.hat(pc)], dim=-1)
    return Residuals(r=r, J_pose=J_pose, J_point=J @ R, depth=pc[:, 2])


def chi2(r: torch.Tensor, inv_sigma2: torch.Tensor) -> torch.Tensor:
    """Per-observation chi-squared error (N,)."""
    return (r * r).sum(-1) * inv_sigma2


def huber_weight(c2: torch.Tensor, delta2: float) -> torch.Tensor:
    """IRLS weight of the Huber kernel with squared threshold delta2:
    1 inside, delta/|r| outside (g2o's RobustKernelHuber)."""
    return torch.where(c2 <= delta2, torch.ones_like(c2),
                       torch.sqrt(delta2 / torch.clamp(c2, min=1e-12)))
