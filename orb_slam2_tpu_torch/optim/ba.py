"""Full bundle adjustment: LM + Schur complement + matrix-free PCG.

Port of the single-device ``bundle_adjust`` of
``orb_slam2_tpu/optim/ba.py`` (Optimizer::BundleAdjustment /
GlobalBundleAdjustemnt, src/Optimizer.cc:56-306):

- the 3x3-block-diagonal point block Hpp is eliminated in closed form;
- the reduced camera system S = Hcc - W Hpp^-1 W^T is never formed: PCG
  applies it with two scatter-add passes over the observations per
  matvec;
- block-Jacobi preconditioner from the exact 6x6 Schur diagonal;
- one linearization per LM iteration (a rejected step re-solves the
  carried system with more damping).

The JAX package keeps the per-observation blocks as rank-1 "lanes"
because the TPU pads the two minor dims of every array to (8, 128); the
card has no such padding, so the port keeps them as (O, 6, 3) / (O, 2, 6)
matrices.  The arithmetic is the same; sums run in another order.
Gauge: a boolean ``fixed_cam`` mask.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import se3
from . import reproj
from .segment import IndexSum

CHI2_MONO = 5.991
# A residual whose point falls behind the camera costs a flat penalty
# instead of vanishing, so LM cannot "improve" the objective by moving
# points to negative depth (the JAX module's INVALID_DEPTH_PENALTY).
INVALID_DEPTH_PENALTY = 1.0e8


class BAResult(NamedTuple):
    cam_Tcw: torch.Tensor     # (K, 4, 4)
    points: torch.Tensor      # (P, 3)
    obs_inlier: torch.Tensor  # (O,) bool
    final_cost: torch.Tensor


class _Linearized(NamedTuple):
    hcc: torch.Tensor   # (K, 6, 6)
    gc: torch.Tensor    # (K, 6)
    hpp: torch.Tensor   # (P, 3, 3)
    gp: torch.Tensor    # (P, 3)
    W: torch.Tensor     # (O, 6, 3)
    cost: torch.Tensor


def _rho(c2, z, obs_wf, use_huber):
    rho = torch.where(c2 > CHI2_MONO,
                      2.0 * torch.sqrt(c2 * CHI2_MONO) - CHI2_MONO,
                      c2) if use_huber else c2
    return torch.where(obs_wf > 0,
                       torch.where(z > 0, rho,
                                   torch.full_like(rho, INVALID_DEPTH_PENALTY)),
                       torch.zeros_like(rho))


def _linearize(cam, pts, per_cam, per_pt, obs_uv, obs_isig2, obs_wf,
               fx, fy, cx, cy, use_huber):
    """``per_cam``, ``per_pt``: IndexSum over the observations' camera
    and point rows."""
    obs_cam, obs_pt = per_cam.idx, per_pt.idx
    res = reproj.project_jacobians(cam[obs_cam], pts[obs_pt], obs_uv,
                                   fx, fy, cx, cy)
    r, z = res.r, res.depth
    c2 = reproj.chi2(r, obs_isig2)
    w = obs_isig2 * (reproj.huber_weight(c2, CHI2_MONO) if use_huber
                     else 1.0)
    w = w * obs_wf * (z > 0)
    Jc, Jp = res.J_pose, res.J_point
    JcT_w = Jc.transpose(1, 2) * w[:, None, None]          # (O, 6, 2)
    JpT_w = Jp.transpose(1, 2) * w[:, None, None]          # (O, 3, 2)
    return _Linearized(
        hcc=per_cam(JcT_w @ Jc),
        gc=per_cam((JcT_w @ r[..., None])[..., 0]),
        hpp=per_pt(JpT_w @ Jp),
        gp=per_pt((JpT_w @ r[..., None])[..., 0]),
        W=JcT_w @ Jp,
        cost=_rho(c2, z, obs_wf, use_huber).sum())


def _inv3_sym(h):
    """Closed-form inverse of symmetric 3x3 blocks (adjugate / det)."""
    h00, h01, h02 = h[:, 0, 0], h[:, 0, 1], h[:, 0, 2]
    h11, h12, h22 = h[:, 1, 1], h[:, 1, 2], h[:, 2, 2]
    c00 = h11 * h22 - h12 * h12
    c01 = h02 * h12 - h01 * h22
    c02 = h01 * h12 - h02 * h11
    c11 = h00 * h22 - h02 * h02
    c12 = h01 * h02 - h00 * h12
    c22 = h00 * h11 - h01 * h01
    det = h00 * c00 + h01 * c01 + h02 * c02
    idet = 1.0 / torch.where(det.abs() < 1e-18, torch.full_like(det, 1e-18),
                             det)
    return torch.stack([
        torch.stack([c00, c01, c02], -1),
        torch.stack([c01, c11, c12], -1),
        torch.stack([c02, c12, c22], -1)], -2) * idet[:, None, None]


def _solve_step(lin: _Linearized, per_cam, per_pt, lam, fixed_cam,
                cg_iters):
    """One damped Schur + PCG solve -> (delta_c (K, 6), delta_p (P, 3))."""
    K = lin.hcc.shape[0]
    free = ~fixed_cam
    eye6 = torch.eye(6, dtype=lin.hcc.dtype, device=lin.hcc.device)
    eye3 = torch.eye(3, dtype=lin.hcc.dtype, device=lin.hcc.device)

    # trace-scaled damping
    tr6 = torch.diagonal(lin.hcc, dim1=-2, dim2=-1).sum(-1)
    hcc_d = lin.hcc + (lam * torch.clamp(tr6 / 6.0, min=1e-6)
                       + 1e-8)[:, None, None] * eye6
    tr3 = torch.diagonal(lin.hpp, dim1=-2, dim2=-1).sum(-1)
    hpp_d = lin.hpp + (lam * torch.clamp(tr3 / 3.0, min=1e-6)
                       + 1e-8)[:, None, None] * eye3
    hpp_inv = _inv3_sym(hpp_d)
    W = lin.W

    obs_cam, obs_pt = per_cam.idx, per_pt.idx

    def W_x(x):        # per obs W^T x(cam) -> scatter to points
        return per_pt((W.transpose(1, 2) @ x[obs_cam][..., None])[..., 0])

    def Wt_z(z):       # per obs W z(point) -> scatter to cameras
        return per_cam((W @ z[obs_pt][..., None])[..., 0])

    def hinv(v):
        return (hpp_inv @ v[..., None])[..., 0]

    b = -(lin.gc - Wt_z(hinv(lin.gp))) * free[:, None]

    def S_matvec(x):
        out = (hcc_d @ x[..., None])[..., 0] - Wt_z(hinv(W_x(x)))
        return torch.where(free[:, None], out, x)

    # block-Jacobi preconditioner: the exact Schur diagonal blocks
    whw = per_cam(W @ hpp_inv[obs_pt] @ W.transpose(1, 2))
    S_diag = torch.where(free[:, None, None], hcc_d - whw,
                         eye6.expand(K, 6, 6))
    M_inv = torch.linalg.inv(S_diag + 1e-8 * eye6)

    def precond(r):
        return (M_inv @ r[..., None])[..., 0]

    x = torch.zeros_like(b)
    r = b - S_matvec(x)
    z = precond(r)
    p = z
    for _ in range(cg_iters):
        Sp = S_matvec(p)
        rz = (r * z).sum()
        alpha = rz / torch.clamp((p * Sp).sum(), min=1e-20)
        x = x + alpha * p
        r = r - alpha * Sp
        z = precond(r)
        beta = (r * z).sum() / torch.clamp(rz, min=1e-20)
        p = z + beta * p
    delta_c = torch.where(free[:, None], x, torch.zeros_like(x))
    delta_p = hinv(-(lin.gp + W_x(delta_c)))
    return delta_c, delta_p


def bundle_adjust(cam_Tcw, points, obs_cam, obs_pt, obs_uv, obs_isig2,
                  obs_valid, fixed_cam, fx: float, fy: float, cx: float,
                  cy: float, iters: int = 10, cg_iters: int = 20,
                  use_huber: bool = True) -> BAResult:
    """Single-device full BA.  cam_Tcw (K, 4, 4), points (P, 3), obs_*
    (O,) per observation (camera row, point row, uv, 1/sigma^2, valid),
    fixed_cam (K,) bool."""
    obs_wf = obs_valid.to(points.dtype)
    obs_cam, obs_pt = obs_cam.long(), obs_pt.long()
    per_cam = IndexSum(obs_cam, cam_Tcw.shape[0])
    per_pt = IndexSum(obs_pt, points.shape[0])

    def lin_at(cam, pts):
        return _linearize(cam, pts, per_cam, per_pt, obs_uv, obs_isig2,
                          obs_wf, fx, fy, cx, cy, use_huber)

    cam, pts = cam_Tcw, points
    lin = lin_at(cam, pts)
    lam = torch.tensor(1e-4, dtype=points.dtype, device=points.device)
    for _ in range(iters):
        dc, dp = _solve_step(lin, per_cam, per_pt, lam, fixed_cam, cg_iters)
        cam_new = se3.exp(dc) @ cam
        pts_new = pts + dp
        lin_new = lin_at(cam_new, pts_new)
        accept = lin_new.cost < lin.cost
        cam = torch.where(accept, cam_new, cam)
        pts = torch.where(accept, pts_new, pts)
        lin = _Linearized(*(torch.where(accept, a, b)
                            for a, b in zip(lin_new, lin)))
        lam = torch.where(accept, lam * 0.5, lam * 4.0)

    res = reproj.project_jacobians(cam[obs_cam], pts[obs_pt], obs_uv,
                                   fx, fy, cx, cy)
    c2 = reproj.chi2(res.r, obs_isig2)
    inlier = obs_valid & (c2 <= CHI2_MONO) & (res.depth > 0)
    return BAResult(cam_Tcw=cam, points=pts, obs_inlier=inlier,
                    final_cost=_rho(c2, res.depth, obs_wf, use_huber).sum())
