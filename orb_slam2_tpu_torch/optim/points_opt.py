"""Structure-only bundle adjustment: P independent damped 3x3 solves.

Port of ``orb_slam2_tpu/optim/points_opt.py``.  This is the reference
fork's local BA: LocalBundleAdjustment with fixedPose=true
(src/LocalMapping.cc:122-124, src/Optimizer.cc:434-439 fixes every
camera vertex), which reduces to optimizing each map point against its
observations independently, as one batched Levenberg-Marquardt.

The JAX package writes every quantity as a rank-1 "lane" to dodge TPU
tile padding; the port uses the plain per-observation form: the (O, 2, 3)
point Jacobians, reduced per point into (P, 3, 3) normal equations by
``segment.IndexSum`` (``index_add_`` that repeats on the card), with
the same LM schedule (one linearization per iteration, per-point
accept/reject, damping x0.5 / x4 from 1e-3, or from ``lam0``) and the
same Huber weighting.  ``PointsOptResult.lam`` is the final damping:
passed back as ``lam0``, a run in chunks of iterations resumes the LM
where the last chunk left it, so chunks of 5 + 5 iterations give what
one call of 10 gives (local mapping runs its structure BA so).

Observation layout (flat arrays, length O):
  obs_pt[o]   : point index
  obs_Tcw     : (O,4,4) per-observation poses, or a (K,4,4) keyframe
                table indexed by obs_cam[o]
  obs_uv[o]   : measurement
  obs_isig2[o]: information (1/sigma^2 of the keypoint level)
  obs_valid[o]
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .segment import IndexSum

CHI2_MONO = 5.991


class PointsOptResult(NamedTuple):
    points: torch.Tensor      # (P, 3) optimized positions
    obs_inlier: torch.Tensor  # (O,) bool — obs passes chi2 at solution
    lam: torch.Tensor         # (P,) final LM damping — pass back as lam0


def optimize_points(
    points0: torch.Tensor,
    obs_pt: torch.Tensor,
    obs_Tcw: torch.Tensor,
    obs_uv: torch.Tensor,
    obs_isig2: torch.Tensor,
    obs_valid: torch.Tensor,
    fx: float, fy: float, cx: float, cy: float,
    iters: int = 10,
    use_huber: bool = True,
    obs_cam: torch.Tensor | None = None,
    lam0: torch.Tensor | None = None,
    longest_obs: int | None = None,
) -> PointsOptResult:
    """``longest_obs``: the most observations of one point, where the
    caller knows it (``IndexSum``'s ``longest``: then the solve does not
    wait for the card)."""
    P = points0.shape[0]
    obs_pt = obs_pt.long()
    per_point = IndexSum(obs_pt, P, longest=longest_obs)
    T = obs_Tcw[obs_cam.long()] if obs_cam is not None else obs_Tcw
    R = T[:, :3, :3]                      # (O, 3, 3)
    t = T[:, :3, 3]                       # (O, 3)

    def project(pts):
        pc = torch.einsum("oij,oj->oi", R, pts[obs_pt]) + t
        z = pc[:, 2]
        zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        iz = 1.0 / zs
        r = torch.stack([fx * pc[:, 0] * iz + cx - obs_uv[:, 0],
                         fy * pc[:, 1] * iz + cy - obs_uv[:, 1]], dim=1)
        c2 = (r * r).sum(1) * obs_isig2
        return pc, iz, r, c2

    def assemble(pts):
        """Per-point normal equations (H, g) and Huber cost."""
        pc, iz, r, c2 = project(pts)
        z = pc[:, 2]
        if use_huber:
            w = obs_isig2 * torch.where(
                c2 <= CHI2_MONO, torch.ones_like(c2),
                torch.sqrt(CHI2_MONO / torch.clamp(c2, min=1e-12)))
            rho = torch.where(c2 > CHI2_MONO,
                              2.0 * torch.sqrt(c2 * CHI2_MONO) - CHI2_MONO,
                              c2)
        else:
            w = obs_isig2
            rho = c2
        w = torch.where(obs_valid & (z > 0), w, torch.zeros_like(w))
        # d(uv)/d(pc) (O, 2, 3) times R: the point Jacobian
        zero = torch.zeros_like(iz)
        duv = torch.stack([
            torch.stack([fx * iz, zero, -fx * pc[:, 0] * iz * iz], 1),
            torch.stack([zero, fy * iz, -fy * pc[:, 1] * iz * iz], 1),
        ], 1)
        J = duv @ R                                          # (O, 2, 3)
        Hobs = w[:, None, None] * (J.transpose(1, 2) @ J)    # (O, 3, 3)
        gobs = w[:, None] * torch.einsum("oki,ok->oi", J, r)  # (O, 3)
        # behind-camera residuals must COST, not vanish
        rho_eff = torch.where(
            obs_valid,
            torch.where(z > 0, rho, torch.full_like(rho, 1.0e8)),
            torch.zeros_like(rho))
        H = per_point(Hobs)
        g = per_point(gobs)
        cost = per_point(rho_eff)
        return H, g, cost

    pts = points0.clone()
    lam = (torch.full((P,), 1e-3, dtype=points0.dtype, device=points0.device)
           if lam0 is None else lam0)
    H, g, cost = assemble(pts)
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    for _ in range(iters):
        # damped solve of the cached system; a rejected step re-solves
        # it with raised damping instead of re-assembling
        diag = torch.diagonal(H, dim1=1, dim2=2)
        dmp = lam * torch.clamp(diag.sum(1) / 3.0, min=1e-6) + 1e-9
        Hd = H + dmp[:, None, None] * eye
        adj, det = _adjugate_sym(Hd)
        idet = 1.0 / torch.where(det.abs() < 1e-18,
                                 torch.full_like(det, 1e-18), det)
        dx = -torch.einsum("pij,pj->pi", adj, g) * idet[:, None]
        cand = pts + dx
        Hn, gn, cost_n = assemble(cand)
        accept = cost_n < cost
        pts = torch.where(accept[:, None], cand, pts)
        H = torch.where(accept[:, None, None], Hn, H)
        g = torch.where(accept[:, None], gn, g)
        cost = torch.where(accept, cost_n, cost)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)

    pc, _, _, c2 = project(pts)
    inlier = obs_valid & (c2 <= CHI2_MONO) & (pc[:, 2] > 0)
    return PointsOptResult(points=pts, obs_inlier=inlier, lam=lam)


def _adjugate_sym(H: torch.Tensor):
    """Adjugate and determinant of symmetric (P, 3, 3) systems (the
    upper triangle is read, as the JAX package's lane form does)."""
    h00, h01, h02 = H[:, 0, 0], H[:, 0, 1], H[:, 0, 2]
    h11, h12, h22 = H[:, 1, 1], H[:, 1, 2], H[:, 2, 2]
    c00 = h11 * h22 - h12 * h12
    c01 = h02 * h12 - h01 * h22
    c02 = h01 * h12 - h02 * h11
    c11 = h00 * h22 - h02 * h02
    c12 = h01 * h02 - h00 * h12
    c22 = h00 * h11 - h01 * h01
    det = h00 * c00 + h01 * c01 + h02 * c02
    adj = torch.stack([torch.stack([c00, c01, c02], -1),
                       torch.stack([c01, c11, c12], -1),
                       torch.stack([c02, c12, c22], -1)], -2)
    return adj, det
