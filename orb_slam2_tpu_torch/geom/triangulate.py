"""Batched two-view DLT triangulation + acceptance gates, in torch.

Port of ``orb_slam2_tpu/geom/triangulate.py`` (Initializer::triangulate,
src/Initializer.cc:56-105, 170-328, and the per-match triangulation of
LocalMapping::CreateNewMapPoints, src/LocalMapping.cc:346-492): the
inhomogeneous DLT solved in closed form per match (3x3 normal equations
by adjugate, one step of iterative refinement), then the finite /
depth / reprojection / parallax gates.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .smallsolve import solve3x3


def projection_matrix(K: torch.Tensor, Tcw: torch.Tensor) -> torch.Tensor:
    """P = K [R|t] from intrinsics (3,3) and pose (..., 4, 4) -> (..., 3, 4)."""
    return K @ Tcw[..., :3, :4]


def _dlt_rows(P, uv):
    r0 = uv[..., 0:1] * P[..., 2, :] - P[..., 0, :]
    r1 = uv[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    return r0, r1


def triangulate_dlt(P1, P2, uv1, uv2) -> torch.Tensor:
    """DLT triangulation of N correspondences with two shared cameras:
    P1, P2 (3, 4); uv1, uv2 (N, 2) undistorted pixels -> (N, 3)."""
    a0, a1 = _dlt_rows(P1[None], uv1)
    a2, a3 = _dlt_rows(P2[None], uv2)
    return _solve_dlt_rows(torch.stack([a0, a1, a2, a3], dim=-2))


def triangulate_dlt_pairs(P1, P2, uv1, uv2) -> torch.Tensor:
    """DLT with a per-match second camera: P1 (3,4) shared, P2 (N,3,4)."""
    a0, a1 = _dlt_rows(P1[None], uv1)
    a2, a3 = _dlt_rows(P2, uv2)
    return _solve_dlt_rows(torch.stack([a0, a1, a2, a3], dim=-2))


def _solve_dlt_rows(A: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) DLT rows -> (..., 3) world point: solve
    (A3^T A3) x = -A3^T a4 (rows normalized), plus one step of float32
    iterative refinement."""
    A = A / (torch.linalg.norm(A, dim=-1, keepdim=True) + 1e-12)
    A3 = A[..., :3]
    a4 = A[..., 3]
    H = torch.einsum("...ri,...rj->...ij", A3, A3)
    b = -torch.einsum("...ri,...r->...i", A3, a4)
    x = solve3x3(H, b)
    r = b - torch.einsum("...ij,...j->...i", H, x)
    return x + solve3x3(H, r)


def triangulate_dlt_pairs_np(P1, P2, uv1, uv2):
    """Host float64 twin of :func:`triangulate_dlt_pairs`: local mapping
    re-triangulates the accepted matches with it, so the stored
    positions do not depend on the device's float32 rounding."""
    a0, a1 = _dlt_rows(P1[None, :, :].astype(np.float64), uv1.astype(np.float64))
    a2, a3 = _dlt_rows(P2.astype(np.float64), uv2.astype(np.float64))
    A = np.stack([a0, a1, a2, a3], axis=-2)          # (N, 4, 4)
    A = A / (np.linalg.norm(A, axis=-1, keepdims=True) + 1e-12)
    A3 = A[..., :3]
    a4 = A[..., 3]
    H = np.einsum("nri,nrj->nij", A3, A3)
    b = -np.einsum("nri,nr->ni", A3, a4)
    return np.linalg.solve(H + 1e-12 * np.eye(3),
                           b[..., None])[..., 0].astype(np.float32)


class TriangulationCheck(NamedTuple):
    good: torch.Tensor          # (N,) bool — passes all gates
    parallax_cos: torch.Tensor  # (N,) cosine of triangulation angle


def _reproj_err2(pc, uv, fx, fy, cx, cy):
    z = pc[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    u = fx * pc[..., 0] * inv_z + cx
    v = fy * pc[..., 1] * inv_z + cy
    du, dv = u - uv[..., 0], v - uv[..., 1]
    return du * du + dv * dv


def _gates(pts_w, pc1, pc2, o1, o2, uv1, uv2, fx, fy, cx, cy,
           sigma2_1, sigma2_2, reproj_chi2, min_parallax_cos):
    e1 = _reproj_err2(pc1, uv1, fx, fy, cx, cy)
    e2 = _reproj_err2(pc2, uv2, fx, fy, cx, cy)
    r1 = pts_w - o1
    r2 = pts_w - o2
    n1 = torch.linalg.norm(r1, dim=-1)
    n2 = torch.linalg.norm(r2, dim=-1)
    cos_par = (r1 * r2).sum(-1) / (n1 * n2 + 1e-12)
    good = (
        torch.isfinite(pts_w).all(dim=-1)
        & (pc1[..., 2] > 0) & (pc2[..., 2] > 0)
        & (e1 <= reproj_chi2 * sigma2_1)
        & (e2 <= reproj_chi2 * sigma2_2)
        & (cos_par < min_parallax_cos)
        & (cos_par > -1.0 + 1e-6)
    )
    return TriangulationCheck(good=good, parallax_cos=cos_par)


def check_triangulation(
    pts_w, Tcw1, Tcw2, uv1, uv2, fx, fy, cx, cy, sigma2_1, sigma2_2,
    reproj_chi2: float = 5.991, min_parallax_cos: float = 0.99998,
) -> TriangulationCheck:
    """Per-point acceptance gates (src/Initializer.cc:233-322,
    src/LocalMapping.cc:380-470): finite, positive depth in both views,
    reprojection error <= chi2 * sigma^2 in both views, parallax above
    the threshold."""
    pc1 = pts_w @ Tcw1[:3, :3].T + Tcw1[:3, 3]
    pc2 = pts_w @ Tcw2[:3, :3].T + Tcw2[:3, 3]
    o1 = -Tcw1[:3, :3].T @ Tcw1[:3, 3]
    o2 = -Tcw2[:3, :3].T @ Tcw2[:3, 3]
    return _gates(pts_w, pc1, pc2, o1, o2, uv1, uv2, fx, fy, cx, cy,
                  sigma2_1, sigma2_2, reproj_chi2, min_parallax_cos)


def check_triangulation_pairs(
    pts_w, Tcw1, Tcw2, uv1, uv2, fx, fy, cx, cy, sigma2_1, sigma2_2,
    reproj_chi2: float = 5.991, min_parallax_cos: float = 0.99998,
) -> TriangulationCheck:
    """:func:`check_triangulation` with a per-match second camera
    Tcw2 (N, 4, 4)."""
    pc1 = pts_w @ Tcw1[:3, :3].T + Tcw1[:3, 3]
    pc2 = torch.einsum("nij,nj->ni", Tcw2[:, :3, :3], pts_w) + Tcw2[:, :3, 3]
    o1 = -Tcw1[:3, :3].T @ Tcw1[:3, 3]
    o2 = -torch.einsum("nji,nj->ni", Tcw2[:, :3, :3], Tcw2[:, :3, 3])
    return _gates(pts_w, pc1, pc2, o1, o2, uv1, uv2, fx, fy, cx, cy,
                  sigma2_1, sigma2_2, reproj_chi2, min_parallax_cos)
