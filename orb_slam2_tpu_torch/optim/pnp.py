"""Batched EPnP + RANSAC: pose from 3D-2D correspondences, in torch.

Port of ``orb_slam2_tpu/optim/pnp.py`` (src/PnPsolver.cc, Lepetit's
EPnP + adaptive RANSAC).  H minimal 4-point hypotheses are solved as one
batch (control points -> barycentric alphas -> 12x12 eigen kernel ->
beta cases N=1/2/3 with Gauss-Newton -> rigid Horn alignment), every
H x N reprojection check runs dense and the hypothesis with the most
inliers wins: no sequential RANSAC loop (src/PnPsolver.cc:180-246).

Anchors in the reference: control points (src/PnPsolver.cc:286-309),
barycentric coordinates (:311-333), the M matrix (:335-355), beta
approximations (:455-527), Gauss-Newton on betas (:571-613), pose
recovery by absolute orientation (:357-453).  Every function takes a
leading batch axis.  Eigenvectors come ascending by eigenvalue, as
from ``jnp.linalg.eigh``.

A call reads nothing back to the host, so ``pnp_ransac`` replays from a
CUDA graph on the card (``pipeline.relocalization``): the symmetric
eigendecompositions are float64 Jacobi sweeps in tensor operations
there (:func:`_eigh`; LAPACK on the CPU, the JAX package's own routine
there), the 3x3 barycentric solve is the closed-form adjugate and the
normal equations of the beta fits a Cholesky solve
(``geom.smallsolve``).  Eigenvector signs, and the basis Jacobi and
LAPACK choose for a minimal set's 4-dimensional null space, move the
intermediate control points and betas but not the pose.
"""
from __future__ import annotations

from typing import NamedTuple

import functools

import torch

from ..geom import horn, jacobi, sim3, smallsolve

_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
# beta monomials [b11, b12, b22, b13, b23, b33, b14, b24, b34, b44]
_MONO = [(0, 0), (0, 1), (1, 1), (0, 2), (1, 2), (2, 2),
         (0, 3), (1, 3), (2, 3), (3, 3)]
# Jacobi sweeps (float64) that hold the eigenvalues to eigh's within
# 1e-6 relative and the eigenvectors (the 12x12 blocks: the projector on
# their 4-dimensional null space) within 1e-6, with a margin of at least
# 1e-7, on tests/test_torch_estimated_graphs.py's minimal sets: the 3x3
# covariances settle after 3 sweeps, the 12x12 M^T M after 7
SWEEPS_COV = 4
SWEEPS_M = 8


class PnPResult(NamedTuple):
    Tcw: torch.Tensor        # (4, 4) best pose
    inliers: torch.Tensor    # (N,) bool under the best pose
    n_inliers: torch.Tensor  # ()
    ok: torch.Tensor         # () bool


def _project(pc, fx, fy, cx, cy):
    z = torch.where(pc[..., 2].abs() < 1e-9, torch.full_like(pc[..., 2], 1e-9),
                    pc[..., 2])
    return torch.stack([fx * pc[..., 0] / z + cx,
                        fy * pc[..., 1] / z + cy], -1)


def _eigh(A, sweeps: int):
    """Ascending eigenvalues and eigenvectors of symmetric blocks
    (..., n, n).  On the card: ``sweeps`` Jacobi sweeps in float64
    (cuSOLVER's ``eigh`` checks its result on the host, which a CUDA
    graph cannot hold).  On the CPU: LAPACK's ``eigh``, NaN for a block
    with a non-finite entry (:func:`jacobi.lapack_eigh`)."""
    if A.is_cuda:
        w, v = jacobi.sym_eigh(A.double(), sweeps)
        return w.to(A.dtype), v.to(A.dtype)
    return jacobi.lapack_eigh(A)


def _control_points(pts):
    """World control points: centroid + principal directions
    (src/PnPsolver.cc:286-309).  (B, n, 3) -> (B, 4, 3)."""
    c0 = pts.mean(dim=-2)
    d = pts - c0[..., None, :]
    cov = d.transpose(-1, -2) @ d / pts.shape[-2]
    w, v = _eigh(cov, SWEEPS_COV)          # ascending
    # degenerate (planar/linear) sets: keep a tiny extent so the
    # barycentric solve stays invertible; RANSAC scoring rejects junk
    s = torch.sqrt(torch.clamp(w, min=1e-12)).clamp(min=1e-6)
    cs = c0[..., None, :] + s[..., :, None] * v.transpose(-1, -2)
    return torch.cat([c0[..., None, :], cs], dim=-2)


def _barycentric(pts, cw):
    """alphas with p = sum_j alpha_j c_j and sum alpha = 1
    (src/PnPsolver.cc:311-333).  (B, n, 3), (B, 4, 3) -> (B, n, 4)."""
    CC = (cw[..., 1:, :] - cw[..., :1, :]).transpose(-1, -2)     # (B, 3, 3)
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    a123 = smallsolve.solve3x3((CC + 1e-12 * eye)[..., None, :, :],
                               pts - cw[..., :1, :])             # (B, n, 3)
    a0 = 1.0 - a123.sum(-1, keepdim=True)
    return torch.cat([a0, a123], dim=-1)


def _build_M(alphas, uv, fx, fy, cx, cy):
    """(B, n, 4), (B, n, 2) -> (B, 2n, 12) (src/PnPsolver.cc:335-355)."""
    B, n = alphas.shape[:2]
    u, v = uv[..., 0], uv[..., 1]
    zero = torch.zeros_like(alphas)
    rows_u = torch.stack([alphas * fx, zero, alphas * (cx - u)[..., None]],
                         dim=-1).reshape(B, n, 12)
    rows_v = torch.stack([zero, alphas * fy, alphas * (cy - v)[..., None]],
                         dim=-1).reshape(B, n, 12)
    return torch.cat([rows_u, rows_v], dim=-2)


def _rho(cw):
    """Squared pairwise distances of the 4 world control points (B, 6)."""
    return torch.stack([((cw[..., i, :] - cw[..., j, :]) ** 2).sum(-1)
                        for i, j in _PAIRS], dim=-1)


def _L6x10(V):
    """V: (B, 12, 4) kernel vectors (columns v1..v4) -> L (B, 6, 10)
    (src/PnPsolver.cc:529-569)."""
    v = V.transpose(-1, -2).reshape(V.shape[0], 4, 4, 3)   # (B, vec, cp, xyz)
    dv = torch.stack([v[:, :, i] - v[:, :, j] for i, j in _PAIRS],
                     dim=1)                                 # (B, 6, 4, 3)

    def dot(a, b):
        return (dv[:, :, a] * dv[:, :, b]).sum(-1)          # (B, 6)

    return torch.stack([
        dot(0, 0), 2 * dot(0, 1), dot(1, 1), 2 * dot(0, 2),
        2 * dot(1, 2), dot(2, 2), 2 * dot(0, 3), 2 * dot(1, 3),
        2 * dot(2, 3), dot(3, 3)], dim=-1)


def _lstsq(A, b):
    """Least squares by the damped normal equations (SPD)."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    At = A.transpose(-1, -2)
    return smallsolve.spd_solve(At @ A + 1e-9 * eye,
                                (At @ b[..., None])[..., 0])


def _sgn_neg(x):
    return torch.where(x < 0, -torch.ones_like(x), torch.ones_like(x))


def _betas_approx_1(L, rho):
    """N=4 start: unknowns [b11, b12, b13, b14] (src/PnPsolver.cc:455-478)."""
    x = _lstsq(torch.stack([L[..., 0], L[..., 1], L[..., 3], L[..., 6]],
                           -1), rho)
    b1 = torch.sqrt(x[:, 0].abs())
    d = torch.clamp(b1, min=1e-12)
    sgn = _sgn_neg(x[:, 0])
    return torch.stack([b1, sgn * x[:, 1] / d, sgn * x[:, 2] / d,
                        sgn * x[:, 3] / d], dim=-1)


def _betas_approx_2(L, rho):
    """N=2 start: [b11, b12, b22] (src/PnPsolver.cc:480-501)."""
    x = _lstsq(L[..., :3], rho)
    b1 = torch.sqrt(x[:, 0].abs())
    b2 = torch.sqrt(x[:, 2].abs()) * _sgn_neg(x[:, 1])
    zero = torch.zeros_like(b1)
    return torch.stack([b1, b2, zero, zero], dim=-1)


def _betas_approx_3(L, rho):
    """N=3 start: [b11, b12, b22, b13, b23] (src/PnPsolver.cc:503-527)."""
    x = _lstsq(L[..., :5], rho)
    b1 = torch.sqrt(x[:, 0].abs())
    b2 = torch.sqrt(x[:, 2].abs()) * _sgn_neg(x[:, 1])
    b3 = x[:, 3] / torch.clamp(b1, min=1e-12)
    return torch.stack([b1, b2, b3, torch.zeros_like(b1)], dim=-1)


@functools.lru_cache(maxsize=None)
def _mono_index(device):
    """The beta monomials' two factor indices (10,) each, made once per
    device (a CUDA graph replays the cached tensors)."""
    return (torch.tensor([a for a, _ in _MONO]).to(device),
            torch.tensor([b for _, b in _MONO]).to(device))


def _gauss_newton_betas(L, rho, betas, iters: int = 5):
    """Refine betas on the 6 distance constraints
    (src/PnPsolver.cc:571-613)."""
    i0, i1 = _mono_index(L.device)
    e = torch.eye(4, dtype=L.dtype, device=L.device)
    for _ in range(iters):
        mono = betas[:, i0] * betas[:, i1]                          # (B, 10)
        r = (L @ mono[..., None])[..., 0] - rho                     # (B, 6)
        jac = (e[i0] * betas[:, i1, None]
               + e[i1] * betas[:, i0, None])                # (B, 10, 4)
        betas = betas + _lstsq(L @ jac, -r)
    return betas


def _pose_from_betas(V, betas, alphas, pts_w):
    """Camera control points -> camera point coords -> rigid Horn
    alignment (src/PnPsolver.cc:357-453)."""
    ccs = (V @ betas[..., None])[..., 0].reshape(-1, 4, 3)
    pc = alphas @ ccs                                               # (B, n, 3)
    # positive depth (cheirality): the EPnP kernel's sign is arbitrary
    flip = torch.where(pc[..., 2].sum(-1) < 0, -1.0, 1.0)
    pc = pc * flip[:, None, None]
    g = horn.horn_sim3(pc, pts_w, fix_scale=True)   # world -> camera rigid
    return sim3.to_se3(g)


def _epnp_batch(pts_w, uv, fx, fy, cx, cy):
    """EPnP on B correspondence sets: (B, n, 3), (B, n, 2) -> (B, 4, 4)
    poses and (B,) mean squared reprojection errors."""
    cw = _control_points(pts_w)
    alphas = _barycentric(pts_w, cw)
    M = _build_M(alphas, uv, fx, fy, cx, cy)
    _, vecs = _eigh(M.transpose(-1, -2) @ M, SWEEPS_M)     # ascending
    V = vecs[..., :4]                                      # null-space basis
    L = _L6x10(V)
    rho = _rho(cw)
    Ts, errs = [], []
    for approx in (_betas_approx_1, _betas_approx_2, _betas_approx_3):
        betas = _gauss_newton_betas(L, rho, approx(L, rho))
        T = _pose_from_betas(V, betas, alphas, pts_w)
        pc = pts_w @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]
        r = _project(pc, fx, fy, cx, cy) - uv
        Ts.append(T)
        errs.append((r * r).sum(-1).mean(-1))
    Ts = torch.stack(Ts, dim=1)                            # (B, 3, 4, 4)
    errs = torch.stack(errs, dim=1)                        # (B, 3)
    best = torch.argmin(errs, dim=1)
    rows = torch.arange(len(best), device=best.device)
    return Ts[rows, best], errs[rows, best]


def epnp(pts_w: torch.Tensor, uv: torch.Tensor,
         fx: float, fy: float, cx: float, cy: float):
    """EPnP on a single correspondence set (n >= 4).  Returns (Tcw, err)."""
    T, err = _epnp_batch(pts_w[None], uv[None], fx, fy, cx, cy)
    return T[0], err[0]


def pnp_ransac(pts_w: torch.Tensor, uv: torch.Tensor,
               inv_sigma2: torch.Tensor, valid: torch.Tensor,
               samples: torch.Tensor, fx: float, fy: float, cx: float,
               cy: float, min_inliers: int = 10,
               chi2: float = 5.991) -> PnPResult:
    """Fixed-batch EPnP RANSAC (PnPsolver::iterate,
    src/PnPsolver.cc:180-246): H hypotheses (``samples`` (H, 4) indices)
    solved as one batch, dense H x N chi2 scoring, the first hypothesis
    with the most inliers wins."""
    samples = samples.long()
    Ts, _ = _epnp_batch(pts_w[samples], uv[samples], fx, fy, cx, cy)
    hyp_ok = valid[samples].all(dim=-1)
    pc = torch.einsum("hij,nj->hni", Ts[:, :3, :3], pts_w) \
        + Ts[:, None, :3, 3]
    r = _project(pc, fx, fy, cx, cy) - uv[None]
    c2 = (r * r).sum(-1) * inv_sigma2[None]
    inl = valid[None] & (c2 <= chi2) & (pc[..., 2] > 0)
    counts = torch.where(hyp_ok, inl.sum(-1), torch.full_like(hyp_ok, -1,
                                                             dtype=torch.long))
    # a (1,) index: a 0-d index tensor would be read back to the host
    best = torch.argmax(counts, dim=0, keepdim=True)
    n_best = counts[best][0]
    return PnPResult(Tcw=Ts[best][0], inliers=inl[best][0],
                     n_inliers=torch.clamp(n_best, min=0),
                     ok=n_best >= min_inliers)
