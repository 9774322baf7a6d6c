"""Closed-form batched small solves, in torch.

Port of ``orb_slam2_tpu/geom/smallsolve.py``: the adjugate inverse is
exact, branch-free, and one elementwise pass over a whole batch of tiny
systems.

The symmetric positive-definite solves of the solvers' LM steps (the
6x6 and 7x7 block preconditioners of bundle adjustment and the essential
graph, the 7x7 damped system of the Sim3 optimization) run as a Cholesky
factorization of fixed size in tensor operations: ``torch.linalg``'s
``inv`` / ``solve`` check their result on the host, which a CUDA graph
cannot hold, and the factorization needs no pivot, since every such
system is damped.
"""
from __future__ import annotations

import torch


def adjugate3x3(H: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 3, 3) -> (adj(H) (..., 3, 3), det(H) (...,)), with
    H @ adj(H) = det(H) * I."""
    c00 = H[..., 1, 1] * H[..., 2, 2] - H[..., 1, 2] * H[..., 2, 1]
    c01 = H[..., 0, 2] * H[..., 2, 1] - H[..., 0, 1] * H[..., 2, 2]
    c02 = H[..., 0, 1] * H[..., 1, 2] - H[..., 0, 2] * H[..., 1, 1]
    c10 = H[..., 1, 2] * H[..., 2, 0] - H[..., 1, 0] * H[..., 2, 2]
    c11 = H[..., 0, 0] * H[..., 2, 2] - H[..., 0, 2] * H[..., 2, 0]
    c12 = H[..., 0, 2] * H[..., 1, 0] - H[..., 0, 0] * H[..., 1, 2]
    c20 = H[..., 1, 0] * H[..., 2, 1] - H[..., 1, 1] * H[..., 2, 0]
    c21 = H[..., 0, 1] * H[..., 2, 0] - H[..., 0, 0] * H[..., 2, 1]
    c22 = H[..., 0, 0] * H[..., 1, 1] - H[..., 0, 1] * H[..., 1, 0]
    det = H[..., 0, 0] * c00 + H[..., 0, 1] * c10 + H[..., 0, 2] * c20
    adj = torch.stack([
        torch.stack([c00, c01, c02], -1),
        torch.stack([c10, c11, c12], -1),
        torch.stack([c20, c21, c22], -1),
    ], -2)
    return adj, det


def solve3x3(H: torch.Tensor, b: torch.Tensor,
             eps: float = 1e-18) -> torch.Tensor:
    """Solve H x = b for batches of 3x3 systems: (..., 3, 3), (..., 3)
    -> (..., 3).  Singular systems return a large-but-finite vector
    (callers gate on residual checks)."""
    adj, det = adjugate3x3(H)
    inv_det = 1.0 / torch.where(det.abs() < eps,
                                torch.full_like(det, eps), det)
    x = torch.einsum("...ij,...j->...i", adj, b)
    return x * inv_det[..., None]


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor L of symmetric positive-definite blocks
    (..., n, n), A = L L^T, one column per step from the columns before
    it, in tensor operations (nothing waits for the card).  A pivot that
    rounding drives to zero or below is clamped to the smallest normal
    float, so a semidefinite block gives a large but finite factor."""
    n = A.shape[-1]
    tiny = torch.finfo(A.dtype).tiny
    rows = torch.arange(n, device=A.device)
    L = torch.zeros_like(A)
    for j in range(n):
        # column j of A minus the columns of L already made (those not
        # made yet are zero and add nothing)
        s = A[..., :, j] - (L @ L[..., j, :, None])[..., 0]
        d = torch.sqrt(torch.clamp(s[..., j], min=tiny))
        col = torch.where(rows >= j, s / d[..., None], torch.zeros_like(s))
        L = L + col[..., :, None] * (rows == j).to(A.dtype)
    return L


def _forward(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Y with L Y = B for lower-triangular L (..., n, n), B (..., n, m)."""
    n = L.shape[-1]
    rows = torch.arange(n, device=L.device)
    Y = torch.zeros_like(B)
    for j in range(n):
        y = (B[..., j, :] - (L[..., j, None, :] @ Y)[..., 0, :]) \
            / L[..., j, j, None]
        Y = Y + (rows == j).to(B.dtype)[:, None] * y[..., None, :]
    return Y


def _backward(L: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """X with L^T X = Y for lower-triangular L (..., n, n)."""
    n = L.shape[-1]
    rows = torch.arange(n, device=L.device)
    Lt = L.transpose(-1, -2)
    X = torch.zeros_like(Y)
    for j in range(n - 1, -1, -1):
        x = (Y[..., j, :] - (Lt[..., j, None, :] @ X)[..., 0, :]) \
            / L[..., j, j, None]
        X = X + (rows == j).to(Y.dtype)[:, None] * x[..., None, :]
    return X


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for symmetric positive-definite blocks: A (..., n,
    n), b (..., n) -> (..., n), through :func:`cholesky`."""
    L = cholesky(A)
    return _backward(L, _forward(L, b[..., None]))[..., 0]


def spd_inverse(A: torch.Tensor) -> torch.Tensor:
    """Inverse of symmetric positive-definite blocks (..., n, n):
    L^-T L^-1 from :func:`cholesky`."""
    L = cholesky(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    Li = _forward(L, eye.expand(A.shape))
    return Li.transpose(-1, -2) @ Li
