"""Closed-form batched 3x3 solves, in torch.

Port of ``orb_slam2_tpu/geom/smallsolve.py``: the adjugate inverse is
exact, branch-free, and one elementwise pass over a whole batch of tiny
systems.
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
