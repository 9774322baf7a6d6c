"""Horn's 1987 closed-form similarity from point correspondences,
batched — port of ``orb_slam2_tpu/geom/horn.py``.

Replaces Sim3Solver::ComputeSim3 (src/Sim3Solver.cc:327-453): centroids,
M = Pr1 @ Pr2^T, the symmetric 4x4 N matrix, rotation from its top
eigenvector, scale from the projection ratio, translation closing the
loop.  Batched over the leading axis, so a whole RANSAC hypothesis set
is solved at once.  The JAX package takes the eigenvector from ``eigh``;
on the card ``torch.linalg.eigh`` checks its result on the host, which a
CUDA graph cannot hold, so the port runs a fixed number of cyclic Jacobi
sweeps in tensor operations there (:func:`top_eigvec`).  The eigenvector
fixes the quaternion only up to sign; the rotation it gives is unique.
"""
from __future__ import annotations

import torch

from . import jacobi, se3, sim3 as sim3_mod


# cyclic Jacobi (``jacobi.sym_eigh``): convergence is quadratic; 6
# sweeps hold the top eigenvector to eigh's within 1e-6 on
# tests/test_torch_loop_graphs.py's blocks
JACOBI_SWEEPS = 6


def sym4_top_eigvec(N: torch.Tensor, sweeps: int = JACOBI_SWEEPS):
    """The unit eigenvector of the largest eigenvalue of symmetric 4x4
    blocks (..., 4, 4), by cyclic Jacobi rotations
    (:func:`jacobi.sym_eigh`): (..., 4), of either sign.  The last
    column of ``eigh``'s eigenvectors, where the largest eigenvalue is
    simple."""
    return jacobi.sym_eigh(N, sweeps)[1][..., -1]


def top_eigvec(N: torch.Tensor) -> torch.Tensor:
    """The top unit eigenvector of symmetric 4x4 blocks, of either sign.
    On the card: :func:`sym4_top_eigvec` in float64 (cuSOLVER's ``eigh``
    checks its result on the host, which a CUDA graph cannot hold).  On
    the CPU: LAPACK's ``eigh``, the JAX package's own routine there,
    NaN for a block with a non-finite entry, as ``jnp.linalg.eigh``
    gives it (:func:`jacobi.lapack_eigh`).  A
    minimal 3-point sample's N can have a small eigengap, where float32
    LAPACK lands 1.3e-5 (in the translation) from the float64 answer;
    the CPU parity tests hold the port to the JAX package at 1e-5, so
    they see LAPACK's rounding, and hold the Jacobi sweeps to both
    within their own bar (``tests/test_torch_loop_graphs.py``)."""
    if N.is_cuda:
        return sym4_top_eigvec(N.double()).to(N.dtype)
    return jacobi.lapack_eigh(N)[1][..., -1]


def horn_sim3(p1: torch.Tensor, p2: torch.Tensor,
              weights: torch.Tensor | None = None,
              fix_scale: bool = False) -> torch.Tensor:
    """Solve min_{s,R,t} sum_i w_i |p1_i - (s R p2_i + t)|^2.

    p1, p2: (..., N, 3) corresponding points (camera-1 and camera-2
    frames: the result maps frame 2 into frame 1, T12).  Returns a Sim3
    (..., 8).  ``fix_scale`` pins s = 1 (src/Sim3Solver.cc:41)."""
    if weights is None:
        weights = torch.ones(p1.shape[:-1], dtype=p1.dtype, device=p1.device)
    wsum = weights.sum(-1, keepdim=True) + 1e-12
    w = (weights / wsum)[..., None]

    c1 = (p1 * w).sum(-2, keepdim=True)
    c2 = (p2 * w).sum(-2, keepdim=True)
    q1 = p1 - c1
    q2 = p2 - c2

    # correlation with "left" = q2, "right" = q1, so the quaternion
    # rotates set 2 into set 1 (M = Pr2 * Pr1^t, src/Sim3Solver.cc:347-352)
    M = (q2 * w).transpose(-1, -2) @ q1
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]

    # Horn's symmetric 4x4 N matrix (quaternion order w, x, y, z)
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    q_wxyz = top_eigvec(N)               # the largest eigenvalue's
    q_xyzw = torch.cat([q_wxyz[..., 1:4], q_wxyz[..., 0:1]], dim=-1)
    R = se3.quat_to_rot(q_xyzw)

    # s = sum w q1 . (R q2) / sum w |q2|^2 (src/Sim3Solver.cc:416-432)
    Rq2 = q2 @ R.transpose(-1, -2)
    num = ((q1 * Rq2).sum(-1) * weights / wsum).sum(-1)
    den = ((q2 * q2).sum(-1) * weights / wsum).sum(-1) + 1e-12
    s = num / den
    if fix_scale:
        s = torch.ones_like(s)

    t = c1[..., 0, :] - s[..., None] * (R @ c2[..., 0, :, None])[..., 0]
    return sim3_mod.make(R, t, s)
