"""SE(3) / SO(3) Lie-group operations, batched, in torch.

Port of the parts of ``orb_slam2_tpu/geom/se3.py`` that the Sim3,
Horn and bundle-adjustment modules call (Sophus::SE3d/SO3d and
g2o::SE3Quat of the reference, src/Converter.cc:30-225).

Conventions
-----------
- A pose is a 4x4 row-major homogeneous matrix ``T = [R t; 0 1]``;
  ``Tcw`` maps world -> camera (src/Frame.cc:231-273).
- Tangent vectors are ``xi = (upsilon, omega)``: translation part first,
  rotation part last (Sophus ordering).
- Everything broadcasts over leading batch axes, and every function
  supports forward-mode autodiff (the Sim3 optimizer takes its Jacobian
  with ``torch.func.jacfwd``).
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-8


def _eye(n: int, like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(shape)


def hat(omega: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta2 = (omega * omega).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    a = torch.sin(theta) / theta
    b = (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, a)
    b = torch.where(small, 0.5 - theta2 / 24.0, b)
    K = hat(omega)
    KK = K @ K
    return _eye(3, omega, K.shape) + a[..., None, None] * K \
        + b[..., None, None] * KK


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues: (..., 3, 3) -> (..., 3) axis-angle, robust near
    theta = 0 and theta = pi; the angle comes from atan2."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w_skew = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    sin_t = 0.5 * torch.sqrt((w_skew * w_skew).sum(-1) + _EPS * _EPS)
    theta = torch.atan2(sin_t, cos_t)
    small = theta < 1e-4
    sin_safe = torch.where(sin_t < 1e-6, torch.ones_like(sin_t), sin_t)
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * sin_safe))
    w_generic = scale[..., None] * w_skew
    # near-pi branch: axis^2 from the diagonal, signs from off-diagonals
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp((diag - cos_t[..., None])
                        / (1.0 - cos_t[..., None] + _EPS), 0.0, 1.0)
    axis = torch.sqrt(axis2 + 1e-12)
    one = torch.ones_like(trace)
    sx = torch.where(w_skew[..., 0].abs() > 1e-6, torch.sign(w_skew[..., 0]),
                     one)
    s01 = R[..., 0, 1] + R[..., 1, 0]
    s02 = R[..., 0, 2] + R[..., 2, 0]
    sy = torch.where(w_skew[..., 1].abs() > 1e-6, torch.sign(w_skew[..., 1]),
                     torch.where(s01.abs() > 1e-6, sx * torch.sign(s01), one))
    sz = torch.where(w_skew[..., 2].abs() > 1e-6, torch.sign(w_skew[..., 2]),
                     torch.where(s02.abs() > 1e-6, sx * torch.sign(s02), one))
    w_pi = theta[..., None] * axis * torch.stack([sx, sy, sz], dim=-1)
    near_pi = theta > (math.pi - 1e-3)
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _left_jacobian(omega: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian V(omega): integrates translation in SE(3) exp."""
    theta2 = (omega * omega).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    b = (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS)
    c = (theta - torch.sin(theta)) / (theta2 * theta + _EPS * _EPS * _EPS)
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0, b)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, c)
    K = hat(omega)
    KK = K @ K
    return _eye(3, omega, K.shape) + b[..., None, None] * K \
        + c[..., None, None] * KK


def exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential: (..., 6) tangent (upsilon, omega) -> (..., 4, 4)."""
    ups, omega = xi[..., :3], xi[..., 3:]
    R = so3_exp(omega)
    t = (_left_jacobian(omega) @ ups[..., None])[..., 0]
    return from_rt(R, t)


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from (..., 3, 3) and (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w), TUM/Sophus order -> rotation matrix."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (x, y, z, w), branch-free (Shepperd):
    four candidate constructions, the best by the largest diagonal-based
    magnitude."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 0.5

    qw0 = root(1.0 + tr)
    q0 = torch.stack([m21 - m12, m02 - m20, m10 - m01, 4.0 * qw0 * qw0],
                     -1) / (4.0 * qw0[..., None])
    qx1 = root(1.0 + m00 - m11 - m22)
    q1 = torch.stack([4.0 * qx1 * qx1, m01 + m10, m02 + m20, m21 - m12],
                     -1) / (4.0 * qx1[..., None])
    qy2 = root(1.0 - m00 + m11 - m22)
    q2 = torch.stack([m01 + m10, 4.0 * qy2 * qy2, m12 + m21, m02 - m20],
                     -1) / (4.0 * qy2[..., None])
    qz3 = root(1.0 - m00 - m11 + m22)
    q3 = torch.stack([m02 + m20, m12 + m21, 4.0 * qz3 * qz3, m10 - m01],
                     -1) / (4.0 * qz3[..., None])
    cands = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                         m22 - m00 - m11], dim=-1)
    best = torch.argmax(cands, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)            # (..., 4, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(qs, -2, idx)[..., 0, :]
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)
