"""Sim(3) similarity transforms, batched, in torch.

Port of ``orb_slam2_tpu/geom/sim3.py`` (g2o::Sim3, used for loop
correction, src/LoopClosing.cc:497-597, and the 7-DoF essential-graph
optimization, src/Optimizer.cc:654-983).

A Sim3 is a flat vector ``g = (q[4 xyzw], t[3], s[1])`` of shape
(..., 8), acting on points as ``x' = s * R(q) @ x + t``.  Tangent
ordering ``(upsilon, omega, sigma)`` (translation, rotation,
log-scale), 7-dim.
"""
from __future__ import annotations

import torch

from . import se3
from .smallsolve import solve3x3

_EPS = 1e-8


def make(R: torch.Tensor, t: torch.Tensor, s) -> torch.Tensor:
    """Pack rotation (..., 3, 3), translation (..., 3), scale (...)."""
    q = se3.rot_to_quat(R)
    s = torch.as_tensor(s, dtype=t.dtype, device=t.device)
    batch = se3.broadcast(q.shape[:-1], t.shape[:-1], s.shape)
    return torch.cat([q.expand(batch + (4,)), t.expand(batch + (3,)),
                      s.expand(batch)[..., None]], dim=-1)


def identity(dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.tensor([0, 0, 0, 1, 0, 0, 0, 1], dtype=dtype, device=device)


def rot(g: torch.Tensor) -> torch.Tensor:
    return se3.quat_to_rot(g[..., :4])


def trans(g: torch.Tensor) -> torch.Tensor:
    return g[..., 4:7]


def scale(g: torch.Tensor) -> torch.Tensor:
    return g[..., 7]


def from_se3(T: torch.Tensor, s=1.0) -> torch.Tensor:
    """Lift an SE(3) matrix to Sim(3) with the given scale (default 1)."""
    return make(T[..., :3, :3], T[..., :3, 3], s)


def to_se3(g: torch.Tensor) -> torch.Tensor:
    """Project to SE(3) by folding scale into translation: [R, t/s]
    (the reference's SE3 write-back, src/LoopClosing.cc:565-571,
    src/Optimizer.cc:944-953)."""
    return se3.from_rt(rot(g), trans(g) / scale(g)[..., None])


def apply(g: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Act on points (..., N, 3): s R x + t."""
    R = rot(g)
    return scale(g)[..., None, None] * (pts @ R.transpose(-1, -2)) \
        + trans(g)[..., None, :]


def apply_one(g: torch.Tensor, pt: torch.Tensor) -> torch.Tensor:
    R = rot(g)
    return scale(g)[..., None] * (R @ pt[..., None])[..., 0] + trans(g)


def compose(ga: torch.Tensor, gb: torch.Tensor) -> torch.Tensor:
    """Group product: (ga*gb)(x) = ga(gb(x))."""
    Ra, ta, sa = rot(ga), trans(ga), scale(ga)
    Rb, tb, sb = rot(gb), trans(gb), scale(gb)
    R = Ra @ Rb
    t = sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta
    return make(R, t, sa * sb)


def inv(g: torch.Tensor) -> torch.Tensor:
    R, t, s = rot(g), trans(g), scale(g)
    Rt = R.transpose(-1, -2)
    tinv = -(Rt @ t[..., None])[..., 0] / s[..., None]
    return make(Rt, tinv, 1.0 / s)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """Sim(3) exponential map, tangent ordering (upsilon, omega, sigma):
    R = exp(omega), s = e^sigma, t = W upsilon with the closed-form W
    (Strasdat's thesis / Sophus sim3)."""
    ups, omega, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = se3.so3_exp(omega)
    s = torch.exp(sigma)
    theta2 = (omega * omega).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = se3.hat(omega)
    KK = K @ K
    eye = se3._eye(3, xi, K.shape)

    sig_small = sigma.abs() < 1e-5
    th_small = theta2 < 1e-8
    sig_safe = torch.where(sig_small, torch.ones_like(sigma), sigma)

    C = torch.where(sig_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                    (s - 1.0) / sig_safe)
    # both sigma and theta generic
    a_gen = s * torch.sin(theta)
    b_gen = s * torch.cos(theta)
    ts2 = theta2 + sigma * sigma
    c_gen = torch.where(ts2 < 1e-12, torch.ones_like(ts2), ts2)
    A_ll = (a_gen * sigma + (1.0 - b_gen) * theta) / (theta * c_gen)
    B_ll = (C - ((b_gen - 1.0) * sigma + a_gen * theta) / c_gen) \
        / (theta2 + _EPS * _EPS)
    # sigma ~ 0, theta generic: the SE(3) left Jacobian
    A_sl = (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS)
    B_sl = (theta - torch.sin(theta)) / (theta2 * theta + _EPS)
    # theta ~ 0, sigma generic: A = int u e^{su} du, B = int u^2/2 e^{su} du
    A_ls = torch.where(sig_small, torch.full_like(sigma, 0.5),
                       ((sigma - 1.0) * s + 1.0) / (sig_safe * sig_safe))
    B_ls = torch.where(sig_small, torch.full_like(sigma, 1.0 / 6.0),
                       (s * (sigma * sigma - 2.0 * sigma + 2.0) - 2.0)
                       / (2.0 * sig_safe ** 3))

    A = torch.where(th_small, A_ls, torch.where(sig_small, A_sl, A_ll))
    B = torch.where(th_small, B_ls, torch.where(sig_small, B_sl, B_ll))

    W = A[..., None, None] * K + B[..., None, None] * KK \
        + C[..., None, None] * eye
    t = (W @ ups[..., None])[..., 0]
    return make(R, t, s)


def log(g: torch.Tensor) -> torch.Tensor:
    """Sim(3) log map -> (upsilon, omega, sigma), (..., 7): W rebuilt by
    pushing the tangent basis through exp, then W upsilon = t solved in
    closed form."""
    R, t, s = rot(g), trans(g), scale(g)
    omega = se3.so3_log(R)
    sigma = torch.log(s)

    def w_col(e):
        xi = torch.cat([e.expand(omega.shape), omega, sigma[..., None]], -1)
        return trans(exp(xi))

    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    W = torch.stack([w_col(eye[0]), w_col(eye[1]), w_col(eye[2])], dim=-1)
    # closed form (adjugate over determinant): torch.linalg.solve checks
    # its result on the host, which a CUDA graph cannot hold
    ups = solve3x3(W, t)
    return torch.cat([ups, omega, sigma[..., None]], dim=-1)
