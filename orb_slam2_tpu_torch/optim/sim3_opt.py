"""Relative Sim3 optimization between two keyframes — port of
``orb_slam2_tpu/optim/sim3_opt.py`` (Optimizer::OptimizeSim3,
src/Optimizer.cc:985-1218).

Given matched map points of KF1 and KF2, optimize the similarity S12
(camera 2 -> camera 1) so that both reprojection directions agree:

  r1_i = proj(S12 . X2_i) - uv1_i,   r2_i = proj(S12^-1 . X1_i) - uv2_i

Huber(sqrt(10)), inlier pruning at chi2 > 10, then re-optimization.
7 parameters on the Sim3 exp chart, one keyframe pair.  The JAX package
takes the Jacobian by forward-mode autodiff in float32; the port takes
it by one batched central difference in float64 (:func:`_jacobian`, as
the pose graph's), with the two rounds run as programs (:func:`lm_round`)
replayed from CUDA graphs on the card.  ``torch.func.jacfwd`` captures
into a graph, but its first call in a process imports and registers
torch modules for seconds of host time (functorch's custom ops,
``torch.distributed``), which the first loop correction paid.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import graphs
from ..geom import sim3, smallsolve

CHI2_SIM3 = 10.0
# Extra Levenberg damping on the log-scale coordinate: a pure sigma step
# scales s and t together, a flat valley when the two cameras are close;
# damping caps each sigma step without moving the optimum (see the JAX
# module for the measurement behind it).
SCALE_DAMPING_W = 2.0e4


class Sim3OptResult(NamedTuple):
    S12: torch.Tensor        # (8,) optimized similarity
    inliers1: torch.Tensor   # (N,) bool (reprojection into image 1 ok)
    inliers2: torch.Tensor   # (N,) bool
    n_inliers: torch.Tensor


def _residuals(S12, pts1_c, pts2_c, uv1, uv2, fx, fy, cx, cy):
    """Both reprojection residuals (N, 2) of one Sim3 (8,), or (B, N, 2)
    of a batch (B, 8), and the depths."""
    g = S12.reshape(-1, 8)
    p2_in_1 = sim3.apply(g, pts2_c)
    p1_in_2 = sim3.apply(sim3.inv(g), pts1_c)
    if S12.dim() == 1:
        p2_in_1, p1_in_2 = p2_in_1[0], p1_in_2[0]

    def proj(pc):
        z = pc[..., 2]
        z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        return torch.stack([fx * pc[..., 0] / z + cx,
                            fy * pc[..., 1] / z + cy], -1)

    return (proj(p2_in_1) - uv1, proj(p1_in_2) - uv2,
            p2_in_1[..., 2], p1_in_2[..., 2])


_FD_STEP = 1e-4


def _jacobian(S12, w1, w2, pts1_c, pts2_c, uv1, uv2, fx, fy, cx, cy):
    """The weighted residuals' Jacobian (4N, 7) on the exp chart at S12,
    by one batched central difference in float64 (as the pose graph's
    ``_edge_jacobians``): with a step of 1e-4 the truncation error is
    ~1e-8 of the entries, below float32's resolution of the JAX
    package's autodiff result."""
    d = torch.eye(7, dtype=torch.float64, device=S12.device) * _FD_STEP
    S = sim3.compose(sim3.exp(torch.cat([d, -d])), S12.double()[None])
    r1, r2, _, _ = _residuals(S, pts1_c.double(), pts2_c.double(),
                              uv1.double(), uv2.double(), fx, fy, cx, cy)
    r = torch.cat([(r1 * w1.double()[:, None]).reshape(14, -1),
                   (r2 * w2.double()[:, None]).reshape(14, -1)], 1)
    return ((r[:7] - r[7:]) / (2 * _FD_STEP)).T.to(S12.dtype)


def _rho(c):
    return torch.where(c > CHI2_SIM3, 2 * torch.sqrt(c * CHI2_SIM3) - CHI2_SIM3,
                       c)


def _robust_w(c, isig, active):
    return torch.sqrt(isig * active * torch.where(
        c > CHI2_SIM3, torch.sqrt(CHI2_SIM3 / torch.clamp(c, min=1e-9)),
        torch.ones_like(c)))


def lm_round(S12, lam, active, pts1_cam, pts2_cam, uv1, uv2, inv_sigma2_1,
             inv_sigma2_2, fx: float, fy: float, cx: float, cy: float,
             iters: int, fix_scale: bool):
    """``iters`` LM iterations of a round of OptimizeSim3 over the
    ``active`` matches, from (S12, lam) (a round starts at lam = 1e-3).
    Returns (S12, lam, c1 <= chi2, c2 <= chi2) at the result: the
    per-match tests that the pruning between the rounds and the final
    inliers read."""

    def cost_and_state(S12):
        r1, r2, _, _ = _residuals(S12, pts1_cam, pts2_cam, uv1, uv2,
                                  fx, fy, cx, cy)
        c1 = (r1 * r1).sum(-1) * inv_sigma2_1
        c2 = (r2 * r2).sum(-1) * inv_sigma2_2
        cost = torch.where(active, _rho(c1) + _rho(c2),
                           torch.zeros_like(c1)).sum()
        return cost, (c1, c2)

    eye7 = torch.eye(7, dtype=S12.dtype, device=S12.device)
    # the log-scale coordinate (index 6), as masks: storing a Python
    # number into one element copies it from the host, which a CUDA
    # graph cannot hold
    pose6 = torch.arange(7, device=S12.device) < 6
    e66 = torch.diag((~pose6).to(S12.dtype))
    activef = active.to(S12.dtype)
    for _ in range(iters):
        # IRLS: robust weights frozen at the current iterate
        _, (c1c, c2c) = cost_and_state(S12)
        w1 = _robust_w(c1c, inv_sigma2_1, activef)
        w2 = _robust_w(c2c, inv_sigma2_2, activef)

        r1, r2, _, _ = _residuals(S12, pts1_cam, pts2_cam, uv1, uv2,
                                  fx, fy, cx, cy)
        r0 = torch.cat([(r1 * w1[:, None]).reshape(-1),
                        (r2 * w2[:, None]).reshape(-1)])
        J = _jacobian(S12, w1, w2, pts1_cam, pts2_cam, uv1, uv2,
                      fx, fy, cx, cy)                      # (4N, 7)
        H = J.T @ J + SCALE_DAMPING_W * e66
        g = J.T @ r0
        if fix_scale:
            H = torch.where(pose6[:, None] & pose6[None, :], H, 0.0) + e66
            g = torch.where(pose6, g, 0.0)
        Hd = (H + lam * torch.diag(torch.diag(H))
              + (1e-6 * torch.trace(H) / 7.0 + 1e-8) * eye7)
        # damped, so positive definite: a Cholesky solve in tensor ops
        # (torch.linalg.solve checks its result on the host)
        dx = -smallsolve.spd_solve(Hd, g)
        S_new = sim3.compose(sim3.exp(dx[None]), S12)[0]
        c_new, _ = cost_and_state(S_new)
        c_old, _ = cost_and_state(S12)
        ok = c_new < c_old
        S12 = torch.where(ok, S_new, S12)
        lam = torch.where(ok, lam * 0.5, lam * 4.0)
    _, (c1, c2) = cost_and_state(S12)
    return S12, lam, c1 <= CHI2_SIM3, c2 <= CHI2_SIM3


# LM iterations per replay within a round, (S12, lam) threaded: a whole
# round of the loop closer's 8
ROUND_CHUNK = 8

# the JAX package's jitted optimize_sim3, as a round program replayed
# from a CUDA graph on the card (on the CPU, the function itself); it
# looks the function up at each call
_round_graph = graphs.graphed(lambda *a: lm_round(*a), "sim3_round")


def optimize_sim3(S12_init, pts1_cam, pts2_cam, uv1, uv2,
                  inv_sigma2_1, inv_sigma2_2, valid,
                  fx: float, fy: float, cx: float, cy: float,
                  iters: int = 10, fix_scale: bool = False) -> Sim3OptResult:
    """Two rounds of ``iters`` LM iterations, the matches pruned between
    them as a tensor mask (src/Optimizer.cc:1126-1180).  Each round is
    ``ROUND_CHUNK`` iterations a replay of :func:`lm_round`'s CUDA graph,
    so nothing waits for the card until the caller reads the result."""
    geo = (pts1_cam, pts2_cam, uv1, uv2, inv_sigma2_1, inv_sigma2_2,
           float(fx), float(fy), float(cx), float(cy))

    def lm(S12, active):
        # a fill, not a copy of host data
        lam = torch.full((), 1e-3, dtype=S12.dtype, device=S12.device)
        done = 0
        while True:
            n = min(ROUND_CHUNK, iters - done)
            S12, lam, ok1, ok2 = _round_graph(S12, lam, active, *geo, n,
                                              bool(fix_scale))
            done += n
            if done >= iters:
                return S12, ok1, ok2

    S12, ok1, ok2 = lm(S12_init, valid)
    # prune and re-optimize (src/Optimizer.cc:1126-1180)
    S12, ok1, ok2 = lm(S12, valid & ok1 & ok2)
    in1 = valid & ok1
    in2 = valid & ok2
    return Sim3OptResult(S12=S12, inliers1=in1, inliers2=in2,
                         n_inliers=(in1 & in2).sum())
