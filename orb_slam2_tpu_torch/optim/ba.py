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

:func:`bundle_adjust` runs on one device as the JAX package's loop of LM
iterations: a program for the first linearization, then one per
``ITER_CHUNK`` iterations, then one for the classification at the
solution, each replayed from a CUDA graph on the card with the state
threaded from replay to replay.  The 6x6 preconditioner
blocks are inverted by a Cholesky factorization in tensor operations
(``geom/smallsolve.py``), and ``IndexSum`` takes its longest segments
from the caller's host layout, so nothing in a step waits for the card.

:func:`bundle_adjust_core` takes the JAX package's collective hooks:
``psum`` closes every camera-indexed sum and the cost over the shards of
an observation-sharded problem, ``psum_pt`` every point-indexed one
(``parallel/dist_ba.py``).  A hook takes a tensor or a tuple of tensors
and returns the same structure summed over the shards.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import graphs
from ..geom import se3, smallsolve
from . import reproj, segment
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


def _identity_psum(x):
    return x


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
               fx, fy, cx, cy, use_huber, psum, psum_pt):
    """``per_cam``, ``per_pt``: IndexSum over the observations' camera
    and point rows; ``psum`` / ``psum_pt`` close them over the shards."""
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
    # the cost is closed with the camera blocks, before any accept test
    # reads it: a shard deciding on its own cost would let the
    # replicated cameras diverge
    hcc, gc, cost = psum((per_cam(JcT_w @ Jc),
                          per_cam((JcT_w @ r[..., None])[..., 0]),
                          _rho(c2, z, obs_wf, use_huber).sum()))
    hpp, gp = psum_pt((per_pt(JpT_w @ Jp),
                       per_pt((JpT_w @ r[..., None])[..., 0])))
    return _Linearized(hcc=hcc, gc=gc, hpp=hpp, gp=gp, W=JcT_w @ Jp,
                       cost=cost)


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
                cg_iters, psum, psum_pt):
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
        return psum_pt(per_pt(
            (W.transpose(1, 2) @ x[obs_cam][..., None])[..., 0]))

    def Wt_z(z):       # per obs W z(point) -> scatter to cameras
        return psum(per_cam((W @ z[obs_pt][..., None])[..., 0]))

    def hinv(v):
        return (hpp_inv @ v[..., None])[..., 0]

    b = -(lin.gc - Wt_z(hinv(lin.gp))) * free[:, None]

    def S_matvec(x):
        out = (hcc_d @ x[..., None])[..., 0] - Wt_z(hinv(W_x(x)))
        return torch.where(free[:, None], out, x)

    # block-Jacobi preconditioner: the exact Schur diagonal blocks
    whw = psum(per_cam(W @ hpp_inv[obs_pt] @ W.transpose(1, 2)))
    S_diag = torch.where(free[:, None, None], hcc_d - whw,
                         eye6.expand(K, 6, 6))
    M_inv = smallsolve.spd_inverse(S_diag + 1e-8 * eye6)

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


class _Problem(NamedTuple):
    """What every LM iteration reads besides the state."""
    per_cam: IndexSum
    per_pt: IndexSum
    obs_uv: torch.Tensor
    obs_isig2: torch.Tensor
    obs_valid: torch.Tensor
    obs_wf: torch.Tensor
    fixed_cam: torch.Tensor
    cam: tuple              # (fx, fy, cx, cy)
    cg_iters: int
    use_huber: bool
    psum: Callable
    psum_pt: Callable


def _problem(n_cams, n_pts, obs_cam, obs_pt, obs_uv, obs_isig2, obs_valid,
             fixed_cam, fx, fy, cx, cy, cg_iters, use_huber, psum, psum_pt,
             longest_cam=None, longest_pt=None) -> _Problem:
    return _Problem(
        per_cam=IndexSum(obs_cam.long(), n_cams, longest=longest_cam),
        per_pt=IndexSum(obs_pt.long(), n_pts, longest=longest_pt),
        obs_uv=obs_uv, obs_isig2=obs_isig2, obs_valid=obs_valid,
        obs_wf=obs_valid.to(obs_uv.dtype), fixed_cam=fixed_cam,
        cam=(fx, fy, cx, cy), cg_iters=cg_iters, use_huber=use_huber,
        psum=psum, psum_pt=psum_pt if psum_pt is not None else psum)


def _lin_at(prob: _Problem, cam, pts) -> _Linearized:
    return _linearize(cam, pts, prob.per_cam, prob.per_pt, prob.obs_uv,
                      prob.obs_isig2, prob.obs_wf, *prob.cam,
                      prob.use_huber, prob.psum, prob.psum_pt)


def _lm_iteration(prob: _Problem, cam, pts, lin: _Linearized, lam):
    """One LM iteration (the body of the JAX package's ``fori_loop``):
    (cam, pts, lin, lam) -> the same, accepted or rejected."""
    dc, dp = _solve_step(lin, prob.per_cam, prob.per_pt, lam, prob.fixed_cam,
                         prob.cg_iters, prob.psum, prob.psum_pt)
    cam_new = se3.exp(dc) @ cam
    pts_new = pts + dp
    lin_new = _lin_at(prob, cam_new, pts_new)
    accept = lin_new.cost < lin.cost
    cam = torch.where(accept, cam_new, cam)
    pts = torch.where(accept, pts_new, pts)
    lin = _Linearized(*(torch.where(accept, a, b)
                        for a, b in zip(lin_new, lin)))
    lam = torch.where(accept, lam * 0.5, lam * 4.0)
    return cam, pts, lin, lam


def _finish(prob: _Problem, cam, pts) -> BAResult:
    """The final classification at the solution."""
    res = reproj.project_jacobians(cam[prob.per_cam.idx],
                                   pts[prob.per_pt.idx], prob.obs_uv,
                                   *prob.cam)
    c2 = reproj.chi2(res.r, prob.obs_isig2)
    inlier = prob.obs_valid & (c2 <= CHI2_MONO) & (res.depth > 0)
    return BAResult(cam_Tcw=cam, points=pts, obs_inlier=inlier,
                    final_cost=prob.psum(_rho(c2, res.depth, prob.obs_wf,
                                              prob.use_huber).sum()))


def _lam0(points):
    # a fill, not a copy of host data: a CUDA graph replays it
    return torch.full((), 1e-4, dtype=points.dtype, device=points.device)


def bundle_adjust_core(cam_Tcw, points, obs_cam, obs_pt, obs_uv,
                       obs_isig2, obs_valid, fixed_cam, fx: float,
                       fy: float, cx: float, cy: float, iters: int = 10,
                       cg_iters: int = 20, use_huber: bool = True,
                       psum: Callable = _identity_psum,
                       psum_pt: Callable | None = None) -> BAResult:
    """LM iteration loop shared by the single-device and the sharded BA,
    in one call.

    ``psum`` closes the camera-indexed sums and the cost over the shards
    of an observation-sharded problem; ``psum_pt`` the point-indexed
    ones: the identity when each shard holds its points' whole state
    (``distributed_bundle_adjust_sharded_points``); defaults to
    ``psum``."""
    prob = _problem(cam_Tcw.shape[0], points.shape[0], obs_cam, obs_pt,
                    obs_uv, obs_isig2, obs_valid, fixed_cam, fx, fy, cx, cy,
                    cg_iters, use_huber, psum, psum_pt)
    cam, pts = cam_Tcw, points
    lin = _lin_at(prob, cam, pts)
    lam = _lam0(points)
    for _ in range(iters):
        cam, pts, lin, lam = _lm_iteration(prob, cam, pts, lin, lam)
    return _finish(prob, cam, pts)


# LM iterations per replay of the step program.  The loop-closing and
# initialization solves run once per problem, so the first call, which
# warms up and captures, is most of their cost: one iteration a chunk
# keeps its eager warm-up to one iteration (a whole 10-iteration call
# would warm up for 10), and the replays cost what a longer chunk's
# would.
ITER_CHUNK = 1


def _ba_begin(cam, pts, obs_cam, obs_pt, obs_uv, obs_isig2, obs_valid,
              fixed_cam, fx, fy, cx, cy, use_huber, longest_cam,
              longest_pt):
    """The first linearization and damping: (lam, *lin)."""
    prob = _problem(cam.shape[0], pts.shape[0], obs_cam, obs_pt, obs_uv,
                    obs_isig2, obs_valid, fixed_cam, fx, fy, cx, cy, 0,
                    use_huber, _identity_psum, None, longest_cam,
                    longest_pt)
    return (_lam0(pts), *_lin_at(prob, cam, pts))


def _ba_step(cam, pts, lam, hcc, gc, hpp, gp, W, cost, obs_cam, obs_pt,
             obs_uv, obs_isig2, obs_valid, fixed_cam, fx, fy, cx, cy,
             iters, cg_iters, use_huber, longest_cam, longest_pt):
    """``iters`` LM iterations from a threaded state: (cam, pts, lam,
    *lin)."""
    prob = _problem(cam.shape[0], pts.shape[0], obs_cam, obs_pt, obs_uv,
                    obs_isig2, obs_valid, fixed_cam, fx, fy, cx, cy,
                    cg_iters, use_huber, _identity_psum, None, longest_cam,
                    longest_pt)
    lin = _Linearized(hcc, gc, hpp, gp, W, cost)
    for _ in range(iters):
        cam, pts, lin, lam = _lm_iteration(prob, cam, pts, lin, lam)
    return (cam, pts, lam, *lin)


def _ba_finish(cam, pts, obs_cam, obs_pt, obs_uv, obs_isig2, obs_valid,
               fx, fy, cx, cy, use_huber, longest_cam, longest_pt):
    """The classification at the solution: (obs_inlier, final_cost)."""
    prob = _problem(cam.shape[0], pts.shape[0], obs_cam, obs_pt, obs_uv,
                    obs_isig2, obs_valid, None, fx, fy, cx, cy, 0,
                    use_huber, _identity_psum, None, longest_cam,
                    longest_pt)
    res = _finish(prob, cam, pts)
    return res.obs_inlier, res.final_cost


# the JAX package's jitted bundle_adjust, as three programs replayed from
# CUDA graphs on the card (on the CPU, the functions themselves); each
# looks its function up at each call
_begin_graph = graphs.graphed(lambda *a: _ba_begin(*a), "ba_begin")
_step_graph = graphs.graphed(lambda *a: _ba_step(*a), "ba_step")
_finish_graph = graphs.graphed(lambda *a: _ba_finish(*a), "ba_finish")


def _longest_of(idx, n: int) -> int:
    """``segment.longest_segment`` of a device index vector: read back
    once, outside the graphs, where the caller gives no host count."""
    return segment.longest_segment(idx.cpu().numpy(), n)


def bundle_adjust(cam_Tcw, points, obs_cam, obs_pt, obs_uv, obs_isig2,
                  obs_valid, fixed_cam, fx: float, fy: float, cx: float,
                  cy: float, iters: int = 10, cg_iters: int = 20,
                  use_huber: bool = True, longest_cam: int | None = None,
                  longest_pt: int | None = None) -> BAResult:
    """Single-device full BA.  cam_Tcw (K, 4, 4), points (P, 3), obs_*
    (O,) per observation (camera row, point row, uv, 1/sigma^2, valid),
    fixed_cam (K,) bool.  ``longest_cam`` / ``longest_pt``: the most
    observations of one camera / point row, from the host layout
    (``segment.longest_segment``); read back here where not given.

    Runs as the JAX package's loop of LM iterations: the first
    linearization, then ``ITER_CHUNK`` iterations a step with (cam,
    points, the linearization, lam) threaded from step to step, then
    the classification at the solution, each a CUDA graph replay on the
    card, so the iteration count and the op order are
    :func:`bundle_adjust_core`'s and nothing waits for the card until
    the caller reads the result."""
    K, P = cam_Tcw.shape[0], points.shape[0]
    if longest_cam is None:
        longest_cam = _longest_of(obs_cam, K)
    if longest_pt is None:
        longest_pt = _longest_of(obs_pt, P)
    longest_cam = min(int(longest_cam), segment.LONG_SEGMENTS + 1)
    longest_pt = min(int(longest_pt), segment.LONG_SEGMENTS + 1)
    fx, fy, cx, cy = float(fx), float(fy), float(cx), float(cy)
    use_huber = bool(use_huber)
    obs = (obs_cam, obs_pt, obs_uv, obs_isig2, obs_valid)
    lam, *lin = _begin_graph(cam_Tcw, points, *obs, fixed_cam, fx, fy, cx,
                             cy, use_huber, longest_cam, longest_pt)
    cam, pts = cam_Tcw, points
    for done in range(0, iters, ITER_CHUNK):
        cam, pts, lam, *lin = _step_graph(
            cam, pts, lam, *lin, *obs, fixed_cam, fx, fy, cx, cy,
            min(ITER_CHUNK, iters - done), int(cg_iters), use_huber,
            longest_cam, longest_pt)
    inlier, cost = _finish_graph(cam, pts, *obs, fx, fy, cx, cy, use_huber,
                                 longest_cam, longest_pt)
    return BAResult(cam_Tcw=cam, points=pts, obs_inlier=inlier,
                    final_cost=cost)
