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

The solver is written once, as a phased program (:func:`_program`):
steps on a dict of named tensors, cut by ``graphs.Collective`` items
where the JAX package's ``psum`` closes a camera-indexed sum or a cost
and its ``psum_pt`` a point-indexed sum.  Every form runs those steps in
that order: :func:`bundle_adjust_core` eagerly in one call with the
caller's hooks (a hook takes a tuple of tensors and returns their sums
over the shards), the single-device programs with the identity inside
one graph each, and :func:`bundle_adjust_shard` as one shard's chain of
CUDA graphs cut at the collectives (``parallel/dist_ba.py``), so all
three agree bit for bit where their sums do.
"""
from __future__ import annotations

import itertools
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import graphs
from ..geom import se3, smallsolve
from ..graphs import Collective
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


# the linearization's entries, in the JAX package's _Linearized order
LIN = ("hcc", "gc", "hpp", "gp", "W", "cost")


class _Cfg(NamedTuple):
    """A phased BA's static arguments."""
    n_cams: int
    n_pts: int
    cam: tuple              # (fx, fy, cx, cy)
    use_huber: bool
    longest_cam: int | None
    longest_pt: int | None


def _rho(c2, z, obs_wf, use_huber):
    rho = torch.where(c2 > CHI2_MONO,
                      2.0 * torch.sqrt(c2 * CHI2_MONO) - CHI2_MONO,
                      c2) if use_huber else c2
    return torch.where(obs_wf > 0,
                       torch.where(z > 0, rho,
                                   torch.full_like(rho, INVALID_DEPTH_PENALTY)),
                       torch.zeros_like(rho))


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


def _lam0(points):
    # a fill, not a copy of host data: a CUDA graph replays it
    return torch.full((), 1e-4, dtype=points.dtype, device=points.device)


# ----------------------------------------------------------------------
# The solver as a phased program (graphs.run_eager / graphs.Chain): steps
# st, cfg -> {entry: tensor} on the state ``st``, cut by the collectives
# where the JAX package's psum ("cam": camera-indexed sums and costs)
# and psum_pt ("pt": point-indexed sums) close a sum over the shards.
# Every form runs these steps in this order: the one-call core, the
# single-device graphs and the sharded chains.
# ----------------------------------------------------------------------

def _sums(st, cfg):
    """The observations' sums over cameras and over points."""
    lay_c, lay_p = st.get("cam_order"), st.get("pt_order")
    return (IndexSum(st["oc"], cfg.n_cams, cfg.longest_cam,
                     None if lay_c is None else (lay_c, st["cam_starts"])),
            IndexSum(st["op"], cfg.n_pts, cfg.longest_pt,
                     None if lay_p is None else (lay_p, st["pt_starts"])))


def _hinv(hpp_inv, v):
    return (hpp_inv @ v[..., None])[..., 0]


def _free(st):
    return ~st["fixed_cam"]


def _setup(st, cfg):
    """The observation rows as long indices, their weights and (on the
    card) the sort layouts of every sum."""
    oc, op = st["obs_cam"].long(), st["obs_pt"].long()
    out = dict(oc=oc, op=op, wf=st["obs_valid"].to(st["obs_uv"].dtype))
    if oc.is_cuda:
        out["cam_order"], out["cam_starts"] = segment.sort_layout(
            oc, cfg.n_cams)
        out["pt_order"], out["pt_starts"] = segment.sort_layout(
            op, cfg.n_pts)
    return out


def _linearize(cam, pts, st, cfg):
    """This shard's part of the normal equations at (cam, pts): the
    camera and point blocks and the cost, each still to be summed over
    the shards, and the local W blocks."""
    per_cam, per_pt = _sums(st, cfg)
    obs_isig2, obs_wf = st["obs_isig2"], st["wf"]
    res = reproj.project_jacobians(cam[st["oc"]], pts[st["op"]],
                                   st["obs_uv"], *cfg.cam)
    r, z = res.r, res.depth
    c2 = reproj.chi2(r, obs_isig2)
    w = obs_isig2 * (reproj.huber_weight(c2, CHI2_MONO) if cfg.use_huber
                     else 1.0)
    w = w * obs_wf * (z > 0)
    Jc, Jp = res.J_pose, res.J_point
    JcT_w = Jc.transpose(1, 2) * w[:, None, None]          # (O, 6, 2)
    JpT_w = Jp.transpose(1, 2) * w[:, None, None]          # (O, 3, 2)
    # the cost is closed with the camera blocks, before any accept test
    # reads it: a shard deciding on its own cost would let the
    # replicated cameras diverge
    return dict(hcc=per_cam(JcT_w @ Jc),
                gc=per_cam((JcT_w @ r[..., None])[..., 0]),
                cost=_rho(c2, z, obs_wf, cfg.use_huber).sum(),
                hpp=per_pt(JpT_w @ Jp),
                gp=per_pt((JpT_w @ r[..., None])[..., 0]),
                W=JcT_w @ Jp)


def _begin_lin(st, cfg):
    """The first linearization and damping."""
    return dict(_linearize(st["cam"], st["pts"], st, cfg),
                lam=_lam0(st["pts"]))


def _damp(st, cfg):
    """The damped blocks, Hpp^-1, and the partials of W Hpp^-1 gp (the
    right-hand side) and of the exact Schur diagonal."""
    hcc, hpp, W, lam = st["hcc"], st["hpp"], st["W"], st["lam"]
    eye6 = torch.eye(6, dtype=hcc.dtype, device=hcc.device)
    eye3 = torch.eye(3, dtype=hcc.dtype, device=hcc.device)
    # trace-scaled damping
    tr6 = torch.diagonal(hcc, dim1=-2, dim2=-1).sum(-1)
    hcc_d = hcc + (lam * torch.clamp(tr6 / 6.0, min=1e-6)
                   + 1e-8)[:, None, None] * eye6
    tr3 = torch.diagonal(hpp, dim1=-2, dim2=-1).sum(-1)
    hpp_d = hpp + (lam * torch.clamp(tr3 / 3.0, min=1e-6)
                   + 1e-8)[:, None, None] * eye3
    hpp_inv = _inv3_sym(hpp_d)
    per_cam, _ = _sums(st, cfg)
    op = st["op"]
    return dict(hcc_d=hcc_d, hpp_inv=hpp_inv,
                wtz=per_cam((W @ _hinv(hpp_inv, st["gp"])[op][..., None])
                            [..., 0]),
                whw=per_cam(W @ hpp_inv[op] @ W.transpose(1, 2)))


def _precond(st, cfg):
    """The reduced right-hand side and the block-Jacobi preconditioner
    (the exact Schur diagonal blocks); PCG starts at x = 0."""
    hcc_d = st["hcc_d"]
    K = hcc_d.shape[0]
    free = _free(st)
    eye6 = torch.eye(6, dtype=hcc_d.dtype, device=hcc_d.device)
    b = -(st["gc"] - st["wtz"]) * free[:, None]
    S_diag = torch.where(free[:, None, None], hcc_d - st["whw"],
                         eye6.expand(K, 6, 6))
    x = torch.zeros_like(b)
    return dict(b=b, M_inv=smallsolve.spd_inverse(S_diag + 1e-8 * eye6),
                x=x, v=x)


def _mv_start(st, cfg):
    """The matvec S v, first half: W^T v, scattered to the points."""
    _, per_pt = _sums(st, cfg)
    return dict(wx=per_pt((st["W"].transpose(1, 2)
                           @ st["v"][st["oc"]][..., None])[..., 0]))


def _mv_mid(st, cfg):
    """The matvec's second half: W Hpp^-1 (W^T v), scattered to the
    cameras."""
    per_cam, _ = _sums(st, cfg)
    return dict(wtz=per_cam((st["W"] @ _hinv(st["hpp_inv"], st["wx"])
                             [st["op"]][..., None])[..., 0]))


def _s_matvec(st, v):
    """S v from the summed second half (``wtz``)."""
    out = (st["hcc_d"] @ v[..., None])[..., 0] - st["wtz"]
    return torch.where(_free(st)[:, None], out, v)


def _precondition(st, r):
    return (st["M_inv"] @ r[..., None])[..., 0]


def _cg_init(st, cfg):
    r = st["b"] - _s_matvec(st, st["x"])
    z = _precondition(st, r)
    return dict(r=r, z=z, p=z, v=z)


def _cg_update(st, cfg):
    """One PCG step, from the matvec S p."""
    x, r, z, p = st["x"], st["r"], st["z"], st["p"]
    Sp = _s_matvec(st, p)
    rz = (r * z).sum()
    alpha = rz / torch.clamp((p * Sp).sum(), min=1e-20)
    x = x + alpha * p
    r = r - alpha * Sp
    z = _precondition(st, r)
    beta = (r * z).sum() / torch.clamp(rz, min=1e-20)
    p = z + beta * p
    return dict(x=x, r=r, z=z, p=p, v=p)


def _delta(st, cfg):
    """The camera step and the partial of W^T delta_c at the points."""
    x = st["x"]
    dc = torch.where(_free(st)[:, None], x, torch.zeros_like(x))
    _, per_pt = _sums(st, cfg)
    return dict(dc=dc, wx=per_pt((st["W"].transpose(1, 2)
                                  @ dc[st["oc"]][..., None])[..., 0]))


def _try_step(st, cfg):
    """The point step, the candidate state and its linearization."""
    dp = _hinv(st["hpp_inv"], -(st["gp"] + st["wx"]))
    cam_new = se3.exp(st["dc"]) @ st["cam"]
    pts_new = st["pts"] + dp
    lin = _linearize(cam_new, pts_new, st, cfg)
    return dict(cam_new=cam_new, pts_new=pts_new,
                **{"n_" + k: v for k, v in lin.items()})


def _accept(st, cfg):
    """Keep the candidate where its (summed) cost is lower; damp."""
    accept = st["n_cost"] < st["cost"]
    out = dict(cam=torch.where(accept, st["cam_new"], st["cam"]),
               pts=torch.where(accept, st["pts_new"], st["pts"]))
    out.update({k: torch.where(accept, st["n_" + k], st[k]) for k in LIN})
    lam = st["lam"]
    out["lam"] = torch.where(accept, lam * 0.5, lam * 4.0)
    return out


def _finish(st, cfg):
    """The classification at the solution and its cost's partial."""
    res = reproj.project_jacobians(st["cam"][st["oc"]], st["pts"][st["op"]],
                                   st["obs_uv"], *cfg.cam)
    c2 = reproj.chi2(res.r, st["obs_isig2"])
    return dict(inlier=st["obs_valid"] & (c2 <= CHI2_MONO) & (res.depth > 0),
                final_cost=_rho(c2, res.depth, st["wf"],
                                cfg.use_huber).sum())


def _begin_program():
    yield _setup
    yield _begin_lin
    yield Collective("cam", ("hcc", "gc", "cost"))
    yield Collective("pt", ("hpp", "gp"))


def _matvec():
    yield _mv_start
    yield Collective("pt", ("wx",))
    yield _mv_mid
    yield Collective("cam", ("wtz",))


def _iteration_program(cg_iters: int):
    """One LM iteration (the body of the JAX package's ``fori_loop``):
    a damped Schur + PCG solve, the candidate's linearization, the
    accept test.  A rejected step keeps the carried system and damps
    more."""
    yield _damp
    yield Collective("cam", ("wtz",))
    yield Collective("cam", ("whw",))
    yield _precond
    yield from _matvec()
    yield _cg_init
    for _ in range(cg_iters):
        yield from _matvec()
        yield _cg_update
    yield _delta
    yield Collective("pt", ("wx",))
    yield _try_step
    yield Collective("cam", ("n_hcc", "n_gc", "n_cost"))
    yield Collective("pt", ("n_hpp", "n_gp"))
    yield _accept


def _finish_program():
    yield _finish
    yield Collective("cam", ("final_cost",))


def _program(iters: int, cg_iters: int):
    yield from _begin_program()
    for _ in range(iters):
        yield from _iteration_program(cg_iters)
    yield from _finish_program()


def collectives(iters: int, cg_iters: int, shard_points: bool) -> int:
    """The collectives of a sharded solve: ``1 + iters (cg_iters + 4) +
    1`` with the points sharded (the point sums are the identity), ``2 +
    iters (2 cg_iters + 7) + 1`` with the observations sharded."""
    return sum(isinstance(item, Collective)
               and not (shard_points and item.kind == "pt")
               for item in _program(iters, cg_iters))


_IDENTITY = {"cam": None, "pt": None}


def _inputs(cam, pts, obs_cam, obs_pt, obs_uv, obs_isig2, obs_valid,
            fixed_cam=None) -> dict:
    st = dict(cam=cam, pts=pts, obs_cam=obs_cam, obs_pt=obs_pt,
              obs_uv=obs_uv, obs_isig2=obs_isig2, obs_valid=obs_valid)
    if fixed_cam is not None:
        st["fixed_cam"] = fixed_cam
    return st


def _result(st) -> BAResult:
    return BAResult(cam_Tcw=st["cam"], points=st["pts"],
                    obs_inlier=st["inlier"], final_cost=st["final_cost"])


def bundle_adjust_core(cam_Tcw, points, obs_cam, obs_pt, obs_uv,
                       obs_isig2, obs_valid, fixed_cam, fx: float,
                       fy: float, cx: float, cy: float, iters: int = 10,
                       cg_iters: int = 20, use_huber: bool = True,
                       psum: Callable = _identity_psum,
                       psum_pt: Callable | None = None,
                       longest_cam: int | None = None,
                       longest_pt: int | None = None) -> BAResult:
    """LM iteration loop shared by the single-device and the sharded BA,
    in one eager call: the phased program with ``psum`` at its
    collectives.

    ``psum`` closes the camera-indexed sums and the cost over the shards
    of an observation-sharded problem; ``psum_pt`` the point-indexed
    ones: the identity when each shard holds its points' whole state
    (``distributed_bundle_adjust_sharded_points``); defaults to
    ``psum``.  ``longest_cam`` / ``longest_pt``: as
    :func:`bundle_adjust_shard`'s; read back once where not given."""
    K, P = cam_Tcw.shape[0], points.shape[0]
    cfg = _Cfg(K, P, (fx, fy, cx, cy), use_huber,
               _longest(longest_cam, obs_cam, K),
               _longest(longest_pt, obs_pt, P))
    st = graphs.run_eager(
        _program(iters, cg_iters),
        _inputs(cam_Tcw, points, obs_cam, obs_pt, obs_uv, obs_isig2,
                obs_valid, fixed_cam), cfg,
        {"cam": psum, "pt": psum if psum_pt is None else psum_pt})
    return _result(st)


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
    cfg = _Cfg(cam.shape[0], pts.shape[0], (fx, fy, cx, cy), use_huber,
               longest_cam, longest_pt)
    st = graphs.run_eager(_begin_program(), _inputs(
        cam, pts, obs_cam, obs_pt, obs_uv, obs_isig2, obs_valid, fixed_cam),
        cfg, _IDENTITY)
    return (st["lam"], *(st[k] for k in LIN))


def _ba_step(cam, pts, lam, hcc, gc, hpp, gp, W, cost, obs_cam, obs_pt,
             obs_uv, obs_isig2, obs_valid, fixed_cam, fx, fy, cx, cy,
             iters, cg_iters, use_huber, longest_cam, longest_pt):
    """``iters`` LM iterations from a threaded state: (cam, pts, lam,
    *lin)."""
    cfg = _Cfg(cam.shape[0], pts.shape[0], (fx, fy, cx, cy), use_huber,
               longest_cam, longest_pt)
    st = _inputs(cam, pts, obs_cam, obs_pt, obs_uv, obs_isig2, obs_valid,
                 fixed_cam)
    st.update(lam=lam, hcc=hcc, gc=gc, hpp=hpp, gp=gp, W=W, cost=cost)
    st = graphs.run_eager(itertools.chain(
        [_setup], *(_iteration_program(cg_iters) for _ in range(iters))),
        st, cfg, _IDENTITY)
    return (st["cam"], st["pts"], st["lam"], *(st[k] for k in LIN))


def _ba_finish(cam, pts, obs_cam, obs_pt, obs_uv, obs_isig2, obs_valid,
               fx, fy, cx, cy, use_huber, longest_cam, longest_pt):
    """The classification at the solution: (obs_inlier, final_cost)."""
    cfg = _Cfg(cam.shape[0], pts.shape[0], (fx, fy, cx, cy), use_huber,
               longest_cam, longest_pt)
    st = graphs.run_eager(itertools.chain([_setup], _finish_program()),
                          _inputs(cam, pts, obs_cam, obs_pt, obs_uv,
                                  obs_isig2, obs_valid), cfg, _IDENTITY)
    return st["inlier"], st["final_cost"]


# the JAX package's jitted bundle_adjust, as three programs replayed from
# CUDA graphs on the card (on the CPU, the functions themselves); each
# looks its function up at each call
_begin_graph = graphs.graphed(lambda *a: _ba_begin(*a), "ba_begin")
_step_graph = graphs.graphed(lambda *a: _ba_step(*a), "ba_step")
_finish_graph = graphs.graphed(lambda *a: _ba_finish(*a), "ba_finish")

# the sharded solvers' chains (parallel/dist_ba.py): one per shard and
# signature
_CHAINS = graphs.ChainCache("ba")


def bundle_adjust_shard(shard: int, device, arrays: dict, fx: float,
                        fy: float, cx: float, cy: float, iters: int,
                        cg_iters: int, use_huber: bool, psum: Callable,
                        shard_points: bool, longest_cam: int | None = None,
                        longest_pt: int | None = None) -> BAResult:
    """One shard's part of a sharded BA, replayed as a chain of CUDA
    graphs (``graphs.Chain``; on the CPU the same steps run eagerly in
    place): the port's ``jax.jit`` of the JAX package's ``shard_map``.
    Where ``psum`` is capturable (NCCL) its sums run inside the graphs,
    one replay an LM iteration; elsewhere the chain is cut at every
    collective.  ``arrays``: this shard's host arrays
    (``cam``, ``pts``, ``obs_cam``, ``obs_pt``, ``obs_uv``,
    ``obs_isig2``, ``obs_valid``, ``fixed_cam``), uploaded outside the
    graphs; their longest segments are counted on the host.  ``psum``
    closes the camera sums and the costs; the point sums too unless
    ``shard_points`` (each shard holds its points' observations).
    ``longest_cam`` / ``longest_pt``: the most observations of one
    camera / point in the caller's single-device layout of the whole
    problem; given, the shard's sums take the reductions of the
    single-device solve of that layout (``IndexSum`` chooses by the
    longest run), else those of its own rows.  The result's tensors are
    this shard's own."""
    K, P = len(arrays["cam"]), len(arrays["pts"])
    cfg = _Cfg(K, P, (float(fx), float(fy), float(cx), float(cy)),
               bool(use_huber),
               _longest(longest_cam, arrays["obs_cam"], K),
               _longest(longest_pt, arrays["obs_pt"], P))
    key = (shard, cfg, int(iters), int(cg_iters), bool(shard_points),
           graphs.capture_key(psum),
           *((k, np.shape(a)) for k, a in sorted(arrays.items())))
    chain = _CHAINS.get(key, device)
    chain.load(**arrays)
    st = chain.run(_program(iters, cg_iters), cfg,
                   {"cam": psum, "pt": None if shard_points else psum},
                   cut_before=(_damp, _finish))
    return BAResult(*(t.clone() for t in _result(st)))


def _longest_of(idx, n: int) -> int:
    """``segment.longest_segment`` of a device index vector: read back
    once, outside the graphs, where the caller gives no host count."""
    return segment.longest_segment(idx.cpu().numpy(), n)


def _longest(given, idx, n: int) -> int:
    """The caller's longest-run count, clamped as ``longest_segment``
    clamps, else the count of ``idx`` (a host array, or a tensor read
    back once)."""
    if given is not None:
        return min(int(given), segment.LONG_SEGMENTS + 1)
    if isinstance(idx, torch.Tensor):
        return _longest_of(idx, n)
    return segment.longest_segment(idx, n)


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
    longest_cam = _longest(longest_cam, obs_cam, K)
    longest_pt = _longest(longest_pt, obs_pt, P)
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
