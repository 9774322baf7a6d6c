"""Essential-graph Sim3 pose-graph optimization — port of
``orb_slam2_tpu/optim/pose_graph.py`` (Optimizer::OptimizeEssentialGraph,
src/Optimizer.cc:654-983).

7-DoF Sim3 vertices per keyframe; edges from loop connections, the
spanning tree, past loop edges and strong covisibility; identity
information; LM.  Edge residual (g2o EdgeSim3): for edge (i -> j) with
measurement Sji, r = log(Sji * Si * Sj^-1), zero when Sj = Sji * Si.
The per-edge Jacobians on the exp chart of each endpoint come from one
batched central difference in float64 (:func:`_edge_jacobians`); the
normal equations are solved by block-Jacobi PCG with edge-list
scatter-add matvecs.  The solver is one phased program (:func:`_program`, as ``ba.py``'s):
steps cut by the collectives that close every edge sum over the shards
of the edges, so the edge list can be sharded; the vertex state is
replicated.  :func:`optimize_pose_graph_core` runs it eagerly with a
``psum`` hook; :func:`optimize_pose_graph` on one device as a step
program of ``ITER_CHUNK`` LM iterations replayed from a CUDA graph,
(sims, lam) threaded, and a program for the cost at the solution;
:func:`pose_graph_shard` as one shard's chain of CUDA graphs cut at the
collectives (``parallel/dist_pose_graph.py``).  Its 7x7 preconditioner
blocks are inverted by a Cholesky factorization in tensor operations,
so no step waits for the card.
"""
from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from .. import graphs
from ..geom import sim3, smallsolve
from ..graphs import Collective
from . import segment
from .segment import IndexSum


class PoseGraphResult(NamedTuple):
    sims: torch.Tensor       # (K, 8) optimized Sim3 world->kf
    final_cost: torch.Tensor


def _edge_residual(xi_i, xi_j, Si, Sj, Sji):
    Si_new = sim3.compose(sim3.exp(xi_i), Si)
    Sj_new = sim3.compose(sim3.exp(xi_j), Sj)
    return sim3.log(sim3.compose(Sji, sim3.compose(Si_new, sim3.inv(Sj_new))))


_FD_STEP = 1e-4


def _edge_jacobians(Si, Sj, Sji):
    """(r (E, 7), Ji (E, 7, 7), Jj (E, 7, 7)) at xi_i = xi_j = 0, with
    J[e, a, b] = d r_a / d xi_b.

    The JAX package takes these by forward-mode autodiff in float32.
    Forward AD in PyTorch costs many residual evaluations per direction
    here, so the port takes central differences in float64 instead, all 28
    perturbed residuals in one batched evaluation: with a step of 1e-4
    the truncation error is ~1e-8 and the rounding error ~1e-12, below
    float32's resolution of the autodiff result."""
    E = Si.shape[0]
    zero = torch.zeros(E, 7, dtype=Si.dtype, device=Si.device)
    r = _edge_residual(zero, zero, Si, Sj, Sji)
    d = torch.eye(7, dtype=torch.float64, device=Si.device) * _FD_STEP
    steps = torch.cat([d, -d])                                 # (14, 7)
    z = torch.zeros_like(steps)
    xi_i = torch.cat([steps, z])[:, None, :].expand(28, E, 7)
    xi_j = torch.cat([z, steps])[:, None, :].expand(28, E, 7)

    def rep(S):
        return S.double()[None].expand(28, E, 8).reshape(28 * E, 8)

    rr = _edge_residual(xi_i.reshape(-1, 7), xi_j.reshape(-1, 7),
                        rep(Si), rep(Sj), rep(Sji)).reshape(28, E, 7)
    jac = (rr[:7] - rr[7:14]) / (2 * _FD_STEP)     # (7 dirs, E, 7)
    jac_j = (rr[14:21] - rr[21:]) / (2 * _FD_STEP)
    return (r, jac.permute(1, 2, 0).to(Si.dtype),
            jac_j.permute(1, 2, 0).to(Si.dtype))


def _identity_psum(x):
    return x


class _Cfg(NamedTuple):
    """A phased pose graph's static arguments."""
    n_kfs: int
    longest: int | None     # the most edge ends at one keyframe


def _lam0(sims):
    # a fill, not a copy of host data: a CUDA graph replays it
    return torch.full((), 1e-3, dtype=sims.dtype, device=sims.device)


# ----------------------------------------------------------------------
# The solver as a phased program (graphs.run_eager / graphs.Chain): steps
# on the state ``st`` cut by the collectives ("psum") that close the
# edge sums over the shards of the edges.  The one-call core, the
# single-device graphs and the sharded chains run these steps in this
# order.
# ----------------------------------------------------------------------

def _per_kf(st, cfg):
    """The edge ends' sum into their keyframes: the i-side rows, then the
    j-side rows."""
    lay = st.get("kf_order")
    return IndexSum(st["kf_idx"], cfg.n_kfs, cfg.longest,
                    None if lay is None else (lay, st["kf_starts"]))


def _scatter(per_kf, vals_i, vals_j):
    return per_kf(torch.cat([vals_i, vals_j]))


def _free(st):
    return ~st["fixed"]


def _edges(st, cfg):
    """The edge ends as long indices."""
    return dict(ei=st["edge_i"].long(), ej=st["edge_j"].long())


def _setup(st, cfg):
    """The edge ends, their sum's rows and (on the card) its sort
    layout."""
    out = _edges(st, cfg)
    out["kf_idx"] = torch.cat([out["ei"], out["ej"]])
    if out["ei"].is_cuda:
        out["kf_order"], out["kf_starts"] = segment.sort_layout(
            out["kf_idx"], cfg.n_kfs)
    return out


def _begin(st, cfg):
    return dict(lam=_lam0(st["sims"]))


def _cost(sims, st):
    """This shard's part of the cost at ``sims``."""
    ei = st["ei"]
    zero = torch.zeros(ei.shape[0], 7, dtype=sims.dtype, device=sims.device)
    r = _edge_residual(zero, zero, sims[ei], sims[st["ej"]], st["edge_meas"])
    return (st["edge_weight"] * (r * r).sum(-1)).sum()


def _jacobians(st, cfg):
    """The edges' Jacobians and the partials of the gradient g_k = sum_e
    J^T r and of the block diagonal."""
    sims = st["sims"]
    r, Ji, Jj = _edge_jacobians(sims[st["ei"]], sims[st["ej"]],
                                st["edge_meas"])
    w = st["edge_weight"][:, None, None]
    Jiw, Jjw = Ji * w, Jj * w
    per_kf = _per_kf(st, cfg)
    return dict(Ji=Ji, Jj=Jj, Jiw=Jiw, Jjw=Jjw,
                g=_scatter(per_kf, torch.einsum("eab,ea->eb", Jiw, r),
                           torch.einsum("eab,ea->eb", Jjw, r)),
                diag=_scatter(per_kf, torch.einsum("eab,eac->ebc", Jiw, Ji),
                              torch.einsum("eab,eac->ebc", Jjw, Jj)))


def _precond(st, cfg):
    """Damping and the block-diagonal preconditioner; PCG starts at
    x = 0."""
    diag, lam = st["diag"], st["lam"]
    K = diag.shape[0]
    dt, dev = diag.dtype, diag.device
    free = _free(st)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    g = torch.where(free[:, None], st["g"], torch.zeros_like(st["g"]))
    damp = lam * eye7 * torch.clamp(
        torch.diagonal(diag, dim1=-2, dim2=-1).sum(-1)[:, None, None]
        / 7.0, min=1e-6)
    diag_d = diag + damp + 1e-8 * eye7
    M_inv = smallsolve.spd_inverse(torch.where(
        free[:, None, None], diag_d, eye7.expand_as(diag_d)))
    x = torch.zeros((K, 7), dtype=dt, device=dev)
    return dict(damp=damp, M_inv=M_inv, b=-g, x=x, v=x)


def _hmv_start(st, cfg):
    """The Hessian matvec H v: the edges' part, to be summed."""
    v = st["v"]
    xm = torch.where(_free(st)[:, None], v, torch.zeros_like(v))
    Ji, Jj = st["Ji"], st["Jj"]
    ri = torch.einsum("eab,eb->ea", Ji, xm[st["ei"]]) \
        + torch.einsum("eab,eb->ea", Jj, xm[st["ej"]])
    return dict(xm=xm, hv=_scatter(
        _per_kf(st, cfg), torch.einsum("eab,ea->eb", st["Jiw"], ri),
        torch.einsum("eab,ea->eb", st["Jjw"], ri)))


def _h_matvec(st, v):
    """H v from the summed edge part (``hv``) and the damping."""
    out = st["hv"] + (st["damp"] @ st["xm"][..., None])[..., 0]
    return torch.where(_free(st)[:, None], out, v)


def _cg_init(st, cfg):
    rr = st["b"] - _h_matvec(st, st["x"])
    z = torch.einsum("kab,kb->ka", st["M_inv"], rr)
    return dict(rr=rr, z=z, p=z, v=z)


def _cg_update(st, cfg):
    """One PCG step, from the matvec H p."""
    x, rr, z, p = st["x"], st["rr"], st["z"], st["p"]
    Hp = _h_matvec(st, p)
    rz = (rr * z).sum()
    alpha = rz / torch.clamp((p * Hp).sum(), min=1e-20)
    x = x + alpha * p
    rr = rr - alpha * Hp
    z_new = torch.einsum("kab,kb->ka", st["M_inv"], rr)
    beta = (rr * z_new).sum() / torch.clamp(rz, min=1e-20)
    p = z_new + beta * p
    return dict(x=x, rr=rr, z=z_new, p=p, v=p)


def _candidate(st, cfg):
    """The candidate vertices and the partials of both costs."""
    x, sims = st["x"], st["sims"]
    dx = torch.where(_free(st)[:, None], x, torch.zeros_like(x))
    cand = sim3.compose(sim3.exp(dx), sims)
    return dict(cand=cand, cost_cand=_cost(cand, st),
                cost_old=_cost(sims, st))


def _accept(st, cfg):
    ok = st["cost_cand"] < st["cost_old"]
    lam = st["lam"]
    return dict(sims=torch.where(ok, st["cand"], st["sims"]),
                lam=torch.where(ok, lam * 0.5, lam * 4.0))


def _final_cost(st, cfg):
    return dict(final_cost=_cost(st["sims"], st))


def _iteration_program(cg_iters: int):
    """One LM iteration with its ``cg_iters`` PCG steps (the body of the
    JAX package's ``fori_loop``)."""
    yield _jacobians
    yield Collective("psum", ("g",))
    yield Collective("psum", ("diag",))
    yield _precond
    yield _hmv_start
    yield Collective("psum", ("hv",))
    yield _cg_init
    for _ in range(cg_iters):
        yield _hmv_start
        yield Collective("psum", ("hv",))
        yield _cg_update
    yield _candidate
    yield Collective("psum", ("cost_cand",))
    yield Collective("psum", ("cost_old",))
    yield _accept


def _final_program():
    yield _final_cost
    yield Collective("psum", ("final_cost",))


def _program(iters: int, cg_iters: int):
    yield _setup
    yield _begin
    for _ in range(iters):
        yield from _iteration_program(cg_iters)
    yield from _final_program()


def collectives(iters: int, cg_iters: int) -> int:
    """The collectives of a sharded solve: ``iters (cg_iters + 5) + 1``
    (the gradient, the block diagonal, the first matvec, one a PCG step,
    both costs; the final cost)."""
    return sum(isinstance(item, Collective)
               for item in _program(iters, cg_iters))


def _inputs(sims, edge_i, edge_j, edge_meas, edge_weight, fixed=None):
    st = dict(sims=sims, edge_i=edge_i, edge_j=edge_j, edge_meas=edge_meas,
              edge_weight=edge_weight)
    if fixed is not None:
        st["fixed"] = fixed
    return st


def optimize_pose_graph_core(sims0, edge_i, edge_j, edge_meas, edge_weight,
                             fixed, iters: int = 20, cg_iters: int = 30,
                             psum=_identity_psum) -> PoseGraphResult:
    """LM over the Sim3 pose graph, in one eager call: the phased program
    with ``psum`` at its collectives.  sims0 (K, 8) world -> kf; edge_i,
    edge_j (E,) int (may be a shard of the edges); edge_meas (E, 8) Sji;
    edge_weight (E,) (0 masks a padded edge); fixed (K,) bool.  ``psum``
    closes the cost, the gradient, the block diagonal and the Hessian
    matvec over the shards of the edges.  The longest segment is read
    back once."""
    K = sims0.shape[0]
    cfg = _Cfg(K, _longest(None, edge_i, edge_j, K))
    st = graphs.run_eager(
        _program(iters, cg_iters),
        _inputs(sims0, edge_i, edge_j, edge_meas, edge_weight, fixed), cfg,
        {"psum": psum})
    return PoseGraphResult(sims=st["sims"], final_cost=st["final_cost"])


# LM iterations per replay of the step program (one, as the BA's
# ba.ITER_CHUNK: the essential graph runs once per loop, so the first
# call's warm-up is most of its cost)
ITER_CHUNK = 1
_IDENTITY = {"psum": None}


def _pg_step(sims, lam, edge_i, edge_j, edge_meas, edge_weight, fixed,
             iters, cg_iters, longest):
    """``iters`` LM iterations from a threaded (sims, lam)."""
    st = _inputs(sims, edge_i, edge_j, edge_meas, edge_weight, fixed)
    st["lam"] = lam
    st = graphs.run_eager(itertools.chain(
        [_setup], *(_iteration_program(cg_iters) for _ in range(iters))),
        st, _Cfg(sims.shape[0], longest), _IDENTITY)
    return st["sims"], st["lam"]


def _pg_cost(sims, edge_i, edge_j, edge_meas, edge_weight):
    st = graphs.run_eager(
        itertools.chain([_edges], _final_program()),
        _inputs(sims, edge_i, edge_j, edge_meas, edge_weight),
        _Cfg(sims.shape[0], None), _IDENTITY)
    return st["final_cost"]


# the JAX package's jitted optimize_pose_graph, as a step program and the
# cost at the solution, replayed from CUDA graphs on the card (on the CPU,
# the functions themselves)
_step_graph = graphs.graphed(lambda *a: _pg_step(*a), "pose_graph_step")
_cost_graph = graphs.graphed(lambda *a: _pg_cost(*a), "pose_graph_cost")

# the sharded solver's chains (parallel/dist_pose_graph.py): one per shard
# and signature
_CHAINS = graphs.ChainCache("pose_graph")


def _longest(given, edge_i, edge_j, K: int) -> int:
    """The caller's count of the most edge ends at one keyframe, clamped
    as ``segment.longest_segment`` clamps, else the count of both end
    lists (host arrays, or tensors read back once)."""
    if given is not None:
        return min(int(given), segment.LONG_SEGMENTS + 1)
    ends = [e.cpu().numpy() if isinstance(e, torch.Tensor) else e
            for e in (edge_i, edge_j)]
    return segment.longest_segment(np.concatenate(ends), K)


def pose_graph_shard(shard: int, device, arrays: dict, iters: int,
                     cg_iters: int, psum) -> PoseGraphResult:
    """One shard's part of an edge-sharded pose graph, replayed as a
    chain of CUDA graphs (``graphs.Chain``; on the CPU the same steps
    run eagerly in place): with a capturable ``psum`` (NCCL) its sums
    inside the graphs, one replay an LM iteration, else cut at every
    collective.  ``arrays``: this
    shard's host arrays (``sims``, ``edge_i``, ``edge_j``,
    ``edge_meas``, ``edge_weight``, ``fixed``), uploaded outside the
    graphs; the longest segment is counted on the host.  The result's
    tensors are this shard's own."""
    K = len(arrays["sims"])
    cfg = _Cfg(K, _longest(None, arrays["edge_i"], arrays["edge_j"], K))
    key = (cfg, int(iters), int(cg_iters), graphs.capture_key(psum),
           *((k, np.shape(a)) for k, a in sorted(arrays.items())))
    chain = _CHAINS.get(key, shard, device)
    chain.load(**arrays)
    st = chain.run(_program(iters, cg_iters), cfg, {"psum": psum},
                   cut_before=(_jacobians, _final_cost))
    return PoseGraphResult(sims=st["sims"].clone(),
                           final_cost=st["final_cost"].clone())


def optimize_pose_graph(sims0, edge_i, edge_j, edge_meas, edge_weight,
                        fixed, iters: int = 20, cg_iters: int = 30,
                        longest: int | None = None) -> PoseGraphResult:
    """Single-device entry point (see :func:`optimize_pose_graph_core`):
    ``ITER_CHUNK`` LM iterations a step, (sims, lam) threaded from step
    to step, then the cost at the solution, each a CUDA graph replay on
    the card; the iteration count and the op order are the one-call
    form's.  ``longest``: the most edge ends at one keyframe, from the
    host (``segment.longest_segment`` of both end lists), else read back
    here once."""
    K = sims0.shape[0]
    longest = _longest(longest, edge_i, edge_j, K)
    sims, lam = sims0, _lam0(sims0)
    for done in range(0, iters, ITER_CHUNK):
        sims, lam = _step_graph(sims, lam, edge_i, edge_j, edge_meas,
                                edge_weight, fixed,
                                min(ITER_CHUNK, iters - done),
                                int(cg_iters), longest)
    return PoseGraphResult(sims=sims, final_cost=_cost_graph(
        sims, edge_i, edge_j, edge_meas, edge_weight))
