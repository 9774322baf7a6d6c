"""Distributed bundle adjustment over a mesh of shards.

Port of ``orb_slam2_tpu/parallel/dist_ba.py``.  Shards the observation
list over the mesh (the natural decomposition of BA: cameras and points
are the small replicated state, observations the big one).  Every sum of
``optim.ba``'s assembly and PCG matvecs is closed with the mesh's
``psum``, so the reduced camera system is solved identically on every
shard.  A mesh is a :class:`~.mesh.LocalMesh` of devices of this process
or a :class:`~.mesh.ProcessGroupMesh` of ``torch.distributed`` ranks
(``parallel/multihost.py``); the solvers take either.

Each shard replays the solver as a chain of CUDA graphs
(``ba.bundle_adjust_shard``, ``graphs.Chain``), the port's ``jax.jit``
of the JAX package's ``shard_map``: its inputs go up outside the
graphs; on a NCCL process group every collective runs inside the graphs
(a warm solve launches one replay an LM iteration), elsewhere the chain
is cut at each collective (a warm solve on a local mesh launches only
replays and the collectives' sums).  Each shard's rows are padded to a power-of-4
bucket (``graphs.pad_bucket``), so problems of about one size share the
shards' captures; the padding is observations of weight 0, spread over
the point rows (``_spread``), and points that only those observations
reach: it changes no point's sum.  ``eager=True`` runs
the one-call ``ba.bundle_adjust_core`` on every shard instead, on the
same padded rows: the form the graph chains are checked against.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import graphs
from ..optim import ba
from . import mesh as mesh_mod
from .mesh import LocalMesh


def make_mesh(n_devices: int | Sequence | None = None,
              axis: str = "obs", device="cuda") -> LocalMesh:
    """A mesh over the visible devices of ``device``'s type (every card
    for ``"cuda"``, the one CPU for ``"cpu"``), the first ``n_devices``
    of them, or the devices of an explicit list (a device may repeat).
    The CPU is used only when asked for: ``"cuda"`` without a card
    raises."""
    if n_devices is None or isinstance(n_devices, int):
        kind = torch.device(device).type
        if kind == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; "
                               "pass device='cpu' for a CPU mesh")
        devs = mesh_mod.local_devices(kind)
        if n_devices is not None:
            devs = devs[:n_devices]
    else:
        devs = list(n_devices)
    return LocalMesh(devs, axis)


def pad_obs_to(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _first_device(mesh) -> torch.device:
    return mesh.device_of(mesh.local_shards()[0])


def _solve_shard(shard, device, arrays, fx, fy, cx, cy, iters, cg_iters,
                 use_huber, psum, shard_points, eager, longest_cam,
                 longest_pt) -> ba.BAResult:
    """One shard's solve: its graph chain, or with ``eager`` the one-call
    core (the parent form, for the checks)."""
    if not eager:
        return ba.bundle_adjust_shard(shard, device, arrays, fx, fy, cx, cy,
                                      iters, cg_iters, use_huber, psum,
                                      shard_points, longest_cam, longest_pt)
    t = {k: graphs.upload(a, device) for k, a in arrays.items()}
    return ba.bundle_adjust_core(
        t["cam"], t["pts"], t["obs_cam"], t["obs_pt"], t["obs_uv"],
        t["obs_isig2"], t["obs_valid"], t["fixed_cam"], fx, fy, cx, cy,
        iters=iters, cg_iters=cg_iters, use_huber=use_huber, psum=psum,
        psum_pt=ba._identity_psum if shard_points else None,
        longest_cam=ba._longest(longest_cam, arrays["obs_cam"],
                                len(arrays["cam"])),
        longest_pt=ba._longest(longest_pt, arrays["obs_pt"],
                               len(arrays["pts"])))


def distributed_bundle_adjust(
    mesh,
    cam_Tcw: np.ndarray,
    points: np.ndarray,
    obs_cam: np.ndarray,
    obs_pt: np.ndarray,
    obs_uv: np.ndarray,
    obs_isig2: np.ndarray,
    obs_valid: np.ndarray,
    fixed_cam: np.ndarray,
    fx: float, fy: float, cx: float, cy: float,
    iters: int = 10,
    cg_iters: int = 20,
    use_huber: bool = True,
    eager: bool = False,
    longest_cam: int | None = None,
    longest_pt: int | None = None,
) -> ba.BAResult:
    """Same contract as ``optim.ba.bundle_adjust``, executed sharded.

    The observation arrays are padded (valid False, 1/sigma^2 1.0) to
    the mesh size times a power-of-4 bucket and split along axis 0;
    camera and point state is replicated.  ``longest_cam`` /
    ``longest_pt``: the caller's host counts of its single-device
    layout (``ba.bundle_adjust_shard``), so that the shards' sums take
    that solve's reductions.  The result's tensors are on the mesh's
    first local device."""
    n_dev = mesh.size
    O = len(obs_cam)
    per = graphs.pad_bucket(-(-max(O, n_dev) // n_dev))
    pad = per * n_dev - O

    cam_Tcw = np.asarray(cam_Tcw, np.float32)
    points = np.asarray(points, np.float32)
    obs_cam = np.pad(np.asarray(obs_cam, np.int32), (0, pad))
    obs_pt = np.concatenate([np.asarray(obs_pt, np.int32),
                             _spread(pad, 0, max(len(points), 1))])
    obs_uv = np.pad(np.asarray(obs_uv, np.float32), ((0, pad), (0, 0)))
    obs_isig2 = np.pad(np.asarray(obs_isig2, np.float32), (0, pad),
                       constant_values=1.0)
    obs_valid = np.pad(np.asarray(obs_valid, bool), (0, pad))
    fixed_cam = np.asarray(fixed_cam, bool)

    def body(d, dev, psum):
        sl = slice(d * per, (d + 1) * per)
        arrays = dict(cam=cam_Tcw, pts=points, obs_cam=obs_cam[sl],
                      obs_pt=obs_pt[sl], obs_uv=obs_uv[sl],
                      obs_isig2=obs_isig2[sl], obs_valid=obs_valid[sl],
                      fixed_cam=fixed_cam)
        return _solve_shard(d, dev, arrays, fx, fy, cx, cy, iters, cg_iters,
                            use_huber, psum, False, eager, longest_cam,
                            longest_pt)

    res = mesh.run(body)
    dev0 = _first_device(mesh)
    first = res[mesh.local_shards()[0]]
    inlier = torch.cat(mesh.all_gather(
        {d: r.obs_inlier for d, r in res.items()}, dev0))
    return ba.BAResult(cam_Tcw=first.cam_Tcw, points=first.points,
                       obs_inlier=inlier[:O], final_cost=first.final_cost)


def _spread(n: int, lo: int, hi: int) -> np.ndarray:
    """Point rows for ``n`` padded observations, round robin over rows
    [lo, hi): no row takes a long run of them, so no point's sum
    changes its reduction (``IndexSum``'s branch follows the longest
    run) and a point's real rows keep their order and their sums."""
    return (lo + np.arange(n) % (hi - lo)).astype(np.int32)


def _rebucket(a: np.ndarray, n_dev: int, per: int, per_b: int, fill=0):
    """Per-shard blocks of ``per`` rows, flattened, padded with ``fill``
    to blocks of ``per_b`` rows."""
    blocks = a.reshape((n_dev, per) + a.shape[1:])
    widths = [(0, 0), (0, per_b - per)] + [(0, 0)] * (a.ndim - 1)
    return np.pad(blocks, widths, constant_values=fill).reshape(
        (n_dev * per_b,) + a.shape[1:])


# ----------------------------------------------------------------------
# Memory-scaling GBA: the POINT state sharded over the mesh.  Each shard
# owns a contiguous block of points AND all of their observations, so
# every point-indexed array (points, Hpp, gp, Hpp^-1, delta_p) exists
# only as that shard's block; only the small camera system is summed
# over the shards.
# ----------------------------------------------------------------------

def shard_points_problem(points, obs_cam, obs_pt, obs_uv, obs_isig2,
                         obs_valid, n_dev):
    """Partition points into n_dev contiguous blocks balanced by
    observation count; colocate each observation with its point's
    shard.  Returns per-shard padded arrays flattened along axis 0
    (split evenly by P(axis)) plus the scatter map back to global
    point rows."""
    P = len(points)
    O = len(obs_cam)
    counts = np.bincount(np.asarray(obs_pt, np.int64), minlength=P)
    csum = np.cumsum(counts)
    # block boundaries at equal observation mass
    cuts = [0]
    for d in range(1, n_dev):
        cuts.append(int(np.searchsorted(csum, csum[-1] * d / n_dev)))
    cuts.append(P)
    starts = np.asarray(cuts[:-1])
    ends = np.asarray(cuts[1:])
    Pmax = max(1, int((ends - starts).max()))
    shard_of_pt = np.zeros(P, np.int32)
    for d in range(n_dev):
        shard_of_pt[starts[d]:ends[d]] = d

    obs_shard = shard_of_pt[np.asarray(obs_pt, np.int64)]
    Omax = max(1, int(np.bincount(obs_shard, minlength=n_dev).max()))

    pts_sh = np.zeros((n_dev, Pmax, 3), np.float32)
    pt_map = np.full((n_dev, Pmax), -1, np.int64)   # global row per slot
    ocam = np.zeros((n_dev, Omax), np.int32)
    opt = np.zeros((n_dev, Omax), np.int32)
    ouv = np.zeros((n_dev, Omax, 2), np.float32)
    osig = np.ones((n_dev, Omax), np.float32)
    ovalid = np.zeros((n_dev, Omax), bool)
    obs_slot = np.zeros(O, np.int64)                # for inlier writeback
    for d in range(n_dev):
        s, e = starts[d], ends[d]
        n_p = e - s
        pts_sh[d, :n_p] = points[s:e]
        pt_map[d, :n_p] = np.arange(s, e)
        sel = np.where(obs_shard == d)[0]
        m = len(sel)
        ocam[d, :m] = obs_cam[sel]
        opt[d, :m] = np.asarray(obs_pt)[sel] - s    # local point index
        ouv[d, :m] = obs_uv[sel]
        osig[d, :m] = obs_isig2[sel]
        ovalid[d, :m] = np.asarray(obs_valid)[sel]
        obs_slot[sel] = d * Omax + np.arange(m)
    flat = lambda a: a.reshape((n_dev * a.shape[1],) + a.shape[2:])  # noqa: E731
    return (flat(pts_sh), flat(ocam), flat(opt), flat(ouv), flat(osig),
            flat(ovalid), pt_map.reshape(-1), obs_slot, Pmax)


def distributed_bundle_adjust_sharded_points(
    mesh,
    cam_Tcw: np.ndarray,
    points: np.ndarray,
    obs_cam: np.ndarray,
    obs_pt: np.ndarray,
    obs_uv: np.ndarray,
    obs_isig2: np.ndarray,
    obs_valid: np.ndarray,
    fixed_cam: np.ndarray,
    fx: float, fy: float, cx: float, cy: float,
    iters: int = 10,
    cg_iters: int = 20,
    use_huber: bool = True,
    eager: bool = False,
    longest_cam: int | None = None,
    longest_pt: int | None = None,
) -> ba.BAResult:
    """Same contract as ``optim.ba.bundle_adjust`` with the point state
    sharded over the mesh (cameras replicated, observations colocated
    with their point's shard, ``psum_pt`` the identity).  Each shard's
    point and observation blocks are padded to power-of-4 buckets.
    ``longest_cam`` / ``longest_pt``: as ``distributed_bundle_adjust``'s.
    The result's tensors are on the mesh's first local device."""
    n_dev = mesh.size
    points = np.asarray(points, np.float32)
    (pts_f, ocam_f, opt_f, ouv_f, osig_f, ovalid_f,
     pt_map, obs_slot, Pmax) = shard_points_problem(
        points, np.asarray(obs_cam, np.int32),
        np.asarray(obs_pt, np.int32), np.asarray(obs_uv, np.float32),
        np.asarray(obs_isig2, np.float32), np.asarray(obs_valid, bool),
        n_dev)
    Omax = len(ocam_f) // n_dev
    # every shard keeps at least one padded point row: its padded
    # observations go to those rows, not to its first point
    Pb, Ob = graphs.pad_bucket(Pmax + 1), graphs.pad_bucket(Omax)
    pts_f, pt_map = (_rebucket(pts_f, n_dev, Pmax, Pb),
                     _rebucket(pt_map, n_dev, Pmax, Pb, -1))
    ocam_f, opt_f, ouv_f, ovalid_f = (
        _rebucket(a, n_dev, Omax, Ob) for a in (ocam_f, opt_f, ouv_f,
                                                 ovalid_f))
    osig_f = _rebucket(osig_f, n_dev, Omax, Ob, 1.0)
    obs_slot = obs_slot // Omax * Ob + obs_slot % Omax
    n_pts = (pt_map.reshape(n_dev, Pb) >= 0).sum(1)
    n_obs = np.bincount(obs_slot // Ob, minlength=n_dev)
    opt_f = opt_f.reshape(n_dev, Ob)
    for d in range(n_dev):
        opt_f[d, n_obs[d]:] = _spread(Ob - n_obs[d], n_pts[d], Pb)
    opt_f = opt_f.reshape(-1)
    cam_Tcw = np.asarray(cam_Tcw, np.float32)
    fixed_cam = np.asarray(fixed_cam, bool)

    def body(d, dev, psum):
        sp = slice(d * Pb, (d + 1) * Pb)
        so = slice(d * Ob, (d + 1) * Ob)
        arrays = dict(cam=cam_Tcw, pts=pts_f[sp], obs_cam=ocam_f[so],
                      obs_pt=opt_f[so], obs_uv=ouv_f[so],
                      obs_isig2=osig_f[so], obs_valid=ovalid_f[so],
                      fixed_cam=fixed_cam)
        return _solve_shard(d, dev, arrays, fx, fy, cx, cy, iters, cg_iters,
                            use_huber, psum, True, eager, longest_cam,
                            longest_pt)

    res = mesh.run(body)
    dev0 = _first_device(mesh)
    first = res[mesh.local_shards()[0]]
    # un-shard: scatter the padded rows back to the global layout, with
    # index tensors uploaded here, outside the graphs
    pts_flat = torch.cat(mesh.all_gather(
        {d: r.points for d, r in res.items()}, dev0))
    inl_flat = torch.cat(mesh.all_gather(
        {d: r.obs_inlier for d, r in res.items()}, dev0))
    live = np.nonzero(pt_map >= 0)[0]
    out_pts = graphs.upload(np.array(points), dev0).index_copy_(
        0, graphs.upload(pt_map[live], dev0),
        pts_flat.index_select(0, graphs.upload(live, dev0)))
    return ba.BAResult(
        cam_Tcw=first.cam_Tcw, points=out_pts,
        obs_inlier=inl_flat.index_select(0, graphs.upload(obs_slot, dev0)),
        final_cost=first.final_cost)
