"""Distributed bundle adjustment over a mesh of shards.

Port of ``orb_slam2_tpu/parallel/dist_ba.py``.  Shards the observation
list over the mesh (the natural decomposition of BA: cameras and points
are the small replicated state, observations the big one).  Every sum of
``optim.ba``'s assembly and PCG matvecs is closed with the mesh's
``psum``, so the reduced camera system is solved identically on every
shard.  A mesh is a :class:`~.mesh.LocalMesh` of devices of this process
or a :class:`~.mesh.ProcessGroupMesh` of ``torch.distributed`` ranks
(``parallel/multihost.py``); the solvers take either.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

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
) -> ba.BAResult:
    """Same contract as ``optim.ba.bundle_adjust``, executed sharded.

    The observation arrays are padded to a multiple of the mesh size
    (valid False, 1/sigma^2 1.0) and split along axis 0; camera and
    point state is replicated.  The result's tensors are on the mesh's
    first local device."""
    n_dev = mesh.size
    O = len(obs_cam)
    Opad = pad_obs_to(max(O, n_dev), n_dev)
    pad = Opad - O
    per = Opad // n_dev

    cam_Tcw = np.asarray(cam_Tcw, np.float32)
    points = np.asarray(points, np.float32)
    obs_cam = np.pad(np.asarray(obs_cam, np.int32), (0, pad))
    obs_pt = np.pad(np.asarray(obs_pt, np.int32), (0, pad))
    obs_uv = np.pad(np.asarray(obs_uv, np.float32), ((0, pad), (0, 0)))
    obs_isig2 = np.pad(np.asarray(obs_isig2, np.float32), (0, pad),
                       constant_values=1.0)
    obs_valid = np.pad(np.asarray(obs_valid, bool), (0, pad))
    fixed_cam = np.asarray(fixed_cam, bool)

    def body(d, dev, psum):
        sl = slice(d * per, (d + 1) * per)

        def t(a):
            return torch.tensor(np.asarray(a), device=dev)
        return ba.bundle_adjust_core(
            t(cam_Tcw), t(points), t(obs_cam[sl]), t(obs_pt[sl]),
            t(obs_uv[sl]), t(obs_isig2[sl]), t(obs_valid[sl]), t(fixed_cam),
            fx, fy, cx, cy, iters=iters, cg_iters=cg_iters,
            use_huber=use_huber, psum=psum)

    res = mesh.run(body)
    dev0 = _first_device(mesh)
    first = res[mesh.local_shards()[0]]
    inlier = torch.cat(mesh.all_gather(
        {d: r.obs_inlier for d, r in res.items()}, dev0))
    return ba.BAResult(cam_Tcw=first.cam_Tcw, points=first.points,
                       obs_inlier=inlier[:O], final_cost=first.final_cost)


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
) -> ba.BAResult:
    """Same contract as ``optim.ba.bundle_adjust`` with the point state
    sharded over the mesh (cameras replicated, observations colocated
    with their point's shard, ``psum_pt`` the identity).  The result's
    tensors are on the mesh's first local device."""
    n_dev = mesh.size
    points = np.asarray(points, np.float32)
    (pts_f, ocam_f, opt_f, ouv_f, osig_f, ovalid_f,
     pt_map, obs_slot, Pmax) = shard_points_problem(
        points, np.asarray(obs_cam, np.int32),
        np.asarray(obs_pt, np.int32), np.asarray(obs_uv, np.float32),
        np.asarray(obs_isig2, np.float32), np.asarray(obs_valid, bool),
        n_dev)
    Omax = len(ocam_f) // n_dev
    cam_Tcw = np.asarray(cam_Tcw, np.float32)
    fixed_cam = np.asarray(fixed_cam, bool)

    def body(d, dev, psum):
        sp = slice(d * Pmax, (d + 1) * Pmax)
        so = slice(d * Omax, (d + 1) * Omax)

        def t(a):
            return torch.tensor(np.asarray(a), device=dev)
        return ba.bundle_adjust_core(
            t(cam_Tcw), t(pts_f[sp]), t(ocam_f[so]), t(opt_f[so]),
            t(ouv_f[so]), t(osig_f[so]), t(ovalid_f[so]), t(fixed_cam),
            fx, fy, cx, cy, iters=iters, cg_iters=cg_iters,
            use_huber=use_huber, psum=psum, psum_pt=ba._identity_psum)

    res = mesh.run(body)
    dev0 = _first_device(mesh)
    first = res[mesh.local_shards()[0]]
    # un-shard: scatter the padded rows back to the global layout
    pts_flat = torch.cat(mesh.all_gather(
        {d: r.points for d, r in res.items()}, dev0))
    inl_flat = torch.cat(mesh.all_gather(
        {d: r.obs_inlier for d, r in res.items()}, dev0))
    out_pts = torch.as_tensor(points, device=dev0).clone()
    live = np.nonzero(pt_map >= 0)[0]
    out_pts[torch.as_tensor(pt_map[live], device=dev0)] = \
        pts_flat[torch.as_tensor(live, device=dev0)]
    return ba.BAResult(
        cam_Tcw=first.cam_Tcw, points=out_pts,
        obs_inlier=inl_flat[torch.as_tensor(obs_slot, device=dev0)],
        final_cost=first.final_cost)
