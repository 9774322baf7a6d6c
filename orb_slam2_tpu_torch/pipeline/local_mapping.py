"""Local mapping: map-point culling, triangulation of new points,
fusion, local BA, keyframe culling — in torch.

Port of the sequential ``LocalMapper`` of
``orb_slam2_tpu/pipeline/local_mapping.py`` (src/LocalMapping.cc).  The
stage order per keyframe is LocalMapping::Run's
(src/LocalMapping.cc:78-158): Process -> MapPointCulling ->
CreateNewMapPoints -> FusePointsInNeighbors -> LocalBA (structure only
in pose-prior mode, where the fork fixes every pose; pose-optimizing in
estimated mode) -> KeyFrameCulling.

The device side of each stage is one of the JAX package's jitted
programs, here a plain function on tensors that the mapper replays from
CUDA graphs (``graphs.graphed``; the static arguments are passed by
value, as the JAX package's ``static_argnames``):

- :func:`_triangulate_neighbors_fused`: the epipolar search (kernel K3)
  against a chunk of ``TRI_CHUNK`` neighbors, first-neighbor-wins
  selection, DLT and the gates; the host merges the chunks;
- :func:`_fuse_stack_rows` / :func:`_fuse_reverse_rows`: this
  keyframe's points into a chunk of ``FUSE_CHUNK`` targets, and the
  targets' points into it (kernel K2), the point rows gathered on the
  device from the ``DevicePoints`` snapshot, one int16 per (target,
  point) with the TH_LOW gate applied; :func:`_compact_matches` lists
  the matches for the read;
- :func:`_sba_step_gathered`: ``SBA_CHUNK`` LM iterations of the
  structure-only BA, its damping threaded from chunk to chunk.

Chunks and padding are the JAX package's: every shape is a power-of-4
bucket, so a run needs a few captures per function, and the tracker's
replays slot in between the chunks on the one stream.  Host arrays go up
through pinned memory (``graphs.upload``) and every stage reads its
results back through pinned copies and one event (``graphs.Readback``).
Loop closing runs at the tail of each keyframe
(``on_keyframe_processed``).

:class:`AsyncMapper` is the reference's LocalMapping thread: tracking
enqueues keyframes and mapping (with loop closing) runs on a worker
thread.  ``LocalMapper.process_keyframe`` holds ``store.lock`` and
drops it around each device dispatch + read window and at stage
boundaries, so the tracker only waits on short host sections.  Both
threads launch on PyTorch's default stream, which serializes their
device work.
"""
from __future__ import annotations

import queue
import threading
from typing import List

import numpy as np
import torch

from .. import graphs
from ..geom import triangulate
from ..geom.camera import undistorted_bounds
from ..matching import search, frustum
from ..models.mapstore import MapStore
from ..optim import ba, points_opt, segment
from ..ops.extractor import level_sigma2
from ..ops.pyramid import scale_factors as pyramid_scale_factors
from .config import SlamConfig
from .tracking import pad_bucket
from ..utils.logging import get_logger, StageTimer

log = get_logger("local_mapping")

TRI_CHUNK = 5       # neighbors per triangulation call
FUSE_CHUNK = 8      # targets per forward-fuse call
SBA_CHUNK = 5       # LM iterations per structure-BA call
FUSE_CAP = 2048     # matches listed per compacted fuse result


def compute_F12(T1: np.ndarray, T2: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Fundamental matrix of (KF1 -> KF2) from their poses
    (LocalMapping::ComputeF12, src/LocalMapping.cc:609-630):
    F12 = K^-T [t12]x R12 K^-1 with T12 = T1 @ T2^-1."""
    T12 = T1 @ np.linalg.inv(T2)
    R12, t12 = T12[:3, :3], T12[:3, 3]
    tx = np.array([
        [0, -t12[2], t12[1]],
        [t12[2], 0, -t12[0]],
        [-t12[1], t12[0], 0],
    ])
    Kinv = np.linalg.inv(K)
    return (Kinv.T @ tx @ R12 @ Kinv).astype(np.float32)


def _fuse_one_raw(pos, normal, min_d, max_d, pvalid, desc,
                  Tcw, kxy, koct, kdesc, kvalid,
                  scale_factors, fx, fy, cx, cy, bounds,
                  n_levels, log_scale, th, ratio):
    """Project a point set into one keyframe and search it (kernel K2);
    returns the search's (idx, dist, valid) per point, ungated (the JAX
    package's ``_fuse_one``)."""
    fr = frustum.is_in_frustum(
        pos, normal, min_d, max_d, pvalid, Tcw,
        fx, fy, cx, cy, bounds, n_levels, log_scale)
    r = search.search_by_projection_local_map(
        fr.uv, fr.pred_level, fr.view_cos, desc, fr.visible,
        kxy, koct, kdesc, kvalid, torch.zeros_like(kvalid),
        scale_factors, th=th, ratio=ratio)
    return r.idx, r.dist, r.valid


def _fuse_one(*args):
    """:func:`_fuse_one_raw` with the TH_LOW merge gate applied: the
    matched feature per point, or -1, as int16."""
    idx, dist, valid = _fuse_one_raw(*args)
    return torch.where(valid & (dist <= 50), idx,
                       torch.full_like(idx, -1)).to(torch.int16)


def _fuse_stack_impl(pos, normal, min_d, max_d, pvalid, desc,
                     Tcw_s, kxy_s, koct_s, kdesc_s, kvalid_s,
                     scale_factors, fx, fy, cx, cy, bounds,
                     n_levels, log_scale, th, ratio):
    """A point set into each of a stack of keyframes: (idx, dist, valid),
    each stacked (B, P), ungated (the JAX ``lax.map`` of ``_fuse_one``)."""
    per = [_fuse_one_raw(pos, normal, min_d, max_d, pvalid, desc,
                         Tcw_s[b], kxy_s[b], koct_s[b], kdesc_s[b],
                         kvalid_s[b], scale_factors, fx, fy, cx, cy, bounds,
                         n_levels, log_scale, th, ratio)
           for b in range(Tcw_s.shape[0])]
    return tuple(torch.stack(parts) for parts in zip(*per))


def _fuse_both_impl(own_pos, own_normal, own_min, own_max, own_valid,
                    own_desc, Tcw_s, kxy_s, koct_s, kdesc_s, kvalid_s,
                    cand_pos, cand_normal, cand_min, cand_max, cand_valid,
                    cand_desc, Tcw0, kxy0, koct0, kdesc0, kvalid0,
                    scale_factors, fx, fy, cx, cy, bounds,
                    n_levels, log_scale, th, ratio):
    fwd = _fuse_stack_impl(
        own_pos, own_normal, own_min, own_max, own_valid, own_desc,
        Tcw_s, kxy_s, koct_s, kdesc_s, kvalid_s,
        scale_factors, fx, fy, cx, cy, bounds,
        n_levels, log_scale, th, ratio)
    rev = _fuse_one_raw(cand_pos, cand_normal, cand_min, cand_max,
                        cand_valid, cand_desc,
                        Tcw0, kxy0, koct0, kdesc0, kvalid0,
                        scale_factors, fx, fy, cx, cy, bounds,
                        n_levels, log_scale, th, ratio)
    return fwd, rev


_fuse_both_graph = graphs.graphed(lambda *a: _fuse_both_impl(*a),
                                  "fuse_both")


def _fuse_both_directions(
        own_pos, own_normal, own_min, own_max, own_valid, own_desc,
        Tcw_s, kxy_s, koct_s, kdesc_s, kvalid_s,
        cand_pos, cand_normal, cand_min, cand_max, cand_valid, cand_desc,
        Tcw0, kxy0, koct0, kdesc0, kvalid0,
        scale_factors, fx, fy, cx, cy, bounds,
        n_levels, log_scale, th=3.0, ratio=1.0):
    """Forward fuse (this keyframe's points into every target) and
    reverse fuse (the targets' points into this keyframe) in one program
    (src/LocalMapping.cc:548-586 runs them as 20 + 1 calls), replayed
    from a CUDA graph on the card: ((idx, dist, valid) stacked over the
    targets, (idx, dist, valid) for the one keyframe), ungated.  The JAX
    package's function, which its pipeline does not call either (the
    mapper runs the gated, chunked :func:`_fuse_stack_rows` and
    :func:`_fuse_reverse_rows`)."""
    return _fuse_both_graph(
        own_pos, own_normal, own_min, own_max, own_valid, own_desc,
        Tcw_s, kxy_s, koct_s, kdesc_s, kvalid_s,
        cand_pos, cand_normal, cand_min, cand_max, cand_valid, cand_desc,
        Tcw0, kxy0, koct0, kdesc0, kvalid0,
        scale_factors, fx, fy, cx, cy, bounds, n_levels, log_scale,
        float(th), float(ratio))


def _gather_rows(pt_pos, pt_desc, pt_normal, pt_min, pt_max, pt_alive,
                 rows):
    """Gather a padded row-index vector (-1 = empty slot) from the
    device point store."""
    r = rows.clamp(min=0).long()
    return (pt_pos[r], pt_normal[r], pt_min[r], pt_max[r],
            (rows >= 0) & pt_alive[r], pt_desc[r])


def _fuse_stack_rows(pt_pos, pt_desc, pt_normal, pt_min, pt_max,
                     pt_alive, rows,
                     Tcw_s, kxy_s, koct_s, kdesc_s, kvalid_s,
                     scale_factors, fx, fy, cx, cy, bounds,
                     n_levels, log_scale, th=3.0, ratio=1.0):
    """Forward fuse: the point rows ``rows`` (-1 = empty slot) of the
    device point store projected into each of a stack of keyframes and
    searched there.  Returns (B, P) int16: the matched feature or -1."""
    pts = _gather_rows(pt_pos, pt_desc, pt_normal, pt_min, pt_max,
                       pt_alive, rows)
    return torch.stack([_fuse_one(
        *pts, Tcw_s[b], kxy_s[b], koct_s[b], kdesc_s[b], kvalid_s[b],
        scale_factors, fx, fy, cx, cy, bounds, n_levels, log_scale, th,
        ratio) for b in range(Tcw_s.shape[0])])


def _fuse_reverse_rows(pt_pos, pt_desc, pt_normal, pt_min, pt_max,
                       pt_alive, rows,
                       Tcw, kxy, koct, kdesc, kvalid,
                       scale_factors, fx, fy, cx, cy, bounds,
                       n_levels, log_scale, th=3.0, ratio=1.0):
    """Reverse fuse: the point rows ``rows`` into ONE keyframe.
    Returns (P,) int16: the matched feature or -1."""
    return _fuse_one(*_gather_rows(pt_pos, pt_desc, pt_normal, pt_min,
                                   pt_max, pt_alive, rows),
                     Tcw, kxy, koct, kdesc, kvalid,
                     scale_factors, fx, fy, cx, cy, bounds,
                     n_levels, log_scale, th, ratio)


def _compact_matches(sfeat, cap):
    """(..., P) int16 matched-feature-or--1 -> (flat positions (cap,)
    int32, feature ids (cap,) int16, match count () int32).

    The first ``cap`` matches in flat order, the rest of the list 0 (as
    ``jnp.nonzero(size=cap, fill_value=0)``): a running count places
    each match, and a scatter writes it; entries past the list land in a
    spare slot.  ``count > cap`` makes the caller read the full
    matrix."""
    flat = sfeat.reshape(-1)
    matched = flat >= 0
    pos = torch.cumsum(matched.to(torch.int32), 0) - 1
    slot = torch.where(matched & (pos < cap), pos.long(),
                       torch.full_like(pos, cap, dtype=torch.long))
    rows = torch.zeros(cap + 1, dtype=torch.int32, device=flat.device)
    rows.scatter_(0, slot, torch.arange(
        flat.shape[0], dtype=torch.int32, device=flat.device))
    rows = rows[:cap]
    return rows, flat[rows.long()], matched.sum(dtype=torch.int32)


def _triangulate_neighbors_fused(
        xy1, desc1, valid1, octave1, Tcw1,
        xy2_s, desc2_s, valid2_s, oct2_s,
        F12_s, epi_s, Tcw2_s, o2_s, nb_valid,
        K, sigma2, scale_factors,
        fx, fy, cx, cy, scale_ratio_factor):
    """The device side of CreateNewMapPoints for a chunk of neighbors:

    1. the epipolar-gated search (kernel K3) against each neighbor,
    2. first-neighbor-wins pair selection per KF1 row (the reference
       binds a feature to the first neighbor that matches it,
       src/LocalMapping.cc:327-346),
    3. per-pair DLT triangulation with that neighbor's camera,
    4. depth/reprojection/parallax gates + the scale-consistency gate
       (src/LocalMapping.cc:380-470).

    Neighbor tensors are stacked (B, n2, ...); rows of ``nb_valid``
    False are padding and match nothing.  Returns per KF1 row (good,
    nb, col, has): nb and col int32."""
    sidx, svalid = [], []
    for b in range(xy2_s.shape[0]):
        r = search.search_for_triangulation(
            xy1, desc1, valid1, octave1,
            xy2_s[b], desc2_s[b], valid2_s[b], oct2_s[b],
            F12_s[b], epi_s[b], sigma2, scale_factors)
        sidx.append(r.idx)
        svalid.append(r.valid)
    sidx = torch.stack(sidx)
    svalid = torch.stack(svalid) & nb_valid[:, None]

    has = svalid.any(dim=0)                              # (N1,)
    nb = svalid.to(torch.uint8).argmax(dim=0)            # first True
    rows = torch.arange(xy1.shape[0], device=xy1.device)
    col = sidx[nb, rows]

    Tcw2 = Tcw2_s[nb]                                    # (N1, 4, 4)
    uv2 = xy2_s[nb, col]
    P1 = triangulate.projection_matrix(K, Tcw1)
    P2 = triangulate.projection_matrix(K, Tcw2)
    X = triangulate.triangulate_dlt_pairs(P1, P2, xy1, uv2)
    octave1 = octave1.long()
    col_oct = oct2_s[nb, col].long()
    chk = triangulate.check_triangulation_pairs(
        X, Tcw1, Tcw2, xy1, uv2, fx, fy, cx, cy,
        sigma2[octave1], sigma2[col_oct])

    # scale-consistency gate
    o1 = -Tcw1[:3, :3].T @ Tcw1[:3, 3]
    d1 = torch.linalg.norm(X - o1, dim=-1)
    d2 = torch.linalg.norm(X - o2_s[nb], dim=-1)
    ratio_dist = d2 / torch.clamp(d1, min=1e-9)
    ratio_oct = scale_factors[octave1] / scale_factors[col_oct]
    good = (has & chk.good
            & (ratio_dist < ratio_oct * scale_ratio_factor)
            & (ratio_dist > ratio_oct / scale_ratio_factor))
    return good, nb.to(torch.int32), col.to(torch.int32), has


def _merge_chunks(parts, chunk: int):
    """The host merge of triangulation chunks (numpy (good, nb, col,
    has) each): the first chunk with a match wins a row, which is the
    first matching neighbor, as chunks keep the neighbor order."""
    good, nb, col, claimed = (np.array(a) for a in parts[0])
    nb, col = nb.astype(np.int64), col.astype(np.int64)
    for ci, (g2, nb2, col2, h2) in enumerate(parts[1:], 1):
        fresh = ~claimed & h2
        good[fresh] = g2[fresh]
        nb[fresh] = nb2[fresh] + ci * chunk
        col[fresh] = col2[fresh]
        claimed |= h2
    return good, nb, col


def gather_ba_problem(store: MapStore, kf_ids: List[int], inv_sigma2):
    """Flat observation arrays for the given keyframes.

    Returns (pids, (obs_kf_local, obs_pt_local, obs_uv, obs_isig2,
    (meta_kid, meta_fi)))."""
    li_parts, pid_parts, fi_parts, uv_parts, sig_parts, kid_parts = \
        [], [], [], [], [], []
    for li, kid in enumerate(kf_ids):
        fr = store.kfs[kid].frame
        fi = np.where(fr.mp_ids >= 0)[0]
        if len(fi) == 0:
            continue
        pids_k = fr.mp_ids[fi].astype(np.int64)
        live = np.asarray(store.mp_valid[pids_k], bool)
        fi, pids_k = fi[live], pids_k[live]
        if len(fi) == 0:
            continue
        li_parts.append(np.full(len(fi), li, np.int32))
        pid_parts.append(pids_k)
        fi_parts.append(fi)
        kid_parts.append(np.full(len(fi), kid, np.int64))
        uv_parts.append(fr.xy[fi])
        sig_parts.append(inv_sigma2[fr.octave[fi]])
    if not pid_parts:
        return [], None
    all_pids = np.concatenate(pid_parts)
    uniq, inv = np.unique(all_pids, return_inverse=True)
    obs_kf = np.concatenate(li_parts)
    obs_pt = inv.astype(np.int32)
    obs_uv = np.concatenate(uv_parts).astype(np.float32)
    obs_sig = np.concatenate(sig_parts).astype(np.float32)
    meta = (np.concatenate(kid_parts), np.concatenate(fi_parts))
    return [int(p) for p in uniq], (obs_kf, obs_pt, obs_uv, obs_sig, meta)


def _sba_step_gathered(points0, obs_pt, kf_poses, xy_stack, oct_stack,
                       inv_sigma2_lvl, obs_cam, obs_fi, n_obs,
                       fx, fy, cx, cy, iters, lam0, longest_obs):
    """A chunk of ``iters`` structure-BA iterations with the
    measurements gathered on the device from the keyframes' feature
    stacks.  Padding is a suffix: observation o is real when o <
    ``n_obs`` (a 0-d tensor, so one capture serves every count).
    ``longest_obs`` is the most observations of one point row, known on
    the host (``IndexSum``'s choice, made without a read).  Returns the
    points, the inlier verdicts and the damping for the next chunk."""
    obs_valid = torch.arange(obs_pt.shape[0], device=obs_pt.device) < n_obs
    obs_uv = xy_stack[obs_cam, obs_fi]
    obs_sig = inv_sigma2_lvl[oct_stack[obs_cam, obs_fi].long()]
    res = points_opt.optimize_points(
        points0, obs_pt, kf_poses, obs_uv, obs_sig, obs_valid,
        fx, fy, cx, cy, iters=iters, obs_cam=obs_cam, lam0=lam0,
        longest_obs=longest_obs)
    return res.points, res.obs_inlier, res.lam


def run_structure_ba(store: MapStore, kf_ids: List[int], cfg: SlamConfig,
                     iters: int = 10, timer: StageTimer | None = None,
                     step=_sba_step_gathered):
    """Fixed-pose local BA == independent point refinement
    (src/Optimizer.cc:328-637 with fixedPose=true), on the store's
    device, in chunks of ``SBA_CHUNK`` iterations through ``step``
    (:func:`_sba_step_gathered`, or the mapper's CUDA graph of it).

    The JAX package's buckets: observations and points by
    ``pad_bucket`` from ``cfg.pad_min_obs`` / ``cfg.pad_min_pts``,
    keyframes to a multiple of 32 with filler rows copied from the first
    (identity poses).  The point rows keep one spare past the points,
    which takes every padded observation, so padding never lengthens a
    real point's sum.  Only index vectors go up; the measurements gather
    on the device from the keyframes' feature tensors."""
    timer = timer or StageTimer()
    dev = store.device
    inv_sigma2 = (1.0 / level_sigma2(cfg.orb)).astype(np.float32)
    with timer.time("sba/gather"):
        pids, packed = gather_ba_problem(store, kf_ids, inv_sigma2)
    if packed is None or len(pids) == 0:
        return
    obs_kf, obs_pt, _, _, meta = packed
    meta_kid, meta_fi = meta
    n_obs, n_pts = len(obs_kf), len(pids)
    points0 = np.asarray(store.mp_pos[np.asarray(pids, np.int64)])
    O = pad_bucket(n_obs, cfg.pad_min_obs)
    P = pad_bucket(n_pts + 1, cfg.pad_min_pts)
    Kp = pad_bucket(len(kf_ids), 32)
    pad_o = O - n_obs
    poses = np.concatenate(
        [np.stack([store.kfs[k].Tcw for k in kf_ids]),
         np.broadcast_to(np.eye(4, dtype=np.float32),
                         (Kp - len(kf_ids), 4, 4))]).astype(np.float32)
    obs_pt_p = np.concatenate([obs_pt, np.full(pad_o, P - 1)]).astype(
        np.int64)
    longest = segment.longest_segment(obs_pt_p, P)
    fx, fy, cx, cy = (float(cfg.cam.fx), float(cfg.cam.fy),
                      float(cfg.cam.cx), float(cfg.cam.cy))
    frames = [store.kfs[k].frame for k in kf_ids]
    frames += [frames[0]] * (Kp - len(kf_ids))
    n2 = max(f.n for f in frames)
    with timer.time("sba/device"), store.unlocked():
        def up(a):
            return graphs.upload(a, dev)
        xy_stack = torch.stack([f.dev_padded("xy", n2) for f in frames])
        oct_stack = torch.stack([f.dev_padded("octave", n2)
                                 for f in frames])
        pts = up(np.pad(points0, ((0, P - n_pts), (0, 0))))
        args = (up(obs_pt_p), up(poses), xy_stack, oct_stack,
                up(inv_sigma2),
                up(np.pad(obs_kf.astype(np.int64), (0, pad_o))),
                up(np.pad(meta_fi.astype(np.int64), (0, pad_o))),
                up(np.int64(n_obs)))
        lam = torch.full((P,), 1e-3, dtype=torch.float32, device=dev)
        for done in range(0, iters, SBA_CHUNK):
            pts, inl, lam = step(pts, *args, fx, fy, cx, cy,
                                 min(SBA_CHUNK, iters - done), lam, longest)
        new_pts, inl = graphs.Readback((pts, inl)).arrays()
    with timer.time("sba/apply"):
        store.mp_pos[np.asarray(pids, np.int64)] = new_pts[:n_pts]
        # erase outlier observations (the reference's post-BA edge
        # removal, src/Optimizer.cc:560-600)
        for o in np.where(~inl[:n_obs])[0]:
            pid = pids[obs_pt[o]]
            if store.mp_valid[pid]:
                store.erase_observation(pid, int(meta_kid[o]))
        store.update_points_batch(pids)


def run_local_ba(store: MapStore, center_kf: int, cfg: SlamConfig,
                 fixed_pose: bool = False, iters: int = 10,
                 timer: StageTimer | None = None,
                 step=_sba_step_gathered):
    """LocalBundleAdjustment (src/Optimizer.cc:328-637): local KFs = the
    center and its covisibles; fixed KFs = every other observer of the
    local points, plus KF 0 and KF 1 (the initial pair holds the gauge
    and the scale).  ``fixed_pose`` (the fork's pose-prior mode) fixes
    every pose: structure-only BA, chunked through ``step``
    (:func:`run_structure_ba`)."""
    local = [center_kf] + [k for k in store.covis[center_kf]
                           if store.kfs[k].valid]
    if fixed_pose:
        run_structure_ba(store, local, cfg, iters=iters, timer=timer,
                         step=step)
        return
    timer = timer or StageTimer()
    with timer.time("lba/gather"):
        local_set = set(local)
        # points seen by the local KFs, in first-seen order
        pid_set = {}
        for kid in local:
            for pid in store.kfs[kid].frame.mp_ids:
                if pid >= 0 and store.mp_valid[pid] and pid not in pid_set:
                    pid_set[pid] = len(pid_set)
        if not pid_set:
            return
        # fixed observers, from the observation mirror
        pid_arr = np.fromiter(pid_set.keys(), np.int64, len(pid_set))
        kidm, fim, nm = store.obs.rows(pid_arr)
        slot_ok = np.arange(kidm.shape[1])[None, :] < nm[:, None]
        fixed = [int(k) for k in np.unique(kidm[slot_ok])
                 if k not in local_set and store.kfs[k].valid]
        all_kfs = local + fixed
        kf_index = {k: i for i, k in enumerate(all_kfs)}
        fixed_mask = np.zeros(len(all_kfs), bool)
        fixed_mask[len(local):] = True
        for gauge in (0, 1):
            if gauge in kf_index:
                fixed_mask[kf_index[gauge]] = True
        if not fixed_mask.any():
            fixed_mask[0] = True
        inv_sigma2 = (1.0 / level_sigma2(cfg.orb)).astype(np.float32)
        # flatten (kf_local, pt_local, kid, fi) from the mirror
        max_kid = max(kf_index)
        kid2local = np.full(max_kid + 2, -1, np.int64)
        for k, i in kf_index.items():
            kid2local[k] = i
        rows, cols = np.nonzero(slot_ok)
        ok_kid = kidm[rows, cols]
        in_graph = (ok_kid <= max_kid) \
            & (kid2local[np.clip(ok_kid, 0, max_kid)] >= 0)
        rows, cols = rows[in_graph], cols[in_graph]
        o_kid = kidm[rows, cols]
        o_fi = fim[rows, cols]
        obs_kf = kid2local[o_kid].astype(np.int32)
        obs_pt = rows.astype(np.int32)    # pid_set insertion order == rows
        n_obs = len(obs_kf)
        if n_obs < 10:
            return
        obs_uv = np.empty((n_obs, 2), np.float32)
        oct_flat = np.empty(n_obs, np.int32)
        for k in np.unique(o_kid):
            m = o_kid == k
            fr = store.kfs[k].frame
            obs_uv[m] = fr.xy[o_fi[m]]
            oct_flat[m] = fr.octave[o_fi[m]]
        pids = list(pid_set.keys())
        poses = np.stack([store.kfs[k].Tcw for k in all_kfs])
        points0 = np.asarray(store.mp_pos[pid_arr])
    # padded as the JAX package pads it (power-of-4 rows, fixed
    # identity cameras)
    K = pad_bucket(len(all_kfs), 8)
    P = pad_bucket(len(pids))
    pad_o = pad_bucket(n_obs) - n_obs
    fx, fy, cx, cy = (float(cfg.cam.fx), float(cfg.cam.fy),
                      float(cfg.cam.cx), float(cfg.cam.cy))
    eye = np.broadcast_to(np.eye(4, dtype=np.float32),
                          (K - len(all_kfs), 4, 4))
    dev = store.device

    def t(a):
        return graphs.upload(a, dev)

    obs_kf_p = np.pad(obs_kf, (0, pad_o))
    obs_pt_p = np.pad(obs_pt, (0, pad_o))
    with timer.time("lba/device"), store.unlocked():
        res = ba.bundle_adjust(
            t(np.concatenate([poses, eye]).astype(np.float32)),
            t(np.pad(points0, ((0, P - len(pids)), (0, 0)))),
            t(obs_kf_p), t(obs_pt_p),
            t(np.pad(obs_uv, ((0, pad_o), (0, 0)))),
            t(np.pad(inv_sigma2[oct_flat], (0, pad_o))),
            t(np.pad(np.ones(n_obs, bool), (0, pad_o))),
            t(np.pad(fixed_mask, (0, K - len(all_kfs)),
                     constant_values=True)),
            fx, fy, cx, cy, iters=iters, cg_iters=20,
            longest_cam=segment.longest_segment(obs_kf_p, K),
            longest_pt=segment.longest_segment(obs_pt_p, P))
        new_poses, new_pts, inl = graphs.Readback(
            (res.cam_Tcw, res.points, res.obs_inlier)).arrays()
    with timer.time("lba/apply"):
        for i, kid in enumerate(all_kfs):
            if not fixed_mask[i]:
                store.set_kf_pose(kid, new_poses[i])
        store.mp_pos[pid_arr] = new_pts[:len(pids)]
        for o in np.where(~inl[:n_obs])[0]:
            pid = pids[obs_pt[o]]
            if store.mp_valid[pid]:
                store.erase_observation(pid, int(o_kid[o]))
        store.update_points_batch(pids)


class LocalMapper:
    def __init__(self, cfg: SlamConfig, store: MapStore):
        self.cfg = cfg
        self.store = store
        self.recent_points: List[int] = []
        self._fuse_touched: List[int] = []  # merge winners awaiting the
        #                                     batched refresh
        self.timer = StageTimer()
        self.on_keyframe_processed = None  # wired to loop closing
        scale, _, sigma2, _ = pyramid_scale_factors(cfg.orb.n_levels,
                                                    cfg.orb.scale_factor)
        self.scale_factors = scale
        self.sigma2 = sigma2
        self.inv_sigma2 = (1.0 / sigma2).astype(np.float32)
        self.log_scale = float(np.log(cfg.orb.scale_factor))
        self._consts = {}   # device -> (K, sigma2, scale factors)
        # the device programs as CUDA graphs (the JAX package's jitted
        # functions); each looks its module function up at each call
        self._tri_step = graphs.graphed(
            lambda *a: _triangulate_neighbors_fused(*a), "triangulate")
        self._fuse_fwd = graphs.graphed(
            lambda *a: _fuse_stack_rows(*a), "fuse_forward")
        self._fuse_rev = graphs.graphed(
            lambda *a: _fuse_reverse_rows(*a), "fuse_reverse")
        self._compact = graphs.graphed(
            lambda *a: _compact_matches(*a), "compact_matches")
        self._sba_step = graphs.graphed(
            lambda *a: _sba_step_gathered(*a), "sba_step")

    def _t(self, a) -> torch.Tensor:
        """Host array -> tensor on the store's device, without waiting
        for the card (``graphs.upload``)."""
        return graphs.upload(a, self.store.device)

    def _const(self):
        """(K, sigma2, scale factors) float32 on the store's device,
        uploaded once."""
        dev = self.store.device
        c = self._consts.get(dev)
        if c is None:
            c = self._consts[dev] = tuple(self._t(np.asarray(
                a, np.float32)) for a in (self.cfg.cam.K, self.sigma2,
                                           self.scale_factors))
        return c

    # ------------------------------------------------------------------
    def process_keyframe(self, kid: int, queue_pressure: bool = False):
        """One LocalMapping::Run iteration (src/LocalMapping.cc:78-158),
        under the map lock (Map::mMutexUpdateMap), which each heavy
        stage drops around its device window.

        ``queue_pressure``: more keyframes are already waiting, so skip
        fusion and local BA for this one, as the reference's mapping
        thread does under load (SearchInNeighbors runs only
        ``if(!CheckNewKeyFrames())``, src/LocalMapping.cc:111, and a new
        insertion aborts the local BA, src/LocalMapping.cc:122-124).
        The next quiet keyframe covers the deferred work."""
        with self.store.lock:
            self._process_keyframe_locked(kid, queue_pressure)

    def _process_keyframe_locked(self, kid: int, queue_pressure: bool):
        store = self.store
        log.info("KF %d begin (pressure=%s, alloc=%d)", kid,
                 queue_pressure, store.n_points())
        # ProcessNewKeyFrame (src/LocalMapping.cc:180-197): refresh the
        # bound points' descriptors/normals and the covisibility graph
        with self.timer.time("mapping/process_kf"):
            f = store.kfs[kid].frame
            bound = f.mp_ids[f.mp_ids >= 0].astype(np.int64)
            if len(bound):
                bound = bound[np.asarray(store.mp_valid[bound], bool)]
            store.update_points_batch(bound.tolist())
            store.update_connections(kid)
        n0 = store.n_valid_points()
        store.yield_lock()  # stage boundary: let the tracker in
        with self.timer.time("mapping/cull_points"):
            self._cull_map_points(kid)
        store.yield_lock()
        with self.timer.time("mapping/triangulate"):
            self._create_new_map_points(kid)
        n1 = store.n_valid_points()
        store.yield_lock()
        if not queue_pressure:
            with self.timer.time("mapping/fuse"):
                self._fuse_neighbors(kid)
            store.yield_lock()
            if store.n_valid_keyframes() > 2:
                with self.timer.time("mapping/local_ba"):
                    run_local_ba(store, kid, self.cfg,
                                 fixed_pose=self.cfg.pose_prior,
                                 iters=self.cfg.local_ba_iters,
                                 timer=self.timer, step=self._sba_step)
            store.yield_lock()
        with self.timer.time("mapping/cull_keyframes"):
            self._cull_keyframes(kid)
        store.yield_lock()
        log.info("KF %d: +%d map points (total %d), %d keyframes",
                 kid, n1 - n0, store.n_valid_points(),
                 store.n_valid_keyframes())
        if self.on_keyframe_processed:
            with self.timer.time("mapping/loop_closing"):
                self.on_keyframe_processed(kid)

    # ------------------------------------------------------------------
    def _cull_map_points(self, kid: int):
        """MapPointCulling (src/LocalMapping.cc:206-248)."""
        store = self.store
        keep = []
        for pid in self.recent_points:
            if not store.mp_valid[pid]:
                continue
            age = kid - store.mp_first_kf[pid]
            if store.matched_ratio(pid) < self.cfg.mp_cull_min_ratio:
                store.erase_point(pid)
            elif age >= 2 and len(store.mp_obs[pid]) <= 2:
                store.erase_point(pid)
            elif age >= 3:
                pass  # graduated
            else:
                keep.append(pid)
        self.recent_points = keep

    # ------------------------------------------------------------------
    def _create_new_map_points(self, kid: int):
        """CreateNewMapPoints (src/LocalMapping.cc:255-495): search every
        eligible neighbor (kernel K3), keep the first neighbor that
        matches each feature, triangulate and gate on the device, then
        re-triangulate the accepted matches on the host in float64."""
        store = self.store
        cfg = self.cfg
        kf1 = store.kfs[kid]
        K = np.asarray(cfg.cam.K)
        o1 = store.kf_center(kid)
        neighbors = store.get_best_covisibles(kid, cfg.triangulation_neighbors)
        f1 = kf1.frame
        unbound1 = (f1.mp_ids < 0) & f1.valid
        fx, fy, cx, cy = (float(cfg.cam.fx), float(cfg.cam.fy),
                          float(cfg.cam.cx), float(cfg.cam.cy))

        with self.timer.time("tri/prep_host"):
            elig = []
            for kid2 in neighbors:
                kf2 = store.kfs[kid2]
                o2 = store.kf_center(kid2)
                baseline = float(np.linalg.norm(o1 - o2))
                med_depth = store.scene_median_depth(kid2)
                if (med_depth <= 0 or baseline / med_depth
                        < cfg.min_baseline_depth_ratio):
                    continue
                F12 = compute_F12(kf1.Tcw, kf2.Tcw, K)
                pc = kf2.Tcw[:3, :3] @ o1 + kf2.Tcw[:3, 3]
                z = pc[2] if abs(pc[2]) > 1e-9 else 1e-9
                uv_e = np.array([fx * pc[0] / z + cx, fy * pc[1] / z + cy],
                                np.float32)
                elig.append((kid2, F12, uv_e, o2))
            if not elig:
                store.update_connections(kid)
                return
            # chunks of TRI_CHUNK neighbors, the last padded with
            # nb_valid False rows (copies of the chunk's first frame)
            n2 = max(store.kfs[e[0]].frame.n for e in elig)
            chunks = []
            for c0 in range(0, len(elig), TRI_CHUNK):
                sub = elig[c0:c0 + TRI_CHUNK]
                frames2 = [store.kfs[e[0]].frame for e in sub]
                frames2 += [frames2[0]] * (TRI_CHUNK - len(sub))
                valid2 = np.zeros((TRI_CHUNK, n2), bool)
                F12_s = np.tile(np.eye(3, dtype=np.float32),
                                (TRI_CHUNK, 1, 1))
                epi_s = np.zeros((TRI_CHUNK, 2), np.float32)
                Tcw2_s = np.tile(np.eye(4, dtype=np.float32),
                                 (TRI_CHUNK, 1, 1))
                o2_s = np.zeros((TRI_CHUNK, 3), np.float32)
                for j, (kid2, F12, uv_e, o2) in enumerate(sub):
                    f2 = frames2[j]
                    valid2[j, :f2.n] = (f2.mp_ids < 0) & f2.valid
                    F12_s[j], epi_s[j], o2_s[j] = F12, uv_e, o2
                    Tcw2_s[j] = store.kfs[kid2].Tcw
                chunks.append((frames2, valid2, F12_s, epi_s, Tcw2_s, o2_s,
                               np.arange(TRI_CHUNK) < len(sub)))
            Tcw1 = kf1.Tcw.copy()

        with self.timer.time("tri/device"), store.unlocked():
            K_d, sigma2_d, scales_d = self._const()
            t = self._t
            head = (f1.dev("xy"), f1.dev("desc"), t(unbound1),
                    f1.dev("octave"), t(Tcw1))
            outs = []
            for frames2, valid2, *host, nb_valid in chunks:
                outs.append(self._tri_step(
                    *head,
                    torch.stack([fr.dev_padded("xy", n2) for fr in frames2]),
                    torch.stack([fr.dev_padded("desc", n2)
                                 for fr in frames2]),
                    t(valid2),
                    torch.stack([fr.dev_padded("octave", n2)
                                 for fr in frames2]),
                    *(t(a) for a in host), t(nb_valid),
                    K_d, sigma2_d, scales_d,
                    fx, fy, cx, cy, float(1.5 * cfg.orb.scale_factor)))
            flat = graphs.Readback([a for o in outs for a in o]).arrays()
            good, nb, col = _merge_chunks(
                [flat[i:i + 4] for i in range(0, len(flat), 4)], TRI_CHUNK)

        with self.timer.time("tri/apply"):
            N1 = f1.n
            rows = np.where(good)[0]
            elig_kids = np.array([e[0] for e in elig], np.int32)
            kid2_arr = elig_kids[nb[rows]]
            cols = col[rows].astype(np.int32)
            # re-triangulate the accepted matches on the host (f64 DLT;
            # the device already applied every gate to ITS triangulation)
            P1m = np.asarray(K.astype(np.float64) @ kf1.Tcw[:3, :4],
                             np.float32)
            X = np.zeros((N1, 3), np.float32)
            if len(rows):
                P2m = np.empty((len(rows), 3, 4), np.float32)
                uv2m = np.empty((len(rows), 2), np.float32)
                for k in np.unique(kid2_arr):
                    m = kid2_arr == k
                    kf2 = store.kfs[int(k)]
                    P2m[m] = (K.astype(np.float64)
                              @ kf2.Tcw[:3, :4]).astype(np.float32)
                    uv2m[m] = kf2.frame.xy[cols[m]]
                X[rows] = triangulate.triangulate_dlt_pairs_np(
                    P1m, P2m, f1.xy[rows], uv2m)
            # skip rows whose f1 feature is already bound, whose target
            # feature is already bound, or whose (kid2, col) slot an
            # earlier row of this batch already claimed
            keep = f1.mp_ids[rows] < 0
            for k in np.unique(kid2_arr):
                m = kid2_arr == k
                f2ids = store.kfs[int(k)].frame.mp_ids
                keep_m = keep[m] & (f2ids[cols[m]] < 0)
                first = np.zeros(int(m.sum()), bool)
                first[np.unique(cols[m], return_index=True)[1]] = True
                keep[m] = keep_m & first
            rows, kid2_arr, cols = rows[keep], kid2_arr[keep], cols[keep]
            new_pids = store.add_points_batch(
                pos=X[rows], desc=f1.desc[rows], kf1=kid, fi1=rows,
                kf2=kid2_arr, fi2=cols, first_frame=f1.frame_id)
            self.recent_points.extend(new_pids.tolist())
        with self.timer.time("tri/update_points"):
            store.update_points_batch(new_pids.tolist())
        with self.timer.time("tri/update_conn"):
            store.update_connections(kid)

    # ------------------------------------------------------------------
    def _fuse_neighbors(self, kid: int):
        """FusePointsInNeighbors (src/LocalMapping.cc:501-606): project
        neighbors' map points into this KF and vice versa, merging
        duplicates."""
        store = self.store
        with self.timer.time("fuse/collect"):
            targets = store.get_best_covisibles(kid, 20)
            second = []
            for t in targets:
                for t2 in store.get_best_covisibles(t, 5):
                    if t2 != kid and t2 not in targets and t2 not in second:
                        second.append(t2)
            all_targets = (targets + second)[:24]

            f0 = store.kfs[kid].frame
            own_arr = np.unique(f0.mp_ids[f0.mp_ids >= 0]).astype(np.int64)
            if len(own_arr):
                own_arr = own_arr[np.asarray(store.mp_valid[own_arr], bool)]
            if all_targets:
                allp = np.concatenate(
                    [store.kfs[t].frame.mp_ids for t in all_targets])
                allp = np.unique(allp[allp >= 0]).astype(np.int64)
                if len(allp):
                    allp = allp[np.asarray(store.mp_valid[allp], bool)]
                cand_arr = np.setdiff1d(allp, own_arr, assume_unique=True)
            else:
                cand_arr = np.zeros(0, np.int64)
            if len(cand_arr):
                kidm, _, nm = store.obs.rows(cand_arr)
                slot_ok = np.arange(kidm.shape[1])[None, :] < nm[:, None]
                has_kid = ((kidm == kid) & slot_ok).any(1)
                cand_arr = cand_arr[~has_kid]
            own = own_arr.tolist()
            cand = cand_arr.tolist()
        self._fuse_touched = []
        if all_targets and (own or cand):
            self._fuse_combined(kid, all_targets, own, cand)
        # one batched refresh of this KF's bindings and every merge winner
        with self.timer.time("fuse/update_points"):
            ids = store.kfs[kid].frame.mp_ids
            store.update_points_batch(
                np.unique(ids[ids >= 0]).tolist() + self._fuse_touched)
        with self.timer.time("fuse/update_conn"):
            store.update_connections(kid)

    def _fuse_combined(self, kid: int, target_kids: List[int],
                       own: List[int], cand: List[int]):
        """Forward fuse (this KF's points into every target, in chunks
        of FUSE_CHUNK targets) and reverse fuse (the targets' points
        into this KF), each a K2 search, one read of the compacted
        match lists, then the host merge."""
        store = self.store
        cfg = self.cfg
        f0 = store.kfs[kid].frame
        P1 = pad_bucket(len(own), cfg.pad_min_bound)
        own_rows = np.pad(np.asarray(own, np.int32), (0, P1 - len(own)),
                          constant_values=-1)
        P2 = pad_bucket(len(cand), cfg.pad_min_cand)
        cand_rows = np.pad(np.asarray(cand, np.int32),
                           (0, P2 - len(cand)), constant_values=-1)
        with self.timer.time("fuse/sync"):
            store.dev_points.sync(store)
            dp = store.dev_points.snapshot()
        n2 = max(store.kfs[t].frame.n for t in target_kids)
        chunks = []
        for c0 in range(0, len(target_kids), FUSE_CHUNK):
            sub = [store.kfs[t] for t in target_kids[c0:c0 + FUSE_CHUNK]]
            frames = [kf.frame for kf in sub]
            frames += [frames[0]] * (FUSE_CHUNK - len(sub))
            Tcw_s = np.tile(np.eye(4, dtype=np.float32), (FUSE_CHUNK, 1, 1))
            kvalid = np.zeros((FUSE_CHUNK, n2), bool)
            for b, kf in enumerate(sub):
                Tcw_s[b] = kf.Tcw
                kvalid[b, :kf.frame.n] = kf.frame.valid
            chunks.append((frames, Tcw_s, kvalid))
        pose0 = store.kfs[kid].Tcw.copy()
        geo = (float(cfg.cam.fx), float(cfg.cam.fy), float(cfg.cam.cx),
               float(cfg.cam.cy), undistorted_bounds(cfg.cam),
               cfg.orb.n_levels, self.log_scale, 3.0, 1.0)
        with self.timer.time("fuse/device"), store.unlocked():
            scales_d = self._const()[2]
            t = self._t
            own_d = t(own_rows)
            fwd = [self._fuse_fwd(
                *dp, own_d, t(Tcw_s),
                torch.stack([fr.dev_padded("xy", n2) for fr in frames]),
                torch.stack([fr.dev_padded("octave", n2) for fr in frames]),
                torch.stack([fr.dev_padded("desc", n2) for fr in frames]),
                t(kvalid), scales_d, *geo)
                for frames, Tcw_s, kvalid in chunks]
            rev = self._fuse_rev(
                *dp, t(cand_rows), t(pose0), f0.dev("xy"), f0.dev("octave"),
                f0.dev("desc"), f0.dev("valid"), scales_d, *geo)
            comp = [self._compact(m, FUSE_CAP) for m in fwd + [rev]]
            with self.timer.time("fuse/read"):
                host = graphs.Readback([a for c in comp for a in c]).arrays()
            # decoded as the JAX package does: the listed matches, or
            # the full matrix where a list overflowed
            dense = []
            for i, full in enumerate(fwd + [rev]):
                rows_c, feats_c, count = host[3 * i:3 * i + 3]
                count = int(count)
                if count > FUSE_CAP:
                    dense.append(graphs.Readback([full]).arrays()[0])
                    continue
                d = np.full(full.shape, -1, np.int16)
                d.reshape(-1)[rows_c[:count]] = feats_c[:count]
                dense.append(d)
        sfeat = np.concatenate(dense[:-1])
        with self.timer.time("fuse/apply"):
            for b, t in enumerate(target_kids):
                self._apply_fuse(t, own, sfeat[b])
                store.yield_lock()
            self._apply_fuse(kid, cand, dense[-1])

    def _apply_fuse(self, kid: int, pids: List[int], feat):
        """The fuse decision loop (ORBmatcher::Fuse tail,
        src/ORBmatcher.cc:1150-1216): replace or add observations.
        ``feat``: per-point matched feature index or -1."""
        store = self.store
        f = store.kfs[kid].frame
        n = len(pids)
        pid_arr = np.asarray(pids, np.int64)
        ridx = np.asarray(feat, np.int64)
        rows = np.where(ridx[:n] >= 0)[0]
        if len(rows) == 0:
            return
        alive = np.asarray(store.mp_valid[pid_arr[rows]], bool)
        rows = rows[alive]
        if len(rows) == 0:
            return
        kidm, _, nm = store.obs.rows(pid_arr[rows])
        slot_ok = np.arange(kidm.shape[1])[None, :] < nm[:, None]
        has_kid = ((kidm == kid) & slot_ok).any(1)
        rows = rows[~has_kid]
        feats = ridx[:n][rows]
        for j, feat_i in zip(rows, feats):
            pid = int(pid_arr[j])
            if kid in store.mp_obs[pid]:
                continue  # bound earlier in this very loop
            # re-read the binding per iteration: replace_point earlier in
            # this loop can rewrite THIS keyframe's mp_ids
            ex = f.mp_ids[int(feat_i)]
            if ex >= 0 and store.mp_valid[ex]:
                if ex == pid:
                    continue
                # keep the point with more observations
                if len(store.mp_obs[ex]) > len(store.mp_obs[pid]):
                    store.replace_point(pid, int(ex), refresh=False)
                    self._fuse_touched.append(int(ex))
                else:
                    store.replace_point(int(ex), pid, refresh=False)
                    self._fuse_touched.append(pid)
            else:
                store.add_observation(pid, kid, int(feat_i))
                self._fuse_touched.append(pid)

    # ------------------------------------------------------------------
    def _cull_keyframes(self, kid: int):
        """KeyFrameCulling (src/LocalMapping.cc:688-772): erase local
        covisible KFs where >= 90% of points are seen >= 3 times at the
        same or finer scale elsewhere.  A vectorized screen over all
        candidates, then an exact sequential re-check against live state
        before each erase (an erase can rescue a later candidate)."""
        store = self.store
        cands = [c for c in store.get_best_covisibles(kid, 10 ** 9)
                 if c != 0 and store.kfs[c].valid]
        if not cands:
            return
        per_cand = []          # (cand, fi, pids, levels)
        all_pids = []
        for cand in cands:
            f = store.kfs[cand].frame
            fi = np.where(f.mp_ids >= 0)[0]
            if len(fi) == 0:
                continue
            pids = f.mp_ids[fi].astype(np.int64)
            live = np.asarray(store.mp_valid[pids], bool)
            fi, pids = fi[live], pids[live]
            if len(fi) == 0:
                continue
            per_cand.append((cand, fi, pids, f.octave[fi].astype(np.int64)))
            all_pids.append(pids)
        if not per_cand:
            return
        store.yield_lock()  # camera-rate thread gets a slot
        upids = np.unique(np.concatenate(all_pids))
        L = int(self.cfg.orb.n_levels)
        kidm, fim, nm = store.obs.rows(upids)
        slot_ok = np.arange(kidm.shape[1])[None, :] < nm[:, None]
        obs_p, cols = np.nonzero(slot_ok)
        octs = store.octave_table()[kidm[obs_p, cols],
                                    fim[obs_p, cols]].astype(np.int64)
        np.clip(octs, 0, L - 1, out=octs)
        hist = np.bincount(obs_p * L + octs,
                           minlength=len(upids) * L).reshape(len(upids), L)
        cum = np.cumsum(hist, axis=1)          # obs with octave <= t
        flagged = []
        for cand, fi, pids, levels in per_cand:
            rows = np.searchsorted(upids, pids)
            thr = np.minimum(levels + 1, L - 1)
            # subtract the candidate's own observation
            n_redundant = int((cum[rows, thr] - 1 >= 3).sum())
            if n_redundant > self.cfg.kf_cull_redundancy * len(fi):
                flagged.append(cand)
        for cand in flagged:
            store.yield_lock()
            if self._cull_verify(cand):
                store.erase_keyframe(cand)

    def _cull_verify(self, cand: int) -> bool:
        """Exact redundancy check for one screened candidate against
        live state (src/LocalMapping.cc:688-772)."""
        store = self.store
        if not store.kfs[cand].valid:
            return False
        f = store.kfs[cand].frame
        fi = np.where(f.mp_ids >= 0)[0]
        if len(fi) == 0:
            return False
        pids = f.mp_ids[fi].astype(np.int64)
        live = np.asarray(store.mp_valid[pids], bool)
        fi, pids = fi[live], pids[live]
        if len(fi) == 0:
            return False
        levels = f.octave[fi]
        kidm, fim, nm = store.obs.rows(pids)
        slot_ok = (np.arange(kidm.shape[1])[None, :] < nm[:, None]) \
            & (kidm != cand)
        obs_l, cols = np.nonzero(slot_ok)
        if len(obs_l) == 0:
            return False
        octs = store.octave_table()[kidm[obs_l, cols],
                                    fim[obs_l, cols]].astype(np.int32)
        fine = octs <= levels[obs_l] + 1
        cnt = np.bincount(obs_l[fine], minlength=len(fi))
        return int((cnt >= 3).sum()) > self.cfg.kf_cull_redundancy * len(fi)


class AsyncMapper:
    """The reference's LocalMapping thread + keyframe queue
    (src/System.cc:96-100; src/LocalMapping.cc:161-167): tracking
    enqueues a keyframe id and keeps running while mapping (and loop
    closing, at the tail of ``process_keyframe``) runs here.
    Synchronization is ``MapStore.lock``.  Both threads use PyTorch's
    default stream, so their device work is serialized in launch order.

    An exception raised by the worker is re-raised on the tracking
    thread at the next ``process_keyframe`` / ``drain`` / ``stop``."""

    def __init__(self, mapper: LocalMapper):
        self.mapper = mapper
        self._q = queue.Queue()
        self._exc = None
        self._thread = threading.Thread(
            target=self._run, name="local_mapping", daemon=True)
        self._thread.start()

    def process_keyframe(self, kid: int):
        self._reraise()
        self._q.put(kid)

    def idle(self) -> bool:
        """LocalMapping::AcceptKeyFrames (src/LocalMapping.cc:572-583):
        no queued keyframe and none being processed.  The tracker's
        NeedNewKeyFrame gates monocular insertion on it
        (src/Tracking.cc:559-615)."""
        return self._q.unfinished_tasks == 0

    def _run(self):
        while True:
            kid = self._q.get()
            try:
                if kid is None:
                    return
                # materialize the new KF's host feature copies (a
                # device -> host read) before taking the map lock
                store = self.mapper.store
                if kid < len(store.kfs):
                    fr = store.kfs[kid].frame
                    _ = fr.desc, fr.octave, fr.xy, fr.angle, fr.valid
                self.mapper.process_keyframe(
                    kid, queue_pressure=not self._q.empty())
            except Exception as e:  # re-raised on the caller's thread
                self._exc = e
            finally:
                self._q.task_done()

    def _reraise(self):
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def drain(self):
        """Block until the queue is empty (LocalMapping idle), then
        re-raise any worker exception."""
        self._q.join()
        self._reraise()

    def stop(self):
        """System::Shutdown thread join (src/System.cc:173-192)."""
        self._q.put(None)
        self._thread.join()
        self._reraise()
