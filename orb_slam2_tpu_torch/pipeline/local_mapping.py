"""Local mapping: map-point culling, triangulation of new points,
fusion, structure-only BA, keyframe culling — in torch.

Port of the sequential ``LocalMapper`` of
``orb_slam2_tpu/pipeline/local_mapping.py`` (src/LocalMapping.cc).  The
stage order per keyframe is LocalMapping::Run's
(src/LocalMapping.cc:78-158): Process -> MapPointCulling ->
CreateNewMapPoints -> FusePointsInNeighbors -> LocalBA (structure only:
the fork fixes every pose) -> KeyFrameCulling.

Triangulation searches every neighbor with kernel K3; fuse projects
points into every target with kernel K2.  The JAX package stacks the
neighbors/targets and runs them with ``lax.map`` in fixed-size chunks
with compacted readbacks for its slow chip link; the port loops over
them and reads the results directly.  Loop closing runs at the tail of
each keyframe (``on_keyframe_processed``).

:class:`AsyncMapper` is the reference's LocalMapping thread: tracking
enqueues keyframes and mapping (with loop closing) runs on a worker
thread.  ``LocalMapper.process_keyframe`` holds ``store.lock`` and
drops it around each device dispatch + read window and at stage
boundaries, so the tracker only waits on short host sections.  Both
threads launch on PyTorch's default stream, which serializes their
device work.  Full (pose-optimizing) local BA is a later slice.
"""
from __future__ import annotations

import queue
import threading
from typing import List

import numpy as np
import torch

from ..geom import triangulate
from ..matching import search, frustum
from ..models.mapstore import MapStore
from ..optim import points_opt
from ..ops.extractor import level_sigma2
from ..ops.pyramid import scale_factors as pyramid_scale_factors
from .config import SlamConfig
from .tracking import pad_bucket
from ..utils.logging import get_logger, StageTimer

log = get_logger("local_mapping")


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


def _fuse_one(pos, normal, min_d, max_d, pvalid, desc,
              Tcw, kxy, koct, kdesc, kvalid,
              scale_factors, fx, fy, cx, cy, bounds,
              n_levels, log_scale, th=3.0, ratio=1.0):
    """Project a point set into one keyframe and search it (kernel K2);
    returns the matched feature per point, or -1, with the TH_LOW
    merge gate applied."""
    fr = frustum.is_in_frustum(
        pos, normal, min_d, max_d, pvalid, Tcw,
        fx, fy, cx, cy, bounds, n_levels, log_scale)
    r = search.search_by_projection_local_map(
        fr.uv, fr.pred_level, fr.view_cos, desc, fr.visible,
        kxy, koct, kdesc, kvalid, torch.zeros_like(kvalid),
        scale_factors, th=th, ratio=ratio)
    return torch.where(r.valid & (r.dist <= 50), r.idx,
                       torch.full_like(r.idx, -1))


def _gather_rows(pt_pos, pt_desc, pt_normal, pt_min, pt_max, pt_alive,
                 rows):
    """Gather a padded row-index vector (-1 = empty slot) from the
    device point store."""
    r = rows.clamp(min=0).long()
    return (pt_pos[r], pt_normal[r], pt_min[r], pt_max[r],
            (rows >= 0) & pt_alive[r], pt_desc[r])


def _triangulate_neighbors(
        xy1, desc1, valid1, octave1, Tcw1,
        xy2_s, desc2_s, valid2_s, oct2_s,
        F12_s, epi_s, Tcw2_s, o2_s,
        K, sigma2, scale_factors,
        fx, fy, cx, cy, scale_ratio_factor):
    """The device side of CreateNewMapPoints:

    1. the epipolar-gated search (kernel K3) against every neighbor,
    2. first-neighbor-wins pair selection per KF1 row (the reference
       binds a feature to the first neighbor that matches it,
       src/LocalMapping.cc:327-346),
    3. per-pair DLT triangulation with that neighbor's camera,
    4. depth/reprojection/parallax gates + the scale-consistency gate
       (src/LocalMapping.cc:380-470).

    Neighbor tensors are stacked (B, n2, ...).  Returns per KF1 row
    (good, nb, col, has)."""
    sidx, svalid = [], []
    for b in range(xy2_s.shape[0]):
        r = search.search_for_triangulation(
            xy1, desc1, valid1, octave1,
            xy2_s[b], desc2_s[b], valid2_s[b], oct2_s[b],
            F12_s[b], epi_s[b], sigma2, scale_factors)
        sidx.append(r.idx)
        svalid.append(r.valid)
    sidx = torch.stack(sidx)
    svalid = torch.stack(svalid)

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
    return good, nb, col, has


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


def run_structure_ba(store: MapStore, kf_ids: List[int], cfg: SlamConfig,
                     iters: int = 10, timer: StageTimer | None = None):
    """Fixed-pose local BA == independent point refinement
    (src/Optimizer.cc:328-637 with fixedPose=true), on the store's
    device.  Measurements gather on the device from the keyframes'
    feature tensors; only index vectors are uploaded."""
    timer = timer or StageTimer()
    dev = store.device
    inv_sigma2 = (1.0 / level_sigma2(cfg.orb)).astype(np.float32)
    with timer.time("sba/gather"):
        pids, packed = gather_ba_problem(store, kf_ids, inv_sigma2)
    if packed is None or len(pids) == 0:
        return
    obs_kf, obs_pt, _, _, meta = packed
    meta_kid, meta_fi = meta
    points0 = np.asarray(store.mp_pos[np.asarray(pids, np.int64)])
    poses = np.stack([store.kfs[k].Tcw for k in kf_ids]).astype(np.float32)
    fx, fy, cx, cy = (float(cfg.cam.fx), float(cfg.cam.fy),
                      float(cfg.cam.cx), float(cfg.cam.cy))
    n2 = max(store.kfs[k].frame.n for k in kf_ids)
    with timer.time("sba/device"), store.unlocked():
        xy_stack = torch.stack(
            [store.kfs[k].frame.dev_padded("xy", n2) for k in kf_ids])
        oct_stack = torch.stack(
            [store.kfs[k].frame.dev_padded("octave", n2) for k in kf_ids])
        obs_cam = torch.as_tensor(obs_kf.astype(np.int64), device=dev)
        obs_fi = torch.as_tensor(meta_fi.astype(np.int64), device=dev)
        isig = torch.as_tensor(inv_sigma2, device=dev)
        res = points_opt.optimize_points(
            torch.as_tensor(points0, device=dev),
            torch.as_tensor(obs_pt.astype(np.int64), device=dev),
            torch.as_tensor(poses, device=dev),
            xy_stack[obs_cam, obs_fi],
            isig[oct_stack[obs_cam, obs_fi].long()],
            torch.ones(len(obs_kf), dtype=torch.bool, device=dev),
            fx, fy, cx, cy, iters=iters, obs_cam=obs_cam)
        new_pts = res.points.cpu().numpy()
        inl = res.obs_inlier.cpu().numpy()
    with timer.time("sba/apply"):
        store.mp_pos[np.asarray(pids, np.int64)] = new_pts
        # erase outlier observations (the reference's post-BA edge
        # removal, src/Optimizer.cc:560-600)
        for o in np.where(~inl)[0]:
            pid = pids[obs_pt[o]]
            if store.mp_valid[pid]:
                store.erase_observation(pid, int(meta_kid[o]))
        store.update_points_batch(pids)


def run_local_ba(store: MapStore, center_kf: int, cfg: SlamConfig,
                 iters: int = 10, timer: StageTimer | None = None):
    """LocalBundleAdjustment (src/Optimizer.cc:328-637) over the center
    keyframe and its covisibles with every pose fixed, as the fork runs
    it: structure-only BA (the pose-optimizing form is a later slice)."""
    local = [center_kf] + [k for k in store.covis[center_kf]
                           if store.kfs[k].valid]
    run_structure_ba(store, local, cfg, iters=iters, timer=timer)


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

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.store.device)

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
                                 iters=self.cfg.local_ba_iters,
                                 timer=self.timer)
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
            n2 = max(store.kfs[e[0]].frame.n for e in elig)
            frames2 = [store.kfs[e[0]].frame for e in elig]
            valid2 = np.zeros((len(elig), n2), bool)
            for b, f2 in enumerate(frames2):
                valid2[b, :f2.n] = (f2.mp_ids < 0) & f2.valid

            Tcw1 = kf1.Tcw.copy()
            Tcw2 = np.stack([store.kfs[e[0]].Tcw for e in elig]).astype(
                np.float32)

        with self.timer.time("tri/device"), store.unlocked():
            good, nb, col, _ = _triangulate_neighbors(
                f1.dev("xy"), f1.dev("desc"), self._t(unbound1),
                f1.dev("octave"), self._t(Tcw1),
                torch.stack([fr.dev_padded("xy", n2) for fr in frames2]),
                torch.stack([fr.dev_padded("desc", n2) for fr in frames2]),
                self._t(valid2),
                torch.stack([fr.dev_padded("octave", n2) for fr in frames2]),
                self._t(np.stack([e[1] for e in elig])),
                self._t(np.stack([e[2] for e in elig])),
                self._t(Tcw2),
                self._t(np.stack([e[3] for e in elig]).astype(np.float32)),
                self._t(K.astype(np.float32)),
                self._t(self.sigma2.astype(np.float32)),
                self._t(self.scale_factors.astype(np.float32)),
                fx, fy, cx, cy, float(1.5 * cfg.orb.scale_factor))
            good = good.cpu().numpy()
            nb = nb.cpu().numpy().astype(np.int64)
            col = col.cpu().numpy().astype(np.int64)

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
        """Forward fuse (this KF's points into every target) and reverse
        fuse (the targets' points into this KF), each a K2 search, then
        the host merge."""
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
        fx, fy, cx, cy = (float(cfg.cam.fx), float(cfg.cam.fy),
                          float(cfg.cam.cx), float(cfg.cam.cy))
        from ..geom.camera import undistorted_bounds
        geo = dict(scale_factors=self._t(self.scale_factors),
                   fx=fx, fy=fy, cx=cx, cy=cy,
                   bounds=undistorted_bounds(cfg.cam),
                   n_levels=cfg.orb.n_levels, log_scale=self.log_scale)
        poses = [store.kfs[t].Tcw.copy() for t in target_kids]
        pose0 = store.kfs[kid].Tcw.copy()
        frames = [store.kfs[t].frame for t in target_kids]
        with self.timer.time("fuse/device"), store.unlocked():
            own_pts = _gather_rows(*dp, self._t(own_rows))
            fwd = []
            for fr, T in zip(frames, poses):
                fwd.append(_fuse_one(
                    *own_pts, self._t(T), fr.dev("xy"),
                    fr.dev("octave"), fr.dev("desc"), fr.dev("valid"),
                    **geo))
            rev = _fuse_one(
                *_gather_rows(*dp, self._t(cand_rows)),
                self._t(pose0), f0.dev("xy"), f0.dev("octave"),
                f0.dev("desc"), f0.dev("valid"), **geo)
            with self.timer.time("fuse/read"):
                sfeat = torch.stack(fwd).cpu().numpy()
                rev_feat = rev.cpu().numpy()
        with self.timer.time("fuse/apply"):
            for b, t in enumerate(target_kids):
                self._apply_fuse(t, own, sfeat[b])
                store.yield_lock()
            self._apply_fuse(kid, cand, rev_feat)

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
