"""Relocalization after tracking loss — port of
``orb_slam2_tpu/pipeline/relocalization.py`` (Tracking::Relocalization,
src/Tracking.cc:1150-1259).

Candidates are the BoW relocalization candidates united with the recent
keyframes (Map::GetLastKeyFrames, src/Map.cc:175, the fork's addition).
Per candidate a BoW descriptor match (>= 15), then verification:

- pose-prior mode (the fork): bind the matches and gate them by
  reprojection chi2 against the trusted input pose; success at >= 50
  good matches (src/Tracking.cc:1204-1246).
- estimated mode (upstream ORB-SLAM2): EPnP + RANSAC on the 3D-2D
  matches (``optim/pnp.py``), LM pose optimization, a projection search
  when the inliers land in [10, 50), success at >= 50 inliers.  The
  RANSAC samples are drawn on the host from ``default_rng(1)``, as the
  JAX package draws them, so both packages see the same.

The device programs replay CUDA graphs on the card: the BoW match and
the pose optimization share the tracker's (``tracking.descriptors_graph``,
``tracking.pose_opt_graph``), the EPnP RANSAC and the projection search
have their own.  Every upload goes through pinned memory
(``graphs.upload``) and each program's results come back through one
``graphs.Readback``, so nothing waits for the card but those reads.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .. import graphs
from ..matching import search
from ..models.frame import Frame
from ..models.mapstore import MapStore
from ..optim import pnp
from . import tracking
from .config import SlamConfig
from .place_recognition import PlaceRecognition
from .tracking import pad_bucket
from ..utils.logging import get_logger

log = get_logger("relocalization")


# the relocalizer's own programs as CUDA graphs (the JAX package's
# jitted pnp_ransac and SearchByProjection(CurrentFrame, KF)); each
# looks its function up at each call
pnp_graph = graphs.graphed(lambda *a: pnp.pnp_ransac(*a), "pnp_ransac")
kf_projection_graph = graphs.graphed(
    lambda *a: search.search_by_projection_last_frame(*a),
    "kf_projection_search")


class Relocalizer:
    def __init__(self, cfg: SlamConfig, store: MapStore,
                 pr: PlaceRecognition):
        self.cfg = cfg
        self.store = store
        self.pr = pr
        cam = cfg.cam
        self._cam_tuple = (float(cam.fx), float(cam.fy),
                           float(cam.cx), float(cam.cy))
        from ..ops.extractor import level_sigma2, pyramid
        self.inv_sigma2 = (1.0 / level_sigma2(cfg.orb)).astype(np.float32)
        self.scale_factors = pyramid.scale_factors(
            cfg.orb.n_levels, cfg.orb.scale_factor)[0].astype(np.float32)
        self._rng = np.random.default_rng(1)
        self._dev = {}      # device -> (inv_sigma2, scale_factors) there

    def _tables(self, device):
        """The levels' inverse sigma^2 and scale factors on ``device``,
        uploaded once."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = (graphs.upload(self.inv_sigma2, device),
                              graphs.upload(self.scale_factors, device))
        return self._dev[key]

    # ------------------------------------------------------------------
    def _candidates(self, frame: Frame) -> List[int]:
        store = self.store
        out: List[int] = []
        bow = self.pr.frame_bow_f(frame)
        if bow is not None:
            out.extend(self.pr.reloc_candidates(bow))
        # recent keyframes by source-frame id (Map::GetLastKeyFrames)
        lo = frame.frame_id - self.cfg.reloc_recent_kf_window
        for kf in store.kfs:
            if kf.valid and lo <= kf.frame.frame_id < frame.frame_id \
                    and kf.kid not in out:
                out.append(kf.kid)
        return out

    def _bow_match(self, kid: int, frame: Frame):
        """SearchByBoW(KF, F): KF's map-point features vs the frame's
        features.  Returns (feat_kf, feat_frame) index arrays."""
        store = self.store
        fk = store.kfs[kid].frame
        ids = np.array([i for i, p in enumerate(fk.mp_ids)
                        if p >= 0 and store.mp_valid[p]], np.int32)
        if len(ids) == 0:
            return ids, ids
        n = pad_bucket(len(ids))
        pad = n - len(ids)
        v = np.zeros(n, bool)
        v[:len(ids)] = True
        dev = frame.device
        t = lambda a: graphs.upload(a, dev)  # noqa: E731
        # FeatureVector-style node blocking (src/ORBmatcher.cc:222-392)
        # when both sides have vocabulary node ids
        nk = self.pr.compute_nodes(fk)
        nf = self.pr.compute_nodes(frame) if nk is not None else None
        node1 = (t(np.pad(nk[ids], (0, pad), constant_values=-1))
                 if nf is not None else None)
        node2 = t(nf) if nf is not None else None
        res = tracking.descriptors_graph(
            t(np.pad(fk.desc[ids], ((0, pad), (0, 0))).view(np.int32)),
            t(v), t(np.pad(fk.angle[ids], (0, pad))), node1,
            frame.dev("desc"), frame.dev("valid"), frame.dev("angle"), node2,
            0.75)
        valid, idx = (a[:len(ids)] for a in graphs.Readback(
            (res.valid, res.idx)).arrays())
        rows = np.where(valid)[0]
        return ids[rows], idx[rows]

    # ------------------------------------------------------------------
    def __call__(self, frame: Frame) -> bool:
        store = self.store
        fx, fy, cx, cy = self._cam_tuple
        for kid in self._candidates(frame):
            feat_kf, feat_fr = self._bow_match(kid, frame)
            if len(feat_kf) < self.cfg.track_refkf_min_matches:
                continue
            fk = store.kfs[kid].frame
            pids = np.array([fk.mp_ids[i] for i in feat_kf], np.int32)
            pts_w = np.asarray(store.mp_pos[pids.astype(np.int64)])
            uv = frame.xy[feat_fr]
            isig = self.inv_sigma2[frame.octave[feat_fr]]
            if self.cfg.pose_prior:
                # trusted-pose verification (src/Tracking.cc:1204-1246)
                pc = pts_w @ frame.Tcw[:3, :3].T + frame.Tcw[:3, 3]
                z = pc[:, 2]
                u = fx * pc[:, 0] / np.maximum(z, 1e-9) + cx
                v = fy * pc[:, 1] / np.maximum(z, 1e-9) + cy
                err2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
                good = (z > 0) & (err2 * isig <= self.cfg.chi2_mono)
                if good.sum() < self.cfg.track_local_min_inliers_reloc:
                    continue
                frame.mp_ids[:] = -1
                for j in np.where(good)[0]:
                    frame.mp_ids[feat_fr[j]] = pids[j]
                log.info("relocalized frame %d against KF %d (%d good)",
                         frame.frame_id, kid, int(good.sum()))
                return True

            # --- estimated mode: EPnP + RANSAC ---
            padn = pad_bucket(len(pids), 64) - len(pids)
            samples = self._rng.integers(0, len(pids), (128, 4)).astype(
                np.int32)
            dev = frame.device
            t = lambda a: graphs.upload(a, dev)  # noqa: E731
            # the samples are a tensor input of the graph, not a
            # constant of its capture
            rr = pnp_graph(
                t(np.pad(pts_w, ((0, padn), (0, 0)))),
                t(np.pad(uv, ((0, padn), (0, 0)))),
                t(np.pad(isig, (0, padn))),
                t(np.pad(np.ones(len(pids), bool), (0, padn))),
                t(samples), fx, fy, cx, cy, 10)
            ok, Tcw, inl = graphs.Readback(
                (rr.ok, rr.Tcw, rr.inliers)).arrays()
            if not ok:
                continue
            frame.Tcw = np.array(Tcw)  # owned: no pinned block stays held
            inl = inl[:len(pids)]
            frame.mp_ids[:] = -1
            frame.mp_ids[feat_fr[inl]] = pids[inl]
            good = self._pose_optimize(frame)
            if good < 10:
                continue
            if good < self.cfg.track_local_min_inliers_reloc:
                # projection-search escalation (upstream: SearchByProjection
                # with th=10, then the pose optimization again)
                self._project_kf_points(kid, frame, th=10.0)
                good = self._pose_optimize(frame)
            if good >= self.cfg.track_local_min_inliers_reloc:
                log.info("relocalized frame %d against KF %d via EPnP "
                         "(%d inliers)", frame.frame_id, kid, good)
                return True
        return False

    # ------------------------------------------------------------------
    def _pose_optimize(self, frame: Frame) -> int:
        """Motion-only LM over the frame's bindings, the keypoints
        gathered on the device (the tracker's graph of
        ``tracking._pose_opt_fused``); unbinds outliers.  Returns the
        inlier count."""
        bound = np.where(frame.mp_ids >= 0)[0]
        if len(bound) < 3:
            return 0
        pos = np.asarray(self.store.mp_pos[frame.mp_ids[bound]])
        pad = pad_bucket(len(bound)) - len(bound)
        fx, fy, cx, cy = self._cam_tuple
        dev = frame.device
        t = lambda a: graphs.upload(a, dev)  # noqa: E731
        res = tracking.pose_opt_graph(
            t(frame.Tcw), t(np.pad(pos, ((0, pad), (0, 0)))),
            t(np.pad(bound, (0, pad))),
            frame.dev("xy"), frame.dev("octave"), self._tables(dev)[0],
            t(np.pad(np.ones(len(bound), bool), (0, pad))),
            fx, fy, cx, cy)
        Tcw, inl = graphs.Readback((res.Tcw, res.inliers)).arrays()
        frame.Tcw = np.array(Tcw)      # owned: no pinned block stays held
        inl = inl[:len(bound)]
        frame.mp_ids[bound[~inl]] = -1
        return int(inl.sum())

    def _project_kf_points(self, kid: int, frame: Frame, th: float):
        """SearchByProjection(CurrentFrame, KF, found, th, dist)
        (src/ORBmatcher.cc:1800-1940): bind more of the keyframe's map
        points by projection with the current pose estimate."""
        store = self.store
        fk = store.kfs[kid].frame
        already = set(int(p) for p in frame.mp_ids if p >= 0)
        ids = np.array([i for i, p in enumerate(fk.mp_ids)
                        if p >= 0 and store.mp_valid[p]
                        and p not in already], np.int32)
        if len(ids) == 0:
            return
        pos = np.asarray(store.mp_pos[fk.mp_ids[ids]])
        fx, fy, cx, cy = self._cam_tuple
        pc = pos @ frame.Tcw[:3, :3].T + frame.Tcw[:3, 3]
        z = pc[:, 2]
        uv = np.stack([fx * pc[:, 0] / np.maximum(z, 1e-9) + cx,
                       fy * pc[:, 1] / np.maximum(z, 1e-9) + cy], -1)
        pad = pad_bucket(len(ids)) - len(ids)
        mp_valid = np.zeros(len(ids) + pad, bool)
        mp_valid[:len(ids)] = z > 0
        dev = frame.device
        t = lambda a: graphs.upload(a, dev)  # noqa: E731
        res = kf_projection_graph(
            t(np.pad(uv.astype(np.float32), ((0, pad), (0, 0)))),
            t(np.pad(fk.octave[ids], (0, pad)).astype(np.int64)),
            t(np.pad(fk.desc[ids], ((0, pad), (0, 0))).view(np.int32)),
            t(mp_valid),
            t(np.pad(fk.angle[ids], (0, pad))),
            frame.dev("xy"), frame.dev("octave"), frame.dev("desc"),
            frame.dev("valid") & t(frame.mp_ids < 0), frame.dev("angle"),
            self._tables(dev)[1], float(th))
        rvalid, ridx = (a[:len(ids)] for a in graphs.Readback(
            (res.valid, res.idx)).arrays())
        for j in np.where(rvalid)[0]:
            frame.mp_ids[ridx[j]] = fk.mp_ids[ids[j]]
