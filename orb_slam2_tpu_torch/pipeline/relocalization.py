"""Relocalization after tracking loss, pose-prior mode — port of
``orb_slam2_tpu/pipeline/relocalization.py`` (Tracking::Relocalization,
src/Tracking.cc:1150-1259, in the reference fork's form).

Candidates are the BoW relocalization candidates united with the recent
keyframes (Map::GetLastKeyFrames, src/Map.cc:175, the fork's addition).
Per candidate a BoW descriptor match (>= 15), then the fork's
verification against the trusted input pose: bind the matches and gate
them by reprojection chi2; success at >= 50 good matches
(src/Tracking.cc:1204-1246).

The estimated-pose branch (EPnP + RANSAC, pose optimization, projection
escalation) belongs to estimated-pose mode, which the port does not have
yet: a Relocalizer built with ``pose_prior=False`` raises.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..matching import search
from ..models.frame import Frame
from ..models.mapstore import MapStore
from .config import SlamConfig
from .place_recognition import PlaceRecognition
from .tracking import pad_bucket
from ..utils.logging import get_logger

log = get_logger("relocalization")


class Relocalizer:
    def __init__(self, cfg: SlamConfig, store: MapStore,
                 pr: PlaceRecognition):
        if not cfg.pose_prior:
            raise NotImplementedError(
                "estimated-mode relocalization (EPnP + pose optimization) "
                "is not ported yet")
        self.cfg = cfg
        self.store = store
        self.pr = pr
        cam = cfg.cam
        self._cam_tuple = (float(cam.fx), float(cam.fy),
                           float(cam.cx), float(cam.cy))
        from ..ops.extractor import level_sigma2
        self.inv_sigma2 = (1.0 / level_sigma2(cfg.orb)).astype(np.float32)

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
        # FeatureVector-style node blocking (src/ORBmatcher.cc:222-392)
        # when both sides have vocabulary node ids
        nk = self.pr.compute_nodes(fk)
        nf = self.pr.compute_nodes(frame) if nk is not None else None
        node1 = (torch.as_tensor(np.pad(nk[ids], (0, pad), constant_values=-1),
                                 device=dev) if nf is not None else None)
        node2 = torch.as_tensor(nf, device=dev) if nf is not None else None
        res = search.search_descriptors(
            torch.as_tensor(np.pad(fk.desc[ids], ((0, pad), (0, 0)))
                            .view(np.int32), device=dev),
            torch.as_tensor(v, device=dev),
            torch.as_tensor(np.pad(fk.angle[ids], (0, pad)), device=dev),
            node1,
            frame.dev("desc"), frame.dev("valid"), frame.dev("angle"), node2,
            ratio=0.75).host()
        rows = np.where(res.valid[:len(ids)])[0]
        return ids[rows], res.idx[:len(ids)][rows]

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
        return False
