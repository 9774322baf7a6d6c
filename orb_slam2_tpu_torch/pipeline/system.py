"""System facade — port of ``orb_slam2_tpu/pipeline/system.py``
(src/System.cc).

Wires Tracking + LocalMapping + LoopClosing over one MapStore on one
torch device and exposes the two tracking entry points:

- ``track_monocular_with_pose(image, timestamp, Tcw)``, the reference
  fork's public API (include/System.h:69-71), with the extraction
  prefetch of pipelined tracking (``prefetch``, ``next_image``,
  ``flush_tracking``);
- ``track_monocular(image, timestamp)``, upstream ORB-SLAM2's
  estimated-pose tracking.

Plus the fork's map export (SaveMap / SaveTrackedMap PLYs through the
real-world transform, src/System.cc:212-322), map checkpoint and resume
(``save_map`` / ``load_map``) and localization-only mode.  Place
recognition (the vocabulary and BoW database) backs both loop closing
and relocalization.  ``async_mapping=True`` runs
local mapping and loop closing on a worker thread fed by a keyframe
queue (src/System.cc:96-109); the default is the deterministic
sequential pipeline.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..models.frame import Frame, FrameFactory
from ..models.mapstore import MapStore
from .config import SlamConfig
from .local_mapping import AsyncMapper, LocalMapper
from .loop_closing import LoopCloser
from .place_recognition import PlaceRecognition
from .relocalization import Relocalizer
from .tracking import Tracker, TrackState


class System:
    def __init__(self, config: SlamConfig, enable_loop_closing: bool = True,
                 vocab=None, async_mapping: bool = False, device="cuda"):
        self.cfg = config
        self.device = torch.device(device)
        self.store = self._new_store()
        self.factory = FrameFactory(config.cam, config.orb,
                                    device=self.device)
        self.tracker = Tracker(config, self.store, self.factory)
        self.mapper = LocalMapper(config, self.store)
        self.map_worker = None
        if async_mapping:
            self.map_worker = AsyncMapper(self.mapper)
            self.tracker.mapping_idle = self.map_worker.idle

        self.place_rec = PlaceRecognition(self.store, vocab=vocab)
        self.store.on_kf_erased = self.place_rec.erase_keyframe
        self.relocalizer = Relocalizer(config, self.store, self.place_rec)
        self.tracker.relocalize = self.relocalizer

        self.loop_closer = None
        if enable_loop_closing:
            self.loop_closer = LoopCloser(config, self.store,
                                          place_rec=self.place_rec)
            self.mapper.on_keyframe_processed = \
                self.loop_closer.process_keyframe
        else:
            # still feed the BoW database so relocalization works
            self.mapper.on_keyframe_processed = self.place_rec.add_keyframe

        self.tracker.on_new_keyframe = self._on_new_keyframe
        self.tracker.on_reset = self.reset
        self.trajectory: List[tuple] = []  # (frame_id, timestamp, Tcw, state)
        self._prefetched = None  # the next image's queued extraction
        # world -> real-world transform (System::SetRealTransform,
        # include/System.h:171-173)
        self.real_transform = np.eye(4, dtype=np.float32)
        # the image of the latest track_* call, as the caller passed it
        # (the tracked-map PLY samples its colors there)
        self._last_image = None
        # called as on_frame_tracked(image, frame) after every track_*
        # call (the reference's Viewer reads the same per-frame state,
        # FrameDrawer::Update, src/FrameDrawer.cc:51-90)
        self.on_frame_tracked = None

    def _new_store(self) -> MapStore:
        store = MapStore(dev_capacity=self.cfg.device_point_capacity,
                         device=self.device)
        store.set_scale_info(self.cfg.orb.scale_factor, self.cfg.orb.n_levels)
        return store

    def _on_new_keyframe(self, kid: int):
        if self.map_worker is not None:
            self.map_worker.process_keyframe(kid)  # enqueue, don't stall
        else:
            self.mapper.process_keyframe(kid)

    def flush_tracking(self):
        """Commit any in-flight pipelined frame (no-op unless
        cfg.pipelined_tracking)."""
        self.tracker.flush()

    def flush_mapping(self):
        """Block until all queued keyframes are mapped (no-op in the
        sequential pipeline); re-raises a mapping-thread exception."""
        if self.map_worker is not None:
            self.map_worker.drain()

    def prefetch(self, image) -> None:
        """Queue the ORB extraction of the NEXT frame on the device; the
        following track_* call consumes it.  The device extracts while
        the host does the current frame's bookkeeping."""
        init_mode = self.tracker.state in (TrackState.NO_IMAGES_YET,
                                           TrackState.NOT_INITIALIZED)
        self._prefetched = self.factory.start(image, init_mode=init_mode)

    def _take_prefetch(self):
        p, self._prefetched = self._prefetched, None
        return p

    def track_monocular_with_pose(self, image, timestamp: float,
                                  Tcw: np.ndarray,
                                  next_image=None) -> Frame:
        """System::TrackMonocularWithPose (src/System.cc:237-258).
        ``image``: (H, W) uint8/float32 numpy array or tensor.

        ``next_image``: the look-ahead frame; its extraction is queued
        after this frame's tracking step and its result copies, before
        their results are read."""
        self._last_image = image
        hook = None
        if next_image is not None:
            hook = lambda: self.prefetch(next_image)  # noqa: E731
        frame = self.tracker.track(image, timestamp,
                                   pose_prior=np.asarray(Tcw, np.float32),
                                   started=self._take_prefetch(),
                                   pre_read_hook=hook)
        self._record(frame)
        return frame

    def track_monocular(self, image, timestamp: float = 0.0,
                        pose_hint: Optional[np.ndarray] = None) -> Frame:
        """Upstream-style tracking (estimated-pose mode).  ``pose_hint``
        may supply poses for the two bootstrap frames (the monocular
        scale and gauge anchor); it is ignored once the map is
        initialized."""
        self._last_image = image
        hint = None
        if self.tracker.state in (TrackState.NO_IMAGES_YET,
                                  TrackState.NOT_INITIALIZED) \
                and pose_hint is not None:
            hint = np.asarray(pose_hint, np.float32)
        frame = self.tracker.track(image, timestamp, pose_prior=hint,
                                   started=self._take_prefetch())
        self._record(frame)
        return frame

    def _record(self, frame: Frame):
        self.trajectory.append((frame.frame_id, frame.timestamp,
                                frame.Tcw.copy(), self.tracker.state))
        if self.on_frame_tracked is not None:
            self.on_frame_tracked(self._last_image, frame)

    def reset(self):
        """System/Tracking::Reset (src/Tracking.cc:1009-1052)."""
        self.tracker._pending = []  # drop the in-flight pipelined steps
        self.tracker._chain = None
        self.flush_mapping()  # the reference's blocking reset handshake
        self.store = self._new_store()
        self.tracker.store = self.store
        self.mapper.store = self.store
        self.mapper.recent_points = []
        self.place_rec = PlaceRecognition(self.store,
                                          vocab=self.place_rec.vocab)
        self.store.on_kf_erased = self.place_rec.erase_keyframe
        self.relocalizer.store = self.store
        self.relocalizer.pr = self.place_rec
        if self.loop_closer is not None:
            self.loop_closer.store = self.store
            self.loop_closer.pr = self.place_rec
            self.loop_closer.last_loop_kf_id = 0
            self.loop_closer.consistent_groups = []
        else:
            self.mapper.on_keyframe_processed = self.place_rec.add_keyframe
        self.tracker.state = TrackState.NO_IMAGES_YET
        self.tracker.init_frame = None
        self.tracker.last_frame = None
        self.tracker.ref_kf = -1
        self.tracker.velocity = None
        self.tracker._prep = None

    @property
    def state(self) -> TrackState:
        return self.tracker.state

    def shutdown(self):
        """System::Shutdown (src/System.cc:173-192): commit the in-flight
        pipelined frames, join the mapping worker, then wait for the
        device."""
        self.tracker.flush()
        if self.map_worker is not None:
            self.map_worker.drain()
            self.map_worker.stop()
            self.map_worker = None
            self.tracker.mapping_idle = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def timing_report(self) -> str:
        """Per-stage wall-clock summary (tracking, mapping, loop
        closing timers)."""
        timers = [("tracker", self.tracker.timer),
                  ("mapper", self.mapper.timer)]
        if self.loop_closer is not None:
            timers.append(("loop", self.loop_closer.timer))
        out = []
        for name, timer in timers:
            s = timer.summary()
            if s:
                out.append(f"[{name}]\n{s}")
        return "\n".join(out)

    def keyframe_trajectory(self):
        """(kid, Tcw) for valid keyframes."""
        return [(kf.kid, kf.Tcw.copy()) for kf in self.store.kfs if kf.valid]

    def camera_centers(self) -> np.ndarray:
        """The camera center of every tracked frame, in call order."""
        return np.asarray([-Tcw[:3, :3].T @ Tcw[:3, 3]
                           for _, _, Tcw, _ in self.trajectory])

    def map_points(self) -> np.ndarray:
        valid = np.asarray(self.store.mp_valid, bool)
        if not valid.any():
            return np.zeros((0, 3), np.float32)
        return np.asarray(self.store.mp_pos)[valid]

    def save_map_ply(self, path: str):
        """SaveMap (src/System.cc:212-234): binary PLY of all valid map
        points, transformed by the real-world transform."""
        from ..utils import ply
        T = self.real_transform
        ply.write_ply_points(path, self.map_points() @ T[:3, :3].T + T[:3, 3])

    def tracked_points(self):
        """GetTrackedMapPoints/GetTrackedKeyPointsUn (include/System.h:
        95-101): (pids, feature_idx) of the last frame's live bindings,
        from its host fields."""
        frame = self.tracker.last_frame
        if frame is None:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        ids = np.asarray(frame.mp_ids)
        bound = (ids >= 0) & ~np.asarray(frame.mp_outlier, bool)
        live = np.zeros_like(bound)
        live[bound] = np.asarray(self.store.mp_valid, bool)[ids[bound]]
        feat = np.flatnonzero(live).astype(np.int32)
        return ids[feat].astype(np.int32), feat

    def save_tracked_map_ply(self, path: str) -> bool:
        """SaveTrackedMap (src/System.cc:260-322): the last frame's
        tracked map points in CAMERA space with per-vertex RGB (sampled
        from the image the caller passed), pixel coords and octave, plus
        a `frame` element carrying the id, Tcw * realTransform^-1, and K.
        Returns False (and writes nothing) when no point is tracked."""
        frame = self.tracker.last_frame
        pids, feat = self.tracked_points()
        if frame is None or len(pids) == 0:
            return False
        pos_w = np.asarray(self.store.mp_pos[pids.astype(np.int64)])
        Tin = frame.Tcw
        pts_cam = pos_w @ Tin[:3, :3].T + Tin[:3, 3]
        uv = frame.xy_raw[feat]
        img = self._last_image
        if isinstance(img, torch.Tensor):
            img = img.cpu().numpy()  # an image the caller staged on the card
        if img is None:
            colors = np.full((len(feat), 3), 255, np.uint8)
        else:
            img = np.asarray(img)
            yy = np.clip(uv[:, 1].astype(int), 0, img.shape[0] - 1)
            xx = np.clip(uv[:, 0].astype(int), 0, img.shape[1] - 1)
            if img.ndim == 2:
                g = img[yy, xx].astype(np.uint8)
                colors = np.stack([g, g, g], -1)
            else:
                colors = img[yy, xx, :3].astype(np.uint8)
        Tcw_out = frame.Tcw @ np.linalg.inv(self.real_transform)
        from ..utils import ply
        ply.write_tracked_frame(
            path, frame.frame_id, Tcw_out, np.asarray(self.cfg.cam.K),
            pts_cam, colors, uv, frame.octave[feat])
        return True

    def set_real_transform(self, T: np.ndarray):
        """System::SetRealTransform (include/System.h:171-173)."""
        self.real_transform = np.asarray(T, np.float32)

    # ------------------------------------------------------------------
    # checkpoint / resume (a capability the reference lacks: LoadMap is
    # commented out at include/System.h:92)
    # ------------------------------------------------------------------
    def save_map(self, path: str):
        """Serialize the full map (points, keyframes, graphs) to npz,
        under the map lock (the mapping thread does not mutate it
        meanwhile)."""
        from ..models.serialize import save_map
        with self.store.lock:
            save_map(self.store, path)

    def load_map(self, path: str):
        """Load a serialized map onto this System's device and resume in
        LOST state: the next frame relocalizes against it."""
        from ..models.serialize import load_map
        self.flush_mapping()
        self.tracker._pending = []  # in-flight steps belong to the old map
        self.tracker._chain = None
        self.store = load_map(path, device=self.device,
                              dev_capacity=self.cfg.device_point_capacity)
        self.store.set_scale_info(self.cfg.orb.scale_factor,
                                  self.cfg.orb.n_levels)
        self.tracker.store = self.store
        self.mapper.store = self.store
        self.mapper.recent_points = []
        self.place_rec = PlaceRecognition(self.store,
                                          vocab=self.place_rec.vocab)
        self.store.on_kf_erased = self.place_rec.erase_keyframe
        for kid in self.store.valid_kf_ids():
            self.place_rec.add_keyframe(kid)
        self.relocalizer.store = self.store
        self.relocalizer.pr = self.place_rec
        if self.loop_closer is not None:
            self.loop_closer.store = self.store
            self.loop_closer.pr = self.place_rec
        else:
            self.mapper.on_keyframe_processed = self.place_rec.add_keyframe
        self.tracker.state = TrackState.LOST
        self.tracker.last_frame = None
        self.tracker.velocity = None
        self.tracker._prep = None
        valid = self.store.valid_kf_ids()
        self.tracker.ref_kf = valid[-1] if valid else -1

    # ------------------------------------------------------------------
    # localization-only mode (upstream ActivateLocalizationMode; removed
    # by the fork, restored)
    # ------------------------------------------------------------------
    def activate_localization_mode(self):
        """Track against the existing map without extending it."""
        self.tracker.mapping_enabled = False

    def deactivate_localization_mode(self):
        self.tracker.mapping_enabled = True
