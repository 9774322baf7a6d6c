"""System facade, pose-prior mode — port of
``orb_slam2_tpu/pipeline/system.py`` (src/System.cc).

Wires Tracking + LocalMapping over one MapStore on one torch device and
exposes the reference fork's public API,
``track_monocular_with_pose(image, timestamp, Tcw)``
(include/System.h:69-71), plus map export.  Mapping runs synchronously
after each new keyframe.  Loop closing, asynchronous mapping,
estimated-pose tracking and pipelined tracking are later slices of the
port and raise NotImplementedError instead of running something else.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.frame import Frame, FrameFactory
from ..models.mapstore import MapStore
from .config import SlamConfig
from .local_mapping import LocalMapper
from .tracking import Tracker, TrackState


class System:
    def __init__(self, config: SlamConfig, enable_loop_closing: bool = True,
                 vocab=None, async_mapping: bool = False, device="cuda"):
        if enable_loop_closing or vocab is not None:
            raise NotImplementedError(
                "loop closing and place recognition are not ported yet: "
                "pass enable_loop_closing=False")
        if async_mapping:
            raise NotImplementedError(
                "asynchronous mapping is not ported yet")
        if not config.pose_prior:
            raise NotImplementedError(
                "estimated-pose tracking is not ported yet: use "
                "pose_prior=True and track_monocular_with_pose")
        self.cfg = config
        self.device = torch.device(device)
        self.store = self._new_store()
        self.factory = FrameFactory(config.cam, config.orb,
                                    device=self.device)
        self.tracker = Tracker(config, self.store, self.factory)
        self.mapper = LocalMapper(config, self.store)
        self.tracker.on_new_keyframe = self.mapper.process_keyframe
        self.tracker.on_reset = self.reset

    def _new_store(self) -> MapStore:
        store = MapStore(dev_capacity=self.cfg.device_point_capacity,
                         device=self.device)
        store.set_scale_info(self.cfg.orb.scale_factor, self.cfg.orb.n_levels)
        return store

    def track_monocular_with_pose(self, image, timestamp: float,
                                  Tcw: np.ndarray) -> Frame:
        """System::TrackMonocularWithPose (src/System.cc:237-258).
        ``image``: (H, W) uint8/float32 numpy array or tensor."""
        return self.tracker.track(image, timestamp,
                                  pose_prior=np.asarray(Tcw, np.float32))

    def reset(self):
        """System/Tracking::Reset (src/Tracking.cc:1009-1052)."""
        self.store = self._new_store()
        self.tracker.store = self.store
        self.mapper.store = self.store
        self.mapper.recent_points = []
        self.tracker.state = TrackState.NO_IMAGES_YET
        self.tracker.init_frame = None
        self.tracker.last_frame = None
        self.tracker.ref_kf = -1
        self.tracker._prep = None

    @property
    def state(self) -> TrackState:
        return self.tracker.state

    def timing_report(self) -> str:
        """Per-stage wall-clock summary (tracking + mapping timers)."""
        out = []
        for name, timer in (("tracker", self.tracker.timer),
                            ("mapper", self.mapper.timer)):
            s = timer.summary()
            if s:
                out.append(f"[{name}]\n{s}")
        return "\n".join(out)

    def map_points(self) -> np.ndarray:
        valid = np.asarray(self.store.mp_valid, bool)
        if not valid.any():
            return np.zeros((0, 3), np.float32)
        return np.asarray(self.store.mp_pos)[valid]

    def save_map_ply(self, path: str):
        """SaveMap (src/System.cc:212-234): binary PLY of all valid map
        points (the real-world transform of the JAX package is not
        ported; points are in map coordinates)."""
        from ..utils import ply
        ply.write_ply_points(path, self.map_points())
