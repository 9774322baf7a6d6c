"""System facade, pose-prior mode — port of
``orb_slam2_tpu/pipeline/system.py`` (src/System.cc).

Wires Tracking + LocalMapping + LoopClosing over one MapStore on one
torch device and exposes the reference fork's public API,
``track_monocular_with_pose(image, timestamp, Tcw)``
(include/System.h:69-71), plus map export.  Place recognition (the
vocabulary and BoW database) backs both loop closing and
relocalization.  ``async_mapping=True`` runs local mapping and loop
closing on a worker thread fed by a keyframe queue (src/System.cc:
96-109); the default is the deterministic sequential pipeline.
Estimated-pose tracking and pipelined tracking
(``cfg.pipelined_tracking``, ``prefetch``, ``next_image``) are later
slices of the port and raise NotImplementedError instead of running
something else.
"""
from __future__ import annotations

from typing import List

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
        if config.pipelined_tracking:
            raise NotImplementedError(
                "pipelined tracking is not ported yet")
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

    def flush_mapping(self):
        """Block until all queued keyframes are mapped (no-op in the
        sequential pipeline); re-raises a mapping-thread exception."""
        if self.map_worker is not None:
            self.map_worker.drain()

    def track_monocular_with_pose(self, image, timestamp: float,
                                  Tcw: np.ndarray,
                                  next_image=None) -> Frame:
        """System::TrackMonocularWithPose (src/System.cc:237-258).
        ``image``: (H, W) uint8/float32 numpy array or tensor."""
        if next_image is not None:
            raise NotImplementedError(
                "next_image (extraction prefetch) belongs to pipelined "
                "tracking, which is not ported yet")
        frame = self.tracker.track(image, timestamp,
                                   pose_prior=np.asarray(Tcw, np.float32))
        self.trajectory.append((frame.frame_id, frame.timestamp,
                                frame.Tcw.copy(), self.tracker.state))
        return frame

    def prefetch(self, image) -> None:
        raise NotImplementedError(
            "prefetch belongs to pipelined tracking, which is not ported "
            "yet")

    def reset(self):
        """System/Tracking::Reset (src/Tracking.cc:1009-1052)."""
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
        self.tracker._prep = None

    @property
    def state(self) -> TrackState:
        return self.tracker.state

    def shutdown(self):
        """System::Shutdown (src/System.cc:173-192): join the mapping
        worker, then wait for the device."""
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
