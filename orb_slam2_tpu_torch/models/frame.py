"""Per-image measurement container + its construction, in torch.

Port of ``orb_slam2_tpu/models/frame.py`` (src/Frame.cc: ORB
extraction, keypoint undistortion, static camera setup,
src/Frame.cc:111-216, 502-597).

Feature arrays are device-first: the extractor's outputs stay on the
frame's device and host numpy copies materialize lazily, all at once,
when something reads them (keyframe bookkeeping, export).  On the host
``desc`` is uint32; on the device it is int32 with the same bits.
Only ``mp_ids`` / ``mp_outlier`` (the map bindings) are host-native.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import graphs
from ..geom import camera as camera_mod
from ..ops import extractor as ex

_FEATURE_FIELDS = ("xy", "xy_raw", "response", "angle", "octave",
                   "desc", "valid")


def to_device(name: str, a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # an owned, writable copy for torch
    if name == "desc":
        a = a.astype(np.uint32, copy=False).view(np.int32)
    return torch.as_tensor(a, device=device)


class Frame:
    """SoA keypoint set + pose + map bindings.

    Fields: xy (N,2 undistorted), xy_raw (N,2 detector coords),
    response (N,), angle (N,), octave (N,), desc (N,8 uint32 on the
    host), valid (N,), Tcw (4,4), mp_ids (N,), mp_outlier (N,)."""

    def __init__(self, frame_id, timestamp, Tcw, mp_ids, mp_outlier,
                 n=None, dev=None, device="cpu", **host_fields):
        self.frame_id = frame_id
        self.timestamp = timestamp
        self.Tcw = Tcw
        self.mp_ids = mp_ids
        self.mp_outlier = mp_outlier
        self.device = torch.device(device)
        self._dev = dict(dev) if dev else {}
        self._n = n
        for k, v in host_fields.items():
            if k not in _FEATURE_FIELDS:
                raise TypeError(f"unknown field {k}")
            self.__dict__[k] = v
        if n is None:
            if "xy" in self.__dict__:
                self._n = self.__dict__["xy"].shape[0]
            else:
                self._n = int(self._dev["xy"].shape[0])

    def __getattr__(self, name):
        # only called for names NOT in __dict__: materialize the host
        # copies of every missing field at once
        if name in _FEATURE_FIELDS:
            self._materialize()
            return self.__dict__[name]
        raise AttributeError(name)

    def _materialize(self):
        # one read: pinned copies behind one event (graphs.Readback),
        # then owned host copies, so no pinned block stays held
        missing = [f for f in _FEATURE_FIELDS if f not in self.__dict__]
        if not missing:
            return
        arrays = graphs.Readback([self._dev[f] for f in missing]).arrays()
        for f, a in zip(missing, arrays):
            a = np.array(a)
            self.__dict__[f] = a.view(np.uint32) if f == "desc" else a

    @property
    def n(self) -> int:
        return self._n

    def n_tracked(self) -> int:
        return int(((self.mp_ids >= 0) & ~self.mp_outlier).sum())

    def dev(self, name: str) -> torch.Tensor:
        arr = self._dev.get(name)
        if arr is None:
            arr = to_device(name, getattr(self, name), self.device)
            self._dev[name] = arr
        return arr

    def compact(self, sel: np.ndarray):
        """Shrink the feature set to rows ``sel``.  Init frames carry a
        2x feature budget (src/Tracking.cc:182-189); once the initial
        map exists they shrink to the standard capacity, so every later
        search sees one row count."""
        sel = np.asarray(sel, np.int64)
        dev_sel = None
        new_dev = {}
        for f in _FEATURE_FIELDS:
            arr = self._dev.get(f)
            if arr is not None:
                if dev_sel is None:
                    dev_sel = torch.as_tensor(sel, device=arr.device)
                new_dev[f] = arr.index_select(0, dev_sel)
        self._dev = new_dev  # drops stale (name, n) padded caches
        for f in _FEATURE_FIELDS:
            if f in self.__dict__:
                self.__dict__[f] = self.__dict__[f][sel]
        self.mp_ids = self.mp_ids[sel]
        self.mp_outlier = self.mp_outlier[sel]
        self._n = int(len(sel))

    def dev_padded(self, name: str, n: int) -> torch.Tensor:
        """Device copy zero-padded to ``n`` rows (cached), so frames of
        different feature counts stack into one batch."""
        key = (name, n)
        arr = self._dev.get(key)
        if arr is None:
            base = self.dev(name)
            pad = n - base.shape[0]
            if pad > 0:
                arr = torch.cat([base, base.new_zeros((pad,) + base.shape[1:])])
            else:
                arr = base
            self._dev[key] = arr
        return arr


class FrameFactory:
    """Builds Frames: extract ORB -> undistort keypoints, with the
    intrinsics and undistorted bounds computed once (the reference's
    mbInitialComputations, src/Frame.cc:111-188)."""

    def __init__(self, cam: camera_mod.Intrinsics, params: ex.OrbParams,
                 device="cuda"):
        self.cam = cam
        self.params = params
        self.device = torch.device(device)
        # 2x feature budget during initialization (src/Tracking.cc:182-189,
        # 219-234)
        self.init_params = params._replace(n_features=2 * params.n_features)
        self.bounds = camera_mod.undistorted_bounds(cam)
        self._next_id = 0
        self.sigma2 = ex.level_sigma2(params)
        self.inv_sigma2 = (1.0 / self.sigma2).astype(np.float32)
        self.scale_factors = ex.pyramid.scale_factors(
            params.n_levels, params.scale_factor)[0]
        self._pipeline = graphs.graphed(self._extract, "extract")

    def _extract(self, image, init_mode):
        """Extraction and undistortion of one image (the JAX package's
        ``FrameFactory._pipeline``): uint8 frames cast on the device."""
        params = self.init_params if init_mode else self.params
        feats = ex.extract(image.float(), params)
        return feats, camera_mod.undistort_points(self.cam, feats.xy)

    def start(self, image, init_mode: bool = False):
        """Queue the extraction of ``image`` on the factory's device and
        return ``(features, undistorted xy, init_mode)`` without waiting
        for it.  Pair with :meth:`make` via ``started=``: a pipeline
        extracts frame t+1 while frame t is processed on the host.  On
        the card the extraction replays a CUDA graph captured once per
        (height, width, image dtype, init_mode) (``graphs.graphed``).

        ``image``: a numpy array (uploaded to the factory's device from
        pinned memory, uint8 staying uint8) or a tensor already there."""
        if isinstance(image, torch.Tensor):
            img = image.to(self.device)
        else:
            img_np = np.asarray(image)
            if img_np.dtype != np.uint8:
                img_np = np.asarray(img_np, np.float32)
            img = graphs.upload(img_np, self.device)
        feats, und = self._pipeline(img, bool(init_mode))
        return feats, und, init_mode

    def make(self, image, timestamp: float = 0.0,
             Tcw: np.ndarray | None = None, init_mode: bool = False,
             started=None) -> Frame:
        """image: (H, W) uint8/float32 grayscale.  ``started``: the
        result of :meth:`start` for this image; it is used when it was
        extracted for the same ``init_mode`` (feature budget), else the
        image is extracted again."""
        if started is not None and started[2] == init_mode:
            feats, und, _ = started
        else:
            feats, und, _ = self.start(image, init_mode)
        fid = self._next_id
        self._next_id += 1
        n = int(feats.xy.shape[0])
        return Frame(
            frame_id=fid,
            timestamp=timestamp,
            Tcw=np.eye(4, dtype=np.float32) if Tcw is None
            else np.asarray(Tcw, np.float32),
            mp_ids=np.full(n, -1, np.int32),
            mp_outlier=np.zeros(n, bool),
            n=n,
            device=self.device,
            dev=dict(xy=und, xy_raw=feats.xy, response=feats.response,
                     angle=feats.angle, octave=feats.octave,
                     desc=feats.desc, valid=feats.valid),
        )
