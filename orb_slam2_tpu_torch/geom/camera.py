"""Pinhole camera model with radial-tangential distortion, in torch.

Port of ``orb_slam2_tpu/geom/camera.py``: projection in
Frame::isInFrustum (src/Frame.cc:275-369), cv::undistortPoints in
Frame::UndistortKeyPoints (src/Frame.cc:502-558), and the K/distCoef
YAML parsing of src/Tracking.cc:95-127.  ``Intrinsics`` is a plain
NamedTuple so the port's config carries no framework import; ``K`` is
a host numpy matrix.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Intrinsics(NamedTuple):
    """Static pinhole parameters. dist = (k1, k2, p1, p2, k3)."""
    fx: float
    fy: float
    cx: float
    cy: float
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)
    width: int = 0
    height: int = 0

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

    @property
    def has_distortion(self) -> bool:
        return any(abs(d) > 0 for d in self.dist)


def project(cam: Intrinsics, pts_cam: torch.Tensor) -> torch.Tensor:
    """Project camera-frame points (..., 3) -> pixel coords (..., 2), with
    no distortion: the pipeline matches undistorted keypoints, as the
    reference does (src/Frame.cc:502)."""
    z = pts_cam[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    u = cam.fx * pts_cam[..., 0] * inv_z + cam.cx
    v = cam.fy * pts_cam[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], dim=-1)


def unproject(cam: Intrinsics, uv: torch.Tensor,
              depth: torch.Tensor) -> torch.Tensor:
    """Back-project undistorted pixels (..., 2) at depth (...) -> (..., 3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def distort_normalized(cam: Intrinsics, xy: torch.Tensor) -> torch.Tensor:
    """Apply radtan distortion to normalized coords (..., 2)."""
    k1, k2, p1, p2, k3 = [float(np.float32(d)) for d in cam.dist]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(cam: Intrinsics, uv: torch.Tensor,
                     iters: int = 8) -> torch.Tensor:
    """Undistort pixel coords (..., 2) -> ideal pixel coords (..., 2) by
    the fixed-point iteration of cv::undistortPoints."""
    if not cam.has_distortion:
        return uv
    xd = (uv[..., 0] - cam.cx) / cam.fx
    yd = (uv[..., 1] - cam.cy) / cam.fy
    target = torch.stack([xd, yd], dim=-1)
    xy = target
    for _ in range(iters):
        xy = xy + (target - distort_normalized(cam, xy))
    u = xy[..., 0] * cam.fx + cam.cx
    v = xy[..., 1] * cam.fy + cam.cy
    return torch.stack([u, v], dim=-1)


def undistorted_bounds(cam: Intrinsics) -> tuple:
    """Image bounds after undistortion (minx, maxx, miny, maxy), as
    Frame::ComputeImageBounds (src/Frame.cc:560-597)."""
    w, h = cam.width, cam.height
    if not cam.has_distortion:
        return (0.0, float(w), 0.0, float(h))
    corners = torch.tensor([[0.0, 0.0], [w, 0.0], [0.0, h], [w, h]],
                           dtype=torch.float32)
    und = undistort_points(cam, corners).numpy()
    return (
        float(min(und[0, 0], und[2, 0])),
        float(max(und[1, 0], und[3, 0])),
        float(min(und[0, 1], und[1, 1])),
        float(max(und[2, 1], und[3, 1])),
    )
