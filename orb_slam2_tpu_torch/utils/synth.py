"""Synthetic planar world for tests and benchmarks, in torch.

Port of the planar parts of ``orb_slam2_tpu/utils/synth.py``: a large
textured ground plane (z = 0) observed by a downward-looking camera
sweep (the aerial geometry of the reference's shenzhen workload,
Examples/Monocular/mono_shenzhen.cc) or a closed circuit for loop
closing.  Views are exact plane-induced
homography warps of the texture, so ground-truth poses and structure
are exact.

The JAX package builds the texture and renders with OpenCV; the port
needs none: the texture layers are numpy-seeded grids upsampled with
bicubic ``torch.nn.functional.interpolate``, and the renderer is the
bilinear, border-clamped homography warp of the JAX package's
``_render_plane_jit``, on any torch device.  The same seed gives a
texture close to, but not identical with, the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ..geom.camera import Intrinsics
from .evaluate import ate_rmse  # noqa: F401  (the JAX module has one too)


@dataclass
class PlanarWorld:
    texture: torch.Tensor   # (Ht, Wt) float32 the plane's appearance
    scale: float            # pixels per world unit on the plane
    origin: np.ndarray      # (2,) texture pixel of world (0, 0)

    def world_to_tex(self) -> np.ndarray:
        """3x3 mapping homogeneous (X, Y, 1) plane coords -> texture px."""
        return np.array([
            [self.scale, 0, self.origin[0]],
            [0, self.scale, self.origin[1]],
            [0, 0, 1.0],
        ], np.float32)


def make_world(seed: int = 0, tex_size: int = 3072, scale: float = 60.0,
               tex_shape: tuple | None = None,
               origin_px: tuple | None = None,
               device="cuda") -> PlanarWorld:
    """Random smooth texture with structure at several octaves, built on
    ``device``.  ``tex_shape``: optional (height, width); cell density is
    anchored to ``tex_size``.  ``origin_px``: texture pixel of world
    (0, 0); defaults to the center."""
    rng = np.random.default_rng(seed)
    th, tw = tex_shape if tex_shape is not None else (tex_size, tex_size)
    tex = torch.zeros((th, tw), dtype=torch.float32, device=device)
    for cells, amp in [(24, 90.0), (96, 60.0), (384, 35.0)]:
        ch = max(2, int(round(cells * th / tex_size)))
        cw = max(2, int(round(cells * tw / tex_size)))
        layer = torch.as_tensor(rng.uniform(0, 1, (ch, cw)).astype(np.float32),
                                device=device)
        tex += amp * F.interpolate(layer[None, None], size=(th, tw),
                                   mode="bicubic", align_corners=False)[0, 0]
    tex = 255.0 * (tex - tex.min()) / (tex.max() - tex.min())
    if origin_px is None:
        origin = np.array([tw / 2, th / 2], np.float32)
    else:
        origin = np.asarray(origin_px, np.float32)
    return PlanarWorld(texture=tex, scale=scale, origin=origin)


def render(world: PlanarWorld, cam: Intrinsics, Tcw: np.ndarray) -> torch.Tensor:
    """Render the plane from camera pose Tcw (world -> camera) as an
    (H, W) uint8 tensor on the texture's device: bilinear sampling,
    border clamp, truncation to uint8."""
    K = np.asarray(cam.K, np.float64)
    Tcw = np.asarray(Tcw, np.float64)
    R, t = Tcw[:3, :3], Tcw[:3, 3]
    # plane point (X, Y, 0): pixel ~ K [r1 r2 t] (X, Y, 1)
    H_world_img = K @ np.stack([R[:, 0], R[:, 1], t], axis=1)
    H_tex_img = H_world_img @ np.linalg.inv(world.world_to_tex())
    Hinv = np.linalg.inv(H_tex_img).astype(np.float32).tolist()
    tex = world.texture
    dev = tex.device
    yy, xx = torch.meshgrid(
        torch.arange(cam.height, dtype=torch.float32, device=dev),
        torch.arange(cam.width, dtype=torch.float32, device=dev),
        indexing="ij")
    den = Hinv[2][0] * xx + Hinv[2][1] * yy + Hinv[2][2]
    den = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
    sx = (Hinv[0][0] * xx + Hinv[0][1] * yy + Hinv[0][2]) / den
    sy = (Hinv[1][0] * xx + Hinv[1][1] * yy + Hinv[1][2]) / den
    th, tw = tex.shape
    sx = sx.clamp(0.0, tw - 1.0)
    sy = sy.clamp(0.0, th - 1.0)
    x0 = sx.floor().long().clamp(0, tw - 2)
    y0 = sy.floor().long().clamp(0, th - 2)
    fx = sx - x0
    fy = sy - y0
    v00 = tex[y0, x0]
    v01 = tex[y0, x0 + 1]
    v10 = tex[y0 + 1, x0]
    v11 = tex[y0 + 1, x0 + 1]
    out = ((1 - fy) * ((1 - fx) * v00 + fx * v01)
           + fy * ((1 - fx) * v10 + fx * v11))
    return out.clamp(0.0, 255.0).to(torch.uint8)


def aerial_trajectory(
    n_frames: int,
    height: float = 10.0,
    speed: float = 0.35,
    yaw_rate: float = 0.0,
    lateral_wobble: float = 0.05,
    seed: int = 1,
) -> List[np.ndarray]:
    """Downward-looking camera sweeping over the plane (shenzhen-style):
    cameras fly at z = -height with camera z along world +z, so the
    plane z = 0 has positive depth.  Returns a list of Tcw."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n_frames):
        yaw = yaw_rate * i
        cy, sy = np.cos(yaw), np.sin(yaw)
        c = np.array([speed * i,
                      lateral_wobble * np.sin(0.2 * i) + 0.01 * rng.normal(),
                      -height + 0.02 * rng.normal()])
        Rwc = np.array([
            [cy, -sy, 0.0],
            [sy, cy, 0.0],
            [0.0, 0.0, 1.0],
        ])
        Rcw = Rwc.T
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rcw
        T[:3, 3] = -Rcw @ c
        poses.append(T)
    return poses


def loop_trajectory(n_frames: int, radius: float = 8.0,
                    height: float = 10.0) -> List[np.ndarray]:
    """Closed circular sweep for loop-closing tests: the camera returns
    to its start after n_frames, heading along the tangent."""
    poses = []
    for i in range(n_frames):
        th = 2 * np.pi * i / n_frames
        c = np.array([radius * np.cos(th), radius * np.sin(th), -height])
        yaw = th + np.pi / 2
        cy, sy = np.cos(yaw), np.sin(yaw)
        Rwc = np.array([
            [cy, -sy, 0.0],
            [sy, cy, 0.0],
            [0.0, 0.0, 1.0],
        ])
        Rcw = Rwc.T
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rcw
        T[:3, 3] = -Rcw @ c
        poses.append(T.astype(np.float32))
    return poses
