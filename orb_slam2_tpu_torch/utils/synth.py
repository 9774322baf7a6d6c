"""Synthetic worlds for tests and benchmarks, in torch.

Port of ``orb_slam2_tpu/utils/synth.py``: a large textured ground plane
(z = 0) observed by a downward-looking camera sweep (the aerial geometry
of the reference's shenzhen workload, Examples/Monocular/mono_shenzhen.cc)
or a closed circuit for loop closing.  Views are exact plane-induced
homography warps of the texture, so ground-truth poses and structure
are exact.  ``HeightWorld`` puts a smooth height field under the same
texture, for true parallax.

The JAX package builds the textures and height maps with OpenCV's cubic
resize and renders with ``cv2.warpPerspective`` / ``cv2.remap``; the
port needs none: the layers are numpy-seeded grids upsampled with
bicubic ``torch.nn.functional.interpolate`` (the same a = -0.75 kernel
and half-pixel centres), and the renderers are bilinear, border-clamped
gathers (the JAX package's ``_render_plane_jit``; OpenCV's remap weighs
with 5-bit fixed-point weights instead), on any torch device.  The same
seed gives a texture close to, but not identical with, the JAX
package's.
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


def render_sequence_device(world: PlanarWorld, cam: Intrinsics,
                           poses: List[np.ndarray]) -> List[torch.Tensor]:
    """Render a pose sequence on the texture's device as uint8 frames:
    the texture is quantized to uint8 once (as the JAX package uploads
    it), then each frame is one warp (:func:`render`) on the device."""
    tex_q = world.texture.clamp(0.0, 255.0).to(torch.uint8).float()
    quantized = PlanarWorld(texture=tex_q, scale=world.scale,
                            origin=world.origin)
    return [render(quantized, cam, T) for T in poses]


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


@dataclass
class HeightWorld:
    """Non-planar world: the textured ground carries a smooth height
    field z = h(X, Y) (amplitude a real fraction of the flight height),
    so triangulation, scale gates and BA face true parallax instead of a
    degenerate plane."""
    texture: torch.Tensor    # (Ht, Wt) float32 appearance
    heights: torch.Tensor    # (Hh, Wh) float32 z of the ground at (X, Y)
    scale: float             # texture pixels per world unit
    h_scale: float           # height-map pixels per world unit
    origin: np.ndarray       # (2,) texture pixel of world (0, 0)
    h_origin: np.ndarray     # (2,) height pixel of world (0, 0)

    def height_at(self, X, Y):
        """Bilinear height lookup at world (X, Y), vectorized, on the
        height map's device; numpy in, numpy out."""
        as_np = not isinstance(X, torch.Tensor)
        h = self.heights
        X = torch.as_tensor(X, device=h.device)
        Y = torch.as_tensor(Y, device=h.device)
        u = (X * self.h_scale + float(self.h_origin[0])).clamp(
            0, h.shape[1] - 1.001)
        v = (Y * self.h_scale + float(self.h_origin[1])).clamp(
            0, h.shape[0] - 1.001)
        u0, v0 = u.long(), v.long()
        fu, fv = u - u0, v - v0
        out = ((h[v0, u0] * (1 - fu) + h[v0, u0 + 1] * fu) * (1 - fv)
               + (h[v0 + 1, u0] * (1 - fu) + h[v0 + 1, u0 + 1] * fu) * fv)
        return out.cpu().numpy() if as_np else out


def make_height_world(seed: int = 0, tex_size: int = 3072,
                      scale: float = 60.0, height_amp: float = 1.5,
                      h_size: int = 768, h_cells: int = 28,
                      device="cuda") -> HeightWorld:
    """Textured ground with a smooth random height field (amplitude
    ``height_amp`` world units, ~15% of the default flight height), on
    ``device``."""
    base = make_world(seed=seed, tex_size=tex_size, scale=scale,
                      device=device)
    rng = np.random.default_rng(seed + 12345)
    h = torch.as_tensor(rng.uniform(-1, 1, (h_cells, h_cells))
                        .astype(np.float32), device=device)
    h = F.interpolate(h[None, None], size=(h_size, h_size), mode="bicubic",
                      align_corners=False)[0, 0]
    h = height_amp * h / torch.clamp(h.abs().max(), min=1e-9)
    h_scale = h_size / (tex_size / scale)   # cover the same world extent
    return HeightWorld(
        texture=base.texture, heights=h, scale=scale, h_scale=h_scale,
        origin=base.origin,
        h_origin=np.array([h_size / 2, h_size / 2], np.float32))


def _bilinear_clamped(img: torch.Tensor, x: torch.Tensor,
                      y: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``img`` at (x, y), indices clamped to the
    border (OpenCV's INTER_LINEAR with BORDER_REPLICATE, in float)."""
    h, w = img.shape
    x0f, y0f = x.floor(), y.floor()
    fx, fy = x - x0f, y - y0f
    x0 = x0f.long().clamp(0, w - 1)
    y0 = y0f.long().clamp(0, h - 1)
    x1 = (x0f.long() + 1).clamp(0, w - 1)
    y1 = (y0f.long() + 1).clamp(0, h - 1)
    return ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x1])
            + fy * ((1 - fx) * img[y1, x0] + fx * img[y1, x1]))


def render_height(world: HeightWorld, cam: Intrinsics, Tcw: np.ndarray,
                  iters: int = 6) -> torch.Tensor:
    """Render the height-field ground from pose Tcw as an (H, W) float32
    tensor on the texture's device, by a per-pixel ray against the
    height field (fixed-point iteration: t_{k+1} solves the ray against
    the height sampled at t_k's footprint; it converges in a few steps
    for |grad h| << 1, which make_height_world guarantees).  Exact
    parallax, approximate silhouettes.  Rays that do not look toward
    the ground are grey (127)."""
    dev = world.texture.device
    K = np.asarray(cam.K, np.float32)
    Tcw = np.asarray(Tcw, np.float32)
    Rwc = torch.as_tensor(Tcw[:3, :3].T.copy(), device=dev)
    c = (-Tcw[:3, :3].T @ Tcw[:3, 3]).astype(np.float32).tolist()
    v, u = torch.meshgrid(
        torch.arange(cam.height, dtype=torch.float32, device=dev),
        torch.arange(cam.width, dtype=torch.float32, device=dev),
        indexing="ij")
    rays = torch.stack([(u - float(K[0, 2])) / float(K[0, 0]),
                        (v - float(K[1, 2])) / float(K[1, 1]),
                        torch.ones_like(u)], dim=-1).reshape(-1, 3)
    d = rays @ Rwc.T                          # world ray directions
    dz = d[:, 2]
    safe = dz > 1e-6                          # looking toward the ground
    dz = torch.where(safe, dz, torch.ones_like(dz))
    tt = (0.0 - c[2]) / dz                    # init: the z = 0 plane
    for _ in range(iters):
        X = c[0] + tt * d[:, 0]
        Y = c[1] + tt * d[:, 1]
        tt = (world.height_at(X, Y) - c[2]) / dz
    X = c[0] + tt * d[:, 0]
    Y = c[1] + tt * d[:, 1]
    th, tw = world.texture.shape
    tx = (X * world.scale + float(world.origin[0])).clamp(0, tw - 1)
    ty = (Y * world.scale + float(world.origin[1])).clamp(0, th - 1)
    img = _bilinear_clamped(world.texture, tx, ty)
    img = torch.where(safe, img, torch.full_like(img, 127.0))
    return img.reshape(cam.height, cam.width)
