"""Batched frustum / visibility test for map points, in torch.

Port of ``orb_slam2_tpu/matching/frustum.py`` (Frame::isInFrustum,
src/Frame.cc:275-369, and MapPoint::PredictScale,
src/MapPoint.cc:593-637), run over the whole local map at once.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class FrustumResult(NamedTuple):
    visible: torch.Tensor     # (P,) bool
    uv: torch.Tensor          # (P, 2) projected pixel coords
    pred_level: torch.Tensor  # (P,) int64 predicted pyramid level
    view_cos: torch.Tensor    # (P,) cosine(normal, viewing ray)
    depth: torch.Tensor       # (P,) camera-frame z


def is_in_frustum(
    pts_w: torch.Tensor,
    normals: torch.Tensor,
    min_dist: torch.Tensor,
    max_dist: torch.Tensor,
    valid: torch.Tensor,
    Tcw: torch.Tensor,
    fx: float, fy: float, cx: float, cy: float,
    bounds: tuple,
    n_levels: int,
    log_scale_factor: float,
    view_cos_limit: float = 0.5,
) -> FrustumResult:
    """All checks of Frame::isInFrustum, batched: positive depth,
    projection inside the undistorted bounds, distance within
    [0.8*min_dist, 1.2*max_dist], viewing cosine > 0.5, and the
    predicted level ceil(log(max_dist/dist)/log(scale))."""
    R, t = Tcw[:3, :3], Tcw[:3, 3]
    pc = pts_w @ R.T + t
    z = pc[:, 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    u = fx * pc[:, 0] * inv_z + cx
    v = fy * pc[:, 1] * inv_z + cy

    minx, maxx, miny, maxy = bounds
    in_img = (u >= minx) & (u < maxx) & (v >= miny) & (v < maxy)

    ow = -R.T @ t  # camera center in world
    po = pts_w - ow
    dist = torch.linalg.norm(po, dim=-1)
    dist_ok = (dist >= 0.8 * min_dist) & (dist <= 1.2 * max_dist)

    vcos = (po * normals).sum(-1) / torch.clamp(dist, min=1e-12)

    ratio = torch.clamp(max_dist, min=1e-12) / torch.clamp(dist, min=1e-12)
    lvl = torch.ceil(torch.log(ratio) / log_scale_factor).long()
    lvl = torch.clamp(lvl, 0, n_levels - 1)

    visible = valid & (z > 0) & in_img & dist_ok & (vcos > view_cos_limit)
    return FrustumResult(
        visible=visible,
        uv=torch.stack([u, v], dim=-1),
        pred_level=lvl,
        view_cos=vcos,
        depth=z,
    )
