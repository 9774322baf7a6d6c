"""The ORB extractor: pyramid -> FAST -> distribute -> orient -> blur ->
describe, with static shapes, in torch.

Port of ``orb_slam2_tpu/ops/extractor.py`` (ORBextractor::operator(),
src/ORBextractor.cc:1223-1340, and the per-level feature budget of its
constructor, src/ORBextractor.cc:511-529).
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import pyramid, fast, distribute, orientation, brief


class OrbParams(NamedTuple):
    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    th_fast_hi: float = 20.0
    th_fast_lo: float = 7.0
    # BRIEF sampling pattern: "random" (default, seeded Gaussian) or
    # "orb_learned" (OpenCV bit_pattern_31_, descriptor-compatible with
    # OpenCV ORB / ORBvoc vocabularies; see ops/orb_pattern.py)
    pattern: str = "random"


class Features(NamedTuple):
    """SoA keypoint set of ``padded_feature_count(n_features)`` rows;
    rows past the selected keypoints have valid=False.

    xy       : (N, 2) float32 — level-0 pixel coords (x, y), raw/distorted.
    response : (N,) float32 — FAST score.
    angle    : (N,) float32 — IC orientation, radians.
    octave   : (N,) int32 — pyramid level.
    desc     : (N, 8) int32 — packed 256-bit descriptor (uint32 bits).
    valid    : (N,) bool.
    """
    xy: torch.Tensor
    response: torch.Tensor
    angle: torch.Tensor
    octave: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor

    @property
    def n(self) -> int:
        return self.xy.shape[0]


def features_per_level(n_features: int, n_levels: int, scale_factor: float) -> List[int]:
    """Geometric budget per level, remainder to the last level — the
    same allocation as src/ORBextractor.cc:511-529."""
    f = 1.0 / scale_factor
    n0 = n_features * (1.0 - f) / (1.0 - f ** n_levels)
    out = []
    total = 0
    for lvl in range(n_levels - 1):
        n = int(round(n0 * f ** lvl))
        out.append(n)
        total += n
    out.append(max(n_features - total, 0))
    return out


def padded_feature_count(n_features: int) -> int:
    """SoA row count for a requested feature budget: the next multiple
    of 128, the row tiling of the search kernels (K2, K3)."""
    return -(-n_features // 128) * 128


def extract(image: torch.Tensor, params: OrbParams) -> Features:
    """image: (H, W) float32 grayscale in [0, 255] -> Features, on the
    image's device."""
    levels = pyramid.build_pyramid(image, params.n_levels, params.scale_factor)
    budgets = features_per_level(params.n_features, params.n_levels,
                                 params.scale_factor)
    sf, _, _, _ = pyramid.scale_factors(params.n_levels, params.scale_factor)
    # every used level's FAST scores at once (K1: one launch on the card)
    used = [lvl for lvl, n_l in enumerate(budgets) if n_l > 0]
    scores = dict(zip(used, fast.score_maps([levels[lvl] for lvl in used])))

    parts = []
    for lvl, (img_l, n_l) in enumerate(zip(levels, budgets)):
        if n_l == 0:
            continue
        keep, score = fast.detect(
            img_l, th_hi=params.th_fast_hi, th_lo=params.th_fast_lo,
            score=scores[lvl])
        ys, xs, resp, valid = distribute.grid_topk(keep, score, n_l)
        ang = orientation.ic_angle(img_l, ys, xs)
        blurred = pyramid.gaussian_blur_7x7(img_l)
        desc = brief.compute_descriptors(blurred, ys, xs, ang,
                                         pattern=params.pattern)
        scale = float(sf[lvl])
        xy = torch.stack([xs.float(), ys.float()], -1) * scale
        parts.append(Features(
            xy=xy,
            response=resp,
            angle=ang,
            octave=torch.full((n_l,), lvl, dtype=torch.int32,
                              device=image.device),
            desc=desc,
            valid=valid,
        ))

    out = Features(*[torch.cat([getattr(p, f) for p in parts], dim=0)
                     for f in Features._fields])
    # pad the SoA height to a multiple of 128 (extra rows valid=False)
    pad = padded_feature_count(params.n_features) - out.n
    if pad > 0:
        out = Features(*[F.pad(a, (0, 0) * (a.dim() - 1) + (0, pad))
                         if a.dtype != torch.bool else
                         torch.cat([a, a.new_zeros(pad)])
                         for a in out])
    return out


def level_sigma2(params: OrbParams) -> np.ndarray:
    """Per-level keypoint variance table (mvLevelSigma2,
    src/ORBextractor.cc:498-505)."""
    return pyramid.scale_factors(params.n_levels, params.scale_factor)[2]
