"""Image pyramid with static per-level shapes, in torch.

Port of ``orb_slam2_tpu/ops/pyramid.py`` (ORBextractor::ComputePyramid,
src/ORBextractor.cc:1345-1410).  Each level is resized from the
previous one, as in the JAX package.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def level_shapes(
    height: int, width: int, n_levels: int, scale_factor: float
) -> List[Tuple[int, int]]:
    """Static (H, W) per level; level 0 is the input size."""
    shapes = []
    for lvl in range(n_levels):
        s = 1.0 / (scale_factor ** lvl)
        shapes.append((max(int(round(height * s)), 16), max(int(round(width * s)), 16)))
    return shapes


def scale_factors(n_levels: int, scale_factor: float):
    """(scale, inv_scale, sigma2, inv_sigma2) per level, like the
    mvScaleFactor/mvLevelSigma2 tables (src/ORBextractor.cc:486-505)."""
    sf = np.array([scale_factor ** i for i in range(n_levels)], np.float32)
    return sf, 1.0 / sf, sf * sf, 1.0 / (sf * sf)


def build_pyramid(
    image: torch.Tensor, n_levels: int, scale_factor: float
) -> List[torch.Tensor]:
    """image: (H, W) float32 in [0, 255] -> list of per-level images.

    Bilinear chain-resize with half-pixel centres and no antialiasing,
    the semantics of ``jax.image.resize(..., "linear", antialias=False)``
    (edge samples clamp to the border pixel in both).  The JAX package
    evaluates it as a dense weight-matrix product, so the two agree to
    float32 rounding, not bit for bit."""
    h, w = image.shape
    shapes = level_shapes(h, w, n_levels, scale_factor)
    levels = [image]
    for lvl in range(1, n_levels):
        prev = levels[-1]
        levels.append(F.interpolate(
            prev[None, None], size=shapes[lvl], mode="bilinear",
            align_corners=False, antialias=False)[0, 0])
    return levels


def _blur_kernel_bf16(sigma: float) -> List[float]:
    r = 3
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    # the taps as bf16 values (round to nearest even), held as floats
    kb = torch.from_numpy(k.astype(np.float32)).to(torch.bfloat16)
    return kb.float().tolist()


def gaussian_blur_7x7(image: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Separable 7x7 Gaussian, the descriptor pre-blur of
    ORBextractor.cc:1305 (GaussianBlur(..., Size(7,7), 2, 2,
    BORDER_REFLECT_101)).

    Runs in bfloat16 like the JAX package: every product and every
    partial sum rounds to bf16, in the same left-to-right order."""
    r = 3
    h, w = image.shape
    taps = _blur_kernel_bf16(sigma)
    pad = F.pad(image[None, None].float(), (r, r, r, r),
                mode="reflect")[0, 0].to(torch.bfloat16)
    rows = None
    for i, k in enumerate(taps):
        term = pad[i:i + h, :] * k
        rows = term if rows is None else rows + term
    cols = None
    for i, k in enumerate(taps):
        term = rows[:, i:i + w] * k
        cols = term if cols is None else cols + term
    return cols.float()
