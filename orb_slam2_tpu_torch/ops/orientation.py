"""Intensity-centroid keypoint orientation, batched, in torch.

Port of ``orb_slam2_tpu/ops/orientation.py`` (IC_Angle,
src/ORBextractor.cc:96-144): the angle of the vector from the keypoint
to the intensity centroid of a radius-15 circular patch.  The disk is
31 contiguous row spans, so every moment is a sum of span differences
of two row prefix-sum images; the dense moment maps are built with the
same float32 formulas as the JAX package, and three values per
keypoint are gathered at the end.  The prefix sums accumulate in
another order than XLA's, so angles agree to float32 rounding.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

HALF_PATCH = 15

# circular-mask half-width per row offset dy (dy^2 + dx^2 <= r^2, the
# same disk as the reference's u_max table, src/ORBextractor.cc:127-144)
_DY = np.arange(-HALF_PATCH, HALF_PATCH + 1)
_HW = np.floor(np.sqrt(np.maximum(HALF_PATCH ** 2 - _DY ** 2, 0))
               ).astype(np.int32)


def gather_patches(image: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                   dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """Gather (N, *offsets.shape) pixel patches with clamped indices."""
    h, w = image.shape
    yy = (ys[:, None, None] + dy[None]).clamp(0, h - 1)
    xx = (xs[:, None, None] + dx[None]).clamp(0, w - 1)
    return image[yy.long(), xx.long()]


def ic_angle(image: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
             ) -> torch.Tensor:
    """Angles in radians, (N,).  Keypoints are >= 16 px from the border
    (the detector's margin), so the edge-padded frame never reaches
    them.  Rows that ``grid_topk`` left invalid may point into its
    padding past the image's edge; they are clamped to it, as the JAX
    package's gathers clamp."""
    h, w = image.shape
    im = image.float()
    xcol = torch.arange(w, dtype=torch.float32, device=im.device)[None, :]
    # exclusive row prefix sums: S[y, x] = sum of im[y, :x]
    S = F.pad(torch.cumsum(im, dim=1), (1, 0))
    Sx = F.pad(torch.cumsum(im * xcol, dim=1), (1, 0))
    # edge-pad 15 columns and 15 rows each side
    A = F.pad(S[None, None], (15, 15, 15, 15), mode="replicate")[0, 0]
    Ax = F.pad(Sx[None, None], (15, 15, 15, 15), mode="replicate")[0, 0]
    m01_map = torch.zeros((h, w), dtype=torch.float32, device=im.device)
    s_map = torch.zeros_like(m01_map)
    sx_map = torch.zeros_like(m01_map)
    for i, ddy in enumerate(_DY):
        hw = int(_HW[i])
        r0 = 15 + int(ddy)
        c1 = 15 + hw + 1
        c0 = 15 - hw
        rs = A[r0:r0 + h, c1:c1 + w] - A[r0:r0 + h, c0:c0 + w]
        rsx = Ax[r0:r0 + h, c1:c1 + w] - Ax[r0:r0 + h, c0:c0 + w]
        m01_map = m01_map + float(ddy) * rs
        s_map = s_map + rs
        sx_map = sx_map + rsx
    ys = ys.long().clamp(0, h - 1)
    xs = xs.long().clamp(0, w - 1)
    m01 = m01_map[ys, xs]
    m10 = sx_map[ys, xs] - xs.float() * s_map[ys, xs]
    return torch.atan2(m01, m10)
