"""FAST-9/16 corner detection as dense mask arithmetic, in torch.

Port of ``orb_slam2_tpu/ops/fast.py`` (the per-cell OpenCV FAST calls
of ORBextractor::ComputeKeyPointsOctTree, src/ORBextractor.cc:1040-1160,
with the iniThFAST=20 / minThFAST=7 fallback for empty 30x30 cells).
A threshold-free score map is computed once and both threshold masks
derive from it.

The score map is kernel K1: on CUDA tensors :func:`score_maps` (a
frame's levels) and :func:`score_map` (one image) launch the
hand-written kernel ``csrc/fast_score.cu``, once for up to
``MAX_LEVELS`` images; on CPU tensors they run the plain version
:func:`fast_score_map`.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch
import torch.nn.functional as F

from .. import kernels

# Bresenham circle of radius 3 (dy, dx), circularly ordered (OpenCV's
# 16-pixel ring).
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC = 9  # contiguous run length for FAST-9/16

# images per K1 launch (csrc/fast_score.cu: kMaxLevels)
MAX_LEVELS = 8


def fast_score_map(image: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9/16 score map, the plain version of kernel K1.

    image: (H, W) float32.  Returns (H, W) float32 where score[y, x] is
    the largest threshold t for which (y, x) is a FAST-9 corner (<= 0 if
    never): the max over the 16 arcs of 9 of the arc-min of (p_i - p)
    (bright) or (p - p_i) (dark).  Computes in bfloat16 like the JAX
    package: the input and every ring difference round to bf16.  The
    ring wraps around the image edges (``torch.roll``), so the outer
    3 px differ from the kernel's zero halo."""
    im = image.to(torch.bfloat16)
    c = torch.stack([torch.roll(im, (-dy, -dx), dims=(0, 1))
                     for dy, dx in CIRCLE])
    d_bright = c - im[None]  # (16, H, W): p_i - p
    d_dark = -d_bright

    def arcmin9(d):
        m2 = torch.minimum(d, torch.roll(d, -1, dims=0))
        m4 = torch.minimum(m2, torch.roll(m2, -2, dims=0))
        m8 = torch.minimum(m4, torch.roll(m4, -4, dims=0))
        m9 = torch.minimum(m8, torch.roll(d, -8, dims=0))
        return m9.amax(dim=0)

    return torch.maximum(arcmin9(d_bright), arcmin9(d_dark)).float()


def fast_score_levels(images: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Kernel K1 on the card: (H, W) float32 CUDA tensors of any sizes ->
    their score maps, one launch for every ``MAX_LEVELS`` images.  Exact
    against :func:`fast_score_map` on ``[3:-3, 3:-3]``."""
    if not images:
        raise ValueError("fast_score takes at least one image")
    dev = images[0].device
    for im in images:
        if not im.is_cuda or im.device != dev:
            raise ValueError("fast_score launches the CUDA kernel: it "
                             "needs CUDA tensors on one device")
        if im.dtype != torch.float32 or im.dim() != 2 or im.numel() == 0:
            raise ValueError(f"fast_score takes (H, W) float32 images, got "
                             f"{tuple(im.shape)} {im.dtype}")
    images = [im.contiguous() for im in images]
    outs = [torch.empty_like(im) for im in images]
    for i in range(0, len(images), MAX_LEVELS):
        ims, res = images[i:i + MAX_LEVELS], outs[i:i + MAX_LEVELS]
        n = len(ims)
        # host arrays: the kernel takes them as one by-value parameter
        kernels.call(
            "fast_score",
            (ctypes.c_void_p * n)(*[im.data_ptr() for im in ims]),
            (ctypes.c_void_p * n)(*[o.data_ptr() for o in res]),
            (ctypes.c_int * n)(*[im.shape[0] for im in ims]),
            (ctypes.c_int * n)(*[im.shape[1] for im in ims]), n)
    return outs


def fast_score(image: torch.Tensor) -> torch.Tensor:
    """Kernel K1 on the card for one (H, W) float32 CUDA tensor."""
    return fast_score_levels([image])[0]


def score_maps(images: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Dense FAST-9/16 score maps of a frame's pyramid levels: kernel K1
    in one launch for CUDA tensors, the plain version per image for CPU
    tensors (they agree outside the 3 px frame, which the detector
    border masks)."""
    on_card = [im.is_cuda for im in images]
    if all(on_card):
        return fast_score_levels(images)
    if any(on_card):
        raise ValueError("score_maps takes images all on the CPU or all "
                         "on one CUDA device")
    return [fast_score_map(im) for im in images]


def score_map(image: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9/16 score map of one image (see :func:`score_maps`)."""
    if image.is_cuda:
        return fast_score(image)
    return fast_score_map(image)


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression mask (ties broken toward the
    top-left so plateaus yield a single detection)."""
    h, w = score.shape
    pad = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
    # tiny raster-order bias so equal neighbors don't both survive
    bias = (
        torch.arange(h + 2, dtype=score.dtype, device=score.device)[:, None]
        * (w + 2)
        + torch.arange(w + 2, dtype=score.dtype, device=score.device)[None, :]
    ) * 1e-6
    biased = pad - bias
    neigh = torch.stack(
        [
            biased[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
            if not (dy == 0 and dx == 0)
        ]
    )
    center = biased[1: 1 + h, 1: 1 + w]
    return center > neigh.amax(dim=0)


def _cell_any(mask: torch.Tensor, cell: int) -> torch.Tensor:
    """Per-pixel broadcast of 'does my cell contain any True'."""
    h, w = mask.shape
    ph = (-h) % cell
    pw = (-w) % cell
    m = F.pad(mask, (0, pw, 0, ph))
    hc, wc = m.shape[0] // cell, m.shape[1] // cell
    cells = m.reshape(hc, cell, wc, cell).any(dim=3).any(dim=1)
    back = cells.repeat_interleave(cell, dim=0).repeat_interleave(cell, dim=1)
    return back[:h, :w]


def detect(
    image: torch.Tensor,
    th_hi: float = 20.0,
    th_lo: float = 7.0,
    cell: int = 30,
    border: int = 16,
    score: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full detection pass for one pyramid level.

    Returns (corner_mask, score_map).  A pixel is kept if it is an NMS
    peak and either clears th_hi, or clears th_lo while its 30x30 cell
    has no th_hi corner (src/ORBextractor.cc:1115-1124).  ``border``
    masks the frame where the ring/descriptor would leave the image
    (EDGE_THRESHOLD-3 = 16, src/ORBextractor.cc:1047-1050).  ``score``
    is the level's score map when it was computed already (the extractor
    takes all levels' in one launch, :func:`score_maps`)."""
    if score is None:
        score = score_map(image)
    h, w = image.shape
    yy = torch.arange(h, device=image.device)[:, None]
    xx = torch.arange(w, device=image.device)[None, :]
    in_bounds = ((yy >= border) & (yy < h - border)
                 & (xx >= border) & (xx < w - border))

    peaks = nms3(torch.where(in_bounds, score,
                             torch.full_like(score, float("-inf")))) & in_bounds
    hi = peaks & (score > th_hi)
    lo = peaks & (score > th_lo)
    cell_has_hi = _cell_any(hi, cell)
    keep = hi | (lo & ~cell_has_hi)
    return keep, score
