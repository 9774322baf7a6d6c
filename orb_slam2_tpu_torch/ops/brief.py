"""Steered-BRIEF 256-bit descriptors packed to 8 words, batched, in torch.

Port of ``orb_slam2_tpu/ops/brief.py`` in its ``binned`` mode, the
code default (``compute_descriptors(mode="binned")``): the steering
angle is quantized to ``N_BINS`` bins, every bit of bin b is the sign of
I[B_b] - I[A_b] on a 39x39 patch, and the final comparison value is the
linear interpolation between the two adjacent bins.

The sampling pattern (:func:`make_pattern`) and the per-bin +-1 weight
matrix (:func:`_bin_weights_np`) are built by the same numpy code as in
the JAX package, so both packages hold identical weights.  The JAX
package multiplies the (N, 1521) patches by that (1521, 12288) matrix;
every column has at most one +1 and one -1, so the port gathers the two
patch pixels of each column and subtracts them: the same integers,
without the dense product.

Descriptors are carried as int32 tensors holding the bit patterns of
the uint32 words (torch's uint32 support is thin).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

N_BITS = 256
PATTERN_CLIP = 13
N_BINS = 48
# rotated +-13 offsets reach radius 13*sqrt(2) ~= 18.4 -> 39x39 window
PATCH_R = 19
PATCH = 2 * PATCH_R + 1
_PAD = 4  # max |rotated offset| is 18 <= PATCH_R - 1; 4 >= 18 - 15 + 1


def make_pattern(seed: int = 20240216) -> np.ndarray:
    """(256, 2, 2) int32 array of (pointA, pointB) offsets (x, y)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, 31 / 5.0, size=(N_BITS, 2, 2))
    pts = np.clip(np.round(pts), -PATTERN_CLIP, PATTERN_CLIP)
    # avoid degenerate A == B pairs
    for i in range(N_BITS):
        while np.all(pts[i, 0] == pts[i, 1]):
            pts[i, 1] = np.clip(np.round(rng.normal(0, 31 / 5.0, 2)), -PATTERN_CLIP, PATTERN_CLIP)
    return pts.astype(np.int32)


_PATTERN = make_pattern()


def get_pattern(kind: str = "random") -> np.ndarray:
    """(256, 2, 2) sampling pattern by name.  The port has the seeded
    ``"random"`` pattern; the JAX package's ``"orb_learned"`` (OpenCV's
    table, for ORBvoc vocabularies) comes with the vocabulary slice."""
    if kind == "random":
        return _PATTERN
    raise ValueError(f"BRIEF pattern {kind!r} is not ported")


@functools.lru_cache(maxsize=4)
def _bin_weights_np(kind: str) -> np.ndarray:
    """(PATCH*PATCH, N_BINS*256) +-1/0 weight matrix: column b*256+s
    holds +1 at the bin-b-rotated B offset of pair s and -1 at its A
    offset (net 0 when both round to the same pixel -> bit 0, matching
    the strict I[A] < I[B] comparison)."""
    pat = get_pattern(kind).astype(np.float64)  # (256, 2, 2) as (x, y)
    px = pat[..., 0]  # (256, 2)
    py = pat[..., 1]
    W = np.zeros((PATCH * PATCH, N_BINS * N_BITS), np.float32)
    for b in range(N_BINS):
        th = 2.0 * np.pi * b / N_BINS
        ca, sa = np.cos(th), np.sin(th)
        rx = np.round(px * ca - py * sa).astype(np.int64)  # (256, 2)
        ry = np.round(px * sa + py * ca).astype(np.int64)
        flat = (ry + PATCH_R) * PATCH + (rx + PATCH_R)
        cols = b * N_BITS + np.arange(N_BITS)
        np.subtract.at(W, (flat[:, 0], cols), 1.0)  # -1 at A
        np.add.at(W, (flat[:, 1], cols), 1.0)       # +1 at B
    return W


@functools.lru_cache(maxsize=4)
def _bin_gather_np(kind: str):
    """(plus, minus) patch indices per weight column, read off
    :func:`_bin_weights_np`: column value = patch[plus] - patch[minus].
    A zero column (A and B on one pixel) gets plus == minus."""
    W = _bin_weights_np(kind)
    plus = np.argmax(W > 0, axis=0)
    minus = np.argmax(W < 0, axis=0)
    zero = ~(W != 0).any(axis=0)
    plus[zero] = 0
    minus[zero] = 0
    return plus.astype(np.int64), minus.astype(np.int64)


def _bin_gather(kind: str, device) -> tuple:
    plus, minus = _bin_gather_np(kind)
    return (torch.as_tensor(plus, device=device),
            torch.as_tensor(minus, device=device))


def _gather_patches(image_blurred: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """(N, PATCH*PATCH) windows centered on each keypoint.  Edge
    replication reproduces the reference's per-sample coordinate
    clamp."""
    n = ys.shape[0]
    h, w = image_blurred.shape
    img_p = F.pad(image_blurred[None, None], (_PAD, _PAD, _PAD, _PAD),
                  mode="replicate")[0, 0]
    y0 = torch.clamp(ys.long() + _PAD - PATCH_R, 0, h + 2 * _PAD - PATCH)
    x0 = torch.clamp(xs.long() + _PAD - PATCH_R, 0, w + 2 * _PAD - PATCH)
    off = torch.arange(PATCH, device=img_p.device)
    yy = (y0[:, None] + off[None, :])[:, :, None]
    xx = (x0[:, None] + off[None, :])[:, None, :]
    return img_p[yy, xx].reshape(n, PATCH * PATCH)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) {0,1} -> (N, 8) int32 holding uint32 bit patterns,
    bit i of word j = bit 32j+i."""
    bits = bits.reshape(-1, 8, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits << shifts).sum(dim=-1)
    # uint32 -> the int32 with the same bits
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def _descriptors_binned(patches: torch.Tensor, angles: torch.Tensor,
                        pattern: str) -> torch.Tensor:
    n = angles.shape[0]
    # integer comparison domain (the reference compares uint8 blurred
    # pixels): I[B] - I[A] is exact in float32
    p_i = torch.round(patches)
    plus, minus = _bin_gather(pattern, patches.device)
    diffs = (p_i[:, plus] - p_i[:, minus]).reshape(n, N_BINS, N_BITS)
    # linear interpolation between the two adjacent bins' comparison
    # values (see the JAX package's module docstring)
    tb = angles * (N_BINS / (2.0 * np.pi))
    fl = torch.floor(tb)
    b0 = fl.long() % N_BINS
    b1 = (b0 + 1) % N_BINS
    t = (tb - fl)[:, None]
    rows = torch.arange(n, device=patches.device)
    s0 = diffs[rows, b0]
    s1 = diffs[rows, b1]
    sel = (1.0 - t) * s0 + t * s1
    return pack_bits(sel > 0)


def compute_descriptors(
    image_blurred: torch.Tensor,
    ys: torch.Tensor,
    xs: torch.Tensor,
    angles: torch.Tensor,
    pattern: str = "random",
) -> torch.Tensor:
    """(N,) keypoints -> (N, 8) int32 packed descriptors.
    ``image_blurred`` is the 7x7 sigma=2 Gaussian-blurred level image
    (ORBextractor.cc:1300-1315 blurs before describing)."""
    patches = _gather_patches(image_blurred, ys, xs)
    return _descriptors_binned(patches, angles, pattern)
