"""Core matching primitives: Hamming distances + masked selection.

Port of ``orb_slam2_tpu/matching/core.py`` (ORBmatcher::DescriptorDistance,
src/ORBmatcher.cc:1991-2011, the TH_LOW/TH_HIGH thresholds and
best/second-best ratio logic, include/ORBmatcher.h:217-219, and the
three-maxima rotation-histogram filter, src/ORBmatcher.cc:1943-1989).

Descriptors are (N, 8) int32 tensors holding the uint32 bit patterns.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# Same acceptance thresholds as the reference (include/ORBmatcher.h:217-218).
TH_LOW = 50
TH_HIGH = 100
HISTO_BINS = 30  # HISTO_LENGTH (include/ORBmatcher.h:219)

_BIG = 1 << 20  # "infinite" distance for masked-out pairs


def unpack_bits_pm1(desc: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 words -> (N, 256) float32 in {-1, +1}."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[:, :, None] >> shifts) & 1
    bits = bits.reshape(desc.shape[0], 256)
    return bits.float() * 2.0 - 1.0


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(N, 8) x (M, 8) -> (N, M) int32 Hamming distances.

    The +-1 product of the JAX package: for a, b in {-1,+1}^256,
    hamming = (256 - a.b) / 2, exact in float32 (the sums are integers
    of magnitude <= 256, and TF32 is off)."""
    dot = unpack_bits_pm1(d1) @ unpack_bits_pm1(d2).T
    return ((256.0 - dot) * 0.5).to(torch.int32)


def hamming_popcount(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Reference-semantics popcount path (an oracle for tests and tiny
    problems): (N, 8) x (M, 8) -> (N, M) int32."""
    acc = torch.zeros((d1.shape[0], d2.shape[0]), dtype=torch.int32,
                      device=d1.device)
    for k in range(8):
        x = d1[:, None, k] ^ d2[None, :, k]
        acc = acc + _popcount32(x)
    return acc


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int32 word (SWAR, on the word's uint32 bits)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF).bitwise_right_shift(24).to(torch.int32)


class MatchResult(NamedTuple):
    idx: torch.Tensor    # (N,) int64 — best column per row (0 if none)
    dist: torch.Tensor   # (N,) int32 — best distance (BIG if none)
    valid: torch.Tensor  # (N,) bool

    def host(self) -> "MatchResult":
        return MatchResult(*(t.cpu().numpy() for t in self))


def best_match(
    dist: torch.Tensor,
    mask: torch.Tensor,
    max_dist: int = TH_LOW,
    ratio: float | None = None,
) -> MatchResult:
    """Masked per-row best match with optional best/second-best ratio
    (the mfNNratio test, src/ORBmatcher.cc:330-344, 664-668).  Ties go
    to the lowest column, as ``jnp.argmin``."""
    d = torch.where(mask, dist, torch.full_like(dist, _BIG))
    best, best_idx = _min_lowest(d, dim=1)
    ok = best <= max_dist
    if ratio is not None:
        # the best column masked out (a masked fill: an indexed store of
        # a Python number copies it from the host, which a CUDA graph
        # cannot hold)
        cols = torch.arange(d.shape[1], device=d.device)
        second = d.masked_fill(cols[None, :] == best_idx[:, None],
                               _BIG).amin(dim=1)
        ok = ok & (best.float() < ratio * second.float())
    return MatchResult(idx=best_idx, dist=best, valid=ok)


def _min_lowest(d: torch.Tensor, dim: int):
    """(min, argmin) along ``dim`` with ties at the lowest index
    (``torch.min`` promises no tie order)."""
    m = d.amin(dim=dim, keepdim=True)
    n = d.shape[dim]
    shape = [1] * d.dim()
    shape[dim] = n
    ar = torch.arange(n, device=d.device).reshape(shape)
    idx = torch.where(d == m, ar, torch.full_like(ar, n)).amin(dim=dim)
    return m.squeeze(dim), idx


def mutual_best(dist: torch.Tensor, mask: torch.Tensor,
                fwd: MatchResult) -> torch.Tensor:
    """Require row i's best column j to also have row i as ITS best
    (src/ORBmatcher.cc:620-640).  Returns updated validity (N,)."""
    d = torch.where(mask, dist, torch.full_like(dist, _BIG))
    _, col_best_row = _min_lowest(d, dim=0)  # (M,)
    rows = torch.arange(dist.shape[0], device=dist.device)
    return fwd.valid & (col_best_row[fwd.idx] == rows)


def rotation_consistency_mask(
    angle1: torch.Tensor,
    angle2_of_match: torch.Tensor,
    valid: torch.Tensor,
    n_keep: int = 3,
) -> torch.Tensor:
    """Keep only matches whose angle difference falls in the 3 most
    populated of 30 histogram bins, dropping bins under 10% of the max
    count (ComputeThreeMaxima, src/ORBmatcher.cc:1943-1989)."""
    two_pi = float(np.float32(2.0 * math.pi))
    rot = torch.remainder(angle1 - angle2_of_match, two_pi)
    bins = torch.clamp((rot * float(np.float32(HISTO_BINS / (2.0 * math.pi))))
                       .to(torch.int32), 0, HISTO_BINS - 1).long()
    counts = torch.zeros(HISTO_BINS, dtype=torch.int64, device=valid.device)
    counts.index_add_(0, bins, valid.long())
    # lax.top_k order: largest counts first, ties at the lowest bin
    top_vals, top_idx = torch.sort(counts, descending=True, stable=True)
    top_vals, top_idx = top_vals[:n_keep], top_idx[:n_keep]
    keep_bin = top_vals > (top_vals[0].float() * 0.1).long()
    in_top = torch.zeros(HISTO_BINS, dtype=torch.bool, device=valid.device)
    in_top[top_idx] = keep_bin
    return valid & in_top[bins]
