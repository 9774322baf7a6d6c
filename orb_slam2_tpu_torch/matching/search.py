"""The search routines of the pose-prior path, as masked-matrix
functions in torch.

Port of ``orb_slam2_tpu/matching/search.py``.  Each function mirrors one
ORBmatcher search (file:line cited per function).  Rows are the "source"
entities (map points / reference features), columns the candidate
keypoints of the target frame.  The projection searches run through
kernel K2 and the fused triangulation search through kernel K3
(``hamming_top2``); the BoW-node and rotation-checked variant of
``search_for_triangulation`` and the Sim3 searches belong to later
slices of the port.
"""
from __future__ import annotations

import torch

from . import core, hamming_top2 as ht
from .core import MatchResult, TH_LOW, TH_HIGH


def _chebyshev_window_mask(xy1, xy2, radius) -> torch.Tensor:
    """(N,2) x (M,2) -> (N,M) bool: |dx|<=r and |dy|<=r (the reference's
    GetFeaturesInArea square window, src/Frame.cc:371-459)."""
    dx = (xy1[:, None, 0] - xy2[None, :, 0]).abs()
    dy = (xy1[:, None, 1] - xy2[None, :, 1]).abs()
    return (dx <= radius) & (dy <= radius)


def _windowed_top2(desc_rows, desc_cols, uv, radius, lmin, lmax, rvalid,
                   kp_xy, kp_octave, cvalid):
    """Masked windowed top-2 + column-best through kernel K2.  Returns
    (best, best_idx, second, second_idx, col_best_row) with
    dist == MASK_D meaning "no match".

    Row sets taller than ROW_STRIDE run in ROW_STRIDE chunks; each
    column's best row is then the lowest (distance, row) over the
    chunks, which a single call would give if its keys were wide
    enough.  (The JAX twin has no such split and aliases its keys
    there.)"""
    row_attr = torch.stack(
        [uv[:, 0], uv[:, 1], radius.float(), lmin.float(), lmax.float(),
         rvalid.float()], dim=1)
    col_attr = torch.stack(
        [kp_xy[:, 0], kp_xy[:, 1], kp_octave.float(), cvalid.float()], dim=1)
    n = desc_rows.shape[0]
    bks, sks = [], []
    col_d = col_row = None
    for r0 in range(0, n, ht.ROW_STRIDE):
        r1 = min(n, r0 + ht.ROW_STRIDE)
        bk, sk, ck = ht.masked_top2_mutual(desc_rows[r0:r1], desc_cols,
                                           row_attr[r0:r1], col_attr)
        bks.append(bk)
        sks.append(sk)
        cd = ck // ht.ROW_STRIDE
        cr = (ck % ht.ROW_STRIDE).long() + r0
        if col_d is None:
            col_d, col_row = cd, cr
        else:
            better = cd < col_d      # earlier chunks hold the lower rows
            col_d = torch.where(better, cd, col_d)
            col_row = torch.where(better, cr, col_row)
    bk = torch.cat(bks)
    sk = torch.cat(sks)
    best = bk // ht.COL_STRIDE
    bidx = (bk % ht.COL_STRIDE).long()
    second = sk // ht.COL_STRIDE
    sidx = (sk % ht.COL_STRIDE).long()
    return best, bidx, second, sidx, col_row


def search_for_initialization(
    xy1, desc1, valid1, octave1, angle1,
    xy2, desc2, valid2, octave2, angle2,
    window: float = 100.0,
    ratio: float = 0.9,
    check_rotation: bool = True,
) -> MatchResult:
    """ORBmatcher::SearchForInitialization (src/ORBmatcher.cc:543-696):
    level-0 features only, square window around the level-0 position,
    TH_LOW + best/second ratio, mutual-best dedup, rotation histogram."""
    dist = core.hamming_matrix(desc1, desc2)
    mask = (
        valid1[:, None] & valid2[None, :]
        & (octave1 == 0)[:, None] & (octave2 == 0)[None, :]
        & _chebyshev_window_mask(xy1, xy2, window)
    )
    res = core.best_match(dist, mask, max_dist=TH_LOW, ratio=ratio)
    valid = core.mutual_best(dist, mask, res)
    if check_rotation:
        valid = core.rotation_consistency_mask(angle1, angle2[res.idx], valid)
    return MatchResult(res.idx, res.dist, valid)


def search_by_projection_local_map(
    uv_proj, pred_level, view_cos, mp_desc, mp_valid,
    kp_xy, kp_octave, kp_desc, kp_valid, kp_has_mp,
    scale_factors, th: float = 1.0,
    ratio: float = 0.8,
) -> MatchResult:
    """ORBmatcher::SearchByProjection(F, vpMapPoints, th)
    (src/ORBmatcher.cc:64-160): local-map points vs the current frame.
    Radius 2.5 px when view_cos > 0.998 else 4.0, times the predicted
    level's scale and ``th``; the ratio test applies only when best and
    second-best share a pyramid level; keypoints already bound are
    excluded."""
    r_base = torch.where(view_cos > 0.998, 2.5, 4.0)
    radius = r_base * th * scale_factors[pred_level]

    best, best_idx, second, second_idx, col_row = _windowed_top2(
        mp_desc, kp_desc, uv_proj, radius,
        pred_level - 1, pred_level + 1, mp_valid,
        kp_xy, kp_octave, kp_valid & ~kp_has_mp)
    same_level = kp_octave[best_idx] == kp_octave[second_idx]
    ratio_ok = torch.where(
        same_level & (second < ht.MASK_D),
        best.float() <= ratio * second.float(),
        torch.ones_like(same_level),
    )
    rows = torch.arange(best.shape[0], device=best.device)
    valid = ((best <= TH_HIGH) & ratio_ok
             & (col_row[best_idx] == rows))
    return MatchResult(best_idx, best, valid)


def search_by_projection_last_frame(
    uv_proj, last_octave, mp_desc, mp_valid, mp_angle,
    kp_xy, kp_octave, kp_desc, kp_valid, kp_angle,
    scale_factors, th: float = 7.0,
    check_rotation: bool = True,
) -> MatchResult:
    """ORBmatcher::SearchByProjection(CurrentFrame, LastFrame, th, mono)
    (src/ORBmatcher.cc:1633-1797), the TrackWithInitialPose matcher:
    radius th * scale[last_octave], candidate levels [last-1, last+1],
    TH_HIGH, rotation consistency, mutual best."""
    radius = th * scale_factors[last_octave]
    best, best_idx, second, second_idx, col_row = _windowed_top2(
        mp_desc, kp_desc, uv_proj, radius,
        last_octave - 1, last_octave + 1, mp_valid,
        kp_xy, kp_octave, kp_valid)
    rows = torch.arange(best.shape[0], device=best.device)
    valid = (best <= TH_HIGH) & (col_row[best_idx] == rows)
    if check_rotation:
        valid = core.rotation_consistency_mask(mp_angle, kp_angle[best_idx],
                                               valid)
    return MatchResult(best_idx, best, valid)


def search_descriptors(
    desc1, valid1, angle1,
    desc2, valid2, angle2,
    ratio: float = 0.7,
    check_rotation: bool = True,
    max_dist: int = TH_LOW,
) -> MatchResult:
    """ORBmatcher::SearchByBoW (src/ORBmatcher.cc:222-392, 698-851)
    across all pairs (the JAX function with node=None, the form tracking
    uses before a vocabulary exists): best + TH_LOW + ratio + rotation,
    mutual best."""
    dist = core.hamming_matrix(desc1, desc2)
    mask = valid1[:, None] & valid2[None, :]
    res = core.best_match(dist, mask, max_dist=max_dist, ratio=ratio)
    valid = core.mutual_best(dist, mask, res)
    if check_rotation:
        valid = core.rotation_consistency_mask(angle1, angle2[res.idx], valid)
    return MatchResult(res.idx, res.dist, valid)


def search_for_triangulation(
    xy1, desc1, valid1, octave1,
    xy2, desc2, valid2, octave2,
    F12, epipole2_uv, sigma2_levels,
    scale_factors,
    epi_chi2: float = 3.84,
) -> MatchResult:
    """ORBmatcher::SearchForTriangulation (src/ORBmatcher.cc:853-1057),
    the fused BoW-free branch of the JAX function (node=None,
    check_rotation=False), through kernel K3.

    Matches features of KF1 against KF2 subject to the epipolar
    constraint under F12 (d^2 < 3.84 sigma^2 of the kp2 level) and the
    near-epipole exclusion (src/ORBmatcher.cc:953-960: skip kp2 closer
    than 100 * scale[octave2] px^2 to the epipole).  Callers pre-mask
    features that already have map points via valid*."""
    octave2 = octave2.long()
    dex = xy2[:, 0] - epipole2_uv[0]
    dey = xy2[:, 1] - epipole2_uv[1]
    far_from_epipole = (dex * dex + dey * dey) >= 100.0 * scale_factors[octave2]

    # epipolar lines of every row-1 feature in image 2, normalized so
    # the kernel's point-line test is (a'x + b'y + c')^2 < thr
    ones1 = torch.ones_like(xy1[:, :1])
    lines = torch.cat([xy1, ones1], dim=1) @ F12   # (N1, 3)
    den = lines[:, 0] ** 2 + lines[:, 1] ** 2
    s = torch.rsqrt(torch.clamp(den, min=1e-12))
    row_attr = torch.stack(
        [lines[:, 0] * s, lines[:, 1] * s, lines[:, 2] * s,
         valid1.float()], dim=1)
    thr = epi_chi2 * sigma2_levels[octave2]
    col_attr = torch.stack(
        [xy2[:, 0], xy2[:, 1], thr,
         (valid2 & far_from_epipole).float()], dim=1)
    bk, _, ck = ht.masked_top2_epi(desc1, desc2, row_attr, col_attr)
    best = bk // ht.COL_STRIDE
    bidx = (bk % ht.COL_STRIDE).long()
    col_row = (ck % ht.ROW_STRIDE).long()
    rows = torch.arange(best.shape[0], device=best.device)
    valid = (best <= TH_LOW) & (col_row[bidx] == rows)
    return MatchResult(bidx, best, valid)
