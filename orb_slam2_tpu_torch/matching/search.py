"""The search routines of the pose-prior path, as masked-matrix
functions in torch.

Port of ``orb_slam2_tpu/matching/search.py``.  Each function mirrors one
ORBmatcher search (file:line cited per function).  Rows are the "source"
entities (map points / reference features), columns the candidate
keypoints of the target frame.  The projection searches run through
kernel K2 and the fused triangulation search through kernel K3
(``hamming_top2``).  The BoW search and the Sim3 searches of loop
closing use the dense distance matrix (``core.hamming_matrix``), as the
JAX package does outside its Pallas kernels.  The BoW-node and
rotation-checked variant of ``search_for_triangulation`` is not ported:
no caller of the port takes it.
"""
from __future__ import annotations

import torch

from ..geom import sim3 as sim3_mod
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
    desc1, valid1, angle1, node1,
    desc2, valid2, angle2, node2,
    ratio: float = 0.7,
    check_rotation: bool = True,
    max_dist: int = TH_LOW,
) -> MatchResult:
    """ORBmatcher::SearchByBoW (src/ORBmatcher.cc:222-392, 698-851).

    The reference walks aligned FeatureVector nodes as an acceleration;
    the acceptance rule is best-in-node + TH_LOW + ratio + rotation.
    Here the node constraint is an equality mask on the vocabulary node
    id per feature; node=None matches across all pairs (before a
    vocabulary exists).  Mutual best."""
    dist = core.hamming_matrix(desc1, desc2)
    mask = valid1[:, None] & valid2[None, :]
    if node1 is not None and node2 is not None:
        mask = mask & (node1[:, None] == node2[None, :])
    res = core.best_match(dist, mask, max_dist=max_dist, ratio=ratio)
    valid = core.mutual_best(dist, mask, res)
    if check_rotation:
        valid = core.rotation_consistency_mask(angle1, angle2[res.idx], valid)
    return MatchResult(res.idx, res.dist, valid)


def _project_rows(pc, fx, fy, cx, cy, bounds):
    """Pinhole projection of camera-frame rows (N, 3): (uv, z, in_img)."""
    z = pc[:, 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    u = fx * pc[:, 0] * inv_z + cx
    v = fy * pc[:, 1] * inv_z + cy
    minx, maxx, miny, maxy = bounds
    in_img = (u >= minx) & (u < maxx) & (v >= miny) & (v < maxy)
    return torch.stack([u, v], dim=-1), z, in_img


def _predicted_level(max_dist, dist, scale_factors, n_levels, log_scale):
    """Scale-band check (0.8/1.2 slack of GetMin/MaxDistanceInvariance,
    src/MapPoint.cc:570-585) and the predicted pyramid level."""
    min_d = max_dist / scale_factors[n_levels - 1]
    dist_ok = (dist >= 0.8 * min_d) & (dist <= 1.2 * max_dist)
    ratio_d = torch.clamp(max_dist, min=1e-12) / torch.clamp(dist, min=1e-12)
    lvl = torch.clamp(torch.ceil(torch.log(ratio_d) / log_scale).to(torch.int32),
                      0, n_levels - 1).long()
    return dist_ok, lvl


def search_by_projection_sim3(
    pts_w, mp_desc, mp_normal, mp_max_dist, mp_valid,
    Scw,
    kp_xy, kp_octave, kp_desc, kp_valid, kp_has_mp,
    scale_factors,
    fx: float, fy: float, cx: float, cy: float,
    bounds: tuple, n_levels: int, log_scale: float,
    th: float = 7.5, max_dist: int = TH_LOW,
) -> MatchResult:
    """ORBmatcher::SearchByProjection(KF, Scw, vpPoints, vpMatched, th)
    (src/ORBmatcher.cc:394-540): loop map points projected through a
    Sim3 world->camera into the current keyframe.  Checks: positive
    depth, in-image, distance within the point's scale band, viewing
    cos > 0.5, candidate levels [pred-1, pred], radius th * scale[pred],
    Hamming <= TH_LOW, no ratio test, mutual best; already-matched
    keypoints are excluded."""
    pc = sim3_mod.apply(Scw, pts_w)
    uv, z, in_img = _project_rows(pc, fx, fy, cx, cy, bounds)
    # camera center in world: Scw^-1 * 0
    ow = sim3_mod.apply_one(sim3_mod.inv(Scw), torch.zeros_like(pts_w[0]))
    po = pts_w - ow
    dist = torch.linalg.norm(po, dim=-1)
    dist_ok, lvl = _predicted_level(mp_max_dist, dist, scale_factors,
                                    n_levels, log_scale)
    vcos = (po * mp_normal).sum(-1) / torch.clamp(dist, min=1e-12)
    radius = th * scale_factors[lvl]

    row_ok = mp_valid & (z > 0) & in_img & dist_ok & (vcos > 0.5)
    koct = kp_octave.long()
    lvl_ok = (koct[None, :] >= lvl[:, None] - 1) & (koct[None, :] <= lvl[:, None])
    dmat = core.hamming_matrix(mp_desc, kp_desc)
    mask = (row_ok[:, None] & kp_valid[None, :] & (~kp_has_mp)[None, :]
            & lvl_ok & _chebyshev_window_mask(uv, kp_xy, radius[:, None]))
    res = core.best_match(dmat, mask, max_dist=max_dist, ratio=1.0)
    valid = core.mutual_best(dmat, mask, res)
    return MatchResult(res.idx, res.dist, valid)


def _sim3_directional_match(pc_src, desc_src, valid_src, max_dist_src,
                            S_dst_src,
                            kp_xy, kp_octave, kp_desc, kp_valid,
                            scale_factors, fx, fy, cx, cy, bounds,
                            n_levels, log_scale, th):
    """One direction of SearchBySim3: source map points (camera frame of
    their own KF) mapped through S_dst_src into the destination image and
    matched against its keypoints (src/ORBmatcher.cc:1430-1530)."""
    pc = sim3_mod.apply(S_dst_src, pc_src)
    uv, z, in_img = _project_rows(pc, fx, fy, cx, cy, bounds)
    dist = torch.linalg.norm(pc, dim=-1)
    dist_ok, lvl = _predicted_level(max_dist_src, dist, scale_factors,
                                    n_levels, log_scale)
    radius = th * scale_factors[lvl]

    row_ok = valid_src & (z > 0) & in_img & dist_ok
    # candidate octave band [pred-1, pred] (src/ORBmatcher.cc:1494)
    koct = kp_octave.long()
    lvl_ok = (koct[None, :] >= lvl[:, None] - 1) & (koct[None, :] <= lvl[:, None])
    dmat = core.hamming_matrix(desc_src, kp_desc)
    mask = (row_ok[:, None] & kp_valid[None, :]
            & lvl_ok & _chebyshev_window_mask(uv, kp_xy, radius[:, None]))
    return core.best_match(dmat, mask, max_dist=TH_HIGH, ratio=1.0)


def search_by_sim3(
    pc1, desc1, valid1, max_dist1, kp_xy1, kp_octave1, kp_valid1,
    pc2, desc2, valid2, max_dist2, kp_xy2, kp_octave2, kp_valid2,
    S12,
    scale_factors,
    fx: float, fy: float, cx: float, cy: float,
    bounds: tuple, n_levels: int, log_scale: float,
    th: float = 7.5,
) -> MatchResult:
    """ORBmatcher::SearchBySim3 (src/ORBmatcher.cc:1368-1630):
    bidirectional Sim3-projected search between two keyframes' map-point
    features; a pair is accepted only when both directions agree.  Rows
    are KF1 features (camera-1 position pc1); returns for each an index
    into KF2's features."""
    S21 = sim3_mod.inv(S12)
    geo = (scale_factors, fx, fy, cx, cy, bounds, n_levels, log_scale, th)
    # KF2 points into image 1, KF1 points into image 2
    m21 = _sim3_directional_match(pc2, desc2, valid2, max_dist2, S12,
                                  kp_xy1, kp_octave1, desc1,
                                  kp_valid1 & valid1, *geo)
    m12 = _sim3_directional_match(pc1, desc1, valid1, max_dist1, S21,
                                  kp_xy2, kp_octave2, desc2,
                                  kp_valid2 & valid2, *geo)
    j = m12.idx
    rows = torch.arange(j.shape[0], device=j.device)
    agree = m12.valid & m21.valid[j] & (m21.idx[j] == rows)
    return MatchResult(j, m12.dist, agree)


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
