"""Batched Sim3 RANSAC — port of ``orb_slam2_tpu/optim/sim3_ransac.py``.

Replaces src/Sim3Solver.cc:200-294 (sequential adaptive RANSAC) with a
fixed-batch hypothesis sweep: H minimal 3-point samples solved in one
batched Horn closed form (geom.horn), all H x N bidirectional
reprojection checks as one dense masked pass, the best hypothesis an
argmax.  Semantics kept:

- minimal sample size 3,
- per-point chi2 thresholds 9.210 * sigma2 of the keypoint octave
  (src/Sim3Solver.cc:43-150, mvnMaxError1/2),
- bidirectional inlier test (CheckInliers, src/Sim3Solver.cc:458-489),
- acceptance iff the best inlier count >= min_inliers.

The samples come from the caller (a seeded ``numpy.random.Generator``),
so both packages can be fed the same hypotheses.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom import horn, sim3

CHI2_SIM3 = 9.210  # 2-DoF chi2 at 0.01 (src/Sim3Solver.cc:139-143)


class Sim3RansacResult(NamedTuple):
    S12: torch.Tensor        # (8,) best similarity mapping frame2 -> frame1
    inliers: torch.Tensor    # (N,) bool for the best hypothesis
    n_inliers: torch.Tensor  # ()
    ok: torch.Tensor         # () bool: n_inliers >= min_inliers


def _project(pc, fx, fy, cx, cy):
    z = pc[..., 2]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    return torch.stack([fx * pc[..., 0] / z + cx,
                        fy * pc[..., 1] / z + cy], -1)


def sim3_ransac(pts1_cam, pts2_cam, uv1, uv2, max_err1, max_err2, valid,
                samples, fx: float, fy: float, cx: float, cy: float,
                min_inliers: int = 20,
                fix_scale: bool = False) -> Sim3RansacResult:
    """pts*_cam (N, 3) matched points in each KF's camera frame, uv*
    (N, 2) their keypoints, max_err* (N,) 9.210*sigma2 thresholds, valid
    (N,) bool, samples (H, 3) int indices into N."""
    samples = samples.long()
    sims = horn.horn_sim3(pts1_cam[samples], pts2_cam[samples],
                          fix_scale=fix_scale)                 # (H, 8)
    # a hypothesis whose sample hit a padded point is dead; degenerate
    # samples can give s <= 0 (masked)
    hyp_ok = valid[samples].all(-1) & (sim3.scale(sims) > 1e-6)

    p2_in_1 = sim3.apply(sims, pts2_cam)                      # (H, N, 3)
    p1_in_2 = sim3.apply(sim3.inv(sims), pts1_cam)
    e1 = _project(p2_in_1, fx, fy, cx, cy) - uv1[None]
    e2 = _project(p1_in_2, fx, fy, cx, cy) - uv2[None]
    inl = (valid[None]
           & ((e1 * e1).sum(-1) < max_err1[None])
           & ((e2 * e2).sum(-1) < max_err2[None]))            # (H, N)
    counts = torch.where(hyp_ok, inl.sum(-1), torch.full_like(hyp_ok, -1,
                                                              dtype=torch.long))
    # the first of equal counts; gathered by a 1-element index tensor (a
    # 0-d index tensor is read back to the host, a sync)
    best = torch.argmax(counts).reshape(1)
    n_best = counts.index_select(0, best)[0]
    return Sim3RansacResult(S12=sims.index_select(0, best)[0],
                            inliers=inl.index_select(0, best)[0],
                            n_inliers=torch.clamp(n_best, min=0),
                            ok=n_best >= min_inliers)
