"""Trajectory evaluation: ATE with Sim3 or SE3 alignment — port of
``orb_slam2_tpu/utils/evaluate.py`` (the TUM benchmark conventions:
align estimated camera centers to ground truth by Umeyama, Sim3 for
monocular, and report the RMSE of the aligned residuals).
"""
from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = True):
    """Least-squares s, R, t with dst ~ s R src + t (Umeyama 1991).
    src/dst: (N, 3).  Returns (s, R, t)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (sc ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_centers: np.ndarray, gt_centers: np.ndarray,
             align: str = "sim3") -> float:
    """Absolute trajectory error RMSE after alignment
    ('sim3' | 'se3' | 'none')."""
    assert est_centers.shape == gt_centers.shape
    if align == "none":
        aligned = est_centers
    else:
        s, R, t = umeyama_alignment(est_centers, gt_centers,
                                    with_scale=(align == "sim3"))
        aligned = (s * (R @ est_centers.T)).T + t
    return float(np.sqrt(((aligned - gt_centers) ** 2).sum(-1).mean()))
