"""Trajectory evaluation: ATE / RPE with Sim3 or SE3 alignment — port
of ``orb_slam2_tpu/utils/evaluate.py`` (the TUM benchmark conventions:
align estimated camera centers to ground truth by Umeyama, Sim3 for
monocular, and report the RMSE of the aligned residuals).
"""
from __future__ import annotations

from typing import List, Tuple

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


def camera_centers(Tcw_list) -> np.ndarray:
    return np.stack([-T[:3, :3].T @ T[:3, 3] for T in Tcw_list])


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


def rpe(Tcw_est: List[np.ndarray], Tcw_gt: List[np.ndarray],
        delta: int = 1) -> Tuple[float, float]:
    """Relative pose error over frame pairs (i, i+delta): returns
    (trans RMSE, rot RMSE in radians)."""
    dt, dr = [], []
    for i in range(len(Tcw_est) - delta):
        Ee = Tcw_est[i + delta] @ np.linalg.inv(Tcw_est[i])
        Eg = Tcw_gt[i + delta] @ np.linalg.inv(Tcw_gt[i])
        E = np.linalg.inv(Eg) @ Ee
        dt.append(np.linalg.norm(E[:3, 3]))
        c = np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1)
        dr.append(np.arccos(c))
    return (float(np.sqrt(np.mean(np.square(dt)))),
            float(np.sqrt(np.mean(np.square(dr)))))


def associate(ts_a: np.ndarray, ts_b: np.ndarray,
              max_dt: float = 0.02) -> List[Tuple[int, int]]:
    """Greedy nearest-timestamp association (the TUM associate.py
    scheme) for pairing estimated and ground-truth trajectories."""
    pairs = []
    used_b = set()
    for i, t in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - t)))
        if j not in used_b and abs(ts_b[j] - t) <= max_dt:
            pairs.append((i, j))
            used_b.add(j)
    return pairs
