"""Pose-file IO (port of ``orb_slam2_tpu/io/poses.py``, host numpy).

- UE4/AirSim pose lists with world rebasing — the reference's
  loadCamerasPose (Examples/Monocular/mono_shenzhen.cc:43-98).
- TUM-format trajectory load/save and KITTI-format save (upstream
  ORB-SLAM2's SaveTrajectoryTUM/KITTI, removed by the fork; restored
  capability for the benchmark configs).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def _quat_to_rot(qx, qy, qz, qw) -> np.ndarray:
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
    ])


def _rot_to_quat(R: np.ndarray):
    """Returns (qx, qy, qz, qw)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        qx, qy, qz, qw = q
    return qx, qy, qz, qw


# UE4 camera axes -> ORB-SLAM camera axes (front-z right-x down-y):
# rotCam2UE4 of mono_shenzhen.cc:55-58
_ROT_CAM2UE4 = np.array([[0.0, 0.0, 1.0],
                         [1.0, 0.0, 0.0],
                         [0.0, 1.0, 0.0]])


def load_ue4_camera_poses(path: str
                          ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Parse a UE4/AirSim pose list and return (Tcw list, revert_transform).

    File format (shenzhen_cameras.txt): one comment line, then per line
    ``x y z qx qy qz qw`` — UE4 left-handed position (z is negated to
    get a right-handed frame) and a right-handed quaternion
    (mono_shenzhen.cc:63-70).  The world is rebased so the first camera
    is the origin (``Tow``, :71-77); the returned 4x4
    ``revert_transform`` maps SLAM world -> original (rebased UE4-RH)
    world, the reference's ``revertTransform`` (:92-96) fed to
    System::SetRealTransform.
    """
    Tcw_list: List[np.ndarray] = []
    Tow: Optional[np.ndarray] = None
    with open(path) as f:
        first = True
        for line in f:
            if first:
                first = False
                continue  # header comment
            parts = line.split()
            if len(parts) < 7:
                continue
            x, y, z, rx, ry, rz, rw = map(float, parts[:7])
            z = -z  # UE4 left-handed -> right-handed
            Rwc = _quat_to_rot(rx, ry, rz, rw) @ _ROT_CAM2UE4
            Twc = np.eye(4)
            Twc[:3, :3] = Rwc
            Twc[:3, 3] = (x, y, z)
            if Tow is None:
                Tow = np.linalg.inv(Twc)
            Toc = Tow @ Twc
            Tcw_list.append(np.linalg.inv(Toc).astype(np.float32))
    revert = (np.linalg.inv(Tow) if Tow is not None
              else np.eye(4)).astype(np.float32)
    return Tcw_list, revert


def save_ue4_camera_poses(path: str, Tcw_list) -> None:
    """Write a UE4/AirSim pose list that :func:`load_ue4_camera_poses`
    maps back to ``Tcw_list`` up to the first-camera rebase (its revert
    transform is then the first pose's Twc): the loader's conversion
    inverted, Twc = (x, y, -z_ue4 | quat(q) @ rotCam2UE4).  The JAX
    package has no writer; synthetic shenzhen-layout datasets need one."""
    with open(path, "w") as f:
        f.write("# x y z qx qy qz qw\n")
        for Tcw in Tcw_list:
            Twc = np.linalg.inv(np.asarray(Tcw, np.float64))
            q = _rot_to_quat(Twc[:3, :3] @ _ROT_CAM2UE4.T)
            x, y, z = Twc[:3, 3]
            f.write(" ".join(repr(float(v)) for v in (x, y, -z, *q)) + "\n")


def load_image_list(path: str) -> List[str]:
    """One image path per line (mono_shenzhen.cc loadImages)."""
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()
                and not ln.lstrip().startswith("#")]


# ----------------------------------------------------------------------
# TUM / KITTI trajectory formats
# ----------------------------------------------------------------------
def load_tum_trajectory(path: str) -> Tuple[np.ndarray, List[np.ndarray]]:
    """TUM format: ``timestamp tx ty tz qx qy qz qw`` per line (camera-
    to-world).  Returns (timestamps, list of Twc 4x4)."""
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = list(map(float, line.split()))
            if len(v) < 8:
                continue
            T = np.eye(4)
            T[:3, :3] = _quat_to_rot(v[4], v[5], v[6], v[7])
            T[:3, 3] = v[1:4]
            ts.append(v[0])
            poses.append(T.astype(np.float32))
    return np.asarray(ts), poses


def save_tum_trajectory(path: str, timestamps, Tcw_list):
    """Upstream System::SaveTrajectoryTUM semantics: camera-to-world
    ``timestamp tx ty tz qx qy qz qw``."""
    with open(path, "w") as f:
        for t, Tcw in zip(timestamps, Tcw_list):
            Twc = np.linalg.inv(np.asarray(Tcw, np.float64))
            qx, qy, qz, qw = _rot_to_quat(Twc[:3, :3])
            tx, ty, tz = Twc[:3, 3]
            f.write(f"{t:.6f} {tx:.7f} {ty:.7f} {tz:.7f} "
                    f"{qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}\n")


def save_kitti_trajectory(path: str, Tcw_list):
    """Upstream System::SaveTrajectoryKITTI: 12 numbers per line, the
    camera-to-world 3x4 row-major."""
    with open(path, "w") as f:
        for Tcw in Tcw_list:
            Twc = np.linalg.inv(np.asarray(Tcw, np.float64))
            f.write(" ".join(f"{v:.9e}" for v in Twc[:3].reshape(-1)) + "\n")
