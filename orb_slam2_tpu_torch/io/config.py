"""Launch + settings configuration (port of ``orb_slam2_tpu/io/config.py``,
host Python; the settings build the port's config types).

The reference uses a two-level config (SURVEY.md §5): a launch.toml with
4 file paths (Examples/Monocular/launch.toml:1-11, parsed at
mono_shenzhen.cc:102-113) and an OpenCV-YAML settings file with camera
intrinsics / ORB / viewer parameters (src/Tracking.cc:93-191).  Both are
supported here; the YAML parser handles the OpenCV FileStorage dialect
(%YAML directive, scalar key: value pairs) without needing OpenCV.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Optional

from ..geom.camera import Intrinsics
from ..ops.extractor import OrbParams
from ..pipeline.config import SlamConfig


@dataclass
class LaunchConfig:
    """The four launch.toml paths (launch.toml:1-11)."""
    vocabulary_path: str = ""
    images_collection_path: str = ""
    camera_pose_collection_path: str = ""
    orbslam_config_path: str = ""
    extra: Dict[str, str] = field(default_factory=dict)


def load_launch_toml(path: str) -> LaunchConfig:
    """Parse launch.toml (mono_shenzhen.cc:102-113 key names)."""
    import tomllib
    with open(path, "rb") as f:
        data = tomllib.load(f)
    known = {
        "FBoWVocabularyPath": "vocabulary_path",
        "ImagesCollectionPath": "images_collection_path",
        "CameraPoseCollectionPath": "camera_pose_collection_path",
        "ORBSLAMConfigPath": "orbslam_config_path",
    }
    out = LaunchConfig()
    for k, v in data.items():
        if k in known:
            setattr(out, known[k], str(v))
        else:
            out.extra[k] = v
    return out


_YAML_LINE = re.compile(r"^([A-Za-z0-9_.]+):\s*(.+?)\s*$")


def _parse_opencv_yaml(path: str) -> Dict[str, float]:
    """Minimal OpenCV FileStorage YAML reader: flat `Key: value` scalars
    (the only structure the reference settings files use)."""
    out: Dict[str, float] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].rstrip()
            if not line or line.startswith("%"):
                continue
            m = _YAML_LINE.match(line)
            if not m:
                continue
            key, val = m.group(1), m.group(2).strip().strip('"')
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val  # type: ignore[assignment]
    return out


def load_settings_yaml(path: str, pose_prior: bool = True,
                       width: Optional[int] = None,
                       height: Optional[int] = None) -> SlamConfig:
    """Build a SlamConfig from the reference's YAML settings schema
    (shenzhen_simple.yaml keys; src/Tracking.cc:95-190)."""
    y = _parse_opencv_yaml(path)
    w = int(y.get("Camera.width", width or 2 * y["Camera.cx"]))
    h = int(y.get("Camera.height", height or 2 * y["Camera.cy"]))
    cam = Intrinsics(
        fx=float(y["Camera.fx"]), fy=float(y["Camera.fy"]),
        cx=float(y["Camera.cx"]), cy=float(y["Camera.cy"]),
        dist=(float(y.get("Camera.k1", 0.0)), float(y.get("Camera.k2", 0.0)),
              float(y.get("Camera.p1", 0.0)), float(y.get("Camera.p2", 0.0)),
              float(y.get("Camera.k3", 0.0))),
        width=w, height=h,
    )
    orb = OrbParams(
        n_features=int(y.get("ORBextractor.nFeatures", 1000)),
        scale_factor=float(y.get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(y.get("ORBextractor.nLevels", 8)),
        th_fast_hi=float(y.get("ORBextractor.iniThFAST", 20)),
        th_fast_lo=float(y.get("ORBextractor.minThFAST", 7)),
    )
    return SlamConfig(
        cam=cam, orb=orb,
        fps=float(y.get("Camera.fps", 30.0)),
        pose_prior=pose_prior,
    )
