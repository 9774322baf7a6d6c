"""Host-side IO: launch/settings config, datasets, poses, vocabulary
files, PLY/trajectory export (port of ``orb_slam2_tpu/io``; host numpy,
no device work).

Replaces the reference's app-layer IO (Examples/Monocular/
mono_shenzhen.cc, toml++/OpenCV-YAML config, happly PLY, DBoW2 binary
vocabulary loading).
"""
from .config import LaunchConfig, load_launch_toml, load_settings_yaml  # noqa: F401
from .poses import load_ue4_camera_poses, load_tum_trajectory, save_tum_trajectory, save_kitti_trajectory  # noqa: F401
from .orbvoc import load_orbvoc_binary, load_orbvoc_text, save_orbvoc_binary  # noqa: F401
