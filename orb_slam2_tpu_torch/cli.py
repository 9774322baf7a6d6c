"""Command-line entry points (port of ``orb_slam2_tpu/cli.py``: the same
commands, arguments, outputs and printed JSON).

``python -m orb_slam2_tpu_torch.cli run launch.toml`` replicates the
reference's mono_shenzhen example (Examples/Monocular/mono_shenzhen.cc
:101-174): parse the launch TOML, load the image list and UE4/AirSim
pose list (converted + rebased to the first camera), drive
TrackMonocularWithPose per frame, write per-frame tracked PLYs and the
final map PLY.

``python -m orb_slam2_tpu_torch.cli tum <sequence_dir>`` runs the
estimated-pose (upstream ORB-SLAM2 monocular) pipeline on a TUM RGB-D
sequence directory and writes a TUM-format trajectory for ATE
evaluation; ``kitti`` and ``euroc`` do the same on those datasets'
layouts.

Every command runs on ``--device`` (default ``cuda``; ``cpu`` runs the
plain versions of the kernels).  ``--viz [PORT]`` serves the live viewer
(``utils/viewer.py``) on 127.0.0.1 during the run; ``--viz-dir DIR``
also refreshes its PNGs in DIR.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _load_image(path: str) -> np.ndarray:
    """Grayscale float32 image loader: cv2 if present, else PIL, else
    .npy files."""
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        try:
            import cv2
            img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
            if img is None:
                raise FileNotFoundError(path)
        except ImportError:
            from PIL import Image
            img = np.asarray(Image.open(path).convert("L"))
    if img.ndim == 3:
        img = img.mean(-1)
    return img.astype(np.float32)


def _maybe_viewer(args, system):
    """--viz [PORT]: start the live HTTP viewer (utils/viewer) attached
    to this run; --viz-dir DIR additionally refreshes PNGs on disk."""
    port = getattr(args, "viz", None)
    viz_dir = getattr(args, "viz_dir", "") or None
    if port is None and viz_dir is None:
        return None
    from .utils.viewer import LiveViewer
    v = LiveViewer(system.store, port=port, out_dir=viz_dir)
    v.attach(system)
    if v.port is not None:
        print(f"live viewer: http://127.0.0.1:{v.port}/", file=sys.stderr)
    return v


def _add_common_args(p):
    p.add_argument("--viz", nargs="?", const=0, default=None, type=int,
                   metavar="PORT",
                   help="serve a live frame+map view over HTTP "
                        "(default: pick a free port)")
    p.add_argument("--viz-dir", default="",
                   help="also refresh frame.png/map.png in this directory")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")


def _load_vocabulary(path: str):
    if not path or not os.path.exists(path):
        return None
    if path.endswith(".npz"):
        from .models.vocabulary import Vocabulary
        return Vocabulary.load(path)
    from .io.orbvoc import load_orbvoc_binary
    return load_orbvoc_binary(path)


def cmd_run(args) -> int:
    """mono_shenzhen.cc:101-174 semantics."""
    from .io import (load_launch_toml, load_settings_yaml,
                     load_ue4_camera_poses)
    from .io.poses import load_image_list
    from .pipeline.system import System
    from .pipeline.tracking import TrackState

    launch = load_launch_toml(args.launch)
    cfg = load_settings_yaml(launch.orbslam_config_path, pose_prior=True)
    images = load_image_list(launch.images_collection_path)
    poses, revert = load_ue4_camera_poses(launch.camera_pose_collection_path)
    if len(images) != len(poses):
        print(f"image count {len(images)} != pose count {len(poses)}",
              file=sys.stderr)
        return 2

    vocab = _load_vocabulary(launch.vocabulary_path)
    system = System(cfg, enable_loop_closing=not args.no_loop, vocab=vocab,
                    device=args.device)
    system.set_real_transform(revert)
    viewer = _maybe_viewer(args, system)

    out_dir = args.out
    os.makedirs(out_dir, exist_ok=True)
    t_total = 0.0
    n_ok = 0
    for i, (img_path, Tcw) in enumerate(zip(images, poses)):
        img = _load_image(img_path)
        t0 = time.perf_counter()
        system.track_monocular_with_pose(img, i / cfg.fps, Tcw)
        t_total += time.perf_counter() - t0
        if system.state == TrackState.OK:
            n_ok += 1
            system.save_tracked_map_ply(
                os.path.join(out_dir, f"tracked_{i:06d}.ply"))
        print(f"frame {i}: state={system.state.name} "
              f"kfs={system.store.n_valid_keyframes()} "
              f"mps={system.store.n_valid_points()}", file=sys.stderr)
    system.save_map_ply(os.path.join(out_dir, "map.ply"))
    if viewer is not None:
        viewer.close()
    system.shutdown()
    print(json.dumps({"frames": len(images), "tracked_ok": n_ok,
                      "fps": len(images) / max(t_total, 1e-9)}))
    return 0


def cmd_tum(args) -> int:
    """Upstream mono_tum example semantics: estimated-pose tracking on a
    TUM sequence (rgb.txt image list), TUM trajectory output."""
    from .geom.camera import Intrinsics
    from .ops.extractor import OrbParams
    from .pipeline.config import SlamConfig
    from .pipeline.system import System
    from .pipeline.tracking import TrackState
    from .io.poses import save_tum_trajectory

    seq = args.sequence
    rgb_txt = os.path.join(seq, "rgb.txt")
    ts_list, files = [], []
    with open(rgb_txt) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, rel = line.split()[:2]
            ts_list.append(float(t))
            files.append(os.path.join(seq, rel))
    if args.settings:
        from .io import load_settings_yaml
        cfg = load_settings_yaml(args.settings, pose_prior=False)
    else:
        # TUM freiburg1 defaults
        cam = Intrinsics(fx=517.306408, fy=516.469215,
                         cx=318.643040, cy=255.313989,
                         dist=(0.262383, -0.953104, -0.005358,
                               0.002628, 1.163314),
                         width=640, height=480)
        cfg = SlamConfig(cam=cam, orb=OrbParams(n_features=1000, n_levels=8),
                         fps=30.0, pose_prior=False)
    vocab = _load_vocabulary(args.vocab) if args.vocab else None
    system = System(cfg, enable_loop_closing=not args.no_loop, vocab=vocab,
                    device=args.device)
    viewer = _maybe_viewer(args, system)

    limit = args.limit or len(files)
    for i, (t, fp) in enumerate(zip(ts_list[:limit], files[:limit])):
        system.track_monocular(_load_image(fp), t)
        print(f"frame {i}: state={system.state.name}", file=sys.stderr)
    Tcw_list = [T for _, _, T, st in system.trajectory
                if st == TrackState.OK]
    ts_ok = [t for _, t, _, st in system.trajectory if st == TrackState.OK]
    save_tum_trajectory(args.traj_out, ts_ok, Tcw_list)
    if viewer is not None:
        viewer.close()
    system.shutdown()
    print(json.dumps({"frames": limit, "tracked_ok": len(Tcw_list)}))
    return 0


def cmd_kitti(args) -> int:
    """Upstream mono_kitti example semantics: estimated-pose tracking on
    a KITTI odometry sequence (image_0/*.png at 10 fps), KITTI-format
    trajectory output for ATE evaluation against poses/XX.txt."""
    import glob
    from .geom.camera import Intrinsics
    from .ops.extractor import OrbParams
    from .pipeline.config import SlamConfig
    from .pipeline.system import System
    from .pipeline.tracking import TrackState
    from .io.poses import save_kitti_trajectory

    files = sorted(glob.glob(os.path.join(args.sequence, "image_0", "*")))
    if not files:
        files = sorted(glob.glob(os.path.join(args.sequence, "*.png")))
    if args.settings:
        from .io import load_settings_yaml
        cfg = load_settings_yaml(args.settings, pose_prior=False)
    else:
        # KITTI00-02 defaults (upstream Examples/Monocular/KITTI00-02.yaml)
        cam = Intrinsics(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                         width=1241, height=376)
        cfg = SlamConfig(cam=cam, orb=OrbParams(n_features=2000, n_levels=8),
                         fps=10.0, pose_prior=False)
    vocab = _load_vocabulary(args.vocab) if args.vocab else None
    system = System(cfg, enable_loop_closing=not args.no_loop, vocab=vocab,
                    device=args.device)
    viewer = _maybe_viewer(args, system)

    limit = args.limit or len(files)
    for i, fp in enumerate(files[:limit]):
        system.track_monocular(_load_image(fp), i / cfg.fps)
        if i + 1 < limit:
            system.prefetch(_load_image(files[i + 1]))
        print(f"frame {i}: state={system.state.name}", file=sys.stderr)
    Tcw_list = [T for _, _, T, st in system.trajectory
                if st == TrackState.OK]
    save_kitti_trajectory(args.traj_out, Tcw_list)
    if viewer is not None:
        viewer.close()
    system.shutdown()
    print(json.dumps({"frames": limit, "tracked_ok": len(Tcw_list),
                      "loops_closed": getattr(system.loop_closer,
                                              "n_loops_closed", 0)}))
    return 0


def cmd_euroc(args) -> int:
    """Upstream mono_euroc example semantics: ASL-format sequence
    (mav0/cam0/data/*.png + data.csv timestamps), estimated-pose
    tracking with relocalization, TUM-format trajectory output."""
    from .geom.camera import Intrinsics
    from .ops.extractor import OrbParams
    from .pipeline.config import SlamConfig
    from .pipeline.system import System
    from .pipeline.tracking import TrackState
    from .io.poses import save_tum_trajectory

    cam_dir = os.path.join(args.sequence, "mav0", "cam0")
    if not os.path.isdir(cam_dir):
        cam_dir = args.sequence
    csv = os.path.join(cam_dir, "data.csv")
    ts_list, files = [], []
    with open(csv) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t_ns, name = line.split(",")[:2]
            ts_list.append(float(t_ns) * 1e-9)
            files.append(os.path.join(cam_dir, "data", name.strip()))
    if args.settings:
        from .io import load_settings_yaml
        cfg = load_settings_yaml(args.settings, pose_prior=False)
    else:
        # EuRoC cam0 defaults (upstream Examples/Monocular/EuRoC.yaml)
        cam = Intrinsics(fx=435.2046959714599, fy=435.2046959714599,
                         cx=367.4517211914062, cy=252.2008514404297,
                         width=752, height=480)
        cfg = SlamConfig(cam=cam, orb=OrbParams(n_features=1000, n_levels=8),
                         fps=20.0, pose_prior=False)
    vocab = _load_vocabulary(args.vocab) if args.vocab else None
    system = System(cfg, enable_loop_closing=not args.no_loop, vocab=vocab,
                    device=args.device)
    viewer = _maybe_viewer(args, system)

    limit = args.limit or len(files)
    for i, (t, fp) in enumerate(zip(ts_list[:limit], files[:limit])):
        system.track_monocular(_load_image(fp), t)
        print(f"frame {i}: state={system.state.name}", file=sys.stderr)
    Tcw_list = [T for _, _, T, st in system.trajectory
                if st == TrackState.OK]
    ts_ok = [t for _, t, _, st in system.trajectory if st == TrackState.OK]
    save_tum_trajectory(args.traj_out, ts_ok, Tcw_list)
    if viewer is not None:
        viewer.close()
    system.shutdown()
    print(json.dumps({"frames": limit, "tracked_ok": len(Tcw_list)}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="orb_slam2_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="mono_shenzhen-style pose-prior run")
    r.add_argument("launch", help="launch.toml path")
    r.add_argument("--out", default="Out", help="output directory")
    r.add_argument("--no-loop", action="store_true")
    _add_common_args(r)
    r.set_defaults(fn=cmd_run)

    t = sub.add_parser("tum", help="TUM monocular (estimated pose)")
    t.add_argument("sequence", help="TUM sequence directory with rgb.txt")
    t.add_argument("--settings", default="")
    t.add_argument("--vocab", default="")
    t.add_argument("--traj-out", default="trajectory_tum.txt")
    t.add_argument("--limit", type=int, default=0)
    t.add_argument("--no-loop", action="store_true")
    _add_common_args(t)
    t.set_defaults(fn=cmd_tum)

    kd = sub.add_parser("kitti", help="KITTI odometry monocular")
    kd.add_argument("sequence", help="sequence dir (contains image_0/)")
    kd.add_argument("--settings", default="")
    kd.add_argument("--vocab", default="")
    kd.add_argument("--traj-out", default="trajectory_kitti.txt")
    kd.add_argument("--limit", type=int, default=0)
    kd.add_argument("--no-loop", action="store_true")
    _add_common_args(kd)
    kd.set_defaults(fn=cmd_kitti)

    e = sub.add_parser("euroc", help="EuRoC MAV monocular (ASL format)")
    e.add_argument("sequence", help="sequence dir (contains mav0/cam0)")
    e.add_argument("--settings", default="")
    e.add_argument("--vocab", default="")
    e.add_argument("--traj-out", default="trajectory_euroc.txt")
    e.add_argument("--limit", type=int, default=0)
    e.add_argument("--no-loop", action="store_true")
    _add_common_args(e)
    e.set_defaults(fn=cmd_euroc)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
