"""The port's dataset runners (``cli tum``, ``kitti``, ``euroc``) end to
end on synthetic sequences written in each dataset's layout, in
estimated-pose mode on the CPU.

- ``tum``:   rgb.txt ("t rel_path") + frames      (upstream mono_tum)
- ``kitti``: image_0/%06d frames at fixed fps     (upstream mono_kitti)
- ``euroc``: mav0/cam0/data.csv + data/<ns> frames (upstream mono_euroc)

Frames are ``.npy`` (uint8) of the port's renderer, on
tests/test_cli_datasets.py's curved sweep.  Bars: the trajectory file is
byte for byte what the JAX package's writer makes of the poses the port
tracked, it has a line per frame tracked OK, and its camera centers lie
within tests/test_cli_datasets.py's Sim3-aligned ATE bar (0.25 over a
~5 unit sweep) of the true ones."""
import json

import numpy as np
import pytest
import torch

from orb_slam2_tpu.io import poses as jposes
from orb_slam2_tpu_torch import cli as tcli
from orb_slam2_tpu_torch.geom.camera import Intrinsics
from orb_slam2_tpu_torch.pipeline.system import System
from orb_slam2_tpu_torch.pipeline.tracking import TrackState
from orb_slam2_tpu_torch.utils import synth
from orb_slam2_tpu_torch.utils.evaluate import ate_rmse

torch.set_num_threads(1)

N_FRAMES = 12
CAM = Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640,
                 height=480)
SETTINGS = """%YAML:1.0
Camera.fx: 450.0
Camera.fy: 450.0
Camera.cx: 320.0
Camera.cy: 240.0
Camera.width: 640
Camera.height: 480
Camera.fps: 10.0
ORBextractor.nFeatures: 800
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
"""


@pytest.fixture(scope="module")
def frames():
    world = synth.make_world(seed=3, device="cpu")
    poses = synth.aerial_trajectory(N_FRAMES, speed=0.35, yaw_rate=0.08)
    imgs = [np.clip(synth.render(world, CAM, T).numpy(), 0, 255)
            .astype(np.uint8) for T in poses]
    return poses, imgs


def _layout(kind, root, imgs):
    """Writes the sequence in ``kind``'s layout; returns its directory."""
    if kind == "tum":
        (root / "rgb").mkdir()
        lines = ["# timestamp filename"]
        for i, img in enumerate(imgs):
            np.save(root / "rgb" / f"{i:04d}.npy", img)
            lines.append(f"{i / 10.0:.6f} rgb/{i:04d}.npy")
        (root / "rgb.txt").write_text("\n".join(lines) + "\n")
        return root
    if kind == "kitti":
        (root / "image_0").mkdir()
        for i, img in enumerate(imgs):
            np.save(root / "image_0" / f"{i:06d}.npy", img)
        return root
    data = root / "mav0" / "cam0" / "data"
    data.mkdir(parents=True)
    lines = ["#timestamp [ns],filename"]
    for i, img in enumerate(imgs):
        name = f"{int(1403636579763555584 + i * 5e7):019d}.npy"
        np.save(data / name, img)
        lines.append(f"{int(1403636579763555584 + i * 5e7)},{name}")
    (root / "mav0" / "cam0" / "data.csv").write_text("\n".join(lines))
    return root


@pytest.mark.parametrize("kind", ["tum", "kitti", "euroc"])
def test_dataset_runner(kind, frames, tmp_path, capsys, monkeypatch):
    poses, imgs = frames
    (tmp_path / "seq").mkdir()
    seq = _layout(kind, tmp_path / "seq", imgs)
    (tmp_path / "settings.yaml").write_text(SETTINGS)
    systems = []
    shutdown = System.shutdown

    def keep(self):
        systems.append(self)
        shutdown(self)
    monkeypatch.setattr(System, "shutdown", keep)
    traj = tmp_path / "traj.txt"
    capsys.readouterr()
    assert tcli.main([kind, str(seq), "--no-loop", "--device", "cpu",
                      "--settings", str(tmp_path / "settings.yaml"),
                      "--traj-out", str(traj)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["frames"] == N_FRAMES
    (system,) = systems
    ok = [(t, T) for _, t, T, st in system.trajectory if st == TrackState.OK]
    assert out["tracked_ok"] == len(ok) >= N_FRAMES - 4
    ref = tmp_path / "ref.txt"
    if kind == "kitti":
        assert set(out) == {"frames", "tracked_ok", "loops_closed"}
        jposes.save_kitti_trajectory(str(ref), [T for _, T in ok])
    else:
        assert set(out) == {"frames", "tracked_ok"}
        jposes.save_tum_trajectory(str(ref), [t for t, _ in ok],
                                   [T for _, T in ok])
    assert traj.read_bytes() == ref.read_bytes()
    rows = np.loadtxt(str(traj), ndmin=2)
    est = rows[:, 1:4] if kind != "kitti" else rows.reshape(-1, 3, 4)[:, :, 3]
    ok_ids = [i for i, (_, _, _, st) in enumerate(system.trajectory)
              if st == TrackState.OK]
    gt = np.stack([np.linalg.inv(poses[i])[:3, 3] for i in ok_ids])
    assert ate_rmse(est, gt, align="sim3") < 0.25
