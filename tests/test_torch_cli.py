"""``python -m orb_slam2_tpu_torch.cli run``: the mono_shenzhen-style launch
flow of both packages' command lines on one dataset.

The dataset is written here in the reference's layout: ``.npy`` frames
of the port's renderer (640x480, test_cli.py's world and sweep), an image
list, a UE4 pose file (``io.poses.save_ue4_camera_poses``, the loader's
conversion inverted, so the revert transform maps the SLAM world back to
the synthetic one, whose ground is z = 0), an OpenCV settings YAML (800 features, 4 levels), a
launch TOML, and for one case a synthetic ORBvoc binary.  Both CLIs run
in this process; the port's with ``--device cpu``."""
import json
import os

import numpy as np
import pytest
import torch

from orb_slam2_tpu import cli as jcli
from orb_slam2_tpu.utils import ply as jply
from orb_slam2_tpu_torch import cli as tcli
from orb_slam2_tpu_torch.geom.camera import Intrinsics
from orb_slam2_tpu_torch.io.orbvoc import save_orbvoc_binary, synthetic_orbvoc
from orb_slam2_tpu_torch.io.poses import save_ue4_camera_poses
from orb_slam2_tpu_torch.utils import ply, synth

torch.set_num_threads(1)

N_FRAMES = 10
CAM = Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640,
                 height=480)
SETTINGS = """%YAML:1.0
Camera.fx: 450.0
Camera.fy: 450.0
Camera.cx: 320.0
Camera.cy: 240.0
Camera.fps: 10.0
ORBextractor.nFeatures: 800
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
"""


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("shenzhen")
    world = synth.make_world(seed=3, device="cpu")
    poses = synth.aerial_trajectory(N_FRAMES, speed=0.4)
    (root / "imgs").mkdir()
    paths = []
    for i, T in enumerate(poses):
        p = root / "imgs" / f"{i:03d}.npy"
        np.save(p, synth.render(world, CAM, T).numpy())
        paths.append(str(p))
    (root / "imgs.txt").write_text("\n".join(paths) + "\n")
    save_ue4_camera_poses(str(root / "cams.txt"), poses)
    (root / "settings.yaml").write_text(SETTINGS)
    save_orbvoc_binary(synthetic_orbvoc(k=10, L=3, seed=2),
                       str(root / "ORBvoc.bin"))
    for name, voc in (("plain", ""), ("orbvoc", str(root / "ORBvoc.bin"))):
        (root / f"launch_{name}.toml").write_text(
            f'FBoWVocabularyPath = "{voc}"\n'
            f'ImagesCollectionPath = "{root}/imgs.txt"\n'
            f'CameraPoseCollectionPath = "{root}/cams.txt"\n'
            f'ORBSLAMConfigPath = "{root}/settings.yaml"\n')
    return root, poses


def _run(main, args, capsys) -> dict:
    capsys.readouterr()
    assert main(args) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("launch,no_loop", [("plain", True),
                                            ("orbvoc", False)],
                         ids=["no-loop", "loop-orbvoc"])
def test_run_matches_reference(dataset, capsys, launch, no_loop):
    """Bars: equal ``frames`` and ``tracked_ok``; tracked PLYs for the
    same frames, each with the frame element; map points within
    test_torch_slice.py's bars (counts within 10%, and through the
    revert transform on the world's ground plane, median |z| < 0.08)."""
    root, poses = dataset
    toml = str(root / f"launch_{launch}.toml")
    extra = ["--no-loop"] if no_loop else []
    out = {k: root / f"out_{launch}_{k}" for k in ("jax", "port")}
    rj = _run(jcli.main, ["run", toml, "--out", str(out["jax"])] + extra,
              capsys)
    rp = _run(tcli.main, ["run", toml, "--out", str(out["port"]),
                          "--device", "cpu"] + extra, capsys)
    assert set(rp) == set(rj) == {"frames", "tracked_ok", "fps"}
    assert rp["frames"] == rj["frames"] == N_FRAMES
    assert rp["tracked_ok"] == rj["tracked_ok"] >= N_FRAMES - 1
    tracked = {k: sorted(p.name for p in out[k].glob("tracked_*.ply"))
               for k in out}
    assert tracked["port"] == tracked["jax"]
    assert len(tracked["port"]) == rp["tracked_ok"]
    head = (out["port"] / tracked["port"][-1]).read_bytes().partition(
        b"end_header")[0].decode()
    assert "element frame 1" in head and "property float k8" in head
    pp = ply.read_ply_points(str(out["port"] / "map.ply"))
    pj = jply.read_ply_points(str(out["jax"] / "map.ply"))
    assert abs(len(pp) - len(pj)) <= 0.1 * len(pj), (len(pp), len(pj))
    assert len(pp) > 200 and np.isfinite(pp).all()
    assert np.median(np.abs(pp[:, 2])) < 0.08
    assert np.median(np.abs(pj[:, 2])) < 0.08


def test_tracked_ply_pose_is_the_prior(dataset, capsys):
    """Through the revert transform the tracked PLY's pose is the
    synthetic world's pose of its frame (within 1e-4): Tcw_slam @
    inv(revert) = the loaded prior @ inv(revert)."""
    root, poses = dataset
    out = root / "out_pose"
    _run(tcli.main, ["run", str(root / "launch_plain.toml"), "--out",
                     str(out), "--no-loop", "--device", "cpu"], capsys)
    n = 0
    for p in sorted(out.glob("tracked_*.ply")):
        i = int(p.stem.split("_")[1])
        body = p.read_bytes()
        vals = np.frombuffer(body[-100:], "<f4")
        np.testing.assert_allclose(vals[:16].reshape(4, 4), poses[i],
                                   atol=1e-4)
        np.testing.assert_allclose(vals[16:].reshape(3, 3), CAM.K)
        n += 1
    assert n >= N_FRAMES - 1


def test_run_rejects_mismatched_lists(dataset, capsys, tmp_path):
    root, _ = dataset
    lines = (root / "imgs.txt").read_text().splitlines()
    (tmp_path / "imgs.txt").write_text("\n".join(lines[:-1]) + "\n")
    toml = (root / "launch_plain.toml").read_text().replace(
        f"{root}/imgs.txt", f"{tmp_path}/imgs.txt")
    (tmp_path / "launch.toml").write_text(toml)
    assert tcli.main(["run", str(tmp_path / "launch.toml"), "--out",
                      str(tmp_path / "out"), "--device", "cpu"]) == 2
    assert not os.path.exists(tmp_path / "out")
