"""The fork's System surface in the port against the JAX package: the
real-world transform, keyframe trajectory, camera centers, tracked
points, the map PLY, the per-frame tracked PLY and the per-frame hook.

Both Systems track the same 12 pose-prior frames (640x480, 800
features, 4 levels; test_torch_slice.py's configuration), rendered
once with the port's renderer, with the same real-world transform."""
import struct

import numpy as np
import pytest
import torch

from orb_slam2_tpu.geom.camera import Intrinsics as JIntrinsics
from orb_slam2_tpu.ops.extractor import OrbParams as JOrbParams
from orb_slam2_tpu.pipeline import SlamConfig as JSlamConfig, System as JSystem
from orb_slam2_tpu.utils import ply as jply
from orb_slam2_tpu_torch import interop
from orb_slam2_tpu_torch.geom.camera import Intrinsics
from orb_slam2_tpu_torch.ops.extractor import OrbParams
from orb_slam2_tpu_torch.pipeline.config import SlamConfig
from orb_slam2_tpu_torch.pipeline.system import System
from orb_slam2_tpu_torch.utils import ply, synth

torch.set_num_threads(1)

N_FRAMES = 12
CAM_KW = dict(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
CFG_KW = dict(fps=10.0, pose_prior=True, init_min_matches=60,
              init_min_triangulated=40, init_min_tracked_after_ba=60)


def _real_transform():
    """A rotation about a tilted axis and a translation (the revert
    transform of a UE4 pose list is of this kind)."""
    w = np.array([0.3, -0.5, 0.9])
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    T[:3, 3] = [12.5, -3.0, 40.0]
    return T.astype(np.float32)


def read_tracked_ply(path):
    """(header lines, vertices as a structured array, frame element as
    (id, Tcw (4, 4), K (3, 3)))."""
    data = open(path, "rb").read()
    head, _, body = data.partition(b"end_header\n")
    lines = head.decode().splitlines()
    n = int(next(ln for ln in lines if ln.startswith("element vertex"))
            .split()[-1])
    vdt = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3), ("uv", "<f4", 2),
                    ("octave", "<i4")])
    verts = np.frombuffer(body[:n * vdt.itemsize], vdt)
    rest = body[n * vdt.itemsize:]
    assert len(rest) == 4 + 25 * 4
    fid = struct.unpack("<i", rest[:4])[0]
    vals = np.frombuffer(rest[4:], "<f4")
    return lines, verts, (fid, vals[:16].reshape(4, 4), vals[16:].reshape(3, 3))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("surface")
    cfg = SlamConfig(cam=Intrinsics(**CAM_KW),
                     orb=OrbParams(n_features=800, n_levels=4), **CFG_KW)
    world = synth.make_world(seed=3, device="cpu")
    poses = synth.aerial_trajectory(N_FRAMES, speed=0.3)
    images = [synth.render(world, cfg.cam, T).numpy() for T in poses]
    jsys = JSystem(JSlamConfig(cam=JIntrinsics(**CAM_KW),
                               orb=JOrbParams(n_features=800, n_levels=4),
                               **CFG_KW), enable_loop_closing=False)
    port = System(cfg, enable_loop_closing=False, device="cpu")
    T_real = _real_transform()
    calls = {"jax": [], "port": []}
    for name, s in (("jax", jsys), ("port", port)):
        s.set_real_transform(T_real)
        s.on_frame_tracked = (lambda img, f, c=calls[name]:
                              c.append((img, f.frame_id)))
    tracked = []
    for i, T in enumerate(poses):
        jsys.track_monocular_with_pose(images[i], i * 0.1, T)
        port.track_monocular_with_pose(images[i], i * 0.1, T)
        ok = {}
        for name, s in (("jax", jsys), ("port", port)):
            p = str(out / f"{name}_tracked_{i:03d}.ply")
            ok[name] = s.save_tracked_map_ply(p)
        tracked.append((i, ok))
    jsys.save_map_ply(str(out / "jax_map.ply"))
    port.save_map_ply(str(out / "port_map.ply"))
    return dict(jsys=jsys, port=port, out=out, calls=calls, images=images,
                tracked=tracked, T_real=T_real)


def test_keyframe_trajectory_and_centers_agree(runs):
    """Bars: every frame's camera center within 1e-5 (the poses are the
    priors both were fed); the same keyframe ids, each made at the same
    frame or one frame apart (a decision near its threshold may fall a
    frame apart: test_torch_slice.py's keyframe bar), each keyframe's
    pose its frame's pose within 1e-5, so keyframes of one frame agree
    within 1e-5."""
    pc, jc = runs["port"].camera_centers(), runs["jsys"].camera_centers()
    assert pc.shape == jc.shape == (N_FRAMES, 3)
    np.testing.assert_allclose(pc, jc, atol=1e-5)
    kf_frames = {}
    for name in ("jsys", "port"):
        s = runs[name]
        traj = s.keyframe_trajectory()
        frames = {kf.kid: kf.frame.frame_id for kf in s.store.kfs}
        for kid, T in traj:
            np.testing.assert_allclose(T, s.trajectory[frames[kid]][2],
                                       atol=1e-5)
        kf_frames[name] = [frames[kid] for kid, _ in traj]
    assert len(kf_frames["port"]) == len(kf_frames["jsys"]) >= 3
    assert all(abs(a - b) <= 1 for a, b in zip(kf_frames["port"],
                                               kf_frames["jsys"]))
    assert sum(a == b for a, b in zip(kf_frames["port"],
                                      kf_frames["jsys"])) >= 3


def test_map_ply_through_the_real_transform(runs):
    """The map PLY holds the valid map points moved by the real-world
    transform.  Bars (test_torch_slice.py's map bars): point counts
    within 10% of the reference; in map coordinates both maps on the
    plane z = 0 (median |z| < 0.08)."""
    T = runs["T_real"]
    out = runs["out"]
    pp = ply.read_ply_points(str(out / "port_map.ply"))
    pj = jply.read_ply_points(str(out / "jax_map.ply"))
    np.testing.assert_allclose(
        pp, runs["port"].map_points() @ T[:3, :3].T + T[:3, 3], atol=1e-4)
    assert abs(len(pp) - len(pj)) <= 0.1 * len(pj), (len(pp), len(pj))
    assert len(pp) > 200
    Ti = np.linalg.inv(T.astype(np.float64))
    for pts in (pp, pj):
        m = pts @ Ti[:3, :3].T + Ti[:3, 3]
        assert np.median(np.abs(m[:, 2])) < 0.08


def test_tracked_ply_headers_and_frame_elements(runs):
    """Per tracked frame: the same header (the vertex count apart: the
    two maps part where a keyframe decision falls a frame apart), the
    frame element's id, Tcw * inv(real transform) and K within 1e-5,
    vertex counts within 5% where both packages made the same keyframe
    decision (a keyframe binds the points triangulated for it); the
    stored camera-space points project
    through K to their stored uv (pooled over the frames, median under
    1 px in both packages and within 0.15 px of each other), and the
    color is the caller's image at uv."""
    out = runs["out"]
    K = np.array([[450.0, 0, 320], [0, 450, 240], [0, 0, 1]])
    err = {"port": [], "jax": []}
    kf_frames = [{kf.frame.frame_id for kf in runs[n].store.kfs}
                 for n in ("port", "jsys")]
    n_written = 0
    for i, ok in runs["tracked"]:
        assert ok["port"] == ok["jax"], (i, ok)
        if not ok["port"]:
            continue
        n_written += 1
        pl, pv, pf = read_tracked_ply(str(out / f"port_tracked_{i:03d}.ply"))
        jl, jv, jf = read_tracked_ply(str(out / f"jax_tracked_{i:03d}.ply"))
        strip = [ln for ln in pl if not ln.startswith("element vertex")]
        assert strip == [ln for ln in jl
                         if not ln.startswith("element vertex")]
        if (i in kf_frames[0]) == (i in kf_frames[1]):
            assert abs(len(pv) - len(jv)) <= 0.05 * len(jv), (i, len(pv),
                                                               len(jv))
        assert pf[0] == jf[0] == i
        np.testing.assert_allclose(pf[1], jf[1], atol=1e-5)
        np.testing.assert_allclose(pf[2], jf[2], atol=1e-5)
        np.testing.assert_allclose(pf[2], K, atol=1e-5)
        # the frame element's pose is Tcw @ inv(T_real): undo it
        Tcw = pf[1] @ runs["T_real"]
        np.testing.assert_allclose(Tcw, runs["port"].trajectory[i][2],
                                   atol=1e-4)
        for name, v in (("port", pv), ("jax", jv)):
            proj = v["xyz"] @ K.T
            err[name].append(np.linalg.norm(proj[:, :2] / proj[:, 2:]
                                            - v["uv"], axis=1))
        g = runs["images"][i][np.clip(pv["uv"][:, 1].astype(int), 0, 479),
                              np.clip(pv["uv"][:, 0].astype(int), 0, 639)]
        np.testing.assert_array_equal(pv["rgb"][:, 0], g.astype(np.uint8))
    assert n_written >= N_FRAMES - 2
    med = {k: float(np.median(np.concatenate(v))) for k, v in err.items()}
    assert med["port"] < 1.0 and med["jax"] < 1.0, med
    assert abs(med["port"] - med["jax"]) < 0.15, med


def test_tracked_points_agree(runs):
    """End to end the last frame's live bindings cover the same
    features (>= 85% of either package's: the maps part a little where
    a keyframe decision falls a frame apart)."""
    _, jf = runs["jsys"].tracked_points()
    _, pf = runs["port"].tracked_points()
    common = len(set(jf.tolist()) & set(pf.tolist()))
    assert common >= 0.85 * max(len(jf), len(pf)), (common, len(jf), len(pf))
    assert len(pf) > 100


def test_tracked_export_from_one_state_byte_identical(runs, tmp_path):
    """From the JAX package's final state (its map, last frame, image
    and real transform) the port's tracked points equal the JAX
    package's and its tracked PLY is the same file, byte for byte."""
    jsys = runs["jsys"]
    port = System(runs["port"].cfg, enable_loop_closing=False, device="cpu")
    port.store = interop.mapstore_from_numpy(
        **interop.mapstore_state(jsys.store), device="cpu")
    port.tracker.store = port.store
    f = jsys.tracker.last_frame
    port.tracker.last_frame = interop.frame_from_numpy(
        **{k: (np.array(getattr(f, k)) if k not in ("frame_id", "timestamp")
               else getattr(f, k)) for k in interop.FRAME_FIELDS})
    port._last_image = runs["images"][-1]
    port.set_real_transform(runs["T_real"])
    for a, b in zip(port.tracked_points(), jsys.tracked_points()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert port.save_tracked_map_ply(str(tmp_path / "t.ply"))
    assert jsys.save_tracked_map_ply(str(tmp_path / "j.ply"))
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_write_tracked_frame_byte_identical(tmp_path):
    rng = np.random.default_rng(9)
    n = 57
    args = (17, rng.normal(size=(4, 4)).astype(np.float32),
            rng.normal(size=(3, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.integers(0, 256, (n, 3)).astype(np.uint8),
            rng.uniform(0, 640, (n, 2)).astype(np.float32),
            rng.integers(0, 8, n).astype(np.int32))
    jply.write_tracked_frame(str(tmp_path / "j.ply"), *args)
    ply.write_tracked_frame(str(tmp_path / "t.ply"), *args)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_on_frame_tracked_once_a_frame(runs):
    """The hook sees every frame once, in order, with the image the
    caller passed."""
    for name in ("jax", "port"):
        c = runs["calls"][name]
        assert [fid for _, fid in c] == list(range(N_FRAMES))
    assert all(img is runs["images"][i]
               for i, (img, _) in enumerate(runs["calls"]["port"]))
