"""The port's height world and device renderer (utils/synth.py) against
the JAX package's, on the CPU.

Measured on the CPU (these inputs): the height maps differ by at most
5.4e-6 (bar 1e-3 of height_amp: OpenCV's cubic resize and torch's
bicubic interpolate share a = -0.75 and half-pixel centres);
render_height on one world differs by 1.4e-4 grey levels at the mean and
0.034 at most (bars 0.05 and 0.5: cv2.remap weighs with 5-bit fixed-point
weights, the port in float); render_sequence_device against the JAX
jitted warp on one texture differs by 1 level on 0.04% of the pixels
(bars: 1 level, 0.1%)."""
import numpy as np
import pytest
import torch

from orb_slam2_tpu.geom.camera import Intrinsics as JIntrinsics
from orb_slam2_tpu.utils import synth as jsynth
from orb_slam2_tpu_torch.geom.camera import Intrinsics
from orb_slam2_tpu_torch.utils import synth

torch.set_num_threads(1)

CAM = Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                 width=640, height=480)
JCAM = JIntrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                   width=640, height=480)


def _jax_world(world):
    """The JAX package's HeightWorld holding the port's arrays."""
    return jsynth.HeightWorld(
        texture=world.texture.numpy(), heights=world.heights.numpy(),
        scale=world.scale, h_scale=world.h_scale, origin=world.origin,
        h_origin=world.h_origin)


@pytest.fixture(scope="module")
def world():
    return synth.make_height_world(seed=5, tex_size=1024, scale=40.0,
                                   height_amp=1.5, device="cpu")


def test_make_height_world_matches_jax(world):
    pytest.importorskip("cv2")
    ref = jsynth.make_height_world(seed=5, tex_size=1024, scale=40.0,
                                   height_amp=1.5)
    assert world.heights.shape == ref.heights.shape
    assert np.abs(world.heights.numpy() - ref.heights).max() < 1e-3 * 1.5
    assert np.abs(world.texture.numpy() - ref.texture).max() < 1e-3
    assert world.h_scale == ref.h_scale
    np.testing.assert_array_equal(world.h_origin, ref.h_origin)
    np.testing.assert_array_equal(world.origin, ref.origin)
    rng = np.random.default_rng(0)
    X, Y = rng.uniform(-10, 10, 500), rng.uniform(-10, 10, 500)
    np.testing.assert_allclose(world.height_at(X, Y),
                               _jax_world(world).height_at(X, Y),
                               atol=1e-6)


@pytest.mark.parametrize("which", ["aerial", "loop"])
def test_render_height_matches_jax(world, which):
    pytest.importorskip("cv2")
    poses = (synth.aerial_trajectory(8, height=10.0, speed=0.8, seed=2)[::3]
             if which == "aerial"
             else synth.loop_trajectory(4, radius=5.0, height=9.0))
    jw = _jax_world(world)
    for T in poses:
        a = synth.render_height(world, CAM, T)
        assert a.dtype == torch.float32 and a.shape == (480, 640)
        d = np.abs(a.numpy() - jsynth.render_height(jw, JCAM, T))
        assert d.mean() < 0.05 and d.max() <= 0.5, (d.mean(), d.max())


def _project(T, K, pts):
    pc = pts @ T[:3, :3].T + T[:3, 3]
    uv = pc[:, :2] / pc[:, 2:3]
    return uv * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]], pc[:, 2]


def test_height_world_multiview_consistency(world):
    """tests/test_synth_height.py's property on the port: a surface point
    (X, Y, h(X, Y)) projected into two views samples the same appearance
    (median error < 6), and the planar projection of the same points
    does measurably worse (real parallax)."""
    assert np.abs(world.heights.numpy()).max() > 1.0
    poses = synth.aerial_trajectory(8, height=10.0, speed=0.8, seed=2)
    T1, T2 = poses[0], poses[6]
    img1 = synth.render_height(world, CAM, T1)
    img2 = synth.render_height(world, CAM, T2)
    rng = np.random.default_rng(0)
    X = rng.uniform(1.5, 4.0, 400)
    Y = rng.uniform(-2.0, 2.0, 400)
    Z = world.height_at(X, Y)
    pts = np.stack([X, Y, Z], 1)
    K = np.asarray(CAM.K)
    uv1, z1 = _project(T1, K, pts)
    uv2, z2 = _project(T2, K, pts)
    m = ((z1 > 0) & (z2 > 0)
         & (uv1 > 8).all(1) & (uv2 > 8).all(1)
         & (uv1[:, 0] < CAM.width - 8) & (uv2[:, 0] < CAM.width - 8)
         & (uv1[:, 1] < CAM.height - 8) & (uv2[:, 1] < CAM.height - 8))
    assert m.sum() > 150

    def sample(img, uv):
        uv = torch.as_tensor(uv, dtype=torch.float32)
        return synth._bilinear_clamped(img, uv[:, 0], uv[:, 1]).numpy()

    err = np.abs(sample(img1, uv1[m]) - sample(img2, uv2[m]))
    assert np.median(err) < 6.0, np.median(err)
    pts_flat = np.stack([X, Y, np.zeros_like(X)], 1)
    uvf2, _ = _project(T2, K, pts_flat)
    err_flat = np.abs(sample(img1, uv1[m]) - sample(img2, uvf2[m]))
    assert np.median(err_flat) > 2.0 * np.median(err)


def test_height_world_trajectory_renders():
    world = synth.make_height_world(seed=1, tex_size=768, scale=30.0,
                                    height_amp=1.2, device="cpu")
    for T in synth.loop_trajectory(4, radius=5.0, height=9.0):
        img = synth.render_height(world, CAM, T)
        assert img.shape == (CAM.height, CAM.width)
        assert torch.isfinite(img).all()
        assert img.std() > 10


def test_render_sequence_device_matches_jax():
    cam = Intrinsics(fx=300.0, fy=300.0, cx=160.0, cy=120.0,
                     width=320, height=240)
    jcam = JIntrinsics(fx=300.0, fy=300.0, cx=160.0, cy=120.0,
                       width=320, height=240)
    world = synth.make_world(seed=3, tex_size=1024, scale=40.0,
                             device="cpu")
    jworld = jsynth.PlanarWorld(texture=world.texture.numpy(),
                                scale=world.scale, origin=world.origin)
    poses = synth.aerial_trajectory(3, height=10.0, speed=0.5)
    ours = synth.render_sequence_device(world, cam, poses)
    ref = jsynth.render_sequence_device(jworld, jcam, poses)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.uint8 and a.shape == (240, 320)
        d = np.abs(a.numpy().astype(np.int16) - np.asarray(b, np.int16))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, \
            (d.max(), (d > 0).mean())
