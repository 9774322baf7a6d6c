"""The port's ORB extractor (ops/ + models/frame.py) against the JAX
package on the same images, at the pipeline test's size (640x480,
800 features, 4 levels)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.geom import camera as jcam
from orb_slam2_tpu.ops import (brief as jbrief, extractor as jex,
                               orientation as jori, pyramid as jpyr)
from orb_slam2_tpu_torch.geom import camera as tcam
from orb_slam2_tpu_torch.models.frame import FrameFactory
from orb_slam2_tpu_torch.ops import (brief as tbrief, extractor as tex,
                                     orientation as tori, pyramid as tpyr)
from orb_slam2_tpu_torch.utils import synth

torch.set_num_threads(1)

CAM = tcam.Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                      width=640, height=480)


@pytest.fixture(scope="module")
def image():
    world = synth.make_world(seed=3, device="cpu")
    T = synth.aerial_trajectory(3, speed=0.3)[1]
    return synth.render(world, CAM, T).numpy().astype(np.float32)


@pytest.fixture(scope="module")
def both(image):
    p = dict(n_features=800, n_levels=4)
    ref = jex.make_extractor(480, 640, jex.OrbParams(**p))(jnp.asarray(image))
    out = tex.extract(torch.from_numpy(image), tex.OrbParams(**p))
    return ({f: np.asarray(getattr(ref, f)) for f in jex.Features._fields},
            {f: getattr(out, f).numpy() for f in tex.Features._fields})


def test_static_tables_identical():
    for args in ((1440, 1920, 8, 1.2), (480, 640, 4, 1.2)):
        assert tpyr.level_shapes(*args) == jpyr.level_shapes(*args)
    assert (tex.features_per_level(4000, 8, 1.2)
            == jex.features_per_level(4000, 8, 1.2))
    assert tex.padded_feature_count(4000) == jex.padded_feature_count(4000)


def test_pyramid(image):
    """Bar: |diff| <= 1e-3 on every level.  Both resize bilinearly with
    half-pixel centres and edge clamping; JAX evaluates it as a dense
    weight-matrix product, so float32 rounding differs (measured
    <= 5e-5 at 0..255)."""
    ref = jpyr.build_pyramid(jnp.asarray(image), 4, 1.2)
    out = tpyr.build_pyramid(torch.from_numpy(image), 4, 1.2)
    for r, o in zip(ref, out):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-3)


def test_orientation_same_keypoints(image):
    """Bar: |angle diff| <= 1e-2 rad.  The moments come from row prefix
    sums whose float32 summation order differs from XLA's cumsum."""
    rng = np.random.default_rng(0)
    ys = rng.integers(16, 480 - 16, 500).astype(np.int32)
    xs = rng.integers(16, 640 - 16, 500).astype(np.int32)
    ref = np.asarray(jori.ic_angle(jnp.asarray(image), jnp.asarray(ys),
                                   jnp.asarray(xs)))
    out = tori.ic_angle(torch.from_numpy(image), torch.from_numpy(ys),
                        torch.from_numpy(xs)).numpy()
    d = np.abs(np.angle(np.exp(1j * (out - ref))))
    assert d.max() <= 1e-2, d.max()


def test_descriptors_same_inputs(image):
    """Same blurred image, keypoints and angles.  Bar: >= 99.9% of bits
    identical — the comparison values are exact integers; only the
    bin interpolation (1-t)*s0 + t*s1 rounds, and XLA may fuse it."""
    rng = np.random.default_rng(1)
    ys = rng.integers(16, 480 - 16, 400).astype(np.int32)
    xs = rng.integers(16, 640 - 16, 400).astype(np.int32)
    ang = rng.uniform(-np.pi, np.pi, 400).astype(np.float32)
    blurred = np.array(jpyr.gaussian_blur_7x7(jnp.asarray(image)))
    ref = np.asarray(jbrief.compute_descriptors(
        jnp.asarray(blurred), jnp.asarray(ys), jnp.asarray(xs),
        jnp.asarray(ang)))
    out = tbrief.compute_descriptors(
        torch.from_numpy(blurred), torch.from_numpy(ys), torch.from_numpy(xs),
        torch.from_numpy(ang)).numpy().view(np.uint32)
    same = np.unpackbits(ref.view(np.uint8)) == np.unpackbits(out.view(np.uint8))
    assert same.mean() >= 0.999, same.mean()


def test_extractor_keypoints(both):
    """Bar: >= 99% of rows with identical position, octave, response
    and validity.  Level images differ at float32 rounding, which can
    move a pixel's bf16 rounding and so one FAST score by one unit."""
    ref, out = both
    same = ((ref["xy"] == out["xy"]).all(1) & (ref["octave"] == out["octave"])
            & (ref["response"] == out["response"])
            & (ref["valid"] == out["valid"]))
    assert out["xy"].shape == ref["xy"].shape == (896, 2)
    assert same.mean() >= 0.99, same.mean()


def test_extractor_angles_and_descriptors(both):
    """Bars on the rows whose keypoint agrees: angle within 1e-2 rad
    (prefix-sum order, see test_orientation_same_keypoints) and >= 99%
    identical descriptor bits (a small angle change moves the bin
    interpolation across zero for a few comparisons)."""
    ref, out = both
    rows = (ref["xy"] == out["xy"]).all(1) & ref["valid"] & out["valid"]
    d = np.abs(np.angle(np.exp(1j * (out["angle"][rows]
                                     - ref["angle"][rows]))))
    assert d.max() <= 1e-2, d.max()
    bits_r = np.unpackbits(ref["desc"][rows].view(np.uint8))
    bits_o = np.unpackbits(out["desc"][rows].view(np.uint8))
    assert (bits_r == bits_o).mean() >= 0.99


def test_extractor_dense_budget(image):
    """A budget above the corners the levels hold (4,000 features on 4
    levels of 640x480): grid_topk leaves slots invalid, some pointing
    into its padding past a level's edge, where the JAX package's
    gathers clamp.  The port's orientation indexed them unclamped and
    raised IndexError.  Bars: the same valid count and >= 99% of the
    JAX run's valid keypoints (position and octave) among the port's,
    as test_extractor_keypoints; measured 3,796 of 3,796."""
    p = dict(n_features=4000, n_levels=4)
    ref = jex.make_extractor(480, 640, jex.OrbParams(**p))(jnp.asarray(image))
    out = tex.extract(torch.from_numpy(image), tex.OrbParams(**p))
    keys = []
    for f in (ref, out):
        valid = np.asarray(f.valid)
        keys.append(set(map(tuple, np.c_[np.asarray(f.xy)[valid],
                                         np.asarray(f.octave)[valid]])))
    assert len(keys[1]) == len(keys[0]) > 3000
    assert len(keys[0] & keys[1]) >= 0.99 * len(keys[0])


def test_undistort_points():
    """Bar: 1e-3 px (the same float32 fixed-point iteration)."""
    kw = dict(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480,
              dist=(-0.2, 0.05, 0.001, -0.002, 0.0))
    uv = np.random.default_rng(2).uniform([0, 0], [640, 480], (200, 2)
                                          ).astype(np.float32)
    ref = np.asarray(jcam.undistort_points(jcam.Intrinsics(**kw),
                                           jnp.asarray(uv)))
    out = tcam.undistort_points(tcam.Intrinsics(**kw),
                                torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)
    assert np.allclose(tcam.undistorted_bounds(tcam.Intrinsics(**kw)),
                       jcam.undistorted_bounds(jcam.Intrinsics(**kw)),
                       atol=1e-3)


def test_frame_factory(image):
    fac = FrameFactory(CAM, tex.OrbParams(n_features=800, n_levels=4),
                       device="cpu")
    f = fac.make(image, 0.0, np.eye(4, dtype=np.float32))
    assert f.n == 896 and f.device.type == "cpu"
    assert f.desc.dtype == np.uint32
    np.testing.assert_array_equal(f.desc.view(np.int32), f.dev("desc").numpy())
    init = fac.make(image, 0.1, init_mode=True)      # 2x budget
    assert init.n == 1664 and init.frame_id == 1
    sel = np.arange(0, 1664, 2)
    want = init.xy[sel].copy()
    init.compact(sel)
    assert init.n == 832
    np.testing.assert_array_equal(init.xy, want)
    np.testing.assert_array_equal(init.dev("xy").numpy(), want)
    assert init.dev_padded("octave", 896).shape == (896,)
