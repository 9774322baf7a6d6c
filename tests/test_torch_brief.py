"""BRIEF beyond the default: the ``orb_learned`` pattern and the
``exact`` (per-keypoint steering) mode of the port against the JAX
package, and the device tables' cache.

Inputs: a 640x480 frame of the port's renderer, blurred by the JAX
package's 7x7 blur, 1500 random keypoints inside the detector border
and random float32 angles over a full turn."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu.ops import brief as jbrief, pyramid as jpyr
from orb_slam2_tpu.ops.orb_pattern import BIT_PATTERN_31 as J_PATTERN_31
from orb_slam2_tpu_torch.geom.camera import Intrinsics
from orb_slam2_tpu_torch.ops import brief as tbrief
from orb_slam2_tpu_torch.ops.orb_pattern import BIT_PATTERN_31
from orb_slam2_tpu_torch.utils import synth

torch.set_num_threads(1)

N_KP = 1500


@pytest.fixture(scope="module")
def inputs():
    cam = Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                     width=640, height=480)
    world = synth.make_world(seed=3, device="cpu")
    img = synth.render(world, cam, synth.aerial_trajectory(3)[1]).numpy()
    blurred = np.array(jpyr.gaussian_blur_7x7(jnp.asarray(img, jnp.float32)))
    rng = np.random.default_rng(5)
    ys = rng.integers(16, 480 - 16, N_KP).astype(np.int32)
    xs = rng.integers(16, 640 - 16, N_KP).astype(np.int32)
    ang = rng.uniform(-np.pi, np.pi, N_KP).astype(np.float32)
    return blurred, ys, xs, ang


# the JAX package runs its BRIEF inside the jitted extractor
_jax_descriptors = jax.jit(jbrief.compute_descriptors,
                           static_argnames=("pattern", "mode"))


def _both(inputs, pattern, mode):
    blurred, ys, xs, ang = inputs
    ref = np.asarray(_jax_descriptors(
        jnp.asarray(blurred), jnp.asarray(ys), jnp.asarray(xs),
        jnp.asarray(ang), pattern=pattern, mode=mode))
    out = tbrief.compute_descriptors(
        torch.from_numpy(blurred), torch.from_numpy(ys),
        torch.from_numpy(xs), torch.from_numpy(ang), pattern=pattern,
        mode=mode).numpy().view(np.uint32)
    return ref, out


def test_orb_learned_table_identical():
    np.testing.assert_array_equal(BIT_PATTERN_31, J_PATTERN_31)
    np.testing.assert_array_equal(tbrief.get_pattern("orb_learned"),
                                  jbrief.get_pattern("orb_learned"))
    with pytest.raises(ValueError):
        tbrief.get_pattern("nope")


@pytest.mark.parametrize("pattern", ["random", "orb_learned"])
def test_exact_descriptors_bit_for_bit(inputs, pattern):
    """Bar: every bit equal.  The rotated offsets are rounded, so the
    port forms them as XLA does (the C library's sinf/cosf, fused
    multiply-adds); the comparisons are of equal patch values."""
    ref, out = _both(inputs, pattern, "exact")
    np.testing.assert_array_equal(out, ref)


def test_exact_rotation_is_the_fused_form(inputs):
    """The offsets' rounding is where a last-bit difference shows: the
    port's offsets equal the fused form on every pair, and the unfused
    torch form would not (so the test above can catch it)."""
    _, _, _, ang = inputs
    pat = tbrief.get_pattern("random").astype(np.float32)
    px, py = pat[..., 0][None], pat[..., 1][None]
    s, c = tbrief._sin_cos(torch.from_numpy(ang))
    s, c = s.numpy()[:, None, None], c.numpy()[:, None, None]
    fused = (px.astype(np.float64) * c - (py * s).astype(np.float64)
             ).astype(np.float32)
    plain = px * torch.cos(torch.from_numpy(ang)).numpy()[:, None, None] \
        - py * torch.sin(torch.from_numpy(ang)).numpy()[:, None, None]
    jx = np.asarray(jax.jit(lambda a: px * jnp.cos(a)[:, None, None]
                            - py * jnp.sin(a)[:, None, None])(ang))
    np.testing.assert_array_equal(fused, jx)
    assert (plain != jx).any()


def test_binned_orb_learned_same_inputs(inputs):
    """The default mode with OpenCV's table.  Bar: >= 99.9% of bits
    identical (test_torch_extractor's bar: only the bin interpolation
    rounds, and XLA may fuse it)."""
    ref, out = _both(inputs, "orb_learned", "binned")
    same = (np.unpackbits(ref.view(np.uint8))
            == np.unpackbits(out.view(np.uint8)))
    assert same.mean() >= 0.999, same.mean()


def test_device_tables_uploaded_once():
    """The binned mode's index tables are made once per (pattern,
    device): a second extraction uploads nothing."""
    dev = torch.device("cpu")
    a = tbrief._bin_gather("random", dev)
    b = tbrief._bin_gather("random", dev)
    assert all(x is y for x, y in zip(a, b))
    assert tbrief._bin_gather("orb_learned", dev)[0] is not a[0]
    assert isinstance(tbrief._bin_gather, functools._lru_cache_wrapper)
