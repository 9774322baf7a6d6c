"""The port's counterpart of ``jax.jit`` (``orb_slam2_tpu_torch/graphs.py``)
on the CPU, where ``graphed`` calls the function: ``make_extractor``
against the JAX package's jitted extractor, ``graphed`` returning what
the function returns, the launch records that replays add, and the
repaired fused step (``_prior_step_core``, whose bound-feature mask is
now a scatter with no host read) against the JAX package's
``_track_prior_step`` and ``_track_prior_chain`` with no gated row,
every row gated and some.

Size: 480x640 frames with ``OrbParams(500, 4, 1.2)``; the fused step on
a synthetic 512-feature frame (``test_torch_gpu.prior_step_scene``).
Inputs are made from numpy seeds."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orb_slam2_tpu.pipeline.tracking as jtracking
from orb_slam2_tpu.ops import extractor as jex
from orb_slam2_tpu_torch import graphs, kernels
from orb_slam2_tpu_torch.ops import extractor as tex
from orb_slam2_tpu_torch.pipeline import tracking as ptracking
from test_torch_gpu import prior_step_scene, scene_tensors, _chain_args

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def image():
    """Blocks of random grey levels (corners at their edges) with a
    little noise, from a numpy seed."""
    rng = np.random.default_rng(5)
    blocks = rng.uniform(0, 255, (30, 40))
    img = np.kron(blocks, np.ones((16, 16))) + rng.normal(0, 4, (480, 640))
    return np.clip(img, 0, 255).astype(np.float32)


PARAMS = dict(n_features=500, n_levels=4, scale_factor=1.2)


def test_make_extractor_matches_jax(image):
    """``make_extractor(480, 640, params)`` against the JAX package's
    ``make_extractor`` on one image, with tests/test_torch_extractor.py's
    bars: >= 99% of rows with identical position, octave, response and
    validity; on those rows angles within 1e-2 rad and >= 99% of the
    descriptor bits equal.  It is cached per (size, params) and, on the
    CPU, returns exactly what ``extract`` returns."""
    run = tex.make_extractor(480, 640, tex.OrbParams(**PARAMS))
    assert tex.make_extractor(480, 640, tex.OrbParams(**PARAMS)) is run
    out = run(torch.from_numpy(image))
    for a, b in zip(out, tex.extract(torch.from_numpy(image),
                                     tex.OrbParams(**PARAMS))):
        assert torch.equal(a, b)
    ref = jex.make_extractor(480, 640, jex.OrbParams(**PARAMS))(
        jnp.asarray(image))
    ref = {f: np.asarray(getattr(ref, f)) for f in jex.Features._fields}
    out = {f: getattr(out, f).numpy() for f in tex.Features._fields}
    assert out["xy"].shape == ref["xy"].shape == (512, 2)
    same = ((ref["xy"] == out["xy"]).all(1)
            & (ref["octave"] == out["octave"])
            & (ref["response"] == out["response"])
            & (ref["valid"] == out["valid"]))
    assert same.mean() >= 0.99, same.mean()
    assert out["valid"].sum() > 400
    rows = same & ref["valid"]
    d = np.abs(np.angle(np.exp(1j * (out["angle"][rows]
                                     - ref["angle"][rows]))))
    assert d.max() <= 1e-2, d.max()
    bits_r = np.unpackbits(ref["desc"][rows].view(np.uint8))
    bits_o = np.unpackbits(out["desc"][rows].view(np.uint8))
    assert (bits_r == bits_o).mean() >= 0.99


def test_graphed_on_cpu_returns_what_fn_returns():
    """On the CPU ``graphed(fn)`` is a call of ``fn``: the same objects
    come back, statics pass through, nothing is captured; tensors on two
    devices are refused."""
    seen = []

    def fn(x, scale, pair):
        seen.append((scale, pair))
        return tex.Features(x, x * scale, x + 1, x.int(), x.int(), x > 0)

    g = graphs.graphed(fn, "fn")
    x = torch.arange(6.0)
    got = g(x, 2.0, (1, 2))
    assert isinstance(got, tex.Features)
    assert got.xy is x and torch.equal(got.response, x * 2.0)
    assert seen == [(2.0, (1, 2))]
    assert g.n_captures() == 0 and "fn" not in graphs.STATS
    with pytest.raises(ValueError):
        g(2.0, 3.0, None)


def test_flatten_rebuilds_nested_outputs():
    """The output tree a capture keeps is rebuilt with its types: a
    NamedTuple inside plain tuples (the extraction's (Features, xy));
    a non-tensor leaf is refused."""
    x, y, z = torch.zeros(2), torch.ones(3), torch.arange(4)
    out = (tex.Features(x, y, z, x, y, z), (x, (y, z)), z)
    leaves = []
    rebuild = graphs._flatten(out, leaves)
    assert len(leaves) == 10
    new = [t + 1 for t in leaves]
    back = rebuild(iter(new))
    assert isinstance(back[0], tex.Features) and torch.equal(back[0].xy, x + 1)
    assert isinstance(back[1][1], tuple) and torch.equal(back[2], z + 1)
    with pytest.raises(TypeError):
        graphs._flatten((x, 3), [])
    with pytest.raises(TypeError):
        graphs._flatten([x], [])


def test_launch_records_stay_on_their_thread():
    """Inside ``kernels.recording()`` this thread's launch counts go to
    the record (what a capture launched); ``add_launches`` adds a record
    to the totals (a replay); another thread's launches meanwhile go to
    the totals, not to the record."""
    kernels.reset_launch_counts()
    with kernels.recording() as rec:
        kernels.add_launches({"fast_score": 1,
                              ("masked_top2_mutual", 4096, 4096): 2,
                              "masked_top2_mutual": 2})
        other = threading.Thread(target=kernels.add_launches,
                                 args=({"masked_top2_epi": 1},))
        other.start()
        other.join(timeout=30)
        assert not other.is_alive()
    assert rec == {"fast_score": 1, "masked_top2_mutual": 2,
                   ("masked_top2_mutual", 4096, 4096): 2}
    assert kernels.LAUNCHES["masked_top2_epi"] == 1
    assert kernels.LAUNCHES["fast_score"] == 0
    for _ in range(3):              # three replays
        kernels.add_launches(rec)
    assert kernels.LAUNCHES["fast_score"] == 3
    assert kernels.LAUNCHES["masked_top2_mutual"] == 6
    assert kernels.SHAPES == {("masked_top2_mutual", 4096, 4096): 6}
    kernels.reset_launch_counts()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bound_features_is_the_jax_scatter(seed):
    """``_bound_features`` (index_put into a spare slot) against the JAX
    package's ``zeros(n).at[idx].max(gate) > 0``, with repeated indices,
    on a random gate, no gated row and every row gated: True exactly at
    the gated rows' features."""
    rng = np.random.default_rng(seed)
    n = 512
    idx = rng.integers(0, n, 256)
    for gate in (rng.random(256) < 0.5, np.zeros(256, bool),
                 np.ones(256, bool)):
        got = ptracking._bound_features(torch.from_numpy(idx),
                                        torch.from_numpy(gate), n).numpy()
        want = np.asarray(jnp.zeros(n, jnp.int32).at[idx].max(
            gate.astype(np.int32)) > 0)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.flatnonzero(got),
                                      np.unique(idx[gate]))


def _jax_args(args):
    return [jnp.asarray(a) if isinstance(a, np.ndarray) else a
            for a in args]


def _compare(pout, jout, L, C):
    """The port's step outputs against the JAX package's packed ones:
    every mask equal, the feature rows equal where matched."""
    unpack = lambda a, n: np.unpackbits(np.asarray(a))[:n].astype(bool)  # noqa: E731
    p = [t.numpy() for t in pout]
    np.testing.assert_array_equal(p[1], unpack(jout[1], L))
    np.testing.assert_array_equal(p[2], np.asarray(jout[6]))
    np.testing.assert_array_equal(p[3], unpack(jout[3], C))
    np.testing.assert_array_equal(p[5], np.asarray(jout[7]))
    np.testing.assert_array_equal(p[6], np.asarray(jout[8]))
    j0 = np.asarray(jout[0]).astype(np.int64) & 0xFFFF
    j4 = np.asarray(jout[4]).astype(np.int64) & 0xFFFF
    np.testing.assert_array_equal(p[0][p[1]], j0[p[1]])
    np.testing.assert_array_equal(p[4][p[5]], j4[p[5]])
    return p


@pytest.mark.parametrize("case", ["none", "all", "some"])
def test_fused_step_matches_jax(case):
    """The repaired ``_prior_step_core`` (and through ``graphed``, which
    on the CPU calls it) against the JAX package's ``_track_prior_step``,
    then the chain step that follows against ``_track_prior_chain``.
    Bars: every mask equal and the matched feature rows equal (the
    synthetic frame's matches are exact: distance 0, reprojection error
    at float rounding).  With no gated row the copies of points 0-31
    find their keypoints; with every row gated they find none (those
    keypoints are bound) and the gate holds exactly the 200 bound
    rows."""
    args = prior_step_scene(case)
    targs = scene_tensors(args)
    L, C = len(args[7]), len(args[9])
    step = graphs.graphed(ptracking._prior_step_core, "prior_step")
    pout = step(*targs)
    for a, b in zip(pout, ptracking._prior_step_core(*targs)):
        assert torch.equal(a, b)
    jout = jtracking._track_prior_step(*_jax_args(args))
    p = _compare(pout, jout, L, C)
    gate, keep = p[2], p[5]
    copies = keep[224:]                  # candidate rows of points 480-511
    if case == "none":
        assert not gate.any() and copies.all()
    elif case == "all":
        assert gate[:200].all() and not gate[200:].any()
        assert not copies.any()
    else:
        np.testing.assert_array_equal(gate[:200], np.arange(200) % 2 == 0)
        np.testing.assert_array_equal(copies, np.arange(32) % 2 == 1)
    assert keep[:224].all()
    # the next step, rebuilt on the device from these outputs
    cout = ptracking._track_prior_chain(*_chain_args(targs, pout))
    jc = jtracking._track_prior_chain(
        *_jax_args(args[:7]), jout[8], jnp.asarray(args[9]), jout[0],
        jout[4], jout[6], jout[7], *_jax_args(args[9:]))
    _compare(cout, jc, L, C)
