"""The port's matching, geometry and structure-BA modules against the
JAX package on identical inputs.

The features are extracted once by the JAX package and handed to both
packages (``interop.features_from_numpy``), so every search sees the
same descriptors and attributes."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.geom import triangulate as jtri
from orb_slam2_tpu.matching import core as jcore, frustum as jfr, search as jsearch
from orb_slam2_tpu.ops import extractor as jex
from orb_slam2_tpu.optim import points_opt as jpo
from orb_slam2_tpu.pipeline.local_mapping import compute_F12
from orb_slam2_tpu_torch import interop
from orb_slam2_tpu_torch.geom import camera as tcam, triangulate as ttri
from orb_slam2_tpu_torch.matching import core as tcore, frustum as tfr, search as tsearch
from orb_slam2_tpu_torch.optim import points_opt as tpo
from orb_slam2_tpu_torch.utils import synth

torch.set_num_threads(1)

CAM = tcam.Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                      width=640, height=480)
SF = (1.2 ** np.arange(4)).astype(np.float32)
SIG2 = SF * SF


@pytest.fixture(scope="module")
def feats():
    """JAX-extracted features of two views 0.6 units apart, as numpy
    dicts (desc uint32)."""
    world = synth.make_world(seed=3, device="cpu")
    poses = synth.aerial_trajectory(3, speed=0.3)
    ext = jex.make_extractor(480, 640, jex.OrbParams(n_features=800,
                                                     n_levels=4))
    out = []
    for T in (poses[0], poses[2]):
        img = synth.render(world, CAM, T).numpy().astype(np.float32)
        f = ext(jnp.asarray(img))
        out.append(dict({k: np.asarray(getattr(f, k)) for k in f._fields},
                        Tcw=T))
    return out


def _both(f):
    """(jax arrays, port tensors) of one feature set."""
    j = {k: jnp.asarray(v) for k, v in f.items() if k != "Tcw"}
    t = interop.features_from_numpy(**{k: f[k] for k in jex.Features._fields})
    return j, t


def _assert_match_equal(ref, out):
    rv = np.asarray(ref.valid)
    np.testing.assert_array_equal(out.valid.numpy(), rv)
    np.testing.assert_array_equal(out.idx.numpy()[rv], np.asarray(ref.idx)[rv])
    np.testing.assert_array_equal(out.dist.numpy()[rv],
                                  np.asarray(ref.dist)[rv])
    assert rv.sum() > 20


def test_hamming_matrix_exact(feats):
    j, t = _both(feats[0])
    j2, t2 = _both(feats[1])
    ref = np.asarray(jcore.hamming_matrix(j["desc"], j2["desc"]))
    out = tcore.hamming_matrix(t.desc, t2.desc).numpy()
    np.testing.assert_array_equal(out, ref)


def test_search_for_initialization_exact(feats):
    """Bar: bit-exact (integer distances, exact masks and argmin ties)."""
    (j1, t1), (j2, t2) = _both(feats[0]), _both(feats[1])
    args_j = [j1[k] for k in ("xy", "desc", "valid", "octave", "angle")] + \
        [j2[k] for k in ("xy", "desc", "valid", "octave", "angle")]
    args_t = [getattr(t1, k) for k in ("xy", "desc", "valid", "octave", "angle")] + \
        [getattr(t2, k) for k in ("xy", "desc", "valid", "octave", "angle")]
    _assert_match_equal(jsearch.search_for_initialization(*args_j),
                        tsearch.search_for_initialization(*args_t))


def _projection_rows(f, seed):
    rng = np.random.default_rng(seed)
    n = len(f["xy"])
    uv = (f["xy"] + np.array([-9.0, 1.5], np.float32)
          + rng.normal(0, 1.0, (n, 2)).astype(np.float32))
    return uv.astype(np.float32), f["valid"] & (rng.random(n) > 0.1)


def test_search_by_projection_last_frame_exact(feats):
    """Rows: view-0 features moved to where view 1 sees them.  Bar:
    bit-exact given identical attributes (both run the K2 contract)."""
    f0 = feats[0]
    (_, t1), (j2, t2) = _both(f0), _both(feats[1])
    uv, mval = _projection_rows(f0, 0)
    ref = jsearch.search_by_projection_last_frame(
        jnp.asarray(uv), jnp.asarray(f0["octave"]), jnp.asarray(f0["desc"]),
        jnp.asarray(mval), jnp.asarray(f0["angle"]),
        j2["xy"], j2["octave"], j2["desc"], j2["valid"], j2["angle"],
        jnp.asarray(SF), th=7.0)
    out = tsearch.search_by_projection_last_frame(
        torch.from_numpy(uv), t1.octave.long(), t1.desc,
        torch.from_numpy(mval), t1.angle,
        t2.xy, t2.octave, t2.desc, t2.valid, t2.angle,
        torch.from_numpy(SF), th=7.0)
    _assert_match_equal(ref, out)


def test_search_by_projection_local_map_exact(feats):
    f0 = feats[0]
    (_, t1), (j2, t2) = _both(f0), _both(feats[1])
    rng = np.random.default_rng(1)
    uv, mval = _projection_rows(f0, 1)
    n = len(uv)
    lvl = f0["octave"].astype(np.int32)
    vcos = rng.uniform(0.99, 1.0, n).astype(np.float32)
    has = rng.random(len(feats[1]["xy"])) < 0.2
    ref = jsearch.search_by_projection_local_map(
        jnp.asarray(uv), jnp.asarray(lvl), jnp.asarray(vcos),
        jnp.asarray(f0["desc"]), jnp.asarray(mval),
        j2["xy"], j2["octave"], j2["desc"], j2["valid"], jnp.asarray(has),
        jnp.asarray(SF), th=3.0)
    out = tsearch.search_by_projection_local_map(
        torch.from_numpy(uv), torch.from_numpy(lvl).long(),
        torch.from_numpy(vcos), t1.desc, torch.from_numpy(mval),
        t2.xy, t2.octave, t2.desc, t2.valid, torch.from_numpy(has),
        torch.from_numpy(SF), th=3.0)
    _assert_match_equal(ref, out)


def test_search_descriptors_exact(feats):
    (j1, t1), (j2, t2) = _both(feats[0]), _both(feats[1])
    ref = jsearch.search_descriptors(
        j1["desc"], j1["valid"], j1["angle"], None,
        j2["desc"], j2["valid"], j2["angle"], None, ratio=0.7)
    out = tsearch.search_descriptors(t1.desc, t1.valid, t1.angle, None,
                                     t2.desc, t2.valid, t2.angle, None,
                                     ratio=0.7)
    _assert_match_equal(ref, out)


def test_search_for_triangulation(feats):
    """The fused (K3) branch with the epipolar geometry of the two true
    poses.  Bar: >= 99.5% of rows with the same verdict and index.  The
    epipolar lines come from a 3-term product ([x, y, 1] @ F12) whose
    last-bit rounding may differ between XLA and torch, which can flip
    a pair sitting on the gate's boundary."""
    f0, f1 = feats
    (j1, t1), (j2, t2) = _both(f0), _both(f1)
    K = np.asarray(CAM.K, np.float64)
    F12 = compute_F12(f0["Tcw"].astype(np.float64),
                      f1["Tcw"].astype(np.float64), K)
    o1 = -f0["Tcw"][:3, :3].T @ f0["Tcw"][:3, 3]
    pc = f1["Tcw"][:3, :3] @ o1 + f1["Tcw"][:3, 3]
    epi = np.array([450 * pc[0] / pc[2] + 320, 450 * pc[1] / pc[2] + 240],
                   np.float32)
    ref = jsearch.search_for_triangulation(
        j1["xy"], j1["desc"], j1["valid"], j1["octave"], j1["angle"], None,
        j2["xy"], j2["desc"], j2["valid"], j2["octave"], j2["angle"], None,
        jnp.asarray(F12), jnp.asarray(epi), jnp.asarray(SIG2), jnp.asarray(SF))
    out = tsearch.search_for_triangulation(
        t1.xy, t1.desc, t1.valid, t1.octave, t2.xy, t2.desc, t2.valid,
        t2.octave, torch.from_numpy(F12), torch.from_numpy(epi),
        torch.from_numpy(SIG2), torch.from_numpy(SF))
    rv, ov = np.asarray(ref.valid), out.valid.numpy()
    same = (rv == ov) & (~rv | (np.asarray(ref.idx) == out.idx.numpy()))
    assert rv.sum() > 50
    assert same.mean() >= 0.995, same.mean()


def test_frustum(feats):
    """Bars: uv within 1e-3 px; >= 99.9% identical visibility and
    predicted levels (a 3x3 product rounds differently in the last bit,
    which can move a point across an image bound)."""
    rng = np.random.default_rng(2)
    n = 2000
    pts = np.concatenate([rng.uniform(-8, 8, (n, 2)), rng.normal(0, 0.1, (n, 1))],
                         1).astype(np.float32)
    nrm = np.tile(np.array([0, 0, 1], np.float32), (n, 1))
    mind = rng.uniform(1, 5, n).astype(np.float32)
    maxd = (mind * rng.uniform(2, 10, n)).astype(np.float32)
    val = rng.random(n) > 0.1
    T = feats[1]["Tcw"]
    kw = dict(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
              bounds=(0.0, 640.0, 0.0, 480.0), n_levels=4,
              log_scale_factor=float(np.log(1.2)))
    ref = jfr.is_in_frustum(*(jnp.asarray(a) for a in (pts, nrm, mind, maxd, val, T)),
                            **kw)
    out = tfr.is_in_frustum(*(torch.from_numpy(a) for a in (pts, nrm, mind, maxd, val, T)),
                            **kw)
    np.testing.assert_allclose(out.uv.numpy(), np.asarray(ref.uv), atol=1e-3)
    assert (out.visible.numpy() == np.asarray(ref.visible)).mean() >= 0.999
    assert (out.pred_level.numpy() == np.asarray(ref.pred_level)).mean() >= 0.999
    assert np.asarray(ref.visible).sum() > 100


def test_triangulation_and_gates():
    """Bars: points within 1e-3 relative, >= 99.5% identical gate
    verdicts (float32 solves rounding differently)."""
    rng = np.random.default_rng(3)
    n = 1000
    X = np.concatenate([rng.uniform(-5, 5, (n, 2)), rng.normal(0, 0.5, (n, 1))], 1)
    poses = synth.aerial_trajectory(5, speed=0.3)
    T1, T2 = poses[0], poses[4]
    K = np.asarray(CAM.K)

    def proj(T):
        pc = X @ T[:3, :3].T + T[:3, 3]
        return (pc[:, :2] / pc[:, 2:] * 450 + [320, 240]
                + rng.normal(0, 0.5, (n, 2))).astype(np.float32)

    uv1, uv2 = proj(T1), proj(T2)
    sig = np.ones(n, np.float32)
    P1j = jtri.projection_matrix(jnp.asarray(K), jnp.asarray(T1))
    P2j = jtri.projection_matrix(jnp.asarray(K), jnp.asarray(T2))
    Xj = jtri.triangulate_dlt(P1j, P2j, jnp.asarray(uv1), jnp.asarray(uv2))
    gj = jtri.check_triangulation(Xj, jnp.asarray(T1), jnp.asarray(T2),
                                  jnp.asarray(uv1), jnp.asarray(uv2),
                                  450.0, 450.0, 320.0, 240.0,
                                  jnp.asarray(sig), jnp.asarray(sig))
    t = torch.from_numpy
    P1t = ttri.projection_matrix(t(K), t(T1))
    P2t = ttri.projection_matrix(t(K), t(T2))
    Xt = ttri.triangulate_dlt(P1t, P2t, t(uv1), t(uv2))
    gt = ttri.check_triangulation(Xt, t(T1), t(T2), t(uv1), t(uv2),
                                  450.0, 450.0, 320.0, 240.0, t(sig), t(sig))
    Xj = np.asarray(Xj)
    np.testing.assert_allclose(Xt.numpy(), Xj, rtol=1e-3, atol=1e-3)
    assert (gt.good.numpy() == np.asarray(gj.good)).mean() >= 0.995
    # the host float64 twin is the same numpy code in both packages
    P2s = np.broadcast_to(np.asarray(P2j), (n, 3, 4))
    np.testing.assert_array_equal(
        ttri.triangulate_dlt_pairs_np(np.asarray(P1j), P2s, uv1, uv2),
        jtri.triangulate_dlt_pairs_np(np.asarray(P1j), P2s, uv1, uv2))


def test_optimize_points():
    """Structure-only LM, per-observation form against the JAX lane
    form, on a well-conditioned problem (6 m baseline at 8 m height).
    Bars: points within 2e-3 (in a ~10 m scene), >= 99.5% identical
    inlier verdicts.  The per-point sums accumulate in another order;
    the steps agree to ~1e-6, but LM's accept test compares two nearly
    equal costs near convergence, so damping can take another branch
    (measured: <= 7e-4 after 10 iterations)."""
    rng = np.random.default_rng(4)
    P, per = 300, 4
    X = np.concatenate([rng.uniform(-5, 5, (P, 2)), np.zeros((P, 1))], 1)
    poses = np.stack(synth.aerial_trajectory(per, speed=2.0, height=8.0))
    obs_pt = np.repeat(np.arange(P), per).astype(np.int32)
    obs_cam = np.tile(np.arange(per), P).astype(np.int32)
    pc = np.einsum("oij,oj->oi", poses[obs_cam, :3, :3], X[obs_pt]) \
        + poses[obs_cam, :3, 3]
    uv = (pc[:, :2] / pc[:, 2:] * 450 + [320, 240]
          + rng.normal(0, 0.7, (len(obs_pt), 2))).astype(np.float32)
    uv[rng.random(len(uv)) < 0.05] += 40.0        # outliers
    isig = (1.0 / 1.44 ** rng.integers(0, 3, len(uv))).astype(np.float32)
    valid = rng.random(len(uv)) > 0.05
    X0 = (X + rng.normal(0, 0.1, X.shape)).astype(np.float32)
    ref = jpo.optimize_points(
        jnp.asarray(X0), jnp.asarray(obs_pt), jnp.asarray(poses),
        jnp.asarray(uv), jnp.asarray(isig), jnp.asarray(valid),
        450.0, 450.0, 320.0, 240.0, iters=10, obs_cam=jnp.asarray(obs_cam))
    t = torch.from_numpy
    out = tpo.optimize_points(t(X0), t(obs_pt), t(poses), t(uv), t(isig),
                              t(valid), 450.0, 450.0, 320.0, 240.0, iters=10,
                              obs_cam=t(obs_cam))
    np.testing.assert_allclose(out.points.numpy(), np.asarray(ref.points),
                               rtol=0, atol=2e-3)
    assert (out.obs_inlier.numpy() == np.asarray(ref.obs_inlier)).mean() >= 0.995
    assert np.abs(out.points.numpy() - X).mean() < 0.05   # it converged
