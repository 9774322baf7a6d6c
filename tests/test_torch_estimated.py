"""Estimated-pose mode (upstream ORB-SLAM2, no trusted pose per frame):
the port's motion-only pose optimization, EPnP and its RANSAC, and the
H/F two-view initializer against the JAX package's on the same inputs;
its pose-optimizing local BA and EPnP relocalization from one JAX state;
and ``System.track_monocular`` of both packages with and without
bootstrap pose hints.

Scenes: tests/test_pnp.py's and tests/test_twoview.py's.  System size:
tests/test_pipeline.py's TestEstimatedMode (640x480, 800 features, 4
levels, 30 frames of the aerial sweep), rendered once with the port's
renderer and fed to both packages."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orb_slam2_tpu.pipeline.local_mapping as jlocal_mapping
from orb_slam2_tpu.geom import se3 as jse3, twoview as jtwoview
from orb_slam2_tpu.geom.camera import Intrinsics as JIntrinsics
from orb_slam2_tpu.ops.extractor import OrbParams as JOrbParams
from orb_slam2_tpu.optim import pnp as jpnp, pose_opt as jpose_opt
from orb_slam2_tpu.pipeline import SlamConfig as JSlamConfig, System as JSystem
from orb_slam2_tpu.pipeline.tracking import TrackState as JTrackState
from orb_slam2_tpu_torch import interop
from orb_slam2_tpu_torch.geom import twoview
from orb_slam2_tpu_torch.geom.camera import Intrinsics
from orb_slam2_tpu_torch.ops.extractor import OrbParams
from orb_slam2_tpu_torch.optim import pnp, pose_opt
from orb_slam2_tpu_torch.pipeline.config import SlamConfig
from orb_slam2_tpu_torch.pipeline.local_mapping import run_local_ba
from orb_slam2_tpu_torch.pipeline.place_recognition import PlaceRecognition
from orb_slam2_tpu_torch.pipeline.relocalization import Relocalizer
from orb_slam2_tpu_torch.pipeline.system import System
from orb_slam2_tpu_torch.pipeline.tracking import TrackState
from orb_slam2_tpu_torch.utils import synth
from orb_slam2_tpu_torch.utils.evaluate import ate_rmse

torch.set_num_threads(1)

FX = FY = 450.0
CX, CY = 320.0, 240.0
K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
N_FRAMES = 30
RELOC_POSE = 20       # the mapped pose a LOST frame is shown again
CAM_KW = dict(fx=FX, fy=FY, cx=CX, cy=CY, width=640, height=480)
CFG_KW = dict(fps=10.0, pose_prior=False, init_min_matches=60,
              init_min_triangulated=40, init_min_tracked_after_ba=60)
T = torch.as_tensor


def _rot(axis):
    return np.asarray(jse3.so3_exp(jnp.asarray(axis, jnp.float32)))


def _pose(axis, trans):
    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = _rot(axis)
    P[:3, 3] = trans
    return P


def _pnp_pose(seed):
    """tests/test_pnp.py's _pose."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=3)
    return _pose(0.4 * axis / np.linalg.norm(axis), [0.3, -0.2, 0.5])


def _project(P, X):
    pc = X @ P[:3, :3].T + P[:3, 3]
    return np.stack([FX * pc[:, 0] / pc[:, 2] + CX,
                     FY * pc[:, 1] / pc[:, 2] + CY], -1).astype(np.float32)


def _outlier_scene():
    """tests/test_pnp.py::test_pnp_ransac_with_outliers's scene and
    samples: 100 points, the last 30 moved 30-120 px."""
    P = _pnp_pose(2)
    rng = np.random.default_rng(3)
    n, n_out = 100, 30
    pw = rng.uniform([-3, -3, 4], [3, 3, 12], (n, 3)).astype(np.float32)
    pw = pw @ P[:3, :3] - (P[:3, 3] @ P[:3, :3])
    uv = _project(P, pw)
    uv[-n_out:] += rng.uniform(30, 120, (n_out, 2)).astype(np.float32)
    samples = rng.integers(0, n, (128, 4)).astype(np.int32)
    return P, pw, uv, samples


# ----------------------------------------------------------------------
# one function at a time, on the same inputs
# ----------------------------------------------------------------------
def test_optimize_pose_matches_jax():
    """The outlier scene from a start 6 cm off, padded to 128 rows (the
    padding invalid).  Bars: pose within 1e-4, the same inlier flags."""
    P, pw, uv, _ = _outlier_scene()
    P0 = P.copy()
    P0[:3, 3] += [0.05, -0.03, 0.02]
    P0[:3, :3] = _rot([0.01, -0.02, 0.005]) @ P[:3, :3]
    pad = 28
    pw = np.pad(pw, ((0, pad), (0, 0)))
    uv = np.pad(uv, ((0, pad), (0, 0)))
    isig = np.pad(np.full(100, 0.8, np.float32), (0, pad))
    valid = np.pad(np.ones(100, bool), (0, pad))
    j = jpose_opt.optimize_pose(jnp.asarray(P0), jnp.asarray(pw),
                                jnp.asarray(uv), jnp.asarray(isig),
                                jnp.asarray(valid), FX, FY, CX, CY)
    p = pose_opt.optimize_pose(T(P0), T(pw), T(uv), T(isig), T(valid),
                               FX, FY, CX, CY)
    np.testing.assert_allclose(p.Tcw.numpy(), np.asarray(j.Tcw), atol=1e-4)
    np.testing.assert_array_equal(p.inliers.numpy(), np.asarray(j.inliers))
    assert int(p.n_inliers) == int(j.n_inliers) == 70


def test_epnp_matches_jax():
    """tests/test_pnp.py::test_epnp_exact's scene.  Bar: pose within
    1e-3 of the JAX package's (and of the truth)."""
    P = _pnp_pose(0)
    rng = np.random.default_rng(1)
    pw = rng.uniform([-3, -3, 4], [3, 3, 12], (12, 3)).astype(np.float32)
    pw = pw @ P[:3, :3] - (P[:3, 3] @ P[:3, :3])
    uv = _project(P, pw)
    Tj, _ = jpnp.epnp(jnp.asarray(pw), jnp.asarray(uv), FX, FY, CX, CY)
    Tp, err = pnp.epnp(T(pw), T(uv), FX, FY, CX, CY)
    np.testing.assert_allclose(Tp.numpy(), np.asarray(Tj), atol=1e-3)
    np.testing.assert_allclose(Tp.numpy(), P, atol=1e-3)
    assert float(err) < 1.0


def test_pnp_ransac_matches_jax():
    """The outlier scene with tests/test_pnp.py's 128 samples.  Bars:
    the same inliers and inlier count; the pose within 1e-3 of the JAX
    package's after the motion-only optimization over those inliers that
    follows every RANSAC in the pipeline (relocalization).  The raw
    winning poses are not held: a minimal set's 12x12 system has a
    4-dimensional null space, whose eigenvector basis LAPACK builds
    choose differently; the beta approximations depend on it, so two
    hypotheses that tie on inliers can swap, and the winners differ by
    the minimal solutions' error (9e-3 here), not by rounding."""
    P, pw, uv, samples = _outlier_scene()
    n = len(pw)
    j = jpnp.pnp_ransac(jnp.asarray(pw), jnp.asarray(uv),
                        jnp.ones(n, jnp.float32), jnp.ones(n, bool),
                        jnp.asarray(samples), FX, FY, CX, CY, min_inliers=10)
    p = pnp.pnp_ransac(T(pw), T(uv), torch.ones(n),
                       torch.ones(n, dtype=torch.bool), T(samples),
                       FX, FY, CX, CY, min_inliers=10)
    assert bool(p.ok) and bool(j.ok)
    np.testing.assert_array_equal(p.inliers.numpy(), np.asarray(j.inliers))
    assert int(p.n_inliers) == int(j.n_inliers)
    ones = np.ones(n, np.float32)
    jr = jpose_opt.optimize_pose(j.Tcw, jnp.asarray(pw), jnp.asarray(uv),
                                 jnp.asarray(ones), j.inliers, FX, FY, CX, CY)
    pr = pose_opt.optimize_pose(p.Tcw, T(pw), T(uv), T(ones), p.inliers,
                                FX, FY, CX, CY)
    np.testing.assert_allclose(pr.Tcw.numpy(), np.asarray(jr.Tcw), atol=1e-3)
    np.testing.assert_array_equal(pr.inliers.numpy(), np.asarray(jr.inliers))


def test_pnp_ransac_rejects_garbage_as_jax():
    """tests/test_pnp.py::test_pnp_ransac_rejects_garbage.  Bar: both
    reject (the garbage hypotheses' own counts are not comparable)."""
    rng = np.random.default_rng(4)
    n = 64
    pw = rng.uniform([-3, -3, 4], [3, 3, 12], (n, 3)).astype(np.float32)
    uv = rng.uniform([0, 0], [640, 480], (n, 2)).astype(np.float32)
    samples = rng.integers(0, n, (128, 4)).astype(np.int32)
    j = jpnp.pnp_ransac(jnp.asarray(pw), jnp.asarray(uv),
                        jnp.ones(n, jnp.float32), jnp.ones(n, bool),
                        jnp.asarray(samples), FX, FY, CX, CY, min_inliers=30)
    p = pnp.pnp_ransac(T(pw), T(uv), torch.ones(n),
                       torch.ones(n, dtype=torch.bool), T(samples),
                       FX, FY, CX, CY, min_inliers=30)
    assert not bool(p.ok) and not bool(j.ok)
    assert max(int(p.n_inliers), int(j.n_inliers)) < 30


def _twoview_scene(name):
    """tests/test_twoview.py's four scenes: (X, T2, n_out, seed)."""
    if name == "general":
        rng = np.random.default_rng(1)
        X = rng.uniform([-3, -3, 4], [3, 3, 12], (200, 3))
        return X, _pose([0.02, -0.05, 0.01], [0.8, 0.05, 0.05]), 0
    if name == "planar":
        rng = np.random.default_rng(2)
        X = np.stack([rng.uniform(-4, 4, 200), rng.uniform(-3, 3, 200),
                      np.full(200, 8.0)], -1)
        return X, _pose([0.05, 0.08, 0.02], [0.6, 0.1, 0.05]), 0
    if name == "outliers":
        rng = np.random.default_rng(3)
        X = rng.uniform([-3, -3, 4], [3, 3, 12], (200, 3))
        return X, _pose([0.02, -0.05, 0.01], [0.8, 0.05, 0.05]), 40
    rng = np.random.default_rng(4)
    X = rng.uniform([-3, -3, 4], [3, 3, 12], (200, 3))
    return X, _pose([0.0, 0.1, 0.0], [1e-5, 0, 0]), 0


@pytest.mark.parametrize("scene, expect", [
    ("general", (True, False)), ("planar", (True, True)),
    ("outliers", (True, False)), ("pure_rotation", (False, None))])
def test_initialize_two_view_matches_jax(scene, expect):
    """Bars: the same ok and model as the JAX package (and as
    tests/test_twoview.py expects); >= 99% of the triangulation inlier
    flags equal; R and t within 1e-3 where the view pair initializes.
    The SVDs' vectors may differ in sign; that reorders the motion
    candidates, not the chosen one."""
    X, T2, n_out = _twoview_scene(scene)
    X = X.astype(np.float32)
    rng = np.random.default_rng(0)      # tests/test_twoview.py::_run's
    uv1 = _project(np.eye(4, dtype=np.float32), X)
    uv2 = _project(T2, X)
    uv1 += rng.normal(0, 0.3, uv1.shape).astype(np.float32)
    uv2 += rng.normal(0, 0.3, uv2.shape).astype(np.float32)
    if n_out:
        uv2[-n_out:] += rng.uniform(20, 80, (n_out, 2)).astype(np.float32)
    n = len(X)
    samples = rng.integers(0, n, (200, 8)).astype(np.int32)
    j = jtwoview.initialize_two_view(
        jnp.asarray(uv1), jnp.asarray(uv2), jnp.ones(n, bool),
        jnp.ones(n, jnp.float32), jnp.asarray(K), jnp.asarray(samples))
    p = twoview.initialize_two_view(
        T(uv1), T(uv2), torch.ones(n, dtype=torch.bool), torch.ones(n),
        T(K), T(samples))
    ok, use_h = expect
    assert bool(p.ok) == bool(j.ok) == ok
    assert bool(p.used_homography) == bool(j.used_homography)
    if use_h is not None:
        assert bool(p.used_homography) == use_h
    assert (p.good.numpy() == np.asarray(j.good)).mean() >= 0.99
    if ok:
        np.testing.assert_allclose(p.R.numpy(), np.asarray(j.R), atol=1e-3)
        np.testing.assert_allclose(p.t.numpy(), np.asarray(j.t), atol=1e-3)


# ----------------------------------------------------------------------
# the System, both packages on the same frames
# ----------------------------------------------------------------------
def _frame_fields(f):
    return {k: (np.array(getattr(f, k)) if k not in ("frame_id", "timestamp")
                else getattr(f, k)) for k in interop.FRAME_FIELDS}


@pytest.fixture(scope="module")
def frames():
    world = synth.make_world(seed=3, device="cpu")
    poses = synth.aerial_trajectory(N_FRAMES, speed=0.3)
    return poses, [synth.render(world, Intrinsics(**CAM_KW), T_).numpy()
                   for T_ in poses]


def _systems():
    jsys = JSystem(JSlamConfig(cam=JIntrinsics(**CAM_KW),
                               orb=JOrbParams(n_features=800, n_levels=4),
                               **CFG_KW), enable_loop_closing=False)
    cfg = SlamConfig(cam=Intrinsics(**CAM_KW),
                     orb=OrbParams(n_features=800, n_levels=4), **CFG_KW)
    return jsys, System(cfg, enable_loop_closing=False, device="cpu"), cfg


def _track(frames, hint: bool, rec: dict = None):
    """Both packages through the sweep with track_monocular.  With
    ``rec`` the JAX run records its first pose-optimizing local BA
    (store before and after), its frames as extracted and, for the
    relocalization test, its state before a LOST frame."""
    poses, imgs = frames
    jsys, port, cfg = _systems()
    jorig = jlocal_mapping.run_local_ba
    if rec is not None:
        orig_make = jsys.tracker.factory.make

        def make(*a, **k):
            f = orig_make(*a, **k)
            rec.setdefault("frames", {})[f.frame_id] = _frame_fields(f)
            return f
        jsys.tracker.factory.make = make

        def local_ba(store, center_kf, cfg_, fixed_pose=False, iters=10,
                     timer=None):
            first = "local_ba" not in rec and not fixed_pose
            before = interop.mapstore_state(store) if first else None
            jorig(store, center_kf, cfg_, fixed_pose=fixed_pose,
                  iters=iters, timer=timer)
            if first:
                rec["local_ba"] = dict(kid=center_kf, iters=iters,
                                       before=before,
                                       after=interop.mapstore_state(store))
        jlocal_mapping.run_local_ba = local_ba
    per = []
    try:
        for i, P in enumerate(poses):
            for s in (jsys, port):
                s.track_monocular(imgs[i], i * 0.1,
                                  pose_hint=P if hint else None)
            per.append((jsys.state.name, port.state.name))
    finally:
        jlocal_mapping.run_local_ba = jorig
    return dict(jsys=jsys, port=port, cfg=cfg, per=per, poses=poses)


@pytest.fixture(scope="module")
def unhinted(frames):
    rec = {}
    run = _track(frames, hint=False, rec=rec)
    run["rec"] = rec
    return run


@pytest.fixture(scope="module")
def hinted(frames):
    return _track(frames, hint=True)


def _ate(system, poses, align):
    est, gt = [], []
    for (_, _, Tcw, state), P in zip(system.trajectory, poses):
        if state.name == "OK":
            est.append(-Tcw[:3, :3].T @ Tcw[:3, 3])
            gt.append(-P[:3, :3].T @ P[:3, 3])
    return len(est), ate_rmse(np.stack(est), np.stack(gt), align=align)


@pytest.mark.parametrize("which, align, min_ok", [
    ("unhinted", "sim3", 21), ("hinted", "se3", 25)])
def test_track_monocular_matches_jax(request, which, align, min_ok):
    """TestEstimatedMode's runs in both packages: no pose at all (H/F
    bootstrap, up-to-scale ATE after a Sim3 alignment) and GT poses as
    bootstrap hints only (ATE after an SE3 alignment).  Bars: identical
    per-frame states; as TestEstimatedMode, > 20 / > 24 frames tracked
    and ATE < 0.10, in both packages."""
    run = request.getfixturevalue(which)
    assert [p for p, _ in run["per"]] == [j for _, j in run["per"]]
    for system in (run["jsys"], run["port"]):
        n, ate = _ate(system, run["poses"], align)
        assert n >= min_ok, n
        assert ate < 0.10, ate


def test_local_ba_from_one_state(unhinted):
    """The port's pose-optimizing local BA on the JAX store as it stood
    before the JAX run's first one.  Bars: keyframe poses within 1e-3
    (the BA sums in another order in float32); points valid in both
    within 1e-2, as test_torch_slice's mapping test; >= 99% of the
    points' observation sets equal (the outlier edges each BA erased)."""
    rec = unhinted["rec"]["local_ba"]
    store = interop.mapstore_from_numpy(**rec["before"], device="cpu")
    run_local_ba(store, rec["kid"], unhinted["cfg"], fixed_pose=False,
                 iters=rec["iters"])
    after = rec["after"]
    for kf, ref in zip(store.kfs, after["keyframes"]):
        if ref["valid"]:
            np.testing.assert_allclose(kf.Tcw, ref["Tcw"], atol=1e-3)
    moved = [not np.allclose(kf["Tcw"], ref["Tcw"]) for kf, ref in
             zip(rec["before"]["keyframes"], after["keyframes"])]
    assert any(moved)      # the local BA did optimize poses
    pv, jv = np.asarray(store.mp_valid), after["points"]["mp_valid"]
    both = pv & jv
    d = np.abs(np.asarray(store.mp_pos)[both]
               - after["points"]["mp_pos"][both])
    assert d.max() < 1e-2, d.max()
    same = [a == b for a, b in zip(store.mp_obs, after["mp_obs"])]
    assert np.mean(same) >= 0.99


def test_estimated_relocalization_from_one_state(unhinted, frames):
    """Both Systems LOST, then shown the image of mapped frame
    RELOC_POSE again with no pose.  Bars: both relocalize (EPnP +
    RANSAC, pose optimization) and track the frame OK; the port's
    Relocalizer, started from the JAX store, vocabulary and sampler
    state and given the JAX-extracted frame, gives the same verdict and
    the same binding on >= 99% of the features either package bound."""
    jsys, port, cfg = unhinted["jsys"], unhinted["port"], unhinted["cfg"]
    _, imgs = frames
    v = jsys.place_rec.vocab
    assert jsys.place_rec.ready
    vocab = dict(k=v.k, levels=v.levels, centers=v.centers, idf=v.idf,
                 node_level=v.node_level)
    before = interop.mapstore_state(jsys.store)
    jrel = jsys.tracker.relocalize
    rng_state = copy.deepcopy(jrel._rng.bit_generator.state)
    got = {}

    def relocalize(frame):
        ok = jrel(frame)
        got.update(ok=ok, mp_ids=frame.mp_ids.copy())
        return ok
    relocalize.pr = jrel.pr
    jsys.tracker.relocalize = relocalize
    jsys.tracker.state = JTrackState.LOST
    jframe = jsys.track_monocular(imgs[RELOC_POSE], 99.0)
    jsys.tracker.relocalize = jrel
    port.tracker.state = TrackState.LOST
    port.track_monocular(imgs[RELOC_POSE], 99.0)
    assert jsys.state.name == port.state.name == "OK"
    assert jsys.tracker.last_reloc_frame_id == jframe.frame_id
    assert got["ok"]

    store = interop.mapstore_from_numpy(**before, device="cpu")
    pr = PlaceRecognition(store, vocab=interop.vocabulary_from_numpy(**vocab))
    for kid in store.valid_kf_ids():
        pr.add_keyframe(kid)
    rel = Relocalizer(cfg, store, pr)
    rel._rng.bit_generator.state = rng_state
    frame = interop.frame_from_numpy(
        **unhinted["rec"]["frames"][jframe.frame_id])
    assert rel(frame)
    either = (frame.mp_ids >= 0) | (got["mp_ids"] >= 0)
    assert (frame.mp_ids >= 0).sum() >= cfg.track_local_min_inliers_reloc
    assert (frame.mp_ids[either] == got["mp_ids"][either]).mean() >= 0.99
