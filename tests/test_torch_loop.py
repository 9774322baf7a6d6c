"""Loop closing in the port against the JAX package: the Lie-group
helpers, Horn's closed form, the Sim3 RANSAC and optimization, the
essential-graph solver and bundle adjustment on synthetic problems made
with numpy; loop correction from one state; and the drifted circuit of
tests/test_loop_proof.py end to end.

Size of the end-to-end runs: 640x480, 800 ORB features, 4 levels, the
40-frame circuit plus its first 14 frames again, rendered once with the
port's renderer and fed to both packages, sequential mapping."""
import copy

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.geom import horn as jhorn, se3 as jse3, sim3 as jsim3
from orb_slam2_tpu.geom.camera import Intrinsics as JIntrinsics
from orb_slam2_tpu.ops.extractor import OrbParams as JOrbParams
from orb_slam2_tpu.optim import (ba as jba, pose_graph as jpg,
                                 reproj as jreproj, sim3_opt as jso,
                                 sim3_ransac as jsr)
from orb_slam2_tpu.pipeline import SlamConfig as JSlamConfig, System as JSystem
from orb_slam2_tpu_torch import interop, parallel
from orb_slam2_tpu_torch.geom import horn as thorn, se3 as tse3, sim3 as tsim3
from orb_slam2_tpu_torch.geom.camera import Intrinsics
from orb_slam2_tpu_torch.ops.extractor import OrbParams
from orb_slam2_tpu_torch.optim import (ba as tba, pose_graph as tpg,
                                       reproj as treproj, sim3_opt as tso,
                                       sim3_ransac as tsr)
from orb_slam2_tpu_torch.pipeline.config import SlamConfig
from orb_slam2_tpu_torch.pipeline.loop_closing import LoopCloser
from orb_slam2_tpu_torch.pipeline.place_recognition import PlaceRecognition
from orb_slam2_tpu_torch.pipeline.system import System
from orb_slam2_tpu_torch.pipeline.tracking import TrackState
from orb_slam2_tpu_torch.utils import synth
from orb_slam2_tpu_torch.utils.evaluate import ate_rmse

torch.set_num_threads(1)

FX, FY, CX, CY = 450.0, 450.0, 320.0, 240.0


def _np(a):
    return np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=0)


def _rand_sims(rng, n, scale_sd=0.1):
    xi = rng.normal(0, 0.3, (n, 7)).astype(np.float32)
    xi[:, 6] *= scale_sd
    return xi


# ----------------------------------------------------------------------
# Lie groups and Horn (bar 1e-5)
# ----------------------------------------------------------------------
def test_se3_ops():
    """Bar: 1e-5 on exp and the quaternion conversions (the se3 functions
    the Sim3, Horn and BA modules call)."""
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.5, (64, 6)).astype(np.float32)
    xi[:4] *= 1e-5                               # the small-angle branch
    xi[4, 3:] = [np.pi - 1e-4, 0, 0]            # the near-pi branch
    Tj, Tt = jse3.exp(jnp.asarray(xi)), tse3.exp(torch.from_numpy(xi))
    _close(Tt, Tj, 1e-5)
    R = Tt[:, :3, :3]
    _close(tse3.rot_to_quat(R), jse3.rot_to_quat(jnp.asarray(R.numpy())), 1e-5)
    _close(tse3.quat_to_rot(tse3.rot_to_quat(R)), R, 1e-5)
    _close(tse3.so3_log(R), jse3.so3_log(jnp.asarray(R.numpy())), 1e-5)


def test_sim3_ops():
    """Bar: 1e-5 on exp, log, compose, inv, apply and the SE3 lifts
    (rotations compared as matrices)."""
    rng = np.random.default_rng(1)
    xi = _rand_sims(rng, 64, scale_sd=1.0)
    xi[:4] *= 1e-6                               # both small branches
    xi[4:8, 3:6] *= 1e-6                         # theta small, sigma not
    xi[8:12, 6] = 0.0                            # sigma zero
    gj, gt = jsim3.exp(jnp.asarray(xi)), tsim3.exp(torch.from_numpy(xi))
    _close(tsim3.rot(gt), jsim3.rot(gj), 1e-5)
    _close(gt[:, 4:], gj[:, 4:], 1e-5)
    _close(tsim3.log(gt), jsim3.log(gj), 1e-5)
    hj, ht = jsim3.exp(jnp.asarray(xi[::-1].copy())), \
        tsim3.exp(torch.from_numpy(xi[::-1].copy()))
    cj, ct = jsim3.compose(gj, hj), tsim3.compose(gt, ht)
    _close(tsim3.rot(ct), jsim3.rot(cj), 1e-5)
    _close(ct[:, 4:], cj[:, 4:], 1e-5)
    ij, it = jsim3.inv(gj), tsim3.inv(gt)
    _close(it[:, 4:], ij[:, 4:], 1e-5)
    p = rng.normal(0, 1, (64, 5, 3)).astype(np.float32)
    _close(tsim3.apply(gt, torch.from_numpy(p)),
           jsim3.apply(gj, jnp.asarray(p)), 1e-5)
    T = tse3.exp(torch.from_numpy(xi[:, :6].copy()))
    _close(tsim3.to_se3(tsim3.from_se3(T, 1.3)),
           jsim3.to_se3(jsim3.from_se3(jnp.asarray(T.numpy()), 1.3)), 1e-5)


def test_horn():
    """Batched minimal and full-set Horn solves with and without fixed
    scale.  Bar: rotation, translation and scale within 1e-5 of the JAX
    solve (quaternions are compared only through their rotations: the
    eigenvector's sign is free)."""
    rng = np.random.default_rng(2)
    true = tsim3.exp(torch.from_numpy(_rand_sims(rng, 32)))
    p2 = rng.uniform(-2, 2, (32, 40, 3)).astype(np.float32)
    p1 = tsim3.apply(true, torch.from_numpy(p2)).numpy()
    p1 = p1 + rng.normal(0, 0.01, p1.shape).astype(np.float32)
    for n in (3, 40):
        for fix in (False, True):
            gj = jhorn.horn_sim3(jnp.asarray(p1[:, :n]), jnp.asarray(p2[:, :n]),
                                 fix_scale=fix)
            gt = thorn.horn_sim3(torch.from_numpy(p1[:, :n]),
                                 torch.from_numpy(p2[:, :n]), fix_scale=fix)
            _close(tsim3.rot(gt), jsim3.rot(gj), 1e-5)
            _close(gt[:, 4:], gj[:, 4:], 1e-5)


# ----------------------------------------------------------------------
# Sim3 RANSAC and optimization
# ----------------------------------------------------------------------
def _sim3_problem(seed, n=180, scale=1.0):
    """Map points of two keyframes related by a Sim3 (frame 2 -> 1),
    their keypoints with noise, 20% gross outliers."""
    rng = np.random.default_rng(seed)
    xi = np.array([0.3, -0.2, 0.1, 0.02, -0.05, 0.03, np.log(scale)],
                  np.float32)
    S12 = tsim3.exp(torch.from_numpy(xi))
    p2 = np.c_[rng.uniform(-3, 3, (n, 2)), rng.uniform(8, 12, n)].astype(
        np.float32)
    p1 = tsim3.apply(S12, torch.from_numpy(p2)).numpy()

    def proj(p):
        return np.stack([FX * p[:, 0] / p[:, 2] + CX,
                         FY * p[:, 1] / p[:, 2] + CY], -1).astype(np.float32)

    uv1 = proj(p1) + rng.normal(0, 0.7, (n, 2)).astype(np.float32)
    uv2 = proj(p2) + rng.normal(0, 0.7, (n, 2)).astype(np.float32)
    out = rng.random(n) < 0.2
    uv1[out] += rng.uniform(-40, 40, (out.sum(), 2)).astype(np.float32)
    oct_ = rng.integers(0, 4, n)
    sig2 = (1.2 ** (2 * oct_)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-12:] = False                       # padded rows
    return dict(S12=S12.numpy(), p1=p1, p2=p2, uv1=uv1, uv2=uv2, sig2=sig2,
                valid=valid, rng=rng)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_sim3_ransac_same_samples(fix_scale):
    """Both packages score the same 256 hypotheses.  Bar: same ok, S12
    within 1e-4 (through R, t, s), >= 99% of inlier flags equal."""
    pr = _sim3_problem(3, scale=1.0 if fix_scale else 1.15)
    n = len(pr["p1"])
    samples = pr["rng"].integers(0, n - 12, (256, 3)).astype(np.int32)
    me = (jsr.CHI2_SIM3 * pr["sig2"]).astype(np.float32)
    args = [pr[k] for k in ("p1", "p2", "uv1", "uv2")] + [me, me,
                                                          pr["valid"], samples]
    rj = jsr.sim3_ransac(*[jnp.asarray(a) for a in args], FX, FY, CX, CY,
                         min_inliers=20, fix_scale=fix_scale)
    rt = tsr.sim3_ransac(*[torch.from_numpy(a) for a in args], FX, FY, CX, CY,
                         min_inliers=20, fix_scale=fix_scale)
    assert bool(rt.ok) == bool(rj.ok) is True
    _close(tsim3.rot(rt.S12), jsim3.rot(rj.S12), 1e-4)
    _close(rt.S12[4:], rj.S12[4:], 1e-4)
    assert (rt.inliers.numpy() == np.asarray(rj.inliers)).mean() >= 0.99
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 0.01 * n


@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_sim3(fix_scale):
    """LM from a perturbed start.  Bar: S12 within 1e-3 (through R, t,
    s) and the inlier count within one."""
    pr = _sim3_problem(4, scale=1.0 if fix_scale else 1.1)
    init = tsim3.compose(tsim3.exp(torch.tensor(
        [0.05, -0.03, 0.02, 0.01, 0.0, -0.01, 0.0])),
        torch.from_numpy(pr["S12"])).numpy()
    isig = (1.0 / pr["sig2"]).astype(np.float32)
    args = [init] + [pr[k] for k in ("p1", "p2", "uv1", "uv2")] + [
        isig, isig, pr["valid"]]
    rj = jso.optimize_sim3(*[jnp.asarray(a) for a in args], FX, FY, CX, CY,
                           iters=8, fix_scale=fix_scale)
    rt = tso.optimize_sim3(*[torch.from_numpy(a) for a in args], FX, FY, CX,
                           CY, iters=8, fix_scale=fix_scale)
    _close(tsim3.rot(rt.S12), jsim3.rot(rj.S12), 1e-3)
    _close(rt.S12[4:], rj.S12[4:], 1e-3)
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 1
    assert int(rt.n_inliers) > 100


# ----------------------------------------------------------------------
# essential graph and bundle adjustment (bar 1e-3)
# ----------------------------------------------------------------------
def test_optimize_pose_graph():
    """A 24-vertex circuit: odometry edges from the true poses, one
    loop edge, drifted starting estimates, padded edges of weight 0.
    Bar: every vertex within 1e-3 of the JAX solve (rotation matrix,
    translation, scale)."""
    rng = np.random.default_rng(6)
    K, E = 24, 64
    true = tsim3.exp(torch.from_numpy(_rand_sims(rng, K, scale_sd=0.05)))
    ei = np.r_[np.arange(K - 1), K - 1, np.zeros(E - K, int)]
    ej = np.r_[np.arange(1, K), 0, np.zeros(E - K, int)]
    meas = tsim3.compose(true[ej], tsim3.inv(true[ei])).numpy()
    w = np.r_[np.ones(K), np.zeros(E - K)].astype(np.float32)
    drift = torch.from_numpy(np.cumsum(rng.normal(0, 0.02, (K, 7)), 0)
                             .astype(np.float32))
    drift[:, 6] *= 0.1
    sims0 = tsim3.compose(tsim3.exp(drift), true).numpy()
    fixed = np.zeros(K, bool)
    fixed[0] = True
    args = [sims0, ei.astype(np.int32), ej.astype(np.int32), meas, w, fixed]
    rj = jpg.optimize_pose_graph(*[jnp.asarray(a) for a in args],
                                 iters=20, cg_iters=30)
    rt = tpg.optimize_pose_graph(*[torch.from_numpy(a) for a in args],
                                 iters=20, cg_iters=30)
    _close(tsim3.rot(rt.sims), jsim3.rot(rj.sims), 1e-3)
    _close(rt.sims[:, 4:], rj.sims[:, 4:], 1e-3)
    assert float(rt.final_cost) < 1e-3 * float(np.sum(w))


def test_reproj_jacobians():
    """Bar: residuals and both Jacobians within 1e-4 (relative to their
    size) of the JAX module's."""
    rng = np.random.default_rng(7)
    T = tse3.exp(torch.from_numpy(rng.normal(0, 0.2, (50, 6)).astype(np.float32)))
    pts = np.c_[rng.uniform(-2, 2, (50, 2)), rng.uniform(4, 8, 50)].astype(
        np.float32)
    uv = rng.uniform(0, 600, (50, 2)).astype(np.float32)
    rj = jreproj.project_jacobians(jnp.asarray(T.numpy()), jnp.asarray(pts),
                                   jnp.asarray(uv), FX, FY, CX, CY)
    rt = treproj.project_jacobians(T, torch.from_numpy(pts),
                                   torch.from_numpy(uv), FX, FY, CX, CY)
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-3)


def _ba_problem(seed):
    """Six cameras, the first two fixed, over 300 plane-ish points,
    each point seen by the
    first three cameras and by each other one with probability 0.8
    (every point well constrained), noisy observations, 5% outliers,
    cameras and points perturbed from the truth."""
    rng = np.random.default_rng(seed)
    Kc, P = 6, 300
    X = np.c_[rng.uniform(-4, 4, (P, 2)), rng.uniform(-0.5, 0.5, P)]
    poses = []
    for k in range(Kc):
        T = np.eye(4)
        T[:3, 3] = [-1.2 * k + 3.0, 0.3 * k, 10.0]
        poses.append(T)
    poses = np.stack(poses).astype(np.float32)
    obs_kf, obs_pt, obs_uv = [], [], []
    for k in range(Kc):
        pc = X @ poses[k, :3, :3].T + poses[k, :3, 3]
        uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX,
                       FY * pc[:, 1] / pc[:, 2] + CY], -1)
        seen = (rng.random(P) < 0.8) | (k < 3)
        obs_kf += [k] * seen.sum()
        obs_pt += list(np.where(seen)[0])
        obs_uv.append(uv[seen])
    obs_uv = np.concatenate(obs_uv)
    obs_uv += rng.normal(0, 0.5, obs_uv.shape)
    bad = rng.random(len(obs_uv)) < 0.05
    obs_uv[bad] += rng.uniform(-30, 30, (bad.sum(), 2))
    O = len(obs_uv)
    pert = tse3.exp(torch.from_numpy(rng.normal(0, 0.01, (Kc, 6))
                                     .astype(np.float32))).numpy()
    cams = np.einsum("kab,kbc->kac", pert, poses).astype(np.float32)
    cams[:2] = poses[:2]
    pts = (X + rng.normal(0, 0.05, X.shape)).astype(np.float32)
    pad = 512 - O % 512
    valid = np.r_[np.ones(O, bool), np.zeros(pad, bool)]
    fixed = np.zeros(Kc, bool)
    fixed[:2] = True                  # the gauge, scale included
    return [cams, pts,
            np.r_[obs_kf, np.zeros(pad, int)].astype(np.int32),
            np.r_[obs_pt, np.zeros(pad, int)].astype(np.int32),
            np.r_[obs_uv, np.zeros((pad, 2))].astype(np.float32),
            (1.2 ** -(2 * rng.integers(0, 3, O + pad))).astype(np.float32),
            valid, fixed]


@pytest.mark.parametrize("use_huber", [True, False])
def test_bundle_adjust(use_huber):
    """The single-device bundle_adjust of both packages on the same
    problem (the JAX test process has 8 CPU devices, so its
    run_global_ba would take the distributed branch; the function is
    compared directly).  Bar: poses and points within 1e-3, inlier
    flags on >= 99% of observations."""
    args = _ba_problem(8)
    rj = jba.bundle_adjust(*[jnp.asarray(a) for a in args], FX, FY, CX, CY,
                           iters=10, cg_iters=20, use_huber=use_huber)
    rt = tba.bundle_adjust(*[torch.from_numpy(a) for a in args], FX, FY, CX,
                           CY, iters=10, cg_iters=20, use_huber=use_huber)
    _close(rt.cam_Tcw, rj.cam_Tcw, 1e-3)
    _close(rt.points, rj.points, 1e-3)
    assert (rt.obs_inlier.numpy() == np.asarray(rj.obs_inlier)).mean() >= 0.99
    assert float(rt.final_cost) < float(
        tba.bundle_adjust(*[torch.from_numpy(a) for a in args], FX, FY, CX,
                          CY, iters=0, use_huber=use_huber).final_cost)


# ----------------------------------------------------------------------
# the drifted circuit, end to end and from one state
# ----------------------------------------------------------------------
CAM_KW = dict(fx=FX, fy=FY, cx=CX, cy=CY, width=640, height=480)
CFG_KW = dict(fps=10.0, pose_prior=True, init_min_matches=60,
              init_min_triangulated=40, init_min_tracked_after_ba=60,
              loop_min_kfs_since_last=6)
N_LAP, N_REVISIT, DRIFT, RADIUS = 40, 14, 0.02, 8.0


def _circuit():
    """tests/test_loop_proof.py's drifted circuit: the true poses render
    the images, priors drifting 0.02 units per frame are fed in.  The
    radius is 8 instead of 6, a circle on which both packages'
    corrections beat the drifted priors (the test's bar)."""
    true = synth.loop_trajectory(N_LAP, radius=RADIUS)
    true = true + true[:N_REVISIT]
    fed = []
    for t, Tcw in enumerate(true):
        D = np.eye(4, dtype=np.float32)
        D[:3, 3] = [DRIFT * t, 0.5 * DRIFT * t, 0.0]
        fed.append((Tcw @ np.linalg.inv(D)).astype(np.float32))
    return true, fed


def _kf_ate(store, true, poses=None):
    """Sim3-aligned ATE of the valid keyframes' centers (or of the given
    per-frame poses at the keyframes' frames)."""
    est, gt = [], []
    for kf in store.kfs:
        if not kf.valid:
            continue
        fid = kf.frame.frame_id
        T = kf.Tcw if poses is None else poses[fid]
        est.append(-T[:3, :3].T @ T[:3, 3])
        gt.append(-true[fid][:3, :3].T @ true[fid][:3, 3])
    return ate_rmse(np.stack(est), np.stack(gt), align="sim3")


def _vocab_state(v):
    return dict(k=v.k, levels=v.levels, centers=v.centers, idf=v.idf,
                node_level=v.node_level)


def run_circuit(cfg, images, fed, vocab=None, jvocab=None):
    """Both packages over the same images and priors, frame by frame,
    sequential mapping, loop closing on (``vocab`` / ``jvocab``: each
    package's live vocabulary; None trains one online).  Records in
    ``rec``, for the from-one-state tests: the JAX store and vocabulary
    before and after its first ``_correct_loop`` and its arguments
    (``before``, ``vocab``, ``args``, ``after``); the store, vocabulary
    and RANSAC generator as the first ``_compute_sim3`` that found a
    loop met them, with its arguments and result (``sim3``); each
    ``loop_candidates`` call up to the first loop that returned
    keyframes, with the store as it stood, the BoW vectors and the
    relocalization candidates of the query's vector (``candidates``);
    the JAX run's first essential-graph problem and its solution
    (``pose_graph``)."""
    cam = cfg.cam
    jsys = JSystem(JSlamConfig(
        cam=JIntrinsics(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                        width=cam.width, height=cam.height),
        orb=JOrbParams(n_features=cfg.orb.n_features,
                       n_levels=cfg.orb.n_levels), **CFG_KW),
        enable_loop_closing=True, vocab=jvocab)
    lc = jsys.loop_closer
    rec = {"candidates": []}
    orig_correct = lc._correct_loop

    def correct(kid, loop_kf, Scw, loop_mps, matched):
        first = "before" not in rec
        if first:
            rec.update(
                before=interop.mapstore_state(jsys.store),
                vocab=_vocab_state(lc.pr.vocab),
                args=(kid, loop_kf, np.array(Scw), list(loop_mps),
                      dict(matched)))
        orig_correct(kid, loop_kf, Scw, loop_mps, matched)
        if first:
            rec["after"] = interop.mapstore_state(jsys.store)
    lc._correct_loop = correct
    compute = lc._compute_sim3

    def compute_sim3(kid, candidates):
        # the map, the vocabulary and the RANSAC generator as this call
        # found them; kept for the first call that finds a loop
        state = (interop.mapstore_state(jsys.store),
                 _vocab_state(lc.pr.vocab),
                 copy.deepcopy(lc._rng.bit_generator.state))
        found = compute(kid, candidates)
        if found is not None and "sim3" not in rec:
            cand, Scw, loop_mps, matched = found
            rec["sim3"] = dict(store=state[0], vocab=state[1], rng=state[2],
                               args=(kid, list(candidates)),
                               found=(cand, np.array(Scw), list(loop_mps),
                                      dict(matched)))
        return found
    lc._compute_sim3 = compute_sim3
    query = lc.pr.loop_candidates

    def loop_candidates(kid, min_score):
        out = query(kid, min_score)
        if out and "before" not in rec:
            rec["candidates"].append(dict(
                store=interop.mapstore_state(jsys.store),
                bow={k: dict(v) for k, v in lc.pr.bow.items()},
                kid=kid, min_score=min_score, out=list(out),
                reloc=lc.pr.reloc_candidates(lc.pr.bow[kid])))
        return out
    lc.pr.loop_candidates = loop_candidates

    solve = jpg.optimize_pose_graph

    def pose_graph_solve(*args, **kwargs):
        res = solve(*args, **kwargs)
        rec.setdefault("pose_graph", dict(
            args=[np.array(a) for a in args], kwargs=dict(kwargs),
            sims=np.array(res.sims), cost=float(res.final_cost)))
        return res
    port = System(cfg, device="cpu", vocab=vocab)
    states = []
    jpg.optimize_pose_graph = pose_graph_solve
    try:
        for i, (img, Tf) in enumerate(zip(images, fed)):
            jsys.track_monocular_with_pose(img, i * 0.1, Tf)
            port.track_monocular_with_pose(img, i * 0.1, Tf)
            states.append((jsys.state.name, port.state.name))
    finally:
        jpg.optimize_pose_graph = solve
    return dict(cfg=cfg, fed=fed, jsys=jsys, port=port, states=states,
                rec=rec)


@pytest.fixture(scope="module")
def circuit():
    true, fed = _circuit()
    cfg = SlamConfig(cam=Intrinsics(**CAM_KW),
                     orb=OrbParams(n_features=800, n_levels=4), **CFG_KW)
    world = synth.make_world(seed=3, device="cpu")
    images = [synth.render(world, cfg.cam, T).numpy() for T in true]
    return dict(run_circuit(cfg, images, fed), true=true)


def test_circuit_closes_the_loop_and_beats_the_priors(circuit):
    """Bars: the port closes >= 1 loop, as the JAX run does; its KF ATE
    (Sim3-aligned) is <= 1.2x the JAX run's + 0.02 and below the ATE of
    the drifted priors at the same keyframes; the frame states agree on
    >= 95% of frames; map and poses are finite."""
    jsys, port, true = circuit["jsys"], circuit["port"], circuit["true"]
    assert jsys.loop_closer.n_loops_closed >= 1
    assert port.loop_closer.n_loops_closed >= 1
    info = port.loop_closer.last_loop
    assert info["n_matched"] >= port.cfg.loop_min_total_matches
    ate_p = _kf_ate(port.store, true)
    ate_j = _kf_ate(jsys.store, true)
    ate_prior = _kf_ate(port.store, true, poses=circuit["fed"])
    assert ate_p <= 1.2 * ate_j + 0.02, (ate_p, ate_j)
    assert ate_p < ate_prior, (ate_p, ate_prior)
    same = np.mean([a == b for a, b in circuit["states"]])
    assert same >= 0.95, circuit["states"]
    assert sum(b == "OK" for _, b in circuit["states"]) > 0.7 * len(true)
    assert np.isfinite(port.map_points()).all()
    assert all(np.isfinite(kf.Tcw).all() for kf in port.store.kfs if kf.valid)
    assert port.place_rec.ready and len(port.place_rec.bow) > 0


def check_circuit_parity(circuit, true):
    """The end-to-end bars of a circuit that holds the port to the JAX
    run rather than to the priors: the port closes >= 1 loop if and
    only if the JAX run does; the frame states agree on >= 95% of
    frames; the port's KF ATE (Sim3-aligned) is <= 1.2x the JAX run's +
    0.02; > 0.7 of the frames OK; map and poses finite."""
    jsys, port = circuit["jsys"], circuit["port"]
    assert ((port.loop_closer.n_loops_closed >= 1)
            == (jsys.loop_closer.n_loops_closed >= 1))
    same = np.mean([a == b for a, b in circuit["states"]])
    assert same >= 0.95, circuit["states"]
    ate_p = _kf_ate(port.store, true)
    ate_j = _kf_ate(jsys.store, true)
    assert ate_p <= 1.2 * ate_j + 0.02, (ate_p, ate_j)
    assert sum(b == "OK" for _, b in circuit["states"]) > 0.7 * len(true)
    assert np.isfinite(port.map_points()).all()
    assert all(np.isfinite(kf.Tcw).all() for kf in port.store.kfs if kf.valid)


def _rotation(T):
    """The rotation of a pose block that the Sim3 writeback scaled by
    1/s (loop_closing._se3_from_sim3), by polar decomposition."""
    U, _, Vt = np.linalg.svd(T[:3, :3].astype(np.float64))
    return U @ Vt


def check_correct_loop(cfg, rec, monkeypatch, tol=2e-3):
    """test_correct_loop_from_one_state's run and bars on a recorded
    circuit (``run_circuit``'s ``rec``); ``tol``: the bar on keyframe
    translations and on the points."""
    monkeypatch.setattr(parallel, "local_devices",
                        lambda device: [torch.device("cpu")] * 8)
    store = interop.mapstore_from_numpy(**rec["before"], device="cpu")
    pr = PlaceRecognition(store, vocab=interop.vocabulary_from_numpy(
        **rec["vocab"]))
    lc = LoopCloser(cfg, store, place_rec=pr)
    kid, loop_kf, Scw, loop_mps, matched = rec["args"]
    lc._correct_loop(kid, loop_kf, Scw, list(loop_mps), dict(matched))
    check_map_matches(store, rec["after"], tol)


def check_map_matches(store, after, tol=2e-3):
    """check_correct_loop's bars on a port store against a JAX state
    (``interop.mapstore_state``): the same valid flags and loop edges,
    keyframe translations within ``tol`` and rotations within 1e-3 rad,
    >= 95% of the JAX run's valid points valid in both and >= 99% of
    those within ``tol``."""
    n_valid = 0
    for kf, ref in zip(store.kfs, after["keyframes"]):
        assert kf.valid == ref["valid"]
        if not kf.valid:
            continue
        n_valid += 1
        dt = np.abs(kf.Tcw[:3, 3] - ref["Tcw"][:3, 3]).max()
        dR = _rotation(kf.Tcw) @ _rotation(ref["Tcw"]).T
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        assert dt < tol and ang < 1e-3, (kf.kid, dt, ang)
        assert np.abs(kf.Tcw[:3, :3] - ref["Tcw"][:3, :3]).max() < 1e-3
        assert kf.loop_edges == ref["loop_edges"]
    assert n_valid > 10
    pv = np.asarray(store.mp_valid)
    jv = after["points"]["mp_valid"]
    n = min(len(pv), len(jv))
    both = pv[:n] & jv[:n]
    assert both.sum() >= 0.95 * jv.sum()
    d = np.abs(np.asarray(store.mp_pos)[:n][both]
               - after["points"]["mp_pos"][:n][both]).max(1)
    assert (d < tol).mean() >= 0.99, np.quantile(d, [0.5, 0.99])


def test_correct_loop_from_one_state(circuit, monkeypatch):
    """The port's _correct_loop (group correction, loop fuse, essential
    graph, global BA) on the JAX store and vocabulary as they stood at
    the JAX run's first loop, with its arguments.  The JAX test process
    has 8 CPU devices, so its global BA took the sharded branch; the
    port's takes its own sharded branch here, over 8 CPU shards
    (``parallel.local_devices`` patched).  Bars: KF translations within
    2e-3 (measured 6.4e-4), rotations within 1e-3 rad, >= 99% of the
    points valid in both within 2e-3 (measured 5.2e-4 at the 99th
    percentile)."""
    check_correct_loop(circuit["cfg"], circuit["rec"], monkeypatch)


def check_compute_sim3(cfg, rec, eigvec, monkeypatch):
    """test_compute_sim3_from_one_state's run and bars on a recorded
    circuit (``run_circuit``'s ``rec``); returns the port's result."""
    if eigvec == "jacobi":
        monkeypatch.setattr(thorn, "top_eigvec", lambda N: (
            thorn.sym4_top_eigvec(N.double()).to(N.dtype)))
    rec = rec["sim3"]
    store = interop.mapstore_from_numpy(**rec["store"], device="cpu")
    pr = PlaceRecognition(store, vocab=interop.vocabulary_from_numpy(
        **rec["vocab"]))
    lc = LoopCloser(cfg, store, place_rec=pr)
    lc._rng.bit_generator.state = copy.deepcopy(rec["rng"])
    found = lc._compute_sim3(*rec["args"])
    assert found is not None
    cand, Scw, loop_mps, matched = found
    j_cand, j_Scw, j_mps, j_matched = rec["found"]
    assert cand == j_cand
    assert loop_mps == j_mps
    St, Sj = torch.from_numpy(np.asarray(Scw)), torch.from_numpy(j_Scw)
    assert np.abs(Scw[4:] - j_Scw[4:]).max() < 2e-3
    assert np.abs(_np(tsim3.rot(St)) - _np(tsim3.rot(Sj))).max() < 1e-3
    same = sum(matched.get(f) == p for f, p in j_matched.items())
    assert same >= 0.95 * len(j_matched), (same, len(j_matched))
    return found


@pytest.mark.parametrize("eigvec", ["lapack", "jacobi"])
def test_compute_sim3_from_one_state(circuit, eigvec, monkeypatch):
    """The port's _compute_sim3 (the BoW match, the Sim3 RANSAC, the
    Sim3 search, OptimizeSim3, the Scw projection of the loop points) on
    the JAX store, vocabulary and RANSAC generator as they stood when
    the JAX run's first loop was found, with its candidates; Horn's
    eigenvector as the CPU takes it (LAPACK's ``eigh``) and as the card
    takes it (Jacobi sweeps in float64).  Bars: the same loop keyframe
    and loop points; Scw within 2e-3 in translation and 1e-3 in its
    rotation matrix (the bars of test_correct_loop_from_one_state);
    >= 95% of the JAX run's matched (feature, point) pairs."""
    check_compute_sim3(circuit["cfg"], circuit["rec"], eigvec, monkeypatch)
