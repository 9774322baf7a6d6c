"""The drifted loop over non-planar ground (tests/test_loop_proof.py's
``test_loop_closure_fires_on_nonplanar_world``) in the port against the
JAX package: end to end, and loop correction and the Sim3 search from
the JAX run's state at its first loop.

The construction is the JAX test's as it is: ``make_height_world(seed=3,
height_amp=1.5)``, the 40-frame circle of radius 6 plus its first 14
frames again, priors drifting 0.02 units a frame, 640x480, 800 ORB
features, 4 levels, sequential mapping, loop closing on.  The frames are
rendered once with the port's ``render_height`` (within 0.034 grey
levels of the JAX package's, tests/test_torch_synth.py) and fed to both
packages.

On these frames both runs close one loop near frame 40 and lose every
frame after it: the correction moves the map onto the true circle while
the priors keep drifting, so the trusted-pose gate rejects the old
points.  The JAX run's KF ATE there is above the priors' at the same
keyframes; its own test asks only for the loop, > 0.7 of the frames OK,
a finite map and std(map z) > 0.2, so the port is held to the JAX run,
not to the priors."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.optim import pose_graph as jpg
from orb_slam2_tpu_torch.geom import sim3 as tsim3
from orb_slam2_tpu_torch.geom.camera import Intrinsics
from orb_slam2_tpu_torch.ops.extractor import OrbParams
from orb_slam2_tpu_torch.optim import pose_graph as tpg
from orb_slam2_tpu_torch.pipeline.config import SlamConfig
from orb_slam2_tpu_torch.utils import synth

from test_torch_loop import (CAM_KW, CFG_KW, check_circuit_parity,
                             check_compute_sim3, check_correct_loop,
                             run_circuit)

torch.set_num_threads(1)

N_LAP, N_REVISIT, DRIFT, RADIUS = 40, 14, 0.02, 6.0
Z_STD = 0.2          # the JAX test's bar: the map is not a plane


def drifted_poses():
    """tests/test_loop_proof.py's ``_drifted_poses``: the true circuit
    renders the images, priors drifting 0.02 units a frame in x and half
    of it in y are fed in."""
    true = synth.loop_trajectory(N_LAP, radius=RADIUS)
    true = true + true[:N_REVISIT]
    fed = []
    for t, Tcw in enumerate(true):
        D = np.eye(4, dtype=np.float32)
        D[:3, 3] = [DRIFT * t, 0.5 * DRIFT * t, 0.0]
        fed.append((Tcw @ np.linalg.inv(D)).astype(np.float32))
    return true, fed


def circuit_config():
    return SlamConfig(cam=Intrinsics(**CAM_KW),
                      orb=OrbParams(n_features=800, n_levels=4), **CFG_KW)


@pytest.fixture(scope="module")
def circuit():
    true, fed = drifted_poses()
    cfg = circuit_config()
    world = synth.make_height_world(seed=3, height_amp=1.5, device="cpu")
    images = [synth.render_height(world, cfg.cam, T).numpy() for T in true]
    return dict(run_circuit(cfg, images, fed), true=true)


def test_height_circuit_closes_the_loop_as_the_jax_run(circuit):
    """Bars: the JAX test's on both runs (>= 1 loop closed, > 0.7 of the
    frames OK, a finite map, std(map z) > 0.2) and the port held to the
    JAX run (``check_circuit_parity``: a loop if and only if the JAX run
    closes one, frame states equal on >= 95% of frames, KF ATE <= 1.2x
    the JAX run's + 0.02)."""
    jsys, port, true = circuit["jsys"], circuit["port"], circuit["true"]
    for s in (jsys, port):
        ok = sum(st.name == "OK" for (_, _, _, st) in s.trajectory)
        assert ok > 0.7 * len(true), ok
        assert s.loop_closer.n_loops_closed >= 1
        pts = s.map_points()
        assert np.isfinite(pts).all()
        assert np.std(pts[:, 2]) > Z_STD, np.std(pts[:, 2])
    check_circuit_parity(circuit, true)


def _gaps(a, b):
    """Largest translation and rotation-matrix gaps of two Sim3 sets."""
    a, b = (torch.as_tensor(np.asarray(x)) for x in (a, b))
    return (float((a[:, 4:] - b[:, 4:]).abs().max()),
            float((tsim3.rot(a) - tsim3.rot(b)).abs().max()))


def test_essential_graph_from_one_state(circuit):
    """The port's essential-graph solve of the JAX run's first problem
    (32 keyframes, 139 edges) against the JAX solve.  Over the height
    field the problem has a valley flat to float32: the JAX solve itself
    moves its poses 1.2e-3 when its CG takes 100 iterations instead of
    30, at the same cost.  Bars: the port's cost within 1e-5 of the JAX
    solve's (relative; measured 4.4e-7), its rotations within 1e-3, its
    translations within 2x the JAX solve's own move (measured 1.4e-3
    against 1.2e-3)."""
    check_essential_graph(circuit["rec"]["pose_graph"])


def check_essential_graph(pg):
    """test_essential_graph_from_one_state's run and bars on a recorded
    essential-graph problem and its JAX solution (``run_circuit``'s
    ``rec["pose_graph"]``): the port's cost within 1e-5 of the JAX
    solve's (relative), its rotations within 1e-3, its translations and
    scales within 2x the JAX solve's own move when its CG takes 100
    iterations."""
    check_essential_graph_solves(pg, *essential_graph_solves(pg))


def essential_graph_solves(pg):
    """check_essential_graph's solves: the port's of the recorded problem,
    and the JAX package's with 100 CG iterations (its sims as numpy)."""
    args, kw = pg["args"], pg["kwargs"]
    rj_cg = jpg.optimize_pose_graph(*[jnp.asarray(a) for a in args],
                                    **dict(kw, cg_iters=100))
    rt = tpg.optimize_pose_graph(*[torch.from_numpy(a) for a in args], **kw)
    return rt, np.asarray(rj_cg.sims)


def check_essential_graph_solves(pg, rt, sims_cg):
    """check_essential_graph's bars on ``essential_graph_solves``."""
    assert abs(float(rt.final_cost) - pg["cost"]) <= 1e-5 * pg["cost"]
    dt, dr = _gaps(rt.sims, pg["sims"])
    own, _ = _gaps(sims_cg, pg["sims"])
    assert dr < 1e-3 and dt <= 2 * own, (dt, dr, own)


def test_correct_loop_from_one_state(circuit, monkeypatch):
    """The port's _correct_loop on the JAX store and vocabulary as they
    stood at the JAX run's first loop over the height field, with its
    arguments and test_torch_loop.py's bars (rotations within 1e-3 rad,
    the same loop edges and valid flags, >= 99% of the points valid in
    both), but translations and points within 5e-3, not 2e-3: up to
    the essential graph both runs agree within 1.5e-6, and from it on
    they part along the essential graph's flat valley
    (test_essential_graph_from_one_state); measured 2.3e-3 on the
    keyframes, 3.5e-3 at the points' 99th percentile."""
    check_correct_loop(circuit["cfg"], circuit["rec"], monkeypatch,
                       tol=5e-3)


@pytest.mark.parametrize("eigvec", ["lapack", "jacobi"])
def test_compute_sim3_from_one_state(circuit, eigvec, monkeypatch):
    """The port's _compute_sim3 on the JAX state that found the first
    loop over the height field, Horn's eigenvector by LAPACK and by the
    card's Jacobi sweeps; test_torch_loop.py's bars (the same loop
    keyframe and loop points, Scw within 2e-3 / 1e-3, >= 95% of the
    matched pairs)."""
    check_compute_sim3(circuit["cfg"], circuit["rec"], eigvec, monkeypatch)
