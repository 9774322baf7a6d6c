"""The long run of tests/test_scale_run.py on the port, held to the JAX
package on the same frames.

Both packages run tests/test_scale_run.py's configuration field for
field (640x480, 800 ORB features, 4 levels, pose-prior mode, sequential
mapping, loop closing on) over its world (``make_world(seed=5,
scale=60.0, tex_size=2048)``) and its 500-frame circuit
(``loop_trajectory(500, radius=16.0)``), rendered once with the port's
renderer and fed to both; three frames of uniform noise from
``default_rng(0)`` force LOST and then relocalization.

- ``test_500_frame_sequence_against_jax`` (slow, as the JAX test is):
  the JAX test's bars on the port's run, and the port against the JAX
  run on the same frames.
- ``test_circuit_start_against_jax`` (tier-1): the first
  ``SHORT_FRAMES`` frames of the same circuit with the noise frames
  moved to ``SHORT_BLACKOUT``.
"""
import time

import numpy as np
import pytest
import torch

from orb_slam2_tpu.geom.camera import Intrinsics as JIntrinsics
from orb_slam2_tpu.ops.extractor import OrbParams as JOrbParams
from orb_slam2_tpu.pipeline import SlamConfig as JSlamConfig, System as JSystem
from orb_slam2_tpu_torch.geom.camera import Intrinsics
from orb_slam2_tpu_torch.ops.extractor import OrbParams
from orb_slam2_tpu_torch.pipeline.config import SlamConfig
from orb_slam2_tpu_torch.pipeline.system import System
from orb_slam2_tpu_torch.utils import synth

torch.set_num_threads(1)

CAM_KW = dict(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
CFG_KW = dict(fps=10.0, pose_prior=True, init_min_matches=60,
              init_min_triangulated=40, init_min_tracked_after_ba=60)
N_FRAMES = 500
BLACKOUT = range(250, 253)      # tests/test_scale_run.py:24
SHORT_FRAMES = 90
SHORT_BLACKOUT = range(60, 63)


def _run(n_frames: int, blackout: range) -> dict:
    """Both packages over the first ``n_frames`` of the 500-frame circuit
    with noise frames at ``blackout``; each call's wall timed alone."""
    cfg = SlamConfig(cam=Intrinsics(**CAM_KW),
                     orb=OrbParams(n_features=800, n_levels=4), **CFG_KW)
    jsys = JSystem(JSlamConfig(cam=JIntrinsics(**CAM_KW),
                               orb=JOrbParams(n_features=800, n_levels=4),
                               **CFG_KW), enable_loop_closing=True)
    port = System(cfg, enable_loop_closing=True, device="cpu")
    world = synth.make_world(seed=5, scale=60.0, tex_size=2048, device="cpu")
    poses = synth.loop_trajectory(N_FRAMES, radius=16.0)[:n_frames]
    rng = np.random.default_rng(0)
    states, walls = [], []
    for i, T in enumerate(poses):
        if i in blackout:
            img = rng.uniform(0, 255, (480, 640)).astype(np.float32)
        else:
            img = synth.render(world, cfg.cam, T).numpy()
        t0 = time.perf_counter()
        jsys.track_monocular_with_pose(img, i * 0.1, T)
        t1 = time.perf_counter()
        port.track_monocular_with_pose(img, i * 0.1, T)
        walls.append((t1 - t0, time.perf_counter() - t1))
        states.append((jsys.state.name, port.state.name))
    return dict(jsys=jsys, port=port, states=states,
                walls=np.asarray(walls), blackout=blackout)


def _summary(sys_, k: int, run: dict) -> dict:
    """One package's results: column ``k`` of the run's states and walls."""
    states = [s[k] for s in run["states"]]
    pts = sys_.map_points()
    return dict(
        states=states, n_ok=sum(s == "OK" for s in states),
        created=len(sys_.store.kfs), valid=sys_.store.n_valid_keyframes(),
        points=sys_.store.n_valid_points(),
        median_z=float(np.median(np.abs(pts[:, 2]))),
        loops=sys_.loop_closer.n_loops_closed,
        reloc=int(sys_.tracker.last_reloc_frame_id),
        walls=run["walls"][:, k])


def _lost_and_recovered(s: dict, blackout: range) -> bool:
    """The noise frames lost tracking (a noise frame, or the frame after
    them, not OK), a relocalization after the first of them brought it
    back, and the frame 10 after the noise is OK."""
    st = s["states"]
    lost = (any(st[i] != "OK" for i in blackout)
            or st[blackout[0] + 1] != "OK")
    return (lost and s["reloc"] >= blackout[0]
            and st[blackout[-1] + 10] == "OK")


def _agree(run: dict) -> float:
    return float(np.mean([a == b for a, b in run["states"]]))


def test_circuit_start_against_jax():
    """The first 90 frames of the circuit, noise at frames 60-62.  Bars:
    the noise is lost and relocalization recovers it in both packages;
    the frame states agree on >= 95% of frames; valid keyframes within
    one of the JAX run's and keyframes created within 20% of its count,
    culling fired in both or in neither; valid points within 10% of the
    JAX run's; the port's median |z| < 0.12.  The created count is held
    loosely: a keyframe decision near its threshold may fall a frame
    apart (tests/test_torch_slice.py), which shifts the cadence after it,
    and over 90 frames these shifts add up (19 against 22 created, 12
    against 12 valid, on the CPU)."""
    run = _run(SHORT_FRAMES, SHORT_BLACKOUT)
    j = _summary(run["jsys"], 0, run)
    p = _summary(run["port"], 1, run)
    info = {k: (j[k], p[k]) for k in ("n_ok", "created", "valid", "points",
                                      "median_z", "loops", "reloc")}
    assert _lost_and_recovered(j, SHORT_BLACKOUT), (info, j["states"])
    assert _lost_and_recovered(p, SHORT_BLACKOUT), (info, p["states"])
    assert _agree(run) >= 0.95, (info, run["states"])
    assert abs(p["valid"] - j["valid"]) <= 1, info
    assert abs(p["created"] - j["created"]) <= 0.2 * j["created"], info
    assert (p["valid"] < p["created"]) == (j["valid"] < j["created"]), info
    assert abs(p["points"] - j["points"]) <= 0.1 * j["points"], info
    assert p["median_z"] < 0.12, info


def _bar(port_value, jax_value, bar) -> bool:
    """The port meets ``bar`` (a predicate); where the JAX run itself
    misses it on this host, the port is held to the JAX run's value
    instead (no worse)."""
    if bar(jax_value):
        return bar(port_value)
    return port_value >= jax_value


@pytest.mark.slow
def test_500_frame_sequence_against_jax():
    """tests/test_scale_run.py's run on both packages.  Bars on the
    port's run, the JAX test's as written (where the JAX run misses one
    on this host, the port is held to the JAX run's value): > 90% of
    frames OK; the blackout loses tracking and relocalization recovers
    it; the last 100 frames OK; >= 40 keyframes created and culling
    fired; > 2,000 points; median |z| < 0.12; the late per-frame wall
    (median of the last 80 frames) <= 3x the early one (frames 60-139).
    Against the JAX run: the frame states agree on >= 95% of frames,
    the same number of loops closed, keyframes created and valid points
    each within 10%."""
    run = _run(N_FRAMES, BLACKOUT)
    j = _summary(run["jsys"], 0, run)
    p = _summary(run["port"], 1, run)
    ratio = {}
    for name, s in (("jax", j), ("port", p)):
        ratio[name] = (np.median(s["walls"][-80:])
                       / np.median(s["walls"][60:140]))
    info = {k: (j[k], p[k]) for k in ("n_ok", "created", "valid", "points",
                                      "median_z", "loops", "reloc")}
    info["wall_ratio"] = (ratio["jax"], ratio["port"])
    print("scale run (jax, port):", info)
    assert _bar(p["n_ok"], j["n_ok"], lambda v: v > 0.9 * N_FRAMES), info
    assert _lost_and_recovered(p, BLACKOUT), info
    assert _lost_and_recovered(j, BLACKOUT), info
    last = [sum(s == "OK" for s in x["states"][-100:]) for x in (p, j)]
    assert _bar(last[0], last[1], lambda v: v == 100), (last, info)
    assert _bar(p["created"], j["created"], lambda v: v >= 40), info
    assert p["valid"] < p["created"], info
    assert _bar(p["points"], j["points"], lambda v: v > 2000), info
    assert p["median_z"] < max(0.12, j["median_z"]), info
    assert ratio["port"] <= max(3.0, ratio["jax"]), info
    assert _agree(run) >= 0.95, info
    assert p["loops"] == j["loops"], info
    assert abs(p["created"] - j["created"]) <= 0.1 * j["created"], info
    assert abs(p["points"] - j["points"]) <= 0.1 * j["points"], info
