"""Estimated mode at bench width on the CPU, on ``chip_smoke.py``'s
path B world and circle (1920x1440, 4,000 features, 8 levels,
``bench_config()`` with ``pose_prior=False``, sequential mapping).  The
frames are rendered with the port's ``render``, sensor noise from
numpy's ``default_rng(seed)`` is added in float64 and clipped (as
tests/test_loop_upstream.py adds it), and the same float32 arrays are
fed to both packages.

The bootstrap of both packages over frames 0-3, with and without
noise: with the JAX test's 4 grey levels neither package initializes
(measured here, JAX / port: 97 / 101 bootstrap matches of 8,000
keypoints and 6 / 7 two-view inliers at frame 1), without noise both
initialize at frame 1 with H (506 / 503 and 471 / 473), and with 2 grey
levels (``chip_smoke.BEST_BENCH_NOISE``) both initialize at frame 1 and
track frames 2-3.

Where the noise limit lies (``slow``): the JAX package alone over
frames 0-3 initializes at frame 1 on each of seeds 11-14 with 1 and 2
grey levels, and on none with 3.  Where the two packages part over the
circuit (``slow``): over frames 0-29 from seed 11 with 2 grey levels
they track the same frames and take the same keyframe decisions up to
the first decision that falls within the spread of their tracked
inliers.

The JAX package as referee (``slow``): its run over the whole circuit
with 2 grey levels from seed 11 closes a free-scale loop and beats its
own run with loop closing off, and the port's loop stages are held to
that run from its own state at the loop keyframe, with the bars of
tests/test_torch_loop_estimated.py's 640x480 circuit.  That is the
configuration of ``chip_smoke.py``'s path B-est on the card."""
import dataclasses
import importlib.util
import os
import threading

import numpy as np
import pytest
import torch

from orb_slam2_tpu.geom import twoview as jtwoview
from orb_slam2_tpu.matching import search as jsearch
from orb_slam2_tpu.pipeline import System as JSystem
from orb_slam2_tpu_torch.geom import twoview as ttwoview
from orb_slam2_tpu_torch.matching import search as tsearch
from orb_slam2_tpu_torch.optim import pose_graph as tpg
from orb_slam2_tpu_torch.pipeline.system import System
from orb_slam2_tpu_torch.utils import synth

from test_torch_loop import _kf_ate, check_map_matches, check_sim3_found
from test_torch_loop_estimated import (Recording, _stage,
                                       check_loop_keyframe_result,
                                       jax_config, port_stages, run_jax)
from test_torch_loop_height import _gaps

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_NOISY = 4         # frames 0-3: three bootstrap attempts on the card
N_PART = 30         # frames 0-29: where the two packages' runs part
REFEREE_SEED = 11   # the JAX package closes its loop on this seed
# where the JAX run with 2 grey levels from seed 11 closes its loop: the
# frame, the keyframe and its loop keyframe
LOOP_FRAME, LOOP_KID, LOOP_KF = 103, 46, 5


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench_estimated_config(cs):
    """Path B-est's configuration: ``bench_config()`` in estimated mode,
    sequential tracking, a loop at least 6 keyframes after the last."""
    return dataclasses.replace(cs.bench_config(), pose_prior=False,
                               loop_min_kfs_since_last=6,
                               pipelined_tracking=False)


def noisy(images, sigma, seed):
    """``images`` with Gaussian noise of ``sigma`` grey levels from
    ``default_rng(seed)``, one draw a frame in order, added in float64
    and clipped to [0, 255]."""
    rng = np.random.default_rng(seed)
    for img in images:
        yield (np.clip(img + rng.normal(0, sigma, img.shape), 0, 255)
               .astype(np.float32))


def circuit_frames(cs, cfg, n):
    """The first ``n`` frames of path B's true circuit, rendered on the
    CPU without noise."""
    true, _ = cs.loop_circuit()
    world = cs.loop_world("cpu")
    return [synth.render(world, cfg.cam, T).numpy() for T in true[:n]]


@pytest.fixture(scope="module")
def clean_frames():
    cs = _chip_smoke()
    cfg = bench_estimated_config(cs)
    return cs, cfg, circuit_frames(cs, cfg, N_NOISY)


@pytest.fixture(scope="module")
def bench_frames(clean_frames):
    cs, cfg, clean = clean_frames
    return cfg, {
        11: list(noisy(clean, cs.BEST_NOISE, cs.BEST_SEEDS[0])),
        None: clean[:2],
        "sigma2-11": list(noisy(clean, cs.BEST_BENCH_NOISE, REFEREE_SEED))}


def _recorded(monkeypatch, mod, name, out):
    """Wraps ``mod.name`` to append what each bootstrap call found."""
    fn = getattr(mod, name)

    def call(*args, **kwargs):
        res = fn(*args, **kwargs)
        if name == "search_for_initialization":
            valid = res.host().valid if hasattr(res, "host") else res.valid
            out.append(("matches", int(np.asarray(valid).sum())))
        else:
            out.append(("two-view", bool(res.ok),
                        int(np.asarray(res.good).sum())))
        return res
    monkeypatch.setattr(mod, name, call)


def _run_both(jsys, port, frames):
    """Both packages' ``track_monocular`` over ``frames``, the port's on a
    second thread (they share no state); returns each frame's (JAX,
    port) states."""
    out = {}

    def run_port():
        try:
            out["port"] = []
            for i, img in enumerate(frames):
                port.track_monocular(img, i * 0.1)
                out["port"].append(port.state.name)
        except BaseException as e:      # raised again on this thread
            out["error"] = e
    thread = threading.Thread(target=run_port, name="port-run")
    thread.start()
    try:
        jstates = []
        for i, img in enumerate(frames):
            jsys.track_monocular(img, i * 0.1)
            jstates.append(jsys.state.name)
    finally:
        thread.join()
    if "error" in out:
        raise out["error"]
    return list(zip(jstates, out["port"]))


@pytest.mark.parametrize("noise", [11, None, "sigma2-11"])
def test_bench_width_bootstrap_as_jax(bench_frames, noise, monkeypatch):
    """Both packages' ``track_monocular`` on the first bench-width
    frames: with 4 grey levels of noise from seed 11 (``11``), without
    noise (``None``) and with 2 grey levels from seed 11
    (``sigma2-11``, path B-est's).  Bars: the same frame states, the
    same bootstrap attempts (a search and, with enough matches, a
    two-view solve) with match counts within 5% and the same two-view
    verdicts; with 4 grey levels no frame initializes in either package,
    without noise both initialize at frame 1, and with 2 grey levels
    both initialize at frame 1 and track frames 2-3 OK."""
    cfg, frames = bench_frames
    jsys = JSystem(jax_config(cfg), enable_loop_closing=False)
    port = System(cfg, enable_loop_closing=False, device="cpu")
    calls = {"jax": [], "port": []}
    for mod, name in ((jsearch, "search_for_initialization"),
                      (jtwoview, "initialize_two_view")):
        _recorded(monkeypatch, mod, name, calls["jax"])
    for mod, name in ((tsearch, "search_for_initialization"),
                      (ttwoview, "initialize_two_view")):
        _recorded(monkeypatch, mod, name, calls["port"])
    states = _run_both(jsys, port, frames[noise])
    assert all(j == p for j, p in states), states
    j, p = calls["jax"], calls["port"]
    assert [c[0] for c in j] == [c[0] for c in p], (j, p)
    for a, b in zip(j, p):
        if a[0] == "matches":
            assert abs(a[1] - b[1]) <= 0.05 * a[1], (j, p)
        else:
            assert a[1] == b[1], (j, p)
    if noise is None:
        assert [s for s, _ in states] == ["NOT_INITIALIZED", "OK"]
    elif noise == "sigma2-11":
        assert [s for s, _ in states] == ["NOT_INITIALIZED"] + ["OK"] * 3
        assert [c[0] for c in j] == ["matches", "two-view"] and j[1][1], j
    else:
        assert all(s == "NOT_INITIALIZED" for s, _ in states), states
        assert any(c[0] == "two-view" for c in j)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [11, 12, 13, 14])
@pytest.mark.parametrize("sigma", [1.0, 2.0, 3.0])
def test_bench_width_noise_limit_of_jax(clean_frames, sigma, seed,
                                        monkeypatch):
    """The JAX package alone over frames 0-3 with ``sigma`` grey levels
    of noise from ``seed``: the table that fixed path B-est's noise
    (``chip_smoke.BEST_BENCH_NOISE``) before any run of the port.  With
    1 and 2 grey levels it initializes at frame 1 (a successful
    two-view solve) and tracks frames 2-3 OK; with 3 it initializes on
    no frame.  Prints each bootstrap attempt (its matches; the two-view
    verdict and inliers).  About 45 s a case on one core."""
    cs, cfg, clean = clean_frames
    calls = []
    for mod, name in ((jsearch, "search_for_initialization"),
                      (jtwoview, "initialize_two_view")):
        _recorded(monkeypatch, mod, name, calls)
    jsys = JSystem(jax_config(cfg), enable_loop_closing=False)
    states = []
    for i, img in enumerate(noisy(clean, sigma, seed)):
        jsys.track_monocular(img, i * 0.1)
        states.append(jsys.state.name)
    print(f"sigma {sigma} seed {seed}: {', '.join(states)}; {calls}")
    if sigma <= cs.BEST_BENCH_NOISE:
        assert states == ["NOT_INITIALIZED"] + ["OK"] * 3, (states, calls)
        assert calls[1][:2] == ("two-view", True), calls
    else:
        assert all(s == "NOT_INITIALIZED" for s in states), (states, calls)


@pytest.mark.slow
def test_bench_width_keyframes_as_jax():
    """Both packages over path B-est's frames 0-29 (2 grey levels from
    seed 11, loop closing off, the port's run on a second thread), each
    frame's state, tracked inliers and keyframe decision.  Bars, up to
    and including the first frame where the two packages' keyframe
    decisions differ (the frame where their runs part; none is
    required): the same frame states, every frame after the bootstrap
    OK, and the tracked inliers within 5% of the JAX run's (the
    bootstrap matches' bar), so that the decision where they part is
    one that lies within the packages' spread.  Prints every frame of
    both runs and the parting.  About 10 minutes on an 8-core CPU."""
    cs = _chip_smoke()
    cfg = bench_estimated_config(cs)
    frames = list(noisy(circuit_frames(cs, cfg, N_PART),
                        cs.BEST_BENCH_NOISE, REFEREE_SEED))
    rows = {}

    def run(name, system):
        rows[name] = []
        for i, img in enumerate(frames):
            system.track_monocular(img, i * 0.1)
            fid = system.trajectory[-1][0]
            rows[name].append((system.state.name,
                               int(system.tracker.matches_inliers),
                               system.tracker.last_kf_frame_id == fid))
    port = System(cfg, enable_loop_closing=False, device="cpu")
    out = {}

    def run_port():
        try:
            run("port", port)
        except BaseException as e:      # raised again on this thread
            out["error"] = e
    thread = threading.Thread(target=run_port, name="port-run")
    thread.start()
    try:
        run("jax", JSystem(jax_config(cfg), enable_loop_closing=False))
    finally:
        thread.join()
    if "error" in out:
        raise out["error"]
    parting = None
    for i, (j, p) in enumerate(zip(rows["jax"], rows["port"])):
        print(f"frame {i:2d}: JAX {j[0]} {j[1]} inliers, keyframe {j[2]}"
              f" | port {p[0]} {p[1]} inliers, keyframe {p[2]}")
        if parting is None:
            assert j[0] == p[0] and (i == 0 or j[0] == "OK"), (i, j, p)
            assert abs(j[1] - p[1]) <= 0.05 * j[1], (i, j, p)
            if j[2] != p[2]:
                parting = i
    print(f"the runs part at frame {parting}")


@pytest.mark.slow
def test_bench_width_loop_as_jax():
    """The JAX package as referee at bench width: its run over path B's
    whole circuit (100 frames a lap, radius 20, height 12, the first 14
    frames again; 114 frames) in path B-est's configuration with 2 grey
    levels of noise from seed 11, with loop closing on and off (the two
    runs on two threads).  Bars on the JAX runs: the loop closes (its
    frame and keyframes, ``n_matched >= loop_min_total_matches``, a
    finite positive scale that is not 1), more than 0.7 of the frames
    OK, the keyframe ATE (Sim3-aligned) below the loop-off run's.  Then
    the port's loop stages from that run's own states, with the 640x480
    circuit's bars (tests/test_torch_loop_estimated.py): the free-scale
    ``_compute_sim3`` (Horn's eigenvector by LAPACK and by the card's
    Jacobi sweeps; the scale within 1e-3), ``_correct_loop`` with
    s != 1, the 7-DoF essential graph (its cost compared in float64,
    ``check_essential_graph_exact``), ``run_global_ba`` and the loop
    keyframe as a whole, each on a third thread as soon as the JAX run
    has recorded the state it starts from (``port_stages``).  About 30
    minutes on an 8-core CPU: the JAX runs take most of it."""
    cs = _chip_smoke()
    cfg = bench_estimated_config(cs)
    true, _ = cs.loop_circuit()
    world = cs.loop_world("cpu")
    images = list(noisy((synth.render(world, cfg.cam, T).numpy()
                         for T in true), cs.BEST_BENCH_NOISE, REFEREE_SEED))
    rec, off, stages = Recording(), {}, {}

    def run_off():
        try:
            off["run"] = run_jax(cfg, images, loop=False)
        except BaseException as e:      # raised again on this thread
            off["error"] = e
    threads = [threading.Thread(target=run_off, name="jax-loop-off"),
               threading.Thread(target=lambda: stages.update(
                   port_stages(cfg, rec)), name="port-stages")]
    for t in threads:
        t.start()
    try:
        on = run_jax(cfg, images, rec=rec)
    finally:
        rec.finish()            # a failed run leaves no stage waiting
        for t in threads:
            t.join()
    if "error" in off:
        raise off["error"]
    off = off["run"]
    info = on["last_loop"]
    assert on["n_loops"] >= 1 and "kf" in rec, on["states"]
    frame = on["store"].kfs[info["kid"]].frame.frame_id
    assert (frame, info["kid"], info["loop_kf"]) == (
        LOOP_FRAME, LOOP_KID, LOOP_KF), (frame, info)
    assert rec["kf"]["kid"] == LOOP_KID
    assert info["n_matched"] >= cfg.loop_min_total_matches, info
    assert np.isfinite(info["scale"]) and info["scale"] > 0
    assert abs(info["scale"] - 1.0) > 1e-3, info["scale"]
    for run in (on, off):
        n_ok = run["states"].count("OK")
        assert n_ok > 0.7 * len(true), run["states"]
    ate_on, ate_off = _kf_ate(on["store"], true), _kf_ate(off["store"], true)
    for name, run, ate in (("on", on, ate_on), ("off", off, ate_off)):
        print(f"JAX, loop closing {name}: {run['states'].count('OK')}/"
              f"{len(true)} OK, {run['store'].n_valid_keyframes()} "
              f"keyframes, KF ATE {ate:.6f}")
    print(f"JAX loop: frame {frame}, keyframe {info['kid']} to "
          f"{info['loop_kf']}, {info['n_matched']} matched, scale "
          f"{info['scale']:.6f}")
    assert ate_on < ate_off, (ate_on, ate_off)

    for eigvec in ("lapack", "jacobi"):
        found = check_sim3_found(_stage(stages, f"sim3_{eigvec}"), rec)
        s, sj = float(found[1][7]), float(rec["sim3"]["found"][1][7])
        assert abs(s - sj) < 1e-3, (eigvec, s, sj)
    kid, loop_kf, Scw = rec["args"][:3]
    assert (kid, loop_kf) == (LOOP_KID, LOOP_KF)
    assert abs(float(Scw[7]) - 1.0) > 1e-3
    check_map_matches(_stage(stages, "correct_loop"), rec["after"])
    pg = rec["pose_graph"]
    assert np.abs(pg["args"][0][:, 7] - 1.0).max() > 1e-3
    check_essential_graph_exact(pg, *_stage(stages, "essential_graph"))
    check_map_matches(_stage(stages, "global_ba"), rec["gba"]["after"])
    got = check_loop_keyframe_result(rec["kf"], _stage(stages,
                                                       "loop_keyframe"))
    assert (got["kid"], got["loop_kf"]) == (LOOP_KID, LOOP_KF)


def _cost64(sims, pg):
    """The essential graph's cost at ``sims`` in float64, by the port's
    cost function, on ``pg``'s edges."""
    _, ei, ej, meas, w, _ = (torch.from_numpy(np.asarray(a))
                             for a in pg["args"])
    return float(tpg._pg_cost(torch.from_numpy(np.asarray(sims)).double(),
                              ei, ej, meas.double(), w.double()))


def check_essential_graph_exact(pg, rt, sims_cg):
    """``check_essential_graph_solves``' bars with the costs compared
    exactly: both solutions' costs taken in float64 by one function
    within 1e-5 of each other (relative), rotations within 1e-3,
    translations and scales within 2x the JAX solve's own move at
    ``cg_iters=100``.  That bar compares each package's float32 cost of
    its own solution; on this circuit's converged graph (cost 1.7e-4,
    poses 20 units out) each float32 cost is 3.2-3.7e-4 from the
    float64 one, and the two are 4.4e-5 apart on poses within 8.3e-7
    of each other (measured on seed 11, whose float64 costs are 3.9e-7
    apart, the port's the lower)."""
    c_port, c_jax = _cost64(rt.sims, pg), _cost64(pg["sims"], pg)
    assert abs(c_port - c_jax) <= 1e-5 * c_jax, (c_port, c_jax)
    dt, dr = _gaps(rt.sims, pg["sims"])
    own, _ = _gaps(sims_cg, pg["sims"])
    assert dr < 1e-3 and dt <= 2 * own, (dt, dr, own)
