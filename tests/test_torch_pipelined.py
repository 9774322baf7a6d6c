"""Pipelined tracking, bench.py's tracking configuration: the pose-prior
System of both packages with ``pipelined_tracking`` at depth 2 and 3,
flushed at two window boundaries; the device recurrence
(``_track_prior_chain``) of the port against the JAX package's from one
recorded state, including a bound set that overflows its padded length;
and the extraction prefetch (``FrameFactory.start``).

Size: tests/test_pipeline.py's (640x480, 800 features, 4 levels), 26
frames of its aerial sweep, rendered once with the port's renderer and
fed to both packages."""
import numpy as np
import pytest
import torch

import orb_slam2_tpu.pipeline.tracking as jtracking
from orb_slam2_tpu.geom.camera import Intrinsics as JIntrinsics
from orb_slam2_tpu.ops.extractor import OrbParams as JOrbParams
from orb_slam2_tpu.pipeline import SlamConfig as JSlamConfig, System as JSystem
import orb_slam2_tpu_torch.pipeline.tracking as ptracking
from orb_slam2_tpu_torch.geom.camera import Intrinsics
from orb_slam2_tpu_torch.models.frame import FrameFactory
from orb_slam2_tpu_torch.ops.extractor import OrbParams
from orb_slam2_tpu_torch.pipeline.config import SlamConfig
from orb_slam2_tpu_torch.pipeline.system import System
from orb_slam2_tpu_torch.utils import synth

torch.set_num_threads(1)

N_FRAMES = 26
FLUSH_AT = (14, 24)   # window boundaries (test_pipeline's flush test)
RECORD_CHAIN = 3      # the chain step whose inputs the one-state test reuses
CAM_KW = dict(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
CFG_KW = dict(fps=10.0, pose_prior=True, init_min_matches=60,
              init_min_triangulated=40, init_min_tracked_after_ba=60,
              pipelined_tracking=True)


@pytest.fixture(scope="module")
def images():
    world = synth.make_world(seed=3, device="cpu")
    poses = synth.aerial_trajectory(N_FRAMES, speed=0.3)
    return poses, [synth.render(world, Intrinsics(**CAM_KW), T).numpy()
                   for T in poses]


@pytest.fixture(scope="module", params=[2, 3], ids=["depth2", "depth3"])
def runs(request, images):
    """Both packages over the sweep at one pipeline depth.  The JAX
    package's chain steps are recorded (inputs and outputs, as numpy);
    the port's are counted."""
    depth = request.param
    poses, imgs = images
    jsys = JSystem(JSlamConfig(cam=JIntrinsics(**CAM_KW),
                               orb=JOrbParams(n_features=800, n_levels=4),
                               pipeline_depth=depth, **CFG_KW),
                   enable_loop_closing=False)
    port = System(SlamConfig(cam=Intrinsics(**CAM_KW),
                             orb=OrbParams(n_features=800, n_levels=4),
                             pipeline_depth=depth, **CFG_KW),
                  enable_loop_closing=False, device="cpu")
    jchain, n_port_chain = [], [0]
    jorig, porig = jtracking._track_prior_chain, ptracking._track_prior_chain

    def jrec(*args):
        out = jorig(*args)
        if len(jchain) < RECORD_CHAIN:
            jchain.append(dict(args=[np.array(a) if hasattr(a, "shape")
                                     else a for a in args],
                               out=[np.array(o) for o in out]))
        return out

    def pcount(*args):
        n_port_chain[0] += 1
        return porig(*args)

    jtracking._track_prior_chain, ptracking._track_prior_chain = jrec, pcount
    per, pending_after_flush = [], []
    try:
        for i, T in enumerate(poses):
            for s in (jsys, port):
                s.track_monocular_with_pose(imgs[i], i * 0.1, T)
                if i in FLUSH_AT:
                    s.flush_tracking()
                    pending_after_flush.append(len(s.tracker._pending))
            per.append(dict(
                jstate=jsys.state.name, pstate=port.state.name,
                jinl=jsys.tracker.matches_inliers,
                pinl=port.tracker.matches_inliers,
                jkf=jsys.store.n_valid_keyframes(),
                pkf=port.store.n_valid_keyframes()))
        for s in (jsys, port):
            s.flush_tracking()
            pending_after_flush.append(len(s.tracker._pending))
    finally:
        jtracking._track_prior_chain = jorig
        ptracking._track_prior_chain = porig
    return dict(jsys=jsys, port=port, per=per, jchain=jchain,
                n_port_chain=n_port_chain[0],
                pending_after_flush=pending_after_flush)


def test_states_identical_and_pipeline_drained(runs):
    """Bars: every frame has the same (lagging) tracking state in both
    packages, nearly all OK; nothing in flight after any flush; the port
    ran its device recurrence."""
    assert [p["pstate"] for p in runs["per"]] == \
        [p["jstate"] for p in runs["per"]]
    assert sum(p["pstate"] == "OK" for p in runs["per"]) >= N_FRAMES - 2
    assert runs["pending_after_flush"] == [0] * (2 * len(FLUSH_AT) + 2)
    assert runs["n_port_chain"] >= N_FRAMES // 2


def test_inliers_and_keyframes_within_bars(runs):
    """Bars (test_torch_slice's): per-frame inliers within 15% of the
    reference where it has any; keyframe counts within one."""
    for i, p in enumerate(runs["per"]):
        if p["jinl"] > 0:
            assert abs(p["pinl"] - p["jinl"]) <= 0.15 * p["jinl"], (i, p)
        assert abs(p["pkf"] - p["jkf"]) <= 1, (i, p)


def test_map_within_bars(runs):
    """Bars: final valid map points within 10% of the reference, both
    maps on the plane z = 0 (median |z| < 0.08)."""
    pj = runs["jsys"].map_points()
    pp = runs["port"].map_points()
    assert abs(len(pp) - len(pj)) <= 0.1 * len(pj), (len(pp), len(pj))
    assert len(pp) > 200
    assert np.median(np.abs(pp[:, 2])) < 0.08
    assert np.median(np.abs(pj[:, 2])) < 0.08


# ----------------------------------------------------------------------
# the device recurrence from one recorded state
# ----------------------------------------------------------------------
def _port_args(args):
    """The JAX chain call's arguments as the port takes them: int16
    feature rows widened (& 0xFFFF), uint32 descriptors as int32 bits."""
    out = []
    for i, a in enumerate(args):
        if isinstance(a, np.ndarray):
            if a.dtype == np.int16:
                a = a.astype(np.int32) & 0xFFFF
            elif a.dtype == np.uint32:
                a = a.view(np.int32)
            out.append(torch.as_tensor(a))
        else:
            out.append(a)
    return out


def _expected_rows(args, L):
    """The chain prologue by hand: the kept (pid, feature) pairs in row
    order, frame-to-frame matches first."""
    pid_all = np.concatenate([args[7][:L], args[8]]).astype(np.int64)
    row_all = np.concatenate([args[9][:L].astype(np.int64) & 0xFFFF,
                              args[10].astype(np.int64) & 0xFFFF])
    kept = np.concatenate([args[11][:L], args[12]])
    return pid_all[kept], row_all[kept]


@pytest.fixture(scope="module")
def chain_state(runs):
    if not runs["jchain"]:
        pytest.fail("the JAX run dispatched no chain step")
    return runs["jchain"][-1]


def test_chain_step_matches_jax(chain_state):
    """The port's chain step on the recorded inputs of a JAX chain step.
    Bars: the rebuilt bound rows (the step's last output) equal, integer
    for integer; the searches' outputs agree on >= 99.5% of rows (their
    projections are float products whose last-bit rounding may differ,
    test_torch_slice's bar)."""
    args, jout = chain_state["args"], chain_state["out"]
    pout = [t.numpy() for t in ptracking._track_prior_chain(
        *_port_args(args))]
    np.testing.assert_array_equal(pout[6], jout[8])
    pids, _ = _expected_rows(args, len(args[7]))
    assert len(pids) <= len(args[7])      # no overflow in the recording
    np.testing.assert_array_equal(pout[6][:len(pids)], pids)
    L, C = len(args[7]), len(args[8])
    unpack = lambda a, n: np.unpackbits(a)[:n].astype(bool)  # noqa: E731
    for mine, theirs in ((pout[0], jout[0].astype(np.int64) & 0xFFFF),
                         (pout[1], unpack(jout[1], L)),
                         (pout[2], jout[6]),
                         (pout[3], unpack(jout[3], C)),
                         (pout[4], jout[4].astype(np.int64) & 0xFFFF),
                         (pout[5], jout[7])):
        assert (mine == theirs).mean() >= 0.995


def test_chain_overflow_takes_the_first_rows(chain_state):
    """The recorded step with its bound vectors cut to L = 256 rows, so
    more pairs are kept than fit.  The port takes the first L kept
    pairs, as the host mirror assumes.  The JAX package scatters every
    pair past L - 1 onto slot L - 1 and, on the CPU, the last one wins:
    its slot L - 1 holds the last kept pair, which its host mirror
    attributes to pair L - 1.  Bars: every other slot equal, integer for
    integer; slot L - 1 as each rule says."""
    args = list(chain_state["args"])
    L = 256
    for i in (7, 9, 11):          # bound pid rows, feature rows, gate
        args[i] = args[i][:L]
    pids, rows = _expected_rows(args, L)
    assert len(pids) > L
    jout = [np.array(o) for o in jtracking._track_prior_chain(*args)]
    pbound, plrows = ptracking._chain_rows(*_port_args(args)[7:13])
    pbound, plrows = pbound.numpy(), plrows.numpy()
    np.testing.assert_array_equal(pbound[:L - 1], jout[8][:L - 1])
    np.testing.assert_array_equal(pbound, pids[:L])
    np.testing.assert_array_equal(plrows, rows[:L])
    assert jout[8][L - 1] == pids[-1]      # the JAX package on the CPU
    pout = [t.numpy() for t in ptracking._track_prior_chain(
        *_port_args(args))]
    np.testing.assert_array_equal(pout[6], pbound)


def test_started_extraction_equals_make(images):
    """``make(started=start(image))`` builds the frame ``make(image)``
    builds; a start for the other feature budget (init_mode) is
    extracted again."""
    _, imgs = images
    fac = FrameFactory(Intrinsics(**CAM_KW),
                       OrbParams(n_features=800, n_levels=4), device="cpu")
    for init_mode, started_mode in ((False, False), (True, True),
                                    (False, True)):
        a = fac.make(imgs[3], init_mode=init_mode,
                     started=fac.start(imgs[3], init_mode=started_mode))
        b = fac.make(imgs[3], init_mode=init_mode)
        assert a.n == b.n
        for name in ("xy", "xy_raw", "response", "angle", "octave", "desc",
                     "valid"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name))
