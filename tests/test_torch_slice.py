"""The ported slice as a whole: the pose-prior System of both packages on
the same frames, and the port's tracking step, reference-keyframe
fallback, local mapping and relocalization started from the JAX
package's own state.

Size: tests/test_pipeline.py's (640x480, 800 features, 4 levels), 15
frames of its aerial sweep, rendered once with the port's renderer and
fed to both packages."""
import copy

import numpy as np
import pytest
import torch

from orb_slam2_tpu.geom.camera import Intrinsics as JIntrinsics
from orb_slam2_tpu.ops.extractor import OrbParams as JOrbParams
from orb_slam2_tpu.pipeline import SlamConfig as JSlamConfig, System as JSystem
from orb_slam2_tpu_torch import interop
from orb_slam2_tpu_torch.geom.camera import Intrinsics
from orb_slam2_tpu_torch.models.frame import FrameFactory
from orb_slam2_tpu_torch.ops.extractor import OrbParams
from orb_slam2_tpu_torch.pipeline.config import SlamConfig
from orb_slam2_tpu_torch.pipeline.local_mapping import LocalMapper
from orb_slam2_tpu_torch.pipeline.place_recognition import PlaceRecognition
from orb_slam2_tpu_torch.pipeline.relocalization import Relocalizer
from orb_slam2_tpu_torch.pipeline.system import System
from orb_slam2_tpu_torch.pipeline.tracking import Tracker, TrackState
from orb_slam2_tpu_torch.utils import ply, synth

torch.set_num_threads(1)

N_FRAMES = 15
STEP_FRAME = 7        # a steady-state frame for the one-state tracking test
RELOC_POSE = 10       # the mapped pose a LOST frame is shown again
CAM_KW = dict(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
CFG_KW = dict(fps=10.0, pose_prior=True, init_min_matches=60,
              init_min_triangulated=40, init_min_tracked_after_ba=60)


def port_config():
    return SlamConfig(cam=Intrinsics(**CAM_KW),
                      orb=OrbParams(n_features=800, n_levels=4), **CFG_KW)


def _frame_fields(f):
    return {k: (np.array(getattr(f, k)) if k not in ("frame_id", "timestamp")
                else getattr(f, k)) for k in interop.FRAME_FIELDS}


@pytest.fixture(scope="module")
def runs():
    cfg = port_config()
    world = synth.make_world(seed=3, device="cpu")
    poses = synth.aerial_trajectory(N_FRAMES, speed=0.3)
    images = [synth.render(world, cfg.cam, T).numpy() for T in poses]

    jsys = JSystem(JSlamConfig(cam=JIntrinsics(**CAM_KW),
                               orb=JOrbParams(n_features=800, n_levels=4),
                               **CFG_KW),
                   enable_loop_closing=False)
    rec = dict(frames={}, mapping=None)
    tr = jsys.tracker

    orig_make = tr.factory.make

    def make(*a, **k):
        f = orig_make(*a, **k)
        rec["frames"][f.frame_id] = _frame_fields(f)   # mp_ids all -1 here
        return f
    tr.factory.make = make

    orig_verdict = tr._fused_verdict

    def verdict(frame, out, p=None):
        if frame.frame_id == STEP_FRAME:
            # the reference-KF fallback from this state, on a copy of
            # the frame (the vocabulary exists by now, so it blocks the
            # descriptor match by node)
            fc = copy.copy(frame)
            fc.__dict__.pop("bow_nodes", None)
            fc.mp_ids = np.full_like(frame.mp_ids, -1)
            rec["refkf"] = dict(ok=tr._track_reference_kf(fc),
                                mp_ids=fc.mp_ids.copy(),
                                vocab=jsys.place_rec.ready)
        v = orig_verdict(frame, out, p)
        if frame.frame_id == STEP_FRAME:
            rec["step_after"] = dict(
                verdict=v, mp_ids=frame.mp_ids.copy(),
                inliers=tr.matches_inliers,
                n_visible=np.array(jsys.store.mp_n_visible),
                n_found=np.array(jsys.store.mp_n_found))
        return v
    tr._fused_verdict = verdict

    orig_process = jsys.mapper.process_keyframe

    def process(kid, queue_pressure=False):
        first = rec["mapping"] is None and kid >= 2
        if first:
            rec["mapping"] = dict(
                kid=kid, before=interop.mapstore_state(jsys.store),
                recent=list(jsys.mapper.recent_points))
        orig_process(kid, queue_pressure)
        if first:
            rec["mapping"]["after"] = interop.mapstore_state(jsys.store)
    jsys.mapper.process_keyframe = process
    jsys._on_new_keyframe = lambda kid: jsys.mapper.process_keyframe(kid)

    port = System(cfg, enable_loop_closing=False, device="cpu")
    per = []
    for i, T in enumerate(poses):
        if i == STEP_FRAME:
            rec["step_before"] = dict(
                store=interop.mapstore_state(jsys.store),
                last=_frame_fields(tr.last_frame), ref_kf=tr.ref_kf,
                last_kf_frame_id=tr.last_kf_frame_id)
        jsys.track_monocular_with_pose(images[i], i * 0.1, T)
        port.track_monocular_with_pose(images[i], i * 0.1, T)
        per.append(dict(
            jstate=jsys.state.name, pstate=port.state.name,
            jinl=jsys.tracker.matches_inliers,
            pinl=port.tracker.matches_inliers,
            jkf=jsys.store.n_valid_keyframes(),
            pkf=port.store.n_valid_keyframes()))
    v = jsys.place_rec.vocab
    rec["vocab"] = dict(k=v.k, levels=v.levels, centers=v.centers,
                        idf=v.idf, node_level=v.node_level)
    return dict(cfg=cfg, jsys=jsys, port=port, per=per, rec=rec,
                poses=poses, images=images)


def test_states_identical(runs):
    """Bar: every frame has the same tracking state in both packages."""
    assert [p["pstate"] for p in runs["per"]] == \
        [p["jstate"] for p in runs["per"]]
    assert sum(p["pstate"] == "OK" for p in runs["per"]) >= N_FRAMES - 1


def test_inliers_and_keyframes_within_bars(runs):
    """Bars: per-frame inliers within 15% of the reference after init;
    keyframe counts within one at every frame.  Extraction agrees to
    float32 rounding (test_torch_extractor), so a keyframe decision
    near its threshold may fall one frame apart."""
    for i, p in enumerate(runs["per"]):
        if p["jinl"] > 0:
            assert abs(p["pinl"] - p["jinl"]) <= 0.15 * p["jinl"], (i, p)
        assert abs(p["pkf"] - p["jkf"]) <= 1, (i, p)


def test_map_within_bars(runs):
    """Bars: final valid map points within 10% of the reference; both
    maps on the plane z = 0 (median |z| < 0.08, test_pipeline's bar)."""
    pj = runs["jsys"].map_points()
    pp = runs["port"].map_points()
    assert abs(len(pp) - len(pj)) <= 0.1 * len(pj), (len(pp), len(pj))
    assert len(pp) > 200
    assert np.median(np.abs(pp[:, 2])) < 0.08
    assert np.median(np.abs(pj[:, 2])) < 0.08


def test_reference_fallback_with_vocabulary_from_one_state(runs):
    """TrackWithReferenceKF with a trained vocabulary, from the JAX
    state just before STEP_FRAME: both packages block the descriptor
    match by vocabulary node (the port with the JAX vocabulary).  Bar:
    the same verdict and the same binding on >= 99% of the features
    that either package bound."""
    ref = runs["rec"]["refkf"]
    assert ref["vocab"]
    tracker, frame = _tracker_before_step(runs)
    tracker.relocalize = Relocalizer(runs["cfg"], tracker.store,
                                     PlaceRecognition(tracker.store, vocab=(
                                         interop.vocabulary_from_numpy(
                                             **runs["rec"]["vocab"]))))
    assert tracker._track_reference_kf(frame) == ref["ok"]
    either = (frame.mp_ids >= 0) | (ref["mp_ids"] >= 0)
    assert either.sum() > 50
    assert (frame.mp_ids[either] == ref["mp_ids"][either]).mean() >= 0.99


def _tracker_before_step(runs):
    """A port Tracker in the JAX state just before STEP_FRAME, and the
    JAX-extracted STEP_FRAME."""
    rec, cfg = runs["rec"], runs["cfg"]
    before = rec["step_before"]
    store = interop.mapstore_from_numpy(**before["store"], device="cpu")
    tracker = Tracker(cfg, store, FrameFactory(cfg.cam, cfg.orb, device="cpu"))
    tracker.state = TrackState.OK
    tracker.ref_kf = before["ref_kf"]
    tracker.last_kf_frame_id = before["last_kf_frame_id"]
    tracker.last_frame = interop.frame_from_numpy(**before["last"])
    return tracker, interop.frame_from_numpy(**rec["frames"][STEP_FRAME])


def test_tracking_step_from_one_state(runs):
    """The port's fused pose-prior step, started from the JAX store and
    last frame just before STEP_FRAME and given the JAX-extracted
    features of STEP_FRAME.  Bar: the same verdict, inlier count and
    bindings for >= 99.5% of features (the projections are 3x3
    products whose last-bit rounding may differ, which can move a match
    across a window or chi2 boundary)."""
    after = runs["rec"]["step_after"]
    tracker, frame = _tracker_before_step(runs)
    tracker._prepare_next(tracker.last_frame)
    out = tracker._fused_dispatch(frame)
    assert tracker._fused_verdict(frame, out) == after["verdict"] == "ok"
    assert abs(tracker.matches_inliers - after["inliers"]) \
        <= 0.005 * after["inliers"]
    assert (frame.mp_ids == after["mp_ids"]).mean() >= 0.995
    assert (np.asarray(tracker.store.mp_n_visible)
            == after["n_visible"]).mean() >= 0.995


def test_fallback_paths_from_one_state(runs):
    """The non-fused paths from the same state: frame-to-frame search +
    local-map tracking (taken when no prepared step exists), and the
    reference-keyframe descriptor fallback + local-map tracking (taken
    when the frame-to-frame match fails).  Bars: the first runs the
    same searches as the fused step in two calls, so >= 99.5% of its
    bindings equal the JAX fused result; the second matches by
    descriptor alone first, so it must track (>= 90% of the reference's
    inliers) and agree on >= 90% of the features both bound."""
    ref = runs["rec"]["step_after"]
    tracker, frame = _tracker_before_step(runs)
    assert tracker._track_with_prior(frame)
    assert tracker._track_local_map(frame)
    assert (frame.mp_ids == ref["mp_ids"]).mean() >= 0.995

    tracker, frame = _tracker_before_step(runs)
    assert tracker._track_reference_kf(frame)
    assert tracker._track_local_map(frame)
    assert tracker.matches_inliers >= 0.9 * ref["inliers"]
    both = (frame.mp_ids >= 0) & (ref["mp_ids"] >= 0)
    assert (frame.mp_ids[both] == ref["mp_ids"][both]).mean() >= 0.9


def test_mapping_from_one_state(runs):
    """The port's LocalMapper on the JAX store as it stood before the
    first keyframe after init was mapped.  Bars: valid map points within
    2% of the reference, the same keyframes culled, and points valid in
    both within 1e-2 of each other (structure BA sums in another order,
    test_torch_matching.test_optimize_points)."""
    m = runs["rec"]["mapping"]
    cfg = runs["cfg"]
    store = interop.mapstore_from_numpy(**m["before"], device="cpu")
    mapper = LocalMapper(cfg, store)
    mapper.recent_points = list(m["recent"])
    mapper.process_keyframe(m["kid"])
    ref = m["after"]["points"]
    pv = np.asarray(store.mp_valid)
    jv = ref["mp_valid"]
    assert pv.sum() > len(m["before"]["points"]["mp_valid"]) * 0.5
    assert abs(int(pv.sum()) - int(jv.sum())) <= 0.02 * jv.sum()
    assert [kf.valid for kf in store.kfs] == \
        [k["valid"] for k in m["after"]["keyframes"]]
    n = min(len(pv), len(jv))
    both = pv[:n] & jv[:n]
    assert both.sum() >= 0.95 * jv.sum()
    d = np.abs(np.asarray(store.mp_pos)[:n][both] - ref["mp_pos"][:n][both])
    assert d.max() < 1e-2, d.max()


def test_ply_export(runs, tmp_path):
    path = tmp_path / "map.ply"
    runs["port"].save_map_ply(str(path))
    pts = ply.read_ply_points(str(path))
    np.testing.assert_array_equal(pts, runs["port"].map_points())


# ----------------------------------------------------------------------
# relocalization (these run last: they track one more frame in both
# Systems of the shared run)
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def reloc(runs):
    """Both Systems told they are LOST, then shown the mapped pose
    RELOC_POSE again with its trusted pose (tests/test_loop_closing.py::
    TestRelocalization::test_reloc_pose_prior).  The JAX store,
    vocabulary and tracker fields are captured before its frame."""
    jsys, port, rec = runs["jsys"], runs["port"], runs["rec"]
    img, T = runs["images"][RELOC_POSE], runs["poses"][RELOC_POSE]
    before = dict(store=interop.mapstore_state(jsys.store),
                  ref_kf=jsys.tracker.ref_kf)
    jrel = jsys.tracker.relocalize
    got = {}

    def relocalize(frame):
        ok = jrel(frame)
        got.update(ok=ok, mp_ids=frame.mp_ids.copy())
        return ok
    relocalize.pr = jrel.pr
    jsys.tracker.relocalize = relocalize
    jsys.tracker.state = TrackState.LOST
    jframe = jsys.track_monocular_with_pose(img, 99.0, T)
    jsys.tracker.relocalize = jrel
    port.tracker.state = TrackState.LOST
    pframe = port.track_monocular_with_pose(img, 99.0, T)
    return dict(before=before, jstate=jsys.state.name, jgot=got,
                jreloc=jsys.tracker.last_reloc_frame_id,
                pstate=port.state.name, fid=jframe.frame_id,
                pinl=port.tracker.matches_inliers,
                jinl=jsys.tracker.matches_inliers, pfid=pframe.frame_id)


def test_lost_frame_relocalizes(reloc):
    """The port relocalizes a LOST frame at a mapped pose, as the JAX
    package does (before relocalization was ported the frame stayed
    LOST).  Bar: both OK with local-map inliers above the
    relocalization threshold (each System tracks its own map, so the
    counts differ; the one-state test below compares bindings)."""
    assert reloc["jstate"] == "OK" and reloc["jreloc"] == reloc["fid"]
    assert reloc["pstate"] == "OK"
    assert min(reloc["pinl"], reloc["jinl"]) >= 50


def test_relocalization_from_one_state(runs, reloc):
    """The port's relocalizer on the JAX store and vocabulary as they
    stood before the LOST frame, given the JAX-extracted frame.  Bar:
    success, and the same binding on >= 99% of the features that either
    package's relocalizer bound."""
    cfg = runs["cfg"]
    store = interop.mapstore_from_numpy(**reloc["before"]["store"],
                                        device="cpu")
    pr = PlaceRecognition(store, vocab=interop.vocabulary_from_numpy(
        **runs["rec"]["vocab"]))
    # the BoW database in the JAX run's insertion order (its culled
    # keyframes were erased, which keeps the others' order)
    for kid in store.valid_kf_ids():
        pr.add_keyframe(kid)
    tracker = Tracker(cfg, store, FrameFactory(cfg.cam, cfg.orb, device="cpu"))
    tracker.relocalize = Relocalizer(cfg, store, pr)
    tracker.ref_kf = reloc["before"]["ref_kf"]
    frame = interop.frame_from_numpy(**runs["rec"]["frames"][reloc["fid"]])
    assert tracker._do_relocalize(frame)
    assert tracker.last_reloc_frame_id == reloc["fid"]
    ref = reloc["jgot"]
    assert ref["ok"]
    either = (frame.mp_ids >= 0) | (ref["mp_ids"] >= 0)
    assert (frame.mp_ids >= 0).sum() >= cfg.track_local_min_inliers_reloc
    assert (ref["mp_ids"][either] == frame.mp_ids[either]).mean() >= 0.99
