"""Keyframe cadence of pipelined tracking at depth 3, both packages on the
CPU at bench.py's shape (slow: ~35 min on the CPU; not in tier-1).

chip_smoke.py path A (pipelined, depth 3) inserts a keyframe every other
frame from frame ~23, more than the sequential A-seq.  This test tells a
port fault from the reference's own behaviour: the JAX package and the
port track the same 40 frames of bench.py's world (1920x1440,
OrbParams(4000, 8, 1.2), pose prior, ``pipelined_tracking=True``,
``pipeline_depth=3``, loop closing on, sequential mapping so that thread
timing drops out), and every keyframe decision's inputs are logged:
the frame, ``matches_inliers``, n_ref (the reference keyframe's points
with enough observations), c1a / c1b / c2 and the decision
(src/Tracking.cc:681-750).

Bars: the same decision at every decision the two packages make, in the
same frame order; inliers within 15% and n_ref within 15% where both
decide (test_torch_slice.py's inlier bar); the valid keyframes left
after keyframe culling within one (test_torch_slice.py's keyframe bar:
culling weighs observation counts against a 0.9 redundancy threshold).
The log is printed (run with ``-s``) and written to ``$CADENCE_LOG``
when that is set.

Outcome on the CPU (40 frames): all 38 decisions equal and positive
in both packages (c2, inliers < 0.9 n_ref, holds at every frame at this
shape, and with sequential mapping the mapper is always idle), so both
insert a keyframe at every committed frame; culling leaves 11 (JAX) and
12 (port).  So at this shape only the mapper's idle gate and the moments
of decision limit keyframes, and path A's keyframe every other frame
follows from the depth-3 consume cadence (two decisions on a consume-2
frame, the second refused while the mapper maps the first; none on a
consume-0 frame) — read from the code, not measured with asynchronous
mapping in both packages: a reference behaviour, not a port fault
(ROADMAP Queue 3, F2).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_cadence.py -m slow -s
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from orb_slam2_tpu.geom.camera import Intrinsics as JIntrinsics
from orb_slam2_tpu.ops.extractor import OrbParams as JOrbParams
from orb_slam2_tpu.pipeline import SlamConfig as JSlamConfig, System as JSystem
from orb_slam2_tpu_torch.bench import bench_config
from orb_slam2_tpu_torch.pipeline.system import System
from orb_slam2_tpu_torch.utils import synth

N_FRAMES = 40


def decision_inputs(tracker, frame) -> dict:
    """The inputs of ``_need_new_keyframe`` (identical in both packages)
    as they stand when it is called."""
    store, cfg = tracker.store, tracker.cfg
    n_kfs = store.n_valid_keyframes()
    min_obs = 3 if n_kfs > 2 else 2
    n_ref = 0
    if tracker.ref_kf >= 0:
        ref = store.kfs[tracker.ref_kf].frame
        rp = ref.mp_ids[ref.mp_ids >= 0].astype(np.int64)
        if len(rp):
            rp = rp[np.asarray(store.mp_valid[rp], bool)]
            n_ref = int((store.obs.n[rp] >= min_obs).sum())
    inl = int(tracker.matches_inliers)
    return dict(
        frame=int(frame.frame_id), inliers=inl, n_ref=n_ref,
        ref_kf=int(tracker.ref_kf), kfs=n_kfs,
        c1a=bool(frame.frame_id >= tracker.last_kf_frame_id
                 + cfg.max_frames_between_kf),
        c1b=bool(frame.frame_id >= tracker.last_kf_frame_id
                 + cfg.min_frames_between_kf),
        c2=bool(inl < n_ref * cfg.ref_ratio and inl > 15))


def _record_decisions(tracker, log: list):
    orig = tracker._need_new_keyframe

    def need(frame):
        d = decision_inputs(tracker, frame)
        d["need"] = bool(orig(frame))
        log.append(d)
        return d["need"]
    tracker._need_new_keyframe = need


def run_both(n_frames: int = N_FRAMES):
    """Both packages over the first ``n_frames`` frames; returns their
    decision logs and per-frame (state, keyframes) rows."""
    torch.set_num_threads(1)
    world = synth.make_world(seed=7, tex_size=4096, scale=120.0,
                             tex_shape=(3072, 10240),
                             origin_px=(1560.0, 1536.0), device="cpu")
    poses = synth.aerial_trajectory(n_frames, height=12.0, speed=0.5)
    # bench.py's configuration (pipelined at depth 3), the port's own
    # definition of it for both packages
    cfg = bench_config()
    jcfg = JSlamConfig(cam=JIntrinsics(*cfg.cam), orb=JOrbParams(*cfg.orb),
                       **{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)
                          if f.name not in ("cam", "orb")})
    runs = {}
    for name in ("jax", "port"):
        if name == "jax":
            sys_ = JSystem(jcfg, enable_loop_closing=True)
        else:
            sys_ = System(cfg, enable_loop_closing=True, device="cpu")
        log, rows = [], []
        _record_decisions(sys_.tracker, log)
        for i, T in enumerate(poses):
            img = synth.render(world, cfg.cam, T).numpy()
            sys_.track_monocular_with_pose(img, i * 0.1, T)
            rows.append((sys_.state.name, sys_.store.n_valid_keyframes()))
            print(f"{name} frame {i:2d}: {rows[-1]}", flush=True)
        sys_.flush_tracking()
        sys_.shutdown()
        runs[name] = dict(decisions=log, frames=rows,
                          keyframes=sys_.store.n_valid_keyframes())
    return runs


@pytest.mark.slow
def test_depth3_keyframe_cadence_matches_reference():
    runs = run_both()
    for name, r in runs.items():
        print(f"{name}: {r['keyframes']} keyframes; decisions:")
        for d in r["decisions"]:
            print(f"  {name} {json.dumps(d)}")
    if os.environ.get("CADENCE_LOG"):
        with open(os.environ["CADENCE_LOG"], "w") as f:
            json.dump(runs, f, indent=1)
    jd, pd = runs["jax"]["decisions"], runs["port"]["decisions"]
    assert [d["frame"] for d in pd] == [d["frame"] for d in jd]
    for j, p in zip(jd, pd):
        assert p["need"] == j["need"], (j, p)
        assert abs(p["inliers"] - j["inliers"]) <= 0.15 * j["inliers"], (j, p)
        assert abs(p["n_ref"] - j["n_ref"]) <= 0.15 * j["n_ref"], (j, p)
    assert abs(runs["port"]["keyframes"] - runs["jax"]["keyframes"]) <= 1
