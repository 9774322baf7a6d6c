"""The port's structured logging and stage timers
(``orb_slam2_tpu_torch/utils/logging.py``): the three cases of
tests/test_logging.py.  The pipeline case runs the port's
``System(device="cpu")`` and the JAX package's System side by side on
the same 6 frames (tests/test_logging.py's configuration, rendered once
with the port's renderer).  Bar: the port logs a ``state=`` event for
every frame with the same state as the JAX run's event for it, and a
``map points`` event; both timing reports hold the extraction and
triangulation stages."""
import logging
import re

import numpy as np
import pytest
import torch

from orb_slam2_tpu_torch.utils.logging import StageTimer, enable, get_logger

torch.set_num_threads(1)


def test_stage_timer():
    """Calls are counted per stage; the summary names them in ms/call;
    reset empties the report."""
    t = StageTimer()
    with t.time("a"):
        pass
    with t.time("a"):
        pass
    with t.time("b"):
        pass
    rep = t.report()
    assert rep["a"][0] == 2 and rep["b"][0] == 1
    assert "a" in t.summary() and "ms/call" in t.summary()
    t.reset()
    assert t.report() == {}


def test_logger_emits_when_enabled(caplog):
    """An enabled logger's records reach the port's namespace."""
    enable("INFO")
    log = get_logger("testmod")
    assert log.name == "orb_slam2_tpu_torch.testmod"
    with caplog.at_level(logging.INFO, logger="orb_slam2_tpu_torch.testmod"):
        log.info("frame %d: state=%s", 3, "OK")
    assert any("state=OK" in r.message for r in caplog.records)


def _states(messages):
    """{frame id: state} from the tracker's ``frame N: state=S`` events."""
    out = {}
    for m in messages:
        hit = re.match(r"frame (\d+): state=(\w+)", m)
        if hit:
            out[int(hit.group(1))] = hit.group(2)
    return out


def test_pipeline_emits_events(caplog):
    from orb_slam2_tpu.geom.camera import Intrinsics as JIntrinsics
    from orb_slam2_tpu.ops.extractor import OrbParams as JOrbParams
    from orb_slam2_tpu.pipeline import SlamConfig as JSlamConfig
    from orb_slam2_tpu.pipeline import System as JSystem
    from orb_slam2_tpu.utils.logging import enable as jenable
    from orb_slam2_tpu_torch.geom.camera import Intrinsics
    from orb_slam2_tpu_torch.ops.extractor import OrbParams
    from orb_slam2_tpu_torch.pipeline.config import SlamConfig
    from orb_slam2_tpu_torch.pipeline.system import System
    from orb_slam2_tpu_torch.utils import synth

    enable("INFO")
    jenable("INFO")
    cam_kw = dict(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640,
                  height=480)
    cfg_kw = dict(pose_prior=True, init_min_matches=60,
                  init_min_triangulated=40, init_min_tracked_after_ba=60)
    cfg = SlamConfig(cam=Intrinsics(**cam_kw),
                     orb=OrbParams(n_features=600, n_levels=4), **cfg_kw)
    world = synth.make_world(seed=3, device="cpu")
    poses = synth.aerial_trajectory(6, speed=0.4)
    images = [synth.render(world, cfg.cam, T).numpy() for T in poses]
    port = System(cfg, enable_loop_closing=False, device="cpu")
    jsys = JSystem(JSlamConfig(cam=JIntrinsics(**cam_kw),
                               orb=JOrbParams(n_features=600, n_levels=4),
                               **cfg_kw), enable_loop_closing=False)
    with caplog.at_level(logging.INFO, logger="orb_slam2_tpu_torch"):
        for i, (img, T) in enumerate(zip(images, poses)):
            port.track_monocular_with_pose(img, i * 0.1, T)
    msgs = [r.message for r in caplog.records
            if r.name.startswith("orb_slam2_tpu_torch")]
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="orb_slam2_tpu"):
        for i, (img, T) in enumerate(zip(images, poses)):
            jsys.track_monocular_with_pose(img, i * 0.1, T)
    jmsgs = [r.message for r in caplog.records
             if r.name.startswith("orb_slam2_tpu.")]
    assert any("state=OK" in m for m in msgs)
    assert any("map points" in m for m in msgs)
    states = _states(msgs)
    assert states and states == _states(jmsgs), (states, _states(jmsgs))
    for rep in (port.timing_report(), jsys.timing_report()):
        assert "track/extract" in rep and "mapping/triangulate" in rep
    assert np.all(np.isfinite(port.map_points()))
