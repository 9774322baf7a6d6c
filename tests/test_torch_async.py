"""The port's asynchronous mapping: ``System(async_mapping=True)`` with a
flush after every frame (bench.py's warm-up discipline) against the JAX
package's own asynchronous run on the same frames, and the AsyncMapper's
queue contract (idle while nothing is queued, worker exceptions
surfacing on the caller's thread).

Size: tests/test_torch_slice.py's (640x480, 800 features, 4 levels),
15 frames of the aerial sweep, rendered once with the port's renderer
and fed to both packages.  In both packages the tracker prepares the
next frame's local map before the mapping thread has mapped a new
keyframe, so the frame after a keyframe searches the map as it stood
before that keyframe: asynchronous mapping with a flush per frame does
not equal sequential mapping, in either package."""
import threading

import numpy as np
import pytest
import torch

from orb_slam2_tpu.geom.camera import Intrinsics as JIntrinsics
from orb_slam2_tpu.ops.extractor import OrbParams as JOrbParams
from orb_slam2_tpu.pipeline import SlamConfig as JSlamConfig, System as JSystem
from orb_slam2_tpu_torch.geom.camera import Intrinsics
from orb_slam2_tpu_torch.ops.extractor import OrbParams
from orb_slam2_tpu_torch.pipeline.config import SlamConfig
from orb_slam2_tpu_torch.pipeline.local_mapping import AsyncMapper
from orb_slam2_tpu_torch.pipeline.system import System
from orb_slam2_tpu_torch.utils import synth

torch.set_num_threads(1)

N_FRAMES = 15
CAM_KW = dict(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
CFG_KW = dict(fps=10.0, pose_prior=True, init_min_matches=60,
              init_min_triangulated=40, init_min_tracked_after_ba=60)
CAM = Intrinsics(**CAM_KW)


def _config():
    return SlamConfig(cam=CAM, orb=OrbParams(n_features=800, n_levels=4),
                      **CFG_KW)


def _run(system, images, poses):
    per = []
    for i, T in enumerate(poses):
        system.track_monocular_with_pose(images[i], i * 0.1, T)
        system.flush_mapping()
        per.append(dict(state=system.state.name,
                        kfs=system.store.n_valid_keyframes(),
                        inliers=system.tracker.matches_inliers))
    system.shutdown()
    return per


@pytest.fixture(scope="module")
def runs():
    """Both packages with loop detection on the mapping thread, as
    bench.py runs them, and a flush after every frame."""
    world = synth.make_world(seed=3)
    poses = synth.aerial_trajectory(N_FRAMES, speed=0.3)
    images = [synth.render(world, CAM, T) for T in poses]
    port = System(_config(), async_mapping=True, device="cpu")
    per_port = _run(port, images, poses)
    jsys = JSystem(JSlamConfig(cam=JIntrinsics(**CAM_KW),
                               orb=JOrbParams(n_features=800, n_levels=4),
                               **CFG_KW), async_mapping=True)
    per_jax = _run(jsys, [im.numpy() for im in images], poses)
    return dict(port=port, jsys=jsys, per_port=per_port, per_jax=per_jax)


def test_async_with_flush_matches_the_reference_async(runs):
    """Bars (tests/test_torch_slice.py's for the sequential pipeline):
    identical per-frame states; keyframe counts within one at every
    frame; per-frame inliers within 15% after initialization; final
    valid map points within 10%.  Extraction agrees to float32 rounding,
    so a keyframe decision near its threshold may fall one frame apart."""
    pp, pj = runs["per_port"], runs["per_jax"]
    assert [p["state"] for p in pp] == [p["state"] for p in pj]
    assert sum(p["state"] == "OK" for p in pp) >= N_FRAMES - 1
    for i, (p, j) in enumerate(zip(pp, pj)):
        assert abs(p["kfs"] - j["kfs"]) <= 1, (i, p, j)
        if j["inliers"] > 0:
            assert abs(p["inliers"] - j["inliers"]) <= 0.15 * j["inliers"], \
                (i, p, j)
    mp, mj = runs["port"].map_points(), runs["jsys"].map_points()
    assert abs(len(mp) - len(mj)) <= 0.1 * len(mj), (len(mp), len(mj))
    assert np.median(np.abs(mp[:, 2])) < 0.08


def test_shutdown_joins_the_mapping_thread(runs):
    """After shutdown the System holds no worker and no mapping thread
    is alive."""
    assert runs["port"].map_worker is None
    assert not any(t.name == "local_mapping" and t.is_alive()
                   for t in threading.enumerate())


def test_async_without_flush_keeps_the_map_consistent():
    """The tracker and the mapping thread run concurrently (no flush
    between frames) with a thread switch interval of 10 us, so their
    locked sections interleave as finely as they can.  Bars: every
    frame after initialization tracks, and the observation graph stays
    consistent: each point's {keyframe: feature} entry is that
    keyframe's binding of the point."""
    import sys
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        world = synth.make_world(seed=3)
        poses = synth.aerial_trajectory(10, speed=0.3)
        system = System(_config(), async_mapping=True, device="cpu")
        states = []
        for i, T in enumerate(poses):
            system.track_monocular_with_pose(synth.render(world, CAM, T),
                                             i * 0.1, T)
            states.append(system.state.name)
        system.shutdown()
    finally:
        sys.setswitchinterval(interval)
    assert states[1:] == ["OK"] * (len(poses) - 1), states
    store = system.store
    n_checked = 0
    for pid in np.where(np.asarray(store.mp_valid, bool))[0]:
        for kid, fi in store.mp_obs[pid].items():
            assert store.kfs[kid].frame.mp_ids[fi] == pid, (pid, kid, fi)
            n_checked += 1
    assert n_checked > 1000


class _Mapper:
    """A stand-in LocalMapper: records keyframes, optionally blocks on
    an event or raises."""

    def __init__(self, gate=None, fail_on=None):
        self.store = type("S", (), {"kfs": []})()
        self.seen = []
        self.gate = gate
        self.entered = threading.Event()
        self.fail_on = fail_on

    def process_keyframe(self, kid, queue_pressure=False):
        self.entered.set()
        if self.gate is not None:
            assert self.gate.wait(30)
        if kid == self.fail_on:
            raise RuntimeError(f"mapping failed on KF {kid}")
        self.seen.append((kid, queue_pressure))


def test_idle_false_while_a_keyframe_is_queued():
    """idle() is false while a keyframe is queued or being mapped; a
    keyframe dequeued with another one waiting is mapped under queue
    pressure (fuse and local BA skipped)."""
    gate = threading.Event()
    worker = AsyncMapper(_Mapper(gate=gate))
    assert worker.idle()
    worker.process_keyframe(0)
    assert worker.mapper.entered.wait(30)   # 0 is being mapped
    worker.process_keyframe(1)
    worker.process_keyframe(2)
    assert not worker.idle()
    gate.set()
    worker.drain()
    assert worker.idle()
    assert worker.mapper.seen == [(0, False), (1, True), (2, False)]
    worker.stop()


def test_worker_exception_surfaces_at_drain():
    worker = AsyncMapper(_Mapper(fail_on=1))
    worker.process_keyframe(0)
    worker.process_keyframe(1)
    with pytest.raises(RuntimeError, match="KF 1"):
        worker.drain()
    worker.process_keyframe(2)        # the error was consumed once
    worker.drain()
    assert [k for k, _ in worker.mapper.seen] == [0, 2]
    worker.stop()


def test_worker_exception_surfaces_at_next_keyframe():
    worker = AsyncMapper(_Mapper(fail_on=0))
    worker.process_keyframe(0)
    worker._q.join()
    with pytest.raises(RuntimeError, match="KF 0"):
        worker.process_keyframe(1)
    worker.stop()
