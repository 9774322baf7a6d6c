"""KeyFrameCulling (src/LocalMapping.cc:688-772) in the port against the
JAX package: the three cases of tests/test_kf_culling.py, each store
built twice from the same frames (tests/test_mapstore.py's ``_frame``),
once for each package, and culled by each package's
``LocalMapper._cull_keyframes``.  Bar: both erase exactly the same
keyframes, and the port meets the JAX test's own assertions (the
in-order semantics: erasing one candidate removes its observations,
which rescues the next candidate)."""
import numpy as np
import torch

from orb_slam2_tpu.geom.camera import Intrinsics as JIntrinsics
from orb_slam2_tpu.models.mapstore import MapStore as JMapStore
from orb_slam2_tpu.pipeline.config import SlamConfig as JSlamConfig
from orb_slam2_tpu.pipeline.local_mapping import LocalMapper as JLocalMapper
from orb_slam2_tpu_torch import interop
from orb_slam2_tpu_torch.geom.camera import Intrinsics
from orb_slam2_tpu_torch.models.mapstore import MapStore
from orb_slam2_tpu_torch.pipeline.config import SlamConfig
from orb_slam2_tpu_torch.pipeline.local_mapping import LocalMapper

from test_mapstore import _frame

torch.set_num_threads(1)

CAM_KW = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)


def _port_frame(jframe):
    return interop.frame_from_numpy(
        **{k: getattr(jframe, k) for k in interop.FRAME_FIELDS})


def _build(n_observers=4, n_pts=20, coarse_from=None):
    """Both packages' stores in tests/test_kf_culling.py's state: KFs
    1..n_observers observe the same ``n_pts`` points (slot j); KF 0
    observes nothing (kid 0 is never culled); every observer is
    covisible with every other.  KFs ``coarse_from``.. see every point at
    octave 4 instead of 0.  Returns (JAX mapper, port mapper)."""
    frames = []
    for i in range(n_observers + 1):
        f = _frame(i)
        if coarse_from is not None and i >= coarse_from:
            f.octave[:] = 4
        frames.append(f)
    mappers = []
    for pkg in ("jax", "port"):
        store = JMapStore() if pkg == "jax" else MapStore(device="cpu")
        store.set_scale_info(1.2, 8)
        for f in frames:
            store.add_keyframe(f if pkg == "jax" else _port_frame(f))
        for j in range(n_pts):
            pid = store.add_point(
                pos=np.array([j, 0, 5.0], np.float32),
                desc=frames[1].desc[j],
                normal=np.array([0, 0, 1.0], np.float32),
                min_dist=0.1, max_dist=100.0, first_kf=1, first_frame=1)
            for k in range(1, n_observers + 1):
                store.add_observation(pid, k, j)
        for i in range(n_observers + 1):
            store.update_connections(i)
        if pkg == "jax":
            mappers.append(JLocalMapper(
                JSlamConfig(cam=JIntrinsics(**CAM_KW)), store))
        else:
            mappers.append(LocalMapper(
                SlamConfig(cam=Intrinsics(**CAM_KW)), store))
    return mappers


def _cull(mappers, kid):
    """Cull from ``kid`` in both packages; returns each one's valid flags."""
    valid = []
    for m in mappers:
        m._cull_keyframes(kid)
        valid.append([bool(kf.valid) for kf in m.store.kfs])
    return valid


def test_redundant_keyframe_is_culled_sequentially():
    """4 observers: every candidate passes the screen, the in-order loop
    erases the first and the others drop under 3 other observers.  Bar:
    the same keyframes erased in both; exactly one of 2-4, never 1."""
    jv, pv = _cull(_build(n_observers=4), 1)
    assert pv == jv
    assert sum(not pv[k] for k in (2, 3, 4)) == 1
    assert pv[1]


def test_non_redundant_keyframes_survive():
    """3 observers: each point seen only twice elsewhere.  Bar: nothing
    erased in either package."""
    jv, pv = _cull(_build(n_observers=3), 1)
    assert pv == jv
    assert all(pv[k] for k in (1, 2, 3))


def test_coarser_scale_does_not_count():
    """The other observers see every point at octave 4 > 0 + 1: no point
    of KF 1 is redundant.  Bar: the same flags in both; KF 1 kept."""
    jv, pv = _cull(_build(n_observers=4, coarse_from=2), 2)
    assert pv == jv
    assert pv[1]
