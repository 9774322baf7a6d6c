"""Map checkpoint and resume (``models/serialize.py``,
``System.save_map`` / ``load_map``) and localization-only mode in the
port, against the JAX package.

Both packages build a map over the same 16 pose-prior frames (640x480,
800 features, 4 levels; tests/test_serialize.py's run), rendered with
the port's renderer.  A map saved by either package must load in the
other with equal arrays."""
import numpy as np
import pytest
import torch

from orb_slam2_tpu.geom.camera import Intrinsics as JIntrinsics
from orb_slam2_tpu.models import serialize as jser
from orb_slam2_tpu.ops.extractor import OrbParams as JOrbParams
from orb_slam2_tpu.pipeline import (SlamConfig as JSlamConfig,
                                    System as JSystem,
                                    TrackState as JTrackState)
from orb_slam2_tpu_torch.geom.camera import Intrinsics
from orb_slam2_tpu_torch.models import serialize as tser
from orb_slam2_tpu_torch.ops.extractor import OrbParams
from orb_slam2_tpu_torch.pipeline.config import SlamConfig
from orb_slam2_tpu_torch.pipeline.system import System
from orb_slam2_tpu_torch.pipeline.tracking import TrackState
from orb_slam2_tpu_torch.utils import synth

torch.set_num_threads(1)

N_FRAMES = 16
CAM_KW = dict(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
CFG_KW = dict(fps=10.0, pose_prior=True, init_min_matches=60,
              init_min_triangulated=40, init_min_tracked_after_ba=60)
POINT_COLUMNS = ("mp_pos", "mp_desc", "mp_normal", "mp_min_dist",
                 "mp_max_dist", "mp_valid", "mp_first_kf", "mp_first_frame",
                 "mp_n_visible", "mp_n_found", "mp_replaced_by")
FEATURES = ("xy", "xy_raw", "response", "angle", "octave", "desc", "valid",
            "mp_ids", "mp_outlier")


def port_config():
    return SlamConfig(cam=Intrinsics(**CAM_KW),
                      orb=OrbParams(n_features=800, n_levels=4), **CFG_KW)


def jax_config():
    return JSlamConfig(cam=JIntrinsics(**CAM_KW),
                       orb=JOrbParams(n_features=800, n_levels=4), **CFG_KW)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Both packages' Systems after the 16 frames, and each one's map
    saved to npz."""
    out = tmp_path_factory.mktemp("maps")
    world = synth.make_world(seed=3, device="cpu")
    poses = synth.aerial_trajectory(N_FRAMES, speed=0.3)
    cam = Intrinsics(**CAM_KW)
    images = [synth.render(world, cam, T).numpy() for T in poses]
    jsys = JSystem(jax_config(), enable_loop_closing=False)
    port = System(port_config(), enable_loop_closing=False, device="cpu")
    for i, T in enumerate(poses):
        jsys.track_monocular_with_pose(images[i], i * 0.1, T)
        port.track_monocular_with_pose(images[i], i * 0.1, T)
    assert jsys.state == JTrackState.OK and port.state == TrackState.OK
    jsys.save_map(str(out / "jax.npz"))
    port.save_map(str(out / "port.npz"))
    return dict(jsys=jsys, port=port, poses=poses, images=images, out=out)


def store_arrays(store) -> dict:
    """Everything a map file holds, read from a MapStore of either
    package as host values."""
    out = {c: np.array(getattr(store, c)) for c in POINT_COLUMNS}
    out["mp_obs"] = [dict(o) for o in store.mp_obs]
    out["obs_mirror"] = [np.array(a)[:store.n_points()] for a in
                         (store.obs.kid, store.obs.fi, store.obs.n)]
    out["covis"] = [dict(c) for c in store.covis]
    out["kfs"] = [dict(
        kid=kf.kid, Tcw=np.array(kf.Tcw), parent=kf.parent,
        children=set(kf.children), loop_edges=set(kf.loop_edges),
        kf_valid=kf.valid, first_connection=kf.first_connection,
        frame_id=kf.frame.frame_id, timestamp=kf.frame.timestamp,
        **{f: np.array(getattr(kf.frame, f)) for f in FEATURES})
        for kf in store.kfs]
    out["max_kf_id"] = store.max_kf_id
    out["scale"] = (store._scale_factor, store._n_levels)
    return out


def _mirror_rows(m):
    kid, fi, n = m
    return [sorted(zip(kid[i, :n[i]].tolist(), fi[i, :n[i]].tolist()))
            for i in range(len(n))]


def assert_same(a, b, check_outliers=True, mirror_order=True):
    assert a.keys() == b.keys()
    for k in a:
        if k == "kfs":
            assert len(a[k]) == len(b[k])
            for ka, kb in zip(a[k], b[k]):
                for f in ka:
                    if f == "mp_outlier" and not check_outliers:
                        continue
                    if isinstance(ka[f], np.ndarray):
                        assert ka[f].dtype == kb[f].dtype, f
                        np.testing.assert_array_equal(ka[f], kb[f], err_msg=f)
                    else:
                        assert ka[f] == kb[f], f
        elif k == "obs_mirror" and not mirror_order:
            assert _mirror_rows(a[k]) == _mirror_rows(b[k])
        elif k == "obs_mirror":
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y)
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_roundtrip_preserves_map(built):
    """The port's map through its own save and load: every array
    equal (the file carries no outlier flags, which load clear, and
    the observation mirror is rebuilt in the graph's order, so its
    rows hold the same links in another slot order, as in the JAX
    package), the device point store rebuilt from it, the same scene
    depth."""
    port = built["port"]
    store2 = tser.load_map(str(built["out"] / "port.npz"), device="cpu")
    assert_same(store_arrays(store2), store_arrays(port.store),
                check_outliers=False, mirror_order=False)
    assert store2.device == "cpu"
    snap = store2.dev_points.snapshot()
    n = store2.n_points()
    np.testing.assert_array_equal(snap[0][:n].numpy(),
                                  np.asarray(store2.mp_pos))
    assert abs(store2.scene_median_depth(0)
               - port.store.scene_median_depth(0)) < 1e-6


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_a_map_saved_by_either_package_loads_in_the_other(built, saved_by):
    """The same file loaded by both packages gives equal arrays; the
    two files carry the same keys and dtypes."""
    path = str(built["out"] / f"{saved_by}.npz")
    a = store_arrays(tser.load_map(path, device="cpu"))
    b = store_arrays(jser.load_map(path))
    assert_same(a, b)
    zj = np.load(str(built["out"] / "jax.npz"))
    zp = np.load(str(built["out"] / "port.npz"))
    assert sorted(zj.files) == sorted(zp.files)
    for k in zj.files:
        assert zj[k].dtype == zp[k].dtype, k
    assert int(zp["version"]) == tser._FORMAT_VERSION == jser._FORMAT_VERSION


def test_resume_and_relocalize(built):
    """A fresh System loads the JAX package's map, resumes LOST and
    relocalizes on a mapped frame, as the JAX package does from the same
    file.  Bar: both OK, inliers within 15% of the JAX package's."""
    path = str(built["out"] / "jax.npz")
    fresh = System(port_config(), enable_loop_closing=False, device="cpu")
    fresh.load_map(path)
    jfresh = JSystem(jax_config(), enable_loop_closing=False)
    jfresh.load_map(path)
    assert fresh.state == TrackState.LOST
    assert (fresh.store.n_valid_keyframes()
            == built["jsys"].store.n_valid_keyframes())
    assert len(fresh.place_rec.db.bow) == fresh.store.n_valid_keyframes()
    T = built["poses"][8]
    fresh.track_monocular_with_pose(built["images"][8], 50.0, T)
    jfresh.track_monocular_with_pose(built["images"][8], 50.0, T)
    assert jfresh.state == JTrackState.OK
    assert fresh.state == TrackState.OK
    assert fresh.tracker.last_reloc_frame_id == 0
    j, p = jfresh.tracker.matches_inliers, fresh.tracker.matches_inliers
    assert abs(p - j) <= 0.15 * j, (p, j)


def test_localization_only_mode(built):
    """Localization mode on a loaded map: eight frames tracked OK, no
    keyframe or point added; deactivating it maps again."""
    fresh = System(port_config(), enable_loop_closing=False, device="cpu")
    fresh.load_map(str(built["out"] / "port.npz"))
    fresh.activate_localization_mode()
    n_kf = fresh.store.n_valid_keyframes()
    n_mp = fresh.store.n_points()
    for i, T in enumerate(built["poses"][6:14]):
        fresh.track_monocular_with_pose(built["images"][6 + i], 100.0 + i, T)
        assert fresh.state == TrackState.OK, i
    assert fresh.store.n_valid_keyframes() == n_kf
    assert fresh.store.n_points() == n_mp
    fresh.deactivate_localization_mode()
    assert fresh.tracker.mapping_enabled


def test_localization_only_mode_pipelined(built):
    """The gate holds on the pipelined consume path too (depth 3, with
    the extraction prefetch): a loaded map in localization mode gains
    no keyframe or point over eight frames."""
    import dataclasses
    cfg = dataclasses.replace(port_config(), pipelined_tracking=True,
                              pipeline_depth=3)
    fresh = System(cfg, enable_loop_closing=False, device="cpu")
    fresh.load_map(str(built["out"] / "port.npz"))
    fresh.activate_localization_mode()
    n_kf = fresh.store.n_valid_keyframes()
    n_mp = fresh.store.n_points()
    imgs, poses = built["images"][6:14], built["poses"][6:14]
    fresh.prefetch(imgs[0])
    for i, T in enumerate(poses):
        nxt = imgs[i + 1] if i + 1 < len(imgs) else None
        fresh.track_monocular_with_pose(imgs[i], 100.0 + i, T,
                                        next_image=nxt)
    fresh.flush_tracking()
    assert fresh.state == TrackState.OK
    assert [st for _, _, _, st in fresh.trajectory][1:] == \
        [TrackState.OK] * (len(poses) - 1)
    assert fresh.store.n_valid_keyframes() == n_kf
    assert fresh.store.n_points() == n_mp
