"""The port's viewer stack (utils/viz.py, utils/viewer.py, the CLI's
--viz / --viz-dir) against the JAX package's, on the CPU.

- ``draw_frame`` is bit for bit the JAX package's RGB array, on a frame
  and map tracked by the JAX package and carried across through
  ``interop``, and on random keypoints that overlap, leave the image,
  point at dead map points or are outliers;
- ``draw_map`` draws what the JAX ``draw_map`` hands ``ax.scatter`` and
  ``ax.plot`` (captured by patching ``matplotlib.pyplot.figure`` in this
  test); the port rasterizes it itself;
- the port's PNG bytes decode to the array they encode;
- ``LiveViewer`` and ``cli run --viz 0 --viz-dir`` serve and write the
  frame and map during a short run (test_viewer.py's surface);
- none of these modules imports cv2, matplotlib or PIL.
"""
import json
import os
import struct
import subprocess
import sys
import threading
import time
import types
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from orb_slam2_tpu.geom.camera import Intrinsics as JIntrinsics
from orb_slam2_tpu.ops.extractor import OrbParams as JOrbParams
from orb_slam2_tpu.pipeline import SlamConfig as JSlamConfig, System as JSystem
from orb_slam2_tpu.utils import viz as jviz
from orb_slam2_tpu_torch import cli as tcli, interop
from orb_slam2_tpu_torch.geom.camera import Intrinsics
from orb_slam2_tpu_torch.io.poses import save_ue4_camera_poses
from orb_slam2_tpu_torch.ops.extractor import OrbParams
from orb_slam2_tpu_torch.pipeline.config import SlamConfig
from orb_slam2_tpu_torch.pipeline.system import System
from orb_slam2_tpu_torch.utils import synth, viz
from orb_slam2_tpu_torch.utils.viewer import LiveViewer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM_KW = dict(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
CFG_KW = dict(fps=10.0, pose_prior=True, init_min_matches=60,
              init_min_triangulated=40, init_min_tracked_after_ba=60)
N_FRAMES = 6


def decode_png(data: bytes) -> np.ndarray:
    """8-bit RGB PNG (filter 0 rows, as viz.encode_png writes) -> array."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = hdr[:4]
    assert depth == 8 and ctype == 2
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


@pytest.fixture(scope="module")
def tracked():
    """The JAX package's System after N_FRAMES pose-prior frames, and the
    same state in the port (store and last frame through interop)."""
    world = synth.make_world(seed=3, device="cpu")
    poses = synth.aerial_trajectory(N_FRAMES, speed=0.3)
    images = [synth.render(world, Intrinsics(**CAM_KW), T).numpy()
              for T in poses]
    jsys = JSystem(JSlamConfig(cam=JIntrinsics(**CAM_KW),
                               orb=JOrbParams(n_features=800, n_levels=4),
                               **CFG_KW), enable_loop_closing=False)
    for i, T in enumerate(poses):
        jsys.track_monocular_with_pose(images[i], i * 0.1, T)
    # a loop edge, so that every kind of segment is drawn
    kids = jsys.store.valid_kf_ids()
    jsys.store.kfs[kids[-1]].loop_edges.add(kids[0])
    store = interop.mapstore_from_numpy(
        **interop.mapstore_state(jsys.store), device="cpu")
    f = jsys.tracker.last_frame
    frame = interop.frame_from_numpy(
        **{k: (np.array(getattr(f, k)) if k not in ("frame_id", "timestamp")
               else getattr(f, k)) for k in interop.FRAME_FIELDS})
    return dict(jsys=jsys, store=store, frame=frame, image=images[-1],
                jframe=f)


def test_draw_frame_bit_exact_on_a_tracked_frame(tracked, tmp_path):
    jsys, f = tracked["jsys"], tracked["jframe"]
    ours = viz.draw_frame(tracked["image"], tracked["frame"],
                          store=tracked["store"])
    ref = jviz.draw_frame(tracked["image"], f, store=jsys.store)
    assert ours.dtype == np.uint8 and ours.shape == (480, 640, 3)
    np.testing.assert_array_equal(ours, ref)
    assert (ours == [0, 255, 0]).all(-1).sum() > 100     # tracked crosses
    # a device-side image (the CLI passes a tensor) draws the same
    ours_t = viz.draw_frame(torch.from_numpy(tracked["image"]),
                            tracked["frame"], store=tracked["store"])
    np.testing.assert_array_equal(ours_t, ref)
    # with path: the same pixels in the PNG, the title as a tEXt chunk
    p = tmp_path / "frame.png"
    viz.draw_frame(tracked["image"], tracked["frame"],
                   store=tracked["store"], path=str(p))
    data = p.read_bytes()
    np.testing.assert_array_equal(decode_png(data), ref)
    n = int(((np.asarray(f.mp_ids) >= 0) & ~np.asarray(f.mp_outlier)).sum())
    assert b"tEXtTitle\x00KFs: " in data and b"Matches: " in data
    assert n > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_draw_frame_bit_exact_on_overlapping_keypoints(seed):
    """Dense random keypoints: crosses overlap (the later one wins),
    leave the image by up to 5 px, lie at negative fractions (int()
    truncates toward zero), point at dead map points or are outliers."""
    rng = np.random.default_rng(seed)
    h, w, n = 60, 80, 400
    image = rng.uniform(-20, 280, (h, w)).astype(np.float32)
    xy = np.stack([rng.uniform(-5, w + 5, n), rng.uniform(-5, h + 5, n)],
                  1).astype(np.float32)
    frame = types.SimpleNamespace(
        valid=rng.random(n) < 0.9, xy_raw=xy,
        mp_ids=rng.integers(-1, 50, n).astype(np.int32),
        mp_outlier=rng.random(n) < 0.2)
    store = types.SimpleNamespace(mp_valid=rng.random(50) < 0.7)
    for s in (None, store):
        np.testing.assert_array_equal(viz.draw_frame(image, frame, s),
                                      jviz.draw_frame(image, frame, s))
    rgb3 = rng.uniform(0, 255, (h, w, 4)).astype(np.float32)
    np.testing.assert_array_equal(viz.draw_frame(rgb3, frame, store),
                                  jviz.draw_frame(rgb3, frame, store))


def test_resize_without_moire_matches_jax():
    img = np.random.default_rng(0).uniform(0, 255, (480, 640))
    for tw, th in ((160, 120), (300, 200), (640, 480)):
        np.testing.assert_allclose(viz.resize_without_moire(img, tw, th),
                                   jviz.resize_without_moire(img, tw, th),
                                   atol=1e-4)


class _Recorder:
    """Stands in for the matplotlib figure and 3D axes of the JAX
    draw_map: keeps what it is asked to draw."""

    def __init__(self):
        self.points, self.segs = None, []

    def add_subplot(self, **kw):
        return self

    def scatter(self, x, y, z, **kw):
        self.points = np.stack([x, y, z], 1)

    def plot(self, xs, ys, zs, c=None, lw=None, **kw):
        self.segs.append((np.array([xs[0], ys[0], zs[0]]),
                          np.array([xs[1], ys[1], zs[1]]), c, lw))

    def view_init(self, **kw):
        self.view = kw

    def set_box_aspect(self, a):
        pass


def test_draw_map_primitives_match_jax(tracked, monkeypatch):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    rec = _Recorder()
    monkeypatch.setattr(plt, "figure", lambda **kw: rec)
    assert jviz.draw_map(tracked["jsys"].store) is rec
    pts, segs = viz.map_primitives(tracked["store"])
    np.testing.assert_array_equal(pts, rec.points)
    assert len(segs) == len(rec.segs)
    for (a, b, c, lw), (ja, jb, jc, jlw) in zip(segs, rec.segs):
        np.testing.assert_array_equal(np.asarray(a, np.float64), ja)
        np.testing.assert_array_equal(np.asarray(b, np.float64), jb)
        assert (c, lw) == (jc, jlw)
    kinds = {(c, lw) for _, _, c, lw in segs}
    assert {("b", 0.5), ("g", 0.8), ("r", 1.0)} <= kinds
    assert rec.view == dict(elev=-70.0, azim=-90.0)
    rgb = viz.draw_map(tracked["store"])
    assert rgb.shape == viz.MAP_SIZE + (3,) and rgb.dtype == np.uint8
    for colour in ((0, 0, 0), (0, 0, 255), (0, 128, 0), (255, 0, 0)):
        assert (rgb == colour).all(-1).sum() > 0, colour


def test_png_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    data = viz.encode_png(rgb, text="KFs: 3")
    np.testing.assert_array_equal(decode_png(data), rgb)
    cv2 = pytest.importorskip("cv2")
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(bgr[..., ::-1], rgb)


def _get(url):
    return urllib.request.urlopen(url, timeout=10).read()


def test_live_viewer_serves_during_run(tmp_path):
    cfg = SlamConfig(cam=Intrinsics(**CAM_KW),
                     orb=OrbParams(n_features=600, n_levels=4), **CFG_KW)
    sys_ = System(cfg, enable_loop_closing=False, device="cpu")
    viewer = LiveViewer(sys_.store, port=0, out_dir=str(tmp_path),
                        frame_period_s=0.15, map_period_s=0.5).attach(sys_)
    assert viewer.port
    base = f"http://127.0.0.1:{viewer.port}"
    world = synth.make_world(seed=3, tex_size=1024, device="cpu")
    poses = synth.aerial_trajectory(N_FRAMES, height=10.0, speed=0.5)
    mid = None
    try:
        for i, T in enumerate(poses):
            sys_.track_monocular_with_pose(
                synth.render(world, cfg.cam, T), i * 0.1, T)
            if i == 4:     # DURING the run, not after
                time.sleep(0.4)
                mid = json.loads(_get(base + "/status.json"))
        assert mid is not None and mid["frames_seen"] >= 4
        time.sleep(1.2)    # the render thread publishes the last frame + map
        st = json.loads(_get(base + "/status.json"))
        assert st["frames_seen"] == len(poses) and st["keyframes"] >= 1
        frame = decode_png(_get(base + "/frame.png"))
        assert frame.shape == (480, 640, 3)
        assert (frame == [0, 255, 0]).all(-1).sum() > 0
        assert decode_png(_get(base + "/map.png")).shape == \
            viz.MAP_SIZE + (3,)
        assert b"live viewer" in _get(base + "/")
        assert (tmp_path / "frame.png").exists()
        assert (tmp_path / "map.png").exists()
    finally:
        viewer.close()
    assert not viewer._worker.is_alive()


SETTINGS = """%YAML:1.0
Camera.fx: 450.0
Camera.fy: 450.0
Camera.cx: 320.0
Camera.cy: 240.0
Camera.fps: 10.0
ORBextractor.nFeatures: 600
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
"""


def test_cli_run_with_viz(tmp_path, capsys, monkeypatch):
    """``cli run launch.toml --viz 0 --viz-dir DIR`` serves the viewer
    while it tracks (a thread polls the URL the CLI prints) and writes
    the PNGs; it no longer exits 2."""
    world = synth.make_world(seed=3, device="cpu")
    poses = synth.aerial_trajectory(N_FRAMES, speed=0.4)
    (tmp_path / "imgs").mkdir()
    paths = []
    for i, T in enumerate(poses):
        p = tmp_path / "imgs" / f"{i:03d}.npy"
        np.save(p, synth.render(world, Intrinsics(**CAM_KW), T).numpy())
        paths.append(str(p))
    (tmp_path / "imgs.txt").write_text("\n".join(paths) + "\n")
    save_ue4_camera_poses(str(tmp_path / "cams.txt"), poses)
    (tmp_path / "settings.yaml").write_text(SETTINGS)
    launch = tmp_path / "launch.toml"
    launch.write_text(
        'FBoWVocabularyPath = ""\n'
        f'ImagesCollectionPath = "{tmp_path}/imgs.txt"\n'
        f'CameraPoseCollectionPath = "{tmp_path}/cams.txt"\n'
        f'ORBSLAMConfigPath = "{tmp_path}/settings.yaml"\n')
    fetched, urls = [], []

    # the viewer's URL is printed on stderr; read it from the viewer
    real_init = LiveViewer.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        urls.append(f"http://127.0.0.1:{self.port}")

    real_close = LiveViewer.close

    def close(self):
        time.sleep(1.0)    # the render thread publishes the last frame
        fetched.append(("final", json.loads(_get(urls[0] + "/status.json")),
                        _get(urls[0] + "/frame.png"),
                        _get(urls[0] + "/map.png")))
        real_close(self)

    monkeypatch.setattr(LiveViewer, "__init__", init)
    monkeypatch.setattr(LiveViewer, "close", close)
    stop = threading.Event()

    def poll():
        while not stop.wait(0.2):
            if urls:
                try:
                    fetched.append(("mid", json.loads(
                        _get(urls[0] + "/status.json"))))
                except OSError:
                    pass

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    vdir = tmp_path / "viz"
    try:
        rc = tcli.main(["run", str(launch), "--out", str(tmp_path / "out"),
                        "--no-loop", "--device", "cpu", "--viz", "0",
                        "--viz-dir", str(vdir)])
    finally:
        stop.set()
        poller.join(5.0)
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["frames"] == N_FRAMES
    assert any(k == "mid" for k, *_ in fetched)
    final = [f for f in fetched if f[0] == "final"]
    assert len(final) == 1
    _, st, frame_png, map_png = final[0]
    assert st["frames_seen"] == N_FRAMES
    frame = decode_png(frame_png)
    assert frame.shape == (480, 640, 3)
    assert (frame == [0, 255, 0]).all(-1).sum() > 0
    assert decode_png(map_png).shape == viz.MAP_SIZE + (3,)
    assert (vdir / "frame.png").exists() and (vdir / "map.png").exists()


def test_viewer_modules_import_no_drawing_library():
    code = ("import sys\n"
            "import orb_slam2_tpu_torch.utils.viz, "
            "orb_slam2_tpu_torch.utils.viewer, orb_slam2_tpu_torch.parallel, "
            "orb_slam2_tpu_torch.cli\n"
            "print(sorted(m for m in ('cv2', 'matplotlib', 'PIL', 'jax', "
            "'orb_slam2_tpu') if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
