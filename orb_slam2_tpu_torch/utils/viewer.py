"""Live observability surface: the reference Viewer thread's role
(src/Viewer.cc:84, a GUI loop redrawing FrameDrawer + MapDrawer while
tracking runs) for headless machines.

Port of ``orb_slam2_tpu/utils/viewer.py``, with no cv2, matplotlib or
PIL (PNGs come from ``viz.encode_png``):

- an HTTP endpoint on 127.0.0.1 ("/" dashboard, "/frame.png",
  "/map.png", "/status.json") served from a background thread,
  watchable in a browser WHILE a sequence tracks;
- optionally the same PNGs refreshed on disk (``out_dir``).

The tracking thread's cost per frame is one reference swap under a lock
(``update``); all drawing happens on the viewer's own thread at a
throttled rate (FrameDrawer::Update copies state, the GUI thread draws
it, src/FrameDrawer.cc:51-90).  On the card the render thread reads the
frame's image and keypoints back from the device; those copies wait on
the stream the tracker shares, not on the tracker's thread.  The map's
points and edges are gathered under the map lock and drawn after it is
released.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import numpy as np

from . import viz

_INDEX_HTML = b"""<!doctype html>
<html><head><title>orb_slam2_tpu live</title><style>
body { background:#111; color:#ddd; font-family:monospace; margin:1em }
img { max-width:48%%; border:1px solid #333; vertical-align:top }
#status { margin:0.5em 0; white-space:pre }
</style></head><body>
<h3>orb_slam2_tpu &mdash; live viewer</h3>
<div id="status">connecting...</div>
<img id="frame" src="/frame.png"/> <img id="map" src="/map.png"/>
<script>
async function tick() {
  try {
    const r = await fetch('/status.json'); const s = await r.json();
    document.getElementById('status').textContent = JSON.stringify(s);
    document.getElementById('frame').src = '/frame.png?t=' + Date.now();
    if (s.map_age_s < 1e8)
      document.getElementById('map').src = '/map.png?t=' + Date.now();
  } catch (e) {}
  setTimeout(tick, 700);
}
tick();
</script></body></html>"""


class LiveViewer:
    """Watchable state of a RUNNING System.

    Wire with ``viewer.attach(system)`` (hooks the per-frame callback)
    or call ``viewer.update(image, frame)`` per frame, then
    ``viewer.close()`` at shutdown.  ``port=0`` picks a free port
    (exposed as ``viewer.port``); ``port=None`` serves nothing (PNG
    files only)."""

    def __init__(self, store, port: Optional[int] = 0,
                 out_dir: Optional[str] = None,
                 frame_period_s: float = 0.4, map_period_s: float = 3.0):
        self.store = store
        self.out_dir = out_dir
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        self.frame_period_s = frame_period_s
        self.map_period_s = map_period_s
        self._lock = threading.Lock()
        self._latest = None          # (image, frame) refs, swapped per frame
        self._stats = {}
        self._frame_png = viz.encode_png(np.zeros((8, 8, 3), np.uint8))
        self._map_png = self._frame_png
        self._map_ts = 0.0
        self._stop = threading.Event()
        self._t0 = time.time()
        self._n_updates = 0

        self._worker = threading.Thread(target=self._render_loop,
                                        name="viewer-render", daemon=True)
        self._worker.start()

        self.port = None
        self._httpd = None
        if port is not None:
            self._start_http(port)

    # ------------------------------------------------------------------
    def attach(self, system) -> "LiveViewer":
        """Hook into a System: chains on the system's per-frame tracked
        callback (keeps any existing one)."""
        prev = getattr(system, "on_frame_tracked", None)

        def hook(image, frame):
            if prev is not None:
                prev(image, frame)
            self.update(image, frame, state=system.state.name)

        system.on_frame_tracked = hook
        return self

    def update(self, image, frame, state: str = ""):
        """Called from the tracking thread: an O(1) reference swap (the
        counts read host arrays only)."""
        with self._lock:
            self._latest = (image, frame)
            self._n_updates += 1
            self._stats = {
                "state": state,
                "frame_id": getattr(frame, "frame_id", -1),
                "n_tracked": int(frame.n_tracked()) if frame is not None
                else 0,
                "keyframes": self.store.n_valid_keyframes(),
                "map_points": int(np.asarray(self.store.mp_valid).sum())
                if len(self.store.kfs) else 0,
                "uptime_s": round(time.time() - self._t0, 1),
                "frames_seen": self._n_updates,
            }

    # ------------------------------------------------------------------
    def _render_loop(self):
        last_map = 0.0
        while not self._stop.wait(self.frame_period_s):
            with self._lock:
                latest = self._latest
            if latest is None:
                continue
            image, frame = latest
            try:
                png = viz.encode_png(viz.draw_frame(image, frame,
                                                    store=self.store))
                self._frame_png = png
                if self.out_dir:
                    self._write(os.path.join(self.out_dir, "frame.png"), png)
            except Exception:
                pass
            now = time.time()
            if now - last_map >= self.map_period_s and self.store.kfs:
                try:
                    with self.store.lock:
                        pts, segs = viz.map_primitives(self.store)
                    png = viz.encode_png(viz.rasterize_map(pts, segs))
                    self._map_png = png
                    if self.out_dir:
                        self._write(os.path.join(self.out_dir, "map.png"),
                                    png)
                    self._map_ts = now
                    last_map = now
                except Exception:
                    last_map = now  # don't spin on render errors

    @staticmethod
    def _write(path: str, data: bytes):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    # ------------------------------------------------------------------
    def _start_http(self, port: int):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/" or path == "/index.html":
                    body, ctype = _INDEX_HTML, "text/html"
                elif path == "/frame.png":
                    body, ctype = viewer._frame_png, "image/png"
                elif path == "/map.png":
                    body, ctype = viewer._map_png, "image/png"
                elif path == "/status.json":
                    with viewer._lock:
                        s = dict(viewer._stats)
                    s["map_age_s"] = round(time.time() - viewer._map_ts, 1) \
                        if viewer._map_ts else 1e9
                    body = json.dumps(s).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        t = threading.Thread(target=self._httpd.serve_forever,
                             name="viewer-http", daemon=True)
        t.start()

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
