"""Offline visualization: the headless stand-in for the reference's
Pangolin viewer (src/Viewer.cc, src/FrameDrawer.cc, src/MapDrawer.cc).

Port of ``orb_slam2_tpu/utils/viz.py``, with no cv2, matplotlib or PIL
(the card's machine has none of them):

- :func:`draw_frame` (FrameDrawer::DrawFrame, src/FrameDrawer.cc:51-248):
  the current image with tracked keypoints as green crosses and
  untracked ones as small red crosses, bit for bit the JAX package's
  RGB array;
- :func:`draw_map` (MapDrawer::DrawMapPoints / DrawKeyFrames,
  src/MapDrawer.cc:50-235): map points, keyframe frusta, covisibility
  edges (weight >= ``covis_weight``), the spanning tree and loop edges,
  in the JAX package's colours;
- :func:`resize_without_moire`: the fork's multi-step downscale
  (FrameDrawer::ResizeWithoutMoirePattern, src/FrameDrawer.cc:291).

Two divergences by design:
- ``draw_map`` rasterizes an orthographic view at the same ``elev`` /
  ``azim`` (and the JAX figure's 1:1:0.5 box) into an RGB uint8 array,
  which it returns, where the JAX package draws a matplotlib 3D figure;
- ``draw_frame(path=...)`` writes the array as a PNG whose title (the
  KFs / MPs / Matches line) is a PNG ``tEXt`` chunk, not drawn text.

PNGs are written by :func:`encode_png` (stdlib ``zlib`` and ``struct``).
"""
from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

# the JAX figure: figsize (10, 8) at 100 dpi
MAP_SIZE = (800, 1000)          # (height, width) of draw_map's image
_MARGIN = 20
_COLOURS = {"k": (0, 0, 0), "b": (0, 0, 255), "g": (0, 128, 0),
            "r": (255, 0, 0)}   # matplotlib's single-letter colours


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


# ----------------------------------------------------------------------
# PNG
# ----------------------------------------------------------------------
def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray, text: str = "") -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, every row filter 0, zlib
    level 1: the viewer encodes a frame every 0.4 s), with ``text`` as a
    ``tEXt`` chunk keyed "Title" when given."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = rgb.reshape(h, 3 * w)
    out = [b"\x89PNG\r\n\x1a\n",
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))]
    if text:
        out.append(_chunk(b"tEXt", b"Title\x00"
                          + text.encode("latin-1", "replace")))
    out.append(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def save_png(path: str, rgb: np.ndarray, text: str = "") -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgb, text))


# ----------------------------------------------------------------------
# Frames
# ----------------------------------------------------------------------
def resize_without_moire(img, target_w: int, target_h: int) -> np.ndarray:
    """Multi-step halving before the final resize so high-frequency
    texture doesn't alias into moire bands (src/FrameDrawer.cc:291)."""
    out = np.asarray(_host(img), np.float32)
    while out.shape[1] >= 2 * target_w and out.shape[0] >= 2 * target_h:
        h2, w2 = out.shape[0] // 2, out.shape[1] // 2
        out = 0.25 * (out[0:2*h2:2, 0:2*w2:2] + out[1:2*h2:2, 0:2*w2:2]
                      + out[0:2*h2:2, 1:2*w2:2] + out[1:2*h2:2, 1:2*w2:2])
    # final bilinear step by index mapping
    ys = np.linspace(0, out.shape[0] - 1, target_h)
    xs = np.linspace(0, out.shape[1] - 1, target_w)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, out.shape[0] - 1)
    x1 = np.minimum(x0 + 1, out.shape[1] - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    return ((1 - wy) * (1 - wx) * out[np.ix_(y0, x0)]
            + (1 - wy) * wx * out[np.ix_(y0, x1)]
            + wy * (1 - wx) * out[np.ix_(y1, x0)]
            + wy * wx * out[np.ix_(y1, x1)])


def _cross_pixels(xs, ys, r, h, w):
    """Flat pixel indices of the crosses of radius r at (xs, ys), and the
    cross each belongs to: the row y over [x - r, x + r] and the column
    x over [y - r, y + r], clipped to the image."""
    k = np.arange(-r, r + 1)
    hx = xs[:, None] + k                            # (n, 2r + 1)
    vy = ys[:, None] + k
    inside_h = (hx >= 0) & (hx < w)
    inside_v = (vy >= 0) & (vy < h)
    ys_b = np.broadcast_to(ys[:, None], hx.shape)
    xs_b = np.broadcast_to(xs[:, None], vy.shape)
    owner = np.broadcast_to(np.arange(len(xs))[:, None], hx.shape)
    pix = np.concatenate([(ys_b * w + hx)[inside_h], (vy * w + xs_b)[inside_v]])
    who = np.concatenate([owner[inside_h], owner[inside_v]])
    return pix, who


def draw_frame(image, frame, store=None,
               path: Optional[str] = None) -> np.ndarray:
    """Render the FrameDrawer overlay into an RGB uint8 array (and
    optionally a PNG): green = tracked keypoint (bound to a live map
    point), red = detected but unmatched (src/FrameDrawer.cc:96-180).

    The crosses are drawn in keypoint order, as the JAX package's loop
    draws them (a later cross covers an earlier one), in one vectorized
    pass: each pixel takes the colour of the last cross over it."""
    img = np.asarray(_host(image), np.float32)
    if img.ndim == 2:
        rgb = np.stack([img] * 3, -1)
    else:
        rgb = img[..., :3].copy()
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    h, w = rgb.shape[:2]
    idx = np.where(_host(frame.valid))[0]
    xy = _host(frame.xy_raw)[idx]
    x = xy[:, 0].astype(np.int64)      # int(): toward zero
    y = xy[:, 1].astype(np.int64)
    inb = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    idx, x, y = idx[inb], x[inb], y[inb]
    pid = np.asarray(frame.mp_ids)[idx]
    ok = (pid >= 0) & ~np.asarray(frame.mp_outlier, bool)[idx]
    if store is not None:
        live = np.asarray(store.mp_valid, bool)
        ok &= live[np.where(pid >= 0, pid, 0)]
    n_tracked = int(ok.sum())
    order = np.arange(len(idx))
    pix_g, who_g = _cross_pixels(x[ok], y[ok], 3, h, w)
    pix_r, who_r = _cross_pixels(x[~ok], y[~ok], 1, h, w)
    pix = np.concatenate([pix_g, pix_r])
    rank = np.concatenate([order[ok][who_g], order[~ok][who_r]])
    last = np.full(h * w, -1, np.int64)
    np.maximum.at(last, pix, rank)
    is_green = np.zeros(len(order), bool)
    is_green[order[ok]] = True
    covered = np.nonzero(last >= 0)[0]
    flat = rgb.reshape(-1, 3)
    flat[covered] = np.where(is_green[last[covered]][:, None],
                             np.array([0, 255, 0], np.uint8),
                             np.array([255, 0, 0], np.uint8))
    if path is not None:
        save_png(path, rgb, text=(
            f"KFs: {store.n_valid_keyframes() if store else '?'}  "
            f"MPs: {store.n_valid_points() if store else '?'}  "
            f"Matches: {n_tracked}"))
    return rgb


# ----------------------------------------------------------------------
# The map
# ----------------------------------------------------------------------
def _frustum_lines(Tcw: np.ndarray, scale: float = 0.3):
    """Camera frustum wireframe in world coords (MapDrawer::DrawKeyFrames
    glVertex pattern, src/MapDrawer.cc:94-150)."""
    w, h, z = 0.5 * scale, 0.3 * scale, 0.4 * scale
    corners = np.array([[0, 0, 0], [w, h, z], [-w, h, z],
                        [-w, -h, z], [w, -h, z]])
    Twc = np.linalg.inv(Tcw)
    pts = corners @ Twc[:3, :3].T + Twc[:3, 3]
    idx = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    return [(pts[i], pts[j]) for i, j in idx]


def map_primitives(store, show_graph: bool = True, covis_weight: int = 100
                   ) -> Tuple[np.ndarray, List[tuple]]:
    """What :func:`draw_map` draws: the valid map points (N, 3) and the
    segments (a, b, colour, line width) in drawing order, the calls the
    JAX package makes to ``ax.scatter`` and ``ax.plot``."""
    valid = np.asarray(store.mp_valid, bool)
    pts = np.asarray(store.mp_pos)[:len(valid)][valid].reshape(-1, 3)
    segs = []
    for kf in store.kfs:
        if not kf.valid:
            continue
        for a, b in _frustum_lines(kf.Tcw):
            segs.append((a, b, "b", 0.5))
    if show_graph:
        centers = {kf.kid: -kf.Tcw[:3, :3].T @ kf.Tcw[:3, 3]
                   for kf in store.kfs if kf.valid}
        drawn = set()
        for kid, c in centers.items():
            # covisibility edges >= weight threshold
            for other, wgt in store.covis[kid].items():
                key = (min(kid, other), max(kid, other))
                if wgt >= covis_weight and other in centers \
                        and key not in drawn:
                    drawn.add(key)
                    segs.append((c, centers[other], "g", 0.4))
            # spanning tree
            parent = store.kfs[kid].parent
            if parent >= 0 and parent in centers:
                segs.append((c, centers[parent], "g", 0.8))
            # loop edges
            for le in store.kfs[kid].loop_edges:
                if le in centers:
                    segs.append((c, centers[le], "r", 1.0))
    return pts, segs


def _view(elev: float, azim: float):
    """Screen axes (right, up) of an orthographic camera at mplot3d's
    elevation / azimuth (degrees)."""
    e, a = np.radians(elev), np.radians(azim)
    right = np.array([-np.sin(a), np.cos(a), 0.0])
    up = np.array([-np.sin(e) * np.cos(a), -np.sin(e) * np.sin(a),
                   np.cos(e)])
    return right, up


def rasterize_map(pts: np.ndarray, segs: List[tuple], elev: float = -70.0,
                  azim: float = -90.0) -> np.ndarray:
    """Orthographic RGB uint8 rendering of map primitives on white: the
    data box scaled to 1:1:0.5 (the JAX figure's box aspect), viewed at
    ``elev`` / ``azim``; points as 1-pixel black dots, segments in their
    colours, thicker than 0.6 as 2 pixels."""
    h, w = MAP_SIZE
    rgb = np.full((h, w, 3), 255, np.uint8)
    ends = [np.asarray(s[0], np.float64) for s in segs] + \
        [np.asarray(s[1], np.float64) for s in segs]
    allp = np.concatenate([np.asarray(pts, np.float64).reshape(-1, 3),
                           np.asarray(ends).reshape(-1, 3)])
    if len(allp) == 0:
        return rgb
    lo, hi = allp.min(0), allp.max(0)
    span = np.where(hi - lo > 1e-9, hi - lo, 1.0)
    aspect = np.array([1.0, 1.0, 0.5])
    right, up = _view(elev, azim)
    box = np.array(np.meshgrid([0, 1], [0, 1], [0, 1])).reshape(3, -1).T \
        * aspect
    bx, by = box @ right, box @ up
    s = min((w - 2 * _MARGIN) / max(bx.max() - bx.min(), 1e-9),
            (h - 2 * _MARGIN) / max(by.max() - by.min(), 1e-9))
    ox = (w - s * (bx.max() - bx.min())) / 2 - s * bx.min()
    oy = (h - s * (by.max() - by.min())) / 2 + s * by.max()

    def screen(p):
        q = (np.asarray(p, np.float64).reshape(-1, 3) - lo) / span * aspect
        return ox + s * (q @ right), oy - s * (q @ up)

    if len(pts):
        sx, sy = screen(pts)
        xi, yi = np.round(sx).astype(np.int64), np.round(sy).astype(np.int64)
        m = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        rgb[yi[m], xi[m]] = _COLOURS["k"]
    for a, b, colour, lw in segs:
        (ax_,), (ay,) = screen(a)
        (bx_,), (by_,) = screen(b)
        n = int(max(abs(bx_ - ax_), abs(by_ - ay))) + 1
        t = np.linspace(0.0, 1.0, n + 1)
        xi = np.round(ax_ + t * (bx_ - ax_)).astype(np.int64)
        yi = np.round(ay + t * (by_ - ay)).astype(np.int64)
        if lw > 0.6:
            xi, yi = np.concatenate([xi, xi + 1]), np.concatenate([yi, yi])
        m = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        rgb[yi[m], xi[m]] = _COLOURS[colour]
    return rgb


def draw_map(store, path: Optional[str] = None, show_graph: bool = True,
             covis_weight: int = 100, elev: float = -70.0,
             azim: float = -90.0) -> np.ndarray:
    """The map as an RGB uint8 array (and a PNG at ``path``): points,
    keyframe frusta, covisibility graph (weight >= ``covis_weight``),
    spanning tree and loop edges (src/MapDrawer.cc:50-235)."""
    pts, segs = map_primitives(store, show_graph, covis_weight)
    rgb = rasterize_map(pts, segs, elev=elev, azim=azim)
    if path is not None:
        save_png(path, rgb)
    return rgb
