"""Binary PLY export — replaces the happly usage of src/System.cc.

Port of ``orb_slam2_tpu/utils/ply.py``, host numpy only.  Two writers
mirroring the reference's outputs:
- ``write_ply_points``     : whole-map export (SaveMap, src/System.cc:212-234).
- ``write_tracked_frame``  : per-frame tracked points with RGB, pixel
  coords, octave, and an embedded frame element carrying the flattened
  pose and K (SaveTrackedMap, src/System.cc:260-322).
"""
from __future__ import annotations

import struct

import numpy as np


def write_ply_points(path: str, pts: np.ndarray, colors: np.ndarray | None = None):
    n = len(pts)
    has_color = colors is not None
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {n}",
               "property float x", "property float y", "property float z"]
        if has_color:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += ["end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        pts = np.asarray(pts, "<f4")
        if has_color:
            colors = np.asarray(colors, np.uint8)
            for p, c in zip(pts, colors):
                f.write(p.tobytes() + c.tobytes())
        else:
            f.write(pts.tobytes())


def write_tracked_frame(path: str, frame_id: int, Tcw: np.ndarray,
                        K: np.ndarray, pts_cam: np.ndarray,
                        colors: np.ndarray, uv: np.ndarray,
                        octave: np.ndarray):
    """Per-frame export: camera-space points + appearance + the frame
    element (id, flattened Tcw, flattened K) — same schema as
    src/System.cc:260-322."""
    n = len(pts_cam)
    with open(path, "wb") as f:
        hdr = [
            "ply", "format binary_little_endian 1.0",
            f"element vertex {n}",
            "property float x", "property float y", "property float z",
            "property uchar red", "property uchar green", "property uchar blue",
            "property float u", "property float v",
            "property int octave",
            "element frame 1",
            "property int id",
        ]
        hdr += [f"property float tcw{i}" for i in range(16)]
        hdr += [f"property float k{i}" for i in range(9)]
        hdr += ["end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        pts_cam = np.asarray(pts_cam, "<f4")
        uv = np.asarray(uv, "<f4")
        colors = np.asarray(colors, np.uint8)
        octave = np.asarray(octave, "<i4")
        for i in range(n):
            f.write(pts_cam[i].tobytes() + colors[i].tobytes()
                    + uv[i].tobytes() + octave[i:i+1].tobytes())
        f.write(struct.pack("<i", frame_id))
        f.write(np.asarray(Tcw, "<f4").reshape(-1).tobytes())
        f.write(np.asarray(K, "<f4").reshape(-1).tobytes())


def read_ply_points(path: str) -> np.ndarray:
    """Minimal reader for round-trip tests (xyz only)."""
    with open(path, "rb") as f:
        data = f.read()
    head, _, body = data.partition(b"end_header\n")
    lines = head.decode().splitlines()
    n = 0
    props = []
    in_vertex = False
    for ln in lines:
        if ln.startswith("element vertex"):
            n = int(ln.split()[-1])
            in_vertex = True
        elif ln.startswith("element"):
            in_vertex = False
        elif ln.startswith("property") and in_vertex:
            props.append(ln.split()[1])
    sizes = {"float": 4, "uchar": 1, "int": 4}
    stride = sum(sizes[p] for p in props)
    out = np.zeros((n, 3), np.float32)
    off = 0
    for i in range(n):
        out[i] = np.frombuffer(body[off:off + 12], "<f4")
        off += stride
    return out
