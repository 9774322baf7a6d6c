"""Binary PLY export — replaces the happly usage of src/System.cc.

The whole-map writer (SaveMap, src/System.cc:212-234) and the reader of
``orb_slam2_tpu/utils/ply.py``, host numpy only; the per-frame tracked
writer comes with the tracked-map export.
"""
from __future__ import annotations

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
