"""Map checkpoint / resume (port of ``orb_slam2_tpu/models/serialize.py``:
the same npz layout and ``_FORMAT_VERSION``, so a map saved by either
package loads in the other).

The reference has NO map persistence — ``LoadMap`` is commented out
(include/System.h:92, SURVEY.md §5) and only PLY exports exist.  This
module adds full map serialization: every map point (position,
descriptor, normal, scale band, observations), every keyframe (feature
SoA + pose + spanning tree + loop edges) and the covisibility graph are
written to one compressed npz; loading reconstructs a MapStore that can
resume tracking / relocalization / loop closing.

The host MapStore is authoritative in the port as in the JAX package:
saving reads its numpy arrays and the keyframes' host feature fields
(a keyframe's features that still live only on the device are copied to
the host).  Loading rebuilds the store on ``device``: the host arrays
and mirrors, then the device point store in one upload; keyframe
features go to the device when a search first asks for them.
"""
from __future__ import annotations

import numpy as np

from .frame import Frame
from .mapstore import KeyFrame, MapStore

_FORMAT_VERSION = 1


def save_map(store: MapStore, path: str):
    n_pts = store.n_points()
    # --- map points ---
    obs_flat = []       # (pid, kid, feat)
    for pid in range(n_pts):
        for kid, fi in store.mp_obs[pid].items():
            obs_flat.append((pid, kid, fi))
    obs_flat = (np.asarray(obs_flat, np.int64).reshape(-1, 3)
                if obs_flat else np.zeros((0, 3), np.int64))

    # --- keyframes: concatenated feature SoA with offsets ---
    kfs = store.kfs
    offsets = np.zeros(len(kfs) + 1, np.int64)
    for i, kf in enumerate(kfs):
        offsets[i + 1] = offsets[i] + kf.frame.n

    def cat(getter, dtype, width=None):
        if not kfs:
            shape = (0,) if width is None else (0, width)
            return np.zeros(shape, dtype)
        return np.concatenate([np.asarray(getter(kf.frame), dtype)
                               for kf in kfs])

    covis_flat = []
    for kid, edges in enumerate(store.covis):
        for other, w in edges.items():
            covis_flat.append((kid, other, w))
    covis_flat = (np.asarray(covis_flat, np.int64).reshape(-1, 3)
                  if covis_flat else np.zeros((0, 3), np.int64))

    children_flat = []
    loop_flat = []
    for kf in kfs:
        for ch in kf.children:
            children_flat.append((kf.kid, ch))
        for le in kf.loop_edges:
            loop_flat.append((kf.kid, le))

    np.savez_compressed(
        path,
        version=_FORMAT_VERSION,
        # points
        mp_pos=np.asarray(store.mp_pos, np.float32).reshape(n_pts, 3)
        if n_pts else np.zeros((0, 3), np.float32),
        mp_desc=np.asarray(store.mp_desc, np.uint32).reshape(n_pts, 8)
        if n_pts else np.zeros((0, 8), np.uint32),
        mp_normal=np.asarray(store.mp_normal, np.float32).reshape(n_pts, 3)
        if n_pts else np.zeros((0, 3), np.float32),
        mp_min_dist=np.asarray(store.mp_min_dist, np.float32),
        mp_max_dist=np.asarray(store.mp_max_dist, np.float32),
        mp_valid=np.asarray(store.mp_valid, bool),
        mp_first_kf=np.asarray(store.mp_first_kf, np.int64),
        mp_first_frame=np.asarray(store.mp_first_frame, np.int64),
        mp_n_visible=np.asarray(store.mp_n_visible, np.int64),
        mp_n_found=np.asarray(store.mp_n_found, np.int64),
        mp_replaced_by=np.asarray(store.mp_replaced_by, np.int64),
        obs=obs_flat,
        # keyframes
        kf_offsets=offsets,
        kf_Tcw=np.stack([kf.Tcw for kf in kfs]) if kfs
        else np.zeros((0, 4, 4), np.float32),
        kf_valid=np.asarray([kf.valid for kf in kfs], bool),
        kf_parent=np.asarray([kf.parent for kf in kfs], np.int64),
        kf_frame_id=np.asarray([kf.frame.frame_id for kf in kfs], np.int64),
        kf_timestamp=np.asarray([kf.frame.timestamp for kf in kfs],
                                np.float64),
        kf_first_connection=np.asarray(
            [kf.first_connection for kf in kfs], bool),
        children=np.asarray(children_flat, np.int64).reshape(-1, 2),
        loop_edges=np.asarray(loop_flat, np.int64).reshape(-1, 2),
        covis=covis_flat,
        # feature SoA
        f_xy=cat(lambda f: f.xy, np.float32, 2),
        f_xy_raw=cat(lambda f: f.xy_raw, np.float32, 2),
        f_response=cat(lambda f: f.response, np.float32),
        f_angle=cat(lambda f: f.angle, np.float32),
        f_octave=cat(lambda f: f.octave, np.int32),
        f_desc=cat(lambda f: f.desc, np.uint32, 8),
        f_valid=cat(lambda f: f.valid, bool),
        f_mp_ids=cat(lambda f: f.mp_ids, np.int32),
        # scale info
        scale_factor=getattr(store, "_scale_factor", 1.2),
        n_levels=getattr(store, "_n_levels", 8),
        max_kf_id=store.max_kf_id,
    )


def load_map(path: str, device="cuda",
             dev_capacity: int = 65536) -> MapStore:
    z = np.load(path, allow_pickle=False)
    if int(z["version"]) != _FORMAT_VERSION:
        raise ValueError(f"unsupported map version {int(z['version'])}")
    store = MapStore(dev_capacity=dev_capacity, device=device)
    store.set_scale_info(float(z["scale_factor"]), int(z["n_levels"]))
    store.max_kf_id = int(z["max_kf_id"])

    from .mapstore import _GrowArray
    n_pts = len(z["mp_valid"])
    store.mp_pos = _GrowArray.from_data(z["mp_pos"].astype(np.float32))
    store.mp_desc = _GrowArray.from_data(z["mp_desc"].astype(np.uint32))
    store.mp_normal = _GrowArray.from_data(z["mp_normal"].astype(np.float32))
    store.mp_min_dist = _GrowArray.from_data(
        z["mp_min_dist"].astype(np.float32))
    store.mp_max_dist = _GrowArray.from_data(
        z["mp_max_dist"].astype(np.float32))
    store.mp_valid = _GrowArray.from_data(z["mp_valid"].astype(bool),
                                          fill=False)
    store.mp_first_kf = _GrowArray.from_data(z["mp_first_kf"])
    store.mp_first_frame = _GrowArray.from_data(z["mp_first_frame"])
    store.mp_n_visible = _GrowArray.from_data(z["mp_n_visible"])
    store.mp_n_found = _GrowArray.from_data(z["mp_n_found"])
    store.mp_replaced_by = _GrowArray.from_data(z["mp_replaced_by"], fill=-1)
    store.mp_obs = [dict() for _ in range(n_pts)]
    from .mapstore import _ObsMirror
    store.obs = _ObsMirror()
    for _ in range(n_pts):
        store.obs.add_row()

    offsets = z["kf_offsets"]
    n_kf = len(offsets) - 1
    for kid in range(n_kf):
        a, b = int(offsets[kid]), int(offsets[kid + 1])
        frame = Frame(
            frame_id=int(z["kf_frame_id"][kid]),
            timestamp=float(z["kf_timestamp"][kid]),
            xy=z["f_xy"][a:b].copy(),
            xy_raw=z["f_xy_raw"][a:b].copy(),
            response=z["f_response"][a:b].copy(),
            angle=z["f_angle"][a:b].copy(),
            octave=z["f_octave"][a:b].copy(),
            desc=z["f_desc"][a:b].copy(),
            valid=z["f_valid"][a:b].copy(),
            Tcw=z["kf_Tcw"][kid].copy(),
            mp_ids=z["f_mp_ids"][a:b].copy(),
            mp_outlier=np.zeros(b - a, bool),
            device=device,
        )
        kf = KeyFrame(kid=kid, frame=frame, Tcw=z["kf_Tcw"][kid].copy(),
                      parent=int(z["kf_parent"][kid]),
                      valid=bool(z["kf_valid"][kid]),
                      first_connection=bool(z["kf_first_connection"][kid]))
        store.kfs.append(kf)
        store.covis.append({})
    for kid, ch in z["children"]:
        store.kfs[int(kid)].children.add(int(ch))
    for kid, le in z["loop_edges"]:
        store.kfs[int(kid)].loop_edges.add(int(le))
    for kid, other, w in z["covis"]:
        store.covis[int(kid)][int(other)] = int(w)
    for pid, kid, fi in z["obs"]:
        store.mp_obs[int(pid)][int(kid)] = int(fi)
        store.obs.add(int(pid), int(kid), int(fi))
    store.dev_points.sync(store)  # the device point store, in one upload
    return store
