"""Start the port from the JAX package's state, given as numpy arrays.

Tests use these to put both packages in one state and compare what each
does next.  Nothing here imports jax: the JAX package's state arrives as
numpy arrays and plain Python containers (``np.asarray`` of its device
arrays; its MapStore is host numpy already).  Descriptors arrive as
uint32 words and become the port's int32 tensors with the same bits.
The functions here build on the CPU unless given a device, unlike the
port's constructors (which default to ``"cuda"``): they exist for the
CPU parity tests.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .models.frame import Frame, to_device
from .models.mapstore import KeyFrame, MapStore, _GrowArray
from .models.vocabulary import Vocabulary
from .ops.extractor import Features


def features_from_numpy(xy, response, angle, octave, desc, valid,
                        device="cpu") -> Features:
    """The ``Features`` fields (desc as (N, 8) uint32) -> port Features."""
    return Features(
        xy=to_device("xy", np.asarray(xy, np.float32), device),
        response=to_device("response", np.asarray(response, np.float32),
                           device),
        angle=to_device("angle", np.asarray(angle, np.float32), device),
        octave=to_device("octave", np.asarray(octave, np.int32), device),
        desc=to_device("desc", np.asarray(desc, np.uint32), device),
        valid=to_device("valid", np.asarray(valid, bool), device))


def frame_from_numpy(frame_id: int, timestamp: float, Tcw, mp_ids,
                     mp_outlier, xy, xy_raw, response, angle, octave, desc,
                     valid, device="cpu") -> Frame:
    """A port Frame holding the given host fields (device copies are
    made on first use)."""
    return Frame(
        frame_id=int(frame_id), timestamp=float(timestamp),
        Tcw=np.array(Tcw, np.float32),
        mp_ids=np.array(mp_ids, np.int32),
        mp_outlier=np.array(mp_outlier, bool),
        device=device,
        xy=np.array(xy, np.float32), xy_raw=np.array(xy_raw, np.float32),
        response=np.array(response, np.float32),
        angle=np.array(angle, np.float32),
        octave=np.array(octave, np.int32),
        desc=np.array(desc, np.uint32), valid=np.array(valid, bool))


_POINT_COLUMNS = (
    # name, dtype, fill of the growable column
    ("mp_pos", np.float32, 0), ("mp_desc", np.uint32, 0),
    ("mp_normal", np.float32, 0), ("mp_min_dist", np.float32, 0),
    ("mp_max_dist", np.float32, 0), ("mp_valid", bool, False),
    ("mp_first_kf", np.int64, 0), ("mp_n_visible", np.int64, 0),
    ("mp_n_found", np.int64, 0), ("mp_replaced_by", np.int64, -1),
    ("mp_first_frame", np.int64, 0),
)

FRAME_FIELDS = ("frame_id", "timestamp", "Tcw", "mp_ids", "mp_outlier",
                "xy", "xy_raw", "response", "angle", "octave", "desc",
                "valid")


def mapstore_from_numpy(points: Dict[str, np.ndarray],
                        mp_obs: List[Dict[int, int]],
                        keyframes: List[dict],
                        covis: List[Dict[int, int]],
                        scale_factor: float, n_levels: int,
                        obs_mirror: tuple,
                        dev_capacity: int = 65536,
                        device="cpu") -> MapStore:
    """A port MapStore in the given state.

    points   : the point SoA, one array per name in ``_POINT_COLUMNS``
               (``mp_pos`` (P, 3), ``mp_desc`` (P, 8) uint32, ...).
    mp_obs   : per point {kid: feature index}.
    keyframes: per keyframe a dict with ``kid``, ``Tcw``, ``parent``,
               ``children``, ``loop_edges``, ``valid``,
               ``first_connection`` and ``frame``, itself a dict of
               ``FRAME_FIELDS``.
    covis    : per keyframe {kid: weight} (the covisibility graph).
    obs_mirror: (kid (P, S), fi (P, S), n (P,)) slot arrays of the
               observation mirror; its slot order decides ties in the
               descriptor medoid.
    """
    store = MapStore(dev_capacity=dev_capacity, device=device)
    store.set_scale_info(scale_factor, n_levels)
    for name, dtype, fill in _POINT_COLUMNS:
        setattr(store, name, _GrowArray.from_data(
            np.asarray(points[name], dtype), fill=fill))
    n_pts = len(store.mp_pos)
    store.mp_obs = [dict(o) for o in mp_obs]
    store.obs.add_rows(n_pts)
    store.obs.kid, store.obs.fi, store.obs.n = (
        np.array(a, np.int32) for a in obs_mirror)
    for k in keyframes:
        frame = frame_from_numpy(**k["frame"], device=device)
        store.kfs.append(KeyFrame(
            kid=int(k["kid"]), frame=frame,
            Tcw=np.array(k["Tcw"], np.float32),
            parent=int(k["parent"]), children=set(k["children"]),
            loop_edges=set(k["loop_edges"]),
            first_connection=bool(k["first_connection"]),
            valid=bool(k["valid"])))
    store.covis = [dict(c) for c in covis]
    store.max_kf_id = len(store.kfs) - 1
    store.dirty_points = set(range(n_pts))
    return store


def mapstore_state(store) -> dict:
    """The keyword arguments of :func:`mapstore_from_numpy` read from a
    MapStore of either package (both are host numpy); every array is a
    copy, so the snapshot survives later changes to the store."""
    def frame_dict(f):
        return {name: np.array(getattr(f, name)) if name not in
                ("frame_id", "timestamp") else getattr(f, name)
                for name in FRAME_FIELDS}

    return dict(
        points={name: np.array(getattr(store, name))
                for name, _, _ in _POINT_COLUMNS},
        mp_obs=[dict(o) for o in store.mp_obs],
        keyframes=[dict(kid=kf.kid, Tcw=np.array(kf.Tcw), parent=kf.parent,
                        children=set(kf.children),
                        loop_edges=set(kf.loop_edges), valid=kf.valid,
                        first_connection=kf.first_connection,
                        frame=frame_dict(kf.frame))
                   for kf in store.kfs],
        covis=[dict(c) for c in store.covis],
        obs_mirror=tuple(np.array(a) for a in
                         (store.obs.kid, store.obs.fi, store.obs.n)),
        scale_factor=getattr(store, "_scale_factor", 1.2),
        n_levels=getattr(store, "_n_levels", 8),
    )


def vocabulary_from_numpy(k: int, levels: int, centers, idf,
                          node_level: int) -> Vocabulary:
    """A port Vocabulary with the given tree: per-level (k**(l+1), 8)
    uint32 centers and the (k**levels,) idf (copies)."""
    return Vocabulary(k=int(k), levels=int(levels),
                      centers=[np.array(c, np.uint32) for c in centers],
                      idf=np.array(idf, np.float32),
                      node_level=int(node_level))
