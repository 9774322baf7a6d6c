"""The global map: keyframes + map points + covisibility + spanning tree.

Port of ``orb_slam2_tpu/models/mapstore.py`` (src/Map.cc,
src/MapPoint.cc, src/KeyFrame.cc, the graph parts).  Everything here is
host numpy/python and is copied from the JAX package; the differences
are the port's Frame, the port's native-library loader, and the device
the point mirror (``dev_points``) lives on.

Conventions: keyframes and map points are identified by dense integer
ids (their slot).  Erased entries keep their slot with valid=False —
ids are never reused, matching the reference's monotonically increasing
mnId behavior.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np

from .frame import Frame

COVIS_THRESHOLD = 15  # shared-observation threshold (src/KeyFrame.cc:396-520)


def hamming_np(d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
    """Host popcount Hamming for small sets: (A, 8) x (B, 8) -> (A, B).
    Delegates to the native C++ kernel when built (native/slamcore.cc)."""
    from .. import native
    return native.hamming_matrix(d1, d2)


@dataclass
class KeyFrame:
    kid: int
    frame: Frame                 # owns the SoA feature data + mp_ids
    Tcw: np.ndarray              # (4, 4) — authoritative pose (frame.Tcw is stale)
    # spanning tree + loop edges (src/KeyFrame.h:146-191)
    parent: int = -1
    children: Set[int] = field(default_factory=set)
    loop_edges: Set[int] = field(default_factory=set)
    first_connection: bool = True
    valid: bool = True
    not_erase: bool = False      # loop-closing protection (SetNotErase)
    to_be_erased: bool = False
    # Tcp: pose relative to parent at erase time (for trajectory recovery)
    Tcp: Optional[np.ndarray] = None
    # scratch for GBA propagation (mTcwGBA / mTcwBefGBA)
    Tcw_gba: Optional[np.ndarray] = None
    Tcw_before_gba: Optional[np.ndarray] = None
    ba_global_for_kf: int = -1


class _GrowArray:
    """Amortized-growth numpy SoA column: list-like append + ndarray
    fancy indexing over the live prefix."""

    def __init__(self, width, dtype, fill=0):
        shape = (64,) if width is None else (64, width)
        self._buf = np.full(shape, fill, dtype)
        self._n = 0
        self._fill = fill

    def append(self, value):
        if self._n == len(self._buf):
            # grow to max(64, 2x) rows — a buffer restored from
            # zero-length data (serialize.load_map of an empty map)
            # must still gain capacity
            grow = max(64, len(self._buf))
            shape = (grow,) + self._buf.shape[1:]
            extra = np.full(shape, self._fill, self._buf.dtype)
            self._buf = np.concatenate([self._buf, extra])
        self._buf[self._n] = value
        self._n += 1

    def extend(self, values):
        """Vectorized multi-append (one capacity check + one slice
        write for k rows — the per-point append loop measured
        200 ms/keyframe in the triangulation apply section)."""
        values = np.asarray(values, self._buf.dtype)
        k = len(values)
        need = self._n + k
        if need > len(self._buf):
            cap = max(64, 2 * len(self._buf))
            while cap < need:
                cap *= 2
            extra = np.full((cap - len(self._buf),) + self._buf.shape[1:],
                            self._fill, self._buf.dtype)
            self._buf = np.concatenate([self._buf, extra])
        self._buf[self._n:need] = values
        self._n = need

    @property
    def data(self) -> np.ndarray:
        return self._buf[:self._n]

    def __len__(self):
        return self._n

    def __getitem__(self, idx):
        return self.data[idx]

    def __setitem__(self, idx, value):
        self.data[idx] = value

    def __iter__(self):
        return iter(self.data)

    def __array__(self, dtype=None, copy=None):
        d = self.data
        return d.astype(dtype) if dtype is not None else d

    @classmethod
    def from_data(cls, data: np.ndarray, fill=0) -> "_GrowArray":
        out = cls(None if data.ndim == 1 else data.shape[1],
                  data.dtype, fill=fill)
        out._buf = np.array(data)
        out._n = len(data)
        return out


class _ObsMirror:
    """Flat numpy mirror of the observation graph (pid -> {kid: fi}).

    The dict-of-dicts is the mutation-friendly source of truth; this
    mirror keeps the same links as (P, S) slot arrays so the hot graph
    scans — covisibility counting, keyframe-culling redundancy, BA
    fixed-observer collection — run as vectorized numpy instead of
    nested Python loops (profiled 50 ms/keyframe at reference scale).
    Updated in O(1) per add/erase; columns double on overflow."""

    def __init__(self, slots: int = 16):
        self.kid = np.full((64, slots), -1, np.int32)
        self.fi = np.zeros((64, slots), np.int32)
        self.n = np.zeros(64, np.int32)
        self._rows = 0

    def add_row(self):
        self.add_rows(1)

    def add_rows(self, k: int):
        need = self._rows + k
        if need > len(self.kid):
            grow = max(64, len(self.kid), need - len(self.kid))
            self.kid = np.concatenate(
                [self.kid, np.full((grow, self.kid.shape[1]), -1, np.int32)])
            self.fi = np.concatenate(
                [self.fi, np.zeros((grow, self.fi.shape[1]), np.int32)])
            self.n = np.concatenate([self.n, np.zeros(grow, np.int32)])
        self._rows = need

    def add(self, pid: int, kid: int, fi: int):
        row_k = self.kid[pid]
        n = self.n[pid]
        hit = np.where(row_k[:n] == kid)[0]
        if len(hit):                       # re-bind same keyframe
            self.fi[pid, hit[0]] = fi
            return
        if n == self.kid.shape[1]:         # widen slot capacity
            s = self.kid.shape[1]
            self.kid = np.concatenate(
                [self.kid, np.full((len(self.kid), s), -1, np.int32)], 1)
            self.fi = np.concatenate(
                [self.fi, np.zeros((len(self.fi), s), np.int32)], 1)
        self.kid[pid, n] = kid
        self.fi[pid, n] = fi
        self.n[pid] = n + 1

    def erase(self, pid: int, kid: int):
        n = self.n[pid]
        hit = np.where(self.kid[pid, :n] == kid)[0]
        if len(hit) == 0:
            return
        c = hit[0]
        self.kid[pid, c] = self.kid[pid, n - 1]
        self.fi[pid, c] = self.fi[pid, n - 1]
        self.kid[pid, n - 1] = -1
        self.n[pid] = n - 1

    def clear(self, pid: int):
        self.kid[pid, :self.n[pid]] = -1
        self.n[pid] = 0

    def rows(self, pids):
        """(len(pids), S) kid + fi slot views and counts."""
        pids = np.asarray(pids, np.int64)
        return self.kid[pids], self.fi[pids], self.n[pids]


class MapStore:
    def __init__(self, dev_capacity: int = 65536, device="cuda"):
        # initial row capacity of the device point store (grows by 4x
        # re-allocation past it) and the device it lives on
        self.dev_capacity = int(dev_capacity)
        self.device = device
        # Map::mMutexUpdateMap equivalent (include/Map.h:148-150): the
        # tracking thread and the asynchronous mapper's thread share it
        import threading
        self.lock = threading.RLock()
        # --- map points (numpy SoA with amortized growth) ---
        self.mp_pos = _GrowArray(3, np.float32)
        self.mp_desc = _GrowArray(8, np.uint32)
        self.mp_normal = _GrowArray(3, np.float32)
        self.mp_min_dist = _GrowArray(None, np.float32)
        self.mp_max_dist = _GrowArray(None, np.float32)
        self.mp_valid = _GrowArray(None, bool, fill=False)
        self.mp_obs: List[Dict[int, int]] = []    # pid -> {kid: feat_idx}
        self.obs = _ObsMirror()                   # flat numpy mirror
        # pids whose SoA row changed since the last device sync
        # (consumed by models.device_points.DevicePoints)
        self.dirty_points: set = set()
        self._dev_points = None
        self.mp_first_kf = _GrowArray(None, np.int64)
        self.mp_n_visible = _GrowArray(None, np.int64)
        self.mp_n_found = _GrowArray(None, np.int64)
        self.mp_replaced_by = _GrowArray(None, np.int64, fill=-1)
        self.mp_first_frame = _GrowArray(None, np.int64)

        # --- keyframes ---
        self.kfs: List[KeyFrame] = []
        # covisibility weights: dict kid -> dict kid -> weight
        self.covis: List[Dict[int, int]] = []

        self.max_kf_id = -1
        # notified on KeyFrame::EraseAndSetBad (the reference calls
        # mpKeyFrameDB->erase there); wired by System to PlaceRecognition
        self.on_kf_erased = None
        # incrementally-grown (n_kfs, max_n) table of per-feature
        # octaves (rows are immutable once a KF exists) — lets graph
        # scans gather octaves across MANY keyframes in one fancy index
        # instead of a per-unique-KF python loop
        self._oct_tab = np.zeros((0, 0), np.int16)
        self._oct_rows = 0
        self._desc_tab = np.zeros((0, 0, 8), np.uint32)
        self._desc_rows = 0

    @property
    def dev_points(self):
        """Shared persistent device image of the point SoA (one per
        map — tracker and mapper gather rows from the same arrays)."""
        if self._dev_points is None:
            from .device_points import DevicePoints
            self._dev_points = DevicePoints(min_capacity=self.dev_capacity,
                                            device=self.device)
        return self._dev_points

    def yield_lock(self):
        """Briefly release+reacquire the map lock (no-op when not
        held): lets a camera-rate thread waiting on a short section
        preempt a long mapping host section between two stages."""
        try:
            self.lock.release()
        except RuntimeError:
            return
        import time
        time.sleep(0)  # give the waiter a scheduling slot
        self.lock.acquire()

    def unlocked(self):
        """Context manager that releases ``self.lock`` for the duration
        of a device dispatch+read window, if the calling thread holds
        it (no-op otherwise, so synchronous callers need no lock)."""
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            try:
                self.lock.release()
            except RuntimeError:
                yield  # lock not held by this thread — nothing to drop
                return
            try:
                yield
            finally:
                self.lock.acquire()

        return _ctx()

    # ------------------------------------------------------------------
    # map points
    # ------------------------------------------------------------------
    def n_points(self) -> int:
        return len(self.mp_pos)

    def n_valid_points(self) -> int:
        return int(np.sum(self.mp_valid))

    def add_point(self, pos, desc, normal, min_dist, max_dist,
                  first_kf: int, first_frame: int) -> int:
        pid = len(self.mp_pos)
        self.mp_pos.append(np.asarray(pos, np.float32))
        self.mp_desc.append(np.asarray(desc, np.uint32))
        self.mp_normal.append(np.asarray(normal, np.float32))
        self.mp_min_dist.append(float(min_dist))
        self.mp_max_dist.append(float(max_dist))
        self.mp_valid.append(True)
        self.mp_obs.append({})
        self.obs.add_row()
        self.mp_first_kf.append(first_kf)
        self.mp_n_visible.append(1)
        self.mp_n_found.append(1)
        self.mp_replaced_by.append(-1)
        self.mp_first_frame.append(first_frame)
        self.dirty_points.add(pid)
        return pid

    def add_points_batch(self, pos, desc, kf1: int, fi1, kf2, fi2,
                         first_frame: int, normal=None,
                         min_dist=0.1, max_dist=100.0,
                         first_kf=None) -> np.ndarray:
        """Append ``len(pos)`` points, each observed by exactly two
        keyframes — (kf1, fi1[i]) and (kf2[i], fi2[i]); ``kf2`` may be
        scalar or per-point.  One capacity check + slice write per SoA
        column and direct slot writes into the obs mirror (the rows are
        brand new, so no per-point membership scans).  Equivalent to
        add_point + 2x add_observation per point; used by the
        triangulation and initial-map hot paths
        (MapPoint::AddObservation, src/MapPoint.cc:96-105)."""
        n = len(pos)
        if n == 0:
            return np.zeros(0, np.int64)
        pid0 = len(self.mp_pos)
        pids = np.arange(pid0, pid0 + n, dtype=np.int64)
        fi1 = np.asarray(fi1, np.int32)
        fi2 = np.asarray(fi2, np.int32)
        kf2 = np.broadcast_to(np.asarray(kf2, np.int32), (n,))
        self.mp_pos.extend(np.asarray(pos, np.float32))
        self.mp_desc.extend(np.asarray(desc, np.uint32))
        self.mp_normal.extend(
            np.broadcast_to(np.array([0, 0, 1], np.float32), (n, 3))
            if normal is None else np.asarray(normal, np.float32))
        self.mp_min_dist.extend(np.full(n, min_dist, np.float32))
        self.mp_max_dist.extend(np.full(n, max_dist, np.float32))
        self.mp_valid.extend(np.ones(n, bool))
        self.mp_first_kf.extend(np.full(
            n, kf1 if first_kf is None else first_kf, np.int64))
        self.mp_n_visible.extend(np.ones(n, np.int64))
        self.mp_n_found.extend(np.ones(n, np.int64))
        self.mp_replaced_by.extend(np.full(n, -1, np.int64))
        self.mp_first_frame.extend(np.full(n, first_frame, np.int64))
        self.mp_obs.extend({int(kf1): int(a), int(k): int(b)}
                           for a, k, b in zip(fi1, kf2, fi2))
        self.obs.add_rows(n)
        self.obs.kid[pids, 0] = kf1
        self.obs.fi[pids, 0] = fi1
        self.obs.kid[pids, 1] = kf2
        self.obs.fi[pids, 1] = fi2
        self.obs.n[pids] = 2
        pids32 = pids.astype(np.int32)
        self.kfs[kf1].frame.mp_ids[fi1] = pids32
        for k in np.unique(kf2):
            m = kf2 == k
            self.kfs[int(k)].frame.mp_ids[fi2[m]] = pids32[m]
        self.dirty_points.update(pids.tolist())
        return pids

    def add_observation(self, pid: int, kid: int, feat_idx: int):
        self.mp_obs[pid][kid] = feat_idx
        self.obs.add(pid, kid, feat_idx)
        self.kfs[kid].frame.mp_ids[feat_idx] = pid

    def erase_observation(self, pid: int, kid: int):
        """MapPoint::EraseObservation (src/MapPoint.cc:219-260): drop the
        link; the point dies if it falls to <= 2 observations."""
        idx = self.mp_obs[pid].pop(kid, None)
        if idx is not None:
            self.obs.erase(pid, kid)
            if self.kfs[kid].frame.mp_ids[idx] == pid:
                self.kfs[kid].frame.mp_ids[idx] = -1
        if len(self.mp_obs[pid]) <= 2:
            self.erase_point(pid)

    def erase_point(self, pid: int):
        """MapPoint::SetBadFlag (src/MapPoint.cc:181-217)."""
        if not self.mp_valid[pid]:
            return
        self.mp_valid[pid] = False
        self.dirty_points.add(pid)
        for kid, idx in list(self.mp_obs[pid].items()):
            if self.kfs[kid].frame.mp_ids[idx] == pid:
                self.kfs[kid].frame.mp_ids[idx] = -1
        self.mp_obs[pid].clear()
        self.obs.clear(pid)

    def replace_point(self, old: int, new: int, refresh: bool = True):
        """MapPoint::Replace (src/MapPoint.cc:276-336): merge old into
        new, transferring observations that new doesn't already have.

        ``refresh=False`` skips the per-point descriptor/normal refresh;
        callers doing many replaces (fuse) MUST then refresh the
        surviving points in one ``update_points_batch`` — the batched
        medoid+segment-sum refresh costs the same for 1 or 500 points,
        while the per-replace python refresh measured 194 ms/fuse."""
        if old == new or not self.mp_valid[old]:
            return
        for kid, idx in list(self.mp_obs[old].items()):
            if kid not in self.mp_obs[new]:
                self.mp_obs[new][kid] = idx
                self.obs.add(new, kid, idx)
                self.kfs[kid].frame.mp_ids[idx] = new
            else:
                if self.kfs[kid].frame.mp_ids[idx] == old:
                    self.kfs[kid].frame.mp_ids[idx] = -1
        self.mp_n_visible[new] += self.mp_n_visible[old]
        self.mp_n_found[new] += self.mp_n_found[old]
        self.mp_valid[old] = False
        self.dirty_points.add(old)
        self.mp_replaced_by[old] = new
        self.mp_obs[old].clear()
        self.obs.clear(old)
        if refresh:
            self.update_point_descriptor(new)
            self.update_normal_and_depth(new)
        else:
            self.dirty_points.add(new)

    def resolve_replaced(self, pid: int) -> int:
        """Follow the Replace chain (Tracking::CheckReplacedMapPoints...,
        src/Tracking.cc:581-597)."""
        seen = 0
        while pid >= 0 and self.mp_replaced_by[pid] >= 0 and seen < 100:
            pid = self.mp_replaced_by[pid]
            seen += 1
        return pid

    def update_point_descriptor(self, pid: int):
        """MapPoint::ComputeDistinctiveDescriptors (src/MapPoint.cc:386-470):
        the observed descriptor with minimum median distance to the rest."""
        obs = self.mp_obs[pid]
        if not obs:
            return
        self.dirty_points.add(pid)
        descs = np.stack([self.kfs[k].frame.desc[i] for k, i in obs.items()])
        if len(descs) == 1:
            self.mp_desc[pid] = descs[0]
            return
        from .. import native
        self.mp_desc[pid] = descs[native.min_median_descriptor_index(descs)]

    def update_normal_and_depth(self, pid: int):
        """MapPoint::UpdateNormalAndDepth (src/MapPoint.cc:508-556)."""
        obs = self.mp_obs[pid]
        if not obs:
            return
        self.dirty_points.add(pid)
        pos = self.mp_pos[pid]
        normals = []
        for kid in obs:
            ow = self.kf_center(kid)
            v = pos - ow
            n = np.linalg.norm(v)
            if n > 1e-9:
                normals.append(v / n)
        if not normals:
            return
        normal = np.mean(normals, axis=0)
        nn = np.linalg.norm(normal)
        if nn > 1e-9:
            self.mp_normal[pid] = (normal / nn).astype(np.float32)
        # scale band from the reference keyframe's observation level
        ref_kf = self.mp_first_kf[pid]
        if ref_kf not in obs:
            ref_kf = next(iter(obs))
        level = int(self.kfs[ref_kf].frame.octave[obs[ref_kf]])
        dist = float(np.linalg.norm(pos - self.kf_center(ref_kf)))
        sf = 1.2  # overwritten by pipeline config via set_scale_info
        n_levels = 8
        if hasattr(self, "_scale_factor"):
            sf = self._scale_factor
            n_levels = self._n_levels
        self.mp_max_dist[pid] = dist * (sf ** level)
        self.mp_min_dist[pid] = self.mp_max_dist[pid] / (sf ** (n_levels - 1))

    def set_scale_info(self, scale_factor: float, n_levels: int):
        self._scale_factor = scale_factor
        self._n_levels = n_levels

    def update_points_batch(self, pids):
        """Batched ComputeDistinctiveDescriptors + UpdateNormalAndDepth
        over a point set — replaces O(points) per-point Python calls
        (they dominated keyframe processing in profiling: 25k calls per
        keyframe).  Descriptor medoids run in one native call; normals
        and scale bands are segment-summed numpy."""
        pids = [p for p in dict.fromkeys(int(p) for p in pids)
                if self.mp_valid[p] and self.mp_obs[p]]
        if not pids:
            return
        # flatten observations (CSR) straight from the numpy obs mirror
        kidm, fim, nm = self.obs.rows(pids)
        slot_ok = np.arange(kidm.shape[1])[None, :] < nm[:, None]
        rows, cols = np.nonzero(slot_ok)          # row-major -> CSR order
        obs_pid_local = rows.astype(np.int64)
        obs_kid = kidm[rows, cols].astype(np.int64)
        obs_fi = fim[rows, cols].astype(np.int64)
        offsets = np.concatenate([[0], np.cumsum(nm)]).astype(np.int64)
        offsets = np.asarray(offsets, np.int64)
        pid_arr = np.asarray(pids, np.int64)

        # --- descriptors: one native medoid-batch call (descriptor
        # rows gathered in ONE fancy index over the store-wide table) ---
        descs_flat = self.desc_table()[obs_kid, obs_fi]
        kf_cache = {kid: self.kfs[kid].frame for kid in np.unique(obs_kid)}
        from .. import native
        sel = native.min_median_descriptor_batch(descs_flat, offsets)
        ok = sel >= 0
        self.mp_desc[pid_arr[ok]] = descs_flat[offsets[:-1][ok] + sel[ok]]

        # --- normals: mean unit viewing ray over observers ---
        centers = {kid: self.kf_center(kid) for kid in kf_cache}
        cen = np.empty((len(obs_kid), 3), np.float64)
        for kid in kf_cache:
            cen[obs_kid == kid] = centers[kid]
        pos = np.asarray(self.mp_pos[pid_arr])
        v = pos[obs_pid_local] - cen
        nrm = np.linalg.norm(v, axis=-1, keepdims=True)
        v = v / np.maximum(nrm, 1e-9)
        acc = np.zeros((len(pids), 3), np.float64)
        np.add.at(acc, obs_pid_local, v)
        an = np.linalg.norm(acc, axis=-1, keepdims=True)
        good_n = an[:, 0] > 1e-9
        new_normal = np.where(good_n[:, None], acc / np.maximum(an, 1e-9),
                              np.asarray(self.mp_normal[pid_arr]))
        self.mp_normal[pid_arr] = new_normal.astype(np.float32)

        # --- scale band from the reference KF observation ---
        sf = getattr(self, "_scale_factor", 1.2)
        n_levels = getattr(self, "_n_levels", 8)
        first = offsets[:-1]
        ref_kf = np.asarray(self.mp_first_kf[pid_arr])
        # first row within each point's CSR span whose kid == ref_kf
        # (falls back to the span's first row), vectorized
        is_ref = obs_kid == ref_kf[obs_pid_local]
        rows = np.arange(len(obs_kid), dtype=np.int64)
        big = len(obs_kid) + 1
        cand_row = np.where(is_ref, rows, big)
        ref_hit = np.full(len(pids), big, np.int64)
        np.minimum.at(ref_hit, obs_pid_local, cand_row)
        ref_row = np.where(ref_hit < big, ref_hit, first)
        level = self.octave_table()[obs_kid[ref_row],
                                    obs_fi[ref_row]].astype(np.int32)
        ref_cen = cen[ref_row]
        dist = np.linalg.norm(pos - ref_cen, axis=-1)
        max_d = dist * (sf ** level)
        self.dirty_points.update(pids)
        self.mp_max_dist[pid_arr] = max_d.astype(np.float32)
        self.mp_min_dist[pid_arr] = (max_d / (sf ** (n_levels - 1))
                                     ).astype(np.float32)

    def matched_ratio(self, pid: int) -> float:
        return self.mp_n_found[pid] / max(self.mp_n_visible[pid], 1)

    # ------------------------------------------------------------------
    # keyframes
    # ------------------------------------------------------------------
    def n_keyframes(self) -> int:
        return len(self.kfs)

    def n_valid_keyframes(self) -> int:
        return sum(kf.valid for kf in self.kfs)

    def valid_kf_ids(self) -> List[int]:
        return [kf.kid for kf in self.kfs if kf.valid]

    def add_keyframe(self, frame: Frame) -> int:
        kid = len(self.kfs)
        self.kfs.append(KeyFrame(kid=kid, frame=frame,
                                 Tcw=frame.Tcw.copy()))
        self.covis.append({})
        self.max_kf_id = kid
        return kid

    def octave_table(self) -> np.ndarray:
        """(n_kfs, max_n) int16: octave of feature f of keyframe k
        (pad rows with 0 — callers index only real (kid, fi) pairs).
        Grown lazily; existing rows are never rewritten."""
        k = len(self.kfs)
        if self._oct_rows < k:
            width = max([self._oct_tab.shape[1]] +
                        [self.kfs[i].frame.n
                         for i in range(self._oct_rows, k)])
            if k > len(self._oct_tab) or width > self._oct_tab.shape[1]:
                rows = max(2 * len(self._oct_tab), k, 64) \
                    if k > len(self._oct_tab) else len(self._oct_tab)
                tab = np.zeros((rows, width), np.int16)
                tab[:self._oct_rows, :self._oct_tab.shape[1]] = \
                    self._oct_tab[:self._oct_rows]
                self._oct_tab = tab
            for i in range(self._oct_rows, k):
                f = self.kfs[i].frame
                self._oct_tab[i, :f.n] = f.octave
            self._oct_rows = k
        return self._oct_tab

    def desc_table(self) -> np.ndarray:
        """(n_kfs, max_n, 8) uint32 feature descriptors, same contract
        as :meth:`octave_table`."""
        k = len(self.kfs)
        if self._desc_rows < k:
            width = max([self._desc_tab.shape[1]] +
                        [self.kfs[i].frame.n
                         for i in range(self._desc_rows, k)])
            if k > len(self._desc_tab) or width > self._desc_tab.shape[1]:
                rows = max(2 * len(self._desc_tab), k, 64) \
                    if k > len(self._desc_tab) else len(self._desc_tab)
                tab = np.zeros((rows, width, 8), np.uint32)
                tab[:self._desc_rows, :self._desc_tab.shape[1]] = \
                    self._desc_tab[:self._desc_rows]
                self._desc_tab = tab
            for i in range(self._desc_rows, k):
                f = self.kfs[i].frame
                self._desc_tab[i, :f.n] = f.desc
            self._desc_rows = k
        return self._desc_tab

    def kf_center(self, kid: int) -> np.ndarray:
        T = self.kfs[kid].Tcw
        return -T[:3, :3].T @ T[:3, 3]

    def set_kf_pose(self, kid: int, Tcw: np.ndarray):
        self.kfs[kid].Tcw = np.asarray(Tcw, np.float32)

    def update_connections(self, kid: int):
        """KeyFrame::UpdateConnections (src/KeyFrame.cc:396-520):
        count shared map points, keep edges with weight >= 15 (always
        keeping the single best), reciprocal update, pick the parent on
        first insertion."""
        frame = self.kfs[kid].frame
        pids = frame.mp_ids[frame.mp_ids >= 0].astype(np.int64)
        if len(pids):
            pids = pids[np.asarray(self.mp_valid[pids], bool)]
        if len(pids) == 0:
            return
        # vectorized shared-observation count over the obs mirror
        kidm, _, nm = self.obs.rows(pids)
        slot_ok = np.arange(kidm.shape[1])[None, :] < nm[:, None]
        others = kidm[slot_ok & (kidm != kid)]
        if len(others) == 0:
            return
        cnt = np.bincount(others)
        nz = np.nonzero(cnt)[0]
        counter: Dict[int, int] = {int(k): int(cnt[k]) for k in nz}
        best_kf = max(counter, key=counter.get)
        edges = {k: w for k, w in counter.items() if w >= COVIS_THRESHOLD}
        if not edges:
            edges = {best_kf: counter[best_kf]}
        # reciprocal
        old = set(self.covis[kid])
        self.covis[kid] = dict(edges)
        for k, w in edges.items():
            self.covis[k][kid] = w
        for k in old - set(edges):
            self.covis[k].pop(kid, None)

        kf = self.kfs[kid]
        if kf.first_connection and kid != 0:
            kf.parent = best_kf
            self.kfs[best_kf].children.add(kid)
            kf.first_connection = False

    def get_covisibles_by_weight(self, kid: int, min_weight: int) -> List[int]:
        return sorted(
            (k for k, w in self.covis[kid].items()
             if w >= min_weight and self.kfs[k].valid),
            key=lambda k: -self.covis[kid][k])

    def get_best_covisibles(self, kid: int, n: int) -> List[int]:
        ranked = sorted(self.covis[kid].items(), key=lambda kv: -kv[1])
        return [k for k, _ in ranked if self.kfs[k].valid][:n]

    def erase_keyframe(self, kid: int):
        """KeyFrame::EraseAndSetBad (src/KeyFrame.cc:611-697): drop
        observations, reparent children to the best-covisible candidate
        among (surviving parents), record Tcp."""
        kf = self.kfs[kid]
        if kid == 0 or not kf.valid:
            return
        if kf.not_erase:
            kf.to_be_erased = True
            return
        # drop covisibility edges
        for other in list(self.covis[kid]):
            self.covis[other].pop(kid, None)
        self.covis[kid].clear()
        # drop observations; survivors refresh in one batched pass
        survivors = []
        for i, pid in enumerate(kf.frame.mp_ids):
            if pid >= 0 and self.mp_valid[pid]:
                obs = self.mp_obs[pid]
                if obs.pop(kid, None) is not None:
                    # keep the numpy obs mirror in sync — a stale slot
                    # makes every mirror consumer (covisibility, KF-cull
                    # redundancy, BA fixed-observer collection) see the
                    # erased keyframe as a live observer
                    self.obs.erase(pid, kid)
                if len(obs) <= 2:
                    self.erase_point(pid)
                else:
                    survivors.append(pid)
        self.update_points_batch(survivors)
        # reparent children: candidates start with the parent, each child
        # connects to the candidate with max covisibility (src/KeyFrame.cc:640-690)
        candidates = {kf.parent} if kf.parent >= 0 else set()
        children = set(kf.children)
        while children:
            best = None
            for child in children:
                for cand in candidates:
                    w = self.covis[child].get(cand, 0)
                    if best is None or w > best[2]:
                        best = (child, cand, w)
            if best is None or best[2] <= 0:
                break
            child, cand, _ = best
            self.kfs[child].parent = cand
            self.kfs[cand].children.add(child)
            candidates.add(child)
            children.remove(child)
        # orphans go to the grandparent
        for child in children:
            self.kfs[child].parent = kf.parent
            if kf.parent >= 0:
                self.kfs[kf.parent].children.add(child)
        if kf.parent >= 0:
            self.kfs[kf.parent].children.discard(kid)
            kf.Tcp = kf.Tcw @ np.linalg.inv(self.kfs[kf.parent].Tcw)
        kf.valid = False
        if self.on_kf_erased is not None:
            self.on_kf_erased(kid)

    # ------------------------------------------------------------------
    # bulk views for device stages
    # ------------------------------------------------------------------
    def points_soa(self, pids: List[int]):
        """Compact SoA arrays for a set of point ids (one fancy-index
        gather per column — no Python loop)."""
        pids = np.asarray(pids, np.int32)
        if len(pids) == 0:
            return dict(pids=pids, pos=np.zeros((0, 3), np.float32),
                        desc=np.zeros((0, 8), np.uint32),
                        normal=np.zeros((0, 3), np.float32),
                        min_dist=np.zeros(0, np.float32),
                        max_dist=np.zeros(0, np.float32),
                        valid=np.zeros(0, bool))
        return dict(
            pids=pids,
            pos=self.mp_pos[pids],
            desc=self.mp_desc[pids],
            normal=self.mp_normal[pids],
            min_dist=np.asarray(self.mp_min_dist[pids], np.float32),
            max_dist=np.asarray(self.mp_max_dist[pids], np.float32),
            valid=np.asarray(self.mp_valid[pids], bool),
        )

    def scene_median_depth(self, kid: int) -> float:
        """KeyFrame::ComputeSceneMedianDepth (src/KeyFrame.cc:787-820)."""
        kf = self.kfs[kid]
        pids = [p for p in kf.frame.mp_ids if p >= 0 and self.mp_valid[p]]
        if not pids:
            return -1.0
        pos = np.stack([self.mp_pos[p] for p in pids])
        R2, t2 = kf.Tcw[2, :3], kf.Tcw[2, 3]
        depths = pos @ R2 + t2
        return float(np.median(depths))
