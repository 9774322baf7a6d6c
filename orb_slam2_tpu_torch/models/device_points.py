"""Device-resident map-point SoA with dirty-row synchronization.

Port of ``orb_slam2_tpu/models/device_points.py``.  The host MapStore
numpy arrays stay authoritative (graph mutations are host logic); their
device image persists across frames, and per-frame consumers (the fused
tracking step, fuse) gather rows on the device by index.

Synchronization: MapStore records touched pids in ``dirty_points``;
``sync()`` drains the set into one indexed copy per column.  Capacity
grows by 4x re-allocation (full re-upload, amortized).  A sync builds
new column tensors instead of writing in place, as JAX's functional
updates do, so a snapshot taken by the tracking thread never changes
under it while the mapping thread syncs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graphs import upload


class DevicePoints:
    """The six column tensors (``_arrs``) of the device point store."""

    def __init__(self, min_capacity: int = 65536, device="cuda"):
        self.min_capacity = min_capacity
        self.device = torch.device(device)
        self.cap = 0
        self._arrs = None

    def snapshot(self):
        """(pos, desc, normal, min_d, max_d, valid); desc is int32 with
        the uint32 bits."""
        return self._arrs

    def _columns(self, store, rows):
        """Host rows of the six columns, as device tensors (uploaded
        without waiting for the card, ``graphs.upload``)."""
        dev = self.device
        return (
            upload(np.asarray(store.mp_pos[rows], np.float32), dev),
            upload(np.asarray(store.mp_desc[rows], np.uint32)
                   .view(np.int32), dev),
            upload(np.asarray(store.mp_normal[rows], np.float32), dev),
            upload(np.asarray(store.mp_min_dist[rows], np.float32), dev),
            upload(np.asarray(store.mp_max_dist[rows], np.float32), dev),
            upload(np.asarray(store.mp_valid[rows], bool), dev),
        )

    def _full_upload(self, store, cap: int):
        n = store.n_points()
        cols = self._columns(store, np.arange(n))
        arrs = []
        for c in cols:
            full = c.new_zeros((cap,) + tuple(c.shape[1:]))
            full[:n] = c
            arrs.append(full)
        self._arrs = tuple(arrs)
        self.cap = cap

    def sync(self, store) -> None:
        """Bring the device image up to date (call with the map lock
        held: reads the numpy SoA)."""
        n = store.n_points()
        if n > self.cap or self._arrs is None:
            cap = self.min_capacity
            while cap < n:
                cap *= 4
            self._full_upload(store, cap)
            store.dirty_points.clear()
            return
        if not store.dirty_points:
            return
        rows = np.fromiter((p for p in store.dirty_points if p < n),
                           np.int64)
        store.dirty_points.clear()
        if len(rows) == 0:
            return
        ridx = upload(rows, self.device)
        self._arrs = tuple(a.index_copy(0, ridx, u) for a, u in
                           zip(self._arrs, self._columns(store, rows)))
