"""The state carrier between the two packages (``interop``): a
snapshot of a MapStore stays as it was when the store changes.

``interop.mapstore_state`` records a store of either package for the
one-state tests and for ``chip_smoke.py``'s recorded problems.  Its
point columns are growable numpy columns whose ``__array__`` answered a
request for a copy (``copy=True``, which NumPy 2 may pass and trust)
with a view of the live buffer, so on a NumPy that trusts the answer a
snapshot followed every later change to the store until the column
grew: found on path B-est's run on the card, whose recorded loop
keyframe held points invalidated and replaced after it."""
import numpy as np
import pytest

from orb_slam2_tpu.models.mapstore import MapStore as JMapStore
from orb_slam2_tpu_torch import interop
from orb_slam2_tpu_torch.models.mapstore import MapStore, _GrowArray


def test_grow_array_copy_is_a_copy():
    """The port's column answers ``copy=True`` with a copy, and anything
    else with a view of the live rows (as before)."""
    col = _GrowArray(None, np.float32)
    col.extend(np.arange(3, dtype=np.float32))
    snap, view = col.__array__(copy=True), col.__array__()
    col[0] = 7.0
    assert snap.tolist() == [0.0, 1.0, 2.0]
    assert view[0] == 7.0


@pytest.mark.parametrize("package", ["jax", "port"])
def test_mapstore_state_is_a_snapshot(package):
    """A snapshot of either package's store keeps its point columns when
    the store then moves a point and erases another."""
    store = JMapStore() if package == "jax" else MapStore(device="cpu")
    for i in range(3):
        store.add_point(np.full(3, i, np.float32), np.zeros(8, np.uint32),
                        np.array([0, 0, 1], np.float32), 0.1, 100.0, 0, 0)
    state = interop.mapstore_state(store)
    store.mp_pos[0] = np.full(3, 9.0, np.float32)
    store.erase_point(1)
    assert state["points"]["mp_valid"].tolist() == [True] * 3
    assert state["points"]["mp_pos"][0].tolist() == [0.0] * 3
