"""The port's distributed solvers (orb_slam2_tpu_torch.parallel) on
local meshes of 2 and 8 CPU shards, against the port's single-device
solves and the JAX package's distributed solvers on its 8-device CPU
mesh (tests/conftest.py), with tests/test_parallel.py's scenes and bars:
poses 2e-4, points 2e-3, cost rtol 1e-3, inliers equal.  The replicated
cameras must be bitwise equal on every shard."""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu.geom import se3 as jse3, sim3 as jsim3
from orb_slam2_tpu.parallel import (distributed_bundle_adjust as jdba,
                                    distributed_pose_graph as jdpg,
                                    make_mesh as jmake_mesh)
from orb_slam2_tpu.parallel.dist_ba import (
    distributed_bundle_adjust_sharded_points as jdba_pts,
    shard_points_problem as jshard_points_problem)
from orb_slam2_tpu_torch import parallel
from orb_slam2_tpu_torch.optim import ba as tba, pose_graph as tpg
from orb_slam2_tpu_torch.parallel import LocalMesh
from orb_slam2_tpu_torch.parallel.dist_ba import (
    distributed_bundle_adjust_sharded_points, shard_points_problem)

from test_optim import make_scene, FX, FY, CX, CY

torch.set_num_threads(1)

SHARDS = [2, 8]


class SpyMesh(LocalMesh):
    """A CPU mesh that keeps every shard's result."""

    def __init__(self, n):
        super().__init__(["cpu"] * n)

    def run(self, body):
        self.results = super().run(body)
        return self.results


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _ba_problem():
    cams, pts, (oc, op, ouv) = make_scene(n_cams=6, n_pts=300, noise=0.2,
                                          seed=8)
    rng = np.random.default_rng(9)
    cams0 = cams.copy()
    for c in range(2, len(cams)):
        xi = rng.normal(0, 0.02, 6).astype(np.float32)
        cams0[c] = np.asarray(jse3.exp(jnp.asarray(xi))) @ cams[c]
    pts0 = pts + rng.normal(0, 0.1, pts.shape).astype(np.float32)
    fixed = np.zeros(len(cams), bool)
    fixed[:2] = True
    n = len(oc)
    return (cams0, pts0, oc, op, ouv, np.ones(n, np.float32),
            np.ones(n, bool), fixed)


def _single(args, **kw):
    return tba.bundle_adjust(*[torch.as_tensor(a) for a in args],
                             FX, FY, CX, CY, **kw)


def _assert_replicated(mesh):
    cams = [_np(r.cam_Tcw) for r in mesh.results.values()]
    costs = [_np(r.final_cost) for r in mesh.results.values()]
    for c, k in zip(cams[1:], costs[1:]):
        assert np.array_equal(c, cams[0])
        assert np.array_equal(k, costs[0])


def _assert_close(res, ref, points=True):
    np.testing.assert_allclose(_np(res.cam_Tcw), _np(ref.cam_Tcw), atol=2e-4)
    if points:
        np.testing.assert_allclose(_np(res.points), _np(ref.points),
                                   atol=2e-3)
    assert np.array_equal(_np(res.obs_inlier), _np(ref.obs_inlier))
    np.testing.assert_allclose(_np(res.final_cost), _np(ref.final_cost),
                               rtol=1e-3)


@pytest.mark.parametrize("n", SHARDS)
def test_ba_matches_single_device(n):
    args = _ba_problem()
    mesh = SpyMesh(n)
    dist = parallel.distributed_bundle_adjust(mesh, *args, FX, FY, CX, CY,
                                              iters=10, cg_iters=30)
    _assert_replicated(mesh)
    _assert_close(dist, _single(args, iters=10, cg_iters=30))
    cams = _make_gt_cams()
    for c in range(2, len(cams)):
        err = np.asarray(jse3.log(jnp.asarray(cams[c])
                                  @ jse3.inv(jnp.asarray(_np(dist.cam_Tcw[c])))))
        assert np.abs(err).max() < 2e-2


def _make_gt_cams():
    return make_scene(n_cams=6, n_pts=300, noise=0.2, seed=8)[0]


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_points_ba_matches_single_device(n):
    args = _ba_problem()
    mesh = SpyMesh(n)
    dist = distributed_bundle_adjust_sharded_points(
        mesh, *args, FX, FY, CX, CY, iters=10, cg_iters=30)
    _assert_replicated(mesh)
    # each shard held only its block of the points
    P = len(args[1])
    assert all(len(r.points) < P for r in mesh.results.values())
    _assert_close(dist, _single(args, iters=10, cg_iters=30))


def test_distributed_ba_matches_jax():
    """Both packages' observation-sharded and point-sharded solves on 8
    shards."""
    args = _ba_problem()
    jmesh = jmake_mesh()
    assert jmesh.devices.size == 8
    for tfn, jfn in ((parallel.distributed_bundle_adjust, jdba),
                     (distributed_bundle_adjust_sharded_points, jdba_pts)):
        t = tfn(SpyMesh(8), *args, FX, FY, CX, CY, iters=10, cg_iters=30)
        j = jfn(jmesh, *args, FX, FY, CX, CY, iters=10, cg_iters=30)
        _assert_close(t, j)


def test_shard_points_problem_equals_jax():
    rng = np.random.default_rng(0)
    P, O = 1000, 8000
    pts = rng.normal(0, 1, (P, 3)).astype(np.float32)
    op = rng.integers(0, P, O).astype(np.int32)
    oc = rng.integers(0, 5, O).astype(np.int32)
    ouv = rng.normal(0, 1, (O, 2)).astype(np.float32)
    for n_dev in (2, 8):
        a = shard_points_problem(pts, oc, op, ouv, np.ones(O, np.float32),
                                 np.ones(O, bool), n_dev)
        b = jshard_points_problem(pts, oc, op, ouv, np.ones(O, np.float32),
                                  np.ones(O, bool), n_dev)
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("n", SHARDS)
def test_uneven_obs_padding(n):
    """An observation count that is no multiple of the shard count: the
    padding (valid False) changes nothing against the single-device
    solve, and the inliers come back at the true length."""
    cams, pts, (oc, op, ouv) = make_scene(n_cams=3, n_pts=50, noise=0.1,
                                          seed=10)
    m = (len(oc) // 8) * 8 + 3
    oc, op, ouv = oc[:m], op[:m], ouv[:m]
    fixed = np.zeros(len(cams), bool)
    fixed[:2] = True
    args = (cams, pts, oc, op, ouv, np.ones(m, np.float32),
            np.ones(m, bool), fixed)
    mesh = SpyMesh(n)
    res = parallel.distributed_bundle_adjust(mesh, *args, FX, FY, CX, CY,
                                             iters=3, cg_iters=10)
    assert res.obs_inlier.shape == (m,)
    assert np.isfinite(float(res.final_cost))
    _assert_replicated(mesh)
    _assert_close(res, _single(args, iters=3, cg_iters=10))


def _pose_graph_problem():
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(2)
    K = 30
    gt = []
    for i in range(K):
        th = 2 * np.pi * i / K
        R = Rotation.from_euler("z", th).as_matrix().astype(np.float32)
        c = np.array([np.cos(th) * 5, np.sin(th) * 5, 0], np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R.T
        T[:3, 3] = -R.T @ c
        gt.append(jsim3.from_se3(jnp.asarray(T)))
    gt = jnp.stack(gt)
    edges_i, edges_j, meas = [], [], []
    noisy = [gt[0]]
    for i in range(K - 1):
        Sji_true = jsim3.compose(gt[i + 1], jsim3.inv(gt[i]))
        xi = np.zeros(7, np.float32)
        xi[:6] = rng.normal(0, 0.005, 6)
        xi[6] = np.log(1.025)
        Sji_noisy = jsim3.compose(jsim3.exp(jnp.asarray(xi)), Sji_true)
        edges_i.append(i)
        edges_j.append(i + 1)
        meas.append(Sji_noisy)
        noisy.append(jsim3.compose(Sji_noisy, noisy[-1]))
    edges_i.append(K - 1)
    edges_j.append(0)
    meas.append(jsim3.compose(gt[0], jsim3.inv(gt[K - 1])))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return (np.asarray(jnp.stack(noisy)), np.array(edges_i, np.int32),
            np.array(edges_j, np.int32), np.asarray(jnp.stack(meas)),
            np.ones(len(meas), np.float32), fixed), np.asarray(gt)


@pytest.mark.parametrize("n", SHARDS)
def test_pose_graph_matches_single_device_and_jax(n):
    """Edge-sharded essential graph against the port's single-device
    solve and the JAX package's 8-device solve (sims 2e-4, cost rtol
    1e-3 with atol 1e-5, as test_parallel.py)."""
    args, gt = _pose_graph_problem()
    mesh = SpyMesh(n)
    dist = parallel.distributed_pose_graph(mesh, *args, iters=30,
                                           cg_iters=40)
    sims = [_np(r.sims) for r in mesh.results.values()]
    assert all(np.array_equal(s, sims[0]) for s in sims)
    single = tpg.optimize_pose_graph(*[torch.as_tensor(a) for a in args],
                                     iters=30, cg_iters=40)
    jres = jdpg(jmake_mesh(), *args, iters=30, cg_iters=40)
    for ref in (single, jres):
        np.testing.assert_allclose(_np(dist.sims), _np(ref.sims), atol=2e-4)
        np.testing.assert_allclose(float(dist.final_cost),
                                   float(ref.final_cost), rtol=1e-3,
                                   atol=1e-5)
    err = np.asarray(jsim3.log(jsim3.compose(
        jnp.asarray(_np(dist.sims)[-1]), jsim3.inv(jnp.asarray(gt[-1])))))
    assert np.abs(err).max() < 0.15


def test_a_shard_that_raises_fails_the_call():
    """A shard that raises before its first psum aborts the barrier: the
    other shards, waiting there, fail at once instead of hanging, and the
    call raises the shard's own error."""
    mesh = LocalMesh(["cpu"] * 4)

    def body(d, dev, psum):
        if d == 2:
            raise ValueError("shard 2 failed")
        return psum(torch.ones(3, device=dev))

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="shard 2 failed"):
        mesh.run(body)
    assert time.perf_counter() - t0 < 10.0
    assert not [t for t in threading.enumerate()
                if t.name.startswith("mesh-shard-")]


def test_a_stalled_shard_times_out(monkeypatch):
    """A shard that never reaches the collective: the waiting shard's
    barrier breaks at the timeout and the call fails there."""
    monkeypatch.setattr(parallel.mesh, "TIMEOUT_S", 0.5)
    mesh = LocalMesh(["cpu"] * 2)
    release = threading.Event()

    def body(d, dev, psum):
        if d == 1:
            release.wait(5.0)
            return None
        return psum(torch.ones(1))

    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        mesh.run(body)
    release.set()
    assert time.perf_counter() - t0 < 4.0


def test_psum_sums_in_shard_order_and_keeps_structure():
    mesh = LocalMesh(["cpu"] * 3)
    vals = [torch.tensor([1e8], dtype=torch.float32),
            torch.tensor([1.0], dtype=torch.float32),
            torch.tensor([-1e8], dtype=torch.float32)]

    def body(d, dev, psum):
        a, b = psum((vals[d], torch.full((2, 2), float(d))))
        return a, b, psum(vals[d])

    out = mesh.run(body)
    # ((1e8 + 1) - 1e8) in float32 is 0: the fixed order, on every shard
    for d in range(3):
        a, b, c = out[d]
        assert a.item() == 0.0 and c.item() == 0.0
        assert torch.equal(b, torch.full((2, 2), 3.0))


def test_local_devices_and_make_mesh():
    assert parallel.local_devices("cpu") == [torch.device("cpu")]
    m = parallel.make_mesh(["cpu", "cpu"])
    assert m.size == 2 and m.axis_names == ("obs",)
    assert parallel.make_mesh(device="cpu").devices == [torch.device("cpu")]
    if not torch.cuda.is_available():
        # the CPU only when asked for: no card, no default mesh
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.make_mesh()
