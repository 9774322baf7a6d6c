"""The distributed solvers as graph chains (``graphs.Chain``), on the CPU:
each shard runs the solver's phases between its collectives, with the
mesh's ``psum`` between them, as the card replays them from CUDA graphs.
On local meshes of 2 and 8 CPU shards, with tests/test_parallel.py's
scenes:

- the chains equal the one-call ``_core`` solvers through the same mesh
  (``eager=True``) bit for bit on every shard;
- a solve makes the collectives its formula counts;
- the padded sharded solvers stay within test_parallel.py's bars of the
  JAX package's distributed solvers on its 8-device CPU mesh (poses
  2e-4, points 2e-3, cost rtol 1e-3, inliers equal), the cameras bitwise
  equal on every shard;
- the shard padding changes no camera, point or inlier on one shard;
- the single-device ``bundle_adjust`` and ``optimize_pose_graph`` equal
  their ``_core`` forms bit for bit.

Iterations are cut (3 LM iterations of 8 PCG steps for the BA, 4 of 10
for the pose graph) to keep the file to seconds; both packages run the
same counts."""
import numpy as np
import pytest
import torch

from orb_slam2_tpu.parallel import (distributed_bundle_adjust as jdba,
                                    distributed_pose_graph as jdpg,
                                    make_mesh as jmake_mesh)
from orb_slam2_tpu.parallel.dist_ba import (
    distributed_bundle_adjust_sharded_points as jdba_pts)
from orb_slam2_tpu_torch import graphs, parallel
from orb_slam2_tpu_torch.optim import ba as tba, pose_graph as tpg
from orb_slam2_tpu_torch.parallel import LocalMesh
from orb_slam2_tpu_torch.parallel.dist_ba import (
    distributed_bundle_adjust_sharded_points)

from test_optim import FX, FY, CX, CY
from test_torch_parallel import (SpyMesh, _assert_close, _assert_replicated,
                                 _ba_problem, _np, _pose_graph_problem)

torch.set_num_threads(1)

BA_KW = dict(iters=3, cg_iters=8)
PG_KW = dict(iters=4, cg_iters=10)
BA_SOLVERS = {"obs": (parallel.distributed_bundle_adjust, jdba),
              "points": (distributed_bundle_adjust_sharded_points, jdba_pts)}


class CountingMesh(SpyMesh):
    """A CPU mesh that counts each shard's collectives."""

    def run(self, body):
        self.calls = {}

        def counted(d, dev, psum):
            self.calls[d] = 0

            def psum_counted(x):
                self.calls[d] += 1
                return psum(x)
            return body(d, dev, psum_counted)
        return super().run(counted)


def _shard_results(mesh):
    return {d: [_np(t) for t in r] for d, r in mesh.results.items()}


def _assert_shards_equal(a, b):
    assert a.keys() == b.keys()
    for d in a:
        for x, y in zip(a[d], b[d]):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("solver", ["obs", "points", "pose_graph"])
def test_chain_equals_core_on_every_shard(solver, n):
    """The graph chain and the one-call core through the same mesh, on
    the same padded shards: every shard's every result equal bit for
    bit, and every result of the whole call."""
    if solver == "pose_graph":
        args, _ = _pose_graph_problem()

        def run(mesh, eager):
            return parallel.distributed_pose_graph(mesh, *args, **PG_KW,
                                                   eager=eager)
    else:
        fn, args = BA_SOLVERS[solver][0], _ba_problem()

        def run(mesh, eager):
            return fn(mesh, *args, FX, FY, CX, CY, **BA_KW, eager=eager)
    chain_mesh, core_mesh = SpyMesh(n), SpyMesh(n)
    chain, core = run(chain_mesh, False), run(core_mesh, True)
    _assert_shards_equal(_shard_results(chain_mesh),
                         _shard_results(core_mesh))
    for x, y in zip(chain, core):
        assert torch.equal(x, y)


@pytest.mark.parametrize("solver", ["obs", "points", "pose_graph"])
def test_collective_count(solver):
    """Each shard's collectives: ``1 + iters (cg_iters + 4) + 1`` for the
    point-sharded BA, ``2 + iters (2 cg_iters + 7) + 1`` for the
    observation-sharded one (the point sums too), ``iters (cg_iters + 5)
    + 1`` for the pose graph; the chain and the core alike."""
    mesh = CountingMesh(2)
    if solver == "pose_graph":
        args, _ = _pose_graph_problem()
        it, cg = PG_KW["iters"], PG_KW["cg_iters"]
        want = it * (cg + 5) + 1
        assert tpg.collectives(it, cg) == want
        for eager in (False, True):
            parallel.distributed_pose_graph(mesh, *args, **PG_KW,
                                            eager=eager)
            assert mesh.calls == {0: want, 1: want}
        return
    it, cg = BA_KW["iters"], BA_KW["cg_iters"]
    pts = solver == "points"
    want = 1 + it * (cg + 4) + 1 if pts else 2 + it * (2 * cg + 7) + 1
    assert tba.collectives(it, cg, shard_points=pts) == want
    for eager in (False, True):
        BA_SOLVERS[solver][0](mesh, *_ba_problem(), FX, FY, CX, CY, **BA_KW,
                              eager=eager)
        assert mesh.calls == {0: want, 1: want}
    # the pipeline's sharded global BA: 10 iterations of 30 PCG steps
    assert tba.collectives(10, 30, shard_points=True) == 342


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's distributed solves on its 8-device mesh, each
    compiled and run once for the module."""
    mesh = jmake_mesh()
    assert mesh.devices.size == 8
    args = _ba_problem()
    refs = {k: jfn(mesh, *args, FX, FY, CX, CY, **BA_KW)
            for k, (_, jfn) in BA_SOLVERS.items()}
    refs["pose_graph"] = jdpg(mesh, *_pose_graph_problem()[0], **PG_KW)
    return refs


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("solver", ["obs", "points"])
def test_padded_ba_matches_jax(solver, n, jax_refs):
    """The padded graph-chain BA against the JAX package's distributed
    solve of the same problem on its 8-device mesh, within
    test_parallel.py's bars; each shard holds a power-of-4 bucket of
    rows (the padding is in place), the cameras bitwise equal on every
    shard."""
    tfn = BA_SOLVERS[solver][0]
    args = _ba_problem()
    mesh = SpyMesh(n)
    res = tfn(mesh, *args, FX, FY, CX, CY, **BA_KW)
    _assert_replicated(mesh)
    assert res.obs_inlier.shape == (len(args[2]),)
    assert res.points.shape == args[1].shape
    for r in mesh.results.values():
        rows = len(r.points) if solver == "points" else len(r.obs_inlier)
        assert rows == graphs.pad_bucket(rows)
        assert rows * n > len(args[1 if solver == "points" else 2])
    _assert_close(res, jax_refs[solver])


@pytest.mark.parametrize("n", [2, 8])
def test_padded_pose_graph_matches_jax(n, jax_refs):
    """The padded graph-chain essential graph (edges in buckets of 16 a
    shard) against the JAX package's distributed solve: Sim3 within
    2e-4, cost rtol 1e-3 (atol 1e-5), the vertices bitwise equal on
    every shard."""
    args, _ = _pose_graph_problem()
    mesh = SpyMesh(n)
    res = parallel.distributed_pose_graph(mesh, *args, **PG_KW)
    sims = [_np(r.sims) for r in mesh.results.values()]
    assert all(np.array_equal(s, sims[0]) for s in sims)
    ref = jax_refs["pose_graph"]
    np.testing.assert_allclose(_np(res.sims), np.asarray(ref.sims),
                               atol=2e-4)
    np.testing.assert_allclose(float(res.final_cost), float(ref.final_cost),
                               rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("solver", ["obs", "points"])
def test_padding_changes_no_sum(solver):
    """One shard: the padded problem (observations of weight 0 spread
    over the point rows, points only they reach) against the unpadded
    one-call core.  Cameras, points and inliers bit for bit (every
    per-camera and per-point sum adds the padded rows after the real
    ones, as zeros); the cost, one flat sum whose blocking follows the
    row count, within 1e-6."""
    args = _ba_problem()
    res = BA_SOLVERS[solver][0](LocalMesh(["cpu"]), *args, FX, FY, CX, CY,
                                **BA_KW)
    ref = tba.bundle_adjust_core(*[torch.as_tensor(a) for a in args], FX,
                                 FY, CX, CY, **BA_KW)
    for x, y in zip(res[:3], ref[:3]):
        assert torch.equal(x, y)
    np.testing.assert_allclose(float(res.final_cost), float(ref.final_cost),
                               rtol=1e-6)


def test_single_device_equals_core():
    """``bundle_adjust`` (a begin, one step a LM iteration and a finish
    program, each a graph on the card) and ``optimize_pose_graph`` (one
    step a LM iteration, then the cost) equal their one-call ``_core``
    forms bit for bit: the same phases, the identity at every
    collective."""
    args = [torch.as_tensor(a) for a in _ba_problem()]
    for x, y in zip(tba.bundle_adjust(*args, FX, FY, CX, CY, **BA_KW),
                    tba.bundle_adjust_core(*args, FX, FY, CX, CY, **BA_KW)):
        assert torch.equal(x, y)
    pargs = [torch.as_tensor(np.array(a)) for a in _pose_graph_problem()[0]]
    for x, y in zip(tpg.optimize_pose_graph(*pargs, **PG_KW),
                    tpg.optimize_pose_graph_core(*pargs, **PG_KW)):
        assert torch.equal(x, y)


def test_chain_runs_steps_in_place_and_skips_identity_collectives():
    """A CPU chain: the steps between two collectives run on the chain's
    buffers, an entry returned under two names gets two buffers, the
    sums are written back over the partials, and an identity hook cuts
    nothing."""
    def double(st, cfg):
        y = st["x"] * 2.0
        return dict(y=y, z=y)

    def bump(st, cfg):
        return dict(y=st["y"] + cfg, x=st["z"] - 1.0)

    program = [double, graphs.Collective("a", ("y",)), bump,
               graphs.Collective("b", ("x",))]
    chain = graphs.Chain("t", "cpu")
    chain.load(x=np.arange(3, dtype=np.float32))
    seen = []

    def hook(vals):
        seen.append(vals[0].clone())
        return tuple(v * 10.0 for v in vals)
    bufs = chain.run(program, 0.5, {"a": hook, "b": None})
    assert bufs["y"] is not bufs["z"]
    assert torch.equal(seen[0], torch.tensor([0.0, 2.0, 4.0]))
    assert torch.equal(bufs["y"], torch.tensor([0.5, 20.5, 40.5]))
    assert torch.equal(bufs["x"], torch.tensor([-1.0, 1.0, 3.0]))
    st = graphs.run_eager(program, dict(x=torch.arange(3.0)), 0.5,
                          {"a": hook, "b": None})
    for k in ("x", "y", "z"):
        assert torch.equal(st[k], bufs[k])


def test_mesh_psum_deposits_copies():
    """A shard that overwrites its partial right after the collective
    (as a chain writes the sums back over it) does not change what the
    shards after it sum."""
    mesh = LocalMesh(["cpu"] * 3)

    def body(d, dev, psum):
        part = torch.full((2,), float(d + 1))
        out = psum((part,))[0]
        part.fill_(100.0)
        return out, psum(part)

    res = mesh.run(body)
    for d in range(3):
        assert torch.equal(res[d][0], torch.full((2,), 6.0))
        assert torch.equal(res[d][1], torch.full((2,), 300.0))
