"""The port's distributed solvers on four shards, at a small size, on the
weak-scaling problem of ``tools/weak_scaling.py`` (2,000 observations a
shard): the port's problem generator held to the tool's bit for bit;
``distributed_bundle_adjust``, ``distributed_bundle_adjust_sharded_points``
and ``distributed_pose_graph`` on a 4-shard CPU ``LocalMesh`` against
the JAX package's same functions on 4 devices of the CPU mesh that
tests/conftest.py provides; four gloo processes of
``distributed_bundle_adjust`` against the 4-shard mesh; the graph-chain
cache's policy over many shards; and ``chip_smoke.py --cards 4``'s
guard without four cards.

The BA bars are tests/test_parallel.py's (poses 2e-4, points 2e-3, cost
rtol 1e-3, inliers equal), or 4x the gap between the two packages'
single-device solves of the problem (sums in another order only) where
that is larger, as chip_smoke.py's path F.  The problem is
ill-conditioned: its cameras share one rotation and lie on a line, 8 LM
iterations leave it in a flat valley, and the two single-device solves'
cameras part by 3.5e-3 (points 4.2e-3) on the CPU.

The gloo test runs this file as each rank's worker:

    python test_torch_multicard.py HOST:PORT RANK WORLD PROBLEM.npz
"""
import ast
import functools
import importlib.util
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SHARDS = 4
LOAD = 2000                   # observations a shard
KW = dict(iters=8, cg_iters=15, use_huber=False)   # the tool's solve


def _tool_make_problem():
    """``make_problem`` of tools/weak_scaling.py, read from its source
    with ``ast``: importing the tool would set XLA_FLAGS and
    JAX_PLATFORMS for this process."""
    path = os.path.join(ROOT, "tools", "weak_scaling.py")
    tree = ast.parse(open(path).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "make_problem")
    ns = {"np": np}
    exec(compile(ast.Module([fn], []), path, "exec"), ns)
    return ns["make_problem"]


def _w_problem(n_dev=SHARDS):
    """The tool's problem of ``n_dev`` devices at LOAD observations a
    device (its sizes and seed), with cameras 0 and 1 fixed: two fixed
    cameras pin the free scale of a monocular BA, so two solvers
    compare."""
    from orb_slam2_tpu_torch import interop
    (cams, pts, ocam, opt, uv, sig, valid,
     fx, fy, cx, cy) = interop.weak_scaling_problem(
        LOAD * n_dev // 4, 8 * n_dev, 4, seed=n_dev)
    fixed = np.zeros(len(cams), bool)
    fixed[:2] = True
    return (cams, pts, ocam, opt, uv, sig, valid, fixed), (fx, fy, cx, cy)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _gaps(res, ref) -> dict:
    def gap(f):
        return float(np.abs(_np(getattr(res, f)).astype(np.float64)
                            - _np(getattr(ref, f))).max())
    return dict(poses=gap("cam_Tcw"), points=gap("points"),
                cost_rel=gap("final_cost") / abs(float(ref.final_cost)))


@functools.lru_cache(maxsize=None)
def _bars() -> dict:
    """test_parallel.py's bars, or 4x the gap between the port's and the
    JAX package's single-device solves of the problem where that is
    larger (see the module)."""
    import jax.numpy as jnp
    from orb_slam2_tpu.optim.ba import bundle_adjust as jba
    from orb_slam2_tpu_torch.optim import ba
    args, cam = _w_problem()
    order = _gaps(ba.bundle_adjust(*map(torch.as_tensor, args), *cam, **KW),
                  jba(*map(jnp.asarray, args), *cam, **KW))
    base = dict(poses=2e-4, points=2e-3, cost_rel=1e-3)
    return {k: max(v, 4 * order[k]) for k, v in base.items()}


def _assert_close(res, ref):
    g, bars = _gaps(res, ref), _bars()
    assert all(g[k] < bars[k] for k in bars), (g, bars)
    assert np.array_equal(_np(res.obs_inlier), _np(ref.obs_inlier))


def _spy_mesh(n):
    from orb_slam2_tpu_torch.parallel import LocalMesh

    class SpyMesh(LocalMesh):
        def run(self, body):
            self.results = super().run(body)
            return self.results
    return SpyMesh(["cpu"] * n)


def _assert_replicated(mesh, fields):
    for f in fields:
        vals = [_np(getattr(r, f)) for r in mesh.results.values()]
        assert all(np.array_equal(v, vals[0]) for v in vals), f


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_weak_scaling_problem_is_the_tools(n_dev):
    """The port's generator against the tool's ``make_problem`` at the
    tool's sizes of a mesh of ``n_dev``: every array bit for bit, with
    its dtype, and the camera constants."""
    from orb_slam2_tpu_torch import interop
    shape = (LOAD * n_dev // 4, 8 * n_dev, 4)
    want = _tool_make_problem()(*shape, seed=n_dev)
    got = interop.weak_scaling_problem(*shape, seed=n_dev)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("solver", ["observations", "points"])
def test_four_shard_ba_matches_jax(solver):
    """Both BA forms on a 4-shard CPU mesh against the JAX package's on
    4 devices, within the module's bars; the shards' cameras and cost
    bitwise equal; with the points sharded, each shard holds only its
    block of the points."""
    from orb_slam2_tpu.parallel import (distributed_bundle_adjust as jdba,
                                        make_mesh as jmake_mesh)
    from orb_slam2_tpu.parallel.dist_ba import (
        distributed_bundle_adjust_sharded_points as jdba_pts)
    from orb_slam2_tpu_torch import parallel
    args, cam = _w_problem()
    tfn, jfn = ((parallel.distributed_bundle_adjust, jdba)
                if solver == "observations" else
                (parallel.distributed_bundle_adjust_sharded_points,
                 jdba_pts))
    mesh = _spy_mesh(SHARDS)
    res = tfn(mesh, *args, *cam, **KW)
    _assert_replicated(mesh, ("cam_Tcw", "final_cost"))
    if solver == "points":
        assert all(len(r.points) < len(args[1])
                   for r in mesh.results.values())
    jmesh = jmake_mesh(SHARDS)
    assert jmesh.devices.size == SHARDS
    _assert_close(res, jfn(jmesh, *args, *cam, **KW))


def _w_pose_graph():
    """An essential graph over the weak-scaling problem's 32 cameras:
    each camera tied to the next and to the fourth after it by its true
    relative Sim3 with noise, every vertex but the fixed first
    perturbed."""
    from orb_slam2_tpu_torch.geom import sim3
    cams = _w_problem()[0][0]
    K = len(cams)
    rng = np.random.default_rng(5)
    gt = sim3.from_se3(torch.as_tensor(cams))
    ei = np.concatenate([np.arange(K - 1), np.arange(K - 4)])
    ej = np.concatenate([np.arange(1, K), np.arange(4, K)])
    ii, jj = torch.as_tensor(ei), torch.as_tensor(ej)

    def noise(n, sd):
        return sim3.exp(torch.as_tensor(rng.normal(0, sd, (n, 7)),
                                        dtype=torch.float32))
    meas = sim3.compose(noise(len(ei), 0.005),
                        sim3.compose(gt[jj], sim3.inv(gt[ii])))
    sims0 = sim3.compose(noise(K, 0.02), gt)
    sims0[0] = gt[0]
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return (sims0.numpy(), ei.astype(np.int32), ej.astype(np.int32),
            meas.numpy(), np.ones(len(ei), np.float32), fixed)


def test_four_shard_pose_graph_matches_jax():
    """The edge-sharded essential graph on a 4-shard CPU mesh against
    the JAX package's on 4 devices (Sim3 2e-4, cost rtol 1e-3 with atol
    1e-5, as test_parallel.py); the shards' vertices and cost bitwise
    equal."""
    from orb_slam2_tpu.parallel import (distributed_pose_graph as jdpg,
                                        make_mesh as jmake_mesh)
    from orb_slam2_tpu_torch import parallel
    args = _w_pose_graph()
    mesh = _spy_mesh(SHARDS)
    res = parallel.distributed_pose_graph(mesh, *args, iters=20,
                                          cg_iters=30)
    _assert_replicated(mesh, ("sims", "final_cost"))
    ref = jdpg(jmake_mesh(SHARDS), *args, iters=20, cg_iters=30)
    np.testing.assert_allclose(_np(res.sims), _np(ref.sims), atol=2e-4)
    np.testing.assert_allclose(float(res.final_cost), float(ref.final_cost),
                               rtol=1e-3, atol=1e-5)


def worker():
    coord, rank, world, path = (sys.argv[1], int(sys.argv[2]),
                                int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    import torch.distributed as dist
    from orb_slam2_tpu_torch.parallel import (distributed_bundle_adjust,
                                              init_multihost,
                                              make_global_mesh)
    init_multihost(coordinator=coord, num_processes=world, process_id=rank,
                   backend="gloo")
    mesh = make_global_mesh(device="cpu")
    assert mesh.size == world and mesh.local_shards() == [rank]
    p = np.load(path)
    res = distributed_bundle_adjust(
        mesh, *[p[f"a{i}"] for i in range(8)], *p["cam"].tolist(), **KW)
    np.savez(f"{path}.rank{rank}.npz", *[_np(t) for t in res])
    print(f"rank={rank} backend={dist.get_backend()}", flush=True)
    dist.destroy_process_group()
    print("MULTICARD_OK", flush=True)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_four_gloo_ranks_match_the_four_shard_mesh(tmp_path):
    """Four processes joined by gloo on the CPU (``init_multihost``,
    ``make_global_mesh``), one shard each, run
    ``distributed_bundle_adjust``: every rank's result bitwise equal to
    the others', and within test_parallel.py's bars of the 4-shard
    ``LocalMesh`` (gloo sums in another order)."""
    from orb_slam2_tpu_torch import parallel
    from orb_slam2_tpu_torch.optim.ba import BAResult
    args, cam = _w_problem()
    path = str(tmp_path / "problem.npz")
    np.savez(path, cam=np.array(cam),
             **{f"a{i}": a for i, a in enumerate(args)})
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), coord, str(rank),
         str(SHARDS), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=HERE) for rank in range(SHARDS)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert "MULTICARD_OK" in out and "backend=gloo" in out, out[-3000:]
    got = []
    for r in range(SHARDS):
        f = np.load(f"{path}.rank{r}.npz")
        got.append([f[f"arr_{i}"] for i in range(len(f.files))])
    for g in got[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(g, got[0]))
    local = parallel.distributed_bundle_adjust(_spy_mesh(SHARDS), *args,
                                               *cam, **KW)
    _assert_close(BAResult(*map(torch.as_tensor, got[0])), local)


def test_chain_cache_keeps_a_signature_for_every_shard():
    """``graphs.ChainCache`` keeps ``MAXSIZE`` signatures, each with a
    chain for every shard that ran it: a mesh of more shards than
    ``MAXSIZE`` finds its own chains again, and four shards keep
    ``MAXSIZE`` problem sizes; one signature more evicts the oldest
    signature's chains together; ``graphs.clear_chains`` drops them
    all.  (Chains are made without touching a card: only their captures
    need one.)"""
    from orb_slam2_tpu_torch import graphs
    cache = graphs.ChainCache("test")
    many = graphs.MAXSIZE + 1
    first = [cache.get("one", d, "cuda:0") for d in range(many)]
    assert len({id(c) for c in first}) == many
    assert all(cache.get("one", d, "cuda:0") is first[d]
               for d in range(many))
    cards = [torch.device("cuda", i) for i in range(SHARDS)]
    chains = {(k, d): cache.get(("size", k), d, cards[d])
              for k in range(graphs.MAXSIZE) for d in range(SHARDS)}
    assert all(c.device == cards[d] for (_, d), c in chains.items())
    # "one" was the least recently used: the eighth size evicted it
    assert cache.get("one", 0, "cuda:0") is not first[0]
    # ("size", 0) is now the oldest, and the new "one" took a slot
    assert cache.get(("size", 1), 3, cards[3]) is chains[(1, 3)]
    assert cache.get(("size", 0), 2, cards[2]) is not chains[(0, 2)]
    # a chain a shard and card: two shards of one card keep two chains
    assert cache.get("two", 0, "cuda:0") is not cache.get("two", 1, "cuda:0")
    # the CPU keeps none
    assert cache.get("one", 0, "cpu") is not cache.get("one", 0, "cpu")
    # graphs.clear_chains drops every cache's chains
    kept = cache.get("two", 0, "cuda:0")
    assert cache.get("two", 0, "cuda:0") is kept
    graphs.clear_chains()
    assert cache.get("two", 0, "cuda:0") is not kept


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_four_card_mode_needs_four_cards():
    """``chip_smoke.require_cards(4)`` fails, naming the count, with
    fewer than four cards; ``chip_smoke.py --cards 4`` exits non-zero
    with that message and prints no result, and falls back to nothing."""
    smoke = _chip_smoke()
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have >= 4:
        pytest.skip(f"{have} cards visible")
    with pytest.raises(smoke.SmokeFailure,
                       match=f"--cards 4 needs 4 CUDA cards; {have} visible"):
        smoke.require_cards(4)
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--cards", "4"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "--cards 4 needs 4 CUDA cards; 0 visible" in out.stderr
    assert '"ok"' not in out.stdout


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    worker()
