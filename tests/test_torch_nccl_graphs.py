"""The captured form of the sharded solvers' graph chains, run on the CPU.

On a NCCL process group the mesh's ``psum`` is capturable
(``graphs.capturable``), and ``graphs.Chain`` runs every collective as a
step of its segment: the sums written back over their entries inside the
capture, a segment cut only before each LM iteration and the finish.
The card checks the capture itself (``tests/test_torch_gpu.py``,
``chip_smoke.py --nccl-worker``); here the same program order runs
eagerly on CPU shards whose hook is declared capturable.  On
tests/test_parallel.py's scenes (the solvers and cuts of
tests/test_torch_parallel_graphs.py), bit for bit throughout:

- the captured order equals the cut chain and the one-call core on
  every shard, for all three solvers, and runs ``iters + 2`` segments a
  shard (none cut at a collective);
- two gloo ranks forced into the captured order print the cut form's
  cost and cameras;
- a gloo mesh says it cannot be captured;
- a capturable hook that fails inside the captured form raises, and
  nothing runs the solve again in another form.

The test runs this file as each gloo rank's worker:

    python test_torch_nccl_graphs.py HOST:PORT RANK WORLD PROBLEM.npz
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

BA_KW = dict(iters=3, cg_iters=8)
PG_KW = dict(iters=4, cg_iters=10)
CHAIN = {"obs": "ba", "points": "ba", "pose_graph": "pose_graph"}


def _solve(solver, mesh, a, eager=False):
    """One of the three sharded solves on the problem arrays ``a`` (the
    BA's ``b0..b7`` and camera ``cam``, the pose graph's ``p0..p5``)."""
    from orb_slam2_tpu_torch import parallel
    if solver == "pose_graph":
        return parallel.distributed_pose_graph(
            mesh, *[a[f"p{i}"] for i in range(6)], **PG_KW, eager=eager)
    fn = (parallel.distributed_bundle_adjust if solver == "obs" else
          parallel.distributed_bundle_adjust_sharded_points)
    return fn(mesh, *[a[f"b{i}"] for i in range(8)],
              *[float(c) for c in a["cam"]], **BA_KW, eager=eager)


def worker():
    coord, rank, world, path = (sys.argv[1], int(sys.argv[2]),
                                int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    import torch.distributed as dist
    from orb_slam2_tpu_torch import graphs
    from orb_slam2_tpu_torch.parallel import init_multihost, make_global_mesh
    init_multihost(coordinator=coord, num_processes=world, process_id=rank,
                   backend="gloo")
    mesh = make_global_mesh(device="cpu")
    print(f"rank={rank} backend={dist.get_backend()} "
          f"capturable={mesh.capturable}", flush=True)
    a = dict(np.load(path))
    for solver in ("obs", "points", "pose_graph"):
        for form in ("cut", "captured"):
            # forced: gloo's sums go through the host, so its mesh says
            # it cannot be captured; on the CPU the order runs all the same
            mesh.capturable = form == "captured"
            graphs.reset_stats()
            res = _solve(solver, mesh, a)
            ran = graphs.STATS[CHAIN[solver]]
            first = res.sims if solver == "pose_graph" else res.cam_Tcw
            np.save(f"{path}.{solver}.{form}.rank{rank}.npy",
                    first.cpu().numpy())
            print(f"rank={rank} solver={solver} form={form} "
                  f"ran={'captured' if ran.get('captured') else 'cut'} "
                  f"segments={ran['segments']} "
                  f"cost={float(res.final_cost)!r}", flush=True)
    dist.destroy_process_group()
    print("NCCL_GRAPHS_OK", flush=True)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ----------------------------------------------------------------------
# The tests (they import the JAX package's scenes; the worker does not)
# ----------------------------------------------------------------------

def _problem() -> dict:
    from test_optim import FX, FY, CX, CY
    from test_torch_parallel import _ba_problem, _pose_graph_problem
    a = {f"b{i}": np.array(x) for i, x in enumerate(_ba_problem())}
    a.update({f"p{i}": np.array(x)
              for i, x in enumerate(_pose_graph_problem()[0])})
    a["cam"] = np.array([FX, FY, CX, CY])
    return a


def _meshes():
    from orb_slam2_tpu_torch import graphs
    from test_torch_parallel import SpyMesh

    class CapturedMesh(SpyMesh):
        """A CPU mesh whose ``psum`` is declared capturable, as a NCCL
        mesh's is: the chains run the captured form's order."""

        def run(self, body):
            return super().run(lambda d, dev, psum: body(
                d, dev, graphs.capturable(psum, "cpu-test")))
    return SpyMesh, CapturedMesh


def _shards(mesh):
    return {d: [t.detach().cpu().numpy() for t in r]
            for d, r in mesh.results.items()}


def _assert_equal(a, b):
    assert a.keys() == b.keys()
    for d in a:
        for x, y in zip(a[d], b[d]):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("solver", ["obs", "points", "pose_graph"])
def test_captured_order_equals_cut_and_core(solver, n):
    """The captured order (each collective a step of its segment, its
    sums written back in place) against the cut chain and the one-call
    core through the same kind of mesh: every shard's every result and
    the whole call's, bit for bit.  ``graphs.STATS`` records the form
    each ran and ``iters + 2`` segments a captured shard (the first
    linearization, one an LM iteration, the finish)."""
    from orb_slam2_tpu_torch import graphs
    SpyMesh, CapturedMesh = _meshes()
    a = _problem()
    name = CHAIN[solver]
    runs = {}
    for form, cls, eager in (("captured", CapturedMesh, False),
                             ("cut", SpyMesh, False), ("core", SpyMesh, True)):
        graphs.reset_stats()
        mesh = cls(n)
        runs[form] = (_solve(solver, mesh, a, eager), _shards(mesh),
                      dict(graphs.STATS.get(name, {})))
    iters = (PG_KW if solver == "pose_graph" else BA_KW)["iters"]
    assert runs["captured"][2]["captured"] == n
    assert "cut" not in runs["captured"][2]
    assert runs["captured"][2]["segments"] == n * (iters + 2)
    assert runs["cut"][2]["cut"] == n and "captured" not in runs["cut"][2]
    assert runs["cut"][2]["segments"] > n * (iters + 2)
    assert runs["core"][2] == {}
    for form in ("cut", "core"):
        _assert_equal(runs["captured"][1], runs[form][1])
        for x, y in zip(runs["captured"][0], runs[form][0]):
            assert torch.equal(x, y)


def test_chain_captured_form_runs_sums_as_steps():
    """A CPU chain with a capturable hook: a collective is a step of its
    segment (the steps after it read the sums, and the sums land in the
    buffers with the segment's results), segments end only before the
    ``cut_before`` steps, and the buffers end as the cut form's and the
    eager run's."""
    from orb_slam2_tpu_torch import graphs

    def double(st, cfg):
        return dict(y=st["x"] * 2.0)

    def bump(st, cfg):
        return dict(x=st["y"] + cfg)

    program = [double, graphs.Collective("a", ("y",)), bump,
               graphs.Collective("a", ("x",)), double, bump,
               graphs.Collective("b", ("x",))]
    seen = []

    def hook(vals):
        seen.append(vals[0].clone())
        return tuple(v * 10.0 for v in vals)
    out = {}
    for form, h in (("captured", graphs.capturable(hook, "k")),
                    ("cut", hook)):
        graphs.reset_stats()
        seen.clear()
        chain = graphs.Chain("t", "cpu")
        chain.load(x=np.arange(3, dtype=np.float32))
        out[form] = {k: v.clone() for k, v in chain.run(
            program, 0.5, {"a": h, "b": None}, cut_before=(bump,)).items()}
        out[form + "_seen"] = [s.clone() for s in seen]
        out[form + "_stats"] = dict(graphs.STATS["t"])
    assert out["captured_stats"]["captured"] == 1
    # [double, sum y] [bump, sum x, double] [bump]: cut before each bump
    assert out["captured_stats"]["segments"] == 3
    # the cut form: [double] sum [bump] sum [double, bump]
    assert out["cut_stats"]["segments"] == 3 and out["cut_stats"]["cut"] == 1
    assert torch.equal(out["captured_seen"][0], torch.tensor([0.0, 2.0, 4.0]))
    assert torch.equal(out["captured_seen"][1],
                       torch.tensor([0.5, 20.5, 40.5]))
    st = graphs.run_eager(program, dict(x=torch.arange(3.0)), 0.5,
                          {"a": hook, "b": None})
    for k in ("x", "y"):
        assert torch.equal(out["captured"][k], out["cut"][k])
        assert torch.equal(out["captured"][k], st[k])


def test_sum_steps_compare_by_collective():
    """Two solves' sum steps are equal where their collectives are,
    whatever hook each carries: a chain finds its captured segments
    again on every solve (the chain itself is keyed on the hook's
    ``capture_key``)."""
    from orb_slam2_tpu_torch import graphs
    c = graphs.Collective("cam", ("hcc", "gc"))
    h1 = graphs.capturable(lambda x: x, "k")
    h2 = graphs.capturable(lambda x: x, "k")
    steps1, steps2 = (graphs._Sum(c, h1),), (graphs._Sum(c, h2),)
    assert steps1 == steps2 and hash(steps1) == hash(steps2)
    assert graphs._Sum(c, h1) != graphs._Sum(
        graphs.Collective("cam", ("hcc",)), h1)
    assert graphs._Sum(c, h1).__name__ == "cam(hcc,gc)"
    assert graphs.capture_key(h1) == "k"
    assert graphs.capture_key(lambda x: x) is None


def test_two_gloo_ranks_captured_order_equals_cut(tmp_path):
    """Two OS processes in one gloo group on the CPU (the worker pattern
    of test_torch_multihost.py): the mesh says it cannot be captured;
    forced into the captured order, each of the three solvers prints
    the cut form's cost and saves its cameras (vertices), bit for bit,
    on both ranks."""
    path = str(tmp_path / "problem.npz")
    np.savez(path, **_problem())
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), coord, str(rank), "2",
         path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=HERE) for rank in range(2)]
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
        assert "NCCL_GRAPHS_OK" in out, out[-3000:]
        assert f"rank={rank} backend=gloo capturable=False" in out
    costs = {}
    for out in outs:
        for ln in out.splitlines():
            if " solver=" not in ln:
                continue
            f = dict(kv.split("=", 1) for kv in ln.split())
            assert f["ran"] == f["form"], ln
            costs[f["rank"], f["solver"], f["form"]] = float(f["cost"])
    for solver in ("obs", "points", "pose_graph"):
        vals = {costs[str(r), solver, form] for r in range(2)
                for form in ("cut", "captured")}
        assert len(vals) == 1, (solver, vals)
        cams = [np.load(f"{path}.{solver}.{form}.rank{r}.npy")
                for r in range(2) for form in ("cut", "captured")]
        assert all(np.array_equal(c, cams[0]) for c in cams[1:]), solver


def test_gloo_mesh_is_not_capturable(tmp_path):
    """A gloo group's mesh (one rank, in this process) says it cannot be
    captured and hands its bodies a hook with no capture key: the
    chains cut at every collective."""
    import torch.distributed as dist
    from orb_slam2_tpu_torch import graphs
    from orb_slam2_tpu_torch.parallel import make_global_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = make_global_mesh(device="cpu")
        assert not mesh.capturable
        keys = mesh.run(lambda d, dev, psum: graphs.capture_key(psum))
        assert keys == {0: None}
        x = mesh.psum((torch.ones(2), torch.full((1,), 3.0)))
        assert torch.equal(x[1], torch.full((1,), 3.0))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("solver", ["obs", "points", "pose_graph"])
def test_capture_failure_raises_without_fallback(solver):
    """A capturable hook that fails inside the captured form (on the
    card: a capture that NCCL refuses) fails the solve with its own
    error: the hook is not called again, and no other form runs
    (``graphs.STATS`` records one captured run and no cut one)."""
    from orb_slam2_tpu_torch import graphs
    from orb_slam2_tpu_torch.parallel import LocalMesh
    calls = [0]

    class FailingCapture(LocalMesh):
        def run(self, body):
            def failing(d, dev, psum):
                def sums(x):
                    calls[0] += 1
                    if calls[0] == 3:
                        raise RuntimeError("capture failed")
                    return psum(x)
                return body(d, dev, graphs.capturable(sums, "cpu-test"))
            return super().run(failing)

    graphs.reset_stats()
    with pytest.raises(RuntimeError, match="capture failed"):
        _solve(solver, FailingCapture(["cpu"]), _problem())
    assert calls[0] == 3
    assert graphs.STATS[CHAIN[solver]].get("captured") == 1
    assert "cut" not in graphs.STATS[CHAIN[solver]]


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    worker()
