"""Two OS processes join one gloo process group on the CPU through the
port's init_multihost + make_global_mesh and run
distributed_bundle_adjust on test_parallel.py's scene, one shard each
(the port's counterpart of test_multihost.py).  Bars: both ranks
print the same cost and the same cameras, within 1e-3 (rtol) of the
single-device cost; every observation's inlier flag comes back.  The
backend rule of ``multihost._backend`` is held with the host's card
count and environment patched: no silent fallback to gloo.

The test runs this file as each rank's worker:

    python test_torch_multihost.py HOST:PORT RANK WORLD PROBLEM.npz
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def worker():
    coord, rank, world, path = (sys.argv[1], int(sys.argv[2]),
                                int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    from orb_slam2_tpu_torch.parallel import (distributed_bundle_adjust,
                                              init_multihost,
                                              make_global_mesh)
    import torch.distributed as dist
    init_multihost(coordinator=coord, num_processes=world, process_id=rank,
                   backend="gloo")
    mesh = make_global_mesh(device="cpu")
    assert mesh.size == world and mesh.local_shards() == [rank]
    x = mesh.psum(torch.tensor([float(rank + 1)]))
    assert x.item() == world * (world + 1) / 2
    p = np.load(path)
    res = distributed_bundle_adjust(
        mesh, p["cams"], p["pts"], p["oc"], p["op"], p["ouv"], p["isig2"],
        p["valid"], p["fixed"], *p["cam"].tolist(), iters=10, cg_iters=30)
    np.save(f"{path}.rank{rank}.npy", res.cam_Tcw.cpu().numpy())
    print(f"rank={rank} backend={dist.get_backend()} "
          f"cost={float(res.final_cost)!r} inliers={int(res.obs_inlier.sum())}"
          f" n_obs={len(res.obs_inlier)}", flush=True)
    dist.destroy_process_group()
    print("MULTIHOST_OK", flush=True)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_distributed_ba(tmp_path):
    from orb_slam2_tpu_torch.optim import ba as tba
    from test_torch_parallel import _ba_problem, FX, FY, CX, CY
    args = _ba_problem()
    names = ("cams", "pts", "oc", "op", "ouv", "isig2", "valid", "fixed")
    path = str(tmp_path / "problem.npz")
    np.savez(path, cam=np.array([FX, FY, CX, CY]),
             **dict(zip(names, args)))
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), coord, str(rank), "2",
         path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=HERE) for rank in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert "MULTIHOST_OK" in out and "backend=gloo" in out, out[-3000:]
    costs = [float(o.split("cost=")[1].split()[0]) for o in outs]
    assert costs[0] == costs[1]
    n_obs = [int(o.split("n_obs=")[1].split()[0]) for o in outs]
    assert n_obs == [len(args[2])] * 2
    cams = [np.load(f"{path}.rank{r}.npy") for r in range(2)]
    assert np.array_equal(cams[0], cams[1])
    single = tba.bundle_adjust(*[torch.as_tensor(a) for a in args],
                               FX, FY, CX, CY, iters=10, cg_iters=30)
    np.testing.assert_allclose(costs[0], float(single.final_cost), rtol=1e-3)
    np.testing.assert_allclose(cams[0], single.cam_Tcw.numpy(), atol=2e-4)


def _cards(monkeypatch, n, local=None):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))


def test_backend_unset_local_world_beyond_the_cards_raises(monkeypatch):
    """Eight ranks, four cards, LOCAL_WORLD_SIZE unset (two hosts launched
    without a launcher): an error naming LOCAL_WORLD_SIZE, not gloo."""
    from orb_slam2_tpu_torch.parallel.multihost import _backend
    _cards(monkeypatch, 4)
    with pytest.raises(RuntimeError, match="LOCAL_WORLD_SIZE"):
        _backend(8)
    assert _backend(4) == "nccl"     # the whole world on this host's cards


def test_backend_set_local_world_is_nccl(monkeypatch):
    """LOCAL_WORLD_SIZE set within the host's cards: NCCL for any world;
    set beyond them: an error that says to ask for gloo."""
    from orb_slam2_tpu_torch.parallel.multihost import _backend
    _cards(monkeypatch, 4, local=4)
    assert _backend(8) == "nccl"
    _cards(monkeypatch, 4, local=8)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        _backend(8)


def test_backend_gloo_only_when_asked(monkeypatch):
    """gloo where the caller names it (on a host with cards or none);
    no visible card and no backend named raises; an unknown name raises."""
    from orb_slam2_tpu_torch.parallel.multihost import _backend
    _cards(monkeypatch, 1)
    assert _backend(2, "gloo") == "gloo"
    _cards(monkeypatch, 0)
    assert _backend(2, "gloo") == "gloo"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _backend(2)
    with pytest.raises(ValueError):
        _backend(2, "mpi")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    worker()
