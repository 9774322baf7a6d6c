"""Two OS processes join one gloo process group on the CPU through the
port's init_multihost + make_global_mesh and run
distributed_bundle_adjust on test_parallel.py's scene, one shard each
(the port's counterpart of test_multihost.py).  Bars: both ranks
print the same cost and the same cameras, within 1e-3 (rtol) of the
single-device cost; every observation's inlier flag comes back.

The test runs this file as each rank's worker:

    python test_torch_multihost.py HOST:PORT RANK WORLD PROBLEM.npz
"""
import os
import socket
import subprocess
import sys

import numpy as np
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
    init_multihost(coordinator=coord, num_processes=world, process_id=rank)
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


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    worker()
