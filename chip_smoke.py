#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``orb_slam2_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing falls back to the CPU):
  1. device: the card's name and power limit; build the hand-written
     CUDA kernels (csrc/*.cu) and print nvcc's register/smem report;
  2. kernels: each kernel against its plain PyTorch version on the card
     at main-path shapes, bit-exact, with CUDA-event times of both;
  3. slice: the pose-prior tracking + local-mapping path through
     ``System.track_monocular_with_pose`` on a 40-frame 1920x1440 aerial
     sweep with 4000 ORB features on 8 levels (the workload of
     bench.py), checking tracking, map quality and that every kernel of
     the path launched.
The last two lines are a JSON object describing the kernels and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

N_FRAMES = 40
FLIGHT_HEIGHT = 12.0
# map points lie on the plane z = 0; tests/test_pipeline.py holds the
# median |z| under 0.08 at flight height 10, scaled here to height 12
MEDIAN_Z_BAR = 0.1
MIN_KEYFRAMES = 3


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ----------------------------------------------------------------------
# bench configuration (bench.py:43-96)
# ----------------------------------------------------------------------
def bench_config():
    from orb_slam2_tpu_torch.geom.camera import Intrinsics
    from orb_slam2_tpu_torch.ops.extractor import OrbParams
    from orb_slam2_tpu_torch.pipeline.config import SlamConfig
    cam = Intrinsics(fx=960.0, fy=960.0, cx=960.0, cy=720.0,
                     width=1920, height=1440)
    return SlamConfig(
        cam=cam,
        orb=OrbParams(n_features=4000, n_levels=8, scale_factor=1.2),
        fps=10.0, pose_prior=True,
        init_min_matches=80, init_min_triangulated=50,
        init_min_tracked_after_ba=80,
        pad_min_bound=4096, pad_min_cand=16384,
        device_point_capacity=262144)


def bench_world(device):
    from orb_slam2_tpu_torch.utils import synth
    world = synth.make_world(seed=7, tex_size=4096, scale=120.0,
                             tex_shape=(3072, 10240),
                             origin_px=(1560.0, 1536.0), device=device)
    poses = synth.aerial_trajectory(N_FRAMES, height=FLIGHT_HEIGHT,
                                    speed=0.5)
    return world, poses


# ----------------------------------------------------------------------
# phase 2 inputs: search problems shaped like the main path's
# ----------------------------------------------------------------------
def search_problem(n_rows: int, n_cols: int, epipolar: bool, seed: int,
                   device):
    """Columns: keypoints over a 1920x1440 image on 8 octaves; rows:
    noisy copies of random columns (descriptor bit flips, position
    jitter), so windows and lines admit real near matches as in the
    tracking and triangulation searches."""
    import torch
    rng = np.random.default_rng(seed)
    sf = 1.2 ** np.arange(8)
    cdesc = rng.integers(0, 2 ** 32, (n_cols, 8), dtype=np.uint64).astype(np.uint32)
    cxy = rng.uniform([0, 0], [1920, 1440], (n_cols, 2)).astype(np.float32)
    coct = rng.integers(0, 8, n_cols)
    cval = rng.random(n_cols) > 0.03
    src = rng.integers(0, n_cols, n_rows)
    bits = np.unpackbits(cdesc[src].view(np.uint8), axis=1)
    flip = rng.random(bits.shape) < rng.uniform(0, 0.25, (n_rows, 1))
    rdesc = np.packbits(bits ^ flip, axis=1).view(np.uint32)
    rxy = cxy[src] + rng.normal(0, 3, (n_rows, 2)).astype(np.float32)
    rval = rng.random(n_rows) > 0.03
    if epipolar:
        ang = rng.uniform(0, np.pi, n_rows)
        a, b = np.cos(ang), np.sin(ang)
        c = -(a * rxy[:, 0] + b * rxy[:, 1])
        row_attr = np.stack([a, b, c, rval], 1).astype(np.float32)
        col_attr = np.stack([cxy[:, 0], cxy[:, 1], 3.84 * sf[coct] ** 2,
                             cval], 1).astype(np.float32)
    else:
        roct = coct[src]
        row_attr = np.stack([rxy[:, 0], rxy[:, 1], 7.0 * sf[roct],
                             roct - 1, roct + 1, rval], 1).astype(np.float32)
        col_attr = np.stack([cxy[:, 0], cxy[:, 1], coct, cval],
                            1).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return (t(rdesc.view(np.int32)), t(cdesc.view(np.int32)),
            t(row_attr), t(col_attr))


def phase_kernels(device, world, cfg):
    """Each kernel against its plain version, bit-exact, with times."""
    import torch
    from orb_slam2_tpu_torch.matching import hamming_top2 as ht
    from orb_slam2_tpu_torch.ops import fast, pyramid
    from orb_slam2_tpu_torch.utils import synth
    results = {}

    # K1 on all 8 levels of a rendered 1920x1440 frame
    _, poses = bench_world(device)
    img = synth.render(world, cfg.cam, poses[0]).float()
    levels = pyramid.build_pyramid(img, cfg.orb.n_levels,
                                   cfg.orb.scale_factor)
    err = 0.0
    for lvl in levels:
        k = fast.fast_score(lvl)
        p = fast.fast_score_map(lvl)
        torch.cuda.synchronize()
        ki, pi = k[3:-3, 3:-3], p[3:-3, 3:-3]
        check(torch.equal(ki, pi),
              f"K1 differs from fast_score_map on the interior of a "
              f"{tuple(lvl.shape)} level: max |diff| "
              f"{(ki - pi).abs().max().item()}")
        err = max(err, (ki - pi).abs().max().item())
    ms = cuda_ms(lambda: [fast.fast_score(lvl) for lvl in levels])
    plain_ms = cuda_ms(lambda: [fast.fast_score_map(lvl) for lvl in levels])
    results["fast_score"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        shape="8 levels of 1920x1440")
    log(f"K1 fast_score: interior bit-exact on 8 levels; "
        f"{ms:.4f} ms per frame (plain {plain_ms:.4f} ms)")

    # K2 at the last-frame (4096x4096) and local-map (16384x4096) shapes
    for n_rows, seed in ((4096, 1), (16384, 2)):
        args = search_problem(n_rows, 4096, False, seed, device)
        k = ht.masked_top2_mutual(*args)
        p = ht.masked_top2_mutual_plain(*args)
        torch.cuda.synchronize()
        for a, b, what in zip(k, p, ("best", "second", "column")):
            check(torch.equal(a, b),
                  f"K2 {what} keys differ at {n_rows}x4096 "
                  f"({(a != b).sum().item()} entries)")
        n_match = int((k[0] // ht.COL_STRIDE <= 100).sum())
        check(n_match > 0, "K2 test problem admits no match")
        ms = cuda_ms(lambda: ht.masked_top2_mutual(*args))
        plain_ms = cuda_ms(lambda: ht.masked_top2_mutual_plain(*args),
                           reps=5)
        log(f"K2 masked_top2_mutual {n_rows}x4096: keys bit-exact "
            f"({n_match} rows matched); {ms:.4f} ms "
            f"(plain {plain_ms:.4f} ms)")
        results["masked_top2_mutual"] = dict(
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            shape=f"{n_rows}x4096")

    # K3 at the triangulation shape (4096x4096)
    args = search_problem(4096, 4096, True, 3, device)
    k = ht.masked_top2_epi(*args)
    p = ht.masked_top2_epi_plain(*args)
    torch.cuda.synchronize()
    for a, b, what in zip(k, p, ("best", "second", "column")):
        check(torch.equal(a, b),
              f"K3 {what} keys differ at 4096x4096 "
              f"({(a != b).sum().item()} entries)")
    n_match = int((k[0] // ht.COL_STRIDE <= 50).sum())
    check(n_match > 0, "K3 test problem admits no match")
    ms = cuda_ms(lambda: ht.masked_top2_epi(*args))
    plain_ms = cuda_ms(lambda: ht.masked_top2_epi_plain(*args), reps=5)
    log(f"K3 masked_top2_epi 4096x4096: keys bit-exact ({n_match} rows "
        f"matched); {ms:.4f} ms (plain {plain_ms:.4f} ms)")
    results["masked_top2_epi"] = dict(max_abs_err=0.0, ms=ms,
                                      plain_ms=plain_ms, shape="4096x4096")
    return results


def phase_slice(device, world, cfg):
    """The main path: System.track_monocular_with_pose over the sweep."""
    import torch
    from orb_slam2_tpu_torch import kernels
    from orb_slam2_tpu_torch.pipeline.system import System
    from orb_slam2_tpu_torch.pipeline.tracking import TrackState
    from orb_slam2_tpu_torch.utils import synth
    _, poses = bench_world(device)
    # the frames are rendered on the card before the timed loop, as
    # bench.py stages its sequence
    frames = [synth.render(world, cfg.cam, T) for T in poses]
    torch.cuda.synchronize()
    system = System(cfg, enable_loop_closing=False, device=device)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    states, frame_ms = [], []
    for i, T in enumerate(poses):
        t0 = time.perf_counter()
        system.track_monocular_with_pose(frames[i], i * 0.1, T)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        states.append(system.state)
        log(f"frame {i:2d}: {system.state.name:15s} "
            f"inliers={system.tracker.matches_inliers:5d} "
            f"kfs={system.store.n_valid_keyframes():3d} "
            f"points={system.store.n_valid_points():6d} "
            f"{frame_ms[-1]:9.1f} ms")
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    ok_idx = [i for i, s in enumerate(states) if s == TrackState.OK]
    check(bool(ok_idx), "the map never initialized")
    first = ok_idx[0]
    check(all(s == TrackState.OK for s in states[first:]),
          f"a frame after initialization (frame {first}) is not OK: "
          f"{[s.name for s in states]}")
    n_kf = system.store.n_valid_keyframes()
    check(n_kf >= MIN_KEYFRAMES, f"only {n_kf} keyframes")
    pts = system.map_points()
    check(len(pts) > 0 and bool(np.isfinite(pts).all()),
          "map points missing or not finite")
    med_z = float(np.median(np.abs(pts[:, 2])))
    check(med_z < MEDIAN_Z_BAR,
          f"map points off the plane: median |z| {med_z:.4f} >= "
          f"{MEDIAN_Z_BAR}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    steady = frame_ms[first + 1:]
    log(f"slice: {len(ok_idx)}/{N_FRAMES} frames OK (initialized at frame "
        f"{first}), {n_kf} keyframes, {len(pts)} map points, median |z| "
        f"{med_z:.4f}")
    log(f"slice: median frame {np.median(steady):.1f} ms after init "
        f"(host clock around torch.cuda.synchronize()), mean "
        f"{np.mean(steady):.1f} ms, max {np.max(steady):.1f} ms; "
        f"peak device memory {peak / 2 ** 20:.0f} MiB")
    log(f"slice: kernel launches {json.dumps(launches)}")
    log("timing report:\n" + system.timing_report())
    return launches


KERNEL_META = {
    "fast_score": ("orb_slam2_tpu_torch/csrc/fast_score.cu",
                   "orb_slam2_tpu/ops/fast.py:81"),
    "masked_top2_mutual": ("orb_slam2_tpu_torch/csrc/hamming_top2.cu",
                           "orb_slam2_tpu/matching/pallas_hamming.py:187"),
    "masked_top2_epi": ("orb_slam2_tpu_torch/csrc/hamming_top2.cu",
                        "orb_slam2_tpu/matching/pallas_hamming.py:307"),
}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the "
              "card", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "orb_slam2_tpu_torch")):
        print("chip_smoke: orb_slam2_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from orb_slam2_tpu_torch import kernels

    device = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {kind} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}); nvidia-smi: {smi}")
    info = kernels.build(force=True)
    kernels.library()
    log(f"build: {info['seconds']:.1f} s")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"ptxas: {line.strip()}")

    cfg = bench_config()
    world, _ = bench_world(device)
    try:
        timing = phase_kernels(device, world, cfg)
        launches = phase_slice(device, world, cfg)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    rows = []
    for name, (source, replaces) in KERNEL_META.items():
        t = timing[name]
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=launches[name],
                         max_abs_err=t["max_abs_err"], ms=t["ms"],
                         plain_ms=t["plain_ms"], shape=t["shape"]))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
