#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``orb_slam2_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing falls back to the CPU):
  1. device: the card's name and power limit; build the hand-written
     CUDA kernels (csrc/*.cu) and print nvcc's register/smem report;
  2. kernels: each kernel (K1-K4) against its plain PyTorch version on
     the card at main-path shapes, bit-exact, with CUDA-event times of
     both and the least time the card could take (``bound_ms``);
  3. path A, bench.py's topology: ``System(cfg,
     enable_loop_closing=True, async_mapping=True)`` tracks a 40-frame
     1920x1440 aerial sweep with 4000 ORB features on 8 levels through
     ``track_monocular_with_pose`` while local mapping and loop
     detection run on the mapping thread; checks tracking, map quality,
     the vocabulary and BoW database, and that K1-K3 launched;
  4. path C: K4 through its entry point ``hamming_top2`` at 4096x4096
     with 20% of the columns invalid;
  5. path B, a loop that closes at full width: a drifted circuit with
     sequential mapping must run DetectLoop -> Sim3 -> correction ->
     essential graph -> global BA and lower the keyframe ATE below the
     drifted priors'; prints the loop-closing stage times.
The kernel launch counts are read per path, each path driven with the
counts set to 0 just before it.  The last three lines are a JSON object
describing the kernels, the card's name and power limit, and
``{"ok": true, "device": {...}}``.

Two diagnostics print no such lines: ``--profile`` runs path A alone
with torch.profiler over a window of frames, and ``--repeat-b`` runs
path B four times and says where the runs part.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

N_FRAMES = 40
FLIGHT_HEIGHT = 12.0
# map points lie on the plane z = 0; tests/test_pipeline.py holds the
# median |z| under 0.08 at flight height 10, scaled here to height 12
MEDIAN_Z_BAR = 0.1
MIN_KEYFRAMES = 3

# path B: the drifted circuit of tests/test_loop_proof.py at bench
# width.  The 1920x1440 footprint at height 12 is 24 x 18 units; on a
# circle of radius 6-16 it overlaps so much of the lap that the loop
# fires against an early keyframe with a long covisible group, and the
# essential graph's identity-weighted edges leave the corrected map no
# better than the drifted priors.  At radius 20 the footprint spans a
# fifth of the lap (test_torch_loop.py's 640x480 circuit: 0.28).
LOOP_LAP = 100          # frames per lap
LOOP_REVISIT = 14       # frames of the lap flown again
LOOP_RADIUS = 20.0      # world units
LOOP_DRIFT = 0.02       # prior drift per frame, world units
LOOP_MIN_OK = 0.7       # share of frames tracked OK
# path A with --profile: the frames recorded by torch.profiler
PROFILE_FROM = 20

# H100 SXM peaks (NVIDIA data sheet, dense): int8 tensor cores, float32
# outside them, and device memory.  A Hamming distance of two 256-bit
# descriptors is (256 - x.y) / 2 for their +-1 vectors x, y; that
# 256-term product is exact in int8 with int32 accumulation, so int8
# is the fastest type that computes it exactly and its rate bounds the
# Hamming searches.
PEAK_INT8 = 1979e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


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


def bound(n_bytes: int, n_ops: int, peak_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their
    type.  The Hamming searches count as the 256-deep +-1 product the
    TPU ran them as: 2*N*M*256 operations at the int8 tensor rate."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def k4_problem(n_rows: int, n_cols: int, invalid: float, seed: int, device):
    """K4 inputs: random columns, rows that are noisy copies of random
    columns, a share of the columns invalid."""
    import torch
    rng = np.random.default_rng(seed)
    cdesc = rng.integers(0, 2 ** 32, (n_cols, 8), dtype=np.uint64).astype(np.uint32)
    src = rng.integers(0, n_cols, n_rows)
    bits = np.unpackbits(cdesc[src].view(np.uint8), axis=1)
    flip = rng.random(bits.shape) < rng.uniform(0, 0.25, (n_rows, 1))
    rdesc = np.packbits(bits ^ flip, axis=1).view(np.uint32)
    valid = rng.random(n_cols) >= invalid
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return t(rdesc.view(np.int32)), t(cdesc.view(np.int32)), t(valid)


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
    # per pixel: read 4 B, write 4 B; 32 ring differences, 2 x (64 arc
    # mins + 16 maxes) and one max = 193 float ops on the CUDA cores
    pixels = sum(int(lvl.numel()) for lvl in levels)
    results["fast_score"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        shape="8 levels of 1920x1440",
        **bound(8 * pixels, 193 * pixels, PEAK_FP32))
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
            shape=f"{n_rows}x4096",
            **bound(n_rows * (32 + 24 + 8) + 4096 * (32 + 16 + 4),
                    2 * n_rows * 4096 * 256, PEAK_INT8))

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
    results["masked_top2_epi"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, shape="4096x4096",
        **bound(4096 * (32 + 16 + 8) + 4096 * (32 + 16 + 4),
                2 * 4096 * 4096 * 256, PEAK_INT8))

    # K4 at tools/pallas_chip_check.py's shape, 20% of the columns
    # invalid, then a block of rows with no valid column at all
    args = k4_problem(4096, 4096, 0.2, 4, device)
    k = ht.hamming_top2(*args)
    p = ht.hamming_top2_plain(*args)
    torch.cuda.synchronize()
    for a, b, what in zip(k, p, ("best", "best_idx", "second")):
        check(torch.equal(a, b), f"K4 {what} differs at 4096x4096 "
              f"({(a != b).sum().item()} rows)")
    n_match = int((k[0] <= 64).sum())
    check(n_match > 0, "K4 test problem admits no near match")
    blk = k4_problem(512, 4096, 1.0, 5, device)
    kb, pb = ht.hamming_top2(*blk), ht.hamming_top2_plain(*blk)
    torch.cuda.synchronize()
    for a, b, what in zip(kb, pb, ("best", "best_idx", "second")):
        check(torch.equal(a, b), f"K4 {what} differs on the all-invalid "
              f"block ({(a != b).sum().item()} rows)")
    check(bool((kb[0] >= ht.BIG).all() and (kb[2] == ht.BIG).all()),
          "K4 all-invalid rows must give BIG + d and second == BIG")
    ms = cuda_ms(lambda: ht.hamming_top2(*args))
    plain_ms = cuda_ms(lambda: ht.hamming_top2_plain(*args), reps=5)
    log(f"K4 hamming_top2 4096x4096 (20% columns invalid): bit-exact "
        f"({n_match} rows within 64 bits), all-invalid 512x4096 block "
        f"bit-exact; {ms:.4f} ms (plain {plain_ms:.4f} ms)")
    results["hamming_top2"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, shape="4096x4096",
        **bound(4096 * (32 + 12) + 4096 * (32 + 1),
                2 * 4096 * 4096 * 256, PEAK_INT8))
    for name, r in results.items():
        log(f"bound {name} {r['shape']}: {r['bound_ms'] * 1e3:.2f} us "
            f"({r['bound_by']}); kernel at {r['bound_ms'] / r['ms']:.3f} "
            f"of it")
    return results


class LockWaitClock:
    """Wraps the map lock and adds up how long the tracking (main)
    thread waited to take it: the tracker's frame time spent waiting on
    the mapping thread's host sections."""

    def __init__(self, lock):
        self._lock = lock
        self._main = threading.main_thread()
        self.wait_s = 0.0

    def acquire(self, *args, **kwargs):
        if threading.current_thread() is not self._main:
            return self._lock.acquire(*args, **kwargs)
        t0 = time.perf_counter()
        got = self._lock.acquire(*args, **kwargs)
        self.wait_s += time.perf_counter() - t0
        return got

    def release(self):
        self._lock.release()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()


def kf_ate(store, true, poses=None):
    """Sim3-aligned ATE of the valid keyframes' centers against the true
    poses (or of the given per-frame poses at the keyframes' frames)."""
    from orb_slam2_tpu_torch.utils.evaluate import ate_rmse
    est, gt = [], []
    for kf in store.kfs:
        if not kf.valid:
            continue
        fid = kf.frame.frame_id
        T = kf.Tcw if poses is None else poses[fid]
        est.append(-T[:3, :3].T @ T[:3, 3])
        gt.append(-true[fid][:3, :3].T @ true[fid][:3, 3])
    return ate_rmse(np.stack(est), np.stack(gt), align="sim3")


def device_window(trace_path: str, threads: dict) -> dict:
    """Reads a torch.profiler chrome trace: the union of the card's
    kernel, copy and fill intervals, and per host thread the CUDA
    runtime calls that wait for the card (stream, device and event
    synchronizations, and copies, which wait for the work queued before
    them) and the kernel launches.  ``threads`` names threading.Thread
    objects."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in
                   ("kernel", "gpu_memcpy", "gpu_memset"))
    busy_us, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    # a runtime event names its thread by the system thread id, or by
    # the pthread id (whole or its low 32 bits) where the profiler did
    # not record the thread's system id
    names = {}
    for who, t in threads.items():
        for key in (t.native_id, t.ident, t.ident & 0xFFFFFFFF):
            names[key] = who
    per = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "cuda_runtime":
            continue
        tid = e.get("tid")
        who = names.get(tid, f"thread {tid}")
        d = per.setdefault(who, dict(sync_ms=0.0, copy_ms=0.0,
                                     launch_ms=0.0, launches=0))
        n = e["name"]
        if "Synchronize" in n:
            d["sync_ms"] += e["dur"] / 1e3
        elif "Memcpy" in n:
            d["copy_ms"] += e["dur"] / 1e3
        elif "LaunchKernel" in n:
            d["launches"] += 1
            d["launch_ms"] += e["dur"] / 1e3
    return dict(busy_ms=busy_us / 1e3, n_device_spans=len(spans),
                threads=per)


def phase_bench(device, world, cfg, profile: bool = False):
    """Path A: bench.py's topology, System(enable_loop_closing=True,
    async_mapping=True), over the sweep; flush_mapping and shutdown at
    the end.  The tracker's time per frame is split by the main
    thread's CPU clock: what it did not run on a CPU it spent blocked,
    on the map lock (measured) or on the interpreter lock (the rest;
    CUDA spins while it synchronizes when the process holds fewer
    contexts than the host has cores, so synchronizations count as run
    time).  ``profile`` records the
    card over frames PROFILE_FROM.. with torch.profiler and reads the
    device's busy share and each thread's waits for the card."""
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
    system = System(cfg, enable_loop_closing=True, async_mapping=True,
                    device=device)
    clock = LockWaitClock(system.store.lock)
    system.store.lock = clock
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    states, frame_ms, cpu_ms, lock_ms = [], [], [], []
    prof = None
    for i, T in enumerate(poses):
        if profile and i == PROFILE_FROM:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        t0, c0, w0 = time.perf_counter(), time.thread_time(), clock.wait_s
        system.track_monocular_with_pose(frames[i], i * 0.1, T)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        cpu_ms.append((time.thread_time() - c0) * 1e3)
        lock_ms.append((clock.wait_s - w0) * 1e3)
        states.append(system.state)
        log(f"A frame {i:2d}: {system.state.name:15s} "
            f"inliers={system.tracker.matches_inliers:5d} "
            f"kfs={system.store.n_valid_keyframes():3d} "
            f"points={system.store.n_valid_points():6d} "
            f"{frame_ms[-1]:9.1f} ms")
    track_s = sum(frame_ms) / 1e3
    window = None
    if prof is not None:
        prof.stop()
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "path_a_trace.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
        window = device_window(path, {
            "tracker": threading.main_thread(),
            "mapper": system.map_worker._thread})
    t0 = time.perf_counter()
    system.flush_mapping()      # re-raises a mapping-thread exception
    flush_s = time.perf_counter() - t0
    system.shutdown()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    ok_idx = [i for i, s in enumerate(states) if s == TrackState.OK]
    check(bool(ok_idx), "A: the map never initialized")
    first = ok_idx[0]
    check(all(s == TrackState.OK for s in states[first:]),
          f"A: a frame after initialization (frame {first}) is not OK: "
          f"{[s.name for s in states]}")
    n_kf = system.store.n_valid_keyframes()
    check(n_kf >= MIN_KEYFRAMES, f"A: only {n_kf} keyframes")
    pts = system.map_points()
    check(len(pts) > 0 and bool(np.isfinite(pts).all()),
          "A: map points missing or not finite")
    med_z = float(np.median(np.abs(pts[:, 2])))
    check(med_z < MEDIAN_Z_BAR,
          f"A: map points off the plane: median |z| {med_z:.4f} >= "
          f"{MEDIAN_Z_BAR}")
    pr = system.place_rec
    check(pr.ready, "A: the vocabulary was never trained")
    check(pr.db is not None and len(pr.db.bow) > 0,
          "A: the BoW keyframe database is empty")
    for name in ("fast_score", "masked_top2_mutual", "masked_top2_epi"):
        check(launches[name] > 0, f"A: kernel {name} never launched")
    steady = frame_ms[first + 1:]
    log(f"A: {len(ok_idx)}/{N_FRAMES} frames OK (initialized at frame "
        f"{first}), {n_kf} keyframes, {len(pts)} map points, median |z| "
        f"{med_z:.4f}, {len(pr.db.bow)} keyframes in the BoW database")
    log(f"A: frame time after init with the mapping thread live: median "
        f"{np.median(steady):.1f} ms, mean {np.mean(steady):.1f} ms, max "
        f"{np.max(steady):.1f} ms (host clock around "
        f"torch.cuda.synchronize()); the tracker waited "
        f"{clock.wait_s * 1e3:.1f} ms of its {track_s * 1e3:.1f} ms on the "
        f"map lock; final flush {flush_s * 1e3:.1f} ms; peak device "
        f"memory {peak / 2 ** 20:.0f} MiB")
    wall, cpu, lck = (sum(x[first + 1:]) for x in (frame_ms, cpu_ms,
                                                     lock_ms))
    log(f"A: the tracker's {wall:.1f} ms over frames {first + 1}-"
        f"{N_FRAMES - 1}: {cpu:.1f} ms running on a CPU, {lck:.1f} ms on "
        f"the map lock, {wall - cpu - lck:.1f} ms blocked otherwise (the "
        f"interpreter lock) (main thread's CPU clock)")
    if window is not None:
        w_wall = sum(frame_ms[PROFILE_FROM:])
        w_cpu = sum(cpu_ms[PROFILE_FROM:])
        w_lck = sum(lock_ms[PROFILE_FROM:])
        tr = window["threads"].get("tracker", {})
        log(f"A profile, frames {PROFILE_FROM}-{N_FRAMES - 1} "
            f"(torch.profiler, CUDA activity): {w_wall:.1f} ms of tracker "
            f"wall time; the card busy {window['busy_ms']:.1f} ms "
            f"({window['busy_ms'] / w_wall:.3f} of it, "
            f"{window['n_device_spans']} kernels and copies); the tracker "
            f"ran {w_cpu:.1f} ms on a CPU, waited {tr.get('sync_ms', 0):.1f}"
            f" ms in CUDA synchronizations and {tr.get('copy_ms', 0):.1f} "
            f"ms in copies, {w_lck:.1f} ms on the map lock, and was "
            f"{w_wall - w_cpu - w_lck:.1f} ms blocked otherwise")
        for who, d in sorted(window["threads"].items()):
            log(f"A profile, {who}: {d['launches']} launches taking "
                f"{d['launch_ms']:.1f} ms, {d['sync_ms']:.1f} ms in "
                f"synchronizations, {d['copy_ms']:.1f} ms in copies")
    log(f"A: kernel launches {json.dumps(launches)}")
    log("A: timing report:\n" + system.timing_report())
    return launches


def phase_k4(device, expect):
    """Path C: K4 through its entry point at 4096x4096, 20% of the
    columns invalid; the result must equal the plain version's."""
    import torch
    from orb_slam2_tpu_torch import kernels
    from orb_slam2_tpu_torch.matching import hamming_top2 as ht
    args = k4_problem(4096, 4096, 0.2, 4, device)
    kernels.reset_launch_counts()
    out = ht.hamming_top2(*args)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check(launches["hamming_top2"] == 1, "C: K4 did not launch once")
    check(all(torch.equal(a, b) for a, b in zip(out, expect)),
          "C: K4 through its entry point differs from the plain version")
    log(f"C: hamming_top2 4096x4096: {launches['hamming_top2']} launch, "
        f"{int((out[0] <= 64).sum())} rows within 64 bits")
    return launches


def loop_circuit():
    """True circuit poses (one lap plus its first frames again) and the
    priors fed in, drifting LOOP_DRIFT units per frame in x and half of
    it in y (tests/test_loop_proof.py's construction)."""
    from orb_slam2_tpu_torch.utils import synth
    true = synth.loop_trajectory(LOOP_LAP, radius=LOOP_RADIUS,
                                 height=FLIGHT_HEIGHT)
    true = true + true[:LOOP_REVISIT]
    fed = []
    for t, Tcw in enumerate(true):
        D = np.eye(4, dtype=np.float32)
        D[:3, 3] = [LOOP_DRIFT * t, 0.5 * LOOP_DRIFT * t, 0.0]
        fed.append((Tcw @ np.linalg.inv(D)).astype(np.float32))
    return true, fed


def record_trail(system, trail: list, frame: list) -> None:
    """At the end of every timed stage of the tracker, the mapper and
    the loop closer, appends (frame, stage, digest of the map's host
    state) to ``trail``: two runs part at the first stage whose
    digests differ."""
    import contextlib
    import hashlib
    store, tracker = system.store, system.tracker

    def digest():
        h = hashlib.blake2b(digest_size=8)
        h.update(store.mp_pos.data.tobytes())
        h.update(store.mp_valid.data.tobytes())
        for kf in store.kfs:
            h.update(kf.Tcw.tobytes() + bytes([kf.valid]))
        if tracker.last_frame is not None:
            h.update(tracker.last_frame.Tcw.tobytes())
        h.update(np.int64(tracker.matches_inliers).tobytes())
        return h.hexdigest()

    for timer in (tracker.timer, system.mapper.timer,
                  system.loop_closer.timer):
        def timed(stage, _time=timer.time):
            with _time(stage):
                yield
            trail.append((frame[0], stage, digest()))
        timer.time = contextlib.contextmanager(timed)


def phase_loop(device, cfg, trail: list = None):
    """Path B: a drifted circuit at bench width, sequential mapping, so
    that whether the loop fires does not depend on thread timing.
    ``trail`` collects record_trail's stage digests."""
    import dataclasses
    import torch
    from orb_slam2_tpu_torch import kernels
    from orb_slam2_tpu_torch.pipeline.system import System
    from orb_slam2_tpu_torch.pipeline.tracking import TrackState
    from orb_slam2_tpu_torch.utils import synth
    true, fed = loop_circuit()
    # a square texture that holds the circle plus the footprint's
    # half-diagonal (15 units at height 12) and a unit of margin, at
    # bench.py's 120 px per unit
    side = int(np.ceil(2 * (LOOP_RADIUS + 16.0) * 120.0 / 128)) * 128
    world = synth.make_world(seed=7, tex_size=4096, scale=120.0,
                             tex_shape=(side, side), device=device)
    frames = [synth.render(world, cfg.cam, T) for T in true]
    torch.cuda.synchronize()
    lcfg = dataclasses.replace(cfg, loop_min_kfs_since_last=6)
    system = System(lcfg, enable_loop_closing=True, device=device)
    lc = system.loop_closer
    # keyframe ATE at each stage of the correction (the group correction
    # and loop fuse run before the essential graph, global BA after it)
    stage_ate = []

    def staged(fn, before, after):
        def run(*args, **kwargs):
            if before:
                stage_ate.append((before, kf_ate(system.store, true)))
            fn(*args, **kwargs)
            stage_ate.append((after, kf_ate(system.store, true)))
        return run
    lc._optimize_essential_graph = staged(
        lc._optimize_essential_graph, "group correction + loop fuse",
        "essential graph")
    lc.run_global_ba = staged(lc.run_global_ba, None, "global BA")
    frame_no = [0]
    if trail is not None:
        record_trail(system, trail, frame_no)
    kernels.reset_launch_counts()
    states, frame_ms = [], []
    for i, (img, Tf) in enumerate(zip(frames, fed)):
        frame_no[0] = i
        t0 = time.perf_counter()
        system.track_monocular_with_pose(img, i * 0.1, Tf)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        states.append(system.state)
        log(f"B frame {i:2d}: {system.state.name:15s} "
            f"kfs={system.store.n_valid_keyframes():3d} "
            f"loops={system.loop_closer.n_loops_closed} "
            f"{frame_ms[-1]:9.1f} ms")
    system.shutdown()
    launches = dict(kernels.LAUNCHES)
    n_ok = sum(s == TrackState.OK for s in states)
    last = {k: v for k, v in (lc.last_loop or {}).items()
            if k != "loop_connections"}
    log(f"B: {n_ok}/{len(true)} frames OK, {lc.n_loops_closed} loops "
        f"closed, last {last}")
    check(n_ok >= LOOP_MIN_OK * len(true),
          f"B: only {n_ok}/{len(true)} frames OK")
    check(lc.n_loops_closed >= 1, "B: the loop never closed")
    check(lc.last_loop["n_matched"] >= lcfg.loop_min_total_matches,
          f"B: {lc.last_loop['n_matched']} loop matches < "
          f"{lcfg.loop_min_total_matches}")
    pts = system.map_points()
    check(len(pts) > 0 and bool(np.isfinite(pts).all()),
          "B: map points missing or not finite")
    check(all(np.isfinite(kf.Tcw).all() for kf in system.store.kfs
              if kf.valid), "B: a keyframe pose is not finite")
    ate = kf_ate(system.store, true)
    ate_prior = kf_ate(system.store, true, poses=fed)
    log(f"B: keyframe ATE {ate:.4f} after loop correction, {ate_prior:.4f} "
        f"for the fed priors at the same {system.store.n_valid_keyframes()} "
        f"keyframes (Sim3-aligned); at the first loop, after "
        + ", ".join(f"{k} {v:.4f}" for k, v in stage_ate[:3]))
    check(ate < ate_prior, f"B: corrected keyframe ATE {ate:.4f} is not "
          f"below the priors' {ate_prior:.4f}")
    for name in ("fast_score", "masked_top2_mutual", "masked_top2_epi"):
        check(launches[name] > 0, f"B: kernel {name} never launched")
    log(f"B: kernel launches {json.dumps(launches)}")
    log("B: loop-closing stages (host clock):\n" + lc.timer.summary())
    log(f"B: median frame {np.median(frame_ms):.1f} ms, max "
        f"{np.max(frame_ms):.1f} ms")
    return launches


KERNEL_META = {
    "fast_score": ("orb_slam2_tpu_torch/csrc/fast_score.cu",
                   "orb_slam2_tpu/ops/fast.py:81"),
    "masked_top2_mutual": ("orb_slam2_tpu_torch/csrc/hamming_top2.cu",
                           "orb_slam2_tpu/matching/pallas_hamming.py:187"),
    "masked_top2_epi": ("orb_slam2_tpu_torch/csrc/hamming_top2.cu",
                        "orb_slam2_tpu/matching/pallas_hamming.py:307"),
    "hamming_top2": ("orb_slam2_tpu_torch/csrc/hamming_top2.cu",
                     "orb_slam2_tpu/matching/pallas_hamming.py:47"),
}


def repeat_loop(device, cfg) -> int:
    """--repeat-b: path B four times in one process, twice as the port
    runs it and twice under torch.use_deterministic_algorithms; says
    where each pair of runs first parts."""
    import torch
    trails, failed = [], 0
    for det in (False, False, True, True):
        torch.use_deterministic_algorithms(det, warn_only=True)
        log(f"B repeat {len(trails)}: deterministic algorithms {det}")
        trails.append([])
        try:
            phase_loop(device, cfg, trails[-1])
        except SmokeFailure as e:
            failed += 1
            log(f"B repeat {len(trails) - 1}: FAIL: {e}")
    torch.use_deterministic_algorithms(False)
    for a, b in ((0, 1), (2, 3)):
        ta, tb = trails[a], trails[b]
        part = next((k for k, (x, y) in enumerate(zip(ta, tb)) if x != y),
                    None)
        if part is None and len(ta) == len(tb):
            log(f"B repeats {a} and {b}: all {len(ta)} stage digests equal")
            continue
        k = min(len(ta), len(tb)) if part is None else part
        last = ta[k - 1][:2] if k else None
        log(f"B repeats {a} and {b} part at stage digest {k} of "
            f"{len(ta)}/{len(tb)}: {ta[k][:2] if k < len(ta) else None} "
            f"against {tb[k][:2] if k < len(tb) else None}; equal up to "
            f"{last}")
    return 1 if failed else 0


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="run only path A, with torch.profiler over "
                         "frames PROFILE_FROM.. (device busy share, "
                         "each thread's waits for the card)")
    ap.add_argument("--repeat-b", action="store_true",
                    help="run only path B, four times (see repeat_loop)")
    args = ap.parse_args()
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
    if args.repeat_b:
        return repeat_loop(device, cfg)
    if args.profile:
        try:
            phase_bench(device, world, cfg, profile=True)
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
            return 1
        return 0
    try:
        timing = phase_kernels(device, world, cfg)
        launches = phase_bench(device, world, cfg)
        from orb_slam2_tpu_torch.matching import hamming_top2 as ht
        k4_ref = ht.hamming_top2_plain(*k4_problem(4096, 4096, 0.2, 4,
                                                   device))
        launches["hamming_top2"] = phase_k4(device, k4_ref)["hamming_top2"]
        phase_loop(device, cfg)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    rows = []
    for name, (source, replaces) in KERNEL_META.items():
        t = timing[name]
        # no single PyTorch call computes any of the four functions
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=launches[name],
                         max_abs_err=t["max_abs_err"], ms=t["ms"],
                         plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                         bound_by=t["bound_by"], library_ms=None,
                         shape=t["shape"]))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
