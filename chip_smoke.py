#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``orb_slam2_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing falls back to the CPU):
  1. device: the card's name and power limit; build the hand-written
     CUDA kernels (csrc/*.cu) and print nvcc's register/smem report;
  2. kernels: each kernel (K1-K4) against its plain PyTorch version on
     the card at main-path shapes (K1 as one launch for a frame's 8
     levels, and on an adversarial image; K2 at both of its shapes; K4
     also with no valid column and past 4096 columns), bit-exact, with
     CUDA-event times of both and the least time the card could take
     (``bound_ms``);
  3. path A, bench.py's configuration: ``System(cfg,
     enable_loop_closing=True, async_mapping=True)`` with
     ``pipelined_tracking`` at depth 3 tracks a 40-frame 1920x1440 aerial
     sweep with 4000 ORB features on 8 levels through
     ``track_monocular_with_pose(..., next_image=)`` after a
     ``prefetch`` of the first frame, and ends with ``flush_tracking``,
     while local mapping and loop detection run on the mapping thread;
     no synchronization per frame.  Checks tracking, that nothing is left
     in flight, map quality, the vocabulary and BoW database, that K1-K3
     launched and K1 once a frame plus once per prefetch that was
     discarded; prints fps as bench.py measures it, the searches'
     launches by shape and the synchronizations of one extraction;
  4. path A-seq: path A with ``pipelined_tracking=False``, for its fps
     and frame times beside path A's on the same card;
  5. path C: K4 through its entry point ``hamming_top2`` at 4096x4096
     with 20% of the columns invalid;
  6. path B, a loop that closes at full width: a drifted circuit with
     sequential mapping must run DetectLoop -> Sim3 -> correction ->
     essential graph -> global BA and lower the keyframe ATE below the
     drifted priors'; prints the loop-closing stage times;
  7. path D, estimated-pose mode at full width: path A's world and a
     50-frame sweep through ``track_monocular`` with no pose (the H/F
     two-view bootstrap, the motion model, pose-optimizing local BA,
     sequential mapping with loop detection): initialized within 10
     frames, 0.8 of the frames after it OK, the Sim3-aligned ATE of the
     camera centers under 1% of the distance flown; then a noise frame
     must go LOST and a mapped frame's image relocalize through EPnP to
     within 1% of the distance flown and 1 degree of the pose tracked
     for it;
  8. path E, the command line at full width: a shenzhen-layout dataset
     (24 frames of path A's world as 8-bit .npy, a UE4 pose list, an
     OpenCV settings YAML, a binary ORBvoc of the shipped vocabulary's
     shape k=10 L=6, a launch TOML) run through ``cli.main(["run", ...])``
     with loop closing on: the printed JSON, every frame after
     initialization OK, K1 once a frame, map.ply on the ground plane
     through the revert transform, each tracked PLY's pose (the prior
     @ inv(revert)) and points (against their uv); then ``save_map``,
     ``load_map`` into a fresh System, a relocalization on a sequence
     frame's image, and localization mode adding no keyframe.
Path A also holds a warm extraction to no host synchronization, and
path D prints the model (H or F) of its two-view bootstrap, which must
be H on the planar world.
The kernel launch counts are read per path, each path driven with the
counts set to 0 just before it.  The last three lines are a JSON object
describing the kernels, the card's name and power limit, and
``{"ok": true, "device": {...}}``.

Four diagnostics print no such lines: ``--profile`` runs path A alone
(pipelined) with torch.profiler over a window of frames, ``--repeat-a``
runs paths A-seq, A, A, A-seq one after another for the spread of their
fps and frame times, ``--repeat-b`` runs path B four times and says
where the runs part, and ``--kernels-from DIR``
runs phases 1 and 2 alone with the port imported from DIR.  To compare
two commits on one card, unpack the other one (``git archive``) into a
git-ignored directory and run, one after another on the same card,
``--kernels-from`` that directory, this checkout, this checkout and that
directory again.
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
PIPELINE_DEPTH = 3      # bench.py's default BENCH_PIPELINE_DEPTH
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
# path D: estimated-pose mode over path A's world.  50 frames leave at
# least 6 keyframes (a loss then does not reset the map), which 40 may
# not; the bars are tests/test_pipeline.py's TestEstimatedMode scaled
D_FRAMES = 50
D_INIT_BY = 10          # frames by which the two-view bootstrap succeeds
D_MIN_OK = 0.8          # share of the frames after it tracked OK
D_ATE_SHARE = 0.01      # ATE bar, share of the distance flown
D_MIN_KEYFRAMES = 6     # a loss with <= 5 keyframes resets the map
D_RELOC_DEG = 1.0       # relocalized pose against the tracked one
# path E: the command line on a shenzhen-layout dataset of path A's
# world; a sequence frame relocalized on the saved and loaded map, then
# E_LOC_FRAMES frames in localization mode
E_FRAMES = 24
E_VOCAB_LEVELS = 6      # the shipped ORBvoc's depth (k=10: 1M words)
E_RELOC_FRAME = 12
E_LOC_FRAMES = 4

# H100 SXM peaks (NVIDIA data sheet, dense): int8 tensor cores and
# device memory.  A Hamming distance of two 256-bit descriptors is
# (256 - x.y) / 2 for their +-1 vectors x, y; that 256-term product is
# exact in int8 with int32 accumulation, so int8 is the fastest type
# that computes it exactly and its rate bounds the Hamming searches.
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12
# K1's arithmetic is bf16 (it rounds the input and its two folded
# differences to bf16; min and max are exact).  Outside the tensor cores
# the H100 does packed bf16x2 subtracts, mins and maxes at 256 results a
# clock per SM: NVIDIA's H100 whitepaper gives 133.8 TFLOP/s of
# non-tensor bf16, counting a fused multiply-add as two, so 67 T simple
# operations/s.
PEAK_BF16_SIMT = 67e12


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


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` on the card with no host in
    the way: ``reps`` calls captured in one CUDA graph, replayed
    ``replays`` times between CUDA events.  ``cuda_ms`` of a call whose
    Python wrapper takes longer than its kernels measures the host."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


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
    """Each kernel against its plain version, bit-exact, with times:
    ``ms`` is the device's time per call with the calls captured in a
    CUDA graph (graph_ms), ``loop_ms`` the time per call of a loop of
    wrapper calls (cuda_ms, which a fast kernel's host wrapper can
    set), ``plain_ms`` the plain version's (cuda_ms).  Returns one
    entry per (kernel, shape)."""
    import torch
    from orb_slam2_tpu_torch import kernels
    from orb_slam2_tpu_torch.matching import hamming_top2 as ht
    from orb_slam2_tpu_torch.ops import fast, pyramid
    from orb_slam2_tpu_torch.utils import synth
    results = []

    # K1 on all 8 levels of a rendered 1920x1440 frame, in one launch
    # (a checkout from before score_maps launches once per level)
    _, poses = bench_world(device)
    img = synth.render(world, cfg.cam, poses[0]).float()
    levels = pyramid.build_pyramid(img, cfg.orb.n_levels,
                                   cfg.orb.scale_factor)
    one_launch = hasattr(fast, "score_maps")
    if one_launch:
        frame = lambda: fast.score_maps(levels)  # noqa: E731
    else:
        frame = lambda: [fast.fast_score(lvl) for lvl in levels]  # noqa: E731
    n0 = kernels.LAUNCHES["fast_score"]
    scores = frame()
    torch.cuda.synchronize()
    n_launch = kernels.LAUNCHES["fast_score"] - n0
    check(n_launch == (1 if one_launch else len(levels)),
          f"K1 took {n_launch} launches for a frame's {len(levels)} levels")
    # 255 beside values below 2^-10, where fl32(r - p) itself rounds
    rng = np.random.default_rng(11)
    adv = rng.integers(0, 256, tuple(img.shape)).astype(np.float32)
    adv[rng.random(adv.shape) < 0.4] = 255.0
    tiny = rng.random(adv.shape) < 0.3
    adv[tiny] = rng.uniform(2.0 ** -24, 2.0 ** -10, int(tiny.sum()))
    adv = torch.as_tensor(adv, device=device)
    err = 0.0
    for what, lvl, k in [*zip(range(len(levels)), levels, scores),
                         ("adversarial", adv, fast.fast_score(adv))]:
        p = fast.fast_score_map(lvl)
        torch.cuda.synchronize()
        ki, pi = k[3:-3, 3:-3], p[3:-3, 3:-3]
        check(torch.equal(ki, pi),
              f"K1 differs from fast_score_map on the interior of "
              f"{what} {tuple(lvl.shape)}: max |diff| "
              f"{(ki - pi).abs().max().item()}")
        err = max(err, (ki - pi).abs().max().item())
    ms, loop_ms = graph_ms(frame), cuda_ms(frame)
    plain_ms = cuda_ms(lambda: [fast.fast_score_map(lvl) for lvl in levels])
    # per pixel: read 4 B, write 4 B; the fewest bf16 operations of the
    # folded form: arc extremes A and B at 42 two-input reductions for
    # the 16 runs of 9 and 15 to combine them each (van Herk / Gil-Werman
    # over the circular 16-axis), 2 differences, 2 roundings and 1 max:
    # 2 x 57 + 5 = 119 (15.2 us at PEAK_BF16_SIMT, under the 20.4 us the
    # bytes take, so bound by bytes)
    pixels = sum(int(lvl.numel()) for lvl in levels)
    results.append(dict(
        name="fast_score", max_abs_err=err, ms=ms, loop_ms=loop_ms,
        plain_ms=plain_ms,
        shape=f"8 levels of 1920x1440 ({n_launch} launches)",
        **bound(8 * pixels, 119 * pixels, PEAK_BF16_SIMT)))
    log(f"K1 fast_score: interior bit-exact on 8 levels and on a "
        f"{tuple(adv.shape)} adversarial image; {ms:.4f} ms per frame of "
        f"{n_launch} launch(es) (loop of wrapper calls {loop_ms:.4f} ms; "
        f"plain {plain_ms:.4f} ms)")

    # K2 at the last-frame (4096x4096) and local-map (16384x4096)
    # shapes, K3 at the triangulation shape (4096x4096)
    for name, n_rows, seed, near in (("masked_top2_mutual", 4096, 1, 100),
                                     ("masked_top2_mutual", 16384, 2, 100),
                                     ("masked_top2_epi", 4096, 3, 50)):
        epi = name == "masked_top2_epi"
        what = "K3" if epi else "K2"
        args = search_problem(n_rows, 4096, epi, seed, device)
        kern = getattr(ht, name)
        plain = getattr(ht, f"{name}_plain")
        k = kern(*args)
        p = plain(*args)
        torch.cuda.synchronize()
        for a, b, key in zip(k, p, ("best", "second", "column")):
            check(torch.equal(a, b),
                  f"{what} {key} keys differ at {n_rows}x4096 "
                  f"({(a != b).sum().item()} entries)")
        n_match = int((k[0] // ht.COL_STRIDE <= near).sum())
        check(n_match > 0, f"{what} test problem admits no match")
        ms = graph_ms(lambda: kern(*args))
        loop_ms = cuda_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args), reps=5)
        log(f"{what} {name} {n_rows}x4096: keys bit-exact ({n_match} rows "
            f"matched); {ms:.4f} ms (loop of wrapper calls {loop_ms:.4f} "
            f"ms; plain {plain_ms:.4f} ms)")
        row_bytes = 32 + (16 if epi else 24) + 8
        results.append(dict(
            name=name, max_abs_err=0.0, ms=ms, loop_ms=loop_ms,
            plain_ms=plain_ms, shape=f"{n_rows}x4096",
            **bound(n_rows * row_bytes + 4096 * (32 + 16 + 4),
                    2 * n_rows * 4096 * 256, PEAK_INT8)))

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
    wide = k4_problem(128, 8192, 0.2, 6, device)
    kw, pw = ht.hamming_top2(*wide), ht.hamming_top2_plain(*wide)
    torch.cuda.synchronize()
    for a, b, what in zip(kw, pw, ("best", "best_idx", "second")):
        check(torch.equal(a, b), f"K4 {what} differs at 128x8192 "
              f"({(a != b).sum().item()} rows)")
    ms = graph_ms(lambda: ht.hamming_top2(*args))
    loop_ms = cuda_ms(lambda: ht.hamming_top2(*args))
    plain_ms = cuda_ms(lambda: ht.hamming_top2_plain(*args), reps=5)
    log(f"K4 hamming_top2 4096x4096 (20% columns invalid): bit-exact "
        f"({n_match} rows within 64 bits), all-invalid 512x4096 block and "
        f"128x8192 bit-exact; {ms:.4f} ms (loop of wrapper calls "
        f"{loop_ms:.4f} ms; plain {plain_ms:.4f} ms)")
    results.append(dict(
        name="hamming_top2", max_abs_err=0.0, ms=ms, loop_ms=loop_ms,
        plain_ms=plain_ms, shape="4096x4096",
        **bound(4096 * (32 + 12) + 4096 * (32 + 1),
                2 * 4096 * 4096 * 256, PEAK_INT8)))
    for r in results:
        log(f"bound {r['name']} {r['shape']}: {r['bound_ms'] * 1e3:.2f} us "
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


def extraction_syncs(system, image) -> list:
    """The host synchronizations of one extraction on the card, by
    torch.cuda.set_sync_debug_mode("warn"): (file:line, count) of the
    warnings, most frequent first.  A synchronizing extraction returns
    from ``factory.start`` only when its work is done, so a prefetch
    cannot overlap it."""
    import collections
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            system.factory.start(image)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    sites = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return sites.most_common()


def phase_bench(device, world, cfg, pipelined: bool = True,
                profile: bool = False) -> dict:
    """Path A (``pipelined``): bench.py's configuration,
    System(enable_loop_closing=True, async_mapping=True) with
    ``pipelined_tracking`` at depth PIPELINE_DEPTH, driven as bench.py
    drives it: ``prefetch`` of the first frame, ``next_image`` with each
    call, ``flush_tracking`` at the end; no synchronization per frame.
    Path A-seq: the same calls with ``pipelined_tracking=False``.  fps
    as bench.py measures it: the frames from the first after
    initialization over the time from the start of its call to the
    return of ``flush_tracking``.  Frame times are each call's on the
    host clock.  The tracker's time per frame is split by the main
    thread's CPU clock: what it did not run on a CPU it spent blocked,
    on the map lock (measured) or on the interpreter lock (the rest;
    CUDA spins while it synchronizes when the process holds fewer
    contexts than the host has cores, so synchronizations count as run
    time).  ``profile`` records the card over frames PROFILE_FROM..
    with torch.profiler and reads the device's busy share and each
    thread's waits for the card."""
    import dataclasses
    import torch
    from orb_slam2_tpu_torch import kernels
    from orb_slam2_tpu_torch.pipeline.system import System
    from orb_slam2_tpu_torch.pipeline.tracking import TrackState
    from orb_slam2_tpu_torch.utils import synth
    name = "A" if pipelined else "A-seq"
    cfg = dataclasses.replace(cfg, pipelined_tracking=pipelined,
                              pipeline_depth=PIPELINE_DEPTH)
    _, poses = bench_world(device)
    # the frames are rendered on the card before the timed loop, as
    # bench.py stages its sequence
    frames = [synth.render(world, cfg.cam, T) for T in poses]
    torch.cuda.synchronize()
    system = System(cfg, enable_loop_closing=True, async_mapping=True,
                    device=device)
    if pipelined and not profile:
        cold = extraction_syncs(system, frames[0])
        sites = extraction_syncs(system, frames[1])
        n_sync = sum(n for _, n in sites)
        log(f"{name}: one warm extraction synchronizes with the host "
            f"{n_sync} times (torch.cuda.set_sync_debug_mode): {sites}; "
            f"the first one {sum(n for _, n in cold)} times: {cold}")
        check(n_sync == 0, f"{name}: a warm extraction synchronizes "
              f"{n_sync} times: {sites}")
    clock = LockWaitClock(system.store.lock)
    system.store.lock = clock
    # a prefetch made for the other feature budget (init_mode) is
    # extracted again: one more K1 launch, allowed and printed
    discarded = []
    make = system.factory.make

    def make_counted(image, timestamp=0.0, Tcw=None, init_mode=False,
                     started=None):
        if started is not None and started[2] != init_mode:
            discarded.append(timestamp)
            log(f"{name}: the prefetched extraction at t={timestamp:.1f} "
                f"was made with init_mode={started[2]}; extracted again")
        return make(image, timestamp, Tcw=Tcw, init_mode=init_mode,
                    started=started)
    system.factory.make = make_counted
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    states, starts, frame_ms, cpu_ms, lock_ms = [], [], [], [], []
    prof = None
    system.prefetch(frames[0])
    for i, T in enumerate(poses):
        if profile and i == PROFILE_FROM:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        nxt = frames[i + 1] if i + 1 < len(frames) else None
        t0, c0, w0 = time.perf_counter(), time.thread_time(), clock.wait_s
        system.track_monocular_with_pose(frames[i], i * 0.1, T,
                                         next_image=nxt)
        starts.append(t0)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        cpu_ms.append((time.thread_time() - c0) * 1e3)
        lock_ms.append((clock.wait_s - w0) * 1e3)
        states.append(system.state)
        log(f"{name} frame {i:2d}: {system.state.name:15s} "
            f"inliers={system.tracker.matches_inliers:5d} "
            f"kfs={system.store.n_valid_keyframes():3d} "
            f"points={system.store.n_valid_points():6d} "
            f"{frame_ms[-1]:9.1f} ms")
    system.flush_tracking()
    t_end = time.perf_counter()
    check(not system.tracker._pending,
          f"{name}: {len(system.tracker._pending)} steps in flight after "
          f"flush_tracking")
    check(system.state == TrackState.OK,
          f"{name}: the last frame is {system.state.name} after the flush")
    track_s = sum(frame_ms) / 1e3
    window = None
    if prof is not None:
        torch.cuda.synchronize()
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
    check(bool(ok_idx), f"{name}: the map never initialized")
    first = ok_idx[0]
    check(all(s == TrackState.OK for s in states[first:]),
          f"{name}: a frame after initialization (frame {first}) is not "
          f"OK: {[s.name for s in states]}")
    n_kf = system.store.n_valid_keyframes()
    check(n_kf >= MIN_KEYFRAMES, f"{name}: only {n_kf} keyframes")
    pts = system.map_points()
    check(len(pts) > 0 and bool(np.isfinite(pts).all()),
          f"{name}: map points missing or not finite")
    med_z = float(np.median(np.abs(pts[:, 2])))
    check(med_z < MEDIAN_Z_BAR,
          f"{name}: map points off the plane: median |z| {med_z:.4f} >= "
          f"{MEDIAN_Z_BAR}")
    pr = system.place_rec
    check(pr.ready, f"{name}: the vocabulary was never trained")
    check(pr.db is not None and len(pr.db.bow) > 0,
          f"{name}: the BoW keyframe database is empty")
    for k in ("fast_score", "masked_top2_mutual", "masked_top2_epi"):
        check(launches[k] > 0, f"{name}: kernel {k} never launched")
    check(launches["fast_score"] == N_FRAMES + len(discarded),
          f"{name}: K1 launched {launches['fast_score']} times over "
          f"{N_FRAMES} frames and {len(discarded)} discarded prefetches")
    shapes = {f"{k[0]} {k[1]}x{k[2]}": v
              for k, v in sorted(kernels.SHAPES.items())}
    steady = frame_ms[first + 1:]
    fps = (N_FRAMES - first - 1) / (t_end - starts[first + 1])
    log(f"{name}: {len(ok_idx)}/{N_FRAMES} frames OK (initialized at "
        f"frame {first}), {n_kf} keyframes, {len(pts)} map points, median "
        f"|z| {med_z:.4f}, {len(pr.db.bow)} keyframes in the BoW database, "
        f"{len(discarded)} prefetched extractions discarded")
    log(f"{name}: {fps:.2f} fps over frames {first + 1}-{N_FRAMES - 1} "
        f"(to the return of flush_tracking); frame time with the mapping "
        f"thread live: median {np.median(steady):.1f} ms, mean "
        f"{np.mean(steady):.1f} ms, max {np.max(steady):.1f} ms (host "
        f"clock per call, no synchronization); the tracker waited "
        f"{clock.wait_s * 1e3:.1f} ms of its {track_s * 1e3:.1f} ms on the "
        f"map lock; final mapping flush {flush_s * 1e3:.1f} ms; peak device "
        f"memory {peak / 2 ** 20:.0f} MiB")
    wall, cpu, lck = (sum(x[first + 1:]) for x in (frame_ms, cpu_ms,
                                                     lock_ms))
    log(f"{name}: the tracker's {wall:.1f} ms over frames {first + 1}-"
        f"{N_FRAMES - 1}: {cpu:.1f} ms running on a CPU, {lck:.1f} ms on "
        f"the map lock, {wall - cpu - lck:.1f} ms blocked otherwise (the "
        f"interpreter lock) (main thread's CPU clock)")
    if window is not None:
        w_wall = sum(frame_ms[PROFILE_FROM:])
        w_cpu = sum(cpu_ms[PROFILE_FROM:])
        w_lck = sum(lock_ms[PROFILE_FROM:])
        tr = window["threads"].get("tracker", {})
        log(f"{name} profile, frames {PROFILE_FROM}-{N_FRAMES - 1} "
            f"(torch.profiler, CUDA activity): {w_wall:.1f} ms of tracker "
            f"wall time; the card busy {window['busy_ms']:.1f} ms "
            f"({window['busy_ms'] / w_wall:.3f} of it, "
            f"{window['n_device_spans']} kernels and copies); the tracker "
            f"ran {w_cpu:.1f} ms on a CPU, waited {tr.get('sync_ms', 0):.1f}"
            f" ms in CUDA synchronizations and {tr.get('copy_ms', 0):.1f} "
            f"ms in copies, {w_lck:.1f} ms on the map lock, and was "
            f"{w_wall - w_cpu - w_lck:.1f} ms blocked otherwise")
        for who, d in sorted(window["threads"].items()):
            log(f"{name} profile, {who}: {d['launches']} launches taking "
                f"{d['launch_ms']:.1f} ms, {d['sync_ms']:.1f} ms in "
                f"synchronizations, {d['copy_ms']:.1f} ms in copies")
    log(f"{name}: kernel launches {json.dumps(launches)}")
    log(f"{name}: search launches by rows x columns {json.dumps(shapes)}")
    log(f"{name}: timing report:\n" + system.timing_report())
    return dict(launches=launches, fps=fps, median_ms=float(
        np.median(steady)), max_ms=float(np.max(steady)), keyframes=n_kf,
        tracker_cpu_ms=cpu, tracker_ms=wall)


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


def rotation_deg(Ta, Tb) -> float:
    """The angle between the rotations of two poses, in degrees."""
    c = (np.trace(Ta[:3, :3] @ Tb[:3, :3].T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def centers(poses) -> np.ndarray:
    """Camera centers (N, 3) of poses Tcw."""
    return np.stack([-T[:3, :3].T @ T[:3, 3] for T in poses])


def phase_estimated(device, world, cfg):
    """Path D: estimated-pose mode at full width.  Path A's world, a
    D_FRAMES sweep, ``pose_prior=False``, System(enable_loop_closing=True,
    async_mapping=False), ``track_monocular(image, t)`` with no pose: the
    H/F two-view bootstrap (a planar world: H), the motion model,
    pose-optimizing local BA.  Then an EPnP relocalization: a noise frame
    goes LOST, and a mapped keyframe's image, shown again with no pose,
    must relocalize to the pose tracked for it."""
    import dataclasses
    import torch
    from orb_slam2_tpu_torch import kernels
    from orb_slam2_tpu_torch.pipeline.system import System
    from orb_slam2_tpu_torch.pipeline.tracking import TrackState
    from orb_slam2_tpu_torch.utils import synth
    from orb_slam2_tpu_torch.utils.evaluate import ate_rmse
    dcfg = dataclasses.replace(cfg, pose_prior=False)
    poses = synth.aerial_trajectory(D_FRAMES, height=FLIGHT_HEIGHT,
                                    speed=0.5)
    frames = [synth.render(world, cfg.cam, T) for T in poses]
    torch.cuda.synchronize()
    system = System(dcfg, enable_loop_closing=True, async_mapping=False,
                    device=device)
    kernels.reset_launch_counts()
    states, frame_ms = [], []
    for i, img in enumerate(frames):
        t0 = time.perf_counter()
        system.track_monocular(img, i * 0.1)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        states.append(system.state)
        log(f"D frame {i:2d}: {system.state.name:15s} "
            f"inliers={system.tracker.matches_inliers:5d} "
            f"kfs={system.store.n_valid_keyframes():3d} "
            f"{frame_ms[-1]:9.1f} ms")
    launches = dict(kernels.LAUNCHES)
    ok_idx = [i for i, s in enumerate(states) if s == TrackState.OK]
    check(bool(ok_idx) and ok_idx[0] < D_INIT_BY,
          f"D: not initialized within {D_INIT_BY} frames: "
          f"{[s.name for s in states]}")
    first = ok_idx[0]
    ok_share = (len(ok_idx) - 1) / (D_FRAMES - first - 1)
    check(ok_share >= D_MIN_OK, f"D: only {ok_share:.3f} of the frames "
          f"after initialization OK")
    est = centers([system.trajectory[i][2] for i in ok_idx])
    gt = centers([poses[i] for i in ok_idx])
    flown = float(np.linalg.norm(np.diff(centers(poses), axis=0),
                                 axis=1).sum())
    ate = ate_rmse(est, gt, align="sim3")
    check(bool(np.isfinite(est).all()), "D: a tracked pose is not finite")
    check(ate < D_ATE_SHARE * flown, f"D: ATE {ate:.4f} over "
          f"{D_ATE_SHARE} of the {flown:.2f} units flown")
    for k in ("fast_score", "masked_top2_mutual", "masked_top2_epi"):
        check(launches[k] > 0, f"D: kernel {k} never launched")
    n_kf = system.store.n_valid_keyframes()
    check(n_kf >= D_MIN_KEYFRAMES, f"D: only {n_kf} keyframes after "
          f"{D_FRAMES} frames (a loss would reset the map)")
    model = {True: "H", False: "F", None: "none"}[
        system.tracker.init_used_homography]
    log(f"D: the two-view bootstrap took model {model} (homography on a "
        f"planar world)")
    check(model == "H", f"D: the bootstrap took model {model}, not H, on "
          f"a planar world")
    steady = frame_ms[first + 1:]
    log(f"D: initialized at frame {first} (two-view, "
        f"{len(ok_idx)}/{D_FRAMES} frames OK, {ok_share:.3f} after it), "
        f"{n_kf} keyframes, {system.store.n_valid_points()} map points; "
        f"Sim3-aligned ATE of the camera centers {ate:.4f} over "
        f"{flown:.2f} units flown ({ate / flown:.5f} of it); frame time "
        f"median {np.median(steady):.1f} ms, max {np.max(steady):.1f} ms "
        f"(host clock per call)")
    log(f"D: kernel launches {json.dumps(launches)}")

    # EPnP relocalization: a noise frame, then a mapped keyframe's image
    rng = np.random.default_rng(0)
    noise = torch.as_tensor(rng.uniform(0, 255, (cfg.cam.height,
                                                 cfg.cam.width))
                            .astype(np.float32), device=device)
    system.track_monocular(noise, D_FRAMES * 0.1)
    check(system.state == TrackState.LOST,
          f"D: the noise frame is {system.state.name}, not LOST")
    check(system.store.n_valid_keyframes() >= D_MIN_KEYFRAMES,
          "D: the loss reset the map")
    j = max(kf.frame.frame_id for kf in system.store.kfs if kf.valid)
    est_flown = float(np.linalg.norm(np.diff(est, axis=0), axis=1).sum())
    t0 = time.perf_counter()
    frame = system.track_monocular(frames[j], (D_FRAMES + 1) * 0.1)
    reloc_ms = (time.perf_counter() - t0) * 1e3
    check(system.state == TrackState.OK
          and system.tracker.last_reloc_frame_id == frame.frame_id,
          f"D: frame {j}'s image shown again did not relocalize "
          f"({system.state.name})")
    T_tracked = system.trajectory[j][2]
    dc = float(np.linalg.norm(centers([frame.Tcw])[0]
                              - centers([T_tracked])[0]))
    deg = rotation_deg(frame.Tcw, T_tracked)
    log(f"D: relocalized the image of keyframe frame {j} in {reloc_ms:.1f} "
        f"ms with {system.tracker.matches_inliers} inliers: center "
        f"{dc:.5f} from the tracked one ({dc / est_flown:.5f} of the "
        f"{est_flown:.3f} map units flown), rotation {deg:.4f} deg")
    check(dc < 0.01 * est_flown and deg < D_RELOC_DEG,
          f"D: relocalized pose {dc:.4f} units / {deg:.3f} deg from the "
          f"tracked one")
    system.shutdown()
    return launches


def read_tracked_ply(path: str):
    """A tracked-frame PLY (utils/ply.write_tracked_frame): the vertices
    as a structured array and the frame element (id, Tcw (4, 4), K)."""
    with open(path, "rb") as f:
        data = f.read()
    head, _, body = data.partition(b"end_header\n")
    lines = head.decode().splitlines()
    check("element frame 1" in lines, f"{path}: no frame element")
    n = int(next(ln for ln in lines if ln.startswith("element vertex"))
            .split()[-1])
    vdt = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3), ("uv", "<f4", 2),
                    ("octave", "<i4")])
    check(len(body) == n * vdt.itemsize + 4 + 25 * 4,
          f"{path}: {len(body)} bytes after the header for {n} vertices")
    verts = np.frombuffer(body[:n * vdt.itemsize], vdt)
    fid = int(np.frombuffer(body[n * vdt.itemsize:][:4], "<i4")[0])
    vals = np.frombuffer(body[n * vdt.itemsize + 4:], "<f4")
    return verts, fid, vals[:16].reshape(4, 4), vals[16:].reshape(3, 3)


def write_shenzhen_dataset(root: str, device, cfg) -> dict:
    """Path E's dataset in the reference fork's layout (mono_shenzhen):
    E_FRAMES 8-bit frames of bench.py's world rendered on the card and
    saved as .npy, their image list, a UE4 pose list, an OpenCV settings
    YAML with bench's intrinsics and ORB parameters, a binary ORBvoc of
    the shipped vocabulary's shape (k=10, L=6) and the launch TOML that
    names them."""
    import torch
    from orb_slam2_tpu_torch.io.orbvoc import (save_orbvoc_binary,
                                               synthetic_orbvoc)
    from orb_slam2_tpu_torch.io.poses import save_ue4_camera_poses
    from orb_slam2_tpu_torch.utils import synth
    world, _ = bench_world(device)
    poses = synth.aerial_trajectory(E_FRAMES, height=FLIGHT_HEIGHT,
                                    speed=0.5)
    os.makedirs(os.path.join(root, "images"))
    paths = []
    for i, T in enumerate(poses):
        img = synth.render(world, cfg.cam, T).round().clamp(0, 255)
        paths.append(os.path.join(root, "images", f"{i:06d}.npy"))
        np.save(paths[-1], img.to(torch.uint8).cpu().numpy())
    with open(os.path.join(root, "images.txt"), "w") as f:
        f.write("\n".join(paths) + "\n")
    save_ue4_camera_poses(os.path.join(root, "cameras.txt"), poses)
    cam, orb = cfg.cam, cfg.orb
    with open(os.path.join(root, "settings.yaml"), "w") as f:
        f.write(f"%YAML:1.0\nCamera.fx: {cam.fx}\nCamera.fy: {cam.fy}\n"
                f"Camera.cx: {cam.cx}\nCamera.cy: {cam.cy}\n"
                f"Camera.width: {cam.width}\nCamera.height: {cam.height}\n"
                f"Camera.fps: {cfg.fps}\n"
                f"ORBextractor.nFeatures: {orb.n_features}\n"
                f"ORBextractor.scaleFactor: {orb.scale_factor}\n"
                f"ORBextractor.nLevels: {orb.n_levels}\n")
    t0 = time.perf_counter()
    save_orbvoc_binary(synthetic_orbvoc(k=10, L=E_VOCAB_LEVELS, seed=0),
                       os.path.join(root, "ORBvoc.bin"))
    gen_s = time.perf_counter() - t0
    with open(os.path.join(root, "launch.toml"), "w") as f:
        f.write(f'FBoWVocabularyPath = "{root}/ORBvoc.bin"\n'
                f'ImagesCollectionPath = "{root}/images.txt"\n'
                f'CameraPoseCollectionPath = "{root}/cameras.txt"\n'
                f'ORBSLAMConfigPath = "{root}/settings.yaml"\n')
    return dict(poses=poses, vocab_gen_s=gen_s, launch=os.path.join(
        root, "launch.toml"))


def phase_cli(device, cfg, smi: str) -> dict:
    """Path E: ``python -m orb_slam2_tpu_torch.cli run launch.toml`` at
    full width, called in this process as ``cli.main``, loop closing on,
    on a shenzhen-layout dataset (write_shenzhen_dataset).  Checks the
    printed JSON, every frame after initialization OK, the map PLY on
    the world's ground plane through the revert transform, each tracked
    PLY's frame element (Tcw = loaded prior @ inv(revert)) and its
    camera-space points against their uv; then ``save_map`` and
    ``load_map`` into a fresh System, which must relocalize on a
    sequence frame's image, and localization mode, which must add no
    keyframe over E_LOC_FRAMES more frames."""
    import contextlib
    import io as io_mod
    import tempfile
    import torch
    from orb_slam2_tpu_torch import cli, kernels
    from orb_slam2_tpu_torch.io import load_settings_yaml
    from orb_slam2_tpu_torch.io.poses import load_ue4_camera_poses
    from orb_slam2_tpu_torch.pipeline.system import System
    from orb_slam2_tpu_torch.pipeline.tracking import TrackState
    from orb_slam2_tpu_torch.utils import ply
    with tempfile.TemporaryDirectory() as root:
        ds = write_shenzhen_dataset(root, device, cfg)
        t0 = time.perf_counter()
        vocab = cli._load_vocabulary(os.path.join(root, "ORBvoc.bin"))
        load_s = time.perf_counter() - t0
        log(f"E: ORBvoc k={vocab.k} L={vocab.levels} ({vocab.n_words} "
            f"words, {os.path.getsize(os.path.join(root, 'ORBvoc.bin'))} "
            f"bytes) generated and written in {ds['vocab_gen_s']:.2f} s, "
            f"loaded in {load_s:.2f} s")
        # the CLI's System, kept when the command shuts it down
        systems = []
        shutdown = System.shutdown

        def keep(self):
            systems.append(self)
            shutdown(self)
        out = os.path.join(root, "Out")
        stdout = io_mod.StringIO()
        System.shutdown = keep
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        try:
            with contextlib.redirect_stdout(stdout):
                rc = cli.main(["run", ds["launch"], "--out", out,
                               "--device", str(device)])
        finally:
            System.shutdown = shutdown
        launches = dict(kernels.LAUNCHES)
        text = stdout.getvalue().strip()
        check(rc == 0, f"E: cli run returned {rc}")
        res = json.loads(text.splitlines()[-1])
        log(f"E: cli run printed {json.dumps(res)}")
        check(res["frames"] == E_FRAMES, f"E: {res['frames']} frames")
        system = systems[0]
        states = [st for _, _, _, st in system.trajectory]
        ok_idx = [i for i, st in enumerate(states) if st == TrackState.OK]
        check(bool(ok_idx), "E: the map never initialized")
        first = ok_idx[0]
        check(ok_idx == list(range(first, E_FRAMES))
              and res["tracked_ok"] == E_FRAMES - first,
              f"E: frames after initialization (frame {first}) not all "
              f"OK: {[st.name for st in states]}")
        for k in ("fast_score", "masked_top2_mutual", "masked_top2_epi"):
            check(launches[k] > 0, f"E: kernel {k} never launched")
        check(launches["fast_score"] == E_FRAMES,
              f"E: K1 launched {launches['fast_score']} times over "
              f"{E_FRAMES} frames")

        # the map PLY, through the revert transform: the world's ground
        pts = ply.read_ply_points(os.path.join(out, "map.ply"))
        check(len(pts) > 0 and bool(np.isfinite(pts).all()),
              "E: map.ply points missing or not finite")
        med_z = float(np.median(np.abs(pts[:, 2])))
        check(med_z < MEDIAN_Z_BAR, f"E: map.ply off the ground plane: "
              f"median |z| {med_z:.4f} >= {MEDIAN_Z_BAR}")

        # the tracked PLYs
        priors, revert = load_ue4_camera_poses(
            os.path.join(root, "cameras.txt"))
        inv_rev = np.linalg.inv(revert)
        K = cfg.cam.K.astype(np.float64)
        names = sorted(n for n in os.listdir(out) if n.startswith("tracked_"))
        check(names == [f"tracked_{i:06d}.ply" for i in ok_idx],
              f"E: tracked PLYs {names[:3]}... for OK frames {ok_idx[:3]}...")
        pose_err, uv_err = 0.0, []
        for name in names:
            verts, fid, Tcw, Kf = read_tracked_ply(os.path.join(out, name))
            i = int(name[8:14])
            check(fid == i, f"E: {name} holds frame id {fid}")
            # Tcw @ inv(revert): the loaded prior's, and the world's pose
            pose_err = max(pose_err, float(np.abs(
                Tcw - priors[i] @ inv_rev).max()), float(np.abs(
                    Tcw - ds["poses"][i]).max()))
            check(np.allclose(Kf, K), f"E: {name} K {Kf.tolist()}")
            proj = verts["xyz"].astype(np.float64) @ K.T
            uv_err.append(np.linalg.norm(proj[:, :2] / proj[:, 2:]
                                         - verts["uv"], axis=1))
        uv_med = float(np.median(np.concatenate(uv_err)))
        check(pose_err < 1e-4, f"E: a tracked PLY's Tcw is {pose_err:.2e} "
              f"from the prior @ inv(revert) or the world's pose")
        check(uv_med < 1.0, f"E: tracked points project {uv_med:.3f} px "
              f"from their uv at the median")
        n_kf = system.store.n_valid_keyframes()
        n_mp = system.store.n_valid_points()
        flown = float(np.linalg.norm(np.diff(centers(ds["poses"]), axis=0),
                                     axis=1).sum())
        log(f"E: {len(ok_idx)}/{E_FRAMES} frames OK (initialized at frame "
            f"{first}), {n_kf} keyframes, {n_mp} map points, "
            f"{system.loop_closer.n_loops_closed} loops closed; cli fps "
            f"{res['fps']:.2f} (its own clock: frames over the time in "
            f"track_monocular_with_pose); map.ply {len(pts)} points, median"
            f" |z| {med_z:.4f}; {len(names)} tracked PLYs, Tcw within "
            f"{pose_err:.2e} of the prior @ inv(revert), points "
            f"{uv_med:.3f} px from their uv at the median")
        log(f"E: kernel launches {json.dumps(launches)} (K1 once a frame) "
            f"on {smi}")

        # save, load into a fresh System, relocalize, localization mode
        path = os.path.join(root, "map.npz")
        t0 = time.perf_counter()
        system.save_map(path)
        save_s = time.perf_counter() - t0
        scfg = load_settings_yaml(os.path.join(root, "settings.yaml"),
                                  pose_prior=True)
        fresh = System(scfg, enable_loop_closing=True, vocab=vocab,
                       device=device)
        fresh.set_real_transform(revert)
        t0 = time.perf_counter()
        fresh.load_map(path)
        load_map_s = time.perf_counter() - t0
        check(fresh.state == TrackState.LOST
              and fresh.store.n_valid_keyframes() == n_kf,
              f"E: the loaded map has {fresh.store.n_valid_keyframes()} "
              f"keyframes, state {fresh.state.name}")
        j = E_RELOC_FRAME
        img = np.load(os.path.join(root, "images", f"{j:06d}.npy"))
        t0 = time.perf_counter()
        frame = fresh.track_monocular_with_pose(img, 100.0, priors[j])
        reloc_ms = (time.perf_counter() - t0) * 1e3
        check(fresh.state == TrackState.OK
              and fresh.tracker.last_reloc_frame_id == frame.frame_id,
              f"E: frame {j}'s image did not relocalize on the loaded map "
              f"({fresh.state.name})")
        dc = float(np.linalg.norm(centers([frame.Tcw @ inv_rev])[0]
                                  - centers([ds["poses"][j]])[0]))
        check(dc < 0.01 * flown, f"E: relocalized center {dc:.4f} from the "
              f"true one, over 0.01 of the {flown:.2f} units flown")
        log(f"E: save_map {save_s:.2f} s, load_map {load_map_s:.2f} s; "
            f"frame {j}'s image relocalized on the loaded map in "
            f"{reloc_ms:.1f} ms with {fresh.tracker.matches_inliers} "
            f"inliers, center {dc:.2e} from the true one "
            f"({flown:.2f} units flown)")
        fresh.activate_localization_mode()
        n_pts = fresh.store.n_points()
        for k in range(1, E_LOC_FRAMES + 1):
            img = np.load(os.path.join(root, "images", f"{j + k:06d}.npy"))
            fresh.track_monocular_with_pose(img, 100.0 + 0.1 * k,
                                            priors[j + k])
            check(fresh.state == TrackState.OK,
                  f"E: localization mode lost frame {j + k}")
        check(fresh.store.n_valid_keyframes() == n_kf
              and fresh.store.n_points() == n_pts,
              f"E: localization mode added keyframes or points "
              f"({fresh.store.n_valid_keyframes()} keyframes, "
              f"{fresh.store.n_points()} points)")
        log(f"E: localization mode tracked frames {j + 1}-"
            f"{j + E_LOC_FRAMES} OK with no keyframe or point added")
        fresh.shutdown()
    return launches


KERNEL_META = {
    "fast_score": ("orb_slam2_tpu_torch/csrc/fast_score.cu",
                   "orb_slam2_tpu/ops/fast.py:81"),
    "masked_top2_mutual": ("orb_slam2_tpu_torch/csrc/masked_top2.cu",
                           "orb_slam2_tpu/matching/pallas_hamming.py:187"),
    "masked_top2_epi": ("orb_slam2_tpu_torch/csrc/masked_top2.cu",
                        "orb_slam2_tpu/matching/pallas_hamming.py:307"),
    "hamming_top2": ("orb_slam2_tpu_torch/csrc/masked_top2.cu",
                     "orb_slam2_tpu/matching/pallas_hamming.py:47"),
}


def repeat_bench(device, world, cfg) -> int:
    """--repeat-a: paths A-seq, A, A, A-seq in one process, one summary
    line each: the spread of fps and frame times between runs of one
    configuration against the gap between the two."""
    runs = []
    for pipelined in (False, True, True, False):
        r = phase_bench(device, world, cfg, pipelined=pipelined)
        runs.append(("A" if pipelined else "A-seq", r))
    for name, r in runs:
        log(f"repeat {name}: {r['fps']:.2f} fps, median frame "
            f"{r['median_ms']:.1f} ms, max {r['max_ms']:.1f} ms, "
            f"{r['keyframes']} keyframes, tracker {r['tracker_cpu_ms']:.1f}"
            f" ms on a CPU of {r['tracker_ms']:.1f} ms")
    return 0


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
    ap.add_argument("--repeat-a", action="store_true",
                    help="run only paths A-seq, A, A, A-seq (see "
                         "repeat_bench)")
    ap.add_argument("--repeat-b", action="store_true",
                    help="run only path B, four times (see repeat_loop)")
    ap.add_argument("--kernels-from", metavar="DIR",
                    help="run only phases 1 and 2 (build, each kernel "
                         "against its plain version, timed) with "
                         "orb_slam2_tpu_torch imported from the checkout "
                         "DIR, and print the results as one JSON line")
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
    root = os.path.abspath(args.kernels_from or here)
    if not os.path.isdir(os.path.join(root, "orb_slam2_tpu_torch")):
        print(f"chip_smoke: orb_slam2_tpu_torch/ is not in {root}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
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
        if any(w in line for w in ("registers", "Compiling entry",
                                    "stack frame")):
            log(f"ptxas: {line.strip()}")

    cfg = bench_config()
    world, _ = bench_world(device)
    if args.repeat_b:
        return repeat_loop(device, cfg)
    if args.repeat_a:
        try:
            return repeat_bench(device, world, cfg)
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
            return 1
    if args.profile or args.kernels_from:
        try:
            if args.profile:
                phase_bench(device, world, cfg, profile=True)
            else:
                log(json.dumps({"tree": root, "kernels": phase_kernels(
                    device, world, cfg)}))
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
            return 1
        return 0
    try:
        timing = phase_kernels(device, world, cfg)
        path_a = phase_bench(device, world, cfg)
        path_seq = phase_bench(device, world, cfg, pipelined=False)
        log(f"A against A-seq on this card: {path_a['fps']:.2f} against "
            f"{path_seq['fps']:.2f} fps, median frame "
            f"{path_a['median_ms']:.1f} against {path_seq['median_ms']:.1f}"
            f" ms, max {path_a['max_ms']:.1f} against "
            f"{path_seq['max_ms']:.1f} ms")
        launches = path_a["launches"]
        from orb_slam2_tpu_torch.matching import hamming_top2 as ht
        k4_ref = ht.hamming_top2_plain(*k4_problem(4096, 4096, 0.2, 4,
                                                   device))
        launches["hamming_top2"] = phase_k4(device, k4_ref)["hamming_top2"]
        phase_loop(device, cfg)
        phase_estimated(device, world, cfg)
        phase_cli(device, cfg, smi)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    rows = []
    for t in timing:
        source, replaces = KERNEL_META[t["name"]]
        # no single PyTorch call computes any of the four functions
        rows.append(dict(name=t["name"], route="cuda", source=source,
                         replaces=replaces, launches=launches[t["name"]],
                         max_abs_err=t["max_abs_err"], ms=t["ms"],
                         plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                         bound_by=t["bound_by"], library_ms=None,
                         shape=t["shape"], loop_ms=t["loop_ms"],
                         share=t["bound_ms"] / t["ms"]))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
