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
  G. the CUDA graphs (``graphs.py``, the counterpart of the JAX
     package's ``jax.jit``) at bench shape on path A's world:
     ``FrameFactory.start`` replayed from a graph against the eager
     extraction and undistortion, bit for bit in every field over 3
     frames, each frame's device arrays unchanged after the next is
     extracted; ``make_extractor`` against ``extract``; then, on a warm
     tracker (12 frames pipelined at depth 3), both forms of the fused
     pose-prior step (the device chain and the host-prepared step)
     replayed against their eager calls, bit for bit; prints captures
     and replays per function;
  3. path A, bench.py's configuration: ``System(cfg,
     enable_loop_closing=True, async_mapping=True)`` with
     ``pipelined_tracking`` at depth 3 tracks a 40-frame 1920x1440 aerial
     sweep with 4000 ORB features on 8 levels through
     ``track_monocular_with_pose(..., next_image=)``: bench.py's 16
     warm-up frames, each followed by ``flush_mapping``, then 24
     measured frames after a ``prefetch`` of the first, ending with
     ``flush_tracking``, while local mapping and loop detection run on
     the mapping thread; no synchronization per measured frame (the
     graphed tracker outruns the mapper: unpaced from the first frame
     on an H100, the map got 3 keyframes in 40 frames).  Checks
     tracking, that nothing is left in flight, map quality, the
     vocabulary and BoW database, that K1-K3 launched and K1 once a
     frame plus once per prefetch that was discarded; prints fps as
     bench.py measures it,
     the searches' launches by shape, the synchronizations of one
     extraction, the graphs' captures and replays, and the host
     synchronizations of the extractions and fused dispatches of each
     frame (bar: none on a steady frame, one without a capture);
  4. path A-seq: path A with ``pipelined_tracking=False``, for its fps
     and frame times beside path A's on the same card;
  H. bench.py's run at its full default length, in this process,
     through the port's benchmark module (``orb_slam2_tpu_torch.bench``,
     the run of ``python -m orb_slam2_tpu_torch.bench``): 16 warm-up
     frames and two measured windows of 100 frames over one 1920x1440
     sweep staged on the card, asynchronous mapping and live loop
     detection, pipelined at depth 3.  Bars: every measured frame OK,
     no loop closed, median |z| under 0.1, no host sync on a measured
     frame without a capture, at most 8 captures a graph.  Prints
     bench.py's JSON and, per window, p50 and p90 frame times, the
     captures inside it by graph and bucket, the map and the mapper's
     queue at its end and the tracker's map-lock wait; peak device
     memory and the kernels' launches over the run;
  L. tests/test_scale_run.py's long run on the card, as the JAX test
     runs it: 500 frames of 640x480 on a circuit, three noise frames
     that force LOST and relocalization, sequential mapping, loop
     closing on; the JAX test's bars (the late per-frame wall within 3x
     the early one among them), at most 8 captures a graph, no host
     sync on a steady frame; prints every capture by frame, graph and
     bucket, allocated and reserved memory every 50 frames and what
     the captures' memory pools hold;
  L-bench. path H for 12 measured windows (1,216 frames), nothing else
     changed: H's bars and the last window's p50 within 3x the first's;
     per window fps, p50, p90, captures, lock waits, memory, the map
     and the device point store's rows, and its re-allocations;
  5. path C: K4 through its entry point ``hamming_top2`` at 4096x4096
     with 20% of the columns invalid;
  6. path B, a loop that closes at full width: a drifted circuit with
     sequential mapping must run DetectLoop -> Sim3 -> correction ->
     essential graph -> global BA and lower the keyframe ATE below the
     drifted priors'; prints the loop-closing stage times and the loop
     keyframe's split (``LoopWatch``: its stage times, host syncs, each
     loop program's calls, first-call and warm-call times and a warm
     call's launches, the loop graphs' captures, bar <= 8 a graph);
     then phase G on its loop programs: each call of the loop keyframe
     (the BoW match, the Sim3 RANSAC, both Sim3 searches, OptimizeSim3,
     the essential graph, global BA) against the same call with every
     CUDA graph run eagerly, bit for bit, and a warm call of each with
     no host sync;
  B-height. path B over non-planar ground (after path F): B's texture
     on tests/test_loop_proof.py's height field (make_height_world's
     field, 1.5 units, over the texture's extent), rendered by
     ``render_height``; B's bars, the map's std in z over 0.2 and at
     most 8 captures a graph; prints B's lines, the map's size and
     spread in z;
  B-1M. path B with a 1,111,111-node ORBvoc (k=10, L=6, 10^6 words) as
     the live vocabulary: ``synthetic_orbvoc`` written as a DBoW2
     binary file, loaded back and given as ``System(..., vocab=)``
     (tests/test_vocab_scale_live.py's boot path); bars: the JAX test's
     (load under 120 s, a warm BoW transform under 2 s), B's loop and
     ATE bars, a warm descent with no host sync, at most 8 captures of
     the descent; prints the file's generation, write and load times,
     the warm descent by CUDA events beside its replay and its copies
     into the static inputs (the centers, ~35.6 MB a replay), what its
     captures hold, the inverted file's size and a loop query's time;
  B-est-640. a loop in estimated mode on the card (after B-1M):
     tests/test_loop_upstream.py's own configuration and circuit
     (640x480, 800 features, 4 levels, its SlamConfig with
     ``pose_prior=False``, ``make_world(seed=3)``, the 48-frame circle
     of radius 6 plus its first 14 frames), sequential mapping, loop
     closing on, ``track_monocular`` with no pose, its noise (4 grey
     levels) from each of the seeds 11-14, one run a seed, and a run
     with loop closing off for each seed that closes a loop.  Bars:
     every run finishes with a finite map and keyframe poses; at least
     one seed closes a loop; each that does has > 0.7 of its frames OK,
     the loop's matches at least ``loop_min_total_matches``, a finite
     positive scale and a Sim3-aligned keyframe ATE below its loop-off
     run's.  Prints per seed the frames OK, the loop's frame, keyframes
     and scale, both ATEs, the loop keyframe's split (``LoopWatch``:
     ``loop/*`` stages, each loop program's host syncs and calls, the
     loop graphs' captures) and K1-K3's launches, each line with the
     card's name and power limit;
  B-est. the same at bench width (after B-est-640): path B's world and
     true circuit (114 frames, no pose fed), ``bench_config()`` with
     ``pose_prior=False``, sequential tracking and mapping, loop closing
     on, 1920x1440, 4,000 features, 8 levels, noise of 2 grey levels
     (with the JAX test's 4 neither package bootstraps there; with 2
     the JAX package bootstraps on every seed and closes its loop on
     seed 11, tests/test_torch_loop_estimated_bench.py); the seeds in
     order, stopping at the first that closes a loop, which is run
     again with loop closing off (``--path-best``: every seed);
     B-est-640's bars and lines, except that the default run prints
     the keyframe ATE against the loop-off run's and does not hold it:
     on the H100 the port's loop on seed 11 raises it, and
     ``--path-best`` holds it on every seed and fails there;
  7. path D, estimated-pose mode at full width: path A's world and a
     50-frame sweep through ``track_monocular`` with no pose (the H/F
     two-view bootstrap, eager, whose time it prints; the motion model
     and the local-map search; the pose optimization, whose programs
     replay CUDA graphs; pose-optimizing local BA, whose ``lba/*``
     stage times it prints; sequential mapping with loop detection):
     initialized within 10 frames, 0.8 of the frames after it OK, the
     Sim3-aligned ATE of the camera centers under 1% of the distance
     flown; each frame's host syncs (bar: none on a steady frame that
     maps no keyframe and captures no graph), captures and time, the
     frame times split into frames with and without a keyframe, three
     frames' kernel and graph launches under torch.profiler; then two
     EPnP relocalizations, each a noise frame that must go LOST and a
     mapped keyframe's image that must relocalize to within 1% of the
     distance flown and 1 degree of the pose tracked for it, their
     times side by side; then phase G on path D's programs (the
     last-frame and local-map searches, the pose optimization, the
     chi2 gate, the descriptor search, the EPnP RANSAC, the
     relocalizer's projection search): each call of a steady frame and
     of the first relocalization against the same call with every
     CUDA graph run eagerly, bit for bit, and a warm call of each with
     no host sync; the graphs' captures (bar <= 8 a graph);
  8. path E, the command line at full width: a shenzhen-layout dataset
     (24 frames of path A's world as 8-bit .npy, a UE4 pose list, an
     OpenCV settings YAML, a binary ORBvoc of the shipped vocabulary's
     shape k=10 L=6, a launch TOML) run through ``cli.main(["run", ...])``
     with loop closing on: the printed JSON, every frame after
     initialization OK, K1 once a frame, map.ply on the ground plane
     through the revert transform, each tracked PLY's pose (the prior
     @ inv(revert)) and points (against their uv); then ``save_map``,
     ``load_map`` into a fresh System, a relocalization on a sequence
     frame's image, and localization mode adding no keyframe; then the
     same command with ``--viz 0 --viz-dir DIR``: /status.json,
     /frame.png and /map.png fetched over 127.0.0.1 while it tracks and
     at the viewer's close (every frame seen, both PNGs decode, green
     crosses on the frame), DIR/frame.png written, and the CLI's fps
     with and without the viewer;
  9. path F, the distributed solvers at full width, after path B: the
     global BA problem and essential graph of B's first loop correction
     and the map as its global BA found it, solved on two shards of the
     one card (``distributed_bundle_adjust``, ``..._sharded_points``,
     ``distributed_pose_graph``, ``LoopCloser.run_global_ba``'s sharded
     branch) against the single-device solve (poses 2e-4, points 2e-3,
     inliers equal, cost rtol 1e-3, the shards' cameras bitwise equal),
     and by two processes on the card joined by gloo
     (``init_multihost`` + ``make_global_mesh``): the same cost on both
     ranks, within 1e-3 of the single device's; each solve's time
     beside the single-device time.  Each sharded solve replays its
     shards' graph chains: held bit for bit to the eager one-call solve
     on every shard (``eager=True``), first and warm, a warm solve with
     no host sync on the local mesh and one a collective on gloo, at
     most ``graphs.MAXSIZE`` captures a segment.  Then the three solves
     on a one-rank NCCL group of the card (``--nccl-worker``, a process
     of its own): the captured form (every collective inside the
     graphs, one replay an LM iteration) and the cut form, each bit for
     bit the eager solve, a warm captured solve with no host sync and
     no host launch but its replays, its inputs' uploads and its
     result's gather; first and warm times, captures, syncs and
     runtime calls of both forms side by side.
Path A also holds a warm extraction to no host synchronization, and
path D prints the model (H or F) of its two-view bootstrap, which must
be H on the planar world.  Phase G ends on the card's eigensolvers:
Horn's matrices of the EPnP batch the port met at frame 27 of
tests/test_loop_upstream.py's circuit on the CPU (``tests/data/
reloc_frame27.npz``; four blocks NaN) through ``horn.top_eigvec``'s
Jacobi sweeps (NaN exactly there, LAPACK's vectors elsewhere, no
error, its time) and that RANSAC problem through the graphed
``pnp_ransac`` (no error, no pose, as on the CPU).

``python3 chip_smoke.py --cards 4`` is the four-card mode, for a host
with four cards (it fails, naming the count, with fewer, and falls back
to nothing): phases 1 and 2 on card 0, then
  B4. path B unchanged on card 0, its global BA sharded over the four
     cards by ``run_global_ba`` (``parallel.local_devices``): B's bars,
     the global BA's chain segments on every card, each card's peak
     memory, the kernels on card 0 only;
  F4-local. path F's three solves of B4's first loop correction on
     ``LocalMesh`` over the four cards, as path F holds them (graphed
     against eager on every shard, replicated state bitwise equal, a
     warm call with no sync and no capture, within the bars of the
     single-device solve), the mesh's psum across the cards, peer
     access, each card's peak memory; B4's recorded global BA against
     its problem solved on one card;
  W. tools/weak_scaling.py's measurement: its problem at 40,000 and
     2^20 observations a card on 1, 2 and 4 cards (first and median warm
     call, obs/s, each card's peak memory, final cost), then the largest
     problem on one card (strong scaling, within the bars);
  F4-NCCL. the three solves on four processes, one NCCL rank a card
     (``--nccl-worker HOST:PORT PROBLEM RANK 4``), eager, captured and
     cut, both forms bit for bit the eager solve on every rank and every
     rank's results bitwise equal, within the bars of the single-device
     solve; then W's largest problem on the four ranks, captured;
then W's table, the kernel JSON line (B4's launches, K4's from path C),
each card's nvidia-smi line and the ok line with ``"count": 4``.
The kernel launch counts are read per path, each path driven with the
counts set to 0 just before it.  Each phase prints its wall time and
the card's memory after it (``time phase_...`` lines, ``time_phases``).
The last three lines are a JSON object
describing the kernels (``launches``: path A's; ``launches_h``,
``launches_l``, ``launches_lb``, ``launches_b_height``,
``launches_b_1m``, ``launches_b_est``, ``launches_b_est_bench``:
paths H's, L's, L-bench's, B-height's, B-1M's, B-est-640's four
loop-closing runs' and B-est's loop-closing runs'), the
card's name and power limit, and
``{"ok": true, "device": {...}}``.

Thirteen diagnostics print no such lines: ``--path-h`` runs path H alone,
``--path-l`` paths L and L-bench alone, ``--path-bh`` / ``--path-b1m``
path B-height / B-1M alone (both with both flags), ``--path-best``
phase G's eigensolver check and paths B-est-640 and B-est (every
seed, every bar) alone, ``--phases-of
DIR`` the default run of DIR's chip_smoke.py (a parent's checkout,
unpacked by git archive) with each of its phases timed as this
script's are (``time_phases``), ``--repeat-f`` runs path B and
then times path F's solves (with ``--tree DIR``: four processes, as
``--repeat-d``), ``--repeat-d`` runs path D twice
(with ``--tree DIR``: four processes, the port from DIR, this
checkout, this checkout and DIR, so a parent and its change are
measured on one card) with one summary line per run (its steady and
keyframe frames' median times, a profiled steady frame's launches, its
host syncs, both relocalizations' times, the bootstrap's time),
``--loop-split`` runs path B
twice with its loop keyframe split (the second run under torch.profiler
for the keyframe's launches) and then path D, ``--profile``
runs path A alone
(pipelined) with torch.profiler over a window of frames (the card's
busy share; each thread's kernel and graph launches, copies and waits
for the card, and per frame), ``--repeat-a``
runs paths A-seq, A, A, A-seq one after another for the spread of their
fps and frame times, ``--repeat-b`` runs path B four times and says
where the runs part (``--tree DIR`` runs ``--loop-split``,
``--profile`` or ``--repeat-a`` with the port
imported from the checkout
DIR: a parent and its change under one script), and ``--kernels-from
DIR``
runs phases 1 and 2 alone with the port imported from DIR
(``--gloo-worker`` and ``--nccl-worker`` are path F's own
subprocesses).  To compare
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
LOOP_SEED = 7           # the texture's (bench.py's world seed)
# path B-height: path B over the JAX package's height field
# (tests/test_loop_proof.py: make_height_world(seed=3, height_amp=1.5),
# whose field is 28x28 random cells bicubic to 768x768 over the
# texture's extent); its bar on the map's spread in z
BH_AMP = 1.5
BH_CELLS = 28
BH_SIZE = 768
BH_Z_STD = 0.2
# path B-1M: path B with a 1,111,111-node ORBvoc (k=10, L=6) as the live
# vocabulary (tests/test_vocab_scale_live.py: synthetic_orbvoc(k=10,
# L=6, seed=7) through the DBoW2 binary file); the JAX test's bars on
# the file's load and a warm BoW transform, host clock
B1M_K, B1M_LEVELS, B1M_SEED = 10, 6, 7
B1M_LOAD_S = 120.0
B1M_TRANSFORM_S = 2.0
# path B-est-640: estimated mode (no pose fed to the tracker, the loop's
# Sim3 scale free) with tests/test_loop_upstream.py's sensor noise.  One
# run a noise seed, the seeds fixed before any run: on the JAX test's
# circuit each package closed its loop on one or two of these four seeds
BEST_SEEDS = (11, 12, 13, 14)
BEST_NOISE = 4.0        # grey levels, the JAX test's
# path B-est: the same at bench width on path B's world and circle.  At
# 4 grey levels neither package bootstraps there; at 2 the JAX package
# bootstraps on each of BEST_SEEDS and closes its loop on seed 11
# (tests/test_torch_loop_estimated_bench.py), so 2 was fixed before
# any run of the port
BEST_BENCH_NOISE = 2.0
# the JAX test's own circuit (48 frames a lap, radius 6, the first 14
# frames again) at its 640x480
BEST_LAP, BEST_RADIUS, BEST_REVISIT = 48, 6.0, 14
# phase G on the card's eigensolvers: the EPnP RANSAC problem the port
# met at frame 27 of the JAX test's circuit on the CPU, and its four
# degenerate samples (tests/test_torch_eigh_nan.py)
FRAME27 = os.path.join("tests", "data", "reloc_frame27.npz")
FRAME27_NAN = [8, 13, 61, 126]
# paths A and A-seq: bench.py's warm-up (BENCH_WARM), each frame
# followed by flush_mapping; the frames after it are measured
WARM_FRAMES = 16
# path A with --profile: the frames recorded by torch.profiler
PROFILE_FROM = 20
# phase G: frames extracted through the graph and against eager, and the
# frames tracked before the fused steps are compared on a warm state
G_EXTRACT = 3
G_TRACK = 12
# phase G tracks on past G_TRACK until the keyframe mapped last has
# called each of the mapper's graphs (structure BA needs 3 keyframes,
# the vocabulary 4), up to G_MAP frames
G_MAP = 30
# path D: estimated-pose mode over path A's world.  50 frames leave at
# least 6 keyframes (a loss then does not reset the map), which 40 may
# not; the bars are tests/test_pipeline.py's TestEstimatedMode scaled
D_FRAMES = 50
D_INIT_BY = 10          # frames by which the two-view bootstrap succeeds
D_MIN_OK = 0.8          # share of the frames after it tracked OK
D_ATE_SHARE = 0.01      # ATE bar, share of the distance flown
D_MIN_KEYFRAMES = 6     # a loss with <= 5 keyframes resets the map
D_RELOC_DEG = 1.0       # relocalized pose against the tracked one
D_WATCH = 4             # the last frames whose program calls phase G keeps
D_PROFILE = (40, 41, 42)  # frames under torch.profiler (their launches)
# path E: the command line on a shenzhen-layout dataset of path A's
# world; a sequence frame relocalized on the saved and loaded map, then
# E_LOC_FRAMES frames in localization mode
E_FRAMES = 24
E_VOCAB_LEVELS = 6      # the shipped ORBvoc's depth (k=10: 1M words)
E_RELOC_FRAME = 12
E_LOC_FRAMES = 4
# path L: tests/test_scale_run.py's run (500 frames, noise at 250-252);
# path L-bench: bench.py's run for 12 measured windows (1,216 frames);
# the JAX test's bar on the growth of the per-frame wall, for both
L_FRAMES = 500
L_BLACKOUT = range(250, 253)
LB_WINDOWS = 12
WALL_RATIO = 3.0

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


def time_phases(module) -> None:
    """Wrap each ``phase_*`` function of ``module`` (this script, or a
    parent's chip_smoke.py under ``--phases-of``) so that each call logs
    its wall time, the card synchronized, and the card's memory after it:
    ``time phase_x[ label]: S s, allocated A MiB, reserved R MiB``.
    The default run's limit is 1200 s: these lines say which phase grew."""
    import functools
    import torch
    for name, fn in list(vars(module).items()):
        if not name.startswith("phase_") or not callable(fn) \
                or hasattr(fn, "timed"):
            continue

        @functools.wraps(fn)
        def timed(*args, _fn=fn, _name=name, **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                label = " ".join([_name] + [
                    a for a in (*args, *kwargs.values())
                    if isinstance(a, str)])
                log(f"time {label}: {time.perf_counter() - t0:.1f} s, "
                    f"allocated {torch.cuda.memory_allocated() / 2**20:.0f}"
                    f" MiB, reserved "
                    f"{torch.cuda.memory_reserved() / 2**20:.0f} MiB")
        timed.timed = True
        setattr(module, name, timed)


def phases_of(tree: str) -> int:
    """``--phases-of``: the default run of ``tree``'s chip_smoke.py with
    its phases timed by ``time_phases``, so that a parent's run and this
    one print the same time lines on one card."""
    import importlib.util
    path = os.path.join(tree, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("parent_chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    time_phases(module)
    sys.argv = [path]
    log(f"the default run of {path}, its phases timed")
    return module.main()


def nvidia_smi_lines() -> list:
    """Each card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()



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
    """bench.py's configuration, as the port's benchmark module defines
    it (pipelined tracking at depth 3, the padded-size floors)."""
    from orb_slam2_tpu_torch.bench import bench_config as config
    return config()


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
    the mapping thread's host sections; and how long the thread
    ``holder`` (the mapping thread, once set) held it (``hold_s``, from
    its outermost acquire to the matching release)."""

    def __init__(self, lock):
        self._lock = lock
        self._main = threading.main_thread()
        self.wait_s = 0.0
        self.holder = None
        self.hold_s = 0.0
        self._depth = 0
        self._t_acq = 0.0

    def acquire(self, *args, **kwargs):
        me = threading.current_thread()
        if me is not self._main:
            got = self._lock.acquire(*args, **kwargs)
            if got and me is self.holder:
                self._depth += 1
                if self._depth == 1:
                    self._t_acq = time.perf_counter()
            return got
        t0 = time.perf_counter()
        got = self._lock.acquire(*args, **kwargs)
        self.wait_s += time.perf_counter() - t0
        return got

    def release(self):
        self._lock.release()
        if threading.current_thread() is self.holder:
            self._depth -= 1
            if self._depth == 0:
                self.hold_s += time.perf_counter() - self._t_acq

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
    """Reads a torch.profiler chrome trace.  The tracker launched
    torch.cuda._sleep (spin_kernel) as its window opened and again as it
    closed; the mapping thread launches one as each keyframe begins and
    ends (``watch_mapper``): those markers name the two threads,
    however the profiler numbered them.  Over the tracker's window: the
    union of the card's kernel, copy and fill intervals, and per host
    thread the CUDA runtime calls that wait for the card (stream, device
    and event synchronizations, and copies, which wait for the work
    queued before them) and the kernel and graph launches.  Over the
    whole trace, per thread, the same counts between consecutive
    markers (``segments``).  ``threads`` names threading.Thread
    objects."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    # a runtime event names its thread by the system thread id, or by
    # the pthread id (whole or its low 32 bits) where the profiler did
    # not record the thread's system id
    names = {}
    for who, t in threads.items():
        for key in (t.native_id, t.ident, t.ident & 0xFFFFFFFF):
            names[key] = who
    spin = {e.get("args", {}).get("correlation") for e in events
            if e.get("cat") == "kernel" and "spin_kernel" in e.get("name", "")}
    runtime = sorted((e for e in events if e.get("ph") == "X"
                      and e.get("cat") == "cuda_runtime"),
                     key=lambda e: e["ts"])
    marks = [e for e in runtime
             if e.get("args", {}).get("correlation") in spin]
    lo, hi = -float("inf"), float("inf")
    if marks:
        # the first marker is the tracker's; markers on another thread
        # are the mapping thread's
        tracker = marks[0].get("tid")
        names = {k: v for k, v in names.items()
                 if v not in ("tracker", "mapper")}
        names.update({e.get("tid"): "tracker" if e.get("tid") == tracker
                      else "mapper" for e in marks})
        ends = [e["ts"] for e in marks if e.get("tid") == tracker]
        lo = ends[0]
        hi = ends[1] if len(ends) > 1 else hi
    spans = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") in
                   ("kernel", "gpu_memcpy", "gpu_memset")
                   and e["ts"] + e["dur"] > lo and e["ts"] < hi)
    busy_us, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    per = {}

    def count(d, e):
        n = e["name"]
        if "Synchronize" in n:
            d["sync_ms"] = d.get("sync_ms", 0.0) + e["dur"] / 1e3
        elif "Memcpy" in n or "Memset" in n:
            d["copy_ms"] = d.get("copy_ms", 0.0) + e["dur"] / 1e3
            d["copies"] = d.get("copies", 0) + 1
        elif "LaunchKernel" in n or "GraphLaunch" in n:
            k = "launches" if "LaunchKernel" in n else "graph_launches"
            d[k] = d.get(k, 0) + 1
            d["launch_ms"] = d.get("launch_ms", 0.0) + e["dur"] / 1e3
    for e in runtime:
        tid = e.get("tid")
        who = names.get(tid, f"thread {tid}")
        d = per.setdefault(who, dict(sync_ms=0.0, copy_ms=0.0,
                                     launch_ms=0.0, launches=0,
                                     graph_launches=0, copies=0,
                                     segments=[]))
        if e.get("args", {}).get("correlation") in spin:
            d["segments"].append({})
            continue
        if d["segments"]:
            count(d["segments"][-1], e)
        if lo <= e["ts"] <= hi:
            count(d, e)
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


class SyncCounter:
    """The host synchronizations made inside the calls it wraps, counted
    as :func:`extraction_syncs` counts them (the warnings of
    torch.cuda.set_sync_debug_mode("warn"), which is on while any
    wrapped call runs) and attributed to the role given with the wrap
    ("tracker": the extractions and fused dispatches of the main thread,
    "mapper": each keyframe's mapping on the mapping thread); a warning
    raised outside a wrapped call is not counted.  Used as a context
    manager around a run, which routes the warnings here.  ``counts``
    holds role -> syncs and ``sites`` role -> (file:line) -> count."""

    def __init__(self):
        import collections
        self.counts = collections.Counter()
        self.sites = collections.defaultdict(collections.Counter)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._active = 0
        self._any = None        # the role of a call wrapped all_threads

    def __enter__(self):
        import warnings
        self._saved = (warnings.showwarning, warnings.filters[:])
        warnings.simplefilter("always")
        warnings.showwarning = self._show
        return self

    def __exit__(self, *exc):
        import warnings
        import torch
        warnings.showwarning, warnings.filters[:] = self._saved
        torch.cuda.set_sync_debug_mode(0)

    def _show(self, message, category, filename, lineno, *rest):
        role = getattr(self._local, "role", None) or self._any
        # the notice that the debug mode is a prototype, which PyTorch
        # gives once a process when it is first set, is no sync
        if ("synchroniz" not in str(message)
                or "prototype feature" in str(message)):
            self._saved[0](message, category, filename, lineno, *rest)
        elif role is not None:
            self.counts[role] += 1
            self.sites[role][f"{os.path.relpath(filename)}:{lineno}"] += 1

    def wrap(self, fn, role: str = "tracker", nested: bool = False,
             all_threads: bool = False):
        """``fn`` with its syncs counted under ``role``.  Inside another
        wrapped call the outer role keeps them, unless ``nested``: then
        this role takes them for the call's length.  With
        ``all_threads`` the syncs of threads that no wrapped call holds
        (a local mesh's shards) count under ``role`` too while ``fn``
        runs."""
        import torch

        if all_threads:
            inner = self.wrap(fn, role, nested)

            def counted_all(*args, **kwargs):
                self._any = role
                try:
                    return inner(*args, **kwargs)
                finally:
                    self._any = None
            return counted_all

        def counted(*args, **kwargs):
            outer = getattr(self._local, "role", None)
            if outer:                               # inside another
                if not nested:
                    return fn(*args, **kwargs)
                self._local.role = role
                try:
                    return fn(*args, **kwargs)
                finally:
                    self._local.role = outer
            self._local.role = role
            with self._lock:
                self._active += 1
                if self._active == 1:
                    torch.cuda.set_sync_debug_mode("warn")
            try:
                return fn(*args, **kwargs)
            finally:
                with self._lock:
                    self._active -= 1
                    if self._active == 0:
                        torch.cuda.set_sync_debug_mode(0)
                self._local.role = None
        return counted


def phase_graphs(device, world, cfg) -> dict:
    """Phase G, the CUDA graphs (``graphs.py``) at bench shape on path
    A's world: ``FrameFactory.start`` (extraction and undistortion
    replayed from a graph) against the eager extraction and
    undistortion, bit for bit in every field, over G_EXTRACT frames,
    each frame's arrays unchanged after the next one is extracted;
    ``make_extractor`` against ``extract``; then path A's tracker
    (pipelined at depth 3, sequential mapping) over G_TRACK frames, and
    on that warm state both forms of the fused step (the device chain
    and the host-prepared step) replayed twice against their eager
    calls, bit for bit."""
    import torch
    from orb_slam2_tpu_torch import graphs
    from orb_slam2_tpu_torch.models.frame import FrameFactory
    from orb_slam2_tpu_torch.ops import extractor as ex
    from orb_slam2_tpu_torch.pipeline import tracking
    from orb_slam2_tpu_torch.pipeline.system import System
    from orb_slam2_tpu_torch.utils import synth
    _, poses = bench_world(device)
    frames = [synth.render(world, cfg.cam, T) for T in poses[:G_MAP + 1]]
    graphs.reset_stats()
    factory = FrameFactory(cfg.cam, cfg.orb, device=device)
    fields = (*ex.Features._fields, "undistorted xy")
    kept = []
    for i in range(G_EXTRACT):
        feats, und, _ = factory.start(frames[i])
        want = (*factory._extract(frames[i], False),)
        torch.cuda.synchronize()
        for name, a, b in zip(fields, (*feats, und), (*want[0], want[1])):
            check(torch.equal(a, b), f"G: the graphed extraction of frame "
                  f"{i} differs from the eager one in {name}")
        for j, (arrays, copies) in enumerate(kept):
            for name, a, b in zip(fields, arrays, copies):
                check(torch.equal(a, b), f"G: frame {j}'s {name} changed "
                      f"when frame {i} was extracted")
        kept.append(((*feats, und), [t.clone() for t in (*feats, und)]))
    h, w = frames[0].shape
    run = ex.make_extractor(h, w, cfg.orb)
    for i in range(2):
        img = frames[i].float()
        for name, a, b in zip(fields, run(img), ex.extract(img, cfg.orb)):
            check(torch.equal(a, b), f"G: make_extractor differs from "
                  f"extract on frame {i} in {name}")
    log(f"G: FrameFactory.start bit-exact against the eager extraction "
        f"over {G_EXTRACT} frames ({factory._pipeline.n_captures()} "
        f"capture), earlier frames unchanged; make_extractor bit-exact")

    system = System(cfg, enable_loop_closing=True, async_mapping=False,
                    device=device)
    mapper_calls = record_mapper(system)
    system.prefetch(frames[0])
    n = 0
    while n < G_TRACK or (len(mapper_calls) < len(MAPPER_GRAPHS)
                          and n < G_MAP):
        system.track_monocular_with_pose(frames[n], n * 0.1, poses[n],
                                         next_image=frames[n + 1])
        n += 1
    tr = system.tracker
    check(tr._chain is not None and tr._prep is not None,
          "G: no live device chain after the warm-up frames")
    check_mapper_graphs(mapper_calls, n, system)
    frame = tr.factory.make(frames[n], n * 0.1, Tcw=poses[n])
    for chained, eager, graph in (
            (True, tracking._track_prior_chain, tr._chain_step),
            (False, tracking._prior_step_core, tr._prior_step)):
        args = tr._fused_inputs(frame, chained=chained)
        want = eager(*args)
        for k in range(2):
            got = graph(*args)
            torch.cuda.synchronize()
            for j, (a, b) in enumerate(zip(got, want)):
                check(torch.equal(a, b), f"G: the graphed "
                      f"{graph.name} differs from its eager call in output "
                      f"{j} (call {k})")
        log(f"G: {graph.name} (L={args[7].shape[0]}, candidates "
            f"{args[13 if chained else 9].shape[0]}) bit-exact against "
            f"its eager call, twice")
    system.flush_tracking()
    system.shutdown()
    stats = {k: dict(v) for k, v in graphs.STATS.items()}
    log(f"G: captures and replays per function {json.dumps(stats)}")
    return stats


# the mapper's graphs (LocalMapper attributes) and the vocabulary
# descent's (models.vocabulary._transform_graph), checked by phase G
MAPPER_GRAPHS = ("_tri_step", "_fuse_fwd", "_fuse_rev", "_compact",
                 "_sba_step", "bow")


def record_mapper(system) -> dict:
    """Wraps the mapper's graphs and the vocabulary descent's so that
    each keeps the arguments and outputs of its calls in the keyframe
    mapped last: returns {name: [(graph, args, outputs), ...]}, emptied
    when a keyframe's mapping begins."""
    from orb_slam2_tpu_torch.models import vocabulary
    calls = {}
    mapper = system.mapper

    def recorder(name, graph):
        def call(*args):
            out = graph(*args)
            calls.setdefault(name, []).append((graph, args, out))
            return out
        return call
    for name in MAPPER_GRAPHS[:-1]:
        setattr(mapper, name, recorder(name, getattr(mapper, name)))
    graph = vocabulary._transform_graph
    vocabulary._transform_graph = recorder("bow", graph)
    vocabulary._transform_graph.graph = graph   # put back by the check
    process = mapper.process_keyframe

    def begin(kid, queue_pressure=False):
        calls.clear()
        return process(kid, queue_pressure)
    mapper.process_keyframe = begin
    return calls


def check_mapper_graphs(calls: dict, n_frames: int, system) -> None:
    """Phase G's mapper part: every call of the keyframe mapped last,
    replayed again, against the eager function on the same arguments,
    bit for bit; then each function's last call replayed under
    ``torch.cuda.set_sync_debug_mode("error")`` (a warm replay waits for
    the card nowhere)."""
    import torch
    from orb_slam2_tpu_torch.models import vocabulary
    vocabulary._transform_graph = vocabulary._transform_graph.graph
    missing = [m for m in MAPPER_GRAPHS if m not in calls]
    check(not missing, f"G: the last keyframe mapped within {n_frames} "
          f"frames made no call of {missing}")

    def leaves(out):
        return (out,) if isinstance(out, torch.Tensor) else tuple(out)
    shapes = {}
    for name in MAPPER_GRAPHS:
        for k, (graph, args, out) in enumerate(calls[name]):
            want = leaves(graph.fn(*args))
            again = leaves(graph(*args))
            torch.cuda.synchronize()
            for j, (a, b, c) in enumerate(zip(leaves(out), want, again)):
                check(torch.equal(a, b) and torch.equal(c, b),
                      f"G: the graphed {graph.name} differs from its eager "
                      f"call in output {j} (call {k} of the last keyframe)")
        graph, args, _ = calls[name][-1]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            graph(*args)
        except RuntimeError as e:
            raise SmokeFailure(f"G: a warm {graph.name} replay "
                               f"synchronizes with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        shapes[graph.name] = (len(calls[name]), [
            tuple(a.shape) for a in args if isinstance(a, torch.Tensor)][:3])
    # the fuse graph copies the point store's snapshot into its static
    # inputs at each replay (DevicePoints.sync replaces the tensors)
    graph, args, _ = calls["_fuse_fwd"][-1]
    snap = [a for a in args[:6]]
    copies = [a.clone() for a in snap]
    n_bytes = sum(a.numel() * a.element_size() for a in snap)
    copy_ms = cuda_ms(lambda: [c.copy_(a) for c, a in zip(copies, snap)])
    call_ms = cuda_ms(lambda: graph(*args))
    log(f"G: a fuse_forward replay copies the {snap[0].shape[0]}-row "
        f"point-store snapshot, {n_bytes / 2 ** 20:.1f} MiB, in "
        f"{copy_ms:.4f} ms of its {call_ms:.4f} ms call (CUDA events)")
    n_kf = system.store.n_valid_keyframes()
    log(f"G: the mapper's graphs bit-exact against their eager calls on "
        f"the keyframe mapped last after {n_frames} frames ({n_kf} "
        f"keyframes), and a warm replay of each with no host sync; calls "
        f"and first shapes {json.dumps(shapes)}")
    check_fuse_both(calls)


def check_fuse_both(calls: dict) -> int:
    """Phase G's ``_fuse_both_directions`` (one graphed program: the
    forward fuse into a chunk of targets and the reverse fuse, ungated)
    on the last fuse calls' inputs at bench shape (the keyframe's point
    rows into the chunk's FUSE_CHUNK targets; the neighbours' rows into
    the keyframe): the capture and a replay against the eager function,
    bit for bit; a warm replay under set_sync_debug_mode("error"); K2's
    launches a replay (kernels.LAUNCHES).  Returns them."""
    import torch
    from orb_slam2_tpu_torch import kernels
    from orb_slam2_tpu_torch.pipeline import local_mapping as lm
    fa, ra = calls["_fuse_fwd"][-1][1], calls["_fuse_rev"][-1][1]
    args = (*lm._gather_rows(*fa[:7]), *fa[7:12],
            *lm._gather_rows(*ra[:7]), *ra[7:12], *fa[12:20])
    th, ratio = fa[20], fa[21]
    want = lm._fuse_both_impl(*args, th, ratio)
    for k in range(2):
        got = lm._fuse_both_directions(*args, th=th, ratio=ratio)
        torch.cuda.synchronize()
        for j, (a, b) in enumerate(zip((*got[0], *got[1]),
                                       (*want[0], *want[1]))):
            check(torch.equal(a, b), f"G: the graphed _fuse_both_directions "
                  f"differs from its eager call in output {j} (call {k})")
    before = kernels.LAUNCHES["masked_top2_mutual"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        lm._fuse_both_directions(*args, th=th, ratio=ratio)
    except RuntimeError as e:
        raise SmokeFailure(f"G: a warm _fuse_both_directions replay "
                           f"synchronizes with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    k2 = kernels.LAUNCHES["masked_top2_mutual"] - before
    check(k2 > 0, "G: _fuse_both_directions launched no K2")
    log(f"G: _fuse_both_directions ({fa[7].shape[0]} targets of "
        f"{fa[8].shape[1]} rows, {fa[6].shape[0]} own and {ra[6].shape[0]} "
        f"candidate point rows) bit-exact against its eager call, twice; a "
        f"warm replay with no host sync launches K2 {k2} times; "
        f"{lm._fuse_both_graph.n_captures()} capture")
    return k2


# the mapper's graphs by their graphs.STATS names
MAPPER_STATS = ("triangulate", "fuse_forward", "fuse_reverse",
                "compact_matches", "sba_step", "bow_transform")
# the mapper's stage timers read per keyframe
MAPPER_STAGES = ("mapping/process_kf", "mapping/cull_points",
                 "mapping/triangulate", "mapping/fuse", "mapping/local_ba",
                 "mapping/cull_keyframes", "mapping/loop_closing",
                 "tri/prep_host", "tri/device", "tri/apply",
                 "tri/update_points", "tri/update_conn", "fuse/collect",
                 "fuse/sync", "fuse/device", "fuse/apply",
                 "fuse/update_points", "fuse/update_conn", "sba/gather",
                 "sba/device", "sba/apply")


def watch_mapper(system, syncs, clock, torch):
    """Wraps the mapper's ``process_keyframe`` (which the mapping thread
    calls for each keyframe): its host syncs (``syncs``, role
    "mapper"), its waits on a result read (``graphs.Readback.wait`` on
    the mapping thread), how long it held the map lock (``clock``, a
    LockWaitClock), its stage times and its start and end on the host
    clock, per keyframe, into ``mapped["keyframes"]``.  While
    ``mapped["window"]`` is open (a profile window), each keyframe
    launches ``torch.cuda._sleep`` as it begins and as it ends: the
    markers name the mapping thread in the trace and bound each
    keyframe's launches.  Returns (mapped, a function that puts
    ``Readback.wait`` back)."""
    import importlib
    mapper = system.mapper
    thread = system.map_worker._thread
    clock.holder = thread
    mapped = dict(keyframes=[], window=None, waits=0)
    try:
        readback = importlib.import_module(
            "orb_slam2_tpu_torch.graphs").Readback
    except (ImportError, AttributeError):   # --tree: an older checkout
        readback = None
    if readback is not None:
        wait = readback.wait

        def counted_wait(self):
            if threading.current_thread() is thread:
                mapped["waits"] += 1
            return wait(self)
        readback.wait = counted_wait
    process = syncs.wrap(mapper.process_keyframe, "mapper")

    def marker():
        window = mapped["window"]
        if window is not None and window[1] is None:
            torch.cuda._sleep(1000)
            return True
        return False

    def process_keyframe(kid, queue_pressure=False):
        begun = marker()
        s0, w0, h0 = syncs.counts["mapper"], mapped["waits"], clock.hold_s
        stages0 = {k: mapper.timer.total.get(k, 0.0) for k in MAPPER_STAGES}
        t0 = time.perf_counter()
        try:
            return process(kid, queue_pressure)
        finally:
            mapped["keyframes"].append(dict(
                marks=(begun, marker()), kid=kid, start=t0,
                end=time.perf_counter(),
                syncs=syncs.counts["mapper"] - s0,
                waits=mapped["waits"] - w0, held=clock.hold_s - h0,
                stages={k: mapper.timer.total.get(k, 0.0) - v
                        for k, v in stages0.items()}))
    mapper.process_keyframe = process_keyframe

    def restore():
        if readback is not None:
            readback.wait = wait
    return mapped, restore


def report_mapper(name, system, mapped, syncs, graphs) -> None:
    """Path A's mapper lines: captures and replays of each of its graphs
    (bar: at most graphs.MAXSIZE captures a function), the stage times
    per keyframe mapped, and the host syncs and result waits per
    keyframe on the mapping thread."""
    kfs = mapped["keyframes"]
    n = max(len(kfs), 1)
    if graphs:
        stats = {k: dict(graphs.STATS.get(k, {})) for k in MAPPER_STATS}
        log(f"{name}: the mapper's graphs (captures, replays) "
            f"{json.dumps(stats)}")
        for k, v in stats.items():
            n_cap = v.get("captures", 0)
            check(n_cap <= graphs.MAXSIZE, f"{name}: {k} captured {n_cap} "
                  f"times, more than its {graphs.MAXSIZE} kept")
    rep = system.mapper.timer.report()
    per_kf = {k: round(rep[k][1] * 1e3 / n, 2) for k in MAPPER_STAGES
              if k in rep}
    med = {k: round(float(np.median([f["stages"][k] for f in kfs])) * 1e3,
                    2) for k in MAPPER_STAGES} if kfs else {}
    log(f"{name}: mapper stage times per keyframe mapped, ms over "
        f"{len(kfs)} keyframes, mean {json.dumps(per_kf)}, median "
        f"{json.dumps(med)}; keyframe mapping median "
        f"{np.median([k['end'] - k['start'] for k in kfs]) * 1e3:.1f} ms"
        if kfs else f"{name}: no keyframe mapped")
    log(f"{name}: mapping thread, host syncs per keyframe "
        f"{[k['syncs'] for k in kfs]} ({sum(k['syncs'] for k in kfs) / n:.1f}"
        f" a keyframe; sites "
        f"{dict(syncs.sites['mapper'].most_common(8))}), result waits "
        f"(Readback.wait) per keyframe {[k['waits'] for k in kfs]}, the "
        f"map lock held per keyframe, ms "
        f"{[round(k['held'] * 1e3, 1) for k in kfs]}")


def phase_bench(device, world, cfg, pipelined: bool = True,
                profile: bool = False) -> dict:
    """Path A (``pipelined``): bench.py's configuration,
    System(enable_loop_closing=True, async_mapping=True) with
    ``pipelined_tracking`` at its depth (3), driven as bench.py
    drives it (bench.py:118-186): WARM_FRAMES warm-up frames, each call
    with ``next_image`` and followed by ``flush_mapping``, then the
    measured frames: ``prefetch`` of the first, ``next_image`` with each
    call, ``flush_tracking`` at the end; no synchronization per frame.
    Path A-seq: the same calls with ``pipelined_tracking=False``.  fps
    as bench.py measures it: the measured frames over the time from the
    window's ``prefetch`` to the return of ``flush_tracking``.  Frame
    times are each call's on the host clock.  The tracker's time per
    frame is split by the main thread's CPU clock: what it did not run
    on a CPU it spent blocked, on the map lock (measured) or on the
    interpreter lock (the rest; CUDA spins while it synchronizes when
    the process holds fewer contexts than the host has cores, so
    synchronizations count as run time).  ``profile`` records the card
    over frames PROFILE_FROM.. with torch.profiler and reads the
    device's busy share and each thread's waits for the card."""
    import dataclasses
    import torch
    from orb_slam2_tpu_torch import kernels
    from orb_slam2_tpu_torch.pipeline.system import System
    from orb_slam2_tpu_torch.pipeline.tracking import TrackState
    from orb_slam2_tpu_torch.utils import synth
    try:
        from orb_slam2_tpu_torch import graphs
    except ImportError:         # --tree: a checkout without graphs.py
        graphs = None
    name = "A" if pipelined else "A-seq"
    cfg = dataclasses.replace(cfg, pipelined_tracking=pipelined)
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
    # the syncs of every extraction and fused dispatch, per frame, and
    # of each keyframe's mapping on the mapping thread
    syncs = SyncCounter()
    system.factory.start = syncs.wrap(system.factory.start)
    system.tracker._fused_dispatch = syncs.wrap(
        system.tracker._fused_dispatch)
    frame_syncs, frame_captures = [], []
    mapped, restore_waits = watch_mapper(system, syncs, clock, torch)

    def captures():
        return sum(v["captures"] for v in graphs.STATS.values()) \
            if graphs else 0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    if graphs:
        graphs.reset_stats()
    states, starts, frame_ms, cpu_ms, lock_ms = [], [], [], [], []
    prof = None
    syncs.__enter__()
    for i, T in enumerate(poses):
        if profile and i == PROFILE_FROM:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            torch.cuda._sleep(1000)     # names the tracker's thread
            mapped["window"] = [time.perf_counter(), None]
        if i == WARM_FRAMES:
            t_window = time.perf_counter()
            system.prefetch(frames[i])
        nxt = frames[i + 1] if i + 1 < len(frames) else None
        if i + 1 == WARM_FRAMES:
            nxt = None
        n_sync, n_cap = syncs.counts["tracker"], captures()
        t0, c0, w0 = time.perf_counter(), time.thread_time(), clock.wait_s
        system.track_monocular_with_pose(frames[i], i * 0.1, T,
                                         next_image=nxt)
        frame_syncs.append(syncs.counts["tracker"] - n_sync)
        frame_captures.append(captures() - n_cap)
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
        if i < WARM_FRAMES:
            system.flush_mapping()  # bench.py's deterministic warm-up
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
        torch.cuda._sleep(1000)     # closes the tracker's window
    t0 = time.perf_counter()
    system.flush_mapping()      # re-raises a mapping-thread exception
    flush_s = time.perf_counter() - t0
    if prof is not None:
        # the trace runs on through the flush, so the keyframe being
        # mapped as the window closed is counted whole
        mapped["window"][1] = time.perf_counter()
        torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "path_a_trace.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
        window = device_window(path, {
            "tracker": threading.main_thread(),
            "mapper": system.map_worker._thread})
    system.shutdown()
    syncs.__exit__()
    restore_waits()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    ok_idx = [i for i, s in enumerate(states) if s == TrackState.OK]
    check(bool(ok_idx), f"{name}: the map never initialized")
    first = ok_idx[0]
    check(all(s == TrackState.OK for s in states[first:]),
          f"{name}: a frame after initialization (frame {first}) is not "
          f"OK: {[s.name for s in states]}")
    check(first < WARM_FRAMES, f"{name}: initialized at frame {first}, "
          f"after the {WARM_FRAMES} warm-up frames")
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
    # steady: after the first frame after initialization, no capture
    steady_sync = [(i, n) for i, (n, c) in enumerate(
        zip(frame_syncs, frame_captures)) if i > first and c == 0]
    if graphs:
        stats = {k: dict(v) for k, v in graphs.STATS.items()}
        log(f"{name}: graphs {json.dumps(stats)}; frames with a capture "
            f"{[i for i, c in enumerate(frame_captures) if c]}")
    log(f"{name}: host syncs in extraction and fused dispatch per frame "
        f"{frame_syncs}; {sum(n for _, n in steady_sync)} over the "
        f"{len(steady_sync)} steady frames (no capture), "
        f"{sum(n for _, n in steady_sync) / max(len(steady_sync), 1):.2f}"
        f" a frame; sites {dict(syncs.sites['tracker'].most_common(8))}")
    # a checkout from before the graphs (--tree) still has the syncs
    check(sum(n for _, n in steady_sync) == 0 or graphs is None,
          f"{name}: steady frames synchronize with the host in extraction "
          f"or fused dispatch: {[x for x in steady_sync if x[1]]}, sites "
          f"{dict(syncs.sites['tracker'])}")
    report_mapper(name, system, mapped, syncs, graphs)
    steady = frame_ms[WARM_FRAMES:]
    fps = (N_FRAMES - WARM_FRAMES) / (t_end - t_window)
    log(f"{name}: {len(ok_idx)}/{N_FRAMES} frames OK (initialized at "
        f"frame {first}), {n_kf} keyframes, {len(pts)} map points, median "
        f"|z| {med_z:.4f}, {len(pr.db.bow)} keyframes in the BoW database, "
        f"{len(discarded)} prefetched extractions discarded")
    log(f"{name}: {fps:.2f} fps over frames {WARM_FRAMES}-{N_FRAMES - 1} "
        f"(from the window's prefetch to the return of flush_tracking; "
        f"frames 0-{WARM_FRAMES - 1} each followed by flush_mapping, as "
        f"bench.py warms up); frame time with the mapping "
        f"thread live: median {np.median(steady):.1f} ms, mean "
        f"{np.mean(steady):.1f} ms, max {np.max(steady):.1f} ms (host "
        f"clock per call, no synchronization); the tracker waited "
        f"{clock.wait_s * 1e3:.1f} ms of its {track_s * 1e3:.1f} ms on the "
        f"map lock; final mapping flush {flush_s * 1e3:.1f} ms; peak device "
        f"memory {peak / 2 ** 20:.0f} MiB")
    wall, cpu, lck = (sum(x[WARM_FRAMES:]) for x in (frame_ms, cpu_ms,
                                                       lock_ms))
    log(f"{name}: the tracker's {wall:.1f} ms over frames {WARM_FRAMES}-"
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
        n_win = N_FRAMES - PROFILE_FROM
        for who, d in sorted(window["threads"].items()):
            n_launch = d["launches"] + d["graph_launches"]
            log(f"{name} profile, {who}: {d['launches']} kernel launches "
                f"and {d['graph_launches']} graph launches taking "
                f"{d['launch_ms']:.1f} ms ({n_launch / n_win:.1f} a "
                f"frame), {d['copies']} copies and fills taking "
                f"{d['copy_ms']:.1f} ms ({d['copies'] / n_win:.1f} a "
                f"frame), {d['sync_ms']:.1f} ms in synchronizations")
        # the mapper's markers, in order: a keyframe begun in the trace
        # marks its start, one ended in it its end; the segment after a
        # keyframe's start marker, up to its end marker, is its launches
        marks = [(kind, i) for i, k in enumerate(mapped["keyframes"])
                 for kind, m in zip("SE", k["marks"]) if m]
        segs = window["threads"].get("mapper", {}).get("segments", [])
        whole = [segs[j] for j in range(min(len(marks), len(segs)) - 1)
                 if marks[j][0] == "S" and marks[j + 1] == ("E",
                                                            marks[j][1])]
        counts = [(g.get("launches", 0), g.get("graph_launches", 0),
                   g.get("copies", 0)) for g in whole]
        log(f"{name} profile, mapper: per keyframe begun after frame "
            f"{PROFILE_FROM}, (kernel launches, graph launches, copies and "
            f"fills) {counts} ({len(marks)} markers, {len(segs)} traced)")
    log(f"{name}: kernel launches {json.dumps(launches)}")
    log(f"{name}: search launches by rows x columns {json.dumps(shapes)}")
    log(f"{name}: timing report:\n" + system.timing_report())
    return dict(launches=launches, fps=fps, median_ms=float(
        np.median(steady)), max_ms=float(np.max(steady)), keyframes=n_kf,
        tracker_cpu_ms=cpu, tracker_ms=wall)


class CaptureLog:
    """Every CUDA graph capture made while it is entered, on any thread
    (a wrapped ``graphs._Capture.__init__``): a dict each with the host
    time, the frame being tracked as it was made (``frame``, set by the
    caller), the graph, the bucket (the two largest argument shapes),
    the bytes of its static inputs (clones in the default pool), its
    memory pool and a weak reference to the capture; :meth:`pools`
    reads back what the pools hold.  Each re-allocation of the device
    point store (a wrapped ``DevicePoints._full_upload``) goes to
    ``grows``: the frame, the new and old rows, the points, the
    thread."""

    def __init__(self):
        self.caps = []
        self.grows = []
        self.frame = None

    def __enter__(self):
        import weakref
        import torch
        from orb_slam2_tpu_torch import graphs
        from orb_slam2_tpu_torch.models.device_points import DevicePoints
        init = self._init = graphs._Capture.__init__
        upload = self._upload = DevicePoints._full_upload
        book = self

        def grown(dp, store, cap):
            book.grows.append(dict(
                frame=book.frame, rows=cap, old_rows=dp.cap,
                points=store.n_points(),
                thread=threading.current_thread().name))
            return upload(dp, store, cap)
        DevicePoints._full_upload = grown

        def capture(cap, fn, args, *rest):
            init(cap, fn, args, *rest)
            shapes = sorted({tuple(a.shape) for a in args
                             if isinstance(a, torch.Tensor)},
                            key=lambda s: -int(np.prod(s)))
            book.caps.append(dict(
                t=time.perf_counter(), frame=book.frame, graph=rest[1],
                bucket=" ".join("x".join(map(str, s)) for s in shapes[:2]),
                static_bytes=sum(a.numel() * a.element_size()
                                 for a in cap.static
                                 if isinstance(a, torch.Tensor)),
                pool=tuple(cap.graph.pool()), ref=weakref.ref(cap)))
        graphs._Capture.__init__ = capture
        return self

    def __exit__(self, *exc):
        from orb_slam2_tpu_torch import graphs
        from orb_slam2_tpu_torch.models.device_points import DevicePoints
        graphs._Capture.__init__ = self._init
        DevicePoints._full_upload = self._upload

    def between(self, t0: float, t1: float) -> dict:
        """graph -> bucket -> captures made from ``t0`` to ``t1``."""
        by = {}
        for c in self.caps:
            if t0 <= c["t"] <= t1:
                by.setdefault(c["graph"], {}).setdefault(c["bucket"], 0)
                by[c["graph"]][c["bucket"]] += 1
        return by

    def pools(self) -> dict:
        """What the logged captures hold on the card now, from the
        caching allocator's snapshot (segments by private pool): the
        pools of which a capture is still cached (``live``: MiB reserved
        and allocated in them, by graph) and those whose captures were
        all evicted (``evicted``: freed only by
        ``torch.cuda.empty_cache``), the cached captures and the MiB of
        their static inputs."""
        import torch
        seg = {}
        for s in torch.cuda.memory_snapshot():
            pid = s.get("segment_pool_id")
            if pid is None:
                continue
            r = seg.setdefault(tuple(pid), [0, 0])
            r[0] += s["total_size"]
            r[1] += s["allocated_size"]
        mib = 2.0 ** -20
        by_pool = {}
        for c in self.caps:
            p = by_pool.setdefault(c["pool"], dict(graphs=set(), live=0))
            p["graphs"].add(c["graph"])
            p["live"] += c["ref"]() is not None
        out = dict(live=0, evicted=0, live_mib=0.0, live_alloc_mib=0.0,
                   evicted_mib=0.0, static_mib=0.0, captures=0,
                   by_graph={})
        for pid, p in by_pool.items():
            res, alloc = seg.get(pid, (0, 0))
            if p["live"]:
                out["live"] += 1
                out["live_mib"] += res * mib
                out["live_alloc_mib"] += alloc * mib
                g = "+".join(sorted(p["graphs"]))
                out["by_graph"][g] = out["by_graph"].get(g, 0) + res * mib
            else:
                out["evicted"] += 1
                out["evicted_mib"] += res * mib
        for c in self.caps:
            if c["ref"]() is not None:
                out["captures"] += 1
                out["static_mib"] += c["static_bytes"] * mib
        return out


def memory_mib() -> dict:
    """The caching allocator's allocated and reserved MiB now."""
    import torch
    return dict(alloc=torch.cuda.memory_allocated() / 2 ** 20,
                reserved=torch.cuda.memory_reserved() / 2 ** 20)


def phase_h(device, n_windows: int = None, label: str = "H") -> dict:
    """Path H: bench.py's run in this process, at its full default
    length, through the port's benchmark module
    (``orb_slam2_tpu_torch.bench``: ``bench_config``,
    ``bench_sequence``, ``run_windows``, ``result_line``): 16 warm-up
    frames and two measured windows of 100 over one 1920x1440 sweep
    staged on the card, System(enable_loop_closing=True,
    async_mapping=True), pipelined at depth 3.  Nothing is warmed that
    bench.py does not warm: a capture inside a window is counted there.
    Bars: every measured frame of every window OK; no loop closed on
    the straight sweep; the valid map points' median |z| under
    MEDIAN_Z_BAR; no host sync in the extractions and fused dispatches
    of a measured frame that made no capture (SyncCounter); at most
    graphs.MAXSIZE captures a graph; K1-K3 launched, K1 at least once a
    frame; the last window's p50 at most WALL_RATIO times the first's
    (the JAX scale test's bar on the per-frame wall as the map grows).
    Prints one ``H {json}`` line: bench.py's JSON; per window
    its fps, p50 and p90 frame ms, the captures made inside it by
    graph and bucket (the two largest argument shapes), the map at its
    end (keyframes valid and inserted, valid and allocated points, the
    mapper's queue, the device point store's rows), allocated and
    reserved memory at its end, the tracker's map-lock wait and the
    mapping thread's hold of the lock (LockWaitClock), syncs on its
    frames without a capture; captures in the warm-up and between the
    windows, every capture by frame, graph and bucket, each
    re-allocation of the device point store (frame, rows), what the
    captures hold (``CaptureLog.pools``); memory every 50 frames; the
    link probes unrounded (``rt_ms``, ``up_ms``); peak device memory;
    the kernels' launches over the run.

    Path L-bench (``n_windows=LB_WINDOWS``, ``label="L-bench"``): the
    same run for that many windows (1,216 frames), nothing else
    changed."""
    import torch
    from orb_slam2_tpu_torch import bench, graphs, kernels
    from orb_slam2_tpu_torch.pipeline.system import System
    cfg = bench.bench_config()
    n_warm, n_meas, n_default = bench.bench_lengths()
    n_windows = n_windows or n_default
    n_total = n_warm + n_meas * n_windows
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    frames, poses = bench.bench_sequence(n_total, cfg.cam, device)
    stage_s = time.perf_counter() - t0
    staged = memory_mib()
    system = System(cfg, enable_loop_closing=True, async_mapping=True,
                    device=device)
    clock = LockWaitClock(system.store.lock)
    system.store.lock = clock
    clock.holder = system.map_worker._thread
    syncs = SyncCounter()
    system.factory.start = syncs.wrap(system.factory.start)
    system.tracker._fused_dispatch = syncs.wrap(
        system.tracker._fused_dispatch)
    book = CaptureLog()
    per_frame, curve = {}, []
    track, flush = system.track_monocular_with_pose, system.flush_tracking

    def tracked(image, timestamp, Tcw, next_image=None):
        i = int(round(timestamp * 10))
        book.frame = i
        if i % 50 == 0:
            curve.append(dict(frame=i, **memory_mib()))
        s0, c0 = syncs.counts["tracker"], len(book.caps)
        w0, h0 = clock.wait_s, clock.hold_s
        try:
            return track(image, timestamp, Tcw, next_image=next_image)
        finally:
            per_frame[i] = dict(
                syncs=syncs.counts["tracker"] - s0,
                caps=len(book.caps) - c0,
                wait=clock.wait_s - w0, held=clock.hold_s - h0)
    flushes = []

    def flushed():
        w0, h0 = clock.wait_s, clock.hold_s
        try:
            return flush()
        finally:
            dp = system.store._dev_points
            flushes.append(dict(wait=clock.wait_s - w0,
                                held=clock.hold_s - h0,
                                dev_rows=dp.cap if dp else 0,
                                **memory_mib()))
    system.track_monocular_with_pose = tracked
    system.flush_tracking = flushed
    kernels.reset_launch_counts()
    graphs.reset_stats()
    t0 = time.perf_counter()
    with syncs, book:
        run = bench.run_windows(system, frames, poses, n_warm, n_meas,
                                n_windows)
    run_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    line = bench.result_line(run)
    pools = book.pools()

    wins = []
    for w, win in enumerate(run["windows"]):
        ids = range(n_warm + w * n_meas, n_warm + (w + 1) * n_meas)
        quiet = [i for i in ids if per_frame[i]["caps"] == 0]
        times = np.asarray(win["times"]) * 1e3
        fl = flushes[w]
        wins.append(dict(
            fps=win["fps"], n_ok=win["n_ok"],
            p50_ms=float(np.percentile(times, 50)),
            p90_ms=float(np.percentile(times, 90)),
            max_ms=float(times.max()),
            captures=book.between(win["start"], win["stop"]),
            frames_with_capture=[i for i in ids if per_frame[i]["caps"]],
            syncs_quiet=sum(per_frame[i]["syncs"] for i in quiet),
            n_quiet=len(quiet),
            lock_wait_ms=1e3 * (sum(per_frame[i]["wait"] for i in ids)
                                + fl["wait"]),
            mapper_lock_held_ms=1e3 * (sum(per_frame[i]["held"]
                                           for i in ids) + fl["held"]),
            alloc_mib=fl["alloc"], reserved_mib=fl["reserved"],
            dev_rows=fl["dev_rows"], **win["end"]))
    first = run["windows"][0]["start"]
    last = run["windows"][-1]["stop"]
    in_windows = sum(sum(sum(b.values()) for b in x["captures"].values())
                     for x in wins)
    pts = system.map_points()
    med_z = float(np.median(np.abs(pts[:, 2]))) if len(pts) else None
    loops = system.loop_closer.n_loops_closed
    stats = {k: v["captures"] for k, v in graphs.STATS.items()}
    out = dict(
        bench=line, windows=wins, n_warm=n_warm, n_meas=n_meas,
        captures_warm=sum(c["t"] < first for c in book.caps),
        captures_between=sum(first <= c["t"] <= last for c in book.caps)
        - in_windows,
        captures=[(c["frame"], c["graph"], c["bucket"]) for c in book.caps
                  if c["t"] >= first],
        captures_by_graph=stats, loops_closed=loops, median_z=med_z,
        map_points=len(pts), dev_point_grows=book.grows, memory=curve,
        pools=pools, staged_mib=staged, peak_mib=peak / 2 ** 20,
        allocated_before_mib=mem0 / 2 ** 20, staging_s=stage_s,
        run_s=run_s, rt_ms=run["rt_ms"], up_ms=run["up_ms"],
        launches={k: v for k, v in launches.items() if v})
    log(f"{label} " + json.dumps(out))
    for w, x in enumerate(wins):
        log(f"{label} window {w}: {x['fps']:.2f} fps, {x['n_ok']}/{n_meas} "
            f"OK, p50 {x['p50_ms']:.1f} ms, p90 {x['p90_ms']:.1f} ms, max "
            f"{x['max_ms']:.1f} ms; captures inside it "
            f"{json.dumps(x['captures'])} (frames "
            f"{x['frames_with_capture']}); the tracker waited "
            f"{x['lock_wait_ms']:.1f} ms on the map lock, the mapping "
            f"thread held it {x['mapper_lock_held_ms']:.1f} ms; at its end "
            f"{x['kfs']} keyframes ({x['inserted']} inserted), {x['pts']} "
            f"valid of {x['alloc']} allocated points (device store "
            f"{x['dev_rows']} rows), queue {x['qd']}, memory "
            f"{x['alloc_mib']:.0f} MiB allocated / {x['reserved_mib']:.0f} "
            f"reserved")
    log(f"{label}: bench.py's line {json.dumps(line)}; staged in "
        f"{stage_s:.1f} s, run {run_s:.1f} s; peak device memory "
        f"{peak / 2 ** 20:.0f} MiB ({mem0 / 2 ** 20:.0f} MiB allocated "
        f"before {label}); device point store re-allocations {book.grows}; "
        f"the "
        f"{pools['captures']} cached captures hold {pools['live_mib']:.0f} "
        f"MiB reserved in {pools['live']} pools "
        f"({json.dumps(pools['by_graph'])}), evicted ones "
        f"{pools['evicted_mib']:.0f} MiB")

    for w, x in enumerate(wins):
        check(x["n_ok"] == n_meas, f"{label}: window {w} tracked "
              f"{x['n_ok']}/{n_meas} frames OK")
        check(x["syncs_quiet"] == 0, f"{label}: window {w}'s frames "
              f"without a capture synchronize with the host "
              f"{x['syncs_quiet']} times, sites "
              f"{dict(syncs.sites['tracker'])}")
    check(loops == 0, f"{label}: {loops} loops closed on a straight sweep")
    check(med_z is not None and med_z < MEDIAN_Z_BAR,
          f"{label}: map points off the plane: median |z| {med_z} >= "
          f"{MEDIAN_Z_BAR}")
    for k, n in stats.items():
        check(n <= graphs.MAXSIZE, f"{label}: {k} captured {n} times, "
              f"more than its {graphs.MAXSIZE} kept")
    for k in ("fast_score", "masked_top2_mutual", "masked_top2_epi"):
        check(launches[k] > 0, f"{label}: kernel {k} never launched")
    check(launches["fast_score"] >= n_total, f"{label}: K1 launched "
          f"{launches['fast_score']} times over {n_total} frames")
    check(wins[-1]["p50_ms"] <= WALL_RATIO * wins[0]["p50_ms"],
          f"{label}: the last window's p50 {wins[-1]['p50_ms']:.2f} ms is "
          f"over {WALL_RATIO}x the first's {wins[0]['p50_ms']:.2f}")
    return out


def phase_l(device) -> dict:
    """Path L: tests/test_scale_run.py's run on the card, as the JAX
    test runs it: 640x480, 800 features, 4 levels, pose-prior mode,
    sequential mapping, loop closing on; its world and 500-frame circuit
    rendered on the card frame by frame (the port's renderer), frames
    L_BLACKOUT uniform noise from ``default_rng(0)``; each
    ``track_monocular_with_pose`` timed alone.  Bars: the JAX test's
    (> 90% of frames OK; the noise loses tracking and relocalization
    recovers it; the last 100 frames OK; >= 40 keyframes created and
    culling fired; > 2,000 points; median |z| < 0.12; the median wall
    of the last 80 frames at most WALL_RATIO times that of frames
    60-139); at most graphs.MAXSIZE captures a graph; no host sync in
    the extractions and fused dispatches of a steady frame (OK after an
    OK frame, no keyframe, no capture); K1-K3 launched.  Prints one
    ``L {json}`` line: the states' counts, relocalizations, loops, the
    keyframes and points, median |z|, early and late median walls, every
    capture by frame, graph and bucket, each re-allocation of the device
    point store, allocated and reserved memory every 50 frames, what the
    captures hold, the launches, the stage times (StageTimer)."""
    import torch
    from orb_slam2_tpu_torch import graphs, kernels
    from orb_slam2_tpu_torch.geom.camera import Intrinsics
    from orb_slam2_tpu_torch.ops.extractor import OrbParams
    from orb_slam2_tpu_torch.pipeline.config import SlamConfig
    from orb_slam2_tpu_torch.pipeline.system import System
    from orb_slam2_tpu_torch.utils import synth
    cam = Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640,
                     height=480)
    cfg = SlamConfig(cam=cam, orb=OrbParams(n_features=800, n_levels=4),
                     fps=10.0, pose_prior=True, init_min_matches=60,
                     init_min_triangulated=40, init_min_tracked_after_ba=60)
    world = synth.make_world(seed=5, scale=60.0, tex_size=2048,
                             device=device)
    poses = synth.loop_trajectory(L_FRAMES, radius=16.0)
    rng = np.random.default_rng(0)
    system = System(cfg, enable_loop_closing=True, device=device)
    syncs = SyncCounter()
    system.factory.start = syncs.wrap(system.factory.start)
    system.tracker._fused_dispatch = syncs.wrap(
        system.tracker._fused_dispatch)
    book = CaptureLog()
    kernels.reset_launch_counts()
    graphs.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    states, walls, fsyncs, fcaps, kfs, curve = [], [], [], [], [], []
    t_run = time.perf_counter()
    with syncs, book:
        for i, T in enumerate(poses):
            if i in L_BLACKOUT:
                img = torch.from_numpy(rng.uniform(
                    0, 255, (480, 640)).astype(np.float32)).to(device)
            else:
                img = synth.render(world, cam, T)
            if i % 50 == 0:
                curve.append(dict(frame=i, **memory_mib()))
            book.frame = i
            s0, c0, k0 = (syncs.counts["tracker"], len(book.caps),
                          len(system.store.kfs))
            t0 = time.perf_counter()
            system.track_monocular_with_pose(img, i * 0.1, T)
            walls.append(time.perf_counter() - t0)
            states.append(system.state.name)
            fsyncs.append(syncs.counts["tracker"] - s0)
            fcaps.append(len(book.caps) - c0)
            kfs.append(len(system.store.kfs) - k0)
            if i % 25 == 0 or i in L_BLACKOUT:
                log(f"L frame {i}: {states[-1]} {walls[-1] * 1e3:.1f} ms, "
                    f"{len(system.store.kfs)} keyframes, "
                    f"{system.store.n_valid_points()} points, captures "
                    f"{fcaps[-1]}")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    curve.append(dict(frame=L_FRAMES, **memory_mib()))
    launches = dict(kernels.LAUNCHES)
    pools = book.pools()
    stats = {k: v["captures"] for k, v in graphs.STATS.items()}
    store = system.store
    pts = system.map_points()
    med_z = float(np.median(np.abs(pts[:, 2]))) if len(pts) else None
    w = np.asarray(walls) * 1e3
    early, late = float(np.median(w[60:140])), float(np.median(w[-80:]))
    steady = [i for i in range(1, L_FRAMES) if states[i] == "OK"
              and states[i - 1] == "OK" and not fcaps[i] and not kfs[i]]
    bad = [(i, fsyncs[i]) for i in steady if fsyncs[i]]
    reloc = int(system.tracker.last_reloc_frame_id)
    lost = (any(states[i] != "OK" for i in L_BLACKOUT)
            or states[L_BLACKOUT[0] + 1] != "OK")
    recovered = (reloc >= L_BLACKOUT[0]
                 and states[L_BLACKOUT[-1] + 10] == "OK")
    created, valid = len(store.kfs), store.n_valid_keyframes()
    n_ok = states.count("OK")
    out = dict(
        n_ok=n_ok, n_lost=states.count("LOST"),
        states_blackout={i: states[i] for i in range(
            L_BLACKOUT[0] - 1, L_BLACKOUT[-1] + 4)},
        reloc_frame=reloc, loops_closed=system.loop_closer.n_loops_closed,
        kfs_created=created, kfs_valid=valid,
        points=store.n_valid_points(), points_alloc=store.n_points(),
        median_z=med_z, early_ms=early, late_ms=late,
        wall_ratio=late / early, max_ms=float(w.max()),
        captures=[(c["frame"], c["graph"], c["bucket"])
                  for c in book.caps],
        captures_by_graph=stats, dev_point_grows=book.grows, memory=curve,
        pools=pools, steady_frames=len(steady),
        steady_syncs=sum(n for _, n in bad), run_s=run_s,
        peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
        launches={k: v for k, v in launches.items() if v},
        stages={k: [n, round(1e3 * t, 3)] for k, (n, t, _) in sorted(
            {**system.tracker.timer.report(),
             **system.mapper.timer.report()}.items())})
    log("L " + json.dumps(out))
    log(f"L: {n_ok}/{L_FRAMES} OK, relocalized at frame {reloc}, "
        f"{out['loops_closed']} loops, {created} keyframes created / "
        f"{valid} valid, {out['points']} points, median |z| {med_z}, wall "
        f"{early:.2f} -> {late:.2f} ms ({late / early:.2f}x), "
        f"{len(book.caps)} captures, memory {curve[0]} -> {curve[-1]}, run "
        f"{run_s:.1f} s")
    check(n_ok > 0.9 * L_FRAMES, f"L: tracked {n_ok}/{L_FRAMES}")
    check(lost, f"L: the noise frames did not lose tracking: "
          f"{out['states_blackout']}")
    check(recovered, f"L: relocalization did not recover after the noise "
          f"(last relocalization at frame {reloc}): "
          f"{out['states_blackout']}")
    check(all(s == "OK" for s in states[-100:]),
          "L: a frame of the last 100 is not OK")
    check(created >= 40, f"L: only {created} keyframes created")
    check(valid < created, "L: keyframe culling never fired")
    check(out["points"] > 2000, f"L: only {out['points']} points")
    check(med_z is not None and med_z < 0.12,
          f"L: map points off the plane: median |z| {med_z}")
    check(late <= WALL_RATIO * early, f"L: the per-frame wall grew with "
          f"the map: {early:.2f} -> {late:.2f} ms")
    for k, n in stats.items():
        check(n <= graphs.MAXSIZE, f"L: {k} captured {n} times, more than "
              f"its {graphs.MAXSIZE} kept")
    check(not bad, f"L: steady frames synchronize with the host: {bad}, "
          f"sites {dict(syncs.sites['tracker'])}")
    for k in ("fast_score", "masked_top2_mutual", "masked_top2_epi"):
        check(launches.get(k, 0) > 0, f"L: kernel {k} never launched")
    return out


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


# the loop closer's programs (the JAX package's jit sites on its path) by
# label: the LoopCloser attribute that holds its CUDA graph in this
# checkout's port (None: the module function is the entry point, which
# replays its solver's step programs), and the module function an older
# checkout's loop closer calls eagerly (--tree)
LOOP_PROGRAMS = (
    ("bow_match", "_match_bow", "matching.search", "search_descriptors"),
    ("sim3_ransac", "_ransac", "optim.sim3_ransac", "sim3_ransac"),
    ("search_by_sim3", "_match_sim3", "matching.search", "search_by_sim3"),
    ("optimize_sim3", None, "optim.sim3_opt", "optimize_sim3"),
    ("search_by_projection_sim3", "_match_proj", "matching.search",
     "search_by_projection_sim3"),
    ("essential_graph", None, "optim.pose_graph", "optimize_pose_graph"),
    ("global_ba", None, "optim.ba", "bundle_adjust"),
)
# global BA where run_global_ba shards over several cards
SHARDED_GBA = ("global_ba", None, "parallel",
               "distributed_bundle_adjust_sharded_points")
# their graphs by graphs.STATS name
LOOP_GRAPHS = ("loop_bow_match", "sim3_ransac", "search_by_sim3",
               "sim3_round", "search_by_projection_sim3", "pose_graph_step",
               "pose_graph_cost", "ba_begin", "ba_step", "ba_finish")
LOOP_STAGES = ("loop/bow", "loop/detect", "loop/sim3", "loop/correct",
               "loop/essential_graph", "loop/global_ba")


def _leaves(out) -> tuple:
    import torch
    if isinstance(out, torch.Tensor):
        return (out,)
    return tuple(x for o in out for x in _leaves(o))


def runtime_counts(fn) -> dict:
    """The CUDA runtime calls ``fn()`` makes, from a torch.profiler trace
    (CUDA activity): kernel launches, graph launches, copies and fills,
    and synchronizations."""
    import tempfile
    import torch
    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return runtime_split(events)


def runtime_split(events) -> dict:
    out = dict(launches=0, graph_launches=0, copies=0, syncs=0)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "cuda_runtime":
            continue
        n = e["name"]
        if "LaunchKernel" in n:
            out["launches"] += 1
        elif "GraphLaunch" in n:
            out["graph_launches"] += 1
        elif "Memcpy" in n or "Memset" in n:
            out["copies"] += 1
        elif "Synchronize" in n:
            out["syncs"] += 1
    return out


class LoopWatch:
    """Path B's loop keyframe, split.  Wraps ``LoopCloser.
    process_keyframe`` (the loop closer's work on one keyframe: its host
    syncs, by SyncCounter, under role "loop", its stage times and host
    time) and each program of LOOP_PROGRAMS (its syncs under its label,
    its time between two ``torch.cuda.synchronize()`` on the host clock,
    its arguments and outputs); programs called outside the loop closer
    (the initialization's BA) are passed through.  Keeps the calls of
    the first keyframe that closes a loop (``loop_kf``) and each
    program's first call's time in the run (``first_ms``).  With
    ``profile``, each keyframe's loop-closer work runs under
    torch.profiler, and the loop keyframe's runtime calls are kept
    (``loop_kf["runtime"]``).  On a host with several cards global BA
    is ``run_global_ba``'s sharded solve (SHARDED_GBA).  ``label``
    names the path in what it prints."""

    def __init__(self, system, syncs, profile: bool = False,
                 label: str = "B"):
        import importlib
        from orb_slam2_tpu_torch import parallel
        self.lc = lc = system.loop_closer
        self.syncs = syncs
        self.profile = profile
        self.label = label
        self.graphed = hasattr(lc, "_ransac")
        self.sharded = len(parallel.local_devices(system.store.device)) > 1
        self.programs = tuple(
            SHARDED_GBA if self.sharded and p[0] == "global_ba" else p
            for p in LOOP_PROGRAMS)
        self.first_ms = {}
        self.loop_kf = None
        self._cur = None
        self._restore = []
        for label, attr, mod, name in self.programs:
            if self.graphed and attr is not None:
                setattr(lc, attr, self._program(label, getattr(lc, attr)))
            else:
                m = importlib.import_module(f"orb_slam2_tpu_torch.{mod}")
                self._restore.append((m, name, getattr(m, name)))
                setattr(m, name, self._program(label, getattr(m, name)))
        counted = syncs.wrap(lc.process_keyframe, "loop")

        def process_keyframe(kid):
            import torch
            roles = ("loop",) + tuple(p[0] for p in self.programs)
            self._cur = {p[0]: [] for p in self.programs}
            n0 = lc.n_loops_closed
            s0 = {r: syncs.counts[r] for r in roles}
            st0 = {k: lc.timer.total.get(k, 0.0) for k in LOOP_STAGES}
            prof = None
            if profile:
                torch.cuda.synchronize()
                prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                prof.start()
            t0 = time.perf_counter()
            try:
                return counted(kid)
            finally:
                ms = (time.perf_counter() - t0) * 1e3
                calls, self._cur = self._cur, None
                closed = lc.n_loops_closed > n0 and self.loop_kf is None
                runtime = None
                if prof is not None:
                    torch.cuda.synchronize()
                    prof.stop()
                    if closed:
                        import tempfile
                        with tempfile.TemporaryDirectory() as root:
                            path = os.path.join(root, "trace.json")
                            prof.export_chrome_trace(path)
                            with open(path) as f:
                                runtime = runtime_split(
                                    json.load(f)["traceEvents"])
                if closed:
                    self.loop_kf = dict(
                        kid=kid, ms=ms, calls=calls, runtime=runtime,
                        syncs={r: syncs.counts[r] - s0[r] for r in roles},
                        stages={k: (lc.timer.total.get(k, 0.0) - v) * 1e3
                                for k, v in st0.items()})
        lc.process_keyframe = process_keyframe
        # the mapper calls the loop closer through the hook System wired
        system.mapper.on_keyframe_processed = process_keyframe

    def _program(self, label, fn):
        import torch
        counted = self.syncs.wrap(fn, label, nested=True)

        def call(*args, **kwargs):
            if self._cur is None:
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = counted(*args, **kwargs)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            self.first_ms.setdefault(label, ms)
            self._cur[label].append(dict(fn=fn, args=args, kwargs=kwargs,
                                         out=out, ms=ms))
            return out
        return call

    def restore(self):
        for m, name, fn in self._restore:
            setattr(m, name, fn)

    def report(self, graphs) -> dict:
        """Prints the loop keyframe's split: stage times, host syncs
        (the loop closer's and each program's), each program's calls,
        their time, its first call's time in the run and a warm call's
        (the last call again, twice, the second timed), a warm call's
        runtime calls (torch.profiler), and each graph's captures and
        replays (bar: at most graphs.MAXSIZE)."""
        import torch
        lk = self.loop_kf
        check(lk is not None, f"{self.label}: no keyframe closed a loop")
        log(f"{self.label} loop keyframe {lk['kid']}: the loop closer's work "
            f"{lk['ms']:.1f} ms (host clock); stages, ms "
            f"{json.dumps({k: round(v, 1) for k, v in lk['stages'].items()})}"
            f"; host syncs {json.dumps(lk['syncs'])} (role loop: outside "
            f"the programs)")
        if lk["runtime"] is not None:
            log(f"{self.label} loop keyframe {lk['kid']}, torch.profiler "
                f"over the loop closer's work: {json.dumps(lk['runtime'])}")
        split = {}
        for label, *_ in self.programs:
            calls = lk["calls"][label]
            if not calls:
                continue
            last = calls[-1]
            warm = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                last["fn"](*last["args"], **last["kwargs"])
                torch.cuda.synchronize()
                warm.append((time.perf_counter() - t0) * 1e3)
            rt = runtime_counts(
                lambda: last["fn"](*last["args"], **last["kwargs"]))
            split[label] = dict(
                calls=len(calls), ms=round(sum(c["ms"] for c in calls), 2),
                first_ms=round(self.first_ms[label], 2),
                warm_ms=round(warm[1], 2), warm_runtime=rt)
            log(f"{self.label} loop keyframe, {label}: "
                f"{json.dumps(split[label])}")
        if graphs is not None and self.graphed:
            stats = {k: dict(graphs.STATS.get(k, {})) for k in LOOP_GRAPHS}
            log(f"{self.label}: the loop programs' graphs (captures, "
                f"replays) over the run {json.dumps(stats)}")
            for k, v in stats.items():
                n_cap = v.get("captures", 0)
                check(n_cap <= graphs.MAXSIZE, f"{self.label}: {k} captured "
                      f"{n_cap} times, more than its {graphs.MAXSIZE} kept")
        return split

    def check_graphs(self) -> None:
        """Phase G on path B's first loop correction: every program call
        of the loop keyframe, made again, against the same call with
        every graph run eagerly (``graphs.Graphed.__call__`` patched to
        call its function), bit for bit, and against the output the run
        got (a sharded global BA against its ``eager=True`` call, the
        one-call core on every shard); then each program's last call
        under ``torch.cuda.set_sync_debug_mode("error")`` (a warm call
        waits for the card nowhere)."""
        import torch
        from orb_slam2_tpu_torch import graphs
        lk = self.loop_kf
        checked = {}
        for prog in self.programs:
            label = prog[0]
            calls = lk["calls"][label]
            for k, c in enumerate(calls):
                again = _leaves(c["fn"](*c["args"], **c["kwargs"]))
                saved = graphs.Graphed.__call__
                graphs.Graphed.__call__ = lambda g, *a: g.fn(*a)
                eager = {"eager": True} if prog == SHARDED_GBA else {}
                try:
                    want = _leaves(c["fn"](*c["args"], **c["kwargs"],
                                           **eager))
                finally:
                    graphs.Graphed.__call__ = saved
                torch.cuda.synchronize()
                for j, (a, b, o) in enumerate(zip(again, want,
                                                  _leaves(c["out"]))):
                    check(torch.equal(a, b) and torch.equal(o, b),
                          f"G: B's {label} differs from its eager call in "
                          f"output {j} (call {k} of the loop keyframe)")
            if not calls:
                continue
            c = calls[-1]
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                c["fn"](*c["args"], **c["kwargs"])
            except RuntimeError as e:
                raise SmokeFailure(f"G: a warm call of B's {label} "
                                   f"synchronizes with the host: {e}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            checked[label] = (len(calls), [tuple(a.shape) for a in c["args"]
                                           if isinstance(a, torch.Tensor)][:2])
        missing = [p[0] for p in self.programs if p[0] not in checked]
        check(not missing, f"G: B's loop keyframe made no call of {missing}")
        log(f"G: path B's loop programs bit-exact against their eager "
            f"calls on the loop keyframe, and a warm call of each with no "
            f"host sync; calls and first shapes {json.dumps(checked)}")


def loop_world(device, ground: str = "plane"):
    """Path B's ground (``"plane"``): a square texture that holds the
    circle plus the footprint's half-diagonal (15 units at height 12)
    and a unit of margin, at bench.py's 120 px per unit; with
    ``"height"``, path B-height's: the same texture over a height field
    made as the port's ``synth.make_height_world`` makes its field
    (seed + 12345, 28x28 cells bicubic to 768x768, scaled to BH_AMP
    units), spread over the texture's extent.  ``make_height_world``
    takes no texture shape and anchors its texture's cells to a square
    ``tex_size``, so it cannot give path B's texture itself."""
    import torch
    import torch.nn.functional as F
    from orb_slam2_tpu_torch.utils import synth
    side = int(np.ceil(2 * (LOOP_RADIUS + 16.0) * 120.0 / 128)) * 128
    world = synth.make_world(seed=LOOP_SEED, tex_size=4096, scale=120.0,
                             tex_shape=(side, side), device=device)
    if ground == "plane":
        return world
    rng = np.random.default_rng(LOOP_SEED + 12345)
    h = torch.as_tensor(rng.uniform(-1, 1, (BH_CELLS, BH_CELLS))
                        .astype(np.float32), device=device)
    h = F.interpolate(h[None, None], size=(BH_SIZE, BH_SIZE),
                      mode="bicubic", align_corners=False)[0, 0]
    h = BH_AMP * h / torch.clamp(h.abs().max(), min=1e-9)
    return synth.HeightWorld(
        texture=world.texture, heights=h, scale=world.scale,
        h_scale=BH_SIZE / (side / world.scale), origin=world.origin,
        h_origin=np.array([BH_SIZE / 2, BH_SIZE / 2], np.float32))


def phase_loop(device, cfg, trail: list = None, record: dict = None,
               watch: bool = False, profile: bool = False,
               ground: str = "plane", vocab=None, label: str = "B",
               keep: dict = None):
    """Path B: a drifted circuit at bench width, bench.py's
    configuration with sequential tracking and mapping, so that whether
    the loop fires does not depend on thread timing or pipeline lag.
    ``trail`` collects record_trail's stage digests; ``record`` receives
    path F's problems from the first loop correction: the global BA's
    inputs (``ba``), the essential graph's (``pose_graph``) and the map
    as run_global_ba found it (``store``, an ``interop`` snapshot).
    ``watch``: the loop keyframe's split (``LoopWatch``), and, where the
    port graphs the loop programs and the path is B, phase G's check of
    them; ``profile``: the loop keyframe's runtime calls too (timings
    then include the profiler's cost).  ``ground``: ``loop_world``'s
    (``"height"``: rendered by ``synth.render_height``); ``vocab``: the
    live vocabulary (``System(..., vocab=)``; None trains one online);
    ``label`` names the path in what it prints; with ``watch``, ``keep``
    receives the System, the ATEs and the loop keyframe."""
    import dataclasses
    import torch
    from orb_slam2_tpu_torch import interop, kernels
    from orb_slam2_tpu_torch.optim import ba, pose_graph
    from orb_slam2_tpu_torch.pipeline.system import System
    from orb_slam2_tpu_torch.pipeline.tracking import TrackState
    from orb_slam2_tpu_torch.utils import synth
    true, fed = loop_circuit()
    world = loop_world(device, ground)
    render = synth.render_height if ground == "height" else synth.render
    frames = [render(world, cfg.cam, T) for T in true]
    torch.cuda.synchronize()
    lcfg = dataclasses.replace(cfg, loop_min_kfs_since_last=6,
                               pipelined_tracking=False)
    system = System(lcfg, enable_loop_closing=True, vocab=vocab,
                    device=device)
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
    syncs = lw = None
    if watch:
        from orb_slam2_tpu_torch import graphs
        graphs.reset_stats()
        syncs = SyncCounter()
        lw = LoopWatch(system, syncs, profile=profile, label=label)
        syncs.__enter__()
    from orb_slam2_tpu_torch import parallel
    solvers = (ba.bundle_adjust, pose_graph.optimize_pose_graph,
               parallel.distributed_bundle_adjust_sharded_points)
    if record is not None:
        in_gba = [False]

        def host(args):
            return [a.cpu().numpy() if isinstance(a, torch.Tensor) else a
                    for a in args]

        def rec_ba(*args, **kwargs):
            if in_gba[0] and "ba" not in record:
                record["ba"] = (host(args), dict(kwargs))
            return solvers[0](*args, **kwargs)

        def rec_pg(*args, **kwargs):
            record.setdefault("pose_graph", (host(args), dict(kwargs)))
            return solvers[1](*args, **kwargs)

        def rec_sharded(mesh, *args, **kwargs):
            # run_global_ba's sharded branch (several cards): the same
            # problem without the single-device padding, and its result
            first = in_gba[0] and "ba" not in record
            res = solvers[2](mesh, *args, **kwargs)
            if first:
                record["ba"] = (host(args), dict(kwargs))
                record["gba_devices"] = [str(mesh.device_of(d))
                                         for d in mesh.local_shards()]
                record["gba_result"] = type(res)(*(t.cpu() for t in res))
            return res

        gba = lc.run_global_ba

        def rec_gba(*args, **kwargs):
            if "store" not in record:
                record["store"] = interop.mapstore_state(system.store)
                record["cfg"] = lcfg
            in_gba[0] = True
            try:
                return gba(*args, **kwargs)
            finally:
                in_gba[0] = False
        lc.run_global_ba = rec_gba
        ba.bundle_adjust, pose_graph.optimize_pose_graph = rec_ba, rec_pg
        parallel.distributed_bundle_adjust_sharded_points = rec_sharded
    frame_no = [0]
    if trail is not None:
        record_trail(system, trail, frame_no)
    kernels.reset_launch_counts()
    states, frame_ms, loops = [], [], []
    try:
        for i, (img, Tf) in enumerate(zip(frames, fed)):
            frame_no[0] = i
            t0 = time.perf_counter()
            system.track_monocular_with_pose(img, i * 0.1, Tf)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            states.append(system.state)
            loops.append(system.loop_closer.n_loops_closed)
            log(f"{label} frame {i:2d}: {system.state.name:15s} "
                f"kfs={system.store.n_valid_keyframes():3d} "
                f"loops={system.loop_closer.n_loops_closed} "
                f"{frame_ms[-1]:9.1f} ms")
        system.shutdown()
    finally:
        (ba.bundle_adjust, pose_graph.optimize_pose_graph,
         parallel.distributed_bundle_adjust_sharded_points) = solvers
        if watch:
            syncs.__exit__(None, None, None)
            lw.restore()
    launches = dict(kernels.LAUNCHES)
    n_ok = sum(s == TrackState.OK for s in states)
    last = {k: v for k, v in (lc.last_loop or {}).items()
            if k != "loop_connections"}
    log(f"{label}: {n_ok}/{len(true)} frames OK, {lc.n_loops_closed} loops "
        f"closed, last {last}")
    check(n_ok >= LOOP_MIN_OK * len(true),
          f"{label}: only {n_ok}/{len(true)} frames OK")
    check(lc.n_loops_closed >= 1, f"{label}: the loop never closed")
    check(lc.last_loop["n_matched"] >= lcfg.loop_min_total_matches,
          f"{label}: {lc.last_loop['n_matched']} loop matches < "
          f"{lcfg.loop_min_total_matches}")
    pts = system.map_points()
    check(len(pts) > 0 and bool(np.isfinite(pts).all()),
          f"{label}: map points missing or not finite")
    check(all(np.isfinite(kf.Tcw).all() for kf in system.store.kfs
              if kf.valid), f"{label}: a keyframe pose is not finite")
    ate = kf_ate(system.store, true)
    ate_prior = kf_ate(system.store, true, poses=fed)
    log(f"{label}: keyframe ATE {ate:.4f} after loop correction, "
        f"{ate_prior:.4f} for the fed priors at the same "
        f"{system.store.n_valid_keyframes()} keyframes (Sim3-aligned); at "
        f"the first loop, after "
        + ", ".join(f"{k} {v:.4f}" for k, v in stage_ate[:3]))
    check(ate < ate_prior, f"{label}: corrected keyframe ATE {ate:.4f} is not "
          f"below the priors' {ate_prior:.4f}")

    for name in ("fast_score", "masked_top2_mutual", "masked_top2_epi"):
        check(launches[name] > 0, f"{label}: kernel {name} never launched")
    log(f"{label}: kernel launches {json.dumps(launches)}")
    log(f"{label}: loop-closing stages (host clock):\n" + lc.timer.summary())
    first_loop = next(i for i, n in enumerate(loops) if n >= 1)
    log(f"{label}: median frame {np.median(frame_ms):.1f} ms, max "
        f"{np.max(frame_ms):.1f} ms; the first loop closed on frame "
        f"{first_loop}, in {frame_ms[first_loop]:.1f} ms (host clock, the "
        f"frame's tracking and its keyframe's mapping included)")
    if record is not None:
        record["b"] = dict(ate=ate, ate_prior=ate_prior, n_ok=n_ok,
                           n_frames=len(true), loop=last,
                           first_loop_ms=frame_ms[first_loop])
    if watch:
        from orb_slam2_tpu_torch import graphs
        lw.report(graphs)
        if keep is not None:
            keep.update(system=system, ate=ate, ate_prior=ate_prior,
                        stage_ate=stage_ate, loop_kf=lw.loop_kf["kid"])
        if lw.graphed and label == "B":
            lw.check_graphs()
    return launches


def graph_captures(label: str, names=None) -> dict:
    """Each graph's captures and replays since the last
    ``graphs.reset_stats()`` (``names``: those graphs only); bar: at
    most ``graphs.MAXSIZE`` captures a graph."""
    from orb_slam2_tpu_torch import graphs
    stats = {k: dict(captures=v["captures"], replays=v["replays"])
             for k, v in graphs.STATS.items()
             if names is None or k in names}
    log(f"{label}: captures and replays by graph over the run "
        f"{json.dumps(stats)}")
    for k, v in stats.items():
        check(v["captures"] <= graphs.MAXSIZE, f"{label}: {k} captured "
              f"{v['captures']} times, more than its {graphs.MAXSIZE} kept")
    return stats


def phase_b_height(device, cfg) -> dict:
    """Path B-height: path B over a height field (``loop_world(...,
    "height")``: B's texture on tests/test_loop_proof.py's field,
    BH_AMP units), rendered by ``synth.render_height``.  Bars: path B's
    (a loop closed, 0.7 of the frames OK, finite map and poses, KF ATE
    after the corrections below the drifted priors' at the same
    keyframes), std(map z) > BH_Z_STD and at most ``graphs.MAXSIZE``
    captures a graph.  Prints B's lines (the KF ATE at each stage of the
    first correction, the loop keyframe's split), the map's points and
    keyframes and their spread in z."""
    keep = {}
    launches = phase_loop(device, cfg, watch=True, ground="height",
                          label="B-height", keep=keep)
    system = keep["system"]
    pts = system.map_points()
    z_std = float(np.std(pts[:, 2]))
    out = dict(points=len(pts), keyframes=system.store.n_valid_keyframes(),
               z_std=z_std, z_median_abs=float(np.median(np.abs(pts[:, 2]))),
               ate=keep["ate"], ate_prior=keep["ate_prior"],
               stage_ate=keep["stage_ate"], loop_kf=keep["loop_kf"],
               launches=launches)
    out["captures"] = graph_captures("B-height")
    log("B-height " + json.dumps(out))
    check(z_std > BH_Z_STD, f"B-height: std(map z) {z_std:.4f} <= "
          f"{BH_Z_STD}: the map collapsed to a plane")
    return out


def phase_b_1m(device, cfg) -> dict:
    """Path B-1M: path B with a 10^6-word ORBvoc as the live vocabulary:
    ``synthetic_orbvoc(k=10, L=6, seed=7)`` written with
    ``save_orbvoc_binary`` to a temporary directory, loaded with
    ``load_orbvoc_binary`` and given as ``System(..., vocab=)``.  Bars:
    the JAX test's (the load under B1M_LOAD_S, a warm BoW transform of
    the loop keyframe's descriptors under B1M_TRANSFORM_S on the host
    clock), path B's (a loop closed, KF ATE below the priors'), a warm
    descent with no host sync, at most ``graphs.MAXSIZE`` captures of
    ``bow_transform``.  Prints the generation, write and load times,
    the warm descent by CUDA events (the call, its graph's replay alone,
    the copies into its static inputs alone), the bytes a replay copies
    into them and what its captures hold (their static inputs, their
    pool), the inverted file's size, the loop-candidate query's time
    and B's lines (the loop keyframe's split)."""
    import tempfile
    import torch
    from orb_slam2_tpu_torch.io import orbvoc
    from orb_slam2_tpu_torch.models import vocabulary
    t0 = time.perf_counter()
    voc = orbvoc.synthetic_orbvoc(k=B1M_K, L=B1M_LEVELS, seed=B1M_SEED)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "ORBvoc.bin")
        orbvoc.save_orbvoc_binary(voc, path)
        t2 = time.perf_counter()
        voc = orbvoc.load_orbvoc_binary(path)
        t3 = time.perf_counter()
        file_bytes = os.path.getsize(path)
    out = dict(words=voc.n_words, node_level=voc.node_level,
               file_bytes=file_bytes, generate_s=t1 - t0, write_s=t2 - t1,
               load_s=t3 - t2)
    log(f"B-1M: ORBvoc k={voc.k} L={voc.levels}: {voc.n_words} words, "
        f"{file_bytes} B file; generated {out['generate_s']:.2f} s, "
        f"written {out['write_s']:.2f} s, loaded {out['load_s']:.2f} s")
    check(voc.n_words == B1M_K ** B1M_LEVELS,
          f"B-1M: {voc.n_words} words loaded")
    check(out["load_s"] < B1M_LOAD_S,
          f"B-1M: the load took {out['load_s']:.1f} s")
    keep = {}
    with CaptureLog() as caps:
        launches = phase_loop(device, cfg, watch=True, vocab=voc,
                              label="B-1M", keep=keep)
    system = keep["system"]
    pr = system.place_rec
    check(pr.vocab is voc, "B-1M: the system's vocabulary is not the "
          "loaded ORBvoc")
    out.update(ate=keep["ate"], ate_prior=keep["ate_prior"],
               loop_kf=keep["loop_kf"], launches=launches,
               captures=graph_captures("B-1M", ("bow_transform",)))
    # the warm descent of the loop keyframe's descriptors
    desc = system.store.kfs[keep["loop_kf"]].frame.dev("desc")
    centers = voc.device_arrays(desc.device)
    voc.transform(desc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    words, _ = voc.transform(desc)
    words.cpu()
    out["transform_host_ms"] = (time.perf_counter() - t0) * 1e3
    check(out["transform_host_ms"] < B1M_TRANSFORM_S * 1e3,
          f"B-1M: a warm BoW transform took "
          f"{out['transform_host_ms']:.1f} ms")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        voc.transform(desc)
    except RuntimeError as e:
        raise SmokeFailure(f"B-1M: a warm descent synchronizes with the "
                           f"host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    cap = next(reversed(vocabulary._transform_graph._captures.values()))
    args = (desc, voc.k, voc.node_level, *centers)

    def copies():
        for s, a in zip(cap.static, args):
            if isinstance(s, torch.Tensor):
                s.copy_(a)
    out.update(
        rows=desc.shape[0],
        transform_ms=cuda_ms(lambda: voc.transform(desc)),
        replay_ms=cuda_ms(cap.graph.replay),
        copies_ms=cuda_ms(copies),
        replay_copy_bytes=sum(s.numel() * s.element_size()
                              for s in cap.static
                              if isinstance(s, torch.Tensor)),
        center_bytes=sum(c.numel() * c.element_size() for c in centers))
    mib = 2.0 ** -20
    held = [c for c in caps.caps
            if c["graph"] == "bow_transform" and c["ref"]() is not None]
    out.update(
        transform_captures=len(held),
        transform_static_mib=sum(c["static_bytes"] for c in held) * mib,
        transform_pool_mib=caps.pools()["by_graph"].get("bow_transform",
                                                        0.0))
    # the inverted file and a loop query against it
    bows = pr.db.bow
    out.update(db_keyframes=len(bows),
               db_postings=sum(len(v) for v in bows.values()),
               db_words=len(set().union(*map(set, bows.values()))))
    kid = keep["loop_kf"]
    min_score = pr.min_covisible_score(kid)
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        cands = pr.loop_candidates(kid, min_score)
        times.append((time.perf_counter() - t0) * 1e3)
    out.update(query_ms=float(np.median(times)), query_candidates=cands)
    log("B-1M " + json.dumps(out))
    return out


def phase_g_eigh(device) -> dict:
    """Phase G on the card's eigensolvers, on the EPnP problem the port
    met at frame 27 of tests/test_loop_upstream.py's circuit on the CPU
    (FRAME27; LAPACK raised there before the CPU branch gave degenerate
    blocks NaN): Horn's 4x4 matrices of its first beta approximation
    through ``horn.top_eigvec`` (float64 Jacobi sweeps on the card) must
    give NaN in exactly the four NaN blocks, raise nothing and return;
    its other vectors must be LAPACK's in float64 up to sign within
    float32's perturbation bound (the gap times the top eigengap,
    relative to the block's largest eigenvalue, under 1e-6).  Then the
    whole RANSAC on the card through the graphed ``pnp_ransac``, twice
    (a capture and a replay): no error, and no pose (5 inliers of the
    10 asked on the CPU).  Prints the blocks, the gaps and the times
    (host clock: a first and a warm call)."""
    import torch
    from orb_slam2_tpu_torch.geom import horn
    from orb_slam2_tpu_torch.pipeline import relocalization
    here = os.path.dirname(os.path.abspath(__file__))
    with np.load(os.path.join(here, FRAME27)) as d:
        prob = {k: d[k] for k in d.files}
    N = torch.from_numpy(prob["horn_N"]).to(device)
    ms = []
    for _ in range(2):          # the first call and a warm one
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = horn.top_eigvec(N)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    v = v.cpu().numpy()
    bad = ~np.isfinite(prob["horn_N"]).all((-1, -2))
    check(np.where(bad)[0].tolist() == FRAME27_NAN, "G: the recorded "
          f"batch's non-finite blocks are {np.where(bad)[0].tolist()}")
    nan = np.isnan(v).all(-1)
    check((nan == bad).all() and np.isfinite(v[~bad]).all(),
          f"G: horn.top_eigvec on the card gives NaN in blocks "
          f"{np.where(np.isnan(v).any(-1))[0].tolist()}, not exactly in "
          f"{FRAME27_NAN}")
    w64, v64 = torch.linalg.eigh(torch.from_numpy(
        prob["horn_N"][~bad]).double())
    w64, ref = w64.numpy(), v64[..., -1].numpy()
    got = v[~bad].astype(np.float64)
    err = np.abs(got * np.sign((got * ref).sum(-1, keepdims=True))
                 - ref).max(-1)
    gap = (w64[:, -1] - w64[:, -2]) / np.abs(w64).max(-1)
    check((err * gap).max() < 1e-6, f"G: horn.top_eigvec on the card is "
          f"{err.max():.3g} from LAPACK's (gap x eigengap "
          f"{(err * gap).max():.3g})")
    args = [torch.from_numpy(prob[k]).to(device) for k in
            ("pts_w", "uv", "inv_sigma2", "valid", "samples")]
    fx = fy = 450.0
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = relocalization.pnp_graph(*args, fx, fy, 320.0, 240.0, 10)
        ok, n_inl = bool(res.ok), int(res.n_inliers)
        runs.append(dict(ok=ok, n_inliers=n_inl,
                         ms=(time.perf_counter() - t0) * 1e3))
        check(not ok, f"G: pnp_ransac on the card found a pose on the "
              f"frame-27 problem ({n_inl} inliers); the CPU finds none")
    out = dict(nan_blocks=np.where(nan)[0].tolist(),
               top_eigvec_ms=dict(first=ms[0], warm=ms[1]),
               max_vector_gap=float(err.max()),
               max_gap_times_eigengap=float((err * gap).max()),
               pnp_ransac=runs)
    log("G: the card's eigensolvers on the frame-27 EPnP batch "
        + json.dumps(out))
    return out


def run_length(states: list) -> str:
    """Frame states as runs: ``OK 1-25, LOST 26-49, ...``."""
    runs = []
    for i, s in enumerate(states):
        if runs and runs[-1][0] == s:
            runs[-1][2] = i
        else:
            runs.append([s, i, i])
    return ", ".join(f"{s} {a}" if a == b else f"{s} {a}-{b}"
                     for s, a, b in runs)


def best_frames(world, cam, true, seed: int, sigma: float, device) -> list:
    """The poses ``true`` rendered on the card, with sensor noise of
    ``sigma`` grey levels from numpy's ``default_rng(seed)`` (one draw a
    frame in order) added and clipped to [0, 255], as the JAX test adds
    it."""
    import torch
    from orb_slam2_tpu_torch.utils import synth
    rng = np.random.default_rng(seed)
    frames = []
    for T in true:
        img = synth.render(world, cam, T)
        noise = torch.from_numpy(rng.normal(0, sigma, tuple(img.shape)))
        # in float64, as numpy adds and clips them in the JAX test
        frames.append(torch.clamp(img.double() + noise.to(device), 0, 255)
                      .float())
    torch.cuda.synchronize()
    return frames


def best_test_circuit(device) -> tuple:
    """tests/test_loop_upstream.py's configuration and circuit, as
    tests/test_torch_loop_estimated.py gives them to the port: 640x480,
    800 features, 4 levels, its SlamConfig with ``pose_prior=False``,
    ``make_world(seed=3)``, the 48-frame circle of radius 6 plus its
    first 14 frames again.  Returns (cfg, world, true poses)."""
    from orb_slam2_tpu_torch.geom.camera import Intrinsics
    from orb_slam2_tpu_torch.ops.extractor import OrbParams
    from orb_slam2_tpu_torch.pipeline.config import SlamConfig
    from orb_slam2_tpu_torch.utils import synth
    cfg = SlamConfig(
        cam=Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640,
                       height=480),
        orb=OrbParams(n_features=800, n_levels=4), fps=10.0,
        pose_prior=False, init_min_matches=60, init_min_triangulated=40,
        init_min_tracked_after_ba=60, loop_min_kfs_since_last=6)
    true = synth.loop_trajectory(BEST_LAP, radius=BEST_RADIUS)
    return (cfg, synth.make_world(seed=3, device=device),
            true + true[:BEST_REVISIT])


def best_bench_circuit(device) -> tuple:
    """Path B-est's configuration and circuit, as
    tests/test_torch_loop_estimated_bench.py gives them to both
    packages: ``bench_config()`` with ``pose_prior=False``, sequential
    tracking and mapping, ``loop_min_kfs_since_last=6`` (1920x1440, 4,000
    features, 8 levels), path B's world and true circuit (``loop_world``,
    ``loop_circuit``: 100 frames a lap, radius 20, height 12, the first
    14 frames again).  Returns (cfg, world, true poses)."""
    import dataclasses
    cfg = dataclasses.replace(bench_config(), pose_prior=False,
                              pipelined_tracking=False,
                              loop_min_kfs_since_last=6)
    true, _ = loop_circuit()
    return cfg, loop_world(device), true


# the estimated-mode loop paths: (circuit, noise in grey levels)
BEST_PATHS = {"B-est-640": (best_test_circuit, BEST_NOISE),
              "B-est": (best_bench_circuit, BEST_BENCH_NOISE)}


def best_run(device, cfg, true, frames, loop: bool, label: str) -> dict:
    """One run of a B-est path: ``track_monocular`` with no pose over
    ``frames``, sequential mapping, loop closing on or off.  With loop
    closing, ``LoopWatch`` splits the first keyframe that closes a
    loop.  Bars: a finite map and finite keyframe poses, K1-K3
    launched.  Returns the run's summary."""
    import torch
    from orb_slam2_tpu_torch import graphs, kernels
    from orb_slam2_tpu_torch.pipeline.system import System
    system = System(cfg, enable_loop_closing=loop, device=device)
    syncs = lw = None
    if loop:
        graphs.reset_stats()
        syncs = SyncCounter()
        lw = LoopWatch(system, syncs, label=label)
        syncs.__enter__()
    kernels.reset_launch_counts()
    states, loops, frame_ms = [], [], []
    t_run = time.perf_counter()
    try:
        for i, img in enumerate(frames):
            t0 = time.perf_counter()
            system.track_monocular(img, i * 0.1)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            states.append(system.state.name)
            loops.append(system.loop_closer.n_loops_closed if loop else 0)
            log(f"{label} frame {i:3d}: {states[-1]:15s} inliers="
                f"{system.tracker.matches_inliers:5d} kfs="
                f"{system.store.n_valid_keyframes():3d} points="
                f"{system.store.n_valid_points():6d} loops={loops[-1]} "
                f"{frame_ms[-1]:8.1f} ms")
        system.shutdown()
    finally:
        if loop:
            syncs.__exit__(None, None, None)
            lw.restore()
    run_s = time.perf_counter() - t_run
    launches = {k: kernels.LAUNCHES.get(k, 0) for k in
                ("fast_score", "masked_top2_mutual", "masked_top2_epi")}
    model = {None: "none", True: "H", False: "F"}[
        system.tracker.init_used_homography]
    log(f"{label}: {run_length(states)}; two-view model {model}")
    pts = system.map_points()
    check(len(pts) > 0 and bool(np.isfinite(pts).all()),
          f"{label}: map points missing or not finite "
          f"({run_length(states)})")
    check(all(np.isfinite(kf.Tcw).all() for kf in system.store.kfs
              if kf.valid), f"{label}: a keyframe pose is not finite")
    for name, n in launches.items():
        check(n > 0, f"{label}: kernel {name} never launched")
    out = dict(n_ok=sum(s == "OK" for s in states), n_frames=len(states),
               states=run_length(states), ate=kf_ate(system.store, true),
               keyframes=system.store.n_valid_keyframes(),
               points=len(pts), launches=launches, run_s=run_s,
               median_frame_ms=float(np.median(frame_ms)),
               max_frame_ms=float(np.max(frame_ms)), loops=0)
    if loop and system.loop_closer.n_loops_closed:
        lc = system.loop_closer
        info = lc.last_loop
        first = next(i for i, n in enumerate(loops) if n >= 1)
        kfs = system.store.kfs
        out.update(
            loops=lc.n_loops_closed, loop_frame=first,
            loop=dict(kid=info["kid"], loop_kf=info["loop_kf"],
                      kf_frames=(kfs[info["kid"]].frame.frame_id,
                                 kfs[info["loop_kf"]].frame.frame_id),
                      n_matched=info["n_matched"], scale=info["scale"]),
            loop_frame_ms=frame_ms[first])
        split = lw.report(graphs)
        lk = lw.loop_kf
        out.update(loop_kf_ms=lk["ms"],
                   stages={k: round(v, 1) for k, v in lk["stages"].items()},
                   loop_syncs=lk["syncs"],
                   programs={k: dict(calls=v["calls"], ms=v["ms"])
                             for k, v in split.items()},
                   captures={k: graphs.STATS.get(k, {}).get("captures", 0)
                             for k in LOOP_GRAPHS})
    return out


def phase_b_est(device, name: str = "B-est-640",
                first: bool = False) -> dict:
    """A loop in estimated mode on the card (the module docstring's
    paths B-est-640 and B-est): ``name``'s configuration, circuit and
    noise (BEST_PATHS), the noise seeds BEST_SEEDS in order, each with a
    run with loop closing off if it closes a loop; with ``first`` (the
    default run's B-est) the seeds stop at the first that closes a
    loop.  Every seed's runs come first and the loop bars after them,
    so that each seed's lines are printed; a failed bar fails the
    phase.  With ``first`` the bar on the keyframe ATE (below the
    loop-off run's on each seed that closes) is printed and not held:
    on the H100 the port misses it on seed 11, the first seed that
    closes, and ``--path-best`` holds it on every seed and fails
    there."""
    import torch
    circuit, sigma = BEST_PATHS[name]
    bcfg, world, true = circuit(device)
    card = nvidia_smi_lines()[0]
    seeds, launches = {}, {}
    for seed in BEST_SEEDS:
        label = f"{name} seed {seed}"
        frames = best_frames(world, bcfg.cam, true, seed, sigma, device)
        on = best_run(device, bcfg, true, frames, True, label)
        for k, n in on["launches"].items():
            launches[k] = launches.get(k, 0) + n
        if on["loops"]:
            off = best_run(device, bcfg, true, frames, False,
                           f"{label}, loop closing off")
            on.update(ate_loop_off=off["ate"], n_ok_loop_off=off["n_ok"],
                      states_loop_off=off["states"])
        del frames
        torch.cuda.empty_cache()
        seeds[seed] = on
        head = (f"{label}: {on['n_ok']}/{on['n_frames']} frames OK "
                f"({on['states']}); ")
        if on["loops"]:
            lp = on["loop"]
            head += (f"loop on frame {on['loop_frame']}, keyframe "
                     f"{lp['kid']} (frame {lp['kf_frames'][0]}) to "
                     f"keyframe {lp['loop_kf']} (frame "
                     f"{lp['kf_frames'][1]}), {lp['n_matched']} matched, "
                     f"scale {lp['scale']:.6f}; KF ATE {on['ate']:.6f} "
                     f"against {on['ate_loop_off']:.6f} with loop "
                     f"closing off ({on['n_ok_loop_off']} OK); the loop "
                     f"keyframe {on['loop_kf_ms']:.1f} ms, stages "
                     f"{json.dumps(on['stages'])}, host syncs "
                     f"{json.dumps(on['loop_syncs'])}, captures "
                     f"{json.dumps(on['captures'])}")
        else:
            head += f"no loop; KF ATE {on['ate']:.6f}"
        log(head + f"; K1-K3 launches {json.dumps(on['launches'])}; "
            f"{on['run_s']:.1f} s [{card}]")
        if first and on["loops"]:
            break
    log(f"{name} [{card}] " + json.dumps(seeds))
    closed = [s for s, r in seeds.items() if r["loops"]]
    check(bool(closed), f"{name}: no seed of {list(seeds)} closed a loop")
    for s in closed:
        r = seeds[s]
        check(r["n_ok"] > LOOP_MIN_OK * r["n_frames"],
              f"{name} seed {s}: only {r['n_ok']}/{r['n_frames']} frames "
              f"OK")
        check(r["loop"]["n_matched"] >= bcfg.loop_min_total_matches,
              f"{name} seed {s}: {r['loop']['n_matched']} loop matches < "
              f"{bcfg.loop_min_total_matches}")
        check(bool(np.isfinite(r["loop"]["scale"]))
              and r["loop"]["scale"] > 0,
              f"{name} seed {s}: loop scale {r['loop']['scale']}")
    for s in closed:
        if seeds[s]["ate"] >= seeds[s]["ate_loop_off"]:
            miss = (f"{name} seed {s}: keyframe ATE {seeds[s]['ate']:.6f} "
                    f"with the loop is not below "
                    f"{seeds[s]['ate_loop_off']:.6f} without it")
            check(first, miss)
            log(f"{miss}: the ATE bar MISSED, not held in the default "
                f"run (--path-best holds it) [{card}]")
    log(f"{name}: seeds {closed} closed a loop [{card}]")
    return dict(seeds=seeds, launches=launches)


# path F: the distributed solvers on path B's problems, two shards on
# the one card, held to the single-device solve with tests/test_parallel.py's
# bars; two gloo processes share the card for the process-group mesh
F_SHARDS = 2
F_POSE_TOL = 2e-4
F_POINT_TOL = 2e-3
F_COST_RTOL = 1e-3
# at full width a sharded solve must be as close to the single-device
# solve as those bars, or within this factor of the gap between the
# card's and the CPU's single-device solves of the same problem (sums
# in another order only), measured in the same call
F_SUM_ORDER_FACTOR = 4.0
F_GLOO_TIMEOUT_S = 300
# path F on a one-rank NCCL group (--nccl-worker): the process's time
# limit, and the most kernel launches plus copies a warm captured solve
# may make from the host (its inputs' uploads, its result's clones and
# gather: none a collective's; the cut form makes one pack and one
# write-back a collective, 342-701 a solve)
F_NCCL_TIMEOUT_S = 420
F_NCCL_HOST_BAR = 64


# --cards 4: the four-card mode (phases B4, F4-local, F4-NCCL, W)
CARDS = 4
# path B's keyframe ATE and the priors' on one card (PERF.md §5)
B_ONE_CARD_ATE = (0.4234, 0.5510)
# phase W, tools/weak_scaling.py's measurement: meshes of 1, 2 and 4
# cards, its 40,000 observations a card and 2^20 (262,144 points a
# card, a power-of-4 bucket a shard), its solve options; the warm calls
# timed after each first call
W_CARDS = (1, 2, 4)
W_LOADS = (40_000, 1 << 20)
W_ITERS, W_CG_ITERS = 8, 15
W_WARM = 3
# the four NCCL ranks' time limit (path F's three solves in both forms,
# then phase W's largest problem: ~2 min), and a rank's for its group's
# teardown
F4_NCCL_TIMEOUT_S = 360
NCCL_TEARDOWN_S = 90


def _captures() -> int:
    """The CUDA graph captures so far, over every graph and segment."""
    from orb_slam2_tpu_torch import graphs
    return sum(v["captures"] for v in graphs.STATS.values())


def _timed(fn):
    import torch
    sync = torch.cuda.synchronize if torch.cuda.is_available() else \
        (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def _gaps(res, ref) -> dict:
    """Largest differences of two BA (or pose-graph) results, with the
    share of points past F_POINT_TOL."""
    def h(a):
        return a.detach().cpu().double().numpy()
    if hasattr(res, "sims"):
        return dict(
            sims=float(np.abs(h(res.sims) - h(ref.sims)).max()),
            cost_rel=float(abs(h(res.final_cost) - h(ref.final_cost))
                           / max(abs(h(ref.final_cost)), 1e-12)))
    dp = np.abs(h(res.points) - h(ref.points)).max(-1)
    return dict(
        poses=float(np.abs(h(res.cam_Tcw) - h(ref.cam_Tcw)).max()),
        points=float(dp.max()),
        points_past_tol=float((dp >= F_POINT_TOL).mean()),
        inliers_differ=int((h(res.obs_inlier) != h(ref.obs_inlier)).sum()),
        cost_rel=float(abs(h(res.final_cost) - h(ref.final_cost))
                       / max(abs(h(ref.final_cost)), 1e-12)))


def _bars(sum_order: dict) -> dict:
    """Path F's bars: test_parallel.py's, or F_SUM_ORDER_FACTOR times the
    sum-order gap where that is larger."""
    base = dict(poses=F_POSE_TOL, sims=F_POSE_TOL, points=F_POINT_TOL,
                inliers_differ=0, cost_rel=F_COST_RTOL)
    return {k: max(v, F_SUM_ORDER_FACTOR * sum_order.get(k, 0.0))
            for k, v in base.items()}


def _within(g: dict, bars: dict) -> bool:
    return all(g[k] <= bars[k] if k == "inliers_differ" else g[k] < bars[k]
               for k in bars if k in g)


def gloo_worker(addr: str, rank: int, problem: str) -> int:
    """``--gloo-worker``: one rank of path F's process group (gloo, the
    ranks share the card): init_multihost + make_global_mesh +
    distributed_bundle_adjust on the saved problem, eagerly (the one-call
    core), then graphed twice (the first call captures the chain); the
    warm call's collectives and host syncs (SyncCounter: those inside
    ProcessGroupMesh.psum, and the rest) against the collective count's
    formula.  Prints its cost, times and whether the graphed solve equals
    the eager one bit for bit."""
    import torch
    from orb_slam2_tpu_torch import parallel
    from orb_slam2_tpu_torch.optim import ba
    parallel.init_multihost(coordinator=addr, num_processes=F_SHARDS,
                            process_id=rank, backend="gloo")
    import torch.distributed as dist
    mesh = parallel.make_global_mesh()
    p = np.load(problem)
    args = [p[f"a{i}"] for i in range(8)]
    kw = dict(iters=int(p["iters"]), cg_iters=int(p["cg_iters"]),
              use_huber=bool(p["use_huber"]),
              longest_cam=int(p["longest"][0]),
              longest_pt=int(p["longest"][1]))

    def solve(eager=False):
        return parallel.distributed_bundle_adjust(
            mesh, *args, *p["cam"].tolist(), eager=eager, **kw)
    eager, eager_ms = _timed(lambda: solve(True))
    _, first_ms = _timed(solve)
    psum, calls = mesh.psum, [0]

    def counted(x):
        calls[0] += 1
        return psum(x)
    with SyncCounter() as syncs:
        # the collectives' syncs under their own role
        mesh.psum = syncs.wrap(counted, "psum", nested=True)
        res, ms = _timed(syncs.wrap(solve, "gloo"))
    equal = all(torch.equal(a, b) for a, b in zip(res, eager))
    np.save(f"{problem}.rank{rank}.npy", res.cam_Tcw.cpu().numpy())
    print(f"GLOO rank={rank} backend={dist.get_backend()} "
          f"device={mesh.device} cost={float(res.final_cost)!r} "
          f"ms={ms:.1f} first_ms={first_ms:.1f} eager_ms={eager_ms:.1f} "
          f"syncs={syncs.counts['gloo'] + syncs.counts['psum']} "
          f"psum_syncs={syncs.counts['psum']} collectives={calls[0]} "
          f"formula={ba.collectives(kw['iters'], kw['cg_iters'], False)} "
          f"equal={equal} other_sites="
          f"{json.dumps(dict(syncs.sites['gloo']))}", flush=True)
    dist.destroy_process_group()
    return 0


def nccl_worker(addr: str, problem: str, rank: int = 0,
                world: int = 1) -> int:
    """``--nccl-worker``: rank ``rank`` of a NCCL process group of
    ``world`` ranks, one a card (``init_multihost``, whose backend is
    NCCL with a card a rank, and ``make_global_mesh``), on path F's
    three problems: each solved eagerly (``eager=True``, the one-call
    core), then in the captured form (the mesh capturable: every
    collective inside the graphs, one replay an LM iteration) and in the
    cut form (``mesh.capturable`` set False: the chain cut at every
    collective, the all-reduce eager between replays), each form's first
    call (its captures) and a warm call; every result of both forms bit
    for bit the eager one (so the two forms equal each other),
    ``graphs.STATS`` saying which form ran; a warm call's host syncs
    (SyncCounter), runtime calls (torch.profiler) and segments.  Checks:
    the captured form ran, a warm captured solve makes no host sync,
    its graph launches are its segments, its other host launches and
    copies at most F_NCCL_HOST_BAR.  Saves each solve's eager result
    beside the problem (``PROBLEM.NAME.rankR.npz``), for the ranks to
    be compared.  Where the problem names a weak-scaling load
    (``w_load``), then solves phase W's problem of ``world`` cards at
    that load, captured, first and W_WARM warm calls, and saves its
    cameras and cost.  Prints one ``NCCL {...}`` JSON line a solve, a
    ``NCCL_W {...}`` line, and ``NCCL_OK``."""
    import torch
    import torch.distributed as dist
    from orb_slam2_tpu_torch import graphs, parallel
    if world > 1:
        # the group's teardown aborts its communicator (every collective
        # has finished by then) instead of a destroy that waits on peers
        os.environ.setdefault("TORCH_NCCL_ABORT_IN_DESTROY_PG", "1")
    parallel.init_multihost(coordinator=addr, num_processes=world,
                            process_id=rank)
    mesh = parallel.make_global_mesh()
    check(dist.get_backend() == "nccl" and mesh.capturable
          and mesh.size == world
          and mesh.device == torch.device("cuda", rank),
          f"F/NCCL rank {rank}: backend {dist.get_backend()}, capturable "
          f"{mesh.capturable}, {mesh.size} ranks, on {mesh.device}")
    p = np.load(problem)
    bargs = [p[f"b{i}"] for i in range(8)] + p["cam"].tolist()
    bkw = dict(iters=int(p["iters"]), cg_iters=int(p["cg_iters"]),
               use_huber=bool(p["use_huber"]),
               longest_cam=int(p["longest"][0]),
               longest_pt=int(p["longest"][1]))
    pargs = [p[f"p{i}"] for i in range(6)]
    pkw = dict(iters=int(p["p_iters"]), cg_iters=int(p["p_cg_iters"]))
    solves = (
        ("distributed_bundle_adjust", "ba", bkw["iters"],
         lambda eager: parallel.distributed_bundle_adjust(
             mesh, *bargs, eager=eager, **bkw)),
        ("distributed_bundle_adjust_sharded_points", "ba", bkw["iters"],
         lambda eager: parallel.distributed_bundle_adjust_sharded_points(
             mesh, *bargs, eager=eager, **bkw)),
        ("distributed_pose_graph", "pose_graph", pkw["iters"],
         lambda eager: parallel.distributed_pose_graph(
             mesh, *pargs, eager=eager, **pkw)))

    def stats(chain):
        st = {k: dict(v) for k, v in graphs.STATS.items()
              if k == chain or k.startswith(chain + ":")}
        return st

    def diff(a, b, field):
        return {k: v.get(field, 0) - a.get(k, {}).get(field, 0)
                for k, v in b.items()
                if v.get(field, 0) != a.get(k, {}).get(field, 0)}

    for name, chain, iters, solve in solves:
        eager, eager_ms = _timed(lambda: solve(True))
        np.savez(f"{problem}.{name}.rank{rank}.npz",
                 *[t.cpu().numpy() for t in eager])
        forms = {}
        for form in ("captured", "cut"):
            mesh.capturable = form == "captured"
            s0 = stats(chain)
            res, first_ms = _timed(lambda: solve(False))
            s1 = stats(chain)
            with SyncCounter() as syncs:
                warm, warm_ms = _timed(syncs.wrap(lambda: solve(False),
                                                  "nccl"))
            s2 = stats(chain)
            runtime = runtime_counts(lambda: solve(False))
            for label, out in (("first", res), ("warm", warm)):
                for j, (a, b) in enumerate(zip(out, eager)):
                    check(torch.equal(a, b), f"F/NCCL rank {rank}: "
                          f"{name}'s {form} {label} call differs from its "
                          f"eager call in field {j}")
            ran = diff(s0, s1, form).get(chain, 0)
            other = diff(s0, s2, "cut" if form == "captured"
                         else "captured").get(chain, 0)
            check(ran == 1 and other == 0, f"F/NCCL rank {rank}: {name} "
                  f"asked for the {form} form ran {ran} {form} and "
                  f"{other} other solves")
            forms[form] = dict(
                first_ms=first_ms, warm_ms=warm_ms,
                warm_syncs=syncs.counts["nccl"],
                sync_sites=dict(syncs.sites["nccl"]), runtime=runtime,
                segments=diff(s1, s2, "segments").get(chain, 0),
                captures=sum(diff(s0, s1, "captures").values()),
                warm_captures=sum(diff(s1, s2, "captures").values()),
                warmup_ms=sum(diff(s0, s1, "warmup_ms").values()),
                capture_ms=sum(diff(s0, s1, "capture_ms").values()),
                stats={k: v for k, v in stats(chain).get(chain, {}).items()
                       if k in ("captured", "cut", "segments")})
        mesh.capturable = True
        cap = forms["captured"]
        check(cap["warm_syncs"] == 0, f"F/NCCL rank {rank}: a warm "
              f"captured {name} synchronizes with the host: "
              f"{cap['sync_sites']}")
        check(cap["warm_captures"] == 0 and forms["cut"]["warm_captures"]
              == 0, f"F/NCCL rank {rank}: a warm {name} captured graphs")
        check(cap["segments"] == iters + 2, f"F/NCCL rank {rank}: a "
              f"captured {name} ran {cap['segments']} segments, not "
              f"{iters + 2}")
        rt = cap["runtime"]
        check(rt["graph_launches"] == cap["segments"]
              and rt["launches"] + rt["copies"] <= F_NCCL_HOST_BAR,
              f"F/NCCL rank {rank}: a warm captured {name}'s host "
              f"launches: {rt}")
        print("NCCL " + json.dumps(dict(name=name, rank=rank, world=world,
                                        eager_ms=eager_ms, **forms)),
              flush=True)
    if "w_load" in p:
        w = w_problem(world, int(p["w_load"]))
        times = [_timed(lambda: w_solve(mesh, w)) for _ in
                 range(1 + W_WARM)]
        res = times[-1][0]
        np.savez(f"{problem}.w.rank{rank}.npz",
                 *[t.cpu().numpy() for t in res])
        print("NCCL_W " + json.dumps(dict(
            rank=rank, world=world, n_obs=len(w[2]),
            first_ms=times[0][1], warm_ms=[t[1] for t in times[1:]],
            cost=float(res.final_cost),
            form=graphs.STATS["ba"]["captured"] > 0)), flush=True)
    # the captured graphs hold NCCL work of the communicator: they go,
    # and the card finishes, before the group does; a teardown that
    # hangs fails this rank within NCCL_TEARDOWN_S
    import gc
    graphs.clear_chains()
    gc.collect()
    torch.cuda.synchronize()
    print("NCCL_DONE", flush=True)
    done = threading.Event()

    def watchdog():
        if not done.wait(NCCL_TEARDOWN_S):
            print(f"F/NCCL rank {rank}: destroy_process_group ran past "
                  f"{NCCL_TEARDOWN_S} s", flush=True)
            os._exit(3)
    threading.Thread(target=watchdog, daemon=True).start()
    dist.destroy_process_group()
    done.set()
    print("NCCL_OK", flush=True)
    return 0


def run_ranks(cmds: list, timeout: float) -> list:
    """Run one process a command from the repository's root, each
    writing to a file of its own, and wait for all of them, at most
    ``timeout`` seconds in all.  The first that fails, or the deadline,
    ends the others: a rank left inside a collective would wait for the
    process group's own timeout.  Returns [(exit code, output)]."""
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as root:
        logs = [open(os.path.join(root, f"{r}.log"), "w+")
                for r in range(len(cmds))]
        procs = [subprocess.Popen(c, cwd=here, stdout=f,
                                  stderr=subprocess.STDOUT, text=True)
                 for c, f in zip(cmds, logs)]
        deadline = time.monotonic() + timeout
        try:
            while any(q.poll() is None for q in procs):
                if (time.monotonic() > deadline
                        or any(q.poll() not in (None, 0) for q in procs)):
                    break
                time.sleep(0.2)
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                q.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    return [(q.returncode, o) for q, o in zip(procs, outs)]


def free_addr() -> str:
    """A free TCP port of this host, as HOST:PORT."""
    import socket
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{sock.getsockname()[1]}"
    sock.close()
    return addr


def phase_nccl(bargs, bkw, pargs, pkw, world: int = 1, w_load=None,
               label: str = "F/NCCL", timeout: float = None) -> dict:
    """Path F on NCCL: ``world`` processes (``--nccl-worker``), one rank
    a card, on path F's three problems (and, with ``w_load``, phase W's
    problem of ``world`` cards); their numbers, captured beside cut,
    printed here.  With several ranks every rank's eager results, which
    both graphed forms equal bit for bit, must be bitwise equal across
    the ranks.  Returns rank 0's numbers by solve, every rank's
    (``ranks``), the wall time and, with ``w_load``, rank 0's W line
    (``w``) and cameras (``w_cams``)."""
    import tempfile
    with tempfile.TemporaryDirectory() as root:
        problem = os.path.join(root, "problem.npz")
        extra = {} if w_load is None else dict(w_load=w_load)
        np.savez(problem, cam=np.array(bargs[8:12]),
                 iters=bkw.get("iters", 10), cg_iters=bkw.get("cg_iters", 20),
                 use_huber=bkw.get("use_huber", True),
                 longest=np.array([bkw["longest_cam"], bkw["longest_pt"]]),
                 p_iters=pkw.get("iters", 20), p_cg_iters=pkw.get("cg_iters",
                                                                  30),
                 **{f"b{i}": a for i, a in enumerate(bargs[:8])},
                 **{f"p{i}": a for i, a in enumerate(pargs)}, **extra)
        addr = free_addr()
        cmd = [sys.executable, os.path.abspath(__file__), "--nccl-worker",
               addr, problem]
        t0 = time.perf_counter()
        runs = run_ranks([cmd] if world == 1 else
                         [cmd + [str(r), str(world)] for r in range(world)],
                         timeout or F_NCCL_TIMEOUT_S)
        wall = time.perf_counter() - t0
        failed = [(r, rc, out) for r, (rc, out) in enumerate(runs)
                  if rc != 0 or "NCCL_OK" not in out]
        check(not failed, f"{label}: NCCL ranks failed after {wall:.1f} s: "
              + "\n".join(f"rank {r} ({rc}):\n{out[-1500:]}"
                          for r, rc, out in failed))
        names = [json.loads(ln[len("NCCL "):])["name"]
                 for ln in runs[0][1].splitlines() if ln.startswith("NCCL {")]
        check(len(names) == 3, f"{label}: the NCCL worker printed {names}")
        results = {}
        for name in names + (["w"] if w_load is not None else []):
            got = [np.load(f"{problem}.{name}.rank{r}.npz")
                   for r in range(world)]
            got = [[g[f"arr_{i}"] for i in range(len(g.files))]
                   for g in got]
            check(all(np.array_equal(a, b) for g in got
                      for a, b in zip(g, got[0])),
                  f"{label}: {name}'s results differ between the ranks")
            results[name] = got[0]
    res = {"ranks": [], "wall_s": wall, "results": results}
    for r, (_, out) in enumerate(runs):
        mine = {}
        for ln in out.splitlines():
            if ln.startswith("NCCL {"):
                rec = json.loads(ln[len("NCCL "):])
                mine[rec["name"]] = rec
            elif ln.startswith("NCCL_W {"):
                mine["w"] = json.loads(ln[len("NCCL_W "):])
        res["ranks"].append(mine)
    for name, r in res["ranks"][0].items():
        res[name] = r
        if name == "w":
            continue
        c, u = r["captured"], r["cut"]
        log(f"{label} {r['name']} on {world} NCCL rank(s), rank 0, "
            f"captured against cut: first {c['first_ms']:.1f} / "
            f"{u['first_ms']:.1f} ms (captures {c['captures']} / "
            f"{u['captures']}; warm-up {c['warmup_ms']:.1f} / "
            f"{u['warmup_ms']:.1f} ms, capture {c['capture_ms']:.1f} / "
            f"{u['capture_ms']:.1f} ms), warm {c['warm_ms']:.1f} / "
            f"{u['warm_ms']:.1f} ms (every rank: "
            f"{[round(x[name]['captured']['warm_ms'], 1) for x in res['ranks']]}"
            f" / {[round(x[name]['cut']['warm_ms'], 1) for x in res['ranks']]}"
            f"), eager {r['eager_ms']:.1f} ms; a warm solve's host syncs "
            f"{c['warm_syncs']} / {u['warm_syncs']}, segments "
            f"{c['segments']} / {u['segments']}, runtime calls "
            f"{json.dumps(c['runtime'])} / {json.dumps(u['runtime'])}; "
            f"graphs.STATS {json.dumps(c['stats'])}; both forms bit for "
            f"bit the eager solve" + ("; every rank's results bitwise "
                                      "equal" if world > 1 else ""))
    log(f"{label}: {wall:.1f} s with the processes' start")
    return res


def _graph_chain_checks(name, run, mesh_cls, devs, label="F") -> dict:
    """One sharded solve on a local mesh of ``devs``: the eager call
    (``run(mesh, True)``, the one-call core on every shard), the graphed
    call's first run (it captures every shard's chain) and a warm run,
    each shard's every result of both graphed runs against the eager
    call's, bit for bit; the warm run's host syncs on every thread
    (SyncCounter, bar 0) and captures (bar 0), each card's peak memory
    over the graphed runs, and a further warm run's CUDA runtime calls
    (torch.profiler).  Returns the graphed result (first run), the mesh
    and the numbers."""
    import torch
    from orb_slam2_tpu_torch import graphs

    def shards(mesh):
        return {d: tuple(r) for d, r in mesh.results.items()}
    cards = sorted({torch.device(d).index for d in devs})
    mesh_e = mesh_cls(devs)
    eager, eager_ms = _timed(lambda: run(mesh_e, True))
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
    mesh_g = mesh_cls(devs)
    before = {k: dict(v) for k, v in graphs.STATS.items()}
    res, first_ms = _timed(lambda: run(mesh_g, False))
    mesh_w = mesh_cls(devs)
    n_cap = _captures()
    with SyncCounter() as syncs:
        warm, warm_ms = _timed(syncs.wrap(lambda: run(mesh_w, False),
                                          "dist", all_threads=True))
    warm_captures = _captures() - n_cap
    peak_mib = {f"cuda:{i}": round(torch.cuda.max_memory_allocated(i)
                                   / 2 ** 20, 1) for i in cards}
    for tag, mesh, out in (("first", mesh_g, res), ("warm", mesh_w, warm)):
        want = shards(mesh_e)
        for d, got in shards(mesh).items():
            for j, (a, b) in enumerate(zip(got, want[d])):
                check(torch.equal(a, b), f"{label}: {name}'s graphed {tag} "
                      f"run differs from its eager call on shard {d} in "
                      f"result {j}")
        for j, (a, b) in enumerate(zip(out, eager)):
            check(torch.equal(a, b), f"{label}: {name}'s graphed {tag} "
                  f"result differs from its eager call in field {j}")
    n_sync = syncs.counts["dist"]
    check(n_sync == 0, f"{label}: a warm graphed {name} synchronizes with "
          f"the host {n_sync} times: {dict(syncs.sites['dist'])}")
    check(warm_captures == 0, f"{label}: a warm graphed {name} captured "
          f"{warm_captures} graphs")
    runtime = runtime_counts(lambda: run(mesh_cls(devs), False))
    new = {k: {f: v[f] - before.get(k, {}).get(f, 0)
               for f in ("captures", "warmup_ms", "capture_ms")}
           for k, v in graphs.STATS.items()
           if v["captures"] > before.get(k, {}).get("captures", 0)}
    segs = {k: v["captures"] for k, v in new.items()}
    setup = {f: round(sum(v[f] for v in new.values()), 1)
             for f in ("warmup_ms", "capture_ms")}
    log(f"{label}: {name} graphed on {len(devs)} shards: first "
        f"{first_ms:.1f} ms (captures: warm-up and capture "
        f"{json.dumps(setup)}), warm {warm_ms:.1f} ms, eager "
        f"{eager_ms:.1f} ms; bit-exact against the eager call on every "
        f"shard (first and warm); a warm call's host syncs {n_sync}, "
        f"captures {warm_captures}, CUDA runtime calls "
        f"{json.dumps(runtime)}; captures by segment {json.dumps(segs)}; "
        f"peak memory by card (MiB) {json.dumps(peak_mib)}")
    return res, mesh_g, dict(first_ms=first_ms, warm_ms=warm_ms,
                             eager_ms=eager_ms, warm_syncs=n_sync,
                             warm_captures=warm_captures, runtime=runtime,
                             captures=segs, peak_mib=peak_mib, **setup)


def f_problems(record: dict):
    """Path F's problems from path B's record: the global BA's without
    run_global_ba's padding (observations past the valid ones, points no
    observation reaches; the JAX package's sharded branch takes it so,
    and padding would leave one shard with filler only) and the
    essential graph's without its zero-weight filler edges, with their
    keyword arguments (the host's longest-segment counts dropped: they
    belong to the padded layouts, and the sharded solvers count their
    own).  Returns (bargs, bkw, pargs, pkw)."""
    bargs, bkw = record["ba"]
    bkw = {k: v for k, v in bkw.items() if not k.startswith("longest")}
    cams, pts, oc, op, ouv, isig, valid, fixed = bargs[:8]
    n_obs = int(valid.sum())
    check(bool(valid[:n_obs].all()), "F: padding inside the observations")
    n_pts = int(op[:n_obs].max()) + 1
    bargs = ([cams, pts[:n_pts]]
             + [a[:n_obs] for a in (oc, op, ouv, isig, valid)] + [fixed]
             + list(bargs[8:12]))
    pargs, pkw = record["pose_graph"]
    pkw = {k: v for k, v in pkw.items() if k != "longest"}
    n_edges = int((pargs[4] > 0).sum())
    check(bool((pargs[4][:n_edges] > 0).all()), "F: filler inside the edges")
    pargs = [pargs[0]] + [a[:n_edges] for a in pargs[1:5]] + [pargs[5]]
    return bargs, bkw, pargs, pkw


def f_times(device, record: dict) -> dict:
    """--repeat-f: path F's solves timed with only the API the parent
    has too (no ``eager=``): the single-device BA and pose graph, first
    and warm, and each sharded solve on a local mesh of F_SHARDS shards
    of the card, first and two warm calls, a warm call's host syncs on
    every thread (SyncCounter) and CUDA runtime calls (torch.profiler)."""
    import torch
    from orb_slam2_tpu_torch import parallel
    from orb_slam2_tpu_torch.optim import ba, pose_graph
    bargs, bkw, pargs, pkw = f_problems(record)
    devs = [device] * F_SHARDS
    out = {}
    dev_b = [torch.as_tensor(a, device=device) for a in bargs[:8]]
    dev_p = [torch.as_tensor(a, device=device) for a in pargs]
    solves = (
        ("single_ba", lambda: ba.bundle_adjust(*dev_b, *bargs[8:12], **bkw)),
        ("single_pose_graph",
         lambda: pose_graph.optimize_pose_graph(*dev_p, **pkw)),
        ("ba_obs", lambda: parallel.distributed_bundle_adjust(
            parallel.LocalMesh(devs), *bargs, **bkw)),
        ("ba_points", lambda: parallel.distributed_bundle_adjust_sharded_points(
            parallel.LocalMesh(devs), *bargs, **bkw)),
        ("pose_graph", lambda: parallel.distributed_pose_graph(
            parallel.LocalMesh(devs), *pargs, **pkw)))
    for name, fn in solves:
        times = [_timed(fn)[1] for _ in range(3)]
        with SyncCounter() as syncs:
            _timed(syncs.wrap(fn, "f", all_threads=True))
        out[name] = dict(first_ms=times[0], warm_ms=times[1:],
                         warm_syncs=syncs.counts["f"],
                         runtime=runtime_counts(fn))
        log(f"F times {name}: {json.dumps(out[name])}")
    return out


def repeat_dist_trees(tree: str) -> int:
    """--repeat-f --tree DIR: path B (for its record) and f_times in
    four processes, the port imported from DIR, this checkout, this
    checkout and DIR (parent, change, change, parent on one card); their
    output passes through, and their summaries are printed side by
    side."""
    here = os.path.abspath(__file__)
    runs = []
    for which in ("tree", "here", "here", "tree"):
        cmd = [sys.executable, here, "--repeat-f", "--f-once"]
        if which == "tree":
            cmd += ["--tree", tree]
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=900)
        sys.stdout.write(out.stdout)
        sys.stderr.write(out.stderr[-4000:])
        summary = [ln for ln in out.stdout.splitlines()
                   if ln.startswith("F summary ")]
        if out.returncode != 0 or not summary:
            log(f"F repeat ({which}): exit {out.returncode}")
            return 1
        runs.append((which, json.loads(summary[-1][len("F summary "):])))
    for which, r in runs:
        log(f"repeat F {'parent' if which == 'tree' else 'change'}: " + "; ".join(
            f"{k} first {v['first_ms']:.1f} warm "
            f"{'/'.join(f'{t:.1f}' for t in v['warm_ms'])} ms, syncs "
            f"{v['warm_syncs']}, {json.dumps(v['runtime'])}"
            for k, v in r.items()))
    return 0


def spy_mesh(devices):
    """A local mesh that keeps every shard's result (``results``)."""
    from orb_slam2_tpu_torch import parallel

    class Mesh(parallel.LocalMesh):
        def run(self, body):
            self.results = super().run(body)
            return self.results
    return Mesh(devices)


def run_gba(record: dict, device, devices=None):
    """``LoopCloser.run_global_ba`` on a copy of the map path B recorded
    before its first global BA, on ``device``, with
    ``parallel.local_devices`` saying ``devices`` (else the visible
    cards); returns the valid keyframes' poses, the valid points and
    the milliseconds."""
    from orb_slam2_tpu_torch import interop, parallel
    from orb_slam2_tpu_torch.pipeline.loop_closing import LoopCloser
    store = interop.mapstore_from_numpy(**record["store"], device=device)
    lc = LoopCloser(record["cfg"], store)
    real = parallel.local_devices
    parallel.local_devices = (lambda d: devices) if devices else real
    try:
        _, ms = _timed(lc.run_global_ba)
    finally:
        parallel.local_devices = real
    kids = store.valid_kf_ids()
    return (np.stack([store.kfs[k].Tcw for k in kids]),
            np.asarray(store.mp_pos)[np.asarray(store.mp_valid, bool)], ms)


def replicated(mesh, field) -> bool:
    """Every shard of a spy_mesh holds the same bits of ``field``."""
    vals = [getattr(r, field).cpu().numpy() for r in mesh.results.values()]
    return all(np.array_equal(v, vals[0]) for v in vals)


def f_solves(device, record: dict, devs: list, label: str) -> dict:
    """Path F's three sharded solves of path B's first loop correction
    on a local mesh of ``devs`` (``label`` starts the lines): each
    graphed against its eager call and warm (_graph_chain_checks), the
    shards' replicated state bitwise equal, each shard's point rows on
    its own card, each within the bars of the single-device solve on
    ``device``.  Returns the numbers, with the single-device results
    (``single``, ``psingle``), the bars (``bars``, ``pbars``) and the
    problems."""
    import torch
    from orb_slam2_tpu_torch import graphs, parallel
    from orb_slam2_tpu_torch.optim import ba, pose_graph, segment
    check(all(k in record for k in ("ba", "pose_graph", "store")),
          f"{label}: path B recorded only {sorted(record)}")
    out = {}
    bargs, bkw, pargs, pkw = f_problems(record)
    cams, pts, oc, op, ouv, isig, valid, fixed = bargs[:8]
    fx, fy, cx, cy = bargs[8:12]
    n_pts, n_obs = len(pts), len(oc)
    rpts, roc = record["ba"][0][1], record["ba"][0][2]
    log(f"{label}: global BA problem: {len(cams)} cameras "
        f"({int(fixed.sum())} fixed), {n_pts} points and {n_obs} "
        f"observations (run_global_ba gave {len(rpts)} and {len(roc)}), "
        f"{bkw}; collectives a sharded solve: "
        f"{ba.collectives(bkw['iters'], bkw['cg_iters'], True)} with the "
        f"points sharded, "
        f"{ba.collectives(bkw['iters'], bkw['cg_iters'], False)} with the "
        f"observations")
    dev_args = [torch.as_tensor(a, device=device) for a in bargs[:8]]
    single, single_ms = _timed(lambda: ba.bundle_adjust(
        *dev_args, fx, fy, cx, cy, **bkw))
    _, single_warm_ms = _timed(lambda: ba.bundle_adjust(
        *dev_args, fx, fy, cx, cy, **bkw))
    cpu = ba.bundle_adjust(*[torch.as_tensor(a) for a in bargs[:8]],
                           fx, fy, cx, cy, **bkw)
    sum_order = _gaps(cpu, single)
    bars = _bars(sum_order)
    log(f"{label}: single-device BA {single_ms:.1f} ms first, "
        f"{single_warm_ms:.1f} ms warm; the CPU's solve against the "
        f"card's (another sum order): {json.dumps(sum_order)}; bars "
        f"{json.dumps(bars)}")
    # the sharded solves take the single-device solve's reductions: its
    # layout's longest runs, from the host
    skw = dict(bkw, longest_cam=segment.longest_segment(oc, len(cams)),
               longest_pt=segment.longest_segment(op, len(pts)))
    for name, fn in (("distributed_bundle_adjust",
                      parallel.distributed_bundle_adjust),
                     ("distributed_bundle_adjust_sharded_points",
                      parallel.distributed_bundle_adjust_sharded_points)):
        res, mesh, nums = _graph_chain_checks(
            name, lambda m, eager: fn(m, *bargs[:8], fx, fy, cx, cy,
                                      eager=eager, **skw), spy_mesh, devs,
            label)
        g = _gaps(res, single)
        rep = replicated(mesh, "cam_Tcw") and replicated(mesh, "final_cost")
        log(f"{label}: {name} on {len(devs)} shards of "
            f"{sorted(set(map(str, devs)))}: {nums['warm_ms']:.1f} ms warm "
            f"(single device {single_warm_ms:.1f} ms warm); against the "
            f"single device {json.dumps(g)}; cameras and cost bitwise "
            f"equal on every shard: {rep}")
        check(rep, f"{label}: {name}: the shards' cameras differ")
        check(_within(g, bars), f"{label}: {name} misses the bars "
              f"{json.dumps(bars)}: {json.dumps(g)}")
        for d, r in mesh.results.items():
            check(all(t.device == mesh.devices[d] for t in r),
                  f"{label}: {name}: shard {d}'s results left its card")
        if name.endswith("sharded_points"):
            rows = {d: len(r.points) for d, r in mesh.results.items()}
            log(f"{label}: point rows a shard (its block, padded to a "
                f"bucket), each on its own card: {rows} of {n_pts} points")
        out[name] = dict(single_ms=single_ms, single_warm_ms=single_warm_ms,
                         **nums, **g)

    log(f"{label}: essential graph: {len(pargs[0])} Sim3 vertices "
        f"({int(pargs[5].sum())} fixed), {len(pargs[1])} edges, {pkw}; "
        f"collectives a sharded solve: "
        f"{pose_graph.collectives(pkw['iters'], pkw['cg_iters'])}")
    pg_dev = [torch.as_tensor(a, device=device) for a in pargs]
    psingle, p_ms = _timed(lambda: pose_graph.optimize_pose_graph(
        *pg_dev, **pkw))
    _, p_warm_ms = _timed(lambda: pose_graph.optimize_pose_graph(
        *pg_dev, **pkw))
    pcpu = pose_graph.optimize_pose_graph(
        *[torch.as_tensor(a) for a in pargs], **pkw)
    psum_order = _gaps(pcpu, psingle)
    pbars = _bars(psum_order)
    pres, mesh, nums = _graph_chain_checks(
        "distributed_pose_graph",
        lambda m, eager: parallel.distributed_pose_graph(
            m, *pargs, eager=eager, **pkw), spy_mesh, devs, label)
    g = _gaps(pres, psingle)
    rep = replicated(mesh, "sims") and replicated(mesh, "final_cost")
    log(f"{label}: distributed_pose_graph on {len(devs)} shards: "
        f"{nums['warm_ms']:.1f} ms warm (single device {p_ms:.1f} ms "
        f"first, {p_warm_ms:.1f} ms warm); against the single device "
        f"{json.dumps(g)}; the CPU's single solve against the card's "
        f"{json.dumps(psum_order)}; bars {json.dumps(pbars)}; Sim3 and "
        f"cost bitwise equal on every shard: {rep}")
    check(rep, f"{label}: distributed_pose_graph: the shards' vertices "
          f"differ")
    check(_within(g, pbars), f"{label}: distributed_pose_graph misses the "
          f"bars {json.dumps(pbars)}: {json.dumps(g)}")
    out["distributed_pose_graph"] = dict(single_ms=p_ms,
                                         single_warm_ms=p_warm_ms,
                                         **nums, **g)
    out.update(single=single, psingle=psingle, bars=bars, pbars=pbars,
               problems=(bargs, skw, pargs, pkw))
    return out


def phase_dist(device, record: dict) -> dict:
    """Path F: the distributed solvers at full width on path B's first
    loop correction.  On a local mesh of F_SHARDS shards on the one card
    (``f_solves``): distributed_bundle_adjust and
    distributed_bundle_adjust_sharded_points on the global BA's problem,
    distributed_pose_graph on the essential graph, each as its graph
    chains (first and warm) and eagerly, the graphed runs bit for bit
    the eager one on every shard, a warm run with no host sync and no
    capture, each within the bars of the single-device solve (poses and
    Sim3 within F_POSE_TOL, points F_POINT_TOL, inliers equal, cost
    within F_COST_RTOL, or F_SUM_ORDER_FACTOR times the gap between the
    card's and the CPU's single-device solve), the cameras bitwise equal
    on every shard; then LoopCloser.run_global_ba's sharded branch on a
    copy of the map; the chains' captures at most graphs.MAXSIZE a
    segment.  Then F_SHARDS processes joined by gloo on the card
    (init_multihost, make_global_mesh) run distributed_bundle_adjust on
    the same problem, eagerly and graphed: the graphed solve equal to
    the eager one, the same cost and cameras on both ranks, within
    F_COST_RTOL of the single-device cost, one host sync a collective.
    Then the three solves on a one-rank NCCL group (phase_nccl)."""
    import tempfile
    from orb_slam2_tpu_torch import graphs
    devs = [device] * F_SHARDS
    out = f_solves(device, record, devs, "F")
    single, bars = out["single"], out["bars"]
    bargs, skw, pargs, pkw = out["problems"]
    fx, fy, cx, cy = bargs[8:12]
    bkw = {k: v for k, v in skw.items() if not k.startswith("longest")}

    # LoopCloser.run_global_ba on two copies of the map: one device, and
    # the sharded branch (local_devices says there are F_SHARDS), which
    # must replay the point-sharded chains
    def chain_replays():
        return sum(v["replays"] for k, v in graphs.STATS.items()
                   if k.startswith("ba:"))
    t1, p1, ms1 = run_gba(record, device)
    r0 = chain_replays()
    t2, p2, ms2 = run_gba(record, device, devs)
    replays = chain_replays() - r0
    g = dict(poses=float(np.abs(t1 - t2).max()),
             points=float(np.abs(p1 - p2).max()), cost_rel=0.0)
    log(f"F: LoopCloser.run_global_ba sharded over {F_SHARDS} shards: "
        f"{ms2:.1f} ms against {ms1:.1f} ms on one device, {replays} "
        f"graph-chain replays; keyframe poses within {g['poses']:.2e}, "
        f"points within {g['points']:.2e}")
    check(replays > 0, "F: run_global_ba's sharded branch replayed no "
          "graph chain")
    check(_within(g, bars), f"F: run_global_ba's sharded branch misses "
          f"the bars {json.dumps(bars)}: {g}")
    out["run_global_ba"] = dict(ms=ms2, single_ms=ms1, replays=replays, **g)
    over = {k: v["captures"] for k, v in graphs.STATS.items()
            if v["captures"] > graphs.MAXSIZE}
    check(not over, f"F: captures past graphs.MAXSIZE: {over}")

    # the process-group mesh: F_SHARDS processes on the card, gloo
    with tempfile.TemporaryDirectory() as root:
        problem = os.path.join(root, "problem.npz")
        np.savez(problem, cam=np.array([fx, fy, cx, cy]),
                 iters=bkw.get("iters", 10), cg_iters=bkw.get("cg_iters", 20),
                 use_huber=bkw.get("use_huber", True),
                 longest=np.array([skw["longest_cam"], skw["longest_pt"]]),
                 **{f"a{i}": a for i, a in enumerate(bargs[:8])})
        addr = free_addr()
        t0 = time.perf_counter()
        runs = run_ranks([[sys.executable, os.path.abspath(__file__),
                           "--gloo-worker", addr, str(r), problem]
                          for r in range(F_SHARDS)], F_GLOO_TIMEOUT_S)
        wall = time.perf_counter() - t0
        outs = [o for _, o in runs]
        for r, (rc, o) in enumerate(runs):
            check(rc == 0 and "GLOO rank=" in o,
                  f"F: gloo rank {r} failed ({rc}):\n{o[-2000:]}")
        lines = [next(ln for ln in o.splitlines() if ln.startswith("GLOO"))
                 for o in outs]
        costs = [float(ln.split("cost=")[1].split()[0]) for ln in lines]
        cams_r = [np.load(f"{problem}.rank{r}.npy") for r in range(F_SHARDS)]

    def field(ln, key):
        return ln.split(f" {key}=")[1].split()[0]
    ref_cost = float(single.final_cost)
    rel = abs(costs[0] - ref_cost) / max(abs(ref_cost), 1e-12)
    log("F: process group: " + "; ".join(lines) + f"; {wall:.1f} s with "
        f"the processes' start; single-device cost {ref_cost!r}, "
        f"relative gap {rel:.2e}")
    check(costs[0] == costs[1], f"F: the gloo ranks' costs differ: {costs}")
    check(all(np.array_equal(c, cams_r[0]) for c in cams_r),
          "F: the gloo ranks' cameras differ")
    check(rel < bars["cost_rel"], f"F: the gloo cost is {rel:.2e} from the "
          f"single device's (bar {bars['cost_rel']:.2e})")
    check("backend=gloo" in lines[0], f"F: {lines[0]}")
    for ln in lines:
        check(field(ln, "equal") == "True", f"F: a gloo rank's graphed "
              f"solve differs from its eager one: {ln}")
        check(field(ln, "psum_syncs") == field(ln, "collectives")
              == field(ln, "formula"), f"F: a gloo rank's collectives, "
              f"their count by formula and its syncs at psum differ: {ln}")
    out["process_group"] = dict(
        cost_rel=rel, wall_s=wall,
        **{k: [float(field(ln, k)) for ln in lines]
           for k in ("ms", "first_ms", "eager_ms", "syncs", "psum_syncs",
                     "collectives", "formula")})
    out["nccl"] = phase_nccl(bargs, skw, pargs, pkw)
    return out


# ----------------------------------------------------------------------
# --cards 4: the distributed solvers over the cards of one host
# ----------------------------------------------------------------------
def require_cards(n: int) -> int:
    """The visible CUDA cards; fails, naming the count, unless there
    are at least ``n``."""
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    check(have >= n, f"--cards {n} needs {n} CUDA cards; {have} visible")
    return have


def _cards_of(devs: list) -> list:
    """The distinct card indices of a list of CUDA devices."""
    return sorted({d.index for d in devs})


def _timed_all(fn, devs: list):
    """``fn()`` and its milliseconds, the queues of every card of
    ``devs`` drained before and after."""
    import torch

    def sync():
        for i in _cards_of(devs):
            torch.cuda.synchronize(i)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


class ChainDevices:
    """The graph-chain segments run on each card while it is open: a
    wrapped ``graphs.Chain._run_steps`` counts (chain name, device)."""

    def __enter__(self):
        import collections
        from orb_slam2_tpu_torch import graphs
        self.counts = collections.Counter()
        self._graphs, self._real = graphs, graphs.Chain._run_steps
        real, counts = self._real, self.counts

        def run_steps(chain, steps, cfg):
            if steps:
                counts[(chain.name, str(chain.device))] += 1
            return real(chain, steps, cfg)
        graphs.Chain._run_steps = run_steps
        return self

    def __exit__(self, *exc):
        self._graphs.Chain._run_steps = self._real

    def cards(self, name: str) -> list:
        return sorted(d for n, d in self.counts if n == name)


class KernelDevices:
    """The cards the hand-written kernels launch on while it is open: a
    wrapped ``kernels.call`` notes the current card and its tensors'
    cards (a graph's capture calls it; its replays run where it was
    captured)."""

    def __enter__(self):
        import torch
        from orb_slam2_tpu_torch import kernels
        self.cards = set()
        self._kernels, self._real = kernels, kernels.call
        real, cards = self._real, self.cards

        def call(name, *args, **kwargs):
            cards.add(torch.cuda.current_device())
            cards.update(a.device.index for a in args
                         if isinstance(a, torch.Tensor))
            return real(name, *args, **kwargs)
        kernels.call = call
        return self

    def __exit__(self, *exc):
        self._kernels.call = self._real


def phase_b4(cfg, devs: list):
    """B4: path B on card 0 of a host whose cards are ``devs``,
    unchanged: its global BA takes ``run_global_ba``'s sharded branch
    over every card (``parallel.local_devices``), with no flag.  Bars:
    B's own, the global BA sharded over ``devs`` with its chain segments
    on every card, each card's peak memory above 0, the hand-written
    kernels on card 0 only.  Prints the loop,
    its matches, the ATE beside one card's run and the loop keyframe's
    split (``LoopWatch``).  Returns path B's record (the global BA's
    problem and result, the essential graph, the map before the global
    BA) and its kernel launches."""
    import torch
    device = devs[0]
    for i in _cards_of(devs):
        torch.cuda.reset_peak_memory_stats(i)
    record = {}
    with ChainDevices() as segs, KernelDevices() as kcards:
        launches = phase_loop(device, cfg, record=record, watch=True)
    peak = [torch.cuda.max_memory_allocated(i) for i in _cards_of(devs)]
    cards = [str(d) for d in devs]
    b = record["b"]
    log(f"B4: loop {b['loop']}; keyframe ATE {b['ate']:.4f} against the "
        f"priors' {b['ate_prior']:.4f} (one card: "
        f"{B_ONE_CARD_ATE[0]:.4f} against {B_ONE_CARD_ATE[1]:.4f}); "
        f"{b['n_ok']}/{b['n_frames']} frames OK; the first loop's frame "
        f"{b['first_loop_ms']:.1f} ms; global BA sharded over "
        f"{record.get('gba_devices')}; chain segments by card "
        f"{json.dumps({f'{n}@{d}': c for (n, d), c in segs.counts.items()})}"
        f"; peak memory by card (MiB) "
        f"{[round(p / 2 ** 20, 1) for p in peak]}; kernels launched on "
        f"cards {sorted(kcards.cards)}: {json.dumps(launches)}")
    check(record.get("gba_devices") == cards, f"B4: the global BA ran on "
          f"{record.get('gba_devices')}, not sharded over {cards}")
    check(segs.cards("ba") == sorted(set(cards)), f"B4: the global BA's "
          f"chains ran on {segs.cards('ba')}, not on {cards}")
    check(all(p > 0 for p in peak), f"B4: a card allocated nothing: {peak}")
    check(kcards.cards == {0}, f"B4: kernels launched on cards "
          f"{sorted(kcards.cards)}")
    return record, launches


def psum_cards(devs: list) -> None:
    """``LocalMesh.psum`` across the cards: each shard's partial comes
    after a wait on its card's stream (``torch.cuda._sleep``), and every
    shard's sum must be bitwise equal to the others' and to the sum in
    shard order on one card."""
    import torch
    from orb_slam2_tpu_torch import parallel
    rng = np.random.default_rng(0)
    parts = [rng.normal(size=(1 << 20,)).astype(np.float32) for _ in devs]

    def body(d, dev, psum):
        x = torch.as_tensor(parts[d]).to(dev)
        torch.cuda._sleep(20_000_000)
        return psum(x * 1.0).cpu()
    got = parallel.LocalMesh(devs).run(body)
    acc = torch.as_tensor(parts[0]).to(devs[0])
    for p in parts[1:]:
        acc = acc + torch.as_tensor(p).to(devs[0])
    want = acc.cpu()
    check(all(torch.equal(got[d], want) for d in got),
          f"F4: LocalMesh.psum over {len(devs)} cards differs from the sum "
          f"in shard order on one card")


def phase_f4_local(record: dict, devs: list) -> dict:
    """F4-local: path F's three solves of B4's first loop correction on
    ``LocalMesh(devs)``, one shard a card (``f_solves``): graphed, bit for
    bit the eager solve on every shard, replicated state bitwise equal,
    each shard's point rows on its card, within the F bars of the
    single-device solve, a warm call with no host sync and no capture;
    the chains' segments on every card.  Before them the mesh's psum
    across the cards (``psum_cards``) and which pairs of cards have peer
    access; after them the result of B4's global BA against its
    recorded problem solved on one card (the single-device solve of
    ``f_solves``), within the F bars."""
    import torch
    n_cards = len(devs)
    peer = {f"{i}->{j}": torch.cuda.can_device_access_peer(i, j)
            for i in _cards_of(devs) for j in _cards_of(devs) if i != j}
    log(f"F4: peer access between the cards: {json.dumps(peer)}")
    psum_cards(devs)
    log(f"F4: LocalMesh.psum over {n_cards} cards bitwise equal on every "
        f"shard and to the shard-order sum on one card")
    with ChainDevices() as segs:
        out = f_solves(devs[0], record, devs, "F4")
    cards = sorted({str(d) for d in devs})
    for chain in ("ba", "pose_graph"):
        check(segs.cards(chain) == cards, f"F4: the {chain} chains ran on "
              f"{segs.cards(chain)}, not on {cards}")
    g = _gaps(record["gba_result"], out["single"])
    log(f"F4: B4's global BA on {n_cards} cards against its recorded "
        f"problem solved on one card: {json.dumps(g)}; bars "
        f"{json.dumps(out['bars'])}")
    check(_within(g, out["bars"]), f"F4: B4's global BA misses the bars "
          f"{json.dumps(out['bars'])}: {json.dumps(g)}")
    for name in ("distributed_bundle_adjust",
                 "distributed_bundle_adjust_sharded_points",
                 "distributed_pose_graph"):
        r = out[name]
        log(f"F4 summary {name}: {n_cards} cards first {r['first_ms']:.1f}"
            f" ms, warm {r['warm_ms']:.1f} ms; one card first "
            f"{r['single_ms']:.1f} ms, warm {r['single_warm_ms']:.1f} ms; "
            f"peak memory by card (MiB) {json.dumps(r['peak_mib'])}")
    out["gba_one_card"] = g
    return out


def w_problem(n_dev: int, load: int) -> tuple:
    """tools/weak_scaling.py's problem for a mesh of ``n_dev`` devices
    at ``load`` observations a device (4 a point, 8 cameras a device,
    ``seed = n_dev``, camera 0 fixed): the arguments of
    ``distributed_bundle_adjust_sharded_points`` after the mesh."""
    from orb_slam2_tpu_torch import interop
    (cams, pts, ocam, opt, uv, sig, valid,
     fx, fy, cx, cy) = interop.weak_scaling_problem(
        load * n_dev // 4, 8 * n_dev, 4, seed=n_dev)
    fixed = np.zeros(len(cams), bool)
    fixed[0] = True
    return (cams, pts, ocam, opt, uv, sig, valid, fixed, fx, fy, cx, cy)


def w_solve(mesh, w: tuple):
    """The tool's solve: the point-sharded BA, its options."""
    from orb_slam2_tpu_torch import parallel
    return parallel.distributed_bundle_adjust_sharded_points(
        mesh, *w, iters=W_ITERS, cg_iters=W_CG_ITERS, use_huber=False)


def w_row(mesh, w: tuple, label: str) -> tuple:
    """One weak-scaling row, its cards cleared of earlier chains
    (``graphs.clear_chains``): the first call (its captures) and W_WARM
    warm calls, each equal to the first bit for bit and capturing
    nothing; the median warm call, obs/s, each card's peak memory
    allocated and reserved (a chain's graphs keep their pool's blocks
    reserved), the final cost.  Returns (row, result)."""
    import torch
    from orb_slam2_tpu_torch import graphs
    # the chains of the rows before, and their graphs' memory pools, go
    graphs.clear_chains()
    torch.cuda.empty_cache()
    cards = _cards_of(mesh.devices)
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
    res, first_ms = _timed_all(lambda: w_solve(mesh, w), mesh.devices)
    n_cap = _captures()
    warm = []
    for _ in range(W_WARM):
        again, ms = _timed_all(lambda: w_solve(mesh, w), mesh.devices)
        warm.append(ms)
        check(all(torch.equal(a, b) for a, b in zip(again, res)),
              f"{label}: a warm solve differs from the first")
    check(_captures() == n_cap, f"{label}: a warm solve captured "
          f"{_captures() - n_cap} graphs")
    ms = float(np.median(warm))
    n_obs = len(w[2])
    row = dict(cards=mesh.size, n_obs=n_obs, n_pts=len(w[1]),
               first_ms=first_ms, warm_ms=warm, ms=ms,
               obs_s=n_obs / ms * 1e3, cost=float(res.final_cost),
               peak_mib=[round(torch.cuda.max_memory_allocated(i) / 2 ** 20,
                               1) for i in cards],
               reserved_mib=[round(torch.cuda.max_memory_reserved(i)
                                   / 2 ** 20, 1) for i in cards])
    log(f"{label}: {json.dumps(row)}")
    return row, res


def phase_w(devs: list, bars: dict) -> dict:
    """W, the port's counterpart of tools/weak_scaling.py: the tool's
    problems (``w_problem``) solved by ``w_solve`` on ``LocalMesh(devs[:n])``
    for n in W_CARDS at each load of W_LOADS (``w_row``); then the
    largest problem of the most cards solved on one card (strong
    scaling: the same problem), which must be within the bars of the
    many-card result: path F's ``bars``, or F_SUM_ORDER_FACTOR
    times the gap between two one-card solves of it whose observations
    come in other orders (sums in another order only) where that is
    larger.  Returns the rows, the strong-scaling row, the many-card
    result and the bars."""
    import torch
    from orb_slam2_tpu_torch import parallel
    rows, big = [], None
    for load in W_LOADS:
        for n in W_CARDS:
            w = w_problem(n, load)
            row, res = w_row(parallel.LocalMesh(devs[:n]), w,
                             f"W {n} card(s), {load} obs a card")
            rows.append(dict(row, load=load))
            if (n, load) == (W_CARDS[-1], W_LOADS[-1]):
                big = (w, res)
            del res
    w, res_n = big
    one = parallel.LocalMesh(devs[:1])
    strong, res_1 = w_row(one, w, f"W strong: {len(w[2])} obs on one card")
    # the sum order alone on this problem: the same solve on one card
    # with the observations in another order (its cameras share one
    # rotation and lie on a line: a flat valley that magnifies rounding)
    perm = np.random.default_rng(0).permutation(len(w[2]))
    res_p = w_solve(one, (*w[:2], *(a[perm] for a in w[2:7]), *w[7:]))
    inlier = torch.empty_like(res_p.obs_inlier)
    inlier[torch.as_tensor(perm, device=inlier.device)] = res_p.obs_inlier
    order = _gaps(res_p._replace(obs_inlier=inlier), res_1)
    wbars = {k: max(v, bars[k]) for k, v in _bars(order).items()}
    g = _gaps(res_1, res_n)
    log(f"W strong: one card against {W_CARDS[-1]} cards on the same "
        f"problem {json.dumps(g)}; the observations in another order on "
        f"one card {json.dumps(order)}; bars {json.dumps(wbars)}")
    check(_within(g, wbars), f"W: one card's solve misses the bars "
          f"{json.dumps(wbars)} of {W_CARDS[-1]} cards': {json.dumps(g)}")
    return dict(rows=rows, strong=dict(strong, **g), result=res_n,
                bars=wbars)


def w_table(w: dict, nccl: dict, smi: list) -> str:
    """Phase W's table, as the tool prints its own, the cards' names and
    power limits above it."""
    lines = ["cards: " + " | ".join(smi), "",
             "| devices | observations | mesh | first s | warm s (median"
             f" of {W_WARM}) | obs/s | obs/s/device | peak MiB a card "
             "(reserved) | final cost |",
             "|---|---|---|---|---|---|---|---|---|"]
    base = {}
    for r in w["rows"]:
        per = r["obs_s"] / r["cards"]
        base.setdefault(r["load"], per)
        lines.append(
            f"| {r['cards']} | {r['n_obs']:,} | local | "
            f"{r['first_ms'] / 1e3:.3f} | {r['ms'] / 1e3:.3f} | "
            f"{r['obs_s']:,.0f} | {per:,.0f} "
            f"({100 * per / base[r['load']]:.0f}%) | "
            f"{max(r['peak_mib']):,.0f} ({max(r['reserved_mib']):,.0f}) | "
            f"{r['cost']:.1f} |")
    s = w["strong"]
    lines.append(f"| 1 (strong) | {s['n_obs']:,} | local | "
                 f"{s['first_ms'] / 1e3:.3f} | {s['ms'] / 1e3:.3f} | "
                 f"{s['obs_s']:,.0f} | {s['obs_s']:,.0f} | "
                 f"{max(s['peak_mib']):,.0f} ({max(s['reserved_mib']):,.0f})"
                 f" | {s['cost']:.1f} |")
    if nccl:
        ms = float(np.median(nccl["warm_ms"]))
        rate = nccl["n_obs"] / ms * 1e3
        lines.append(f"| {nccl['world']} | {nccl['n_obs']:,} | NCCL, "
                     f"captured | {nccl['first_ms'] / 1e3:.3f} | "
                     f"{ms / 1e3:.3f} | {rate:,.0f} | "
                     f"{rate / nccl['world']:,.0f} | - | "
                     f"{nccl['cost']:.1f} |")
    return "\n".join(lines)


def four_cards(cfg, world, smi: list) -> tuple:
    """``--cards 4``: phase 2 on card 0, then B4, F4-local, W and
    F4-NCCL (see the module).  Returns phase 2's timings and B4's
    kernel launches, with K4's from path C."""
    import torch
    from orb_slam2_tpu_torch import graphs, kernels
    from orb_slam2_tpu_torch.matching import hamming_top2 as ht
    require_cards(CARDS)
    devs = [torch.device("cuda", i) for i in range(CARDS)]
    for d in devs:          # each card's context and allocator, up front
        torch.zeros(1, device=d)
    n = len(devs)
    device = devs[0]
    timing = phase_kernels(device, world, cfg)
    record, launches = phase_b4(cfg, devs)
    k4_ref = ht.hamming_top2_plain(*k4_problem(4096, 4096, 0.2, 4, device))
    launches["hamming_top2"] = phase_k4(device, k4_ref)["hamming_top2"]
    kernels.reset_launch_counts()
    f4 = phase_f4_local(record, devs)
    w = phase_w(devs, f4["bars"])
    bargs, skw, pargs, pkw = f4["problems"]
    # the ranks' processes share the cards: this one's chains go first
    graphs.clear_chains()
    torch.cuda.empty_cache()
    nccl = phase_nccl(bargs, skw, pargs, pkw, world=n,
                      w_load=W_LOADS[-1], label="F4/NCCL",
                      timeout=F4_NCCL_TIMEOUT_S)
    check(sum(kernels.LAUNCHES.values()) == 0,
          f"F4: kernels launched: {dict(kernels.LAUNCHES)}")
    for name, single, bars in (
            ("distributed_bundle_adjust", f4["single"], f4["bars"]),
            ("distributed_bundle_adjust_sharded_points", f4["single"],
             f4["bars"]),
            ("distributed_pose_graph", f4["psingle"], f4["pbars"])):
        r = nccl[name]
        got = type(single)(*map(torch.as_tensor, nccl["results"][name]))
        g = _gaps(got, single)
        log(f"F4/NCCL summary {name}: warm captured "
            f"{r['captured']['warm_ms']:.1f} ms, cut "
            f"{r['cut']['warm_ms']:.1f} ms on {n} ranks; local mesh of "
            f"{n} cards {f4[name]['warm_ms']:.1f} ms; one card "
            f"{f4[name]['single_warm_ms']:.1f} ms; against the single "
            f"device {json.dumps(g)}")
        check(_within(g, bars), f"F4/NCCL: {name} misses the bars "
              f"{json.dumps(bars)}: {json.dumps(g)}")
    got = type(f4["single"])(*map(torch.as_tensor, nccl["results"]["w"]))
    g = _gaps(got, w["result"])
    log(f"W NCCL: {n} ranks against the local mesh of {n} cards on the "
        f"same problem: {json.dumps(g)}")
    check(_within(g, w["bars"]), f"W: the NCCL ranks' solve misses the "
          f"bars {json.dumps(w['bars'])}: {json.dumps(g)}")
    log("W table\n" + w_table(w, nccl.get("w"), smi))
    return timing, launches


def rotation_deg(Ta, Tb) -> float:
    """The angle between the rotations of two poses, in degrees."""
    c = (np.trace(Ta[:3, :3] @ Tb[:3, :3].T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def centers(poses) -> np.ndarray:
    """Camera centers (N, 3) of poses Tcw."""
    return np.stack([-T[:3, :3].T @ T[:3, 3] for T in poses])


# path D's programs (the JAX package's jit sites on its per-frame and
# relocalization path) by label: the module under orb_slam2_tpu_torch
# and its attribute that holds the CUDA graph, which the tracker and the
# relocalizer look up at each call
D_PROGRAMS = (
    ("match_last", "pipeline.tracking", "match_last_graph"),
    ("frustum_search", "pipeline.tracking", "frustum_graph"),
    ("pose_opt", "pipeline.tracking", "pose_opt_graph"),
    ("reproj_chi2_gate", "pipeline.tracking", "chi2_gate_graph"),
    ("search_descriptors", "pipeline.tracking", "descriptors_graph"),
    ("pnp_ransac", "pipeline.relocalization", "pnp_graph"),
    ("kf_projection_search", "pipeline.relocalization",
     "kf_projection_graph"),
)


class DPrograms:
    """Path D's programs (D_PROGRAMS), each module attribute wrapped so
    that, while ``keep`` is set, its calls (the graph, the arguments,
    the outputs) are kept under ``calls[keep][label]``.  An older
    checkout's port (--tree) has no such graphs: then ``graphed`` is
    False and nothing is wrapped."""

    def __init__(self):
        import importlib
        self.keep = None
        self.calls = {}
        self._saved = []
        mods = [importlib.import_module(f"orb_slam2_tpu_torch.{m}")
                for _, m, _ in D_PROGRAMS]
        self.graphed = all(hasattr(m, a) for m, (_, _, a)
                           in zip(mods, D_PROGRAMS))
        if not self.graphed:
            return
        for m, (label, _, attr) in zip(mods, D_PROGRAMS):
            g = getattr(m, attr)
            self._saved.append((m, attr, g))
            setattr(m, attr, self._wrap(label, g))

    def _wrap(self, label, g):
        def call(*args):
            out = g(*args)
            if self.keep is not None:
                self.calls.setdefault(self.keep, {}).setdefault(
                    label, []).append((g, args, out))
            return out
        return call

    def restore(self):
        for m, attr, g in self._saved:
            setattr(m, attr, g)

    def check(self, keys) -> dict:
        """Phase G on path D: every kept call under ``keys``, made
        again, against the same call with every graph run eagerly
        (``graphs.Graphed.__call__`` patched to call its function), bit
        for bit, and against the output the run got; then each program's
        last call under ``torch.cuda.set_sync_debug_mode("error")`` (a
        warm call waits for the card nowhere), its time warm and eager
        (host clock between two ``torch.cuda.synchronize()``) and the
        eager call's kernel launches (torch.profiler).
        Every program of D_PROGRAMS must have been called."""
        import torch
        from orb_slam2_tpu_torch import graphs
        checked = {}
        for key in keys:
            for label, calls in self.calls.get(key, {}).items():
                for k, (g, args, out) in enumerate(calls):
                    again = _leaves(g(*args))
                    saved = graphs.Graphed.__call__
                    graphs.Graphed.__call__ = lambda gr, *a: gr.fn(*a)
                    try:
                        want = _leaves(g(*args))
                    finally:
                        graphs.Graphed.__call__ = saved
                    torch.cuda.synchronize()
                    for j, (a, b, o) in enumerate(zip(again, want,
                                                      _leaves(out))):
                        check(torch.equal(a, b) and torch.equal(o, b),
                              f"G: D's {label} differs from its eager call "
                              f"in output {j} (call {k} of {key})")
                g, args, _ = calls[-1]
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    g(*args)
                except RuntimeError as e:
                    raise SmokeFailure(f"G: a warm call of D's {label} "
                                       f"synchronizes with the host: {e}")
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                ms = {}
                for how in ("graph", "eager"):
                    saved = graphs.Graphed.__call__
                    if how == "eager":
                        graphs.Graphed.__call__ = lambda gr, *a: gr.fn(*a)
                    try:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        g(*args)
                        torch.cuda.synchronize()
                        ms[how] = round((time.perf_counter() - t0) * 1e3, 3)
                    finally:
                        graphs.Graphed.__call__ = saved
                saved = graphs.Graphed.__call__
                graphs.Graphed.__call__ = lambda gr, *a: gr.fn(*a)
                try:
                    ms["eager_launches"] = runtime_counts(
                        lambda: g(*args))["launches"]
                finally:
                    graphs.Graphed.__call__ = saved
                n, shapes, _ = checked.get(label, (0, None, None))
                checked[label] = (n + len(calls), shapes or [
                    tuple(a.shape) for a in args
                    if isinstance(a, torch.Tensor)][:2], ms)
        missing = [p[0] for p in D_PROGRAMS if p[0] not in checked]
        check(not missing, f"G: path D made no call of {missing}")
        return checked


def phase_estimated(device, world, cfg) -> dict:
    """Path D: estimated-pose mode at full width.  Path A's world, a
    D_FRAMES sweep, ``pose_prior=False``, System(enable_loop_closing=True,
    async_mapping=False), ``track_monocular(image, t)`` with no pose: the
    H/F two-view bootstrap (a planar world: H), the motion model,
    pose-optimizing local BA.  Each frame's host syncs (SyncCounter;
    bar: none on a steady frame that maps no keyframe and captures no
    graph), its time, and whether it mapped a keyframe; the frames of
    D_PROFILE under torch.profiler instead of the clock (their kernel
    and graph launches).  Then two EPnP relocalizations: a noise frame
    goes LOST, and a mapped keyframe's image, shown again with no pose,
    must relocalize to the pose tracked for it, the second against
    another keyframe.  Then phase G on path D's programs (DPrograms:
    the calls of the last steady frame of the sweep and of the first
    relocalization against their eager calls, bit for bit, and a warm
    call of each with no host sync) and their graphs' captures (bar:
    at most graphs.MAXSIZE a graph).  Returns the run's summary."""
    import copy
    import dataclasses
    import torch
    from orb_slam2_tpu_torch import graphs, kernels
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
    tr = system.tracker
    progs = DPrograms()
    syncs = SyncCounter()
    track = syncs.wrap(system.track_monocular, "tracker")
    stats0 = {k: dict(v) for k, v in graphs.STATS.items()}

    def n_captures():
        return sum(v["captures"] for v in graphs.STATS.values())

    init_calls = []
    initialize = tr._initialize

    def timed_initialize(frame, prior):
        t0 = time.perf_counter()
        try:
            return initialize(frame, prior)
        finally:
            init_calls.append(dict(frame=frame.frame_id, ok=tr.state
                                   == TrackState.OK,
                                   ms=(time.perf_counter() - t0) * 1e3))
    tr._initialize = timed_initialize

    def step(img, t, keep=None, profile=False):
        """One frame: (frame, row) with its host time (None when
        profiled), syncs, captures, keyframe flag."""
        s0, c0 = syncs.counts["tracker"], n_captures()
        progs.keep = keep
        rt, ms = None, None
        try:
            if profile:
                out = []
                rt = runtime_counts(lambda: out.append(track(img, t)))
                frame = out[0]
            else:
                t0 = time.perf_counter()
                frame = track(img, t)
                ms = (time.perf_counter() - t0) * 1e3
        finally:
            progs.keep = None
        return frame, dict(ms=ms, state=system.state.name,
                           syncs=syncs.counts["tracker"] - s0,
                           captures=n_captures() - c0,
                           kf=tr.last_kf_frame_id == frame.frame_id,
                           runtime=rt)

    kernels.reset_launch_counts()
    rows = []
    try:
        with syncs:
            for i, img in enumerate(frames):
                keep = i if (progs.graphed
                             and i >= D_FRAMES - D_WATCH) else None
                _, row = step(img, i * 0.1, keep, profile=i in D_PROFILE)
                rows.append(row)
                log(f"D frame {i:2d}: {row['state']:15s} "
                    f"inliers={tr.matches_inliers:5d} "
                    f"kfs={system.store.n_valid_keyframes():3d} "
                    f"syncs={row['syncs']:4d} captures={row['captures']}"
                    f"{' keyframe' if row['kf'] else ''} " + (
                        f"{row['ms']:9.1f} ms" if row['ms'] is not None
                        else f"profiled {json.dumps(row['runtime'])}"))
            launches = dict(kernels.LAUNCHES)
            states = [r["state"] for r in rows]
            ok_idx = [i for i, s in enumerate(states) if s == "OK"]
            check(bool(ok_idx) and ok_idx[0] < D_INIT_BY,
                  f"D: not initialized within {D_INIT_BY} frames: {states}")
            first = ok_idx[0]
            ok_share = (len(ok_idx) - 1) / (D_FRAMES - first - 1)
            check(ok_share >= D_MIN_OK, f"D: only {ok_share:.3f} of the "
                  f"frames after initialization OK")
            est = centers([system.trajectory[i][2] for i in ok_idx])
            gt = centers([poses[i] for i in ok_idx])
            flown = float(np.linalg.norm(np.diff(centers(poses), axis=0),
                                         axis=1).sum())
            ate = ate_rmse(est, gt, align="sim3")
            check(bool(np.isfinite(est).all()),
                  "D: a tracked pose is not finite")
            check(ate < D_ATE_SHARE * flown, f"D: ATE {ate:.4f} over "
                  f"{D_ATE_SHARE} of the {flown:.2f} units flown")
            for k in ("fast_score", "masked_top2_mutual", "masked_top2_epi"):
                check(launches[k] > 0, f"D: kernel {k} never launched")
            n_kf = system.store.n_valid_keyframes()
            check(n_kf >= D_MIN_KEYFRAMES, f"D: only {n_kf} keyframes "
                  f"after {D_FRAMES} frames (a loss would reset the map)")
            model = {True: "H", False: "F", None: "none"}[
                tr.init_used_homography]
            log(f"D: the two-view bootstrap took model {model} (homography "
                f"on a planar world)")
            check(model == "H", f"D: the bootstrap took model {model}, "
                  f"not H, on a planar world")
            boot = [c for c in init_calls if c["ok"]]
            log(f"D: the bootstrap (Tracker._initialize, eager) at frame "
                f"{first}: {boot[0]['ms'] if boot else float('nan'):.1f} ms "
                f"(host clock); its calls before it "
                f"{[round(c['ms'], 1) for c in init_calls if not c['ok']]}")
            after = rows[first + 1:]
            steady = [r for r in after if r["state"] == "OK" and not r["kf"]
                      and r["ms"] is not None]
            quiet = [r for r in steady if r["captures"] == 0]
            keyed = [r for r in after if r["kf"] and r["ms"] is not None]
            all_ms = [r["ms"] for r in after if r["ms"] is not None]
            log(f"D: initialized at frame {first} (two-view, "
                f"{len(ok_idx)}/{D_FRAMES} frames OK, {ok_share:.3f} after "
                f"it), {n_kf} keyframes, {system.store.n_valid_points()} map "
                f"points; Sim3-aligned ATE of the camera centers {ate:.4f} "
                f"over {flown:.2f} units flown ({ate / flown:.5f} of it); "
                f"frame time (host clock per call) median "
                f"{np.median(all_ms):.1f} ms, max {np.max(all_ms):.1f} ms; "
                f"frames without a keyframe {len(steady)}, median "
                f"{np.median([r['ms'] for r in steady]):.1f} ms (without a "
                f"capture {len(quiet)}, median "
                f"{np.median([r['ms'] for r in quiet]) if quiet else float('nan'):.1f}"
                f" ms); frames with a keyframe {len(keyed)}, median "
                f"{np.median([r['ms'] for r in keyed]) if keyed else float('nan'):.1f}"
                f" ms")
            quiet_syncs = [r["syncs"] for r in after if r["state"] == "OK"
                           and not r["kf"] and r["captures"] == 0]
            prof = [r for r in after if r["runtime"] is not None]
            log(f"D: host syncs a frame after the bootstrap "
                f"{[r['syncs'] for r in after]}; on the steady frames "
                f"without a capture {quiet_syncs}; the frames under "
                f"torch.profiler {json.dumps([dict(r['runtime'], keyframe=r['kf'], captures=r['captures']) for r in prof])}")
            log(f"D: host syncs by site "
                f"{json.dumps(syncs.sites['tracker'].most_common(12))}")
            if progs.graphed:
                check(quiet_syncs and max(quiet_syncs) == 0,
                      f"D: a steady frame without a keyframe or a capture "
                      f"made host syncs: {quiet_syncs}")
            log(f"D: kernel launches {json.dumps(launches)}")
            rep = system.mapper.timer.report()
            lba = {k: dict(calls=rep[k][0],
                           mean_ms=round(rep[k][2] * 1e3, 2),
                           max_ms=round(system.mapper.timer.maxv[k] * 1e3,
                                        2))
                   for k in ("lba/gather", "lba/device", "lba/apply")
                   if k in rep}
            log(f"D: the pose-optimizing local BA per keyframe (host clock) "
                f"{json.dumps(lba)}")

            # two EPnP relocalizations: each a noise frame, then a mapped
            # keyframe's image
            rng = np.random.default_rng(0)
            noise = torch.as_tensor(rng.uniform(0, 255, (
                cfg.cam.height, cfg.cam.width)).astype(np.float32),
                device=device)
            est_flown = float(np.linalg.norm(np.diff(est, axis=0),
                                             axis=1).sum())
            kf_frames = sorted(kf.frame.frame_id for kf in system.store.kfs
                               if kf.valid)
            reloc = []
            t = D_FRAMES * 0.1
            for n, j in enumerate(kf_frames[-1:-3:-1]):
                step(noise, t)
                check(system.state == TrackState.LOST,
                      f"D: noise frame {n + 1} is {system.state.name}, not "
                      f"LOST")
                check(system.store.n_valid_keyframes() >= D_MIN_KEYFRAMES,
                      "D: the loss reset the map")
                frame, row = step(frames[j], t + 0.1,
                                  keep=f"reloc{n + 1}" if progs.graphed
                                  else None)
                t += 0.2
                check(system.state == TrackState.OK
                      and tr.last_reloc_frame_id == frame.frame_id,
                      f"D: frame {j}'s image shown again did not relocalize "
                      f"({system.state.name})")
                T_tracked = system.trajectory[j][2]
                dc = float(np.linalg.norm(centers([frame.Tcw])[0]
                                          - centers([T_tracked])[0]))
                deg = rotation_deg(frame.Tcw, T_tracked)
                reloc.append(dict(frame=j, ms=row["ms"], syncs=row["syncs"],
                                  captures=row["captures"]))
                log(f"D: relocalization {n + 1}: the image of keyframe frame "
                    f"{j} in {row['ms']:.1f} ms ({row['syncs']} host syncs, "
                    f"{row['captures']} captures) with {tr.matches_inliers} "
                    f"inliers: center {dc:.5f} from the tracked one "
                    f"({dc / est_flown:.5f} of the {est_flown:.3f} map units "
                    f"flown), rotation {deg:.4f} deg")
                check(dc < 0.01 * est_flown and deg < D_RELOC_DEG,
                      f"D: relocalization {n + 1}: pose {dc:.4f} units / "
                      f"{deg:.3f} deg from the tracked one")
            log(f"D: relocalization times {reloc[0]['ms']:.1f} ms (first) "
                f"and {reloc[1]['ms']:.1f} ms (second)")

        stats = {}
        for name in graphs.STATS:
            now, was = graphs.STATS[name], stats0.get(name, {})
            d = {k: round(now[k] - was.get(k, 0), 2) for k in now}
            if d["captures"] or d["replays"]:
                stats[name] = d
        log(f"D: the graphs' captures and replays over the run "
            f"{json.dumps(stats)}")
        if progs.graphed:
            for label, mod, _ in D_PROGRAMS:
                n_cap = stats.get(label, {}).get("captures", 0)
                check(n_cap <= graphs.MAXSIZE, f"D: {label} captured "
                      f"{n_cap} times, more than its {graphs.MAXSIZE} kept")
            # the programs the run did not call, called once on its
            # state: the chi2 gate (pose-prior mode's) on the last
            # relocalized frame's bindings, and the relocalizer's
            # projection search if its escalation did not run
            last = max((i for i in range(D_FRAMES - D_WATCH, D_FRAMES)
                        if i in progs.calls and not rows[i]["kf"]
                        and rows[i]["captures"] == 0), default=None)
            check(last is not None, "D: no steady frame among the last "
                  f"{D_WATCH} of the sweep")
            progs.keep = "extra"
            try:
                fcopy = copy.copy(tr.last_frame)   # the relocalized one
                fcopy.mp_ids = tr.last_frame.mp_ids.copy()
                tr._pose_chi2_filter(fcopy)
                if "kf_projection_search" not in progs.calls.get(
                        "reloc1", {}):
                    fcopy.mp_ids = np.full_like(fcopy.mp_ids, -1)
                    system.relocalizer._project_kf_points(
                        system.store.valid_kf_ids()[-1], fcopy, th=10.0)
            finally:
                progs.keep = None
            checked = progs.check([last, "reloc1", "extra"])
            log(f"G: path D's programs bit-exact against their eager calls "
                f"(steady frame {last}, the first relocalization, the "
                f"extra calls) and a warm call of each with no host sync; "
                f"calls, first shapes, the last call's ms as a graph and "
                f"eager and its eager kernel launches "
                f"{json.dumps(checked)}")
    finally:
        progs.restore()
        tr._initialize = initialize
    system.shutdown()
    summary = dict(
        init_frame=first, bootstrap_ms=boot[0]["ms"] if boot else None,
        steady_median_ms=float(np.median([r["ms"] for r in steady])),
        quiet_median_ms=(float(np.median([r["ms"] for r in quiet]))
                         if quiet else None),
        keyframe_median_ms=(float(np.median([r["ms"] for r in keyed]))
                            if keyed else None),
        n_steady=len(steady), n_quiet=len(quiet), n_keyframe=len(keyed),
        steady_syncs=quiet_syncs,
        profiled=[dict(r["runtime"], keyframe=r["kf"],
                       captures=r["captures"]) for r in prof],
        reloc_ms=[r["ms"] for r in reloc], ate=ate, flown=flown,
        launches=launches)
    log(f"D summary {json.dumps(summary)}")
    return summary


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
        viewer_run(root, ds, device, res["fps"], smi)
    return launches


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit RGB PNG whose rows are all filter 0 (as the port's
    viz.encode_png writes them) -> (H, W, 3) uint8; fails otherwise."""
    import struct
    import zlib
    check(data[:8] == b"\x89PNG\r\n\x1a\n", "E: not a PNG signature")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        check(struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
              == zlib.crc32(kind + body) & 0xFFFFFFFF,
              f"E: PNG chunk {kind} fails its CRC")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = hdr[:4]
    check(depth == 8 and ctype == 2, f"E: PNG header {hdr}")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h,
                                                                 1 + 3 * w)
    check(bool((raw[:, 0] == 0).all()), "E: a PNG row is filtered")
    return raw[:, 1:].reshape(h, w, 3)


def viewer_run(root: str, ds: dict, device, fps_plain: float,
               smi: str) -> None:
    """Path E with the viewer: ``cli run launch.toml --viz 0 --viz-dir
    DIR`` on the same dataset.  A thread fetches /status.json,
    /frame.png and /map.png over 127.0.0.1 while the CLI tracks, and the
    viewer's close fetches them once more after the render thread has
    drawn the last frame.  Bars: the final status has seen every frame,
    both PNGs decode (1440x1920x3 and the map's size), the frame holds
    green crosses, DIR/frame.png exists.  Prints the CLI's fps with and
    without the viewer."""
    import contextlib
    import io as io_mod
    import urllib.request
    from orb_slam2_tpu_torch import cli
    from orb_slam2_tpu_torch.utils import viz
    from orb_slam2_tpu_torch.utils.viewer import LiveViewer

    def get(url):
        return urllib.request.urlopen(url, timeout=10).read()

    urls, fetched, final = [], [], []
    init, close = LiveViewer.__init__, LiveViewer.close

    def init_hook(self, *a, **kw):
        init(self, *a, **kw)
        urls.append(f"http://127.0.0.1:{self.port}")

    def close_hook(self):
        time.sleep(1.5)     # the render thread draws the last frame
        final.append((json.loads(get(urls[0] + "/status.json")),
                      get(urls[0] + "/frame.png"), get(urls[0] + "/map.png"),
                      get(urls[0] + "/")))
        close(self)

    stop = threading.Event()

    def poll():
        while not stop.wait(0.25):
            if urls:
                try:
                    st = json.loads(get(urls[0] + "/status.json"))
                    png = get(urls[0] + "/frame.png")
                    # before the first frame the status has no count
                    if "frames_seen" in st:
                        fetched.append((st["frames_seen"], len(png)))
                except OSError:
                    pass

    vdir = os.path.join(root, "viz")
    stdout = io_mod.StringIO()
    poller = threading.Thread(target=poll, daemon=True)
    LiveViewer.__init__, LiveViewer.close = init_hook, close_hook
    poller.start()
    try:
        with contextlib.redirect_stdout(stdout):
            rc = cli.main(["run", ds["launch"], "--out",
                           os.path.join(root, "OutViz"), "--device",
                           str(device), "--viz", "0", "--viz-dir", vdir])
    finally:
        LiveViewer.__init__, LiveViewer.close = init, close
        stop.set()
        poller.join(10)
    check(rc == 0, f"E: cli run --viz returned {rc}")
    res = json.loads(stdout.getvalue().strip().splitlines()[-1])
    check(len(final) == 1, "E: the viewer was not closed once")
    st, frame_png, map_png, html = final[0]
    check(st["frames_seen"] == res["frames"] == E_FRAMES,
          f"E: viewer saw {st['frames_seen']} of {res['frames']} frames")
    frame = decode_png(frame_png)
    check(frame.shape == (1440, 1920, 3), f"E: frame.png {frame.shape}")
    n_green = int((frame == [0, 255, 0]).all(-1).sum())
    check(n_green > 0, "E: frame.png holds no green cross")
    mp = decode_png(map_png)
    check(mp.shape == viz.MAP_SIZE + (3,), f"E: map.png {mp.shape}")
    check(b"live viewer" in html, "E: the viewer's page")
    check(os.path.exists(os.path.join(vdir, "frame.png")),
          "E: --viz-dir holds no frame.png")
    check(len(fetched) > 0, "E: nothing was fetched while the CLI tracked")
    log(f"E: viewer: {len(fetched)} fetches of /status.json + /frame.png "
        f"while the CLI tracked (frames seen {fetched[0][0]}..."
        f"{fetched[-1][0]}); at close {st['frames_seen']} frames seen, "
        f"{st['keyframes']} keyframes, frame.png {len(frame_png)} bytes "
        f"with {n_green} green pixels, map.png {len(map_png)} bytes "
        f"{mp.shape}; DIR holds {sorted(os.listdir(vdir))}")
    log(f"E: cli fps {res['fps']:.2f} with the viewer against "
        f"{fps_plain:.2f} without (the same dataset, this call, {smi})")


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


def repeat_estimated(device, world, cfg) -> int:
    """--repeat-d: path D twice in this process, one summary line each
    (``D summary``), then the two side by side."""
    runs = []
    for _ in range(2):
        try:
            runs.append(phase_estimated(device, world, cfg))
        except SmokeFailure as e:
            log(f"D repeat {len(runs)}: FAIL: {e}")
            return 1
    for k, r in enumerate(runs):
        log(f"repeat D {k}: {d_line(r)}")
    return 0


def d_line(r: dict) -> str:
    """One path-D summary in a line."""
    steady = [p for p in r["profiled"] if not p["keyframe"]]
    return (f"steady frame median {r['steady_median_ms']:.1f} ms "
            f"({r['n_steady']} frames; without a capture "
            f"{r['quiet_median_ms']}), keyframe frame median "
            f"{r['keyframe_median_ms']} ms ({r['n_keyframe']}), launches a "
            f"profiled steady frame "
            f"{[(p['launches'], p['graph_launches']) for p in steady]}, "
            f"syncs a steady frame {r['steady_syncs']}, relocalizations "
            f"{[round(x, 1) for x in r['reloc_ms']]} ms, bootstrap "
            f"{r['bootstrap_ms']} ms")


def repeat_estimated_trees(tree: str) -> int:
    """--repeat-d --tree DIR: path D in four processes, the port
    imported from DIR, this checkout, this checkout and DIR (parent,
    change, change, parent on one card), each as ``--repeat-d
    --d-once``; their output passes through, and their summaries are
    printed side by side."""
    here = os.path.abspath(__file__)
    runs = []
    for which in ("tree", "here", "here", "tree"):
        cmd = [sys.executable, here, "--repeat-d", "--d-once"]
        if which == "tree":
            cmd += ["--tree", tree]
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=900)
        sys.stdout.write(out.stdout)
        sys.stderr.write(out.stderr[-4000:])
        summary = [ln for ln in out.stdout.splitlines()
                   if ln.startswith("D summary ")]
        if out.returncode != 0 or not summary:
            log(f"D repeat ({which}): exit {out.returncode}")
            return 1
        runs.append((which, json.loads(summary[-1][len("D summary "):])))
    for which, r in runs:
        log(f"repeat D {'parent' if which == 'tree' else 'change'}: "
            f"{d_line(r)}")
    return 0


def loop_split(device, world, cfg) -> int:
    """--loop-split: path B with its loop keyframe split (LoopWatch:
    stage times, host syncs, each program's calls, first-call and
    warm-call times and a warm call's runtime calls), then path B again
    with the loop keyframe's loop-closer work under torch.profiler (its
    kernel and graph launches, copies, synchronizations; the times of
    that run include the profiler's), then path D (its pose-optimizing
    local BA's times).  With --tree the port comes from another
    checkout, whose loop closer may call its programs eagerly."""
    phase_loop(device, cfg, watch=True)
    phase_loop(device, cfg, watch=True, profile=True)
    phase_estimated(device, world, cfg)
    return 0


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
    ap.add_argument("--path-h", action="store_true",
                    help="run only path H, bench.py's run (see phase_h)")
    ap.add_argument("--path-l", action="store_true",
                    help="run only paths L and L-bench, the long runs "
                         "(see phase_l and phase_h)")
    ap.add_argument("--path-bh", action="store_true",
                    help="run only path B-height, path B over a height "
                         "field (see phase_b_height); with --path-b1m, "
                         "both")
    ap.add_argument("--path-b1m", action="store_true",
                    help="run only path B-1M, path B with a 10^6-word "
                         "ORBvoc (see phase_b_1m)")
    ap.add_argument("--path-best", action="store_true",
                    help="run only phase G's eigensolver check and paths "
                         "B-est-640 and B-est (every seed), a loop in "
                         "estimated mode (see phase_g_eigh and "
                         "phase_b_est)")
    ap.add_argument("--phases-of", metavar="DIR",
                    help="run the default run of DIR/chip_smoke.py (a "
                         "parent's checkout) with each of its phases "
                         "timed as this script's are (see time_phases)")
    ap.add_argument("--repeat-b", action="store_true",
                    help="run only path B, four times (see repeat_loop)")
    ap.add_argument("--loop-split", action="store_true",
                    help="run only path B, twice, with its loop keyframe "
                         "split (the second run under torch.profiler), "
                         "then path D (see loop_split)")
    ap.add_argument("--repeat-d", action="store_true",
                    help="run only path D, twice (see repeat_estimated); "
                         "with --tree DIR, four times in four processes: "
                         "DIR, this checkout, this checkout, DIR")
    ap.add_argument("--d-once", action="store_true",
                    help="with --repeat-d: path D once (a process of "
                         "--repeat-d --tree)")
    ap.add_argument("--repeat-f", action="store_true",
                    help="run only path B (for its record) and path F's "
                         "solves, timed (see f_times); with --tree DIR, "
                         "in four processes: DIR, this checkout, this "
                         "checkout, DIR")
    ap.add_argument("--f-once", action="store_true",
                    help="with --repeat-f: once (a process of --repeat-f "
                         "--tree)")
    ap.add_argument("--gloo-worker", nargs=3,
                    metavar=("HOST:PORT", "RANK", "PROBLEM"),
                    help="path F's process-group rank (started by path F)")
    ap.add_argument("--nccl-worker", nargs="+",
                    metavar="HOST:PORT PROBLEM [RANK WORLD]",
                    help="a rank of path F's NCCL group (one rank, or "
                         "RANK of WORLD), captured against cut (started "
                         "by path F and F4-NCCL)")
    ap.add_argument("--cards", type=int, choices=(1, CARDS), default=1,
                    help=f"{CARDS}: the four-card mode (phases 1-2, B4, "
                         f"F4-local, W, F4-NCCL) on a host with {CARDS} "
                         f"cards; 1: the default run on one card")
    ap.add_argument("--kernels-from", metavar="DIR",
                    help="run only phases 1 and 2 (build, each kernel "
                         "against its plain version, timed) with "
                         "orb_slam2_tpu_torch imported from the checkout "
                         "DIR, and print the results as one JSON line")
    ap.add_argument("--tree", metavar="DIR",
                    help="with --repeat-a, --repeat-d, --profile or "
                         "--loop-split: import "
                         "orb_slam2_tpu_torch from the checkout DIR (the "
                         "parent of a change, unpacked by git archive), "
                         "so both run under this script")
    args = ap.parse_args()
    if args.nccl_worker and len(args.nccl_worker) not in (2, 4):
        ap.error("--nccl-worker takes HOST:PORT PROBLEM [RANK WORLD]")
    if args.tree and not (args.repeat_a or args.profile or args.loop_split
                          or args.repeat_d or args.repeat_f or args.path_h
                          or args.path_l):
        ap.error("--tree goes with --repeat-a, --repeat-d, --repeat-f, "
                 "--profile, --loop-split, --path-h or --path-l")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if args.cards > 1:
        try:
            require_cards(args.cards)
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
            return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the "
              "card", file=sys.stderr)
        return 2
    if args.phases_of:
        return phases_of(os.path.abspath(args.phases_of))
    time_phases(sys.modules[__name__])
    here = os.path.dirname(os.path.abspath(__file__))
    if args.repeat_d and args.tree and not args.d_once:
        return repeat_estimated_trees(os.path.abspath(args.tree))
    if args.repeat_f and args.tree and not args.f_once:
        return repeat_dist_trees(os.path.abspath(args.tree))
    root = os.path.abspath(args.kernels_from or args.tree or here)
    if not os.path.isdir(os.path.join(root, "orb_slam2_tpu_torch")):
        print(f"chip_smoke: orb_slam2_tpu_torch/ is not in {root}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    if args.gloo_worker:
        addr, rank, problem = args.gloo_worker
        return gloo_worker(addr, int(rank), problem)
    if args.nccl_worker:
        addr, problem, *rank_world = args.nccl_worker
        try:
            return nccl_worker(addr, problem, *map(int, rank_world))
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
            return 1
    from orb_slam2_tpu_torch import kernels

    t_start = time.perf_counter()
    device = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi_all = nvidia_smi_lines()
    smi = smi_all[0]
    log(f"device: {kind} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, numpy {np.__version__}); "
        f"{torch.cuda.device_count()} card(s); "
        f"nvidia-smi: {' | '.join(smi_all)}")
    info = kernels.build(force=True)
    kernels.library()
    log(f"build: {info['seconds']:.1f} s")
    for line in info["ptxas"].splitlines():
        if any(w in line for w in ("registers", "Compiling entry",
                                    "stack frame")):
            log(f"ptxas: {line.strip()}")

    cfg = bench_config()
    world, _ = bench_world(device)
    if args.cards > 1:
        try:
            timing, launches = four_cards(cfg, world, smi_all)
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
            return 1
        return finish(timing, launches, None, t_start, smi_all, kind)
    if args.repeat_b:
        return repeat_loop(device, cfg)
    if args.tree:
        log(f"the port imported from {root}")
    if args.loop_split:
        try:
            return loop_split(device, world, cfg)
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
            return 1
    if args.repeat_f:
        try:
            record = {}
            phase_loop(device, cfg, record=record)
            log("F summary " + json.dumps(f_times(device, record)))
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
            return 1
        return 0
    if args.repeat_d:
        if not args.d_once:
            return repeat_estimated(device, world, cfg)
        try:
            phase_estimated(device, world, cfg)
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
            return 1
        return 0
    if args.repeat_a:
        try:
            return repeat_bench(device, world, cfg)
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
            return 1
    if (args.profile or args.kernels_from or args.path_h or args.path_l
            or args.path_bh or args.path_b1m or args.path_best):
        try:
            if args.path_best:
                phase_g_eigh(device)
                phase_b_est(device)
                phase_b_est(device, "B-est")
            elif args.path_bh or args.path_b1m:
                if args.path_bh:
                    phase_b_height(device, cfg)
                if args.path_b1m:
                    phase_b_1m(device, cfg)
            elif args.path_h:
                phase_h(device)
            elif args.path_l:
                phase_l(device)
                phase_h(device, LB_WINDOWS, "L-bench")
            elif args.profile:
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
        phase_graphs(device, world, cfg)
        phase_g_eigh(device)
        path_a = phase_bench(device, world, cfg)
        path_seq = phase_bench(device, world, cfg, pipelined=False)
        log(f"A against A-seq on this card: {path_a['fps']:.2f} against "
            f"{path_seq['fps']:.2f} fps, median frame "
            f"{path_a['median_ms']:.1f} against {path_seq['median_ms']:.1f}"
            f" ms, max {path_a['max_ms']:.1f} against "
            f"{path_seq['max_ms']:.1f} ms")
        path_h = phase_h(device)
        path_l = phase_l(device)
        path_lb = phase_h(device, LB_WINDOWS, "L-bench")
        launches = path_a["launches"]
        from orb_slam2_tpu_torch.matching import hamming_top2 as ht
        k4_ref = ht.hamming_top2_plain(*k4_problem(4096, 4096, 0.2, 4,
                                                   device))
        launches["hamming_top2"] = phase_k4(device, k4_ref)["hamming_top2"]
        record = {}
        phase_loop(device, cfg, record=record, watch=True)
        kernels.reset_launch_counts()
        phase_dist(device, record)
        check(sum(kernels.LAUNCHES.values()) == 0,
              f"F: kernels launched: {dict(kernels.LAUNCHES)}")
        path_bh = phase_b_height(device, cfg)
        path_b1m = phase_b_1m(device, cfg)
        path_best = phase_b_est(device)
        path_best_bench = phase_b_est(device, "B-est", first=True)
        phase_estimated(device, world, cfg)
        phase_cli(device, cfg, smi)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    return finish(timing, launches, dict(
        launches_h=path_h["launches"], launches_l=path_l["launches"],
        launches_lb=path_lb["launches"],
        launches_b_height=path_bh["launches"],
        launches_b_1m=path_b1m["launches"],
        launches_b_est=path_best["launches"],
        launches_b_est_bench=path_best_bench["launches"]), t_start, [smi],
        kind)


def finish(timing, launches, more, t_start, smi: list,
           kind: str) -> int:
    """The last lines: the kernels' JSON (``launches``: the main path's
    run; ``more``: key -> another path's launches, where they ran:
    ``launches_h`` path H's, ``launches_l`` L's, ``launches_lb``
    L-bench's, ``launches_b_height`` B-height's, ``launches_b_1m``
    B-1M's, ``launches_b_est`` B-est-640's four loop-closing runs',
    ``launches_b_est_bench`` B-est's loop-closing runs), the nvidia-smi
    line of each card used, and the ok line."""
    import torch
    rows = []
    for t in timing:
        source, replaces = KERNEL_META[t["name"]]
        h = {k: v.get(t["name"], 0) for k, v in (more or {}).items()}
        # no single PyTorch call computes any of the four functions
        rows.append(dict(name=t["name"], route="cuda", source=source,
                         replaces=replaces, launches=launches[t["name"]],
                         **h, max_abs_err=t["max_abs_err"], ms=t["ms"],
                         plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                         bound_by=t["bound_by"], library_ms=None,
                         shape=t["shape"], loop_ms=t["loop_ms"],
                         share=t["bound_ms"] / t["ms"]))
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s, the kernels' build "
        f"included")
    print(json.dumps({"kernels": rows}))
    for line in smi:
        print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
