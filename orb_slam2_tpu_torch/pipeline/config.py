"""Pipeline configuration (port of ``orb_slam2_tpu/pipeline/config.py``).

Groups the reference's YAML settings (src/Tracking.cc:93-191) and the
hard-coded thresholds scattered through Tracking/LocalMapping into one
place, with the reference values as defaults.  Field names and defaults
are those of the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..geom.camera import Intrinsics
from ..ops.extractor import OrbParams


@dataclass
class SlamConfig:
    cam: Intrinsics
    orb: OrbParams = field(default_factory=OrbParams)
    fps: float = 10.0

    # --- mode ---
    # pose_prior=True reproduces the reference fork: every frame arrives
    # with a trusted pose (TrackMonocularWithPose) and per-frame pose
    # optimization is skipped (src/Tracking.cc:240, 637).
    pose_prior: bool = False

    # --- initialization (src/Tracking.cc:392-573) ---
    init_min_keypoints: int = 100
    init_match_window: float = 100.0
    init_min_matches: int = 100
    init_min_triangulated: int = 50     # src/Initializer.cc:147-150
    init_min_tracked_after_ba: int = 100  # src/Tracking.cc:539-544

    # --- tracking gates ---
    track_prior_min_matches: int = 20   # TrackWithInitialPose (src/Tracking.cc:1060-1072)
    track_prior_min_good: int = 10
    track_refkf_min_matches: int = 15   # TrackWithReferenceKF (src/Tracking.cc:1080-1096)
    track_refkf_min_good: int = 10
    track_local_min_inliers: int = 30   # TrackLocalMap (src/Tracking.cc:641-666)
    track_local_min_inliers_reloc: int = 50
    chi2_mono: float = 5.991
    max_local_keyframes: int = 80       # src/Tracking.cc:962

    # --- keyframe decision (src/Tracking.cc:681-750) ---
    min_frames_between_kf: int = 0
    ref_ratio: float = 0.9

    # --- local mapping ---
    triangulation_neighbors: int = 20   # src/LocalMapping.cc:260
    min_baseline_depth_ratio: float = 0.01  # src/LocalMapping.cc:303-318
    mp_cull_min_ratio: float = 0.25     # src/LocalMapping.cc:206-248
    kf_cull_redundancy: float = 0.9     # src/LocalMapping.cc:688-772
    local_ba_iters: int = 10

    # --- loop closing ---
    loop_min_kfs_since_last: int = 10   # src/LoopClosing.cc:139
    loop_consistency_threshold: int = 3  # src/LoopClosing.cc:60-61
    loop_sim3_min_inliers: int = 20     # src/LoopClosing.cc:380-402
    loop_min_total_matches: int = 40    # src/LoopClosing.cc:418-460
    # Fix the loop transform's scale to 1 (6-DoF solve).  None = auto:
    # fixed in pose-prior mode, whose per-frame odometry prior is metric
    # (upstream sets bFixScale whenever the sensor gives metric scale,
    # Sim3Solver.cc:41-46, Optimizer.cc:1014).
    loop_fix_scale: bool | None = None

    # --- relocalization ---
    reloc_recent_kf_window: int = 10    # Map::GetLastKeyFrames period

    # --- padded sizes ---
    # Row counts of the padded search operands grow through
    # power-of-4 buckets starting at these floors (tracking.pad_bucket).
    # The padding decides which rows the searches see, so the port keeps
    # the JAX package's floors to give the same answers on the same
    # inputs.  Every padded size is also a static shape of a CUDA graph
    # (graphs.py): a few buckets keep the captures per function few.
    pad_min_bound: int = 256    # tracked bound points (fused step L)
    pad_min_cand: int = 256     # local-map candidates (fused step C)
    pad_min_obs: int = 256      # structure BA observation rows
    pad_min_pts: int = 256      # structure BA point rows
    # initial row capacity of the device point store (rows are
    # append-only; the store grows by 4x re-allocation past it)
    device_point_capacity: int = 65536

    # --- one-frame-lag pipelined tracking (pose-prior mode) ---
    # When True, the fused tracking step for frame t is dispatched and
    # its results are consumed at the start of a later frame (the
    # transfer runs in the background into pinned host memory), so the
    # host's wait for the results leaves the frame period.  Bindings and
    # keyframe decisions are those of the sequential mode, committed
    # later; the reported state lags.  Default off (same-frame semantics
    # for tests and tools).
    pipelined_tracking: bool = False
    # max fused steps in flight before the oldest MUST be consumed.
    # 2 = classic one/two-frame lag; with the device recurrence the
    # host consume is pure bookkeeping, so deeper pipelines only delay
    # keyframe decisions (lag x frame period), not tracking itself
    pipeline_depth: int = 2

    @property
    def max_frames_between_kf(self) -> int:
        return int(self.fps)  # mMaxFrames = fps (src/Tracking.cc:128-134)
