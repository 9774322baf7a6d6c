"""The tracking front end, in torch.

Port of ``orb_slam2_tpu/pipeline/tracking.py`` (src/Tracking.cc).  Both
tracking modes:

- ``pose_prior=True``: the reference fork's TrackMonocularWithPose
  (src/Tracking.cc:194-356).  Every frame carries a trusted pose,
  matches are gated by reprojection chi2 against it
  (CheckMatchesByProjection, src/Tracking.cc:1108-1142), and no pose is
  optimized per frame.  The steady state runs one fused step
  (:func:`_prior_step_core`) on the device: the last-frame and
  local-map projection searches through kernel K2, the chi2 gates and
  the frustum cull; the host then applies the bindings
  (:meth:`Tracker._fused_verdict`).  The map starts from the known-pose
  DLT initializer.
- ``pose_prior=False``: upstream ORB-SLAM2.  The H/F-model two-view
  initializer with a median-depth gauge, the constant-velocity motion
  model and the motion-only LM pose optimization
  (``optim/pose_opt.py``).

``cfg.pipelined_tracking`` (pose-prior mode) keeps up to
``cfg.pipeline_depth`` fused steps in flight: each step's bound set is
rebuilt on the device from the previous step's outputs
(:func:`_track_prior_chain`), its host-facing outputs are copied to
pinned host memory behind an event (:class:`_Readback`), and the host
consumes them one or more frames later.

A LOST frame goes to relocalization; when the frame-to-frame match
fails, the reference-keyframe fallback matches by descriptor, blocked by
vocabulary node once a vocabulary exists.  Host sections that read or
change the map take ``store.lock``, as the JAX package's do, so an
asynchronous mapper can run beside the tracker; the device dispatch and
read of the fused step run without it.
"""
from __future__ import annotations

import enum
from typing import Callable, Optional

import numpy as np
import torch

from ..matching import search, frustum
from ..models.frame import Frame, FrameFactory
from ..models.mapstore import MapStore
from ..geom import triangulate, twoview
from ..ops.extractor import padded_feature_count
from ..optim import ba, pose_opt
from .config import SlamConfig
from ..utils.logging import get_logger, StageTimer

log = get_logger("tracking")


class TrackState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


def pad_bucket(n: int, minimum: int = 256) -> int:
    """Round up to a power-of-4 bucket (the JAX package's padded row
    counts, kept so both packages search the same padded operands)."""
    m = minimum
    while m < n:
        m *= 4
    return m


def _project_points(Tcw, pos, fx, fy, cx, cy):
    R, t = Tcw[:3, :3], Tcw[:3, 3]
    pc = pos @ R.T + t
    z = pc[:, 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    uv = torch.stack([fx * pc[:, 0] * inv_z + cx,
                      fy * pc[:, 1] * inv_z + cy], -1)
    return uv, z


def _in_image(uv, z, bounds):
    minx, maxx, miny, maxy = bounds
    return ((z > 0) & (uv[:, 0] >= minx) & (uv[:, 0] < maxx)
            & (uv[:, 1] >= miny) & (uv[:, 1] < maxy))


def _chi2(uv, kp_xy, kp_octave, inv_sigma2, idx):
    r = uv - kp_xy[idx]
    return (r * r).sum(-1) * inv_sigma2[kp_octave[idx].long()]


def _match_last(Tcw, pos, mp_valid, row_ids,
                last_octave, last_desc, last_angle,
                kp_xy, kp_octave, kp_desc, kp_valid, kp_angle,
                scale_factors, inv_sigma2, fx, fy, cx, cy, bounds,
                th, chi2):
    """Projection + in-image gating + last-frame search.  Returns the
    match result and, with ``chi2 > 0``, the mask gated by the
    trusted-pose reprojection test (src/Tracking.cc:1108-1142), else the
    match validity."""
    row_ids = row_ids.long()
    oct_ = last_octave[row_ids].long()
    uv, z = _project_points(Tcw, pos, fx, fy, cx, cy)
    res = search.search_by_projection_last_frame(
        uv, oct_, last_desc[row_ids], mp_valid & _in_image(uv, z, bounds),
        last_angle[row_ids], kp_xy, kp_octave, kp_desc, kp_valid, kp_angle,
        scale_factors, th=th)
    if chi2 <= 0:
        return res, res.valid
    c2 = _chi2(uv, kp_xy, kp_octave, inv_sigma2, res.idx)
    return res, res.valid & (c2 <= chi2)


def _frustum_search(pos, normal, min_d, max_d, pvalid, desc,
                    Tcw, kp_xy, kp_octave, kp_desc, kp_valid,
                    kp_has_mp, old_pos, old_idx, old_valid,
                    scale_factors, inv_sigma2,
                    fx, fy, cx, cy, bounds, n_levels, log_scale, th, chi2):
    """isInFrustum + local-map projection search; with ``chi2 > 0``
    (pose-prior mode) the trusted-pose gate too, for both the new
    matches and the pre-existing bindings (old_pos/old_idx).  Returns
    (visible, match result, new-match gate, old-binding gate)."""
    fr = frustum.is_in_frustum(pos, normal, min_d, max_d, pvalid, Tcw,
                               fx, fy, cx, cy, bounds, n_levels, log_scale)
    r = search.search_by_projection_local_map(
        fr.uv, fr.pred_level, fr.view_cos, desc, fr.visible,
        kp_xy, kp_octave, kp_desc, kp_valid, kp_has_mp,
        scale_factors, th=th)
    if chi2 <= 0:
        return fr.visible, r, r.valid, old_valid

    def gate(pw, feat_idx, valid):
        uvp, z = _project_points(Tcw, pw, fx, fy, cx, cy)
        c2 = _chi2(uvp, kp_xy, kp_octave, inv_sigma2, feat_idx)
        return valid & (z > 0) & (c2 <= chi2)

    return (fr.visible, r, gate(pos, r.idx, r.valid),
            gate(old_pos, old_idx.long(), old_valid))


def _prior_step_core(Tcw,
                     pt_pos, pt_desc, pt_normal, pt_min, pt_max,
                     pt_alive,
                     bound_pid_rows, last_rows, cand_rows,
                     last_octave_all, last_desc_all, last_angle_all,
                     kp_xy, kp_octave, kp_desc, kp_valid, kp_angle,
                     scale_factors, inv_sigma2,
                     fx, fy, cx, cy, bounds, n_levels, log_scale,
                     th_last, th_local, chi2):
    """The steady-state pose-prior tracking step, all on the device:

    1. project the last frame's bound map points with the trusted pose
       and match them against the current keypoints
       (SearchByProjection(cur, last, th), src/ORBmatcher.cc:1633-1797),
    2. trusted-pose chi2 gate (CheckMatchesByProjection,
       src/Tracking.cc:1108-1142),
    3. mark the matched keypoints as bound,
    4. frustum-cull the local-map candidates (points bound in step 2
       drop out, found by a sorted search of the bound pid rows) and
       run the local-map projection search against the remaining
       keypoints (src/ORBmatcher.cc:64-160),
    5. chi2-gate the new matches.

    The map-point SoA (pt_*) is the device point store; the row vectors
    pick the last frame's bound points and the local-map candidates,
    prepared by the host (the JAX package's ``_track_prior_step``) or
    rebuilt on the device by :func:`_track_prior_chain`.  Returns
    (ridx, rvalid, gate, visible, r2idx, keep_new, bound_pid_rows): the
    first six are the host-facing results, without the JAX package's
    int16/packbits compaction (the same values; the compaction served
    its slow chip link); the last, with ridx, gate, r2idx and keep_new,
    seeds the next step of the chain."""
    b_rows = bound_pid_rows.clamp(min=0).long()
    last_pos = pt_pos[b_rows]
    last_valid = (bound_pid_rows >= 0) & pt_alive[b_rows]
    c_rows = cand_rows.clamp(min=0).long()
    cand_pos = pt_pos[c_rows]
    cand_valid = (cand_rows >= 0) & pt_alive[c_rows]

    res, gate = _match_last(
        Tcw, last_pos, last_valid, last_rows,
        last_octave_all, last_desc_all, last_angle_all,
        kp_xy, kp_octave, kp_desc, kp_valid, kp_angle,
        scale_factors, inv_sigma2, fx, fy, cx, cy, bounds, th_last, chi2)

    # per-feature "already bound" mask (mutual best => unique targets)
    has_mp = torch.zeros(kp_xy.shape[0], dtype=torch.bool,
                         device=kp_xy.device)
    has_mp[res.idx[gate]] = True

    # candidate rows whose point is gate-bound this frame drop out; -1
    # pads on both sides only ever meet rows whose gate is False
    sorted_pids, order = torch.sort(bound_pid_rows, stable=True)
    pos = torch.searchsorted(sorted_pids, cand_rows).clamp(
        0, sorted_pids.shape[0] - 1)
    row_bound = (sorted_pids[pos] == cand_rows) & gate[order[pos]]
    fr = frustum.is_in_frustum(cand_pos, pt_normal[c_rows], pt_min[c_rows],
                               pt_max[c_rows], cand_valid & ~row_bound, Tcw,
                               fx, fy, cx, cy, bounds, n_levels, log_scale)
    r2 = search.search_by_projection_local_map(
        fr.uv, fr.pred_level, fr.view_cos, pt_desc[c_rows], fr.visible,
        kp_xy, kp_octave, kp_desc, kp_valid, has_mp,
        scale_factors, th=th_local)
    uvp, z2 = _project_points(Tcw, cand_pos, fx, fy, cx, cy)
    c2n = _chi2(uvp, kp_xy, kp_octave, inv_sigma2, r2.idx)
    keep_new = r2.valid & (z2 > 0) & (c2n <= chi2)
    return (res.idx, res.valid, gate, fr.visible, r2.idx, keep_new,
            bound_pid_rows)


def _chain_rows(prev_bound_rows, prev_cand_rows, prev_ridx, prev_r2idx,
                prev_gate, prev_keep):
    """The bound set of a chain step from the previous step's device
    outputs: the previous step matched bound row i -> feature ridx[i]
    (kept iff gate[i]) and candidate row j -> feature r2idx[j] (kept iff
    keep[j]).  The kept pairs, frame-to-frame matches first, in row
    order, fill the fixed (L,) vectors (pid rows padded with -1, feature
    rows with 0).

    The searches are disjoint over features, so at most n_features
    pairs are kept, but ``L`` (the bootstrap step's padded bound count)
    can be smaller.  Then the first L pairs are taken, which is what the
    host mirror in :meth:`Tracker._fused_verdict` assumes.  (The JAX
    package scatters with repeated indices, every pair past L - 1 onto
    slot L - 1: XLA leaves the winner to the implementation; on the CPU
    the last pair wins, which the host mirror does not assume.)  Slot j
    is gathered from the first row whose running count of kept pairs
    reaches j + 1: no scatter, so no repeated index."""
    L = prev_bound_rows.shape[0]
    pid_all = torch.cat([prev_bound_rows.int(), prev_cand_rows.int()])
    row_all = torch.cat([prev_ridx.int(), prev_r2idx.int()])
    count = torch.cumsum(torch.cat([prev_gate, prev_keep]).long(), 0)
    slots = torch.arange(1, L + 1, device=count.device)
    src = torch.searchsorted(count, slots).clamp(max=len(count) - 1)
    has = slots <= count[-1]
    bound = torch.where(has, pid_all[src], torch.full_like(pid_all[src], -1))
    lrows = torch.where(has, row_all[src], torch.zeros_like(row_all[src]))
    return bound, lrows


def _track_prior_chain(Tcw,
                       pt_pos, pt_desc, pt_normal, pt_min, pt_max,
                       pt_alive,
                       prev_bound_rows, prev_cand_rows,
                       prev_ridx, prev_r2idx, prev_gate, prev_keep,
                       cand_rows,
                       last_octave_all, last_desc_all, last_angle_all,
                       kp_xy, kp_octave, kp_desc, kp_valid, kp_angle,
                       scale_factors, inv_sigma2,
                       fx, fy, cx, cy, bounds, n_levels, log_scale,
                       th_last, th_local, chi2):
    """The device-resident tracking recurrence: this step's bound set is
    rebuilt from the previous step's device outputs
    (:func:`_chain_rows`), so no host consume sits between two
    dispatches; the host reads results one or more frames behind, for
    bookkeeping only (bindings, keyframe decisions, counters).  Then the
    fused step, :func:`_prior_step_core`."""
    bound, lrows = _chain_rows(prev_bound_rows, prev_cand_rows, prev_ridx,
                               prev_r2idx, prev_gate, prev_keep)
    return _prior_step_core(
        Tcw, pt_pos, pt_desc, pt_normal, pt_min, pt_max, pt_alive,
        bound, lrows, cand_rows,
        last_octave_all, last_desc_all, last_angle_all,
        kp_xy, kp_octave, kp_desc, kp_valid, kp_angle,
        scale_factors, inv_sigma2,
        fx, fy, cx, cy, bounds, n_levels, log_scale,
        th_last, th_local, chi2)


class _Readback:
    """The host-facing outputs of one dispatched fused step, on their
    way to the host.  On the card they are queued as non-blocking copies
    into pinned host memory right after the step's launches, followed by
    an event: a consume waits on that event (not on the whole stream),
    and the copies overlap what the host does meanwhile.  A non-blocking
    copy into pageable memory would be synchronous and undo the overlap;
    the pinned tensors live here until they are read."""

    def __init__(self, tensors):
        self.event = None
        self._arrays = None
        if tensors[0].is_cuda:
            self._host = tuple(
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                .copy_(t, non_blocking=True) for t in tensors)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self._host = tuple(tensors)

    def wait(self):
        if self.event is not None:
            self.event.synchronize()

    def arrays(self):
        """The outputs as numpy arrays (waits for the copies once)."""
        if self._arrays is None:
            self.wait()
            self._arrays = tuple(t.numpy() for t in self._host)
        return self._arrays


class Tracker:
    def __init__(self, config: SlamConfig, store: MapStore,
                 factory: FrameFactory):
        self.cfg = config
        self.store = store
        self.factory = factory
        self.device = factory.device
        self.state = TrackState.NO_IMAGES_YET

        self.init_frame: Optional[Frame] = None
        self.last_frame: Optional[Frame] = None
        self.ref_kf: int = -1
        self.velocity: Optional[np.ndarray] = None  # Tcw_cur @ inv(Tcw_last)
        self.last_kf_frame_id: int = 0
        self.last_reloc_frame_id: int = -(10 ** 9)
        self.matches_inliers: int = 0
        # localization-only mode (System.activate_localization_mode):
        # no keyframe is inserted while False
        self.mapping_enabled: bool = True
        # the model the two-view initializer took (True: homography,
        # False: fundamental), set when it builds the initial map
        self.init_used_homography: Optional[bool] = None

        # wired by System
        self.on_new_keyframe: Optional[Callable[[int], None]] = None
        self.on_reset: Optional[Callable[[], None]] = None
        # async mapper's AcceptKeyFrames (None = sequential, always idle)
        self.mapping_idle: Optional[Callable[[], bool]] = None
        # Relocalizer (carries the shared PlaceRecognition)
        self.relocalize: Optional[Callable[[Frame], bool]] = None

        self.timer = StageTimer()
        # device-side local-map preparation for the fused step, built at
        # the end of each tracked frame for the next one
        self._prep = None
        # in-flight pipelined steps, oldest first: (frame, _Readback,
        # meta), at most cfg.pipeline_depth
        self._pending = []
        # the device recurrence: the last dispatched step's device
        # outputs and the frame and candidate rows it used (see
        # _track_prior_chain).  None = the next dispatch is a
        # host-prepared step
        self._chain = None
        self._last_meta = None  # meta of the most recent dispatch

        cam = config.cam
        self._cam_tuple = (float(cam.fx), float(cam.fy), float(cam.cx),
                           float(cam.cy))
        self.bounds = factory.bounds
        self.scale_factors = np.asarray(factory.scale_factors, np.float32)
        self.inv_sigma2 = np.asarray(factory.inv_sigma2, np.float32)
        self._t_scales = torch.as_tensor(self.scale_factors,
                                         device=self.device)
        self._t_inv_sigma2 = torch.as_tensor(self.inv_sigma2,
                                             device=self.device)
        self.log_scale = float(np.log(config.orb.scale_factor))

    def _t(self, a, dtype=None) -> torch.Tensor:
        """Host array -> tensor on the tracker's device."""
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def track(self, image, timestamp: float = 0.0,
              pose_prior: Optional[np.ndarray] = None,
              started=None, pre_read_hook=None) -> Frame:
        """Process one frame — Tracking::trackImageWithPose
        (src/Tracking.cc:194-356) merged with upstream GrabImageMonocular.

        ``started``: this image's extraction, queued earlier by
        ``factory.start``.  ``pre_read_hook``: called after the frame's
        fused step is queued on the device but before its results are
        read; a caller queues the next frame's extraction there."""
        init_mode = self.state in (TrackState.NO_IMAGES_YET,
                                   TrackState.NOT_INITIALIZED)
        with self.timer.time("track/extract"):
            frame = self.factory.make(image, timestamp, Tcw=pose_prior,
                                      init_mode=init_mode, started=started)

        if self._pending:
            # commit in-flight pipelined steps before touching this
            # frame.  Steady state takes the fast path: consume -> prep
            # -> dispatch this frame -> only then the keyframe epilogue
            if not init_mode:
                done = self._finish_pending_fast(frame, pre_read_hook)
                if done is not None:
                    return done
            else:
                self._finish_pending()

        if init_mode:
            with self.store.lock:
                self._initialize(frame, pose_prior)
                self.last_frame = frame
                if self.state == TrackState.OK:
                    self._prepare_next(frame)
            return frame

        ok = False
        fused_done = False
        if self.state == TrackState.OK:
            prep_ok = (self._prep is not None
                       and self._prep["frame"] is self.last_frame)
            if self.cfg.pose_prior and prep_ok:
                with self.timer.time("track/fused_step"):
                    out = self._fused_dispatch(frame, pre_read_hook)
                if self.cfg.pipelined_tracking:
                    # consumed one or more frames later.  The meta is
                    # _last_meta, what _fused_dispatch recorded: a chain
                    # step decodes through its parent's meta, not _prep
                    self._pending.append((frame, out, self._last_meta))
                    return frame
                verdict = self._fused_verdict(frame, out)
                if verdict == "ok":
                    ok = fused_done = True
                elif verdict == "lost":
                    fused_done = True  # local-map stage ran; don't redo
                else:  # prior_fail -> reference-KF fallback
                    with self.store.lock:
                        ok = self._track_reference_kf(frame)
            elif self.cfg.pose_prior:
                with self.store.lock:
                    with self.timer.time("track/refresh_replaced"):
                        self._refresh_replaced_bindings(self.last_frame)
                    with self.timer.time("track/prior"):
                        ok = self._track_with_prior(frame)
                    if not ok:
                        ok = self._track_reference_kf(frame)
            else:
                with self.store.lock:
                    with self.timer.time("track/refresh_replaced"):
                        self._refresh_replaced_bindings(self.last_frame)
                    if self.velocity is not None:
                        ok = self._track_motion_model(frame)
                    if not ok:
                        ok = self._track_reference_kf(frame)
        else:  # LOST
            with self.store.lock:
                ok = self._do_relocalize(frame)

        if ok and not fused_done:
            with self.timer.time("track/local_map"), self.store.lock:
                ok = self._track_local_map(frame)

        self._post_track(frame, ok)
        return frame

    def _post_track(self, frame: Frame, ok: bool):
        """The per-frame epilogue: state machine, keyframe decision,
        next-frame preparation, reset (src/Tracking.cc:330-356)."""
        do_reset = False
        with self.store.lock:
            if ok:
                self.state = TrackState.OK
                self._update_velocity(frame)
                with self.timer.time("track/need_kf"):
                    need = (self.mapping_enabled
                            and self._need_new_keyframe(frame))
                if need:
                    with self.timer.time("track/create_kf"):
                        self._create_new_keyframe(frame)
            else:
                do_reset = self._lose()
            if self.state == TrackState.OK and self.cfg.pose_prior:
                with self.timer.time("track/prep_next"):
                    self._prepare_next(frame)
        if do_reset:
            # outside the map lock: reset drains the mapping worker,
            # which must be able to take the lock to finish its queue
            self.on_reset()
        log.info("frame %d: state=%s inliers=%d tracked=%d",
                 frame.frame_id, self.state.name, self.matches_inliers,
                 frame.n_tracked())
        self.last_frame = frame

    def _update_velocity(self, frame: Frame):
        """The motion model's velocity (estimated mode)."""
        if not self.cfg.pose_prior and self.last_frame is not None:
            self.velocity = frame.Tcw @ np.linalg.inv(self.last_frame.Tcw)

    def _lose(self) -> bool:
        """State LOST: drop the velocity, the prepared step and the
        device recurrence.  Returns whether the map is to be reset
        (src/Tracking.cc:339-344)."""
        self.state = TrackState.LOST
        self.velocity = None
        self._prep = None
        self._chain = None
        return (self.store.n_valid_keyframes() <= 5
                and self.on_reset is not None)

    # ------------------------------------------------------------------
    # pipelined tracking
    # ------------------------------------------------------------------
    def _post_track_core(self, frame: Frame, ok: bool,
                         do_prep: bool = True) -> bool:
        """State machine + next-frame prep only (pipelined fast path).
        The keyframe decision, reset and log run in
        :meth:`_post_track_epilogue`, after the caller has dispatched the
        next frame's fused step, so that step's device work and result
        copy overlap the epilogue's host work.  Returns ``do_reset`` for
        the epilogue."""
        do_reset = False
        with self.store.lock:
            if ok:
                self.state = TrackState.OK
                self._update_velocity(frame)
            else:
                do_reset = self._lose()
            if do_prep and self.state == TrackState.OK \
                    and self.cfg.pose_prior:
                with self.timer.time("track/prep_next"):
                    self._prepare_next(frame)
        self.last_frame = frame
        return do_reset

    def _post_track_epilogue(self, frame: Frame, ok: bool, do_reset: bool):
        """The deferred half of the pipelined epilogue: keyframe decision
        (one keyframe staler than the sequential path with respect to
        the just-prepared candidate set), reset handshake, log."""
        if ok:
            with self.store.lock:
                with self.timer.time("track/need_kf"):
                    need = (self.mapping_enabled
                            and self._need_new_keyframe(frame))
                if need:
                    with self.timer.time("track/create_kf"):
                        self._create_new_keyframe(frame)
        if do_reset:
            self.on_reset()
        log.info("frame %d: state=%s inliers=%d tracked=%d",
                 frame.frame_id, self.state.name, self.matches_inliers,
                 frame.n_tracked())

    def _verdict_then_fallback(self, pframe: Frame, out, prep):
        """A pipelined step's verdict, with the sequential path's
        fallbacks (reference-KF tracking, then the local map).  Returns
        (verdict, ok)."""
        verdict = self._fused_verdict(pframe, out, prep)
        ok = verdict == "ok"
        if verdict == "prior_fail":
            with self.store.lock:
                ok = (self._track_reference_kf(pframe)
                      and self._track_local_map(pframe))
        return verdict, ok

    def _finish_pending(self):
        """Commit the oldest in-flight step with the sequential
        epilogue: falls back to reference-KF tracking or LOST exactly
        like the sequential path, frames later."""
        pframe, out, prep = self._pending.pop(0)
        with self.timer.time("track/finish_pending"):
            _, ok = self._verdict_then_fallback(pframe, out, prep)
            self._post_track(pframe, ok)

    def _prefetch_heads(self, k: int):
        """Wait once for the first ``k`` pending steps' copies (the
        newest of them completes last: one stream, in order) and turn
        them into numpy arrays."""
        k = min(k, len(self._pending))
        with self.timer.time("fused/read_batch"):
            self._pending[k - 1][1].wait()
            for i in range(k):
                self._pending[i][1].arrays()

    def _consume_head(self, do_prep: bool = True) -> bool:
        """Consume the oldest in-flight step: verdict -> bindings ->
        state machine (+ optional next-frame prep) -> keyframe epilogue.
        Returns ok."""
        pframe, out, prep = self._pending.pop(0)
        verdict, ok = self._verdict_then_fallback(pframe, out, prep)
        if verdict != "ok":
            # the device recurrence no longer matches the host bindings
            # (fallback rebinding or loss): the next dispatch starts
            # from a fresh host prep
            self._chain = None
        do_reset = self._post_track_core(pframe, ok, do_prep=do_prep)
        self._post_track_epilogue(pframe, ok, do_reset)
        return ok

    def _finish_pending_fast(self, frame: Frame, pre_read_hook):
        """The pipelined steady path.  At most ``cfg.pipeline_depth``
        fused steps stay in flight; the oldest is consumed only when the
        queue is full.  At depth >= 3 the heads are read in one wait and
        all but the newest committed, so steady state alternates
        consume-2 / consume-0.  The cost: frame-to-frame matching runs
        against the newest consumed frame's bindings through the device
        chain; the local-map search projects with the frame's own pose
        prior.  Returns the frame when dispatched, None when the caller
        must fall back (LOST, stale prep, reset)."""
        with self.timer.time("track/finish_pending"):
            if len(self._pending) >= self.cfg.pipeline_depth:
                if self.cfg.pipeline_depth >= 3 and len(self._pending) >= 2:
                    k = len(self._pending) - 1
                    self._prefetch_heads(k)
                    for i in range(k):
                        if i and self.state != TrackState.OK:
                            break  # the drain below finishes the rest
                        self._consume_head(do_prep=(i == k - 1))
                else:
                    self._consume_head()
        if self.state != TrackState.OK:
            # drain what is still in flight with full semantics so
            # relocalization sees the newest state
            while self._pending:
                with self.timer.time("track/finish_pending"):
                    self._consume_head()
            return None
        if self._prep is None or self._prep["frame"] is not self.last_frame:
            return None
        with self.timer.time("track/fused_step"):
            out = self._fused_dispatch(frame, pre_read_hook)
        self._pending.append((frame, out, self._last_meta))
        return frame

    def flush(self):
        """Commit every in-flight pipelined step (call before reading
        trajectories or maps, or shutting down).  A flush is a pipeline
        boundary: the next dispatch starts from a fresh host prep."""
        while self._pending:
            self._finish_pending()
        self._chain = None

    # ------------------------------------------------------------------
    # initialization (src/Tracking.cc:392-573)
    # ------------------------------------------------------------------
    def _initialize(self, frame: Frame, pose_prior: Optional[np.ndarray]):
        n_kp = int(frame.valid.sum())
        if self.init_frame is None or self.state == TrackState.NO_IMAGES_YET:
            if n_kp > self.cfg.init_min_keypoints:
                self.init_frame = frame
                self.state = TrackState.NOT_INITIALIZED
            return
        if n_kp <= self.cfg.init_min_keypoints:
            self.init_frame = None
            self.state = TrackState.NO_IMAGES_YET
            return

        f1, f2 = self.init_frame, frame
        res = search.search_for_initialization(
            f1.dev("xy"), f1.dev("desc"), f1.dev("valid"),
            f1.dev("octave"), f1.dev("angle"),
            f2.dev("xy"), f2.dev("desc"), f2.dev("valid"),
            f2.dev("octave"), f2.dev("angle"),
            window=self.cfg.init_match_window).host()
        valid = res.valid
        idx = res.idx
        if int(valid.sum()) < self.cfg.init_min_matches:
            # restart with the current frame (src/Tracking.cc:436-445)
            self.init_frame = frame
            return

        # both poses must be known: the prior mode supplies them per
        # frame and bootstrap hints may supply them in estimated mode;
        # otherwise run the upstream H/F-model RANSAC initializer
        T1, T2 = f1.Tcw, f2.Tcw
        if pose_prior is None and np.allclose(T1, T2):
            self._initialize_two_view(f1, f2, valid, idx)
            return

        K = self._t(self.cfg.cam.K)
        rows = np.where(valid)[0]
        cols = idx[rows]
        nb = pad_bucket(len(rows))
        padn = nb - len(rows)
        uv1 = self._t(np.pad(f1.xy[rows], ((0, padn), (0, 0))))
        uv2 = self._t(np.pad(f2.xy[cols], ((0, padn), (0, 0))))
        T1d, T2d = self._t(T1), self._t(T2)
        X = triangulate.triangulate_dlt(
            triangulate.projection_matrix(K, T1d),
            triangulate.projection_matrix(K, T2d), uv1, uv2)
        sig1 = self._t(np.pad(self.factory.sigma2[f1.octave[rows]],
                              (0, padn), constant_values=1.0))
        sig2 = self._t(np.pad(self.factory.sigma2[f2.octave[cols]],
                              (0, padn), constant_values=1.0))
        fx, fy, cx, cy = self._cam_tuple
        chk = triangulate.check_triangulation(
            X, T1d, T2d, uv1, uv2, fx, fy, cx, cy, sig1, sig2)
        good = chk.good.cpu().numpy()[:len(rows)]
        X = X[:len(rows)].cpu().numpy()
        if good.sum() < self.cfg.init_min_triangulated:
            self.init_frame = frame
            return
        self._create_initial_map(f1, f2, rows[good], cols[good], X[good])

    def _initialize_two_view(self, f1: Frame, f2: Frame,
                             valid: np.ndarray, idx: np.ndarray):
        """Upstream monocular initialization: H/F-model RANSAC relative
        pose + triangulation + median-depth gauge (geom/twoview.py).  The
        RANSAC samples are drawn on the host, as the JAX package draws
        them, so both packages see the same."""
        rows = np.where(valid)[0]
        cols = idx[rows]
        nb = pad_bucket(len(rows))
        padn = nb - len(rows)
        vmask = np.zeros(nb, bool)
        vmask[:len(rows)] = True
        samples = np.random.default_rng(f2.frame_id).integers(
            0, max(len(rows), 1), (200, 8)).astype(np.int32)
        res = twoview.initialize_two_view(
            self._t(np.pad(f1.xy[rows], ((0, padn), (0, 0)))),
            self._t(np.pad(f2.xy[cols], ((0, padn), (0, 0)))),
            self._t(vmask),
            self._t(np.pad(self.factory.inv_sigma2[f2.octave[cols]],
                           (0, padn), constant_values=1.0)),
            self._t(self.cfg.cam.K), self._t(samples),
            min_triangulated=self.cfg.init_min_triangulated)
        ok, R, t, X, good, use_h = (a.cpu().numpy() for a in (
            res.ok, res.R, res.t, res.points, res.good,
            res.used_homography))
        if not ok:
            return  # keep the initial frame, try with the next image
        self.init_used_homography = bool(use_h)
        good = good[:len(rows)]
        X = X[:len(rows)]
        f1.Tcw = np.eye(4, dtype=np.float32)
        T2 = np.eye(4, dtype=np.float32)
        T2[:3, :3] = R
        T2[:3, 3] = t
        f2.Tcw = T2
        self._create_initial_map(f1, f2, rows[good], cols[good], X[good],
                                 estimated=True)

    def _compact_init_frame(self, frame: Frame, keep) -> np.ndarray:
        """Compact a 2x-budget init frame to the standard (padded)
        feature capacity, keeping the matched rows ``keep`` plus the
        highest-response remaining valid features.  Returns ``keep``
        remapped to the compacted row space."""
        keep = np.asarray(keep, np.int64)
        cap = padded_feature_count(self.factory.params.n_features)
        if frame.n <= cap:
            return keep
        ukeep = np.unique(keep)
        if len(ukeep) >= cap:
            return keep
        in_keep = np.zeros(frame.n, bool)
        in_keep[ukeep] = True
        resp = np.where(np.asarray(frame.valid, bool),
                        np.asarray(frame.response, np.float32), -np.inf)
        rest = np.where(~in_keep)[0]
        rest = rest[np.argsort(-resp[rest], kind="stable")]
        sel = np.concatenate([ukeep, rest[:cap - len(ukeep)]])
        frame.compact(sel)
        remap = -np.ones(int(sel.max()) + 1, np.int64)
        remap[sel] = np.arange(len(sel))
        return remap[keep]

    def _create_initial_map(self, f1: Frame, f2: Frame, rows, cols, X,
                            estimated: bool = False):
        """CreateInitialMap (src/Tracking.cc:467-573); upstream
        CreateInitialMapMonocular when ``estimated``."""
        rows = self._compact_init_frame(f1, rows)
        cols = self._compact_init_frame(f2, cols)
        store = self.store
        k1 = store.add_keyframe(f1)
        k2 = store.add_keyframe(f2)
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        new_pids = store.add_points_batch(
            pos=np.asarray(X, np.float32), desc=f2.desc[cols],
            kf1=k1, fi1=rows, kf2=k2, fi2=cols,
            first_frame=f2.frame_id, first_kf=k2).tolist()
        store.update_points_batch(new_pids)
        store.update_connections(k1)
        store.update_connections(k2)
        if estimated:
            # upstream: full BA fixing only KF0, then the median-depth
            # gauge
            self._run_init_full_ba(k1, k2)
        else:
            # structure-only BA with both poses fixed == the reference's
            # GlobalBundleAdjustemnt(20 it, fix both init KFs)
            # (src/Tracking.cc:536, include/Optimizer.h:80-82)
            from .local_mapping import run_structure_ba
            run_structure_ba(store, [k1, k2], self.cfg, iters=20)

        tracked = sum(1 for p in f2.mp_ids if p >= 0)
        if tracked < self.cfg.init_min_tracked_after_ba:
            if self.on_reset:
                self.on_reset()
            return

        if estimated:
            med = store.scene_median_depth(k1)
            if med <= 0:
                if self.on_reset:
                    self.on_reset()
                return
            inv = 1.0 / med
            live = np.where(np.asarray(store.mp_valid, bool))[0]
            store.mp_pos[live] = store.mp_pos[live] * inv
            T2 = store.kfs[k2].Tcw.copy()
            T2[:3, 3] *= inv
            store.set_kf_pose(k2, T2)
            f2.Tcw = T2.copy()
            store.update_points_batch(live)
        self.ref_kf = k2
        self.last_kf_frame_id = f2.frame_id
        self.state = TrackState.OK
        if self.on_new_keyframe:
            self.on_new_keyframe(k1)
            self.on_new_keyframe(k2)

    def _run_init_full_ba(self, k1: int, k2: int, iters: int = 20):
        """Full two-keyframe BA fixing only KF0 (upstream
        GlobalBundleAdjustemnt at initialization), padded as the JAX
        package pads it (6 fixed identity cameras, power-of-4 rows)."""
        from .local_mapping import gather_ba_problem
        store = self.store
        pids, packed = gather_ba_problem(store, [k1, k2],
                                         self.factory.inv_sigma2)
        if packed is None or len(pids) == 0:
            return
        obs_kf, obs_pt, obs_uv, obs_sig, meta = packed
        pids_a = np.asarray(pids, np.int64)
        poses = np.stack([store.kfs[k].Tcw for k in (k1, k2)])
        P = pad_bucket(len(pids))
        O = pad_bucket(len(obs_kf))
        pad_o = O - len(obs_kf)
        fx, fy, cx, cy = self._cam_tuple
        eye = np.broadcast_to(np.eye(4, dtype=np.float32), (6, 4, 4))
        res = ba.bundle_adjust(
            self._t(np.concatenate([poses, eye]).astype(np.float32)),
            self._t(np.pad(np.asarray(store.mp_pos[pids_a]),
                           ((0, P - len(pids)), (0, 0)))),
            self._t(np.pad(obs_kf, (0, pad_o))),
            self._t(np.pad(obs_pt, (0, pad_o))),
            self._t(np.pad(obs_uv, ((0, pad_o), (0, 0)))),
            self._t(np.pad(obs_sig, (0, pad_o))),
            self._t(np.pad(np.ones(len(obs_kf), bool), (0, pad_o))),
            self._t(np.pad(np.array([True, False]), (0, 6),
                           constant_values=True)),
            fx, fy, cx, cy, iters=iters, cg_iters=20)
        new_poses, new_pts, inl = (a.cpu().numpy() for a in (
            res.cam_Tcw, res.points, res.obs_inlier))
        store.set_kf_pose(k2, new_poses[1])
        store.kfs[k2].frame.Tcw = new_poses[1].copy()
        store.mp_pos[pids_a] = new_pts[:len(pids)]
        store.dirty_points.update(pids)
        meta_kid, _ = meta
        for o in np.where(~inl[:len(obs_kf)])[0]:
            pid = pids[obs_pt[o]]
            if store.mp_valid[pid]:
                store.erase_observation(pid, int(meta_kid[o]))

    # ------------------------------------------------------------------
    # frame-to-frame tracking
    # ------------------------------------------------------------------
    def _refresh_replaced_bindings(self, frame: Optional[Frame]):
        """CheckReplacedMapPointsInLastFrame (src/Tracking.cc:581-597)."""
        if frame is None:
            return
        rows = np.where(frame.mp_ids >= 0)[0]
        if len(rows) == 0:
            return
        pids = frame.mp_ids[rows].astype(np.int64)
        for _ in range(100):
            rb = np.asarray(self.store.mp_replaced_by[pids], np.int64)
            if not (rb >= 0).any():
                break
            pids = np.where(rb >= 0, rb, pids)
        alive = np.asarray(self.store.mp_valid[pids], bool)
        frame.mp_ids[rows] = np.where(alive, pids, -1).astype(np.int32)

    def _gather_last_frame_mps(self, last: Frame):
        has = (last.mp_ids >= 0) & ~last.mp_outlier
        ids = np.where(has)[0]
        if len(ids) == 0:
            return ids.astype(np.int32)
        live = np.asarray(self.store.mp_valid[last.mp_ids[ids]], bool)
        return ids[live].astype(np.int32)

    def _match_against_last(self, frame: Frame, Tcw_pred: np.ndarray,
                            th: float, chi2: float = 0.0):
        """SearchByProjection(cur, last, th) — bind map points of the
        last frame to current features (src/ORBmatcher.cc:1633-1797).
        With ``chi2 > 0`` the trusted-pose gate runs in the same step and
        only its survivors are bound.  Returns (n_matches, n_good)."""
        last = self.last_frame
        ids = self._gather_last_frame_mps(last)
        if len(ids) == 0:
            return 0, 0
        pos = np.asarray(self.store.mp_pos[last.mp_ids[ids]])
        n = pad_bucket(len(ids))
        pad = n - len(ids)
        mp_valid = np.zeros(n, bool)
        mp_valid[:len(ids)] = True
        fx, fy, cx, cy = self._cam_tuple
        res, gate = _match_last(
            self._t(Tcw_pred), self._t(np.pad(pos, ((0, pad), (0, 0)))),
            self._t(mp_valid), self._t(np.pad(ids, (0, pad))),
            last.dev("octave"), last.dev("desc"), last.dev("angle"),
            frame.dev("xy"), frame.dev("octave"), frame.dev("desc"),
            frame.dev("valid"), frame.dev("angle"),
            self._t_scales, self._t_inv_sigma2,
            fx, fy, cx, cy, self.bounds, th, chi2)
        rvalid = res.valid.cpu().numpy()[:len(ids)]
        ridx = res.idx.cpu().numpy()[:len(ids)]
        ggate = gate.cpu().numpy()[:len(ids)]
        sel = np.where(ggate)[0]
        frame.mp_ids[ridx[sel]] = last.mp_ids[ids[sel]]
        return int(rvalid.sum()), len(sel)

    def _pose_chi2_filter(self, frame: Frame) -> int:
        """Gate current bindings by reprojection chi2 under the trusted
        pose; returns the surviving count."""
        bound = np.where(frame.mp_ids >= 0)[0]
        if len(bound) == 0:
            return 0
        pos = self._t(np.asarray(self.store.mp_pos[frame.mp_ids[bound]]))
        fx, fy, cx, cy = self._cam_tuple
        uv, z = _project_points(self._t(frame.Tcw), pos, fx, fy, cx, cy)
        c2 = _chi2(uv, frame.dev("xy"), frame.dev("octave"),
                   self._t_inv_sigma2, self._t(bound).long())
        ok = ((z > 0) & (c2 <= self.cfg.chi2_mono)).cpu().numpy()
        frame.mp_ids[bound[~ok]] = -1
        return int(ok.sum())

    def _optimize_frame_pose(self, frame: Frame) -> int:
        """Motion-only LM over the current bindings, the keypoints
        gathered on the device; flags outliers (upstream
        PoseOptimization).  Returns the inlier count."""
        bound = np.where(frame.mp_ids >= 0)[0]
        if len(bound) < 3:
            return 0
        pos = np.asarray(self.store.mp_pos[frame.mp_ids[bound]])
        pad = pad_bucket(len(bound)) - len(bound)
        rows = self._t(np.pad(bound, (0, pad))).long()
        fx, fy, cx, cy = self._cam_tuple
        res = pose_opt.optimize_pose(
            self._t(frame.Tcw), self._t(np.pad(pos, ((0, pad), (0, 0)))),
            frame.dev("xy")[rows],
            self._t_inv_sigma2[frame.dev("octave")[rows].long()],
            self._t(np.pad(np.ones(len(bound), bool), (0, pad))),
            fx, fy, cx, cy)
        frame.Tcw = res.Tcw.cpu().numpy()
        inl = res.inliers.cpu().numpy()[:len(bound)]
        frame.mp_outlier[:] = False
        frame.mp_outlier[bound[~inl]] = True
        return int(inl.sum())

    # ------------------------------------------------------------------
    # fused steady-state step
    # ------------------------------------------------------------------
    def _prepare_next(self, frame: Frame):
        """Build the next frame's device inputs for the fused step: this
        frame's final bindings (rows of the frame-to-frame search) and
        the local-map candidates (the covisibility vote of
        UpdateLocalKeyFrames, src/Tracking.cc:890-1005)."""
        self._refresh_replaced_bindings(frame)
        local_kfs = self._local_keyframes(frame)  # also votes ref_kf
        bound_idx = np.where((frame.mp_ids >= 0) & ~frame.mp_outlier)[0]
        if len(bound_idx):
            live = np.asarray(
                self.store.mp_valid[frame.mp_ids[bound_idx].astype(np.int64)],
                bool)
            bound_idx = bound_idx[live]
        if not local_kfs or len(bound_idx) == 0:
            self._prep = None
            return
        bound_pids = frame.mp_ids[bound_idx].astype(np.int64)
        allp = np.concatenate(
            [self.store.kfs[k].frame.mp_ids for k in local_kfs])
        uniq = np.unique(allp[allp >= 0])
        if len(uniq):
            uniq = uniq[np.asarray(
                self.store.mp_valid[uniq.astype(np.int64)], bool)]
        if len(uniq) == 0:
            self._prep = None
            return
        L = pad_bucket(len(bound_idx), self.cfg.pad_min_bound)
        C = pad_bucket(len(uniq), self.cfg.pad_min_cand)
        self.store.dev_points.sync(self.store)
        self._prep = dict(
            frame=frame,
            bound_pids=bound_pids,
            cand_pids=uniq.astype(np.int64),
            bound_pid_rows=self._t(np.pad(bound_pids.astype(np.int32),
                                          (0, L - len(bound_idx)),
                                          constant_values=-1)),
            last_rows=self._t(np.pad(bound_idx.astype(np.int32),
                                     (0, L - len(bound_idx)))),
            cand_rows=self._t(np.pad(uniq.astype(np.int32),
                                     (0, C - len(uniq)),
                                     constant_values=-1)),
        )

    def _fused_dispatch(self, frame: Frame, pre_read_hook=None) -> _Readback:
        """Queue the fused step for ``frame`` and the copies of its
        host-facing outputs (no read).  With pipelined tracking and a
        live chain the step is the device recurrence
        (:func:`_track_prior_chain`), else the host-prepared step."""
        p = self._prep
        last = self.last_frame
        fx, fy, cx, cy = self._cam_tuple
        th_local = 3.0 if (frame.frame_id - self.last_reloc_frame_id
                           < self.cfg.max_frames_between_kf) else 1.0
        common = (self._t_scales, self._t_inv_sigma2,
                  fx, fy, cx, cy, self.bounds,
                  self.cfg.orb.n_levels, self.log_scale,
                  7.0, th_local, self.cfg.chi2_mono)
        cur = (frame.dev("xy"), frame.dev("octave"), frame.dev("desc"),
               frame.dev("valid"), frame.dev("angle"))
        with self.timer.time("fused/dispatch"):
            # one snapshot: the mapper's sync() swaps the column tensors
            # (async mapping) and the chain must not see a half-update
            dp = self.store.dev_points.snapshot()
            ch = self._chain if self.cfg.pipelined_tracking else None
            if ch is not None:
                # the consumer derives this step's bound pids from its
                # parent's consumed masks, as the device did
                self._last_meta = dict(
                    lazy=True, parent=self._last_meta,
                    cand_pids=p["cand_pids"], frame=frame,
                    n_bound=int(ch["bound_rows"].shape[0]))
                out = _track_prior_chain(
                    self._t(frame.Tcw), *dp,
                    ch["bound_rows"], ch["cand_rows"],
                    ch["ridx"], ch["r2idx"], ch["gate"], ch["keep"],
                    p["cand_rows"],
                    ch["frame"].dev("octave"), ch["frame"].dev("desc"),
                    ch["frame"].dev("angle"), *cur, *common)
            else:
                self._last_meta = p
                out = _prior_step_core(
                    self._t(frame.Tcw), *dp,
                    p["bound_pid_rows"], p["last_rows"], p["cand_rows"],
                    last.dev("octave"), last.dev("desc"), last.dev("angle"),
                    *cur, *common)
            if self.cfg.pipelined_tracking:
                self._chain = dict(
                    frame=frame, cand_rows=p["cand_rows"],
                    ridx=out[0], r2idx=out[4], gate=out[2], keep=out[5],
                    bound_rows=out[6])
            # the copies are queued before the hook queues the next
            # frame's extraction, so they do not wait behind it
            rb = _Readback(out[:6])
        if pre_read_hook is not None:
            pre_read_hook()
        return rb

    def _fused_verdict(self, frame: Frame, out: _Readback, p=None) -> str:
        """Consume the fused step's results.  Returns 'ok', 'prior_fail'
        (frame-to-frame match too weak -> reference-KF tracking), or
        'lost' (local-map inliers below threshold,
        src/Tracking.cc:641-666).  ``p``: the meta of the step (default:
        the current prep)."""
        if p is None:
            p = self._prep
        if p.get("lazy") and "bound_pids" not in p:
            # mirror the chain prologue: the parent's gated
            # frame-to-frame matches, then its kept local-map matches,
            # in row order, the first n_bound of them (_chain_rows)
            par = p["parent"]["res"]
            p["bound_pids"] = np.concatenate([
                par["bound_pids"][par["gate"]],
                par["cand_pids"][par["keep"]]])[:p["n_bound"]]
            p["parent"] = None  # break the meta chain (no leak)
        with self.timer.time("fused/read"):
            ridx, rvalid, gate, visible, r2idx, keep_new = out.arrays()
        L = len(p["bound_pids"])
        C = len(p["cand_pids"])
        # a chain consumer derives the next step's pid list from these
        # masks: store them before any verdict-dependent return (the
        # device chain used them whatever the verdict)
        p["res"] = dict(bound_pids=p["bound_pids"], cand_pids=p["cand_pids"],
                        gate=gate[:L], keep=keep_new[:C])
        n_matches = int(rvalid[:L].sum())
        store = self.store
        with self.timer.time("fused/apply"), store.lock:
            if n_matches < self.cfg.track_prior_min_matches:
                frame.mp_ids[:] = -1
                return "prior_fail"
            sel = np.where(gate[:L])[0]
            if len(sel) < self.cfg.track_prior_min_good:
                frame.mp_ids[:] = -1
                return "prior_fail"

            def live_of(pids: np.ndarray) -> np.ndarray:
                # the mapper may have erased/replaced points since the
                # prep: follow replace chains, drop dead pids
                # (CheckReplacedMapPointsInLastFrame, src/Tracking.cc:581)
                pids = np.asarray(pids, np.int64)
                for _ in range(100):
                    rb = np.asarray(store.mp_replaced_by[pids], np.int64)
                    if not (rb >= 0).any():
                        break
                    pids = np.where(rb >= 0, rb, pids)
                alive = np.asarray(store.mp_valid[pids], bool) \
                    if len(pids) else np.zeros(0, bool)
                return np.where(alive, pids, -1)

            bsel = live_of(p["bound_pids"][sel])
            sel, bsel = sel[bsel >= 0], bsel[bsel >= 0]
            newsel = np.where(keep_new[:C])[0]
            csel = live_of(p["cand_pids"][newsel])
            newsel, csel = newsel[csel >= 0], csel[csel >= 0]
            if len(sel):
                frame.mp_ids[ridx[:L][sel]] = bsel.astype(np.int32)
            if len(newsel):
                frame.mp_ids[r2idx[:C][newsel]] = csel.astype(np.int32)

            # visible: current bindings (unconditional) + in-frustum cand
            vis_cand = p["cand_pids"][visible[:C]]
            vis_cand = vis_cand[np.asarray(store.mp_valid[vis_cand], bool)]
            vis_pids = np.unique(np.concatenate([vis_cand, bsel]))
            if len(vis_pids):
                store.mp_n_visible[vis_pids] = store.mp_n_visible[vis_pids] + 1
            found = frame.mp_ids[frame.mp_ids >= 0].astype(np.int64)
            if len(found):
                store.mp_n_found[found] = store.mp_n_found[found] + 1
            self.matches_inliers = len(sel) + len(newsel)
        need = (self.cfg.track_local_min_inliers_reloc
                if frame.frame_id - self.last_reloc_frame_id
                < self.cfg.max_frames_between_kf
                else self.cfg.track_local_min_inliers)
        return "ok" if self.matches_inliers >= need else "lost"

    def _track_with_prior(self, frame: Frame) -> bool:
        """TrackWithInitialPose (src/Tracking.cc:1060-1072)."""
        n, good = self._match_against_last(frame, frame.Tcw, th=7.0,
                                           chi2=self.cfg.chi2_mono)
        if n < self.cfg.track_prior_min_matches:
            frame.mp_ids[:] = -1
            return False
        return good >= self.cfg.track_prior_min_good

    def _track_motion_model(self, frame: Frame) -> bool:
        """Upstream TrackWithMotionModel: predict the pose with the
        velocity, search the last frame's points (wider when few match),
        optimize the pose."""
        Tcw_pred = (self.velocity @ self.last_frame.Tcw).astype(np.float32)
        frame.Tcw = Tcw_pred
        n, _ = self._match_against_last(frame, Tcw_pred, th=15.0)
        if n < 20:
            frame.mp_ids[:] = -1
            n, _ = self._match_against_last(frame, Tcw_pred, th=30.0)
        if n < 20:
            frame.mp_ids[:] = -1
            return False
        return self._optimize_frame_pose(frame) >= 10

    def _track_reference_kf(self, frame: Frame) -> bool:
        """TrackWithReferenceKF (src/Tracking.cc:1080-1096): descriptor
        match against the reference KF's map points, then the
        trusted-pose gate (pose-prior mode) or the pose optimization
        from the reference keyframe's pose (estimated mode)."""
        if self.ref_kf < 0:
            return False
        kf = self.store.kfs[self.ref_kf].frame
        ids = np.where(kf.mp_ids >= 0)[0]
        if len(ids):
            live = np.asarray(self.store.mp_valid[kf.mp_ids[ids]], bool)
            ids = ids[live].astype(np.int32)
        if len(ids) < self.cfg.track_refkf_min_matches:
            return False
        n_rows = pad_bucket(len(ids))
        pad = n_rows - len(ids)
        valid_rows = np.zeros(n_rows, bool)
        valid_rows[:len(ids)] = True
        # FeatureVector-style node blocking once a vocabulary exists
        # (src/ORBmatcher.cc:222-392); the relocalizer carries the
        # shared PlaceRecognition
        pr = getattr(self.relocalize, "pr", None)
        nk = pr.compute_nodes(kf) if pr is not None else None
        nf = pr.compute_nodes(frame) if nk is not None else None
        node1 = (self._t(np.pad(nk[ids], (0, pad), constant_values=-1))
                 if nf is not None else None)
        node2 = self._t(nf) if nf is not None else None
        res = search.search_descriptors(
            self._t(np.pad(kf.desc[ids], ((0, pad), (0, 0))).view(np.int32)),
            self._t(valid_rows),
            self._t(np.pad(kf.angle[ids], (0, pad))), node1,
            frame.dev("desc"), frame.dev("valid"), frame.dev("angle"), node2,
            ratio=0.7).host()
        rvalid = res.valid[:len(ids)]
        ridx = res.idx[:len(ids)]
        n = 0
        for j in np.where(rvalid)[0]:
            frame.mp_ids[ridx[j]] = kf.mp_ids[ids[j]]
            n += 1
        if n < self.cfg.track_refkf_min_matches:
            frame.mp_ids[:] = -1
            return False
        if self.cfg.pose_prior:
            good = self._pose_chi2_filter(frame)
        else:
            if self.velocity is None:
                frame.Tcw = self.store.kfs[self.ref_kf].Tcw.copy()
            good = self._optimize_frame_pose(frame)
        return good >= self.cfg.track_refkf_min_good

    def _do_relocalize(self, frame: Frame) -> bool:
        if self.relocalize is not None and self.relocalize(frame):
            self.last_reloc_frame_id = frame.frame_id
            return True
        return False

    # ------------------------------------------------------------------
    # local map tracking (src/Tracking.cc:619-667, 789-1005)
    # ------------------------------------------------------------------
    def _local_keyframes(self, frame: Frame):
        """UpdateLocalKeyFrames (src/Tracking.cc:890-1005): vote by
        shared observations, add covisible neighbors/children/parent,
        cap at 80."""
        pids = frame.mp_ids[frame.mp_ids >= 0].astype(np.int64)
        if len(pids):
            pids = pids[np.asarray(self.store.mp_valid[pids], bool)]
        if len(pids) == 0:
            return []
        kidm, _, nm = self.store.obs.rows(pids)
        slot_ok = np.arange(kidm.shape[1])[None, :] < nm[:, None]
        voted = kidm[slot_ok]
        if len(voted) == 0:
            return []
        cnt = np.bincount(voted)
        nz = np.nonzero(cnt)[0]
        votes = {int(k): int(cnt[k]) for k in nz}
        local = sorted(votes, key=votes.get, reverse=True)
        local = [k for k in local if self.store.kfs[k].valid]
        out = list(local)
        seen = set(local)
        for kid in local:
            if len(out) >= self.cfg.max_local_keyframes:
                break
            for nb in self.store.get_best_covisibles(kid, 10):
                if nb not in seen:
                    out.append(nb)
                    seen.add(nb)
                    break
            kf = self.store.kfs[kid]
            for ch in kf.children:
                if ch not in seen and self.store.kfs[ch].valid:
                    out.append(ch)
                    seen.add(ch)
                    break
            if kf.parent >= 0 and kf.parent not in seen:
                out.append(kf.parent)
                seen.add(kf.parent)
        self.ref_kf = max(votes, key=votes.get)
        return out[:self.cfg.max_local_keyframes]

    def _track_local_map(self, frame: Frame) -> bool:
        """TrackLocalMap after a non-fused frame-to-frame stage: frustum
        + local-map search over points not yet bound; then the
        trusted-pose gate on old and new bindings (pose-prior mode) or
        the pose optimization (estimated mode)."""
        local_kfs = self._local_keyframes(frame)
        if not local_kfs:
            return False
        allp = np.concatenate(
            [self.store.kfs[k].frame.mp_ids for k in local_kfs])
        uniq = np.unique(allp[allp >= 0])
        if len(uniq) == 0:
            return False
        uniq = uniq[np.asarray(self.store.mp_valid[uniq.astype(np.int64)],
                               bool)]
        if len(uniq) == 0:
            return False

        bound_idx = np.where(frame.mp_ids >= 0)[0]
        bound = frame.mp_ids[bound_idx]
        # points already tracked this frame get visible+1 unconditionally
        # (src/Tracking.cc:795-805)
        if len(bound):
            ub = np.unique(bound.astype(np.int64))
            self.store.mp_n_visible[ub] = self.store.mp_n_visible[ub] + 1
        cand = np.setdiff1d(uniq, bound, assume_unique=False)
        prior = self.cfg.pose_prior
        good = 0
        if len(cand):
            n = pad_bucket(len(cand), self.cfg.pad_min_cand)
            soa = self.store.points_soa(cand)
            pad = n - len(cand)
            nb = pad_bucket(max(len(bound_idx), 1), self.cfg.pad_min_bound)
            old_pos = np.zeros((nb, 3), np.float32)
            if len(bound_idx):
                old_pos[:len(bound_idx)] = np.asarray(
                    self.store.mp_pos[bound.astype(np.int64)])
            old_valid = np.zeros(nb, bool)
            old_valid[:len(bound_idx)] = True
            fx, fy, cx, cy = self._cam_tuple
            th = 3.0 if (frame.frame_id - self.last_reloc_frame_id
                         < self.cfg.max_frames_between_kf) else 1.0
            vis_dev, res, new_gate, old_gate = _frustum_search(
                self._t(np.pad(soa["pos"], ((0, pad), (0, 0)))),
                self._t(np.pad(soa["normal"], ((0, pad), (0, 0)))),
                self._t(np.pad(soa["min_dist"], (0, pad))),
                self._t(np.pad(soa["max_dist"], (0, pad))),
                self._t(np.pad(soa["valid"], (0, pad))),
                self._t(np.pad(soa["desc"], ((0, pad), (0, 0)))
                        .view(np.int32)),
                self._t(frame.Tcw),
                frame.dev("xy"), frame.dev("octave"),
                frame.dev("desc"), frame.dev("valid"),
                self._t(frame.mp_ids >= 0),
                self._t(old_pos),
                self._t(np.pad(bound_idx, (0, nb - len(bound_idx)))),
                self._t(old_valid),
                self._t_scales, self._t_inv_sigma2,
                fx, fy, cx, cy, self.bounds,
                self.cfg.orb.n_levels, self.log_scale, th,
                self.cfg.chi2_mono if prior else 0.0)
            visible, ridx, rvalid, g_new, g_old = (
                t.cpu().numpy() for t in
                (vis_dev, res.idx, res.valid, new_gate, old_gate))
            vis_pids = np.asarray(cand, np.int64)[visible[:len(cand)]]
            if len(vis_pids):
                self.store.mp_n_visible[vis_pids] = \
                    self.store.mp_n_visible[vis_pids] + 1
            keep_new = (rvalid & g_new)[:len(cand)]
            sel = np.where(keep_new)[0]
            frame.mp_ids[ridx[:len(cand)][sel]] = \
                np.asarray(cand, np.int32)[sel]
            if prior:
                bad_old = bound_idx[~g_old[:len(bound_idx)]]
                frame.mp_ids[bad_old] = -1
                good = len(sel) + int(g_old[:len(bound_idx)].sum())
        if not prior:
            good = self._optimize_frame_pose(frame)
        elif not len(cand):
            good = self._pose_chi2_filter(frame)

        found = frame.mp_ids[(frame.mp_ids >= 0) & ~frame.mp_outlier]
        if len(found):
            self.store.mp_n_found[found.astype(np.int64)] = \
                self.store.mp_n_found[found.astype(np.int64)] + 1
        self.matches_inliers = good
        need = (self.cfg.track_local_min_inliers_reloc
                if frame.frame_id - self.last_reloc_frame_id
                < self.cfg.max_frames_between_kf
                else self.cfg.track_local_min_inliers)
        return good >= need

    # ------------------------------------------------------------------
    # keyframe decision (src/Tracking.cc:681-780)
    # ------------------------------------------------------------------
    def _need_new_keyframe(self, frame: Frame) -> bool:
        if self.ref_kf < 0:
            return False
        n_kfs = self.store.n_valid_keyframes()
        if (frame.frame_id - self.last_reloc_frame_id
                < self.cfg.max_frames_between_kf
                and n_kfs > self.cfg.max_frames_between_kf):
            return False
        min_obs = 3 if n_kfs > 2 else 2
        ref = self.store.kfs[self.ref_kf].frame
        rp = ref.mp_ids[ref.mp_ids >= 0].astype(np.int64)
        if len(rp):
            rp = rp[np.asarray(self.store.mp_valid[rp], bool)]
        n_ref = int((self.store.obs.n[rp] >= min_obs).sum()) if len(rp) else 0
        # LocalMapping::AcceptKeyFrames gate (src/Tracking.cc:559-615):
        # monocular never inserts while mapping is busy, which throttles
        # keyframe production to the mapper's rate (the sequential
        # mapper is always idle)
        idle = self.mapping_idle() if self.mapping_idle else True
        c1a = (frame.frame_id
               >= self.last_kf_frame_id + self.cfg.max_frames_between_kf)
        c1b = (frame.frame_id
               >= self.last_kf_frame_id + self.cfg.min_frames_between_kf) \
            and idle
        c2 = (self.matches_inliers < n_ref * self.cfg.ref_ratio
              and self.matches_inliers > 15)
        return (c1a or c1b) and c2 and idle

    def _create_new_keyframe(self, frame: Frame):
        kid = self.store.add_keyframe(frame)
        for i, pid in enumerate(frame.mp_ids):
            if (pid >= 0 and not frame.mp_outlier[i]
                    and self.store.mp_valid[pid]):
                self.store.add_observation(pid, kid, i)
            elif pid >= 0:
                frame.mp_ids[i] = -1
        self.ref_kf = kid
        self.last_kf_frame_id = frame.frame_id
        if self.on_new_keyframe:
            self.on_new_keyframe(kid)
