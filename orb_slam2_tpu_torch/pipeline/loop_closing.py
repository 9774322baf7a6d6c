"""Loop detection, Sim3 verification, loop correction, pose-graph
optimization and global BA — port of
``orb_slam2_tpu/pipeline/loop_closing.py`` (src/LoopClosing.cc).

The reference runs this on its own thread with stop/kill handshakes
against LocalMapping and a separate global-BA thread
(src/LoopClosing.cc:666-673).  Here the sequence DetectLoop ->
CheckCurKFsTcwAndLoopMPs -> CorrectLoop -> OptimizeEssentialGraph ->
GBA runs at the tail of each keyframe's local mapping, inside the
mapper's locked section, with the reference's thresholds:

- skip when < 10 KFs since the last loop (src/LoopClosing.cc:139),
- covisibility consistency across 3 consecutive detections (:60-61,
  178-258),
- BoW matches >= 20 -> Sim3 RANSAC -> SearchBySim3 -> OptimizeSim3 with
  >= 20 inliers (:307-402),
- >= 40 total matched loop points after Scw projection (:418-460).

The searches and solvers run on the map store's device; the few
single-Sim3 compositions run on the host.  RANSAC samples come from a
seeded ``numpy.random.Generator`` (seed 0, as the JAX package's).

The device side is the JAX package's jitted programs, replayed from CUDA
graphs on the card (``graphs.graphed``; static arguments by value, as
its ``static_argnames``): the BoW match, the Sim3 RANSAC and the
Sim3-projected searches are programs of each ``LoopCloser``; the Sim3
optimization, the essential graph and global BA replay their modules'
step programs, one LM round or iteration a replay with the state
threaded (``sim3_opt``, ``pose_graph``, ``ba``).  Host arrays go up
through pinned memory (``graphs.upload``) and every result comes back
through pinned copies and one event per program (``graphs.Readback``),
so nothing else waits for the card.  The JAX package's padding
(``pad_bucket``) keeps the signatures few.
Global BA shards its point state over the runtime's local devices when
there are several (``parallel.local_devices``), as the JAX package
does over ``jax.devices()``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from .. import graphs, parallel
from ..geom import sim3 as sim3_mod
from ..matching import search
from ..models.mapstore import MapStore
from ..optim import ba, pose_graph, segment, sim3_opt, sim3_ransac
from .config import SlamConfig
from .local_mapping import gather_ba_problem
from .place_recognition import PlaceRecognition
from .tracking import pad_bucket
from ..utils.logging import StageTimer, get_logger

log = get_logger("loop_closing")


def _h(a) -> torch.Tensor:
    """Host float32 tensor (single-Sim3 algebra runs on the CPU)."""
    return torch.as_tensor(np.asarray(a, np.float32))


def _sim3_from_se3(T: np.ndarray, s: float = 1.0) -> np.ndarray:
    return sim3_mod.from_se3(_h(T), float(s)).numpy()


def _se3_from_sim3(g: np.ndarray) -> np.ndarray:
    """The SE3 writeback of a Sim3 (src/LoopClosing.cc:569-573,
    src/Optimizer.cc:929-940), as the JAX package computes it: it
    divides ``to_se3(g) = [R | t/s]`` by s once more, giving
    [R/s | t/s^2].  Kept for parity; in pose-prior mode the loop Sim3
    has s = 1 and only the pose graph moves s, slightly."""
    gt = _h(g)
    T = sim3_mod.to_se3(gt).numpy()
    s = float(sim3_mod.scale(gt))
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = T[:3, :3] / s
    out[:3, 3] = T[:3, 3] / s
    return out


def _compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return sim3_mod.compose(_h(a), _h(b)).numpy()


class LoopCloser:
    def __init__(self, cfg: SlamConfig, store: MapStore,
                 place_rec: Optional[PlaceRecognition] = None):
        self.cfg = cfg
        self.store = store
        self.pr = place_rec or PlaceRecognition(store)
        self.last_loop_kf_id = 0
        self.consistent_groups: List[Tuple[Set[int], int]] = []
        self.n_loops_closed = 0
        self.last_loop: Optional[dict] = None  # inspected by tests/tools
        self.timer = StageTimer()
        # 6-DoF loop solve when the sensor scale is metric
        # (SlamConfig.loop_fix_scale): auto = pose-prior mode
        self.fix_scale = (cfg.pose_prior if cfg.loop_fix_scale is None
                          else bool(cfg.loop_fix_scale))

        cam = cfg.cam
        self._cam_tuple = (float(cam.fx), float(cam.fy),
                           float(cam.cx), float(cam.cy))
        from ..geom.camera import undistorted_bounds
        self.bounds = undistorted_bounds(cam)
        from ..ops.extractor import level_sigma2, pyramid
        self.sigma2 = level_sigma2(cfg.orb)
        self.scale_factors = pyramid.scale_factors(
            cfg.orb.n_levels, cfg.orb.scale_factor)[0].astype(np.float32)
        self.log_scale = float(np.log(cfg.orb.scale_factor))
        self._rng = np.random.default_rng(0)
        self._sf = {}       # store device -> the scale factors there
        # the device programs as CUDA graphs (the JAX package's jitted
        # functions); each looks its module function up at each call
        self._match_bow = graphs.graphed(
            lambda *a: search.search_descriptors(*a), "loop_bow_match")
        self._ransac = graphs.graphed(
            lambda *a: sim3_ransac.sim3_ransac(*a), "sim3_ransac")
        self._match_sim3 = graphs.graphed(
            lambda *a: search.search_by_sim3(*a), "search_by_sim3")
        self._match_proj = graphs.graphed(
            lambda *a: search.search_by_projection_sim3(*a),
            "search_by_projection_sim3")

    def reset(self):
        self.last_loop_kf_id = 0
        self.consistent_groups = []
        self.pr = PlaceRecognition(self.store, vocab=self.pr.vocab)

    def _t(self, a, dtype=None) -> torch.Tensor:
        """Host array -> tensor on the map store's device, without
        waiting for the card (``graphs.upload``)."""
        return graphs.upload(a, self.store.device, dtype)

    def _scales(self) -> torch.Tensor:
        """The pyramid's scale factors on the store's device, uploaded
        once."""
        key = str(self.store.device)
        if key not in self._sf:
            self._sf[key] = self._t(self.scale_factors)
        return self._sf[key]

    def _desc(self, a: np.ndarray) -> torch.Tensor:
        """(N, 8) uint32 descriptors -> int32 device tensor, same bits."""
        return self._t(np.ascontiguousarray(a, np.uint32).view(np.int32))

    # ------------------------------------------------------------------
    def process_keyframe(self, kid: int) -> bool:
        """One LoopClosing::Run iteration (src/LoopClosing.cc:77-98)."""
        with self.timer.time("loop/bow"):
            self.pr.add_keyframe(kid)
        with self.timer.time("loop/detect"):
            candidates = self._detect_loop(kid)
        if not candidates:
            return False
        with self.timer.time("loop/sim3"):
            found = self._compute_sim3(kid, candidates)
        if found is None:
            return False
        loop_kf, Scw, loop_mps, matched = found
        log.info("LOOP detected: KF %d <-> KF %d (%d matched points)",
                 kid, loop_kf, len(matched))
        with self.timer.time("loop/correct"):
            self._correct_loop(kid, loop_kf, Scw, loop_mps, matched)
        log.info("loop corrected + essential graph + GBA done (loop #%d)",
                 self.n_loops_closed + 1)
        self.last_loop_kf_id = kid
        self.n_loops_closed += 1
        return True

    # ------------------------------------------------------------------
    # DetectLoop (src/LoopClosing.cc:125-258)
    # ------------------------------------------------------------------
    def _detect_loop(self, kid: int) -> List[int]:
        store = self.store
        if kid < self.last_loop_kf_id + self.cfg.loop_min_kfs_since_last:
            return []
        if not self.pr.ready:
            return []
        min_score = self.pr.min_covisible_score(kid)
        cands = self.pr.loop_candidates(kid, min_score)
        if not cands:
            self.consistent_groups = []
            return []

        # covisibility consistency over consecutive detections
        # (src/LoopClosing.cc:178-258)
        enough: List[int] = []
        current_groups: List[Tuple[Set[int], int]] = []
        group_used = [False] * len(self.consistent_groups)
        for cand in cands:
            group = set(store.get_best_covisibles(cand, 10 ** 9)) | {cand}
            consistent_for_some = False
            for gi, (prev_set, prev_n) in enumerate(self.consistent_groups):
                if group & prev_set:
                    n = prev_n + 1
                    if not group_used[gi]:
                        current_groups.append((group, n))
                        group_used[gi] = True
                    if (n >= self.cfg.loop_consistency_threshold
                            and cand not in enough):
                        enough.append(cand)
                    consistent_for_some = True
            if not consistent_for_some:
                current_groups.append((group, 0))
        self.consistent_groups = current_groups
        return enough

    # ------------------------------------------------------------------
    # CheckCurKFsTcwAndLoopMPs (src/LoopClosing.cc:274-460)
    # ------------------------------------------------------------------
    def _mp_features(self, kid: int):
        """Feature indices of a KF that carry a valid map point."""
        f = self.store.kfs[kid].frame
        return np.array([i for i, p in enumerate(f.mp_ids)
                         if p >= 0 and self.store.mp_valid[p]], np.int32)

    def _cam_points(self, kid: int, feat_idx: np.ndarray) -> np.ndarray:
        """World MP positions of the given features, in the KF's camera
        frame."""
        store = self.store
        f = store.kfs[kid].frame
        if len(feat_idx) == 0:
            return np.zeros((0, 3), np.float32)
        pos = np.asarray(store.mp_pos[f.mp_ids[feat_idx]])
        T = store.kfs[kid].Tcw
        return (pos @ T[:3, :3].T + T[:3, 3]).astype(np.float32)

    def _compute_sim3(self, kid: int, candidates: List[int]):
        store = self.store
        fx, fy, cx, cy = self._cam_tuple
        fcur = store.kfs[kid].frame
        idx_cur = self._mp_features(kid)
        if len(idx_cur) < self.cfg.loop_sim3_min_inliers:
            return None
        sf = self._scales()

        for cand in candidates:
            idx_cand = self._mp_features(cand)
            if len(idx_cand) < self.cfg.loop_sim3_min_inliers:
                continue
            fc = store.kfs[cand].frame

            # --- BoW-style descriptor match between MP features ---
            n1 = pad_bucket(len(idx_cur))
            n2 = pad_bucket(len(idx_cand))
            v1 = np.zeros(n1, bool)
            v1[:len(idx_cur)] = True
            v2 = np.zeros(n2, bool)
            v2[:len(idx_cand)] = True
            # node blocking (FeatureVector walk, src/ORBmatcher.cc:698-851)
            na = self.pr.compute_nodes(fcur)
            nb = self.pr.compute_nodes(fc) if na is not None else None
            node1 = (self._t(np.pad(na[idx_cur], (0, n1 - len(idx_cur)),
                                    constant_values=-1))
                     if nb is not None else None)
            node2 = (self._t(np.pad(nb[idx_cand], (0, n2 - len(idx_cand)),
                                    constant_values=-1))
                     if nb is not None else None)
            res = self._match_bow(
                self._desc(np.pad(fcur.desc[idx_cur],
                                  ((0, n1 - len(idx_cur)), (0, 0)))),
                self._t(v1),
                self._t(np.pad(fcur.angle[idx_cur], (0, n1 - len(idx_cur)))),
                node1,
                self._desc(np.pad(fc.desc[idx_cand],
                                  ((0, n2 - len(idx_cand)), (0, 0)))),
                self._t(v2),
                self._t(np.pad(fc.angle[idx_cand], (0, n2 - len(idx_cand)))),
                node2, 0.75, True, search.TH_LOW)
            bvalid, bidx = graphs.Readback((res.valid, res.idx)).arrays()
            rows = np.where(bvalid[:len(idx_cur)])[0]
            midx = bidx[:len(idx_cur)]
            if len(rows) < self.cfg.loop_sim3_min_inliers:
                log.debug("sim3 cand %d: bow matches %d < %d", cand,
                          len(rows), self.cfg.loop_sim3_min_inliers)
                continue

            # --- batched Sim3 RANSAC (replaces Sim3Solver::iterate) ---
            fi_cur = idx_cur[rows]
            fi_cand = idx_cand[midx[rows]]
            p1 = self._cam_points(kid, fi_cur)
            p2 = self._cam_points(cand, fi_cand)
            uv1 = fcur.xy[fi_cur]
            uv2 = fc.xy[fi_cand]
            me1 = (sim3_ransac.CHI2_SIM3
                   * self.sigma2[fcur.octave[fi_cur]]).astype(np.float32)
            me2 = (sim3_ransac.CHI2_SIM3
                   * self.sigma2[fc.octave[fi_cand]]).astype(np.float32)
            N = pad_bucket(len(rows), 64)
            padn = N - len(rows)
            samples = self._rng.integers(0, len(rows), (256, 3)).astype(
                np.int32)
            # the samples are a tensor input of the graph, not a
            # constant of its capture
            rr = self._ransac(
                self._t(np.pad(p1, ((0, padn), (0, 0)))),
                self._t(np.pad(p2, ((0, padn), (0, 0)))),
                self._t(np.pad(uv1, ((0, padn), (0, 0)))),
                self._t(np.pad(uv2, ((0, padn), (0, 0)))),
                self._t(np.pad(me1, (0, padn))),
                self._t(np.pad(me2, (0, padn))),
                self._t(np.pad(np.ones(len(rows), bool), (0, padn))),
                self._t(samples), fx, fy, cx, cy,
                int(self.cfg.loop_sim3_min_inliers), bool(self.fix_scale))
            ok, S12 = graphs.Readback((rr.ok, rr.S12)).arrays()
            if not bool(ok):
                log.debug("sim3 cand %d: RANSAC failed (%d bow matches)",
                          cand, len(rows))
                continue
            S12 = np.array(S12)

            # --- SearchBySim3: grow the match set (src/LoopClosing.cc:378) ---
            pc1_all = np.zeros((fcur.n, 3), np.float32)
            pc2_all = np.zeros((fc.n, 3), np.float32)
            mv1 = np.zeros(fcur.n, bool)
            mv2 = np.zeros(fc.n, bool)
            md1 = np.ones(fcur.n, np.float32)
            md2 = np.ones(fc.n, np.float32)
            pc1_all[idx_cur] = self._cam_points(kid, idx_cur)
            pc2_all[idx_cand] = self._cam_points(cand, idx_cand)
            mv1[idx_cur] = True
            mv2[idx_cand] = True
            md1[idx_cur] = np.asarray(store.mp_max_dist[fcur.mp_ids[idx_cur]])
            md2[idx_cand] = np.asarray(store.mp_max_dist[fc.mp_ids[idx_cand]])
            sres = self._match_sim3(
                self._t(pc1_all), fcur.dev("desc"), self._t(mv1),
                self._t(md1), fcur.dev("xy"), fcur.dev("octave"),
                fcur.dev("valid"),
                self._t(pc2_all), fc.dev("desc"), self._t(mv2),
                self._t(md2), fc.dev("xy"), fc.dev("octave"),
                fc.dev("valid"),
                self._t(S12), sf, fx, fy, cx, cy, self.bounds,
                self.cfg.orb.n_levels, self.log_scale, 7.5)
            svalid, sidx = graphs.Readback((sres.valid, sres.idx)).arrays()

            # union of BoW matches and Sim3-search matches, by cur feature
            pair: Dict[int, int] = {int(a): int(b)
                                    for a, b in zip(fi_cur, fi_cand)}
            for i in np.where(svalid)[0]:
                pair.setdefault(int(i), int(sidx[i]))
            fi_cur2 = np.array(sorted(pair), np.int32)
            fi_cand2 = np.array([pair[i] for i in fi_cur2], np.int32)

            # --- OptimizeSim3 (src/Optimizer.cc:985-1218) ---
            p1 = self._cam_points(kid, fi_cur2)
            p2 = self._cam_points(cand, fi_cand2)
            M = pad_bucket(len(fi_cur2), 64)
            padm = M - len(fi_cur2)
            ores = sim3_opt.optimize_sim3(
                self._t(S12),
                self._t(np.pad(p1, ((0, padm), (0, 0)))),
                self._t(np.pad(p2, ((0, padm), (0, 0)))),
                self._t(np.pad(fcur.xy[fi_cur2], ((0, padm), (0, 0)))),
                self._t(np.pad(fc.xy[fi_cand2], ((0, padm), (0, 0)))),
                self._t(np.pad(1.0 / self.sigma2[fcur.octave[fi_cur2]],
                               (0, padm)).astype(np.float32)),
                self._t(np.pad(1.0 / self.sigma2[fc.octave[fi_cand2]],
                               (0, padm)).astype(np.float32)),
                self._t(np.pad(np.ones(len(fi_cur2), bool), (0, padm))),
                fx, fy, cx, cy, iters=8, fix_scale=self.fix_scale)
            n_inl, S12, inl = graphs.Readback(
                (ores.n_inliers, ores.S12,
                 ores.inliers1 & ores.inliers2)).arrays()
            n_inl = int(n_inl)
            if n_inl < self.cfg.loop_sim3_min_inliers:
                log.debug("sim3 cand %d: OptimizeSim3 inliers %d < %d",
                          cand, n_inl, self.cfg.loop_sim3_min_inliers)
                continue
            S12 = np.array(S12)
            inl = inl[:len(fi_cur2)]

            # matched loop MPs on current-KF features (the Sim3 inliers)
            matched: Dict[int, int] = {}
            for j in np.where(inl)[0]:
                matched[int(fi_cur2[j])] = int(fc.mp_ids[fi_cand2[j]])

            # corrected Scw = S12 * Sim3(Tcw_cand) (src/LoopClosing.cc:404-409)
            Scw = _compose(S12, _sim3_from_se3(store.kfs[cand].Tcw))

            # --- gather loop-group map points + Scw projection ---
            loop_mps: List[int] = []
            seen: Set[int] = set()
            for gk in [cand] + store.get_best_covisibles(cand, 10 ** 9):
                for pid in store.kfs[gk].frame.mp_ids:
                    if pid >= 0 and pid not in seen and store.mp_valid[pid]:
                        seen.add(pid)
                        loop_mps.append(int(pid))
            n_total = self._project_loop_points(kid, Scw, loop_mps, matched)
            if n_total < self.cfg.loop_min_total_matches:
                log.debug("sim3 cand %d: total loop matches %d < %d",
                          cand, n_total, self.cfg.loop_min_total_matches)
                continue
            return cand, Scw, loop_mps, matched
        return None

    def _search_sim3_projection(self, pids: List[int], S: np.ndarray,
                                kid: int, has_mp: np.ndarray, th: float):
        """SearchByProjection(KF, Scw, points) of the given map points
        into keyframe ``kid``: (valid (P,), feature idx (P,)) on the
        host."""
        store = self.store
        f = store.kfs[kid].frame
        fx, fy, cx, cy = self._cam_tuple
        soa = store.points_soa(pids)
        P = pad_bucket(len(pids))
        pad = P - len(pids)
        res = self._match_proj(
            self._t(np.pad(soa["pos"], ((0, pad), (0, 0)))),
            self._desc(np.pad(soa["desc"], ((0, pad), (0, 0)))),
            self._t(np.pad(soa["normal"], ((0, pad), (0, 0)))),
            self._t(np.pad(soa["max_dist"], (0, pad))),
            self._t(np.pad(soa["valid"], (0, pad))),
            self._t(S),
            f.dev("xy"), f.dev("octave"), f.dev("desc"), f.dev("valid"),
            self._t(has_mp), self._scales(),
            fx, fy, cx, cy, self.bounds,
            self.cfg.orb.n_levels, self.log_scale, float(th), search.TH_LOW)
        valid, idx = graphs.Readback((res.valid, res.idx)).arrays()
        return valid[:len(pids)], idx[:len(pids)]

    def _project_loop_points(self, kid: int, Scw: np.ndarray,
                             loop_mps: List[int],
                             matched: Dict[int, int]) -> int:
        """SearchByProjection(Scw) over loop map points, adding new
        matches into ``matched`` (src/LoopClosing.cc:418-460)."""
        f = self.store.kfs[kid].frame
        if not loop_mps:
            return len(matched)
        already = np.zeros(f.n, bool)
        for i in matched:
            already[i] = True
        rvalid, ridx = self._search_sim3_projection(loop_mps, Scw, kid,
                                                    already, th=10.0)
        claimed = set(matched.values())
        for j in np.where(rvalid)[0]:
            pid = loop_mps[j]
            feat = int(ridx[j])
            if feat not in matched and pid not in claimed:
                matched[feat] = pid
                claimed.add(pid)
        return len(matched)

    # ------------------------------------------------------------------
    # CorrectLoop (src/LoopClosing.cc:471-680)
    # ------------------------------------------------------------------
    def _correct_loop(self, kid: int, loop_kf: int, Scw: np.ndarray,
                      loop_mps: List[int], matched: Dict[int, int]):
        store = self.store
        group = [kid] + [k for k in store.get_best_covisibles(kid, 10 ** 9)
                         if store.kfs[k].valid]
        T_cur = store.kfs[kid].Tcw.copy()
        corrected: Dict[int, np.ndarray] = {kid: Scw}
        non_corrected: Dict[int, np.ndarray] = {}
        for gk in group:
            T_g = store.kfs[gk].Tcw
            non_corrected[gk] = _sim3_from_se3(T_g)
            if gk != kid:
                T_gc = (T_g @ np.linalg.inv(T_cur)).astype(np.float32)
                corrected[gk] = _compose(_sim3_from_se3(T_gc), Scw)

        # remap group map points through corrected^-1 * non_corrected
        # (src/LoopClosing.cc:520-560)
        moved: Set[int] = set()
        for gk in group:
            fix = sim3_mod.compose(sim3_mod.inv(_h(corrected[gk])),
                                   _h(non_corrected[gk]))
            pids = [p for p in store.kfs[gk].frame.mp_ids
                    if p >= 0 and p not in moved and store.mp_valid[p]]
            if pids:
                pos = np.asarray(store.mp_pos[np.asarray(pids, np.int64)])
                new = sim3_mod.apply(fix, _h(pos)).numpy()
                for p, x in zip(pids, new):
                    store.mp_pos[p] = x.astype(np.float32)
                    moved.add(p)
            # SE3 writeback with t/s (src/LoopClosing.cc:569-573)
            store.set_kf_pose(gk, _se3_from_sim3(corrected[gk]))
        store.update_points_batch(list(moved))
        for gk in group:
            store.update_connections(gk)

        # replace/add matched loop MPs on the current KF
        # (src/LoopClosing.cc:599-621)
        fcur = store.kfs[kid].frame
        for feat, lp in matched.items():
            if not store.mp_valid[lp]:
                continue
            cur_p = fcur.mp_ids[feat]
            if cur_p >= 0 and store.mp_valid[cur_p] and cur_p != lp:
                store.replace_point(cur_p, lp)
            elif cur_p < 0:
                store.add_observation(lp, kid, feat)
                store.update_point_descriptor(lp)
                store.update_normal_and_depth(lp)

        # SearchAndFuse: loop MPs into every corrected KF, radius x4
        # (src/LoopClosing.cc:688-725)
        pre_connections = {gk: set(store.covis[gk]) for gk in group}
        for gk in group:
            self._fuse_loop_points(gk, corrected[gk], loop_mps)
        for gk in group:
            store.update_connections(gk)

        # new loop connections (src/LoopClosing.cc:633-654)
        loop_connections: Dict[int, Set[int]] = {}
        group_set = set(group)
        for gk in group:
            new_conn = set(store.covis[gk]) - pre_connections[gk] - group_set
            if new_conn:
                loop_connections[gk] = new_conn

        with self.timer.time("loop/essential_graph"):
            self._optimize_essential_graph(kid, loop_kf, corrected,
                                           non_corrected, loop_connections)

        # add loop edges (src/LoopClosing.cc:663-664)
        store.kfs[kid].loop_edges.add(loop_kf)
        store.kfs[loop_kf].loop_edges.add(kid)

        with self.timer.time("loop/global_ba"):
            self.run_global_ba(loop_kf_id=kid)
        self.last_loop = dict(kid=kid, loop_kf=loop_kf,
                              n_matched=len(matched),
                              # solved Sim3 scale of the loop transform
                              scale=float(sim3_mod.scale(_h(Scw))),
                              loop_connections={k: set(v) for k, v in
                                                loop_connections.items()})

    def _fuse_loop_points(self, gk: int, S_gw: np.ndarray,
                          loop_mps: List[int]):
        """ORBmatcher::Fuse(pKF, Scw, points, 4) with Replace semantics
        (src/ORBmatcher.cc:1218-1366, src/LoopClosing.cc:700-723)."""
        store = self.store
        f = store.kfs[gk].frame
        pids = [p for p in loop_mps
                if store.mp_valid[p] and gk not in store.mp_obs[p]]
        if not pids:
            return
        rvalid, ridx = self._search_sim3_projection(
            pids, S_gw, gk, np.zeros(f.n, bool), th=4.0)  # bound allowed
        for j in np.where(rvalid)[0]:
            pid = pids[j]
            feat = int(ridx[j])
            existing = f.mp_ids[feat]
            if existing >= 0 and store.mp_valid[existing]:
                if existing != pid:
                    # loop point wins (src/LoopClosing.cc:716-719)
                    store.replace_point(existing, pid)
            elif store.mp_valid[pid] and gk not in store.mp_obs[pid]:
                store.add_observation(pid, gk, feat)

    # ------------------------------------------------------------------
    # OptimizeEssentialGraph (src/Optimizer.cc:654-983)
    # ------------------------------------------------------------------
    def _optimize_essential_graph(self, cur_kf: int, loop_kf: int,
                                  corrected: Dict[int, np.ndarray],
                                  non_corrected: Dict[int, np.ndarray],
                                  loop_connections: Dict[int, Set[int]]):
        store = self.store
        kids = store.valid_kf_ids()
        vid = {k: i for i, k in enumerate(kids)}
        K = len(kids)

        sims0 = np.zeros((K, 8), np.float32)
        for k, i in vid.items():
            s = corrected.get(k)
            sims0[i] = s if s is not None else _sim3_from_se3(store.kfs[k].Tcw)
        sims_before = sims0.copy()

        def rel(Si_w: np.ndarray, Sj_w: np.ndarray) -> np.ndarray:
            """Sji such that the residual log(Sji * Si * Sj^-1) = 0."""
            return sim3_mod.compose(_h(Sj_w), sim3_mod.inv(_h(Si_w))).numpy()

        def nc_sim(k: int) -> np.ndarray:
            s = non_corrected.get(k)
            return s if s is not None else _sim3_from_se3(store.kfs[k].Tcw)

        edges_i: List[int] = []
        edges_j: List[int] = []
        meas: List[np.ndarray] = []
        inserted: Set[Tuple[int, int]] = set()

        def add_edge(ki: int, kj: int, Sji: np.ndarray):
            key = (min(ki, kj), max(ki, kj))
            if key in inserted or ki == kj:
                return
            inserted.add(key)
            edges_i.append(vid[ki])
            edges_j.append(vid[kj])
            meas.append(Sji)

        # loop connections: current (corrected) vertex estimates, weight
        # gate 100 except the (cur, loop) pair (src/Optimizer.cc:720-745)
        for ki, conns in loop_connections.items():
            for kj in conns:
                if kj not in vid or ki not in vid:
                    continue
                if not ((ki == cur_kf and kj == loop_kf)
                        or (ki == loop_kf and kj == cur_kf)):
                    if store.covis[ki].get(kj, 0) < 100:
                        continue
                add_edge(ki, kj, rel(sims0[vid[ki]], sims0[vid[kj]]))

        # normal edges measured with PRE-correction poses
        # (src/Optimizer.cc:747-830)
        for k in kids:
            kf = store.kfs[k]
            Siw_nc = nc_sim(k)
            if kf.parent >= 0 and kf.parent in vid:
                add_edge(k, kf.parent, rel(Siw_nc, nc_sim(kf.parent)))
            for le in kf.loop_edges:
                if le < k and le in vid:
                    add_edge(k, le, rel(Siw_nc, nc_sim(le)))
            for kj in store.get_covisibles_by_weight(k, 100):
                if kj < k and kj in vid and kj != kf.parent \
                        and kj not in kf.children:
                    add_edge(k, kj, rel(Siw_nc, nc_sim(kj)))

        if not edges_i:
            return

        Kp = pad_bucket(K, 8)
        E = pad_bucket(len(edges_i), 16)
        ident = sim3_mod.identity().numpy()
        fixed = np.zeros(Kp, bool)
        fixed[K:] = True
        fixed[vid[loop_kf]] = True
        sims_p = np.concatenate([sims0, np.tile(ident, (Kp - K, 1))])
        ei = np.pad(np.asarray(edges_i, np.int64), (0, E - len(edges_i)))
        ej = np.pad(np.asarray(edges_j, np.int64), (0, E - len(edges_i)))
        em = np.concatenate([np.stack(meas),
                             np.tile(ident, (E - len(meas), 1))]).astype(
            np.float32)
        ew = np.pad(np.ones(len(edges_i), np.float32), (0, E - len(edges_i)))

        res = pose_graph.optimize_pose_graph(
            self._t(sims_p), self._t(ei), self._t(ej), self._t(em),
            self._t(ew), self._t(fixed), iters=20, cg_iters=30,
            longest=segment.longest_segment(np.concatenate([ei, ej]), Kp))
        sims_new = graphs.Readback((res.sims,)).arrays()[0][:K]

        # writeback poses (src/Optimizer.cc:929-940)
        for k, i in vid.items():
            store.set_kf_pose(k, _se3_from_sim3(sims_new[i]))

        # remap map points via their reference KF (src/Optimizer.cc:
        # 944-983), grouped by vertex: one batched fix per vertex
        pids_all = np.where(np.asarray(store.mp_valid, bool))[0]
        if len(pids_all) == 0:
            return
        kid2v = np.full(store.max_kf_id + 2, -1, np.int64)
        for k, i in vid.items():
            kid2v[k] = i
        first = np.asarray(store.mp_first_kf[pids_all], np.int64)
        vi = np.where((first >= 0) & (first <= store.max_kf_id),
                      kid2v[np.clip(first, 0, store.max_kf_id)], -1)
        # points whose first KF left the graph use any observing vertex
        for j in np.where(vi < 0)[0]:
            ref = next((k for k in store.mp_obs[pids_all[j]] if k in vid),
                       None)
            if ref is not None:
                vi[j] = vid[ref]
        keep = vi >= 0
        pids_all, vi = pids_all[keep], vi[keep]
        if len(pids_all) == 0:
            return
        # per-vertex correction fix_i = S_after_i^-1 * S_before_i
        fixes = sim3_mod.compose(sim3_mod.inv(_h(sims_new)), _h(sims_before))
        Rm = sim3_mod.rot(fixes).numpy()
        fixes = fixes.numpy()
        tv, sv = fixes[:, 4:7], fixes[:, 7]
        pos = np.asarray(store.mp_pos[pids_all], np.float64)
        for i in np.unique(vi):
            m = vi == i
            pos[m] = sv[i] * (pos[m] @ Rm[i].T) + tv[i]
        store.mp_pos[pids_all] = pos.astype(np.float32)
        store.update_points_batch(pids_all.tolist())

    # ------------------------------------------------------------------
    # RunGlobalBundleAdjustment (src/LoopClosing.cc:753-894)
    # ------------------------------------------------------------------
    def run_global_ba(self, loop_kf_id: int = 0, iters: int = 10):
        """Full-map BA, gauge fixed at KF 0 (the reference's post-loop
        GBA, src/LoopClosing.cc:764-768).  No keyframe is created
        mid-GBA (it runs inside the mapper's locked section), so the
        spanning-tree propagation (src/LoopClosing.cc:807-884) reduces
        to a direct writeback.  Huber stays on, unlike the reference's
        bRobust=false: the JAX package measured the non-robust solve
        dragging the corrected map away from ground truth."""
        store = self.store
        kids = store.valid_kf_ids()
        if len(kids) < 2:
            return
        inv_sigma2 = (1.0 / self.sigma2).astype(np.float32)
        pids, packed = gather_ba_problem(store, kids, inv_sigma2)
        if packed is None or len(pids) == 0:
            return
        obs_kf, obs_pt, obs_uv, obs_sig, _ = packed
        poses = np.stack([store.kfs[k].Tcw for k in kids])
        points0 = np.asarray(store.mp_pos[np.asarray(pids, np.int64)])
        fixed = np.zeros(len(kids), bool)
        fixed[0] = True

        Kp = pad_bucket(len(kids), 8)
        P = pad_bucket(len(pids))
        O = pad_bucket(len(obs_kf))
        no = len(obs_kf)
        fx, fy, cx, cy = self._cam_tuple
        eye = np.broadcast_to(np.eye(4, dtype=np.float32),
                              (Kp - len(kids), 4, 4))
        devices = parallel.local_devices(store.device)
        obs_kf_p = np.pad(obs_kf, (0, O - no))
        obs_pt_p = np.pad(obs_pt, (0, O - no))
        # the single-device layout's longest runs, from the host: the
        # sharded branch's sums take the reductions that solve takes
        longest = dict(longest_cam=segment.longest_segment(obs_kf_p, Kp),
                       longest_pt=segment.longest_segment(obs_pt_p, P))
        if len(devices) > 1:
            # memory-scaling variant: the POINT state (and Hpp, gp, the
            # deltas) sharded over the devices with the observations
            # colocated, so the map can outgrow one device; each shard
            # replays its graph chain (parallel/dist_ba.py)
            res = parallel.distributed_bundle_adjust_sharded_points(
                parallel.make_mesh(devices),
                np.concatenate([poses, eye]).astype(np.float32),
                points0, obs_kf, obs_pt, obs_uv, obs_sig,
                np.ones(no, bool),
                np.pad(fixed, (0, Kp - len(kids)), constant_values=True),
                fx, fy, cx, cy, iters=iters, cg_iters=30, use_huber=True,
                **longest)
        else:
            res = ba.bundle_adjust(
                self._t(np.concatenate([poses, eye]).astype(np.float32)),
                self._t(np.pad(points0, ((0, P - len(pids)), (0, 0)))),
                self._t(obs_kf_p), self._t(obs_pt_p),
                self._t(np.pad(obs_uv, ((0, O - no), (0, 0)))),
                self._t(np.pad(obs_sig, (0, O - no))),
                self._t(np.pad(np.ones(no, bool), (0, O - no))),
                self._t(np.pad(fixed, (0, Kp - len(kids)), constant_values=True)),
                fx, fy, cx, cy, iters=iters, cg_iters=30, use_huber=True,
                **longest)
        new_poses, new_pts = graphs.Readback(
            (res.cam_Tcw, res.points)).arrays()
        for i, k in enumerate(kids):
            if not fixed[i]:
                store.set_kf_pose(k, new_poses[i])
        store.mp_pos[np.asarray(pids, np.int64)] = \
            np.asarray(new_pts[:len(pids)], np.float32)
        store.update_points_batch(pids)
