"""BoW inverted-file keyframe database — port of
``orb_slam2_tpu/models/keyframe_db.py``.

Replaces src/KeyFrameDatabase.cc: an inverted file word -> [keyframes],
with the reference's exact candidate-accumulation logic for loop
detection (src/KeyFrameDatabase.cc:105-259) and relocalization
(:261-396): shared-word counting, 0.8*maxCommonWords pruning, L1-score
threshold, accumulation over top-10 covisible groups, 0.75*bestAccScore
final cut.

The shared-word counting + L1 scoring inner loop runs in the native C++
runtime (the port's native/slamcore.cc kfdb_*) with a numpy fallback; the
covisibility-group accumulation stays in Python (tiny candidate sets).
"""
from __future__ import annotations

from typing import Dict, List

from .. import native
from .mapstore import MapStore
from .vocabulary import Vocabulary


class KeyFrameDatabase:
    def __init__(self, voc: Vocabulary):
        self.voc = voc
        self.bow: Dict[int, dict] = {}  # kid -> BoW vector
        self._db = native.NativeKfDatabase()

    def add(self, kid: int, bow_vec: dict):
        self.bow[kid] = bow_vec
        self._db.add(kid, bow_vec)

    def erase(self, kid: int):
        if self.bow.pop(kid, None) is not None:
            self._db.erase(kid)

    def clear(self):
        self.bow.clear()
        self._db = native.NativeKfDatabase()

    # ------------------------------------------------------------------
    def _accumulate_groups(self, store: MapStore, scored: Dict[int, float],
                           floor: float) -> List[int]:
        """Covisibility-group accumulation shared by both detectors
        (src/KeyFrameDatabase.cc:171-252, 330-390)."""
        acc: Dict[int, tuple] = {}
        best_acc = floor
        for cand, s in scored.items():
            group = store.get_best_covisibles(cand, 10)
            acc_score = s
            best_kid, best_s = cand, s
            for g in group:
                if g in scored:
                    acc_score += scored[g]
                    if scored[g] > best_s:
                        best_kid, best_s = g, scored[g]
            acc[cand] = (acc_score, best_kid)
            best_acc = max(best_acc, acc_score)
        min_acc = 0.75 * best_acc
        out = []
        seen = set()
        for cand, (acc_score, best_kid) in acc.items():
            if acc_score > min_acc and best_kid not in seen:
                seen.add(best_kid)
                out.append(best_kid)
        return out

    def detect_loop_candidates(self, store: MapStore, kid: int,
                               min_score: float) -> List[int]:
        """src/KeyFrameDatabase.cc:105-259."""
        connected = set(store.covis[kid]) | {kid}
        query = self.bow.get(kid)
        if query is None:
            return []
        kids, counts, scores = self._db.query(query, exclude=connected)
        if len(kids) == 0:
            return []
        min_common = 0.8 * counts.max()
        scored = {int(k): float(s)
                  for k, c, s in zip(kids, counts, scores)
                  if c > min_common and s >= min_score}
        if not scored:
            return []
        return self._accumulate_groups(store, scored, floor=min_score)

    def detect_relocalization_candidates(self, store: MapStore,
                                         bow_vec: dict) -> List[int]:
        """src/KeyFrameDatabase.cc:261-396 — same scheme, no covisible
        exclusion, no absolute minimum score."""
        kids, counts, scores = self._db.query(bow_vec)
        if len(kids) == 0:
            return []
        min_common = 0.8 * counts.max()
        scored = {int(k): float(s)
                  for k, c, s in zip(kids, counts, scores)
                  if c > min_common}
        if not scored:
            return []
        return self._accumulate_groups(store, scored, floor=0.0)
