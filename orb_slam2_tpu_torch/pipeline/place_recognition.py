"""Shared place-recognition state: vocabulary + BoW keyframe database.

Port of ``orb_slam2_tpu/pipeline/place_recognition.py``.  The reference
loads a prebuilt ORBvoc at startup (src/System.cc:65-72) and every
KeyFrame computes its BoW vector against it (src/KeyFrame.cc
ComputeBoW).  Both modes are supported:

- an explicit :class:`~orb_slam2_tpu_torch.models.vocabulary.Vocabulary`,
- lazy self-training: once ``min_train_keyframes`` keyframes exist, a
  vocabulary is trained from their descriptors and all pending BoW
  vectors are backfilled.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .. import graphs
from ..models.keyframe_db import KeyFrameDatabase
from ..models.mapstore import MapStore
from ..models.vocabulary import Vocabulary


class PlaceRecognition:
    def __init__(self, store: MapStore,
                 vocab: Optional[Vocabulary] = None,
                 min_train_keyframes: int = 4,
                 train_k: int = 10, train_levels: int = 4):
        self.store = store
        self.vocab = vocab
        self.min_train_keyframes = min_train_keyframes
        self.train_k = train_k
        self.train_levels = train_levels
        self.db: Optional[KeyFrameDatabase] = (
            KeyFrameDatabase(vocab) if vocab is not None else None)
        self.bow: Dict[int, dict] = {}      # kid -> BoW vector
        self._pending: List[int] = []       # KFs awaiting a vocabulary

    # ------------------------------------------------------------------
    def _train_if_ready(self):
        if self.vocab is not None:
            return
        kids = [kf.kid for kf in self.store.kfs if kf.valid]
        if len(kids) < self.min_train_keyframes:
            return
        descs = []
        for kid in kids:
            f = self.store.kfs[kid].frame
            descs.append(f.desc[f.valid])
        desc = np.concatenate(descs)
        # production-scale tree (k=10, L=4 -> 10k words); a deep tree
        # trained on few descriptors just leaves unused leaves, so gate
        # only on having a sane sample
        if len(desc) < max(1000, 4 * self.train_k ** 2):
            return
        self.vocab = Vocabulary.train(
            desc, k=self.train_k, levels=self.train_levels,
            kmeans_iters=4, seed=0, max_train=30_000)
        self.db = KeyFrameDatabase(self.vocab)

    def _words_nodes(self, frame):
        """Vocabulary descent of one frame on its device, one read back.
        Returns (valid-feature word ids, per-feature node ids with -1 at
        invalid rows) and caches the node ids on the frame for the
        FeatureVector-style SearchByBoW blocking
        (src/ORBmatcher.cc:222-392)."""
        w, nd = graphs.Readback(
            self.vocab.transform(frame.dev("desc"))).arrays()
        valid = np.asarray(frame.valid, bool)
        words = w[:len(valid)][valid]
        nodes = np.where(valid, nd[:len(valid)], -1).astype(np.int32)
        frame.bow_nodes = nodes
        return words, nodes

    def compute_nodes(self, frame) -> Optional[np.ndarray]:
        """Per-feature node ids at the vocabulary's blocking level
        (cached on the frame; None until a vocabulary exists)."""
        if self.vocab is None:
            return None
        nodes = getattr(frame, "bow_nodes", None)
        if nodes is None:
            _, nodes = self._words_nodes(frame)
        return nodes

    def _compute_bow(self, kid: int) -> dict:
        f = self.store.kfs[kid].frame
        words, _ = self._words_nodes(f)
        return self.vocab.bow_vector_from_words(words)

    # ------------------------------------------------------------------
    def add_keyframe(self, kid: int):
        """KeyFrame::ComputeBoW + KeyFrameDatabase::add.  The KF enters
        the inverted file at once; the candidate searches exclude the
        query KF (the reference adds it after DetectLoop,
        src/LoopClosing.cc:172-175)."""
        if self.vocab is None:
            self._pending.append(kid)
            with self.store.unlocked():
                # k-medians training + backfill transforms read only
                # immutable frame descriptors: the map lock is not held
                self._train_if_ready()
                if self.vocab is None:
                    return
                vecs = [(p, self._compute_bow(p)) for p in self._pending
                        if self.store.kfs[p].valid and p not in self.bow]
            for p, vec in vecs:
                self.bow[p] = vec
                self.db.add(p, vec)
            self._pending.clear()
            return
        with self.store.unlocked():
            vec = self._compute_bow(kid)
        self.bow[kid] = vec
        self.db.add(kid, vec)

    def erase_keyframe(self, kid: int):
        if self.db is not None:
            self.db.erase(kid)
        self.bow.pop(kid, None)

    def frame_bow(self, desc: np.ndarray, valid: np.ndarray) -> Optional[dict]:
        """A frame's BoW vector from its host descriptors ((N, 8) uint32
        words, (N,) bool) by the host descent."""
        if self.vocab is None:
            return None
        return self.vocab.bow_vector(desc, valid)

    def frame_bow_f(self, frame) -> Optional[dict]:
        """A frame's BoW vector by the device descent (also caches the
        frame's node ids for the SearchByBoW that follows)."""
        if self.vocab is None:
            return None
        words, _ = self._words_nodes(frame)
        return self.vocab.bow_vector_from_words(words)

    @property
    def ready(self) -> bool:
        return self.vocab is not None

    # ------------------------------------------------------------------
    def loop_candidates(self, kid: int, min_score: float) -> List[int]:
        if self.db is None or kid not in self.bow:
            return []
        out = self.db.detect_loop_candidates(self.store, kid, min_score)
        return [k for k in out if k != kid and self.store.kfs[k].valid]

    def reloc_candidates(self, bow_vec: dict) -> List[int]:
        if self.db is None or bow_vec is None:
            return []
        out = self.db.detect_relocalization_candidates(self.store, bow_vec)
        return [k for k in out if self.store.kfs[k].valid]

    def score(self, v1: dict, v2: dict) -> float:
        return Vocabulary.score_l1(v1, v2)

    def min_covisible_score(self, kid: int) -> float:
        """minScore = min BoW similarity against covisible neighbors
        (src/LoopClosing.cc:146-162)."""
        if kid not in self.bow:
            return 1.0
        vec = self.bow[kid]
        scores = [self.score(vec, self.bow[nb])
                  for nb in self.store.covis[kid]
                  if nb in self.bow and self.store.kfs[nb].valid]
        return min(scores) if scores else 1.0
