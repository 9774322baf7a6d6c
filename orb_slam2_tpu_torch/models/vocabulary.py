"""Binary bag-of-words vocabulary — port of
``orb_slam2_tpu/models/vocabulary.py`` (replaces DBoW2,
Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h, FORB).

A k-ary tree of binary (256-bit) cluster centers.  Training is
hierarchical k-medians with bit-majority center updates on the host, a
verbatim copy of the JAX package's numpy code, so equal descriptors give
equal centers and idf.  The transform (descriptor -> leaf word +
intermediate node for match blocking) runs on the frame's device in
plain torch: per tree level, gather the current node's k child centers,
XOR, popcount and take the lowest-index argmin — all features descend
in lockstep.  (In the JAX package this descent is plain XLA too, outside
any Pallas kernel.)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..matching.core import _min_lowest


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 tensors holding uint32 bits (SWAR
    in int64, so the shifts are logical)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def transform_device(centers, desc: torch.Tensor, k: int, node_level: int):
    """Batched vocabulary-tree descent on ``desc``'s device.

    centers: per-level (k**(l+1), 8) int32 tensors (uint32 bits), on the
    same device.  desc: (N, 8) int32.  Returns (word_ids (N,),
    node_ids (N,)) int64."""
    node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    node_at = node
    for lvl, C in enumerate(centers):
        cand = C.reshape(-1, k, 8)[node]                # (N, k, 8)
        d = popcount32(cand ^ desc[:, None, :]).sum(-1)
        _, arg = _min_lowest(d, dim=1)
        node = node * k + arg
        if lvl == node_level - 1:
            node_at = node
    return node, node_at


def _unpack_bits(desc: np.ndarray) -> np.ndarray:
    """(N, 8) uint32 -> (N, 256) uint8 bits."""
    return np.unpackbits(
        desc.astype("<u4").view(np.uint8), axis=-1, bitorder="little")


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    """(N, 256) {0,1} -> (N, 8) uint32."""
    return np.packbits(bits.astype(np.uint8), axis=-1,
                       bitorder="little").view("<u4")


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    x = np.bitwise_xor(a[:, None, :], b[None, :, :])
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _kmedians_binary(desc: np.ndarray, k: int, iters: int, rng) -> np.ndarray:
    """Binary k-medians: Hamming assignment + bit-majority update."""
    n = len(desc)
    k = min(k, n)
    centers = desc[rng.choice(n, k, replace=False)]
    for _ in range(iters):
        d = _hamming_np(desc, centers)
        assign = d.argmin(1)
        new = []
        for c in range(k):
            members = desc[assign == c]
            if len(members) == 0:
                new.append(desc[rng.integers(n)])
                continue
            bits = _unpack_bits(members)
            maj = (bits.mean(0) >= 0.5)
            new.append(_pack_bits(maj[None])[0])
        centers = np.stack(new)
    return centers


@dataclass
class Vocabulary:
    k: int
    levels: int
    # centers[l]: (k**(l+1), 8) uint32 — children of node i at level l
    # are rows [i*k, (i+1)*k) of centers[l].
    centers: list
    idf: np.ndarray  # (k**levels,) inverse document frequency
    node_level: int = 2  # level whose node ids block BoW matching
                         # (the reference uses vocab level 4 of 6,
                         # src/Frame.cc:483-500; scaled to our depth)

    @property
    def n_words(self) -> int:
        return self.k ** self.levels

    # ------------------------------------------------------------------
    @staticmethod
    def train(descriptors: np.ndarray, k: int = 10, levels: int = 4,
              kmeans_iters: int = 6, seed: int = 0,
              max_train: int = 200_000) -> "Vocabulary":
        rng = np.random.default_rng(seed)
        desc = np.asarray(descriptors, np.uint32)
        if len(desc) > max_train:
            desc = desc[rng.choice(len(desc), max_train, replace=False)]

        centers = []
        # level 0: k clusters of everything
        groups = [desc]
        for lvl in range(levels):
            new_centers = np.zeros((k ** (lvl + 1), 8), np.uint32)
            new_groups = []
            for gi, g in enumerate(groups):
                if len(g) == 0:
                    cs = np.zeros((k, 8), np.uint32)
                    assign = np.zeros(0, np.int64)
                else:
                    cs = _kmedians_binary(g, k, kmeans_iters, rng)
                    if len(cs) < k:  # degenerate tiny group
                        cs = np.concatenate(
                            [cs, np.tile(cs[-1:], (k - len(cs), 1))])
                    assign = _hamming_np(g, cs).argmin(1)
                new_centers[gi * k:(gi + 1) * k] = cs
                for c in range(k):
                    new_groups.append(g[assign == c] if len(g) else g)
            centers.append(new_centers)
            groups = new_groups

        voc = Vocabulary(k=k, levels=levels, centers=centers,
                         idf=np.ones(k ** levels, np.float32))
        # idf from the training corpus treated as one document per ~500
        # descriptors (approximates per-image statistics)
        words = voc.transform_np(desc)
        n_docs = max(len(desc) // 500, 1)
        counts = np.zeros(voc.n_words, np.int64)
        for d in range(n_docs):
            counts[np.unique(words[d::n_docs])] += 1
        voc.idf = np.log(n_docs / np.maximum(counts, 1)).astype(np.float32)
        voc.idf[counts == 0] = np.log(n_docs)
        return voc

    # ------------------------------------------------------------------
    def transform_np(self, desc: np.ndarray) -> np.ndarray:
        """Host transform: (N, 8) uint32 -> word ids (N,)."""
        node = np.zeros(len(desc), np.int64)
        for lvl in range(self.levels):
            cand = self.centers[lvl].reshape(-1, self.k, 8)[node]  # (N, k, 8)
            x = np.bitwise_xor(cand, desc[:, None, :])
            d = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
            node = node * self.k + d.argmin(1)
        return node

    def device_arrays(self, device) -> tuple:
        """Per-level center tensors (int32 with the uint32 bits) on
        ``device``, uploaded once per device and cached."""
        cache = self.__dict__.setdefault("_dev_centers", {})
        key = str(torch.device(device))
        dev = cache.get(key)
        if dev is None:
            dev = tuple(torch.as_tensor(
                np.asarray(c, np.uint32).view(np.int32), device=device)
                for c in self.centers)
            cache[key] = dev
        return dev

    def transform(self, desc: torch.Tensor):
        """Device transform: (N, 8) int32 -> (word_ids, node_ids) on
        ``desc``'s device."""
        return transform_device(self.device_arrays(desc.device), desc,
                                k=self.k, node_level=self.node_level)

    # ------------------------------------------------------------------
    def bow_vector_from_words(self, words: np.ndarray) -> dict:
        """(n,) word ids -> L1-normalized tf-idf dict (DBoW2 TF_IDF +
        L1, the ORBvoc configuration)."""
        uniq, counts = np.unique(np.asarray(words, np.int64),
                                 return_counts=True)
        w = counts * self.idf[uniq]
        s = float(w.sum())
        if s > 0:
            w = w / s
        return dict(zip(uniq.tolist(), w.tolist()))

    def bow_vector(self, desc: np.ndarray, valid: np.ndarray) -> dict:
        return self.bow_vector_from_words(self.transform_np(desc[valid]))

    @staticmethod
    def score_l1(v1: dict, v2: dict) -> float:
        """DBoW2 L1 score: 1 - 0.5 |v1 - v2|_1 =
        sum over shared words of (|a|+|b|-|a-b|)/2
        (ScoringObject.cpp L1Scoring)."""
        if len(v2) < len(v1):
            v1, v2 = v2, v1
        s = 0.0
        for w, a in v1.items():
            b = v2.get(w)
            if b is not None:
                s += abs(a) + abs(b) - abs(a - b)
        return 0.5 * s

    # ------------------------------------------------------------------
    def save(self, path: str):
        np.savez_compressed(
            path, k=self.k, levels=self.levels, idf=self.idf,
            node_level=self.node_level,
            **{f"centers_{i}": c for i, c in enumerate(self.centers)})

    @staticmethod
    def load(path: str) -> "Vocabulary":
        z = np.load(path)
        levels = int(z["levels"])
        return Vocabulary(
            k=int(z["k"]), levels=levels,
            centers=[z[f"centers_{i}"] for i in range(levels)],
            idf=z["idf"], node_level=int(z["node_level"]))

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other
