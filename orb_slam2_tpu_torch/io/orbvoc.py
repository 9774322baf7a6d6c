"""Binary ORBvoc.bin parser -> device-friendly Vocabulary (port of
``orb_slam2_tpu/io/orbvoc.py``, host numpy; builds the port's
``models/vocabulary.Vocabulary``).

Reads the DBoW2 binary vocabulary format written by
TemplatedVocabulary::saveToBinaryFile and read by loadFromBinaryFile
(Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1444-1546):

  header:  u32 nb_nodes, u32 size_node, i32 k, i32 L, i32 scoring,
           i32 weighting
  records: nb_nodes-1 fixed-size entries
           { i32 parent, u8 descriptor[32], f32 weight, u8 is_leaf }

The DBoW2 tree is *ragged* (clusters with < k points produce early
leaves); our device transform wants a complete k-ary level-block layout
(models/vocabulary.py).  The conversion flattens the tree level by
level: every real node gets slot = parent_slot * k + sibling_rank;
early leaves propagate their descriptor down the slot-0 chain (so the
batched Hamming-argmin descent deterministically resolves to one slot
per leaf — ties break to the lowest index); vacant sibling slots copy
sibling 0 (equal distance, higher index -> never selected).  Word
weights land in an idf array indexed by final-level slot.

Everything is vectorized numpy — a 1.1M-node ORBvoc parses in one
``np.frombuffer`` plus L passes.
"""
from __future__ import annotations

import numpy as np

from ..models.vocabulary import Vocabulary


def load_orbvoc_binary(path: str) -> Vocabulary:
    with open(path, "rb") as f:
        raw = f.read()
    header = np.frombuffer(raw[:24], dtype=np.dtype(
        [("nb_nodes", "<u4"), ("size_node", "<u4"), ("k", "<i4"),
         ("L", "<i4"), ("scoring", "<i4"), ("weighting", "<i4")]))[0]
    k = int(header["k"])
    L = int(header["L"])
    size_node = int(header["size_node"])
    desc_len = size_node - 9  # parent(4) + weight(4) + leaf(1)
    if desc_len != 32:
        raise ValueError(f"unsupported descriptor length {desc_len}")
    body = raw[24:]
    n_rec = len(body) // size_node
    rec = np.frombuffer(body[:n_rec * size_node], dtype=np.dtype(
        [("parent", "<i4"), ("desc", "u1", (32,)),
         ("weight", "<f4"), ("leaf", "u1")]))

    # node ids: records are nodes 1..n_rec (root = 0 implicit; its own
    # parent is set to -1 so it never ranks as a sibling of its children)
    parent = np.concatenate([[-1], rec["parent"].astype(np.int64)])
    desc8 = np.zeros((n_rec + 1, 8), np.uint32)
    desc8[1:] = rec["desc"].view("<u4").reshape(n_rec, 8)
    weight = np.concatenate([[0.0], rec["weight"].astype(np.float64)])
    is_leaf = np.concatenate([[False], rec["leaf"].astype(bool)])
    return _build_vocab(k, L, parent, desc8, weight, is_leaf, n_rec)


def load_orbvoc_text(path: str) -> Vocabulary:
    """Parse the DBoW2 TEXT vocabulary format (saveToTextFile,
    TemplatedVocabulary.h:1548-1574) — the format upstream ORB-SLAM2
    ships as ORBvoc.txt: a header line ``k L scoring weighting`` then
    one node per line ``parent is_leaf d0..d31 weight`` in node order."""
    with open(path) as f:
        head = f.readline().split()
        k, L = int(head[0]), int(head[1])
        rows = np.loadtxt(f, dtype=np.float64)
    n_rec = len(rows)
    parent = np.concatenate([[-1], rows[:, 0].astype(np.int64)])
    is_leaf = np.concatenate([[False], rows[:, 1].astype(bool)])
    desc_u8 = rows[:, 2:34].astype(np.uint8)
    desc8 = np.zeros((n_rec + 1, 8), np.uint32)
    desc8[1:] = np.ascontiguousarray(desc_u8).view("<u4").reshape(n_rec, 8)
    weight = np.concatenate([[0.0], rows[:, 34]])
    return _build_vocab(k, L, parent, desc8, weight, is_leaf, n_rec)


def save_orbvoc_binary(voc: Vocabulary, path: str):
    """Write our complete level-block vocabulary in the DBoW2 BINARY
    format (saveToBinaryFile layout) so reference tooling can load it.
    Fully vectorized (one structured-record array + tofile) — a 1M-word
    tree writes in well under a second."""
    import struct
    k, L = voc.k, voc.levels
    # node ids are assigned level by level: depth-d block starts at
    # S(d) = sum_{i<d} k^i; parent of slot s at depth d is node
    # S(d-1) + s // k
    starts = np.cumsum([0] + [k ** d for d in range(L + 1)])
    n_rec = int(starts[L + 1]) - 1
    rec = np.zeros(n_rec, dtype=np.dtype(
        [("parent", "<i4"), ("desc", "u1", (32,)),
         ("weight", "<f4"), ("leaf", "u1")]))
    row = 0
    for d in range(1, L + 1):
        n = k ** d
        ids = np.arange(n)
        rec["parent"][row:row + n] = starts[d - 1] + ids // k
        rec["desc"][row:row + n] = np.ascontiguousarray(
            voc.centers[d - 1], dtype="<u4").view("u1").reshape(n, 32)
        if d == L:
            rec["leaf"][row:row + n] = 1
            rec["weight"][row:row + n] = np.asarray(voc.idf, np.float32)
        row += n
    with open(path, "wb") as f:
        f.write(struct.pack("<IIiiii", n_rec + 1, 41, k, L, 0, 0))
        rec.tofile(f)


def synthetic_orbvoc(k: int = 10, L: int = 6, seed: int = 0,
                     flip_bits=(0, 64, 40, 24, 14, 8, 5)) -> Vocabulary:
    """Generate a production-SCALE vocabulary tree (k=10, L=6 -> 1M
    words, the dimensions of the reference's ORBvoc, src/System.cc:64)
    with hierarchical Hamming structure: each node's children perturb
    the parent descriptor by a decreasing number of random bit flips,
    so nearby descriptors follow the same descent path and quantize to
    the same word — a usable (if untrained) place-recognition quantizer
    at the real node count, for in-system scale tests in a zero-egress
    environment where the genuine trained ORBvoc.bin cannot be
    downloaded."""
    rng = np.random.default_rng(seed)

    def flip_mask(n: int, bits: int) -> np.ndarray:
        m = np.zeros((n, 8), np.uint32)
        for _ in range(bits):
            r = rng.integers(0, 256, n)
            m[np.arange(n), r >> 5] |= np.uint32(1) << (r & 31).astype(
                np.uint32)
        return m

    centers = []
    parent = rng.integers(0, 2 ** 32, (1, 8), dtype=np.uint64
                          ).astype(np.uint32)
    for d in range(1, L + 1):
        n = k ** d
        cur = np.repeat(parent, k, axis=0)
        bits = flip_bits[min(d, len(flip_bits) - 1)]
        cur = np.bitwise_xor(cur, flip_mask(n, bits))
        centers.append(cur)
        parent = cur
    idf = rng.uniform(0.2, 1.0, k ** L).astype(np.float32)
    return Vocabulary(k=k, levels=L, centers=centers, idf=idf)


def _build_vocab(k, L, parent, desc8, weight, is_leaf, n_rec) -> Vocabulary:

    # depth per node (parents always precede children in the file)
    depth = np.zeros(n_rec + 1, np.int32)
    nids = np.arange(1, n_rec + 1)
    depth[nids] = -1
    for d in range(L + 1):
        mask = (depth[nids] == -1) & (depth[np.maximum(parent[nids], 0)] == d) \
            & (parent[nids] >= 0)
        depth[nids[mask]] = d + 1
    if (depth < 0).any():
        raise ValueError("orphan nodes in vocabulary file")

    # sibling rank: children of one parent in nid order
    order = np.lexsort((np.arange(n_rec + 1), parent))
    ranked = np.zeros(n_rec + 1, np.int64)
    p_sorted = parent[order]
    first = np.concatenate([[True], p_sorted[1:] != p_sorted[:-1]])
    grp_start = np.maximum.accumulate(np.where(first,
                                               np.arange(n_rec + 1), 0))
    ranked[order] = np.arange(n_rec + 1) - grp_start
    ranked[0] = 0

    # word ids in increasing nid order (loadFromBinaryFile assigns them
    # as leaves are encountered)
    word_id = np.full(n_rec + 1, -1, np.int64)
    leaf_ids = np.where(is_leaf)[0]
    word_id[leaf_ids] = np.arange(len(leaf_ids))

    # slot per node, per level fill
    slot = np.zeros(n_rec + 1, np.int64)
    centers = [np.zeros((k ** (l + 1), 8), np.uint32) for l in range(L)]
    filled = [np.zeros(k ** (l + 1), bool) for l in range(L)]
    owner = [np.full(k ** (l + 1), -1, np.int64) for l in range(L)]
    owner_w = [np.zeros(k ** (l + 1), np.float64) for l in range(L)]
    for d in range(1, L + 1):
        at = np.where(depth == d)[0]
        if len(at) == 0:
            continue
        s = slot[parent[at]] * k + ranked[at]
        if ranked[at].max() >= k:
            raise ValueError("node with more than k children")
        slot[at] = s
        centers[d - 1][s] = desc8[at]
        filled[d - 1][s] = True
        lf = is_leaf[at]
        owner[d - 1][s[lf]] = word_id[at[lf]]
        owner_w[d - 1][s[lf]] = weight[at[lf]]

    # top-down vacancy fill + early-leaf propagation
    for l in range(1, L):
        n_slots = k ** (l + 1)
        s = np.arange(n_slots)
        p = s // k
        vac = ~filled[l]
        parent_collapsed = owner[l - 1][p] >= 0
        # descendants of early leaves: inherit descriptor + word
        m = vac & parent_collapsed & (s % k == 0)
        centers[l][m] = centers[l - 1][p[m]]
        owner[l][m] = owner[l - 1][p[m]]
        owner_w[l][m] = owner_w[l - 1][p[m]]
        filled[l][m] = True
        # remaining vacancies: copy sibling 0 (unreachable under argmin)
        vac = ~filled[l]
        sib0 = p * k
        centers[l][vac] = centers[l][sib0[vac]]
        owner[l][vac] = owner[l][sib0[vac]]
        owner_w[l][vac] = owner_w[l][sib0[vac]]
    # level-0 vacancies (root with < k children)
    vac0 = ~filled[0]
    centers[0][vac0] = centers[0][0]

    idf = owner_w[L - 1].astype(np.float32)
    voc = Vocabulary(k=k, levels=L, centers=centers, idf=idf,
                     node_level=min(4, max(L - 2, 1)))
    # expose the true word ids for parity checks
    voc.word_of_slot = owner[L - 1]  # type: ignore[attr-defined]
    return voc
