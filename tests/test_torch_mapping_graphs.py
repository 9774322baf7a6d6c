"""The local mapper's device programs (``pipeline/local_mapping.py``),
which the port replays from CUDA graphs on the card, against the JAX
package's jitted functions on the CPU, where ``graphed`` calls the
function: the chunked triangulation (K3's plain version), both fuse
directions (K2's), the compacted match lists, the chunked structure BA
with its damping threaded, ``IndexSum`` with the longest segment given,
and the vocabulary descent.

Scenes are synthetic and made from numpy seeds: 640x480 views of an
aerial sweep (``synth.aerial_trajectory``) over points near the plane
z = 0, 256 feature rows a view (the points' projections with 0.3 px of
noise and a few flipped descriptor bits, the rest random), 4 pyramid
levels.  Matches sit far from every gate's boundary, so the searches
agree bit for bit; sums in another order are held to tolerances."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu.geom.camera import Intrinsics as JIntrinsics
from orb_slam2_tpu.models import mapstore as jms
from orb_slam2_tpu.models.frame import Frame as JFrame
from orb_slam2_tpu.models.vocabulary import _transform_device
from orb_slam2_tpu.ops.extractor import OrbParams as JOrbParams
from orb_slam2_tpu.optim import points_opt as jpo
from orb_slam2_tpu.pipeline import local_mapping as jlm
from orb_slam2_tpu.pipeline.config import SlamConfig as JSlamConfig
from orb_slam2_tpu_torch import interop
from orb_slam2_tpu_torch.geom.camera import Intrinsics
from orb_slam2_tpu_torch.ops.extractor import OrbParams
from orb_slam2_tpu_torch.optim import points_opt as tpo
from orb_slam2_tpu_torch.optim.segment import IndexSum
from orb_slam2_tpu_torch.pipeline import local_mapping as tlm
from orb_slam2_tpu_torch.pipeline.config import SlamConfig
from orb_slam2_tpu_torch.utils import synth

torch.set_num_threads(1)

CAM_KW = dict(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
FX, FY, CX, CY = 450.0, 450.0, 320.0, 240.0
K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
N_ROWS = 256
SF = (1.2 ** np.arange(4)).astype(np.float32)
SIG2 = SF * SF
BOUNDS = (0.0, 640.0, 0.0, 480.0)


def _rand_desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _flip_bits(rng, desc, n_bits=4):
    out = desc.copy()
    for i in range(len(out)):
        for b in rng.choice(256, n_bits, replace=False):
            out[i, b // 32] ^= np.uint32(1 << (b % 32))
    return out


def _scene(seed, n_views, n_pts=150, speed=1.0):
    """Views of ``n_pts`` points: per view the Tcw, the feature rows
    (xy, desc uint32, octave, valid) and which row sees each point
    (-1: not seen)."""
    rng = np.random.default_rng(seed)
    poses = np.stack(synth.aerial_trajectory(n_views, speed=speed))
    X = np.c_[rng.uniform(0.0, speed * (n_views - 1), n_pts),
              rng.uniform(-4.0, 4.0, n_pts),
              rng.normal(0.0, 0.3, n_pts)].astype(np.float32)
    base = _rand_desc(rng, n_pts)
    pt_oct = rng.integers(0, 3, n_pts)
    views = []
    for T in poses:
        pc = X @ T[:3, :3].T + T[:3, 3]
        uv = pc[:, :2] / pc[:, 2:] * FX + [CX, CY]
        vis = ((uv > 2) & (uv < [638, 478])).all(1)
        row = np.full(n_pts, -1)
        row[vis] = rng.permutation(N_ROWS)[:int(vis.sum())]
        xy = rng.uniform([0, 0], [640, 480], (N_ROWS, 2))
        desc = _rand_desc(rng, N_ROWS)
        octave = rng.integers(0, 4, N_ROWS)
        xy[row[vis]] = uv[vis] + rng.normal(0, 0.3, (int(vis.sum()), 2))
        desc[row[vis]] = _flip_bits(rng, base[vis])
        octave[row[vis]] = pt_oct[vis]
        views.append(dict(Tcw=T, xy=xy.astype(np.float32), desc=desc,
                          octave=octave.astype(np.int32),
                          valid=rng.random(N_ROWS) > 0.03, row=row))
    return X, base, views


def _center(T):
    return (-T[:3, :3].T @ T[:3, 3]).astype(np.float32)


def _tri_inputs(views, nb_ids, chunk, rng):
    """The triangulation inputs of view 0 against views ``nb_ids``, in
    stacks of ``chunk`` padded as the mapper pads them: (shared, [per
    chunk stacks])."""
    v1 = views[0]
    T1 = v1["Tcw"]
    o1 = _center(T1)
    valid1 = v1["valid"] & (rng.random(N_ROWS) > 0.1)
    shared = (v1["xy"], v1["desc"], valid1, v1["octave"], T1)
    stacks = []
    for c0 in range(0, len(nb_ids), chunk):
        sub = nb_ids[c0:c0 + chunk]
        pad = [sub[0]] * (chunk - len(sub))
        vs = [views[i] for i in sub + pad]
        F12 = np.tile(np.eye(3, dtype=np.float32), (chunk, 1, 1))
        epi = np.zeros((chunk, 2), np.float32)
        T2 = np.tile(np.eye(4, dtype=np.float32), (chunk, 1, 1))
        o2 = np.zeros((chunk, 3), np.float32)
        valid2 = np.zeros((chunk, N_ROWS), bool)
        for j, i in enumerate(sub):
            T = views[i]["Tcw"]
            F12[j] = tlm.compute_F12(T1.astype(np.float64),
                                     T.astype(np.float64), K)
            pc = T[:3, :3] @ o1 + T[:3, 3]
            epi[j] = [FX * pc[0] / pc[2] + CX, FY * pc[1] / pc[2] + CY]
            T2[j], o2[j] = T, _center(T)
            valid2[j] = views[i]["valid"] & (rng.random(N_ROWS) > 0.1)
        stacks.append((np.stack([v["xy"] for v in vs]),
                       np.stack([v["desc"] for v in vs]), valid2,
                       np.stack([v["octave"] for v in vs]), F12, epi, T2, o2,
                       np.arange(chunk) < len(sub)))
    return shared, stacks


def _tri_jax(shared, st):
    xy1, desc1, valid1, oct1, T1 = shared
    xy2, desc2, valid2, oct2, F12, epi, T2, o2, nbv = st
    zeros1 = np.zeros(N_ROWS, np.float32)
    out = jlm._triangulate_neighbors_fused(
        *map(jnp.asarray, (xy1, desc1, valid1, oct1, zeros1, T1, xy2, desc2,
                           np.packbits(valid2, axis=1), oct2,
                           np.zeros(oct2.shape, np.float32), F12, epi, T2,
                           o2, nbv, K, SIG2, SF)),
        FX, FY, CX, CY, 1.8)
    gb, nb, col, hb = (np.asarray(a) for a in out)
    return (np.unpackbits(gb)[:N_ROWS].astype(bool), nb.astype(np.int64),
            col.astype(np.int64), np.unpackbits(hb)[:N_ROWS].astype(bool))


def _tri_port(shared, st):
    t = torch.from_numpy
    xy1, desc1, valid1, oct1, T1 = shared
    xy2, desc2, valid2, oct2, F12, epi, T2, o2, nbv = st
    out = tlm._triangulate_neighbors_fused(
        t(xy1), t(desc1.view(np.int32)), t(valid1), t(oct1), t(T1),
        t(xy2), t(desc2.view(np.int32)), t(valid2), t(oct2), t(F12),
        t(epi), t(T2), t(o2), t(nbv), t(K), t(SIG2), t(SF),
        FX, FY, CX, CY, 1.8)
    return tuple(a.numpy() for a in out)


def _assert_tri_equal(port, ref):
    """good and has bit for bit, nb on every row, col where a neighbor
    matched (a row with no match has no column to agree on)."""
    good, nb, col, has = port
    np.testing.assert_array_equal(good, ref[0])
    np.testing.assert_array_equal(has, ref[3])
    np.testing.assert_array_equal(nb, ref[1])
    np.testing.assert_array_equal(col[has], ref[2][has])
    assert good.sum() > 30 and (nb[good] > 0).any()


def test_triangulation_chunk_with_padded_neighbors():
    """One chunk of TRI_CHUNK = 5 stacks with 3 neighbors and 2 padded
    (``nb_valid`` False) rows.  Bar: bit-exact."""
    _, _, views = _scene(0, 4)
    rng = np.random.default_rng(10)
    shared, stacks = _tri_inputs(views, [1, 2, 3], tlm.TRI_CHUNK, rng)
    assert len(stacks) == 1 and not stacks[0][-1][3:].any()
    _assert_tri_equal(_tri_port(shared, stacks[0]),
                      _tri_jax(shared, stacks[0]))


def test_triangulation_two_chunks_merged_by_host():
    """Seven neighbors in two chunks (5 + 2 and 3 padded), each run by
    the port and merged by ``_merge_chunks``, against the JAX package's
    function over all seven in one stack (first neighbor wins either
    way); 40 points are hidden from the first five neighbors, so the
    second chunk wins rows.  Bar: bit-exact."""
    _, _, views = _scene(1, 8)
    rng = np.random.default_rng(11)
    nb_ids = list(range(1, 8))
    shared, stacks = _tri_inputs(views, nb_ids, tlm.TRI_CHUNK, rng)
    rng = np.random.default_rng(11)
    _, (whole,) = _tri_inputs(views, nb_ids, len(nb_ids), rng)
    assert len(stacks) == 2
    for j, i in enumerate(nb_ids[:5]):
        r = views[i]["row"][:40]
        stacks[0][2][j, r[r >= 0]] = False
        whole[2][j, r[r >= 0]] = False
    good, nb, col = tlm._merge_chunks(
        [_tri_port(shared, st) for st in stacks], tlm.TRI_CHUNK)
    ref = _tri_jax(shared, whole)
    has = ref[3]
    _assert_tri_equal((good, nb, col, has), ref)
    assert (nb[has] >= tlm.TRI_CHUNK).any()     # the second chunk won rows


def _fuse_scene(seed, n_targets):
    """A device point store of 512 rows (the scene's points, some dead)
    and ``n_targets`` target views; the points' distance range and
    normal put each one at a predicted level well inside a bucket."""
    X, base, views = _scene(seed, n_targets + 1)
    rng = np.random.default_rng(seed + 100)
    n = len(X)
    cap = 512
    centers = np.stack([_center(v["Tcw"]) for v in views])
    d_ref = np.linalg.norm(X - centers.mean(0), axis=1)
    lvl = rng.integers(0, 3, n)
    max_d = (d_ref * 1.2 ** (lvl + 0.5)).astype(np.float32)
    normal = X - centers.mean(0)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    store = dict(
        pos=np.zeros((cap, 3), np.float32), desc=np.zeros((cap, 8), np.uint32),
        normal=np.zeros((cap, 3), np.float32),
        min_d=np.zeros(cap, np.float32), max_d=np.zeros(cap, np.float32),
        alive=np.zeros(cap, bool))
    store["pos"][:n], store["desc"][:n], store["normal"][:n] = X, base, normal
    store["max_d"][:n] = max_d
    store["min_d"][:n] = max_d / 1.2 ** 3
    store["alive"][:n] = rng.random(n) > 0.05
    # the feature at a point's projection sits at its predicted level
    for v in views:
        seen = v["row"] >= 0
        dist = np.linalg.norm(X - _center(v["Tcw"]), axis=1)
        pred = np.clip(np.ceil(np.log(max_d / dist) / np.log(1.2)), 0, 3)
        v["octave"][v["row"][seen]] = pred[seen].astype(np.int32)
    rows = np.full(256, -1, np.int32)
    rows[:n] = rng.permutation(n)
    rows[rng.random(256) < 0.1] = -1
    return store, views, rows


def _store_args(store, jax_side):
    cols = (store["pos"], store["desc"], store["normal"], store["min_d"],
            store["max_d"], store["alive"])
    if jax_side:
        return [jnp.asarray(c) for c in cols]
    return [torch.from_numpy(c.view(np.int32) if c.dtype == np.uint32
                             else c) for c in cols]


def test_fuse_forward_and_reverse():
    """``_fuse_stack_rows`` over a chunk of FUSE_CHUNK = 8 targets (5
    views and 3 padded copies with no valid keypoint, as the mapper
    pads) and ``_fuse_reverse_rows`` into one view, both with -1 rows
    in the row vector.  Bar: the int16 results equal."""
    store, views, rows = _fuse_scene(2, 5)
    tg = views[1:] + [views[1]] * 3
    Tcw_s = np.stack([v["Tcw"] for v in tg])
    kvalid = np.stack([v["valid"] for v in tg])
    kvalid[5:] = False
    kxy, koct = np.stack([v["xy"] for v in tg]), np.stack([v["octave"]
                                                           for v in tg])
    kdesc = np.stack([v["desc"] for v in tg])
    geo = (FX, FY, CX, CY, BOUNDS, 4, float(np.log(1.2)))
    ref = np.asarray(jlm._fuse_stack_rows(
        *_store_args(store, True), jnp.asarray(rows), jnp.asarray(Tcw_s),
        jnp.asarray(kxy), jnp.asarray(koct), jnp.asarray(kdesc),
        jnp.asarray(np.packbits(kvalid, axis=1)), jnp.asarray(SF), *geo,
        th=3.0, ratio=1.0))
    t = torch.from_numpy
    out = tlm._fuse_stack_rows(
        *_store_args(store, False), t(rows), t(Tcw_s), t(kxy), t(koct),
        t(kdesc.view(np.int32)), t(kvalid), t(SF), *geo, 3.0, 1.0).numpy()
    assert out.dtype == np.int16 and out.shape == (8, 256)
    np.testing.assert_array_equal(out, ref)
    assert (out[:5] >= 0).sum() > 200 and (out[5:] < 0).all()
    assert (out[:, rows < 0] < 0).all()
    v = views[0]
    ref = np.asarray(jlm._fuse_reverse_rows(
        *_store_args(store, True), jnp.asarray(rows),
        *map(jnp.asarray, (v["Tcw"], v["xy"], v["octave"], v["desc"],
                           v["valid"], SF)), *geo, th=3.0, ratio=1.0))
    out = tlm._fuse_reverse_rows(
        *_store_args(store, False), t(rows), t(v["Tcw"]), t(v["xy"]),
        t(v["octave"]), t(v["desc"].view(np.int32)), t(v["valid"]),
        t(SF), *geo, 3.0, 1.0).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out >= 0).sum() > 30


def _point_set(store, rows):
    """The columns (pos, normal, min_d, max_d, valid, desc) of the
    store's rows (-1 = empty slot), gathered on the host."""
    r = np.clip(rows, 0, None)
    return (store["pos"][r], store["normal"][r], store["min_d"][r],
            store["max_d"][r], (rows >= 0) & store["alive"][r],
            store["desc"][r])


def test_fuse_both_directions():
    """``_fuse_both_directions`` (one program: the forward fuse of this
    keyframe's points into 4 targets and the reverse fuse of other
    points into this keyframe, ungated) against the JAX package's jitted
    function.  Bar: indices, distances (Hamming, integer) and valid
    flags equal, both directions."""
    store, views, rows = _fuse_scene(3, 4)
    rng = np.random.default_rng(33)
    cand_rows = rng.permutation(rows)
    tg = views[1:]
    kvalid = np.stack([v["valid"] for v in tg])
    stack = [np.stack([v[k] for v in tg]) for k in ("Tcw", "xy", "octave")]
    kdesc = np.stack([v["desc"] for v in tg])
    v = views[0]
    own, cand = _point_set(store, rows), _point_set(store, cand_rows)
    geo = (FX, FY, CX, CY, BOUNDS, 4, float(np.log(1.2)))
    j = jnp.asarray
    jf, jr = jlm._fuse_both_directions(
        *map(j, own), *map(j, stack), j(kdesc), j(kvalid), *map(j, cand),
        *map(j, (v["Tcw"], v["xy"], v["octave"], v["desc"], v["valid"], SF)),
        *geo, th=3.0, ratio=1.0)

    def t(a):
        a = np.asarray(a)
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                else a)
    tf, tr = tlm._fuse_both_directions(
        *map(t, own), *map(t, stack), t(kdesc), t(kvalid), *map(t, cand),
        *map(t, (v["Tcw"], v["xy"], v["octave"], v["desc"], v["valid"], SF)),
        *geo, th=3.0, ratio=1.0)
    for ours, ref in zip((*tf, *tr), (*jf, *jr)):
        assert tuple(ours.shape) == tuple(np.shape(ref))
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert tf[2].shape == (4, 256) and int(tf[2].sum()) > 150
    assert int(tr[2].sum()) > 30


@pytest.mark.parametrize("cap", [2048, 16])
def test_compact_matches(cap):
    """The compacted list of a (8, 256) int16 match matrix with ~10% of
    its entries matched: positions, feature ids (the fill included) and
    the count, against the JAX package's ``_compact_matches``, below the
    cap and past it (the count is then the true count, over cap, and the
    list holds the first cap matches).  Bar: equal."""
    rng = np.random.default_rng(cap)
    sfeat = np.where(rng.random((8, 256)) < 0.1,
                     rng.integers(0, 4000, (8, 256)), -1).astype(np.int16)
    rows, feats, count = (np.asarray(a) for a in jlm._compact_matches(
        jnp.asarray(sfeat), cap))
    out = tlm._compact_matches(torch.from_numpy(sfeat), cap)
    assert out[0].dtype == torch.int32 and out[1].dtype == torch.int16
    np.testing.assert_array_equal(out[0].numpy(), rows)
    np.testing.assert_array_equal(out[1].numpy(), feats)
    assert int(out[2]) == int(count) == int((sfeat >= 0).sum())
    assert (int(count) > cap) == (cap == 16)


def _points_problem():
    """tests/test_torch_matching.py::test_optimize_points' problem."""
    rng = np.random.default_rng(4)
    P, per = 300, 4
    X = np.concatenate([rng.uniform(-5, 5, (P, 2)), np.zeros((P, 1))], 1)
    poses = np.stack(synth.aerial_trajectory(per, speed=2.0, height=8.0))
    obs_pt = np.repeat(np.arange(P), per).astype(np.int32)
    obs_cam = np.tile(np.arange(per), P).astype(np.int32)
    pc = np.einsum("oij,oj->oi", poses[obs_cam, :3, :3], X[obs_pt]) \
        + poses[obs_cam, :3, 3]
    uv = (pc[:, :2] / pc[:, 2:] * 450 + [320, 240]
          + rng.normal(0, 0.7, (len(obs_pt), 2))).astype(np.float32)
    uv[rng.random(len(uv)) < 0.05] += 40.0        # outliers
    isig = (1.0 / 1.44 ** rng.integers(0, 3, len(uv))).astype(np.float32)
    valid = rng.random(len(uv)) > 0.05
    X0 = (X + rng.normal(0, 0.1, X.shape)).astype(np.float32)
    return X, (X0, obs_pt, poses, uv, isig, valid), obs_cam


def _chunked(fn, to, args, obs_cam, chunks, use_huber):
    X0, obs_pt, poses, uv, isig, valid = args
    pts, lam = to(X0), to(np.full(len(X0), 1e-3, np.float32))
    for it in chunks:
        r = fn(pts, to(obs_pt), to(poses), to(uv), to(isig), to(valid),
               450.0, 450.0, 320.0, 240.0, iters=it, use_huber=use_huber,
               obs_cam=to(obs_cam), lam0=lam)
        pts, lam = r.points, r.lam
    return np.asarray(pts), np.asarray(r.obs_inlier), np.asarray(lam)


@pytest.mark.parametrize("use_huber", [True, False])
def test_optimize_points_chunked_with_lam0(use_huber):
    """Two chunks of 5 LM iterations with ``lam`` threaded through
    ``lam0``, against the JAX package's same chunked calls and against
    the port's one call of 10.  Bars (test_optimize_points'): points
    within 2e-3, >= 99.5% identical inlier verdicts.  The damping handed
    on is the one call's (the chunk boundary re-assembles the same
    system); against the JAX package it is no bar, as the accept test
    near convergence takes either branch on last-bit differences."""
    X, args, obs_cam = _points_problem()
    t = torch.from_numpy
    pts, inl, lam = _chunked(tpo.optimize_points, t, args, obs_cam, (5, 5),
                             use_huber)
    ref = _chunked(jpo.optimize_points, jnp.asarray, args, obs_cam, (5, 5),
                   use_huber)
    one = tpo.optimize_points(*map(t, args), 450.0, 450.0, 320.0, 240.0,
                              iters=10, use_huber=use_huber,
                              obs_cam=t(obs_cam))
    for p, v in ((ref[0], ref[1]), (one.points.numpy(),
                                    one.obs_inlier.numpy())):
        np.testing.assert_allclose(pts, p, rtol=0, atol=2e-3)
        assert (inl == v).mean() >= 0.995
    np.testing.assert_array_equal(lam, one.lam.numpy())
    if use_huber:       # it converged (without it the outliers pull)
        assert np.abs(pts - X).mean() < 0.05


@pytest.mark.parametrize("trail", [(), (3,), (3, 3)])
def test_index_sum_with_longest_given(trail):
    """``IndexSum`` told its longest segment sums as the one that reads
    it does, and as ``index_add_``: equal."""
    rng = np.random.default_rng(len(trail))
    idx = torch.as_tensor(rng.integers(0, 50, 2000))
    vals = torch.as_tensor(rng.standard_normal((2000,) + trail)
                           .astype(np.float32))
    longest = int(np.bincount(idx.numpy()).max())
    a = IndexSum(idx, 60, longest=longest)(vals)
    b = IndexSum(idx, 60)(vals)
    ref = vals.new_zeros((60,) + trail).index_add_(0, idx, vals)
    assert torch.equal(a, b) and torch.equal(a, ref)


def test_transform_device_matches_jax():
    """The vocabulary descent of 300 descriptors through a random k=4,
    L=4 tree (``Vocabulary.transform``) against the JAX package's
    ``_transform_device``.  Bar: word and node ids equal."""
    rng = np.random.default_rng(6)
    k, levels, node_level = 4, 4, 2
    centers = [_rand_desc(rng, k ** (lvl + 1)) for lvl in range(levels)]
    voc = interop.vocabulary_from_numpy(k, levels, centers,
                                        np.ones(k ** levels, np.float32),
                                        node_level)
    desc = _rand_desc(rng, 300)
    desc[:50] = centers[-1][rng.integers(0, k ** levels, 50)]
    w, n = voc.transform(torch.from_numpy(desc.view(np.int32)))
    jw, jn = _transform_device(tuple(jnp.asarray(c) for c in centers),
                               jnp.asarray(desc), k=k, node_level=node_level)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(w.numpy(), voc.transform_np(desc))


# ----------------------------------------------------------------------
# run_structure_ba on one map state in both packages
# ----------------------------------------------------------------------
def _map_state(seed=3, n_views=6):
    """A map of ``n_views`` keyframes observing the scene's points:
    measurements at the projections (0.3 px of noise, 5% of them 25 px
    off), point positions 0.05 off, as ``interop.mapstore_from_numpy``
    takes it."""
    X, base, views = _scene(seed, n_views)
    rng = np.random.default_rng(seed + 200)
    n = len(X)
    mp_obs = [dict() for _ in range(n)]
    keyframes = []
    for kid, v in enumerate(views):
        mp_ids = np.full(N_ROWS, -1, np.int32)
        seen = np.where(v["row"] >= 0)[0]
        mp_ids[v["row"][seen]] = seen
        xy = v["xy"].copy()
        bad = v["row"][seen[rng.random(len(seen)) < 0.05]]
        xy[bad] += 25.0
        for p in seen:
            mp_obs[p][kid] = int(v["row"][p])
        keyframes.append(dict(
            kid=kid, Tcw=v["Tcw"], parent=kid - 1, children=set(),
            loop_edges=set(), valid=True, first_connection=kid == 0,
            frame=dict(frame_id=kid, timestamp=0.1 * kid, Tcw=v["Tcw"],
                       mp_ids=mp_ids, mp_outlier=np.zeros(N_ROWS, bool),
                       xy=xy, xy_raw=xy, response=np.ones(N_ROWS, np.float32),
                       angle=np.zeros(N_ROWS, np.float32),
                       octave=v["octave"], desc=v["desc"], valid=v["valid"])))
    slots = 16
    kid_m = np.full((n, slots), -1, np.int32)
    fi_m = np.zeros((n, slots), np.int32)
    for p, o in enumerate(mp_obs):
        kid_m[p, :len(o)] = list(o)
        fi_m[p, :len(o)] = list(o.values())
    covis = [dict() for _ in views]
    for o in mp_obs:
        for a in o:
            for b in o:
                if a != b:
                    covis[a][b] = covis[a].get(b, 0) + 1
    dist = np.linalg.norm(X - _center(views[0]["Tcw"]), axis=1)
    points = dict(
        mp_pos=(X + rng.normal(0, 0.05, X.shape)).astype(np.float32),
        mp_desc=base, mp_normal=np.tile([0, 0, 1.0], (n, 1)),
        mp_min_dist=dist / 2, mp_max_dist=dist * 2,
        mp_valid=np.array([len(o) >= 3 for o in mp_obs]),
        mp_first_kf=np.zeros(n), mp_n_visible=np.ones(n),
        mp_n_found=np.ones(n), mp_replaced_by=np.full(n, -1),
        mp_first_frame=np.zeros(n))
    return dict(points=points, mp_obs=mp_obs, keyframes=keyframes,
                covis=covis, scale_factor=1.2, n_levels=4,
                obs_mirror=(kid_m, fi_m, np.array([len(o) for o in mp_obs])))


def _jax_store(state):
    """The JAX package's MapStore in ``state`` (interop's builder, with
    the JAX classes)."""
    store = jms.MapStore()
    store.set_scale_info(state["scale_factor"], state["n_levels"])
    for name, dtype, fill in interop._POINT_COLUMNS:
        setattr(store, name, jms._GrowArray.from_data(
            np.asarray(state["points"][name], dtype), fill=fill))
    n_pts = len(store.mp_pos)
    store.mp_obs = [dict(o) for o in state["mp_obs"]]
    store.obs.add_rows(n_pts)
    store.obs.kid, store.obs.fi, store.obs.n = (
        np.array(a, np.int32) for a in state["obs_mirror"])
    for k in state["keyframes"]:
        f = k["frame"]
        frame = JFrame(f["frame_id"], f["timestamp"],
                       np.array(f["Tcw"], np.float32),
                       np.array(f["mp_ids"], np.int32),
                       np.array(f["mp_outlier"], bool),
                       **{name: np.array(f[name]) for name in
                          ("xy", "xy_raw", "response", "angle", "octave",
                           "desc", "valid")})
        store.kfs.append(jms.KeyFrame(
            kid=k["kid"], frame=frame, Tcw=np.array(k["Tcw"], np.float32),
            parent=k["parent"], children=set(k["children"]),
            loop_edges=set(k["loop_edges"]),
            first_connection=k["first_connection"], valid=k["valid"]))
    store.covis = [dict(c) for c in state["covis"]]
    store.max_kf_id = len(store.kfs) - 1
    store.dirty_points = set(range(n_pts))
    return store


def _observations(store):
    return {(p, k) for p, o in enumerate(store.mp_obs)
            if store.mp_valid[p] for k in o}


def test_run_structure_ba_matches_jax():
    """``run_structure_ba`` over six keyframes of one map state, built
    by ``interop.mapstore_from_numpy`` for the port and by the same
    steps for the JAX package, 10 iterations (two chunks of 5 in both).
    Bars (test_optimize_points'): points valid in both within 2e-3, and
    >= 99.5% identical inlier verdicts, read as the observations each
    kept; the outliers were erased and the points moved."""
    state = _map_state()
    cfg_kw = dict(fps=10.0, pose_prior=True)
    pcfg = SlamConfig(cam=Intrinsics(**CAM_KW),
                      orb=OrbParams(n_features=256, n_levels=4), **cfg_kw)
    jcfg = JSlamConfig(cam=JIntrinsics(**CAM_KW),
                       orb=JOrbParams(n_features=256, n_levels=4), **cfg_kw)
    port = interop.mapstore_from_numpy(**state, device="cpu")
    ref = _jax_store(state)
    before = _observations(port)
    assert before == _observations(ref)
    kfs = list(range(len(state["keyframes"])))
    tlm.run_structure_ba(port, kfs, pcfg, iters=10)
    jlm.run_structure_ba(ref, kfs, jcfg, iters=10)
    kept_p, kept_j = _observations(port), _observations(ref)
    verdict = [((o in kept_p) == (o in kept_j)) for o in before]
    assert np.mean(verdict) >= 0.995
    assert 0 < len(before - kept_p) < 0.2 * len(before)
    both = np.asarray(port.mp_valid) & np.asarray(ref.mp_valid)
    got = np.asarray(port.mp_pos)[both]
    np.testing.assert_allclose(got, np.asarray(ref.mp_pos)[both], rtol=0,
                               atol=2e-3)
    moved = np.abs(got - state["points"]["mp_pos"][both]).max(1)
    assert (moved > 1e-3).mean() > 0.5
