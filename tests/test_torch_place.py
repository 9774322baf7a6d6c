"""Place recognition in the port against the JAX package: the
vocabulary (training, device descent, BoW vectors, L1 score), the
keyframe database's candidate lists, the BoW-node branch of
search_descriptors and the two Sim3 searches of loop closing.

The features are extracted once by the JAX package and handed to both
packages, as in tests/test_torch_matching.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.geom import sim3 as jsim3
from orb_slam2_tpu.matching import search as jsearch
from orb_slam2_tpu.models import keyframe_db as jkfdb, vocabulary as jvoc
from orb_slam2_tpu.ops import extractor as jex
from orb_slam2_tpu_torch import interop
from orb_slam2_tpu_torch.geom import camera as tcam, sim3 as tsim3
from orb_slam2_tpu_torch.matching import search as tsearch
from orb_slam2_tpu_torch.models import keyframe_db as tkfdb, vocabulary as tvoc
from orb_slam2_tpu_torch.utils import synth

torch.set_num_threads(1)

CAM = tcam.Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                      width=640, height=480)
SF = (1.2 ** np.arange(4)).astype(np.float32)
BOUNDS = (0.0, 640.0, 0.0, 480.0)
GEO = dict(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bounds=BOUNDS,
           n_levels=4, log_scale=float(np.log(1.2)))


@pytest.fixture(scope="module")
def feats():
    """JAX-extracted features of three views of the aerial sweep, as
    numpy dicts (desc uint32), with each feature's point on the plane."""
    world = synth.make_world(seed=3)
    poses = synth.aerial_trajectory(5, speed=0.3)
    ext = jex.make_extractor(480, 640, jex.OrbParams(n_features=800,
                                                     n_levels=4))
    K = np.asarray(CAM.K, np.float64)
    out = []
    for T in (poses[0], poses[2], poses[4]):
        img = synth.render(world, CAM, T).numpy().astype(np.float32)
        f = ext(jnp.asarray(img))
        d = {k: np.asarray(getattr(f, k)) for k in f._fields}
        # back-project every keypoint onto the plane z = 0
        R, t = T[:3, :3].astype(np.float64), T[:3, 3].astype(np.float64)
        c = -R.T @ t
        rays = np.linalg.inv(K) @ np.c_[d["xy"], np.ones(len(d["xy"]))].T
        dw = (R.T @ rays).T
        X = c + (-c[2] / dw[:, 2])[:, None] * dw
        d.update(Tcw=T, X=X.astype(np.float32))
        out.append(d)
    return out


@pytest.fixture(scope="module")
def vocabs(feats):
    """The JAX vocabulary trained on the three views, and the port's
    trained on the same descriptors."""
    desc = np.concatenate([f["desc"][f["valid"]] for f in feats])
    kw = dict(k=6, levels=3, kmeans_iters=3, seed=0, max_train=2000)
    return jvoc.Vocabulary.train(desc, **kw), tvoc.Vocabulary.train(desc, **kw)


def _tdesc(a):
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


# ----------------------------------------------------------------------
# vocabulary
# ----------------------------------------------------------------------
def test_train_exact(vocabs):
    """Bar: identical centers and idf (the host training is the same
    numpy code with default_rng(0) on the same descriptors; the
    subsample of max_train exercises the rng)."""
    jv, tv = vocabs
    assert len(jv.centers) == len(tv.centers) == 3
    for a, b in zip(jv.centers, tv.centers):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jv.idf, tv.idf)


def test_device_transform_exact(vocabs, feats):
    """Bar: word and node ids identical to the JAX device descent
    (integer popcounts, lowest-index argmin)."""
    jv, tv = vocabs
    for f in feats:
        jw, jn = (np.asarray(a) for a in jv.transform(jnp.asarray(f["desc"])))
        tw, tn = tv.transform(_tdesc(f["desc"]))
        np.testing.assert_array_equal(tw.numpy(), jw)
        np.testing.assert_array_equal(tn.numpy(), jn)
        np.testing.assert_array_equal(tw.numpy(), tv.transform_np(f["desc"]))


def test_vocabulary_from_numpy_round_trip(vocabs):
    jv, _ = vocabs
    tv = interop.vocabulary_from_numpy(jv.k, jv.levels, jv.centers, jv.idf,
                                       jv.node_level)
    for a, b in zip(jv.centers, tv.centers):
        np.testing.assert_array_equal(a, b)
    assert tv.node_level == jv.node_level


def test_bow_vector_and_score(vocabs, feats):
    """Bar: BoW weights and L1 scores within 1e-6."""
    jv, tv = vocabs
    vj = [jv.bow_vector(f["desc"], f["valid"]) for f in feats]
    vt = [tv.bow_vector(f["desc"], f["valid"]) for f in feats]
    for a, b in zip(vj, vt):
        assert a.keys() == b.keys()
        assert max(abs(a[k] - b[k]) for k in a) <= 1e-6
    for i in range(3):
        for j in range(3):
            assert abs(jv.score_l1(vj[i], vj[j])
                       - tv.score_l1(vt[i], vt[j])) <= 1e-6
    assert abs(tv.score_l1(vt[0], vt[0]) - 1.0) <= 1e-6
    assert 0 < tv.score_l1(vt[0], vt[1]) < 1


# ----------------------------------------------------------------------
# keyframe database
# ----------------------------------------------------------------------
class _Covis:
    """The two members of a map store the database reads."""

    def __init__(self, covis):
        self.covis = covis

    def get_best_covisibles(self, kid, n):
        return sorted(self.covis[kid], key=lambda k: (-self.covis[kid][k],
                                                      k))[:n]


def test_keyframe_database_candidates(vocabs, feats):
    """Twelve keyframes whose descriptors are subsets of the three
    views, a chain covisibility graph.  Bar: identical loop and
    relocalization candidate lists from both databases (the native
    inverted file of each package, the same accumulation)."""
    jv, tv = vocabs
    rng = np.random.default_rng(5)
    jdb, tdb = jkfdb.KeyFrameDatabase(jv), tkfdb.KeyFrameDatabase(tv)
    n_kf = 12
    for kid in range(n_kf):
        f = feats[kid % 3]
        sel = f["valid"] & (rng.random(len(f["valid"])) < 0.7)
        jdb.add(kid, jv.bow_vector(f["desc"], sel))
        tdb.add(kid, tv.bow_vector(f["desc"], sel))
    covis = [{k: 40 - 3 * abs(k - kid) for k in range(max(0, kid - 2),
                                                      min(n_kf, kid + 3))
              if k != kid} for kid in range(n_kf)]
    store = _Covis(covis)
    n_found = 0
    for kid in range(n_kf):
        jl = jdb.detect_loop_candidates(store, kid, 0.01)
        tl = tdb.detect_loop_candidates(store, kid, 0.01)
        assert jl == tl
        n_found += len(tl)
    assert n_found > 0
    for f in feats:
        q = tv.bow_vector(f["desc"], f["valid"])
        assert tdb.detect_relocalization_candidates(store, q) == \
            jdb.detect_relocalization_candidates(
                store, jv.bow_vector(f["desc"], f["valid"]))
    tdb.erase(3)
    jdb.erase(3)
    assert tdb.detect_loop_candidates(store, 0, 0.01) == \
        jdb.detect_loop_candidates(store, 0, 0.01)


# ----------------------------------------------------------------------
# searches
# ----------------------------------------------------------------------
def _feat_tensors(f):
    return interop.features_from_numpy(**{k: f[k] for k in jex.Features._fields})


def test_search_descriptors_with_nodes_exact(vocabs, feats):
    """Node-blocked SearchByBoW.  Bar: idx, dist and valid identical."""
    jv, tv = vocabs
    f1, f2 = feats[0], feats[1]
    n1 = np.where(f1["valid"], np.asarray(jv.transform(jnp.asarray(f1["desc"]))[1]), -1)
    n2 = np.where(f2["valid"], np.asarray(jv.transform(jnp.asarray(f2["desc"]))[1]), -1)
    ref = jsearch.search_descriptors(
        jnp.asarray(f1["desc"]), jnp.asarray(f1["valid"]),
        jnp.asarray(f1["angle"]), jnp.asarray(n1),
        jnp.asarray(f2["desc"]), jnp.asarray(f2["valid"]),
        jnp.asarray(f2["angle"]), jnp.asarray(n2), ratio=0.75)
    t1, t2 = _feat_tensors(f1), _feat_tensors(f2)
    out = tsearch.search_descriptors(
        t1.desc, t1.valid, t1.angle, torch.from_numpy(n1),
        t2.desc, t2.valid, t2.angle, torch.from_numpy(n2), ratio=0.75)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert out.valid.sum() > 20
    free = tsearch.search_descriptors(t1.desc, t1.valid, t1.angle, None,
                                      t2.desc, t2.valid, t2.angle, None,
                                      ratio=0.75)
    assert not torch.equal(free.valid, out.valid)


def _assert_mostly_equal(ref, out):
    """Bar: >= 99.5% of (idx, valid) identical and distances exact where
    both are valid.  A window edge can flip on the last bit of a
    projection (3x3 products summed in another order)."""
    rv, ov = np.asarray(ref.valid), out.valid.numpy()
    ri, oi = np.asarray(ref.idx), out.idx.numpy()
    same = (rv == ov) & (~rv | (ri == oi))
    assert same.mean() >= 0.995, same.mean()
    both = rv & ov & (ri == oi)
    np.testing.assert_array_equal(out.dist.numpy()[both],
                                  np.asarray(ref.dist)[both])
    assert rv.sum() > 50


def _cam_rows(f):
    T = f["Tcw"]
    pc = f["X"] @ T[:3, :3].T + T[:3, 3]
    dist = np.linalg.norm(pc, axis=1)
    return pc.astype(np.float32), (dist * SF[f["octave"]]).astype(np.float32)


def test_search_by_sim3(feats):
    """Bidirectional SearchBySim3 between views 0 and 1 with their true
    relative pose as S12 (scale 1) and 10% of each side's points
    masked."""
    f1, f2 = feats[0], feats[1]
    rng = np.random.default_rng(7)
    pc1, md1 = _cam_rows(f1)
    pc2, md2 = _cam_rows(f2)
    mv1 = f1["valid"] & (rng.random(len(pc1)) > 0.1)
    mv2 = f2["valid"] & (rng.random(len(pc2)) > 0.1)
    T12 = (f1["Tcw"] @ np.linalg.inv(f2["Tcw"])).astype(np.float32)
    S12j = jsim3.from_se3(jnp.asarray(T12))
    ref = jsearch.search_by_sim3(
        jnp.asarray(pc1), jnp.asarray(f1["desc"]), jnp.asarray(mv1),
        jnp.asarray(md1), jnp.asarray(f1["xy"]), jnp.asarray(f1["octave"]),
        jnp.asarray(f1["valid"]),
        jnp.asarray(pc2), jnp.asarray(f2["desc"]), jnp.asarray(mv2),
        jnp.asarray(md2), jnp.asarray(f2["xy"]), jnp.asarray(f2["octave"]),
        jnp.asarray(f2["valid"]),
        S12j, jnp.asarray(SF), th=7.5, **GEO)
    t1, t2 = _feat_tensors(f1), _feat_tensors(f2)
    out = tsearch.search_by_sim3(
        torch.from_numpy(pc1), t1.desc, torch.from_numpy(mv1),
        torch.from_numpy(md1), t1.xy, t1.octave, t1.valid,
        torch.from_numpy(pc2), t2.desc, torch.from_numpy(mv2),
        torch.from_numpy(md2), t2.xy, t2.octave, t2.valid,
        tsim3.from_se3(torch.from_numpy(T12)), torch.from_numpy(SF),
        th=7.5, **GEO)
    _assert_mostly_equal(ref, out)


def test_search_by_projection_sim3(feats):
    """View-0 features as map points (plane points, normals toward the
    camera) projected into view 2 through its pose as a Sim3, 10% of
    view 2's keypoints already matched."""
    f0, f2 = feats[0], feats[2]
    rng = np.random.default_rng(8)
    T0 = f0["Tcw"]
    c0 = -T0[:3, :3].T @ T0[:3, 3]
    po = f0["X"] - c0
    dist = np.linalg.norm(po, axis=1)
    normal = (po / dist[:, None]).astype(np.float32)
    max_d = (dist * SF[f0["octave"]]).astype(np.float32)
    mval = f0["valid"] & (rng.random(len(dist)) > 0.1)
    has = rng.random(len(f2["valid"])) < 0.1
    Scw = (f2["Tcw"]).astype(np.float32)
    ref = jsearch.search_by_projection_sim3(
        jnp.asarray(f0["X"]), jnp.asarray(f0["desc"]), jnp.asarray(normal),
        jnp.asarray(max_d), jnp.asarray(mval),
        jsim3.from_se3(jnp.asarray(Scw)),
        jnp.asarray(f2["xy"]), jnp.asarray(f2["octave"]),
        jnp.asarray(f2["desc"]), jnp.asarray(f2["valid"]), jnp.asarray(has),
        jnp.asarray(SF), th=10.0, **GEO)
    t0, t2 = _feat_tensors(f0), _feat_tensors(f2)
    out = tsearch.search_by_projection_sim3(
        torch.from_numpy(f0["X"]), t0.desc, torch.from_numpy(normal),
        torch.from_numpy(max_d), torch.from_numpy(mval),
        tsim3.from_se3(torch.from_numpy(Scw)),
        t2.xy, t2.octave, t2.desc, t2.valid, torch.from_numpy(has),
        torch.from_numpy(SF), th=10.0, **GEO)
    _assert_mostly_equal(ref, out)
