"""The last public names of the JAX package held to their port
counterparts on seeded numpy inputs: se3 (compose, inv, log,
normalize_rotation, transform, transform_points), camera (project,
unproject), core.hamming_popcount, extractor.make_extractor,
orientation.gather_patches, PlaceRecognition.frame_bow,
LoopCloser.reset, KeyFrameDatabase.clear, native.covis_count, and the
dense (BoW-node / rotation-checked) branch of search_for_triangulation
with epipolar_distance_sq.  Last, every module of orb_slam2_tpu has its
counterpart in orb_slam2_tpu_torch with every public name (the Pallas
kernels' module apart: its functions live in matching/hamming_top2.py).
"""
import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu.geom import camera as jcam, se3 as jse3
from orb_slam2_tpu.matching import core as jcore, search as jsearch
from orb_slam2_tpu.models import keyframe_db as jkfdb, vocabulary as jvoc
from orb_slam2_tpu.native import covis_count as jcovis_count
from orb_slam2_tpu.ops import extractor as jex, orientation as jori
from orb_slam2_tpu_torch import native as tnative
from orb_slam2_tpu_torch.geom import camera as tcam, se3 as tse3
from orb_slam2_tpu_torch.matching import core as tcore, search as tsearch
from orb_slam2_tpu_torch.models import keyframe_db as tkfdb, vocabulary as tvoc
from orb_slam2_tpu_torch.ops import extractor as tex, orientation as tori
from orb_slam2_tpu_torch.pipeline.config import SlamConfig
from orb_slam2_tpu_torch.pipeline.loop_closing import LoopCloser
from orb_slam2_tpu_torch.pipeline.place_recognition import PlaceRecognition
from orb_slam2_tpu_torch.models.mapstore import MapStore

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _poses(rng, n):
    xi = rng.normal(0, 0.5, (n, 6)).astype(np.float32)
    return np.asarray(jse3.exp(jnp.asarray(xi)))


def test_se3_names():
    """Bar 1e-5 (float32, the same formulas)."""
    rng = np.random.default_rng(0)
    A, B = _poses(rng, 16), _poses(rng, 16)
    pts = rng.normal(0, 3, (16, 5, 3)).astype(np.float32)
    tA, tB = torch.from_numpy(A.copy()), torch.from_numpy(B.copy())
    for t, j in ((tse3.compose(tA, tB), jse3.compose(A, B)),
                 (tse3.inv(tA), jse3.inv(jnp.asarray(A))),
                 (tse3.log(tA), jse3.log(jnp.asarray(A))),
                 (tse3.transform(tA, torch.from_numpy(pts[:, 0])),
                  jse3.transform(jnp.asarray(A), jnp.asarray(pts[:, 0]))),
                 (tse3.transform_points(tA, torch.from_numpy(pts)),
                  jse3.transform_points(jnp.asarray(A), jnp.asarray(pts)))):
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=1e-5)
    near = A[:, :3, :3] + rng.normal(0, 1e-3, (16, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tse3.normalize_rotation(torch.from_numpy(near))),
        np.asarray(jse3.normalize_rotation(jnp.asarray(near))), atol=1e-5)


def test_camera_project_unproject():
    rng = np.random.default_rng(1)
    kw = dict(fx=450.0, fy=440.0, cx=320.0, cy=240.0, width=640,
              height=480)
    pc = rng.uniform([-3, -3, 1], [3, 3, 9], (50, 3)).astype(np.float32)
    uv = rng.uniform(0, 600, (50, 2)).astype(np.float32)
    d = rng.uniform(1, 9, 50).astype(np.float32)
    np.testing.assert_allclose(
        _np(tcam.project(tcam.Intrinsics(**kw), torch.from_numpy(pc))),
        np.asarray(jcam.project(jcam.Intrinsics(**kw), jnp.asarray(pc))),
        atol=1e-4)
    np.testing.assert_allclose(
        _np(tcam.unproject(tcam.Intrinsics(**kw), torch.from_numpy(uv),
                           torch.from_numpy(d))),
        np.asarray(jcam.unproject(jcam.Intrinsics(**kw), jnp.asarray(uv),
                                  jnp.asarray(d))), atol=1e-5)


def _desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)


def test_hamming_popcount_exact():
    rng = np.random.default_rng(2)
    a, b = _desc(rng, 40), _desc(rng, 30)
    t = tcore.hamming_popcount(torch.from_numpy(a.view(np.int32)),
                               torch.from_numpy(b.view(np.int32)))
    j = jcore.hamming_popcount(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(_np(t), np.asarray(j))
    np.testing.assert_array_equal(
        _np(t), _np(tcore.hamming_matrix(torch.from_numpy(a.view(np.int32)),
                                         torch.from_numpy(b.view(np.int32)))))


def test_make_extractor_is_extract():
    params = tex.OrbParams(n_features=300, n_levels=3)
    run = tex.make_extractor(120, 160, params)
    assert tex.make_extractor(120, 160, params) is run      # cached
    img = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 255, (120, 160)).astype(np.float32))
    for a, b in zip(run(img), tex.extract(img, params)):
        assert torch.equal(a, b)
    jrun = jex.make_extractor(120, 160, jex.OrbParams(n_features=300,
                                                      n_levels=3))
    assert len(jrun(jnp.asarray(img.numpy())).xy) == len(run(img).xy)


def test_gather_patches_exact():
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, (40, 50)).astype(np.float32)
    ys = rng.integers(-3, 43, 20).astype(np.int32)
    xs = rng.integers(-3, 53, 20).astype(np.int32)
    dy, dx, _ = jori._patch_offsets(4)
    t = tori.gather_patches(torch.from_numpy(img), torch.from_numpy(ys),
                            torch.from_numpy(xs), torch.from_numpy(dy),
                            torch.from_numpy(dx))
    j = jori.gather_patches(jnp.asarray(img), jnp.asarray(ys),
                            jnp.asarray(xs), jnp.asarray(dy), jnp.asarray(dx))
    np.testing.assert_array_equal(_np(t), np.asarray(j))


@pytest.fixture(scope="module")
def vocabs():
    desc = _desc(np.random.default_rng(5), 600)
    kw = dict(k=5, levels=2, kmeans_iters=2, seed=0, max_train=600)
    return desc, jvoc.Vocabulary.train(desc, **kw), \
        tvoc.Vocabulary.train(desc, **kw)


def test_frame_bow_and_database_clear(vocabs):
    from orb_slam2_tpu.pipeline.place_recognition import (
        PlaceRecognition as JPlaceRecognition)
    desc, jv, tv = vocabs
    valid = np.random.default_rng(6).random(len(desc)) < 0.8
    jpr = JPlaceRecognition(None, vocab=jv)
    tpr = PlaceRecognition(None, vocab=tv)
    assert tpr.frame_bow(desc, valid) == jpr.frame_bow(desc, valid)
    assert PlaceRecognition(None).frame_bow(desc, valid) is None
    jdb, tdb = jkfdb.KeyFrameDatabase(jv), tkfdb.KeyFrameDatabase(tv)
    for db in (jdb, tdb):
        db.add(3, jv.bow_vector(desc[:50], valid[:50]))
        db.clear()
        assert db.bow == {}
        db.add(4, jv.bow_vector(desc[50:90], valid[50:90]))
        assert list(db.bow) == [4]


def test_loop_closer_reset():
    from orb_slam2_tpu_torch.geom.camera import Intrinsics
    from orb_slam2_tpu_torch.ops.extractor import OrbParams
    cfg = SlamConfig(cam=Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                                    width=640, height=480),
                     orb=OrbParams(n_features=300, n_levels=3))
    store = MapStore(device="cpu")
    lc = LoopCloser(cfg, store)
    old = lc.pr
    lc.last_loop_kf_id, lc.consistent_groups = 7, [({1, 2}, 1)]
    lc.reset()
    assert lc.last_loop_kf_id == 0 and lc.consistent_groups == []
    assert lc.pr is not old and lc.pr.store is store
    assert lc.pr.vocab is old.vocab


@pytest.mark.parametrize("threshold", [1, 15, 40])
def test_covis_count_matches_jax(threshold):
    rng = np.random.default_rng(7)
    n_pts = 300
    per = rng.integers(1, 6, n_pts)
    offsets = np.concatenate([[0], np.cumsum(per)]).astype(np.int64)
    kids = rng.integers(0, 12, offsets[-1]).astype(np.int32)
    a = tnative.covis_count(kids, offsets, 3, threshold=threshold)
    b = jcovis_count(kids, offsets, 3, threshold=threshold)
    order_a, order_b = np.argsort(a[0]), np.argsort(b[0])
    np.testing.assert_array_equal(a[0][order_a], b[0][order_b])
    np.testing.assert_array_equal(a[1][order_a], b[1][order_b])
    assert len(a[0]) > 0


def _triangulation_problem(seed):
    """Two views of 3D points with noisy descriptors: F12 from their
    relative pose (the rows' lines in image 2 are x1^T F12)."""
    rng = np.random.default_rng(seed)
    n = 300
    K = np.array([[450, 0, 320], [0, 450, 240], [0, 0, 1]], np.float64)
    X = rng.uniform([-4, -3, 6], [4, 3, 12], (n, 3))
    R = np.asarray(jse3.so3_exp(jnp.asarray([0.02, -0.05, 0.03],
                                            jnp.float32)), np.float64)
    t = np.array([0.8, 0.05, 0.1])
    x1 = (X @ K.T)[:, :2] / X[:, 2:]
    X2 = X @ R.T + t
    x2 = (X2 @ K.T)[:, :2] / X2[:, 2:]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    F = np.linalg.inv(K).T @ tx @ R @ np.linalg.inv(K)
    e2 = K @ t
    perm = rng.permutation(n)
    d1 = _desc(rng, n)
    flips = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
        np.uint32) & np.uint32(0x01010101)
    d2 = (d1 ^ flips)[perm]
    f32 = lambda a: np.asarray(a, np.float32)       # noqa: E731
    oct1 = rng.integers(0, 4, n).astype(np.int32)
    oct2 = oct1[perm]
    ang1 = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    ang2 = ((ang1 + 0.3 + rng.normal(0, 0.05, n)) % (2 * np.pi))[perm]
    node1 = rng.integers(0, 6, n).astype(np.int32)
    node2 = np.where(rng.random(n) < 0.8, node1,
                     rng.integers(0, 6, n))[perm].astype(np.int32)
    sf = (1.2 ** np.arange(4)).astype(np.float32)
    return dict(
        xy1=f32(x1 + rng.normal(0, 0.5, x1.shape)), desc1=d1,
        valid1=rng.random(n) < 0.9, octave1=oct1, angle1=ang1, node1=node1,
        xy2=f32(x2[perm]), desc2=d2, valid2=rng.random(n) < 0.9,
        octave2=oct2, angle2=f32(ang2), node2=node2, F12=f32(F.T),
        epipole2_uv=f32(e2[:2] / e2[2]), sigma2_levels=sf * sf,
        scale_factors=sf)


def test_epipolar_distance_sq():
    p = _triangulation_problem(8)
    t = tsearch.epipolar_distance_sq(torch.from_numpy(p["xy1"]),
                                     torch.from_numpy(p["xy2"]),
                                     torch.from_numpy(p["F12"]))
    j = jsearch.epipolar_distance_sq(jnp.asarray(p["xy1"]),
                                     jnp.asarray(p["xy2"]),
                                     jnp.asarray(p["F12"]))
    np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("nodes,check_rotation",
                         [(True, False), (False, True), (True, True)])
def test_search_for_triangulation_dense_branch(nodes, check_rotation):
    """Bar: the same matches (index, distance, validity) on every row."""
    p = _triangulation_problem(9)

    def t(k):
        a = p[k]
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(np.array(a))
    ours = tsearch.search_for_triangulation(
        t("xy1"), t("desc1"), t("valid1"), t("octave1"),
        t("xy2"), t("desc2"), t("valid2"), t("octave2"),
        t("F12"), t("epipole2_uv"), t("sigma2_levels"), t("scale_factors"),
        angle1=t("angle1"), angle2=t("angle2"),
        node1=t("node1") if nodes else None,
        node2=t("node2") if nodes else None,
        check_rotation=check_rotation)
    j = {k: jnp.asarray(v) for k, v in p.items()}
    ref = jsearch.search_for_triangulation(
        j["xy1"], j["desc1"], j["valid1"], j["octave1"], j["angle1"],
        j["node1"] if nodes else None,
        j["xy2"], j["desc2"], j["valid2"], j["octave2"], j["angle2"],
        j["node2"] if nodes else None,
        j["F12"], j["epipole2_uv"], j["sigma2_levels"], j["scale_factors"],
        check_rotation=check_rotation)
    valid = _np(ours.valid)
    np.testing.assert_array_equal(valid, np.asarray(ref.valid))
    assert valid.sum() > 20
    np.testing.assert_array_equal(_np(ours.idx), np.asarray(ref.idx))
    np.testing.assert_array_equal(_np(ours.dist), np.asarray(ref.dist))


def _public_names(path):
    tree = ast.parse(open(path).read())
    out = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)) \
                and not n.name.startswith("_"):
            out.add(n.name)
            if isinstance(n, ast.ClassDef):
                out |= {f"{n.name}.{m.name}" for m in n.body
                        if isinstance(m, ast.FunctionDef)
                        and not m.name.startswith("_")}
        elif isinstance(n, ast.Assign):
            out |= {t.id for t in n.targets
                    if isinstance(t, ast.Name) and not t.id.startswith("_")}
        elif isinstance(n, ast.ImportFrom):
            out |= {a.asname or a.name for a in n.names
                    if not (a.asname or a.name).startswith("_")}
    return out


def test_every_public_name_has_a_counterpart():
    missing = []
    jroot = os.path.join(ROOT, "orb_slam2_tpu")
    for d, _, files in os.walk(jroot):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, f), jroot)
            if rel == os.path.join("matching", "pallas_hamming.py"):
                continue        # the kernels: matching/hamming_top2.py
            port = os.path.join(ROOT, "orb_slam2_tpu_torch", rel)
            if not os.path.exists(port):
                missing.append(rel)
                continue
            jn = _public_names(os.path.join(d, f))
            if not f == "__init__.py":
                # names a module imports are its own only in a package
                jn = {n for n in jn if not any(
                    isinstance(x, ast.ImportFrom) and n in
                    {a.asname or a.name for a in x.names}
                    for x in ast.parse(open(os.path.join(d, f)).read()).body)}
            gone = jn - _public_names(port)
            missing += [f"{rel}:{n}" for n in sorted(gone)]
    assert missing == []


# functions the JAX package compiles whose port counterpart has another
# name: (module, JAX name) -> (port name, why)
JIT_RENAMED = {
    ("pipeline/tracking.py", "_match_last_fused"): (
        "_match_last", "replayed as tracking.match_last_graph"),
    ("pipeline/tracking.py", "_frustum_search_fused"): (
        "_frustum_search", "replayed as tracking.frustum_graph"),
    ("pipeline/tracking.py", "_track_prior_step"): (
        "_prior_step_core", "replayed as Tracker._prior_step"),
    ("models/vocabulary.py", "_transform_device"): (
        "transform_device", "replayed as vocabulary._transform_graph"),
    ("utils/synth.py", "_render_plane_jit"): (
        "render", "its jitted _warp is the body of the port's render"),
    ("models/device_points.py", "_scatter_rows"): (
        "DevicePoints", "kept eager by record: a graph would copy the six "
        "columns in and clone them out on every replay; DevicePoints.sync "
        "scatters them"),
}
# the Pallas kernels' module: its jitted wrappers live in the port's
# matching/hamming_top2.py
JIT_MODULE = {"matching/pallas_hamming.py": "matching/hamming_top2.py"}


def _jitted(path):
    """The functions of a module that ``jax.jit`` compiles (decorated,
    also through ``functools.partial``, or passed to ``jax.jit``), each
    by its own name where it is defined at the top of the module, else
    by the name of the top-level function, class or assignment around
    it."""
    out = []
    for top in ast.parse(open(path).read()).body:
        name = getattr(top, "name", None)
        if isinstance(top, ast.Assign):
            name = ast.unparse(top.targets[0])
        for node in ast.walk(top):
            if isinstance(node, ast.FunctionDef) and any(
                    "jax.jit" in ast.unparse(d) for d in node.decorator_list):
                out.append(node.name if node is top else name)
            elif isinstance(node, ast.Call) \
                    and ast.unparse(node.func) == "jax.jit":
                out.append(name)
    return out


def _defined_names(path):
    """Every function and class a module defines, at any depth, and its
    top-level assignments."""
    tree = ast.parse(open(path).read())
    names = {n.name for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    for n in tree.body:
        if isinstance(n, ast.Assign):
            names |= {t.id for t in n.targets if isinstance(t, ast.Name)}
    return names


def test_every_jitted_function_has_a_counterpart():
    """Every function the JAX package compiles with ``jax.jit`` has a
    counterpart of the same name in the port's module of the same path,
    or the one ``JIT_RENAMED`` gives with its reason."""
    jroot = os.path.join(ROOT, "orb_slam2_tpu")
    missing, seen = [], 0
    for d, _, files in os.walk(jroot):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, f), jroot).replace(
                os.sep, "/")
            port = os.path.join(ROOT, "orb_slam2_tpu_torch",
                                JIT_MODULE.get(rel, rel))
            for name in _jitted(os.path.join(d, f)):
                seen += 1
                want = JIT_RENAMED.get((rel, name), (name, ""))[0]
                if not os.path.exists(port) \
                        or want not in _defined_names(port):
                    missing.append(f"{rel}:{name} -> {want}")
    assert missing == []
    assert seen >= 30
    # every renamed entry still names a compiled JAX function
    for rel, name in JIT_RENAMED:
        assert name in _jitted(os.path.join(jroot, rel))
