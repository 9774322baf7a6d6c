"""The port's host I/O (``io/``) and trajectory evaluation against the JAX
package: the same files in, the same fields, arrays and bytes out.

Inputs are made here from seeds: a launch TOML and an OpenCV settings
YAML in the reference's schema, a UE4 pose list, an image list, random
poses, and a ragged DBoW2 vocabulary tree written in both of its file
formats."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu import io as jio
from orb_slam2_tpu.io import orbvoc as jorbvoc, poses as jposes
from orb_slam2_tpu.utils import evaluate as jeval
from orb_slam2_tpu_torch import io as tio
from orb_slam2_tpu_torch.io import orbvoc as torbvoc, poses as tposes
from orb_slam2_tpu_torch.utils import evaluate as teval

torch.set_num_threads(1)

SETTINGS = """%YAML:1.0
# shenzhen_simple.yaml schema
Camera.fx: 960.0
Camera.fy: 955.5
Camera.cx: 960.0
Camera.cy: 720.0
Camera.k1: 0.01
Camera.k2: -0.002
Camera.p1: 0.0005
Camera.p2: 0.0
Camera.fps: 10.0
Camera.RGB: 1
ORBextractor.nFeatures: 4000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
Viewer.KeyFrameSize: 0.05
"""


def _random_poses(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = rng.normal(0, 0.4, 3)
        th = np.linalg.norm(w)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        T = np.eye(4)
        T[:3, :3] = (np.eye(3) + np.sin(th) / th * K
                     + (1 - np.cos(th)) / th ** 2 * K @ K)
        T[:3, 3] = rng.normal(0, 3, 3)
        out.append(T.astype(np.float32))
    return out


def test_launch_toml_same_fields(tmp_path):
    p = tmp_path / "launch.toml"
    p.write_text('FBoWVocabularyPath = "Vocabulary/ORBvoc.bin"\n'
                 'ImagesCollectionPath = "imgs.txt"\n'
                 'CameraPoseCollectionPath = "cams.txt"\n'
                 'ORBSLAMConfigPath = "shenzhen_simple.yaml"\n'
                 'OutputDir = "Out"\n')
    j, t = jio.load_launch_toml(str(p)), tio.load_launch_toml(str(p))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.vocabulary_path == "Vocabulary/ORBvoc.bin"
    assert t.extra == {"OutputDir": "Out"}


@pytest.mark.parametrize("pose_prior", [True, False])
def test_settings_yaml_same_fields(tmp_path, pose_prior):
    p = tmp_path / "settings.yaml"
    p.write_text(SETTINGS)
    j = jio.load_settings_yaml(str(p), pose_prior=pose_prior)
    t = tio.load_settings_yaml(str(p), pose_prior=pose_prior)
    assert tuple(t.cam) == tuple(j.cam)
    assert t.orb._asdict() == j.orb._asdict()
    np.testing.assert_array_equal(t.cam.K, np.asarray(j.cam.K))
    for f in dataclasses.fields(t):
        if f.name not in ("cam", "orb"):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.cam.width == 1920 and t.cam.height == 1440
    assert t.pose_prior is pose_prior


def test_ue4_poses_and_revert_equal(tmp_path):
    rng = np.random.default_rng(2)
    lines = ["# x y z qx qy qz qw"]
    for _ in range(12):
        q = rng.normal(size=4)
        x = rng.normal(0, 50, 3)
        lines.append(" ".join(f"{v:.6f}" for v in (*x, *q)))
    lines.append("short line 1 2")         # skipped by both loaders
    p = tmp_path / "cams.txt"
    p.write_text("\n".join(lines) + "\n")
    jT, jrev = jposes.load_ue4_camera_poses(str(p))
    tT, trev = tposes.load_ue4_camera_poses(str(p))
    assert len(tT) == len(jT) == 12
    for a, b in zip(tT, jT):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(trev, jrev)
    np.testing.assert_allclose(tT[0], np.eye(4), atol=1e-5)


def test_ue4_pose_writer_inverts_both_loaders(tmp_path):
    """The port's UE4 writer (a dataset tool the JAX package lacks):
    both packages' loaders read its file back as the poses rebased to
    the first camera, and the revert transform as the first Twc."""
    Tcw = _random_poses(10, 9)
    p = str(tmp_path / "cams.txt")
    tposes.save_ue4_camera_poses(p, Tcw)
    for load in (jposes.load_ue4_camera_poses, tposes.load_ue4_camera_poses):
        got, revert = load(p)
        np.testing.assert_allclose(revert, np.linalg.inv(Tcw[0]), atol=1e-5)
        for a, b in zip(got, Tcw):
            np.testing.assert_allclose(a @ np.linalg.inv(revert), b,
                                       atol=1e-5)


def test_image_lists_equal(tmp_path):
    p = tmp_path / "imgs.txt"
    p.write_text("# images\n/data/a/000.png\n\n  /data/a/001.png  \n"
                 "  # skipped\n/data/a/002.png")
    assert tposes.load_image_list(str(p)) == jposes.load_image_list(str(p))
    assert len(tposes.load_image_list(str(p))) == 3


def test_tum_and_kitti_files_byte_identical(tmp_path):
    Tcw = _random_poses(9, 3)
    ts = np.arange(9) * 0.1 + 1305031102.175304
    jposes.save_tum_trajectory(str(tmp_path / "j_tum.txt"), ts, Tcw)
    tposes.save_tum_trajectory(str(tmp_path / "t_tum.txt"), ts, Tcw)
    jposes.save_kitti_trajectory(str(tmp_path / "j_kitti.txt"), Tcw)
    tposes.save_kitti_trajectory(str(tmp_path / "t_kitti.txt"), Tcw)
    for name in ("tum", "kitti"):
        assert ((tmp_path / f"t_{name}.txt").read_bytes()
                == (tmp_path / f"j_{name}.txt").read_bytes())
    jts, jTwc = jposes.load_tum_trajectory(str(tmp_path / "j_tum.txt"))
    tts, tTwc = tposes.load_tum_trajectory(str(tmp_path / "j_tum.txt"))
    np.testing.assert_array_equal(tts, jts)
    for a, b in zip(tTwc, jTwc):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------
# ORBvoc
# ----------------------------------------------------------------------
def _ragged_tree(k, L, seed):
    """A random DBoW2 tree in node-id order (parents first): each
    internal node has 2..k children, some of which stop early as
    leaves; each child descriptor is its parent's with a few bits
    flipped.  Returns (parent, desc (n, 32) uint8, weight, is_leaf)."""
    rng = np.random.default_rng(seed)
    parent, desc, weight, leaf = [], [], [], []
    root = rng.integers(0, 256, 32, dtype=np.uint8)
    frontier = [(0, root, 0)]               # (node id, desc, depth)
    nid = 0
    while frontier:
        nxt = []
        for p, pd, depth in frontier:
            for _ in range(int(rng.integers(2, k + 1))):
                nid += 1
                d = pd.copy()
                d[rng.integers(0, 32, 3)] ^= np.uint8(1 << int(rng.integers(8)))
                is_leaf = depth + 1 == L or (depth > 0
                                             and rng.random() < 0.15)
                parent.append(p)
                desc.append(d)
                weight.append(np.float32(rng.uniform(0.1, 3.0))
                              if is_leaf else np.float32(0))
                leaf.append(is_leaf)
                if not is_leaf:
                    nxt.append((nid, d, depth + 1))
        frontier = nxt
    return (np.asarray(parent), np.stack(desc), np.asarray(weight,
                                                           np.float32),
            np.asarray(leaf))


def _write_binary(path, k, L, tree):
    parent, desc, weight, leaf = tree
    rec = np.zeros(len(parent), dtype=np.dtype(
        [("parent", "<i4"), ("desc", "u1", (32,)), ("weight", "<f4"),
         ("leaf", "u1")]))
    rec["parent"], rec["desc"] = parent, desc
    rec["weight"], rec["leaf"] = weight, leaf
    with open(path, "wb") as f:
        f.write(np.array([len(parent) + 1, 41], "<u4").tobytes())
        f.write(np.array([k, L, 0, 0], "<i4").tobytes())
        rec.tofile(f)


def _write_text(path, k, L, tree):
    parent, desc, weight, leaf = tree
    with open(path, "w") as f:
        f.write(f"{k} {L} 0 0\n")
        for p, d, w, lf in zip(parent, desc, weight, leaf):
            f.write(f"{p} {int(lf)} " + " ".join(map(str, d))
                    + f" {float(w)!r}\n")


def _assert_same_vocab(t, j):
    assert (t.k, t.levels, t.node_level) == (j.k, j.levels, j.node_level)
    assert len(t.centers) == len(j.centers)
    for a, b in zip(t.centers, j.centers):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.idf, j.idf)
    np.testing.assert_array_equal(t.word_of_slot, j.word_of_slot)


@pytest.mark.parametrize("fmt", ["binary", "text"])
def test_orbvoc_files_parse_to_equal_vocabularies(tmp_path, fmt):
    k, L = 5, 4
    tree = _ragged_tree(k, L, seed=7)
    path = str(tmp_path / f"voc.{fmt}")
    if fmt == "binary":
        _write_binary(path, k, L, tree)
        t, j = torbvoc.load_orbvoc_binary(path), jorbvoc.load_orbvoc_binary(path)
    else:
        _write_text(path, k, L, tree)
        t, j = torbvoc.load_orbvoc_text(path), jorbvoc.load_orbvoc_text(path)
    _assert_same_vocab(t, j)
    # the same words for random descriptors, on the host and through
    # each package's device transform
    rng = np.random.default_rng(8)
    d = rng.integers(0, 2 ** 32, (500, 8), dtype=np.uint64).astype(np.uint32)
    leaves = tree[1][tree[3]].view("<u4")     # the leaves' own descriptors
    d[:len(leaves)] = leaves
    np.testing.assert_array_equal(t.transform_np(d), j.transform_np(d))
    tw, tn = t.transform(torch.from_numpy(d.view(np.int32)))
    jw, jn = j.transform(jnp.asarray(d))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_save_orbvoc_binary_byte_identical(tmp_path):
    jv = jorbvoc.synthetic_orbvoc(k=4, L=3, seed=1)
    tv = torbvoc.synthetic_orbvoc(k=4, L=3, seed=1)
    jorbvoc.save_orbvoc_binary(jv, str(tmp_path / "j.bin"))
    torbvoc.save_orbvoc_binary(tv, str(tmp_path / "t.bin"))
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    # and what one package writes, the other reads back equal
    _assert_same_vocab(torbvoc.load_orbvoc_binary(str(tmp_path / "j.bin")),
                       jorbvoc.load_orbvoc_binary(str(tmp_path / "t.bin")))


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_orbvoc_equal_arrays(seed):
    jv = jorbvoc.synthetic_orbvoc(k=6, L=4, seed=seed)
    tv = torbvoc.synthetic_orbvoc(k=6, L=4, seed=seed)
    assert (tv.k, tv.levels) == (jv.k, jv.levels)
    for a, b in zip(tv.centers, jv.centers):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tv.idf, jv.idf)


# ----------------------------------------------------------------------
# evaluation
# ----------------------------------------------------------------------
def test_camera_centers_rpe_associate_agree():
    est = _random_poses(20, 4)
    gt = [T @ np.diag([1, 1, 1, 1]).astype(np.float32) for T in
          _random_poses(20, 5)]
    np.testing.assert_array_equal(teval.camera_centers(est),
                                  jeval.camera_centers(est))
    for delta in (1, 3):
        assert teval.rpe(est, gt, delta) == jeval.rpe(est, gt, delta)
    rng = np.random.default_rng(6)
    ta = np.sort(rng.uniform(0, 5, 60))
    tb = np.sort(rng.uniform(0, 5, 70))
    pairs = teval.associate(ta, tb, max_dt=0.03)
    assert pairs == jeval.associate(ta, tb, max_dt=0.03)
    assert len(pairs) > 10
