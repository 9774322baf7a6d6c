"""Estimated-pose mode's compiled programs in the port, on the CPU,
against the JAX package: the tracker's per-frame programs
(``_pose_opt_fused``, ``_match_last``, ``_frustum_search``,
``_reproj_chi2_gate``, which replay CUDA graphs on the card) against
the JAX package's jitted ``_pose_opt_fused``, ``_match_last_fused``,
``_frustum_search_fused`` and ``_reproj_chi2_gate``; the Jacobi
eigensolver that EPnP runs on the card against ``torch.linalg.eigh``;
and ``pnp_ransac`` with that eigensolver forced on the CPU against the
JAX RANSAC.

On the CPU ``graphs.graphed`` calls its function, so these run the code
that the card replays, eagerly.  Sizes: 640x480 frames of 800 features
on 4 levels (tests/test_torch_matching.py's two views), <= 1,024 padded
rows, 128 minimal sets; inputs from numpy seeds.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_estimated_graphs.py
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu.optim import pnp as jpnp, pose_opt as jpose_opt
from orb_slam2_tpu.pipeline import tracking as jtracking
from orb_slam2_tpu_torch.geom import horn, jacobi
from orb_slam2_tpu_torch.optim import pnp, pose_opt
from orb_slam2_tpu_torch.pipeline import tracking

from test_torch_estimated import CX, CY, FX, FY, _outlier_scene, _pose
from test_torch_matching import SF, feats  # noqa: F401 (fixture)

torch.set_num_threads(1)

INV_SIG2 = (1.0 / (SF * SF)).astype(np.float32)
BOUNDS = (0.0, 640.0, 0.0, 480.0)
LOG_SCALE = float(np.log(1.2))
T = torch.as_tensor


def _backproject(Tcw, uv, depth):
    """World points that ``Tcw`` projects to ``uv`` at ``depth``."""
    pc = np.stack([(uv[:, 0] - CX) / FX * depth,
                   (uv[:, 1] - CY) / FY * depth, depth], -1)
    R, t = Tcw[:3, :3], Tcw[:3, 3]
    return ((pc - t) @ R).astype(np.float32)


def _frame_rows(f, n_rows):
    """``n_rows`` valid features of view 0 as the map points they see:
    their rays from view 0 meet the synthetic world's ground plane z = 0
    there; padded to pad_bucket(n_rows) rows.  Returns (view 1's pose,
    the rows, padded row ids, points, row validity)."""
    T0 = f[0]["Tcw"].astype(np.float64)
    rows = np.where(f[0]["valid"])[0][:n_rows]
    n = tracking.pad_bucket(len(rows))
    xy = f[0]["xy"][rows].astype(np.float64)
    ray = np.stack([(xy[:, 0] - CX) / FX, (xy[:, 1] - CY) / FY,
                    np.ones(len(rows))], -1) @ T0[:3, :3]
    center = -T0[:3, :3].T @ T0[:3, 3]
    pos = (center - (center[2] / ray[:, 2])[:, None] * ray).astype(np.float32)
    pad = n - len(rows)
    return (f[1]["Tcw"].astype(np.float32), rows,
            np.pad(rows, (0, pad)).astype(np.int32),
            np.pad(pos, ((0, pad), (0, 0))), np.arange(n) < len(rows))


# ----------------------------------------------------------------------
# the per-frame programs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n_rows", [200, 900])
def test_pose_opt_fused_matches_jax(n_rows):
    """The pose optimization with the keypoints gathered on the device,
    at 256 and 1,024 padded rows: a pose 6 cm and 1.3 degrees off, a
    fifth of the bindings moved 30-120 px, keypoints on 4 levels in
    shuffled rows of a 1,200-feature frame.  Bars: pose within 1e-4 of
    the JAX package's, the same inlier flags."""
    rng = np.random.default_rng(n_rows)
    P = _pose(0.4 * np.array([0.3, -0.5, 0.8]), [0.3, -0.2, 0.5])
    n = tracking.pad_bucket(n_rows)
    pw = rng.uniform([-3, -3, 4], [3, 3, 12], (n_rows, 3)).astype(np.float32)
    pw = pw @ P[:3, :3] - (P[:3, 3] @ P[:3, :3])
    pc = pw @ P[:3, :3].T + P[:3, 3]
    uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX,
                   FY * pc[:, 1] / pc[:, 2] + CY], -1).astype(np.float32)
    n_out = n_rows // 5
    uv[-n_out:] += rng.uniform(30, 120, (n_out, 2)).astype(np.float32)
    m = 1200
    bound = rng.permutation(m)[:n_rows]
    kp_xy = rng.uniform(0, 640, (m, 2)).astype(np.float32)
    kp_xy[bound] = uv
    kp_octave = rng.integers(0, 4, m).astype(np.int32)
    P0 = P.copy()
    P0[:3, 3] += [0.05, -0.03, 0.02]
    P0[:3, :3] = _pose([0.01, -0.02, 0.005], [0, 0, 0])[:3, :3] @ P[:3, :3]
    pad = n - n_rows
    args = [P0, np.pad(pw, ((0, pad), (0, 0))), np.pad(bound, (0, pad)),
            kp_xy, kp_octave, INV_SIG2, np.arange(n) < n_rows]
    j = jtracking._pose_opt_fused(*[jnp.asarray(a) for a in args],
                                  FX, FY, CX, CY)
    p = tracking._pose_opt_fused(*[T(a) for a in args], FX, FY, CX, CY)
    np.testing.assert_allclose(p.Tcw.numpy(), np.asarray(j.Tcw), atol=1e-4)
    np.testing.assert_array_equal(p.inliers.numpy(), np.asarray(j.inliers))
    assert n_rows - n_out - 5 <= int(p.n_inliers) <= n_rows - n_out


@pytest.mark.parametrize("chi2", [0.0, 5.991])
def test_match_last_matches_jax(feats, chi2):  # noqa: F811
    """The last-frame search (projection, in-image gate, K2 search and,
    with chi2 > 0, the reprojection gate) of the map points of 400 of
    view 0's features against view 1's features.  Bars: idx, valid and gate
    equal to ``_match_last_fused``'s."""
    f0, f1 = feats
    Tcw, _, row_ids, pos, mval = _frame_rows(feats, 400)
    args = [Tcw, pos, mval, row_ids, f0["octave"], f0["desc"], f0["angle"],
            f1["xy"], f1["octave"], f1["desc"], f1["valid"], f1["angle"],
            SF, INV_SIG2]
    jres, jgate = jtracking._match_last_fused(
        *[jnp.asarray(a) for a in args], FX, FY, CX, CY, BOUNDS, 7.0, chi2)
    targs = [T(np.array(a)) for a in args]
    targs[5] = T(f0["desc"].view(np.int32))
    targs[9] = T(f1["desc"].view(np.int32))
    res, gate = tracking._match_last(*targs, FX, FY, CX, CY, BOUNDS, 7.0,
                                     chi2)
    np.testing.assert_array_equal(res.valid.numpy(), np.asarray(jres.valid))
    np.testing.assert_array_equal(res.idx.numpy(), np.asarray(jres.idx))
    np.testing.assert_array_equal(gate.numpy(), np.asarray(jgate))
    assert 100 < int(gate.sum()) <= int(res.valid.sum())


def test_frustum_search_matches_jax(feats):  # noqa: F811
    """The local-map search (frustum cull, K2 search) of the map points
    of 600 of view 0's features, their normals and scale band from view
    0 (the reference keyframe's, src/MapPoint.cc:UpdateNormalAndDepth),
    against view 1's features of which a fifth are bound; estimated mode
    (chi2 0).  Bars: every output equal to ``_frustum_search_fused``'s."""
    f0, f1 = feats
    Tcw, rows, _, pos, pvalid = _frame_rows(feats, 600)
    rng = np.random.default_rng(2)
    T0 = f0["Tcw"]
    d = pos - (-T0[:3, :3].T @ T0[:3, 3])
    dist = np.linalg.norm(d, axis=1).astype(np.float32)
    normal = (d / np.maximum(dist, 1e-6)[:, None]).astype(np.float32)
    level = np.pad(f0["octave"][rows], (0, len(pos) - len(rows)))
    max_d = (dist * SF[level]).astype(np.float32)
    min_d = (max_d / SF[-1]).astype(np.float32)
    desc = np.pad(f0["desc"][rows], ((0, len(pos) - len(rows)), (0, 0)))
    has = rng.random(len(f1["xy"])) < 0.2
    nb = 256
    old_idx = np.pad(np.where(has)[0][:nb], (0, max(0, nb - has.sum())))
    old_pos = rng.uniform(-2, 2, (nb, 3)).astype(np.float32)
    old_valid = np.arange(nb) < min(nb, has.sum())
    args = [pos, normal, min_d, max_d, pvalid, desc, Tcw, f1["xy"],
            f1["octave"], f1["desc"], f1["valid"], has, old_pos,
            old_idx.astype(np.int32), old_valid, SF, INV_SIG2]
    jout = jtracking._frustum_search_fused(
        *[jnp.asarray(a) for a in args], FX, FY, CX, CY, BOUNDS, 4,
        LOG_SCALE, 3.0, 0.0)
    targs = [T(np.array(a)) for a in args]
    targs[5] = T(desc.view(np.int32))
    targs[9] = T(f1["desc"].view(np.int32))
    out = tracking._frustum_search(*targs, FX, FY, CX, CY, BOUNDS, 4,
                                   LOG_SCALE, 3.0, 0.0)
    vis, res, new_gate, old_gate = out
    jvis, jres, jnew, jold = jout
    for name, a, b in (("visible", vis, jvis), ("idx", res.idx, jres.idx),
                       ("dist", res.dist, jres.dist),
                       ("valid", res.valid, jres.valid),
                       ("new gate", new_gate, jnew),
                       ("old gate", old_gate, jold)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert int(res.valid.sum()) > 100


def test_reproj_chi2_gate_padded_matches_jax(feats):  # noqa: F811
    """The trusted-pose chi2 gate over 300 bindings padded to 1,024 rows
    as the tracker pads them (``pad_bucket``), a third of the bindings'
    points moved 5-40 px off their keypoint.  Bar: the mask equal to
    the JAX ``_reproj_chi2_gate``'s, the padding rows False."""
    f1 = feats[1]
    rng = np.random.default_rng(4)
    Tcw = f1["Tcw"].astype(np.float32)
    bound = np.where(f1["valid"])[0][:300]
    uv = f1["xy"][bound].copy()
    uv[::3] += rng.uniform(5, 40, (len(uv[::3]), 2)).astype(np.float32)
    pos = _backproject(Tcw, uv, rng.uniform(8, 12, len(bound)))
    n = tracking.pad_bucket(len(bound))
    assert n == 1024
    pad = n - len(bound)
    args = [Tcw, np.pad(pos, ((0, pad), (0, 0))), np.pad(bound, (0, pad)),
            f1["xy"], f1["octave"], INV_SIG2, np.arange(n) < len(bound)]
    want = np.asarray(jtracking._reproj_chi2_gate(
        *[jnp.asarray(a) for a in args], FX, FY, CX, CY, 5.991))
    got = tracking._reproj_chi2_gate(*[T(a) for a in args], FX, FY, CX, CY,
                                     5.991).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[len(bound):].any()
    assert 150 < got.sum() < 250


# ----------------------------------------------------------------------
# EPnP on the card's eigensolver
# ----------------------------------------------------------------------
def _minimal_sets():
    """The 12x12 M^T M and the 3x3 covariances of EPnP on the outlier
    scene's 128 minimal samples (tests/test_pnp.py's), in float64, and
    which samples hold four distinct points."""
    _, pw, uv, samples = _outlier_scene()
    p, u = T(pw)[T(samples).long()], T(uv)[T(samples).long()]
    cw = pnp._control_points(p)
    M = pnp._build_M(pnp._barycentric(p, cw), u, FX, FY, CX, CY)
    d = p - p.mean(-2, keepdim=True)
    cov = d.transpose(-1, -2) @ d / p.shape[-2]
    distinct = torch.tensor([len(set(s)) == 4 for s in samples.tolist()])
    return (M.transpose(-1, -2) @ M).double(), cov.double(), distinct


def test_jacobi_eigh_matches_linalg():
    """``jacobi.sym_eigh`` with EPnP's sweep counts (``pnp.SWEEPS_COV``,
    ``pnp.SWEEPS_M``) against float64 ``torch.linalg.eigh`` on the 128
    minimal sets' 3x3 covariances and 12x12 M^T M.  Bars: eigenvalues
    within 1e-6 of the largest; the vectors orthonormal within 1e-12;
    the covariances' eigenvectors within 1e-6 up to sign where the
    eigenvalues are apart; the projector on the 4-dimensional null space
    of M^T M within 1e-6 (where the sample's four points are distinct:
    a repeated point widens the null space, where no 4-dimensional
    projector is defined)."""
    MtM, cov, distinct = _minimal_sets()
    assert distinct.sum() >= 100
    for A, sweeps in ((cov, pnp.SWEEPS_COV), (MtM, pnp.SWEEPS_M)):
        w, v = jacobi.sym_eigh(A, sweeps)
        w0, v0 = torch.linalg.eigh(A)
        scale = w0.abs().amax(-1, keepdim=True)
        assert ((w - w0).abs() / scale).max() < 1e-6
        eye = torch.eye(A.shape[-1], dtype=A.dtype)
        assert (v.transpose(-1, -2) @ v - eye).abs().max() < 1e-12
    w, v = jacobi.sym_eigh(cov, pnp.SWEEPS_COV)
    w0, v0 = torch.linalg.eigh(cov)
    apart = (w0.diff(dim=-1).min(-1).values > 1e-3 * w0[:, -1])
    err = torch.minimum((v - v0).abs().amax(-2), (v + v0).abs().amax(-2))
    assert apart.sum() >= 100 and err[apart].max() < 1e-6
    w, v = jacobi.sym_eigh(MtM, pnp.SWEEPS_M)
    w0, v0 = torch.linalg.eigh(MtM)
    proj = v[..., :4] @ v[..., :4].transpose(-1, -2)
    proj0 = v0[..., :4] @ v0[..., :4].transpose(-1, -2)
    assert (proj - proj0).abs().amax((-1, -2))[distinct].max() < 1e-6


def _card_eigh(monkeypatch):
    """EPnP's eigensolver and Horn's eigenvector (its pose recovery) as
    the card takes them (Jacobi in float64), on the CPU.  A minimal set
    with a repeated point has no pose: its hypothesis may come out NaN,
    which LAPACK's ``eigh`` refuses and the Jacobi sweeps carry to a
    hypothesis with no inlier."""
    def eigh(A, sweeps):
        w, v = jacobi.sym_eigh(A.double(), sweeps)
        return w.to(A.dtype), v.to(A.dtype)
    monkeypatch.setattr(pnp, "_eigh", eigh)
    monkeypatch.setattr(horn, "top_eigvec", lambda N: horn.sym4_top_eigvec(
        N.double()).to(N.dtype))


def test_pnp_ransac_on_the_cards_eigh_matches_jax(monkeypatch):
    """tests/test_torch_estimated.py's test_pnp_ransac_matches_jax with
    the Jacobi eigensolver forced on the CPU.  Bars (that test's): the same
    inliers and inlier count as the JAX RANSAC, and the pose within
    1e-3 of the JAX package's after the motion-only optimization over
    those inliers."""
    _card_eigh(monkeypatch)
    P, pw, uv, samples = _outlier_scene()
    n = len(pw)
    j = jpnp.pnp_ransac(jnp.asarray(pw), jnp.asarray(uv),
                        jnp.ones(n, jnp.float32), jnp.ones(n, bool),
                        jnp.asarray(samples), FX, FY, CX, CY, min_inliers=10)
    p = pnp.pnp_ransac(T(pw), T(uv), torch.ones(n),
                       torch.ones(n, dtype=torch.bool), T(samples),
                       FX, FY, CX, CY, 10)
    assert bool(p.ok) and bool(j.ok)
    np.testing.assert_array_equal(p.inliers.numpy(), np.asarray(j.inliers))
    assert int(p.n_inliers) == int(j.n_inliers) == 70
    ones = np.ones(n, np.float32)
    jr = jpose_opt.optimize_pose(j.Tcw, jnp.asarray(pw), jnp.asarray(uv),
                                 jnp.asarray(ones), j.inliers, FX, FY, CX, CY)
    pr = pose_opt.optimize_pose(p.Tcw, T(pw), T(uv), T(ones), p.inliers,
                                FX, FY, CX, CY)
    np.testing.assert_allclose(pr.Tcw.numpy(), np.asarray(jr.Tcw), atol=1e-3)
    np.testing.assert_allclose(pr.Tcw.numpy(), P, atol=1e-3)


def test_epnp_on_the_cards_eigh_matches_jax(monkeypatch):
    """tests/test_torch_estimated.py's test_epnp_matches_jax (12 exact
    correspondences) with the Jacobi eigensolver.  Bar: pose within 1e-3
    of the JAX package's."""
    _card_eigh(monkeypatch)
    P = _pose(0.4 * np.array([0.6, -0.3, 0.74]), [0.3, -0.2, 0.5])
    rng = np.random.default_rng(1)
    pw = rng.uniform([-3, -3, 4], [3, 3, 12], (12, 3)).astype(np.float32)
    pw = pw @ P[:3, :3] - (P[:3, 3] @ P[:3, :3])
    pc = pw @ P[:3, :3].T + P[:3, 3]
    uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX,
                   FY * pc[:, 1] / pc[:, 2] + CY], -1).astype(np.float32)
    Tj, _ = jpnp.epnp(jnp.asarray(pw), jnp.asarray(uv), FX, FY, CX, CY)
    Tp, err = pnp.epnp(T(pw), T(uv), FX, FY, CX, CY)
    np.testing.assert_allclose(Tp.numpy(), np.asarray(Tj), atol=1e-3)
    assert float(err) < 1.0
