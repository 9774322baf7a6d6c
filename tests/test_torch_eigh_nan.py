"""The CPU eigensolvers of the port on blocks with NaN entries, against
the JAX package's: Horn's top eigenvector (``geom/horn.top_eigvec``),
EPnP's ``_eigh`` and ``pnp_ransac`` with degenerate samples.

A RANSAC batch of minimal samples drawn with replacement holds samples
that repeat a point; EPnP's beta fits on such a sample can give NaN,
and so Horn's 4x4 matrix of that sample is NaN in every entry.
``jnp.linalg.eigh`` returns NaN for such a block and the RANSAC scores
the hypothesis out; LAPACK's ``eigh`` in PyTorch raises for the whole
batch (``torch._C._LinAlgError``).  The port's CPU branch gives such a
block NaN and every finite block LAPACK's result as before, bit for bit.

``data/reloc_frame27.npz`` is the relocalization problem the port met
at frame 27 of tests/test_loop_upstream.py's noisy circuit (seed 11;
tests/test_torch_loop_estimated.py): 64 map points and their keypoints,
128 EPnP samples, and Horn's matrices of the first beta approximation,
NaN in blocks 8, 13, 61 and 126."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_tpu.optim import pnp as jpnp, pose_opt as jpose_opt
from orb_slam2_tpu_torch.geom import horn
from orb_slam2_tpu_torch.optim import pnp, pose_opt

from test_torch_estimated import CX, CY, FX, FY, _pnp_pose, _project

torch.set_num_threads(1)

FRAME27 = os.path.join(os.path.dirname(__file__), "data",
                       "reloc_frame27.npz")
NAN_BLOCKS = [8, 13, 61, 126]     # the recorded batch's degenerate samples


def frame27():
    with np.load(FRAME27) as d:
        return {k: d[k] for k in d.files}


def _sym_batch(n: int, seed: int, size: int = 64):
    """Seeded symmetric positive semi-definite blocks (covariance-like),
    blocks 5 and 17 NaN in every entry, block 40 in one entry (which
    makes ``jnp.linalg.eigh``'s whole block NaN as well)."""
    rng = np.random.default_rng(seed)
    B = rng.normal(0, 1, (size, n + 2, n)).astype(np.float32)
    A = B.transpose(0, 2, 1) @ B
    A[[5, 17]] = np.nan
    A[40, 0, 0] = np.nan
    return A


@pytest.mark.parametrize("which", ["frame27", "seeded"])
def test_top_eigvec_nan_blocks_as_jax(which):
    """Horn's top eigenvector on the CPU against ``jnp.linalg.eigh``'s
    last column, block by block.  Bars: NaN in every entry exactly
    where the JAX package's is NaN (the recorded frame-27 batch's four
    blocks; the seeded batch's three); elsewhere LAPACK's vector of the
    finite blocks alone, bit for bit, and the JAX vector up to sign
    within float32's perturbation bound: the gap times the top
    eigengap (relative to the block's largest eigenvalue) within 1e-6,
    and within 1e-5 (test_torch_loop.py's Horn bar) where that eigengap
    is above 0.1.  The recorded blocks are minimal samples' with
    eigengaps down to 2.3e-4, where the vectors differ by up to 3.7e-4
    (gap x eigengap at most 3.9e-7)."""
    N = frame27()["horn_N"] if which == "frame27" else _sym_batch(4, 0)
    wj, vj = (np.asarray(x) for x in jnp.linalg.eigh(jnp.asarray(N)))
    vj = vj[..., -1]
    vp = horn.top_eigvec(torch.from_numpy(N)).numpy()
    nan_j = np.isnan(vj).all(-1)
    assert (np.isnan(vp).all(-1) == nan_j).all()
    assert not np.isnan(vj[~nan_j]).any()
    if which == "frame27":
        assert np.where(nan_j)[0].tolist() == NAN_BLOCKS
    alone = torch.linalg.eigh(torch.from_numpy(N[~nan_j]))[1][..., -1]
    assert torch.equal(torch.from_numpy(vp[~nan_j]), alone)
    vp, vj, wj = vp[~nan_j], vj[~nan_j], wj[~nan_j]
    sign = np.sign((vp * vj).sum(-1, keepdims=True))
    err = np.abs(vp * sign - vj).max(-1)
    gap = (wj[:, -1] - wj[:, -2]) / np.abs(wj).max(-1)
    assert (err * gap).max() < 1e-6, (err * gap).max()
    assert err[gap > 0.1].max() < 1e-5, err[gap > 0.1].max()


@pytest.mark.parametrize("n, sweeps", [(3, pnp.SWEEPS_COV),
                                       (12, pnp.SWEEPS_M)])
def test_epnp_eigh_nan_blocks_as_jax(n, sweeps):
    """EPnP's ``_eigh`` on the CPU (its 3x3 covariances and 12x12
    ``M^T M``) against ``jnp.linalg.eigh``, block by block.  Bars: NaN
    eigenvalues and eigenvectors exactly where the JAX package's are;
    elsewhere eigenvalues within 1e-5 of the block's largest and
    eigenvectors equal up to sign within 1e-4 (the seeded spectra are
    simple), and LAPACK's result on the finite blocks alone, bit for
    bit."""
    A = _sym_batch(n, n)
    wj, vj = (np.asarray(x) for x in jnp.linalg.eigh(jnp.asarray(A)))
    wp, vp = (x.numpy() for x in pnp._eigh(torch.from_numpy(A), sweeps))
    nan_j = np.isnan(wj).all(-1)
    assert nan_j.tolist() == [i in (5, 17, 40) for i in range(len(A))]
    assert (np.isnan(vj).all((-1, -2)) == nan_j).all()
    assert (np.isnan(wp).all(-1) == nan_j).all()
    assert (np.isnan(vp).all((-1, -2)) == nan_j).all()
    ok = ~nan_j
    assert not np.isnan(wp[ok]).any() and not np.isnan(vp[ok]).any()
    scale = np.abs(wj[ok]).max(-1, keepdims=True)
    np.testing.assert_allclose(wp[ok] / scale, wj[ok] / scale, atol=1e-5,
                               rtol=0)
    cp, cj = np.swapaxes(vp[ok], -1, -2), np.swapaxes(vj[ok], -1, -2)
    sign = np.sign((cp * cj).sum(-1, keepdims=True))
    np.testing.assert_allclose(cp * sign, cj, atol=1e-4, rtol=0)
    w1, v1 = torch.linalg.eigh(torch.from_numpy(A[ok]))
    assert torch.equal(torch.from_numpy(wp[ok]), w1)
    assert torch.equal(torch.from_numpy(vp[ok]), v1)


def _deep_scene(seed: int = 0):
    """tests/test_pnp.py's pose over 64 points 20-200 units deep, the
    last 20 moved 30-120 px, and 128 samples drawn with replacement of
    which every fourth repeats a point: EPnP gives NaN for some of them
    at this depth."""
    P = _pnp_pose(seed)
    rng = np.random.default_rng(seed + 100)
    n = 64
    pw = rng.uniform([-30, -30, 20], [30, 30, 200], (n, 3)).astype(np.float32)
    pw = pw @ P[:3, :3] - (P[:3, 3] @ P[:3, :3])
    uv = _project(P, pw)
    uv[-20:] += rng.uniform(30, 120, (20, 2)).astype(np.float32)
    samples = rng.integers(0, n, (128, 4)).astype(np.int32)
    samples[::4, 3] = samples[::4, 2]
    return pw, uv, samples


def test_pnp_ransac_with_degenerate_samples_as_jax():
    """``pnp_ransac`` on a problem whose samples include degenerate ones
    (EPnP's pose is NaN for them).  Bars: the JAX package's verdict,
    inlier flags and count; the pose within 1e-3 of the JAX package's
    after the motion-only optimization over those inliers that follows
    every RANSAC in the pipeline (test_torch_estimated.py's EPnP bar),
    with the same inliers after it."""
    pw, uv, samples = _deep_scene()
    n = len(pw)
    T, _ = pnp._epnp_batch(torch.from_numpy(pw)[samples],
                           torch.from_numpy(uv)[samples], FX, FY, CX, CY)
    assert (~torch.isfinite(T).all(-1).all(-1)).sum() > 0
    ones = np.ones(n, np.float32)
    j = jpnp.pnp_ransac(jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(ones),
                        jnp.ones(n, bool), jnp.asarray(samples), FX, FY, CX,
                        CY, min_inliers=10)
    p = pnp.pnp_ransac(torch.from_numpy(pw), torch.from_numpy(uv),
                       torch.from_numpy(ones), torch.ones(n, dtype=torch.bool),
                       torch.from_numpy(samples), FX, FY, CX, CY,
                       min_inliers=10)
    assert bool(p.ok) == bool(j.ok) is True
    np.testing.assert_array_equal(p.inliers.numpy(), np.asarray(j.inliers))
    assert int(p.n_inliers) == int(j.n_inliers)
    jr = jpose_opt.optimize_pose(j.Tcw, jnp.asarray(pw), jnp.asarray(uv),
                                 jnp.asarray(ones), j.inliers, FX, FY, CX, CY)
    pr = pose_opt.optimize_pose(p.Tcw, torch.from_numpy(pw),
                                torch.from_numpy(uv), torch.from_numpy(ones),
                                p.inliers, FX, FY, CX, CY)
    np.testing.assert_allclose(pr.Tcw.numpy(), np.asarray(jr.Tcw), atol=1e-3)
    np.testing.assert_array_equal(pr.inliers.numpy(), np.asarray(jr.inliers))


def test_pnp_ransac_frame27_as_jax():
    """``pnp_ransac`` on the recorded frame-27 problem, where the parent
    raised.  Bars: the JAX package's verdict (no pose: 5 inliers of the
    10 asked) and inlier count.  The winning hypotheses tie among junk
    poses, so their flags and poses are not compared."""
    d = frame27()
    args = [d[k] for k in ("pts_w", "uv", "inv_sigma2", "valid", "samples")]
    j = jpnp.pnp_ransac(*[jnp.asarray(a) for a in args], FX, FY, CX, CY,
                        min_inliers=10)
    p = pnp.pnp_ransac(*[torch.from_numpy(a) for a in args], FX, FY, CX, CY,
                       min_inliers=10)
    assert bool(p.ok) == bool(j.ok) is False
    assert int(p.n_inliers) == int(j.n_inliers)
