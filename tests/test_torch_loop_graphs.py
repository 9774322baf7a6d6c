"""Loop closing's compiled programs in the port, on the CPU: the small
linear algebra that lets them run without a host sync (the Cholesky
solves and inverses of the LM steps, the closed-form 3x3 solve of
``sim3.log``, the Jacobi eigenvector of Horn's method) against
``torch.linalg`` and the JAX package; the step-chunked solvers
(``bundle_adjust``, ``optimize_pose_graph``, ``optimize_sim3``) against
their one-call forms bit for bit and against the JAX functions; the
Sim3 RANSAC on the card's eigenvector against the JAX one; ``IndexSum``
with its longest segment from the host; and the mesh constructors,
which take the CPU only when asked.

On the CPU ``graphs.graphed`` calls its function, so these run the code
that the card replays from CUDA graphs, eagerly.  Sizes: <= 32
keyframes, <= 2,048 observations, <= 256 edges, made from numpy seeds.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.geom import horn as jhorn, sim3 as jsim3
from orb_slam2_tpu.optim import (ba as jba, pose_graph as jpg,
                                 sim3_opt as jso, sim3_ransac as jsr)
from orb_slam2_tpu_torch import parallel
from orb_slam2_tpu_torch.geom import horn as thorn, sim3 as tsim3, smallsolve
from orb_slam2_tpu_torch.optim import (ba as tba, pose_graph as tpg,
                                       segment, sim3_opt as tso,
                                       sim3_ransac as tsr)
from orb_slam2_tpu_torch.parallel import multihost

from test_torch_loop import (CX, CY, FX, FY, _ba_problem, _close,
                             _rand_sims, _sim3_problem)

torch.set_num_threads(1)


def _equal(a, b):
    """Two results (named tuples of tensors) equal bit for bit."""
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _spd(rng, batch, n):
    """SPD blocks with eigenvalues in [0.5, 5] (condition <= 10)."""
    q, _ = np.linalg.qr(rng.normal(size=(batch, n, n)))
    lam = rng.uniform(0.5, 5.0, (batch, n))
    return np.einsum("bij,bj,bkj->bik", q, lam, q).astype(np.float32)


# ----------------------------------------------------------------------
# small linear algebra (bars relative to the result's largest entry)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n", [6, 7])
def test_spd_inverse_and_solve_match_linalg_and_jax(n):
    """The Cholesky inverse and solve of the BA (6x6) and pose-graph /
    Sim3 (7x7) blocks.  Bar: within 1e-5 of ``torch.linalg`` and of the
    JAX package's ``jnp.linalg`` (relative to the largest entry), the
    factor within 1e-5 of ``torch.linalg.cholesky``."""
    rng = np.random.default_rng(n)
    A = _spd(rng, 64, n)
    b = rng.normal(size=(64, n)).astype(np.float32)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    inv = smallsolve.spd_inverse(At)
    x = smallsolve.spd_solve(At, bt)
    for got, want in ((inv, torch.linalg.inv(At)),
                      (inv, np.asarray(jnp.linalg.inv(jnp.asarray(A)))),
                      (x, torch.linalg.solve(At, bt)),
                      (x, np.asarray(jnp.linalg.solve(
                          jnp.asarray(A), jnp.asarray(b)[..., None]))[..., 0]),
                      (smallsolve.cholesky(At), torch.linalg.cholesky(At))):
        want = np.asarray(want)
        _close(got, want, 1e-5 * np.abs(want).max())


def test_spd_solve_of_one_system():
    """The Sim3 optimization's single 7x7 damped system (no batch
    axis).  Bar: 1e-5 of ``torch.linalg.solve``."""
    rng = np.random.default_rng(1)
    A = torch.from_numpy(_spd(rng, 1, 7)[0])
    b = torch.from_numpy(rng.normal(size=7).astype(np.float32))
    want = torch.linalg.solve(A, b)
    _close(smallsolve.spd_solve(A, b), want, 1e-5 * want.abs().max())


def test_sim3_log_closed_form_matches_linalg_and_jax():
    """``sim3.log`` solves W upsilon = t by the adjugate.  Bar: within
    1e-5 of the same log with ``torch.linalg.solve`` and of the JAX
    package's log, in float32; 1e-12 of the linalg form in float64 (the
    pose graph's central differences)."""
    rng = np.random.default_rng(5)
    g = tsim3.exp(torch.from_numpy(_rand_sims(rng, 200)))

    def log_linalg(g):
        from orb_slam2_tpu_torch.geom import se3
        R, t, s = tsim3.rot(g), tsim3.trans(g), tsim3.scale(g)
        omega, sigma = se3.so3_log(R), torch.log(s)
        eye = torch.eye(3, dtype=t.dtype)
        W = torch.stack([tsim3.trans(tsim3.exp(torch.cat(
            [e.expand(omega.shape), omega, sigma[..., None]], -1)))
            for e in eye], -1)
        ups = torch.linalg.solve(W, t[..., None])[..., 0]
        return torch.cat([ups, omega, sigma[..., None]], -1)
    _close(tsim3.log(g), log_linalg(g), 1e-5)
    _close(tsim3.log(g), jsim3.log(jnp.asarray(g.numpy())), 1e-5)
    _close(tsim3.log(g.double()), log_linalg(g.double()), 1e-12)


def test_jacobi_top_eigvec_matches_eigh_and_jax():
    """The card's eigenvector for Horn: cyclic Jacobi sweeps in float64
    on symmetric 4x4 blocks with an eigengap >= 0.2 of a norm <= 3.
    Bar: up to sign, within 1e-6 of ``torch.linalg.eigh``'s (float64)
    and 1e-5 of the JAX package's (float32) last eigenvector."""
    rng = np.random.default_rng(9)
    q, _ = np.linalg.qr(rng.normal(size=(256, 4, 4)))
    lam = np.sort(rng.uniform(-3, 3, (256, 4)), -1)
    lam[:, 3] = np.maximum(lam[:, 3], lam[:, 2] + 0.2)
    N = np.einsum("bij,bj,bkj->bik", q, lam, q)
    got = thorn.sym4_top_eigvec(torch.from_numpy(N)).numpy()
    for want, tol in ((torch.linalg.eigh(torch.from_numpy(N))[1][..., -1]
                       .numpy(), 1e-6),
                      (np.asarray(jnp.linalg.eigh(jnp.asarray(
                          N.astype(np.float32)))[1][..., -1]), 1e-5)):
        err = np.minimum(np.abs(got - want).max(-1),
                         np.abs(got + want).max(-1))
        assert err.max() < tol, err.max()


def _card_eigvec(monkeypatch):
    """Horn's eigenvector as the card takes it (Jacobi in float64), on
    the CPU."""
    monkeypatch.setattr(thorn, "top_eigvec", lambda N: thorn.sym4_top_eigvec(
        N.double()).to(N.dtype))


def test_horn_on_the_cards_eigenvector(monkeypatch):
    """test_torch_loop.test_horn's solves through the Jacobi eigenvector.
    Bars: rotation, translation and scale within 1e-5 of the JAX solve
    on 40 points; within 5e-5 on minimal 3-point samples, whose small
    eigengaps put float32 LAPACK (the JAX package's eigh) up to 1.3e-5
    from the float64 answer."""
    _card_eigvec(monkeypatch)
    rng = np.random.default_rng(2)
    true = tsim3.exp(torch.from_numpy(_rand_sims(rng, 32)))
    p2 = rng.uniform(-2, 2, (32, 40, 3)).astype(np.float32)
    p1 = tsim3.apply(true, torch.from_numpy(p2)).numpy()
    p1 = p1 + rng.normal(0, 0.01, p1.shape).astype(np.float32)
    for n, tol in ((3, 5e-5), (40, 1e-5)):
        for fix in (False, True):
            gj = jhorn.horn_sim3(jnp.asarray(p1[:, :n]),
                                 jnp.asarray(p2[:, :n]), fix_scale=fix)
            gt = thorn.horn_sim3(torch.from_numpy(p1[:, :n]),
                                 torch.from_numpy(p2[:, :n]), fix_scale=fix)
            _close(tsim3.rot(gt), jsim3.rot(gj), tol)
            _close(gt[:, 4:], gj[:, 4:], tol)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_sim3_ransac_on_the_cards_eigenvector(monkeypatch, fix_scale):
    """The RANSAC of test_torch_loop with Horn's eigenvector taken as on
    the card, fed the JAX package's 256 samples.  Bars: the same
    verdict, the same best hypothesis (S12 within 1e-4 through R, t, s)
    and the same inlier flags and count."""
    _card_eigvec(monkeypatch)
    pr = _sim3_problem(3, scale=1.0 if fix_scale else 1.15)
    n = len(pr["p1"])
    samples = pr["rng"].integers(0, n - 12, (256, 3)).astype(np.int32)
    me = (jsr.CHI2_SIM3 * pr["sig2"]).astype(np.float32)
    args = [pr[k] for k in ("p1", "p2", "uv1", "uv2")] + [me, me,
                                                          pr["valid"], samples]
    rj = jsr.sim3_ransac(*[jnp.asarray(a) for a in args], FX, FY, CX, CY,
                         min_inliers=20, fix_scale=fix_scale)
    rt = tsr.sim3_ransac(*[torch.from_numpy(a) for a in args], FX, FY, CX, CY,
                         20, fix_scale)
    assert bool(rt.ok) == bool(rj.ok) is True
    _close(tsim3.rot(rt.S12), jsim3.rot(rj.S12), 1e-4)
    _close(rt.S12[4:], rj.S12[4:], 1e-4)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers)


# ----------------------------------------------------------------------
# IndexSum's longest segment from the host
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,trail", [(100, ()), (100, (3,)), (5, (7, 7))])
def test_index_sum_with_host_longest(n, trail):
    """``segment.longest_segment`` is the clamped ``np.bincount`` maximum,
    and ``IndexSum`` built with it sums as the one built without it
    (``index_add_`` on the CPU), bit for bit."""
    rng = np.random.default_rng(n)
    idx = rng.integers(0, n, 2000)
    longest = segment.longest_segment(idx, n)
    assert longest == min(int(np.bincount(idx, minlength=n).max()),
                          segment.LONG_SEGMENTS + 1)
    assert segment.longest_segment(np.zeros(0, np.int64), n) == 0
    assert segment.longest_segment(np.arange(n), n) == 1
    vals = torch.from_numpy(rng.normal(size=(2000,) + trail)
                            .astype(np.float32))
    it = torch.from_numpy(idx)
    out = segment.IndexSum(it, n, longest=longest)(vals)
    assert torch.equal(out, segment.IndexSum(it, n)(vals))
    assert torch.equal(out, torch.zeros((n,) + trail).index_add_(0, it, vals))


# ----------------------------------------------------------------------
# the step-chunked solvers against their one-call forms and the JAX ones
# ----------------------------------------------------------------------
def _ba_args():
    return [torch.from_numpy(a) for a in _ba_problem(8)]


@pytest.mark.parametrize("chunk", [1, 3, 10])
@pytest.mark.parametrize("iters", [0, 7, 10])
def test_bundle_adjust_chunks_equal_one_call(monkeypatch, chunk, iters):
    """``bundle_adjust`` in chunks of 1, 3 (a remainder) or 10 LM
    iterations, (cam, points, the linearization, lam) threaded, with
    the longest segments from the host: bit for bit
    ``bundle_adjust_core`` in one call."""
    monkeypatch.setattr(tba, "ITER_CHUNK", chunk)
    args = _ba_args()
    kw = dict(iters=iters, cg_iters=20,
              longest_cam=segment.longest_segment(args[2].numpy(), 6),
              longest_pt=segment.longest_segment(args[3].numpy(), 300))
    _equal(tba.bundle_adjust(*args, FX, FY, CX, CY, **kw),
           tba.bundle_adjust_core(*args, FX, FY, CX, CY, iters=iters,
                                  cg_iters=20))


@pytest.mark.parametrize("use_huber", [True, False])
def test_bundle_adjust_chunked_matches_jax(use_huber):
    """The chunked BA with host-given segments against the JAX
    package's, with test_torch_loop.test_bundle_adjust's bars: poses and
    points within 1e-3, inlier flags on >= 99% of observations."""
    args = _ba_args()
    rt = tba.bundle_adjust(
        *args, FX, FY, CX, CY, iters=10, cg_iters=20, use_huber=use_huber,
        longest_cam=segment.longest_segment(args[2].numpy(), 6),
        longest_pt=segment.longest_segment(args[3].numpy(), 300))
    rj = jba.bundle_adjust(*[jnp.asarray(a.numpy()) for a in args], FX, FY,
                           CX, CY, iters=10, cg_iters=20, use_huber=use_huber)
    _close(rt.cam_Tcw, rj.cam_Tcw, 1e-3)
    _close(rt.points, rj.points, 1e-3)
    assert (rt.obs_inlier.numpy() == np.asarray(rj.obs_inlier)).mean() >= 0.99


def _pose_graph_args(seed=6, K=24, E=64):
    """test_torch_loop.test_optimize_pose_graph's circuit: odometry edges
    from the true poses, one loop edge, drifted starts, padded edges of
    weight 0."""
    rng = np.random.default_rng(seed)
    true = tsim3.exp(torch.from_numpy(_rand_sims(rng, K, scale_sd=0.05)))
    ei = np.r_[np.arange(K - 1), K - 1, np.zeros(E - K, int)]
    ej = np.r_[np.arange(1, K), 0, np.zeros(E - K, int)]
    meas = tsim3.compose(true[ej], tsim3.inv(true[ei])).numpy()
    w = np.r_[np.ones(K), np.zeros(E - K)].astype(np.float32)
    drift = torch.from_numpy(np.cumsum(rng.normal(0, 0.02, (K, 7)), 0)
                             .astype(np.float32))
    drift[:, 6] *= 0.1
    sims0 = tsim3.compose(tsim3.exp(drift), true).numpy()
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return [sims0, ei.astype(np.int32), ej.astype(np.int32), meas, w, fixed]


@pytest.mark.parametrize("chunk", [1, 6])
@pytest.mark.parametrize("iters", [0, 20])
def test_pose_graph_chunks_equal_one_call(monkeypatch, chunk, iters):
    """``optimize_pose_graph`` in chunks of 1 or 6 LM iterations (with
    a remainder), (sims, lam) threaded, ``longest`` from the host: bit
    for bit ``optimize_pose_graph_core`` in one call."""
    monkeypatch.setattr(tpg, "ITER_CHUNK", chunk)
    args = [torch.from_numpy(a) for a in _pose_graph_args()]
    longest = segment.longest_segment(
        np.concatenate([args[1].numpy(), args[2].numpy()]), 24)
    _equal(tpg.optimize_pose_graph(*args, iters=iters, cg_iters=30,
                                   longest=longest),
           tpg.optimize_pose_graph_core(*args, iters=iters, cg_iters=30))


def test_pose_graph_chunked_matches_jax():
    """The chunked essential graph on a 32-vertex circuit with 256
    edges (224 of them padding) against the JAX package's, with
    test_torch_loop.test_optimize_pose_graph's bar: every vertex within
    1e-3 (rotation matrix, translation, scale)."""
    args = _pose_graph_args(seed=11, K=32, E=256)
    rt = tpg.optimize_pose_graph(*[torch.from_numpy(a) for a in args],
                                 iters=20, cg_iters=30)
    rj = jpg.optimize_pose_graph(*[jnp.asarray(a) for a in args],
                                 iters=20, cg_iters=30)
    _close(tsim3.rot(rt.sims), jsim3.rot(rj.sims), 1e-3)
    _close(rt.sims[:, 4:], rj.sims[:, 4:], 1e-3)


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_sim3_rounds(monkeypatch, fix_scale, chunk):
    """``optimize_sim3`` with each round run ``chunk`` LM iterations a
    step program ((S12, lam) threaded, a remainder for 3) and the
    pruning between the rounds a tensor mask: bit for bit each round in
    one call of ``lm_round`` (``ROUND_CHUNK`` = 8 iterations), and
    within test_torch_loop.test_optimize_sim3's bars of the JAX package
    (S12 1e-3 through R, t, s; inliers within one)."""
    pr = _sim3_problem(4, scale=1.0 if fix_scale else 1.1)
    init = tsim3.compose(tsim3.exp(torch.tensor(
        [0.05, -0.03, 0.02, 0.01, 0.0, -0.01, 0.0])),
        torch.from_numpy(pr["S12"])).numpy()
    isig = (1.0 / pr["sig2"]).astype(np.float32)
    args = [init] + [pr[k] for k in ("p1", "p2", "uv1", "uv2")] + [
        isig, isig, pr["valid"]]
    targs = [torch.from_numpy(a) for a in args]
    monkeypatch.setattr(tso, "ROUND_CHUNK", 8)
    want = tso.optimize_sim3(*targs, FX, FY, CX, CY, iters=8,
                             fix_scale=fix_scale)
    monkeypatch.setattr(tso, "ROUND_CHUNK", chunk)
    rt = tso.optimize_sim3(*targs, FX, FY, CX, CY, iters=8,
                           fix_scale=fix_scale)
    _equal(rt, want)
    rj = jso.optimize_sim3(*[jnp.asarray(a) for a in args], FX, FY, CX, CY,
                           iters=8, fix_scale=fix_scale)
    _close(tsim3.rot(rt.S12), jsim3.rot(rj.S12), 1e-3)
    _close(rt.S12[4:], rj.S12[4:], 1e-3)
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 1


# ----------------------------------------------------------------------
# the mesh constructors take the CPU only when asked
# ----------------------------------------------------------------------
def test_mesh_constructors_raise_without_a_card(monkeypatch):
    """Without a card, ``make_mesh()`` and ``make_global_mesh()`` raise
    instead of meshing over the CPU; ``device="cpu"`` or a list of CPU
    devices gives the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.make_global_mesh()
    assert parallel.make_mesh(device="cpu").devices == [torch.device("cpu")]
    assert parallel.make_mesh(["cpu"] * 2).devices == [torch.device("cpu")] * 2
