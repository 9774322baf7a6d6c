"""Symmetric eigendecomposition of small blocks by cyclic Jacobi
rotations, in tensor operations.

On the card ``torch.linalg.eigh`` (cuSOLVER) checks its result on the
host, which a CUDA graph cannot hold.  The solvers' small symmetric
blocks (Horn's 4x4 ``N``, EPnP's 3x3 covariances and 12x12 ``M^T M``)
are therefore diagonalized by a fixed number of Jacobi sweeps (Golub &
Van Loan 8.5).  A sweep rotates every off-diagonal pair to zero once, in
the round-robin order of a parallel Jacobi method: each round rotates
``n // 2`` disjoint pairs at once as one orthogonal matrix ``J`` (``A <-
J^T A J``, ``V <- V J``), so a sweep is ``n - 1`` rounds (``n`` for odd
``n``) of a few batched operations.  Convergence is quadratic once the
off-diagonal mass is small; callers run in float64.
"""
from __future__ import annotations

import functools

import torch


def _schedule(n: int):
    """Round-robin rounds of disjoint pairs (p < q) of ``range(n)`` that
    together hold every pair once (for odd ``n`` one index rests in each
    round)."""
    m = n + n % 2
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        pairs = []
        for k in range(m // 2):
            a, b = players[k], players[m - 1 - k]
            if a < n and b < n:
                pairs.append((min(a, b), max(a, b)))
        rounds.append(pairs)
        players = [players[0], players[-1]] + players[1:-1]
    return rounds


@functools.lru_cache(maxsize=None)
def _round_tables(n: int, dtype, device):
    """Per round: the flat indices of (a_pp, a_qq, a_pq) of its pairs
    (3k,), and the (2k, n*n) rows that build its rotation from (c - 1,
    s): c - 1 onto e_p e_p^T + e_q e_q^T, s onto e_p e_q^T - e_q e_p^T.
    Made once per device (a CUDA graph replays the cached tensors)."""
    tables = []
    for pairs in _schedule(n):
        k = len(pairs)
        idx = torch.tensor([p * n + p for p, _ in pairs]
                           + [q * n + q for _, q in pairs]
                           + [p * n + q for p, q in pairs])
        basis = torch.zeros(2 * k, n, n, dtype=dtype)
        for i, (p, q) in enumerate(pairs):
            basis[i, p, p] = basis[i, q, q] = 1.0
            basis[k + i, p, q], basis[k + i, q, p] = 1.0, -1.0
        tables.append((k, idx.to(device), basis.reshape(2 * k, n * n)
                       .to(device)))
    return tables


def sym_eigh(A: torch.Tensor, sweeps: int):
    """Eigenvalues (..., n), ascending, and unit eigenvectors (..., n, n)
    as columns to match, of symmetric blocks (..., n, n), after
    ``sweeps`` Jacobi sweeps: ``torch.linalg.eigh``'s layout.  The
    vectors' signs, and the basis of a repeated eigenvalue's space, may
    differ from LAPACK's."""
    n = A.shape[-1]
    dt, dev = A.dtype, A.device
    batch = A.shape[:-2]
    eye = torch.eye(n, dtype=dt, device=dev)
    V = eye.expand(A.shape)
    for _ in range(sweeps):
        for k, idx, basis in _round_tables(n, dt, dev):
            app, aqq, apq = A.reshape(batch + (n * n,)).index_select(
                -1, idx).split(k, -1)
            zero = apq == 0
            theta = (aqq - app) / (2.0 * torch.where(
                zero, torch.ones_like(apq), apq))
            # the smaller root of t^2 + 2 t theta - 1 = 0 (|angle| <= pi/4)
            t = torch.copysign(1.0 / (theta.abs()
                                      + torch.sqrt(theta * theta + 1.0)),
                               theta)
            t = torch.where(zero, torch.zeros_like(t), t)
            c = torch.rsqrt(t * t + 1.0)
            J = eye + (torch.cat([c - 1.0, t * c], -1) @ basis).reshape(
                batch + (n, n))
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    w, order = torch.sort(torch.diagonal(A, dim1=-2, dim2=-1), dim=-1)
    return w, torch.gather(V, -1, order[..., None, :].expand(V.shape))


def lapack_eigh(A: torch.Tensor):
    """``torch.linalg.eigh`` of symmetric blocks (..., n, n) on the CPU,
    where the card runs :func:`sym_eigh`, with NaN eigenvalues and
    eigenvectors for every block that holds a non-finite entry, as
    ``jnp.linalg.eigh`` returns them (a degenerate RANSAC sample's
    block; the callers score and drop such hypotheses).  LAPACK raises
    for the whole batch on such a block, so each one is replaced by the
    identity before the call and its results by NaN after it; LAPACK
    diagonalizes each block alone, so every finite block's result is
    the one it gets without the others, bit for bit."""
    bad = ~torch.isfinite(A).all(-1).all(-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    w, v = torch.linalg.eigh(torch.where(bad[..., None, None], eye, A))
    nan = torch.full((), float("nan"), dtype=A.dtype, device=A.device)
    return (torch.where(bad[..., None], nan, w),
            torch.where(bad[..., None, None], nan, v))
