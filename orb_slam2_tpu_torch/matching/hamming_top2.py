"""256-bit Hamming top-2 searches: kernels K2, K3 and K4.

Port of ``orb_slam2_tpu/matching/pallas_hamming.py`` (the
``masked_top2_mutual`` / ``masked_top2_epi`` / ``hamming_top2`` Pallas
kernels and their XLA twins).

K4, :func:`hamming_top2`, is the unmasked search with column validity:
(best, best_idx, second) per row.  No pipeline stage calls it, in the
port as in the JAX package.

K2 and K3 are the inner loop of every projection and epipolar search:
for each row, the best and second-best admissible column by Hamming
distance, and for each column its best row, with no (N, M) matrix on
the card.

Distances and indices travel as packed keys, so a plain min reproduces
argmin's lowest-index tie-break:

    best_key[i]   = d * COL_STRIDE + col
    second_key[i] = the same for the runner-up (the best column itself
                    counts as masked, MASK_D * COL_STRIDE + best)
    col_key[j]    = d * ROW_STRIDE + row

with d == MASK_D (1023) for a masked pair.  Keys are int32; they need
M <= COL_STRIDE and N <= ROW_STRIDE, which both the kernels' wrappers
and the plain versions check (the JAX twins alias past those limits).

On a CUDA tensor :func:`masked_top2_mutual` / :func:`masked_top2_epi`
launch the hand-written kernels of ``csrc/hamming_top2.cu``; on a CPU
tensor they run :func:`masked_top2_mutual_plain` /
:func:`masked_top2_epi_plain`.
"""
from __future__ import annotations

import torch

from .. import kernels
from . import core

TILE = 128           # row/column multiple the kernels take
BIG = 1 << 20        # K4: added to the distance of an invalid column
MASK_D = 1023        # masked-pair distance sentinel (real max is 256)
COL_STRIDE = 4096    # key = d * COL_STRIDE + col  (requires M <= 4096)
ROW_STRIDE = 16384   # colkey = d * ROW_STRIDE + row (requires N <= 16384)


def _check_sizes(n: int, m: int) -> None:
    if m > COL_STRIDE or n > ROW_STRIDE:
        raise ValueError(
            f"masked top-2 keys need M <= {COL_STRIDE} and N <= "
            f"{ROW_STRIDE}, got N={n}, M={m}")


def _keys_plain(ok: torch.Tensor, desc1, desc2):
    """Packed keys from the (N, M) admissibility mask (plain version)."""
    n, m = ok.shape
    d = core.hamming_matrix(desc1, desc2)
    dm = torch.where(ok, d, torch.full_like(d, MASK_D))
    cols = torch.arange(m, dtype=torch.int32, device=d.device)[None, :]
    rows = torch.arange(n, dtype=torch.int32, device=d.device)[:, None]
    key = dm * COL_STRIDE + cols
    ckey = dm * ROW_STRIDE + rows
    bkey = key.amin(dim=1)
    key2 = torch.where(key == bkey[:, None], MASK_D * COL_STRIDE + cols, key)
    return bkey, key2.amin(dim=1), ckey.amin(dim=0)


def masked_top2_mutual_plain(desc1, desc2, row_attr, col_attr):
    """Plain PyTorch version of K2 (the port of
    ``masked_top2_mutual_xla``).

    desc1 (N, 8), desc2 (M, 8) int32; row_attr (N, 6) float32
    [u, v, radius, lvl_min, lvl_max, valid]; col_attr (M, 4) float32
    [x, y, octave, valid].  Returns (best_key (N,), second_key (N,),
    col_key (M,)) int32."""
    _check_sizes(desc1.shape[0], desc2.shape[0])
    ux, uy, rad, lmin, lmax, rval = [row_attr[:, k][:, None] for k in range(6)]
    cx, cy, coct, cval = [col_attr[:, k][None, :] for k in range(4)]
    ok = ((rval > 0) & (cval > 0)
          & ((ux - cx).abs() <= rad) & ((uy - cy).abs() <= rad)
          & (coct >= lmin) & (coct <= lmax))
    return _keys_plain(ok, desc1, desc2)


def masked_top2_epi_plain(desc1, desc2, row_attr, col_attr):
    """Plain PyTorch version of K3 (the port of ``masked_top2_epi_xla``).

    row_attr (N, 4) float32 [la, lb, lc, valid] with the epipolar line
    pre-normalized by 1/sqrt(la^2+lb^2); col_attr (M, 4) float32
    [x, y, chi2_threshold, valid].  The line test rounds each product
    and sum separately: ((la*x + lb*y) + lc)^2 < thr."""
    _check_sizes(desc1.shape[0], desc2.shape[0])
    la, lb, lc, rval = [row_attr[:, k][:, None] for k in range(4)]
    kx, ky, thr, cval = [col_attr[:, k][None, :] for k in range(4)]
    e = la * kx + lb * ky + lc
    ok = (rval > 0) & (cval > 0) & (e * e < thr)
    return _keys_plain(ok, desc1, desc2)


def _launch(name: str, desc1, desc2, row_attr, col_attr, n_row_attr: int):
    """Validate and launch K2 / K3 on CUDA tensors."""
    n, m = desc1.shape[0], desc2.shape[0]
    _check_sizes(n, m)
    if n % TILE or m % TILE:
        raise ValueError(f"{name} takes N and M in multiples of {TILE}, "
                         f"got N={n}, M={m}")
    expect = ((desc1, (n, 8), torch.int32), (desc2, (m, 8), torch.int32),
              (row_attr, (n, n_row_attr), torch.float32),
              (col_attr, (m, 4), torch.float32))
    for t, shape, dtype in expect:
        if not t.is_cuda or t.device != desc1.device:
            raise ValueError(f"{name}: every operand must be on one CUDA "
                             f"device")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    desc1, desc2, row_attr, col_attr = (t.contiguous() for t in
                                        (desc1, desc2, row_attr, col_attr))
    bkey = torch.empty(n, dtype=torch.int32, device=desc1.device)
    skey = torch.empty(n, dtype=torch.int32, device=desc1.device)
    ckey = torch.full((m,), 2 ** 31 - 1, dtype=torch.int32,
                      device=desc1.device)
    kernels.call(name, desc1, desc2, row_attr, col_attr, n, m,
                 bkey, skey, ckey)
    return bkey, skey, ckey


def masked_top2_mutual(desc1, desc2, row_attr, col_attr):
    """K2: the windowed top-2 search.  Same contract as
    :func:`masked_top2_mutual_plain`; CUDA tensors launch the kernel
    (N, M multiples of 128), CPU tensors run the plain version."""
    if desc1.is_cuda:
        return _launch("masked_top2_mutual", desc1, desc2, row_attr,
                       col_attr, 6)
    return masked_top2_mutual_plain(desc1, desc2, row_attr, col_attr)


def masked_top2_epi(desc1, desc2, row_attr, col_attr):
    """K3: the epipolar top-2 search.  Same contract as
    :func:`masked_top2_epi_plain`; CUDA tensors launch the kernel,
    CPU tensors run the plain version."""
    if desc1.is_cuda:
        return _launch("masked_top2_epi", desc1, desc2, row_attr,
                       col_attr, 4)
    return masked_top2_epi_plain(desc1, desc2, row_attr, col_attr)


# ----------------------------------------------------------------------
# K4: unmasked top-2 with column validity
# ----------------------------------------------------------------------
def hamming_top2_plain(desc1, desc2, valid2):
    """Plain PyTorch version of K4, with the TPU kernel's semantics
    (``pallas_hamming._kernel``): an invalid column's distance is
    ``d + BIG``, so a row with no valid column returns ``BIG + d`` at its
    lowest-index argmin, and ``second`` never exceeds ``BIG`` (the
    kernel puts BIG at each tile's argmin).  The JAX package's XLA twin
    writes BIG exactly instead; the two agree on every row with >= 2
    valid columns.

    desc1 (N, 8), desc2 (M, 8) int32; valid2 (M,) bool.  Returns
    (best (N,), best_idx (N,), second (N,)) int32; ties go to the
    lowest column."""
    d = core.hamming_matrix(desc1, desc2)
    d = d + torch.where(valid2, 0, BIG).to(torch.int32)[None, :]
    best, idx = core._min_lowest(d, dim=1)
    rows = torch.arange(d.shape[0], device=d.device)
    d[rows, idx] = BIG
    second = torch.clamp(d.amin(dim=1), max=BIG)
    return best, idx.to(torch.int32), second


def hamming_top2(desc1, desc2, valid2):
    """K4: the fused Hamming top-2.  Same contract as
    :func:`hamming_top2_plain`; N and M must be multiples of 128 (as the
    TPU kernel asks).  CUDA tensors launch the kernel of
    ``csrc/hamming_top2.cu``, CPU tensors run the plain version."""
    n, m = desc1.shape[0], desc2.shape[0]
    if n % TILE or m % TILE:
        raise ValueError(f"hamming_top2 takes N and M in multiples of "
                         f"{TILE}, got N={n}, M={m}")
    if not desc1.is_cuda:
        return hamming_top2_plain(desc1, desc2, valid2)
    expect = ((desc1, (n, 8), torch.int32), (desc2, (m, 8), torch.int32),
              (valid2, (m,), torch.bool))
    for t, shape, dtype in expect:
        if not t.is_cuda or t.device != desc1.device:
            raise ValueError("hamming_top2: every operand must be on one "
                             "CUDA device")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"hamming_top2: expected {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    desc1, desc2 = desc1.contiguous(), desc2.contiguous()
    v2 = valid2.to(torch.int32).contiguous()
    best, idx, second = (torch.empty(n, dtype=torch.int32,
                                     device=desc1.device) for _ in range(3))
    kernels.call("hamming_top2", desc1, desc2, v2, n, m, best, idx, second)
    return best, idx, second


# the JAX package's backend-dispatching name for the same search
hamming_top2_auto = hamming_top2
