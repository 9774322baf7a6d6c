"""256-bit Hamming top-2 searches: kernels K2, K3 and K4.

Port of ``orb_slam2_tpu/matching/pallas_hamming.py`` (the
``masked_top2_mutual`` / ``masked_top2_epi`` / ``hamming_top2`` Pallas
kernels and their XLA twins).

K4, :func:`hamming_top2`, is the unmasked search with column validity:
(best, best_idx, second) per row.  No pipeline stage calls it, in the
port as in the JAX package.  On a CUDA tensor it launches the same
tensor-core kernel as K2/K3 with no gate (``csrc/masked_top2.cu``).

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
launch the hand-written kernel of ``csrc/masked_top2.cu`` (distances on
the tensor cores as a +-1 int8 product, laid out as
:func:`pm1_operand` shows; the columns cut into as many splits as fill
the card, merged inside the launch); on a CPU tensor they run
:func:`masked_top2_mutual_plain` / :func:`masked_top2_epi_plain`.
"""
from __future__ import annotations

import functools

import torch

from .. import kernels
from . import core

TILE = 128           # row/column multiple the kernels take
BIG = 1 << 20        # K4: added to the distance of an invalid column
K4_MAX_COLS = 1 << 21  # K4: key = (d + 257 * invalid) * 2^21 + col
MASK_D = 1023        # masked-pair distance sentinel (real max is 256)
COL_STRIDE = 4096    # key = d * COL_STRIDE + col  (requires M <= 4096)
ROW_STRIDE = 16384   # colkey = d * ROW_STRIDE + row (requires N <= 16384)
INT_MAX = 2 ** 31 - 1


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


def pm1_operand(desc):
    """Plain version of the operand layout K2/K3 stage for the tensor
    cores: (N, 8) int32 descriptors -> (N, 256) int8, +1 for a set bit
    and -1 for a clear one, so that ``256 - a @ b.T == 2 * hamming``.
    Within word w, bits 0-3 of byte t go to k = 32w + 4t + 0..3 and
    bits 4-7 to k = 32w + 16 + 4t + 0..3: the k order of one thread's
    mma.m16n8k32 fragment, so that a byte feeds one 8-byte load."""
    shifts = torch.arange(32, dtype=torch.int64, device=desc.device)
    bits = (desc.to(torch.int64)[:, :, None] >> shifts) & 1   # (N, 8, 32)
    t = torch.arange(4).repeat_interleave(8)     # byte of bit position b
    i = torch.arange(32) % 8                     # bit within that byte
    k = t * 4 + torch.where(i < 4, i, i - 4 + 16)
    out = torch.empty_like(bits)
    out[:, :, k.to(desc.device)] = bits
    return (out * 2 - 1).to(torch.int8).reshape(desc.shape[0], 256)


@functools.lru_cache(maxsize=None)
def _splits(index: int, n: int, m: int) -> int:
    return kernels.masked_top2_splits(index, n, m)


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
    dev = desc1.device
    splits = _splits(dev.index, n, m)
    bkey = torch.empty(n, dtype=torch.int32, device=dev)
    skey = torch.empty(n, dtype=torch.int32, device=dev)
    # the column keys, then one arrival counter per row tile
    ckey = torch.full((m + n // TILE,), INT_MAX, dtype=torch.int32,
                      device=dev)
    part = torch.empty(2 * splits * n, dtype=torch.int32, device=dev)
    kernels.call(name, desc1, desc2, row_attr, col_attr, n, m, splits,
                 bkey, skey, ckey, part, shape=(n, m))
    return bkey, skey, ckey[:m]


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
    TPU kernel asks) and M <= ``K4_MAX_COLS`` (2^21 = 2,097,152: the
    kernel packs (distance, column) into an int32 key).  CUDA tensors
    launch the kernel of ``csrc/masked_top2.cu`` (K2/K3's tensor-core
    search without a gate), CPU tensors run the plain version."""
    n, m = desc1.shape[0], desc2.shape[0]
    if n % TILE or m % TILE:
        raise ValueError(f"hamming_top2 takes N and M in multiples of "
                         f"{TILE}, got N={n}, M={m}")
    if m > K4_MAX_COLS:
        raise ValueError(f"hamming_top2 keys need M <= {K4_MAX_COLS}, "
                         f"got M={m}")
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
    desc1, desc2, valid2 = (t.contiguous() for t in (desc1, desc2, valid2))
    dev = desc1.device
    splits = _splits(dev.index, n, m)
    best, idx, second = (torch.empty(n, dtype=torch.int32, device=dev)
                         for _ in range(3))
    # one arrival counter per row tile
    counters = torch.full((n // TILE,), INT_MAX, dtype=torch.int32,
                          device=dev)
    part = torch.empty(2 * splits * n, dtype=torch.int32, device=dev)
    kernels.call("hamming_top2", desc1, desc2, valid2, n, m, splits, best,
                 idx, second, counters, part, shape=(n, m))
    return best, idx, second


# the JAX package's backend-dispatching name for the same search
hamming_top2_auto = hamming_top2
