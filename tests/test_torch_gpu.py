"""The hand-written CUDA kernels (K1, K2, K3, K4) against their plain
PyTorch versions on the card; the solvers' per-target sums
(``optim.segment.IndexSum``) against ``index_add_`` on the CPU; the
pipelined tracker's pinned result copies and the repeatability of a
pipelined run; and the estimated-pose solvers (pose optimization, EPnP
RANSAC, the two-view initializer) against the port's own CPU results.
Every test here is marked ``gpu`` and skips without a CUDA device.  This file imports no jax, so it runs on a
machine without the JAX package:

    python3 -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(``--noconftest`` skips tests/conftest.py, which sets up JAX)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from orb_slam2_tpu_torch import kernels
from orb_slam2_tpu_torch.geom import se3, twoview
from orb_slam2_tpu_torch.geom.camera import Intrinsics
from orb_slam2_tpu_torch.matching import hamming_top2 as ht
from orb_slam2_tpu_torch.ops import fast as tfast, pyramid as tpyr
from orb_slam2_tpu_torch.ops.extractor import OrbParams
from orb_slam2_tpu_torch.optim import pnp, pose_opt
from orb_slam2_tpu_torch.optim.segment import IndexSum
from orb_slam2_tpu_torch.pipeline.config import SlamConfig
from orb_slam2_tpu_torch.pipeline.system import System
from orb_slam2_tpu_torch.pipeline.tracking import _Readback
from orb_slam2_tpu_torch.utils import synth

torch.set_num_threads(1)


def _rand_desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _arc_extreme(r, inner, outer):
    """Over the circular 16-axis of ``r`` (16 tensors): ``inner`` over
    each run of 9, ``outer`` over the 16 runs, in the kernel's order
    (van Herk / Gil-Werman: each run a block suffix joined to a block
    prefix, blocks [0..8], [9..17], [18..26] mod 16)."""
    s0 = [r[8]]                            # s0[-1 - i] = inner(r[8-i..8])
    for k in range(7, -1, -1):
        s0.insert(0, inner(r[k], s0[0]))
    p1 = [r[9]]                            # p1[j] = inner(r[9..9+j])
    for j in range(1, 8):
        p1.append(inner(p1[-1], r[(9 + j) % 16]))
    s1 = [r[1]]                            # s1[k] = inner(r[9+k..17])
    for k in range(7, -1, -1):
        s1.insert(0, inner(r[(9 + k) % 16], s1[0]))
    p2 = [r[2]]                            # p2[j] = inner(r[18..18+j])
    for j in range(1, 6):
        p2.append(inner(p2[-1], r[2 + j]))
    runs = ([s0[0]] + [inner(s0[k], p1[k - 1]) for k in range(1, 9)]
            + [s1[0]] + [inner(s1[k - 9], p2[k - 10]) for k in range(10, 16)])
    w = 8
    while w:
        runs = [outer(runs[k], runs[k + w]) for k in range(w)] + runs[w:]
        w //= 2
    return runs[0]


def _fast_score_folded(image):
    """Plain mirror of K1's arithmetic (csrc/fast_score.cu): the arc
    extremes A = max_k min_arc r and B = min_k max_arc r on the bf16
    pixels, then max(bf16(A - p), -bf16(B - p)) with each difference in
    float32.  Wraps at the edges as ``fast_score_map`` does.  The last
    max orders -0 below +0, as ``jnp.maximum`` does (``torch.maximum``
    picks between +0 and -0 by argument order and size)."""
    im = image.to(torch.bfloat16)
    r = [torch.roll(im, (-dy, -dx), dims=(0, 1)) for dy, dx in tfast.CIRCLE]
    a = _arc_extreme(r, torch.minimum, torch.maximum)
    b = _arc_extreme(r, torch.maximum, torch.minimum)
    p = im.float()
    bright = (a.float() - p).to(torch.bfloat16)
    dark = -(b.float() - p).to(torch.bfloat16)
    score = torch.maximum(bright, dark)
    plus_zero = ((bright == 0) & (dark == 0)
                 & ~(torch.signbit(bright) & torch.signbit(dark)))
    return torch.where(plus_zero, torch.zeros_like(score), score).float()


def _adversarial_image(rng, shape):
    """255 beside values below 2^-10: fl32(r - p) itself rounds before
    the bf16 rounding, so a single rounding would differ."""
    img = rng.integers(0, 256, shape).astype(np.float32)
    img[rng.random(shape) < 0.4] = 255.0
    tiny = rng.random(shape) < 0.3
    img[tiny] = rng.uniform(2.0 ** -24, 2.0 ** -10, int(tiny.sum()))
    return img


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _window_problem(seed, n, m):
    """Rows are noisy copies of random columns, so windows and level
    bands admit real near matches."""
    rng = np.random.default_rng(seed)
    d2 = _rand_desc(rng, m)
    src = rng.integers(0, m, n)
    bits = np.unpackbits(d2[src].view(np.uint8), axis=1)
    bits ^= (rng.random(bits.shape) < rng.uniform(0, 0.3, (n, 1))).astype(np.uint8)
    d1 = np.packbits(bits, axis=1).view(np.uint32)
    cxy = rng.uniform(0, 200, (m, 2)).astype(np.float32)
    coct = rng.integers(0, 4, m)
    roct = coct[src]
    uv = cxy[src] + rng.normal(0, 2, (n, 2)).astype(np.float32)
    row_attr = np.stack([uv[:, 0], uv[:, 1], rng.uniform(2, 12, n),
                         roct - 1, roct + 1, rng.random(n) > 0.1],
                        1).astype(np.float32)
    col_attr = np.stack([cxy[:, 0], cxy[:, 1], coct, rng.random(m) > 0.1],
                        1).astype(np.float32)
    return d1, d2, row_attr, col_attr


def _epi_problem(seed, n, m):
    rng = np.random.default_rng(seed)
    d1, d2, _, _ = _window_problem(seed, n, m)
    kxy = rng.uniform(0, 200, (m, 2)).astype(np.float32)
    ang = rng.uniform(0, np.pi, n)
    a, b = np.cos(ang), np.sin(ang)
    c = -(a * rng.uniform(0, 200, n) + b * rng.uniform(0, 200, n))
    row_attr = np.stack([a, b, c, rng.random(n) > 0.1], 1).astype(np.float32)
    col_attr = np.stack([kxy[:, 0], kxy[:, 1],
                         3.84 * 1.44 ** rng.integers(0, 4, m),
                         rng.random(m) > 0.1], 1).astype(np.float32)
    return d1, d2, row_attr, col_attr


def _both(fn, args):
    """One call of K2/K3 (exactly one launch) against its plain version,
    bit for bit; returns the kernel's keys."""
    name = f"masked_top2_{fn}"
    before = kernels.LAUNCHES[name]
    k = getattr(ht, name)(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    p = getattr(ht, f"{name}_plain")(*args)
    for a, b, what in zip(k, p, ("best", "second", "column")):
        assert torch.equal(a, b), f"{what} keys: {(a != b).sum().item()} differ"
    return k


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: python3 -m pytest "
                    "tests/test_torch_gpu.py -m gpu --noconftest)")
    return torch.device("cuda")


@pytest.mark.gpu
class TestKernelsOnCard:
    """Bar: bit-exact (K1 on the interior), as on the CPU."""

    @pytest.mark.parametrize("shape", [(40, 70), (1440, 1920), (402, 536)])
    def test_fast_score(self, cuda, shape):
        rng = np.random.default_rng(shape[0])
        img = torch.as_tensor(rng.integers(0, 256, shape).astype(np.float32),
                              device=cuda)
        for lvl in tpyr.build_pyramid(img, 3, 1.2):
            n0 = kernels.LAUNCHES["fast_score"]
            k = tfast.score_map(lvl)
            assert kernels.LAUNCHES["fast_score"] == n0 + 1
            p = tfast.fast_score_map(lvl)
            assert torch.equal(k[3:-3, 3:-3], p[3:-3, 3:-3])

    @pytest.mark.parametrize("n,m", [(256, 384), (4096, 4096), (16384, 4096),
                                     (128, 128), (128, 4096), (4096, 128)])
    def test_masked_top2_mutual(self, cuda, n, m):
        _both("mutual", [_t(a).to(cuda) for a in _window_problem(n, n, m)])

    @pytest.mark.parametrize("n,m", [(128, 256), (4096, 4096), (128, 128),
                                     (128, 4096), (4096, 128), (16384, 4096)])
    def test_masked_top2_epi(self, cuda, n, m):
        _both("epi", [_t(a).to(cuda) for a in _epi_problem(n, n, m)])

    @pytest.mark.parametrize("n,m", [(128, 128), (256, 4096), (4096, 384)])
    def test_hamming_top2(self, cuda, n, m):
        rng = np.random.default_rng(n + m)
        d1, d2 = _rand_desc(rng, n), _rand_desc(rng, m)
        d1[: n // 2] = d2[rng.integers(0, m, n // 2)]
        v2 = rng.random(m) > 0.2
        if n == 128:
            v2[:] = False          # every row without a valid column
        args = (_t(d1).to(cuda), _t(d2).to(cuda), torch.from_numpy(v2).to(cuda))
        before = kernels.LAUNCHES["hamming_top2"]
        out = ht.hamming_top2(*args)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["hamming_top2"] == before + 1
        for o, r in zip(out, ht.hamming_top2_plain(*args)):
            assert torch.equal(o, r)

    def test_wrapper_checks(self, cuda):
        d = torch.zeros((128, 8), dtype=torch.int32, device=cuda)
        ra = torch.zeros((128, 6), device=cuda)
        ca = torch.zeros((128, 4), device=cuda)
        with pytest.raises(ValueError):     # row count not a multiple
            ht.masked_top2_mutual(d[:100], d, ra[:100], ca)
        with pytest.raises(ValueError):     # wrong dtype
            ht.masked_top2_mutual(d.float(), d, ra, ca)
        with pytest.raises(ValueError):     # mixed devices
            ht.masked_top2_mutual(d, d.cpu(), ra, ca)


def _pass_all(fn, n, m, rng):
    """Attributes that admit every pair (a few rows and columns
    invalid)."""
    rval = rng.random(n) > 0.05
    cval = rng.random(m) > 0.05
    if fn == "mutual":
        ra = np.stack([np.zeros(n), np.zeros(n), np.full(n, 1e6),
                       np.full(n, -1), np.full(n, 9), rval], 1)
        ca = np.stack([rng.uniform(0, 100, m), rng.uniform(0, 100, m),
                       rng.integers(0, 8, m), cval], 1)
    else:   # the line x = 0, every column on it
        ra = np.stack([np.ones(n), np.zeros(n), np.zeros(n), rval], 1)
        ca = np.stack([np.zeros(m), rng.uniform(0, 100, m), np.ones(m),
                       cval], 1)
    return ra.astype(np.float32), ca.astype(np.float32)


def _last_split_begin(n, m):
    """First column of the kernel's last column split at shape (n, m):
    the split count is the kernel's own choice for this card, and a
    split is a run of whole 32-column chunks."""
    s = kernels.masked_top2_splits(0, n, m)
    return (s - 1) * (m // 32) // s * 32


@pytest.mark.gpu
class TestMaskedTop2Edges:
    """The tensor-core design's edges for K2 (mutual) and K3 (epi):
    column splits merged inside the launch, row tiles, ties.  Bar:
    bit-exact against the plain versions, one launch per call (the
    shapes 128x128 to 16384x4096 are TestKernelsOnCard's)."""

    @pytest.mark.parametrize("fn", ["mutual", "epi"])
    @pytest.mark.parametrize("n,m", [(256, 384), (4096, 4096),
                                     (16384, 4096)])
    def test_ties_across_splits_and_tiles(self, cuda, fn, n, m):
        """64 distinct descriptors repeat along the columns (ties in
        every split) and 128 along the rows (ties in every row tile):
        the lowest column and the lowest row must win."""
        rng = np.random.default_rng(n + m)
        base = _rand_desc(rng, 128)
        d2 = np.tile(base[:64], (m // 64, 1))
        d1 = np.tile(base, (n // 128, 1))
        d1[: n // 2] ^= (rng.random((n // 2, 8)) < 0.01).astype(np.uint32)
        ra, ca = _pass_all(fn, n, m, rng)
        k = _both(fn, [_t(a).to(cuda) for a in (d1, d2, ra, ca)])
        bd = k[0] // ht.COL_STRIDE
        assert bool((bd[(k[1] // ht.COL_STRIDE) == bd] < ht.MASK_D).any())

    @pytest.mark.parametrize("fn", ["mutual", "epi"])
    @pytest.mark.parametrize("n,m", [(4096, 4096), (128, 4096), (256, 384)])
    def test_rows_admitting_none_or_one_in_last_split(self, cuda, fn, n, m):
        """Only the last split's columns sit where rows look, one spot
        per column: a third of the rows admit exactly one column there,
        a third none, a third the whole last split."""
        rng = np.random.default_rng(n * 3 + m)
        d1, d2 = _rand_desc(rng, n), _rand_desc(rng, m)
        j0 = _last_split_begin(n, m)
        cx = np.zeros(m)
        cx[j0:] = 1000.0 + 10.0 * np.arange(m - j0)
        pick = rng.integers(j0, m, n)
        kind = np.arange(n) % 3          # 0: one, 1: none, 2: the split
        half = 5.0 * (m - j0)            # the last split spans 2 * half
        if fn == "mutual":
            x = np.where(kind == 0, cx[pick],
                         np.where(kind == 1, -5000.0, 1000.0 + half))
            rad = np.where(kind == 2, half + 1.0, 1.0)
            ra = np.stack([x, np.zeros(n), rad, np.full(n, -1),
                           np.full(n, 9), np.ones(n)], 1)
            ca = np.stack([cx, np.zeros(m), np.zeros(m), np.ones(m)], 1)
        else:
            # kinds 0 and 1: the line x = X admits |x_j - X| < 0.5; kind
            # 2: the line y = 0, on which only the last split lies
            x = np.where(kind == 0, cx[pick], -5000.0)
            a = np.where(kind == 2, 0.0, 1.0)
            ra = np.stack([a, 1.0 - a, -a * x, np.ones(n)], 1)
            cy = np.where(np.arange(m) < j0, 100.0, 0.0)
            ca = np.stack([cx, cy, np.full(m, 0.25), np.ones(m)], 1)
        args = [_t(v).to(cuda) for v in (d1, d2, ra.astype(np.float32),
                                         ca.astype(np.float32))]
        k = _both(fn, args)
        bd = (k[0] // ht.COL_STRIDE).cpu().numpy()
        bcol = (k[0] % ht.COL_STRIDE).cpu().numpy()
        assert (bd[kind == 1] == ht.MASK_D).all()
        one = kind == 0
        assert (bcol[one] == pick[one]).all() and (bd[one] < ht.MASK_D).all()
        assert ((k[1] // ht.COL_STRIDE).cpu().numpy()[one] == ht.MASK_D).all()

    @pytest.mark.parametrize("fn", ["mutual", "epi"])
    def test_column_best_in_another_row_tile(self, cuda, fn):
        """Each of the first 128 columns has an exact copy in the fourth
        row tile: its best row lies there, three tiles from the first."""
        rng = np.random.default_rng(7)
        n, m = 512, 256
        d1, d2 = _rand_desc(rng, n), _rand_desc(rng, m)
        d1[384:] = d2[:128]
        ra, ca = _pass_all(fn, n, m, rng)
        ra[:, -1] = 1.0
        ca[:, -1] = 1.0
        k = _both(fn, [_t(a).to(cuda) for a in (d1, d2, ra, ca)])
        ck = k[2][:128].cpu().numpy()
        np.testing.assert_array_equal(ck // ht.ROW_STRIDE, 0)
        np.testing.assert_array_equal(ck % ht.ROW_STRIDE, 384 + np.arange(128))


def _k1_check(images, launches=1):
    """K1 on ``images`` (CUDA) in ``launches`` launches; each score map
    equals ``fast_score_map`` and the folded mirror on the interior, and
    ``fast_score_map`` of the zero-padded image everywhere (the kernel's
    zero halo)."""
    n0 = kernels.LAUNCHES["fast_score"]
    out = tfast.score_maps(images)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fast_score"] == n0 + launches
    for im, k in zip(images, out):
        assert k.shape == im.shape and k.dtype == torch.float32
        p = tfast.fast_score_map(im)
        assert torch.equal(k[3:-3, 3:-3], p[3:-3, 3:-3])
        assert torch.equal(k[3:-3, 3:-3], _fast_score_folded(im)[3:-3, 3:-3])
        padded = tfast.fast_score_map(F.pad(im, (8, 8, 8, 8)))[8:-8, 8:-8]
        assert torch.equal(k, padded)
    return out


@pytest.mark.gpu
class TestFastScoreLevels:
    """K1 redesigned: a frame's levels in one launch.  Bar: equal to the
    plain version on the interior (and to the plain version of the
    zero-padded image everywhere), one launch per 8 images."""

    def test_eight_levels_one_launch(self, cuda):
        rng = np.random.default_rng(8)
        img = torch.as_tensor(
            rng.integers(0, 256, (1440, 1920)).astype(np.float32), device=cuda)
        levels = tpyr.build_pyramid(img, 8, 1.2)
        assert not torch.equal(levels[1], levels[1].round())  # resized
        _k1_check(levels)

    def test_odd_sizes_and_levels_below_a_tile(self, cuda):
        rng = np.random.default_rng(9)
        shapes = [(5, 7), (1, 300), (300, 1), (31, 127), (33, 129),
                  (97, 131), (64, 256), (402, 536)]
        _k1_check([torch.as_tensor(rng.integers(0, 256, s).astype(np.float32),
                                   device=cuda) for s in shapes])

    def test_non_integer_and_adversarial(self, cuda):
        rng = np.random.default_rng(10)
        images = [rng.uniform(0, 255, (200, 300)),
                  _adversarial_image(rng, (1440, 1920)),
                  _adversarial_image(rng, (83, 111))]
        _k1_check([torch.as_tensor(a.astype(np.float32), device=cuda)
                   for a in images])

    def test_more_than_eight_images(self, cuda):
        rng = np.random.default_rng(11)
        images = [torch.as_tensor(rng.integers(0, 256, (40 + i, 70 - i))
                                  .astype(np.float32), device=cuda)
                  for i in range(tfast.MAX_LEVELS + 1)]
        _k1_check(images, launches=2)

    def test_single_image(self, cuda):
        rng = np.random.default_rng(12)
        img = torch.as_tensor(rng.integers(0, 256, (100, 150))
                              .astype(np.float32), device=cuda)
        n0 = kernels.LAUNCHES["fast_score"]
        k = tfast.score_map(img)
        assert kernels.LAUNCHES["fast_score"] == n0 + 1
        assert torch.equal(k, tfast.fast_score(img))
        assert torch.equal(k[3:-3, 3:-3], tfast.fast_score_map(img)[3:-3, 3:-3])
        with pytest.raises(ValueError):      # CPU and CUDA images mixed
            tfast.score_maps([img, img.cpu()])


def _k4_both(d1, d2, v2, cuda):
    """One call of K4 (exactly one launch) against its plain version."""
    args = (_t(d1).to(cuda), _t(d2).to(cuda), torch.from_numpy(v2).to(cuda))
    before = kernels.LAUNCHES["hamming_top2"]
    out = ht.hamming_top2(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hamming_top2"] == before + 1
    for o, r, what in zip(out, ht.hamming_top2_plain(*args),
                          ("best", "idx", "second")):
        assert torch.equal(o, r), f"{what}: {(o != r).sum().item()} differ"
    return [o.cpu().numpy() for o in out]


@pytest.mark.gpu
class TestHammingTop2Edges:
    """K4 redesigned on K2/K3's tensor-core search: column splits merged
    inside the launch, validity folded into the keys.  Bar: bit-exact
    against ``hamming_top2_plain``, one launch per call."""

    @pytest.mark.parametrize("n,m", [(256, 384), (4096, 4096), (128, 8192)])
    def test_ties_across_splits(self, cuda, n, m):
        rng = np.random.default_rng(n + m)
        base = _rand_desc(rng, 128)
        d2 = np.tile(base[:64], (m // 64, 1))
        d1 = np.tile(base, (n // 128, 1))
        d1[: n // 2] ^= (rng.random((n // 2, 8)) < 0.01).astype(np.uint32)
        v2 = rng.random(m) > 0.2
        best, _, second = _k4_both(d1, d2, v2, cuda)
        assert ((best == second) & (best < ht.BIG)).any()

    @pytest.mark.parametrize("n,m", [(4096, 4096), (128, 4096), (256, 384)])
    def test_only_valid_column_in_last_split(self, cuda, n, m):
        rng = np.random.default_rng(n * 3 + m)
        d1, d2 = _rand_desc(rng, n), _rand_desc(rng, m)
        v2 = np.zeros(m, bool)
        j = m - 1 - int(rng.integers(0, m - _last_split_begin(n, m)))
        v2[j] = True
        best, idx, second = _k4_both(d1, d2, v2, cuda)
        assert (idx == j).all() and (best <= 256).all()
        assert (second == ht.BIG).all()

    def test_all_invalid_block(self, cuda):
        rng = np.random.default_rng(5)
        d1, d2 = _rand_desc(rng, 512), _rand_desc(rng, 4096)
        d1[:256] = d2[rng.integers(0, 4096, 256)]
        best, _, second = _k4_both(d1, d2, np.zeros(4096, bool), cuda)
        assert (best >= ht.BIG).all() and (second == ht.BIG).all()
        assert (best[:256] == ht.BIG).all()

    def test_columns_above_4096(self, cuda):
        rng = np.random.default_rng(6)
        d1, d2 = _rand_desc(rng, 128), _rand_desc(rng, 8192)
        d1[:64] = d2[8192 - 64:]
        v2 = rng.random(8192) > 0.2
        best, idx, _ = _k4_both(d1, d2, v2, cuda)
        hit = v2[8192 - 64:]
        assert (idx[:64][hit] == np.arange(8192 - 64, 8192)[hit]).all()

    def test_size_guard(self, cuda):
        m = ht.K4_MAX_COLS + ht.TILE
        d1 = torch.zeros((128, 8), dtype=torch.int32, device=cuda)
        d2 = torch.zeros((1, 8), dtype=torch.int32, device=cuda).expand(m, 8)
        v2 = torch.ones(1, dtype=torch.bool, device=cuda).expand(m)
        n0 = kernels.LAUNCHES["hamming_top2"]
        with pytest.raises(ValueError, match="keys need"):
            ht.hamming_top2(d1, d2, v2)
        assert kernels.LAUNCHES["hamming_top2"] == n0


@pytest.mark.gpu
@pytest.mark.parametrize("n", [50000, 100])
@pytest.mark.parametrize("trail", [(), (3,), (7, 7)])
def test_index_sum_repeats(cuda, n, trail):
    """200000 rows into n targets: a map point's few observations (n =
    50000) or a keyframe's thousands (n = 100).  Bars: two calls give
    the same bits; short segments of rows with two or more dimensions
    sum in row order, bit-exact with ``index_add_`` on the CPU; the
    rest (tree reductions) within 1e-5 relative of it."""
    rng = np.random.default_rng(n + len(trail))
    idx = torch.as_tensor(rng.integers(0, n, 200000))
    vals = torch.as_tensor(
        rng.standard_normal((200000,) + trail).astype(np.float32))
    ref = vals.new_zeros((n,) + trail).index_add_(0, idx, vals)
    per = IndexSum(idx.to(cuda), n)
    a, b = per(vals.to(cuda)), per(vals.to(cuda))
    assert torch.equal(a, b)
    if trail and not per.long:
        assert torch.equal(a.cpu(), ref)
    else:
        torch.testing.assert_close(a.cpu(), ref, rtol=1e-5, atol=1e-4)


# ----------------------------------------------------------------------
# pipelined tracking on the card
# ----------------------------------------------------------------------
@pytest.mark.gpu
def test_pinned_readback_equals_synchronous_copy(cuda):
    """A step's outputs (indices, masks) copied without blocking into
    pinned memory behind an event read back as a synchronous copy does,
    with more work queued behind them on the stream."""
    g = torch.Generator(device=cuda).manual_seed(0)
    outs = (torch.randint(0, 4096, (4096,), device=cuda, generator=g),
            torch.rand(4096, device=cuda, generator=g) > 0.5,
            torch.randint(0, 4096, (16384,), device=cuda, generator=g),
            torch.rand(16384, device=cuda, generator=g) > 0.3)
    rb = _Readback(outs)
    big = torch.rand((4096, 4096), device=cuda, generator=g)
    for _ in range(4):
        big = big @ big / 4096.0       # later work on the same stream
    assert all(t.is_pinned() for t in rb._host)
    for host, dev in zip(rb.arrays(), outs):
        np.testing.assert_array_equal(host, dev.cpu().numpy())


def _pipelined_run(cuda):
    cam = Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640,
                     height=480)
    cfg = SlamConfig(cam=cam, orb=OrbParams(n_features=800, n_levels=4),
                     fps=10.0, pose_prior=True, init_min_matches=60,
                     init_min_triangulated=40, init_min_tracked_after_ba=60,
                     pipelined_tracking=True, pipeline_depth=3)
    world = synth.make_world(seed=3, device=cuda)
    poses = synth.aerial_trajectory(26, speed=0.3)
    system = System(cfg, enable_loop_closing=False, device=cuda)
    frames, states = [], []
    system.prefetch(synth.render(world, cam, poses[0]))
    for i, P in enumerate(poses):
        nxt = synth.render(world, cam, poses[i + 1]) \
            if i + 1 < len(poses) else None
        frames.append(system.track_monocular_with_pose(
            synth.render(world, cam, P), i * 0.1, P, next_image=nxt))
        states.append(system.state.name)
    system.flush_tracking()
    system.shutdown()
    return states, [f.mp_ids.copy() for f in frames]


@pytest.mark.gpu
def test_pipelined_depth3_runs_repeat(cuda):
    """Two pipelined depth-3 runs of the 640x480 sweep with the
    extraction prefetch give the same states and the same bindings at
    every frame."""
    s1, b1 = _pipelined_run(cuda)
    s2, b2 = _pipelined_run(cuda)
    assert s1 == s2
    assert sum(s == "OK" for s in s1) >= len(s1) - 2
    for i, (x, y) in enumerate(zip(b1, b2)):
        np.testing.assert_array_equal(x, y, err_msg=f"frame {i}")


# ----------------------------------------------------------------------
# estimated-pose solvers: the card against the port's CPU results, with
# tests/test_torch_estimated.py's tolerances
# ----------------------------------------------------------------------
FX = FY = 450.0
CX, CY = 320.0, 240.0


def _project(P, X):
    pc = X @ P[:3, :3].T + P[:3, 3]
    return np.stack([FX * pc[:, 0] / pc[:, 2] + CX,
                     FY * pc[:, 1] / pc[:, 2] + CY], -1).astype(np.float32)


def _pose(axis, trans):
    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = se3.so3_exp(torch.tensor(axis, dtype=torch.float32)).numpy()
    P[:3, 3] = trans
    return P


def _pnp_scene():
    rng = np.random.default_rng(2)
    axis = rng.normal(size=3)
    P = _pose(0.4 * axis / np.linalg.norm(axis), [0.3, -0.2, 0.5])
    rng = np.random.default_rng(3)
    pw = rng.uniform([-3, -3, 4], [3, 3, 12], (100, 3)).astype(np.float32)
    pw = pw @ P[:3, :3] - (P[:3, 3] @ P[:3, :3])
    uv = _project(P, pw)
    uv[-30:] += rng.uniform(30, 120, (30, 2)).astype(np.float32)
    samples = rng.integers(0, 100, (128, 4)).astype(np.int32)
    return P, pw, uv, samples


@pytest.mark.gpu
def test_optimize_pose_on_card(cuda):
    """Bars: pose within 1e-4 of the CPU result, the same inliers."""
    P, pw, uv, _ = _pnp_scene()
    P0 = P.copy()
    P0[:3, 3] += [0.05, -0.03, 0.02]
    args = [torch.as_tensor(a) for a in (
        P0, np.pad(pw, ((0, 28), (0, 0))), np.pad(uv, ((0, 28), (0, 0))),
        np.pad(np.full(100, 0.8, np.float32), (0, 28)),
        np.pad(np.ones(100, bool), (0, 28)))]
    c = pose_opt.optimize_pose(*args, FX, FY, CX, CY)
    g = pose_opt.optimize_pose(*[a.to(cuda) for a in args], FX, FY, CX, CY)
    np.testing.assert_allclose(g.Tcw.cpu().numpy(), c.Tcw.numpy(),
                               atol=1e-4)
    assert torch.equal(g.inliers.cpu(), c.inliers)


@pytest.mark.gpu
def test_pnp_ransac_on_card(cuda):
    """Bars: the same inliers as on the CPU; the pose within 1e-3 of the
    CPU's after the pose optimization over those inliers (the raw
    winners are not held: cuSOLVER and LAPACK choose different bases of
    a minimal set's null space, tests/test_torch_estimated.py)."""
    _, pw, uv, samples = _pnp_scene()
    args = [torch.as_tensor(a) for a in (
        pw, uv, np.ones(100, np.float32), np.ones(100, bool), samples)]
    c = pnp.pnp_ransac(*args, FX, FY, CX, CY, min_inliers=10)
    g = pnp.pnp_ransac(*[a.to(cuda) for a in args], FX, FY, CX, CY,
                       min_inliers=10)
    assert bool(g.ok) and bool(c.ok)
    assert torch.equal(g.inliers.cpu(), c.inliers)
    refine = [args[0], args[1], args[2]]
    cr = pose_opt.optimize_pose(c.Tcw, *refine, c.inliers, FX, FY, CX, CY)
    gr = pose_opt.optimize_pose(g.Tcw, *[a.to(cuda) for a in refine],
                                g.inliers, FX, FY, CX, CY)
    np.testing.assert_allclose(gr.Tcw.cpu().numpy(), cr.Tcw.numpy(),
                               atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("planar", [False, True])
def test_initialize_two_view_on_card(cuda, planar):
    """tests/test_twoview.py's general and planar scenes.  Bars: the same
    ok and model as on the CPU, >= 99% of the inlier flags equal, R and
    t within 1e-3."""
    rng = np.random.default_rng(2 if planar else 1)
    if planar:
        X = np.stack([rng.uniform(-4, 4, 200), rng.uniform(-3, 3, 200),
                      np.full(200, 8.0)], -1).astype(np.float32)
        T2 = _pose([0.05, 0.08, 0.02], [0.6, 0.1, 0.05])
    else:
        X = rng.uniform([-3, -3, 4], [3, 3, 12], (200, 3)).astype(np.float32)
        T2 = _pose([0.02, -0.05, 0.01], [0.8, 0.05, 0.05])
    rng = np.random.default_rng(0)
    uv1 = _project(np.eye(4, dtype=np.float32), X)
    uv2 = _project(T2, X)
    uv1 += rng.normal(0, 0.3, uv1.shape).astype(np.float32)
    uv2 += rng.normal(0, 0.3, uv2.shape).astype(np.float32)
    K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
    args = [torch.as_tensor(a) for a in (
        uv1, uv2, np.ones(200, bool), np.ones(200, np.float32), K,
        rng.integers(0, 200, (200, 8)).astype(np.int32))]
    c = twoview.initialize_two_view(*args)
    g = twoview.initialize_two_view(*[a.to(cuda) for a in args])
    assert bool(g.ok) == bool(c.ok) is True
    assert bool(g.used_homography) == bool(c.used_homography) == planar
    assert (g.good.cpu() == c.good).float().mean() >= 0.99
    np.testing.assert_allclose(g.R.cpu().numpy(), c.R.numpy(), atol=1e-3)
    np.testing.assert_allclose(g.t.cpu().numpy(), c.t.numpy(), atol=1e-3)


# ----------------------------------------------------------------------
# the extraction's host synchronizations, the command line and map
# loading on the card
# ----------------------------------------------------------------------
@pytest.mark.gpu
def test_warm_extraction_makes_no_host_sync(cuda):
    """At bench shape (1920x1440, 4000 features, 8 levels) a warm
    extraction queues its work and returns without waiting for the card
    (torch.cuda.set_sync_debug_mode("error") raises on a sync)."""
    from orb_slam2_tpu_torch.models.frame import FrameFactory
    cam = Intrinsics(fx=960.0, fy=960.0, cx=960.0, cy=720.0, width=1920,
                     height=1440)
    factory = FrameFactory(cam, OrbParams(n_features=4000, n_levels=8),
                           device=cuda)
    world = synth.make_world(seed=7, tex_size=4096, scale=120.0,
                             tex_shape=(3072, 10240),
                             origin_px=(1560.0, 1536.0), device=cuda)
    images = [synth.render(world, cam, T) for T in
              synth.aerial_trajectory(2, height=12.0, speed=0.5)]
    factory.start(images[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        feats, _, _ = factory.start(images[1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(feats.valid.sum()) > 3000


def _cpu_saved_map(tmp_path):
    """A 640x480 pose-prior map built on the CPU and saved."""
    cam = Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640,
                     height=480)
    cfg = SlamConfig(cam=cam, orb=OrbParams(n_features=800, n_levels=4),
                     fps=10.0, pose_prior=True, init_min_matches=60,
                     init_min_triangulated=40, init_min_tracked_after_ba=60)
    world = synth.make_world(seed=3, device="cpu")
    poses = synth.aerial_trajectory(14, speed=0.3)
    images = [synth.render(world, cam, T).numpy() for T in poses]
    system = System(cfg, enable_loop_closing=False, device="cpu")
    for i, T in enumerate(poses):
        system.track_monocular_with_pose(images[i], i * 0.1, T)
    path = str(tmp_path / "map.npz")
    system.save_map(path)
    return cfg, system, path, poses, images


@pytest.mark.gpu
def test_load_cpu_saved_map_on_card(cuda, tmp_path):
    """A map saved on the CPU loads onto the card (host arrays equal,
    the device point store on the card) and relocalizes a mapped frame
    there."""
    from orb_slam2_tpu_torch.pipeline.tracking import TrackState
    cfg, cpu_sys, path, poses, images = _cpu_saved_map(tmp_path)
    card = System(cfg, enable_loop_closing=False, device=cuda)
    card.load_map(path)
    assert card.store.dev_points.snapshot()[0].device.type == "cuda"
    n = card.store.n_points()
    assert n == cpu_sys.store.n_points()
    np.testing.assert_array_equal(np.asarray(card.store.mp_pos),
                                  np.asarray(cpu_sys.store.mp_pos))
    np.testing.assert_array_equal(
        card.store.dev_points.snapshot()[0][:n].cpu().numpy(),
        np.asarray(card.store.mp_pos))
    assert card.state == TrackState.LOST
    card.track_monocular_with_pose(images[8], 50.0, poses[8])
    assert card.state == TrackState.OK
    card.shutdown()


@pytest.mark.gpu
def test_cli_run_on_card(cuda, tmp_path, capsys):
    """``cli run --device cuda`` on a 640x480 shenzhen-layout dataset
    against the same command on the CPU: the same frames tracked OK and
    tracked-PLY frames, map point counts within 10%, the map on the
    world's ground plane (median |z| < 0.08)."""
    import json
    from orb_slam2_tpu_torch import cli
    from orb_slam2_tpu_torch.io.poses import save_ue4_camera_poses
    from orb_slam2_tpu_torch.utils import ply
    cam = Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640,
                     height=480)
    world = synth.make_world(seed=3, device="cpu")
    poses = synth.aerial_trajectory(10, speed=0.4)
    paths = []
    for i, T in enumerate(poses):
        paths.append(str(tmp_path / f"{i:03d}.npy"))
        np.save(paths[-1], synth.render(world, cam, T).numpy())
    (tmp_path / "imgs.txt").write_text("\n".join(paths) + "\n")
    save_ue4_camera_poses(str(tmp_path / "cams.txt"), poses)
    (tmp_path / "settings.yaml").write_text(
        "%YAML:1.0\nCamera.fx: 450.0\nCamera.fy: 450.0\nCamera.cx: 320.0\n"
        "Camera.cy: 240.0\nCamera.fps: 10.0\nORBextractor.nFeatures: 800\n"
        "ORBextractor.scaleFactor: 1.2\nORBextractor.nLevels: 4\n")
    (tmp_path / "launch.toml").write_text(
        f'FBoWVocabularyPath = ""\n'
        f'ImagesCollectionPath = "{tmp_path}/imgs.txt"\n'
        f'CameraPoseCollectionPath = "{tmp_path}/cams.txt"\n'
        f'ORBSLAMConfigPath = "{tmp_path}/settings.yaml"\n')
    res, pts, tracked = {}, {}, {}
    for dev in ("cpu", "cuda"):
        out = tmp_path / f"out_{dev}"
        capsys.readouterr()
        assert cli.main(["run", str(tmp_path / "launch.toml"), "--out",
                         str(out), "--device", dev]) == 0
        res[dev] = json.loads(capsys.readouterr().out.strip()
                              .splitlines()[-1])
        pts[dev] = ply.read_ply_points(str(out / "map.ply"))
        tracked[dev] = sorted(p.name for p in out.glob("tracked_*.ply"))
    assert res["cuda"]["frames"] == 10
    assert res["cuda"]["tracked_ok"] == res["cpu"]["tracked_ok"] >= 9
    assert tracked["cuda"] == tracked["cpu"]
    assert abs(len(pts["cuda"]) - len(pts["cpu"])) <= 0.1 * len(pts["cpu"])
    assert np.isfinite(pts["cuda"]).all()
    assert np.median(np.abs(pts["cuda"][:, 2])) < 0.08
