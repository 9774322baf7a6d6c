"""The hand-written CUDA kernels (K1, K2, K3, K4) against their plain
PyTorch versions on the card; the solvers' per-target sums
(``optim.segment.IndexSum``) against ``index_add_`` on the CPU; the
pipelined tracker's pinned result copies and the repeatability of a
pipelined run; the estimated-pose solvers (pose optimization, EPnP
RANSAC, the two-view initializer) against the port's own CPU results;
and the CUDA graphs (``graphs.py``) of the extraction, the fused step
and the local mapper's programs (triangulation, both fuse directions,
the compacted match lists, the structure-BA chunks, the vocabulary
descent) against their eager calls, with no host sync when warm.
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
from orb_slam2_tpu_torch.graphs import Readback
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


def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: python3 -m pytest "
                    "tests/test_torch_gpu.py -m gpu --noconftest)")
    return torch.device("cuda")


@pytest.fixture
def cuda():
    return cuda_device()


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
    rb = Readback(outs)
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


def _ba_scene(seed=8, n_cams=6, n_pts=300):
    """test_optim.make_scene's BA problem in numpy (no jax here): noisy
    observations, cameras 2.. and every point perturbed, two fixed."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-3, -3, 6], [3, 3, 14], (n_pts, 3)).astype(np.float32)
    cams, oc, op, ouv = [], [], [], []
    for i in range(n_cams):
        T = se3.exp(torch.tensor([-0.4 * i, 0.02 * i, 0.01 * i]
                                 + rng.normal(0, 0.03, 3).tolist())).numpy()
        cams.append(T.astype(np.float32))
        pc = pts @ T[:3, :3].T + T[:3, 3]
        uv = pc[:, :2] / pc[:, 2:] * 500.0 + [320.0, 240.0]
        vis = np.where((pc[:, 2] > 0) & (uv[:, 0] > 0) & (uv[:, 0] < 640)
                       & (uv[:, 1] > 0) & (uv[:, 1] < 480))[0]
        oc += [i] * len(vis)
        op += vis.tolist()
        ouv += (uv[vis] + rng.normal(0, 0.2, (len(vis), 2))).tolist()
    cams = np.stack(cams)
    for c in range(2, n_cams):
        cams[c] = se3.exp(torch.tensor(rng.normal(0, 0.02, 6),
                                       dtype=torch.float32)).numpy() @ cams[c]
    pts = pts + rng.normal(0, 0.1, pts.shape).astype(np.float32)
    fixed = np.zeros(n_cams, bool)
    fixed[:2] = True
    n = len(oc)
    return (cams, pts, np.array(oc, np.int32), np.array(op, np.int32),
            np.array(ouv, np.float32), np.ones(n, np.float32),
            np.ones(n, bool), fixed)


@pytest.mark.gpu
def test_distributed_solvers_two_shards_on_card(cuda):
    """The observation- and point-sharded BA and the edge-sharded pose
    graph on two shards of one card against the single-device solves
    on the card.  Bars: tests/test_parallel.py's (poses 2e-4, points
    2e-3, cost rtol 1e-3, inliers equal), or 4x the gap between the
    card's and the CPU's single-device BA (sums in another order only)
    where that is larger, as chip_smoke.py's path F: on the card this
    scene's poses move 1.9e-4 with the sum order alone.  The pose
    graph's sharded solve is no further from the float64 solve than
    twice the single device's distance plus 2e-4: on the card the two
    float32 solves part by 6.7e-4 (an LM accept flips with the sum
    order) and the float32 solve lies ~1e-3 from the float64 one.  The
    replicated cameras and vertices are bitwise equal on both
    shards."""
    from orb_slam2_tpu_torch import parallel
    from orb_slam2_tpu_torch.geom import sim3
    from orb_slam2_tpu_torch.optim import ba, pose_graph

    class Mesh(parallel.LocalMesh):
        def run(self, body):
            self.results = super().run(body)
            return self.results

    args = _ba_scene()
    single = ba.bundle_adjust(*[torch.as_tensor(a, device=cuda)
                                for a in args], 500.0, 500.0, 320.0, 240.0,
                              iters=10, cg_iters=30)
    cpu = ba.bundle_adjust(*[torch.as_tensor(a) for a in args], 500.0,
                           500.0, 320.0, 240.0, iters=10, cg_iters=30)

    def gap(a, b):
        return float((a.cpu() - b.cpu()).abs().max())
    # the card's single solve against the CPU's: sums in another order
    order = dict(poses=gap(single.cam_Tcw, cpu.cam_Tcw),
                 points=gap(single.points, cpu.points))
    for fn in (parallel.distributed_bundle_adjust,
               parallel.distributed_bundle_adjust_sharded_points):
        mesh = Mesh([cuda, cuda])
        res = fn(mesh, *args, 500.0, 500.0, 320.0, 240.0, iters=10,
                 cg_iters=30)
        assert res.cam_Tcw.is_cuda
        cams = [r.cam_Tcw for r in mesh.results.values()]
        assert torch.equal(cams[0], cams[1])
        got = dict(poses=gap(res.cam_Tcw, single.cam_Tcw),
                   points=gap(res.points, single.points))
        assert got["poses"] < max(2e-4, 4 * order["poses"]) \
            and got["points"] < max(2e-3, 4 * order["points"]), (
                fn.__name__, got, "card against CPU:", order)
        assert torch.equal(res.obs_inlier.cpu(), single.obs_inlier.cpu())
        np.testing.assert_allclose(float(res.final_cost),
                                   float(single.final_cost), rtol=1e-3)

    # a drifted ring of 30 Sim3 vertices closed by one loop edge
    rng = np.random.default_rng(2)
    K = 30
    gt = []
    for i in range(K):
        th = 2 * np.pi * i / K
        T = se3.from_rt(
            se3.so3_exp(torch.tensor([0.0, 0.0, -th])),
            torch.tensor([-5.0, 0.0, 0.0])).float()
        gt.append(sim3.from_se3(T))
    ei, ej, meas, noisy = [], [], [], [gt[0]]
    for i in range(K - 1):
        xi = torch.tensor(rng.normal(0, 0.005, 6).tolist() + [np.log(1.025)],
                          dtype=torch.float32)
        Sji = sim3.compose(sim3.exp(xi),
                           sim3.compose(gt[i + 1], sim3.inv(gt[i])))
        ei.append(i)
        ej.append(i + 1)
        meas.append(Sji)
        noisy.append(sim3.compose(Sji, noisy[-1]))
    ei.append(K - 1)
    ej.append(0)
    meas.append(sim3.compose(gt[0], sim3.inv(gt[K - 1])))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    pargs = (torch.stack(noisy).numpy(), np.array(ei, np.int32),
             np.array(ej, np.int32), torch.stack(meas).numpy(),
             np.ones(K, np.float32), fixed)
    psingle = pose_graph.optimize_pose_graph(
        *[torch.as_tensor(a, device=cuda) for a in pargs], iters=30,
        cg_iters=40)
    # the same solve in float64 on the CPU: the float32 solves' common
    # reference (this ring's LM accepts flip with the sum order, and its
    # float32 and float64 solutions lie ~1e-3 apart)
    p64 = pose_graph.optimize_pose_graph(
        *[torch.as_tensor(a).double() if a.dtype == np.float32
          else torch.as_tensor(a) for a in pargs], iters=30, cg_iters=40)
    mesh = Mesh([cuda, cuda])
    pres = parallel.distributed_pose_graph(mesh, *pargs, iters=30,
                                           cg_iters=40)
    sims = [r.sims for r in mesh.results.values()]
    assert torch.equal(sims[0], sims[1])
    err_single, err_sharded = gap(psingle.sims, p64.sims), gap(pres.sims,
                                                               p64.sims)
    assert err_sharded < 2 * err_single + 2e-4, (
        err_sharded, "single device:", err_single,
        "sharded against single:", gap(pres.sims, psingle.sims))
    np.testing.assert_allclose(float(pres.final_cost),
                               float(psingle.final_cost), rtol=1e-3,
                               atol=1e-5)


def _sharded_solves():
    """The three sharded solves, ``solve(mesh, eager)``, on a small BA
    scene (3 LM iterations of 8 PCG steps) and a random pose graph of 12
    vertices and 40 edges."""
    from orb_slam2_tpu_torch import parallel
    args = _ba_scene()
    rng = np.random.default_rng(3)
    K, E = 12, 40
    sims = np.zeros((K, 8), np.float32)
    sims[:, 3] = 1.0                      # unit quaternions
    sims[:, 4:7] = rng.normal(0, 1, (K, 3))
    sims[:, 7] = 1.0
    ei = rng.integers(0, K, E).astype(np.int32)
    ej = ((ei + rng.integers(1, K, E)) % K).astype(np.int32)
    meas = np.tile(sims[:1], (E, 1))
    meas[:, 4:7] += rng.normal(0, 0.1, (E, 3)).astype(np.float32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    cam = (500.0, 500.0, 320.0, 240.0)
    return (
        lambda m, eager: parallel.distributed_bundle_adjust(
            m, *args, *cam, iters=3, cg_iters=8, eager=eager),
        lambda m, eager: parallel.distributed_bundle_adjust_sharded_points(
            m, *args, *cam, iters=3, cg_iters=8, eager=eager),
        lambda m, eager: parallel.distributed_pose_graph(
            m, sims, ei, ej, meas, np.ones(E, np.float32), fixed, iters=3,
            cg_iters=8, eager=eager))


@pytest.mark.gpu
def test_sharded_graph_chains_equal_the_eager_solves(cuda):
    """The three sharded solvers' graph chains on two shards of the card
    (first call: captures; second: warm) against the one-call cores
    through the same mesh (``eager=True``): every shard's every result
    equal bit for bit; a warm call waits for the card nowhere
    (``set_sync_debug_mode("error")`` on every shard's thread)."""
    from orb_slam2_tpu_torch import parallel

    class Mesh(parallel.LocalMesh):
        def run(self, body):
            self.results = super().run(body)
            return self.results

    for solve in _sharded_solves():
        ref = Mesh([cuda, cuda])
        solve(ref, True)
        for warm in (False, True):
            mesh = Mesh([cuda, cuda])
            torch.cuda.synchronize()
            if warm:
                torch.cuda.set_sync_debug_mode("error")
            try:
                solve(mesh, False)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            for d, res in mesh.results.items():
                for a, b in zip(res, ref.results[d]):
                    assert torch.equal(a, b)


@pytest.mark.gpu
def test_nccl_captured_solves_equal_the_eager_solves(cuda):
    """A one-rank NCCL group (``init_multihost``, ``make_global_mesh``):
    its mesh is capturable, and each of the three sharded solves runs
    its collectives inside the graphs (``graphs.STATS``: the captured
    form, one replay a segment, ``iters + 2`` segments), first call and
    warm, bit for bit the one-call core on the same rank
    (``eager=True``); a warm solve waits for the card nowhere
    (``set_sync_debug_mode("error")``)."""
    import socket
    import torch.distributed as dist
    from orb_slam2_tpu_torch import graphs, parallel
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{sock.getsockname()[1]}"
    sock.close()
    parallel.init_multihost(coordinator=addr, num_processes=1, process_id=0)
    try:
        assert dist.get_backend() == "nccl"
        mesh = parallel.make_global_mesh()
        assert mesh.capturable and mesh.device.type == "cuda"
        for solve, chain in zip(_sharded_solves(),
                                ("ba", "ba", "pose_graph")):
            ref = solve(mesh, True)
            for warm in (False, True):
                graphs.reset_stats()
                torch.cuda.synchronize()
                if warm:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    res = solve(mesh, False)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                ran = graphs.STATS[chain]
                assert ran["captured"] == 1 and "cut" not in ran
                assert ran["segments"] == 3 + 2
                replays = sum(v["replays"] for k, v in graphs.STATS.items()
                              if k.startswith(chain + ":"))
                assert replays == ran["segments"]
                for a, b in zip(res, ref):
                    assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_viewer_png_of_a_card_frame(cuda):
    """draw_frame on a card image and frame (device tensors read back on
    the drawing thread) equals the drawing of their host copies, and the
    PNG bytes decode to it."""
    import struct
    import zlib
    from orb_slam2_tpu_torch.utils import viz
    cfg = SlamConfig(cam=Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                                    width=640, height=480),
                     orb=OrbParams(n_features=800, n_levels=4), fps=10.0,
                     pose_prior=True, init_min_matches=60,
                     init_min_triangulated=40, init_min_tracked_after_ba=60)
    system = System(cfg, enable_loop_closing=False, device=cuda)
    world = synth.make_world(seed=3, device=cuda)
    frame = None
    for i, T in enumerate(synth.aerial_trajectory(4, speed=0.3)):
        img = synth.render(world, cfg.cam, T)
        frame = system.track_monocular_with_pose(img, i * 0.1, T)
    assert img.is_cuda
    rgb = viz.draw_frame(img, frame, store=system.store)
    host = viz.draw_frame(img.cpu().numpy(), frame, store=system.store)
    np.testing.assert_array_equal(rgb, host)
    assert (rgb == [0, 255, 0]).all(-1).sum() > 0
    data = viz.encode_png(rgb, text="t")
    w, h = struct.unpack(">II", data[16:24])
    idat = data.index(b"IDAT")
    n, = struct.unpack(">I", data[idat - 4:idat])
    raw = np.frombuffer(zlib.decompress(data[idat + 4:idat + 4 + n]),
                        np.uint8).reshape(h, 1 + 3 * w)
    np.testing.assert_array_equal(raw[:, 1:].reshape(h, w, 3), rgb)
    system.shutdown()


# ----------------------------------------------------------------------
# CUDA graphs (graphs.py): the extraction and both forms of the fused
# pose-prior step replayed against their eager calls
# ----------------------------------------------------------------------
SCENE_CAM = dict(fx=450.0, fy=450.0, cx=320.0, cy=240.0)
SCENE_BOUNDS = (0.0, 640.0, 0.0, 480.0)


def prior_step_scene(case: str, seed: int = 0):
    """The arguments of ``tracking._prior_step_core`` for a synthetic
    frame, as numpy arrays (descriptors uint32) and statics, in its
    order.  512 feature rows (480 keypoints at random positions, octaves
    0-3, random descriptors and angles); the last frame is the same
    keypoint set; point k lies on keypoint k's ray at depth 5-10 under
    the identity pose.  Bound rows i < 200 hold point i at last-frame
    row i (L = 512: the next chain step's kept pairs fit, as they do on
    the main path); the candidates (C = 256) are points 200-423 and
    points 480-511, copies of points 0-31: a copy finds its keypoint
    only where the frame-to-frame pass left it unbound (``has_mp``).
    ``case``: "all" (every bound row matches and passes the gate),
    "none" (no bound row: the gate holds no match), "some" (the odd
    points among 0-199 dead)."""
    rng = np.random.default_rng(seed)
    nf, n_kp, n_bound, L = 512, 480, 200, 512
    sf = (1.2 ** np.arange(4)).astype(np.float32)
    xy = np.zeros((nf, 2), np.float32)
    xy[:n_kp] = rng.uniform([20, 20], [620, 460], (n_kp, 2))
    octave = rng.integers(0, 4, nf).astype(np.int32)
    desc = _rand_desc(rng, nf)
    angle = rng.uniform(-np.pi, np.pi, nf).astype(np.float32)
    valid = np.arange(nf) < n_kp
    # the point store: points 0-479 on their keypoints' rays, 480-511
    # copies of 0-31, rows past 512 empty
    cap = 1024
    src = np.concatenate([np.arange(n_kp), np.arange(32)])
    depth = rng.uniform(5.0, 10.0, len(src)).astype(np.float32)
    ray = np.stack([(xy[src, 0] - SCENE_CAM["cx"]) / SCENE_CAM["fx"],
                    (xy[src, 1] - SCENE_CAM["cy"]) / SCENE_CAM["fy"],
                    np.ones(len(src), np.float32)], 1)
    pos = np.zeros((cap, 3), np.float32)
    pos[:len(src)] = ray * depth[:, None]
    dist = np.linalg.norm(pos[:len(src)], axis=1)
    normal = np.zeros((cap, 3), np.float32)
    normal[:len(src)] = pos[:len(src)] / dist[:, None]
    # the predicted level is the keypoint's octave
    max_d = np.zeros(cap, np.float32)
    max_d[:len(src)] = dist * 1.2 ** (octave[src] - 0.5)
    min_d = (max_d / sf[-1]).astype(np.float32)
    pdesc = np.zeros((cap, 8), np.uint32)
    pdesc[:len(src)] = desc[src]
    alive = np.arange(cap) < len(src)
    bound = np.full(L, -1, np.int32)
    if case != "none":
        bound[:n_bound] = np.arange(n_bound)
    if case == "some":
        alive[1:n_bound:2] = False
    last_rows = np.zeros(L, np.int32)
    last_rows[:n_bound] = np.arange(n_bound)
    cand = np.concatenate([np.arange(200, 424),
                           np.arange(n_kp, n_kp + 32)]).astype(np.int32)
    return [np.eye(4, dtype=np.float32), pos, pdesc, normal, min_d,
            max_d, alive, bound, last_rows, cand,
            octave, desc, angle, xy, octave, desc, valid, angle,
            sf, (1.0 / sf ** 2).astype(np.float32),
            SCENE_CAM["fx"], SCENE_CAM["fy"], SCENE_CAM["cx"],
            SCENE_CAM["cy"], SCENE_BOUNDS, 4, float(np.log(1.2)),
            7.0, 1.0, 5.991]


def scene_tensors(args, device="cpu"):
    """``prior_step_scene``'s arguments as the port takes them."""
    return [_t(a).to(device) if isinstance(a, np.ndarray) else a
            for a in args]


def _chain_args(args, out):
    """``_track_prior_chain``'s arguments for the step after the one
    that took ``args`` and gave ``out``: the bound set from its outputs,
    the same candidates and the same frame again."""
    return [*args[:7], out[6], args[9], out[0], out[4], out[2], out[5],
            *args[9:]]


@pytest.mark.gpu
def test_graphed_fused_steps_equal_eager_on_card(cuda):
    """Both forms of the fused step replayed from a CUDA graph equal
    their eager calls bit for bit, over three calls each (a capture, then
    replays) and for each gate case; a warm replay makes no host sync;
    the outputs are fresh tensors, not the graph's buffers."""
    from orb_slam2_tpu_torch import graphs
    from orb_slam2_tpu_torch.pipeline import tracking
    step = graphs.graphed(tracking._prior_step_core, "prior_step")
    chain = graphs.graphed(tracking._track_prior_chain, "prior_chain")
    for case in ("none", "all", "some"):
        args = scene_tensors(prior_step_scene(case), cuda)
        eager = tracking._prior_step_core(*args)
        cargs = _chain_args(args, eager)
        eager_chain = tracking._track_prior_chain(*cargs)
        outs = []
        for i in range(3):
            if i == 2:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                got = step(*args)
                got_chain = chain(*_chain_args(args, got))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            for a, b in zip((*got, *got_chain), (*eager, *eager_chain)):
                assert torch.equal(a, b), case
            outs.append(got)
        assert outs[1][0].data_ptr() != outs[2][0].data_ptr()
        if case == "all":
            assert bool(eager[2][:200].all()) and not bool(eager[2][200:].any())
    assert step.n_captures() == chain.n_captures() == 1


@pytest.mark.gpu
def test_graphed_extraction_equals_eager_and_keeps_frames(cuda):
    """``FrameFactory.start`` replayed from a CUDA graph equals the eager
    extraction plus undistortion bit for bit in every field, over three
    frames at 640x480 (uint8 frames); frame t's arrays are unchanged
    after frame t+1 is extracted; a warm extraction makes no host sync;
    ``make_extractor`` replays likewise."""
    from orb_slam2_tpu_torch.models.frame import FrameFactory
    from orb_slam2_tpu_torch.ops import extractor as ex
    cam = Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640,
                     height=480, dist=(-0.1, 0.02, 0.0, 0.0, 0.0))
    params = OrbParams(n_features=800, n_levels=4)
    factory = FrameFactory(cam, params, device=cuda)
    world = synth.make_world(seed=3, device=cuda)
    images = [synth.render(world, cam, T) for T in
              synth.aerial_trajectory(4, speed=0.3)]
    kept = []
    for i, img in enumerate(images):
        if i == 3:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            feats, und, _ = factory.start(img)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        want, want_und = factory._extract(img, False)
        for a, b in zip((*feats, und), (*want, want_und)):
            assert torch.equal(a, b), i
        for prev, copies in kept:
            for a, b in zip(prev, copies):
                assert torch.equal(a, b)
        kept.append(((*feats, und), [t.clone() for t in (*feats, und)]))
        run = ex.make_extractor(480, 640, params)
        for a, b in zip(run(img.float()), ex.extract(img.float(), params)):
            assert torch.equal(a, b), i
    assert factory._pipeline.n_captures() == 1


def _graph_run(cuda, eager: bool, n_frames: int = 16):
    """The 640x480 sweep, pipelined at depth 3 with sequential mapping
    (one thread: the same work in the same order every run), eagerly or
    through the graphs.  Returns the launch counts, states and
    bindings."""
    from orb_slam2_tpu_torch import graphs
    cam = Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640,
                     height=480)
    cfg = SlamConfig(cam=cam, orb=OrbParams(n_features=800, n_levels=4),
                     fps=10.0, pose_prior=True, init_min_matches=60,
                     init_min_triangulated=40, init_min_tracked_after_ba=60,
                     pipelined_tracking=True, pipeline_depth=3)
    world = synth.make_world(seed=3, device=cuda)
    poses = synth.aerial_trajectory(n_frames, speed=0.3)
    images = [synth.render(world, cam, T) for T in poses]
    call = graphs.Graphed.__call__
    if eager:
        graphs.Graphed.__call__ = lambda self, *a: self.fn(*a)
    try:
        system = System(cfg, enable_loop_closing=False, device=cuda)
        kernels.reset_launch_counts()
        frames = [system.track_monocular_with_pose(img, i * 0.1, T)
                  for i, (img, T) in enumerate(zip(images, poses))]
        system.flush_tracking()
        torch.cuda.synchronize()
        launches = (dict(kernels.LAUNCHES), dict(kernels.SHAPES))
        system.shutdown()
    finally:
        graphs.Graphed.__call__ = call
    return launches, [f.mp_ids.copy() for f in frames]


@pytest.mark.gpu
def test_graphed_run_launches_as_eager(cuda):
    """A graphed run of 16 frames counts the same kernel launches, per
    kernel and per search shape, as the eager run of the same frames
    (a replay counts what its capture launched; the warm-up calls are
    not counted), and binds the same map points."""
    eager, b_eager = _graph_run(cuda, eager=True)
    graph, b_graph = _graph_run(cuda, eager=False)
    assert eager == graph
    assert eager[0]["fast_score"] == 16
    for i, (x, y) in enumerate(zip(b_eager, b_graph)):
        np.testing.assert_array_equal(x, y, err_msg=f"frame {i}")


@pytest.mark.gpu
@pytest.mark.parametrize("pipelined", [False, True])
def test_warm_fused_dispatch_makes_no_host_sync(cuda, pipelined):
    """A warm ``Tracker._fused_dispatch`` (host-prepared when sequential,
    the device chain when pipelined) queues its step and the result
    copies without waiting for the card."""
    cam = Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640,
                     height=480)
    cfg = SlamConfig(cam=cam, orb=OrbParams(n_features=800, n_levels=4),
                     fps=10.0, pose_prior=True, init_min_matches=60,
                     init_min_triangulated=40, init_min_tracked_after_ba=60,
                     pipelined_tracking=pipelined, pipeline_depth=3)
    world = synth.make_world(seed=3, device=cuda)
    poses = synth.aerial_trajectory(12, speed=0.3)
    system = System(cfg, enable_loop_closing=False, device=cuda)
    for i, T in enumerate(poses[:10]):
        system.track_monocular_with_pose(synth.render(world, cam, T),
                                         i * 0.1, T)
    tr = system.tracker
    assert (tr._chain is not None) == pipelined
    for i in (10, 11):
        frame = tr.factory.make(synth.render(world, cam, poses[i]),
                                Tcw=poses[i])
        torch.cuda.synchronize()
        if i == 11:
            torch.cuda.set_sync_debug_mode("error")
        try:
            rb = tr._fused_dispatch(frame)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert len(rb.arrays()) == 6
    system.shutdown()


GRAPHED_SYNC = """
import sys, torch
sys.path.insert(0, sys.argv[1])
from orb_slam2_tpu_torch import graphs
calls = []
def reads_back(x):
    calls.append(1)
    return x * float((x > 0).sum().item())
g = graphs.graphed(reads_back, "reads_back")
x = torch.ones(64, device="cuda")
for attempt in range(2):
    try:
        g(x)
    except RuntimeError as e:
        print("raised", type(e).__name__)
    else:
        print("returned")
print("calls", len(calls), "captures", g.n_captures())
"""


@pytest.mark.gpu
def test_graphed_sync_raises_without_eager_fallback(cuda):
    """A function that reads a value back (``.item()``) cannot be
    captured: every call raises, after the warm-up calls and one capture
    attempt, and no call hands back an eager result.  In a child
    process: a failed capture may leave the allocator's capture state
    behind."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from orb_slam2_tpu_torch import graphs
    out = subprocess.run([sys.executable, "-c", GRAPHED_SYNC, root],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    assert lines[0].startswith("raised") and lines[1].startswith("raised")
    assert lines[2] == (f"calls {2 * (graphs.WARMUP + 1)} captures 0"), \
        out.stdout


# ----------------------------------------------------------------------
# the local mapper's CUDA graphs (pipeline/local_mapping.py) against
# their eager calls
# ----------------------------------------------------------------------
MAPPER_GRAPHS = ("_tri_step", "_fuse_fwd", "_fuse_rev", "_compact",
                 "_sba_step")


class _Recorder:
    """Stands in for a ``graphs.Graphed`` and keeps each call's
    arguments and outputs."""

    def __init__(self, graph):
        self.graph = graph
        self.calls = []

    def __call__(self, *args):
        out = self.graph(*args)
        self.calls.append((args, out))
        return out


def _mapper_config(**kw):
    cam = Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640,
                     height=480)
    return SlamConfig(cam=cam, orb=OrbParams(n_features=800, n_levels=4),
                      fps=10.0, pose_prior=True, init_min_matches=60,
                      init_min_triangulated=40, init_min_tracked_after_ba=60,
                      **kw)


@pytest.fixture(scope="module")
def mapped_run():
    """The 640x480 sweep over 16 frames with sequential mapping and loop
    detection on the card, every mapper graph and the vocabulary
    descent's recorded; the map state before each keyframe that was
    mapped is kept (``interop.mapstore_state``)."""
    from orb_slam2_tpu_torch import interop
    from orb_slam2_tpu_torch.models import vocabulary
    cuda = cuda_device()
    cfg = _mapper_config()
    world = synth.make_world(seed=3, device=cuda)
    poses = synth.aerial_trajectory(16, speed=0.3)
    system = System(cfg, enable_loop_closing=True, device=cuda)
    mapper = system.mapper
    rec = {name: _Recorder(getattr(mapper, name)) for name in MAPPER_GRAPHS}
    for name, r in rec.items():
        setattr(mapper, name, r)
    rec["bow"] = vocabulary._transform_graph = _Recorder(
        vocabulary._transform_graph)
    before = []
    process = mapper.process_keyframe

    def snapshot(kid, queue_pressure=False):
        before.append((kid, interop.mapstore_state(system.store),
                       list(mapper.recent_points)))
        process(kid, queue_pressure)
    mapper.process_keyframe = snapshot
    try:
        for i, T in enumerate(poses):
            system.track_monocular_with_pose(synth.render(world, cfg.cam, T),
                                             i * 0.1, T)
        system.flush_tracking()
        torch.cuda.synchronize()
    finally:
        vocabulary._transform_graph = rec["bow"].graph
    system.shutdown()
    return dict(cfg=cfg, rec=rec, before=before)


def _leaves(out):
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


@pytest.mark.gpu
def test_graphed_mapper_functions_equal_eager_on_card(mapped_run):
    """Every call the mapper made through its graphs (triangulation,
    both fuse directions, the compacted lists, the structure-BA chunks)
    and the vocabulary descent, against the eager function on the same
    arguments: the replayed outputs equal it bit for bit, at the call
    and replayed once more; each function captured at most MAXSIZE
    times."""
    from orb_slam2_tpu_torch import graphs
    rec = mapped_run["rec"]
    for name, r in rec.items():
        assert r.calls, f"{name} was never called"
        for k, (args, out) in enumerate(r.calls):
            want = _leaves(r.graph.fn(*args))
            again = _leaves(r.graph(*args))
            for j, (a, b, c) in enumerate(zip(_leaves(out), want, again)):
                assert torch.equal(a, b), (name, k, j)
                assert torch.equal(c, b), (name, k, j)
        assert r.graph.n_captures() <= graphs.MAXSIZE
    assert len(rec["_fuse_fwd"].calls) >= len(rec["_fuse_rev"].calls)
    assert len(rec["_sba_step"].calls) % 2 == 0     # 10 iterations: 5 + 5


@pytest.mark.gpu
def test_warm_mapper_chunks_make_no_host_sync(mapped_run):
    """A warm triangulation, fuse and structure-BA chunk (replays of the
    captures the run made) queue their work without waiting for the
    card: no host sync under ``set_sync_debug_mode("error")``."""
    rec = mapped_run["rec"]
    for name in ("_tri_step", "_fuse_fwd", "_fuse_rev", "_compact",
                 "_sba_step", "bow"):
        args, _ = rec[name].calls[-1]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            rec[name].graph(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)


@pytest.mark.gpu
def test_mapper_capture_beside_tracker_replays(mapped_run, cuda):
    """A fresh capture of the structure-BA chunk and of the
    triangulation on a second thread while the first thread replays the
    tracker's fused step 50 times: every result equals its eager call."""
    import threading
    from orb_slam2_tpu_torch import graphs
    from orb_slam2_tpu_torch.pipeline import local_mapping, tracking
    step = graphs.graphed(tracking._prior_step_core, "prior_step")
    args = scene_tensors(prior_step_scene("some"), cuda)
    want = tracking._prior_step_core(*args)
    step(*args)                              # captured before the thread
    jobs = [(graphs.graphed(local_mapping._sba_step_gathered, "sba"),
             mapped_run["rec"]["_sba_step"].calls[-1][0]),
            (graphs.graphed(local_mapping._triangulate_neighbors_fused,
                            "tri"),
             mapped_run["rec"]["_tri_step"].calls[-1][0])]
    got, errors = [], []

    def mapper_thread():
        try:
            for g, a in jobs:
                got.append((g(*a), g.fn(*a)))
        except Exception as e:               # re-raised below
            errors.append(e)
    th = threading.Thread(target=mapper_thread)
    th.start()
    outs = [step(*args) for _ in range(50)]
    th.join(timeout=600)
    assert not th.is_alive() and not errors, errors
    torch.cuda.synchronize()
    for out in outs:
        for a, b in zip(out, want):
            assert torch.equal(a, b)
    for g, a in jobs:
        assert g.n_captures() == 1
    for out, eager in got:
        for a, b in zip(out, eager):
            assert torch.equal(a, b)


def _map_one(cuda, state, cfg, eager: bool):
    """Map keyframe ``kid`` from the map state ``state`` with a fresh
    LocalMapper, eagerly or through the graphs (its first call of each
    function captures); returns the launch counts and the map."""
    from orb_slam2_tpu_torch import graphs, interop
    from orb_slam2_tpu_torch.pipeline.local_mapping import LocalMapper
    kid, snap, recent = state
    store = interop.mapstore_from_numpy(**snap, device=cuda)
    mapper = LocalMapper(cfg, store)
    mapper.recent_points = list(recent)
    call = graphs.Graphed.__call__
    if eager:
        graphs.Graphed.__call__ = lambda self, *a: self.fn(*a)
    try:
        kernels.reset_launch_counts()
        mapper.process_keyframe(kid)
        torch.cuda.synchronize()
        launches = (dict(kernels.LAUNCHES), dict(kernels.SHAPES))
    finally:
        graphs.Graphed.__call__ = call
    return launches, interop.mapstore_state(store)


@pytest.mark.gpu
def test_mapped_keyframe_launches_as_eager(mapped_run, cuda):
    """The run's last mapped keyframe mapped again from the state before
    it, eagerly and through the graphs: the same kernel launches, per
    kernel and per search shape (a replay counts what its capture
    launched), and the same map bit for bit (points, validity,
    observations, keyframes)."""
    state = mapped_run["before"][-1]
    eager, m_eager = _map_one(cuda, state, mapped_run["cfg"], eager=True)
    graph, m_graph = _map_one(cuda, state, mapped_run["cfg"], eager=False)
    assert eager == graph
    assert eager[0]["masked_top2_epi"] > 0
    assert eager[0]["masked_top2_mutual"] > 0
    for name in ("mp_pos", "mp_valid", "mp_desc", "mp_normal"):
        np.testing.assert_array_equal(m_eager["points"][name],
                                      m_graph["points"][name], err_msg=name)
    assert m_eager["mp_obs"] == m_graph["mp_obs"]
    assert [k["valid"] for k in m_eager["keyframes"]] == \
        [k["valid"] for k in m_graph["keyframes"]]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [50000, 100])
@pytest.mark.parametrize("trail", [(), (3,), (3, 3)])
def test_index_sum_host_given_choice(cuda, n, trail):
    """``IndexSum`` told the longest segment (``np.bincount(idx).max()``,
    known on the host) makes the choice the one that reads it makes,
    and sums bit for bit as it does; made and called with the length
    given, it waits for the card nowhere (argsort, searchsorted and
    ``segment_reduce(unsafe=True)`` queue without a sync)."""
    rng = np.random.default_rng(n + len(trail))
    idx_np = rng.integers(0, n, 200000)
    idx = torch.as_tensor(idx_np).to(cuda)
    vals = torch.as_tensor(rng.standard_normal((200000,) + trail)
                           .astype(np.float32)).to(cuda)
    read = IndexSum(idx, n)
    longest = int(np.bincount(idx_np, minlength=n).max())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        given = IndexSum(idx, n, longest=longest)
        out = given(vals)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert given.long == read.long == (n == 100)
    assert torch.equal(out, read(vals))


# ----------------------------------------------------------------------
# loop closing's CUDA graphs (pipeline/loop_closing.py; the step programs
# of optim/sim3_opt.py, optim/pose_graph.py, optim/ba.py) against their
# eager calls
# ----------------------------------------------------------------------
LOOP_GRAPHS = ("_match_bow", "_ransac", "_match_sim3", "_match_proj")
# the solvers' step programs, module attributes their entry points call
STEP_GRAPHS = (("sim3_opt", "_round_graph"), ("pose_graph", "_step_graph"),
               ("pose_graph", "_cost_graph"), ("ba", "_begin_graph"),
               ("ba", "_step_graph"), ("ba", "_finish_graph"))


def _step_modules():
    from orb_slam2_tpu_torch.optim import ba, pose_graph, sim3_opt
    return dict(ba=ba, pose_graph=pose_graph, sim3_opt=sim3_opt)


@pytest.fixture(scope="module")
def loop_run():
    """tests/test_torch_loop.py's drifted 640x480 circuit (40 frames and
    14 again, priors drifting 0.02 a frame) on the card with sequential
    mapping and loop closing; every call of the LoopCloser's graphs (BoW
    match, RANSAC, both Sim3 searches) and of the solvers' step programs
    (the Sim3 rounds, the essential graph's and global BA's LM
    iterations) recorded."""
    cuda = cuda_device()
    cfg = _mapper_config(loop_min_kfs_since_last=6)
    world = synth.make_world(seed=3, device=cuda)
    true = synth.loop_trajectory(40, radius=8.0)
    true = true + true[:14]
    system = System(cfg, enable_loop_closing=True, device=cuda)
    lc = system.loop_closer
    rec = {name: _Recorder(getattr(lc, name)) for name in LOOP_GRAPHS}
    for name, r in rec.items():
        setattr(lc, name, r)
    mods = _step_modules()
    for mod, name in STEP_GRAPHS:
        rec[f"{mod}.{name}"] = _Recorder(getattr(mods[mod], name))
        setattr(mods[mod], name, rec[f"{mod}.{name}"])
    try:
        for t, Tcw in enumerate(true):
            D = np.eye(4, dtype=np.float32)
            D[:3, 3] = [0.02 * t, 0.01 * t, 0.0]
            system.track_monocular_with_pose(
                synth.render(world, cfg.cam, Tcw), t * 0.1,
                (Tcw @ np.linalg.inv(D)).astype(np.float32))
        torch.cuda.synchronize()
    finally:
        for mod, name in STEP_GRAPHS:
            setattr(mods[mod], name, rec[f"{mod}.{name}"].graph)
    n_loops = lc.n_loops_closed
    system.shutdown()
    return dict(rec=rec, n_loops=n_loops)


@pytest.mark.gpu
def test_graphed_loop_programs_equal_eager_on_card(loop_run):
    """The circuit closes its loop; every call the loop closer made
    through a graph (the BoW match, the RANSAC, both Sim3 searches, the
    Sim3 rounds, the essential graph's and global BA's steps) against
    the eager function on the same arguments: bit for bit, at the call
    and replayed once more; each captured at most MAXSIZE times."""
    from orb_slam2_tpu_torch import graphs
    assert loop_run["n_loops"] >= 1
    for name, r in loop_run["rec"].items():
        assert r.calls, f"{name} was never called"
        for k, (args, out) in enumerate(r.calls):
            want = _leaves_all(r.graph.fn(*args))
            again = _leaves_all(r.graph(*args))
            for j, (a, b, c) in enumerate(zip(_leaves_all(out), want, again)):
                assert torch.equal(a, b), (name, k, j)
                assert torch.equal(c, b), (name, k, j)
        assert r.graph.n_captures() <= graphs.MAXSIZE


def _leaves_all(out):
    if isinstance(out, torch.Tensor):
        return (out,)
    return tuple(x for o in out for x in _leaves_all(o))


@pytest.mark.gpu
def test_warm_loop_programs_make_no_host_sync(loop_run):
    """A warm replay of each loop program (the captures the run made)
    queues its work without waiting for the card: no host sync under
    ``set_sync_debug_mode("error")``."""
    for name, r in loop_run["rec"].items():
        args, _ = r.calls[-1]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            r.graph(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)


def _eager_call(fn, *args, **kwargs):
    """``fn`` with every CUDA graph run as its eager function."""
    from orb_slam2_tpu_torch import graphs
    call = graphs.Graphed.__call__
    graphs.Graphed.__call__ = lambda self, *a: self.fn(*a)
    try:
        return fn(*args, **kwargs)
    finally:
        graphs.Graphed.__call__ = call


def _path_b_problems(cuda):
    """Synthetic problems at path B's padded shapes (chip_smoke.py's
    loop at 1920x1440): global BA 128 keyframe rows, 65,536 point rows,
    262,144 observation rows (8 keyframes over 19,458 points: ~150,000
    observations); the essential graph 128 vertices, 1,024 edge rows;
    a Sim3 match set of 1,024 rows."""
    from orb_slam2_tpu_torch.geom import sim3
    from orb_slam2_tpu_torch.optim import segment
    rng = np.random.default_rng(12)
    cams, pts, oc, op, ouv, isig, valid, fixed = _ba_scene(
        seed=12, n_cams=8, n_pts=19458)
    K, P, O = 128, 65536, 262144
    n = len(oc)
    cams = np.concatenate([cams, np.broadcast_to(
        np.eye(4, dtype=np.float32), (K - len(cams), 4, 4))])
    fixed = np.r_[fixed, np.ones(K - len(fixed), bool)]
    ba_args = [cams, np.pad(pts, ((0, P - len(pts)), (0, 0))),
               np.pad(oc, (0, O - n)), np.pad(op, (0, O - n)),
               np.pad(ouv, ((0, O - n), (0, 0))), np.pad(isig, (0, O - n)),
               np.pad(valid, (0, O - n)), fixed]
    Kv, E = 128, 1024
    xi = rng.normal(0, 0.3, (Kv, 7)).astype(np.float32)
    xi[:, 6] *= 0.05
    true = sim3.exp(torch.from_numpy(xi))
    ei = np.r_[np.arange(Kv - 1), rng.integers(0, Kv, 772),
               np.zeros(E - Kv + 1 - 772, int)]
    ej = np.r_[np.arange(1, Kv), rng.integers(0, Kv, 772),
               np.zeros(E - Kv + 1 - 772, int)]
    meas = sim3.compose(true[ej], sim3.inv(true[ei])).numpy()
    w = np.r_[np.ones(Kv - 1 + 772), np.zeros(E - Kv + 1 - 772)].astype(
        np.float32) * (ei != ej)
    drift = np.cumsum(rng.normal(0, 0.01, (Kv, 7)), 0).astype(np.float32)
    sims0 = sim3.compose(sim3.exp(torch.from_numpy(drift)), true).numpy()
    pg_fixed = np.zeros(Kv, bool)
    pg_fixed[0] = True
    pg_args = [sims0, ei.astype(np.int64), ej.astype(np.int64), meas, w,
               pg_fixed]
    M = 1024
    S12 = sim3.exp(torch.tensor([0.3, -0.2, 0.1, 0.02, -0.05, 0.03, 0.0]))
    p2 = np.c_[rng.uniform(-3, 3, (M, 2)), rng.uniform(8, 12, M)].astype(
        np.float32)
    p1 = sim3.apply(S12, torch.from_numpy(p2)).numpy()

    def proj(p):
        return np.stack([450.0 * p[:, 0] / p[:, 2] + 960.0,
                         450.0 * p[:, 1] / p[:, 2] + 720.0], -1)
    uv1 = (proj(p1) + rng.normal(0, 0.7, (M, 2))).astype(np.float32)
    uv2 = (proj(p2) + rng.normal(0, 0.7, (M, 2))).astype(np.float32)
    sig = np.ones(M, np.float32)
    sim_valid = np.arange(M) < 700
    samples = rng.integers(0, 700, (256, 3)).astype(np.int32)
    t = lambda a: torch.as_tensor(a).to(cuda)      # noqa: E731
    return dict(
        ba=([t(a) for a in ba_args], dict(
            iters=10, cg_iters=30, use_huber=True,
            longest_cam=segment.longest_segment(ba_args[2], K),
            longest_pt=segment.longest_segment(ba_args[3], P))),
        pose_graph=([t(a) for a in pg_args], dict(
            iters=20, cg_iters=30, longest=segment.longest_segment(
                np.concatenate([ei, ej]), Kv))),
        sim3_opt=([t(S12.numpy())] + [t(a) for a in (
            p1, p2, uv1, uv2, sig, sig, sim_valid)], dict(iters=8)),
        ransac=[t(a) for a in (p1, p2, uv1, uv2, 9.21 * sig, 9.21 * sig,
                               sim_valid, samples)])


@pytest.mark.gpu
def test_loop_solvers_at_path_b_shapes(cuda):
    """At path B's padded shapes: ``bundle_adjust``,
    ``optimize_pose_graph`` and ``optimize_sim3`` through their step
    graphs, and the Sim3 RANSAC as one graph, against the same calls
    with every graph run eagerly, bit for bit; a warm call of each
    makes no host sync; each step program captured at most MAXSIZE
    times."""
    from orb_slam2_tpu_torch import graphs
    from orb_slam2_tpu_torch.optim import ba, pose_graph, sim3_opt, sim3_ransac
    pr = _path_b_problems(cuda)
    ransac = graphs.graphed(sim3_ransac.sim3_ransac, "ransac")
    calls = [
        (ba.bundle_adjust, pr["ba"][0] + [450.0, 450.0, 960.0, 720.0],
         pr["ba"][1]),
        (pose_graph.optimize_pose_graph, pr["pose_graph"][0],
         pr["pose_graph"][1]),
        (sim3_opt.optimize_sim3, pr["sim3_opt"][0] + [450.0, 450.0, 960.0,
                                                      720.0],
         pr["sim3_opt"][1]),
        (ransac, pr["ransac"] + [450.0, 450.0, 960.0, 720.0, 20, False],
         {})]
    for fn, args, kw in calls:
        got = _leaves_all(fn(*args, **kw))
        want = _leaves_all(_eager_call(fn, *args, **kw))
        torch.cuda.synchronize()
        for j, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), (fn, j)
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for mod, name in STEP_GRAPHS:
        assert getattr(_step_modules()[mod], name).n_captures() \
            <= graphs.MAXSIZE


@pytest.mark.gpu
def test_loop_capture_beside_tracker_replays(loop_run, cuda):
    """Fresh captures of global BA's step and the essential graph's step
    on a second thread (the mapping thread, where the loop closer runs)
    while the first thread replays the tracker's fused step 50 times:
    every result equals its eager call."""
    import threading
    from orb_slam2_tpu_torch import graphs
    from orb_slam2_tpu_torch.optim import ba, pose_graph
    from orb_slam2_tpu_torch.pipeline import tracking
    step = graphs.graphed(tracking._prior_step_core, "prior_step")
    args = scene_tensors(prior_step_scene("some"), cuda)
    want = tracking._prior_step_core(*args)
    step(*args)                              # captured before the thread
    rec = loop_run["rec"]
    jobs = [(graphs.graphed(ba._ba_step, "ba"),
             rec["ba._step_graph"].calls[-1][0]),
            (graphs.graphed(pose_graph._pg_step, "pg"),
             rec["pose_graph._step_graph"].calls[-1][0])]
    got, errors = [], []

    def mapper_thread():
        try:
            for g, a in jobs:
                got.append((g(*a), g.fn(*a)))
        except Exception as e:               # re-raised below
            errors.append(e)
    th = threading.Thread(target=mapper_thread)
    th.start()
    outs = [step(*args) for _ in range(50)]
    th.join(timeout=600)
    assert not th.is_alive() and not errors, errors
    torch.cuda.synchronize()
    for out in outs:
        for a, b in zip(out, want):
            assert torch.equal(a, b)
    for g, a in jobs:
        assert g.n_captures() == 1
    for out, eager in got:
        for a, b in zip(_leaves_all(out), _leaves_all(eager)):
            assert torch.equal(a, b)


# ----------------------------------------------------------------------
# estimated-pose mode's CUDA graphs (pipeline/tracking.py,
# pipeline/relocalization.py) against their eager calls
# ----------------------------------------------------------------------
# (module, attribute) of each graph the tracker and the relocalizer call
ESTIMATED_GRAPHS = (
    ("tracking", "match_last_graph"), ("tracking", "frustum_graph"),
    ("tracking", "pose_opt_graph"), ("tracking", "chi2_gate_graph"),
    ("tracking", "descriptors_graph"), ("relocalization", "pnp_graph"),
    ("relocalization", "kf_projection_graph"))


def _estimated_modules():
    from orb_slam2_tpu_torch.pipeline import relocalization, tracking
    return dict(tracking=tracking, relocalization=relocalization)


def _signature(args):
    """What a graph keys its captures by (graphs.Graphed)."""
    return tuple((tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor)
                 else a for a in args)


@pytest.fixture(scope="module")
def estimated_run():
    """tests/test_torch_estimated.py's sweep on the card (640x480, 800
    features, 4 levels, 30 frames, ``track_monocular`` with no pose,
    sequential mapping; the last frame and velocity kept), then a noise
    frame and the image of a mapped
    frame again (an EPnP relocalization), then the pose-prior chi2 gate
    and the relocalizer's projection search once on the relocalized
    frame; every call of the estimated-mode graphs recorded, and the
    tracker in its final state."""
    import copy
    cuda = cuda_device()
    from orb_slam2_tpu_torch.pipeline.tracking import TrackState
    cam = Intrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640,
                     height=480)
    cfg = SlamConfig(cam=cam, orb=OrbParams(n_features=800, n_levels=4),
                     fps=10.0, pose_prior=False, init_min_matches=60,
                     init_min_triangulated=40, init_min_tracked_after_ba=60)
    world = synth.make_world(seed=3, device=cuda)
    poses = synth.aerial_trajectory(31, speed=0.3)
    images = [synth.render(world, cam, T) for T in poses]
    system = System(cfg, enable_loop_closing=False, device=cuda)
    from orb_slam2_tpu_torch import graphs
    mods = _estimated_modules()
    rec = {}
    for mod, name in ESTIMATED_GRAPHS:
        rec[name] = _Recorder(getattr(mods[mod], name))
        setattr(mods[mod], name, rec[name])

    def captures():
        # the graphs are module-level: earlier tests' captures count too
        return {name: graphs.STATS.get(r.graph.name, {}).get("captures", 0)
                for name, r in rec.items()}
    before = captures()
    try:
        states = []
        for i, img in enumerate(images[:30]):
            system.track_monocular(img, i * 0.1)
            states.append(system.state)
        steady = dict(last=system.tracker.last_frame,
                      velocity=system.tracker.velocity)
        noise = torch.rand(480, 640, device=cuda) * 255
        system.track_monocular(noise, 3.0)
        lost = system.state
        frame = system.track_monocular(images[20], 3.1)
        relocalized = system.tracker.last_reloc_frame_id == frame.frame_id
        tr = system.tracker
        fcopy = copy.copy(tr.last_frame)
        fcopy.mp_ids = tr.last_frame.mp_ids.copy()
        tr._pose_chi2_filter(fcopy)
        fcopy.mp_ids[:] = -1
        system.relocalizer._project_kf_points(
            system.store.valid_kf_ids()[-1], fcopy, th=10.0)
        torch.cuda.synchronize()
        after = captures()
        new_captures = {k: after[k] - before[k] for k in rec}
    finally:
        for mod, name in ESTIMATED_GRAPHS:
            setattr(mods[mod], name, rec[name].graph)
    out = dict(rec=rec, states=states, lost=lost, relocalized=relocalized,
               system=system, images=images, steady=steady,
               new_captures=new_captures, TrackState=TrackState)
    yield out
    system.shutdown()


@pytest.mark.gpu
def test_graphed_estimated_programs_equal_eager_on_card(estimated_run):
    """The sweep tracks and relocalizes; every call the tracker and the
    relocalizer made through a graph (the last-frame and local-map
    searches, the pose optimization, the descriptor search, the EPnP
    RANSAC, the projection search; the chi2 gate once) against the
    eager function on the same arguments: bit for bit, at the call and
    replayed once more; each graph captured at most once per signature
    the run gave it (the run's captures: the graphs are module-level,
    and earlier tests' captures stay in their counts)."""
    TS = estimated_run["TrackState"]
    states = estimated_run["states"]
    assert states[-1] == TS.OK and states.count(TS.OK) >= 25
    assert estimated_run["lost"] == TS.LOST
    assert estimated_run["relocalized"]
    for name, r in estimated_run["rec"].items():
        assert r.calls, f"{name} was never called"
        for k, (args, out) in enumerate(r.calls):
            want = _leaves_all(r.graph.fn(*args))
            again = _leaves_all(r.graph(*args))
            for j, (a, b, c) in enumerate(zip(_leaves_all(out), want,
                                              again)):
                assert torch.equal(a, b), (name, k, j)
                assert torch.equal(c, b), (name, k, j)
        n_sig = len({_signature(args) for args, _ in r.calls})
        assert estimated_run["new_captures"][name] <= n_sig, (name, n_sig)


@pytest.mark.gpu
def test_warm_estimated_programs_make_no_host_sync(estimated_run):
    """A warm replay of each estimated-mode program queues its work
    without waiting for the card: no host sync under
    ``set_sync_debug_mode("error")``."""
    for name, r in estimated_run["rec"].items():
        args, _ = r.calls[-1]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            r.graph(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)


@pytest.mark.gpu
def test_warm_estimated_stages_make_no_host_sync(estimated_run):
    """The tracker's per-frame stages of estimated mode (the motion
    model with its last-frame search and pose optimization, then the
    local-map search and pose optimization) on the sweep's next frame,
    from its last frame and velocity, twice: the second call, its
    programs captured, makes no host sync under
    ``set_sync_debug_mode("error")`` (the host reads go through
    ``graphs.Readback``'s pinned copies)."""
    tr = estimated_run["system"].tracker
    steady = estimated_run["steady"]
    frame = tr.factory.make(estimated_run["images"][30], 3.2)
    Tcw0 = frame.Tcw
    for attempt in range(2):
        frame.mp_ids[:] = -1
        frame.mp_outlier[:] = False
        frame.Tcw = Tcw0
        tr.last_frame = steady["last"]
        tr.velocity = steady["velocity"]
        torch.cuda.synchronize()
        if attempt:
            torch.cuda.set_sync_debug_mode("error")
        try:
            ok = tr._track_motion_model(frame) and tr._track_local_map(frame)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert ok


def _estimated_shapes(cuda):
    """Synthetic inputs at path D's padded shapes (chip_smoke.py's
    1920x1440 sweep, 4000 features = 4096 rows): a 4,096-feature frame
    on 8 levels; 1,800 bound points (4,096 rows); 3,000 local-map
    candidates (4,096 rows); 300 BoW-matched rows (1,024) and 300 EPnP
    correspondences (1,024 rows) with 128 minimal sets."""
    rng = np.random.default_rng(21)
    m, levels = 4096, 8
    fx, fy, cx, cy = 1350.0, 1350.0, 960.0, 720.0
    P = _pose([0.1, -0.2, 0.05], [0.3, -0.2, 0.5])
    sf = (1.2 ** np.arange(levels)).astype(np.float32)
    isig = (1.0 / sf ** 2).astype(np.float32)

    def scene(n):
        pw = rng.uniform([-6, -5, 8], [6, 5, 14], (n, 3)).astype(np.float32)
        pw = pw @ P[:3, :3] - (P[:3, 3] @ P[:3, :3])
        pc = pw @ P[:3, :3].T + P[:3, 3]
        uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                       fy * pc[:, 1] / pc[:, 2] + cy], -1).astype(np.float32)
        return pw, uv

    pw, uv = scene(m)
    kp_xy = (uv + rng.normal(0, 0.7, uv.shape)).astype(np.float32)
    kp_oct = rng.integers(0, levels, m).astype(np.int32)
    kp_desc = _rand_desc(rng, m).view(np.int32)
    kp_angle = rng.uniform(0, 360, m).astype(np.float32)
    kp_valid = np.arange(m) < 4000
    t = lambda a: torch.as_tensor(np.asarray(a)).to(cuda)   # noqa: E731
    kp = [t(a) for a in (kp_xy, kp_oct, kp_desc, kp_valid, kp_angle)]
    cam = (fx, fy, cx, cy)
    bounds = (0.0, 1920.0, 0.0, 1440.0)

    def rows(n, size):
        ids = rng.permutation(4000)[:n]
        return ids, np.arange(size) < n, np.pad(ids, (0, size - n))

    ids, v, pad_ids = rows(1800, 4096)
    P0 = P.copy()
    P0[:3, 3] += [0.02, -0.01, 0.01]
    pos = np.pad(pw[ids], ((0, 4096 - 1800), (0, 0)))
    pose = [t(P0), t(pos), t(pad_ids), kp[0], kp[1], t(isig), t(v), *cam]
    last = [t(np.pad(pad_ids[:1800], (0, 2296))), t(kp_oct), t(kp_desc),
            t(kp_angle)]
    match_last = [t(P0), t(pos), t(v), last[0], last[1], last[2], last[3],
                  kp[0], kp[1], kp[2], kp[3], kp[4], t(sf), t(isig), *cam,
                  bounds, 15.0, 0.0]
    cids, cv, _ = rows(3000, 4096)
    cpos = np.pad(pw[cids], ((0, 1096), (0, 0)))
    center = -P0[:3, :3].T @ P0[:3, 3]
    d = cpos - center
    dist = np.linalg.norm(d, axis=1).astype(np.float32) + 1e-3
    normal = (d / dist[:, None]).astype(np.float32)
    max_d = dist * sf[np.pad(kp_oct[cids], (0, 1096))]
    has = np.zeros(m, bool)
    has[ids] = True
    frustum = [t(cpos), t(normal), t(max_d / sf[-1]), t(max_d), t(cv),
               t(np.pad(kp_desc[cids], ((0, 1096), (0, 0)))), t(P0),
               kp[0], kp[1], kp[2], kp[3], t(has), t(pos), t(pad_ids), t(v),
               t(sf), t(isig), *cam, bounds, levels, float(np.log(1.2)),
               1.0, 0.0]
    chi2 = [t(P0), t(pos), t(pad_ids), kp[0], kp[1], t(isig), t(v), *cam,
            5.991]
    bids, bv, bpad = rows(300, 1024)
    nodes = rng.integers(0, 50, m).astype(np.int32)
    desc = [t(np.pad(kp_desc[bids], ((0, 724), (0, 0)))), t(bv),
            t(np.pad(kp_angle[bids], (0, 724)))]
    bow = [*desc, t(np.pad(nodes[bids], (0, 724), constant_values=-1)),
           kp[2], kp[3], kp[4], t(nodes), 0.75]
    bow_free = [*desc, None, kp[2], kp[3], kp[4], None, 0.7]
    out = np.arange(300) >= 240
    uv_pnp = kp_xy[bids] + out[:, None] * rng.uniform(30, 120, (300, 2))
    pnp_args = [t(np.pad(pw[bids], ((0, 724), (0, 0)))),
                t(np.pad(uv_pnp.astype(np.float32), ((0, 724), (0, 0)))),
                t(np.pad(isig[kp_oct[bids]], (0, 724))), t(bv),
                t(rng.integers(0, 300, (128, 4)).astype(np.int32)), *cam, 10]
    proj = [t(np.pad(uv[bids], ((0, 724), (0, 0)))),
            t(np.pad(kp_oct[bids], (0, 724)).astype(np.int64)), desc[0],
            t(bv), desc[2], kp[0], kp[1], kp[2], t(kp_valid & ~has), kp[4],
            t(sf), 10.0]
    return dict(pose_opt_graph=pose, match_last_graph=match_last,
                frustum_graph=frustum, chi2_gate_graph=chi2,
                descriptors_graph=[bow, bow_free], pnp_graph=pnp_args,
                kf_projection_graph=proj)


@pytest.mark.gpu
def test_estimated_programs_at_path_d_shapes(cuda):
    """At path D's padded shapes: each estimated-mode graph against the
    same call run eagerly, bit for bit (the descriptor search with and
    without BoW nodes, two signatures); a warm call of each makes no
    host sync; each captured at most MAXSIZE times."""
    from orb_slam2_tpu_torch import graphs
    mods = _estimated_modules()
    problems = _estimated_shapes(cuda)
    for mod, name in ESTIMATED_GRAPHS:
        g = getattr(mods[mod], name)
        calls = problems[name]
        for args in (calls if name == "descriptors_graph" else [calls]):
            got = _leaves_all(g(*args))
            want = _leaves_all(_eager_call(g, *args))
            torch.cuda.synchronize()
            for j, (a, b) in enumerate(zip(got, want)):
                assert torch.equal(a, b), (name, j)
            torch.cuda.set_sync_debug_mode("error")
            try:
                g(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        assert g.n_captures() <= graphs.MAXSIZE
