"""The port's kernel modules against the JAX package: K1 (FAST score),
K2 (windowed Hamming top-2) and K3 (epipolar Hamming top-2).

On the CPU each port wrapper runs its plain PyTorch version; those are
held bit for bit to the JAX reference (the Pallas kernels in interpret
mode, as tests/test_pallas_hamming.py runs them, and the XLA
``fast_score_map`` twin of K1).  The CUDA kernels themselves are tested
against the plain versions on the card by tests/test_torch_gpu.py."""
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.matching import pallas_hamming as jph
from orb_slam2_tpu.ops import (brief as jbrief, distribute as jdist,
                               fast as jfast, pyramid as jpyr)
from orb_slam2_tpu_torch import kernels
from orb_slam2_tpu_torch.matching import hamming_top2 as ht
from orb_slam2_tpu_torch.ops import (brief as tbrief, distribute as tdist,
                                     fast as tfast, pyramid as tpyr)
from test_torch_gpu import _epi_problem, _t, _window_problem

torch.set_num_threads(1)


# ----------------------------------------------------------------------
# K1: FAST score map
# ----------------------------------------------------------------------
class TestFastScore:
    """Bar: bit-exact on [3:-3, 3:-3].  Both compute in bf16 with the
    same roundings (input, each ring difference), and min/max are exact;
    the outer 3 px are the wrap-around frame both plain versions share
    and the detector's 16 px border masks."""

    @pytest.mark.parametrize("shape", [(64, 96), (97, 131)])
    def test_integer_image(self, shape):
        img = np.random.default_rng(0).integers(0, 256, shape).astype(np.float32)
        ref = np.asarray(jfast.fast_score_map(jnp.asarray(img)))
        out = tfast.score_map(torch.from_numpy(img)).numpy()
        np.testing.assert_array_equal(out[3:-3, 3:-3], ref[3:-3, 3:-3])

    def test_resized_levels(self):
        """Non-integer pyramid levels: the same level image goes into
        both, so the bf16 rounding of each difference is exercised."""
        rng = np.random.default_rng(1)
        img = rng.integers(0, 256, (120, 160)).astype(np.float32)
        for lvl in jpyr.build_pyramid(jnp.asarray(img), 4, 1.2)[1:]:
            lvl = np.array(lvl)
            assert not np.all(lvl == np.round(lvl))
            ref = np.asarray(jfast.fast_score_map(jnp.asarray(lvl)))
            out = tfast.fast_score_map(torch.from_numpy(lvl)).numpy()
            np.testing.assert_array_equal(out[3:-3, 3:-3], ref[3:-3, 3:-3])

    def test_kernel_wrapper_refuses_cpu_tensor(self):
        with pytest.raises(ValueError):
            tfast.fast_score(torch.zeros(32, 32))


# ----------------------------------------------------------------------
# K2 / K3: masked Hamming top-2
# ----------------------------------------------------------------------
class TestMaskedTop2:
    """Bar: keys bit-exact against the Pallas kernels run in interpret
    mode — integer distances, exact comparisons, and the line test
    rounding each product and sum the same way."""

    @pytest.mark.parametrize("n,m", [(256, 256), (256, 384), (384, 128)])
    def test_mutual_matches_pallas(self, n, m):
        d1, d2, ra, ca = _window_problem(n + m, n, m)
        ref = jph.masked_top2_mutual(jnp.asarray(d1), jnp.asarray(d2),
                                     jnp.asarray(ra), jnp.asarray(ca),
                                     interpret=True)
        out = ht.masked_top2_mutual(_t(d1), _t(d2), _t(ra), _t(ca))
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        assert (out[0].numpy() // ht.COL_STRIDE <= 100).sum() > n // 4

    @pytest.mark.parametrize("n,m", [(256, 256), (128, 384)])
    def test_epi_matches_pallas(self, n, m):
        d1, d2, ra, ca = _epi_problem(n * m, n, m)
        ref = jph.masked_top2_epi(jnp.asarray(d1), jnp.asarray(d2),
                                  jnp.asarray(ra), jnp.asarray(ca),
                                  interpret=True)
        out = ht.masked_top2_epi(_t(d1), _t(d2), _t(ra), _t(ca))
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        assert (out[0].numpy() // ht.COL_STRIDE < ht.MASK_D).sum() > 0

    def test_cpu_tensors_run_the_plain_version(self):
        kernels.reset_launch_counts()
        d1, d2, ra, ca = _window_problem(5, 128, 128)
        out = ht.masked_top2_mutual(_t(d1), _t(d2), _t(ra), _t(ca))
        ref = ht.masked_top2_mutual_plain(_t(d1), _t(d2), _t(ra), _t(ca))
        for o, r in zip(out, ref):
            assert torch.equal(o, r)
        assert sum(kernels.LAUNCHES.values()) == 0

    @pytest.mark.parametrize("n,m", [(16384 + 128, 128), (128, 4096 + 128)])
    @pytest.mark.parametrize("fn", ["mutual", "epi"])
    def test_size_guard(self, n, m, fn):
        """Keys alias past M = 4096 columns or N = 16384 rows, so both
        the plain versions and the kernel wrappers refuse such shapes."""
        n_attr = 6 if fn == "mutual" else 4
        d1 = torch.zeros((n, 8), dtype=torch.int32)
        d2 = torch.zeros((m, 8), dtype=torch.int32)
        ra = torch.zeros((n, n_attr))
        ca = torch.zeros((m, 4))
        plain = (ht.masked_top2_mutual_plain if fn == "mutual"
                 else ht.masked_top2_epi_plain)
        with pytest.raises(ValueError, match="keys need"):
            plain(d1, d2, ra, ca)
        with pytest.raises(ValueError, match="keys need"):
            ht._launch(f"masked_top2_{fn}", d1, d2, ra, ca, n_attr)

    def test_tall_row_sets_split_into_chunks(self):
        """_windowed_top2 splits rows past ROW_STRIDE; the column-best
        row over the chunks equals the direct (distance, row) minimum."""
        from orb_slam2_tpu_torch.matching import search
        d1, d2, ra, ca = _window_problem(9, 256, 128)
        reps = ht.ROW_STRIDE // 256 + 1          # > ROW_STRIDE rows
        d1 = np.tile(d1, (reps, 1))
        ra = np.tile(ra, (reps, 1))
        best, bidx, _, _, col_row = search._windowed_top2(
            _t(d1), _t(d2), _t(ra[:, :2]), _t(ra[:, 2]), _t(ra[:, 3]),
            _t(ra[:, 4]), _t(ra[:, 5] > 0), _t(ca[:, :2]), _t(ca[:, 2]),
            _t(ca[:, 3] > 0))
        # rows repeat every 256: every column's best row is in the first
        # copy, and every copy sees the same row results
        assert int(col_row.max()) < 256
        np.testing.assert_array_equal(best.numpy().reshape(reps, 256),
                                      np.tile(best.numpy()[:256], (reps, 1)))


# ----------------------------------------------------------------------
# hazard pins and shared constants
# ----------------------------------------------------------------------
def test_grid_topk_ties_lowest_index_first():
    """Integer FAST scores tie often; lax.top_k returns ties lowest
    index first and torch.topk promises no order.  On a tie-heavy map
    the port must select the same corners in the same order."""
    rng = np.random.default_rng(3)
    score = rng.integers(8, 12, (96, 128)).astype(np.float32)  # 4 values
    mask = rng.random((96, 128)) < 0.5
    ref = jdist.grid_topk(jnp.asarray(mask), jnp.asarray(score), 150)
    out = tdist.grid_topk(torch.from_numpy(mask), torch.from_numpy(score), 150)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_brief_pattern_and_weights_identical():
    """The BRIEF pattern and bin weights are the only fixed parameters;
    both packages build them with the same numpy code."""
    np.testing.assert_array_equal(tbrief.get_pattern("random"),
                                  jbrief.get_pattern("random"))
    np.testing.assert_array_equal(tbrief._bin_weights_np("random"),
                                  jbrief._bin_weights_np("random"))
    # the port's gather form reproduces the weight matrix product
    W = jbrief._bin_weights_np("random")
    plus, minus = tbrief._bin_gather_np("random")
    patches = np.random.default_rng(0).integers(0, 256, (4, W.shape[0]))
    np.testing.assert_array_equal(patches[:, plus] - patches[:, minus],
                                  (patches @ W).astype(np.int64))


def test_blur_matches_reference():
    """Bar: max |diff| <= 1 (one bf16 unit at 128..255).  Both round
    every product and partial sum to bf16 in the same order; XLA may
    keep a fused bf16 chain in float32, which can move a pixel by that
    one unit."""
    img = np.random.default_rng(4).integers(0, 256, (60, 80)).astype(np.float32)
    ref = np.asarray(jpyr.gaussian_blur_7x7(jnp.asarray(img)))
    out = tpyr.gaussian_blur_7x7(torch.from_numpy(img)).numpy()
    assert np.abs(out - ref).max() <= 1.0


def test_import_pulls_in_no_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "import orb_slam2_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'orb_slam2_tpu' not in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
