"""The port's kernel modules against the JAX package: K1 (FAST score),
K2 (windowed Hamming top-2), K3 (epipolar Hamming top-2) and K4
(unmasked Hamming top-2 with column validity).

On the CPU each port wrapper runs its plain PyTorch version; those are
held bit for bit to the JAX reference (the Pallas kernels in interpret
mode, as tests/test_pallas_hamming.py runs them, and the XLA
``fast_score_map`` twin of K1).  The CUDA kernels themselves are tested
against the plain versions on the card by tests/test_torch_gpu.py."""
import ctypes
import glob
import os
import re
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam2_tpu.matching import core as jcore, pallas_hamming as jph
from orb_slam2_tpu.ops import (brief as jbrief, distribute as jdist,
                               fast as jfast, pyramid as jpyr)
from orb_slam2_tpu_torch import kernels
from orb_slam2_tpu_torch.matching import hamming_top2 as ht
from orb_slam2_tpu_torch.ops import (brief as tbrief, distribute as tdist,
                                     fast as tfast, pyramid as tpyr)
from test_torch_gpu import (_adversarial_image, _epi_problem,
                            _fast_score_folded, _rand_desc, _t,
                            _window_problem)

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

    @pytest.mark.parametrize("kind", ["integer", "resized", "constant",
                                      "adversarial"])
    def test_fold_matches_reference(self, kind):
        """The kernel's arithmetic (``_fast_score_folded``: arc extremes
        on the bf16 pixels, two roundings a pixel) against the JAX
        package's ``fast_score_map`` (16 roundings a pixel): every bit
        of the interior, the sign of zero included."""
        rng = np.random.default_rng(21)
        if kind == "integer":
            images = [rng.integers(0, 256, (64, 96)).astype(np.float32)]
        elif kind == "resized":
            img = rng.integers(0, 256, (120, 160)).astype(np.float32)
            images = [np.array(lvl) for lvl in
                      jpyr.build_pyramid(jnp.asarray(img), 4, 1.2)[1:]]
        elif kind == "constant":
            images = [np.full((40, 50), 77.0, np.float32)]
        else:
            images = [_adversarial_image(rng, (70, 90))]
        for img in images:
            ref = np.asarray(jfast.fast_score_map(jnp.asarray(img)))
            out = _fast_score_folded(torch.from_numpy(img)).numpy()
            np.testing.assert_array_equal(out[3:-3, 3:-3].view(np.uint32),
                                          ref[3:-3, 3:-3].view(np.uint32))

    def test_extractor_scores_all_levels_in_one_call(self, monkeypatch):
        """extract() takes every level's scores from one score_maps call
        and hands them to detect(score=...); the Features equal those of
        detect computing each level's score itself."""
        from orb_slam2_tpu_torch.ops import extractor as tex
        img = torch.from_numpy(np.random.default_rng(5).integers(
            0, 256, (160, 200)).astype(np.float32))
        params = tex.OrbParams(n_features=300, n_levels=4)
        calls = []
        score_maps = tfast.score_maps

        def spy(levels):
            calls.append(len(levels))
            return score_maps(levels)
        monkeypatch.setattr(tfast, "score_maps", spy)
        out = tex.extract(img, params)
        assert calls == [4]
        monkeypatch.setattr(tfast, "score_maps",
                            lambda levels: [None] * len(levels))
        ref = tex.extract(img, params)
        assert int(ref.valid.sum()) > 100
        for a, b in zip(out, ref):
            assert torch.equal(a, b)


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

    @pytest.mark.parametrize("n_splits", [2, 3])
    @pytest.mark.parametrize("fn", ["mutual", "epi"])
    def test_split_merge_matches_pallas(self, fn, n_splits):
        """The CUDA kernel cuts the columns into splits and merges their
        (best, second) keys by the TPU kernel's rule.  Here the plain
        version runs on each slice (cut as the kernel cuts them), the
        slice keys are shifted to global columns and merged; the result
        equals the Pallas kernel's keys bit for bit.  The second half of
        the columns repeats the first, so ties cross the slices and the
        lowest column must win."""
        n, m = 256, 384
        problem = _window_problem if fn == "mutual" else _epi_problem
        d1, d2, ra, ca = problem(17 + n_splits, n, m)
        d2[m // 2:], ca[m // 2:] = d2[:m // 2], ca[:m // 2]
        jfn = getattr(jph, f"masked_top2_{fn}")
        ref = [np.asarray(a) for a in jfn(
            jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(ra),
            jnp.asarray(ca), interpret=True)]
        plain = getattr(ht, f"masked_top2_{fn}_plain")
        chunk = 32              # the kernel stages columns 32 at a time
        cuts = [s * (m // chunk) // n_splits * chunk
                for s in range(n_splits + 1)]
        b = s = None
        ckeys = []
        for c0, c1 in zip(cuts[:-1], cuts[1:]):
            pb, ps, pc = plain(_t(d1), _t(d2[c0:c1]), _t(ra), _t(ca[c0:c1]))
            pb, ps = pb + c0, ps + c0          # slice columns -> global
            if b is None:
                b, s = pb, ps
            else:
                b, s = (torch.minimum(b, pb),
                        torch.minimum(torch.maximum(b, pb),
                                      torch.minimum(s, ps)))
            ckeys.append(pc)
        out = (b, s, torch.cat(ckeys))
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o.numpy(), r)
        bd, sd = ref[0] // ht.COL_STRIDE, ref[1] // ht.COL_STRIDE
        assert ((bd == sd) & (bd < ht.MASK_D)).sum() > 0   # ties occurred

    def test_pm1_operand_gives_hamming(self):
        """The kernel's +-1 int8 operand layout: 256 - a.b == 2d."""
        rng = np.random.default_rng(11)
        d1, d2 = _rand_desc(rng, 96), _rand_desc(rng, 160)
        d1[:32] = d2[:32]
        a8 = ht.pm1_operand(_t(d1))
        assert a8.dtype == torch.int8 and a8.shape == (96, 256)
        assert bool((a8.abs() == 1).all())
        a = a8.to(torch.int32)
        b = ht.pm1_operand(_t(d2)).to(torch.int32)
        ref = np.asarray(jcore.hamming_matrix(jnp.asarray(d1),
                                              jnp.asarray(d2)))
        np.testing.assert_array_equal((256 - a @ b.T).numpy(), 2 * ref)

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
# K4: unmasked Hamming top-2 with column validity
# ----------------------------------------------------------------------
def _k4_ref(d1, d2, v2):
    return [np.asarray(a) for a in jph.hamming_top2(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v2), interpret=True)]


def _k4_port(d1, d2, v2):
    return [a.numpy() for a in ht.hamming_top2(_t(d1), _t(d2),
                                               torch.from_numpy(v2))]


class TestHammingTop2:
    """Bar: best, best_idx and second bit-exact against the Pallas
    kernel in interpret mode on every row (integer distances; ties to
    the lowest index), including its BIG + d answer on rows without a
    valid column; against the XLA twin (which writes BIG exactly) on
    the rows with >= 2 valid columns."""

    @pytest.mark.parametrize("n,m", [(256, 256), (256, 512), (512, 256)])
    def test_matches_pallas(self, n, m):
        rng = np.random.default_rng(n + 3 * m)
        d1, d2 = _rand_desc(rng, n), _rand_desc(rng, m)
        # near copies, so ties and small distances occur
        d1[: n // 2] = d2[rng.integers(0, m, n // 2)] ^ (
            rng.random((n // 2, 8)) < 0.02).astype(np.uint32)
        v2 = rng.random(m) > 0.2
        for o, r in zip(_k4_port(d1, d2, v2), _k4_ref(d1, d2, v2)):
            np.testing.assert_array_equal(o, r)
        xb, xi, xs = (np.asarray(a) for a in jph.hamming_top2_xla(
            jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v2)))
        b, i, s = _k4_port(d1, d2, v2)
        np.testing.assert_array_equal(b, xb)
        np.testing.assert_array_equal(i, xi)
        np.testing.assert_array_equal(s, xs)

    def test_all_columns_invalid(self):
        rng = np.random.default_rng(2)
        d1, d2 = _rand_desc(rng, 256), _rand_desc(rng, 256)
        v2 = np.zeros(256, bool)
        out = _k4_port(d1, d2, v2)
        for o, r in zip(out, _k4_ref(d1, d2, v2)):
            np.testing.assert_array_equal(o, r)
        assert (out[0] > ht.BIG).all() and (out[2] == ht.BIG).all()

    def test_one_valid_column(self):
        rng = np.random.default_rng(4)
        d1, d2 = _rand_desc(rng, 128), _rand_desc(rng, 256)
        v2 = np.zeros(256, bool)
        v2[200] = True
        out = _k4_port(d1, d2, v2)
        for o, r in zip(out, _k4_ref(d1, d2, v2)):
            np.testing.assert_array_equal(o, r)
        assert (out[1] == 200).all() and (out[2] == ht.BIG).all()

    def test_identical_descriptors(self):
        rng = np.random.default_rng(1)
        d = _rand_desc(rng, 256)
        d[128:] = d[:128]                 # every row ties at two columns
        v = np.ones(256, bool)
        out = _k4_port(d, d, v)
        for o, r in zip(out, _k4_ref(d, d, v)):
            np.testing.assert_array_equal(o, r)
        assert (out[0] == 0).all() and (out[2] == 0).all()
        np.testing.assert_array_equal(out[1], np.tile(np.arange(128), 2))

    @pytest.mark.parametrize("n_splits", [2, 3])
    @pytest.mark.parametrize("valid", ["none", "one_in_last", "some", "all"])
    def test_split_merge_matches_pallas(self, valid, n_splits):
        """The CUDA kernel cuts the columns into splits (32-column
        chunks), carries per row the best and true second key
        (d + 257 * invalid) * 2^21 + col, merges splits by K2's rule and
        decodes the last merge.  Here the plain version runs on each
        slice, its answer is turned into those keys (a second at BIG is
        an invalid key: only its being invalid matters), the slices are
        merged and decoded; the result equals the Pallas kernel's bit for
        bit.  The second half of the columns repeats the first, so ties
        cross the slices and the lowest column must win."""
        n, m = 256, 384
        rng = np.random.default_rng(31 + n_splits)
        d2 = _rand_desc(rng, m)
        d2[m // 2:] = d2[:m // 2]
        d1 = d2[rng.integers(0, m, n)] ^ (
            rng.random((n, 8)) < 0.03).astype(np.uint32)
        d1[: n // 4] = _rand_desc(rng, n // 4)
        chunk = 32
        cuts = [s * (m // chunk) // n_splits * chunk
                for s in range(n_splits + 1)]
        v2 = {"none": np.zeros(m, bool), "all": np.ones(m, bool),
              "some": rng.random(m) > 0.3}.get(valid)
        if v2 is None:
            v2 = np.zeros(m, bool)
            v2[cuts[-2] + 5] = True
        bits, inv_d = 21, 257
        b = s = None
        for c0, c1 in zip(cuts[:-1], cuts[1:]):
            pb, pi, ps = (a.to(torch.int64) for a in ht.hamming_top2_plain(
                _t(d1), _t(d2[c0:c1]), torch.from_numpy(v2[c0:c1])))
            bd = torch.where(pb < ht.BIG, pb, pb - ht.BIG + inv_d)
            kb = (bd << bits) + pi + c0
            sd = torch.where((pb < ht.BIG) & (ps < ht.BIG), ps, inv_d)
            ks = (sd << bits) + (1 << bits) - 1
            if b is None:
                b, s = kb, ks
            else:
                b, s = (torch.minimum(b, kb),
                        torch.minimum(torch.maximum(b, kb),
                                      torch.minimum(s, ks)))
        bd, sd = b >> bits, s >> bits
        ok = bd < inv_d
        out = (torch.where(ok, bd, ht.BIG + bd - inv_d),
               b & ((1 << bits) - 1),
               torch.where(ok & (sd < inv_d), sd, ht.BIG))
        ref = _k4_ref(d1, d2, v2)
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o.numpy(), r)
        if valid in ("some", "all"):
            assert (ref[0] == ref[2]).sum() > 0          # ties occurred

    def test_column_limit(self):
        """K4's keys hold the column in 21 bits: M past 2^21 is refused,
        on the CPU as on the card."""
        m = ht.K4_MAX_COLS + ht.TILE
        d2 = torch.zeros((1, 8), dtype=torch.int32).expand(m, 8)
        with pytest.raises(ValueError, match="keys need"):
            ht.hamming_top2(torch.zeros((128, 8), dtype=torch.int32), d2,
                            torch.ones(1, dtype=torch.bool).expand(m))

    def test_shape_guard_and_no_launch_on_cpu(self):
        kernels.reset_launch_counts()
        with pytest.raises(ValueError, match="multiples of 128"):
            ht.hamming_top2(torch.zeros((100, 8), dtype=torch.int32),
                            torch.zeros((128, 8), dtype=torch.int32),
                            torch.ones(128, dtype=torch.bool))
        assert ht.hamming_top2_auto is ht.hamming_top2
        ht.hamming_top2(torch.zeros((128, 8), dtype=torch.int32),
                        torch.zeros((128, 8), dtype=torch.int32),
                        torch.ones(128, dtype=torch.bool))
        assert sum(kernels.LAUNCHES.values()) == 0


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


def _c_params(cname):
    """The parameters of the C entry point ``cname`` in csrc/*.cu."""
    for path in sorted(glob.glob(os.path.join(kernels.SRC_DIR, "*.cu"))):
        with open(path) as f:
            found = re.search(r'extern "C" int ' + cname + r"\(([^)]*)\)",
                              f.read())
        if found:
            return [" ".join(p.split()) for p in found.group(1).split(",")]
    raise AssertionError(f'no extern "C" int {cname}(...) in csrc/')


_ENTRY_POINTS = ([(c, a, True) for c, a in kernels._SIGNATURES.values()]
                 + [(c, a, False) for c, a in kernels._HELPERS.items()])


@pytest.mark.parametrize("cname,argtypes,launches", _ENTRY_POINTS,
                         ids=[e[0] for e in _ENTRY_POINTS])
def test_ctypes_signatures_match_sources(cname, argtypes, launches):
    """ctypes checks nothing against the C source, so kernels.py's
    argument types must match it by hand: a pointer where the source
    takes a pointer, an int where it takes an int, and a launching entry
    point ends with the stream."""
    params = _c_params(cname)
    assert len(params) == len(argtypes), params
    for p, a in zip(params, argtypes):
        assert a in (ctypes.c_void_p, ctypes.c_int)
        assert ("*" in p) == (a is ctypes.c_void_p), (p, a)
        assert "*" in p or p.split()[0] == "int", p
    assert (params[-1] == "void* stream") == launches, params
