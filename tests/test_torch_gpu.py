"""The hand-written CUDA kernels (K1, K2, K3) against their plain
PyTorch versions on the card.  Every test here is marked ``gpu`` and
skips without a CUDA device.  This file imports no jax, so it runs on a
machine without the JAX package:

    python3 -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(``--noconftest`` skips tests/conftest.py, which sets up JAX)."""
import numpy as np
import pytest
import torch

from orb_slam2_tpu_torch import kernels
from orb_slam2_tpu_torch.matching import hamming_top2 as ht
from orb_slam2_tpu_torch.ops import fast as tfast, pyramid as tpyr

torch.set_num_threads(1)


def _rand_desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)


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

    @pytest.mark.parametrize("n,m", [(256, 384), (4096, 4096), (16384, 4096)])
    def test_masked_top2_mutual(self, cuda, n, m):
        args = [_t(a).to(cuda) for a in _window_problem(n, n, m)]
        k = ht.masked_top2_mutual(*args)
        p = ht.masked_top2_mutual_plain(*args)
        for a, b in zip(k, p):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("n,m", [(128, 256), (4096, 4096)])
    def test_masked_top2_epi(self, cuda, n, m):
        args = [_t(a).to(cuda) for a in _epi_problem(n, n, m)]
        k = ht.masked_top2_epi(*args)
        p = ht.masked_top2_epi_plain(*args)
        for a, b in zip(k, p):
            assert torch.equal(a, b)

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
