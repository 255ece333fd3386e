"""The plain references against schoolbook products and NumPy's float64
FFT at small n, and their controls against the references."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.lib.spec import BENCH_DIR, load_module

RNS = load_module(BENCH_DIR / "reference" / "rns_negacyclic.py")
REAL = load_module(BENCH_DIR / "reference" / "real_circular.py")


@pytest.mark.parametrize("n", [2, 8, 32, 64])
def test_rns_reference_equals_schoolbook(n):
    _, qs = RNS.limbs(n, 40, 30)
    rng = np.random.default_rng(n)
    a = np.stack([rng.integers(0, q, (3, n)) for q in qs]).astype(np.uint32)
    b = np.stack([rng.integers(0, q, (3, n)) for q in qs]).astype(np.uint32)
    got = RNS.product(torch.from_numpy(a), torch.from_numpy(b), qs)
    for i, q in enumerate(qs):
        for r in range(3):
            want = RNS.schoolbook(a[i, r].tolist(), b[i, r].tolist(), q)
            assert got[i, r].tolist() == want


def test_rns_limbs_cover_the_product_bound():
    for bits, k in ((109, 9), (60, 5)):
        q_big, qs = RNS.limbs(4096, bits, 30)
        assert q_big.bit_length() >= bits
        assert len(qs) == k
        m = 1
        for q in qs:
            assert RNS.is_prime(q) and q % (2 * 4096) == 1 and q < 2**30
            m *= q
        assert m > 2 * 4096 * q_big**2
    assert RNS.limbs(4096, 109, 30)[0].bit_length() == 120


def test_rns_psi_is_a_primitive_2n_th_root():
    for q in RNS.limbs(64, 40, 30)[1]:
        p = RNS.psi(q, 64)
        assert pow(p, 64, q) == q - 1 and pow(p, 128, q) == 1


def test_rns_control_breaks_exactness():
    n = 1024
    _, qs = RNS.limbs(n, 40, 30)
    gen = torch.Generator().manual_seed(5)
    a = torch.stack([torch.randint(0, q, (2, n), generator=gen) for q in qs])
    b = torch.stack([torch.randint(0, q, (2, n), generator=gen) for q in qs])
    a, b = (x.to(torch.int32).view(torch.uint32) for x in (a, b))
    want = RNS.product(a, b, qs)
    bad = (RNS.float_product(a, b, qs).to(torch.int64) != want).sum()
    assert bad > want.numel() // 2


@pytest.mark.parametrize("n", [2, 16, 64, 1024])
def test_real_reference_equals_numpy_fft_and_naive(n):
    rng = np.random.default_rng(n)
    a, b = rng.standard_normal((2, 4, n))
    got = REAL.product(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.fft.irfft(np.fft.rfft(a) * np.fft.rfft(b), n)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * n)
    if n <= 64:
        naive = np.array([REAL.naive(x.tolist(), y.tolist())
                          for x, y in zip(a, b)])
        np.testing.assert_allclose(got, naive, rtol=0, atol=1e-12 * n)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_real_controls_fail_where_float32_passes(dtype):
    gen = torch.Generator().manual_seed(3)
    a, b = torch.randn((2, 8, 4096), generator=gen)
    want = REAL.product(a, b)
    fp32 = torch.fft.irfft(torch.fft.rfft(a) * torch.fft.rfft(b), 4096)
    low = REAL.low_precision_product(a, b, dtype)
    assert REAL.row_errors(fp32, want).max() < 1e-5
    assert REAL.row_errors(low, want).min() > 1e-4


def test_row_errors_flag_non_finite_rows():
    want = torch.ones(2, 4, dtype=torch.float64)
    got = torch.ones(2, 4)
    got[1, 2] = float("nan")
    err = REAL.row_errors(got, want)
    assert err[0] == 0 and err[1] == float("inf")
