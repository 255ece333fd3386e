"""Port oracles (``repro_torch.kernels.ref``) against the reference oracles
(``repro.kernels.ref``) and numpy, on the same seeded numpy inputs.

Tolerance: both sides compute in complex64 with their own summation order
(matmul, Stockham sweeps), so they agree to fp32 rounding grown over the
transform: rtol 1e-4, atol 1e-4 * sqrt(n) (the reference FFT tests' bound)
for the transforms, rtol 1e-3, atol 1e-4 * n for the products (the
reference polymul tests' bound). The direct convolution: the port sums in
float64, the reference in float32 (JAX's x64 mode is off, so its float64
cast truncates), so they agree to fp32 rounding of an m-term sum: rtol 1e-5,
atol 1e-5 * m; the port agrees with numpy's float64 convolve to 1e-12.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref


def _cx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("n", [1, 2, 8, 64])
@pytest.mark.parametrize("inverse", [False, True])
def test_dft_matches_reference(rng, n, inverse):
    x = _cx(rng, (3, n))
    got = tref.dft(torch.from_numpy(x), inverse=inverse).numpy()
    want = np.asarray(jref.dft(jnp.asarray(x), inverse=inverse))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.sqrt(n))
    f64 = np.fft.ifft(x) if inverse else np.fft.fft(x)
    np.testing.assert_allclose(got, f64, rtol=1e-4, atol=1e-4 * np.sqrt(n))


@pytest.mark.parametrize("n", [2, 16, 128, 1024])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_stockham_matches_reference(rng, n, inverse):
    x = _cx(rng, (2, 3, n))
    got = tref.fft_stockham(torch.from_numpy(x), inverse=inverse).numpy()
    want = np.asarray(jref.fft_stockham(jnp.asarray(x), inverse=inverse))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.sqrt(n))
    f64 = np.fft.ifft(x) if inverse else np.fft.fft(x)
    np.testing.assert_allclose(got, f64, rtol=1e-4, atol=1e-4 * np.sqrt(n))


def test_fft_stockham_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        tref.fft_stockham(torch.zeros(12, dtype=torch.complex64))


@pytest.mark.parametrize("n,m", [(5, 3), (16, 16)])
@pytest.mark.parametrize("complex_in", [False, True])
def test_convolve_direct_matches_reference(rng, n, m, complex_in):
    if complex_in:
        a, b = _cx(rng, (2, n)), _cx(rng, (2, m))
    else:
        a = rng.standard_normal((2, n)).astype(np.float32)
        b = rng.standard_normal((2, m)).astype(np.float32)
    got = tref.convolve_direct(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jref.convolve_direct(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * m)
    np.testing.assert_allclose(
        got.numpy()[0], np.convolve(a[0].astype(np.complex128 if complex_in
                                                else np.float64), b[0]),
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [8, 64])
@pytest.mark.parametrize("linear", [False, True])
def test_polymul_refs_match_reference(rng, n, linear):
    a = rng.standard_normal((2, n)).astype(np.float32)
    b = rng.standard_normal((2, n)).astype(np.float32)
    tfn = tref.polymul_linear_ref if linear else tref.polymul_circular_ref
    jfn = jref.polymul_linear_ref if linear else jref.polymul_circular_ref
    got = tfn(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b)))
    width = 2 * n if linear else n
    assert got.shape == want.shape == (2, width)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * width)
    if linear:
        full = np.stack([np.convolve(a[i].astype(np.float64), b[i])
                         for i in range(2)])
        np.testing.assert_allclose(got.real[:, :2 * n - 1], full,
                                   rtol=1e-3, atol=1e-4 * width)
