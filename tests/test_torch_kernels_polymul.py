"""Port of the fused product kernels (``repro_torch.kernels.polymul``)
against the reference Pallas kernels (``repro.kernels.polymul``, interpret
mode on the CPU) and float64 numpy, on the same seeded numpy inputs. At
n = 16384 the wrappers take their split-pass schedule (its plain mirrors
on the CPU; ``tests/test_torch_two_pass.py`` pins them to the plain
versions bit for bit).

Tolerance: rtol 1e-3, atol 1e-4 * n -- the reference polymul tests' bound
(three transforms of fp32 rounding, each growing with log n, and products
of O(sqrt n) spectra).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import polymul as jpoly
from repro_torch.kernels import _build
from repro_torch.kernels import polymul as tpoly


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _tol(n):
    return dict(rtol=1e-3, atol=1e-4 * n)


@pytest.mark.parametrize("n,radix,batch", [
    (8, 2, 3), (64, 4, 1), (128, 4, 2), (512, 4, 5), (16384, 4, 3),
    (16384, 2, 1)])
def test_polymul_complex_planes_matches_pallas(rng, n, radix, batch):
    a = (rng.standard_normal((batch, n))
         + 1j * rng.standard_normal((batch, n))).astype(np.complex64)
    b = (rng.standard_normal((batch, n))
         + 1j * rng.standard_normal((batch, n))).astype(np.complex64)
    planes = [a.real, a.imag, b.real, b.imag]
    cr, ci = tpoly.polymul_complex_planes(*map(_t, planes), radix=radix)
    jr, ji = jpoly.polymul_complex_planes(*map(jnp.asarray, planes),
                                          radix=radix)
    got = cr.numpy() + 1j * ci.numpy()
    np.testing.assert_allclose(got, np.asarray(jr) + 1j * np.asarray(ji),
                               **_tol(n))
    a64, b64 = a.astype(np.complex128), b.astype(np.complex128)
    np.testing.assert_allclose(
        got, np.fft.ifft(np.fft.fft(a64) * np.fft.fft(b64)), **_tol(n))


@pytest.mark.parametrize("n,radix,batch", [
    (2, 2, 1), (8, 2, 1), (64, 4, 3), (128, 4, 2), (512, 2, 5),
    (16384, 4, 3), (16384, 2, 4)])
def test_polymul_real_planes_matches_pallas(rng, n, radix, batch):
    """Odd batches pair the last product with a zero row."""
    a = rng.standard_normal((batch, n)).astype(np.float32)
    b = rng.standard_normal((batch, n)).astype(np.float32)
    got = tpoly.polymul_real_planes(_t(a), _t(b), radix=radix).numpy()
    want = np.asarray(jpoly.polymul_real_planes(jnp.asarray(a),
                                                jnp.asarray(b), radix=radix))
    assert got.shape == want.shape == (batch, n)
    np.testing.assert_allclose(got, want, **_tol(n))
    f64 = np.fft.ifft(np.fft.fft(a.astype(np.float64))
                      * np.fft.fft(b.astype(np.float64))).real
    np.testing.assert_allclose(got, f64, **_tol(n))


@pytest.mark.parametrize("batch", [1, 2, 3, 5, 8])
def test_polymul_real_rows_independent_of_pairing(rng, batch):
    """Each product equals its own single-row product: the pairing of rows
    (2j, 2j+1) and the zero pad of an odd batch leak nothing across rows.
    Same tolerance as above."""
    n = 128
    a = rng.standard_normal((batch, n)).astype(np.float32)
    b = rng.standard_normal((batch, n)).astype(np.float32)
    got = tpoly.polymul_real_planes(_t(a), _t(b), radix=4).numpy()
    for i in range(batch):
        one = tpoly.polymul_real_planes(_t(a[i:i + 1]), _t(b[i:i + 1]),
                                        radix=4).numpy()
        np.testing.assert_allclose(got[i], one[0], **_tol(n))


def test_default_blocks():
    """A product CTA holds both spectra of a row: half the transform
    block, at least one row (two, paired, on the real route)."""
    assert tpoly.default_complex_block(1024) == 1
    assert tpoly.default_complex_block(64) == 16
    assert tpoly.default_real_block(4096) == 2
    assert tpoly.default_real_block(64) == 32


@pytest.mark.parametrize("n", [16, 16384])
def test_cpu_tensors_launch_nothing(rng, n):
    """Resident (n = 16) and split-pass (n = 16384) sizes alike."""
    _build.reset_launches()
    x = _t(rng.standard_normal((3, n)).astype(np.float32))
    tpoly.polymul_complex_planes(x, x, x, x)
    tpoly.polymul_real_planes(x, x)
    assert set(_build.LAUNCHES.values()) == {0}


def test_wrappers_reject_mismatched_planes():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        tpoly.polymul_complex_planes(x, x, x, torch.zeros(3, 8))
    with pytest.raises(TypeError):
        tpoly.polymul_real_planes(x, x.double())
