"""The port's transform surface (``repro_torch.kernels.ops`` and its
``core.fft`` exports) against the reference ``repro.kernels.ops``, on the
same seeded numpy inputs. The reference runs its Pallas route in
interpret mode (``backend="pallas"``) at the same radix.

Tolerances: transforms rtol 1e-4, atol 1e-4 * sqrt(n) (the reference FFT
tests' bound); products rtol 1e-3, atol 1e-4 * n (the reference polymul
tests' bound); layout converters bitwise, since they only move values.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.core import fft as tcore
from repro_torch.kernels import ops as tops


def _cx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _ftol(n):
    return dict(rtol=1e-4, atol=1e-4 * np.sqrt(n))


def _ptol(n):
    return dict(rtol=1e-3, atol=1e-4 * n)


def test_core_exports_the_local_surface():
    for name in ("fft", "ifft", "rfft", "irfft", "polymul", "polymul_real",
                 "packed_to_halfspec", "halfspec_to_packed", "plan",
                 "FFTPlan"):
        assert name in tcore.__all__ and hasattr(tcore, name)
    assert tcore.fft is tops.fft


@pytest.mark.parametrize("inverse", [False, True])
def test_fft_leading_dims_matches_reference(rng, inverse):
    """(2, 3, n) input: leading dims flatten into the batch and back."""
    n = 64
    x = _cx(rng, (2, 3, n))
    got = tops.fft(torch.from_numpy(x), inverse=inverse, radix=4).numpy()
    want = np.asarray(jops.fft(jnp.asarray(x), inverse=inverse,
                               backend="pallas", radix=4))
    assert got.shape == (2, 3, n) and got.dtype == np.complex64
    scale = n if inverse else 1
    np.testing.assert_allclose(got * scale, want * scale, **_ftol(n))


def test_ifft_roundtrip(rng):
    """Same tolerance as the reference's ops round-trip test."""
    x = _cx(rng, (3, 128))
    y = tops.ifft(tops.fft(torch.from_numpy(x), radix=4), radix=4)
    np.testing.assert_allclose(y.numpy(), x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("packed", [False, True])
def test_rfft_matches_reference(rng, packed):
    n = 128
    x = rng.standard_normal((3, n)).astype(np.float32)
    got = tops.rfft(torch.from_numpy(x), radix=4, packed=packed)
    want = jops.rfft(jnp.asarray(x), backend="pallas", radix=4,
                     packed=packed)
    if packed:
        for g, w in zip(got, want):
            assert g.shape == (3, n // 2)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **_ftol(n))
    else:
        assert got.shape == (3, n // 2 + 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **_ftol(n))
        np.testing.assert_allclose(got.numpy(),
                                   np.fft.rfft(x.astype(np.float64)),
                                   **_ftol(n))


@pytest.mark.parametrize("packed", [False, True])
def test_irfft_matches_reference(rng, packed):
    """Both layouts, leading batch dims with an odd row count, against the
    reference's Pallas route on the same half spectrum and the round trip
    (the reference's ``test_ops_irfft_roundtrip`` bound, 1e-3)."""
    n = 64
    x = rng.standard_normal((3, 5, n)).astype(np.float32)
    h = tops.rfft(torch.from_numpy(x), packed=packed)
    got = tcore.irfft(h, packed=packed)
    assert got.shape == x.shape and got.dtype == torch.float32
    jh = (tuple(jnp.asarray(t.numpy()) for t in h) if packed
          else jnp.asarray(h.numpy()))
    want = np.asarray(jops.irfft(jh, backend="pallas", packed=packed))
    np.testing.assert_allclose(got.numpy(), want, **_ftol(n))
    np.testing.assert_allclose(got.numpy(), x, rtol=1e-3, atol=1e-3)
    if not packed:
        np.testing.assert_allclose(got.numpy(), np.fft.irfft(h.numpy(), n=n),
                                   **_ftol(n))


def test_rfft_rejects_complex(rng):
    with pytest.raises(TypeError):
        tops.rfft(torch.from_numpy(_cx(rng, (2, 8))))
    with pytest.raises(TypeError):
        tops.polymul_real(torch.zeros(8, dtype=torch.complex64),
                          torch.zeros(8, dtype=torch.complex64))


def test_layout_converters_match_reference(rng):
    n = 16
    half = np.fft.rfft(rng.standard_normal((2, n))).astype(np.complex64)
    got = tops.halfspec_to_packed(torch.from_numpy(half))
    want = jops.halfspec_to_packed(jnp.asarray(half))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = tops.packed_to_halfspec(*got).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jops.packed_to_halfspec(*want)))
    np.testing.assert_array_equal(back, half)


@pytest.mark.parametrize("mode", ["linear", "circular"])
@pytest.mark.parametrize("complex_in", [False, True])
def test_polymul_matches_reference(rng, mode, complex_in):
    n = 32
    if complex_in:
        a, b = _cx(rng, (3, n)), _cx(rng, (3, n))
    else:
        a = rng.standard_normal((3, n)).astype(np.float32)
        b = rng.standard_normal((3, n)).astype(np.float32)
    got = tops.polymul(torch.from_numpy(a), torch.from_numpy(b), mode=mode,
                       radix=4).numpy()
    want = np.asarray(jops.polymul(jnp.asarray(a), jnp.asarray(b),
                                   mode=mode, backend="pallas", radix=4))
    width = 2 * n if mode == "linear" else n
    assert got.shape == want.shape == (3, width)
    assert got.dtype == (np.complex64 if complex_in else np.float32)
    np.testing.assert_allclose(got, want, **_ptol(width))
    if mode == "linear":
        full = np.stack([np.convolve(a[i].astype(np.complex128), b[i])
                         for i in range(3)])
        np.testing.assert_allclose(got[:, :2 * n - 1], full if complex_in
                                   else full.real, **_ptol(width))


def test_polymul_real_linear_matches_direct(rng):
    n = 64
    a = rng.standard_normal((2, n)).astype(np.float32)
    b = rng.standard_normal((2, n)).astype(np.float32)
    got = tops.polymul_real(torch.from_numpy(a), torch.from_numpy(b),
                            mode="linear").numpy()
    want = np.zeros((2, 2 * n))
    for i in range(2):
        want[i, :2 * n - 1] = np.convolve(a[i].astype(np.float64), b[i])
    np.testing.assert_allclose(got, want, **_ptol(2 * n))


def test_polymul_rejects_bad_mode_and_shapes():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        tops.polymul(x, x, mode="cyclic")
    with pytest.raises(ValueError):
        tops.polymul(x, torch.zeros(2, 4))
