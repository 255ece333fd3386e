"""The port's FFT compositions and Fourier token mixing on the CPU, against
the reference (``repro.kernels.ref``, ``repro.kernels.ops``,
``repro.models.layers.common``) and float64 numpy, on the same seeded
numpy inputs.

Covered: the oracles ``fft_recursive``, ``ifft_recursive``,
``ifft_stockham``, ``realpack_fft_ref`` and ``fft_causal_conv_ref``; the ops
``realpack_fft``, ``fft2``, ``fft_conv2d`` and ``fft_causal_conv``; and the
layer ``fourier_mixing``. On the CPU the ops run ``fft_planes``' plain
version (below ``TWO_PASS_FROM["fft"]`` points its sweeps, from there on
its two-pass mirror).

Tolerances, those of the reference tests (``tests/test_kernels_fft.py``):
the oracles and ops rtol 1e-3, atol 1e-3 (atol 1e-3 * n where the
reference scales it with n, for whole spectra of random inputs); the 2-D
round trip atol 1e-4. ``fourier_mixing`` in fp32 within 1e-4: both sides
round the same exact convolution in fp32 (the reference on its radix-2
XLA Stockham with fp32 phases, the port on the kernels' radix-4 sweeps and
table), and the results of magnitude about 1 agree to a few 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.layers import common as jcommon
from repro_torch.core import fft as core_fft
from repro_torch.kernels import _build
from repro_torch.kernels import fft as tkfft
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.layers import common as tcommon

TOL = dict(rtol=1e-3, atol=1e-3)
MIX_TOL = dict(rtol=1e-4, atol=1e-4)


def _cx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 16, 128, 512])
def test_fft_recursive_matches_reference(rng, n):
    x = _cx(rng, (2, 3, n))
    got = tref.fft_recursive(torch.from_numpy(x)).numpy()
    want = np.asarray(jref.fft_recursive(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * n)
    np.testing.assert_allclose(got, np.fft.fft(x), rtol=1e-3, atol=1e-3 * n)


@pytest.mark.parametrize("n", [2, 16, 128, 512])
def test_ifft_recursive_matches_reference(rng, n):
    x = _cx(rng, (3, n))
    got = tref.ifft_recursive(torch.from_numpy(x)).numpy()
    want = np.asarray(jref.ifft_recursive(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, np.fft.ifft(x), **TOL)


@pytest.mark.parametrize("n", [2, 16, 128, 1024])
def test_ifft_stockham_matches_reference(rng, n):
    x = _cx(rng, (2, 3, n))
    got = tref.ifft_stockham(torch.from_numpy(x)).numpy()
    want = np.asarray(jref.ifft_stockham(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, np.fft.ifft(x), **TOL)


def test_fft_recursive_rejects_odd_length():
    with pytest.raises(ValueError):
        tref.fft_recursive(torch.zeros(6, dtype=torch.complex64))


@pytest.mark.parametrize("n", [8, 64, 128])
def test_realpack_fft_ref_matches_reference(rng, n):
    """Eq. (10) is exact: both halves equal the two real FFTs."""
    x, y = _f32(rng, (2, n)), _f32(rng, (2, n))
    gx, gy = tref.realpack_fft_ref(torch.from_numpy(x), torch.from_numpy(y))
    wx, wy = jref.realpack_fft_ref(jnp.asarray(x), jnp.asarray(y))
    for got, want, plain in ((gx, wx, x), (gy, wy, y)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                                   atol=1e-3 * n)
        np.testing.assert_allclose(got.numpy(), np.fft.fft(plain), rtol=1e-3,
                                   atol=1e-3 * n)


@pytest.mark.parametrize("T,K", [(100, 17), (32, 32), (16, 4)])
def test_fft_causal_conv_ref_matches_reference(rng, T, K):
    x, k = _f32(rng, (3, T)), _f32(rng, (3, K))
    got = tref.fft_causal_conv_ref(torch.from_numpy(x), torch.from_numpy(k))
    assert got.dtype == torch.float32 and got.shape == (3, T)
    want = np.asarray(jref.fft_causal_conv_ref(jnp.asarray(x),
                                               jnp.asarray(k)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    direct = np.stack([np.convolve(x[i], k[i])[:T] for i in range(3)])
    np.testing.assert_allclose(got.numpy(), direct, **TOL)


# ---------------------------------------------------------------------------
# Ops: against the reference's XLA backend and numpy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("n", [8, 64, 1024])
def test_realpack_fft_matches_reference(rng, n, radix):
    x, y = _f32(rng, (2, n)), _f32(rng, (2, n))
    gx, gy = tops.realpack_fft(torch.from_numpy(x), torch.from_numpy(y),
                               radix=radix)
    wx, wy = jops.realpack_fft(jnp.asarray(x), jnp.asarray(y),
                               backend="xla")
    for got, want, plain in ((gx, wx, x), (gy, wy, y)):
        assert got.dtype == torch.complex64 and got.shape == (2, n)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got.numpy(), np.fft.fft(plain), **TOL)


@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("shape", [(2, 16, 32), (8, 8), (1, 64, 4)])
def test_fft2_matches_reference_and_round_trips(rng, shape, radix):
    x = _cx(rng, shape)
    got = tops.fft2(torch.from_numpy(x), radix=radix)
    want = np.asarray(jops.fft2(jnp.asarray(x), backend="xla"))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), np.fft.fft2(x), **TOL)
    back = tops.fft2(got, inverse=True, radix=radix)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jops.fft2(jnp.asarray(want), inverse=True,
                                        backend="xla")), rtol=1e-3,
        atol=1e-4)


def _conv2d_same(img, kern):
    """Direct 'same' 2-D convolution in float64: out[r, c] = sum over the
    taps of kern[i, j] img[r + kh//2 - i, c + kw//2 - j]."""
    kh, kw = kern.shape
    H, W = img.shape[-2:]
    pad = np.pad(img.astype(np.float64),
                 [(0, 0)] * (img.ndim - 2) + [(kh - 1, kh - 1),
                                              (kw - 1, kw - 1)])
    full = np.zeros(img.shape[:-2] + (H + kh - 1, W + kw - 1))
    for i in range(kh):
        for j in range(kw):
            full += kern[i, j] * pad[..., kh - 1 - i:kh - 1 - i + H + kh - 1,
                                     kw - 1 - j:kw - 1 - j + W + kw - 1]
    r0, c0 = kh // 2, kw // 2
    return full[..., r0:r0 + H, c0:c0 + W]


@pytest.mark.parametrize("H,W,kh,kw", [(12, 20, 3, 5), (16, 16, 5, 5),
                                       (7, 9, 1, 3)])
def test_fft_conv2d_matches_reference_and_direct(rng, H, W, kh, kw):
    img = _f32(rng, (2, H, W))
    kern = _f32(rng, (kh, kw))
    got = tops.fft_conv2d(torch.from_numpy(img), torch.from_numpy(kern))
    assert got.dtype == torch.float32 and got.shape == (2, H, W)
    want = np.asarray(jops.fft_conv2d(jnp.asarray(img), jnp.asarray(kern),
                                      backend="xla"))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), _conv2d_same(img, kern), **TOL)


def _causal(x, k):
    """Causal depthwise convolution in float64 by np.convolve, x (..., T)
    and k (..., K) broadcast against each other."""
    T = x.shape[-1]
    lead = np.broadcast_shapes(x.shape[:-1], k.shape[:-1])
    xb = np.broadcast_to(x, lead + x.shape[-1:]).reshape(-1, T)
    kb = np.broadcast_to(k, lead + k.shape[-1:]).reshape(-1, k.shape[-1])
    out = np.stack([np.convolve(a.astype(np.float64), b)[:T]
                    for a, b in zip(xb, kb)])
    return out.reshape(lead + (T,))


@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("xs,ks", [((3, 100), (3, 17)),
                                   ((2, 8, 40), (1, 8, 16)),
                                   ((1, 6, 64), (1, 6, 64)),
                                   ((4, 5), (4, 3))])
def test_fft_causal_conv_matches_reference(rng, xs, ks, radix):
    """T 100 with K 17 (not powers of two), the batched (B, d, T) x
    (1, d, K) broadcast of ``fourier_mixing``, K == T, and a short row."""
    x, k = _f32(rng, xs), _f32(rng, ks)
    got = tops.fft_causal_conv(torch.from_numpy(x), torch.from_numpy(k),
                               radix=radix)
    assert got.dtype == torch.float32 and got.shape == xs
    want = np.asarray(jops.fft_causal_conv(jnp.asarray(x), jnp.asarray(k),
                                           backend="xla"))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), _causal(x, k), **TOL)


def test_fft_causal_conv_matches_pallas_interpret(rng):
    """One small case against the reference's Pallas kernel in interpret
    mode: T 100 + K 17 pads to n = 128."""
    x, k = _f32(rng, (2, 100)), _f32(rng, (2, 17))
    got = tops.fft_causal_conv(torch.from_numpy(x), torch.from_numpy(k),
                               radix=4)
    want = np.asarray(jops.fft_causal_conv(jnp.asarray(x), jnp.asarray(k),
                                           backend="pallas"))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fft_causal_conv_two_pass_length(rng):
    """T 8000 + K 200 pads to n = 16384, past ``TWO_PASS_FROM["fft"]``:
    the two-pass mirror of the kernel's schedule, against numpy."""
    n = tops._next_pow2(8000 + 200)
    assert n == 16384 and n >= tkfft.TWO_PASS_FROM["fft"]
    assert tkfft.two_pass_plan(n, 4) is not None
    x, k = _f32(rng, (2, 8000)), _f32(rng, (1, 200))
    got = tops.fft_causal_conv(torch.from_numpy(x), torch.from_numpy(k),
                               radix=4)
    np.testing.assert_allclose(got.numpy(), _causal(x, k), **TOL)


def test_fft_causal_conv_is_three_fft_planes_calls(rng, monkeypatch):
    """The reference's dataflow: two forward transforms at n =
    next_pow2(T + K), one inverse, each through ``fft_planes`` (whose CPU
    path is the plain version; no launch, no torch.fft)."""
    calls = []
    real = tkfft.fft_planes

    def spy(xr, xi, *, inverse=False, radix=2, block_b=None):
        calls.append((tuple(xr.shape), inverse, radix))
        return real(xr, xi, inverse=inverse, radix=radix, block_b=block_b)

    def no_torch_fft(*a, **kw):
        raise AssertionError("torch.fft called")

    monkeypatch.setattr(tkfft, "fft_planes", spy)
    monkeypatch.setattr(torch.fft, "fft", no_torch_fft)
    monkeypatch.setattr(torch.fft, "ifft", no_torch_fft)
    x, k = _f32(rng, (2, 3, 30)), _f32(rng, (1, 3, 5))
    _build.reset_launches()
    tops.fft_causal_conv(torch.from_numpy(x), torch.from_numpy(k), radix=4)
    assert calls == [((6, 64), False, 4), ((3, 64), False, 4),
                     ((6, 64), True, 4)]
    assert not any(_build.LAUNCHES.values())


def test_core_fft_exports_the_reference_surface():
    from repro.core import fft as jcore
    for name in ("realpack_fft", "fft_causal_conv"):
        assert name in core_fft.__all__ and name in jcore.__all__
        assert getattr(core_fft, name) is getattr(tops, name)


# ---------------------------------------------------------------------------
# fourier_mixing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Mixer:
    taps: torch.Tensor
    gate: torch.Tensor


def _mixer_params(rng, d, K):
    taps = (rng.standard_normal((K, d)) * 0.02).astype(np.float32)
    gate = (rng.standard_normal((d, d)) * d ** -0.5).astype(np.float32)
    return taps, gate


@pytest.mark.parametrize("B,S,d,K", [(2, 32, 128, 16), (2, 40, 128, 16),
                                     (1, 512, 768, 256)])
def test_fourier_mixing_matches_reference(rng, B, S, d, K):
    """fp32 at the reduced widths (d 128, K 16; S a multiple of K and not)
    and at fourierpim-lm's full widths (d 768, K 256, B 1, S 512)."""
    taps, gate = _mixer_params(rng, d, K)
    x = _f32(rng, (B, S, d))
    got = tcommon.fourier_mixing(_Mixer(torch.from_numpy(taps),
                                        torch.from_numpy(gate)),
                                 torch.from_numpy(x))
    want = jcommon.fourier_mixing({"taps": jnp.asarray(taps),
                                   "gate": jnp.asarray(gate)},
                                  jnp.asarray(x))
    assert got.dtype == torch.float32 and got.shape == (B, S, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MIX_TOL)


def test_fourier_mixing_bf16_matches_reference(rng):
    """bf16 activations, fp32 taps, the gate cast to bf16 (as the model
    holds it): within one bf16 step (rtol 1e-2)."""
    d, K, S = 128, 16, 32
    taps, gate = _mixer_params(rng, d, K)
    x = _f32(rng, (2, S, d))
    xb = torch.from_numpy(x).bfloat16()
    got = tcommon.fourier_mixing(
        _Mixer(torch.from_numpy(taps), torch.from_numpy(gate).bfloat16()),
        xb)
    want = jcommon.fourier_mixing(
        {"taps": jnp.asarray(taps), "gate": jnp.asarray(gate)},
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)


def test_fourier_mixing_matches_direct_convolution(rng):
    """The reference's direct-convolution test (tests/test_layers.py):
    with a zero gate, sigmoid(0) = 0.5 halves the causal convolution."""
    d, K, S = 8, 4, 32
    taps = rng.standard_normal((K, d)).astype(np.float32)
    x = rng.standard_normal((1, S, d)).astype(np.float32)
    y = tcommon.fourier_mixing(_Mixer(torch.from_numpy(taps),
                                      torch.zeros(d, d)),
                               torch.from_numpy(x))
    want = np.zeros((1, S, d))
    for t in range(S):
        for s in range(min(K, t + 1)):
            want[0, t] += taps[s] * x[0, t - s]
    want *= 0.5
    np.testing.assert_allclose(y.numpy(), want, **TOL)
