"""Port of the FFT kernel module (``repro_torch.kernels.fft``) against the
reference (``repro.kernels.fft``) on the same seeded numpy inputs.

The reference's Pallas kernels run in interpret mode on the CPU, as its own
tests run them; the port's wrappers run their plain versions, because the
tensors lie on the CPU. Tolerances, each with its reason:

  * twiddle tables, the packing helpers and the Stockham sweeps on their
    own: bitwise (``==``) -- the same fp32 operations in the same order;
  * the Hermitian split: bitwise against the reference, and exactly
    Hermitian, component by component;
  * the ``*_planes`` functions against the Pallas kernels and numpy: rtol
    1e-4, atol 1e-4 * sqrt(n), the reference FFT tests' bound (interpret
    mode may contract or reorder fp32 operations).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import fft as jfft
from repro_torch.kernels import _build
from repro_torch.kernels import fft as tfft


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(*ts):
    return [np.asarray(t) for t in ts]


@pytest.mark.parametrize("n", [1, 2, 4, 8, 64, 128, 1024, 4096, 65536,
                               262144])
@pytest.mark.parametrize("inverse", [False, True])
def test_twiddle_table_bitwise(n, inverse):
    """The port's table is the reference's, bit for bit (f64 angles,
    rounded once)."""
    got = tfft.twiddle_table(n, inverse=inverse)
    want = jfft.twiddle_table(n, inverse=inverse)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == (1, n)
        assert (g.view(np.uint32) == w.view(np.uint32)).all()
    dev = tfft.device_twiddles(n, inverse, torch.device("cpu"))
    for d, w in zip(dev, want):
        assert (d.numpy().view(np.uint32) == w.view(np.uint32)).all()


@pytest.mark.parametrize("n", [2, 4, 8, 32, 128, 512, 1024])
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("inverse", [False, True])
def test_stockham_stages_bitwise(rng, n, radix, inverse):
    """Radix 2 and 4 at odd and even log2 n: the sweeps are the reference's
    jnp sweeps written as torch ops, so the planes agree bit for bit."""
    xr = rng.standard_normal((3, n)).astype(np.float32)
    xi = rng.standard_normal((3, n)).astype(np.float32)
    wr, wi = tfft.twiddle_table(n, inverse=inverse)
    got = tfft.stockham_stages(_t(xr), _t(xi), _t(wr), _t(wi), n=n,
                               inverse=inverse, radix=radix)
    want = jfft.stockham_stages(jnp.asarray(xr), jnp.asarray(xi),
                                jnp.asarray(wr), jnp.asarray(wi), n=n,
                                inverse=inverse, radix=radix)
    for g, w in zip(_np(*got), _np(*want)):
        np.testing.assert_array_equal(g, w)
    ref = np.fft.ifft if inverse else np.fft.fft
    np.testing.assert_allclose(
        _np(*got)[0] + 1j * _np(*got)[1],
        ref(xr.astype(np.float64) + 1j * xi),
        rtol=1e-4, atol=1e-4 * np.sqrt(n) / (n if inverse else 1))


def test_hermitian_split_exact_and_matches_reference(rng):
    """Bitwise equal to the reference split, and EXACTLY Hermitian: the
    paired inverse of the real product relies on it."""
    n = 64
    zr = rng.standard_normal((3, n)).astype(np.float32)
    zi = rng.standard_normal((3, n)).astype(np.float32)
    got = _np(*tfft.hermitian_split(_t(zr), _t(zi)))
    want = _np(*jfft.hermitian_split(jnp.asarray(zr), jnp.asarray(zi)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ar, ai, br, bi = got
    for sr, si in ((ar, ai), (br, bi)):
        mirror_r = np.roll(sr[:, ::-1], 1, axis=1)   # S_{n-k}.re
        mirror_i = np.roll(si[:, ::-1], 1, axis=1)
        assert (sr == mirror_r).all()
        assert (si == -mirror_i).all()


@pytest.mark.parametrize("n", [2, 8, 64])
def test_pack_and_unpack_match_reference(rng, n):
    """The packed-Nyquist layout helpers, bitwise against the reference."""
    nh = n // 2
    sr = rng.standard_normal((2, n)).astype(np.float32)
    si = rng.standard_normal((2, n)).astype(np.float32)
    got = _np(*tfft._pack_half(_t(sr), _t(si), nh))
    want = _np(*jfft._pack_half(jnp.asarray(sr), jnp.asarray(si), nh))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    pr, pi = got
    got = _np(*tfft._unpack_full(_t(pr), _t(pi), n))
    want = _np(*jfft._unpack_full(jnp.asarray(pr), jnp.asarray(pi), n))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,radix,batch,inverse", [
    (8, 2, 3, False), (64, 4, 1, False), (128, 4, 5, False),
    (256, 2, 2, False), (64, 4, 3, True)])
def test_fft_planes_matches_pallas(rng, n, radix, batch, inverse):
    xr = rng.standard_normal((batch, n)).astype(np.float32)
    xi = rng.standard_normal((batch, n)).astype(np.float32)
    got = _np(*tfft.fft_planes(_t(xr), _t(xi), inverse=inverse, radix=radix))
    want = _np(*jfft.fft_planes(jnp.asarray(xr), jnp.asarray(xi),
                                inverse=inverse, radix=radix))
    scale = n if inverse else 1      # hold the inverse as n * ifft
    tol = dict(rtol=1e-4, atol=1e-4 * np.sqrt(n))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g * scale, w * scale, **tol)
    ref = np.fft.ifft if inverse else np.fft.fft
    np.testing.assert_allclose((got[0] + 1j * got[1]) * scale,
                               ref(xr.astype(np.float64) + 1j * xi) * scale,
                               **tol)


@pytest.mark.parametrize("n,radix,batch", [
    (2, 2, 1), (32, 4, 3), (256, 4, 5), (1024, 2, 2)])
def test_rfft_planes_matches_pallas(rng, n, radix, batch):
    """Packed half-spectrum planes, including odd batches (one zero row
    pads the last pair)."""
    x = rng.standard_normal((batch, n)).astype(np.float32)
    got = _np(*tfft.rfft_planes(_t(x), radix=radix))
    want = _np(*jfft.rfft_planes(jnp.asarray(x), radix=radix))
    for g, w in zip(got, want):
        assert g.shape == (batch, n // 2)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.sqrt(n))
    half = np.fft.rfft(x.astype(np.float64))
    pr, pi = got
    np.testing.assert_allclose(pr, half[:, :n // 2].real, rtol=1e-4,
                               atol=1e-4 * np.sqrt(n))
    np.testing.assert_allclose(pi[:, 0], half[:, n // 2].real, rtol=1e-4,
                               atol=1e-4 * np.sqrt(n))
    np.testing.assert_allclose(pi[:, 1:], half[:, 1:n // 2].imag, rtol=1e-4,
                               atol=1e-4 * np.sqrt(n))


@pytest.mark.parametrize("n,radix,batch", [
    (2, 2, 1), (16, 4, 3), (256, 2, 4), (256, 4, 5), (1024, 4, 2)])
def test_irfft_planes_matches_pallas(rng, n, radix, batch):
    """The inverse of the packed half-spectrum, including odd batches (one
    zero spectrum pads the last pair): the reference kernel at the
    reference FFT tests' bound, and the round trip at the reference's
    ``tests/test_real_fastpath.py`` bound (rtol 1e-4, atol 1e-4 * n)."""
    x = rng.standard_normal((batch, n)).astype(np.float32)
    yr, yi = jfft.rfft_planes(jnp.asarray(x), radix=radix, block_b=4)
    got = tfft.irfft_planes(_t(np.array(yr)), _t(np.array(yi)),
                            radix=radix).numpy()
    assert got.shape == (batch, n) and got.dtype == np.float32
    want = np.asarray(jfft.irfft_planes(yr, yi, radix=radix, block_b=4))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.sqrt(n))
    np.testing.assert_allclose(got, x, rtol=1e-4, atol=1e-4 * n)
    back = tfft.irfft_planes(*tfft.rfft_planes(_t(x), radix=radix),
                             radix=radix).numpy()
    np.testing.assert_allclose(back, x, rtol=1e-4, atol=1e-4 * n)


@pytest.mark.parametrize("n", [8, 64, 256])
def test_irfft_planes_matches_numpy(rng, n):
    """Against numpy.fft.irfft of the same (Hermitian) half spectrum."""
    half = (rng.standard_normal((3, n // 2 + 1))
            + 1j * rng.standard_normal((3, n // 2 + 1)))
    half[:, 0] = half[:, 0].real
    half[:, -1] = half[:, -1].real
    pr = half[:, :n // 2].real.astype(np.float32)
    pi = np.concatenate([half[:, -1:].real, half[:, 1:n // 2].imag],
                        axis=1).astype(np.float32)
    got = tfft.irfft_planes(_t(pr), _t(pi)).numpy()
    np.testing.assert_allclose(got, np.fft.irfft(half, n=n), rtol=1e-4,
                               atol=1e-4 * np.sqrt(n))


def test_plain_path_is_independent_of_block(rng):
    """On the CPU the block cap changes nothing: the plain version runs the
    whole batch at once."""
    x = _t(rng.standard_normal((5, 64)).astype(np.float32))
    base = tfft.rfft_planes(x)
    for blk in (2, 4, 8):
        for g, w in zip(tfft.rfft_planes(x, block_b=blk), base):
            assert torch.equal(g, w)


def test_batch_block_planning():
    """The block is re-derived for Hopper shared memory (two ping-pong fp32
    buffers per row against a 48 KB budget), so it differs from the
    reference's VMEM block on purpose; the real mode still doubles it."""
    for n in (1024, 4096, 16384):
        assert tfft.plan_batch_block(n, real=True) == \
            2 * tfft.plan_batch_block(n)
    assert tfft.plan_batch_block(1024) == 2       # 3 rows of 16 KB fit
    assert tfft.plan_batch_block(4096) == 1       # at least one row
    assert tfft.plan_batch_block(2) == 1024       # the cap
    for n in (2, 64, 1024, 8192):
        blk = tfft.plan_batch_block(n)
        assert blk == 1 or tfft.smem_bytes(n, blk) <= \
            tfft.SMEM_BLOCK_BUDGET
    # _fit_block: the planned block is a cap shrunk to the batch
    assert tfft._fit_block(64, 3) == 4
    assert tfft._fit_block(64, 1) == 1
    assert tfft._fit_block(64, 1, even=True) == 2
    assert tfft._fit_block(2, 100) == 2


def test_shared_memory_switch():
    """Rows stay in shared memory while two buffers of them fit 227 KB: to
    n = 8192 for the FFT and real FFT, n = 4096 for the products."""
    for n, fft_res, prod_res in ((4096, True, True), (8192, True, False),
                                 (16384, False, False), (65536, False, False)):
        assert tfft.resident(n) == fft_res
        assert tfft.resident(n, real=True) == fft_res
        assert tfft.resident(n, product=True) == prod_res
        assert tfft.resident(n, real=True, product=True) == prod_res
    # a cap that does not fit is halved; a row that does not fit is staged
    assert tfft.cta_rows(4096, 64, 8) == (2, False)
    assert tfft.cta_rows(65536, 64, 1) == (1, True)
    assert tfft.cta_rows(65536, 64, 2, real=True) == (2, True)
    with pytest.raises(ValueError):
        tfft.cta_rows(64, 8, 3, real=True)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(2, 8)
    with pytest.raises(TypeError):
        tfft.fft_planes(x.double(), x.double())
    with pytest.raises(ValueError):
        tfft.fft_planes(x, torch.zeros(2, 4))
    with pytest.raises(ValueError):
        tfft.fft_planes(torch.zeros(2, 16)[:, ::2], x)   # not contiguous
    with pytest.raises(ValueError):
        tfft.fft_planes(torch.zeros(2, 12), torch.zeros(2, 12))
    with pytest.raises(ValueError):
        tfft.fft_planes(x, x, radix=8)
    with pytest.raises(ValueError):
        tfft.rfft_planes(torch.zeros(8))
    with pytest.raises(ValueError):
        tfft.irfft_planes(x, torch.zeros(2, 4))
    with pytest.raises(TypeError):
        tfft.irfft_planes(x.double(), x.double())


def test_cpu_tensors_launch_nothing(rng):
    """On CPU tensors the wrappers run the plain version: no launch."""
    _build.reset_launches()
    x = _t(rng.standard_normal((3, 32)).astype(np.float32))
    tfft.fft_planes(x, x)
    tfft.irfft_planes(*tfft.rfft_planes(x))
    assert set(_build.LAUNCHES.values()) == {0}
