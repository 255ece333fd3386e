"""The two-pass schedule of ``fft_planes``, ``rfft_planes`` and
``irfft_planes`` (``repro_torch.kernels.fft``: ``two_pass_split``,
``stockham_two_pass``, ``rfft_two_pass``, ``irfft_two_pass``) and the
products' split-pass schedule
(``repro_torch.kernels.polymul``: ``product_two_pass_plan``,
``polymul_complex_two_pass``, ``polymul_real_two_pass``) on the CPU,
against the single-pass plain versions and the reference
(``repro.kernels.fft``).

The plain mirrors follow the kernels' dataflow: pass 1 on (B n2, n1)
sub-rows gathered at stride n2, pass 2 on (B n1, n2) contiguous sub-rows
with twiddles from the global block index, scattered at stride n1, and for
the rfft the Hermitian split paired by the mirror ranges of pass 2's CTAs,
for the irfft the unpacking per bin in pass 1's load. Tolerances, each with
its reason:

  * the mirrors against ``stockham_stages`` (the port's and the
    reference's), ``rfft_planes_plain`` and ``irfft_planes_plain``: bitwise
    (``==``) -- the very fp32 operations in the same order, only split into
    independent pieces;
  * the wrappers on CPU tensors against the reference's Pallas kernels in
    interpret mode and float64 numpy: rtol 1e-4, atol 1e-4 * sqrt(n), the
    reference FFT tests' bound (interpret mode may contract or reorder fp32
    operations).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import fft as jfft
from repro_torch.core import fft as tcore
from repro_torch.kernels import _build
from repro_torch.kernels import fft as tfft
from repro_torch.kernels import ntt as tntt
from repro_torch.kernels import polymul as tpoly


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The mirrors run thousands of small torch ops on the CPU; under xdist
    several workers' intra-op thread pools contend for the cores and these
    tests run many times slower than alone. One thread per worker keeps
    them near their single-process time; the results do not depend on it
    (elementwise fp32 operations)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _planes(rng, b, n):
    return (rng.standard_normal((b, n)).astype(np.float32),
            rng.standard_normal((b, n)).astype(np.float32))


def _sequence(n: int, radix: int) -> set[int]:
    """The L values the sweeps of an n-point transform pass through."""
    lg = n.bit_length() - 1
    L, seq = 1, set()
    if radix == 4 and lg % 2:
        L *= 2
        seq.add(L)
    while L < n:
        L *= 4 if radix == 4 else 2
        seq.add(L)
    return seq


@pytest.mark.parametrize("lg", range(14, 27))
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("real", [False, True])
def test_split_is_on_the_sweep_sequence_and_fits(lg, radix, real):
    """n1 is an L of the sweep sequence, n1 <= 8192 and n2 <= 8192 (4096
    for the rfft, whose pass 2 holds each sub-problem with its mirror), and
    n1 is the closest such to sqrt(n), the smaller on a tie. Where no split
    qualifies (radix 4 at 2^26; the rfft at 2^26) there is none, and the
    wrapper keeps one CTA per row."""
    n = 1 << lg
    cap2 = 4096 if real else 8192
    valid = [n1 for n1 in sorted(_sequence(n, radix))
             if 2 <= n1 <= 8192 and 2 <= n // n1 <= cap2]
    got = tfft.two_pass_split(n, radix, real=real)
    if not valid:
        assert got is None
        assert tfft.two_pass_plan(n, radix, real=real) is None
        return
    n1, n2 = got
    assert n1 * n2 == n and n1 in valid
    best = min(abs(lg - 2 * (v.bit_length() - 1)) for v in valid)
    assert abs(lg - 2 * (n1.bit_length() - 1)) == best
    assert n1 == min(v for v in valid
                     if abs(lg - 2 * (v.bit_length() - 1)) == best)
    if radix == 4 and lg % 4 == 2 and lg < 26:
        assert n1 == math.isqrt(n) // 2          # sqrt(n) is off the sequence
    launch = tfft.two_pass_plan(n, radix, real=real)
    assert (launch.n1, launch.n2) == (n1, n2)
    # the CTAs' shared memory, two buffers at row stride m + 1 at most,
    # fits 227 KB
    slots2 = 2 * launch.c2 if real else launch.c2
    for slots, m, avail in ((launch.c1, n1, n2), (slots2, n2, n1)):
        assert 16 * slots * (m + 1) <= tfft.SMEM_MAX_BYTES
        assert slots <= avail and slots & (slots - 1) == 0


def test_split_examples():
    assert tfft.two_pass_split(65536, 4) == (256, 256)
    assert tfft.two_pass_split(4096, 4) == (64, 64)
    assert tfft.two_pass_split(16384, 4) == (64, 256)
    assert tfft.two_pass_split(16384, 2) == (128, 128)
    assert tfft.two_pass_split(32768, 4) == (128, 256)
    assert tfft.two_pass_split(1 << 18, 4) == (256, 1024)
    assert tfft.two_pass_split(1 << 26, 2) == (8192, 8192)
    assert tfft.two_pass_split(1 << 26, 2, real=True) is None
    assert tfft.two_pass_split(1 << 25, 2, real=True) == (8192, 4096)
    assert tfft.two_pass_split(1 << 26, 4) is None
    assert tfft.two_pass_launch(256, 256) == tfft.TwoPass(256, 256, 16, 16)
    assert tfft.two_pass_launch(256, 256, real=True) == \
        tfft.TwoPass(256, 256, 16, 8)


@pytest.mark.parametrize("n", [1 << 14, 1 << 15, 1 << 16])
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("inverse", [False, True])
def test_two_pass_equals_stockham_stages(rng, n, radix, inverse):
    """The mirror at the planned split equals the port's single-pass sweeps
    and the reference's, bit for bit."""
    xr, xi = _planes(rng, 2, n)
    wr, wi = tfft.twiddle_table(n, inverse=inverse)
    n1, _ = tfft.two_pass_split(n, radix)
    got = tfft.stockham_two_pass(_t(xr), _t(xi), _t(wr), _t(wi), n=n,
                                 inverse=inverse, radix=radix, n1=n1)
    port = tfft.stockham_stages(_t(xr), _t(xi), _t(wr), _t(wi), n=n,
                                inverse=inverse, radix=radix)
    ref = jfft.stockham_stages(jnp.asarray(xr), jnp.asarray(xi),
                               jnp.asarray(wr), jnp.asarray(wi), n=n,
                               inverse=inverse, radix=radix)
    for g, p, r in zip(got, port, ref):
        assert torch.equal(g, p)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("n1", [16, 256, 4096])
def test_any_split_on_the_sequence_is_bitwise(rng, n1):
    """At n = 2^16, radix 4, every n1 on the sweep sequence gives the same
    bits."""
    n = 1 << 16
    xr, xi = _planes(rng, 2, n)
    wr, wi = (_t(w) for w in tfft.twiddle_table(n))
    got = tfft.stockham_two_pass(_t(xr), _t(xi), wr, wi, n=n, inverse=False,
                                 radix=4, n1=n1)
    want = tfft.stockham_stages(_t(xr), _t(xi), wr, wi, n=n, inverse=False,
                                radix=4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,n1", [(1 << 14, 128), (1 << 14, 512)])
def test_a_split_off_the_sequence_differs(rng, n, n1):
    """n1 = 128 or 512 is no L of the radix-4 sequence at 2^14: the split
    then runs other sweeps and gives another answer (still an FFT)."""
    xr, xi = _planes(rng, 1, n)
    wr, wi = (_t(w) for w in tfft.twiddle_table(n))
    got = tfft.stockham_two_pass(_t(xr), _t(xi), wr, wi, n=n, inverse=False,
                                 radix=4, n1=n1)
    want = tfft.stockham_stages(_t(xr), _t(xi), wr, wi, n=n, inverse=False,
                                radix=4)
    assert not torch.equal(got[0], want[0])


@pytest.mark.parametrize("n,radix", [(4096, 4), (4096, 2), (1 << 14, 4),
                                     (1 << 15, 4), (65536, 4), (65536, 2)])
@pytest.mark.parametrize("inverse", [False, True])
def test_pass2_twiddles_are_the_sweeps_own(n, radix, inverse):
    """The pass-2 table the kernels read: entry n1 (L - 1) + ((m - 1) L + l)
    n1 + l0 of the sweep at local L holds, bit for bit, the twiddle W[l_g m
    n / (R L_g)] that the whole-row sweep gives global block l_g = l0 + n1 l
    at L_g = n1 L -- the index arithmetic of csrc/stockham.cu's
    Pass2Twiddles -- and the table has n1 (n2 - 1) entries."""
    n1, n2 = tfft.two_pass_split(n, radix)
    wr, wi = tfft.twiddle_table(n, inverse=inverse)
    tr, ti = tfft.pass2_twiddles(n, n1, radix, inverse=inverse)
    assert tr.shape == ti.shape == (n1 * (n2 - 1),)
    L = 1
    while L < n2:
        for m in range(1, radix):
            for l in range(L):
                entry = n1 * (L - 1) + ((m - 1) * L + l) * n1
                lg = np.arange(n1) + n1 * l
                want = lg * m * (n // (radix * n1 * L))
                assert (tr[entry:entry + n1].view(np.uint32)
                        == wr[0, want].view(np.uint32)).all()
                assert (ti[entry:entry + n1].view(np.uint32)
                        == wi[0, want].view(np.uint32)).all()
        L *= radix


@pytest.mark.parametrize("n1,c", [(2, 1), (4, 2), (64, 8), (256, 8),
                                  (256, 1)])
def test_mirror_slots_hold_each_subproblem_once(n1, c):
    """Pass 2 of the rfft: the CTAs' slots hold every l0 < n1 exactly once,
    and each slot's mirror slot holds (n1 - l0) mod n1 in the same CTA."""
    l0, mirror = tfft.mirror_slots(n1, c)
    assert l0.shape == mirror.shape == (n1 // (2 * c), 2 * c)
    assert sorted(l0.flatten().tolist()) == list(range(n1))
    assert torch.equal(torch.gather(l0, 1, mirror), (n1 - l0) % n1)


@pytest.mark.parametrize("n", [1 << 14, 1 << 16])
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("batch", [1, 3, 4])
def test_rfft_two_pass_equals_plain(rng, n, radix, batch):
    """Odd and even batches (an odd one pairs its last row with a zero
    row): the mirror equals ``rfft_planes_plain`` bit for bit."""
    x = _t(rng.standard_normal((batch, n)).astype(np.float32))
    plan = tfft.two_pass_plan(n, radix, real=True)
    got = tfft.rfft_two_pass(x, radix=radix, plan=plan)
    for g, w in zip(got, tfft.rfft_planes_plain(x, radix=radix)):
        assert g.shape == (batch, n // 2)
        assert torch.equal(g, w)


@pytest.mark.parametrize("lg", range(13, 19))
@pytest.mark.parametrize("radix", [2, 4])
def test_irfft_two_pass_equals_plain(rng, lg, radix):
    """The irfft's mirror at the rfft's split equals ``irfft_planes_plain``
    bit for bit for random packed spectra, odd and even batches (an odd one
    pairs its last spectrum with a zero spectrum); from the threshold on it
    is the wrapper's plan."""
    n = 1 << lg
    plan = tfft.two_pass_launch(*tfft.two_pass_split(n, radix, real=True))
    if n >= tfft.TWO_PASS_FROM["irfft"]:
        assert tfft.irfft_two_pass_plan(n, radix) == plan
    for batch in (1, 2, 5):
        pr, pi = (_t(v) for v in _planes(rng, batch, n // 2))
        got = tfft.irfft_two_pass(pr, pi, radix=radix, plan=plan)
        assert got.shape == (batch, n)
        assert torch.equal(got, tfft.irfft_planes_plain(pr, pi, radix=radix))


def test_irfft_unpacks_each_bin_from_one_packed_bin(rng):
    """Pass 1's per-bin unpacking (``unpacked_bins``) gives Z = A + iB of
    the full Hermitian spectra, bin for bin, as the whole-row unpacking of
    ``irfft_planes_plain`` does: A_{n-k} = conj A_k, real DC and Nyquist."""
    n, nh = 64, 32
    pr, pi = (_t(v) for v in _planes(rng, 2, nh))
    zr, zi = tfft.unpacked_bins(pr[None], pi[None], torch.arange(n))
    ar, ai = tfft._unpack_full(pr[:1], pi[:1], n)
    br, bi = tfft._unpack_full(pr[1:], pi[1:], n)
    assert torch.equal(zr[0], (ar - bi)[0])
    assert torch.equal(zi[0], (ai + br)[0])


@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("batch", [1, 3])
def test_irfft_planes_two_pass_matches_pallas(rng, radix, batch):
    """n = 16384, where the wrapper takes two passes: the real rows against
    the reference kernel (interpret mode) and numpy.fft.irfft of the same
    half spectrum at rtol 1e-4, atol 1e-4 sqrt(n)."""
    n = 16384
    assert tfft.irfft_two_pass_plan(n, radix) is not None
    x = rng.standard_normal((batch, n)).astype(np.float32)
    pr, pi = (np.array(v) for v in jfft.rfft_planes(jnp.asarray(x),
                                                    radix=radix))
    got = tfft.irfft_planes(_t(pr), _t(pi), radix=radix).numpy()
    tol = dict(rtol=1e-4, atol=1e-4 * np.sqrt(n))
    want = jfft.irfft_planes(jnp.asarray(pr), jnp.asarray(pi), radix=radix)
    np.testing.assert_allclose(got, np.asarray(want), **tol)
    half = np.zeros((batch, n // 2 + 1), np.complex128)
    half[:, :n // 2] = pr + 1j * pi
    half[:, 0] = pr[:, 0]
    half[:, n // 2] = pi[:, 0]
    np.testing.assert_allclose(got, np.fft.irfft(half, n=n), **tol)


@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_planes_two_pass_matches_pallas(rng, radix, inverse):
    """n = 16384, where the wrapper takes two passes: against the reference
    kernel (interpret mode) and numpy at rtol 1e-4, atol 1e-4 sqrt(n), the
    inverse held as n * ifft."""
    n = 16384
    assert tfft.two_pass_plan(n, radix) is not None
    xr, xi = _planes(rng, 3, n)
    got = [g.numpy() for g in tfft.fft_planes(_t(xr), _t(xi),
                                              inverse=inverse, radix=radix)]
    want = jfft.fft_planes(jnp.asarray(xr), jnp.asarray(xi), inverse=inverse,
                           radix=radix)
    scale = n if inverse else 1
    tol = dict(rtol=1e-4, atol=1e-4 * np.sqrt(n))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g * scale, np.asarray(w) * scale, **tol)
    ref = np.fft.ifft if inverse else np.fft.fft
    np.testing.assert_allclose((got[0] + 1j * got[1]) * scale,
                               ref(xr.astype(np.float64) + 1j * xi) * scale,
                               **tol)


@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("batch", [1, 4])
def test_rfft_planes_two_pass_matches_pallas(rng, radix, batch):
    """n = 16384, two passes: the packed planes against the reference
    kernel (interpret mode) and numpy's half spectrum at rtol 1e-4, atol
    1e-4 sqrt(n)."""
    n = 16384
    assert tfft.two_pass_plan(n, radix, real=True) is not None
    x = rng.standard_normal((batch, n)).astype(np.float32)
    pr, pi = (g.numpy() for g in tfft.rfft_planes(_t(x), radix=radix))
    tol = dict(rtol=1e-4, atol=1e-4 * np.sqrt(n))
    for g, w in zip((pr, pi), jfft.rfft_planes(jnp.asarray(x), radix=radix)):
        np.testing.assert_allclose(g, np.asarray(w), **tol)
    half = np.fft.rfft(x.astype(np.float64))
    np.testing.assert_allclose(pr, half[:, :n // 2].real, **tol)
    np.testing.assert_allclose(pi[:, 0], half[:, n // 2].real, **tol)
    np.testing.assert_allclose(pi[:, 1:], half[:, 1:n // 2].imag, **tol)


@pytest.mark.parametrize("n", [4096, 8192, 16384, 65536])
def test_schedule_follows_the_threshold(n):
    """Below ``TWO_PASS_FROM`` a row stays in one CTA; from it on the
    wrappers, the plan and its description take the two-pass schedule (the
    products' split-pass one)."""
    for real, product, key in (
            (False, False, "fft"), (True, False, "rfft"),
            (False, True, "polymul_complex"), (True, True, "polymul_real")):
        launch = (tpoly.product_two_pass_plan(n, 4, real=real) if product
                  else tfft.two_pass_plan(n, 4, real=real))
        p = tcore.plan(n, 64, real=real, product=product)
        if n < tfft.TWO_PASS_FROM[key]:
            assert launch is None and p.two_pass is None
            assert "shared-memory resident" in p.describe()
        else:
            assert p.two_pass == (launch.n1, launch.n2)
            assert f"two-pass {launch.n1} x {launch.n2}" in p.describe()
            assert not p.resident
    # the irfft has no plan of its own (the library path calls it); it
    # takes the rfft's split from its own threshold
    launch = tfft.irfft_two_pass_plan(n, 4)
    assert (launch is None) == (n < tfft.TWO_PASS_FROM["irfft"])
    if launch is not None:
        assert (launch.n1, launch.n2) == tfft.two_pass_split(n, 4, real=True)
    # the exact tier: its split-pass schedule, three launches
    launch = tntt.ntt_two_pass_plan(n)
    p = tcore.plan(n, 64, exact=True)
    if n < tfft.TWO_PASS_FROM["ntt_polymul"]:
        assert launch is None and p.two_pass is None and p.launches == 1
        assert "shared-memory resident" in p.describe()
    else:
        assert p.two_pass == (launch.n1, launch.n2)
        assert p.launches == 3 and not p.resident
        assert f"two-pass {launch.n1} x {launch.n2} (3 launches" in \
            p.describe()


def test_exact_plan_at_65536_records_the_split():
    p = tcore.plan(65536, 64, exact=True)
    assert p.two_pass == (256, 256) and p.launches == 3
    assert p.exact and p.radix == 2 and not p.resident


def test_cpu_wrappers_run_the_mirror_and_launch_nothing(rng):
    """At n = 65536 the CPU wrappers run the two-pass mirrors (the same bits
    as the single-pass plain versions) and launch no kernel."""
    n = 65536
    xr, xi = (_t(v) for v in _planes(rng, 3, n))
    _build.reset_launches()
    for inverse in (False, True):
        got = tfft.fft_planes(xr, xi, inverse=inverse, radix=4)
        for g, w in zip(got, tfft.fft_planes_plain(xr, xi, inverse=inverse,
                                                   radix=4)):
            assert torch.equal(g, w)
    for g, w in zip(tfft.rfft_planes(xr, radix=4),
                    tfft.rfft_planes_plain(xr, radix=4)):
        assert torch.equal(g, w)
    for g, w in zip(tpoly.polymul_complex_planes(xr, xi, xi, xr, radix=4),
                    tpoly.polymul_complex_planes_plain(xr, xi, xi, xr,
                                                       radix=4)):
        assert torch.equal(g, w)
    assert torch.equal(tpoly.polymul_real_planes(xr, xi, radix=4),
                       tpoly.polymul_real_planes_plain(xr, xi, radix=4))
    pr, pi = (_t(v) for v in _planes(rng, 3, n // 2))
    assert torch.equal(tfft.irfft_planes(pr, pi, radix=4),
                       tfft.irfft_planes_plain(pr, pi, radix=4))
    assert set(_build.LAUNCHES.values()) == {0}


# ---------------------------------------------------------------------------
# The products' split-pass schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1 << 14, 1 << 16, 1 << 17])
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("batch", [1, 3, 4])
def test_product_mirrors_equal_plain(rng, n, radix, batch):
    """The plain mirrors of the products' kernels equal the whole-row plain
    versions bit for bit: three launches where the mirrored split is on the
    sweep sequence (radix 2; radix 4 at 2^14 and 2^16), four at 2^17, radix
    4 (odd log2 n); odd batches pair the last product with a zero row."""
    ar, ai, br, bi = (_t(v) for v in _planes(rng, batch, n)
                      + _planes(rng, batch, n))
    plans = [tpoly.product_two_pass_plan(n, radix, real=r)
             for r in (False, True)]
    assert all(p.fused == (radix == 2 or n != 1 << 17) for p in plans)
    got = tpoly.polymul_complex_two_pass(ar, ai, br, bi, radix=radix,
                                         plan=plans[0])
    for g, w in zip(got, tpoly.polymul_complex_planes_plain(ar, ai, br, bi,
                                                            radix=radix)):
        assert torch.equal(g, w)
    got = tpoly.polymul_real_two_pass(ar, br, radix=radix, plan=plans[1])
    assert got.shape == (batch, n)
    assert torch.equal(got, tpoly.polymul_real_planes_plain(ar, br,
                                                            radix=radix))


def test_product_split_off_the_sequence_differs(rng):
    """n1 = 128 is no L of the radix-4 sequence at 2^14: the products'
    mirrors split there run other sweeps and give another answer."""
    n = 1 << 14
    ar, ai = (_t(v) for v in _planes(rng, 1, n))
    for real in (False, True):
        off = tpoly.product_two_pass_launch(128, 128, 4, real=real)
        if real:
            got = (tpoly.polymul_real_two_pass(ar, ai, radix=4, plan=off),)
            want = (tpoly.polymul_real_planes_plain(ar, ai, radix=4),)
        else:
            got = tpoly.polymul_complex_two_pass(ar, ai, ai, ar, radix=4,
                                                 plan=off)
            want = tpoly.polymul_complex_planes_plain(ar, ai, ai, ar,
                                                      radix=4)
        assert not torch.equal(got[0], want[0])


@pytest.mark.parametrize("n,radix,real,want", [
    (65536, 4, False, tpoly.ProductTwoPass(256, 256, 16, 8, 16, True)),
    (65536, 4, True, tpoly.ProductTwoPass(256, 256, 16, 4, 16, True)),
    (1 << 17, 4, False, tpoly.ProductTwoPass(512, 256, 8, 8, 16, False)),
    (1 << 17, 2, True, tpoly.ProductTwoPass(256, 512, 16, 2, 16, True)),
    (8192, 4, True, tpoly.ProductTwoPass(128, 64, 16, 4, 16, False)),
])
def test_product_plan_examples(n, radix, real, want):
    """M holds cm low sub-problems of n2 points beside b's (2 cm in all) or
    their mirrors and the pair's second row's (4 cm), within
    ``TWO_PASS_CTA_POINTS``; the inverse's last pass takes sub-problems of
    n1 points where fused, n2 otherwise."""
    plan = tpoly.product_two_pass_plan(n, radix, real=real)
    assert plan == want
    held = 4 if real else 2
    assert held * plan.cm * plan.n2 <= tfft.TWO_PASS_CTA_POINTS
    assert plan.launches == (3 if plan.fused else 4)


@pytest.mark.parametrize("lg", range(13, 27))
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("real", [False, True])
def test_product_split_fits(lg, radix, real):
    """The products' split is the transforms' rule with pass-2 sub-problems
    half as long again (M holds b's, or the pair's second row's, beside
    each): two buffers of M's 2 cm or 4 cm sub-problems at row stride
    n2 + 1 fit 227 KB, and the inverse's pass-2 sub-problems are on the
    radix-4 sequence where fused."""
    n = 1 << lg
    plan = tpoly.product_two_pass_plan(n, radix, real=real)
    split = tfft.two_pass_split(n, radix, real=real, product=True)
    if split is None:
        assert plan is None
        return
    assert (plan.n1, plan.n2) == split
    held = 4 if real else 2
    assert 16 * held * plan.cm * (plan.n2 + 1) <= tfft.SMEM_MAX_BYTES
    assert plan.n2 <= tfft.TWO_PASS_MAX_SUB // held
    if plan.fused and radix == 4:
        assert (plan.n1.bit_length() - 1) % 2 == 0


@pytest.mark.parametrize("lg", range(12, 26))
@pytest.mark.parametrize("radix", [2, 4])
def test_real_mid_plan(lg, radix):
    """The real product's M at every split the planner gives it: its two
    shared buffers (4 cm rows of n2 + 2 interleaved complex values each,
    csrc/stockham.cu ``real_mid_smem``) fit one CTA; each CTA holds whole
    sub-problems with their mirrors; and its grid of (B + 1) / 2 row pairs
    times n1 / 2 cm groups takes every sub-problem of every row pair
    exactly once."""
    n = 1 << lg
    plan = tpoly.product_two_pass_plan(n, radix, real=True)
    if plan is None:
        assert tfft.two_pass_split(n, radix, real=True, product=True) is None
        return
    assert 2 * 4 * plan.cm * (plan.n2 + 2) * 8 <= tfft.SMEM_MAX_BYTES
    l0, mirror = (t.numpy() for t in tfft.mirror_slots(plan.n1, plan.cm))
    groups = plan.n1 // (2 * plan.cm)
    assert l0.shape == mirror.shape == (groups, 2 * plan.cm)
    for g in range(groups):
        assert (l0[g, mirror[g]] == (plan.n1 - l0[g]) % plan.n1).all()
    for batch in (1, 5, 64, 1024):
        pairs = (batch + 1) // 2
        taken = sorted((w // groups, int(q)) for w in range(pairs * groups)
                       for q in l0[w % groups])
        assert taken == [(p, q) for p in range(pairs)
                         for q in range(plan.n1)]


def test_real_mid_shapes_are_the_planners():
    """``polymul_real_mid_kernel`` compiles the planner's real-product
    splits at radix 4 (the radix ``plan`` takes for every local float
    route from n = 4 on) with their sizes as constants where they are
    fused (``MID_SHAPES`` in csrc/stockham.cu): the list is exactly the
    (log2 n2, radix, log2 cm) of every such split ``product_two_pass_plan``
    gives, each fused at some n, so none of the fused ones runs the
    kernel's run-time fallback."""
    import pathlib
    import re
    src = (pathlib.Path(tpoly.__file__).parent / "csrc" /
           "stockham.cu").read_text()
    body = re.search(r"#define MID_SHAPES\(X\)(.*?)\n\n", src, re.S).group(1)
    listed = {tuple(int(v) for v in m)
              for m in re.findall(r"X\((\d+), (\d+), (\d+)\)", body)}
    planned = set()
    for lg in range(12, 26):
        assert tcore.plan(1 << lg, 64, real=True, product=True).radix == 4
        plan = tpoly.product_two_pass_plan(1 << lg, 4, real=True)
        if plan is not None and plan.fused:
            planned.add((plan.n2.bit_length() - 1, 4,
                         plan.cm.bit_length() - 1))
    assert listed == planned
