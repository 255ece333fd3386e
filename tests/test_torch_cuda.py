"""The port's CUDA kernels on the card (skipped on hosts without one).

This file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same card
tensors, and the wrapper must count exactly one launch; the LM's greedy
tokens on the card must equal those on the CPU. Tolerances: fft,
rfft and irfft rtol 1e-4, atol 1e-4 * sqrt(n); the products rtol 1e-3,
atol 1e-4 * n (the reference tests' bounds). The kernels are built with
-fmad=false and perform the plain versions' fp32 operations in the same
order, so on the card they agree far inside these bounds. The NTT kernels
are exact: they equal their plain versions and the numpy reference bit
for bit (``==``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import ntt as tntt
from repro_torch.kernels import _build
from repro_torch.kernels import attention as tattn
from repro_torch.kernels import fft as tfft
from repro_torch.kernels import ntt as tknt
from repro_torch.kernels import polymul as tpoly
from repro_torch.launch import engine, serve
from repro_torch.models import convert, lm

pytestmark = pytest.mark.cuda

NS = [2, 8, 4096, 8192, 65536]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _planes(rng, batch, n, k, device):
    return [torch.from_numpy(rng.standard_normal((batch, n)).astype(
        np.float32)).to(device) for _ in range(k)]


def _close(got, want, rtol, atol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=rtol, atol=atol)


def _launched(name, fn):
    before = _build.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    return out


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_kernel_matches_plain(cuda, rng, n, radix, inverse):
    xr, xi = _planes(rng, 5, n, 2, cuda)
    got = _launched("fft_planes", lambda: tfft.fft_planes(
        xr, xi, inverse=inverse, radix=radix))
    scale = n if inverse else 1
    _close([g * scale for g in got],
           [w * scale for w in tfft.fft_planes_plain(xr, xi, inverse=inverse,
                                                     radix=radix)],
           1e-4, 1e-4 * np.sqrt(n))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("radix", [2, 4])
def test_rfft_kernel_matches_plain(cuda, rng, n, radix):
    (x,) = _planes(rng, 5, n, 1, cuda)
    got = _launched("rfft_planes", lambda: tfft.rfft_planes(x, radix=radix))
    _close(got, tfft.rfft_planes_plain(x, radix=radix), 1e-4,
           1e-4 * np.sqrt(n))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("batch", [1, 4, 5])
def test_irfft_kernel_matches_plain(cuda, rng, n, radix, batch):
    """Odd batches pair their last spectrum with a zero spectrum."""
    (x,) = _planes(rng, batch, n, 1, cuda)
    yr, yi = tfft.rfft_planes(x, radix=radix)
    got = _launched("irfft_planes",
                    lambda: tfft.irfft_planes(yr, yi, radix=radix))
    _close([got], [tfft.irfft_planes_plain(yr, yi, radix=radix)], 1e-4,
           1e-4 * np.sqrt(n))
    _close([got], [x], 1e-4, 1e-4 * n)


def _schedules(n, radix, real):
    """The planner's schedule of fft_planes / rfft_planes at n and, at the
    resident lengths, the other one: {label: TwoPass or None}."""
    planned = tfft.two_pass_plan(n, radix, real=real)
    out = {"planned": planned}
    if n <= 8192:
        split = tfft.two_pass_split(n, radix, real=real)
        out["other"] = (None if planned else
                        tfft.two_pass_launch(*split, real=real))
    return out


@pytest.mark.parametrize("n", [4096, 8192, 16384, 65536, 1 << 18])
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("batch", [1, 5, 64])
def test_fft_schedules_equal_plain_bitwise(cuda, rng, n, radix, batch):
    """fft_planes under the two-pass schedule and the resident one (the
    latter through the launch helper where the planner picks the former),
    forward and inverse: bit for bit the plain version, one count per
    call."""
    xr, xi = _planes(rng, batch, n, 2, cuda)
    for label, sched in _schedules(n, radix, False).items():
        for inverse in (False, True):
            if label == "planned":
                got = _launched("fft_planes", lambda: tfft.fft_planes(
                    xr, xi, inverse=inverse, radix=radix))
            else:
                got = _launched("fft_planes", lambda: tfft._launch_fft(
                    xr, xi, inverse, radix, tfft.plan_batch_block(n), sched))
            want = tfft.fft_planes_plain(xr, xi, inverse=inverse,
                                         radix=radix)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (label, inverse)


@pytest.mark.parametrize("n", [4096, 8192, 16384, 65536, 1 << 18])
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("batch", [1, 4, 5, 64])
def test_rfft_schedules_equal_plain_bitwise(cuda, rng, n, radix, batch):
    """rfft_planes under both schedules, odd and even batches: bit for bit
    the plain version, and the round trip through irfft_planes within rtol
    1e-4, atol 1e-4 n."""
    (x,) = _planes(rng, batch, n, 1, cuda)
    for label, sched in _schedules(n, radix, True).items():
        if label == "planned":
            got = _launched("rfft_planes",
                            lambda: tfft.rfft_planes(x, radix=radix))
        else:
            got = _launched("rfft_planes", lambda: tfft._launch_rfft(
                x, radix, tfft.plan_batch_block(n, real=True), sched))
        for g, w in zip(got, tfft.rfft_planes_plain(x, radix=radix)):
            assert torch.equal(g, w), label
        _close([tfft.irfft_planes(*got, radix=radix)], [x], 1e-4, 1e-4 * n)


@pytest.mark.parametrize("n", [4096, 8192, 65536])
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("batch", [1, 4, 5, 64])
def test_irfft_schedules_equal_plain_bitwise(cuda, rng, n, radix, batch):
    """irfft_planes under the two-pass schedule and the single-CTA one
    (resident at 4096 and 8192, staged at 65536; through the launch helper
    where the planner picks the other), odd and even batches: bit for bit
    the plain version, one count per call."""
    pr, pi = _planes(rng, batch, n // 2, 2, cuda)
    want = tfft.irfft_planes_plain(pr, pi, radix=radix)
    planned = tfft.irfft_two_pass_plan(n, radix)
    other = (None if planned else tfft.two_pass_launch(
        *tfft.two_pass_split(n, radix, real=True)))
    got = _launched("irfft_planes",
                    lambda: tfft.irfft_planes(pr, pi, radix=radix))
    assert torch.equal(got, want), "planned"
    got = _launched("irfft_planes", lambda: tfft._launch_irfft(
        pr, pi, radix, tfft.plan_batch_block(n, real=True), other))
    assert torch.equal(got, want), "other"


def _product_schedules(n, radix, real):
    """The planner's schedule of a product at n and, where both exist (the
    resident and staged lengths below 2^14), the other one: {label:
    ProductTwoPass or None}."""
    planned = tpoly.product_two_pass_plan(n, radix, real=real)
    out = {"planned": planned}
    if n <= 8192:
        split = tfft.two_pass_split(n, radix, real=real, product=True)
        out["other"] = (None if planned else
                        tpoly.product_two_pass_launch(*split, radix,
                                                      real=real))
    return out


@pytest.mark.parametrize("n", [4096, 8192, 16384, 65536, 1 << 17])
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("batch", [1, 4, 5, 64])
def test_product_schedules_equal_plain_bitwise(cuda, rng, n, radix, batch):
    """Both products under the split-pass schedule (three launches, or four
    at 2^13 and 2^17, radix 4) and the single-CTA one (resident at 4096,
    staged at 8192; through the launch helpers where the planner picks the
    other): bit for bit the plain versions, one count per call; odd
    batches pair the real product's last row with a zero row."""
    ar, ai, br, bi = _planes(rng, batch, n, 4, cuda)
    want = tpoly.polymul_complex_planes_plain(ar, ai, br, bi, radix=radix)
    for label, sched in _product_schedules(n, radix, False).items():
        if label == "planned":
            got = _launched("polymul_complex_planes",
                            lambda: tpoly.polymul_complex_planes(
                                ar, ai, br, bi, radix=radix))
        else:
            got = _launched("polymul_complex_planes",
                            lambda: tpoly._launch_polymul_complex(
                                ar, ai, br, bi, radix,
                                tpoly.default_complex_block(n), sched))
        for g, w in zip(got, want):
            assert torch.equal(g, w), label
    want = tpoly.polymul_real_planes_plain(ar, br, radix=radix)
    for label, sched in _product_schedules(n, radix, True).items():
        before = _build.SCHEDULES[_real_schedule(n, batch, sched)]
        if label == "planned":
            got = _launched("polymul_real_planes",
                            lambda: tpoly.polymul_real_planes(ar, br,
                                                              radix=radix))
        else:
            got = _launched("polymul_real_planes",
                            lambda: tpoly._launch_polymul_real(
                                ar, br, radix, tpoly.default_real_block(n),
                                sched))
        assert torch.equal(got, want), label
        assert _build.SCHEDULES[_real_schedule(n, batch, sched)] == \
            before + 1, label


def _real_schedule(n, batch, sched):
    """The key ``polymul_real_planes`` counts a call under in
    ``_build.SCHEDULES``: the split-pass schedule, or the single-CTA
    kernel's rows resident or staged."""
    if sched is not None:
        return "polymul_real_planes", "split-pass"
    _, staged = tfft.cta_rows(n, batch, tpoly.default_real_block(n),
                              real=True, product=True)
    return "polymul_real_planes", "staged" if staged else "resident"


@pytest.mark.parametrize("n", [16384, 32768])
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("batch", [1, 4, 5, 64, 1024])
def test_real_product_split_pass_bitwise(cuda, rng, n, radix, batch):
    """The real product at the benchmark's n and the next (three launches,
    four at 2^15 and radix 4), odd and even batches up to the benchmark's
    1024 products: bit for bit the plain version, one launch count and one
    call of the split-pass schedule (``SCHEDULES``) per call."""
    a, b = _planes(rng, batch, n, 2, cuda)
    key = ("polymul_real_planes", "split-pass")
    before = _build.SCHEDULES[key]
    got = _launched("polymul_real_planes",
                    lambda: tpoly.polymul_real_planes(a, b, radix=radix))
    assert _build.SCHEDULES[key] == before + 1
    assert torch.equal(got, tpoly.polymul_real_planes_plain(a, b,
                                                            radix=radix))


NTT_NS = [2, 8, 4096, 16384, 32768, 65536]


def _residues(rng, shape, q, device):
    return torch.from_numpy(rng.integers(0, q, shape).astype(
        np.uint32)).to(device)


@pytest.mark.parametrize("n", NTT_NS)
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_kernel_matches_plain_and_reference(cuda, rng, n, inverse):
    """The planned schedule and, where n has both (4 to 16384: the
    resident kernel and the two passes), the other through the launch
    helper: each equal to the plain version and the numpy reference, one
    count per call."""
    p = tntt.NTTParams.make(n)
    x = _residues(rng, (5, n), p.q, cuda)
    want = tknt.ntt_batched_plain(x, p, inverse=inverse)
    assert (tknt.residues_to_numpy(want)
            == (tntt.intt if inverse else tntt.ntt)(x.cpu().numpy(),
                                                    p)).all()
    got = _launched("ntt_batched",
                    lambda: tknt.ntt_batched(x, p, inverse=inverse))
    assert got.dtype == torch.int32
    assert torch.equal(got, want), "planned"
    if 4 <= n <= 16384:
        planned = tknt.ntt_batched_two_pass_plan(n)
        other = None if planned else tfft.two_pass_launch(
            *tfft.two_pass_split(n, 2))
        got = _launched("ntt_batched", lambda: tknt._launch_ntt_batched(
            x, p, inverse, tknt.plan_ntt_block(n, product=False), other))
        assert torch.equal(got, want), "other"


@pytest.mark.parametrize("n", NTT_NS)
@pytest.mark.parametrize("negacyclic", [True, False])
@pytest.mark.parametrize("batch,block", [(1, None), (5, None), (5, 2)])
def test_ntt_polymul_kernel_matches_plain_and_reference(
        cuda, rng, n, negacyclic, batch, block):
    p = tntt.NTTParams.make(n)
    a, b = (_residues(rng, (batch, n), p.q, cuda) for _ in range(2))
    got = _launched("ntt_polymul", lambda: tknt.ntt_polymul(
        a, b, p, negacyclic=negacyclic, block_b=block))
    assert torch.equal(got, tknt.ntt_polymul_plain(a, b, p,
                                                   negacyclic=negacyclic))
    fn = tntt.negacyclic_polymul if negacyclic else tntt.cyclic_polymul
    assert (tknt.residues_to_numpy(got)
            == fn(a.cpu().numpy(), b.cpu().numpy(), p)).all()


@pytest.mark.parametrize("n", [4096, 8192, 65536])
@pytest.mark.parametrize("negacyclic", [True, False])
@pytest.mark.parametrize("batch", [1, 4, 5, 64])
def test_ntt_polymul_schedules_equal_plain_bitwise(cuda, rng, n, negacyclic,
                                                   batch):
    """ntt_polymul under the split-pass schedule and the single-CTA one
    (resident at 4096 and 8192, staged at 65536; through the launch helper
    where the planner picks the other): equal to the plain version and the
    numpy reference, one count per call."""
    p = tntt.NTTParams.make(n)
    a, b = (_residues(rng, (batch, n), p.q, cuda) for _ in range(2))
    want = tknt.ntt_polymul_plain(a, b, p, negacyclic=negacyclic)
    fn = tntt.negacyclic_polymul if negacyclic else tntt.cyclic_polymul
    assert (tknt.residues_to_numpy(want)
            == fn(a.cpu().numpy(), b.cpu().numpy(), p)).all()
    planned = tknt.ntt_two_pass_plan(n)
    other = None if planned else tknt.ntt_two_pass_launch(
        *tfft.two_pass_split(n, 2, product=True))
    got = _launched("ntt_polymul", lambda: tknt.ntt_polymul(
        a, b, p, negacyclic=negacyclic))
    assert torch.equal(got, want), "planned"
    got = _launched("ntt_polymul", lambda: tknt._launch_ntt_polymul(
        a, b, p, negacyclic, tknt.plan_ntt_block(n), other))
    assert torch.equal(got, want), "other"


@pytest.mark.parametrize("n,kw", [(64, {"modulus": 17}),
                                  (4096, {"modulus_bits": 109}),
                                  (8192, {"modulus_bits": 109}),
                                  (65536, {"modulus_bits": 60})])
@pytest.mark.parametrize("negacyclic", [True, False])
def test_rns_kernel_matches_plain_and_reference(cuda, rng, n, kw,
                                                negacyclic):
    """Every schedule that runs at n -- the single-CTA kernel (staged at
    65536), the register steps (while both rows fit a CTA), the split-pass
    launches (from 16 points) -- the planned one through the wrapper, the
    others through its launch helper: each equal to the plain version,
    its CRT to the reference product mod Q, one count per call."""
    r = tntt.RNSParams.make(n, **kw)
    a, b = (np.stack([tntt.random_poly(rng, n, r.modulus)
                      for _ in range(3)]) for _ in range(2))
    ar, br = (torch.from_numpy(tntt.to_rns(x, r).astype(np.uint32)).to(cuda)
              for x in (a, b))
    plain = tknt.rns_ntt_polymul_plain(ar, br, r, negacyclic=negacyclic)
    want = tntt.rns_polymul_reference(a, b, r, negacyclic=negacyclic)
    assert (tntt.crt_to_modulus(tknt.residues_to_numpy(plain), r)
            == want).all()
    got = _launched("rns_ntt_polymul", lambda: tknt.rns_ntt_polymul(
        ar, br, r, negacyclic=negacyclic))
    assert torch.equal(got, plain), "planned"
    others = [None, tknt.ntt_two_pass_launch(
        *tfft.two_pass_split(n, 2, product=True))]
    if tknt.rns_steps_smem_bytes(n) <= tfft.SMEM_MAX_BYTES:
        others.append(tknt.RNSRegisterSteps(n))
    for sched in others:
        if sched == tknt.rns_schedule(n):
            continue
        got = _launched("rns_ntt_polymul",
                        lambda: tknt._launch_rns_ntt_polymul(
                            ar, br, r, negacyclic, tknt.plan_ntt_block(n),
                            sched))
        assert torch.equal(got, plain), tknt.schedule_name(sched)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("radix", [2, 4])
def test_polymul_kernels_match_plain(cuda, rng, n, radix):
    """The planner's schedule at each n (resident, split-pass); bit for bit
    is held above, the reference tests' bounds here."""
    ar, ai, br, bi = _planes(rng, 5, n, 4, cuda)
    got = _launched("polymul_complex_planes",
                    lambda: tpoly.polymul_complex_planes(ar, ai, br, bi,
                                                         radix=radix))
    _close(got, tpoly.polymul_complex_planes_plain(ar, ai, br, bi,
                                                   radix=radix),
           1e-3, 1e-4 * n)
    got = _launched("polymul_real_planes",
                    lambda: tpoly.polymul_real_planes(ar, br, radix=radix))
    _close([got], [tpoly.polymul_real_planes_plain(ar, br, radix=radix)],
           1e-3, 1e-4 * n)


@pytest.mark.parametrize("op,bits", [
    ("fft", None), ("rfft", None), ("polymul", None),
    ("polymul-real", None), ("polymul-mod", None), ("polymul-mod", 109)])
def test_service_on_card_matches_cpu(cuda, rng, op, bits):
    """The same payloads served on the card and on the CPU: each result
    within the op's tolerance of the other, and the card's kernels ran."""
    n, cap, total = 4096, 4, 6
    on_card = serve.FFTService(n, cap, op, modulus_bits=bits, device="cuda")
    on_cpu = serve.FFTService(n, cap, op, modulus_bits=bits, device="cpu")
    payloads = [on_card.bound.random_payload(rng) for _ in range(total)]
    _build.reset_launches()
    for svc in (on_card, on_cpu):
        for rid, p in enumerate(payloads):
            svc.submit(rid, p)
        assert svc.run(total)["served"] == total
    assert sum(_build.LAUNCHES.values()) == 2      # batches [4, 2]
    tol = (dict(rtol=1e-3, atol=1e-4 * n) if op.startswith("polymul")
           else dict(rtol=1e-4, atol=1e-4 * np.sqrt(n)))
    for rid, p in enumerate(payloads):
        if op == "polymul-mod":      # exact: bit for bit
            assert (on_card.results[rid] == on_cpu.results[rid]).all()
        else:
            np.testing.assert_allclose(on_card.results[rid],
                                       on_cpu.results[rid], **tol)
        on_card.bound.verify(p, on_card.results[rid])


def test_engine_copies_results_back_without_blocking(cuda, rng):
    """A dispatched batch's results go to pinned host memory, and the event
    the engine waits on comes after that copy: once it has passed, the
    buffer holds exactly what a direct, synchronous dispatch returns."""
    svc = serve.FFTService(4096, 4, "polymul-real", device="cuda")
    payloads = [svc.bound.random_payload(rng) for _ in range(3)]
    flight = svc.engine._dispatch(
        svc.bound.key, [engine._Request(i, p, 0.0)
                        for i, p in enumerate(payloads)])
    assert flight.host.is_pinned() and flight.done is not None
    flight.done.synchronize()
    np.testing.assert_array_equal(
        flight.host.numpy(), svc.bound.to_numpy(svc.bound.execute(payloads)))


@pytest.mark.parametrize("name,block", [
    ("fft_planes", 1), ("rfft_planes", 2), ("polymul_complex_planes", 1),
    ("polymul_real_planes", 2), ("irfft_planes", 2)])
@pytest.mark.parametrize("staged", [False, True])
def test_occupancy_matches_launch_configuration(cuda, name, block, staged):
    """The occupancy query reports the launchers' own configuration at
    n = 4096: one thread per radix-4 butterfly of the CTA's rows (at most
    1024), 16 bytes of shared memory per point of each complex row it
    holds (none when staged), and at least one CTA per SM. For fft_planes
    and rfft_planes these are the single-CTA kernels, which run below
    ``TWO_PASS_FROM`` (resident) and past the two-pass splits (staged);
    their two-pass launch is held by the next test."""
    slots = {"fft_planes": block, "rfft_planes": block // 2,
             "polymul_complex_planes": 2 * block,
             "polymul_real_planes": block, "irfft_planes": block // 2}[name]
    occ = _build.occupancy(name, 12, block, staged)
    assert occ["threads"] == min(1024, slots * 4096 // 4)
    assert occ["smem_bytes"] == (0 if staged else 16 * 4096 * slots)
    assert occ["regs"] > 0 and occ["ctas_per_sm"] >= 1


def _steps(lm):
    """Steps of a radix-4 sub-problem of 2^lm points: a leading radix-2
    sweep for odd lm, two radix-4 sweeps per step, one radix-4 sweep last
    where an odd count remains."""
    if lm % 2:
        return 1 + _steps(lm - 1)
    return lm // 4 + (lm % 4 == 2)


@pytest.mark.parametrize("name", ["fft_planes", "rfft_planes"])
@pytest.mark.parametrize("n", [4096, 65536, 1 << 18])
def test_two_pass_occupancy_matches_launch_configuration(cuda, name, n):
    """Each pass kernel of the two-pass launch at n (radix 4): one thread
    per work item of 16 elements of the CTA's sub-problems (at least a
    warp, at most 256), and one shared buffer of split planes at row stride
    m + 1 (8 (m + 1) bytes per sub-problem of m points) for every state a
    step leaves in shared memory, two at most: pass 1 reads and writes
    device memory, pass 2 reads it, and the fft's pass 2 writes it (the
    rfft's pass 2 holds 2 c2 sub-problems, each low one with its mirror,
    and keeps its result for the epilogue); at least one CTA per SM."""
    real = name == "rfft_planes"
    tp = tfft.two_pass_launch(*tfft.two_pass_split(n, 4, real=real),
                              real=real)
    for mode, m, c, slots, to_device in (
            (2, tp.n1, tp.c1, tp.c1, True),
            (3, tp.n2, tp.c2, (2 if real else 1) * tp.c2, not real)):
        lm = m.bit_length() - 1
        occ = _build.occupancy(name, lm, c, mode)
        assert occ["threads"] == max(32, min(256, slots * max(1, m // 16)))
        buffers = min(2, max(1, _steps(lm) - int(to_device)))
        assert occ["smem_bytes"] == buffers * 8 * slots * (m + 1)
        assert occ["regs"] > 0 and occ["ctas_per_sm"] >= 1


@pytest.mark.parametrize("name", ["polymul_complex_planes",
                                  "polymul_real_planes"])
@pytest.mark.parametrize("n", [4096, 65536, 1 << 17])
def test_product_two_pass_occupancy_matches_launch_configuration(cuda, name,
                                                                 n):
    """Each launch of a product's split-pass schedule at n (radix 4): F1 and
    I2 as the fft's pass kernels are launched (one thread per work item of
    16 elements, at most 256; one shared buffer of 8 (m + 1) bytes per
    sub-problem for each state a step leaves in shared memory, two at
    most); M with one thread per work item of its 2 cm (complex) or 4 cm
    (real) sub-problems and always two buffers of them (the product, Q and
    the inverse's first pass use both), the real product's of interleaved
    complex values at row stride m + 2; at least one CTA per SM."""
    real = name == "polymul_real_planes"
    tp = tpoly.product_two_pass_plan(n, 4, real=real) or \
        tpoly.product_two_pass_launch(
            *tfft.two_pass_split(n, 4, real=real, product=True), 4,
            real=real)
    li2 = n // tp.inverse_n1
    for mode, m, c, slots, buffers in (
            (2, tp.n1, tp.c1, tp.c1, min(2, max(1, _steps(
                tp.n1.bit_length() - 1) - 1))),
            (3, tp.n2, tp.cm, (4 if real else 2) * tp.cm, 2),
            (4, li2, tp.ci, tp.ci, min(2, max(1, _steps(
                li2.bit_length() - 1) - 1)))):
        occ = _build.occupancy(name, m.bit_length() - 1, c, mode)
        assert occ["threads"] == max(32, min(256, slots * max(1, m // 16)))
        pad = 2 if mode == 3 and real else 1
        assert occ["smem_bytes"] == buffers * 8 * slots * (m + pad)
        assert occ["regs"] > 0 and occ["ctas_per_sm"] >= 1


@pytest.mark.parametrize("n", [16384, 65536, 1 << 18])
def test_irfft_two_pass_occupancy_matches_launch_configuration(cuda, n):
    """Both pass kernels of the irfft's two-pass launch at n (radix 4), as
    the fft's: one thread per work item of 16 elements of the CTA's c
    sub-problems (at least a warp, at most 256), one shared buffer of
    8 (m + 1) bytes a sub-problem for each state a step leaves in shared
    memory (both passes read and write device memory), two at most."""
    tp = tfft.two_pass_launch(*tfft.two_pass_split(n, 4, real=True))
    for mode, m, c in ((2, tp.n1, tp.c1), (3, tp.n2, tp.c2)):
        lm = m.bit_length() - 1
        occ = _build.occupancy("irfft_planes", lm, c, mode)
        assert occ["threads"] == max(32, min(256, c * max(1, m // 16)))
        buffers = min(2, max(1, _steps(lm) - 1))
        assert occ["smem_bytes"] == buffers * 8 * c * (m + 1)
        assert occ["regs"] > 0 and occ["ctas_per_sm"] >= 1


@pytest.mark.parametrize("n", [4096, 65536, 1 << 19])
def test_ntt_two_pass_occupancy_matches_launch_configuration(cuda, n):
    """Each launch of the exact product's split-pass schedule at n: one
    thread per work item of 16 residues of the sub-problems a CTA holds
    (F1 and M: c of each operand; at least a warp, at most 256); shared
    buffers of 4 (m + 1) bytes a held sub-problem, one for each state the
    radix-2 steps of up to four sweeps leave in shared memory (F1 and I2:
    two at most) and always two for M."""
    tp = tfft.two_pass_split(n, 2, product=True)
    tp = tknt.ntt_two_pass_launch(*tp)
    for mode, m, c, held in ((2, tp.n1, tp.c1, 2 * tp.c1),
                             (3, tp.n2, tp.cm, 2 * tp.cm),
                             (4, tp.n1, tp.ci, tp.ci)):
        lm = m.bit_length() - 1
        occ = _build.occupancy("ntt_polymul", lm, c, mode)
        assert occ["threads"] == max(32, min(256, held * max(1, m // 16)))
        steps = -(-lm // 4)
        buffers = 2 if mode == 3 else min(2, max(1, steps - 1))
        assert occ["smem_bytes"] == buffers * 4 * held * (m + 1)
        assert occ["regs"] > 0 and occ["ctas_per_sm"] >= 1


@pytest.mark.parametrize("n", [2048, 4096, 8192])
def test_rns_register_steps_occupancy_matches_launch_configuration(cuda, n):
    """The register-step kernel: one thread per work item of 16 residues
    of both operands' rows (at most 256), two shared buffers of both rows
    at one pad word in 16 (17n bytes)."""
    lg = n.bit_length() - 1
    occ = _build.occupancy("rns_ntt_polymul", lg, 1, 5)
    assert occ["threads"] == min(256, 2 * n // 16)
    assert occ["smem_bytes"] == tknt.rns_steps_smem_bytes(n) == 17 * n
    assert occ["regs"] > 0 and occ["ctas_per_sm"] >= 1


@pytest.mark.parametrize("n", [4096, 65536, 1 << 19])
def test_ntt_batched_two_pass_occupancy_matches_launch_configuration(
        cuda, n):
    """Both launches of the NTT's two passes at n, as the fft's: one
    thread per work item of 16 residues of the CTA's c sub-problems (at
    least a warp, at most 256), one shared buffer of 4 (m + 1) bytes a
    sub-problem for each state the radix-2 steps of up to four sweeps
    leave in shared memory, two at most."""
    tp = tfft.two_pass_launch(*tfft.two_pass_split(n, 2))
    for mode, m, c in ((2, tp.n1, tp.c1), (3, tp.n2, tp.c2)):
        lm = m.bit_length() - 1
        occ = _build.occupancy("ntt_batched", lm, c, mode)
        assert occ["threads"] == max(32, min(256, c * max(1, m // 16)))
        buffers = min(2, max(1, -(-lm // 4) - 1))
        assert occ["smem_bytes"] == buffers * 4 * c * (m + 1)
        assert occ["regs"] > 0 and occ["ctas_per_sm"] >= 1


@pytest.mark.parametrize("name,slots", [
    ("ntt_batched", 1), ("ntt_polymul", 2), ("rns_ntt_polymul", 2)])
@pytest.mark.parametrize("staged", [False, True])
def test_ntt_occupancy_matches_launch_configuration(cuda, name, slots,
                                                    staged):
    """At n = 4096 and one row per CTA: one thread per butterfly (at most
    1024), 8 bytes of shared memory per residue of each row the CTA holds
    (none when staged), and at least one CTA per SM."""
    occ = _build.occupancy(name, 12, 1, staged)
    assert occ["threads"] == min(1024, slots * 4096 // 2)
    assert occ["smem_bytes"] == (0 if staged else 8 * 4096 * slots)
    assert occ["regs"] > 0 and occ["ctas_per_sm"] >= 1


# ---------------------------------------------------------------------------
# Flash attention and the LM on the card
# ---------------------------------------------------------------------------

#: bf16: kernel and plain version round the same fp32 result once; a
#: difference of fp32 sums may move it to the neighbouring bf16 value, a
#: step of at most 2^-8 relative. fp32: the reference tests' 2e-4.
ATTN_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
            torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


def _counter(dtype, hd):
    """The launch counter of the kernel that (dtype, hd) dispatches to."""
    return tattn.LAUNCHERS[tattn.kernel_for(dtype, hd)]


@pytest.mark.parametrize("hd", [32, 64, 128, 320])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,KV,window,causal", [
    (200, 4, 2, 1 << 30, True), (130, 2, 1, 24, True),
    (100, 2, 2, 1 << 30, False), (64, 4, 4, 1, True), (1, 4, 2, 1 << 30, True),
    (37, 4, 2, 1 << 30, True), (300, 6, 2, 100, True)])
def test_flash_kernel_matches_plain(cuda, hd, dtype, S, H, KV, window,
                                    causal):
    """Each (dtype, hd) against the plain version of the kernel it
    dispatches to, whose counter alone moves: bf16 on the wgmma kernel,
    fp32 on the 3xTF32 kernel, at every head_dim; S ragged against the
    kernels' tiles, S = 1 and S < 64."""
    g = torch.Generator(device=cuda).manual_seed(hd + S)
    q = torch.randn(2, S, H, hd, device=cuda, generator=g).to(dtype)
    k, v = (torch.randn(2, S, KV, hd, device=cuda, generator=g).to(dtype)
            for _ in range(2))
    kw = dict(window=window, causal=causal, scale=hd ** -0.5)
    others = set(tattn.LAUNCHERS.values()) - {_counter(dtype, hd)}
    before = {n: _build.LAUNCHES[n] for n in others}
    got = _launched(_counter(dtype, hd),
                    lambda: tattn.attention(q, k, v, **kw))
    assert {n: _build.LAUNCHES[n] for n in others} == before
    want = tattn.attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 64),
                                      (torch.float32, 128),
                                      (torch.float32, 320),
                                      (torch.bfloat16, 64),
                                      (torch.bfloat16, 128),
                                      (torch.bfloat16, 320)])
def test_flash_public_layout_matches_plain(cuda, dtype, hd):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(6, 96, hd, device=cuda, generator=g).to(dtype)
               for _ in range(3))
    got = _launched(_counter(dtype, hd),
                    lambda: tattn.flash_attention(q, k, v, window=40))
    bk = tattn.kernel_keys(dtype, hd)
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        tattn.flash_attention_plain(q, k, v, window=40, bk=bk).float().cpu()
        .numpy(), **ATTN_TOL[dtype])
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        tattn.attention_ref(q, k, v, window=40).float().cpu().numpy(),
        **ATTN_TOL[dtype])


def test_flash_kernel_raises_on_unsupported_head_dim(cuda):
    x = torch.zeros(1, 8, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim 48"):
        tattn.attention(x, x, x, window=4, scale=1.0)


def _wgmma_smem(hd, keys=128):
    """Q tile (128 rows), two stages of K and V tiles (``keys`` keys), nine
    mbarriers, and 1024 bytes to align the tiles to the swizzle atom."""
    return 2 * 128 * hd + 2 * 2 * 2 * keys * hd + 8 * 9 + 1024


def _tf32_smem(hd, keys, stages=2):
    """Q_lo (128 rows of fp32), ``stages`` stages of five fp32 planes
    (K_hi, K_lo, V, V^T_hi, V^T_lo) of ``keys`` keys, 1 + 6 stages
    mbarriers, and 1024 bytes to align the tiles to the swizzle atom."""
    return (4 * 128 * hd + stages * 5 * 4 * keys * hd + 8 * (1 + 6 * stages)
            + 1024)


def _tf32_split_smem(hd, keys=8, stages=3):
    """The head_dim-split instance: Q_lo (64 rows of fp32), ``stages``
    stages of four fp32 planes (K_hi, K_lo, V^T_hi, V^T_lo) of ``keys``
    keys, the exchange of s (2 tiles x 2 warpgroups x 128 threads x keys /
    2 floats), 1 + 6 stages mbarriers, and 1024 bytes of alignment."""
    return (4 * 64 * hd + stages * 4 * 4 * keys * hd + 2 * 2 * 128 * keys * 2
            + 8 * (1 + 6 * stages) + 1024)


@pytest.mark.parametrize("name,hd,bf16,threads,smem,ctas", [
    ("flash_attention", 128, 1, 256, 4 * (64 * 132 * 2 + 64 * 68), 2),
    ("flash_attention", 320, 0, 256, 4 * (64 * 324 * 2 + 64 * 68), 1),
    ("flash_attention_wgmma", 64, 1, 384, _wgmma_smem(64), 1),
    ("flash_attention_wgmma", 128, 1, 384, _wgmma_smem(128), 1),
    # gemma3-4b's heads: 48-key tiles
    ("flash_attention_wgmma", 320, 1, 384, _wgmma_smem(320, 48), 1),
    # the reduced configs' head_dim: one 64-byte box a row
    ("flash_attention_wgmma", 32, 1, 384, _wgmma_smem(32), 1),
    # fp32: 512 threads (loads and K prep, V prep, two consumers)
    ("flash_attention_tf32", 64, 0, 512, _tf32_smem(64, 64), 1),
    ("flash_attention_tf32", 128, 0, 512, _tf32_smem(128, 32), 1),
    # the reduced configs' head_dim in fp32: one 128-byte box a row
    ("flash_attention_tf32", 32, 0, 512, _tf32_smem(32, 64, 4), 1),
    # gemma3-4b in fp32: 64 query rows, head_dim split, 8-key tiles
    ("flash_attention_tf32", 320, 0, 512, _tf32_split_smem(320), 1)])
def test_attention_occupancy(cuda, name, hd, bf16, threads, smem, ctas):
    occ = _build.occupancy(name, hd, bf16, 0)
    assert occ["threads"] == threads
    assert occ["smem_bytes"] == smem
    assert occ["ctas_per_sm"] == ctas


def _wgmma_direct(q, k, v, *, window, causal):
    """The wgmma launcher called directly, past the wrapper's checks."""
    B, S, H, hd = q.shape
    o = torch.empty_like(q)
    _build.launch("flash_attention_wgmma", "flash_attention_wgmma",
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B,
                  S, H, k.shape[2], hd, *q.stride()[:3], *k.stride()[:3],
                  *v.stride()[:3], *o.stride()[:3], window, int(causal),
                  hd ** -0.5, 1)
    return o


@pytest.mark.parametrize("S,window,causal", [
    (1, 1 << 30, True), (37, 1 << 30, True), (300, 24, True),
    (200, 1 << 30, False), (1000, 1 << 30, True), (2048, 1024, True)])
def test_wgmma_hd320_matches_plain(cuda, S, window, causal):
    """The hd-320 instance (48-key tiles) against the plain version folded
    at its key tile, at gemma3-4b's 8 heads over 4 kv heads."""
    g = torch.Generator(device=cuda).manual_seed(S + 48)
    q = torch.randn(2, S, 8, 320, device=cuda, generator=g).bfloat16()
    k, v = (torch.randn(2, S, 4, 320, device=cuda, generator=g).bfloat16()
            for _ in range(2))
    kw = dict(window=window, causal=causal, scale=320 ** -0.5)
    got = _launched("flash_attention_wgmma",
                    lambda: tattn.attention(q, k, v, **kw))
    want = tattn.attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **ATTN_TOL[torch.bfloat16])


@pytest.mark.parametrize("S,window,causal,H,KV", [
    (1, 1 << 30, True, 16, 8), (37, 1 << 30, True, 16, 8),
    (300, 24, True, 16, 8), (200, 1 << 30, False, 16, 8),
    (1000, 1 << 30, True, 16, 8), (1024, 1 << 30, True, 8, 8),
    (2048, 1 << 30, True, 16, 8)])
def test_wgmma_hd32_matches_plain(cuda, S, window, causal, H, KV):
    """The hd-32 instance (one 64-byte box a row, its key tile) against the
    plain version folded at that tile, p split in two bf16 parts: S = 1,
    S < 64, window 24, non-causal, ragged S, G = 1 and the served prompt;
    only its counter moves."""
    g = torch.Generator(device=cuda).manual_seed(S + 32)
    q = torch.randn(2, S, H, 32, device=cuda, generator=g).bfloat16()
    k, v = (torch.randn(2, S, KV, 32, device=cuda, generator=g).bfloat16()
            for _ in range(2))
    kw = dict(window=window, causal=causal, scale=32 ** -0.5)
    before = dict(_build.LAUNCHES)
    got = tattn.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in _build.LAUNCHES.items()
            if c != before[n]} == {"flash_attention_wgmma": 1}
    want = tattn.attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **ATTN_TOL[torch.bfloat16])


@pytest.mark.parametrize("B,S,window,causal,H,KV", [
    (2, 1, 1 << 30, True, 8, 4), (3, 37, 1 << 30, True, 8, 4),
    (2, 300, 24, True, 8, 4), (2, 200, 1 << 30, False, 8, 4),
    (2, 1000, 1 << 30, True, 8, 4), (2, 1024, 1 << 30, True, 4, 4),
    (1, 2048, 1024, True, 8, 4), (1, 2048, 1 << 30, True, 8, 4)])
def test_tf32_hd320_matches_plain(cuda, B, S, window, causal, H, KV):
    """The fp32 hd-320 instance (64 query rows a CTA, head_dim split
    between its two consumer warpgroups, 8-key tiles) against the plain
    version, which sums s over the two halves as the kernel does, within
    the reference tests' 2e-4: S = 1, S < 64, window 24, non-causal,
    ragged S, G = 1 and gemma3-4b's local and global layers at the served
    prompt; only its counter moves."""
    g = torch.Generator(device=cuda).manual_seed(S + 320)
    q = torch.randn(B, S, H, 320, device=cuda, generator=g)
    k, v = (torch.randn(B, S, KV, 320, device=cuda, generator=g)
            for _ in range(2))
    kw = dict(window=window, causal=causal, scale=320 ** -0.5)
    before = dict(_build.LAUNCHES)
    got = tattn.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in _build.LAUNCHES.items()
            if c != before[n]} == {"flash_attention_tf32": 1}
    want = tattn.attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **ATTN_TOL[torch.float32])


@pytest.mark.parametrize("B,S,window,causal,H,KV", [
    (2, 1, 1 << 30, True, 16, 8), (3, 37, 1 << 30, True, 16, 8),
    (2, 300, 24, True, 16, 8), (2, 200, 1 << 30, False, 16, 8),
    (2, 1000, 1 << 30, True, 16, 8), (2, 1024, 1 << 30, True, 8, 8),
    (2, 2048, 1 << 30, True, 16, 8)])
def test_tf32_hd32_matches_plain(cuda, B, S, window, causal, H, KV):
    """The fp32 hd-32 instance (one 128-byte box a row, its key tile)
    against the plain version folded at that tile, both products as three
    TF32 products, within the reference tests' 2e-4: S = 1, S < 64, window
    24, non-causal, ragged S, G = 1 and the served prompt; only its counter
    moves."""
    g = torch.Generator(device=cuda).manual_seed(S + 3232)
    q = torch.randn(B, S, H, 32, device=cuda, generator=g)
    k, v = (torch.randn(B, S, KV, 32, device=cuda, generator=g)
            for _ in range(2))
    kw = dict(window=window, causal=causal, scale=32 ** -0.5)
    before = dict(_build.LAUNCHES)
    got = tattn.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in _build.LAUNCHES.items()
            if c != before[n]} == {"flash_attention_tf32": 1}
    want = tattn.attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **ATTN_TOL[torch.float32])


def test_wgmma_launcher_refuses_an_instance_it_lacks(cuda):
    """A head_dim with no instance (96) is refused by the launcher, and the
    wrapper counts no launch."""
    x = torch.zeros(1, 8, 2, 96, device=cuda, dtype=torch.bfloat16)
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="flash_attention_wgmma"):
        _wgmma_direct(x, x, x, window=4, causal=True)
    assert _build.LAUNCHES == before


def test_wgmma_kernel_refuses_fp32(cuda):
    """The wgmma launcher takes bf16 only; asked for fp32 it refuses the
    launch, and the wrapper raises instead of running another kernel."""
    x = torch.zeros(1, 8, 2, 64, device=cuda)
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="flash_attention_wgmma"):
        _build.launch("flash_attention_wgmma", "flash_attention_wgmma",
                      x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(),
                      1, 8, 2, 2, 64, *x.stride()[:3] * 4, 8, 1, 1.0, 0)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("B,S,H,KV,window,causal", [
    (2, 2048, 16, 8, 24, True), (2, 1024, 16, 8, 1 << 30, False),
    (2, 1000, 16, 8, 1 << 30, True), (2, 1, 16, 8, 1 << 30, True),
    (3, 37, 16, 8, 1 << 30, True), (2, 1024, 8, 8, 1 << 30, True),
    (2, 333, 24, 8, 100, True)])
def test_tf32_kernel_matches_plain(cuda, hd, B, S, H, KV, window, causal):
    """The 3xTF32 kernel against its plain version (three TF32 products,
    its key tile) within the reference tests' 2e-4: window 24, non-causal,
    ragged S, S = 1, S < 64, G = 1 and a ragged window; only its counter
    moves."""
    g = torch.Generator(device=cuda).manual_seed(hd + S + H)
    q = torch.randn(B, S, H, hd, device=cuda, generator=g)
    k, v = (torch.randn(B, S, KV, hd, device=cuda, generator=g)
            for _ in range(2))
    kw = dict(window=window, causal=causal, scale=hd ** -0.5)
    before = dict(_build.LAUNCHES)
    got = tattn.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    moved = {n: c - before[n] for n, c in _build.LAUNCHES.items()
             if c != before[n]}
    assert moved == {"flash_attention_tf32": 1}
    want = tattn.attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **ATTN_TOL[torch.float32])


@pytest.mark.parametrize("hd,counter", [(32, "flash_attention_tf32"),
                                        (64, "flash_attention_tf32"),
                                        (128, "flash_attention_tf32"),
                                        (320, "flash_attention_tf32")])
def test_fp32_reaches_one_kernel(cuda, hd, counter):
    """fp32 at head_dim 32, 64, 128 and 320 launches the 3xTF32 kernel
    and nothing else."""
    x = torch.randn(1, 70, 4, hd, device=cuda)
    _build.reset_launches()
    tattn.attention(x, x, x, window=1 << 30, scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {counter: 1}


def test_tf32_kernel_refuses_bf16(cuda):
    """The tf32 launcher takes fp32 only; asked for bf16 it refuses the
    launch, and the wrapper raises instead of running another kernel."""
    x = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="flash_attention_tf32"):
        _build.launch("flash_attention_tf32", "flash_attention_tf32",
                      x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(),
                      1, 8, 2, 2, 64, *x.stride()[:3] * 4, 8, 1, 1.0, 1)
    assert _build.LAUNCHES == before


def test_reduced_config_bf16_prefill_launches_only_wgmma(cuda, monkeypatch):
    """A reduced config in bf16 (head_dim 32): its prefill launches the
    wgmma kernel once per layer and nothing else, and its last logits are
    within four bf16 steps of the same prefill with the plain version in
    place of the kernel (which launches nothing)."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b").scaled_down(),
                              dtype="bfloat16")
    sd = convert.init_params(cfg, torch.Generator().manual_seed(0))
    model = convert.build(cfg, sd, cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 100),
                           generator=torch.Generator().manual_seed(1)).to(cuda)
    _build.reset_launches()
    got, _ = model.prefill(tokens)
    torch.cuda.synchronize()
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {
        "flash_attention_wgmma": cfg.num_layers}
    kernel_attention = tattn.attention
    monkeypatch.setattr(tattn, "attention",
                        lambda q, k, v, *, window, causal=True, scale,
                        kv_block=None: tattn.attention_plain(
                            q, k, v, window=window, causal=causal,
                            scale=scale))
    want, _ = model.prefill(tokens)
    torch.cuda.synchronize()
    assert tattn.attention is not kernel_attention
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {
        "flash_attention_wgmma": cfg.num_layers}
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=0,
                               atol=0.125)


def test_generate_on_card_matches_cpu(cuda):
    """The smoke qwen3 in fp32 with the same weights on the card and on the
    CPU: the same greedy tokens, one flash-attention launch per layer per
    prefill."""
    cfg = get_config("qwen3-1.7b").scaled_down()
    sd = convert.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 48),
                           generator=torch.Generator().manual_seed(1))
    want = lm.generate(convert.build(cfg, sd, "cpu"), tokens, 6)
    _build.reset_launches()
    got = lm.generate(convert.build(cfg, sd, cuda), tokens.to(cuda), 6)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention_tf32"] == cfg.num_layers
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


# ---------------------------------------------------------------------------
# The FFT compositions and fourierpim-lm: every transform a launch of
# fft_planes (three per causal convolution), none of torch.fft
# ---------------------------------------------------------------------------

def _plain_fft_planes(xr, xi, *, inverse=False, radix=2, block_b=None):
    """``fft_planes`` with its plain version on the card (the two-pass
    mirror equals the whole-row sweeps bit for bit)."""
    return tfft.fft_planes_plain(xr, xi, inverse=inverse, radix=radix)


def _causal_numpy(x, k):
    T = x.shape[-1]
    lead = np.broadcast_shapes(x.shape[:-1], k.shape[:-1])
    xb = np.broadcast_to(x, lead + (T,)).reshape(-1, T).astype(np.float64)
    kb = np.broadcast_to(k, lead + k.shape[-1:]).reshape(-1, k.shape[-1])
    return np.stack([np.convolve(a, b)[:T] for a, b in zip(xb, kb)]
                    ).reshape(lead + (T,))


def test_fourier_ops_on_card_match_numpy(cuda, rng):
    """realpack_fft, fft2 forward and inverse, fft_conv2d and
    fft_causal_conv on card tensors against float64 numpy, at the
    reference tests' rtol 1e-3, atol 1e-3; each transform one launch."""
    from repro_torch.kernels import ops as tops
    x, y = (rng.standard_normal((4, 256)).astype(np.float32)
            for _ in range(2))
    _build.reset_launches()
    gx, gy = tops.realpack_fft(torch.from_numpy(x).to(cuda),
                               torch.from_numpy(y).to(cuda), radix=4)
    assert _build.LAUNCHES["fft_planes"] == 1
    _close([gx, gy], [torch.from_numpy(np.fft.fft(x)),
                      torch.from_numpy(np.fft.fft(y))], 1e-3, 1e-3 * 256)
    z = (rng.standard_normal((2, 32, 64))
         + 1j * rng.standard_normal((2, 32, 64))).astype(np.complex64)
    f = tops.fft2(torch.from_numpy(z).to(cuda), radix=4)
    back = tops.fft2(f, inverse=True, radix=4)
    assert _build.LAUNCHES["fft_planes"] == 5
    np.testing.assert_allclose(f.cpu().numpy(), np.fft.fft2(z), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(back.cpu().numpy(), z, rtol=1e-3, atol=1e-4)
    img = rng.standard_normal((2, 12, 20)).astype(np.float32)
    kern = rng.standard_normal((3, 5)).astype(np.float32)
    got = tops.fft_conv2d(torch.from_numpy(img).to(cuda),
                          torch.from_numpy(kern).to(cuda))
    want = tops.fft_conv2d(torch.from_numpy(img), torch.from_numpy(kern))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-3,
                               atol=1e-3)
    xs = rng.standard_normal((2, 8, 100)).astype(np.float32)
    ks = rng.standard_normal((1, 8, 17)).astype(np.float32)
    before = _build.LAUNCHES["fft_planes"]
    got = tops.fft_causal_conv(torch.from_numpy(xs).to(cuda),
                               torch.from_numpy(ks).to(cuda), radix=4)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fft_planes"] == before + 3
    np.testing.assert_allclose(got.cpu().numpy(), _causal_numpy(xs, ks),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("xs,K", [((2, 768, 2048), 256),
                                  ((1, 64, 8192), 256)])
def test_fft_causal_conv_kernel_equals_plain(cuda, monkeypatch, xs, K):
    """fourierpim-lm's convolution at n = 4096 (resident, one kernel a
    transform) and n = 16384 (two passes, two kernels a transform, one
    counted launch): through the kernel == with the plain version swapped
    in for ``fft_planes`` on the card, bit for bit, and within 1e-3 of
    float64 numpy on a few rows."""
    from repro_torch.kernels import ops as tops
    g = torch.Generator(device=cuda).manual_seed(K)
    x = torch.randn(*xs, device=cuda, generator=g)
    k = torch.randn(1, xs[1], K, device=cuda, generator=g) * 0.02
    _build.reset_launches()
    got = tops.fft_causal_conv(x, k, radix=4)
    torch.cuda.synchronize()
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {
        "fft_planes": 3}
    monkeypatch.setattr(tfft, "fft_planes", _plain_fft_planes)
    want = tops.fft_causal_conv(x, k, radix=4)
    assert torch.equal(got, want)
    rows = _causal_numpy(x[0, :4].cpu().numpy(), k[0, :4].cpu().numpy())
    np.testing.assert_allclose(got[0, :4].cpu().numpy(), rows, rtol=1e-3,
                               atol=1e-3)


def test_fourierpim_prefill_launches_fft_planes_three_times_per_layer(cuda):
    """fourierpim-lm at full width in bf16 (12 layers, d 768, K 256): one
    prefill of B 2 x S 512 launches fft_planes 36 times and nothing else;
    its last logits are finite."""
    cfg = dataclasses.replace(get_config("fourierpim-lm"), dtype="bfloat16")
    model = convert.build(cfg, convert.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0)), cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 512), device=cuda,
                           generator=torch.Generator(
                               device=cuda).manual_seed(1))
    _build.reset_launches()
    last, state = model.prefill(tokens)
    torch.cuda.synchronize()
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {
        "fft_planes": 3 * cfg.num_layers}
    assert last.shape == (2, cfg.vocab_padded)
    assert torch.isfinite(last.float()).all()
    assert state["ring"].shape == (cfg.num_layers, 2, cfg.fourier_taps,
                                   cfg.d_model)


def test_fourierpim_on_card_matches_cpu(cuda):
    """The reduced fourierpim-lm in fp32 with the same weights on the card
    and on the CPU: prefill and three decode steps' logits within 2e-3."""
    cfg = get_config("fourierpim-lm").scaled_down()
    sd = convert.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 35),
                           generator=torch.Generator().manual_seed(1))
    outs = []
    for dev in ("cpu", cuda):
        model = convert.build(cfg, sd, dev)
        t = tokens.to(dev)
        last, state = model.prefill(t[:, :32], cache_capacity=35)
        steps = [last]
        for pos in range(32, 35):
            logits, state = model.decode_step(state, t[:, pos], pos)
            steps.append(logits)
        outs.append(torch.stack([s.float().cpu() for s in steps]))
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), rtol=2e-3,
                               atol=2e-3)


# ---------------------------------------------------------------------------
# Auto mode on the card: the complex-packing routes and an auto engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op,route,counter", [
    ("rfft", "rfft-complex", "fft_planes"),
    ("polymul-real", "polymul-real-complex", "polymul_complex_planes"),
])
@pytest.mark.parametrize("n", [256, 4096, 65536])
def test_complex_packing_routes_match_numpy(cuda, rng, op, route, counter,
                                            n):
    """The routes auto mode binds where the cost model picks complex
    packing for a real op: one launch of the complex kernel a batch on
    cast-up rows, every row within the op's oracle tolerance (rel 1e-3)
    of numpy."""
    from repro_torch.launch import ops as tops
    ctx = tops.OpContext(auto=True, packings=(False,))
    bound = tops.get_op(op).bind(n, ctx, batch=5, device="cuda")
    assert bound.route == route and not bound.plan.real
    payloads = [bound.random_payload(rng) for _ in range(5)]
    before = _build.LAUNCHES[counter]
    out = bound.to_numpy(bound.execute(payloads))
    assert _build.LAUNCHES[counter] == before + 1
    for payload, row in zip(payloads, out):
        bound.verify(payload, row)


def test_auto_engine_serves_the_five_ops_on_card(cuda, rng):
    """``ServeEngine(auto=True)`` at n = 4096: every op binds the cost
    model's route, serves on the card, equals its numpy oracle
    (``polymul-mod`` bit for bit), launches its route's kernel once a
    dispatched batch, and reports predicted against observed cost."""
    ops = ("fft", "rfft", "polymul", "polymul-real", "polymul-mod")
    counters = {"fft": "fft_planes", "rfft-real": "rfft_planes",
                "polymul": "polymul_complex_planes",
                "polymul-real-packed": "polymul_real_planes",
                "polymul-mod-single": "ntt_polymul"}
    eng = engine.ServeEngine(max_batch=8, auto=True, device="cuda")
    for op in ops:
        eng.register(op, 4096)
    eng.warmup()
    torch.cuda.synchronize()
    _build.reset_launches()
    kept = {}
    for i in range(40):
        op = ops[i % len(ops)]
        payload = eng.bound(op, 4096).random_payload(rng)
        kept[eng.submit(op, 4096, payload)] = (op, payload)
    stats = eng.run(40)
    for rid, (op, payload) in kept.items():
        eng.bound(op, 4096).verify(payload, eng.results[rid])
    want = {counters[b["route"]]: b["batches"]
            for b in stats["buckets"].values()}
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == want
    for b in stats["buckets"].values():
        assert b["predicted_tier"] == "local"
        assert b["predicted_s_per_req"] > 0 and b["observed_s_per_req"] > 0


ROUTE_COUNTERS = {"fft": "fft_planes", "rfft-real": "rfft_planes",
                  "polymul": "polymul_complex_planes",
                  "polymul-real-packed": "polymul_real_planes",
                  "polymul-mod-single": "ntt_polymul",
                  "polymul-mod-rns": "rns_ntt_polymul"}


def _serve_all(eng, ops, n, rng, total):
    """Submit ``total`` requests round-robin before the run, serve them
    with the counters zeroed after the warmup, and check every result
    against its oracle. Returns the stats and the launches."""
    for op in ops:
        eng.register(op, n)
    eng.warmup()
    torch.cuda.synchronize()
    _build.reset_launches()
    kept = {}
    for i in range(total):
        op = ops[i % len(ops)]
        payload = eng.bound(op, n).random_payload(rng)
        kept[eng.submit(op, n, payload)] = (op, payload)
    stats = eng.run(total)
    for rid, (op, payload) in kept.items():
        eng.bound(op, n).verify(payload, eng.results[rid])
    return stats, {k: v for k, v in _build.LAUNCHES.items() if v}


@pytest.mark.parametrize("ops,bits", [
    (("fft", "rfft", "polymul", "polymul-real", "polymul-mod"), None),
    (("polymul-mod",), 109)])
def test_verified_engine_serves_on_card_without_detections(cuda, rng, ops,
                                                           bits):
    """``ServeEngine(verified=True)`` at n = 4096: every batch is checked
    on the host after its kernel and host step, no check fails on the
    card's fp32 (or exact) results, every result equals its oracle, and
    each route kernel launches once a batch."""
    eng = engine.ServeEngine(max_batch=8, verified=True, modulus_bits=bits,
                             device="cuda")
    stats, launches = _serve_all(eng, ops, 4096, rng, 8 * len(ops))
    want = {}
    for b in stats["buckets"].values():
        integ = b["integrity"]
        assert integ["checked"] == b["batches"] >= 1
        assert integ["corrupted"] == integ["retried"] == 0
        assert integ["fell_back"] == 0 and not integ["breaker_open"]
        want[ROUTE_COUNTERS[b["route"]]] = b["batches"]
    assert launches == want


def test_chaos_engine_on_card_every_result_equals_its_oracle(cuda, rng):
    """Permanent faults on every array: each bucket detects, retries,
    trips its breaker and re-runs clean; every delivered result equals
    its oracle, and the route kernels launch once per execution (batches
    + retries + fallback re-runs)."""
    from repro_torch.core.pim import FaultModel
    fm = FaultModel(seed=3, stuck_per_array=1, bitflip_per_gate=1e-6,
                    n_arrays=4, spares=4)
    eng = engine.ServeEngine(max_batch=8, verified=True, fault_model=fm,
                             device="cuda")
    ops = ("fft", "polymul-real", "polymul-mod")
    stats, launches = _serve_all(eng, ops, 4096, rng, 48)
    want = {}
    for b in stats["buckets"].values():
        integ = b["integrity"]
        assert integ["corrupted"] >= 1 and integ["retried"] >= 1
        assert integ["fell_back"] == 1 and integ["breaker_open"]
        want[ROUTE_COUNTERS[b["route"]]] = (b["batches"] + integ["retried"]
                                            + integ["fell_back"])
    assert launches == want
    assert len(fm.quarantined) == len(ops)


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_kernels_read_transposed_views_as_rows(cuda, rng, inverse):
    """A (rows, m) view of a transpose (what a reshape that merges a
    size-1 batch gives) reaches the kernels as rows: ``ntt_batched`` and
    ``ntt_polymul`` on such a view equal their plain versions on the
    contiguous copy. The four-step NTT's first transform at batch 1 is
    this case."""
    m = 8
    p = tntt.NTTParams.make(m)
    x = torch.from_numpy(rng.integers(0, p.q, (1, m, 1024)).astype(
        np.int32)).to(cuda).swapaxes(-1, -2).reshape(-1, m)
    assert not x.is_contiguous()
    want = tknt.ntt_batched_plain(x.contiguous(), p, inverse=inverse)
    assert torch.equal(tknt.ntt_batched(x, p, inverse=inverse), want)
    y = x.flip(0)
    assert torch.equal(tknt.ntt_polymul(x, y, p),
                       tknt.ntt_polymul_plain(x.contiguous(),
                                              y.contiguous(), p))


@pytest.mark.parametrize("batch", [1, 3, 16])
@pytest.mark.parametrize("shards", [2, 8])
def test_distributed_routes_on_card_equal_the_local_routes(cuda, rng, batch,
                                                           shards):
    """The distributed routes at every batch shape the engine dispatches
    (1, odd, full): ``polymul-mod-distributed`` == the local kernel,
    ``polymul-real-distributed`` within the op's tolerance of the local
    route, every result equal to its oracle."""
    from repro_torch.launch import ops as op_registry
    n = 65536
    for op in ("polymul-mod", "polymul-real"):
        spec = op_registry.get_op(op)
        dist = spec.bind(n, op_registry.OpContext(model_shards=shards),
                         batch=batch, device="cuda")
        local = spec.bind(n, batch=batch, device="cuda")
        assert dist.route == f"{op}-distributed"
        payloads = [dist.random_payload(rng) for _ in range(batch)]
        got = dist.to_numpy(dist.execute(payloads))
        want = local.to_numpy(local.execute(payloads))
        for payload, row in zip(payloads, got):
            dist.verify(payload, row)
        if op == "polymul-mod":
            assert (got == want).all()
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-3 * np.abs(want).max())


def test_kernel_wrappers_refuse_gradients_they_would_drop(cuda):
    """A bare wrapper call under grad mode with an input that requires grad
    raises on the card (a launch has no backward); under ``no_grad`` it
    runs, and the differentiable routes (``fft_causal_conv``,
    ``blockwise_attention``) give every input its gradient."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import attention as layer_attn
    g = torch.Generator(device=cuda).manual_seed(0)

    def leaf(*shape):
        return torch.randn(*shape, device=cuda, generator=g
                           ).requires_grad_()

    x, z = leaf(4, 64), torch.zeros(4, 64, device=cuda)
    z32 = torch.zeros(4, 32, device=cuda)
    q, k, v = leaf(1, 64, 2, 64), leaf(1, 64, 2, 64), leaf(1, 64, 2, 64)
    bare = [lambda: tfft.fft_planes(x, z),
            lambda: tfft.rfft_planes(x),
            lambda: tfft.irfft_planes(x[:, :32].contiguous(), z32),
            lambda: tpoly.polymul_complex_planes(x, z, z, z),
            lambda: tpoly.polymul_real_planes(x, z),
            lambda: tattn.attention(q, k, v, window=1 << 30, scale=1.0),
            lambda: tattn.flash_attention(q[0].transpose(0, 1),
                                          k[0].transpose(0, 1),
                                          v[0].transpose(0, 1))]
    for call in bare:
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
        with torch.no_grad():
            call()
    xs, ks = leaf(2, 8, 100), leaf(1, 8, 16)
    before = _build.LAUNCHES["fft_planes"]
    ops.fft_causal_conv(xs, ks, radix=4).square().sum().backward()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fft_planes"] == before + 6
    out = layer_attn.blockwise_attention(q, k, v, window=1 << 30)
    out.square().sum().backward()
    for t in (xs, ks, q, k, v):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())


def test_training_step_on_card_matches_cpu(cuda):
    """One ``lm.value_and_grad`` of the reduced fourierpim-lm config on the
    card (its convolution's forward, recomputation and backward on the
    kernel: 9 launches a layer) against the CPU: the loss rtol 1e-4, each
    leaf's gradient within 1e-4 of its largest magnitude (a sound fp32
    step reads about 2e-6; one with TF32 matmuls falls outside)."""
    cfg = get_config("fourierpim-lm").scaled_down()
    params = convert.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32))
                                 .astype(np.int32)) for k in ("tokens",
                                                             "labels")}
    model = lm.DecoderLM(cfg, device="meta")
    want_loss, want = lm.value_and_grad(model, params, batch)
    before = _build.LAUNCHES["fft_planes"]
    loss, grads = lm.value_and_grad(
        model, {k: v.to(cuda) for k, v in params.items()},
        {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fft_planes"] == before + 9 * cfg.num_layers
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    for name, g in grads.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.cpu().numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))


@pytest.mark.parametrize("arch,kernel,per_layer", [
    ("fourierpim-lm", "fft_planes", 9),
    ("qwen3-1.7b", "flash_attention_tf32", 2)])
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_training_step_on_card_matches_cpu(cuda, arch, kernel,
                                                   per_layer, shards):
    """One training step of the reduced config split over ``shards`` model
    shards on the card (``models/sharded.py``; every shard on the card)
    against the same split step on the CPU: the loss rtol 1e-4, each
    leaf's gradient within 1e-4 of its largest magnitude; each shard
    launches its own kernel, ``per_layer`` times a layer."""
    from repro_torch.dist import sharding
    from repro_torch.models import sharded
    cfg = get_config(arch).scaled_down()
    params = convert.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32))
                                 .astype(np.int32)) for k in ("tokens",
                                                             "labels")}

    def run(device):
        mesh = sharding.make_mesh((1, shards), ("data", "model"),
                                  device=device)
        sh = sharded.Shards(cfg, mesh, {k: v.to(device)
                                        for k, v in params.items()})
        return sharded.value_and_grad(sh, {k: v.to(device)
                                           for k, v in batch.items()})

    want_loss, want = run("cpu")
    before = _build.LAUNCHES[kernel]
    loss, grads = run("cuda")
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kernel] == \
        before + shards * per_layer * cfg.num_layers
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    for name, g in grads.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.cpu().numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))
