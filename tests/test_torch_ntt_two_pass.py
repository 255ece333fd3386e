"""The exact kernels' split schedules (``repro_torch.kernels.ntt``:
``ntt_two_pass_plan``, ``pass2_tables``, ``ntt_polymul_two_pass``; the RNS
product's ``rns_schedule``, ``rns_pass2_tables``,
``rns_ntt_polymul_two_pass`` and register-step ``rns_ntt_polymul_steps``;
the NTT's ``ntt_batched_two_pass_plan`` and ``ntt_batched_two_pass``) on
the CPU, against the single-CTA plain versions, the reference's Pallas
kernels (``repro.kernels.ntt``, interpret mode, as the reference's own
tests run them) and the ported numpy reference (``core.ntt.ref``).

The mirror follows the three launches' dataflow: F1 on (B n2, n1) sub-rows
gathered at stride n2 (after the load's reduction and psi twist), M's
forward pass 2 on (B n1, n2) contiguous sub-rows with twiddles from the
global block index, the r2-hop product, the inverse's pass 1 on the same
sub-rows (the mirrored split n2 x n1) scattered at stride n1, and I2 on
(B n2, n1) contiguous sub-rows scattered at stride n2 with the untwist.
The RNS product's split runs those launches once per limb (the kernels'
grid row y); its register steps run the sweeps of a whole row four at a
time on 16-residue groups (``step_sweeps``). The NTT's two passes are F1's
reader on one operand and M's forward pass 2 with the bins stored in
natural order. Residues are exact, so every comparison is ``==``, for
every split.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.ntt import ref as jref
from repro.kernels import ntt as jntt
from repro_torch.core import fft as tcore
from repro_torch.core.ntt import ref as tref
from repro_torch.core.ntt import rns as trns
from repro_torch.kernels import _build
from repro_torch.kernels import fft as tfft
from repro_torch.kernels import ntt as tntt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small int64 torch ops; one intra-op thread per xdist worker
    keeps them near their single-process time (elementwise, so the results
    do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _residues(rng, shape, q):
    return rng.integers(0, q, size=shape).astype(np.uint32)


def _split_plan(n):
    return tntt.ntt_two_pass_launch(*tfft.two_pass_split(n, 2, product=True))


@pytest.mark.parametrize("lg", range(3, 17))
@pytest.mark.parametrize("negacyclic", [True, False])
def test_mirror_equals_plain_and_numpy_reference(rng, lg, negacyclic):
    """n = 8 .. 2^16 at the planner's rule for the split, batches 1, 2 and
    5: the mirror equals ``ntt_polymul_plain`` and the numpy reference's
    product, residue for residue."""
    n = 1 << lg
    p = tref.NTTParams.make(n)
    plan = _split_plan(n)
    fn = tref.negacyclic_polymul if negacyclic else tref.cyclic_polymul
    for batch in (1, 2, 5):
        a, b = (_residues(rng, (batch, n), p.q) for _ in range(2))
        got = tntt.ntt_polymul_two_pass(_t(a), _t(b), p,
                                        negacyclic=negacyclic, plan=plan)
        assert got.dtype == torch.int32 and got.shape == (batch, n)
        assert torch.equal(got, tntt.ntt_polymul_plain(
            _t(a), _t(b), p, negacyclic=negacyclic))
        assert (tntt.residues_to_numpy(got) == fn(a, b, p)).all()


@pytest.mark.parametrize("lg", range(3, 17))
def test_mirror_equals_pallas_kernel(rng, lg):
    """Against the reference kernel in interpret mode, n = 8 .. 2^16, the
    batch (1, 2, 5) and the product (negacyclic at even log2 n, cyclic at
    odd) varying with n, so each n costs one interpret-mode compile; the
    words include values >= q, which the load reduces."""
    n = 1 << lg
    p, pj = tref.NTTParams.make(n), jref.NTTParams.make(n)
    batch, negacyclic = (1, 2, 5)[lg % 3], lg % 2 == 0
    a = _residues(rng, (batch, n), p.q) + np.uint32(p.q)
    b = _residues(rng, (batch, n), p.q)
    got = tntt.ntt_polymul_two_pass(_t(a), _t(b), p, negacyclic=negacyclic,
                                    plan=_split_plan(n))
    want = jntt.ntt_polymul(jnp.asarray(a), jnp.asarray(b), pj,
                            negacyclic=negacyclic)
    assert (tntt.residues_to_numpy(got) == np.asarray(want)).all()


@pytest.mark.parametrize("n", [16, 4096])
def test_any_split_is_exact(rng, n):
    """Every split n1 = 2 .. n/2 (radix 2 puts each on the sweep sequence)
    gives the same residues, for both products."""
    p = tref.NTTParams.make(n)
    a, b = (_t(_residues(rng, (2, n), p.q)) for _ in range(2))
    for negacyclic in (True, False):
        want = tntt.ntt_polymul_plain(a, b, p, negacyclic=negacyclic)
        n1 = 2
        while n1 < n:
            plan = tntt.ntt_two_pass_launch(n1, n // n1)
            assert torch.equal(tntt.ntt_polymul_two_pass(
                a, b, p, negacyclic=negacyclic, plan=plan), want), n1
            n1 *= 2


def test_plan_examples_and_threshold():
    assert tntt.ntt_two_pass_plan(65536) == tntt.NTTTwoPass(256, 256, 8,
                                                            16, 16)
    assert tntt.ntt_two_pass_plan(1 << 19) == tntt.NTTTwoPass(512, 1024, 4,
                                                              4, 8)
    assert tntt.ntt_two_pass_plan(1 << 25) == tntt.NTTTwoPass(8192, 4096, 1,
                                                              1, 1)
    assert tntt.ntt_two_pass_plan(1 << 26) is None     # no split fits
    low = tfft.TWO_PASS_FROM["ntt_polymul"]
    assert tntt.ntt_two_pass_plan(low // 2) is None
    assert tntt.ntt_two_pass_plan(low) is not None
    assert tntt.ntt_two_pass_plan(low).launches == 3


@pytest.mark.parametrize("lg", range(2, 26))
def test_split_fits_shared_memory(lg):
    """Each launch's CTA fits the 227 KB a CTA may hold: F1 2 c1
    sub-problems of n1 words, M two buffers of 2 cm of n2 words, I2 ci of
    n1 words, one or two buffers at row stride m + 1; every count is a
    power of two within the sub-problems a row has, and a CTA holds at
    most ``TWO_PASS_CTA_POINTS`` points (M twice that, as many of each
    operand as I2 holds of its one) unless one sub-problem is longer."""
    n = 1 << lg
    plan = tntt.ntt_two_pass_launch(*tfft.two_pass_split(n, 2, product=True))
    assert plan.n1 * plan.n2 == n
    cap = tfft.TWO_PASS_CTA_POINTS
    for held, m, avail, most in (
            (2 * plan.c1, plan.n1, 2 * plan.n2, cap),
            (2 * plan.cm, plan.n2, 2 * plan.n1, 2 * cap),
            (plan.ci, plan.n1, plan.n2, cap)):
        assert 2 * 4 * held * (m + 1) <= tfft.SMEM_MAX_BYTES
        assert held <= avail and held & (held - 1) == 0
        assert held * m <= max(most, 2 * m)


@pytest.mark.parametrize("n", [64, 4096, 65536])
@pytest.mark.parametrize("negacyclic", [True, False])
def test_pass2_tables_are_the_sweeps_own(n, negacyclic):
    """The pass-2 tables the kernels read: entry n1 (L - 1) + l n1 + l0 of
    the forward table's sweep at local L holds w[(l0 + n1 l) n2 / 2L] of
    the master table, and the inverse's the same of the inverse table with
    n1 and n2 swapped (the csrc/ntt.cu NttTw2 index arithmetic)."""
    p = tref.NTTParams.make(n)
    n1, n2 = tfft.two_pass_split(n, 2, product=True)
    cpu = torch.device("cpu")
    wf, wi = tntt.polymul_tables(p, negacyclic, cpu)[:2]
    tw2f, tw2i = tntt.pass2_tables(p, negacyclic, n1, cpu)
    for table, w, a, b in ((tw2f, wf, n1, n2), (tw2i, wi, n2, n1)):
        assert table.shape == (a * (b - 1),)
        L = 1
        while L < b:
            for l in range(L):
                entry = a * (L - 1) + l * a
                want = (np.arange(a) + a * l) * (b // (2 * L))
                assert torch.equal(table[entry:entry + a], w[want])
            L *= 2


def test_cpu_wrapper_runs_the_mirror_and_launches_nothing(rng):
    """From the threshold on the CPU wrapper runs the mirror (the plain
    version's residues) and launches no kernel."""
    _build.reset_launches()
    for n in (tfft.TWO_PASS_FROM["ntt_polymul"], 65536):
        p = tref.NTTParams.make(n)
        assert tcore.plan(n, 3, exact=True).two_pass is not None
        a, b = (_t(_residues(rng, (3, n), p.q)) for _ in range(2))
        for negacyclic in (True, False):
            assert torch.equal(
                tntt.ntt_polymul(a, b, p, negacyclic=negacyclic),
                tntt.ntt_polymul_plain(a, b, p, negacyclic=negacyclic))
    assert set(_build.LAUNCHES.values()) == {0}


# ---------------------------------------------------------------------------
# The RNS product's schedules
# ---------------------------------------------------------------------------

def _rns_words(rng, r, batch, *, above_q=False):
    """(k, batch, n) uint32 words of each limb, in [q, 2q) if
    ``above_q``."""
    x = np.stack([rng.integers(0, q, (batch, r.n)) for q in r.qs])
    if above_q:
        x = x + np.array(r.qs)[:, None, None]
    return x.astype(np.uint32)


@pytest.mark.parametrize("n", [16, 4096])
@pytest.mark.parametrize("kw", [{"modulus_bits": 109}, {"modulus": 17}])
def test_rns_mirror_any_split_equals_plain(rng, n, kw):
    """Every split n1 = 2 .. n/2 of the RNS product's split-pass mirror,
    at k = 9 and k = 1, both products: the plain version's residues."""
    r = trns.RNSParams.make(n, **kw)
    a, b = (_t(_rns_words(rng, r, 2, above_q=i == 0)) for i in range(2))
    for negacyclic in (True, False):
        want = tntt.rns_ntt_polymul_plain(a, b, r, negacyclic=negacyclic)
        n1 = 2
        while n1 < n:
            plan = tntt.ntt_two_pass_launch(n1, n // n1)
            assert torch.equal(tntt.rns_ntt_polymul_two_pass(
                a, b, r, negacyclic=negacyclic, plan=plan), want), n1
            n1 *= 2


@pytest.mark.parametrize("lg", range(1, 14))
def test_register_steps_equal_sweeps(rng, lg):
    """``step_sweeps`` (the register-step kernel's order: steps of up to
    four sweeps on 16-residue groups) equals ``ntt_stages`` sweep for
    sweep, forward and inverse table, and the RNS product's register-step
    mirror equals the plain version (k = 3, both products)."""
    n = 1 << lg
    r = trns.RNSParams.make(n, modulus_bits=40)
    scal, wf, wi = tntt.rns_tables(r, True, torch.device("cpu"))[:3]
    scal = scal.to(torch.int64) & 0xFFFFFFFF
    q, qinv = (scal[:, i].view(-1, 1, 1) for i in range(2))
    x = _t(_rns_words(rng, r, 2)).view(torch.int32).to(torch.int64)
    for w in (wf, wi):
        w = w.to(torch.int64)
        assert torch.equal(tntt.step_sweeps(x, w, q, qinv),
                           tntt.ntt_stages(x, w, q, qinv))
    a, b = (_t(_rns_words(rng, r, 3, above_q=i == 0)) for i in range(2))
    for negacyclic in (True, False):
        assert torch.equal(
            tntt.rns_ntt_polymul_steps(a, b, r, negacyclic=negacyclic),
            tntt.rns_ntt_polymul_plain(a, b, r, negacyclic=negacyclic))


@pytest.mark.parametrize("n", [64, 4096])
@pytest.mark.parametrize("negacyclic", [True, False])
def test_rns_pass2_tables_are_each_limbs_own(n, negacyclic):
    """Row ``limb`` of the stacked pass-2 tables holds that limb's own
    ``pass2_tables`` (forward and inverse), zero-padded to n words."""
    r = trns.RNSParams.make(n, modulus_bits=109)
    n1, n2 = tfft.two_pass_split(n, 2, product=True)
    cpu = torch.device("cpu")
    tw2f, tw2i = tntt.rns_pass2_tables(r, n1, cpu)
    assert tw2f.shape == tw2i.shape == (r.k, n)
    for i, limb in enumerate(r.limbs):
        for got, want in zip((tw2f[i], tw2i[i]),
                             tntt.pass2_tables(limb, negacyclic, n1, cpu)):
            assert torch.equal(got[:want.shape[0]], want)
            assert not got[want.shape[0]:].any()


def test_rns_schedule_examples_and_thresholds():
    """Single-CTA below ``REGISTER_STEPS_FROM``, register steps up to the
    split's threshold (while 17n bytes fit a CTA), the single-limb
    product's split from there to 2^25, single-CTA (staged) past it."""
    steps = tfft.REGISTER_STEPS_FROM["rns_ntt_polymul"]
    split = tfft.TWO_PASS_FROM["rns_ntt_polymul"]
    assert tntt.rns_schedule(steps // 2) is None
    assert steps < split
    for n in (steps, split // 2):
        assert tntt.rns_schedule(n) == tntt.RNSRegisterSteps(n)
        assert tntt.rns_schedule(n).launches == 1
    for n in (split, 65536, 1 << 25):
        assert tntt.rns_schedule(n) == tntt.ntt_two_pass_plan(n)
        assert tntt.rns_schedule(n).launches == 3
    assert tntt.rns_schedule(1 << 26) is None
    assert [tntt.schedule_name(tntt.rns_schedule(n)) for n in
            (steps // 2, steps, split)] == ["single-CTA", "register-step",
                                            "split-pass"]


@pytest.mark.parametrize("lg", range(1, 15))
def test_register_steps_fit_shared_memory(lg):
    """The register-step CTA holds two buffers of both operands' rows at
    one pad word in 16 (17n bytes from n = 16): within the 227 KB a CTA
    may hold up to 8192 points, so the schedule never plans it beyond; its
    grid is (B, k), k within the 65535 rows a grid may have."""
    n = 1 << lg
    fits = tntt.rns_steps_smem_bytes(n) <= tfft.SMEM_MAX_BYTES
    assert tntt.rns_steps_smem_bytes(n) == 16 * (n + n // 16)
    assert fits == (n <= 8192)
    if not fits:
        assert not isinstance(tntt.rns_schedule(n), tntt.RNSRegisterSteps)
    assert trns.RNSParams.make(n, modulus_bits=109).k <= 65535


# ---------------------------------------------------------------------------
# ntt_batched's two passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [16, 4096])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_batched_mirror_any_split_equals_plain(rng, n, inverse):
    """Every split n1 = 2 .. n/2 of the NTT's two-pass mirror, on words of
    any value: the plain version's residues and the numpy reference's."""
    p = tref.NTTParams.make(n)
    x = rng.integers(0, 2**32, (3, n)).astype(np.uint32)
    want = tntt.ntt_batched_plain(_t(x), p, inverse=inverse)
    assert (tntt.residues_to_numpy(want)
            == (tref.intt if inverse else tref.ntt)(x, p)).all()
    n1 = 2
    while n1 < n:
        plan = tfft.two_pass_launch(n1, n // n1)
        assert torch.equal(tntt.ntt_batched_two_pass(
            _t(x), p, inverse=inverse, plan=plan), want), n1
        n1 *= 2


@pytest.mark.parametrize("lg", range(2, 27))
def test_ntt_batched_split_fits_shared_memory_and_grid(lg):
    """Both launches of the NTT's two passes (the fft's radix-2 split,
    n1, n2 <= 8192): c sub-problems of m words in one or two buffers at
    row stride m + 1 within 227 KB, c a power of two within the
    sub-problems a row has, at most ``TWO_PASS_CTA_POINTS`` points unless
    one sub-problem is longer; at batch 64 each grid is far within 2^31 -
    1 CTAs."""
    n = 1 << lg
    plan = tntt.ntt_batched_two_pass_plan(n) or tfft.two_pass_launch(
        *tfft.two_pass_split(n, 2))
    assert plan.n1 * plan.n2 == n and plan.launches == 2
    cap = tfft.TWO_PASS_CTA_POINTS
    for held, m, avail in ((plan.c1, plan.n1, plan.n2),
                           (plan.c2, plan.n2, plan.n1)):
        assert 2 * 4 * held * (m + 1) <= tfft.SMEM_MAX_BYTES
        assert held <= avail and held & (held - 1) == 0
        assert held * m <= max(cap, m)
        assert 64 * (avail // held) < 2**31


def test_ntt_batched_plan_threshold():
    low = tfft.TWO_PASS_FROM["ntt_batched"]
    assert tntt.ntt_batched_two_pass_plan(low // 2) is None
    assert tntt.ntt_batched_two_pass_plan(low) == tfft.two_pass_launch(
        *tfft.two_pass_split(low, 2))
    assert tntt.ntt_batched_two_pass_plan(65536) == tfft.TwoPass(256, 256,
                                                                 16, 16)
    assert tntt.ntt_batched_two_pass_plan(1 << 27) is None
    assert tntt.schedule_name(tntt.ntt_batched_two_pass_plan(low)) == \
        "two-pass"


def test_cpu_rns_and_ntt_wrappers_run_the_planned_mirror(rng):
    """On the CPU the RNS wrapper runs the mirror of its planned schedule
    (register steps, split) and ``ntt_batched`` its two-pass mirror from
    the threshold on, each the plain version's residues, launching
    nothing."""
    _build.reset_launches()
    steps = tfft.REGISTER_STEPS_FROM["rns_ntt_polymul"]
    for n in (steps, tfft.TWO_PASS_FROM["rns_ntt_polymul"]):
        r = trns.RNSParams.make(n, modulus_bits=40)
        assert tntt.rns_schedule(n) is not None
        a, b = (_t(_rns_words(rng, r, 2)) for _ in range(2))
        for negacyclic in (True, False):
            assert torch.equal(
                tntt.rns_ntt_polymul(a, b, r, negacyclic=negacyclic),
                tntt.rns_ntt_polymul_plain(a, b, r, negacyclic=negacyclic))
    n = tfft.TWO_PASS_FROM["ntt_batched"]
    p = tref.NTTParams.make(n)
    x = _t(_residues(rng, (3, n), p.q))
    for inverse in (False, True):
        assert torch.equal(tntt.ntt_batched(x, p, inverse=inverse),
                           tntt.ntt_batched_plain(x, p, inverse=inverse))
    assert set(_build.LAUNCHES.values()) == {0}
    assert not _build.SCHEDULES
