"""The exact product's split-pass schedule (``repro_torch.kernels.ntt``:
``ntt_two_pass_plan``, ``pass2_tables``, ``ntt_polymul_two_pass``) on the
CPU, against the single-CTA plain version, the reference's Pallas kernel
(``repro.kernels.ntt.ntt_polymul``, interpret mode, as the reference's own
tests run it) and the ported numpy reference (``core.ntt.ref``).

The mirror follows the three launches' dataflow: F1 on (B n2, n1) sub-rows
gathered at stride n2 (after the load's reduction and psi twist), M's
forward pass 2 on (B n1, n2) contiguous sub-rows with twiddles from the
global block index, the r2-hop product, the inverse's pass 1 on the same
sub-rows (the mirrored split n2 x n1) scattered at stride n1, and I2 on
(B n2, n1) contiguous sub-rows scattered at stride n2 with the untwist.
Residues are exact, so every comparison is ``==``, for every split.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.ntt import ref as jref
from repro.kernels import ntt as jntt
from repro_torch.core import fft as tcore
from repro_torch.core.ntt import ref as tref
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
