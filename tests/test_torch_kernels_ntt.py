"""Port of the NTT kernel module (``repro_torch.kernels.ntt``) against the
reference (``repro.kernels.ntt``) on the same seeded numpy inputs.

The reference's Pallas kernels run in interpret mode on the CPU, as its own
tests run them; the port's wrappers run their plain versions, because the
tensors lie on the CPU. Residues are exact, so every comparison is ``==``:
a single wrong residue breaks an RLWE pipeline. The cases port the kernel
cases of ``tests/test_ntt.py`` and ``tests/test_rns_ntt.py`` (not the
scalar-prefetch layout case: that layout is the TPU's own).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from repro.core.ntt import ref as jref
from repro.core.ntt import rns as jrns
from repro.kernels import ntt as jntt
from repro_torch.core.ntt import ref as tref
from repro_torch.core.ntt import rns as trns
from repro_torch.kernels import _build
from repro_torch.kernels import fft as tfft
from repro_torch.kernels import ntt as tntt


def _params(n, bits=30):
    return tref.NTTParams.make(n, bits=bits), jref.NTTParams.make(n, bits=bits)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return tntt.residues_to_numpy(x)


def _residues(rng, shape, q):
    return rng.integers(0, q, size=shape).astype(np.uint32)


# ---------------------------------------------------------------------------
# Montgomery arithmetic and tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [20, 30, 31])
def test_mont_mul_equals_reference(rng, bits):
    """The int64 REDC equals the reference's 16-bit-limb uint32 REDC on
    random residues and on the edges 0, 1, q - 1."""
    p, _ = _params(1024, bits)
    edge = np.array([0, 1, p.q - 1, p.q - 2], np.uint32)
    a = np.concatenate([_residues(rng, 4096, p.q), np.repeat(edge, 4)])
    b = np.concatenate([_residues(rng, 4096, p.q), np.tile(edge, 4)])
    want = np.asarray(jntt._mont_mul(jnp.asarray(a), jnp.asarray(b), p.q,
                                     p.qinv))
    got = tntt.mont_mul(_t(a).to(torch.int64), _t(b).to(torch.int64), p.q,
                        p.qinv)
    assert (got.numpy() == want).all()
    prod = a.astype(np.uint64) * b % p.q
    assert (want == prod * pow(2**32, -1, p.q) % p.q).all()


@pytest.mark.parametrize("n", [2, 64, 1024])
@pytest.mark.parametrize("negacyclic", [True, False])
def test_tables_equal_reference(n, negacyclic):
    p, pj = _params(n)
    cpu = torch.device("cpu")
    assert (tntt.untwist_table(p, negacyclic)
            == jntt.untwist_table(pj, negacyclic)).all()
    for base in (p.w, p.w_inv, p.psi):
        want = np.asarray(jntt._master_table(pj, base))[0]
        assert (_np(tntt.master_table(p, base, cpu)) == want).all()
    r, rj = (m.RNSParams.make(n, modulus_bits=100) for m in (trns, jrns))
    got = tntt.rns_tables(r, negacyclic, cpu)
    want = jntt._rns_tables(rj, negacyclic)
    for g, w in zip(got, want):
        if negacyclic or w is not want[3]:     # cyclic twist is unused
            assert (_np(g) == w).all()


def test_block_planning_is_the_hopper_rule():
    """Two ping-pong buffers of uint32 rows: 8n bytes a transformed row,
    16n a product row, against the 48 KB block budget and the 227 KB a
    CTA may hold."""
    assert tntt.plan_ntt_block(4096) == 1
    assert tntt.plan_ntt_block(256) == 8
    assert tntt.plan_ntt_block(256, product=False) == 16
    assert tntt.plan_ntt_block(2) == 1024
    assert tntt.ntt_cta_rows(256, 5, 4) == (4, False)
    assert tntt.ntt_cta_rows(256, 3, 8) == (4, False)       # fitted
    assert tntt.ntt_cta_rows(8192, 64, 8) == (1, False)
    assert tntt.ntt_cta_rows(16384, 64, 1) == (1, True)
    assert tntt.ntt_cta_rows(16384, 64, 1, product=False) == (1, False)
    assert tntt.ntt_cta_rows(65536, 64, 1) == (1, True)
    assert [tntt.ntt_resident(n) for n in (4096, 8192, 16384)] == \
        [True, True, False]
    with pytest.raises(ValueError):
        tntt.ntt_cta_rows(256, 4, 0)


# ---------------------------------------------------------------------------
# ntt_batched (tests/test_ntt.py kernel cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 8, 256, 1024])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_batched_equals_reference_kernel(rng, n, inverse):
    p, pj = _params(n)
    x = _residues(rng, (3, n), p.q)
    got = tntt.ntt_batched(_t(x), p, inverse=inverse)
    assert got.dtype == torch.int32 and got.shape == (3, n)
    want = np.asarray(jntt.ntt_batched(jnp.asarray(x), pj, inverse=inverse))
    assert (_np(got) == want).all()
    assert (_np(got) == (tref.intt if inverse else tref.ntt)(x, p)).all()


@pytest.mark.parametrize("n", [256, 1024])
def test_ntt_roundtrip_exact(rng, n):
    p, _ = _params(n)
    x = _residues(rng, (2, n), p.q)
    back = tntt.ntt_batched(tntt.ntt_batched(_t(x), p), p, inverse=True)
    assert (_np(back) == x).all()


def test_ntt_nondivisible_batch(rng):
    """A batch that is not a multiple of the block: the port fits the block
    to the batch (the reference pads and strips)."""
    p, pj = _params(256)
    x = _residues(rng, (5, 256), p.q)
    got = tntt.ntt_batched(_t(x), p, block_b=4)
    want = np.asarray(jntt.ntt_batched(jnp.asarray(x), pj, block_b=4))
    assert (_np(got) == want).all()


@pytest.mark.parametrize("fn", ["ntt_batched", "ntt_polymul"])
def test_float_input_raises(fn):
    p, pj = _params(256)
    x = torch.zeros((2, 256), dtype=torch.float32)
    args = (x,) if fn == "ntt_batched" else (x, x)
    with pytest.raises(TypeError):
        getattr(tntt, fn)(*args, p)
    with pytest.raises(TypeError):
        jntt.ntt_batched(jnp.zeros((2, 256), jnp.float32), pj)


def test_unreduced_and_negative_input_reduce_as_reference(rng):
    """Signed coefficients wrap Python-style and uint32 words >= q reduce
    mod q, as the reference kernel does (tests/test_ntt.py)."""
    p, pj = _params(256)
    signed = rng.integers(-(p.q - 1), p.q, size=(2, 256)).astype(np.int32)
    want = np.asarray(jntt.ntt_batched(jnp.asarray(signed), pj))
    assert (_np(tntt.ntt_batched(_t(signed), p)) == want).all()
    assert (_np(tntt.ntt_batched(_t(signed.astype(np.int64)), p))
            == want).all()
    big = _residues(rng, (2, 256), p.q) + np.uint32(p.q)
    want = np.asarray(jntt.ntt_batched(jnp.asarray(big), pj))
    assert (_np(tntt.ntt_batched(_t(big), p)) == want).all()
    a = _residues(rng, (2, 256), p.q) + np.uint32(2**31)
    want = np.asarray(jntt.ntt_polymul(jnp.asarray(a), jnp.asarray(signed),
                                       pj))
    assert (_np(tntt.ntt_polymul(_t(a), _t(signed), p)) == want).all()


@settings(max_examples=8, deadline=None)
@given(n=st.sampled_from([64, 256]), seed=st.integers(0, 2**31 - 1))
def test_ntt_batched_equals_reference_property(n, seed):
    p, _ = _params(n)
    x = _residues(np.random.default_rng(seed), (2, n), p.q)
    assert (_np(tntt.ntt_batched(_t(x), p)) == tref.ntt(x, p)).all()


# ---------------------------------------------------------------------------
# ntt_polymul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 64, 256, 1024])
@pytest.mark.parametrize("negacyclic", [True, False])
@pytest.mark.parametrize("batch", [1, 3])
def test_ntt_polymul_equals_reference_kernel(rng, n, negacyclic, batch):
    p, pj = _params(n)
    a = _residues(rng, (batch, n), p.q)
    b = _residues(rng, (batch, n), p.q)
    got = tntt.ntt_polymul(_t(a), _t(b), p, negacyclic=negacyclic)
    want = np.asarray(jntt.ntt_polymul(jnp.asarray(a), jnp.asarray(b), pj,
                                       negacyclic=negacyclic))
    assert (_np(got) == want).all()
    fn = tref.negacyclic_polymul if negacyclic else tref.cyclic_polymul
    assert (_np(got) == fn(a, b, p)).all()


def test_ntt_polymul_equals_schoolbook(rng):
    """End to end against the O(n^2) oracle: no transform code shared."""
    p, _ = _params(256)
    a = _residues(rng, (2, 256), p.q)
    b = _residues(rng, (2, 256), p.q)
    want = tref.schoolbook_polymul(a, b, p.q, negacyclic=True)
    assert (_np(tntt.ntt_polymul(_t(a), _t(b), p)) == want).all()


def test_wrapper_shape_and_device_checks():
    p, _ = _params(64)
    x = torch.zeros((2, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="expected shape"):
        tntt.ntt_batched(torch.zeros((2, 32), dtype=torch.int32), p)
    with pytest.raises(ValueError, match="expected shape"):
        tntt.ntt_polymul(x, torch.zeros((3, 64), dtype=torch.int32), p)
    # the meta device (the dry-run's): a meta result of the input's shape
    out = tntt.ntt_batched(x.to("meta"), p)
    assert out.device.type == "meta" and out.shape == x.shape


# ---------------------------------------------------------------------------
# rns_ntt_polymul (tests/test_rns_ntt.py kernel cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,kw", [(256, {"modulus": 17}),
                                  (64, {"modulus_bits": 100}),
                                  (128, {"modulus_bits": 109})])
@pytest.mark.parametrize("negacyclic", [True, False])
def test_rns_kernel_equals_reference_kernel(rng, n, kw, negacyclic):
    r, rj = (m.RNSParams.make(n, **kw) for m in (trns, jrns))
    a = np.stack([trns.random_poly(rng, n, r.modulus) for _ in range(3)])
    b = np.stack([trns.random_poly(rng, n, r.modulus) for _ in range(3)])
    ar = trns.to_rns(a, r).astype(np.uint32)
    br = trns.to_rns(b, r).astype(np.uint32)
    got = tntt.rns_ntt_polymul(_t(ar), _t(br), r, negacyclic=negacyclic)
    assert got.dtype == torch.int32 and got.shape == (r.k, 3, n)
    want = np.asarray(jntt.rns_ntt_polymul(ar, br, rj,
                                           negacyclic=negacyclic))
    assert (_np(got) == want).all()


def _rns_schedule_run(name, ar, br, r, negacyclic):
    """The plain mirror of the RNS schedule ``name`` on the CPU: the
    register steps, or the split-pass launches at the planner's split."""
    if name == "register-step":
        return tntt.rns_ntt_polymul_steps(ar, br, r, negacyclic=negacyclic)
    plan = tntt.ntt_two_pass_launch(*tfft.two_pass_split(r.n, 2,
                                                         product=True))
    return tntt.rns_ntt_polymul_two_pass(ar, br, r, negacyclic=negacyclic,
                                         plan=plan)


@pytest.mark.parametrize("n,kw", [(16, {"modulus": 17}),
                                  (64, {"modulus_bits": 100}),
                                  (256, {"modulus_bits": 109})])
@pytest.mark.parametrize("negacyclic", [True, False])
@pytest.mark.parametrize("schedule", ["register-step", "split-pass"])
def test_rns_schedules_equal_reference_kernel(rng, n, kw, negacyclic,
                                              schedule):
    """The mirrors of the RNS product's register-step and split-pass
    schedules against the reference kernel (interpret mode), k = 1 and
    k >= 3, on words in [q, 2q) of each limb in the first operand (the
    port's load reduces them; the reference's transforms keep them
    congruent, and the final REDC makes the residues canonical)."""
    r, rj = (m.RNSParams.make(n, **kw) for m in (trns, jrns))
    assert (r.k == 1) == ("modulus" in kw)
    ar = trns.to_rns(np.stack([trns.random_poly(rng, n, r.modulus)
                               for _ in range(3)]), r).astype(np.uint32)
    ar = ar + np.array(r.qs, np.uint32)[:, None, None]
    br = trns.to_rns(np.stack([trns.random_poly(rng, n, r.modulus)
                               for _ in range(3)]), r).astype(np.uint32)
    got = _rns_schedule_run(schedule, _t(ar), _t(br), r, negacyclic)
    want = np.asarray(jntt.rns_ntt_polymul(ar, br, rj,
                                           negacyclic=negacyclic))
    assert (_np(got) == want).all()
    assert torch.equal(got, tntt.rns_ntt_polymul_plain(
        _t(ar), _t(br), r, negacyclic=negacyclic))


@pytest.mark.parametrize("n", [16, 256, 4096])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_batched_two_pass_equals_reference_kernel(rng, n, inverse):
    """The NTT's two-pass mirror (the planner's split) against the
    reference kernel in interpret mode, on words in [q, 2q)."""
    p, pj = _params(n)
    x = _residues(rng, (3, n), p.q) + np.uint32(p.q)
    plan = tfft.two_pass_launch(*tfft.two_pass_split(n, 2))
    got = tntt.ntt_batched_two_pass(_t(x), p, inverse=inverse, plan=plan)
    want = np.asarray(jntt.ntt_batched(jnp.asarray(x), pj, inverse=inverse))
    assert (_np(got) == want).all()


def test_rns_batched_and_shapes_against_schoolbook(rng):
    """(B, n) batches through one launch; the 1-D shape is kept."""
    n, bsz = 128, 3
    r = trns.RNSParams.make(n, modulus_bits=100)
    a = np.stack([trns.random_poly(rng, n, r.modulus) for _ in range(bsz)])
    b = np.stack([trns.random_poly(rng, n, r.modulus) for _ in range(bsz)])
    got = trns.rns_polymul(a, b, r, device="cpu")
    assert got.shape == (bsz, n)
    for i in range(bsz):
        want = trns.schoolbook_polymul_mod(a[i], b[i], r.modulus)
        assert (got[i] == want).all()
    one = trns.rns_polymul(a[0], b[0], r, device="cpu")
    assert one.shape == (n,) and (one == got[0]).all()


def test_rns_single_limb_degenerates_to_ntt_polymul(rng):
    n = 256
    r = trns.RNSParams.make(n, modulus=17)
    assert r.k == 1
    p = r.limbs[0]
    a = _residues(rng, (2, n), p.q)
    b = _residues(rng, (2, n), p.q)
    via_rns = tntt.rns_ntt_polymul(_t(a[None]), _t(b[None]), r)[0]
    assert torch.equal(via_rns, tntt.ntt_polymul(_t(a), _t(b), p))


def test_rns_input_checks():
    r = trns.RNSParams.make(64, modulus_bits=100)
    good = torch.zeros((r.k, 2, 64), dtype=torch.uint32)
    with pytest.raises(TypeError, match="uint32"):
        tntt.rns_ntt_polymul(good.view(torch.int32), good, r)
    with pytest.raises(ValueError, match="expected shape"):
        tntt.rns_ntt_polymul(good[:1], good[:1], r)
    with pytest.raises(ValueError, match=r"\(k, B, n\)"):
        tntt.rns_ntt_polymul(good[0], good[0], r)


def test_cpu_wrappers_launch_no_kernel(rng):
    _build.reset_launches()
    p, _ = _params(64)
    x = _t(_residues(rng, (2, 64), p.q))
    tntt.ntt_batched(x, p)
    tntt.ntt_polymul(x, x, p)
    r = trns.RNSParams.make(64, modulus_bits=40)
    res = _t(trns.to_rns(np.zeros((2, 64), np.int64), r).astype(np.uint32))
    tntt.rns_ntt_polymul(res, res, r)
    assert set(_build.LAUNCHES.values()) == {0}
