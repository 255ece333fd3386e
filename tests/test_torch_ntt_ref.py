"""The port's exact-tier reference (``repro_torch.core.ntt``: ``ref`` and
``rns``) against the original (``repro.core.ntt``) on the same seeded
numpy inputs.

Both are numpy code over exact integers, so every comparison is ``==``:
parameters field by field, tables and transforms element by element, CRT
values as Python ints.
"""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.core.ntt import ref as jref
from repro.core.ntt import rns as jrns
from repro_torch.core.ntt import ref as tref
from repro_torch.core.ntt import rns as trns

PARAM_CASES = [(n, bits) for n in (1, 2, 8, 64, 256, 1024, 4096, 65536)
               for bits in (20, 30, 31)]
RNS_CASES = [(64, {"modulus_bits": 40}), (64, {"modulus_bits": 100}),
             (128, {"modulus_bits": 120}), (256, {"modulus": 17}),
             (1024, {"modulus": 2**61 - 1}),
             (4096, {"modulus_bits": 109}), (65536, {"modulus_bits": 60})]


@pytest.mark.parametrize("n,bits", PARAM_CASES)
def test_ntt_params_equal_reference(n, bits):
    got = tref.NTTParams.make(n, bits=bits)
    want = jref.NTTParams.make(n, bits=bits)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for f in ("q", "w", "w_inv", "psi", "psi_inv", "n_inv", "qinv", "r2"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.qinv * got.q % 2**32 == 2**32 - 1      # -q^-1 mod 2^32


@pytest.mark.parametrize("n", [2, 64, 1024])
def test_tables_equal_reference(n):
    got, want = tref.NTTParams.make(n), jref.NTTParams.make(n)
    for base in (got.w, got.w_inv, got.psi, got.psi_inv, 1):
        pg, pw = got.powers(base), want.powers(base)
        assert pg.dtype == pw.dtype == np.uint64 and (pg == pw).all()
        assert (got.to_montgomery(pg) == want.to_montgomery(pw)).all()


@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_number_theory_equals_reference(n):
    assert tref.choose_modulus(n) == jref.choose_modulus(n)
    q = tref.choose_modulus(n)
    assert tref.is_prime(q) and not tref.is_prime(q + 1)
    assert tref.primitive_root(q) == jref.primitive_root(q)
    assert tref.root_of_unity(2 * n, q) == jref.root_of_unity(2 * n, q)
    assert (tref.bit_reverse_indices(n) == jref.bit_reverse_indices(n)).all()
    assert [tref.is_prime(v) for v in range(200)] == \
        [jref.is_prime(v) for v in range(200)]


@pytest.mark.parametrize("bad", [
    dict(n=48), dict(n=0), dict(n=1024, bits=10), dict(n=1024, q=97),
    dict(n=8, q=2**31 + 11)])
def test_param_errors_match_reference(bad):
    with pytest.raises(ValueError) as want:
        jref.NTTParams.make(**bad)
    with pytest.raises(ValueError) as got:
        tref.NTTParams.make(**bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n", [8, 256, 1024])
def test_transforms_and_products_equal_reference(rng, n):
    p, pj = tref.NTTParams.make(n), jref.NTTParams.make(n)
    a = rng.integers(0, p.q, size=(3, n)).astype(np.uint32)
    b = rng.integers(-p.q, 2 * p.q, size=(3, n)).astype(np.int64)
    for fn in ("ntt", "intt"):
        assert (getattr(tref, fn)(a, p) == getattr(jref, fn)(a, pj)).all()
        assert (getattr(tref, fn)(b, p) == getattr(jref, fn)(b, pj)).all()
    assert (tref.intt(tref.ntt(a, p), p) == a).all()
    for fn in ("cyclic_polymul", "negacyclic_polymul"):
        assert (getattr(tref, fn)(a, b, p) == getattr(jref, fn)(a, b, pj)
                ).all()
    assert (tref.as_residues(b, p.q) == jref.as_residues(b, p.q)).all()
    with pytest.raises(TypeError):
        tref.as_residues(np.zeros(4, np.float32), p.q)


@pytest.mark.parametrize("negacyclic", [True, False])
def test_schoolbook_equals_reference_and_transform_product(rng, negacyclic):
    n = 64
    p = tref.NTTParams.make(n)
    a = rng.integers(0, p.q, size=(2, n))
    b = rng.integers(0, p.q, size=(2, n))
    got = tref.schoolbook_polymul(a, b, p.q, negacyclic=negacyclic)
    assert (got == jref.schoolbook_polymul(a, b, p.q,
                                           negacyclic=negacyclic)).all()
    fn = tref.negacyclic_polymul if negacyclic else tref.cyclic_polymul
    assert (got == fn(a, b, p)).all()


# ---------------------------------------------------------------------------
# RNS
# ---------------------------------------------------------------------------

def _rns_pair(n, kw):
    return trns.RNSParams.make(n, **kw), jrns.RNSParams.make(n, **kw)


@pytest.mark.parametrize("n,kw", RNS_CASES)
def test_rns_params_equal_reference(n, kw):
    got, want = _rns_pair(n, kw)
    assert got.modulus == want.modulus and got.k == want.k
    assert [dataclasses.asdict(p) for p in got.limbs] == \
        [dataclasses.asdict(p) for p in want.limbs]
    assert got.qs == want.qs and got.limb_product == want.limb_product
    assert got.garner_inv == want.garner_inv
    assert got.limb_product > 2 * n * got.modulus ** 2
    if kw == {"modulus_bits": 109}:
        assert got.k == 9 and got.modulus.bit_length() >= 109


def test_rns_param_errors_match_reference():
    for kw in (dict(n=64), dict(n=64, modulus=5, modulus_bits=40),
               dict(n=64, modulus_bits=1), dict(n=64, modulus=1),
               dict(n=48, modulus_bits=40)):
        with pytest.raises(ValueError) as want:
            jrns.RNSParams.make(**kw)
        with pytest.raises(ValueError) as got:
            trns.RNSParams.make(**kw)
        assert str(got.value) == str(want.value)
    assert list(itertools.islice(trns.ntt_limb_primes(64), 5)) == \
        list(itertools.islice(jrns.ntt_limb_primes(64), 5))


@pytest.mark.parametrize("n,kw", RNS_CASES[:5])
def test_crt_layer_equals_reference(rng, n, kw):
    r, rj = _rns_pair(n, kw)
    x = np.stack([trns.random_poly(np.random.default_rng(7), n, r.modulus)
                  for _ in range(2)])
    xj = np.stack([jrns.random_poly(np.random.default_rng(7), n, r.modulus)
                   for _ in range(2)])
    assert (x == xj).all()
    x[0, 0] = -x[0, 0]                  # a negative coefficient wraps
    res = trns.to_rns(x, r)
    assert (res == jrns.to_rns(x, rj)).all()
    assert (trns.garner_digits(res, r) == jrns.garner_digits(res, rj)).all()
    assert (trns.crt_reconstruct(res, r) == jrns.crt_reconstruct(res, rj)
            ).all()
    assert (trns.crt_to_modulus(res, r) == jrns.crt_to_modulus(res, rj)
            ).all()
    assert (trns.crt_to_modulus(res, r) == x % r.modulus).all()
    if r.limb_product < 2**64:
        assert (trns.crt_reconstruct_u64(res, r)
                == jrns.crt_reconstruct_u64(res, rj)).all()
    else:
        with pytest.raises(ValueError, match="uint64 path"):
            trns.crt_reconstruct_u64(res, r)


@pytest.mark.parametrize("negacyclic", [True, False])
@pytest.mark.parametrize("bits", [40, 100])
def test_rns_products_equal_reference_and_schoolbook(rng, negacyclic, bits):
    n = 32
    r, rj = _rns_pair(n, {"modulus_bits": bits})
    a = trns.random_poly(rng, n, r.modulus)
    b = trns.random_poly(rng, n, r.modulus)
    got = trns.rns_polymul_reference(a, b, r, negacyclic=negacyclic)
    assert (got == jrns.rns_polymul_reference(a, b, rj,
                                              negacyclic=negacyclic)).all()
    want = trns.schoolbook_polymul_mod(a, b, r.modulus,
                                       negacyclic=negacyclic)
    assert (want == jrns.schoolbook_polymul_mod(
        a, b, r.modulus, negacyclic=negacyclic)).all()
    assert (got == want).all()
    assert (trns.rns_polymul(a, b, r, negacyclic=negacyclic, device="cpu")
            == want).all()
