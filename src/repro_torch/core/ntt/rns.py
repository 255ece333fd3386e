"""RNS (residue number system) layer over the single-word NTT (port of
``repro.core.ntt.rns``: a numpy copy, pinned equal to the original by
``tests/test_torch_ntt_ref.py``).

Real FHE moduli are 100+ bits, but the exact NTT tier is single-word: every
limb modulus q < 2^31 so a residue fits one 32-bit word. This module
composes the two: a target modulus Q (a bit budget or an explicit product of
scheme moduli) is covered by k pairwise-coprime 30-bit NTT-friendly limb
primes, polynomial products run per limb (``rns_polymul``: all k limbs in
one launch of ``repro_torch.kernels.ntt.rns_ntt_polymul``), and the Chinese
Remainder Theorem reconstructs the exact integer result, which reduces
mod Q.

Correctness bound: a negacyclic coefficient of a·b with |a_i|, |b_i| < Q is
an alternating sum of at most n products, so its magnitude is < n·Q². The
limb set is chosen with M = prod q_i > 2·n·Q², which makes the centered CRT
lift exact; reducing that integer mod Q is then the true ring product in
Z_Q[x]/(x^n ± 1).

Two reconstruction paths, both from the same Garner mixed-radix digits
(digit arithmetic is entirely mod q_i < 2^30, so it vectorizes in uint64):

  * ``crt_reconstruct``      — python-int / object-dtype assembly, any k.
  * ``crt_reconstruct_u64``  — vectorized uint64 assembly, valid when
    M < 2^64 (k <= 2 thirty-bit limbs).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.ntt.ref import (NTTParams, cyclic_polymul, is_prime,
                                negacyclic_polymul)

__all__ = [
    "RNSParams", "crt_reconstruct", "crt_reconstruct_u64", "crt_to_modulus",
    "garner_digits", "ntt_limb_primes", "random_poly", "rns_polymul",
    "rns_polymul_reference", "schoolbook_polymul_mod", "to_rns",
]


def ntt_limb_primes(n: int, bits: int = 30) -> Iterator[int]:
    """Descending primes q < 2^bits with q ≡ 1 (mod 2n): every yield is a
    valid single-word NTT modulus for length-n negacyclic transforms."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"n={n} must be a power of two")
    step = 2 * n
    q = ((1 << bits) - 2) // step * step + 1
    while q > step:
        if is_prime(q):
            yield q
        q -= step


@dataclasses.dataclass(frozen=True)
class RNSParams:
    """k coprime limb moduli covering a target modulus Q; hashable so the
    kernel layer can cache its tables on it."""
    n: int
    modulus: int                       # Q: the ring modulus results reduce to
    limbs: tuple[NTTParams, ...]       # per-limb single-word NTT parameters

    @classmethod
    def make(cls, n: int, *, modulus: int | None = None,
             modulus_bits: int | None = None, bits: int = 30) -> "RNSParams":
        """Cover ``modulus`` (or a ``modulus_bits``-bit product of scheme
        primes) with enough limb primes that M > 2·n·Q² — the exact-centered-
        lift bound for negacyclic products of inputs in [0, Q)."""
        if (modulus is None) == (modulus_bits is None):
            raise ValueError("pass exactly one of modulus / modulus_bits")
        if modulus is None:
            if modulus_bits < 2:
                raise ValueError(f"modulus_bits={modulus_bits} too small")
            # Scheme-style Q: a product of NTT-friendly primes (what an RLWE
            # modulus chain looks like), >= the requested bit budget.
            q_prod = 1
            for p in ntt_limb_primes(n, bits):
                q_prod *= p
                if q_prod.bit_length() >= modulus_bits:
                    break
            modulus = q_prod
        if modulus < 2:
            raise ValueError(f"modulus={modulus} must be >= 2")
        bound = 2 * n * modulus * modulus
        limbs: list[int] = []
        m_prod = 1
        for p in ntt_limb_primes(n, bits):
            limbs.append(p)
            m_prod *= p
            if m_prod > bound:
                break
        if m_prod <= bound:
            raise ValueError(
                f"not enough {bits}-bit NTT primes for n={n}, "
                f"Q~2^{modulus.bit_length()}")
        return cls(n=n, modulus=modulus,
                   limbs=tuple(NTTParams.make(n, q=p) for p in limbs))

    @property
    def k(self) -> int:
        return len(self.limbs)

    @functools.cached_property
    def qs(self) -> tuple[int, ...]:
        return tuple(p.q for p in self.limbs)

    @functools.cached_property
    def limb_product(self) -> int:
        m = 1
        for q in self.qs:
            m *= q
        return m

    @functools.cached_property
    def garner_inv(self) -> tuple[int, ...]:
        """garner_inv[i] = (q_0 · ... · q_{i-1})^{-1} mod q_i (entry 0 unused)."""
        out = [0]
        prefix = 1
        for i in range(1, self.k):
            prefix = prefix * self.qs[i - 1] % self.limb_product
            out.append(pow(prefix % self.qs[i], -1, self.qs[i]))
        return tuple(out)


# ---------------------------------------------------------------------------
# Residue split / CRT reconstruction
# ---------------------------------------------------------------------------

def _as_int_object(x) -> np.ndarray:
    """Coerce to an object array of python ints; floats raise loudly (same
    contract as ``ref.as_residues`` — truncation would be a silent lie)."""
    a = np.asarray(x)
    if a.dtype.kind == "O":
        return a
    if a.dtype.kind not in "iu":
        raise TypeError(f"RNS needs integer input, got {a.dtype}")
    return a.astype(object)


def to_rns(x, rns: RNSParams) -> np.ndarray:
    """Split coefficients (..., n) into per-limb residues (k, ..., n) uint64.

    Negative coefficients wrap python-style per limb, so the CRT value of
    the stack is x mod M — consistent with the centered lift downstream.
    """
    a = _as_int_object(x)
    out = np.empty((rns.k,) + a.shape, np.uint64)
    for i, q in enumerate(rns.qs):
        out[i] = (a % q).astype(np.uint64)
    return out


def garner_digits(residues, rns: RNSParams) -> np.ndarray:
    """Mixed-radix (Garner) digits d with x = Σ d_i · q_0···q_{i-1}, d_i < q_i.

    Fully vectorized uint64: every intermediate is mod q_i < 2^30, so the
    Horner products stay below 2^60 — no python-int arithmetic anywhere.
    """
    res = np.asarray(residues, np.uint64)
    if res.shape[0] != rns.k:
        raise ValueError(f"expected {rns.k} limb planes, got {res.shape[0]}")
    d = np.empty_like(res)
    d[0] = res[0] % np.uint64(rns.qs[0])
    for i in range(1, rns.k):
        qi = np.uint64(rns.qs[i])
        # acc = (d_0 + d_1 q_0 + ... + d_{i-1} q_0..q_{i-2}) mod q_i, Horner
        # from the top digit down.
        acc = d[i - 1] % qi
        for j in range(i - 2, -1, -1):
            acc = (acc * np.uint64(rns.qs[j] % rns.qs[i]) + d[j]) % qi
        inv = np.uint64(rns.garner_inv[i])
        d[i] = (res[i] % qi + qi - acc) % qi * inv % qi
    return d


def crt_reconstruct(residues, rns: RNSParams) -> np.ndarray:
    """Exact CRT value in [0, M) as an object array of python ints — the
    oracle path, valid for any limb count."""
    digits = garner_digits(residues, rns)
    val = np.zeros(digits.shape[1:], object)
    weight = 1
    for i in range(rns.k):
        val = val + digits[i].astype(object) * weight
        weight *= rns.qs[i]
    return val


def crt_reconstruct_u64(residues, rns: RNSParams) -> np.ndarray:
    """Vectorized uint64 CRT value in [0, M); requires M < 2^64 (k <= 2
    thirty-bit limbs) — every partial sum is then < M and exact."""
    if rns.limb_product >> 64:
        raise ValueError(
            f"limb product is {rns.limb_product.bit_length()} bits; the "
            f"uint64 path needs M < 2^64 (use crt_reconstruct)")
    digits = garner_digits(residues, rns)
    val = np.zeros(digits.shape[1:], np.uint64)
    weight = np.uint64(1)
    for i in range(rns.k):
        val = val + digits[i] * weight
        weight = weight * np.uint64(rns.qs[i])
    return val


def crt_to_modulus(residues, rns: RNSParams) -> np.ndarray:
    """Centered CRT lift reduced into [0, Q): the exact ring coefficient.

    The lift maps [0, M) onto (-M/2, M/2]; with M > 2·n·Q² that interval
    contains the true (possibly negative) convolution coefficient, so the
    final ``% Q`` is exact integer arithmetic, not a modeling choice.
    """
    raw = crt_reconstruct(residues, rns)
    half = rns.limb_product // 2
    centered = np.where(raw > half, raw - rns.limb_product, raw)
    return centered % rns.modulus


# ---------------------------------------------------------------------------
# Polynomial products mod Q
# ---------------------------------------------------------------------------

def schoolbook_polymul_mod(a, b, modulus: int, *,
                           negacyclic: bool = True) -> np.ndarray:
    """O(n²) product mod (x^n ± 1, Q) in pure python big-int arithmetic —
    the independent oracle for the whole RNS stack (no CRT, no transforms)."""
    av = [int(v) % modulus for v in np.asarray(a, object).ravel()]
    bv = [int(v) % modulus for v in np.asarray(b, object).ravel()]
    n = len(av)
    if len(bv) != n:
        raise ValueError(f"length mismatch: {n} vs {len(bv)}")
    out = [0] * n
    for i in range(n):
        if not av[i]:
            continue
        for j in range(n):
            k = i + j
            t = av[i] * bv[j]
            if k < n:
                out[k] += t
            elif negacyclic:
                out[k - n] -= t
            else:
                out[k - n] += t
    return np.array([v % modulus for v in out], object)


def rns_polymul_reference(a, b, rns: RNSParams, *,
                          negacyclic: bool = True) -> np.ndarray:
    """Limb-parallel product through the numpy NTT reference + CRT: the
    mid-level differential point between the big-int schoolbook oracle and
    the fused kernel."""
    ar = to_rns(a, rns)
    br = to_rns(b, rns)
    fn = negacyclic_polymul if negacyclic else cyclic_polymul
    prods = np.stack([fn(ar[i], br[i], p)
                      for i, p in enumerate(rns.limbs)])
    return crt_to_modulus(prods, rns)


def rns_polymul(a, b, rns: RNSParams, *, negacyclic: bool = True,
                block_b: int | None = None,
                device: str | torch.device = "cuda") -> np.ndarray:
    """Exact product mod (x^n ± 1, Q) through the fused kernel: one launch
    for all k limbs (``kernels.ntt.rns_ntt_polymul``) on ``device``, then
    CRT on the host.

    Accepts (n,) or (B, n) coefficient arrays (ints or object-dtype big
    ints); returns the same shape as object-dtype residues in [0, Q).
    """
    # deferred: kernels.ntt imports core.ntt.ref, so core -> kernels here
    from repro_torch.kernels.ntt import residues_to_numpy, rns_ntt_polymul
    a_obj = _as_int_object(a)
    b_obj = _as_int_object(b)
    if a_obj.shape != b_obj.shape or a_obj.shape[-1] != rns.n:
        raise ValueError(f"bad shapes {a_obj.shape} / {b_obj.shape} "
                         f"for n={rns.n}")
    squeeze = a_obj.ndim == 1
    if squeeze:
        a_obj, b_obj = a_obj[None], b_obj[None]
    ar, br = (torch.from_numpy(to_rns(x, rns).astype(np.uint32)).to(device)
              for x in (a_obj, b_obj))                 # residues < 2^30
    prods = rns_ntt_polymul(ar, br, rns, negacyclic=negacyclic,
                            block_b=block_b)
    out = crt_to_modulus(residues_to_numpy(prods), rns)
    return out[0] if squeeze else out


def random_poly(rng: np.random.Generator, n: int, modulus: int) -> np.ndarray:
    """Uniform-ish coefficients in [0, Q) as an object array of python ints
    (assembled from 30-bit draws so 100+ bit Q is actually exercised)."""
    chunks = (modulus.bit_length() + 29) // 30
    vals = rng.integers(0, 1 << 30, size=(chunks, n), dtype=np.int64)
    out = np.zeros(n, object)
    for c in range(chunks):
        out = (out << 30) | vals[c].astype(object)
    return out % modulus
