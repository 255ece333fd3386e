"""Exact number-theoretic transform (NTT) reference over a prime modulus
(port of ``repro.core.ntt.ref``: a numpy copy, pinned equal to the original
by ``tests/test_torch_ntt_ref.py``).

Crypto polymul must be exact: RLWE/FHE needs negacyclic products mod q,
which the float FFT path cannot deliver. This module is the bit-exact
oracle that the port's NTT kernels (``repro_torch/kernels/ntt.py``) are
tested against.

Math conventions:

  * q is an NTT-friendly prime, q ≡ 1 (mod 2n), q < 2^31 so a residue fits
    one 32-bit word and 32x32-bit products fit uint64 exactly;
  * w = g^((q-1)/n) is a primitive n-th root of unity: the CYCLIC transform
    X[k] = sum_j x[j] w^{jk} diagonalizes multiplication mod x^n - 1;
  * psi = g^((q-1)/2n) with psi^2 = w twists the input (x[j] -> psi^j x[j])
    so the same cyclic transform computes the NEGACYCLIC product
    mod x^n + 1 — the RLWE ring — after the psi^{-j}/n untwist.

Everything here is vectorized numpy uint64: operands stay < q < 2^31, so
w*v products stay < 2^62 and every intermediate is exact.

Montgomery constants (``R = 2^32`` fixed) live here too: the kernels carry
their twiddles in Montgomery form so a single REDC per butterfly multiply
suffices.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

MONTGOMERY_R_BITS = 32
_R = 1 << MONTGOMERY_R_BITS

__all__ = [
    "MONTGOMERY_R_BITS", "NTTParams", "as_residues", "bit_reverse_indices",
    "choose_modulus", "cyclic_polymul", "intt", "is_prime",
    "negacyclic_polymul", "ntt", "primitive_root",
    "schoolbook_polymul", "root_of_unity",
]


# ---------------------------------------------------------------------------
# Number theory: primality, generators, roots of unity
# ---------------------------------------------------------------------------

def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3 * 10^24 (fixed base set)."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def choose_modulus(n: int, bits: int = 30) -> int:
    """Largest prime q < 2^bits with q ≡ 1 (mod 2n) (bits <= 31 so the
    kernel's single-word Montgomery arithmetic applies)."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"n={n} must be a power of two")
    if not 2 * n < (1 << bits) <= (1 << 31):
        raise ValueError(f"bits={bits} out of range for n={n}")
    step = 2 * n
    q = ((1 << bits) - 2) // step * step + 1
    while q > step:
        if is_prime(q):
            return q
        q -= step
    raise ValueError(f"no NTT prime below 2^{bits} for n={n}")


def _factorize(n: int) -> list[int]:
    """Distinct prime factors by trial division (n < 2^31 here)."""
    fac, d = [], 2
    while d * d <= n:
        if n % d == 0:
            fac.append(d)
            while n % d == 0:
                n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        fac.append(n)
    return fac


@functools.lru_cache(maxsize=None)
def primitive_root(q: int) -> int:
    """Smallest generator of (Z/q)^* for prime q."""
    if not is_prime(q):
        raise ValueError(f"q={q} is not prime")
    fac = _factorize(q - 1)
    g = 2
    while True:
        if all(pow(g, (q - 1) // p, q) != 1 for p in fac):
            return g
        g += 1


def root_of_unity(order: int, q: int) -> int:
    """A primitive ``order``-th root of unity mod q (order | q-1)."""
    if (q - 1) % order:
        raise ValueError(f"order {order} does not divide q-1 = {q - 1}")
    return pow(primitive_root(q), (q - 1) // order, q)


# ---------------------------------------------------------------------------
# Transform parameters
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NTTParams:
    """All per-(n, q) constants; hashable, so tables cache on it.

    Montgomery constants use R = 2^32: ``qinv`` is -q^{-1} mod R (the REDC
    multiplier) and ``r2`` is R^2 mod q (domain-entry factor).
    """
    n: int
    q: int
    w: int          # primitive n-th root of unity
    w_inv: int
    psi: int        # primitive 2n-th root, psi^2 = w (negacyclic twist)
    psi_inv: int
    n_inv: int      # n^{-1} mod q
    qinv: int       # -q^{-1} mod 2^32
    r2: int         # 2^64 mod q

    @classmethod
    def make(cls, n: int, q: int | None = None, *,
             bits: int = 30) -> "NTTParams":
        if n <= 0 or n & (n - 1):
            raise ValueError(f"n={n} must be a power of two")
        if q is None:
            q = choose_modulus(n, bits=bits)
        if not is_prime(q) or (q - 1) % (2 * n) or q % 2 == 0 or q >= 1 << 31:
            raise ValueError(
                f"q={q} must be an odd prime ≡ 1 (mod 2n={2 * n}), < 2^31")
        psi = root_of_unity(2 * n, q)
        w = psi * psi % q
        return cls(n=n, q=q, w=w, w_inv=pow(w, -1, q),
                   psi=psi, psi_inv=pow(psi, -1, q), n_inv=pow(n, -1, q),
                   qinv=(-pow(q, -1, _R)) % _R, r2=_R * _R % q)

    def subparams(self, m: int) -> "NTTParams":
        """Parameters for the length-m sub-transform (m | n) over the SAME q.

        Roots are the originals raised to the (n/m)-th power: the per-shard
        twiddle roots of the four-step decomposition (the PIM model's
        distributed NTT, ``core.pim.ntt_pim.pim_ntt_distributed``): psi has
        order 2n, so psi^(n/m) is a primitive 2m-th root and
        (psi^(n/m))^2 = w^(n/m) generates the length-m cyclic transform.
        q = 1 (mod 2n) implies q = 1 (mod 2m), so the result is a valid
        NTTParams without re-searching moduli.
        """
        if m <= 1 or self.n % m:
            raise ValueError(f"m={m} must divide n={self.n} and exceed 1")
        f = self.n // m
        psi = pow(self.psi, f, self.q)
        w = psi * psi % self.q
        return NTTParams(n=m, q=self.q, w=w, w_inv=pow(w, -1, self.q),
                         psi=psi, psi_inv=pow(psi, -1, self.q),
                         n_inv=pow(m, -1, self.q), qinv=self.qinv,
                         r2=self.r2)

    # -- twiddle tables (numpy, normal domain) ------------------------------
    def powers(self, base: int) -> np.ndarray:
        """[base^0, base^1, ..., base^(n-1)] mod q as uint64 (a fresh array;
        the table is computed once per (n, q, base))."""
        return _powers(self.n, self.q, base).copy()

    def to_montgomery(self, x: np.ndarray) -> np.ndarray:
        """x * R mod q elementwise (x < q < 2^31, so x*R < 2^63: exact)."""
        return (np.asarray(x, np.uint64) << np.uint64(MONTGOMERY_R_BITS)) \
            % np.uint64(self.q)


@functools.lru_cache(maxsize=64)
def _powers(n: int, q: int, base: int) -> np.ndarray:
    out = np.empty(n, np.uint64)
    acc = 1
    for i in range(n):
        out[i] = acc
        acc = acc * base % q
    return out


def bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


# ---------------------------------------------------------------------------
# Transforms (vectorized over leading batch dims)
# ---------------------------------------------------------------------------

def as_residues(x, q: int) -> np.ndarray:
    """Coerce integer coefficients to residues in [0, q) as uint64.

    Floats are rejected loudly — silently truncating un-quantized data
    would defeat the whole point of the exact path. Negative coefficients
    reduce Python-style ((-1) % q == q - 1), the RLWE convention.
    """
    a = np.asarray(x)
    if a.dtype.kind not in "iu":
        raise TypeError(f"NTT needs integer input, got {a.dtype}")
    return (a.astype(np.int64) % q).astype(np.uint64)


def _ntt_core(x: np.ndarray, params: NTTParams, root: int) -> np.ndarray:
    """Iterative DIT butterflies after bit reversal, batched over x[..., n].

    Same loop structure as ``fft_pim._fft_groups`` / py-fhe's ``ntt`` —
    log2 n stages of span-m butterflies with stride-(n/m) twiddles.
    """
    n, q = params.n, np.uint64(params.q)
    y = x[..., bit_reverse_indices(n)].copy()
    pw = params.powers(root)
    for s in range(n.bit_length() - 1):
        m = 2 << s
        half = m >> 1
        blocks = y.reshape(*y.shape[:-1], n // m, m)
        u = blocks[..., :half]
        v = blocks[..., half:]
        tw = pw[(n // m) * np.arange(half)]
        t = (tw * v) % q
        blocks[..., :half], blocks[..., half:] = (u + t) % q, (u + q - t) % q
    return y


def ntt(x, params: NTTParams) -> np.ndarray:
    """Forward cyclic NTT of x[..., n]: X[k] = sum_j x[j] w^{jk} mod q."""
    return _ntt_core(as_residues(x, params.q), params, params.w)


def intt(x, params: NTTParams) -> np.ndarray:
    """Inverse cyclic NTT: intt(ntt(x)) == x exactly."""
    y = _ntt_core(as_residues(x, params.q), params, params.w_inv)
    return (y * np.uint64(params.n_inv)) % np.uint64(params.q)


# ---------------------------------------------------------------------------
# Polynomial products
# ---------------------------------------------------------------------------

def cyclic_polymul(a, b, params: NTTParams) -> np.ndarray:
    """a * b mod (x^n - 1, q): the convolution theorem, exactly."""
    q = np.uint64(params.q)
    return intt((ntt(a, params) * ntt(b, params)) % q, params)


def negacyclic_polymul(a, b, params: NTTParams) -> np.ndarray:
    """a * b mod (x^n + 1, q) — the RLWE ring — via the psi twist."""
    q = np.uint64(params.q)
    psi_pow = params.powers(params.psi)
    at = (as_residues(a, params.q) * psi_pow) % q
    bt = (as_residues(b, params.q) * psi_pow) % q
    ct = intt((ntt(at, params) * ntt(bt, params)) % q, params)
    return (ct * params.powers(params.psi_inv)) % q


def schoolbook_polymul(a, b, q: int, *, negacyclic: bool = True) -> np.ndarray:
    """O(n^2) coefficient product mod (x^n ± 1, q): the independent oracle
    the transform stack is tested against (no roots of unity involved)."""
    a = as_residues(a, q)
    b = as_residues(b, q)
    n = a.shape[-1]
    if a.ndim == 1:
        a = a[None]
        b = b[None]
        squeeze = True
    else:
        squeeze = False
    out = np.zeros_like(a)
    qq = np.uint64(q)
    for i in range(n):
        for j in range(n):
            k = i + j
            term = (a[..., i] * b[..., j]) % qq
            if k < n:
                out[..., k] = (out[..., k] + term) % qq
            elif negacyclic:
                out[..., k - n] = (out[..., k - n] + qq - term) % qq
            else:
                out[..., k - n] = (out[..., k - n] + term) % qq
    return out[0] if squeeze else out
