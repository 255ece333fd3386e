"""Plain reference of the exact RLWE ring product held in RNS form.

For each limb prime q_i the product is the negacyclic convolution
c = a * b mod (x^n + 1, q_i), computed exactly with int64 arithmetic
(residues < 2^30, so a product of two fits in 60 bits). Everything is
derived here from (n, modulus_bits, limb_bits): the limb primes, their
roots of unity and the twiddle powers. Nothing is taken from the program
under test, and nothing of it is imported.

``product`` is the reference. ``float_product`` is the control: the same
ring product through float64 FFTs, the tempting shortcut that breaks the
guarantee that every residue is exact (coefficients reach n q^2 ~ 2^72,
past float64's 53 bits).
"""
from __future__ import annotations

import functools

import torch

_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(m: int) -> bool:
    """Deterministic Miller-Rabin for m < 3.3e24."""
    if m < 2:
        return False
    for p in _BASES:
        if m % p == 0:
            return m == p
    d, s = m - 1, 0
    while d % 2 == 0:
        d, s = d // 2, s + 1
    for a in _BASES:
        x = pow(a, d, m)
        if x in (1, m - 1):
            continue
        for _ in range(s - 1):
            x = x * x % m
            if x == m - 1:
                break
        else:
            return False
    return True


def ntt_primes(n: int, bits: int):
    """Descending primes q < 2^bits with q = 1 (mod 2n): each has a
    primitive 2n-th root of unity, so it carries a negacyclic NTT."""
    step = 2 * n
    q = ((1 << bits) - 2) // step * step + 1
    while q > step:
        if is_prime(q):
            yield q
        q -= step


@functools.lru_cache(maxsize=None)
def limbs(n: int, modulus_bits: int, limb_bits: int = 30
          ) -> tuple[int, tuple[int, ...]]:
    """(Q, limb primes). Q is the first product of descending NTT primes
    that reaches ``modulus_bits`` bits, as an RLWE modulus chain is built.
    The limbs are the fewest descending primes whose product M exceeds
    2 n Q^2, so that the CRT of a product of two polynomials with
    coefficients in [0, Q) is exact."""
    q_big = 1
    for p in ntt_primes(n, limb_bits):
        q_big *= p
        if q_big.bit_length() >= modulus_bits:
            break
    out, m = [], 1
    for p in ntt_primes(n, limb_bits):
        out.append(p)
        m *= p
        if m > 2 * n * q_big * q_big:
            return q_big, tuple(out)
    raise ValueError(f"too few {limb_bits}-bit primes for n={n}")


def _factors(m: int) -> list[int]:
    out, d = [], 2
    while d * d <= m:
        if m % d == 0:
            out.append(d)
            while m % d == 0:
                m //= d
        d += 1
    if m > 1:
        out.append(m)
    return out


@functools.lru_cache(maxsize=None)
def psi(q: int, n: int) -> int:
    """A primitive 2n-th root of unity mod q, from the least generator."""
    fac = _factors(q - 1)
    g = 2
    while any(pow(g, (q - 1) // f, q) == 1 for f in fac):
        g += 1
    return pow(g, (q - 1) // (2 * n), q)


def _powers(base: int, count: int, q: int) -> list[int]:
    out, x = [], 1
    for _ in range(count):
        out.append(x)
        x = x * base % q
    return out


@functools.lru_cache(maxsize=64)
def _tables(q: int, n: int, device: str):
    """Twiddle powers of w = psi^2 and of w^-1, psi^j and n^-1 psi^-j, as
    int64 tensors on ``device``."""
    p = psi(q, n)
    w = p * p % q
    as_t = functools.partial(torch.tensor, dtype=torch.int64, device=device)
    pinv = pow(p, -1, q)
    ninv = pow(n, -1, q)
    return (as_t(_powers(w, n, q)), as_t(_powers(pow(w, -1, q), n, q)),
            as_t(_powers(p, n, q)),
            as_t([ninv * x % q for x in _powers(pinv, n, q)]))


def _bitrev(n: int, device) -> torch.Tensor:
    bits = n.bit_length() - 1
    idx = torch.arange(n, device=device)
    rev = torch.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def ntt(x: torch.Tensor, powers: torch.Tensor, q: int) -> torch.Tensor:
    """Cyclic NTT of int64 residue rows (..., n), natural order in and
    out: X_k = sum_j x_j w^(jk) mod q, w the root whose powers are given.
    Iterative radix-2 decimation in time after a bit reversal."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    x = x[..., _bitrev(n, x.device)]
    half = 1
    while half < n:
        tw = powers[:: n // (2 * half)][:half]
        y = x.reshape(*lead, n // (2 * half), 2, half)
        u, v = y[..., 0, :], y[..., 1, :] * tw % q
        x = torch.stack(((u + v) % q, (u - v) % q), dim=-2).reshape(*lead, n)
        half *= 2
    return x


def negacyclic(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """a * b mod (x^n + 1, q) for int64 residue rows (..., n) < q."""
    n = a.shape[-1]
    wf, wi, tw, untw = _tables(q, n, str(a.device))
    fa = ntt(a * tw % q, wf, q)
    fb = ntt(b * tw % q, wf, q)
    return ntt(fa * fb % q, wi, q) * untw % q


def residues(x: torch.Tensor) -> torch.Tensor:
    """uint32 or int32 residue words (< 2^31) -> int64."""
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64)


def product(a: torch.Tensor, b: torch.Tensor, primes) -> torch.Tensor:
    """The reference: (k, B, n) residue stacks -> (k, B, n) int64, limb i
    reduced mod primes[i]."""
    return torch.stack([negacyclic(residues(a[i]), residues(b[i]), q)
                        for i, q in enumerate(primes)])


def float_product(a: torch.Tensor, b: torch.Tensor, primes) -> torch.Tensor:
    """The control: each limb's negacyclic product through a float64 FFT
    of length 2n (the linear product folded by x^n = -1), rounded and
    reduced mod q_i; int32 out, as the program's words."""
    n = a.shape[-1]
    out = []
    for i, q in enumerate(primes):
        fa = torch.fft.rfft(residues(a[i]).to(torch.float64), 2 * n)
        fb = torch.fft.rfft(residues(b[i]).to(torch.float64), 2 * n)
        lin = torch.round(torch.fft.irfft(fa * fb, 2 * n))
        c = lin[..., :n] - lin[..., n:]
        out.append(torch.remainder(c, q).to(torch.int64).to(torch.int32))
    return torch.stack(out)


def schoolbook(a: list[int], b: list[int], q: int) -> list[int]:
    """Quadratic negacyclic product of Python ints (tests only)."""
    n = len(a)
    c = [0] * n
    for i in range(n):
        for j in range(n):
            k = i + j
            if k < n:
                c[k] += a[i] * b[j]
            else:
                c[k - n] -= a[i] * b[j]
    return [v % q for v in c]
