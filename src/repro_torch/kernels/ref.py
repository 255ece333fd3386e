"""Plain-torch oracles for the Fourier kernels (port of ``repro.kernels.ref``).

These are test oracles, written independently of the kernels: a naive
Vandermonde DFT, a recursive radix-2 FFT, an iterative radix-2 Stockham FFT,
direct convolution, and the real-packing identity (paper Eq. (10)).
Complex values are carried as complex64/complex128 tensors here; the kernels
use split real/imag planes.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def dft_matrix(n: int, *, inverse: bool = False,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """Vandermonde matrix W[j, k] = omega_n^{j k},  omega_n = e^{-2 pi i / n},
    computed in complex128 and rounded once to complex64."""
    k = np.arange(n)
    sign = 1.0 if inverse else -1.0
    w = np.exp(sign * 2j * np.pi * np.outer(k, k) / n)
    return torch.as_tensor(w).to(device=device, dtype=torch.complex64)


def dft(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """Naive DFT via matmul; x shape (..., n)."""
    n = x.shape[-1]
    x = x.to(torch.complex64)
    y = x @ dft_matrix(n, inverse=inverse, device=x.device).T
    if inverse:
        y = y / n
    return y


def fft_recursive(x: torch.Tensor) -> torch.Tensor:
    """Recursive decimation-in-time FFT (paper Eq. (3)); x shape (..., n),
    n a power of two. Twiddles in fp32 phases, as the reference's."""
    n = x.shape[-1]
    if n == 1:
        return x.to(torch.complex64)
    if n % 2:
        raise ValueError(f"n={n} is not a power of two")
    even = fft_recursive(x[..., 0::2])
    odd = fft_recursive(x[..., 1::2])
    k = torch.arange(n // 2, device=x.device)
    w = torch.exp(-2j * math.pi * k / n).to(torch.complex64)
    t = w * odd
    return torch.cat([even + t, even - t], dim=-1)


def ifft_recursive(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    return torch.conj(fft_recursive(torch.conj(x))) / n


def fft_stockham(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """Iterative radix-2 Stockham autosort FFT; x shape (..., n).

    Invariant: A_t has shape (..., L, r) with L = 2^t, r = n / 2^t and
    A_t[..., l, q] = FFT_L(x[q :: r])[l]. Like the reference oracle, the
    per-stage twiddle phases are computed in fp32 (complex64): this is an
    oracle, not the kernels' table (``kernels.fft.twiddle_table``).
    """
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"n={n} must be a power of two")
    batch = x.shape[:-1]
    sign = 1.0 if inverse else -1.0
    y = x.to(torch.complex64).reshape(*batch, 1, n)
    L, r = 1, n
    while r > 1:
        half = r // 2
        e = y[..., :, :half]
        o = y[..., :, half:]
        ang = torch.arange(L, device=x.device) / (2 * L)   # fp32 phases
        w = torch.exp(sign * 2j * math.pi * ang).to(torch.complex64)
        t = w[:, None] * o
        y = torch.cat([e + t, e - t], dim=-2)
        L, r = 2 * L, half
    y = y.reshape(*batch, n)
    if inverse:
        y = y / n
    return y


def ifft_stockham(x: torch.Tensor) -> torch.Tensor:
    return fft_stockham(x, inverse=True)


def convolve_direct(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full linear convolution, O(n m), via explicit sum; a, b shape (..., n)."""
    n = a.shape[-1]
    m = b.shape[-1]
    out_len = n + m - 1
    wide = torch.complex128 if a.is_complex() else torch.float64
    a64 = a.to(wide)
    b64 = b.to(wide)
    # out[k] = sum_j a[j] b[k - j]
    a_p = torch.nn.functional.pad(a64, (0, out_len - n))
    rows = torch.stack([torch.roll(a_p, s, dims=-1) for s in range(m)],
                       dim=-2)                       # (..., m, out_len)
    return torch.einsum("...m,...ml->...l", b64, rows)


def polymul_circular_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Circular (mod x^n - 1) product via the convolution theorem with
    oracle DFTs."""
    return dft(dft(a) * dft(b), inverse=True)


def polymul_linear_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full product of degree-(n-1) polys: zero-pad to 2n, then circular
    multiply. Output length 2n (last coefficient is structurally zero)."""
    n = a.shape[-1]
    pad = torch.nn.functional.pad
    return polymul_circular_ref(pad(a, (0, n)), pad(b, (0, n)))


def realpack_fft_ref(x: torch.Tensor, y: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """FFTs of two real sequences via one complex DFT of z = x + i y
    (paper Eq. (10)):
    X_k = (conj(Z_{n-k}) + Z_k) / 2,  Y_k = i (conj(Z_{n-k}) - Z_k) / 2,
    indices mod n."""
    z = torch.complex(x.to(torch.float32), y.to(torch.float32))
    zf = dft(z)
    zrev = torch.roll(torch.flip(zf, dims=[-1]), 1, dims=-1)   # Z_{n-k}
    return 0.5 * (torch.conj(zrev) + zf), 0.5j * (torch.conj(zrev) - zf)


def fft_causal_conv_ref(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Causal depthwise convolution y[t] = sum_{s<=t} k[s] x[t-s], by direct
    summation; x (..., T), k (..., K)."""
    T = x.shape[-1]
    return convolve_direct(x, k)[..., :T].to(x.dtype)
