"""Public transform surface over the kernels (port of ``repro.kernels.ops``).

Functions take tensors of shape (..., n), n a power of two, with any
leading batch dims, and run where the tensor lies: on the card through the
CUDA kernels, on the CPU through their plain versions. Complex tensors are
complex64; real tensors float32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fft as _kfft
from repro_torch.kernels import polymul as _kpoly


def _as2d(x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    n = x.shape[-1]
    return x.reshape(-1, n), tuple(x.shape[:-1])


def _planes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    x = x.to(torch.complex64)
    return x.real.contiguous(), x.imag.contiguous()


def _real(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def fft(x: torch.Tensor, *, inverse: bool = False, radix: int = 2,
        block_b: int | None = None) -> torch.Tensor:
    """Batched FFT of a complex tensor (..., n)."""
    x2, lead = _as2d(x)
    yr, yi = _kfft.fft_planes(*_planes(x2), inverse=inverse, radix=radix,
                              block_b=block_b)
    return torch.complex(yr, yi).reshape(*lead, x.shape[-1])


def ifft(x: torch.Tensor, **kw) -> torch.Tensor:
    return fft(x, inverse=True, **kw)


# ---------------------------------------------------------------------------
# Real-Hermitian fast path (paper Eq. (10)).
#
# Public layout is numpy's (..., n/2 + 1) complex half-spectrum; ``packed=
# True`` exposes the kernel's packed-Nyquist layout (n/2 bins,
# P[0] = X[0].re + i X[n/2].re) without the O(n) repack.
# ---------------------------------------------------------------------------

def packed_to_halfspec(yr: torch.Tensor, yi: torch.Tensor) -> torch.Tensor:
    """Packed-Nyquist planes (..., n/2) -> numpy-layout (..., n/2+1)."""
    zero = torch.zeros_like(yr[..., :1])
    re = torch.cat([yr, yi[..., :1]], dim=-1)
    im = torch.cat([zero, yi[..., 1:], zero], dim=-1)
    return torch.complex(re, im)


def halfspec_to_packed(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Numpy-layout half-spectrum (..., n/2+1) -> packed planes (..., n/2)."""
    nh = x.shape[-1] - 1
    re = x.real.to(torch.float32)
    im = x.imag.to(torch.float32)
    pr = re[..., :nh]
    pi = torch.cat([re[..., nh:], im[..., 1:nh]], dim=-1)
    return pr, pi


def rfft(x: torch.Tensor, *, radix: int = 2, packed: bool = False,
         block_b: int | None = None):
    """FFT of a real tensor (..., n): the half-spectrum only.

    Returns complex (..., n/2+1) matching ``np.fft.rfft``, or the packed
    planes ``(re, im)`` of shape (..., n/2) with ``packed=True``. Runs the
    two-for-one kernel: two real rows per complex transform.
    """
    if x.is_complex():
        raise TypeError(f"rfft needs real input, got {x.dtype}")
    n = x.shape[-1]
    x2, lead = _as2d(x)
    yr, yi = _kfft.rfft_planes(_real(x2), radix=radix, block_b=block_b)
    yr = yr.reshape(*lead, n // 2)
    yi = yi.reshape(*lead, n // 2)
    return (yr, yi) if packed else packed_to_halfspec(yr, yi)


def irfft(x, *, radix: int = 2, packed: bool = False,
          block_b: int | None = None) -> torch.Tensor:
    """Inverse of ``rfft``: half-spectrum -> real (..., n).

    ``x`` is complex (..., n/2+1) (numpy layout), or the packed plane pair
    ``(re, im)`` of shape (..., n/2) with ``packed=True``. Runs the
    two-for-one inverse kernel: two half-spectra per inverse complex
    transform, unpacked inside the kernel.
    """
    if packed:
        pr, pi = x
        pr, pi = _real(pr), _real(pi)
    else:
        pr, pi = halfspec_to_packed(x)
    n = 2 * pr.shape[-1]
    p2, lead = _as2d(pr)
    q2, _ = _as2d(pi)
    y = _kfft.irfft_planes(p2.contiguous(), q2.contiguous(), radix=radix,
                           block_b=block_b)
    return y.reshape(*lead, n)


def polymul_real(a: torch.Tensor, b: torch.Tensor, *, mode: str = "linear",
                 radix: int = 2, block_b: int | None = None) -> torch.Tensor:
    """Polynomial product of REAL coefficient tensors: the explicit fast
    path. Raises on complex input, then delegates to ``polymul``'s real
    branch (one forward transform per product, one inverse per pair)."""
    if a.is_complex() or b.is_complex():
        raise TypeError(f"polymul_real needs real input, got "
                        f"{a.dtype}/{b.dtype}")
    return polymul(a, b, mode=mode, radix=radix, block_b=block_b)


def polymul(a: torch.Tensor, b: torch.Tensor, *, mode: str = "linear",
            radix: int = 2, block_b: int | None = None) -> torch.Tensor:
    """Polynomial multiplication via the convolution theorem (Eq. (9)).

    mode='circular': product mod x^n - 1 (length n).
    mode='linear'  : full product, inputs zero-padded to 2n; returns length
                     2n (last coefficient structurally 0).

    Real inputs take the real-packed kernel (float32 result); complex
    inputs the three-transform kernel (complex64 result).
    """
    if a.shape != b.shape:
        raise ValueError(f"operand shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    n = a.shape[-1]
    if mode == "linear":
        a = torch.nn.functional.pad(a, (0, n))
        b = torch.nn.functional.pad(b, (0, n))
        n = 2 * n
    elif mode != "circular":
        raise ValueError(f"unknown mode {mode!r}")
    a2, lead = _as2d(a)
    b2, _ = _as2d(b)
    if not a.is_complex() and not b.is_complex():
        c = _kpoly.polymul_real_planes(_real(a2), _real(b2), radix=radix,
                                       block_b=block_b)
        return c.reshape(*lead, n)
    cr, ci = _kpoly.polymul_complex_planes(*_planes(a2), *_planes(b2),
                                           radix=radix, block_b=block_b)
    return torch.complex(cr, ci).reshape(*lead, n)
