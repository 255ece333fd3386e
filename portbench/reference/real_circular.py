"""Plain reference of the circular product of real coefficient rows.

``product`` computes c = a * b mod (x^n - 1) in float64 through float64
FFTs (the error of that is ~1e-15 of the row's scale, far below what is
compared). ``low_precision_product`` is the control: the same product with
every plane (both operands, both spectra, their product and the result)
held in a lower precision, the arithmetic between them in float32.
Nothing of the program under test is imported or read.
"""
from __future__ import annotations

import math

import torch


def product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, n) real rows -> (B, n) float64 circular product."""
    n = a.shape[-1]
    fa = torch.fft.rfft(a.to(torch.float64))
    fb = torch.fft.rfft(b.to(torch.float64))
    return torch.fft.irfft(fa * fb, n)


def _round_planes(z: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.complex(z.real.to(dtype).to(torch.float32),
                         z.imag.to(dtype).to(torch.float32))


def low_precision_product(a: torch.Tensor, b: torch.Tensor,
                          dtype: torch.dtype) -> torch.Tensor:
    """The control: planes stored in ``dtype`` (float16: the paper's half
    precision; bfloat16: the next precision below float32), float32 out.
    Each spectrum is scaled by a power of two near 1/sqrt(n) before it is
    stored, and the result by n after, so that float16's range holds it;
    a power of two changes no rounding."""
    n = a.shape[-1]
    scale = 2.0 ** -round(math.log2(n) / 2)
    a = a.to(dtype).to(torch.float32)
    b = b.to(dtype).to(torch.float32)
    fa = _round_planes(torch.fft.rfft(a) * scale, dtype)
    fb = _round_planes(torch.fft.rfft(b) * scale, dtype)
    p = _round_planes(fa * fb, dtype)
    c = torch.fft.irfft(p, n) / (scale * scale)
    return c.to(dtype).to(torch.float32)


def row_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per row: the largest coefficient error over the row's largest
    reference magnitude (float64)."""
    got = got.to(torch.float64)
    err = (got - want).abs().amax(dim=-1)
    scale = want.abs().amax(dim=-1).clamp_min(1e-300)
    bad = ~torch.isfinite(got).all(dim=-1)
    return torch.where(bad, torch.full_like(err, float("inf")), err / scale)


def naive(a: list[float], b: list[float]) -> list[float]:
    """Quadratic circular product in Python floats (tests only)."""
    n = len(a)
    return [sum(a[j] * b[(k - j) % n] for j in range(n)) for k in range(n)]
