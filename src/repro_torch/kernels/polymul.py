"""Fused polynomial products via the convolution theorem (port of
``repro.kernels.polymul``): forward transforms, pointwise product and
inverse transform in one kernel launch, one residency per row.

As in ``kernels.fft``, each ``*_planes`` function launches its CUDA kernel
for tensors on the card and runs its plain PyTorch version for tensors on
the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fft import (_log2, check_planes,
                                     check_radix, cta_rows, device_twiddles,
                                     hermitian_split, plan_batch_block, ptr,
                                     scratch_for, stockham_stages)


def default_complex_block(n: int) -> int:
    """Rows per CTA of the complex product: it holds two spectra per row."""
    return max(1, plan_batch_block(n) // 2)


def default_real_block(n: int) -> int:
    """Rows per CTA of the real product (even: rows pair for the inverse)."""
    return max(2, plan_batch_block(n, real=True) // 2)


def polymul_complex_planes_plain(ar, ai, br, bi, *, radix: int = 2):
    """Plain version of ``polymul_complex_planes``."""
    n = ar.shape[1]
    wr, wi = device_twiddles(n, False, ar.device)
    far, fai = stockham_stages(ar, ai, wr, wi, n=n, inverse=False, radix=radix)
    fbr, fbi = stockham_stages(br, bi, wr, wi, n=n, inverse=False, radix=radix)
    pr = far * fbr - fai * fbi
    pi = far * fbi + fai * fbr
    # Inverse transform with the forward table: conj(FFT(conj(.)))/n.
    cr, ci = stockham_stages(pr, -pi, wr, wi, n=n, inverse=False, radix=radix)
    inv = 1.0 / n
    return cr * inv, -ci * inv


def polymul_complex_planes(ar: torch.Tensor, ai: torch.Tensor,
                           br: torch.Tensor, bi: torch.Tensor, *,
                           radix: int = 2, block_b: int | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Circular (mod x^n - 1) product of complex coefficient planes (B, n).

    On the card: kernel ``polymul_complex_kernel``, at most ``block_b``
    products per CTA (default ``default_complex_block``). Replaces
    ``repro/kernels/polymul.py::polymul_complex_planes``.
    """
    b, n = check_planes("polymul_complex_planes", ar, ai, br, bi)
    check_radix(radix)
    if ar.device.type == "cpu":
        return polymul_complex_planes_plain(ar, ai, br, bi, radix=radix)
    rows, staged = cta_rows(n, b, block_b or default_complex_block(n),
                            product=True)
    cr, ci = torch.empty_like(ar), torch.empty_like(ai)
    if b == 0:
        return cr, ci
    with torch.cuda.device(ar.device):
        wr, wi = device_twiddles(n, False, ar.device)
        scratch = scratch_for(n, b, rows, staged, ar.device, product=True)
        _build.launch("stockham_polymul_complex", "polymul_complex_planes",
                      ptr(ar), ptr(ai), ptr(br), ptr(bi), ptr(cr), ptr(ci),
                      ptr(wr), ptr(wi), ptr(scratch), b, _log2(n), radix,
                      rows)
    return cr, ci


def polymul_real_planes_plain(a, b, *, radix: int = 2):
    """Plain version of ``polymul_real_planes``: one forward transform per
    product, one inverse per pair of products (an odd batch pairs its last
    product with a zero row)."""
    bsz, n = a.shape
    if bsz % 2:
        a = torch.cat([a, torch.zeros_like(a[:1])])
        b = torch.cat([b, torch.zeros_like(b[:1])])
    bp = a.shape[0]
    wr, wi = device_twiddles(n, False, a.device)
    wir, wii = device_twiddles(n, True, a.device)
    # z = a + i b ; Z = FFT(z); Hermitian split -> A = FFT(a), B = FFT(b)
    zr, zi = stockham_stages(a, b, wr, wi, n=n, inverse=False, radix=radix)
    far, fai, fbr, fbi = hermitian_split(zr, zi)
    pr = far * fbr - fai * fbi
    pi = far * fbi + fai * fbr
    # Pair rows for the inverse: Q = P_even + i P_odd.
    pr = pr.reshape(bp // 2, 2, n)
    pi = pi.reshape(bp // 2, 2, n)
    qr = pr[:, 0] - pi[:, 1]
    qi = pi[:, 0] + pr[:, 1]
    cr, ci = stockham_stages(qr, qi, wir, wii, n=n, inverse=True, radix=radix)
    return torch.stack([cr, ci], dim=1).reshape(bp, n)[:bsz]


def polymul_real_planes(a: torch.Tensor, b: torch.Tensor, *, radix: int = 2,
                        block_b: int | None = None) -> torch.Tensor:
    """Circular product of REAL coefficient rows (B, n) via Eq. (10):
    1.5 transforms per product instead of the complex path's 3.

    On the card: kernel ``polymul_real_kernel``, an even number of at most
    ``block_b`` products per CTA (default ``default_real_block``). Replaces
    ``repro/kernels/polymul.py::polymul_real_planes``.
    """
    bsz, n = check_planes("polymul_real_planes", a, b)
    check_radix(radix)
    if a.device.type == "cpu":
        return polymul_real_planes_plain(a, b, radix=radix)
    rows, staged = cta_rows(n, bsz, block_b or default_real_block(n),
                            real=True, product=True)
    c = torch.empty_like(a)
    if bsz == 0:
        return c
    with torch.cuda.device(a.device):
        wr, wi = device_twiddles(n, False, a.device)
        wir, wii = device_twiddles(n, True, a.device)
        scratch = scratch_for(n, bsz, rows, staged, a.device, real=True,
                              product=True)
        _build.launch("stockham_polymul_real", "polymul_real_planes",
                      ptr(a), ptr(b), ptr(c), ptr(wr), ptr(wi), ptr(wir),
                      ptr(wii), ptr(scratch), bsz, _log2(n), radix, rows)
    return c
