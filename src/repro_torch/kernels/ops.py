"""Public transform surface over the kernels (port of ``repro.kernels.ops``).

Functions take tensors of shape (..., n), n a power of two, with any
leading batch dims, and run where the tensor lies: on the card through the
CUDA kernels, on the CPU through their plain versions. Complex tensors are
complex64; real tensors float32. On a CUDA tensor no op here calls
``torch.fft``: every transform is a launch of the port's kernels.
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


# ---------------------------------------------------------------------------
# Compositions of the batched transform: the real-packing identity, 2-D
# transforms and FFT convolutions.
# ---------------------------------------------------------------------------

def realpack_fft(x: torch.Tensor, y: torch.Tensor, *, radix: int = 2
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """FFTs of two real tensors (..., n) through one complex FFT of
    z = x + i y (paper Eq. (10)):
    X_k = (conj(Z_{n-k}) + Z_k) / 2,  Y_k = i (conj(Z_{n-k}) - Z_k) / 2."""
    zf = fft(torch.complex(_real(x), _real(y)), radix=radix)
    zrev = torch.roll(torch.flip(zf, dims=[-1]), 1, dims=-1)   # Z_{n-k}
    return 0.5 * (torch.conj(zrev) + zf), 0.5j * (torch.conj(zrev) - zf)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def fft2(x: torch.Tensor, *, inverse: bool = False,
         radix: int = 2) -> torch.Tensor:
    """2-D FFT of (..., H, W), H and W powers of two, by separability: the
    batched 1-D transform along W, then (the last two axes swapped) along
    H."""
    y = fft(x, inverse=inverse, radix=radix)                   # along W
    y = fft(y.transpose(-1, -2), inverse=inverse, radix=radix)  # along H
    return y.transpose(-1, -2)


def fft_conv2d(img: torch.Tensor, kern: torch.Tensor, *,
               radix: int = 2) -> torch.Tensor:
    """'same'-padded 2-D convolution by the convolution theorem.

    img: (..., H, W) real; kern: (kh, kw) real, kh and kw odd. Both are
    zero-padded to the next powers of two >= H + kh and W + kw."""
    H, W = img.shape[-2:]
    kh, kw = kern.shape
    Hp, Wp = _next_pow2(H + kh), _next_pow2(W + kw)
    pad = torch.nn.functional.pad
    xi = pad(_real(img), (0, Wp - W, 0, Hp - H))
    ki = pad(_real(kern), (0, Wp - kw, 0, Hp - kh))
    fx = fft2(xi.to(torch.complex64), radix=radix)
    fk = fft2(ki.to(torch.complex64), radix=radix)
    full = fft2(fx * fk, inverse=True, radix=radix).real
    r0, c0 = kh // 2, kw // 2
    return full[..., r0:r0 + H, c0:c0 + W].to(img.dtype)


def fft_causal_conv(x: torch.Tensor, k: torch.Tensor, *,
                    radix: int = 2) -> torch.Tensor:
    """Causal depthwise long convolution y[t] = sum_{s<=t} k[s] x[t-s].

    x: (..., T) real signal, k: (..., K) real taps, their leading dims
    broadcast against each other (``fourier_mixing`` passes x (B, d, T)
    and k (1, d, K)). Both are zero-padded to n = the next power of two
    >= T + K, so the circular product does not wrap; each is transformed
    by the complex FFT (``fft_planes``, zero imaginary plane), the spectra
    are multiplied, the product is transformed back, and the real part of
    the first T points is returned in x's type. Three calls of
    ``fft_planes``, each one kernel below ``TWO_PASS_FROM["fft"]`` points
    and two passes from there on.

    Differentiable (``_CausalConv``): the backward makes three more calls
    of ``fft_planes``, so on the card the gradient runs on the kernel too.
    """
    return _CausalConv.apply(_real(x), _real(k), radix).to(x.dtype)


def _fft_rows(re: torch.Tensor, im: torch.Tensor | None, *, radix: int,
              inverse: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``fft_planes`` over the last axis of (..., n) planes (a zero
    imaginary plane where ``im`` is None), in their shape."""
    r2, lead = _as2d(re.contiguous())
    i2 = torch.zeros_like(r2) if im is None else im.contiguous().reshape(
        r2.shape)
    yr, yi = _kfft.fft_planes(r2, i2, inverse=inverse, radix=radix)
    return yr.reshape(*lead, -1), yi.reshape(*lead, -1)


class _CausalConv(torch.autograd.Function):
    """``fft_causal_conv`` on fp32 x (..., T) and k (..., K).

    Forward: X = FFT(x padded), Kf = FFT(k padded), y = Re IFFT(X Kf)[:T];
    the spectra X and Kf are saved. Backward, with G = FFT(g padded to n):
    dx = Re IFFT(G conj Kf)[:T] and dk = Re IFFT(G conj X)[:K], each
    product summed over the dims its operand broadcast over before the
    inverse (linear, so the same function: dk's inverse runs on k's rows,
    not on the batch's). No term wraps: n >= T + K, so a lag t - s < 0
    lands at n + t - s, past both operands' supports. Under activation
    recomputation the forward runs again and saves its spectra again."""

    @staticmethod
    def forward(ctx, x, k, radix: int):
        T, K = x.shape[-1], k.shape[-1]
        n = _next_pow2(T + K)
        pad = torch.nn.functional.pad
        ar, ai = _fft_rows(pad(x, (0, n - T)), None, radix=radix)
        br, bi = _fft_rows(pad(k, (0, n - K)), None, radix=radix)
        yr, _ = _fft_rows(ar * br - ai * bi, ar * bi + ai * br, radix=radix,
                          inverse=True)
        ctx.save_for_backward(ar, ai, br, bi)
        ctx.radix, ctx.T, ctx.K = radix, T, K
        ctx.x_lead, ctx.k_lead = x.shape[:-1], k.shape[:-1]
        return yr[..., :T]

    @staticmethod
    def backward(ctx, g):
        ar, ai, br, bi = ctx.saved_tensors
        radix, T, K = ctx.radix, ctx.T, ctx.K
        n = ar.shape[-1]
        gr, gi = _fft_rows(torch.nn.functional.pad(g.float(), (0, n - T)),
                           None, radix=radix)
        dx = dk = None
        if ctx.needs_input_grad[0]:
            # G conj(Kf)
            pr = (gr * br + gi * bi).sum_to_size(*ctx.x_lead, n)
            pi = (gi * br - gr * bi).sum_to_size(*ctx.x_lead, n)
            dx = _fft_rows(pr, pi, radix=radix, inverse=True)[0][..., :T]
        if ctx.needs_input_grad[1]:
            # G conj(X), summed over the batch before the inverse
            pr = (gr * ar + gi * ai).sum_to_size(*ctx.k_lead, n)
            pi = (gi * ar - gr * ai).sum_to_size(*ctx.k_lead, n)
            dk = _fft_rows(pr, pi, radix=radix, inverse=True)[0][..., :K]
        return dx, dk, None
