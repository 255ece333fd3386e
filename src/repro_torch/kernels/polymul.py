"""Fused polynomial products via the convolution theorem (port of
``repro.kernels.polymul``): forward transforms, pointwise product and
inverse transform, one residency per row below ``TWO_PASS_FROM`` (4096
points at most), and from it on a split-pass schedule of three or four
launches whose CTAs hold whole sub-problems of a split n = n1 x n2.

As in ``kernels.fft``, each ``*_planes`` function launches its CUDA kernel
for tensors on the card and runs its plain PyTorch version for tensors on
the CPU.

On the ``meta`` device (the dry-run's) a wrapper runs its plain
version's ops, which compute nothing and give the result's shape and
type; nothing is launched.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch import spans
from repro_torch.kernels import _build
from repro_torch.kernels.fft import (TWO_PASS_FROM, _log2, _sweeps,
                                     check_planes, check_radix, cta_rows,
                                     device_pass2_twiddles, device_twiddles,
                                     hermitian_split, mirror_slots, natural,
                                     pass1_plain, pass2_plain, pass_slots,
                                     plan_batch_block, ptr, scratch_for,
                                     stockham_stages, twiddle_table,
                                     two_pass_split)


def default_complex_block(n: int) -> int:
    """Rows per CTA of the complex product: it holds two spectra per row."""
    return max(1, plan_batch_block(n) // 2)


def default_real_block(n: int) -> int:
    """Rows per CTA of the real product (even: rows pair for the inverse)."""
    return max(2, plan_batch_block(n, real=True) // 2)


# ---------------------------------------------------------------------------
# The split-pass schedule (csrc/stockham.cu, the products' section)
#
# Launch F1 runs pass 1 of the forward transforms (split n1 x n2, on the
# sweep sequence, as ``kernels.fft``'s two-pass schedule). Launch M runs
# their pass 2: its CTA holds sub-problems l0 of a and of b (the complex
# product), or of rows 2j and 2j+1 each beside its mirror (the real
# product), forms the product, and, where the mirrored split (n2, n1) is on
# the sweep sequence too (radix 2; radix 4 at even log2 n), runs pass 1 of
# the inverse on the same sub-problems: forward pass 2's sub-problem l0
# holds the bins l0 + k n1, exactly the inputs of the inverse's pass-1
# sub-problem q0 = l0, in order. Launch I2 is the inverse's pass 2. Off
# that sequence (odd log2 n at radix 4) M stores the product in natural
# order and the inverse runs as the fft's two passes: four launches.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProductTwoPass:
    """A product's split-pass launches: n = n1 n2 as its forward transforms
    split; F1 holds ``c1`` sub-problems of n1 points a CTA, M ``cm`` low
    sub-problems of n2 points (with b's: 2 cm in all; the real product
    with their mirrors and the pair's second row's: 4 cm), and the
    inverse's last pass ``ci``. ``fused``: M runs the inverse's pass 1
    (three launches); otherwise it stores the product and the inverse runs
    as two fft passes split n1 x n2 (four launches)."""
    n1: int
    n2: int
    c1: int
    cm: int
    ci: int
    fused: bool

    @property
    def launches(self) -> int:
        return 3 if self.fused else 4

    @property
    def inverse_n1(self) -> int:
        """The first factor of the inverse's split: n2 where fused."""
        return self.n2 if self.fused else self.n1


@functools.lru_cache(maxsize=256)
def product_two_pass_plan(n: int, radix: int, *, real: bool = False
                          ) -> ProductTwoPass | None:
    """The split-pass launches ``polymul_complex_planes`` (or, ``real``,
    ``polymul_real_planes``) makes for n-point rows, or None where one CTA
    takes whole rows: below ``TWO_PASS_FROM``, and where no split fits
    (past 2^25 points; a single CTA then stages through device memory)."""
    if n < TWO_PASS_FROM["polymul_real" if real else "polymul_complex"]:
        return None
    split = two_pass_split(n, radix, real=real, product=True)
    return None if split is None else product_two_pass_launch(
        *split, radix, real=real)


def product_two_pass_launch(n1: int, n2: int, radix: int, *,
                            real: bool = False) -> ProductTwoPass:
    """Sub-problems per CTA of each launch for the split (n1, n2)."""
    fused = radix == 2 or _log2(n1 * n2) % 2 == 0
    held = 4 if real else 2
    cm = pass_slots(n2, n1 // 2 if real else n1, held)
    ci = pass_slots(n1, n2) if fused else pass_slots(n2, n1)
    return ProductTwoPass(n1, n2, pass_slots(n1, n2), cm, ci, fused)


@functools.lru_cache(maxsize=64)
def mid_inverse_twiddles(n: int, n1: int, device: torch.device
                         ) -> torch.Tensor:
    """Every twiddle of the inverse's pass 1 that the real product's M runs
    (split n2 x n1): the inverse table's W[m n1], m < n / n1, as (n / n1,
    2) interleaved fp32 on ``device``, cached as ``device_twiddles`` is."""
    wr, wi = twiddle_table(n, inverse=True)
    return torch.from_numpy(np.ascontiguousarray(
        np.stack([wr[0, ::n1], wi[0, ::n1]], axis=-1))).to(device)


def _complex_product(far, fai, fbr, fbi):
    return far * fbr - fai * fbi, far * fbi + fai * fbr


def _inverse_two_pass(qr, qi, wr, wi, *, n, radix, sign, plan):
    """The inverse of the products' schedule on P (Q) held as M holds it,
    (B, n1, n2) in sub-problems l0 (bins l0 + k n1): fused, the inverse's
    pass 1 on those very sub-problems, scattered at stride n1 (A'[l n1 +
    l0]), then its pass 2 split n2 x n1; otherwise P in natural order
    through pass 1 and pass 2 split n1 x n2. Natural-order result, not
    scaled."""
    b, n1, n2 = qr.shape
    if plan.fused:
        yr, yi = _sweeps(qr.reshape(b * n1, 1, n2), qi.reshape(b * n1, 1, n2),
                         wr, wi, n=n, r=n2, radix=radix, sign=sign)
        ar, ai = (p.reshape(b, n1, n2).transpose(1, 2).reshape(b, n)
                  for p in (yr, yi))
    else:
        ar, ai = pass1_plain(natural(qr), natural(qi), wr, wi, n=n, n1=n1,
                             radix=radix, sign=sign)
    return tuple(natural(p) for p in pass2_plain(
        ar, ai, wr, wi, n=n, n1=plan.inverse_n1, radix=radix, sign=sign))


# ---------------------------------------------------------------------------
# Complex product
# ---------------------------------------------------------------------------

def polymul_complex_planes_plain(ar, ai, br, bi, *, radix: int = 2):
    """Plain version of ``polymul_complex_planes``."""
    n = ar.shape[1]
    wr, wi = device_twiddles(n, False, ar.device)
    far, fai = stockham_stages(ar, ai, wr, wi, n=n, inverse=False, radix=radix)
    fbr, fbi = stockham_stages(br, bi, wr, wi, n=n, inverse=False, radix=radix)
    pr, pi = _complex_product(far, fai, fbr, fbi)
    # Inverse transform with the forward table: conj(FFT(conj(.)))/n.
    cr, ci = stockham_stages(pr, -pi, wr, wi, n=n, inverse=False, radix=radix)
    inv = 1.0 / n
    return cr * inv, -ci * inv


def polymul_complex_two_pass(ar, ai, br, bi, *, radix: int,
                             plan: ProductTwoPass):
    """Plain mirror of the complex product's split-pass kernels: F1 and M's
    forward sweeps (``pass1_plain``, ``pass2_plain``) on a and b, the
    pointwise product on M's sub-problems, and the inverse as
    conj(FFT(conj P))/n with the forward table (``_inverse_two_pass``),
    the plain version's operations in its order, so the result equals
    ``polymul_complex_planes_plain`` bit for bit."""
    n = ar.shape[1]
    kw = dict(n=n, radix=radix, sign=-1.0)
    wr, wi = device_twiddles(n, False, ar.device)
    fa = pass2_plain(*pass1_plain(ar, ai, wr, wi, n1=plan.n1, **kw), wr, wi,
                     n1=plan.n1, **kw)
    fb = pass2_plain(*pass1_plain(br, bi, wr, wi, n1=plan.n1, **kw), wr, wi,
                     n1=plan.n1, **kw)
    pr, pi = _complex_product(*fa, *fb)
    cr, ci = _inverse_two_pass(pr, -pi, wr, wi, plan=plan, **kw)
    inv = 1.0 / n
    return cr * inv, -ci * inv


def polymul_complex_planes(ar: torch.Tensor, ai: torch.Tensor,
                           br: torch.Tensor, bi: torch.Tensor, *,
                           radix: int = 2, block_b: int | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Circular (mod x^n - 1) product of complex coefficient planes (B, n).

    On the card: kernel ``polymul_complex_kernel`` -- from
    ``TWO_PASS_FROM["polymul_complex"]`` points on its split-pass schedule
    (``product_two_pass_plan``), below that at most ``block_b`` products
    per CTA (default ``default_complex_block``). On the CPU the plain
    version of the same schedule. Replaces
    ``repro/kernels/polymul.py::polymul_complex_planes``.
    """
    with spans.span("repro_torch.glue/polymul_complex_planes"):
        b, n = check_planes("polymul_complex_planes", ar, ai, br, bi)
        check_radix(radix)
        two_pass = product_two_pass_plan(n, radix)
        if ar.device.type in ("cpu", "meta"):
            if two_pass is not None:
                return polymul_complex_two_pass(ar, ai, br, bi, radix=radix,
                                                plan=two_pass)
            return polymul_complex_planes_plain(ar, ai, br, bi, radix=radix)
        _build.refuse_grad("polymul_complex_planes", ar, ai, br, bi)
        return _launch_polymul_complex(ar, ai, br, bi, radix,
                                       block_b or default_complex_block(n),
                                       two_pass)


def _split_args(plan: ProductTwoPass | None) -> tuple[int, ...]:
    """log2 of n1, c1, cm and ci for the C launchers; zeros for one CTA per
    block of rows."""
    if plan is None:
        return 0, 0, 0, 0
    return tuple(_log2(v) for v in (plan.n1, plan.c1, plan.cm, plan.ci))


def _launch_polymul_complex(ar, ai, br, bi, radix: int, block: int,
                            two_pass: ProductTwoPass | None):
    """Launch ``stockham_polymul_complex`` on card planes under the given
    schedule: ``two_pass``, or one CTA per ``block`` rows at most."""
    b, n = ar.shape
    cr, ci = torch.empty_like(ar), torch.empty_like(ai)
    if b == 0:
        return cr, ci
    with torch.cuda.device(ar.device):
        wr, wi = device_twiddles(n, False, ar.device)
        if two_pass is None:
            rows, staged = cta_rows(n, b, block, product=True)
            scratch = scratch_for(n, b, rows, staged, ar.device,
                                  product=True)
            tw2f = tw2i = None
        else:
            # F1's spectra of a and b (2B rows), then P or the inverse's
            # pass-1 result (B rows), as split planes
            rows = 1
            scratch = torch.empty(6 * b * n, dtype=ar.dtype,
                                  device=ar.device)
            tw2f = device_pass2_twiddles(n, two_pass.n1, radix, False,
                                         ar.device)
            tw2i = device_pass2_twiddles(n, two_pass.inverse_n1, radix,
                                         False, ar.device)
        _build.launch("stockham_polymul_complex", "polymul_complex_planes",
                      ptr(ar), ptr(ai), ptr(br), ptr(bi), ptr(cr), ptr(ci),
                      ptr(wr), ptr(wi), ptr(scratch), ptr(tw2f), ptr(tw2i),
                      b, _log2(n), radix, rows, *_split_args(two_pass))
    return cr, ci


# ---------------------------------------------------------------------------
# Real product
# ---------------------------------------------------------------------------

def _pad_even(a, b):
    """An odd batch pairs its last product with a zero row."""
    if a.shape[0] % 2:
        a = torch.cat([a, torch.zeros_like(a[:1])])
        b = torch.cat([b, torch.zeros_like(b[:1])])
    return a, b


def polymul_real_planes_plain(a, b, *, radix: int = 2):
    """Plain version of ``polymul_real_planes``: one forward transform per
    product, one inverse per pair of products (an odd batch pairs its last
    product with a zero row)."""
    bsz, n = a.shape
    a, b = _pad_even(a, b)
    bp = a.shape[0]
    wr, wi = device_twiddles(n, False, a.device)
    wir, wii = device_twiddles(n, True, a.device)
    # z = a + i b ; Z = FFT(z); Hermitian split -> A = FFT(a), B = FFT(b)
    zr, zi = stockham_stages(a, b, wr, wi, n=n, inverse=False, radix=radix)
    pr, pi = _complex_product(*hermitian_split(zr, zi))
    # Pair rows for the inverse: Q = P_even + i P_odd.
    pr = pr.reshape(bp // 2, 2, n)
    pi = pi.reshape(bp // 2, 2, n)
    qr = pr[:, 0] - pi[:, 1]
    qi = pi[:, 0] + pr[:, 1]
    cr, ci = stockham_stages(qr, qi, wir, wii, n=n, inverse=True, radix=radix)
    return torch.stack([cr, ci], dim=1).reshape(bp, n)[:bsz]


def polymul_real_two_pass(a, b, *, radix: int, plan: ProductTwoPass):
    """Plain mirror of the real product's split-pass kernels: F1 and M's
    forward sweeps on z = a + ib of each product; in M, CTA g of row pair j
    holds sub-problems l0 = ``mirror_slots(n1, cm)[0][g]`` of rows 2j and
    2j+1, bin k = l0 + n1 l' of slot s pairing with bin n - k in the mirror
    slot for the Hermitian split, the product and Q = P_2j + i P_2j+1 per
    slot; then the inverse of Q with the inverse table
    (``_inverse_two_pass``), c_2j = Re, c_2j+1 = Im, times 1/n. The plain
    version's float expressions in its order, so the result equals
    ``polymul_real_planes_plain`` bit for bit."""
    bsz, n = a.shape
    n1, n2 = plan.n1, plan.n2
    a, b = _pad_even(a, b)
    pairs = a.shape[0] // 2
    dev = a.device
    kw = dict(n=n, radix=radix)
    wr, wi = device_twiddles(n, False, dev)
    wir, wii = device_twiddles(n, True, dev)
    zr, zi = pass2_plain(*pass1_plain(a, b, wr, wi, n1=n1, sign=-1.0, **kw),
                         wr, wi, n1=n1, sign=-1.0, **kw)    # (2 pairs, n1, n2)
    l0, ms = (t.to(dev) for t in mirror_slots(n1, plan.cm))  # (G, 2 cm)
    lp = torch.arange(n2, device=dev)
    k = l0[..., None] + n1 * lp                              # (G, 2 cm, n2)
    mk = (n - k) & (n - 1)
    ml0 = torch.gather(l0, 1, ms)[..., None].expand_as(mk)
    z_r, z_i = zr[:, l0[..., None], lp], zi[:, l0[..., None], lp]
    m_r, m_i = zr[:, ml0, mk // n1], zi[:, ml0, mk // n1]
    far = 0.5 * (m_r + z_r)
    fai = 0.5 * (-m_i + z_i)
    fbr = 0.5 * (m_i + z_i)
    fbi = 0.5 * (m_r - z_r)
    pr, pi = (p.reshape(pairs, 2, *k.shape)
              for p in _complex_product(far, fai, fbr, fbi))
    qr = pr[:, 0] - pi[:, 1]
    qi = pi[:, 0] + pr[:, 1]
    # M's slots back to sub-problem order: sub-problem l0 holds bins
    # l0 + k n1
    order = torch.argsort(l0.flatten())
    qr, qi = (q.reshape(pairs, -1, n2)[:, order] for q in (qr, qi))
    cr, ci = _inverse_two_pass(qr, qi, wir, wii, sign=1.0, plan=plan, **kw)
    inv = 1.0 / n
    return torch.stack([cr * inv, ci * inv], dim=1).reshape(
        2 * pairs, n)[:bsz]


def polymul_real_planes(a: torch.Tensor, b: torch.Tensor, *, radix: int = 2,
                        block_b: int | None = None) -> torch.Tensor:
    """Circular product of REAL coefficient rows (B, n) via Eq. (10):
    1.5 transforms per product instead of the complex path's 3.

    On the card: kernel ``polymul_real_kernel`` -- from
    ``TWO_PASS_FROM["polymul_real"]`` points on its split-pass schedule
    (``product_two_pass_plan``), below that an even number of at most
    ``block_b`` products per CTA (default ``default_real_block``). On the
    CPU the plain version of the same schedule. Replaces
    ``repro/kernels/polymul.py::polymul_real_planes``.
    """
    with spans.span("repro_torch.glue/polymul_real_planes"):
        bsz, n = check_planes("polymul_real_planes", a, b)
        check_radix(radix)
        two_pass = product_two_pass_plan(n, radix, real=True)
        if a.device.type in ("cpu", "meta"):
            if two_pass is not None:
                return polymul_real_two_pass(a, b, radix=radix, plan=two_pass)
            return polymul_real_planes_plain(a, b, radix=radix)
        _build.refuse_grad("polymul_real_planes", a, b)
        return _launch_polymul_real(a, b, radix,
                                    block_b or default_real_block(n),
                                    two_pass)


def _launch_polymul_real(a, b, radix: int, block: int,
                         two_pass: ProductTwoPass | None):
    """Launch ``stockham_polymul_real`` on card rows under the given
    schedule: ``two_pass``, or one CTA per ``block`` rows at most; counted
    in ``_build.SCHEDULES`` as "split-pass", "resident" or "staged"."""
    bsz, n = a.shape
    c = torch.empty_like(a)
    if bsz == 0:
        return c
    with torch.cuda.device(a.device):
        wr, wi = device_twiddles(n, False, a.device)
        wir, wii = device_twiddles(n, True, a.device)
        if two_pass is None:
            rows, staged = cta_rows(n, bsz, block, real=True, product=True)
            scratch = scratch_for(n, bsz, rows, staged, a.device, real=True,
                                  product=True)
            tw2f = tw2i = twi = None
            schedule = "staged" if staged else "resident"
        else:
            # F1's spectra of z = a + ib (B rows), then Q or the inverse's
            # pass-1 result (one row per pair), as split planes
            rows = 2
            scratch = torch.empty(2 * (bsz + (bsz + 1) // 2) * n,
                                  dtype=a.dtype, device=a.device)
            tw2f = device_pass2_twiddles(n, two_pass.n1, radix, False,
                                         a.device)
            tw2i = device_pass2_twiddles(n, two_pass.inverse_n1, radix, True,
                                         a.device)
            twi = (mid_inverse_twiddles(n, two_pass.n1, a.device)
                   if two_pass.fused else None)
            schedule = "split-pass"
        _build.launch("stockham_polymul_real", "polymul_real_planes",
                      ptr(a), ptr(b), ptr(c), ptr(wr), ptr(wi), ptr(wir),
                      ptr(wii), ptr(scratch), ptr(tw2f), ptr(tw2i), ptr(twi),
                      bsz, _log2(n), radix, rows, *_split_args(two_pass),
                      schedule=schedule)
    return c
