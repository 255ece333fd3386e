"""Batched Stockham FFT and two-for-one real FFT and its inverse (port of
``repro.kernels.fft``).

Each public ``*_planes`` function is a wrapper: for tensors on the card it
launches its hand-written CUDA kernel (``csrc/stockham.cu``), for tensors on
the CPU it runs the plain PyTorch version beside it, which performs the same
sweeps, twiddles, split and packing as torch ops. Any other device raises.
A launch has no backward, so on the card a wrapper raises for an input that
requires grad under grad mode (``_build.refuse_grad``); the plain versions
are torch ops that autograd records.

Complex data is carried as split fp32 planes (B, n). Stockham invariant: the
state of a row is A(L, r) with L * r = n, and column q of A is the length-L
FFT of x[q :: r]; no bit-reversal permutation is ever applied.

On the ``meta`` device (the dry-run's) a wrapper runs its plain
version's ops, which compute nothing and give the result's shape and
type (``fft_planes`` returns planes of its input's shape at
once); nothing is launched.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch import spans
from repro_torch.kernels import _build


def _log2(n: int) -> int:
    if n <= 0 or n & (n - 1):
        raise ValueError(f"n={n} must be a power of two")
    return n.bit_length() - 1


def twiddle_table(n: int, *, inverse: bool = False
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Master twiddle table W[k] = exp(sign * 2 pi i k / n), k < n, fp32 planes.

    Every stage's twiddles are strided slices of this one table (stage L
    uses W[:: n/(2L)][:L]). Angles are computed in float64 from exact
    integer exponents and rounded once to fp32.
    """
    k = np.arange(n, dtype=np.float64)
    sign = 1.0 if inverse else -1.0
    ang = sign * 2.0 * np.pi * k / n
    return (np.cos(ang).astype(np.float32)[None, :],
            np.sin(ang).astype(np.float32)[None, :])


@functools.lru_cache(maxsize=64)
def device_twiddles(n: int, inverse: bool, device: torch.device
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``twiddle_table`` as (1, n) fp32 tensors on ``device``, cached so a
    served batch does not copy the table to the card again."""
    wr, wi = twiddle_table(n, inverse=inverse)
    return (torch.from_numpy(wr).to(device), torch.from_numpy(wi).to(device))


# ---------------------------------------------------------------------------
# Plain Stockham sweeps (the dataflow every kernel in csrc/stockham.cu runs)
# ---------------------------------------------------------------------------

def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _mul_i(r, i, sign: float):
    """(r + i j) * (sign * j):  sign=-1 -> multiply by -i, sign=+1 -> by +i."""
    if sign < 0:
        return i, -r
    return -i, r


def _twiddles(wr, wi, L, step, blocks):
    """W[l * step] for the L column blocks of a sweep, shaped to broadcast
    against a state (..., L, r): (1, L, 1) from a strided slice of the
    table, or, where ``blocks`` gives each block's global index (a pass-2
    sub-problem's l0 + n1 l), (..., L, 1) gathered at those indices."""
    if blocks is None:
        return (wr[:, 0:L * step:step][:, :, None],
                wi[:, 0:L * step:step][:, :, None])
    idx = blocks * step
    return wr[0][idx][..., None], wi[0][idx][..., None]


def _radix2_stage(yr, yi, wr, wi, L, r, n, blocks=None):
    """One Stockham radix-2 sweep: (..., L, r) -> (..., 2L, r/2).

    L is the global block count (it sets the twiddle stride n / 2L); the
    state may hold fewer blocks per row when ``blocks`` names them."""
    half = r // 2
    er, ei = yr[..., :half], yi[..., :half]
    orr, oii = yr[..., half:], yi[..., half:]
    twr, twi = _twiddles(wr, wi, L, n // (2 * L), blocks)
    tr, ti = _cmul(twr, twi, orr, oii)
    outr = torch.cat([er + tr, er - tr], dim=-2)
    outi = torch.cat([ei + ti, ei - ti], dim=-2)
    return outr, outi


def _radix4_stage(yr, yi, wr, wi, L, r, n, sign: float, blocks=None):
    """One Stockham radix-4 sweep: (..., L, r) -> (..., 4L, r/4).

    U[l + m L'] = sum_j w4^{jm} T_j,  T_j = W_n^{j l (n/4L)} E_j[l],
    with E_j = A[..., j*r/4 : (j+1)*r/4] and L' = 4L blocks concatenated.
    """
    q = r // 4
    s = n // (4 * L)
    e = [(yr[..., j * q:(j + 1) * q], yi[..., j * q:(j + 1) * q])
         for j in range(4)]
    t = [e[0]]
    for j in (1, 2, 3):
        twr, twi = _twiddles(wr, wi, L, j * s, blocks)
        t.append(_cmul(twr, twi, e[j][0], e[j][1]))
    (t0r, t0i), (t1r, t1i), (t2r, t2i), (t3r, t3i) = t
    a_r, a_i = t0r + t2r, t0i + t2i      # T0 + T2
    b_r, b_i = t0r - t2r, t0i - t2i      # T0 - T2
    c_r, c_i = t1r + t3r, t1i + t3i      # T1 + T3
    d_r, d_i = t1r - t3r, t1i - t3i      # T1 - T3
    id_r, id_i = _mul_i(d_r, d_i, sign)  # (+-i)(T1 - T3)
    outr = torch.cat([a_r + c_r, b_r + id_r, a_r - c_r, b_r - id_r], dim=-2)
    outi = torch.cat([a_i + c_i, b_i + id_i, a_i - c_i, b_i - id_i], dim=-2)
    return outr, outi


def stockham_stages(xr, xi, wr, wi, *, n: int, inverse: bool, radix: int):
    """Run all Stockham sweeps on (B, n) planes; the inverse scales by 1/n.

    wr, wi: (1, n) fp32 master table (already conjugated for inverse).
    Radix 4 runs one radix-2 sweep first when log2 n is odd.
    """
    sign = 1.0 if inverse else -1.0
    b = xr.shape[0]
    yr = xr.reshape(b, 1, n)
    yi = xi.reshape(b, 1, n)
    L, r = 1, n
    if radix == 4 and _log2(n) % 2 == 1:
        yr, yi = _radix2_stage(yr, yi, wr, wi, L, r, n)
        L, r = 2 * L, r // 2
    while r > 1:
        if radix == 4 and r % 4 == 0:
            yr, yi = _radix4_stage(yr, yi, wr, wi, L, r, n, sign)
            L, r = 4 * L, r // 4
        else:
            yr, yi = _radix2_stage(yr, yi, wr, wi, L, r, n)
            L, r = 2 * L, r // 2
    yr = yr.reshape(b, n)
    yi = yi.reshape(b, n)
    if inverse:
        yr, yi = yr * (1.0 / n), yi * (1.0 / n)
    return yr, yi


# ---------------------------------------------------------------------------
# The two-pass schedule (fft_planes and rfft_planes)
#
# The Stockham state A(L, r) splits at L = n1 (n = n1 n2) without changing a
# single operation. The sweeps from L = 1 up to n1 keep the column index q
# modulo n2, so they are n2 independent n1-point sub-problems: sub-problem
# q0 reads x[q0 + k n2] (k < n1) and ends as A[l n2 + q0]. The sweeps from
# n1 up to n keep the block index l modulo n1, so they are n1 independent
# n2-point sub-problems: sub-problem l0 starts as the slice
# A[l0 n2 : (l0 + 1) n2] and ends as y[l0 + k n1]; its twiddles take the
# global block index l = l0 + n1 l' (the four-step twiddle, folded into the
# sweeps). Each pass is one launch whose CTAs hold a few whole
# sub-problems in shared memory, so device memory sees the input, one
# intermediate row per row and the output once each, and every SM has work.
# n1 must be an L that the sweep sequence passes through; another split
# gives a different result.
# ---------------------------------------------------------------------------

#: Longest sub-problem one CTA of a pass holds (two ping-pong buffers of
#: 8192 complex fp32 points: 128 KB of shared memory). Where pass 2 holds
#: each sub-problem beside others -- its mirror (the rfft), b's (the
#: complex product), or its mirror and the pair's second row's two (the
#: real product) -- its sub-problems are that many times shorter at most
#: (``two_pass_split``).
TWO_PASS_MAX_SUB = 8192
#: Points a CTA of a pass holds (sub-problems x length): 4096 complex
#: points, 16 in the registers of each of 256 threads and 32 KB in each
#: shared buffer; a sub-problem longer than that runs alone in its CTA.
TWO_PASS_CTA_POINTS = 4096
#: Most sub-problems one CTA takes: 16 consecutive ones, so a strided load
#: or store moves runs of 16 contiguous floats (64 bytes).
TWO_PASS_MAX_SLOTS = 16
#: Least n at which each wrapper takes the two-pass schedule (the products:
#: their split-pass schedule, ``kernels.polymul`` and, for the exact
#: products, ``kernels.ntt``); below it a row stays resident in one CTA.
#: Above n = 8192 no float row fits one CTA (above 4096 for the products,
#: which hold two spectra; above 8192 for the NTT products, above 16384
#: for the NTT), so the threshold only matters at the resident sizes. It
#: comes from chip_smoke.py phase 4's A/B of the schedules (lines "[ab]":
#: batch 64, the planner's radix, in turns) on an NVIDIA H100 80GB HBM3 at
#: 700 W, whose runs and times PERF.md records: two passes were faster at
#: n = 8192 for every kernel, and at n = 4096 for the real product and the
#: NTT product (slower there for the fft, the rfft and the irfft, within
#: the turns' spread for the complex product), so those stay resident at
#: 4096. The NTT's two passes were faster from 2048 on, forward and
#: inverse (at 1024 neither schedule won both directions). The RNS
#: product (k = 9 limbs) took its split where it beat the register steps:
#: at 8192 and above (the register steps won at 4096, today's single-CTA
#: kernel lost at every length from 32 on).
TWO_PASS_FROM = {"fft": 8192, "rfft": 8192, "irfft": 8192,
                 "polymul_complex": 8192, "polymul_real": 4096,
                 "ntt_polymul": 4096, "ntt_batched": 2048,
                 "rns_ntt_polymul": 8192}
#: Least n at which ``kernels.ntt.rns_ntt_polymul`` takes its register-step
#: schedule (one CTA per row and limb) below its split; below it, and
#: where the two rows do not fit one CTA, it runs its single-CTA kernel.
#: From the same A/B (k = 9): the register steps were faster from 32
#: points on, within the turns' spread at 16, slower at 8 and below.
REGISTER_STEPS_FROM = {"rns_ntt_polymul": 32}


@dataclasses.dataclass(frozen=True)
class TwoPass:
    """A two-pass launch: n = n1 n2, and the sub-problems each CTA of pass
    1 (``c1``, of n1 points) and of pass 2 (``c2``, of n2 points; for the
    rfft, ``c2`` low sub-problems and their mirrors) holds."""
    n1: int
    n2: int
    c1: int
    c2: int

    @property
    def launches(self) -> int:
        return 2


def two_pass_split(n: int, radix: int, *, real: bool = False,
                   product: bool = False) -> tuple[int, int] | None:
    """(n1, n2) with n1 on the sweep sequence (radix 4: 4, 16, ... for even
    log2 n, 2, 8, ... for odd; radix 2: any power of two), both at least 2,
    n1 <= TWO_PASS_MAX_SUB and n2 <= TWO_PASS_MAX_SUB / h, where pass 2
    holds h sub-problems for each of its own (the fft 1, the rfft and the
    complex product 2, the real product 4), n1 as close to sqrt(n) as that
    allows, the smaller n1 on a tie; None when no split qualifies."""
    lg = _log2(n)
    cap2 = TWO_PASS_MAX_SUB // ((2 if real else 1) * (2 if product else 1))
    best = None
    for lg1 in range(1, lg):
        n1, n2 = 1 << lg1, 1 << (lg - lg1)
        if radix == 4 and (lg - lg1) % 2:
            continue                      # n1 off the radix-4 sequence
        if n1 > TWO_PASS_MAX_SUB or n2 > cap2:
            continue
        key = (abs(lg - 2 * lg1), lg1)
        if best is None or key < best[0]:
            best = (key, (n1, n2))
    return None if best is None else best[1]


@functools.lru_cache(maxsize=256)
def two_pass_plan(n: int, radix: int, *, real: bool = False
                  ) -> TwoPass | None:
    """The two-pass launch ``fft_planes`` (``rfft_planes`` if ``real``)
    makes for n-point rows, or None where it runs one CTA per row block:
    below ``TWO_PASS_FROM``, and where no split qualifies (past 2^25 or
    2^26 points; a single CTA then stages its sweeps through device
    memory)."""
    if n < TWO_PASS_FROM["rfft" if real else "fft"]:
        return None
    split = two_pass_split(n, radix, real=real)
    return None if split is None else two_pass_launch(*split, real=real)


@functools.lru_cache(maxsize=256)
def irfft_two_pass_plan(n: int, radix: int) -> TwoPass | None:
    """The two-pass launch ``irfft_planes`` makes for n-point rows, or None
    where it runs one CTA per row block: below ``TWO_PASS_FROM["irfft"]``,
    and where no split qualifies. The split is the rfft's (the same
    transform run backwards); neither pass holds mirrors, so each CTA takes
    as many sub-problems as the fft's passes."""
    if n < TWO_PASS_FROM["irfft"]:
        return None
    split = two_pass_split(n, radix, real=True)
    return None if split is None else two_pass_launch(*split)


def pass_slots(m: int, avail: int, held: int = 1) -> int:
    """Sub-problems of m points a pass CTA takes, out of ``avail``, where it
    holds ``held`` sub-problems for each one it takes: as many as
    ``TWO_PASS_CTA_POINTS`` and ``TWO_PASS_MAX_SLOTS`` allow, at least
    one."""
    most = min(TWO_PASS_MAX_SLOTS, TWO_PASS_CTA_POINTS // m) // held
    return max(1, min(most, avail))


def two_pass_launch(n1: int, n2: int, *, real: bool = False) -> TwoPass:
    """Sub-problems per CTA for the split (n1, n2): as many as
    ``TWO_PASS_CTA_POINTS`` allows, at most ``TWO_PASS_MAX_SLOTS`` and at
    most the pass's sub-problems (for the rfft's pass 2, half of n1, each
    with its mirror beside it)."""
    return TwoPass(n1, n2, pass_slots(n1, n2),
                   pass_slots(n2, n1 // 2, 2) if real else pass_slots(n2, n1))


def pass2_twiddle_index(n: int, n1: int, radix: int) -> np.ndarray:
    """Where pass 2's twiddles lie in the master table, in the order its
    kernels read them: the sweep at local L (global L = n1 L, radix R)
    uses W[(l0 + n1 l) m' n2 / (R L)] for m' < R, l < L and sub-problem l0,
    at entry n1 (L - 1) + ((m' - 1) L + l) n1 + l0 -- sweep after sweep, l0
    fastest, so the consecutive sub-problems of a CTA read consecutive
    entries. n1 (n2 - 1) indices."""
    n2 = n // n1
    parts, L = [], 1
    while L < n2:
        m = np.arange(1, radix)[:, None, None]
        l = np.arange(L)[None, :, None]
        l0 = np.arange(n1)[None, None, :]
        parts.append(((l0 + n1 * l) * m * (n2 // (radix * L))).reshape(-1))
        L *= radix
    return np.concatenate(parts)


def pass2_twiddles(n: int, n1: int, radix: int, *, inverse: bool = False
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Pass 2's twiddles (``pass2_twiddle_index``), each the master table's
    own fp32 value."""
    wr, wi = twiddle_table(n, inverse=inverse)
    idx = pass2_twiddle_index(n, n1, radix)
    return wr[0, idx], wi[0, idx]


@functools.lru_cache(maxsize=64)
def device_pass2_twiddles(n: int, n1: int, radix: int, inverse: bool,
                          device: torch.device) -> torch.Tensor:
    """``pass2_twiddles`` as one (2, n1 (n2 - 1)) fp32 tensor on
    ``device``, cached as ``device_twiddles`` is."""
    return torch.from_numpy(np.stack(pass2_twiddles(
        n, n1, radix, inverse=inverse))).to(device)


def _sweeps(yr, yi, wr, wi, *, n: int, r: int, radix: int, sign: float,
            n1: int | None = None):
    """Every sweep of r-point sub-problems, states (..., 1, r) -> (..., r,
    1), in the order the whole transform runs them. Pass 1 (``n1`` None):
    the local block index is the global one. Pass 2: the state is
    (B, n1, 1, r), sub-problem l0 = its index on axis 1, global block
    l = l0 + n1 l', and global L = n1 L'."""
    def blocks(L):
        if n1 is None:
            return None
        l0 = torch.arange(n1, device=yr.device)[:, None]
        return l0 + n1 * torch.arange(L, device=yr.device)[None, :]

    scale = 1 if n1 is None else n1
    L = 1
    if radix == 4 and _log2(r) % 2 == 1:
        yr, yi = _radix2_stage(yr, yi, wr, wi, scale * L, r, n, blocks(L))
        L, r = 2 * L, r // 2
    while r > 1:
        if radix == 4 and r % 4 == 0:
            yr, yi = _radix4_stage(yr, yi, wr, wi, scale * L, r, n, sign,
                                   blocks(L))
            L, r = 4 * L, r // 4
        else:
            yr, yi = _radix2_stage(yr, yi, wr, wi, scale * L, r, n,
                                   blocks(L))
            L, r = 2 * L, r // 2
    return yr, yi


def pass1_plain(xr, xi, wr, wi, *, n: int, n1: int, radix: int,
                sign: float):
    """Pass 1 on (B, n) planes: sub-row q0 = x[q0 :: n2] through the sweeps
    from L = 1 to n1, scattered back at stride n2 into the intermediate A
    (B, n), A[l n2 + q0]."""
    b, n2 = xr.shape[0], n // n1

    def gather(p):      # sub-row q0 = p[q0 :: n2], as (B n2, 1, n1)
        return p.reshape(b, n1, n2).transpose(1, 2).reshape(b * n2, 1, n1)

    yr, yi = _sweeps(gather(xr), gather(xi), wr, wi, n=n, r=n1, radix=radix,
                     sign=sign)
    return tuple(p.reshape(b, n2, n1).transpose(1, 2).reshape(b, n)
                 for p in (yr, yi))


def pass2_plain(ar, ai, wr, wi, *, n: int, n1: int, radix: int,
                sign: float):
    """Pass 2 on intermediates A (B, n): sub-row l0 = A[l0 n2 : (l0 + 1)
    n2] through the sweeps from L = n1 to n, twiddles from the global block
    index. Returns (B, n1, n2): element k of sub-problem l0 is bin
    l0 + k n1 (``natural`` puts it in place)."""
    b, n2 = ar.shape[0], n // n1
    yr, yi = _sweeps(ar.reshape(b, n1, 1, n2), ai.reshape(b, n1, 1, n2), wr,
                     wi, n=n, r=n2, radix=radix, sign=sign, n1=n1)
    return yr.reshape(b, n1, n2), yi.reshape(b, n1, n2)


def natural(p):
    """Pass 2's (B, n1, n2) sub-problems in natural order: y[l0 + k n1]."""
    b = p.shape[0]
    return p.transpose(1, 2).reshape(b, -1)


def stockham_two_pass(xr, xi, wr, wi, *, n: int, inverse: bool, radix: int,
                      n1: int):
    """Plain mirror of the two-pass kernels on (B, n) planes: the very
    sweeps of ``stockham_stages`` split at L = n1, in the kernels' layout,
    so the result equals it bit for bit (for n1 on the sweep sequence).

    Pass 1 runs (B n2, n1) sub-rows gathered at stride n2 and scatters them
    back to the intermediate A at stride n2; pass 2 runs (B n1, n2)
    contiguous sub-rows of A with twiddles from the global block index and
    scatters them to y at stride n1. The inverse scales by 1/n on the
    store.
    """
    sign = 1.0 if inverse else -1.0
    ar, ai = pass1_plain(xr, xi, wr, wi, n=n, n1=n1, radix=radix, sign=sign)
    yr, yi = (natural(p) for p in pass2_plain(ar, ai, wr, wi, n=n, n1=n1,
                                              radix=radix, sign=sign))
    if inverse:
        yr, yi = yr * (1.0 / n), yi * (1.0 / n)
    return yr, yi


def mirror_slots(n1: int, c: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 2 of the rfft: the sub-problems (l0) each CTA holds and, per
    slot, the slot of its mirror (n1 - l0) mod n1, as (n1 / 2c, 2c) arrays.
    CTA g holds l0 = g c + t in slot t (t < c) and its mirror n1 - l0 in
    slot c + t; the two that are their own mirrors, 0 and n1 / 2, sit in
    CTA 0's slots 0 and c. Every l0 < n1 is held exactly once."""
    g = torch.arange(n1 // (2 * c))[:, None]
    t = torch.arange(c)[None, :]
    low = g * c + t
    high = torch.where(low == 0, n1 // 2, n1 - low)
    slots = torch.arange(2 * c).expand(len(g), 2 * c)
    mirror = torch.where(slots < c, slots + c, slots - c)
    own = (g == 0) & ((slots == 0) | (slots == c))
    return torch.cat([low, high], 1), torch.where(own, slots, mirror)


def rfft_two_pass(x, *, radix: int, plan: TwoPass):
    """Plain mirror of the two-pass rfft on real rows (B, n): rows
    (2j, 2j+1) ride z = a + ib through ``stockham_two_pass``, and the
    Hermitian split and packed-Nyquist store run as pass 2's epilogue does:
    bin k = l0 + n1 l' (l' < n2 / 2) of slot s pairs with bin n - k of the
    mirror slot (``mirror_slots``), and Z_{n/2} lies in sub-problem 0. The
    split's float expressions are ``hermitian_split``'s, so the result
    equals ``rfft_planes_plain`` bit for bit."""
    b, n = x.shape
    nh, n1, n2 = n // 2, plan.n1, plan.n2
    if b % 2:
        x = torch.cat([x, torch.zeros_like(x[:1])])
    bp = x.shape[0]
    z = x.reshape(bp // 2, 2, n)
    wr, wi = device_twiddles(n, False, x.device)
    zr, zi = stockham_two_pass(z[:, 0], z[:, 1], wr, wi, n=n, inverse=False,
                               radix=radix, n1=n1)
    l0, ms = (t.to(x.device) for t in mirror_slots(n1, plan.c2))
    lp = torch.arange(n2 // 2, device=x.device)
    k = l0[..., None] + n1 * lp                     # (G, 2c, n2 / 2)
    mk = (n - k) & (n - 1)
    mirror = torch.gather(l0, 1, ms)[..., None] + n1 * (mk // n1)
    k, mirror = k.flatten(), mirror.flatten()
    z_r, z_i, m_r, m_i = zr[:, k], zi[:, k], zr[:, mirror], zi[:, mirror]
    dc = k == 0
    yr = torch.empty((bp // 2, 2, nh), dtype=x.dtype, device=x.device)
    yi = torch.empty_like(yr)
    yr[:, 0, k] = 0.5 * (m_r + z_r)
    yi[:, 0, k] = torch.where(dc, 0.5 * (zr[:, nh:nh + 1] + zr[:, nh:nh + 1]),
                              0.5 * (-m_i + z_i))
    yr[:, 1, k] = 0.5 * (m_i + z_i)
    yi[:, 1, k] = torch.where(dc, 0.5 * (zi[:, nh:nh + 1] + zi[:, nh:nh + 1]),
                              0.5 * (m_r - z_r))
    return yr.reshape(bp, nh)[:b], yi.reshape(bp, nh)[:b]


def unpacked_bins(xr, xi, kk):
    """Bins kk of the full spectra A and B of packed pairs (P, 2, n/2), as
    ``irfft_kernel`` and ``irfft_pass1_kernel`` form them in their load,
    one bin at a time from one packed bin of each spectrum: (pr[kk],
    pi[kk]) below n/2 (imaginary part 0 at DC), pi[0] at the Nyquist bin,
    (pr[n-kk], -pi[n-kk]) above it. Returns Z = A + iB at kk."""
    nh = xr.shape[-1]
    n = 2 * nh
    src = torch.where(kk == nh, 0, torch.where(kk < nh, kk, n - kk))
    xr, xi = xr[..., src], xi[..., src]
    ar = torch.where(kk == nh, xi[:, 0], xr[:, 0])
    br = torch.where(kk == nh, xi[:, 1], xr[:, 1])
    real_bin = (kk == 0) | (kk == nh)
    zero = torch.zeros((), dtype=xr.dtype, device=xr.device)
    ai = torch.where(real_bin, zero, torch.where(kk < nh, xi[:, 0], -xi[:, 0]))
    bi = torch.where(real_bin, zero, torch.where(kk < nh, xi[:, 1], -xi[:, 1]))
    return ar - bi, ai + br


def irfft_two_pass(xr, xi, *, radix: int, plan: TwoPass):
    """Plain mirror of the two-pass irfft on packed planes (B, n/2): pass
    1's load forms element k of sub-problem q0 as bin q0 + k n2 of
    Z = A + iB of spectra (2j, 2j+1), each bin from one packed bin of each
    spectrum (``unpacked_bins``); the inverse sweeps run split at n1
    (``stockham_two_pass``, 1/n on the store); pass 2 stores Re z to row 2j
    and Im z to row 2j+1. An odd batch pairs its last spectrum with a zero
    spectrum. The float expressions are ``irfft_planes_plain``'s, so the
    result equals it bit for bit."""
    b, nh = xr.shape
    n = 2 * nh
    if b % 2:
        xr = torch.cat([xr, torch.zeros_like(xr[:1])])
        xi = torch.cat([xi, torch.zeros_like(xi[:1])])
    bp = xr.shape[0]
    kk = torch.arange(n, device=xr.device)
    zr, zi = unpacked_bins(xr.reshape(bp // 2, 2, nh),
                           xi.reshape(bp // 2, 2, nh), kk)
    wr, wi = device_twiddles(n, True, xr.device)
    yr, yi = stockham_two_pass(zr, zi, wr, wi, n=n, inverse=True,
                               radix=radix, n1=plan.n1)
    return torch.stack([yr, yi], dim=1).reshape(bp, n)[:b]


# ---------------------------------------------------------------------------
# Shared-memory planning: rows per CTA, and whether they stay on chip.
#
# A CTA keeps its rows in two ping-pong buffers, so a complex row costs 16n
# bytes of shared memory and a real row (half of a packed complex row) 8n.
# The products hold both operands' spectra: twice that.
# ---------------------------------------------------------------------------

#: Shared memory one CTA may opt into on Hopper (227 KB).
SMEM_MAX_BYTES = 232448
#: Budget for the planned batch block: the per-CTA limit that needs no
#: opt-in, so CTAs of short rows stay small and several share an SM.
SMEM_BLOCK_BUDGET = 48 * 1024
#: Most rows one CTA holds (twice that in real mode).
MAX_BLOCK = 1024
_BUFFERS = 2


def smem_bytes(n: int, block: int, *, real: bool = False,
               product: bool = False) -> int:
    """Shared memory of a CTA holding ``block`` rows of n points."""
    per_row = (1 if real else 2) * n * 4 * _BUFFERS
    return block * per_row * (2 if product else 1)


def plan_batch_block(n: int, *, real: bool = False) -> int:
    """Largest power-of-two batch block whose working set fits the block
    budget (at least one row, or one row pair in real mode).

    ``real=True`` is the two-for-one packed mode: two real rows share one
    complex working row, so the per-row footprint halves and both the
    derived block and its cap double.
    """
    per_row = smem_bytes(n, 1, real=real)
    max_block = 2 * MAX_BLOCK if real else MAX_BLOCK
    blk = SMEM_BLOCK_BUDGET // per_row
    blk = max(2 if real else 1, min(max_block, blk))
    return 1 << (blk.bit_length() - 1)


def _fit_block(blk: int, batch: int, *, even: bool = False) -> int:
    """Shrink a planned batch block to the actual batch (next power of two
    >= batch), so a small batch runs in fewer, fuller CTAs: the planned
    block is a cap, not a minimum. ``even=True`` keeps the two-for-one
    pairing invariant."""
    cap = 1 << max(0, batch - 1).bit_length()
    blk = min(blk, max(1, cap))
    return max(2, blk) if even else blk


def cta_rows(n: int, batch: int, block: int, *, real: bool = False,
             product: bool = False) -> tuple[int, bool]:
    """(rows per CTA, staged) for a launch.

    ``block`` is a cap: it shrinks to the batch, then halves while the CTA's
    working set exceeds ``SMEM_MAX_BYTES``. When even the least block (one
    row, or one row pair in real mode) does not fit, ``staged`` is True and
    the kernel runs the same sweeps on a device-memory scratch.
    """
    if block < 1 or (real and block % 2):
        raise ValueError(f"block={block}: need a block >= 1"
                         + (", even for two-for-one packing" if real else ""))
    return fit_smem(lambda blk: smem_bytes(n, blk, real=real,
                                           product=product),
                    _fit_block(block, batch, even=real), 2 if real else 1)


def fit_smem(bytes_of, blk: int, least: int) -> tuple[int, bool]:
    """Halve ``blk`` while a CTA of ``blk`` rows needs more than
    ``SMEM_MAX_BYTES`` (``bytes_of(blk)``), down to ``least`` rows; returns
    (rows per CTA, staged), staged when even ``least`` rows do not fit."""
    while blk > least and bytes_of(blk) > SMEM_MAX_BYTES:
        blk //= 2
    return blk, bytes_of(blk) > SMEM_MAX_BYTES


def resident(n: int, *, real: bool = False, product: bool = False) -> bool:
    """Whether a row (a row pair in real mode) stays in shared memory."""
    least = 2 if real else 1
    return smem_bytes(n, least, real=real, product=product) <= SMEM_MAX_BYTES


# ---------------------------------------------------------------------------
# Real-input fast path: two-for-one packed rfft (paper Eq. (10)).
#
# Packed-Nyquist layout of a real row's spectrum (n/2 complex bins):
#   P[0] = X[0].re + i * X[n/2].re     (DC and Nyquist are both real)
#   P[k] = X[k]                        (1 <= k < n/2)
# ---------------------------------------------------------------------------

def _roll1(x):
    """roll(x, 1) along the last axis."""
    return torch.cat([x[..., -1:], x[..., :-1]], dim=-1)


def _reverse_mod_n(xr, xi):
    """(Z_k) -> (Z_{n-k}), indices mod n: flip then rotate so k=0 stays."""
    return _roll1(torch.flip(xr, dims=[-1])), _roll1(torch.flip(xi, dims=[-1]))


def hermitian_split(zr, zi):
    """Split Z = FFT(a + i b) of two real rows into their spectra (Eq. (10)).

    A_k = (Z_k + conj(Z_{n-k})) / 2,  B_k = -i (Z_k - conj(Z_{n-k})) / 2.
    The results are EXACTLY Hermitian in fp32 (each component of A_{n-k} is
    the same float expression as +-A_k's), which is what lets the paired
    inverse in kernels/polymul.py split two real products per transform.
    """
    zrr, zri = _reverse_mod_n(zr, zi)
    ar = 0.5 * (zrr + zr)
    ai = 0.5 * (-zri + zi)
    br = 0.5 * (zri + zi)
    bi = 0.5 * (zrr - zr)
    return ar, ai, br, bi


def _pack_half(sr, si, nh: int):
    """Full Hermitian spectrum planes (B, n) -> packed-Nyquist (B, nh)."""
    pr = sr[:, :nh]
    pi = torch.cat([sr[:, nh:nh + 1], si[:, 1:nh]], dim=1)
    return pr, pi


def _unpack_full(pr, pi, n: int):
    """Packed-Nyquist half-spectrum (B, n/2) -> full Hermitian planes (B, n).

    Mirror bins k in (n/2, n) are conj(P[n-k]); DC/Nyquist imag parts are
    structurally zero.
    """
    zero = torch.zeros_like(pr[:, :1])
    head_i = torch.cat([zero, pi[:, 1:]], dim=1)          # im, bins < n/2
    tail_r = torch.flip(pr[:, 1:], dims=[1])              # re, bins > n/2
    tail_i = -torch.flip(pi[:, 1:], dims=[1])
    fr = torch.cat([pr, pi[:, :1], tail_r], dim=1)        # Nyquist at n/2
    fi = torch.cat([head_i, zero, tail_i], dim=1)
    return fr, fi


# ---------------------------------------------------------------------------
# Plain versions and kernel wrappers
# ---------------------------------------------------------------------------

def check_planes(name: str, *planes: torch.Tensor) -> tuple[int, int]:
    """Raise unless the planes are what the kernels take: 2-D fp32, one
    shape, contiguous, on the CPU or one CUDA device. Returns (B, n)."""
    ref = planes[0]
    if ref.ndim != 2:
        raise ValueError(f"{name}: expected (batch, n) planes, got "
                         f"shape {tuple(ref.shape)}")
    for p in planes:
        if p.device != ref.device:
            raise ValueError(f"{name}: planes on {p.device} and {ref.device}")
        if p.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32 planes, got {p.dtype}")
        if p.shape != ref.shape:
            raise ValueError(f"{name}: plane shapes {tuple(p.shape)} and "
                             f"{tuple(ref.shape)} differ")
        if not p.is_contiguous():
            raise ValueError(f"{name}: planes must be contiguous")
    if ref.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: no kernel for device {ref.device}")
    b, n = ref.shape
    _log2(n)
    return b, n


def check_radix(radix: int) -> None:
    if radix not in (2, 4):
        raise ValueError(f"radix={radix}: the kernels run radix 2 or 4")


def scratch_for(n: int, batch: int, rows: int, staged: bool,
                device: torch.device, *, real: bool = False,
                product: bool = False) -> torch.Tensor | None:
    """Device-memory ping-pong buffers for a staged launch (one slice per
    CTA); None when the rows stay in shared memory."""
    if not staged:
        return None
    grid = -(-batch // rows)
    floats = grid * smem_bytes(n, rows, real=real, product=product) // 4
    return torch.empty(floats, dtype=torch.float32, device=device)


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def fft_planes_plain(xr, xi, *, inverse: bool = False, radix: int = 2):
    """Plain version of ``fft_planes``: the same sweeps as torch ops."""
    n = xr.shape[1]
    wr, wi = device_twiddles(n, inverse, xr.device)
    return stockham_stages(xr, xi, wr, wi, n=n, inverse=inverse, radix=radix)


def fft_planes(xr: torch.Tensor, xi: torch.Tensor, *, inverse: bool = False,
               radix: int = 2, block_b: int | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched FFT (or inverse FFT, scaled by 1/n) on split planes (B, n).

    On the card: kernel ``fft_kernel`` -- from ``TWO_PASS_FROM["fft"]``
    points on, its two-pass schedule (``two_pass_plan``: two launches, an
    intermediate row per row), below that one CTA per ``block_b`` rows at
    most (default ``plan_batch_block``), fitted to the batch. On the CPU the
    plain version of the same schedule; on the ``meta`` device planes of the
    result's shape, nothing computed. Replaces
    ``repro/kernels/fft.py::fft_planes``.
    """
    with spans.span("repro_torch.glue/fft_planes"):
        b, n = check_planes("fft_planes", xr, xi)
        check_radix(radix)
        two_pass = two_pass_plan(n, radix)
        if xr.device.type == "meta":
            return torch.empty_like(xr), torch.empty_like(xi)
        if xr.device.type == "cpu":
            if two_pass is not None:
                wr, wi = device_twiddles(n, inverse, xr.device)
                return stockham_two_pass(xr, xi, wr, wi, n=n, inverse=inverse,
                                         radix=radix, n1=two_pass.n1)
            return fft_planes_plain(xr, xi, inverse=inverse, radix=radix)
        _build.refuse_grad("fft_planes", xr, xi)
        return _launch_fft(xr, xi, inverse, radix,
                           block_b or plan_batch_block(n), two_pass)


def _launch_fft(xr, xi, inverse: bool, radix: int, block: int,
                two_pass: TwoPass | None):
    """Launch ``stockham_fft`` on card planes under the given schedule:
    ``two_pass``, or one CTA per ``block`` rows at most."""
    b, n = xr.shape
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    if b == 0:
        return yr, yi
    with torch.cuda.device(xr.device):
        wr, wi = device_twiddles(n, inverse, xr.device)
        if two_pass is None:
            rows, staged = cta_rows(n, b, block)
            scratch = scratch_for(n, b, rows, staged, xr.device)
            tw2, split = None, (0, 0, 0)
        else:
            rows = 1
            scratch = torch.empty((2, b, n), dtype=xr.dtype,
                                  device=xr.device)
            tw2 = device_pass2_twiddles(n, two_pass.n1, radix, inverse,
                                        xr.device)
            split = (_log2(two_pass.n1), _log2(two_pass.c1),
                     _log2(two_pass.c2))
        _build.launch("stockham_fft", "fft_planes", ptr(xr), ptr(xi),
                      ptr(yr), ptr(yi), ptr(wr), ptr(wi), ptr(scratch),
                      ptr(tw2), b, _log2(n), radix, int(inverse), rows,
                      *split)
    return yr, yi


def rfft_planes_plain(x, *, radix: int = 2):
    """Plain version of ``rfft_planes``: pairs rows (2j, 2j+1) as a + ib,
    padding an odd batch with one zero row."""
    b, n = x.shape
    nh = n // 2
    if b % 2:
        x = torch.cat([x, torch.zeros_like(x[:1])])
    bp = x.shape[0]
    z = x.reshape(bp // 2, 2, n)
    wr, wi = device_twiddles(n, False, x.device)
    zr, zi = stockham_stages(z[:, 0, :], z[:, 1, :], wr, wi, n=n,
                             inverse=False, radix=radix)
    ar, ai, br, bi = hermitian_split(zr, zi)
    par, pai = _pack_half(ar, ai, nh)
    pbr, pbi = _pack_half(br, bi, nh)
    yr = torch.stack([par, pbr], dim=1).reshape(bp, nh)
    yi = torch.stack([pai, pbi], dim=1).reshape(bp, nh)
    return yr[:b], yi[:b]


def rfft_planes(x: torch.Tensor, *, radix: int = 2,
                block_b: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed half-spectrum FFT of real rows: (B, n) -> planes (B, n//2).

    On the card: kernel ``rfft_kernel`` -- from ``TWO_PASS_FROM["rfft"]``
    points on, its two-pass schedule, with the Hermitian split in pass 2's
    epilogue; below that an even number of rows per CTA (default
    ``plan_batch_block(n, real=True)``). An odd batch pairs its last row
    with a zero row. On the CPU the plain version of the same schedule.
    Replaces ``repro/kernels/fft.py::rfft_planes``.
    """
    with spans.span("repro_torch.glue/rfft_planes"):
        b, n = check_planes("rfft_planes", x)
        if n < 2:
            raise ValueError(f"rfft_planes: n={n} must be >= 2")
        check_radix(radix)
        two_pass = two_pass_plan(n, radix, real=True)
        if x.device.type in ("cpu", "meta"):
            if two_pass is not None:
                return rfft_two_pass(x, radix=radix, plan=two_pass)
            return rfft_planes_plain(x, radix=radix)
        _build.refuse_grad("rfft_planes", x)
        return _launch_rfft(x, radix,
                            block_b or plan_batch_block(n, real=True),
                            two_pass)


def _launch_rfft(x, radix: int, block: int, two_pass: TwoPass | None):
    """Launch ``stockham_rfft`` on card rows under the given schedule:
    ``two_pass``, or one CTA per ``block`` rows at most."""
    b, n = x.shape
    yr = torch.empty((b, n // 2), dtype=x.dtype, device=x.device)
    yi = torch.empty_like(yr)
    if b == 0:
        return yr, yi
    with torch.cuda.device(x.device):
        wr, wi = device_twiddles(n, False, x.device)
        if two_pass is None:
            rows, staged = cta_rows(n, b, block, real=True)
            scratch = scratch_for(n, b, rows, staged, x.device, real=True)
            tw2, split = None, (0, 0, 0)
        else:
            rows = 2
            scratch = torch.empty((2, (b + 1) // 2, n), dtype=x.dtype,
                                  device=x.device)
            tw2 = device_pass2_twiddles(n, two_pass.n1, radix, False,
                                        x.device)
            split = (_log2(two_pass.n1), _log2(two_pass.c1),
                     _log2(two_pass.c2))
        _build.launch("stockham_rfft", "rfft_planes", ptr(x), ptr(yr),
                      ptr(yi), ptr(wr), ptr(wi), ptr(scratch), ptr(tw2), b,
                      _log2(n), radix, rows, *split)
    return yr, yi


def irfft_planes_plain(xr, xi, *, radix: int = 2):
    """Plain version of ``irfft_planes``: pairs spectra (2j, 2j+1) as
    A + iB, padding an odd batch with one zero spectrum."""
    b, nh = xr.shape
    n = 2 * nh
    if b % 2:
        xr = torch.cat([xr, torch.zeros_like(xr[:1])])
        xi = torch.cat([xi, torch.zeros_like(xi[:1])])
    bp = xr.shape[0]
    pr = xr.reshape(bp // 2, 2, nh)
    pi = xi.reshape(bp // 2, 2, nh)
    ar, ai = _unpack_full(pr[:, 0], pi[:, 0], n)
    br, bi = _unpack_full(pr[:, 1], pi[:, 1], n)
    wr, wi = device_twiddles(n, True, xr.device)
    # Linearity: IFFT(A + i B) = a + i b for real rows a, b.
    yr, yi = stockham_stages(ar - bi, ai + br, wr, wi, n=n, inverse=True,
                             radix=radix)
    return torch.stack([yr, yi], dim=1).reshape(bp, n)[:b]


def irfft_planes(xr: torch.Tensor, xi: torch.Tensor, *, radix: int = 2,
                 block_b: int | None = None) -> torch.Tensor:
    """Inverse of ``rfft_planes``: packed planes (B, n//2) -> real (B, n).

    On the card: kernel ``irfft_kernel`` -- from ``TWO_PASS_FROM["irfft"]``
    points on, its two-pass schedule (``irfft_two_pass_plan``: the
    unpacking in pass 1's load, the split of the two real rows in pass 2's
    store), below that an even number of rows per CTA (default
    ``plan_batch_block(n, real=True)``); two packed half-spectra are
    unpacked in the kernel and ride one inverse complex transform, and an
    odd batch pairs its last spectrum with a zero spectrum. On the CPU the
    plain version of the same schedule. Replaces
    ``repro/kernels/fft.py::irfft_planes``.
    """
    with spans.span("repro_torch.glue/irfft_planes"):
        b, nh = check_planes("irfft_planes", xr, xi)
        n = 2 * nh
        check_radix(radix)
        two_pass = irfft_two_pass_plan(n, radix)
        if xr.device.type in ("cpu", "meta"):
            if two_pass is not None:
                return irfft_two_pass(xr, xi, radix=radix, plan=two_pass)
            return irfft_planes_plain(xr, xi, radix=radix)
        _build.refuse_grad("irfft_planes", xr, xi)
        return _launch_irfft(xr, xi, radix,
                             block_b or plan_batch_block(n, real=True),
                             two_pass)


def _launch_irfft(xr, xi, radix: int, block: int, two_pass: TwoPass | None):
    """Launch ``stockham_irfft`` on card planes under the given schedule:
    ``two_pass``, or one CTA per ``block`` rows at most."""
    b, nh = xr.shape
    n = 2 * nh
    y = torch.empty((b, n), dtype=xr.dtype, device=xr.device)
    if b == 0:
        return y
    with torch.cuda.device(xr.device):
        wr, wi = device_twiddles(n, True, xr.device)
        if two_pass is None:
            rows, staged = cta_rows(n, b, block, real=True)
            scratch = scratch_for(n, b, rows, staged, xr.device, real=True)
            tw2, split = None, (0, 0, 0)
        else:
            rows = 2
            scratch = torch.empty((2, (b + 1) // 2, n), dtype=xr.dtype,
                                  device=xr.device)
            tw2 = device_pass2_twiddles(n, two_pass.n1, radix, True,
                                        xr.device)
            split = (_log2(two_pass.n1), _log2(two_pass.c1),
                     _log2(two_pass.c2))
        _build.launch("stockham_irfft", "irfft_planes", ptr(xr), ptr(xi),
                      ptr(y), ptr(wr), ptr(wi), ptr(scratch), ptr(tw2), b,
                      _log2(n), radix, rows, *split)
    return y
