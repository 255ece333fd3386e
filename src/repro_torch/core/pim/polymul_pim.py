"""In-memory polynomial multiplication (paper §5) on the crossbar simulator.

Port of ``repro.core.pim.polymul_pim``: a numpy copy that imports nothing of
the reference, pinned equal to the original by
``tests/test_torch_pim.py``.

Pipeline (convolution theorem, Eq. (9)):
  (1) FFT of each polynomial's coefficients — WITHOUT the input bit-reversal
      permutations: across DFT.IDFT they cancel (paper §5), so neither the
      forward nor the inverse transform charges them;
  (2) element-wise complex product — one vectored cmul, serial over the
      beta column-units (ceil(beta/p) with partitions);
  (3) inverse FFT with the 1/n scaling absorbed as an exponent decrement.

Real-coefficient variant (Eq. (10)): both forward transforms fold into ONE
complex FFT of z = a + i b; the unpack uses the paper's in-memory tricks —
conjugate = imag sign-bit flip, multiply-by-i = plane swap + sign flip,
divide-by-2 = exponent decrement, Z_{n-k} = order reversal via swaps. Area
also halves (one packed sequence instead of two), which doubles the batch —
both effects feed the paper's observation that real-polymul ratios beat the
FFT ratios.

Paired inverse (this reproduction's batched extension of Eq. (10), mirrored
by kernels/polymul.py): the product spectrum of two real polynomials is
Hermitian, so TWO products pack into one inverse transform as
Q = P_0 + i P_1 — per product that is 1 forward + 1/2 inverse = 1.5
transform-equivalents vs the complex path's 3, the ~2x the serve bench and
the BENCH_fourier.json gate pin at <= 0.65x simulated cycles.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.pim import aritpim
from repro_torch.core.pim.crossbar import Counters, CrossbarSim
from repro_torch.core.pim.device_model import PIMConfig
from repro_torch.core.pim.fft_pim import (PIMFFTResult, _hermitian_split,
                                          fft_latency_cycles, pim_fft,
                                          realpack_unpack_cycles)

# Back-compat alias: the unpack charge moved to fft_pim so pim_rfft and the
# polymul paths share one definition.
_unpack_cycles = realpack_unpack_cycles


@dataclasses.dataclass(frozen=True)
class PIMPolymulResult:
    output: np.ndarray
    counters: Counters


def pim_polymul(a: np.ndarray, b: np.ndarray, cfg: PIMConfig,
                spec: aritpim.FloatSpec, *, faults=None,
                array_id: int = 0) -> PIMPolymulResult:
    """Circular product (length n) on the simulator, complex coefficients."""
    n = len(a)
    beta = max(1, n // (2 * cfg.crossbar_rows))
    serial = math.ceil(beta / cfg.partitions)
    fa = pim_fft(np.asarray(a), cfg, spec, charge_perm=False,
                 faults=faults, array_id=array_id)
    fb = pim_fft(np.asarray(b), cfg, spec, charge_perm=False,
                 faults=faults, array_id=array_id)
    sim = CrossbarSim(cfg, spec)
    prod = fa.output * fb.output
    sim.charge_column_op("cmul", cfg.crossbar_rows, serial=serial)
    inv = pim_fft(prod, cfg, spec, inverse=True, charge_perm=False,
                  faults=faults, array_id=array_id)
    ctr = Counters(
        cycles=fa.counters.cycles + fb.counters.cycles + sim.ctr.cycles
        + inv.counters.cycles,
        gates=fa.counters.gates + fb.counters.gates + sim.ctr.gates
        + inv.counters.gates)
    return PIMPolymulResult(output=inv.output, counters=ctr)


def _real_forward_product(a: np.ndarray, b: np.ndarray, cfg: PIMConfig,
                          spec: aritpim.FloatSpec, serial: int,
                          faults=None,
                          array_id: int = 0) -> tuple[np.ndarray, Counters]:
    """Shared front half of the real paths: packed forward FFT of
    z = a + i b, Hermitian unpack, pointwise product — returns the product
    spectrum and its counters (no inverse transform)."""
    z = np.asarray(a, np.float64) + 1j * np.asarray(b, np.float64)
    fz = pim_fft(z, cfg, spec, charge_perm=False,
                 faults=faults, array_id=array_id)
    sim = CrossbarSim(cfg, spec)
    fa, fb = _hermitian_split(fz.output)
    unpack = realpack_unpack_cycles(cfg, spec)
    sim.ctr.cycles += unpack * serial
    sim.ctr.gates += unpack * serial * cfg.crossbar_rows
    prod = fa * fb
    sim.charge_column_op("cmul", cfg.crossbar_rows, serial=serial)
    ctr = Counters(cycles=fz.counters.cycles + sim.ctr.cycles,
                   gates=fz.counters.gates + sim.ctr.gates)
    return prod, ctr


def _pack_pair_cycles(cfg: PIMConfig, spec: aritpim.FloatSpec) -> int:
    """Charge for packing Q = P_0 + i P_1 before the shared inverse:
    multiply-by-i (half-word swap + sign flip) plus one complex add."""
    word = aritpim.complex_word_bits(spec)
    return (aritpim.swap_cycles(word // 2) + 2
            + aritpim.complex_add_cycles(spec))


def pim_polymul_real(a: np.ndarray, b: np.ndarray, cfg: PIMConfig,
                     spec: aritpim.FloatSpec, *, faults=None,
                     array_id: int = 0) -> PIMPolymulResult:
    """Circular product of REAL polys via Eq. (10): one packed forward FFT
    per product, and — for batched inputs of shape (B, n) — one inverse
    transform per PAIR of products (Q = P_0 + i P_1; both product spectra
    are Hermitian, so Re/Im of IFFT(Q) are the two results).

    1-D inputs keep the legacy single-product pipeline (its own forward AND
    inverse); (B, n) inputs run ceil(B/2) inverse transforms. Counter parity
    for both shapes is pinned in tests/test_pim.py.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    n = a.shape[-1]
    beta = max(1, n // (2 * cfg.crossbar_rows))
    serial = math.ceil(beta / cfg.partitions)
    if a.ndim == 1:
        prod, ctr = _real_forward_product(a, b, cfg, spec, serial,
                                          faults=faults, array_id=array_id)
        inv = pim_fft(prod, cfg, spec, inverse=True, charge_perm=False,
                      faults=faults, array_id=array_id)
        return PIMPolymulResult(
            output=inv.output.real,
            counters=Counters(cycles=ctr.cycles + inv.counters.cycles,
                              gates=ctr.gates + inv.counters.gates))
    assert a.ndim == 2, f"expected (n,) or (B, n), got {a.shape}"
    B = a.shape[0]
    out = np.empty((B, n), np.float64)
    total = Counters()
    for j in range(0, B - 1, 2):
        p0, c0 = _real_forward_product(a[j], b[j], cfg, spec, serial,
                                       faults=faults, array_id=array_id)
        p1, c1 = _real_forward_product(a[j + 1], b[j + 1], cfg, spec, serial,
                                       faults=faults, array_id=array_id)
        sim = CrossbarSim(cfg, spec)
        pack = _pack_pair_cycles(cfg, spec)
        sim.ctr.cycles += pack * serial
        sim.ctr.gates += pack * serial * cfg.crossbar_rows
        q = p0 + 1j * p1
        inv = pim_fft(q, cfg, spec, inverse=True, charge_perm=False,
                      faults=faults, array_id=array_id)
        out[j] = inv.output.real
        out[j + 1] = inv.output.imag
        total.cycles += (c0.cycles + c1.cycles + sim.ctr.cycles
                         + inv.counters.cycles)
        total.gates += (c0.gates + c1.gates + sim.ctr.gates
                        + inv.counters.gates)
    if B % 2:
        res = pim_polymul_real(a[-1], b[-1], cfg, spec,
                               faults=faults, array_id=array_id)
        out[-1] = res.output
        total.cycles += res.counters.cycles
        total.gates += res.counters.gates
    return PIMPolymulResult(output=out, counters=total)


# ---------------------------------------------------------------------------
# Closed forms + throughput/energy (benchmarks)
# ---------------------------------------------------------------------------

def polymul_latency_cycles(n: int, cfg: PIMConfig, spec: aritpim.FloatSpec,
                           *, real: bool = False) -> int:
    """Single-product closed form: ``real=True`` is the legacy unpaired
    Eq. (10) pipeline (1 fwd + 1 inv). The production real path amortizes
    the inverse across pairs — see ``polymul_real_pair_latency_cycles``."""
    beta = max(1, n // (2 * cfg.crossbar_rows))
    serial = math.ceil(beta / cfg.partitions)
    fwd = fft_latency_cycles(n, cfg, spec, charge_perm=False)
    inv = fft_latency_cycles(n, cfg, spec, charge_perm=False, inverse=True)
    total = (1 if real else 2) * fwd + inv
    total += aritpim.complex_mul_cycles(spec) * serial
    if real:
        total += realpack_unpack_cycles(cfg, spec) * serial
    return total


def polymul_real_pair_latency_cycles(n: int, cfg: PIMConfig,
                                     spec: aritpim.FloatSpec) -> int:
    """Closed form for TWO real products through the paired-inverse path:
    2 packed forwards + 2 unpacks + 2 pointwise cmuls + the Q = P_0 + i P_1
    pack + ONE inverse. Per product this is ~1.5 transform-equivalents; the
    ratio ``pair / (2 * complex)`` is the <= 0.65 gate in
    benchmarks/run.py --smoke (BENCH_fourier.json) and tests/test_pim.py.
    Asserted equal to ``pim_polymul_real`` counters on (2, n) inputs."""
    beta = max(1, n // (2 * cfg.crossbar_rows))
    serial = math.ceil(beta / cfg.partitions)
    fwd = fft_latency_cycles(n, cfg, spec, charge_perm=False)
    inv = fft_latency_cycles(n, cfg, spec, charge_perm=False, inverse=True)
    return (2 * fwd + inv
            + 2 * realpack_unpack_cycles(cfg, spec) * serial
            + 2 * aritpim.complex_mul_cycles(spec) * serial
            + _pack_pair_cycles(cfg, spec) * serial)


def polymul_real_batch_latency_cycles(n: int, batch: int, cfg: PIMConfig,
                                      spec: aritpim.FloatSpec) -> int:
    """Closed form for a (batch, n) call to ``pim_polymul_real``: full
    pairs ride the shared inverse, an odd tail product falls back to the
    unpaired pipeline."""
    pairs, tail = divmod(batch, 2)
    total = pairs * polymul_real_pair_latency_cycles(n, cfg, spec)
    if tail:
        total += polymul_latency_cycles(n, cfg, spec, real=True)
    return total


def polymul_area_words(real: bool) -> int:
    """Operand words per element: complex needs a and b resident (2), real
    packs both into one complex sequence (1)."""
    return 1 if real else 2


def polymul_throughput_per_s(n: int, cfg: PIMConfig, spec: aritpim.FloatSpec,
                             *, real: bool = False) -> float:
    """Steady-state products/s. The real path amortizes the paired inverse
    (pair latency / 2 per product) on top of its halved operand area — the
    two effects behind the paper's real-polymul ratios exceeding its FFT
    ratios."""
    word = aritpim.complex_word_bits(spec)
    if real:
        lat = (polymul_real_pair_latency_cycles(n, cfg, spec) / 2
               / cfg.clock_hz)
    else:
        lat = polymul_latency_cycles(n, cfg, spec, real=real) / cfg.clock_hz
    r = cfg.crossbar_rows
    beta = max(1, n // (2 * r))
    data_cols = polymul_area_words(real) * 2 * beta * word
    scratch = cfg.temp_words * word * cfg.partitions
    area = max(1.0, (data_cols + scratch) / cfg.crossbar_cols)
    batch = int(cfg.num_crossbars / area)
    return batch * cfg.concurrency / lat


def polymul_energy_j_per_op(n: int, cfg: PIMConfig, spec: aritpim.FloatSpec,
                            *, real: bool = False) -> float:
    rng = np.random.default_rng(0)
    if real:
        a = rng.standard_normal(n)
        b = rng.standard_normal(n)
        res = pim_polymul_real(a, b, cfg, spec)
    else:
        a = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        res = pim_polymul(a, b, cfg, spec)
    return res.counters.energy_j(cfg)
