"""In-memory FFT algorithms (paper §4): r-, 2r-, and 2r-beta configurations.

Port of ``repro.core.pim.fft_pim``: a numpy copy that imports nothing of
the reference, pinned equal to the original by
``tests/test_torch_pim.py``.

Each algorithm runs on the logical crossbar simulator: the butterfly values
are computed numerically (and checked against numpy.fft in the tests) while
cycle/gate counters accumulate per the AritPIM cost model. Closed-form
latency/energy expressions — used by the large-n benchmarks — are derived
from the same per-group structure and asserted equal to the simulator's
counters in tests/test_pim.py.

Structural model per group g (of log2 n groups), following §4.3-4.5:

  r-FFT   (n = r):   align half the sequence (1 column-parallel word copy +
                     r/2 serial row copies), butterfly on r/2 rows, move back.
  2r-FFT  (n = 2r):  butterfly on all r rows (full utilization); transition =
                     one in-place pair swap: within-row (column-parallel,
                     3N cycles) when the partner shares the row, otherwise
                     r/2 serial row swaps.
  2rb-FFT (n = 2rb): beta column-units execute the group's butterflies
                     serially (ceil(beta/p) with p partitions [25]); unit
                     transitions add column-parallel copies between units.

Twiddle constants are written by the periphery each group (footnote 3),
charged as r/2 row writes.

The input bit-reversal permutation is charged as serial row swaps for FFT
(and skipped for polymul where the permutations cancel, §5) — with Stockham
there is no analogue; this is the memristive layout's own cost.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.pim import aritpim
from repro_torch.core.pim.crossbar import Counters, CrossbarSim
from repro_torch.core.pim.device_model import PIMConfig


def _bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _perm_swap_count(n: int) -> int:
    """Number of 2-cycles in the bit-reversal permutation."""
    rev = _bit_reverse_perm(n)
    return int(np.sum(rev > np.arange(n)))


@dataclasses.dataclass(frozen=True)
class PIMFFTResult:
    output: np.ndarray
    counters: Counters
    #: ordered (tag, cycles) charge records from the simulator, for
    #: counter-ordering assertions (see CrossbarSim.log).
    log: tuple = ()


def _twiddles(n: int, inverse: bool) -> np.ndarray:
    sign = 1.0 if inverse else -1.0
    return np.exp(sign * 2j * np.pi * np.arange(n // 2) / n)


def _fft_groups(sim: CrossbarSim, x: np.ndarray, *, inverse: bool,
                serial_units: int, active_rows: int,
                transition_fn) -> np.ndarray:
    """Shared group loop: iterative DIT butterflies after bit reversal.

    ``transition_fn(stage)`` charges the inter-group data movement of the
    specific configuration. Butterfly values verified numerically.
    """
    n = len(x)
    stages = n.bit_length() - 1
    y = x[_bit_reverse_perm(n)].astype(np.complex128)
    for s in range(stages):
        m = 2 << s            # butterfly span
        half = m >> 1
        # gather pairs (j, j + half) within blocks of m
        idx = np.arange(n).reshape(n // m, m)
        top = idx[:, :half].ravel()
        bot = idx[:, half:].ravel()
        w = np.tile(_twiddles(m, inverse), n // m)
        sim.charge_twiddle_writes(sim.cfg.crossbar_rows // 2)
        transition_fn(s)
        u, v = sim.butterfly_rows(y[top], y[bot], w, active_rows,
                                  serial_units=serial_units)
        y[top], y[bot] = u, v
    if inverse:
        # 1/n scaling: exponent decrement per element (paper §5 trick) —
        # column-parallel copy-scale, one word op.
        sim.charge_column_op("copy", active_rows)
        y = y / n
    return y


def r_fft(x: np.ndarray, cfg: PIMConfig, spec: aritpim.FloatSpec,
          *, inverse: bool = False, charge_perm: bool = True,
          faults=None, array_id: int = 0) -> PIMFFTResult:
    """r-configuration (§4.3): n = crossbar rows, one element per row."""
    n = len(x)
    assert n == cfg.crossbar_rows, f"r-FFT needs n == rows ({cfg.crossbar_rows})"
    sim = CrossbarSim(cfg, spec, faults=faults, array_id=array_id)
    sim.load(x)
    if charge_perm:
        sim.charge_row_ops(_perm_swap_count(n), cycles_per_row=6, tag="perm")

    def transition(stage):
        # shift half right (column-parallel word copy) + r/2 rows up, then
        # back after the butterfly: 2x.
        sim.charge_column_op("copy", n // 2)
        sim.charge_row_ops(n // 2, cycles_per_row=2)
        sim.charge_column_op("copy", n // 2)
        sim.charge_row_ops(n // 2, cycles_per_row=2)

    y = _fft_groups(sim, x, inverse=inverse, serial_units=1,
                    active_rows=n // 2, transition_fn=transition)
    return PIMFFTResult(output=y, counters=sim.ctr, log=tuple(sim.log))


def fft_2r(x: np.ndarray, cfg: PIMConfig, spec: aritpim.FloatSpec,
           *, inverse: bool = False, charge_perm: bool = True,
           faults=None, array_id: int = 0) -> PIMFFTResult:
    """2r-configuration (§4.4): two elements per row (snake), full-row use."""
    n = len(x)
    r = cfg.crossbar_rows
    assert n == 2 * r, f"2r-FFT needs n == 2*rows ({2 * r})"
    sim = CrossbarSim(cfg, spec, faults=faults, array_id=array_id)
    sim.load(x)
    if charge_perm:
        sim.charge_row_ops(_perm_swap_count(n), cycles_per_row=6, tag="perm")

    def transition(stage):
        if stage == 0:
            return  # snake layout already pairs stage-0 partners in-row
        # in-place pair swap (Fig. 4d): one column-parallel word swap plus
        # r/2 serial row swaps for the cross-row half of the pairs.
        sim.charge_column_op("swap", r)
        sim.charge_row_ops(r // 2, cycles_per_row=6)

    y = _fft_groups(sim, x, inverse=inverse, serial_units=1,
                    active_rows=r, transition_fn=transition)
    return PIMFFTResult(output=y, counters=sim.ctr, log=tuple(sim.log))


def fft_2rbeta(x: np.ndarray, cfg: PIMConfig, spec: aritpim.FloatSpec,
               *, inverse: bool = False, charge_perm: bool = True,
               faults=None, array_id: int = 0) -> PIMFFTResult:
    """2r-beta configuration (§4.5): 2*beta elements per row across beta
    column-units; butterflies serial over units, ceil(beta/p) with
    partitions [25]."""
    n = len(x)
    r = cfg.crossbar_rows
    beta = n // (2 * r)
    assert n == 2 * r * beta and beta >= 1, f"n={n} not a 2r*beta multiple"
    word = aritpim.complex_word_bits(spec)
    need = cfg.crossbars_per_fft(n, word)
    assert need <= 1.0 + 1e-9 or beta <= cfg.crossbar_cols // (2 * word), \
        f"n={n} exceeds crossbar width (footnote 7)"
    sim = CrossbarSim(cfg, spec, faults=faults, array_id=array_id)
    serial = math.ceil(beta / cfg.partitions)
    if charge_perm:
        # Input bit-reversal happens BEFORE the group loop, exactly as in
        # the r/2r configurations (it permutes the in-array layout, bounded
        # by one array's 2r elements); an earlier revision charged it after
        # the groups, which kept the totals right but broke any
        # counter-ordering invariant (tests/test_pim_ntt.py pins this).
        sim.charge_row_ops(_perm_swap_count(min(n, 2 * r)), cycles_per_row=6,
                           tag="perm")

    def transition(stage):
        if stage == 0:
            return
        sim.charge_column_op("swap", r)          # within-row pair swaps
        sim.charge_row_ops(r // 2, cycles_per_row=6)  # cross-row half
        if stage >= int(math.log2(2 * r)):
            # pairs now span units: column-parallel inter-unit word copies,
            # serialized over units (partitions parallelize them too).
            sim.charge_column_op("copy", r,
                                 serial=math.ceil(beta / cfg.partitions))

    y = _fft_groups(sim, x, inverse=inverse, serial_units=serial,
                    active_rows=r, transition_fn=transition)
    return PIMFFTResult(output=y, counters=sim.ctr, log=tuple(sim.log))


def pim_fft(x: np.ndarray, cfg: PIMConfig, spec: aritpim.FloatSpec,
            *, inverse: bool = False, charge_perm: bool = True,
            faults=None, array_id: int = 0) -> PIMFFTResult:
    """Dispatch to the layout the paper uses for this n (§6: 2K..16K -> 2r,
    2r*2, 2r*4, 2r*8)."""
    n = len(x)
    r = cfg.crossbar_rows
    if n == r:
        return r_fft(x, cfg, spec, inverse=inverse, charge_perm=charge_perm,
                     faults=faults, array_id=array_id)
    return fft_2rbeta(x, cfg, spec, inverse=inverse, charge_perm=charge_perm,
                      faults=faults, array_id=array_id)


# ---------------------------------------------------------------------------
# Real-input path (paper Eq. (10)): two real sequences per complex FFT.
# ---------------------------------------------------------------------------

def realpack_unpack_cycles(cfg: PIMConfig, spec: aritpim.FloatSpec) -> int:
    """Eq. (10) Hermitian unpack, per serial unit: order reversal + conj +
    2 complex adds + multiply-by-i + exponent decrements, charged with the
    paper's §5 in-memory trick costs (conjugate = imag sign-bit flip,
    multiply by i = half-word swap + sign flip, /2 = exponent decrement).
    THE single definition — ``pim_rfft`` and the real polymul paths in
    ``polymul_pim`` all charge it from here."""
    word = aritpim.complex_word_bits(spec)
    cycles = 0
    cycles += (cfg.crossbar_rows // 2) * 6        # order reversal (row swaps)
    cycles += 2                                   # conjugate: sign-bit NOT
    cycles += 2 * aritpim.complex_add_cycles(spec)  # (Zrev* +- Z)
    cycles += aritpim.swap_cycles(word // 2) + 2  # multiply by i
    cycles += 2 * 2                               # /2: exponent decrements
    return cycles


def _hermitian_split(zf: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Numerical Eq. (10) split of Z = FFT(x + i y) into (X, Y)."""
    zrev = np.roll(zf[::-1], 1)
    return 0.5 * (np.conj(zrev) + zf), 0.5j * (np.conj(zrev) - zf)


@dataclasses.dataclass(frozen=True)
class PIMRFFTResult:
    #: (2, n//2 + 1) complex half-spectra of the two packed real sequences
    spectra: np.ndarray
    counters: Counters


def pim_rfft(x: np.ndarray, y: np.ndarray, cfg: PIMConfig,
             spec: aritpim.FloatSpec, *, charge_perm: bool = True,
             faults=None, array_id: int = 0) -> PIMRFFTResult:
    """Half-spectra of TWO real sequences via ONE packed complex FFT.

    The crossbar holds z = x + i y (the imag plane stores the second
    sequence instead of zeros — area per transform halves, so the batched
    throughput doubles on top of the shared butterflies). The Hermitian
    unpack runs in-memory with the §5 tricks; only n/2+1 bins per sequence
    are kept. Counter parity with ``rfft_latency_cycles`` is pinned in
    tests/test_pim.py.
    """
    n = len(x)
    assert len(y) == n
    beta = max(1, n // (2 * cfg.crossbar_rows))
    serial = math.ceil(beta / cfg.partitions)
    z = np.asarray(x, np.float64) + 1j * np.asarray(y, np.float64)
    fz = pim_fft(z, cfg, spec, charge_perm=charge_perm,
                 faults=faults, array_id=array_id)
    sim = CrossbarSim(cfg, spec)
    unpack = realpack_unpack_cycles(cfg, spec)
    sim.ctr.cycles += unpack * serial
    sim.ctr.gates += unpack * serial * cfg.crossbar_rows
    fa, fb = _hermitian_split(fz.output)
    half = n // 2 + 1
    spectra = np.stack([fa[:half], fb[:half]])
    ctr = Counters(cycles=fz.counters.cycles + sim.ctr.cycles,
                   gates=fz.counters.gates + sim.ctr.gates)
    return PIMRFFTResult(spectra=spectra, counters=ctr)


def rfft_latency_cycles(n: int, cfg: PIMConfig, spec: aritpim.FloatSpec,
                        *, charge_perm: bool = True) -> int:
    """Closed form for ``pim_rfft`` (two sequences per run): one complex
    transform plus the Hermitian unpack, serialized over the beta units."""
    beta = max(1, n // (2 * cfg.crossbar_rows))
    serial = math.ceil(beta / cfg.partitions)
    return (fft_latency_cycles(n, cfg, spec, charge_perm=charge_perm)
            + realpack_unpack_cycles(cfg, spec) * serial)


def rfft_throughput_per_s(n: int, cfg: PIMConfig, spec: aritpim.FloatSpec
                          ) -> float:
    """Real-sequence transforms per second: each schedule slot carries TWO
    sequences in one packed complex word — the ~2x the paper's real-polymul
    ratios build on, verified against ``fft_throughput_per_s`` in tests."""
    lat = rfft_latency_cycles(n, cfg, spec) / cfg.clock_hz
    word = aritpim.complex_word_bits(spec)
    return 2 * cfg.batch_capacity(n, word) * cfg.concurrency / lat


# ---------------------------------------------------------------------------
# Distributed real-Hermitian path: four-step FFT across crossbar arrays
# (paper §7's multi-crossbar future work, real-input serving tier).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PIMDistRFFTResult:
    #: (2, n//2 + 1) complex half-spectra of the two packed real sequences
    spectra: np.ndarray
    #: per-shard cycle/gate counters (each shard == the closed form)
    shard_counters: tuple
    #: inter-array transpose traffic, the multi-device tiers' all-to-all
    #: analogue
    a2a_bytes: int
    #: conjugate-bin mirror route (the half-block ppermute), in bytes
    permute_bytes: int


def _phase_a_fft(sim: CrossbarSim, block: np.ndarray, n1: int,
                 active_rows: int) -> np.ndarray:
    """Length-n1 FFT down the column dimension of a (n1, w) block with
    r-layout alignment moves per stage — the float twin of the NTT model's
    phase A (``ntt_pim._phase_a_ntt``)."""
    y = block[_bit_reverse_perm(n1)].astype(np.complex128)
    for s in range(n1.bit_length() - 1):
        m = 2 << s
        half = m >> 1
        idx = np.arange(n1).reshape(n1 // m, m)
        top = idx[:, :half].ravel()
        bot = idx[:, half:].ravel()
        w = np.tile(_twiddles(m, False), n1 // m)[:, None]
        sim.charge_twiddle_writes(active_rows)
        sim.charge_column_op("copy", active_rows)
        sim.charge_row_ops(active_rows, cycles_per_row=2)
        sim.charge_column_op("copy", active_rows)
        sim.charge_row_ops(active_rows, cycles_per_row=2)
        u, v = sim.butterfly_rows(y[top], y[bot], w, active_rows)
        y[top], y[bot] = u, v
    return y


def pim_rfft_distributed(x: np.ndarray, y: np.ndarray, n_shards: int,
                         cfg: PIMConfig, spec: aritpim.FloatSpec
                         ) -> PIMDistRFFTResult:
    """Half-spectra of TWO real sequences via ONE four-step packed complex
    FFT across ``n_shards`` crossbar arrays.

    n = n1 * n2 with n1 = D shards and n2 = n / D = crossbar rows. The
    Hermitian split (Eq. (10)) is charged PER SHARD (``realpack_unpack_
    cycles``: the within-shard order reversal, conjugate, adds and
    half-scales) and the cross-shard conjugate-bin route — Z-order bin
    k = idx + D*k2 mirrors onto shard (D - idx) mod D — is a half-block
    periphery move charged as BYTES (``permute_bytes``), the same unit as
    the two inter-array transposes (``a2a_bytes``). Matches np.fft.rfft
    numerically and the closed forms ``rfft_distributed_latency_cycles`` /
    ``rfft_distributed_a2a_bytes`` (tests/test_pim.py); total moved bytes
    land at ~0.58x the complex distributed path's per real sequence.
    """
    n = len(x)
    D = n_shards
    if D < 2 or D & (D - 1):
        raise ValueError(f"n_shards={D} must be a power of two >= 2")
    n2 = n // D
    if n2 != cfg.crossbar_rows:
        # ValueError, not assert: a wrong-geometry cost model under
        # ``python -O`` would silently report counters for the wrong shape.
        raise ValueError(f"four-step PIM wants n/D == rows "
                         f"({cfg.crossbar_rows}), got {n2}")
    if len(y) != n:
        raise ValueError(f"sequence lengths differ: {n} vs {len(y)}")
    z = np.asarray(x, np.float64) + 1j * np.asarray(y, np.float64)
    sims = [CrossbarSim(cfg, spec) for _ in range(D)]
    M = z.reshape(D, n2)                               # row j1
    wcol = n2 // D
    # Step 1 transpose: shard s owns all j1 for j2 slice s.
    blocks = [M[:, s * wcol:(s + 1) * wcol].copy() for s in range(D)]
    for s, sim in enumerate(sims):
        yv = _phase_a_fft(sim, blocks[s], D, active_rows=n2 // 2)
        # Step 3: twiddle w^{j2 k1} with GLOBAL j2, exact integer exponents
        # reduced mod n (the same fix as core/fft/distributed.py) — one
        # column-parallel complex multiply over the shard's working set.
        j2 = np.arange(s * wcol, (s + 1) * wcol, dtype=np.int64)
        k1 = np.arange(D, dtype=np.int64)[:, None]
        tw = np.exp(-2j * np.pi * ((k1 * j2[None, :]) % n) / n)
        blocks[s] = yv * tw
        sim.charge_column_op("cmul", cfg.crossbar_rows)
    # Step 4 transpose: shard s owns row k1 = s, all j2.
    Y = np.concatenate(blocks, axis=1)                 # (D=k1, n2=j2)
    Z = np.empty((D, n2), np.complex128)
    for s, sim in enumerate(sims):
        def transition(stage):
            sim.charge_column_op("copy", n2 // 2)
            sim.charge_row_ops(n2 // 2, cycles_per_row=2)
            sim.charge_column_op("copy", n2 // 2)
            sim.charge_row_ops(n2 // 2, cycles_per_row=2)
        # Phase-B input bit-reversal, before the group loop (r-config).
        sim.charge_row_ops(_perm_swap_count(n2), cycles_per_row=6,
                           tag="perm")
        Z[s] = _fft_groups(sim, Y[s], inverse=False, serial_units=1,
                           active_rows=n2 // 2, transition_fn=transition)
        # Per-shard Eq. (10) split: reversal/conjugate/adds/half-scales on
        # the shard's own block (the cross-shard mirror is permute_bytes).
        unpack = realpack_unpack_cycles(cfg, spec)
        sim.ctr.cycles += unpack
        sim.ctr.gates += unpack * cfg.crossbar_rows
    # Z-order assembly X[k1 + k2 n1] = Z[k1, k2] (host-side view), then the
    # numerical split — the per-shard charges above already costed it.
    fz = Z.T.reshape(n)
    fa, fb = _hermitian_split(fz)
    half = n // 2 + 1
    return PIMDistRFFTResult(
        spectra=np.stack([fa[:half], fb[:half]]),
        shard_counters=tuple(s.ctr for s in sims),
        a2a_bytes=rfft_distributed_a2a_bytes(n, spec),
        permute_bytes=rfft_distributed_permute_bytes(n, spec))


def fft_distributed_latency_cycles(n: int, n_shards: int, cfg: PIMConfig,
                                   spec: aritpim.FloatSpec) -> int:
    """Closed-form per-shard cycles of the four-step complex FFT (== every
    shard's counter in ``pim_rfft_distributed`` before the split charge):
    log2(D) r-layout column stages, one twiddle cmul, then a full r-config
    FFT of length n/D."""
    D = n_shards
    n2 = n // D
    r = cfg.crossbar_rows
    assert n2 == r, (n, D, r)
    stage_a = (r // 2                                  # twiddle writes
               + 2 * aritpim.op_cycles("copy", spec) + 2 * (r // 2) * 2
               + aritpim.op_cycles("butterfly", spec))
    phase_a = (D.bit_length() - 1) * stage_a
    twiddle = aritpim.op_cycles("cmul", spec)
    phase_b = fft_latency_cycles(n2, cfg, spec, charge_perm=True)
    return phase_a + twiddle + phase_b


def rfft_distributed_latency_cycles(n: int, n_shards: int, cfg: PIMConfig,
                                    spec: aritpim.FloatSpec) -> int:
    """Per-shard cycles including the Eq. (10) split (two real sequences
    ride the run, as in ``pim_rfft``)."""
    return (fft_distributed_latency_cycles(n, n_shards, cfg, spec)
            + realpack_unpack_cycles(cfg, spec))


def _word_bytes(spec) -> int:
    return aritpim.storage_word_bits(spec) // 8


def fft_distributed_a2a_bytes(n: int, spec, *, ordered: bool = True) -> int:
    """Inter-array transpose traffic of the four-step complex FFT, per
    transform: two in-fabric transposes plus (``ordered``) the Z-order ->
    natural reorder, each moving every complex word once. Unlike the NTT
    model (which leaves Z-order assembly as a host view), the serving tier
    returns natural order, so the ordering transpose is charged — the same
    convention as the multi-device tiers' ledger
    (``four_step_collective_stats``)."""
    return (3 if ordered else 2) * n * _word_bytes(spec)


def rfft_distributed_a2a_bytes(n: int, spec) -> int:
    """Transpose traffic of the packed real four-step (TWO real sequences):
    two full-width transposes of the packed transform plus the ordering
    move of the two packed half-spectra (2 x n/2 = n words) — the
    half-spectrum never crosses at full complex width."""
    return (2 * n + n) * _word_bytes(spec)


def rfft_distributed_permute_bytes(n: int, spec) -> int:
    """The conjugate-bin mirror route: each shard ships the upper half of
    its Z-order block to its mirror peer — n/2 words total."""
    return (n // 2) * _word_bytes(spec)


# ---------------------------------------------------------------------------
# Closed forms (benchmarks at scale; asserted == simulator in tests)
# ---------------------------------------------------------------------------

def fft_latency_cycles(n: int, cfg: PIMConfig, spec: aritpim.FloatSpec,
                       *, charge_perm: bool = True,
                       inverse: bool = False) -> int:
    r = cfg.crossbar_rows
    beta = max(1, n // (2 * r))
    stages = n.bit_length() - 1
    bfly = aritpim.butterfly_cycles(spec)
    word = aritpim.complex_word_bits(spec)
    serial = math.ceil(beta / cfg.partitions)
    total = 0
    if charge_perm:
        total += _perm_swap_count(min(n, 2 * r)) * 6
    for s in range(stages):
        total += r // 2                     # twiddle writes
        total += bfly * serial              # butterflies
        if n == r:                          # r-config moves
            total += 2 * aritpim.copy_cycles(word) + 2 * (n // 2) * 2
        elif s > 0:                         # 2r / 2rb transitions
            total += aritpim.swap_cycles(word) + (r // 2) * 6
            if n > 2 * r and s >= int(math.log2(2 * r)):
                total += aritpim.copy_cycles(word) * serial
    if inverse:
        total += aritpim.copy_cycles(word)  # 1/n exponent-decrement pass
    return total


def fft_throughput_per_s(n: int, cfg: PIMConfig, spec: aritpim.FloatSpec
                         ) -> float:
    """Batched throughput: all crossbars run the same schedule in parallel
    (paper: batch size = number of crossbars, net of scratch area)."""
    word = aritpim.complex_word_bits(spec)
    lat = fft_latency_cycles(n, cfg, spec) / cfg.clock_hz
    return cfg.batch_capacity(n, word) * cfg.concurrency / lat


def batched_fft_stats(n: int, batch: int | None, cfg: PIMConfig,
                      spec: aritpim.FloatSpec, *, mesh=None) -> dict:
    """Schedule a batch of B n-point FFTs onto the crossbar arrays (and,
    when ``mesh`` is given, across its (pod, data) axes first) via
    ``repro_torch.dist.batching``; report waves, per-array utilization,
    end-to-end latency and achieved throughput.

    At ``batch == num_arrays`` (one full wave) the achieved throughput
    equals ``fft_throughput_per_s`` — the paper's §6 steady-state; smaller
    or non-dividing batches surface the idle-array cost instead of silently
    assuming perfect packing.
    """
    from repro_torch.dist import batching
    word = aritpim.complex_word_bits(spec)
    num_arrays = max(1, int(cfg.batch_capacity(n, word) * cfg.concurrency))
    if batch is None:        # one full wave everywhere: the steady state
        n_dev = (batching.shard_batch(0, mesh).n_devices
                 if mesh is not None else 1)
        batch = num_arrays * n_dev
    plan = batching.plan_crossbar_batch(batch, num_arrays=num_arrays,
                                        mesh=mesh)
    wave_latency_s = fft_latency_cycles(n, cfg, spec) / cfg.clock_hz
    return {
        **plan.report(),
        "n": n,
        "wave_latency_s": wave_latency_s,
        "latency_s": plan.latency(wave_latency_s),
        "throughput_per_s": plan.throughput(wave_latency_s),
    }


def fft_energy_j_per_op(n: int, cfg: PIMConfig, spec: aritpim.FloatSpec
                        ) -> float:
    """Energy per FFT: gate executions dominate; derived from the simulator
    counter structure (gates ~= cycles * active rows for column ops)."""
    x = np.random.default_rng(0).standard_normal(n).astype(np.complex128)
    res = pim_fft(x, cfg, spec)
    return res.counters.energy_j(cfg)
