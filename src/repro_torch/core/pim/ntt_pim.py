"""In-memory NUMBER-THEORETIC transform on the crossbar simulator.

Port of ``repro.core.pim.ntt_pim``: a numpy copy that imports nothing of
the reference, pinned equal to the original by
``tests/test_torch_pim.py``.

The exact counterpart of ``fft_pim.py``: the same r / 2r / 2r-beta layout
algebra (paper §4.3-4.5 — the configurations describe data MOVEMENT, which
is domain-independent), with the complex floating-point butterfly replaced
by a fixed-point modular one costed per AritPIM's integer sequences
(``aritpim.IntSpec``; NTT-PIM [arXiv:2310.09715] maps the identical
structure). Values are tracked exactly in uint64 residues and verified
against ``core.ntt.ref``; cycle/gate counters accumulate per vectored op,
and the closed forms below are asserted equal to the simulator's counters
in tests/test_pim_ntt.py — the same parity contract tests/test_pim.py
enforces for the float FFT.

Differences from the float pipeline, all from the arithmetic domain:

  * butterfly: 1 Barrett modmul + 2 modadds on w-bit words (no IEEE
    special-case overhead), vs 4 fmul + 6 fadd on 2x(1+e+m) bits;
  * inverse scaling: 1/n is a genuine modmul by n^{-1} mod q, not an
    exponent decrement (there is no exponent);
  * negacyclic twist (RLWE, mod x^n + 1): one column-parallel modmul per
    operand before the forward transforms and one after the inverse, with
    the 1/n fold-in — the §5 permutation-cancellation analogue is charged
    the same way (DIT/DIF pairing cancels the bit-reversals, so polymul
    transforms skip the permutation cost).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.ntt.ref import NTTParams, as_residues
from repro_torch.core.pim import aritpim
from repro_torch.core.pim.crossbar import Counters, CrossbarSim
from repro_torch.core.pim.device_model import PIMConfig
from repro_torch.core.pim.fft_pim import (_bit_reverse_perm,
                                          _perm_swap_count)


@dataclasses.dataclass(frozen=True)
class PIMNTTResult:
    output: np.ndarray
    counters: Counters
    #: ordered (tag, cycles) charge records (see CrossbarSim.log).
    log: tuple = ()


_residues = as_residues    # same contract as the reference: floats raise


def _ntt_groups(sim: CrossbarSim, x: np.ndarray, params: NTTParams, *,
                inverse: bool, serial_units: int, active_rows: int,
                transition_fn) -> np.ndarray:
    """Shared group loop: iterative DIT modular butterflies after bit
    reversal — structurally identical to ``fft_pim._fft_groups``."""
    n = params.n
    q = np.uint64(params.q)
    y = _residues(x, params.q)[_bit_reverse_perm(n)]
    pw = params.powers(params.w_inv if inverse else params.w)
    for s in range(n.bit_length() - 1):
        m = 2 << s            # butterfly span
        half = m >> 1
        idx = np.arange(n).reshape(n // m, m)
        top = idx[:, :half].ravel()
        bot = idx[:, half:].ravel()
        w = np.tile(pw[(n // m) * np.arange(half)], n // m)
        sim.charge_twiddle_writes(sim.cfg.crossbar_rows // 2)
        transition_fn(s)
        u, v = sim.butterfly_rows_mod(y[top], y[bot], w, params.q,
                                      active_rows,
                                      serial_units=serial_units)
        y[top], y[bot] = u, v
    if inverse:
        # 1/n scaling: a real modmul by n^{-1} mod q (no exponent trick).
        sim.charge_column_op("modmul", active_rows)
        y = (y * np.uint64(params.n_inv)) % q
    return y


def r_ntt(x: np.ndarray, params: NTTParams, cfg: PIMConfig,
          spec: aritpim.IntSpec, *, inverse: bool = False,
          charge_perm: bool = True, faults=None,
          array_id: int = 0) -> PIMNTTResult:
    """r-configuration: n = crossbar rows, one residue per row."""
    n = params.n
    assert n == cfg.crossbar_rows, f"r-NTT needs n == rows ({cfg.crossbar_rows})"
    sim = CrossbarSim(cfg, spec, faults=faults, array_id=array_id)
    sim.load(_residues(x, params.q).astype(np.float64))
    if charge_perm:
        sim.charge_row_ops(_perm_swap_count(n), cycles_per_row=6, tag="perm")

    def transition(stage):
        sim.charge_column_op("copy", n // 2)
        sim.charge_row_ops(n // 2, cycles_per_row=2)
        sim.charge_column_op("copy", n // 2)
        sim.charge_row_ops(n // 2, cycles_per_row=2)

    y = _ntt_groups(sim, x, params, inverse=inverse, serial_units=1,
                    active_rows=n // 2, transition_fn=transition)
    return PIMNTTResult(output=y, counters=sim.ctr, log=tuple(sim.log))


def ntt_2r(x: np.ndarray, params: NTTParams, cfg: PIMConfig,
           spec: aritpim.IntSpec, *, inverse: bool = False,
           charge_perm: bool = True, faults=None,
           array_id: int = 0) -> PIMNTTResult:
    """2r-configuration: two residues per row (snake), full-row use."""
    n = params.n
    r = cfg.crossbar_rows
    assert n == 2 * r, f"2r-NTT needs n == 2*rows ({2 * r})"
    sim = CrossbarSim(cfg, spec, faults=faults, array_id=array_id)
    sim.load(_residues(x, params.q).astype(np.float64))
    if charge_perm:
        sim.charge_row_ops(_perm_swap_count(n), cycles_per_row=6, tag="perm")

    def transition(stage):
        if stage == 0:
            return
        sim.charge_column_op("swap", r)
        sim.charge_row_ops(r // 2, cycles_per_row=6)

    y = _ntt_groups(sim, x, params, inverse=inverse, serial_units=1,
                    active_rows=r, transition_fn=transition)
    return PIMNTTResult(output=y, counters=sim.ctr, log=tuple(sim.log))


def ntt_2rbeta(x: np.ndarray, params: NTTParams, cfg: PIMConfig,
               spec: aritpim.IntSpec, *, inverse: bool = False,
               charge_perm: bool = True, faults=None,
               array_id: int = 0) -> PIMNTTResult:
    """2r-beta configuration: 2*beta residues per row across beta
    column-units; butterflies serial over units, ceil(beta/p) with
    partitions."""
    n = params.n
    r = cfg.crossbar_rows
    beta = n // (2 * r)
    assert n == 2 * r * beta and beta >= 1, f"n={n} not a 2r*beta multiple"
    word = spec.word_bits
    assert 2 * beta * word <= cfg.crossbar_cols, \
        f"n={n} exceeds crossbar width"
    sim = CrossbarSim(cfg, spec, faults=faults, array_id=array_id)
    serial = math.ceil(beta / cfg.partitions)
    if charge_perm:
        # Charged BEFORE the group loop, same placement as r/2r (the
        # fft_2rbeta ordering fix rides the same contract).
        sim.charge_row_ops(_perm_swap_count(min(n, 2 * r)), cycles_per_row=6,
                           tag="perm")

    def transition(stage):
        if stage == 0:
            return
        sim.charge_column_op("swap", r)
        sim.charge_row_ops(r // 2, cycles_per_row=6)
        if stage >= int(math.log2(2 * r)):
            sim.charge_column_op("copy", r,
                                 serial=math.ceil(beta / cfg.partitions))

    y = _ntt_groups(sim, x, params, inverse=inverse, serial_units=serial,
                    active_rows=r, transition_fn=transition)
    return PIMNTTResult(output=y, counters=sim.ctr, log=tuple(sim.log))


def pim_ntt(x: np.ndarray, params: NTTParams, cfg: PIMConfig,
            spec: aritpim.IntSpec, *, inverse: bool = False,
            charge_perm: bool = True, faults=None,
            array_id: int = 0) -> PIMNTTResult:
    """Dispatch to the layout for this n, mirroring ``fft_pim.pim_fft``."""
    if params.n == cfg.crossbar_rows:
        return r_ntt(x, params, cfg, spec, inverse=inverse,
                     charge_perm=charge_perm, faults=faults,
                     array_id=array_id)
    return ntt_2rbeta(x, params, cfg, spec, inverse=inverse,
                      charge_perm=charge_perm, faults=faults,
                      array_id=array_id)


def pim_ntt_polymul(a: np.ndarray, b: np.ndarray, params: NTTParams,
                    cfg: PIMConfig, spec: aritpim.IntSpec, *,
                    negacyclic: bool = True, faults=None,
                    array_id: int = 0) -> PIMNTTResult:
    """Exact polynomial product mod (x^n ± 1, q) on the simulator.

    Negacyclic: psi-twist both operands (2 modmuls), transform without the
    cancelled permutations, pointwise modmul, inverse transform, untwist
    (1 modmul, the 1/n already charged by the inverse path)."""
    n = params.n
    q = np.uint64(params.q)
    beta = max(1, n // (2 * cfg.crossbar_rows))
    serial = math.ceil(beta / cfg.partitions)
    sim = CrossbarSim(cfg, spec)
    at = _residues(a, params.q)
    bt = _residues(b, params.q)
    if negacyclic:
        psi_pow = params.powers(params.psi)
        at = (at * psi_pow) % q
        bt = (bt * psi_pow) % q
        sim.charge_column_op("modmul", cfg.crossbar_rows, serial=serial)
        sim.charge_column_op("modmul", cfg.crossbar_rows, serial=serial)
    fa = pim_ntt(at, params, cfg, spec, charge_perm=False,
                 faults=faults, array_id=array_id)
    fb = pim_ntt(bt, params, cfg, spec, charge_perm=False,
                 faults=faults, array_id=array_id)
    prod = (fa.output * fb.output) % q
    sim.charge_column_op("modmul", cfg.crossbar_rows, serial=serial)
    inv = pim_ntt(prod, params, cfg, spec, inverse=True, charge_perm=False,
                  faults=faults, array_id=array_id)
    out = inv.output
    if negacyclic:
        out = (out * params.powers(params.psi_inv)) % q
        sim.charge_column_op("modmul", cfg.crossbar_rows, serial=serial)
    ctr = Counters(
        cycles=fa.counters.cycles + fb.counters.cycles + inv.counters.cycles
        + sim.ctr.cycles,
        gates=fa.counters.gates + fb.counters.gates + inv.counters.gates
        + sim.ctr.gates)
    # Concatenated ledger (transforms, then the pointwise/twist charges):
    # fault entries from the sub-transforms survive into the composite
    # result, so callers can audit which array misbehaved.
    return PIMNTTResult(output=out, counters=ctr,
                        log=tuple(fa.log) + tuple(fb.log) + tuple(inv.log)
                        + tuple(sim.log))


# ---------------------------------------------------------------------------
# Closed forms (asserted == simulator in tests/test_pim_ntt.py)
# ---------------------------------------------------------------------------

def ntt_latency_cycles(n: int, cfg: PIMConfig, spec: aritpim.IntSpec,
                       *, charge_perm: bool = True,
                       inverse: bool = False) -> int:
    r = cfg.crossbar_rows
    beta = max(1, n // (2 * r))
    stages = n.bit_length() - 1
    bfly = aritpim.ntt_butterfly_cycles(spec)
    word = spec.word_bits
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
        total += aritpim.mod_mul_cycles(spec)   # 1/n modmul pass
    return total


def ntt_polymul_latency_cycles(n: int, cfg: PIMConfig,
                               spec: aritpim.IntSpec, *,
                               negacyclic: bool = True) -> int:
    beta = max(1, n // (2 * cfg.crossbar_rows))
    serial = math.ceil(beta / cfg.partitions)
    fwd = ntt_latency_cycles(n, cfg, spec, charge_perm=False)
    inv = ntt_latency_cycles(n, cfg, spec, charge_perm=False, inverse=True)
    pointwise = aritpim.mod_mul_cycles(spec) * serial
    twists = 3 * aritpim.mod_mul_cycles(spec) * serial if negacyclic else 0
    return 2 * fwd + inv + pointwise + twists


def ntt_throughput_per_s(n: int, cfg: PIMConfig, spec: aritpim.IntSpec
                         ) -> float:
    """Batched throughput: one NTT per crossbar, all arrays in parallel.
    A w-bit residue word is half the complex float word, so per-array
    capacity roughly doubles vs the float FFT at equal n."""
    lat = ntt_latency_cycles(n, cfg, spec) / cfg.clock_hz
    return cfg.batch_capacity(n, spec.word_bits) * cfg.concurrency / lat


def _arrays_per_device(n: int, cfg: PIMConfig,
                       spec: aritpim.IntSpec) -> int:
    """Concurrent n-point modular transforms one device can run: memory
    capacity discounted by controller issue concurrency. The one definition
    every NTT wave plan uses (batched stats, RNS limb scheduling) — the
    sim-side plans and the closed-form stats must not each re-derive it."""
    return max(1, int(cfg.batch_capacity(n, spec.word_bits)
                      * cfg.concurrency))


def batched_ntt_stats(n: int, batch: int | None, cfg: PIMConfig,
                      spec: aritpim.IntSpec, *, mesh=None) -> dict:
    """Schedule a batch of B n-point NTTs through the same
    ``repro_torch.dist.batching`` wave scheduler as
    ``batched_fft_stats``."""
    from repro_torch.dist import batching
    num_arrays = _arrays_per_device(n, cfg, spec)
    if batch is None:        # one full wave everywhere: the steady state
        n_dev = (batching.shard_batch(0, mesh).n_devices
                 if mesh is not None else 1)
        batch = num_arrays * n_dev
    plan = batching.plan_crossbar_batch(batch, num_arrays=num_arrays,
                                        mesh=mesh)
    wave_latency_s = ntt_latency_cycles(n, cfg, spec) / cfg.clock_hz
    return {
        **plan.report(),
        "n": n,
        "wave_latency_s": wave_latency_s,
        "latency_s": plan.latency(wave_latency_s),
        "throughput_per_s": plan.throughput(wave_latency_s),
    }


def ntt_energy_j_per_op(n: int, cfg: PIMConfig, spec: aritpim.IntSpec,
                        *, q: int | None = None) -> float:
    params = NTTParams.make(n, q)
    x = np.random.default_rng(0).integers(0, params.q, size=n)
    res = pim_ntt(x, params, cfg, spec)
    return res.counters.energy_j(cfg)


# ---------------------------------------------------------------------------
# RNS: k-limb polymul, limbs scheduled as waves over the crossbar pool
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PIMRNSResult:
    """Per-limb products + CRT result + summed cost counters + limb plan."""
    outputs: np.ndarray          # (k, n) uint64 per-limb residue products
    result: np.ndarray           # (n,) object: exact coefficients mod Q
    counters: Counters           # total work: sum over limbs
    plan: object                 # CrossbarBatchPlan of limbs onto arrays


def pim_rns_polymul(a, b, rns, cfg: PIMConfig, spec: aritpim.IntSpec, *,
                    negacyclic: bool = True, mesh=None,
                    faults=None) -> PIMRNSResult:
    """Multi-limb exact polymul mod Q on the simulator: each limb is one
    independent single-word ``pim_ntt_polymul`` (limbs are embarrassingly
    parallel — one limb per crossbar), scheduled as waves through
    ``dist.batching`` like any other transform batch. Counters are the SUM
    of the per-limb simulators (total work); wave latency comes from the
    plan (``rns_polymul_wave_stats`` is the closed form)."""
    from repro_torch.core.ntt.rns import crt_to_modulus, to_rns
    ar = to_rns(a, rns)
    br = to_rns(b, rns)
    outs = np.empty((rns.k, rns.n), np.uint64)
    cycles = gates = 0
    for i, params in enumerate(rns.limbs):
        # Limb i runs on (logical) array i — the wave schedule's placement
        # — so a fault model can hit individual limbs deterministically.
        res = pim_ntt_polymul(ar[i], br[i], params, cfg, spec,
                              negacyclic=negacyclic, faults=faults,
                              array_id=i)
        outs[i] = res.output
        cycles += res.counters.cycles
        gates += res.counters.gates
    stats = rns_polymul_wave_stats(rns.n, rns.k, cfg, spec,
                                   negacyclic=negacyclic, mesh=mesh)
    return PIMRNSResult(outputs=outs, result=crt_to_modulus(outs, rns),
                        counters=Counters(cycles=cycles, gates=gates),
                        plan=stats["plan"])


def rns_polymul_latency_cycles(n: int, k: int, cfg: PIMConfig,
                               spec: aritpim.IntSpec, *,
                               negacyclic: bool = True) -> int:
    """Total simulator cycles of a k-limb RNS polymul: exactly k times the
    single-word fused polymul (asserted == summed counters in tests)."""
    return k * ntt_polymul_latency_cycles(n, cfg, spec,
                                          negacyclic=negacyclic)


def rns_polymul_wave_stats(n: int, k: int, cfg: PIMConfig,
                           spec: aritpim.IntSpec, *, negacyclic: bool = True,
                           mesh=None) -> dict:
    """Wall-clock view of the limb schedule: k limbs over the crossbar pool
    run in ``waves`` wavefronts of one fused polymul each."""
    from repro_torch.dist import batching
    plan = batching.plan_crossbar_batch(
        k, num_arrays=_arrays_per_device(n, cfg, spec), mesh=mesh)
    wave_latency_s = (ntt_polymul_latency_cycles(n, cfg, spec,
                                                 negacyclic=negacyclic)
                      / cfg.clock_hz)
    return {
        **plan.report(),
        "plan": plan,
        "n": n,
        "limbs": k,
        "wave_latency_s": wave_latency_s,
        "latency_s": plan.latency(wave_latency_s),
        "throughput_per_s": plan.throughput(wave_latency_s),
        "total_cycles": rns_polymul_latency_cycles(n, k, cfg, spec,
                                                   negacyclic=negacyclic),
    }


# ---------------------------------------------------------------------------
# Distributed four-step NTT (n = n1 * n2 over D crossbar shards)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PIMDistNTTResult:
    """Four-step NTT across D shards: values + per-shard counters + bytes."""
    output: np.ndarray                 # (n,) uint64, natural order
    shard_counters: tuple              # one Counters per shard (all equal)
    a2a_bytes: int                     # inter-array transpose traffic, total
    logs: tuple = ()                   # per-shard (tag, cycles) charge logs

    @property
    def latency_cycles(self) -> int:
        """Shards run in parallel: latency is one shard's cycles (symmetric
        by construction, asserted in tests)."""
        return max(c.cycles for c in self.shard_counters)


def _phase_a_ntt(sim: CrossbarSim, block: np.ndarray, p1: NTTParams,
                 active_rows: int) -> np.ndarray:
    """Step-2 column transforms: NTT_{n1} along axis 0 of the (n1, n2/D)
    shard block, every column in parallel (one vectored butterfly per
    stage). Charged exactly like an r-layout stage: twiddle writes + two
    copy/row-move pairs + one butterfly op. The bit-reversal of the n1
    rows is NOT charged — the step-1 transpose delivery order absorbs it
    (the inter-array move places rows wherever the algorithm wants)."""
    q = np.uint64(p1.q)
    n1 = p1.n
    y = block[_bit_reverse_perm(n1)].copy()
    pw = p1.powers(p1.w)
    for s in range(n1.bit_length() - 1):
        m = 2 << s
        half = m >> 1
        idx = np.arange(n1).reshape(n1 // m, m)
        top = idx[:, :half].ravel()
        bot = idx[:, half:].ravel()
        w = np.tile(pw[(n1 // m) * np.arange(half)], n1 // m)[:, None]
        sim.charge_twiddle_writes(active_rows)
        sim.charge_column_op("copy", active_rows)
        sim.charge_row_ops(active_rows, cycles_per_row=2)
        sim.charge_column_op("copy", active_rows)
        sim.charge_row_ops(active_rows, cycles_per_row=2)
        u, v = sim.butterfly_rows_mod(y[top], y[bot], w, p1.q, active_rows)
        y[top], y[bot] = u, v
    assert (y < q).all()
    return y


def pim_ntt_distributed(x: np.ndarray, params: NTTParams, n_shards: int,
                        cfg: PIMConfig, spec: aritpim.IntSpec
                        ) -> PIMDistNTTResult:
    """Four-step NTT across ``n_shards`` crossbar arrays, value-exact.

    n = n1 * n2 with n1 = D shards and n2 = n / D = crossbar rows (each
    shard's working set is exactly one column of the array). Per-shard
    roots come from ``NTTParams.subparams``; the two inter-array transposes
    are periphery moves charged as BYTES (``a2a_bytes``, the ledger unit of
    the multi-device tiers), not cycles. Matches ``ref.ntt`` exactly and the
    closed forms ``ntt_distributed_latency_cycles`` /
    ``ntt_distributed_a2a_bytes`` (tests/test_pim_ntt.py).
    """
    n = params.n
    D = n_shards
    if D < 2 or D & (D - 1):
        raise ValueError(f"n_shards={D} must be a power of two >= 2")
    n2 = n // D
    assert n2 == cfg.crossbar_rows, \
        f"four-step PIM wants n/D == rows ({cfg.crossbar_rows}), got {n2}"
    p1 = params.subparams(D)
    p2 = params.subparams(n2)
    q = np.uint64(params.q)
    sims = [CrossbarSim(cfg, spec) for _ in range(D)]
    M = _residues(x, params.q).reshape(D, n2)          # row j1
    wcol = n2 // D
    # Step 1 transpose: shard s owns all j1 for j2 slice s.
    blocks = [M[:, s * wcol:(s + 1) * wcol].copy() for s in range(D)]
    pw = params.powers(params.w)
    for s, sim in enumerate(sims):
        y = _phase_a_ntt(sim, blocks[s], p1, active_rows=n2 // 2)
        # Step 3: twiddle w^{j2 k1} with GLOBAL j2 — one column-parallel
        # modmul over the shard's full working set.
        j2 = np.arange(s * wcol, (s + 1) * wcol)
        k1 = np.arange(D)[:, None]
        tw = pw[(k1 * j2[None, :]) % n]
        blocks[s] = (y * tw) % q
        sim.charge_column_op("modmul", cfg.crossbar_rows)
    # Step 4 transpose: shard s owns row k1 = s, all j2.
    Y = np.concatenate(blocks, axis=1)                 # (D=k1, n2=j2)
    Z = np.empty((D, n2), np.uint64)
    for s, sim in enumerate(sims):
        def transition(stage):
            sim.charge_column_op("copy", n2 // 2)
            sim.charge_row_ops(n2 // 2, cycles_per_row=2)
            sim.charge_column_op("copy", n2 // 2)
            sim.charge_row_ops(n2 // 2, cycles_per_row=2)
        sim.charge_row_ops(_perm_swap_count(n2), cycles_per_row=6,
                           tag="perm")
        Z[s] = _ntt_groups(sim, Y[s], p2, inverse=False, serial_units=1,
                           active_rows=n2 // 2, transition_fn=transition)
    # X[k1 + k2 n1] = Z[k1, k2]: natural-order assembly (host-side view).
    out = Z.T.reshape(n)
    return PIMDistNTTResult(
        output=out,
        shard_counters=tuple(s.ctr for s in sims),
        a2a_bytes=ntt_distributed_a2a_bytes(n, D, spec),
        logs=tuple(tuple(s.log) for s in sims))


def ntt_distributed_latency_cycles(n: int, n_shards: int, cfg: PIMConfig,
                                   spec: aritpim.IntSpec) -> int:
    """Closed-form per-shard cycles of the four-step NTT (== every shard's
    simulator counter): log2(D) r-layout stages for the column transforms,
    one twiddle modmul, then a full r-layout NTT of length n/D."""
    D = n_shards
    n2 = n // D
    r = cfg.crossbar_rows
    assert n2 == r, (n, D, r)
    word = spec.word_bits
    stage_a = (r // 2                                  # twiddle writes
               + 2 * aritpim.copy_cycles(word) + 2 * (r // 2) * 2
               + aritpim.ntt_butterfly_cycles(spec))
    phase_a = (D.bit_length() - 1) * stage_a
    twiddle = aritpim.mod_mul_cycles(spec)
    phase_b = ntt_latency_cycles(n2, cfg, spec, charge_perm=True)
    return phase_a + twiddle + phase_b


def ntt_distributed_a2a_bytes(n: int, n_shards: int,
                              spec: aritpim.IntSpec) -> int:
    """Inter-array transpose traffic of the four-step NTT: two all-to-all
    transposes, each moving every residue word once (same accounting unit
    as ``core.ntt.distributed.four_step_collective_stats``)."""
    del n_shards  # traffic is layout-independent: every word moves twice
    return 2 * n * (aritpim.storage_word_bits(spec) // 8)
