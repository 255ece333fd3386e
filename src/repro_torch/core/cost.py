"""Unified cost model behind the planner's auto mode (port of
``repro.core.cost``).

One module owns every number the planner compares, so the comparison is
apples-to-apples:

  * **PIM closed forms** (``core.pim.fft_pim`` / ``polymul_pim`` /
    ``ntt_pim``): bit-serial cycle counts, pinned equal to the
    ``CrossbarSim`` counters by the reference's tests and to the
    reference's own closed forms by ``tests/test_torch_pim.py``. Every PIM
    term is the reference's, unchanged.
  * **Roofline of the card** (backend ``"cuda"``, the reference's
    ``"xla"``): the reference's flop and byte formulas
    (``_cuda_local_terms``, its ``_xla_local_terms`` unchanged) over the
    H100 rates ``PERF.md``'s kernel table bounds its kernels with.

``workload_cost(workload, n, batch, ...)`` enumerates every (tier,
packing) candidate the port's kernels execute (the planner only ever
returns plans the kernels accept), scores each on both backends (PIM
cost twin and the card's roofline), and returns the predicted-cheapest
candidate plus a machine-readable breakdown. Every pruned candidate
carries the NAME of the constraint that pruned it: the port's on-chip
ceiling (``local_prune_reason``), and for the distributed four-step tier
the device count and the ``D^2 | n`` tilings (``dist_prune_reason``).
``verified=True`` prices the ABFT integrity check (``ft/abft.py``) on both
backends, as the reference does, and ``pim_ok=False`` takes the PIM
backend off the table.

Accounting conventions:

  * Card: ``total = max(t_compute, t_memory) + t_collective``, the
    roofline max of the on-chip terms, at ``HBM_BW`` and, for the
    operations, ``PEAK_FLOPS`` (the float workloads run fp32 on the CUDA
    cores) or ``PEAK_INT_OPS`` (``polymul-mod``'s Montgomery arithmetic on
    32-bit integers), plus the exchanges. The distributed tier charges the
    ledger bytes of ``four_step_collective_stats`` (``_cuda_collective_
    bytes``), priced by where the mesh puts its shards (``mesh_cards``):
    one shard a card splits the on-chip work D ways and sends each shard's
    ledger bytes over NVLink at ``LINK_BW``; shards sharing a card do all
    the work on it and copy every shard's block in device memory (read
    and written: 2 bytes of HBM traffic a ledger byte a shard).
  * PIM local: steady-state batched throughput (every crossbar runs the
    schedule in parallel, net of scratch area: the paper's §6 model).
  * PIM distributed: one in-flight transform holds one crossbar on each
    of the D shards, so ``num_crossbars * concurrency`` units pipeline;
    inter-shard transpose bytes cross each shard's link at
    ``bytes/D / LINK_BW``. Only valid under the ``n1 = D`` cap
    (``n == D * crossbar_rows``) that the closed forms assert.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.core.pim import aritpim
from repro_torch.core.pim.device_model import FOURIERPIM_8, PIMConfig
from repro_torch.core.pim.fft_pim import (
    fft_distributed_a2a_bytes,
    fft_distributed_latency_cycles,
    fft_latency_cycles,
    fft_throughput_per_s,
    realpack_unpack_cycles,
    rfft_distributed_a2a_bytes,
    rfft_distributed_latency_cycles,
    rfft_distributed_permute_bytes,
    rfft_latency_cycles,
    rfft_throughput_per_s,
)
from repro_torch.core.pim.ntt_pim import (
    ntt_distributed_a2a_bytes,
    ntt_distributed_latency_cycles,
    ntt_polymul_latency_cycles,
)
from repro_torch.core.pim.polymul_pim import (
    polymul_latency_cycles,
    polymul_real_batch_latency_cycles,
    polymul_throughput_per_s,
)
from repro_torch.kernels.fft import (SMEM_MAX_BYTES, TWO_PASS_MAX_SUB,
                                     resident, two_pass_split)
from repro_torch.ft import abft
from repro_torch.kernels.ntt import ntt_resident

# The card's rates (NVIDIA H100 SXM data sheet), as PERF.md's kernel table
# bounds the kernels with them.
HBM_BW = 3.35e12           # bytes/s of HBM3
PEAK_FLOPS = 67e12         # fp32 FLOP/s on the CUDA cores (no tensor cores)
#: 32-bit integer operations per second: 132 SMs x 64 integer lanes an SM
#: a clock (the CUDA programming guide's throughput table for compute
#: capability 9.0) x 1.98 GHz, as ``chip_smoke.py``'s ``INT32_OPS_PER_S``.
PEAK_INT_OPS = 132 * 64 * 1.98e9
#: bytes/s one H100 SXM sends to another over NVLink 4, one direction
#: (900 GB/s both ways; NVIDIA's data sheet). Unmeasured: the card the
#: port is measured on is alone on its host.
LINK_BW = 450e9

#: Workloads the chooser understands: exactly the ``OpSpec`` registry names
#: (launch/ops.py), so serve buckets can ask for costs verbatim.
WORKLOADS = ("fft", "rfft", "polymul", "polymul-real", "polymul-mod")
#: the workloads whose route is a fused product (``plan(product=True)``)
PRODUCTS = ("polymul", "polymul-real", "polymul-mod")

_PIM_CFG = FOURIERPIM_8
_FP = aritpim.FP32
_INT = aritpim.INT32


@dataclasses.dataclass(frozen=True)
class TierCost:
    """Predicted cost of one executable (tier, packing) candidate on one
    backend. ``total_s`` is the comparison key; the component terms and
    raw PIM cycle / collective byte counts ride along so tests can pin
    them against the reference's."""
    tier: str               # "local" | "distributed"
    backend: str            # "pim" | "cuda"
    real: bool
    exact: bool
    seq_shards: int
    total_s: float
    t_compute_s: float = 0.0
    t_memory_s: float = 0.0
    t_collective_s: float = 0.0
    pim_cycles: int = 0           # per-unit closed-form latency (pim only)
    collective_bytes: int = 0     # per-batch interconnect bytes

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _require_pow2(n: int) -> None:
    if n <= 0 or n & (n - 1):
        raise ValueError(f"n={n} must be a power of two")


def _word_bits(*, real: bool, exact: bool) -> int:
    if exact:
        return _INT.word_bits
    # Real rows pack pairwise into full complex words; the per-row
    # capacity doubling is carried by the throughput closed forms, so
    # crossbar feasibility is judged at the complex word width.
    return aritpim.complex_word_bits(_FP)


# ---------------------------------------------------------------------------
# Executability constraints: each returns None (ok) or the prune reason.
# The reason strings NAME the constraint; tests pin them.
# ---------------------------------------------------------------------------

def route_kind(workload: str, real: bool) -> tuple[bool, bool, bool]:
    """(real, product, exact) of the kernels a (workload, packing)
    candidate runs: a complex-packing candidate of a real workload runs
    the complex kernels on cast-up rows."""
    exact = workload == "polymul-mod"
    return (real and not exact, workload in PRODUCTS, exact)


def _on_chip(n: int, real: bool, product: bool, exact: bool) -> bool:
    """Whether the kernels keep an n-point row on chip: resident in one
    CTA's shared memory, or split n1 x n2 into two passes whose
    sub-problems each fit one CTA."""
    if exact:
        return ntt_resident(n) or two_pass_split(n, 2, product=True) \
            is not None
    radix = 4 if n >= 4 else 2
    return (resident(n, real=real, product=product)
            or two_pass_split(n, radix, real=real, product=product)
            is not None)


@functools.lru_cache(maxsize=None)
def local_ceiling(real: bool, product: bool, exact: bool) -> int:
    """Longest n the port's kernels of this kind keep on chip (past it a
    row stages its sweeps through device memory, and the byte formulas'
    one crossing of each operand no longer holds), from ``SMEM_MAX_BYTES``
    and ``TWO_PASS_MAX_SUB`` as the planner's splits use them: 2^25 points
    for the fft, the rfft and the complex and exact products, 2^23 for the
    real product (its pass 2 holds four sub-problems a CTA, and at radix 4
    the split n1 = 8192 x 2048 of 2^24 is off the sweep sequence)."""
    n, best = 2, 0
    while n <= TWO_PASS_MAX_SUB ** 2:
        if _on_chip(n, real, product, exact):
            best = n
        n *= 2
    return best


def local_prune_reason(workload: str, n: int, *, real: bool) -> str | None:
    """Local tier: the row must stay on chip in the kernels the candidate
    runs (``local_ceiling``)."""
    kind = route_kind(workload, real)
    cap = local_ceiling(*kind)
    if n > cap:
        return (f"local tier: n={n} exceeds the on-chip ceiling {cap} of "
                f"the {'real ' if kind[0] else ''}"
                f"{'exact ' if kind[2] else ''}"
                f"{'product' if kind[1] else 'transform'} kernels (no row "
                f"fits SMEM_MAX_BYTES={SMEM_MAX_BYTES} and no two-pass "
                f"split keeps its sub-problems within "
                f"TWO_PASS_MAX_SUB={TWO_PASS_MAX_SUB} points)")
    return None


def dist_prune_reason(workload: str, n: int, n_devices: int, *,
                      real: bool) -> str | None:
    """Four-step tier: device count and transpose tiling."""
    if n_devices <= 1:
        return ("distributed tier: four-step needs model_shards > 1 "
                f"(have {n_devices})")
    d2 = n_devices * n_devices
    if n % d2:
        return (f"distributed tier: four-step tiling needs D^2 | n "
                f"(transposes + twiddle blocks): n={n}, D^2={d2}")
    if real and workload == "rfft" and n % (2 * d2):
        return (f"distributed real tier: the ordered rfft's half-width "
                f"ordering all-to-all needs 2*D^2 | n: n={n}, "
                f"2*D^2={2 * d2}")
    return None


def pim_local_infeasible(workload: str, n: int,
                         cfg: PIMConfig = _PIM_CFG) -> str | None:
    """PIM cost twin, local tier: one sequence must fit one crossbar's
    columns (``PIMConfig.valid_config``: the paper's footnote 7)."""
    real = workload in ("rfft", "polymul-real")
    exact = workload == "polymul-mod"
    word = _word_bits(real=real, exact=exact)
    if not cfg.valid_config(n, word):
        beta = max(1, n // (2 * cfg.crossbar_rows))
        return (f"pim local: 2*beta*word_bits={2 * beta * word} exceeds "
                f"crossbar_cols={cfg.crossbar_cols} (valid_config: "
                f"multi-crossbar FFT is the paper's future work)")
    return None


def pim_dist_infeasible(n: int, n_devices: int,
                        cfg: PIMConfig = _PIM_CFG) -> str | None:
    """PIM cost twin, distributed tier: the closed forms assert the
    ``n1 = D`` four-step cap (each shard's block is exactly one r-config
    crossbar column: n2 = n/D == crossbar_rows)."""
    if n_devices <= 1:
        return "pim distributed: needs model_shards > 1"
    r = cfg.crossbar_rows
    if n != n_devices * r:
        return (f"pim distributed: closed forms need n2 = n/D == "
                f"crossbar_rows={r} (the n1 = D four-step cap): "
                f"n={n}, D={n_devices}, n/D={n // n_devices}")
    return None


# ---------------------------------------------------------------------------
# The card's roofline
# ---------------------------------------------------------------------------

def _cuda_local_terms(workload: str, n: int, batch: int, *,
                      real: bool) -> tuple[float, float]:
    """(flops, hbm_bytes) of one local batched call: the reference's
    ``_xla_local_terms``, unchanged.

    FFT flop model: 5 n log2 n per complex transform; real packing runs
    batch/2 packed transforms plus O(n) unpack adds. Byte model: each
    operand/result crosses device memory exactly once (the twiddle tables
    are not counted; ``chip_smoke.py``'s ``work()`` adds them).
    ``polymul-mod`` counts 8 integer operations a Montgomery butterfly,
    where ``chip_smoke.py``'s ``ntt_work`` counts ``BUTTERFLY_OPS``.
    """
    lg = n.bit_length() - 1
    fft_flops = 5.0 * n * lg
    # repro: noqa[dispatch-ladder]: per-workload closed-form flop/byte FORMULAS (cost-model data, not op dispatch) — executable routes bind through the launch/ops.py registry
    if workload == "fft":  # repro_torch: noqa[dispatch-ladder]: per-workload closed-form flop/byte FORMULAS (cost-model data, not op dispatch); served ops bind through the launch/ops.py registry
        flops = batch * fft_flops
        nbytes = batch * 2 * n * 8                      # c64 in + out
    elif workload == "rfft":
        if real:
            flops = batch * (fft_flops / 2 + 4.0 * n)   # packed + unpack
            nbytes = batch * (n * 4 + n * 4)            # f32 in, half c64 out
        else:                                           # complex fallback
            flops = batch * fft_flops
            nbytes = batch * (2 * n * 8)
    elif workload == "polymul":
        flops = batch * (3 * fft_flops + 6.0 * n)
        nbytes = batch * 3 * n * 8                      # a, b in + out
    elif workload == "polymul-real":
        if real:   # paired inverse: ~1.5 transform-equivalents/product
            flops = batch * (1.5 * fft_flops + 12.0 * n)
            nbytes = batch * 3 * n * 4                  # f32 a, b, out
        else:      # cast-to-complex fallback: full complex product
            flops = batch * (3 * fft_flops + 6.0 * n)
            nbytes = batch * 3 * n * 8
    elif workload == "polymul-mod":
        # Montgomery butterfly ~ 8 int-op equivalents; 3 transforms +
        # pointwise + negacyclic twists.
        flops = batch * (3 * 8.0 * (n / 2) * lg + 4.0 * 2 * n)
        nbytes = batch * 3 * n * 4                      # u32 a, b, out
    else:
        raise ValueError(f"unknown workload {workload!r}")
    return flops, nbytes


#: the ``four_step_collective_stats`` op of each (workload, real packing)
#: candidate: the complex-packing candidates of the real workloads run the
#: complex routes
_LEDGER_OP = {("fft", False): "fft", ("rfft", True): "rfft",
              ("rfft", False): "fft", ("polymul", False): "polymul",
              ("polymul-real", True): "polymul_real",
              ("polymul-real", False): "polymul"}


def _cuda_collective_bytes(workload: str, n: int, batch: int,
                           n_devices: int, *, real: bool) -> int:
    """Ledger bytes of one distributed call: the
    ``four_step_collective_stats`` closed forms (pinned against the live
    ledger), with the zero row the real tiers pair an odd batch's last
    row with (``pad_pairs``) folded in."""
    # lazy: the distributed tiers import ``core.fft``, whose planner
    # imports this module
    if workload == "polymul-mod":
        from repro_torch.core.ntt.distributed import \
            four_step_collective_stats as ntt_stats
        return ntt_stats(n, batch, n_devices, op="polymul")["bytes"]
    from repro_torch.core.fft.distributed import four_step_collective_stats
    op = _LEDGER_OP[workload, real]
    if op in ("rfft", "polymul_real") and batch % 2:
        batch += 1                      # the real tiers pad odd batches
    return four_step_collective_stats(n, batch, n_devices,
                                      op=op)["total_bytes"]


def mesh_cards(n_devices: int) -> int:
    """Cards a mesh of ``n_devices`` shards spans: ``dist.sharding.
    make_mesh`` deals shards round-robin over the visible cards (one
    where none is visible, as on the CPU)."""
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return max(1, min(n_devices, visible))


def cuda_cost(workload: str, n: int, batch: int, *, tier: str = "local",
              n_devices: int = 1, real: bool = False,
              verified: bool = False) -> TierCost:
    """The card's roofline time of one batched call; ``verified`` adds the
    reference's price of the ABFT check (its ``xla_cost`` term).

    The distributed tier runs ``n_devices`` shards on the ``mesh_cards``
    cards the mesh spans, ``s = ceil(D / cards)`` shards a card: each card
    does s/D of the on-chip work, and the exchanges move s shards' ledger
    bytes a card, over NVLink at ``LINK_BW`` where the mesh spans cards,
    else as copies in device memory (each byte read and written at
    ``HBM_BW``)."""
    exact = workload == "polymul-mod"
    flops, nbytes = _cuda_local_terms(workload, n, max(batch, 1), real=real)
    if verified:
        # Host-side integrity check (ft/abft.py): O(n) reductions over
        # each operand/result row plus one more pass over the result.
        ops = {"fft": 2, "rfft": 2}.get(workload, 3)
        flops += max(batch, 1) * ops * 4.0 * n
        nbytes += max(batch, 1) * n * 8
    coll, t_coll, shards = 0, 0.0, 1
    if tier == "distributed":
        shards = n_devices
        cards = mesh_cards(n_devices)
        per_card = math.ceil(n_devices / cards)
        flops *= per_card / n_devices
        nbytes *= per_card / n_devices
        coll = _cuda_collective_bytes(workload, n, max(batch, 1),
                                      n_devices, real=real)
        t_coll = per_card * coll * (1 / LINK_BW if cards > 1
                                    else 2 / HBM_BW)
    t_comp = flops / (PEAK_INT_OPS if exact else PEAK_FLOPS)
    t_mem = nbytes / HBM_BW
    return TierCost(tier=tier, backend="cuda", real=real, exact=exact,
                    seq_shards=shards, total_s=max(t_comp, t_mem) + t_coll,
                    t_compute_s=t_comp, t_memory_s=t_mem,
                    t_collective_s=t_coll, collective_bytes=coll)


# ---------------------------------------------------------------------------
# PIM cost-twin estimates
# ---------------------------------------------------------------------------

def abft_check_cycles(workload: str, n: int, *,
                      cfg: PIMConfig = _PIM_CFG) -> int:
    """Closed-form cycles of one ABFT integrity check (ft/abft.py) at the
    planner's default device model: the quantity ``verified=True`` pricing
    adds per work unit."""
    spec = _INT if workload == "polymul-mod" else _FP
    return abft.check_cycles(workload, n, cfg, spec)


def pim_local_unit_cycles(workload: str, n: int, *, batch: int = 2,
                          cfg: PIMConfig = _PIM_CFG) -> int:
    """Closed-form latency cycles of one unit of work on one crossbar.

    Units: one transform (fft), one packed run of TWO real rows (rfft),
    one product (polymul / polymul-mod), a ``batch``-product real call
    (polymul-real: pairs share the inverse, so cycles are per-call)."""
    if workload == "fft":
        return fft_latency_cycles(n, cfg, _FP)
    if workload == "rfft":
        return rfft_latency_cycles(n, cfg, _FP)
    if workload == "polymul":
        return polymul_latency_cycles(n, cfg, _FP)
    if workload == "polymul-real":
        return polymul_real_batch_latency_cycles(n, batch, cfg, _FP)
    if workload == "polymul-mod":
        return ntt_polymul_latency_cycles(n, cfg, _INT)
    raise ValueError(f"unknown workload {workload!r}")


def _pim_local_throughput(workload: str, n: int,
                          cfg: PIMConfig = _PIM_CFG) -> float:
    if workload == "fft":
        return fft_throughput_per_s(n, cfg, _FP)
    if workload == "rfft":
        return rfft_throughput_per_s(n, cfg, _FP)
    if workload == "polymul":
        return polymul_throughput_per_s(n, cfg, _FP, real=False)
    if workload == "polymul-real":
        return polymul_throughput_per_s(n, cfg, _FP, real=True)
    # polymul-mod: mirror polymul_throughput_per_s's operand-area
    # accounting at the residue word width (a and b both resident).
    lat = ntt_polymul_latency_cycles(n, cfg, _INT) / cfg.clock_hz
    word = _INT.word_bits
    beta = max(1, n // (2 * cfg.crossbar_rows))
    data_cols = 2 * 2 * beta * word
    scratch = cfg.temp_words * word * cfg.partitions
    area = max(1.0, (data_cols + scratch) / cfg.crossbar_cols)
    return int(cfg.num_crossbars / area) * cfg.concurrency / lat


def pim_dist_unit_cycles(workload: str, n: int, n_devices: int, *,
                         cfg: PIMConfig = _PIM_CFG) -> int:
    """Per-shard closed-form cycles of one distributed unit. Transforms
    use the pinned dist closed forms; the polymul workloads compose them
    (2 forwards + 1 inverse + pointwise), mirroring the local forms."""
    spec = _FP
    serial = 1                      # n2 == r: beta = 1 per shard block
    if workload == "fft":
        return fft_distributed_latency_cycles(n, n_devices, cfg, spec)
    if workload == "rfft":
        return rfft_distributed_latency_cycles(n, n_devices, cfg, spec)
    if workload == "polymul":
        return (3 * fft_distributed_latency_cycles(n, n_devices, cfg, spec)
                + aritpim.complex_mul_cycles(spec) * serial)
    if workload == "polymul-real":
        # Per PAIR: 2 packed forwards + 1 inverse + 2 unpacks + 2 cmuls
        # + the Q-pack (same schedule as the local paired form).
        return (3 * fft_distributed_latency_cycles(n, n_devices, cfg, spec)
                + 2 * realpack_unpack_cycles(cfg, spec)
                + 2 * aritpim.complex_mul_cycles(spec))
    if workload == "polymul-mod":
        return (3 * ntt_distributed_latency_cycles(n, n_devices, cfg, _INT)
                + 4 * aritpim.mod_mul_cycles(_INT))
    raise ValueError(f"unknown workload {workload!r}")


def pim_dist_unit_bytes(workload: str, n: int, n_devices: int) -> int:
    """Inter-array transpose traffic of one distributed unit (global
    bytes across the fabric), from the pinned per-transform formulas."""
    if workload == "fft":
        return fft_distributed_a2a_bytes(n, _FP, ordered=True)
    if workload == "rfft":
        return (rfft_distributed_a2a_bytes(n, _FP)
                + rfft_distributed_permute_bytes(n, _FP))
    if workload == "polymul":
        # 2 fwd + 1 inv, two transposes each, no ordering move needed
        # inside the product: 6 full-width transform widths.
        return 3 * fft_distributed_a2a_bytes(n, _FP, ordered=False)
    if workload == "polymul-real":
        # Per PAIR: 3 packed transforms (2 transposes each) + the mirror
        # permute: the PIM twin of the four-step tier's 3.5-block-unit
        # ratio.
        return (3 * fft_distributed_a2a_bytes(n, _FP, ordered=False)
                + rfft_distributed_permute_bytes(n, _FP))
    if workload == "polymul-mod":
        return 3 * ntt_distributed_a2a_bytes(n, n_devices, _INT)
    raise ValueError(f"unknown workload {workload!r}")


def _pim_workload(workload: str, real: bool) -> str:
    """Effective PIM schedule for a (workload, packing) candidate: the
    complex-fallback candidates of the real workloads run the plain
    complex schedules on the crossbar, exactly as they do on the card."""
    if not real:
        if workload == "rfft":
            return "fft"
        if workload == "polymul-real":
            return "polymul"
    return workload


def _pim_units(workload: str, batch: int, *, real: bool) -> int:
    """Work units in a batch: packed real transforms carry two rows per
    run; real products pair per-call (pairs already amortized inside the
    closed forms, so units = calls of the batch form)."""
    if workload == "rfft" and real:
        return max(1, math.ceil(batch / 2))
    if workload == "polymul-real" and real:
        return 1            # one batched call; cycles already batch-wide
    return max(batch, 1)


def pim_cost(workload: str, n: int, batch: int, *, tier: str = "local",
             n_devices: int = 1, real: bool = False,
             verified: bool = False,
             cfg: PIMConfig = _PIM_CFG) -> TierCost:
    """The PIM twin's time of one batched call: on the local tier
    ``batch`` units at the crossbars' steady-state throughput, on the
    distributed tier waves of units over the D shards' crossbars plus the
    transposes over the link (the reference's terms; its link is the
    TPU's, this one the card's ``LINK_BW``)."""
    exact = workload == "polymul-mod"
    batch = max(batch, 1)
    wl = _pim_workload(workload, real)
    check = abft_check_cycles(wl, n, cfg=cfg) if verified else 0
    if tier == "local":
        unit_cycles = pim_local_unit_cycles(wl, n, batch=batch, cfg=cfg)
        t = batch / _pim_local_throughput(wl, n, cfg)
        if verified:
            # The check rides the same vectored column ops as the
            # transform (batch rows in parallel), so throughput scales by
            # the per-unit cycle stretch.
            t *= (unit_cycles + check) / unit_cycles
            unit_cycles += check
        return TierCost(tier="local", backend="pim", real=real, exact=exact,
                        seq_shards=1, total_s=t, t_compute_s=t,
                        pim_cycles=unit_cycles)
    unit_cycles = pim_dist_unit_cycles(wl, n, n_devices, cfg=cfg) + check
    unit_bytes = pim_dist_unit_bytes(wl, n, n_devices)
    units = _pim_units(workload, batch, real=real)
    if workload == "polymul-real" and real:
        units = max(1, math.ceil(batch / 2))    # dist form is per pair
    capacity = max(1, int(cfg.num_crossbars * cfg.concurrency))
    waves = math.ceil(units / capacity)
    t_comp = waves * unit_cycles / cfg.clock_hz
    coll = units * unit_bytes
    t_coll = (coll / n_devices) / LINK_BW
    return TierCost(tier="distributed", backend="pim", real=real,
                    exact=exact, seq_shards=n_devices,
                    total_s=t_comp + t_coll, t_compute_s=t_comp,
                    t_collective_s=t_coll, pim_cycles=unit_cycles,
                    collective_bytes=coll)


# ---------------------------------------------------------------------------
# The chooser
# ---------------------------------------------------------------------------

def _packings(workload: str) -> list[bool]:
    """Packing candidates (``real`` flag values) per workload. Real
    workloads may fall back to complex packing (cast + full-width route):
    on one card where the real kernels' on-chip ceiling is below the
    complex kernels' (``local_ceiling``)."""
    if workload in ("rfft", "polymul-real"):
        return [True, False]
    return [False]


def workload_cost(workload: str, n: int, batch: int, *,
                  n_devices: int = 1,
                  tiers: tuple[str, ...] = ("local", "distributed"),
                  packings: list[bool] | None = None,
                  verified: bool = False, pim_ok: bool = True) -> dict:
    """Score every executable (tier, packing) candidate on both backends.

    ``verified=True`` prices the ABFT integrity check on both backends
    (``abft_check_cycles`` on PIM, the O(n) host reductions on the card),
    so a verified serve bucket's predicted costs include the checksum
    overhead. ``pim_ok=False`` marks the PIM backend infeasible on every
    candidate (a serve bucket whose crossbar array is quarantined re-plans
    with the PIM placement off the table). ``n_devices`` is the shard
    count the distributed candidates run on (``tiers`` names the tiers
    to score).

    Returns a machine-readable breakdown::

        {"workload", "n", "batch", "n_devices",
         "candidates": [{"tier", "real", "exact", "seq_shards", "total_s",
                         "backend_best", "backends": {...}}, ...],
         "pruned":     [{"tier", "real", "exact", "reason"}, ...],
         "best":       <cheapest candidate or None>,
         "constants":  {"peak_flops", "peak_int_ops", "hbm_bw",
                        "link_bw", "cards"}}

    A candidate is listed iff the card can execute it (the planner never
    returns a plan ``bind()`` rejects); the PIM backend may be marked
    infeasible per candidate (crossbar columns, the ``n1 = D`` cap)
    without pruning the candidate itself: the plan still runs on the card,
    it just doesn't win a PIM placement.
    """
    _require_pow2(n)
    if workload not in WORKLOADS:
        raise ValueError(f"unknown workload {workload!r}; "
                         f"expected one of {WORKLOADS}")
    exact = workload == "polymul-mod"
    candidates, pruned = [], []
    for tier in tiers:
        for real in (packings if packings is not None
                     else _packings(workload)):
            reason = (local_prune_reason(workload, n, real=real)
                      if tier == "local" else
                      dist_prune_reason(workload, n, n_devices, real=real))
            if reason is not None:
                pruned.append({"tier": tier, "real": real, "exact": exact,
                               "reason": reason})
                continue
            backends = {}
            cc = cuda_cost(workload, n, batch, tier=tier,
                           n_devices=n_devices, real=real,
                           verified=verified)
            backends["cuda"] = cc.as_dict()
            if not pim_ok:
                pim_bad = ("quarantined (circuit breaker): pim backend "
                           "disabled for this bucket")
            elif tier == "local":
                pim_bad = pim_local_infeasible(
                    _pim_workload(workload, real), n)
            else:
                pim_bad = pim_dist_infeasible(n, n_devices)
            if pim_bad is None:
                pc = pim_cost(workload, n, batch, tier=tier,
                              n_devices=n_devices, real=real,
                              verified=verified)
                backends["pim"] = pc.as_dict()
                best_backend = ("pim" if pc.total_s <= cc.total_s
                                else "cuda")
                total = min(pc.total_s, cc.total_s)
            else:
                backends["pim"] = {"infeasible": pim_bad}
                best_backend, total = "cuda", cc.total_s
            candidates.append({"tier": tier, "real": real, "exact": exact,
                               "seq_shards": (n_devices
                                              if tier == "distributed"
                                              else 1),
                               "total_s": total,
                               "backend_best": best_backend,
                               "backends": backends})
    # Deterministic tie-break: cheapest first; on ties prefer local over
    # distributed (fewer moving parts), then real packing over complex
    # (the route the workload named). Sort is stable, so encode the
    # preference in the key.
    candidates.sort(key=lambda c: (c["total_s"],
                                   c["tier"] != "local",
                                   not c["real"]))
    return {"workload": workload, "n": n, "batch": batch,
            "n_devices": n_devices,
            "candidates": candidates, "pruned": pruned,
            "best": candidates[0] if candidates else None,
            "constants": {"peak_flops": PEAK_FLOPS,
                          "peak_int_ops": PEAK_INT_OPS, "hbm_bw": HBM_BW,
                          "link_bw": LINK_BW,
                          "cards": mesh_cards(n_devices)}}
