"""Device models for the faithful FourierPIM reproduction (paper Table 1).

Port of ``repro.core.pim.device_model``: a numpy copy that imports
nothing of the reference, pinned equal to the original by
``tests/test_torch_pim.py``.

The paper evaluates on a cycle-accurate simulator parameterized by the RACER
architecture and the Bitlet model; we reproduce those parameters here. GPU
baselines are the two cards the paper measures cuFFT on.

Provenance of constants:
  * crossbar 1024x1024, clock 333.3 MHz, 6.4 fJ/gate, 8/40 GB, <=4
    partitions: paper Table 1 (RACER [5] / Bitlet [22] / PartitionPIM [25]).
  * GPU memory bandwidths / sizes: paper Table 1.
  * GPU board power: vendor TDP (RTX 3070: 220 W, A100-40GB: 400 W (SXM)).
    The paper measured power with nvidia-smi; TDP is the stand-in and the
    achieved-fraction knob below absorbs the difference (see EXPERIMENTS.md
    §Repro-calibration).
  * cuFFT efficiency: cuFFT is memory-bound at these sizes (paper Fig. 1);
    we model achieved bandwidth as a fraction of peak and a number of
    HBM round-trip passes per transform — both recorded explicitly.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class PIMConfig:
    name: str
    memory_bytes: int
    crossbar_rows: int = 1024
    crossbar_cols: int = 1024
    clock_hz: float = 333.3e6
    gate_energy_j: float = 6.4e-15
    partitions: int = 1              # parallel column-units per array (<=4)
    # Working-column model: AritPIM-style bit-serial arithmetic needs scratch
    # columns for carries / partial products / the twiddle constant. We
    # charge `temp_words` N-bit words of scratch per column-unit (shared
    # across the unit's butterfly). See DESIGN.md §PIM-area.
    temp_words: int = 4
    # Controller issue concurrency (Bitlet: the controller's micro-op issue
    # bandwidth bounds how many crossbars execute concurrently). Single
    # calibration constant of the reproduction, fit once so the
    # full-precision FFT throughput ratio vs the RTX 3070 matches the
    # paper's reported 5x (EXPERIMENTS.md §Repro-calibration); everything
    # else (trends, precision scaling, energy, polymul advantage) is left
    # to fall out of the structural model.
    concurrency: float = 0.75

    @property
    def num_crossbars(self) -> int:
        bits = self.crossbar_rows * self.crossbar_cols
        return int(self.memory_bytes * 8 // bits)

    def crossbars_per_fft(self, n: int, word_bits: int) -> float:
        """Fractional crossbar area of one n-point FFT (data + scratch).

        Data: snake layout, 2*beta words per row over r rows (n = 2 r beta);
        scratch: temp_words per active unit (x partitions). The paper's
        footnote 7 (dimension restricted by intermediate memristor area)
        falls out of this accounting: e.g. full-precision n=8K admits at
        most 2 partitions (512 data + 512 scratch columns), and n=16K
        (1024 data columns) spills scratch into a neighbouring array.
        """
        r = self.crossbar_rows
        beta = max(1, n // (2 * r))
        data_cols = 2 * beta * word_bits
        scratch_cols = self.temp_words * word_bits * self.partitions
        return (data_cols + scratch_cols) / self.crossbar_cols

    def valid_config(self, n: int, word_bits: int) -> bool:
        """Data must fit one crossbar's columns (multi-crossbar FFT is the
        paper's future work); scratch may spill to a paired array."""
        r = self.crossbar_rows
        beta = max(1, n // (2 * r))
        return 2 * beta * word_bits <= self.crossbar_cols

    def batch_capacity(self, n: int, word_bits: int) -> int:
        """Batched problems held by the memory. One FFT per crossbar (ops
        within an array are serial), discounted when scratch spills."""
        area = max(1.0, self.crossbars_per_fft(n, word_bits))
        return int(self.num_crossbars / area)


@dataclasses.dataclass(frozen=True)
class GPUConfig:
    name: str
    memory_bytes: int
    mem_bw_bytes: float
    board_power_w: float
    # Achieved fraction of peak bandwidth for cuFFT's streaming passes.
    # Fig. 1 of the paper shows cuFFT pinned to the memory roof; large
    # batched streaming workloads achieve 80-90% of peak.
    bw_efficiency: float = 0.90
    # cuFFT executes transforms that fit a threadblock's shared memory in a
    # single HBM pass (read + write); larger ones use the two-step
    # decomposition (sqrt(n)-sized smem sub-FFTs -> 2 passes, enough for any
    # n up to (smem/bytes)^2). The paper's footnote 8 observes exactly this
    # regime change at n=16K full precision ("a different linear trend").
    smem_bytes: int = 100 * 1024     # RTX 3070 (Ampere consumer): 100 KB/SM

    def fft_passes(self, n: int, word_bytes: int) -> int:
        return 1 if n * word_bytes <= self.smem_bytes else 2


FOURIERPIM_8 = PIMConfig(name="FourierPIM-8", memory_bytes=8 << 30)
FOURIERPIM_40 = PIMConfig(name="FourierPIM-40", memory_bytes=40 << 30)


def with_partitions(cfg: PIMConfig, p: int) -> PIMConfig:
    return dataclasses.replace(cfg, partitions=p,
                               name=f"{cfg.name}-p{p}")


RTX3070 = GPUConfig(name="RTX3070", memory_bytes=8 << 30,
                    mem_bw_bytes=448e9, board_power_w=220.0)
A100 = GPUConfig(name="A100", memory_bytes=40 << 30,
                 mem_bw_bytes=1555e9, board_power_w=400.0,
                 smem_bytes=164 * 1024)   # A100: 164 KB usable smem/SM

# Word widths, paper §6: full precision = 64-bit complex (2 x fp32),
# half precision = 32-bit complex (2 x fp16).
FULL_COMPLEX_BITS = 64
HALF_COMPLEX_BITS = 32
