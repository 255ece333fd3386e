"""cuFFT baseline model (paper §6, Table 1; roofline of Fig. 1).

Port of ``repro.core.pim.gpu_model``: a numpy copy that imports nothing of
the reference, pinned equal to the original by
``tests/test_torch_pim.py``.

The paper's own roofline (Fig. 1) shows cuFFT pinned against the memory
bandwidth roof on the RTX 3070 — FFT arithmetic intensity is ~log2(n)/8
FLOP/byte, far below the machine balance point. We therefore model cuFFT
throughput as streaming-bandwidth bound:

    t_fft = passes(n) * 2 * n * word_bytes / (BW * efficiency)

with `passes` = 1 while the transform fits a threadblock's shared memory
(cuFFT's single-pass regime for these sizes) and the multi-pass fallback
beyond — which reproduces the paper's footnote-8 regime change at n=16K
full precision on the 3070.

Energy = board power * time (the paper measures power with nvidia-smi).

Polynomial multiplication on the GPU (cuFFT + pointwise): 3 transforms of
the 2n-padded sequences plus one pointwise-multiply pass, each memory bound
— the paper's §6 explanation for why its polymul ratios beat its FFT ratios.
Real polymul uses the same Eq. (10) packing (2 transform-equivalents).
"""
from __future__ import annotations

from repro_torch.core.pim.device_model import GPUConfig


def fft_time_s(n: int, gpu: GPUConfig, word_bytes: int) -> float:
    passes = gpu.fft_passes(n, word_bytes)
    traffic = passes * 2 * n * word_bytes
    return traffic / (gpu.mem_bw_bytes * gpu.bw_efficiency)


def fft_throughput_per_s(n: int, gpu: GPUConfig, word_bytes: int) -> float:
    return 1.0 / fft_time_s(n, gpu, word_bytes)


def fft_energy_j_per_op(n: int, gpu: GPUConfig, word_bytes: int) -> float:
    return gpu.board_power_w * fft_time_s(n, gpu, word_bytes)


def _pointwise_time_s(n: int, gpu: GPUConfig, word_bytes: int) -> float:
    # read two operands + write product, streaming
    return 3 * n * word_bytes / (gpu.mem_bw_bytes * gpu.bw_efficiency)


def polymul_time_s(n: int, gpu: GPUConfig, word_bytes: int,
                   *, real: bool = False) -> float:
    """Polymul at transform dimension n (inputs of degree n/2 zero-padded to
    n, paper footnote 4 — benchmark dimensions index the transform size so
    PIM and GPU run identical transforms).

    complex: FFT(a), FFT(b), pointwise, IFFT = 3 transforms + 1 pointwise.
    real:    Eq. (10) packing = 2 transform-equivalents + unpack + pointwise.
    """
    n_transforms = 2 if real else 3
    t = n_transforms * fft_time_s(n, gpu, word_bytes)
    t += _pointwise_time_s(n, gpu, word_bytes)
    if real:
        t += _pointwise_time_s(n, gpu, word_bytes)  # unpack pass
    return t


def polymul_throughput_per_s(n: int, gpu: GPUConfig, word_bytes: int,
                             *, real: bool = False) -> float:
    return 1.0 / polymul_time_s(n, gpu, word_bytes, real=real)


def polymul_energy_j_per_op(n: int, gpu: GPUConfig, word_bytes: int,
                            *, real: bool = False) -> float:
    return gpu.board_power_w * polymul_time_s(n, gpu, word_bytes, real=real)
