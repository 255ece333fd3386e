"""Faithful reproduction of FourierPIM on its own terms: the logical
crossbar simulator, AritPIM cost model, r/2r/2r-beta FFT mappings,
convolution-theorem polymul, and the cuFFT baseline models (paper §6).

Port of ``repro.core.pim``: numpy copies that import nothing of the
reference, with the same exports, pinned equal to the originals by
``tests/test_torch_pim.py``. The H100 beside the paper's GPUs lives in
``repro_torch.core.pim.hopper``, outside the copies."""
from repro_torch.core.pim.aritpim import (
    FP16, FP32, INT16, INT32, FloatSpec, IntSpec, butterfly_cycles,
    complex_word_bits, mod_add_cycles, mod_mul_cycles,
    ntt_butterfly_cycles, op_cycles)
from repro_torch.core.pim.crossbar import Counters, CrossbarSim
from repro_torch.core.pim.faults import ArrayFaults, FaultModel, SparesExhausted
from repro_torch.core.pim.device_model import (
    A100, FOURIERPIM_8, FOURIERPIM_40, FULL_COMPLEX_BITS,
    HALF_COMPLEX_BITS, GPUConfig, PIMConfig, RTX3070, with_partitions)
from repro_torch.core.pim.fft_pim import (
    PIMDistRFFTResult, PIMFFTResult, PIMRFFTResult, fft_2r, fft_2rbeta,
    fft_distributed_a2a_bytes, fft_distributed_latency_cycles,
    fft_energy_j_per_op, fft_latency_cycles, fft_throughput_per_s, pim_fft,
    pim_rfft, pim_rfft_distributed, r_fft, realpack_unpack_cycles,
    rfft_distributed_a2a_bytes, rfft_distributed_latency_cycles,
    rfft_distributed_permute_bytes, rfft_latency_cycles,
    rfft_throughput_per_s)
from repro_torch.core.pim.polymul_pim import (
    PIMPolymulResult, pim_polymul, pim_polymul_real,
    polymul_energy_j_per_op, polymul_latency_cycles,
    polymul_real_batch_latency_cycles, polymul_real_pair_latency_cycles,
    polymul_throughput_per_s)
from repro_torch.core.pim.ntt_pim import (
    PIMDistNTTResult, PIMNTTResult, PIMRNSResult, batched_ntt_stats,
    ntt_2r, ntt_2rbeta, ntt_distributed_a2a_bytes,
    ntt_distributed_latency_cycles, ntt_energy_j_per_op,
    ntt_latency_cycles, ntt_polymul_latency_cycles, ntt_throughput_per_s,
    pim_ntt, pim_ntt_distributed, pim_ntt_polymul, pim_rns_polymul, r_ntt,
    rns_polymul_latency_cycles, rns_polymul_wave_stats)
from repro_torch.core.pim import gpu_model

__all__ = [
    "FP16", "FP32", "INT16", "INT32", "FloatSpec", "IntSpec",
    "butterfly_cycles", "complex_word_bits", "mod_add_cycles",
    "mod_mul_cycles", "ntt_butterfly_cycles", "op_cycles", "Counters",
    "CrossbarSim", "ArrayFaults", "FaultModel", "SparesExhausted",
    "A100", "FOURIERPIM_8", "FOURIERPIM_40",
    "FULL_COMPLEX_BITS", "HALF_COMPLEX_BITS", "GPUConfig", "PIMConfig",
    "RTX3070", "with_partitions", "PIMDistRFFTResult", "PIMFFTResult",
    "PIMRFFTResult", "fft_2r",
    "fft_2rbeta", "fft_distributed_a2a_bytes",
    "fft_distributed_latency_cycles", "fft_energy_j_per_op",
    "fft_latency_cycles",
    "fft_throughput_per_s", "pim_fft", "pim_rfft", "pim_rfft_distributed",
    "r_fft",
    "realpack_unpack_cycles", "rfft_distributed_a2a_bytes",
    "rfft_distributed_latency_cycles", "rfft_distributed_permute_bytes",
    "rfft_latency_cycles", "rfft_throughput_per_s",
    "PIMPolymulResult", "pim_polymul",
    "pim_polymul_real", "polymul_energy_j_per_op", "polymul_latency_cycles",
    "polymul_real_batch_latency_cycles", "polymul_real_pair_latency_cycles",
    "polymul_throughput_per_s", "PIMDistNTTResult", "PIMNTTResult",
    "PIMRNSResult", "batched_ntt_stats", "ntt_2r", "ntt_2rbeta",
    "ntt_distributed_a2a_bytes", "ntt_distributed_latency_cycles",
    "ntt_energy_j_per_op", "ntt_latency_cycles",
    "ntt_polymul_latency_cycles", "ntt_throughput_per_s", "pim_ntt",
    "pim_ntt_distributed", "pim_ntt_polymul", "pim_rns_polymul", "r_ntt",
    "rns_polymul_latency_cycles", "rns_polymul_wave_stats", "gpu_model",
]
