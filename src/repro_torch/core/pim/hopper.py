"""The H100 beside the paper's GPUs, for the cuFFT baseline model.

``device_model`` stays an exact copy of the reference's, with only the two
cards the paper measured (``RTX3070``, ``A100``); the card this port runs
on is described here, in the same ``GPUConfig`` terms, so
``gpu_model.fft_time_s`` can put the paper's cuFFT model beside the times
``chip_smoke.py`` measures on it.
"""
from __future__ import annotations

from repro_torch.core.pim.device_model import GPUConfig

#: NVIDIA H100 SXM5 80GB, from NVIDIA's data sheet (HBM3, 3.35 TB/s; 700 W
#: maximum board power, the power limit the measured card ran at) and the
#: Hopper tuning guide (up to 228 KB of shared memory per SM). With 8-byte
#: fp32 complex words ``fft_passes`` gives one pass up to n = 16384 and two
#: from 32768. ``bw_efficiency`` keeps the paper model's 0.90.
H100 = GPUConfig(name="H100", memory_bytes=80 << 30, mem_bw_bytes=3.35e12,
                 board_power_w=700.0, smem_bytes=228 * 1024)
