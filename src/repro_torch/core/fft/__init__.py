"""Fourier ops of the local tier (port of ``repro.core.fft``).

Public surface:
  fft / ifft / polymul / realpack_fft / fft_causal_conv   (kernels.ops)
  rfft / irfft / polymul_real                             (real fast path)
  packed_to_halfspec / halfspec_to_packed                 (layout converters)
  plan / FFTPlan                                          (planner)
"""
from repro_torch.kernels.ops import (fft, fft_causal_conv,
                                     halfspec_to_packed, ifft, irfft,
                                     packed_to_halfspec, polymul,
                                     polymul_real, realpack_fft, rfft)
from repro_torch.core.fft.planner import FFTPlan, plan

__all__ = [
    "fft", "ifft", "rfft", "irfft", "polymul", "polymul_real",
    "realpack_fft", "fft_causal_conv",
    "packed_to_halfspec", "halfspec_to_packed",
    "FFTPlan", "plan",
]
