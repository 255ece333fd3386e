"""Fourier ops (port of ``repro.core.fft``).

Public surface:
  fft / ifft / polymul / realpack_fft / fft_causal_conv   (kernels.ops)
  rfft / irfft / polymul_real                             (real fast path)
  packed_to_halfspec / halfspec_to_packed                 (layout converters)
  fft_distributed / make_sharded_fft / make_sharded_polymul (four-step)
  rfft_distributed / irfft_distributed / polymul_real_distributed
  make_sharded_rfft / make_sharded_irfft / make_sharded_polymul_real
  four_step_collective_stats                               (byte ledger form)
  plan / FFTPlan                                          (planner)
"""
from repro_torch.kernels.ops import (fft, fft_causal_conv,
                                     halfspec_to_packed, ifft, irfft,
                                     packed_to_halfspec, polymul,
                                     polymul_real, realpack_fft, rfft)
from repro_torch.core.fft.distributed import (fft_distributed,
                                              four_step_collective_stats,
                                              irfft_distributed,
                                              make_sharded_fft,
                                              make_sharded_irfft,
                                              make_sharded_polymul,
                                              make_sharded_polymul_real,
                                              make_sharded_rfft,
                                              polymul_real_distributed,
                                              rfft_distributed)
from repro_torch.core.fft.planner import FFTPlan, plan

__all__ = [
    "fft", "ifft", "rfft", "irfft", "polymul", "polymul_real",
    "realpack_fft", "fft_causal_conv",
    "packed_to_halfspec", "halfspec_to_packed",
    "fft_distributed", "make_sharded_fft", "make_sharded_polymul",
    "rfft_distributed", "irfft_distributed", "polymul_real_distributed",
    "make_sharded_rfft", "make_sharded_irfft", "make_sharded_polymul_real",
    "four_step_collective_stats",
    "FFTPlan", "plan",
]
