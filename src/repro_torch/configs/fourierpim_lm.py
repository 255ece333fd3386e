"""fourierpim-lm: the paper's primitive as a sequence model — FourierPIM
FFT-convolution token mixing (O(S log S)) in place of attention. Used by
examples/fourier_lm.py and the Fourier-mixing ablation benchmarks."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="fourierpim-lm", family="fourier",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=32768,
    mixer="fourier", fourier_taps=256, attention="none",
)
