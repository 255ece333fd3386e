"""rwkv6-7b [ssm]: 32L d_model=4096 (attention-free) d_ff=14336 vocab=65536
— Finch: data-dependent decay linear attention [arXiv:2404.05892].

The recurrence is not an LTI convolution (decay is input-dependent), so the
FourierPIM convolution theorem does not apply — runs without the technique
(DESIGN.md §Arch-applicability). O(1) state => long_500k supported."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
    d_ff=14336, vocab_size=65536,
    mixer="rwkv6", attention="none",
)
