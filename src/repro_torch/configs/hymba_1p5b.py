"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads [arXiv:2411.13676].

Attention heads are sliding-window (the Hymba recipe keeps most layers
local; the parallel SSM heads carry the global summary), so long_500k runs
with O(window) attention + O(1) SSM state."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001,
    mixer="hymba", ssm_state=16,
    attention="swa", window=2048,
)
