"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution [arXiv:2409.12191].

Vision frontend is a STUB: input_specs() provides the merged sequence of
precomputed patch+text embeddings plus (B, S, 3) M-RoPE position streams
(temporal / height / width)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064,
    attention="full", mrope_sections=(16, 24, 24),
    frontend="embeddings", rope_theta=1_000_000.0,
    param_dtype="bfloat16", remat="full",
)
