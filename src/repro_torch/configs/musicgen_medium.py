"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24, MHA) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284].

The EnCodec frontend is a STUB per the shape contract: input_specs()
provides precomputed frame embeddings (B, S, d_model); the backbone predicts
the 2048-way codebook tokens."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048,
    attention="full", frontend="embeddings",
)
