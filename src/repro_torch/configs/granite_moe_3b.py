"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8 [ibm-granite family].

NOTE: the assignment lists both "MoE 40e top-8" and "32 experts top-8";
we take the structured config field (40 experts) — see DESIGN.md §5."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab_size=49155,
    attention="full",
    num_experts=40, experts_per_token=8,
)
