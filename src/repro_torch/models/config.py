"""Model configuration dataclass for the architecture zoo (a copy of
``repro.models.config``, pinned field by field by the tests).

Every assigned architecture instantiates this one config (see
src/repro_torch/configs/<id>.py); the decoder in models/lm.py is entirely
config-driven. Reduced smoke-test variants use .scaled_down().
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads

    # --- attention structure ---
    attention: str = "full"       # full | swa | local_global | none
    window: int = 4096            # sliding-window size (swa / local layers)
    local_global_ratio: int = 0   # gemma3: 5 local layers per 1 global
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: Optional[tuple[int, int, int]] = None  # qwen2-vl M-RoPE

    # --- mixer selection ---
    mixer: str = "attn"           # attn | rwkv6 | hymba (parallel attn+ssm)
    ssm_state: int = 0            # state size for mamba-style heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_group_size: int = 1024    # GShard-style grouped dispatch
    capacity_factor: float = 1.25
    # dtype of the dispatch/combine one-hot tensors (router logits stay
    # fp32). bf16 halves the dominant MoE collective payloads — §Perf knob.
    moe_dispatch_dtype: str = "float32"
    # Output dtype of TP-partial matmuls (down-proj / out-proj / expert
    # einsums). jnp defaults bf16 dots to f32 outputs, so XLA all-reduces
    # f32 partial sums; "bfloat16" halves every TP collective payload
    # (fwd and bwd) at the standard mixed-precision accuracy trade.
    reduce_dtype: str = "float32"

    # --- FourierPIM tie-in (paper §5 primitive as a token-mixing layer) ---
    use_fourier_mixing: bool = False
    fourier_taps: int = 128

    # --- modality frontend stub (audio/vlm: precomputed embeddings) ---
    frontend: str = "none"        # none | embeddings

    # --- numerics / memory ---
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "float32"
    remat: str = "block"          # none | block | full | sqrt
    scan_layers: bool = True
    # Sequence-parallel residual stream (Megatron-SP): the scan carry and
    # its saved per-layer stack are sharded over the model axis on the
    # sequence dim; attention/MLP re-gather internally. Memory-term lever
    # traded against the collective term (see EXPERIMENTS.md §Perf).
    sequence_parallel: bool = False
    # Gradient accumulation: the train step scans over this many
    # microbatches, accumulating fp32 grads — activations scale 1/k while
    # arithmetic is unchanged (memory-term lever at fixed global batch).
    grad_accum_steps: int = 1

    # --- serving ---
    max_seq_len: int = 32768

    # --- attention micro-tiling (0 = default: min(1024, S)). The dry-run's
    # cost probes set this to S so the flash KV-scan unrolls to one step
    # and XLA's cost_analysis counts its FLOPs exactly. ---
    attn_kv_block: int = 0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(1, self.num_heads))

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up so the logits axis shards over 16-way TP."""
        return _round_up(self.vocab_size, 256)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def n_global_layers(self) -> int:
        if self.attention != "local_global":
            return self.num_layers
        return self.num_layers // (self.local_global_ratio + 1)

    def layer_is_global(self, i: int) -> bool:
        """gemma3 pattern: every (ratio+1)-th layer is global."""
        if self.attention != "local_global":
            return self.attention == "full"
        return (i + 1) % (self.local_global_ratio + 1) == 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, H, KV, hd = (self.d_model, self.d_ff, self.num_heads,
                           self.num_kv_heads, self.head_dim)
        per_layer = 0
        if self.mixer in ("attn", "hymba"):
            per_layer += d * H * hd + 2 * d * KV * hd + H * hd * d
        if self.mixer == "rwkv6":
            per_layer += 4 * d * d + d * d  # r,k,v,g,o projections
        if self.mixer == "hymba":
            per_layer += 2 * d * d // 2 + d * self.ssm_state * 2  # ssm branch
        if self.is_moe:
            per_layer += d * self.num_experts            # router
            per_layer += self.num_experts * 3 * d * f    # expert FFNs
        else:
            per_layer += 3 * d * f
        per_layer += 2 * d                                # norms
        total = self.num_layers * per_layer
        total += self.vocab_padded * d                    # embedding
        total += d * self.vocab_padded                    # lm head
        total += d                                        # final norm
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_experts = self.num_experts * 3 * d * f
        active_experts = self.experts_per_token * 3 * d * f
        return (self.param_count()
                - self.num_layers * (dense_experts - active_experts))

    def scaled_down(self) -> "ModelConfig":
        """Reduced config of the same family for CPU smoke tests."""
        mrope = None
        if self.mrope_sections is not None:
            half = 32 // 2  # reduced head_dim = 32
            s0 = half // 4
            s1 = (half - s0) // 2
            mrope = (s0, s1, half - s0 - s1)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(4, max(1, self.num_kv_heads)),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            window=64,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            moe_group_size=32,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            mrope_sections=mrope,
            fourier_taps=16,
            max_seq_len=128,
            dtype="float32",
            param_dtype="float32",
        )
