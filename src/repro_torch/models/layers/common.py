"""Common layers: RMSNorm, rotary embeddings (incl. M-RoPE) and the SwiGLU
MLP (port of ``repro.models.layers.common``).

``fourier_mixing`` is not here yet: it needs ``fft_causal_conv``
(ROADMAP queue 1, item 4).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def _rope_angles(positions: torch.Tensor, dim: int,
                 theta: float) -> torch.Tensor:
    """positions (...,) -> angles (..., dim/2)."""
    freq = theta ** (-torch.arange(0, dim, 2, dtype=torch.float32,
                                   device=positions.device) / dim)
    return positions.float()[..., None] * freq


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, S, N, hd); positions: (B, S)."""
    return _rotate(x, _rope_angles(positions, x.shape[-1], theta))


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, *,
                sections: tuple[int, int, int],
                theta: float = 10_000.0) -> torch.Tensor:
    """Qwen2-VL multimodal rotary: positions (B, S, 3) = (t, h, w) streams.

    The rotary feature dim is split into three sections, each rotated by its
    own position stream (temporal / height / width). Text tokens carry
    identical t=h=w indices, reducing to standard RoPE.
    """
    hd = x.shape[-1]
    half = hd // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} must sum to {half}")
    parts = []
    for i, sec in enumerate(sections):
        freq_idx = sum(sections[:i]) * 2 + torch.arange(
            0, 2 * sec, 2, dtype=torch.float32, device=x.device)
        freq = theta ** (-freq_idx / hd)
        parts.append(positions[..., i].float()[..., None] * freq)
    return _rotate(x, torch.cat(parts, dim=-1))


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def swiglu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    """params: w_gate (d, f), w_up (d, f), w_down (f, d), in x's type.

    The reference asks for the down-projection in fp32 and rounds once to
    x's type; a torch matmul in bf16 accumulates in fp32 and rounds once
    (with ``allow_bf16_reduced_precision_reduction`` off on the card)."""
    dtype = x.dtype
    gate = x @ params.w_gate
    up = x @ params.w_up
    h = F.silu(gate.float()).to(dtype) * up
    return h @ params.w_down
