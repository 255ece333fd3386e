"""Common layers: RMSNorm, rotary embeddings (incl. M-RoPE), the SwiGLU
MLP and the FourierPIM token-mixing layer (port of
``repro.models.layers.common``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import fft_causal_conv

#: Radix of the token mixer's transforms: the planner's at every n >= 4
#: (``core.fft.plan``). The reference mixes on its radix-2 XLA Stockham;
#: both round the same exact convolution, within fp32 rounding.
MIXING_RADIX = 4


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

def swiglu_mlp(params, x: torch.Tensor,
               reduce_dtype: torch.dtype | None = None) -> torch.Tensor:
    """params: w_gate (d, f), w_up (d, f), w_down (f, d), in x's type.

    reduce_dtype: the type the down-projection is rounded to before x's
    type (the reference's ``preferred_element_type``; None is fp32). A
    torch matmul in bf16 accumulates in fp32 and rounds once (with
    ``allow_bf16_reduced_precision_reduction`` off on the card)."""
    dtype = x.dtype
    gate = x @ params.w_gate
    up = x @ params.w_up
    h = F.silu(gate.float()).to(dtype) * up
    out = h @ params.w_down
    if reduce_dtype is not None:
        out = out.to(reduce_dtype)
    return out.to(dtype)


# ---------------------------------------------------------------------------
# FourierPIM token mixing (paper section 5 as a sequence-model primitive)
# ---------------------------------------------------------------------------

def fourier_mixing(params, x: torch.Tensor) -> torch.Tensor:
    """Causal depthwise long convolution over the sequence by FFT
    (``kernels.ops.fft_causal_conv``), then a sigmoid output gate.

    params: taps (K, d) in the parameter type, gate (d, d) in x's type.
    x: (B, S, d). The convolution runs in fp32 on (B, d, S), its result
    goes back to x's type; the gate is sigmoid((x @ gate) in fp32) in x's
    type, as the reference casts them."""
    dtype = x.dtype
    taps = params.taps.float()                          # (K, d)
    xt = x.float().transpose(-1, -2)                    # (B, d, S)
    y = fft_causal_conv(xt, taps.t()[None], radix=MIXING_RADIX)
    y = y.transpose(-1, -2).to(dtype)                   # (B, S, d)
    gate = torch.sigmoid((x @ params.gate).float()).to(dtype)
    return y * gate
