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


# ---------------------------------------------------------------------------
# The model axis (``models/sharded.py``): ``sh`` is the run's ``Shards``,
# ``hs`` the replicated input, one tensor a shard
# ---------------------------------------------------------------------------

def partial_product(h: torch.Tensor, w: torch.Tensor,
                    reduce_dtype: torch.dtype | None) -> torch.Tensor:
    """A row-parallel product, one shard's partial sum, in the type the
    partial sums are reduced in (the reference's ``preferred_element_type``:
    fp32 unless ``reduce_dtype``). bf16 operands are widened to fp32 for an
    fp32 partial: their products are exact and their sum fp32, as the
    reference's."""
    if reduce_dtype is not None:
        return (h @ w).to(reduce_dtype)
    if h.dtype != torch.float32:
        return h.float() @ w.float()
    return h @ w


def swiglu_mlp_sharded(sh, prefix: str, hs: list,
                       reduce_dtype: torch.dtype | None = None) -> list:
    """``swiglu_mlp`` over the model axis: ``w_gate`` and ``w_up`` by
    column blocks, ``w_down`` by row blocks; each shard's partial sum in
    ``reduce_dtype`` (fp32 by default), their psum, then x's type."""
    parts = []
    for x, wg, wu, wd in zip(sh.enter(hs), sh.view(prefix + "w_gate", 1),
                             sh.view(prefix + "w_up", 1),
                             sh.view(prefix + "w_down", 0)):
        h = F.silu((x @ wg).float()).to(x.dtype) * (x @ wu)
        parts.append(partial_product(h, wd, reduce_dtype))
    return [y.to(x.dtype) for y, x in zip(sh.psum(parts), hs)]


def fourier_mixing_sharded(sh, prefix: str, hs: list) -> list:
    """``fourier_mixing`` over the model axis: the depthwise convolution by
    channel blocks (each shard's ``fft_causal_conv`` on its B d/M rows), the
    gate by column blocks, and the gated channel blocks all-gathered into
    the output every shard holds."""
    outs = []
    for x, xc, taps, gate in zip(sh.enter(hs), sh.split(hs, -1),
                                 sh.view(prefix + "taps", 1),
                                 sh.view(prefix + "gate", 1)):
        y = fft_causal_conv(xc.float().transpose(-1, -2),
                            taps.float().t()[None], radix=MIXING_RADIX)
        y = y.transpose(-1, -2).to(x.dtype)
        outs.append(y * torch.sigmoid((x @ gate).float()).to(x.dtype))
    return sh.gather(outs, -1)

