"""Grouped-query attention: flash attention for train/prefill, cache-based
single-step decode, with full / sliding-window / local:global masking, all
config-driven (port of ``repro.models.layers.attention``).

The prefill's attention runs ``repro_torch.kernels.attention.attention``:
on the card one launch of the hand-written flash-attention kernel per
layer, in the layer's (B, S, H, hd) / (B, S, KV, hd) layout, without
repeating k or v per group. The decode step is plain torch ops over the
cache, as the reference's are plain einsums.

Parameters are the attributes of an ``nn.Module`` (``wq``, ``wk``, ``wv``,
``wo`` and, with qk-norm, ``q_norm``, ``k_norm``); the matrices are held in
the activation type (see ``models/lm.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import attention as kattn
from repro_torch.models.layers.common import apply_mrope, apply_rope, rms_norm

NEG = kattn.NEG


def _qkv(params, x: torch.Tensor, cfg, positions: torch.Tensor):
    """Project + rope. Returns q (B,S,H,hd), k/v (B,S,KV,hd)."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params.wq).reshape(B, S, H, hd)
    k = (x @ params.wk).reshape(B, S, KV, hd)
    v = (x @ params.wv).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params.q_norm)
        k = rms_norm(k, params.k_norm)
    if cfg.mrope_sections is not None:
        if positions.ndim != 3:
            raise ValueError("M-RoPE needs (B, S, 3) positions")
        q = apply_mrope(q, positions, sections=cfg.mrope_sections,
                        theta=cfg.rope_theta)
        k = apply_mrope(k, positions, sections=cfg.mrope_sections,
                        theta=cfg.rope_theta)
    else:
        pos2 = positions if positions.ndim == 2 else positions[..., 0]
        q = apply_rope(q, pos2, theta=cfg.rope_theta)
        k = apply_rope(k, pos2, theta=cfg.rope_theta)
    return q, k, v


def _scale_q(q: torch.Tensor) -> torch.Tensor:
    """q * hd^-0.5 in q's type, the scale rounded to that type first, as the
    reference's layer scales q (a weak-typed Python float) before its fp32
    cast."""
    return q * torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int, kv_block: int = 1024
                        ) -> torch.Tensor:
    """Online-softmax attention with causal + window mask.

    q: (B, S, H, hd); k, v: (B, S, KV, hd); H = KV * G, head h = kv * G + g.
    window: effective lookback (>= S means full causal).
    Returns (B, S, H, hd) in q.dtype; accumulation in fp32. q is scaled in
    its own type and the kernel takes scale 1.0, as the reference scales
    before the fp32 cast. The reference's ``q_start`` (always 0 there) is
    not taken: queries and keys cover the same positions.
    """
    return kattn.attention(_scale_q(q), k, v, window=window, causal=True,
                           scale=1.0, kv_block=kv_block)


def attention_train(params, x: torch.Tensor, cfg, *,
                    positions: torch.Tensor, window: int,
                    want_cache: bool = False):
    """Full-sequence attention for train/prefill. window: per-layer int
    (big value = full causal; cfg.window for SWA/local layers). With
    ``want_cache`` also returns (k, v) for the decode cache, the values the
    reference recomputes for it."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg, positions)
    blk = cfg.attn_kv_block or min(1024, S)
    out = blockwise_attention(q, k, v, window=window, kv_block=blk)
    y = out.reshape(B, S, cfg.num_heads * cfg.head_dim) @ params.wo
    return (y, (k, v)) if want_cache else y


def attention_decode(params, x: torch.Tensor, cfg, *,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: int, window: int,
                     positions: Optional[torch.Tensor] = None):
    """Single-token decode with a KV cache.

    x: (B, 1, d); cache_k/v: (B, C, KV, hd) (C = cache length, either
    max_seq or the sliding window); pos: current position. Sliding-window
    caches are rings indexed by pos % C. The new k and v are written into
    the caches in place (the reference returns updated copies).
    Returns y (B, 1, d).
    """
    B = x.shape[0]
    C = cache_k.shape[1]
    if positions is None:
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x.device)
    q, k, v = _qkv(params, x, cfg, positions)
    slot = pos % C
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    KV, hd, H = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    G = H // KV
    qh = _scale_q(q.reshape(B, KV, G, hd)).float()
    s = torch.einsum("bkgh,bckh->bkgc", qh, cache_k.float())
    # ring position of slot c holds absolute index: for pos < C it is c;
    # for a full ring, absolute = pos - ((slot - c) mod C)
    cidx = torch.arange(C, device=x.device)
    absolute = pos - torch.remainder(slot - cidx, C)
    valid = (absolute >= 0) & (absolute <= pos) & (absolute > pos - window)
    s = torch.where(valid, s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckh->bkgh", p, cache_v.float())
    return out.reshape(B, 1, H * hd).to(x.dtype) @ params.wo


def init_attention_params(cfg, generator: torch.Generator, dtype: torch.dtype,
                          device) -> dict[str, torch.Tensor]:
    """Weights of the reference's distributions (``init_attention_params``
    there), drawn from ``generator``."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def normal(shape, std):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device) * std

    p = {"wq": normal((d, H * hd), d ** -0.5),
         "wk": normal((d, KV * hd), d ** -0.5),
         "wv": normal((d, KV * hd), d ** -0.5),
         "wo": normal((H * hd, d), (H * hd) ** -0.5)}
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return p
