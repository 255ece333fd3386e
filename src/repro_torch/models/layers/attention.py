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
from repro_torch.models.layers.common import (apply_mrope, apply_rope,
                                              partial_product, rms_norm)

NEG = kattn.NEG


def _qkv(params, x: torch.Tensor, cfg, positions: torch.Tensor):
    """Project + rope. Returns q (B,S,H,hd), k/v (B,S,KV,hd)."""
    norms = (params.q_norm, params.k_norm) if cfg.qk_norm else (None, None)
    q = _rotated(_heads(x @ params.wq, cfg), norms[0], cfg, positions)
    k = _rotated(_heads(x @ params.wk, cfg), norms[1], cfg, positions)
    return q, k, _heads(x @ params.wv, cfg)


def _heads(y: torch.Tensor, cfg) -> torch.Tensor:
    """(B, S, n hd) -> (B, S, n, hd)."""
    return y.reshape(*y.shape[:2], -1, cfg.head_dim)


def _rotated(t: torch.Tensor, norm: Optional[torch.Tensor], cfg,
             positions: torch.Tensor) -> torch.Tensor:
    """q or k (B, S, n, hd): the qk-norm (with its scale), then the rotary
    embedding. Both act on each head alone."""
    if norm is not None:
        t = rms_norm(t, norm)
    if cfg.mrope_sections is not None:
        if positions.ndim != 3:
            raise ValueError("M-RoPE needs (B, S, 3) positions")
        return apply_mrope(t, positions, sections=cfg.mrope_sections,
                           theta=cfg.rope_theta)
    pos2 = positions if positions.ndim == 2 else positions[..., 0]
    return apply_rope(t, pos2, theta=cfg.rope_theta)


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

    Differentiable (``_Attention``): the forward is the flash kernel (its
    plain version on the CPU), the backward differentiates the plain
    version.
    """
    return _Attention.apply(_scale_q(q), k, v, window, kv_block)


class _Attention(torch.autograd.Function):
    """Flash attention with a gradient. The forward launches the kernel
    ``kernels.attention.kernel_for`` picks (on the CPU its plain version)
    and saves only q, k and v. The backward recomputes the attention as
    the plain version with fp32 products (``kernel="cuda_core"``: the
    reference's fp32 einsums, without the kernels' bf16 or TF32 splits of
    the operands) over key blocks of ``kv_block``, the reference's, under
    autograd, and backpropagates through it. The reference trains through
    its pure-JAX blockwise attention; no backward kernel exists on either
    side."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, kv_block: int):
        ctx.save_for_backward(q, k, v)
        ctx.window, ctx.kv_block = window, kv_block
        return kattn.attention(q, k, v, window=window, causal=True,
                               scale=1.0, kv_block=kv_block)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            out = kattn.attention_plain(*inputs, window=ctx.window,
                                        causal=True, scale=1.0,
                                        kv_block=ctx.kv_block,
                                        kernel="cuda_core")
        wanted = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad(out, wanted, grad))
        return (*(next(got) if t.requires_grad else None for t in inputs),
                None, None)


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
    if cfg.reduce_dtype == "bfloat16":   # the reference's rounding
        y = y.to(torch.bfloat16).to(x.dtype)
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
    q, k, v = _qkv(params, x, cfg, _decode_positions(x, pos, positions))
    _write_slot(cache_k, cache_v, k, v, pos)
    return _cached(q, cache_k, cache_v, pos=pos, window=window) @ params.wo


def _decode_positions(x: torch.Tensor, pos: int,
                      positions: Optional[torch.Tensor]) -> torch.Tensor:
    if positions is not None:
        return positions
    return torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                      device=x.device)


def _write_slot(cache_k: torch.Tensor, cache_v: torch.Tensor,
                k: torch.Tensor, v: torch.Tensor, pos: int) -> None:
    """The new token's k, v (B, 1, KV, hd) into slot pos % C."""
    slot = pos % cache_k.shape[1]
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)


def _cached(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
            *, pos: int, window: int) -> torch.Tensor:
    """One token's attention over the cache: q (B, 1, H, hd), caches
    (B, C, KV, hd) -> (B, 1, H hd) in q's type."""
    B, _, H, hd = q.shape
    C, KV = cache_k.shape[1], cache_k.shape[2]
    qh = _scale_q(q.reshape(B, KV, H // KV, hd)).float()
    s = torch.einsum("bkgh,bckh->bkgc", qh, cache_k.float())
    # ring position of slot c holds absolute index: for pos < C it is c;
    # for a full ring, absolute = pos - ((slot - c) mod C)
    slot = pos % C
    cidx = torch.arange(C, device=q.device)
    absolute = pos - torch.remainder(slot - cidx, C)
    valid = (absolute >= 0) & (absolute <= pos) & (absolute > pos - window)
    s = torch.where(valid, s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckh->bkgh", p, cache_v.float())
    return out.reshape(B, 1, H * hd).to(q.dtype)


# ---------------------------------------------------------------------------
# The model axis: heads over the shards (``models/sharded.py``)
# ---------------------------------------------------------------------------

def head_plan(cfg, shards: int) -> tuple[str, int, int]:
    """How ``shards`` model shards split the attention: ("split", q heads,
    kv heads a shard) when the q heads divide and each shard's q heads
    read a whole number of kv heads (k and v split too when the kv heads
    divide; else each shard computes them whole and keeps the ones its q
    heads read: "select"), or ("whole", H, KV) when the q heads do not
    divide (hymba's 25 at 2 or 4 shards): each shard computes the whole
    mixer, with the weights gathered whole."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if shards == 1 or H % shards:
        return "whole", H, KV
    h = H // shards
    G = H // KV
    if KV % shards == 0:
        return "split", h, KV // shards
    if h % G == 0 or G % h == 0:
        return "select", h, max(1, h // G)
    return "whole", H, KV


def _own_kv(t: torch.Tensor, cfg, shard: int, shards: int) -> torch.Tensor:
    """The kv heads (B, S, KV, hd) -> the ones shard ``shard``'s q heads
    read."""
    h = cfg.num_heads // shards
    G = cfg.num_heads // cfg.num_kv_heads
    first = shard * h // G
    return t[:, :, first:first + max(1, h // G)]


def attention_sharded(sh, prefix: str, hs: list, cfg, *,
                      positions: list, window: int,
                      want_cache: bool = False):
    """``attention_train`` over the model axis of ``sh`` (a
    ``models.sharded.Shards``), ``hs`` the replicated input (one (B, S, d)
    tensor a shard). Each shard projects its q heads (``wq``'s column
    block), its kv heads (``wk``, ``wv``'s blocks, or k and v whole and its
    heads taken), runs the flash attention on them, and its rows of ``wo``
    give a partial sum; the psum of the partial sums (in the reduce type)
    is the output on every shard. Under ``head_plan``'s "whole" every
    shard runs the unsharded layer. Returns the outputs, and with
    ``want_cache`` each shard's (k, v) for its cache."""
    plan, h, kv = head_plan(cfg, sh.shards)
    if plan == "whole":
        params = sh.namespaces(prefix, ("wq", "wk", "wv", "wo", "q_norm",
                                        "k_norm"))
        outs = [attention_train(p, x, cfg, positions=pos, window=window,
                                want_cache=want_cache)
                for p, x, pos in zip(params, hs, positions)]
        return ([y for y, _ in outs], [c for _, c in outs]) \
            if want_cache else outs
    norms = ([None] * len(hs),) * 2
    if cfg.qk_norm:
        # replicated scales acting on each shard's own heads: their
        # gradients are partial, psummed (the select plan's k is whole)
        norms = (sh.enter(sh.view(prefix + "q_norm")),
                 sh.view(prefix + "k_norm"))
        if plan == "split":
            norms = (norms[0], sh.enter(norms[1]))
    entered = sh.enter(hs)
    q = [_rotated(_heads(x @ w, cfg), n, cfg, pos) for x, w, n, pos in zip(
        entered, sh.view(prefix + "wq", 1), norms[0], positions)]
    if plan == "split":
        wk, wv = sh.view(prefix + "wk", 1), sh.view(prefix + "wv", 1)
        k = [_rotated(_heads(x @ w, cfg), n, cfg, pos)
             for x, w, n, pos in zip(entered, wk, norms[1], positions)]
        v = [_heads(x @ w, cfg) for x, w in zip(entered, wv)]
    else:
        wk, wv = sh.view(prefix + "wk"), sh.view(prefix + "wv")
        k = sh.enter([_rotated(_heads(x @ w, cfg), n, cfg, pos)
                      for x, w, n, pos in zip(hs, wk, norms[1], positions)])
        v = sh.enter([_heads(x @ w, cfg) for x, w in zip(hs, wv)])
    cache = list(zip(k, v))
    if plan == "select":
        k = [_own_kv(t, cfg, m, sh.shards) for t, m in zip(k, sh.model_index)]
        v = [_own_kv(t, cfg, m, sh.shards) for t, m in zip(v, sh.model_index)]
    B, S = hs[0].shape[:2]
    blk = cfg.attn_kv_block or min(1024, S)
    rdt = torch.bfloat16 if cfg.reduce_dtype == "bfloat16" else None
    parts = []
    for qi, ki, vi, wo in zip(q, k, v, sh.view(prefix + "wo", 0)):
        out = blockwise_attention(qi, ki, vi, window=window, kv_block=blk)
        parts.append(partial_product(out.reshape(B, S, -1), wo, rdt))
    ys = [y.to(x.dtype) for y, x in zip(sh.psum(parts), hs)]
    return (ys, cache) if want_cache else ys


def attention_decode_sharded(sh, prefix: str, hs: list, cfg, *,
                             caches: list, pos: int, window: int,
                             positions: Optional[list] = None) -> list:
    """``attention_decode`` over the model axis: each shard's q heads
    against its cache (its kv heads under "split", all of them under
    "select" and "whole"; ``caches`` one (cache_k, cache_v) a shard, written
    in place; ``positions`` one a shard, or None), its rows of ``wo``, and
    the psum of the partial products in the activation type (the
    reference's decode product)."""
    plan, h, kv = head_plan(cfg, sh.shards)
    if plan == "whole":
        params = sh.namespaces(prefix, ("wq", "wk", "wv", "wo", "q_norm",
                                        "k_norm"))
        return [attention_decode(p, x, cfg, cache_k=ck, cache_v=cv,
                                 pos=pos, window=window,
                                 positions=None if positions is None
                                 else positions[i])
                for i, (p, x, (ck, cv)) in enumerate(zip(params, hs,
                                                         caches))]
    norms = ([None] * len(hs),) * 2
    if cfg.qk_norm:
        norms = (sh.view(prefix + "q_norm"), sh.view(prefix + "k_norm"))
    split_kv = plan == "split"
    wq = sh.view(prefix + "wq", 1)
    wk = sh.view(prefix + "wk", 1 if split_kv else None)
    wv = sh.view(prefix + "wv", 1 if split_kv else None)
    parts = []
    for i, (x, wo) in enumerate(zip(hs, sh.view(prefix + "wo", 0))):
        at = _decode_positions(x, pos, None if positions is None
                               else positions[i])
        q = _rotated(_heads(x @ wq[i], cfg), norms[0][i], cfg, at)
        k = _rotated(_heads(x @ wk[i], cfg), norms[1][i], cfg, at)
        ck, cv = caches[i]
        _write_slot(ck, cv, k, _heads(x @ wv[i], cfg), pos)
        if plan == "select":
            ck = _own_kv(ck, cfg, sh.model_index[i], sh.shards)
            cv = _own_kv(cv, cfg, sh.model_index[i], sh.shards)
        parts.append(_cached(q, ck, cv, pos=pos, window=window) @ wo)
    return sh.psum(parts)


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
