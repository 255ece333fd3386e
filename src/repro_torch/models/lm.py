"""Config-driven decoder LM: the dense attention family and FourierPIM
token mixing (port of ``repro.models.lm``).

``DecoderLM`` serves the architectures whose FFN is the dense SwiGLU and
whose mixer is GQA attention (full, sliding-window or gemma3's
local:global), with token or precomputed-embedding input and RoPE or
M-RoPE positions: qwen3, gemma3, starcoder2, llama3, musicgen and qwen2-vl;
or FourierPIM's FFT convolution (``fourier_mixing``): fourierpim-lm. The
other mixers and FFNs raise ``NotImplementedError`` naming the ROADMAP item
that ports them.

Entry points, as in the reference:
  forward       (B, S) tokens -> (B, S, vocab_padded) logits
  prefill       builds the KV caches at full sequence length
  decode_step   one token with the caches (serve_step)
and ``generate``, the serve CLI's greedy loop.

Differences from the reference, none of which changes a value:
  * The reference stacks every block's leaves on a leading layer axis and
    runs ``lax.scan``; here the blocks are an ``nn.ModuleList`` and a
    Python loop.
  * Remat and the sharding constraints have no meaning for inference on
    one card and are dropped.
  * The weight matrices are cast to the activation type once, at load; the
    reference casts its fp32 parameters at every use, to the same values.
    Norm scales stay in the parameter type, as the reference reads them.
  * The decode caches are updated in place; the reference returns updated
    copies.
  * ``prefill`` applies ``lm_head`` to the last position only; the
    reference computes all S positions' logits and returns the last.
  * The prefill attention runs the flash-attention kernel on the card
    (``repro_torch.kernels.attention``), once per layer; the Fourier
    mixer's prefill runs the FFT kernel (``kernels.fft.fft_planes``) three
    times per layer.

On the card the entry points turn TF32 and reduced-precision bf16
reductions off (``exact_matmuls``): the reference asks for its products in
fp32 (``preferred_element_type``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers.common import (fourier_mixing, rms_norm,
                                              swiglu_mlp)

BIG_WINDOW = 1 << 30
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for an architecture this slice of the port does not serve."""
    if cfg.mixer in ("rwkv6", "hymba"):
        item = "11c" if cfg.mixer == "rwkv6" else "11d"
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.mixer} mixer is not ported yet "
            f"(ROADMAP queue 1, item {item})")
    if cfg.mixer not in ("attn", "fourier"):
        raise ValueError(f"{cfg.name}: unknown mixer {cfg.mixer!r}")
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: the MoE FFN is not ported yet (ROADMAP queue 1, "
            f"item 11b)")


def exact_matmuls() -> None:
    """fp32 products in full fp32 and bf16 products with fp32 reductions on
    the card, as the reference asks for them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _layer_windows(cfg: ModelConfig) -> list[int]:
    """Per-layer effective attention window (the reference also takes a
    sequence length it does not use)."""
    if cfg.attention == "full" or cfg.mixer in ("rwkv6", "fourier"):
        return [BIG_WINDOW] * cfg.num_layers
    if cfg.attention == "swa":
        return [cfg.window] * cfg.num_layers
    if cfg.attention == "local_global":
        return [BIG_WINDOW if cfg.layer_is_global(i) else cfg.window
                for i in range(cfg.num_layers)]
    return [BIG_WINDOW] * cfg.num_layers


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """SWA archs keep a ring of window size; others the full sequence."""
    if cfg.attention == "swa" and cfg.mixer in ("attn", "hymba"):
        return min(seq_len, cfg.window)
    return seq_len


def _weights(module: nn.Module, shapes: dict, dtype: torch.dtype,
             device) -> None:
    for name, shape in shapes.items():
        module.register_parameter(name, nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device),
            requires_grad=False))


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, wdt, ndt, device):
        super().__init__()
        d, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim)
        _weights(self, {"wq": (d, H * hd), "wk": (d, KV * hd),
                        "wv": (d, KV * hd), "wo": (H * hd, d)}, wdt, device)
        if cfg.qk_norm:
            _weights(self, {"q_norm": (hd,), "k_norm": (hd,)}, ndt, device)


class Fourier(nn.Module):
    """The token mixer's leaves: taps (K, d) in the parameter type (the
    reference reads them in fp32), the gate (d, d) in the activation
    type."""

    def __init__(self, cfg: ModelConfig, wdt, ndt, device):
        super().__init__()
        d = cfg.d_model
        _weights(self, {"taps": (cfg.fourier_taps, d)}, ndt, device)
        _weights(self, {"gate": (d, d)}, wdt, device)


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, wdt, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        _weights(self, {"w_gate": (d, f), "w_up": (d, f),
                        "w_down": (f, d)}, wdt, device)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, wdt, ndt, device):
        super().__init__()
        _weights(self, {"ln1": (cfg.d_model,), "ln2": (cfg.d_model,)}, ndt,
                 device)
        if cfg.mixer == "fourier":
            self.fourier = Fourier(cfg, wdt, ndt, device)
        else:
            self.attn = Attention(cfg, wdt, ndt, device)
        self.mlp = MLP(cfg, wdt, device)

    def forward(self, cfg: ModelConfig, x: torch.Tensor, *,
                positions: torch.Tensor, window: int, cache=None
                ) -> torch.Tensor:
        """One block over the whole sequence. ``cache``: this layer's
        decode state to fill (prefill): (cache_k, cache_v) to receive its
        k, v, or the Fourier mixer's ring to receive its last inputs."""
        h = rms_norm(x, self.ln1)
        if cfg.mixer == "fourier":
            y = fourier_mixing(self.fourier, h)
            if cache is not None:
                _fill_cache((cache,), h)
        elif cache is None:
            y = attn_lib.attention_train(self.attn, h, cfg,
                                         positions=positions, window=window)
        else:
            y, (k, v) = attn_lib.attention_train(
                self.attn, h, cfg, positions=positions, window=window,
                want_cache=True)
            _fill_cache(cache, k, v)
        x = x + y
        return x + swiglu_mlp(self.mlp, rms_norm(x, self.ln2),
                              _reduce_dtype(cfg))

    def decode(self, cfg: ModelConfig, x: torch.Tensor, cache, *,
               pos: int, window: int, positions: Optional[torch.Tensor]
               ) -> torch.Tensor:
        h = rms_norm(x, self.ln1)
        if cfg.mixer == "fourier":
            y = _fourier_decode(self.fourier, h, cache, pos=pos).to(x.dtype)
        else:
            y = attn_lib.attention_decode(
                self.attn, h, cfg, cache_k=cache[0], cache_v=cache[1],
                pos=pos, window=window, positions=positions)
        x = x + y
        return x + swiglu_mlp(self.mlp, rms_norm(x, self.ln2),
                              _reduce_dtype(cfg))


def _reduce_dtype(cfg: ModelConfig) -> torch.dtype | None:
    """The down-projection's rounding (the reference's ``reduce_dtype``
    argument of ``swiglu_mlp``): bf16, or None for fp32."""
    return torch.bfloat16 if cfg.reduce_dtype == "bfloat16" else None


def _fill_cache(cache, *values: torch.Tensor) -> None:
    """Write a prefill's values (B, S, ...) into a layer's caches
    (B, C, ...), pairwise: k, v into (cache_k, cache_v), or the Fourier
    mixer's inputs into its ring. Slots p % C == p while S <= C, else the
    ring of the last C positions, whose slots line up when S % C == 0."""
    C, S = cache[0].shape[1], values[0].shape[1]
    if C < S and S % C:
        raise ValueError(f"prefill of {S} positions into a ring of {C} "
                         f"slots: the slots line up only when S % C == 0")
    for slots, value in zip(cache, values):
        if C >= S:
            slots[:, :S] = value
        else:
            slots.copy_(value[:, -C:])


def _fourier_decode(params, h: torch.Tensor, ring: torch.Tensor, *,
                    pos: int) -> torch.Tensor:
    """One token of the Fourier mixer, in fp32: write h (B, 1, d) into
    slot pos % K of the ring, weight each slot by the tap of its age (zero
    where the age exceeds pos), sum, and gate."""
    K = ring.shape[1]
    slot = pos % K
    ring[:, slot] = h[:, 0].to(ring.dtype)
    taps = params.taps.float()                                   # (K, d)
    lag = torch.remainder(slot - torch.arange(K, device=ring.device), K)
    w = torch.where((lag <= pos)[:, None], taps[lag], 0.0)
    y = torch.einsum("bkd,kd->bd", ring.float(), w)[:, None]
    return y * torch.sigmoid((h @ params.gate).float())


def _layer_state(state: dict, i: int):
    """Layer i's part of the decode state: its ring, or (cache_k,
    cache_v)."""
    if "ring" in state:
        return state["ring"][i]
    return state["cache_k"][i], state["cache_v"][i]


class DecoderLM(nn.Module):
    """The decoder LM for one config. Parameters are created empty on
    ``device`` (``load_state_dict`` fills them; see ``models/convert.py``):
    matrices and the embedding in the activation type ``cfg.dtype``, norm
    scales in ``cfg.param_dtype``."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        adt, pdt = dtype_of(cfg.dtype), dtype_of(cfg.param_dtype)
        d, vp = cfg.d_model, cfg.vocab_padded
        _weights(self, {"embed": (vp, d), "lm_head": (d, vp)}, adt, device)
        self.blocks = nn.ModuleList(Block(cfg, adt, pdt, device)
                                    for _ in range(cfg.num_layers))
        _weights(self, {"final_norm": (d,)}, pdt, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _embed(self, tokens: Optional[torch.Tensor],
               embeds: Optional[torch.Tensor]) -> torch.Tensor:
        if self.device.type == "cuda":
            exact_matmuls()
        adt = dtype_of(self.cfg.dtype)
        if self.cfg.frontend == "embeddings":
            if embeds is None:
                raise ValueError(f"{self.cfg.name} takes precomputed "
                                 f"embeddings, not tokens")
            return embeds.to(adt)
        scale = torch.tensor(math.sqrt(float(self.cfg.d_model)),
                             dtype=torch.float32).to(adt)
        return self.embed[tokens] * scale

    @staticmethod
    def _positions(x: torch.Tensor,
                   positions: Optional[torch.Tensor]) -> torch.Tensor:
        if positions is not None:
            return positions
        B, S = x.shape[:2]
        return torch.arange(S, dtype=torch.int32,
                            device=x.device)[None].expand(B, S)

    def _trunk(self, x: torch.Tensor, positions: torch.Tensor,
               state: Optional[dict] = None) -> torch.Tensor:
        windows = _layer_windows(self.cfg)
        for i, block in enumerate(self.blocks):
            cache = None if state is None else _layer_state(state, i)
            x = block(self.cfg, x, positions=positions, window=windows[i],
                      cache=cache)
        return rms_norm(x, self.final_norm)

    @torch.no_grad()
    def forward(self, tokens: Optional[torch.Tensor] = None, *,
                positions: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, S, vocab_padded) logits in the activation type."""
        x = self._embed(tokens, embeds)
        x = self._trunk(x, self._positions(x, positions))
        return x @ self.lm_head

    def init_decode_state(self, batch: int, seq_len: int) -> dict:
        """Zeroed KV caches (L, batch, C, KV, hd), or for the Fourier mixer
        its rings of the last inputs (L, batch, K, d), in the activation
        type."""
        cfg = self.cfg
        adt = dtype_of(cfg.dtype)
        if cfg.mixer == "fourier":
            shape = (cfg.num_layers, batch, cfg.fourier_taps, cfg.d_model)
            return {"ring": torch.zeros(shape, dtype=adt,
                                        device=self.device)}
        C = cache_len(cfg, seq_len)
        shape = (cfg.num_layers, batch, C, cfg.num_kv_heads, cfg.head_dim)
        return {"cache_k": torch.zeros(shape, dtype=adt, device=self.device),
                "cache_v": torch.zeros(shape, dtype=adt, device=self.device)}

    @torch.no_grad()
    def prefill(self, tokens: Optional[torch.Tensor] = None, *,
                positions: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None,
                cache_capacity: Optional[int] = None
                ) -> tuple[torch.Tensor, dict]:
        """Full-sequence forward returning (last_logits (B, vocab_padded) in
        the activation type, decode_state).

        cache_capacity: KV slots to allocate (>= S for full attention so
        decode can append; defaults to the prefilled length)."""
        x = self._embed(tokens, embeds)
        B, S = x.shape[:2]
        state = self.init_decode_state(B, cache_capacity or S)
        x = self._trunk(x, self._positions(x, positions), state)
        return (x[:, -1] @ self.lm_head), state

    @torch.no_grad()
    def decode_step(self, state: dict, token: Optional[torch.Tensor],
                    pos: int, *, positions: Optional[torch.Tensor] = None,
                    embed: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, dict]:
        """serve_step: one new token for the whole batch.

        token: (B,) int (or embed (B, 1, d) for frontend archs); pos: int.
        Returns (logits (B, vocab_padded) fp32, state updated in place)."""
        if self.cfg.frontend == "embeddings":
            x = self._embed(None, embed)
        else:
            x = self._embed(token, None)[:, None]
        windows = _layer_windows(self.cfg)
        for i, block in enumerate(self.blocks):
            x = block.decode(self.cfg, x, _layer_state(state, i), pos=pos,
                             window=windows[i], positions=positions)
        x = rms_norm(x, self.final_norm)
        return (x @ self.lm_head)[:, 0].float(), state


@torch.no_grad()
def generate(model: DecoderLM, tokens: torch.Tensor,
             gen: int) -> torch.Tensor:
    """Greedy generation, the reference serve CLI's loop: prefill the
    (B, S) prompt with room for ``gen`` more positions, then ``gen`` decode
    steps, each fed the argmax of the previous logits. Returns the (gen, B)
    tokens, the first from the prefill's logits."""
    if model.cfg.frontend == "embeddings":
        raise ValueError(f"{model.cfg.name} takes embeddings; generate "
                         f"feeds back tokens")
    S = tokens.shape[1]
    logits, state = model.prefill(tokens, cache_capacity=S + gen)
    tok = logits.argmax(dim=-1)
    out = []
    for i in range(gen):
        out.append(tok)
        logits, state = model.decode_step(state, tok, S + i)
        tok = logits.argmax(dim=-1)
    return torch.stack(out)
