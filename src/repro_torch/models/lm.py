"""Config-driven decoder LM covering the whole architecture zoo (port of
``repro.models.lm``).

One implementation serves all eleven architectures of the registry:
  * mixer: GQA attention (full, sliding-window or gemma3's local:global),
    RWKV6, Hymba's parallel attention + SSM heads, or FourierPIM's FFT
    convolution (``fourier_mixing``);
  * FFN: the dense SwiGLU or the grouped top-k MoE (``layers/moe.py``);
    RWKV6 has its channel mix in the FFN's place;
  * embeddings: token table or precomputed frontend embeddings;
  * positions: RoPE or M-RoPE.

Entry points, as in the reference:
  forward       (B, S) tokens -> (B, S, vocab_padded) logits
  prefill       builds the KV caches at full sequence length
  decode_step   one token with the caches (serve_step)
  loss_fn       (B, S) tokens and labels -> scalar loss, differentiable
and ``generate``, the serve CLI's greedy loop. The serving entry points
run under ``torch.no_grad`` on the module's own weights, which never
require grad. Training goes through ``loss_fn`` / ``value_and_grad`` with
the fp32 master parameters of ``convert.init_params`` (or
``params_from_jax``), cast to each parameter's type at every step
(``cast_params``) and handed to each block with its call
(``forward_train``), so the module may live on the ``meta`` device.

Differences from the reference, none of which changes a value beyond the
order of an fp32 sum, but the last, which changes served tokens:
  * The reference stacks every block's leaves on a leading layer axis and
    runs ``lax.scan``; here the blocks are an ``nn.ModuleList`` and a
    Python loop.
  * The sharding constraints are not calls inside the model: the model
    split over a mesh's ``model`` axis is ``models/sharded.py``, which
    runs each ``constrain``'s split as per-shard work over this module's
    layers; ``param_specs`` and ``decode_state_specs`` are the reference's
    specs. Remat (``cfg.remat``) applies to the training forward:
    ``torch.utils.checkpoint`` around each block
    (``block`` keeps the blocks' matmul outputs, ``full`` nothing) or
    around about sqrt(L) groups of blocks (``sqrt``).
  * For serving the weight matrices are cast to the activation type once,
    at load; the reference casts its fp32 parameters at every use, to the
    same values (training casts the masters at every step). Norm scales
    stay in the parameter type, as the reference reads them.
  * The decode state (KV caches, rings, the recurrences' states) is
    updated in place; the reference returns updated copies.
  * ``prefill`` applies ``lm_head`` to the last position only; the
    reference computes all S positions' logits and returns the last.
  * The MoE FFN scatters and gathers its kept slots where the reference
    multiplies one-hot tensors, and the recurrences form their terms in
    another order (``layers/moe.py``, ``layers/recurrent.py``): fp32 sums
    in other orders.
  * The prefill attention runs the flash-attention kernel on the card
    (``repro_torch.kernels.attention``), once per layer; the Fourier
    mixer runs the FFT kernel (``kernels.fft.fft_planes``) three
    times per layer, and in training three more in its backward. The
    attention's backward differentiates its plain version. The
    recurrences and the MoE are PyTorch ops: the reference's are
    ``lax.scan``s and einsums outside any Pallas kernel.

  * ``generate`` takes its greedy argmax over the ``vocab_size`` logits;
    the reference's serve loop takes it over all ``vocab_padded`` ones, and
    so emits a padding id (which is no token) wherever a padding logit is
    the largest. Where the reference's argmax is a token the two agree.

On the card the entry points turn TF32 and reduced-precision bf16
reductions off (``exact_matmuls``): the reference asks for its products in
fp32 (``preferred_element_type``).
"""
from __future__ import annotations

import functools
import math
from typing import Mapping, Optional

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.dist.sharding import PartitionSpec as P
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers import moe as moe_lib
from repro_torch.models.layers import recurrent as rec_lib
from repro_torch.models.layers.common import (fourier_mixing, rms_norm,
                                              swiglu_mlp)

BIG_WINDOW = 1 << 30
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


MIXERS = ("attn", "hymba", "rwkv6", "fourier")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a mixer the model does not know (the reference raises in
    ``block_forward``)."""
    if cfg.mixer not in MIXERS:
        raise ValueError(f"{cfg.name}: unknown mixer {cfg.mixer!r}")


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


class MoE(nn.Module):
    """The experts in the activation type; the router in fp32, as the
    reference creates and reads it whatever the parameter type."""

    def __init__(self, cfg: ModelConfig, wdt, device):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        _weights(self, {"router": (d, E)}, torch.float32, device)
        _weights(self, {"w_gate": (E, d, f), "w_up": (E, d, f),
                        "w_down": (E, f, d)}, wdt, device)


class RWKVTime(nn.Module):
    """RWKV6 time mixing: the token-shift mix and the projections in the
    activation type; the decay bias ``w0`` and bonus ``u`` in fp32 and the
    decay's low-rank pair ``ww1``, ``ww2`` in the parameter type, which the
    reference reads in fp32."""

    def __init__(self, cfg: ModelConfig, wdt, ndt, device):
        super().__init__()
        d, lora = cfg.d_model, rec_lib.RWKV_LORA
        _weights(self, {"mu": (5, d), **dict.fromkeys(
            ("wr", "wk", "wv", "wg", "wo"), (d, d))}, wdt, device)
        _weights(self, {"w0": (d,), "u": (d // rec_lib.RWKV_HEAD_DIM,
                                          rec_lib.RWKV_HEAD_DIM)},
                 torch.float32, device)
        _weights(self, {"ww1": (d, lora), "ww2": (lora, d)}, ndt, device)


class RWKVChannel(nn.Module):
    def __init__(self, cfg: ModelConfig, wdt, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        _weights(self, {"mu_c": (2, d), "wk": (d, f), "wv": (f, d),
                        "wr": (d, d)}, wdt, device)


class SSM(nn.Module):
    """Hymba's SSM branch, all read in fp32 as the reference reads it: the
    projections in the parameter type, ``a_log``, ``d_skip`` and
    ``dt_bias`` in fp32."""

    def __init__(self, cfg: ModelConfig, ndt, device):
        super().__init__()
        d, n = cfg.d_model, cfg.ssm_state
        _weights(self, {"w_dt": (d, d), "w_b": (d, n), "w_c": (d, n)}, ndt,
                 device)
        _weights(self, {"a_log": (d, n), "d_skip": (d,), "dt_bias": (d,)},
                 torch.float32, device)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, wdt, ndt, device):
        super().__init__()
        d = cfg.d_model
        _weights(self, {"ln1": (d,), "ln2": (d,)}, ndt, device)
        if cfg.mixer in ("attn", "hymba"):
            self.attn = Attention(cfg, wdt, ndt, device)
        if cfg.mixer == "hymba":
            self.ssm = SSM(cfg, ndt, device)
            _weights(self, {"ln_attn_out": (d,), "ln_ssm_out": (d,)}, ndt,
                     device)
        if cfg.mixer == "rwkv6":
            self.rwkv_t = RWKVTime(cfg, wdt, ndt, device)
            self.rwkv_c = RWKVChannel(cfg, wdt, device)
        if cfg.mixer == "fourier":
            self.fourier = Fourier(cfg, wdt, ndt, device)
        if cfg.mixer != "rwkv6":
            if cfg.is_moe:
                self.moe = MoE(cfg, wdt, device)
            else:
                self.mlp = MLP(cfg, wdt, device)

    def forward(self, cfg: ModelConfig, x: torch.Tensor, *,
                positions: torch.Tensor, window: int,
                state: Optional[dict] = None
                ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One block over the whole sequence: (x, the MoE's aux
        load-balance loss, None without a MoE). ``state``: this layer's
        decode state to fill (prefill; ``_layer_state``): the attention's
        k, v, the Fourier mixer's ring of its last inputs, the recurrences'
        final states and last inputs. Without a state the block writes
        nothing in place, so autograd can record it (the training
        forward)."""
        h = rms_norm(x, self.ln1)
        if cfg.mixer == "fourier":
            y = fourier_mixing(self.fourier, h)
            if state is not None:
                _fill_cache((state["ring"],), h)
        elif cfg.mixer == "rwkv6":
            y, new = rec_lib.rwkv_time_mix(self.rwkv_t, h)
            if state is not None:
                state["prev_x"].copy_(new["prev_x"])
                state["S"].copy_(new["S"])
        else:
            if state is None:
                y = attn_lib.attention_train(self.attn, h, cfg,
                                             positions=positions,
                                             window=window)
            else:
                y, (k, v) = attn_lib.attention_train(
                    self.attn, h, cfg, positions=positions, window=window,
                    want_cache=True)
                _fill_cache((state["cache_k"], state["cache_v"]), k, v)
            if cfg.mixer == "hymba":
                y_ssm, h_fin = rec_lib.ssm_mix(self.ssm, h)
                if state is not None:
                    state["ssm_h"].copy_(h_fin)
                y = self._hymba_out(y, y_ssm)
        x = x + y
        h2 = rms_norm(x, self.ln2)
        if cfg.mixer == "rwkv6":
            y2, last = rec_lib.rwkv_channel_mix(self.rwkv_c, h2,
                                                torch.zeros_like(h2[:, 0]))
            if state is not None:
                state["prev_x_c"].copy_(last)
            return x + y2, None
        y2, aux = self._ffn(cfg, h2)
        return x + y2, aux

    def decode(self, cfg: ModelConfig, x: torch.Tensor, state: dict, *,
               pos: int, window: int, positions: Optional[torch.Tensor]
               ) -> torch.Tensor:
        """One token (B, 1, d); ``state`` is this layer's decode state,
        updated in place."""
        h = rms_norm(x, self.ln1)
        if cfg.mixer == "fourier":
            y = _fourier_decode(self.fourier, h, state["ring"],
                                pos=pos).to(x.dtype)
        elif cfg.mixer == "rwkv6":
            y, new = rec_lib.rwkv_time_mix(self.rwkv_t, h, state=state)
            state["prev_x"].copy_(new["prev_x"])
            state["S"].copy_(new["S"])
        else:
            y = attn_lib.attention_decode(
                self.attn, h, cfg, cache_k=state["cache_k"],
                cache_v=state["cache_v"], pos=pos, window=window,
                positions=positions)
            if cfg.mixer == "hymba":
                y_ssm, h_new = rec_lib.ssm_mix(self.ssm, h,
                                               state=state["ssm_h"])
                state["ssm_h"].copy_(h_new)
                y = self._hymba_out(y, y_ssm)
        x = x + y
        h2 = rms_norm(x, self.ln2)
        if cfg.mixer == "rwkv6":
            y2, last = rec_lib.rwkv_channel_mix(self.rwkv_c, h2,
                                                state["prev_x_c"])
            state["prev_x_c"].copy_(last)
            return x + y2
        return x + self._ffn(cfg, h2)[0]

    def _hymba_out(self, y_attn: torch.Tensor,
                   y_ssm: torch.Tensor) -> torch.Tensor:
        """Hymba's parallel heads: the mean of the two branches, each
        normed."""
        return 0.5 * (rms_norm(y_attn, self.ln_attn_out)
                      + rms_norm(y_ssm, self.ln_ssm_out))

    def _ffn(self, cfg: ModelConfig, h: torch.Tensor
             ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(the FFN's output, the MoE's aux loss or None)."""
        if cfg.is_moe:
            return moe_lib.moe_ffn(self.moe, h, cfg, _reduce_dtype(cfg))
        return swiglu_mlp(self.mlp, h, _reduce_dtype(cfg)), None


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
                    pos: int, gate_input: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """One token of the Fourier mixer, in fp32: write h (B, 1, d) into
    slot pos % K of the ring, weight each slot by the tap of its age (zero
    where the age exceeds pos), sum, and gate. ``gate_input``: the gate's
    input where it is not h (a model shard's h is its channels, the gate's
    input the whole token)."""
    K = ring.shape[1]
    slot = pos % K
    ring[:, slot] = h[:, 0].to(ring.dtype)
    taps = params.taps.float()                                   # (K, d)
    lag = torch.remainder(slot - torch.arange(K, device=ring.device), K)
    w = torch.where((lag <= pos)[:, None], taps[lag], 0.0)
    y = torch.einsum("bkd,kd->bd", ring.float(), w)[:, None]
    gate_input = h if gate_input is None else gate_input
    return y * torch.sigmoid((gate_input @ params.gate).float())


def _layer_state(state: dict, i: int) -> dict:
    """Layer i's part of the decode state: a view of each entry."""
    return {name: value[i] for name, value in state.items()}


class DecoderLM(nn.Module):
    """The decoder LM for one config. Parameters are created empty on
    ``device`` (``load_state_dict`` fills them; see ``models/convert.py``):
    matrices and the embedding in the activation type ``cfg.dtype``, norm
    scales and the leaves the reference reads in fp32 in
    ``cfg.param_dtype`` or fp32, as it creates them (see ``MoE``,
    ``RWKVTime``, ``SSM``)."""

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
               embeds: Optional[torch.Tensor],
               table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The first activations: the embeddings given, or the rows of
        ``table`` (default: the module's ``embed``) scaled by sqrt(d)."""
        table = self.embed if table is None else table
        if table.device.type == "cuda":
            exact_matmuls()
        adt = dtype_of(self.cfg.dtype)
        if self.cfg.frontend == "embeddings":
            if embeds is None:
                raise ValueError(f"{self.cfg.name} takes precomputed "
                                 f"embeddings, not tokens")
            return embeds.to(adt)
        scale = torch.tensor(math.sqrt(float(self.cfg.d_model)),
                             dtype=torch.float32).to(adt)
        return table[tokens] * scale

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
            x, _ = block(self.cfg, x, positions=positions, window=windows[i],
                         state=None if state is None else _layer_state(state,
                                                                       i))
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
        """The reference's zeroed decode state, each entry stacked over the
        layers: KV caches (L, batch, C, KV, hd) for attention and hymba;
        hymba's SSM state ``ssm_h`` (L, batch, d, n) in fp32; RWKV's last
        inputs ``prev_x``, ``prev_x_c`` (L, batch, d) and state ``S``
        (L, batch, H, 64, 64) in fp32; the Fourier mixer's rings of its
        last inputs (L, batch, K, d). The rest in the activation type."""
        cfg = self.cfg
        L, d = cfg.num_layers, cfg.d_model

        def zeros(*shape, dtype=dtype_of(cfg.dtype)):
            return torch.zeros((L, batch, *shape), dtype=dtype,
                               device=self.device)

        st = {}
        if cfg.mixer in ("attn", "hymba"):
            C = cache_len(cfg, seq_len)
            st["cache_k"] = zeros(C, cfg.num_kv_heads, cfg.head_dim)
            st["cache_v"] = zeros(C, cfg.num_kv_heads, cfg.head_dim)
        if cfg.mixer == "hymba":
            st["ssm_h"] = zeros(d, cfg.ssm_state, dtype=torch.float32)
        if cfg.mixer == "rwkv6":
            hd = rec_lib.RWKV_HEAD_DIM
            st["prev_x"] = zeros(d)
            st["S"] = zeros(d // hd, hd, hd, dtype=torch.float32)
            st["prev_x_c"] = zeros(d)
        if cfg.mixer == "fourier":
            st["ring"] = zeros(cfg.fourier_taps, d)
        return st

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


# ---------------------------------------------------------------------------
# Sharding specs (the reference's logical rules, over the port's names;
# sanitized against a mesh where they are used)
# ---------------------------------------------------------------------------

FSDP = ("pod", "data")
TP = "model"


def _block_specs(cfg: ModelConfig) -> dict:
    """One block's specs by the name under ``blocks.<i>.``: the reference's
    ``param_specs`` without its leading layer entry."""
    b = {"ln1": P(FSDP), "ln2": P(FSDP)}
    if cfg.mixer in ("attn", "hymba"):
        b.update({"attn.wq": P(FSDP, TP), "attn.wk": P(FSDP, TP),
                  "attn.wv": P(FSDP, TP), "attn.wo": P(TP, FSDP)})
        if cfg.qk_norm:
            b.update({"attn.q_norm": P(None), "attn.k_norm": P(None)})
    if cfg.mixer == "hymba":
        b.update({"ssm.w_dt": P(FSDP, TP), "ssm.w_b": P(FSDP, None),
                  "ssm.w_c": P(FSDP, None), "ssm.a_log": P(FSDP, None),
                  "ssm.d_skip": P(FSDP), "ssm.dt_bias": P(FSDP),
                  "ln_attn_out": P(FSDP), "ln_ssm_out": P(FSDP)})
    if cfg.mixer == "rwkv6":
        b.update({"rwkv_t.mu": P(None, FSDP), "rwkv_t.wr": P(FSDP, TP),
                  "rwkv_t.wk": P(FSDP, TP), "rwkv_t.wv": P(FSDP, TP),
                  "rwkv_t.wg": P(FSDP, TP), "rwkv_t.wo": P(TP, FSDP),
                  "rwkv_t.w0": P(FSDP), "rwkv_t.ww1": P(FSDP, TP),
                  "rwkv_t.ww2": P(TP, FSDP), "rwkv_t.u": P(TP, None),
                  "rwkv_c.mu_c": P(None, FSDP), "rwkv_c.wk": P(FSDP, TP),
                  "rwkv_c.wv": P(TP, FSDP), "rwkv_c.wr": P(FSDP, TP)})
    if cfg.mixer == "fourier":
        b.update({"fourier.taps": P(None, FSDP),
                  "fourier.gate": P(FSDP, TP)})
    if cfg.mixer != "rwkv6":
        if cfg.is_moe:
            b.update({"moe.router": P(FSDP, None),
                      "moe.w_gate": P(None, FSDP, TP),
                      "moe.w_up": P(None, FSDP, TP),
                      "moe.w_down": P(None, TP, FSDP)})
        else:
            b.update({"mlp.w_gate": P(FSDP, TP), "mlp.w_up": P(FSDP, TP),
                      "mlp.w_down": P(TP, FSDP)})
    return b


def param_specs(cfg: ModelConfig) -> dict:
    """The reference's ``param_specs`` (FSDP over (pod, data), TP over
    model) by the port's parameter names: a block leaf's spec is the
    reference's without its leading layer ``None`` (the port keeps a leaf
    a layer)."""
    check_supported(cfg)
    specs = {"embed": P(TP, FSDP), "final_norm": P(FSDP),
             "lm_head": P(FSDP, TP)}
    block = _block_specs(cfg)
    for i in range(cfg.num_layers):
        specs.update({f"blocks.{i}.{k}": v for k, v in block.items()})
    return specs


def decode_state_specs(cfg: ModelConfig) -> dict:
    """The reference's ``decode_state_specs``: the port's decode state is
    stacked over the layers as the reference's is, so the specs are the
    same, leading layer ``None`` included."""
    sp = {}
    if cfg.mixer in ("attn", "hymba"):
        sp["cache_k"] = P(None, FSDP, None, None, TP)
        sp["cache_v"] = P(None, FSDP, None, None, TP)
    if cfg.mixer == "hymba":
        sp["ssm_h"] = P(None, FSDP, TP, None)
    if cfg.mixer == "rwkv6":
        sp["prev_x"] = P(None, FSDP, TP)
        sp["S"] = P(None, FSDP, TP, None, None)
        sp["prev_x_c"] = P(None, FSDP, TP)
    if cfg.mixer == "fourier":
        sp["ring"] = P(None, FSDP, None, TP)
    return sp


# ---------------------------------------------------------------------------
# Training: the differentiable forward with the fp32 master parameters, the
# loss, and the reference's remat policies
# ---------------------------------------------------------------------------

REMATS = ("none", "block", "full", "sqrt")
#: What ``remat="block"`` keeps of a block's forward for the backward: the
#: products without batch dims (the reference's
#: ``dots_with_no_batch_dims_saveable``; ``x @ W`` is one ``mm``). The rest
#: is recomputed; ``"full"`` keeps nothing.
_BLOCK_SAVES = (torch.ops.aten.mm.default,)


def cast_params(model: DecoderLM, params: Mapping[str, torch.Tensor]
                ) -> dict[str, torch.Tensor]:
    """The master parameters (``convert.init_params``' dict, fp32) cast to
    each parameter's type in ``model``: the matrices to the activation
    type, as the reference casts at every use. The casts are recorded by
    autograd, so gradients come back in the masters' type."""
    return {name: params[name].to(p.dtype)
            for name, p in model.named_parameters()}


def _block_call(block: Block, params: dict, cfg: ModelConfig,
                x: torch.Tensor, *, positions: torch.Tensor, window: int):
    """One block's training forward with ``params`` in place of its own
    weights. The weights go in with the call, so a recomputation under
    ``torch.utils.checkpoint`` reads them too."""
    return torch.func.functional_call(block, params, (cfg, x), {
        "positions": positions, "window": window})


def _checkpointed(fn, saves=None):
    """``fn`` under ``torch.utils.checkpoint`` (not reentrant): nothing of
    its forward kept for the backward, or the outputs of the ops in
    ``saves``."""
    kw = {}
    if saves is not None:
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, list(saves))
    return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False, **kw)


def _best_outer(L: int) -> int:
    """Largest divisor of L closest to sqrt(L) (the reference's)."""
    for d in range(math.isqrt(L), 0, -1):
        if L % d == 0:
            return d
    return 1


def _add_aux(total: torch.Tensor, aux: Optional[torch.Tensor]
             ) -> torch.Tensor:
    return total if aux is None else total + aux


def _run_blocks(calls: list, x: torch.Tensor, remat: str
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The blocks' training forward under the reference's remat policy
    (``_scan_blocks``): ``none``; ``block`` and ``full``, one checkpoint a
    block; ``sqrt``, a checkpoint around each of about sqrt(L) groups of
    blocks, each block inside checkpointed again. Returns (x, aux summed
    over the blocks)."""
    if remat not in REMATS:
        raise ValueError(f"remat={remat!r}: one of {REMATS}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if remat == "sqrt":
        Li = len(calls) // _best_outer(len(calls))

        def group(fns, xc, acc):
            for fn in fns:
                xc, a = fn(xc)
                acc = _add_aux(acc, a)
            return xc, acc

        inner = [_checkpointed(fn) for fn in calls]
        for g in range(0, len(calls), Li):
            x, aux = _checkpointed(functools.partial(
                group, inner[g:g + Li]))(x, aux)
        return x, aux
    if remat != "none":
        calls = [_checkpointed(fn, _BLOCK_SAVES if remat == "block"
                               else None) for fn in calls]
    for fn in calls:
        x, a = fn(x)
        aux = _add_aux(aux, a)
    return x, aux


def forward_train(model: DecoderLM, params: Mapping[str, torch.Tensor],
                  tokens: Optional[torch.Tensor] = None, *,
                  positions: Optional[torch.Tensor] = None,
                  embeds: Optional[torch.Tensor] = None,
                  remat: Optional[str] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``forward`` for training, differentiable: (B, S,
    vocab_padded) logits in the activation type and the aux loss summed
    over the blocks (fp32), with ``params`` (``cast_params``: each in its
    parameter's type) in place of the module's weights. ``model`` gives
    the structure only and may live on the ``meta`` device. ``remat``
    defaults to ``model.cfg.remat``."""
    cfg = model.cfg
    x = model._embed(tokens, embeds, params["embed"])
    positions = model._positions(x, positions)
    windows = _layer_windows(cfg)
    calls = []
    for i, block in enumerate(model.blocks):
        prefix = f"blocks.{i}."
        own = {name[len(prefix):]: value for name, value in params.items()
               if name.startswith(prefix)}
        calls.append(functools.partial(_block_call, block, own, cfg,
                                       positions=positions,
                                       window=windows[i]))
    x, aux = _run_blocks(calls, x, cfg.remat if remat is None else remat)
    x = rms_norm(x, params["final_norm"])
    return x @ params["lm_head"], aux


def loss_fn(model: DecoderLM, params: Mapping[str, torch.Tensor],
            batch: Mapping[str, torch.Tensor], *,
            remat: Optional[str] = None) -> torch.Tensor:
    """The reference's ``loss_fn``: next-token cross entropy over
    ``batch["labels"]`` (-1 = ignore) in fp32, the padded vocabulary
    masked by an additive -1e9 bias, plus 0.01 x the MoE's aux loss.
    ``params`` are the fp32 masters, cast here (``cast_params``). The
    label's logit is picked by a gather, not the reference's one-hot
    contraction (a (B, S, vocab) one-hot is 2.1 GB at fourierpim-lm's
    full width): the same value."""
    cfg = model.cfg
    logits, aux = forward_train(
        model, cast_params(model, params), batch.get("tokens"),
        positions=batch.get("positions"), embeds=batch.get("embeds"),
        remat=remat)
    labels = batch["labels"].long()
    logits = logits.float()
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(cfg.vocab_padded, device=logits.device)
        logits = logits + torch.where(pad >= cfg.vocab_size, -1e9, 0.0)
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    loss = torch.sum((lse - picked) * mask) / torch.clamp(mask.sum(),
                                                          min=1.0)
    return loss + 0.01 * aux


def value_and_grad(model: DecoderLM, params: Mapping[str, torch.Tensor],
                   batch: Mapping[str, torch.Tensor], *,
                   remat: Optional[str] = None
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(loss, the gradient of every master parameter, in its type): the
    reference's ``jax.value_and_grad(lambda p: loss_fn(cfg, p, batch))``.
    ``params`` need not require grad."""
    leaves = {name: p.detach().requires_grad_(True)
              for name, p in params.items()}
    with torch.enable_grad():
        loss = loss_fn(model, leaves, batch, remat=remat)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    # a leaf the loss does not read (the token table of an arch that takes
    # embeddings) has a zero gradient, as under jax.grad
    return loss.detach(), {
        name: torch.zeros_like(leaves[name]) if g is None else g
        for name, g in zip(leaves, grads)}


@torch.no_grad()
def generate(model: DecoderLM, tokens: torch.Tensor,
             gen: int) -> torch.Tensor:
    """Greedy generation, the reference serve CLI's loop: prefill the
    (B, S) prompt with room for ``gen`` more positions, then ``gen`` decode
    steps, each fed the argmax of the previous logits over the vocabulary.
    Returns the (gen, B) tokens, the first from the prefill's logits.

    The reference's loop takes the argmax over all ``vocab_padded`` logits,
    so it can emit a padding id, which is no token; here the padding
    columns are left out. Where the reference's argmax is a token the two
    agree."""
    if model.cfg.frontend == "embeddings":
        raise ValueError(f"{model.cfg.name} takes embeddings; generate "
                         f"feeds back tokens")
    S, V = tokens.shape[1], model.cfg.vocab_size
    logits, state = model.prefill(tokens, cache_capacity=S + gen)
    tok = logits[:, :V].argmax(dim=-1)
    out = []
    for i in range(gen):
        out.append(tok)
        logits, state = model.decode_step(state, tok, S + i)
        tok = logits[:, :V].argmax(dim=-1)
    return torch.stack(out)
