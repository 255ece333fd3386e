"""Mixture-of-Experts FFN: GShard-style grouped top-k routing (port of
``repro.models.layers.moe``).

Tokens are routed in groups of g = min(cfg.moe_group_size, S) (the
sequence padded with zero rows to a multiple of g), with a capacity of
C = max(1, ceil(g k / E capacity_factor)) slots per expert, batch row and
group. The routing decisions are the reference's:

  * the router's logits in fp32 from the fp32 router, their softmax, and
    the k largest probabilities in ``jax.lax.top_k``'s order (among equal
    probabilities the lower expert first: a stable descending sort, where
    ``torch.topk`` keeps no order among ties);
  * the gates, those k probabilities over their sum;
  * queue positions slot-major (slot 0 of every token of the group first,
    then slot 1, ...); a slot is kept where its position is below C and
    its gate, cast to ``cfg.moe_dispatch_dtype``, is above 0. The
    reference's arithmetic flushes subnormal results to zero (XLA on the
    CPU, as the TPU), so a gate below fp32's smallest normal number is 0
    there: such a slot is dropped here too (``_TINY``). bf16 has fp32's
    exponent range, so no normal fp32 gate rounds to 0 in bf16.

The reference dispatches and combines with dense one-hot einsums over
(token, expert, capacity slot), "the standard TPU formulation". Here the
kept slots are scattered into an (E, B nG C, d) buffer (each slot unique,
empty slots zero, as in the reference), the three expert products run as
batched matmuls over E, and each kept slot's output is gathered back,
weighted by its gate rounded to ``moe_dispatch_dtype`` and then to x's type
(the reference's ``combine.astype(x.dtype)``), and the k slots summed in
fp32. The dispatch is exact; the combine differs from the reference only
in the order of that k-term fp32 sum.

``route``, ``dispatch``, ``experts`` and ``combine`` are looked up at call
time, so a caller may wrap them (``chip_smoke.py`` records the routing and
labels each stage in a trace).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers.common import partial_product

_DISPATCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: fp32's smallest normal number: a gate below it is 0 in the reference
_TINY = torch.finfo(torch.float32).tiny


def init_moe_params(cfg, generator: torch.Generator, dtype: torch.dtype,
                    device) -> dict[str, torch.Tensor]:
    """Weights of the reference's distributions (``init_moe_params``): the
    router in fp32 whatever ``dtype``, the experts in ``dtype``."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts

    def normal(shape, std, dt=dtype):
        return torch.randn(shape, generator=generator, dtype=dt,
                           device=device) * std

    return {"router": normal((d, E), d ** -0.5, torch.float32),
            "w_gate": normal((E, d, f), d ** -0.5),
            "w_up": normal((E, d, f), d ** -0.5),
            "w_down": normal((E, f, d), f ** -0.5)}


@dataclasses.dataclass
class Routing:
    """One call's routing, each field per (batch row, group, token, slot)
    (B, nG, g, k) unless said otherwise."""
    probs: torch.Tensor      # (B, nG, g, E) fp32 softmax of the logits
    expert: torch.Tensor     # chosen expert, int64
    gate: torch.Tensor       # normalised gate, fp32
    pos: torch.Tensor        # queue position in the expert, int64
    kept: torch.Tensor       # bool: dispatched
    row: torch.Tensor        # row in the (E B nG C) expert buffer; E B nG C
                             # (one past the end) where dropped
    capacity: int            # C
    dispatch_dtype: torch.dtype
    aux: torch.Tensor        # () fp32 load-balance loss


def route(router: torch.Tensor, xg: torch.Tensor, cfg) -> Routing:
    """The reference's routing of xg (B, nG, g, d) by the fp32 router
    (d, E)."""
    E, k = cfg.num_experts, cfg.experts_per_token
    g = xg.shape[2]
    logits = xg.float() @ router.float()                      # (B,nG,g,E)
    probs = torch.softmax(logits, dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = top[..., :k], order[..., :k]
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)

    # aux load-balance loss: E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1, 2))
    fe = F.one_hot(expert[..., 0], E).float().mean(dim=(0, 1, 2))
    aux = E * torch.sum(me * fe)

    C = max(1, math.ceil(g * k / E * cfg.capacity_factor))
    # queue position: slot 0 of every token first, then slot 1, ...
    slot_major = expert.transpose(2, 3)                       # (B,nG,k,g)
    onehot = F.one_hot(slot_major.flatten(2), E)              # (B,nG,kg,E)
    before = onehot.cumsum(dim=2) - onehot
    pos = before.gather(-1, slot_major.flatten(2)[..., None])[..., 0]
    pos = pos.view_as(slot_major).transpose(2, 3)             # (B,nG,g,k)
    ddt = _DISPATCH_DTYPES[cfg.moe_dispatch_dtype]
    kept = (pos < C) & (gate.to(ddt) >= _TINY)
    B, nG = xg.shape[:2]
    n = B * nG * C                                 # rows per expert
    group = torch.arange(B * nG, device=xg.device).view(B, nG, 1, 1)
    row = torch.where(kept, expert * n + group * C + pos, E * n)
    return Routing(probs=probs, expert=expert, gate=gate, pos=pos,
                   kept=kept, row=row, capacity=C, dispatch_dtype=ddt,
                   aux=aux)


def dispatch(xg: torch.Tensor, r: Routing,
             reduce_dtype: torch.dtype | None) -> torch.Tensor:
    """The kept slots' tokens in an (E, B nG C, d) buffer, empty slots
    zero, each rounded to ``reduce_dtype`` as the reference's dispatch
    einsum rounds it. Dropped slots are written to one spare row past the
    end."""
    B, nG, g, d = xg.shape
    E = r.probs.shape[-1]
    n = B * nG * r.capacity
    buf = xg.new_zeros((E * n + 1, d))
    src = xg.reshape(-1, d)
    if reduce_dtype is not None:
        src = src.to(reduce_dtype).to(xg.dtype)
    for j in range(r.row.shape[-1]):
        buf.index_copy_(0, r.row[..., j].reshape(-1), src)
    return buf[:E * n].view(E, n, d)


def experts(xe: torch.Tensor, params, reduce_dtype: torch.dtype | None
            ) -> torch.Tensor:
    """The SwiGLU experts over xe (E, N, d) in its type, each product
    rounded to ``reduce_dtype`` (None: fp32) before that type, as the
    reference's ``preferred_element_type``."""
    h = experts_hidden(xe, params.w_gate, params.w_up, reduce_dtype)
    return _rounded(h, params.w_down, reduce_dtype)


def _rounded(a: torch.Tensor, b: torch.Tensor,
             reduce_dtype: torch.dtype | None) -> torch.Tensor:
    out = torch.bmm(a, b)
    return out if reduce_dtype is None else out.to(reduce_dtype).to(a.dtype)


def experts_hidden(xe: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                   reduce_dtype: torch.dtype | None) -> torch.Tensor:
    """The experts' SwiGLU hidden layer (E, N, f) in xe's type."""
    gate = _rounded(xe, w_gate, reduce_dtype)
    return F.silu(gate.float()).to(xe.dtype) * _rounded(xe, w_up,
                                                        reduce_dtype)


def combine(ye: torch.Tensor, r: Routing, dtype: torch.dtype,
            reduce_dtype: torch.dtype | None) -> torch.Tensor:
    """Each token's kept slots' outputs from ye (E, N, d), weighted by
    their gates rounded to the dispatch type and then to ``dtype``, summed
    over the k slots in fp32: (B, nG, g, d) in ``dtype``."""
    d = ye.shape[-1]
    flat = ye.reshape(-1, d)
    weight = torch.where(r.kept, r.gate.to(r.dispatch_dtype).to(dtype)
                         .float(), 0.0)
    rows = torch.where(r.kept, r.row, 0)
    acc = None
    for j in range(rows.shape[-1]):
        term = (flat.index_select(0, rows[..., j].reshape(-1)).float()
                * weight[..., j].reshape(-1, 1))
        acc = term if acc is None else acc + term
    y = acc.view(*r.expert.shape[:3], d)
    if reduce_dtype is not None:
        y = y.to(reduce_dtype)
    return y.to(dtype)


def moe_ffn(params, x: torch.Tensor, cfg,
            reduce_dtype: torch.dtype | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d) in x's type, aux_loss () fp32).

    params: router (d, E) fp32; w_gate, w_up (E, d, f) and w_down
    (E, f, d) in x's type. reduce_dtype: the products' rounding, as for
    ``swiglu_mlp`` (the reference's ``cfg.reduce_dtype``)."""
    B, S, d = x.shape
    g = min(cfg.moe_group_size, S)
    pad = (-S) % g
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    xg = x.reshape(B, -1, g, d)
    r = route(params.router, xg, cfg)
    ye = experts(dispatch(xg, r, reduce_dtype), params, reduce_dtype)
    y = combine(ye, r, x.dtype, reduce_dtype).reshape(B, -1, d)
    return y[:, :S], r.aux


def moe_ffn_sharded(sh, prefix: str, hs: list, cfg,
                    reduce_dtype: torch.dtype | None = None
                    ) -> tuple[list, list]:
    """``moe_ffn`` over the model axis of ``sh`` (``models/sharded.py``),
    ``hs`` the replicated input, one (B, S, d) tensor a shard. The routing,
    the queue positions and the kept slots are computed on every shard
    from its copy of the input, alike (the router is replicated), and so
    is the dispatch; the experts' hidden width goes over the shards
    (``w_gate``, ``w_up`` by column blocks, ``w_down`` by row blocks), each
    shard's partial sums in ``reduce_dtype`` (fp32 by default) are psummed,
    and each shard combines its copy. The aux loss's means over the batch
    go over the data shards (``sh.data_mean``). Returns (outputs, aux
    losses), one a shard."""
    routed = []
    for x, router in zip(hs, sh.view(prefix + "router")):
        B, S, d = x.shape
        g = min(cfg.moe_group_size, S)
        xg = F.pad(x, (0, 0, 0, (-S) % g)).reshape(B, -1, g, d)
        routed.append((xg, route(router, xg, cfg)))
    xe = sh.enter([dispatch(xg, r, reduce_dtype) for xg, r in routed])
    parts = []
    for x, wg, wu, wd in zip(xe, sh.view(prefix + "w_gate", 2),
                             sh.view(prefix + "w_up", 2),
                             sh.view(prefix + "w_down", 1)):
        h = experts_hidden(x, wg, wu, reduce_dtype)
        parts.append(partial_product(h, wd, reduce_dtype))
    ys, auxs = [], []
    E = cfg.num_experts
    me = sh.data_mean([r.probs.mean(dim=(0, 1, 2)) for _, r in routed])
    fe = sh.data_mean([F.one_hot(r.expert[..., 0], E).float().mean(
        dim=(0, 1, 2)) for _, r in routed])
    for (xg, r), ye, x, m, f in zip(routed, sh.psum(parts), hs, me, fe):
        y = combine(ye.to(x.dtype), r, x.dtype, reduce_dtype)
        ys.append(y.reshape(x.shape[0], -1, x.shape[-1])[:, :x.shape[1]])
        auxs.append(E * torch.sum(m * f))
    return ys, auxs

