"""Recurrent mixers: RWKV6 (Finch) time and channel mixing and the
Mamba-style selective SSM branch of Hymba's parallel heads (port of
``repro.models.layers.recurrent``).

Both recurrences are loops over the sequence with an fp32 state, as the
reference's are ``lax.scan``s: (B, H, 64, 64) for RWKV, (B, d, n) for the
SSM. A decode step is the same loop at S = 1. Neither recurrence is an LTI
convolution (the decay depends on the data), so the FFT does not apply.

Each step is one fused multiply-add over the state (``torch.addcmul``):
the terms that do not depend on the state are formed for a chunk of
SCAN_CHUNK steps at a time (RWKV's k v^T, the SSM's decay and input), and
the outputs that read the states are one batched product per chunk.
Against the reference's step, the RWKV output r.(S + u k v^T) is formed
as r.S + (r.(u k)) v, the same sum in another order.

Parameters are the attributes of an ``nn.Module`` (see ``models/lm.py``):
the matrices the reference casts to x's type are held in x's type; the
leaves it reads in fp32 (``w0``, ``u``, ``ww1``, ``ww2``; ``w_dt``,
``w_b``, ``w_c``, ``a_log``, ``d_skip``, ``dt_bias``) in the type it
creates them in, and are read here in fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers.common import partial_product

RWKV_HEAD_DIM = 64
RWKV_LORA = 64
#: Steps whose state-independent terms are formed at once: the (B, H, 64,
#: 64) k v^T of 64 steps of rwkv6-7b at batch 8 is 512 MB in fp32.
SCAN_CHUNK = 64


# ---------------------------------------------------------------------------
# RWKV6 time mixing (data-dependent decay, per-head matrix state)
# ---------------------------------------------------------------------------

def init_rwkv_params(cfg, generator: torch.Generator, dtype: torch.dtype,
                     device) -> dict[str, torch.Tensor]:
    """Weights of the reference's distributions (``init_rwkv_params``):
    ``w0`` and ``u`` in fp32, the rest in ``dtype``."""
    d = cfg.d_model
    H = d // RWKV_HEAD_DIM

    def normal(shape, std, dt=dtype):
        return torch.randn(shape, generator=generator, dtype=dt,
                           device=device) * std

    return {"mu": torch.full((5, d), 0.5, dtype=dtype, device=device),
            **{name: normal((d, d), d ** -0.5)
               for name in ("wr", "wk", "wv", "wg", "wo")},
            "w0": torch.full((d,), -6.0, dtype=torch.float32, device=device),
            "ww1": normal((d, RWKV_LORA), d ** -0.5),
            "ww2": normal((RWKV_LORA, d), RWKV_LORA ** -0.5),
            "u": normal((H, RWKV_HEAD_DIM), 0.1, torch.float32)}


def _shifted(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) shifted one token later, x_prev (B, d) in front."""
    return torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _rwkv_inputs(params, x: torch.Tensor, x_prev: torch.Tensor):
    """Token-shifted projections. x: (B, S, d); x_prev: (B, d) last token of
    the previous chunk (zeros at sequence start). Returns r, k, v, g in x's
    type and the decay w (B, S, d) in fp32."""
    shifted = _shifted(x, x_prev)
    mu = params.mu
    xs = [x + mu[i] * (shifted - x) for i in range(5)]
    r = xs[0] @ params.wr
    k = xs[1] @ params.wk
    v = xs[2] @ params.wv
    g = xs[3] @ params.wg
    w_raw = (xs[4].float() @ params.ww1.float() @ params.ww2.float()
             + params.w0)
    return r, k, v, g, torch.exp(-torch.exp(w_raw))


def _wkv_scan(r, k, v, w, u, S0):
    """The RWKV6 recurrence, time-major fp32: r, k, v, w (T, B, H, hd); u
    (H, hd); S0 (B, H, hd, hd). out_t = r_t.(S_{t-1} + u k_t v_t^T),
    S_t = w_t S_{t-1} + k_t v_t^T (w scaling S's rows). Returns out
    (T, B, H, hd) and S_T."""
    T = r.shape[0]
    out = (r * u * k).sum(dim=-1, keepdim=True) * v      # the u term
    S = S0
    for t0 in range(0, T, SCAN_CHUNK):
        t1 = min(T, t0 + SCAN_CHUNK)
        kv = k[t0:t1, ..., :, None] * v[t0:t1, ..., None, :]
        wt = w[t0:t1, ..., None]
        states = _chunk_states(kv, wt, S)
        out[t0:t1] += torch.einsum("tbhi,tbhij->tbhj", r[t0:t1],
                                   states[:-1])
        S = states[-1]
    return out, S


def _chunk_states(inp: torch.Tensor, decay: torch.Tensor,
                  h: torch.Tensor) -> torch.Tensor:
    """The states h_0 = h, h_{t+1} = inp_t + decay_t h_t over a chunk
    (T, ...), stacked: (T + 1, ...). Each step is one ``addcmul``, written
    into a preallocated stack; where autograd records (grad mode on and an
    input that requires grad) the steps are kept as separate tensors and
    stacked, since an ``out=`` write has no backward. The same values
    either way. On the ``meta`` device (the dry-run) the states' shapes
    come from one ``addcmul`` over the chunk, which depends on the same
    inputs: no values, and no loop of T ops."""
    if inp.device.type == "meta":
        return torch.cat([h[None], torch.addcmul(inp, decay, h)])
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (inp, decay, h)):
        states = [h]
        for t in range(inp.shape[0]):
            states.append(torch.addcmul(inp[t], decay[t], states[-1]))
        return torch.stack(states)
    states = inp.new_empty((inp.shape[0] + 1, *h.shape))
    states[0] = h
    for t in range(inp.shape[0]):
        torch.addcmul(inp[t], decay[t], states[t], out=states[t + 1])
    return states


def rwkv_time_mix(params, x: torch.Tensor, state: dict | None = None):
    """x: (B, S, d). Returns (y (B, S, d) in x's type, new_state). state =
    {"prev_x": (B, d), "S": (B, H, 64, 64) fp32} carried across chunks and
    decode steps (zeros when None)."""
    B, S, d = x.shape
    H, hd = d // RWKV_HEAD_DIM, RWKV_HEAD_DIM
    dtype = x.dtype
    if state is None:
        state = {"prev_x": x.new_zeros((B, d)),
                 "S": x.new_zeros((B, H, hd, hd), dtype=torch.float32)}
    r, k, v, g, w = _rwkv_inputs(params, x, state["prev_x"])

    def heads(a):                                   # (S, B, H, hd) fp32
        return a.float().reshape(B, S, H, hd).transpose(0, 1)

    out, S_fin = _wkv_scan(heads(r), heads(k), heads(v), heads(w),
                           params.u.float(), state["S"])
    y = out.transpose(0, 1).reshape(B, S, d).to(dtype)
    y = y * F.silu(g.float()).to(dtype)
    return y @ params.wo, {"prev_x": x[:, -1], "S": S_fin}


def init_rwkv_channel_params(cfg, generator: torch.Generator,
                             dtype: torch.dtype, device
                             ) -> dict[str, torch.Tensor]:
    """Weights of the reference's distributions
    (``init_rwkv_channel_params``), in ``dtype``."""
    d, f = cfg.d_model, cfg.d_ff

    def normal(shape, std):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device) * std

    return {"mu_c": torch.full((2, d), 0.5, dtype=dtype, device=device),
            "wk": normal((d, f), d ** -0.5),
            "wv": normal((f, d), f ** -0.5),
            "wr": normal((d, d), d ** -0.5)}


def rwkv_channel_mix(params, x: torch.Tensor, prev_x: torch.Tensor):
    """RWKV squared-ReLU channel mixing with token shift. Returns (y, x's
    last token: the next call's prev_x)."""
    dtype = x.dtype
    shifted = _shifted(x, prev_x)
    mu = params.mu_c
    xk = x + mu[0] * (shifted - x)
    xr = x + mu[1] * (shifted - x)
    k = torch.square(torch.relu((xk @ params.wk).float())).to(dtype)
    r = torch.sigmoid((xr @ params.wr).float()).to(dtype)
    return r * (k @ params.wv), x[:, -1]


# ---------------------------------------------------------------------------
# Mamba-style selective SSM branch (Hymba parallel heads)
# ---------------------------------------------------------------------------

def init_ssm_params(cfg, generator: torch.Generator, dtype: torch.dtype,
                    device) -> dict[str, torch.Tensor]:
    """Weights of the reference's distributions (``init_ssm_params``): the
    projections in ``dtype``; ``a_log`` = log(1 .. n) on every row,
    ``d_skip`` 1 and ``dt_bias`` -4 in fp32."""
    d, n = cfg.d_model, cfg.ssm_state

    def normal(shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device) * d ** -0.5

    f32 = dict(dtype=torch.float32, device=device)
    return {"w_dt": normal((d, d)), "w_b": normal((d, n)),
            "w_c": normal((d, n)),
            "a_log": torch.log(torch.linspace(1.0, float(n), n, **f32))
            [None, :] * torch.ones((d, 1), **f32),
            "d_skip": torch.ones((d,), **f32),
            "dt_bias": torch.full((d,), -4.0, **f32)}


def _ssm_scan(dt, xf, bt, ct, a, h0):
    """The selective SSM, time-major fp32: dt, xf (T, B, d); bt, ct
    (T, B, n); a (d, n); h0 (B, d, n). h_t = exp(dt_t a) h_{t-1} +
    (dt_t x_t) b_t; y_t = h_t . c_t. Returns y (T, B, d) and h_T."""
    T = dt.shape[0]
    ys = []
    h = h0
    for t0 in range(0, T, SCAN_CHUNK):
        t1 = min(T, t0 + SCAN_CHUNK)
        decay = torch.exp(dt[t0:t1, ..., None] * a)
        inp = (dt[t0:t1] * xf[t0:t1])[..., None] * bt[t0:t1, :, None, :]
        states = _chunk_states(inp, decay, h)
        ys.append(torch.einsum("tbdn,tbn->tbd", states[1:], ct[t0:t1]))
        h = states[-1]
    return torch.cat(ys), h


def ssm_mix(params, x: torch.Tensor, state: torch.Tensor | None = None):
    """Selective SSM: h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t;
    y_t = h_t . C_t + D x_t.  x: (B, S, d); state: (B, d, n) fp32 (zeros
    when None). Returns (y in x's type, the final state)."""
    B, S, d = x.shape
    n = params.w_b.shape[-1]
    if state is None:
        state = x.new_zeros((B, d, n), dtype=torch.float32)
    xf = x.float()
    dt = F.softplus(xf @ params.w_dt.float() + params.dt_bias)
    bt = xf @ params.w_b.float()
    ct = xf @ params.w_c.float()
    a = -torch.exp(params.a_log)

    def steps(t):
        return t.transpose(0, 1)

    ys, h = _ssm_scan(steps(dt), steps(xf), steps(bt), steps(ct), a, state)
    y = ys.transpose(0, 1) + xf * params.d_skip
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# The model axis (``models/sharded.py``): ``sh`` is the run's ``Shards``,
# ``hs`` the replicated input, one tensor a shard
# ---------------------------------------------------------------------------

def rwkv_heads_split(cfg, shards: int) -> bool:
    """Whether the RWKV6 time-mix heads go over ``shards`` model shards
    (else every shard runs the whole mixer)."""
    return shards > 1 and (cfg.d_model // RWKV_HEAD_DIM) % shards == 0


def rwkv_time_mix_sharded(sh, prefix: str, hs: list, cfg,
                          states: list | None = None) -> tuple[list, list]:
    """``rwkv_time_mix`` over the model axis: the heads go over the shards
    (``wr``, ``wk``, ``wv``, ``wg`` by column blocks, ``u`` and the state S
    by heads, ``wo`` by row blocks with a psum) and the decay's low-rank
    pair by rank (``ww1`` columns, ``ww2`` rows, a psum); the token-shift
    mixes are computed on every shard alike. ``states``: one {"prev_x"
    (B, d), "S" (B, H/M, 64, 64)} a shard, or None. Returns (outputs, new
    states). Where the heads do not divide every shard runs the whole
    mixer (``rwkv_heads_split``)."""
    if not rwkv_heads_split(cfg, sh.shards):
        params = sh.namespaces(prefix, ("mu", "wr", "wk", "wv", "wg", "wo",
                                        "w0", "ww1", "ww2", "u"))
        outs = [rwkv_time_mix(p, x, None if states is None else st)
                for p, x, st in zip(params, hs, states or [None] * len(hs))]
        return [y for y, _ in outs], [st for _, st in outs]
    B, S, d = hs[0].shape
    hd = RWKV_HEAD_DIM
    if states is None:
        states = [{"prev_x": x.new_zeros((B, d)),
                   "S": x.new_zeros((B, d // hd // sh.shards, hd, hd),
                                    dtype=torch.float32)} for x in hs]
    mixes = []
    for x, mu, st in zip(hs, sh.view(prefix + "mu"), states):
        shifted = _shifted(x, st["prev_x"])
        mixes.append([x + mu[i] * (shifted - x) for i in range(5)])
    entered = [sh.enter([m[i] for m in mixes]) for i in range(5)]

    def cols(name, i):
        return [x @ w for x, w in zip(entered[i],
                                      sh.view(prefix + name, 1))]

    r, k, v, g = cols("wr", 0), cols("wk", 1), cols("wv", 2), cols("wg", 3)
    low = [partial_product(x.float() @ w1.float(), w2, None)
           for x, w1, w2 in zip(entered[4], sh.view(prefix + "ww1", 1),
                                sh.view(prefix + "ww2", 0))]
    w = sh.split([torch.exp(-torch.exp(y + w0)) for y, w0 in zip(
        sh.psum(low), sh.view(prefix + "w0"))], -1)
    parts, new = [], []
    for i, (x, u, st) in enumerate(zip(hs, sh.view(prefix + "u", 0),
                                       states)):
        def heads(a):                               # (S, B, H/M, hd) fp32
            return a.float().reshape(B, S, -1, hd).transpose(0, 1)

        out, S_fin = _wkv_scan(heads(r[i]), heads(k[i]), heads(v[i]),
                               heads(w[i]), u.float(), st["S"])
        y = out.transpose(0, 1).reshape(B, S, -1).to(x.dtype)
        parts.append(y * F.silu(g[i].float()).to(x.dtype))
        new.append({"prev_x": x[:, -1], "S": S_fin})
    parts = [partial_product(y, wo, None) for y, wo in zip(parts,
                                               sh.view(prefix + "wo", 0))]
    return [y.to(x.dtype) for y, x in zip(sh.psum(parts), hs)], new


def rwkv_channel_mix_sharded(sh, prefix: str, hs: list,
                             prev: list) -> tuple[list, list]:
    """``rwkv_channel_mix`` over the model axis: ``wk`` by column blocks,
    ``wv`` by row blocks with a psum, ``wr`` by column blocks with an
    all-gather. Returns (outputs, each shard's last token)."""
    xk, xr = [], []
    for x, mu, p in zip(hs, sh.view(prefix + "mu_c"), prev):
        shifted = _shifted(x, p)
        xk.append(x + mu[0] * (shifted - x))
        xr.append(x + mu[1] * (shifted - x))
    parts, rs = [], []
    for x, a, b, wk, wv, wr in zip(hs, sh.enter(xk), sh.enter(xr),
                                   sh.view(prefix + "wk", 1),
                                   sh.view(prefix + "wv", 0),
                                   sh.view(prefix + "wr", 1)):
        k = torch.square(torch.relu((a @ wk).float())).to(x.dtype)
        parts.append(partial_product(k, wv, None))
        rs.append(torch.sigmoid((b @ wr).float()).to(x.dtype))
    return ([r * kv.to(x.dtype) for r, kv, x in zip(
        sh.gather(rs, -1), sh.psum(parts), hs)], [x[:, -1] for x in hs])


def ssm_mix_sharded(sh, prefix: str, hs: list,
                    states: list | None = None) -> tuple[list, list]:
    """``ssm_mix`` over the model axis: the channels go over the shards
    (``w_dt`` by column blocks; ``dt_bias``, ``a_log``, ``d_skip`` and the
    state by channel), ``w_b`` and ``w_c`` stay whole on every shard, and
    each shard's output channels are all-gathered. ``states``: one
    (B, d/M, n) fp32 state a shard, or None. Returns (outputs, final
    states)."""
    xf = [x.float() for x in hs]
    bt = sh.enter([x @ w.float() for x, w in zip(xf,
                                                 sh.view(prefix + "w_b"))])
    ct = sh.enter([x @ w.float() for x, w in zip(xf,
                                                 sh.view(prefix + "w_c"))])
    outs, new = [], []
    for i, (x, xc, w_dt, bias, a_log, skip) in enumerate(zip(
            sh.enter(xf), sh.split(xf, -1), sh.view(prefix + "w_dt", 1),
            sh.view(prefix + "dt_bias", 0), sh.view(prefix + "a_log", 0),
            sh.view(prefix + "d_skip", 0))):
        B, S, dm = xc.shape
        h0 = xc.new_zeros((B, dm, a_log.shape[-1])) if states is None \
            else states[i]
        dt = F.softplus(x @ w_dt.float() + bias)

        def steps(t):
            return t.transpose(0, 1)

        ys, h = _ssm_scan(steps(dt), steps(xc), steps(bt[i]), steps(ct[i]),
                          -torch.exp(a_log), h0)
        outs.append((ys.transpose(0, 1) + xc * skip).to(hs[i].dtype))
        new.append(h)
    return sh.gather(outs, -1), new

