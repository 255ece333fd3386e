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
    either way."""
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
