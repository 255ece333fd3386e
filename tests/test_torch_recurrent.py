"""The port's recurrent mixers (``repro_torch.models.layers.recurrent``:
RWKV6 time and channel mixing, hymba's selective SSM) against the
reference's (``repro.models.layers.recurrent``) on the CPU, at smoke sizes.

The same numpy inputs and reference weights go to both; the port holds the
weights as ``DecoderLM`` does (``models/lm.py``: ``RWKVTime``,
``RWKVChannel``, ``SSM``). Tolerances: fp32 outputs and states 1e-4
(absolute and relative): the port forms RWKV's output r.(S + u k v^T) as
r.S + (r.(u k)) v and takes each state step as one fused multiply-add, the
same sums in other orders; the chunked-state consistency 2e-4, the
reference's own (``tests/test_layers.py``). bf16 outputs one bf16 step
(1e-2).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.models.config import ModelConfig as JConfig
from repro.models.layers import recurrent as jrec
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models import lm as tlm
from repro_torch.models.layers import recurrent as trec

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
_DT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _cfgs(mixer, **kw):
    base = dict(name="t", family="ssm", num_layers=1, d_model=128,
                num_heads=2, num_kv_heads=2, d_ff=256, vocab_size=128,
                mixer=mixer, ssm_state=8 if mixer == "hymba" else 0,
                dtype="float32", param_dtype="float32")
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def _holder(module, w):
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                            for k, v in w.items()})
    return module


def _rwkv(dtype="float32", seed=0):
    jc, tc = _cfgs("rwkv6", dtype=dtype)
    wdt = _DT[dtype][0]
    wt = jax.tree.map(np.asarray,
                      jrec.init_rwkv_params(jax.random.key(seed), jc,
                                            jnp.float32))
    wc = jax.tree.map(np.asarray,
                      jrec.init_rwkv_channel_params(jax.random.key(seed + 1),
                                                    jc, jnp.float32))
    return (wt, wc, _holder(tlm.RWKVTime(tc, wdt, torch.float32, "cpu"), wt),
            _holder(tlm.RWKVChannel(tc, wdt, "cpu"), wc))


def _ssm(dtype="float32", seed=0):
    jc, tc = _cfgs("hymba", dtype=dtype)
    w = jax.tree.map(np.asarray,
                     jrec.init_ssm_params(jax.random.key(seed), jc,
                                          jnp.float32))
    return w, _holder(tlm.SSM(tc, torch.float32, "cpu"), w)


def _x(shape, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("S", [1, 16, 150])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_time_mix_matches_reference(S, with_state):
    """S = 1 is a decode step; 150 crosses two SCAN_CHUNK boundaries."""
    wt, _, ht, _ = _rwkv()
    B, d = 2, 128
    x = _x((B, S, d), S)
    state = jstate = None
    if with_state:
        prev, S0 = _x((B, d), 1), _x((B, 2, 64, 64), 2, 0.5)
        state = {"prev_x": torch.from_numpy(prev), "S": torch.from_numpy(S0)}
        jstate = {"prev_x": jnp.asarray(prev), "S": jnp.asarray(S0)}
    y, new = trec.rwkv_time_mix(ht, torch.from_numpy(x), state)
    jy, jnew = jrec.rwkv_time_mix({k: jnp.asarray(v) for k, v in wt.items()},
                                  jnp.asarray(x), jstate)
    _close(y, jy)
    _close(new["prev_x"], jnew["prev_x"])
    assert new["S"].dtype == torch.float32
    _close(new["S"], jnew["S"])


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_channel_mix_matches_reference(with_state):
    _, wc, _, hc = _rwkv()
    x = _x((2, 20, 128), 4)
    prev = _x((2, 128), 5) if with_state else np.zeros((2, 128), np.float32)
    y, last = trec.rwkv_channel_mix(hc, torch.from_numpy(x),
                                    torch.from_numpy(prev))
    jy, jlast = jrec.rwkv_channel_mix(
        {k: jnp.asarray(v) for k, v in wc.items()}, jnp.asarray(x),
        jnp.asarray(prev))
    _close(y, jy)
    _close(last, jlast)


@pytest.mark.parametrize("S", [1, 12, 150])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_mix_matches_reference(S, with_state):
    w, h = _ssm()
    x = _x((2, S, 128), S + 10)
    state = _x((2, 128, 8), 6) if with_state else None
    y, hfin = trec.ssm_mix(h, torch.from_numpy(x),
                           None if state is None else torch.from_numpy(state))
    jy, jh = jrec.ssm_mix({k: jnp.asarray(v) for k, v in w.items()},
                          jnp.asarray(x),
                          None if state is None else jnp.asarray(state))
    _close(y, jy)
    assert hfin.dtype == torch.float32 and hfin.shape == (2, 128, 8)
    _close(hfin, jh)


def test_rwkv_chunked_state_consistency():
    """[0:S] in one call == two calls with the state carried (the property
    decode and a prefill's state rely on), as the reference's own test
    pins it for the reference."""
    _, _, ht, _ = _rwkv()
    x = torch.from_numpy(_x((2, 16, 128), 8))
    y_full, s_full = trec.rwkv_time_mix(ht, x)
    y1, st = trec.rwkv_time_mix(ht, x[:, :8])
    y2, s2 = trec.rwkv_time_mix(ht, x[:, 8:], state=st)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_full,
                               rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s2["S"], s_full["S"], rtol=2e-4, atol=2e-4)


def test_ssm_chunked_state_consistency():
    _, h = _ssm()
    x = torch.from_numpy(_x((2, 12, 128), 9))
    y_full, h_full = trec.ssm_mix(h, x)
    y1, h1 = trec.ssm_mix(h, x[:, :6])
    y2, h2 = trec.ssm_mix(h, x[:, 6:], state=h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_full,
                               rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(h2, h_full, rtol=2e-4, atol=2e-4)


def test_bf16_activations_keep_fp32_leaves():
    """bf16 activations over fp32 parameters, as rwkv6-7b and hymba-1.5b
    are served: the projections the reference casts to bf16 are held in
    bf16, and ww1, ww2, w_dt, w_b, w_c (which it reads in fp32) stay fp32,
    as do w0, u and the SSM's a_log, d_skip, dt_bias; the outputs within
    one bf16 step of the reference's on the same bf16 input."""
    wt, wc, ht, hc = _rwkv("bfloat16")
    w, h = _ssm("bfloat16")
    assert ht.wr.dtype == ht.mu.dtype == hc.wk.dtype == torch.bfloat16
    for p in (ht.ww1, ht.ww2, ht.w0, ht.u, h.w_dt, h.w_b, h.w_c, h.a_log,
              h.d_skip, h.dt_bias):
        assert p.dtype == torch.float32
    x = torch.from_numpy(_x((2, 16, 128), 12)).bfloat16()
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    y, new = trec.rwkv_time_mix(ht, x)
    jy, jnew = jrec.rwkv_time_mix({k: jnp.asarray(v) for k, v in wt.items()},
                                  jx)
    assert y.dtype == torch.bfloat16
    _close(y, jy, BF16_TOL)
    _close(new["S"], jnew["S"], BF16_TOL)
    y, _ = trec.rwkv_channel_mix(hc, x, torch.zeros((2, 128),
                                                    dtype=torch.bfloat16))
    jy, _ = jrec.rwkv_channel_mix({k: jnp.asarray(v) for k, v in wc.items()},
                                  jx, jnp.zeros((2, 128), jnp.bfloat16))
    _close(y, jy, BF16_TOL)
    y, hfin = trec.ssm_mix(h, x)
    jy, jh = jrec.ssm_mix({k: jnp.asarray(v) for k, v in w.items()}, jx)
    assert y.dtype == torch.bfloat16 and hfin.dtype == torch.float32
    _close(y, jy, BF16_TOL)
    _close(hfin, jh, TOL)


@pytest.mark.parametrize("init,jinit,mixer", [
    ("init_rwkv_params", "init_rwkv_params", "rwkv6"),
    ("init_rwkv_channel_params", "init_rwkv_channel_params", "rwkv6"),
    ("init_ssm_params", "init_ssm_params", "hymba")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_follow_reference(init, jinit, mixer, dtype):
    """Each leaf's shape and type as the reference creates it for a
    parameter type of ``dtype``; the constant leaves equal the reference's
    and the random ones have its spread."""
    jc, tc = _cfgs(mixer, d_model=256)
    tdt, jdt = _DT[dtype]
    want = getattr(jrec, jinit)(jax.random.key(0), jc, jdt)
    got = getattr(trec, init)(tc, torch.Generator().manual_seed(0), tdt,
                              "cpu")
    assert set(got) == set(want)
    for name, v in want.items():
        assert tuple(got[name].shape) == v.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(v.dtype), name
        g = got[name].float().numpy()
        v = np.asarray(v, np.float32)
        if v.std() == 0 or name == "a_log":
            np.testing.assert_allclose(g, v, rtol=1e-6)
        else:
            assert abs(g.std() / v.std() - 1) < 0.1, name
