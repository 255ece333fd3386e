"""The port's LM stack (``repro_torch.models``, ``repro_torch.configs``)
against the reference's (``repro.models``, ``repro.configs``) at smoke size
on the CPU, where the flash-attention wrapper runs its plain version.

Inputs are made with numpy from a seed and handed to both; the port takes
the reference's own weights through ``convert.params_from_jax``.
Tolerances: fp32 logits and layers 1e-4 (absolute and relative): the two
frameworks take fp32 sums in other orders and their sin, cos and pow may
differ in the last bit; the observed difference of the logits (magnitude
about 4) is below 1e-5. bf16 layers: one bf16 step (rtol 1e-2). Greedy
tokens must be equal, and the test checks that each step's top-two margin
exceeds the logits' tolerance, so equality is what the tolerance implies.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.models.layers import attention as jattn
from repro.models.layers import common as jcommon
from repro_torch.configs import registry as treg
from repro_torch.kernels import _build
from repro_torch.kernels import attention as kattn
from repro_torch.models import convert, lm as tlm
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import common as tcommon

ALL_ARCHS = list(jreg.ARCH_MODULES)
#: the dense attention family
DENSE = ["qwen3-1.7b", "gemma3-4b", "starcoder2-15b", "llama3-405b",
         "musicgen-medium", "qwen2-vl-72b"]
#: the MoE FFN, the recurrent mixers
MOE = ["granite-moe-3b-a800m", "mixtral-8x22b"]
RECURRENT = ["rwkv6-7b", "hymba-1.5b"]
#: ... and the Fourier token mixer: every arch of the registry
SERVED = DENSE + ["fourierpim-lm"] + MOE + RECURRENT
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# Configs and registry, pinned to the reference
# ---------------------------------------------------------------------------

def _pinned(c):
    out = dataclasses.asdict(c)
    out.update(vocab_padded=c.vocab_padded, is_moe=c.is_moe,
               n_global_layers=c.n_global_layers,
               param_count=c.param_count(),
               active_param_count=c.active_param_count(),
               layer_is_global=[c.layer_is_global(i)
                                for i in range(c.num_layers)])
    return out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_pinned_to_reference(arch):
    want, got = jreg.get_config(arch), treg.get_config(arch)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert _pinned(got) == _pinned(want)
    assert _pinned(got.scaled_down()) == _pinned(want.scaled_down())
    for seq in (1, 64, 4096):
        assert tlm.cache_len(got, seq) == jlm.cache_len(want, seq)
        assert tlm._layer_windows(got) == \
            [int(w) for w in jlm._layer_windows(want, seq)]


def test_registry_pinned_to_reference():
    assert treg.ARCH_MODULES == jreg.ARCH_MODULES
    assert treg.ASSIGNED == jreg.ASSIGNED
    assert {k: dataclasses.astuple(v) for k, v in treg.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jreg.SHAPES.items()}
    for arch in ALL_ARCHS:
        for shape in jreg.SHAPES:
            assert treg.cell_supported(treg.get_config(arch),
                                       treg.SHAPES[shape]) == \
                jreg.cell_supported(jreg.get_config(arch), jreg.SHAPES[shape])
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_config("nope")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype)


@pytest.mark.parametrize("tdt,jdt,tol", [
    (torch.float32, jnp.float32, TOL), (torch.bfloat16, jnp.bfloat16,
                                        BF16_TOL)])
def test_rms_norm_and_rope(rng, tdt, jdt, tol):
    x = rng.standard_normal((2, 12, 3, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        tcommon.rms_norm(_t(x, tdt), _t(scale)).float().numpy(),
        np.asarray(jcommon.rms_norm(_j(x, jdt), _j(scale)), np.float32),
        **tol)
    pos = rng.integers(0, 3000, (2, 12)).astype(np.int32)
    np.testing.assert_allclose(
        tcommon.apply_rope(_t(x, tdt), _t(pos, torch.int32),
                           theta=1e6).float().numpy(),
        np.asarray(jcommon.apply_rope(_j(x, jdt), _j(pos, jnp.int32),
                                      theta=1e6), np.float32), **tol)


def test_apply_mrope(rng):
    x = rng.standard_normal((2, 10, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 10, 3)).astype(np.int32)
    sections = (4, 6, 6)
    np.testing.assert_allclose(
        tcommon.apply_mrope(_t(x), _t(pos, torch.int32), sections=sections,
                            theta=1e6).numpy(),
        np.asarray(jcommon.apply_mrope(_j(x), _j(pos, jnp.int32),
                                       sections=sections, theta=1e6)),
        **TOL)
    with pytest.raises(ValueError, match="sum to 16"):
        tcommon.apply_mrope(_t(x), _t(pos, torch.int32), sections=(4, 4, 4))


class _Params(torch.nn.Module):
    """Attribute access over a dict of weights, as the port's layers take
    them."""

    def __init__(self, weights: dict, dtype=torch.float32):
        super().__init__()
        for k, v in weights.items():
            setattr(self, k, torch.nn.Parameter(_t(v, dtype),
                                                requires_grad=False))


@pytest.mark.parametrize("tdt,jdt,tol", [
    (torch.float32, jnp.float32, TOL), (torch.bfloat16, jnp.bfloat16,
                                        BF16_TOL)])
def test_swiglu_mlp(rng, tdt, jdt, tol):
    w = {"w_gate": rng.standard_normal((32, 64)) * 0.2,
         "w_up": rng.standard_normal((32, 64)) * 0.2,
         "w_down": rng.standard_normal((64, 32)) * 0.1}
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    got = tcommon.swiglu_mlp(_Params(w, tdt), _t(x, tdt))
    want = jcommon.swiglu_mlp({k: _j(v) for k, v in w.items()}, _j(x, jdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """(reference config, port config, reference params as numpy)."""
    jc = jreg.get_config(arch).scaled_down()
    params = jlm.init_params(jc, jax.random.key(0))
    return jc, treg.get_config(arch).scaled_down(), \
        jax.tree.map(np.asarray, params)


def _block0_attn(arch):
    jc, tc, tree = _reference(arch)
    w = {k: v[0] for k, v in tree["blocks"]["attn"].items()}
    return jc, tc, w


@pytest.mark.parametrize("arch,window", [("qwen3-1.7b", 1 << 30),
                                         ("gemma3-4b", 24),
                                         ("qwen2-vl-72b", 1 << 30)])
def test_attention_train_matches_reference(rng, arch, window):
    jc, tc, w = _block0_attn(arch)
    B, S = 2, 48
    x = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)
    if tc.mrope_sections is not None:
        pos = rng.integers(0, 100, (B, S, 3)).astype(np.int32)
    else:
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    got = tattn.attention_train(_Params(w), _t(x), tc,
                                positions=_t(pos, torch.int32), window=window)
    want = jattn.attention_train({k: _j(v) for k, v in w.items()}, _j(x), jc,
                                 positions=_j(pos, jnp.int32), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pos,C,window", [(5, 16, 1 << 30), (20, 16, 8),
                                          (31, 32, 64)])
def test_attention_decode_matches_reference(rng, pos, C, window):
    jc, tc, w = _block0_attn("qwen3-1.7b")
    B, KV, hd = 2, tc.num_kv_heads, tc.head_dim
    x = rng.standard_normal((B, 1, tc.d_model)).astype(np.float32)
    ck = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    cv = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    tk, tv = _t(ck), _t(cv)
    got = tattn.attention_decode(_Params(w), _t(x), tc, cache_k=tk,
                                 cache_v=tv, pos=pos, window=window)
    want, wk, wv = jattn.attention_decode(
        {k: _j(v) for k, v in w.items()}, _j(x), jc, cache_k=_j(ck),
        cache_v=_j(cv), pos=jnp.int32(pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the caches are updated in place
    np.testing.assert_allclose(tk.numpy(), np.asarray(wk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(wv), **TOL)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def _port_model(arch, **replace):
    _, tc, tree = _reference(arch)
    tc = dataclasses.replace(tc, **replace)
    return convert.build(tc, convert.params_from_jax(tc, tree), "cpu")


def _no_drops(cfg) -> dict:
    """A MoE config's no-drop capacity factor (E / k), as the reference's
    ``tests/test_arch_smoke.py`` takes for its parity check: the drops
    depend on a group's members, so a prefill and a longer forward differ
    by design otherwise."""
    if not cfg.is_moe:
        return {}
    return {"capacity_factor": cfg.num_experts / cfg.experts_per_token}


def _inputs(cfg, B, S, seed=1):
    """Tokens or embeddings, and M-RoPE positions where the arch takes
    them, as numpy."""
    rng = np.random.default_rng(seed)
    tokens = embeds = positions = None
    if cfg.frontend == "embeddings":
        embeds = (rng.standard_normal((B, S, cfg.d_model)) * 0.02).astype(
            np.float32)
    else:
        tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.mrope_sections is not None:
        positions = np.broadcast_to(
            np.arange(S, dtype=np.int32)[None, :, None], (B, S, 3)).copy()
    return tokens, embeds, positions


def _as(fn, arrs):
    return [None if a is None else fn(a) for a in arrs]


@pytest.mark.parametrize("arch", SERVED)
def test_forward_logits_match_reference(arch):
    """gemma3 runs 96 positions, past its smoke window of 64, so the local
    layers' window masks keys."""
    jc, tc, tree = _reference(arch)
    S = 96 if arch == "gemma3-4b" else 32
    tokens, embeds, positions = _inputs(tc, 2, S)
    want, _, _ = jlm.forward(jc, jax.tree.map(jnp.asarray, tree),
                             *_as(jnp.asarray, [tokens]),
                             positions=_as(jnp.asarray, [positions])[0],
                             embeds=_as(jnp.asarray, [embeds])[0])
    t_tok, t_emb, t_pos = _as(torch.from_numpy, [tokens, embeds, positions])
    got = _port_model(arch)(t_tok, positions=t_pos, embeds=t_emb)
    assert got.shape == (2, S, tc.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_decode_parity(arch):
    """decode_step(token S | prefill(tokens[:S])) == forward(tokens[:S+1])
    in the port alone, as tests/test_arch_smoke.py pins the reference; the
    prefill's last logits (lm_head on the last position only) equal the
    full forward's row S - 1. The MoE archs take the no-drop capacity
    (``_no_drops``); S = 64 is the smoke window, so hymba's ring slots line
    up."""
    _, tc, _ = _reference(arch)
    model = _port_model(arch, **_no_drops(tc))
    B, S = 2, 64
    tokens, embeds, positions = _as(torch.from_numpy,
                                    _inputs(tc, B, S + 1))
    full = model(tokens, positions=positions, embeds=embeds)

    def cut(x, sl):
        return None if x is None else x[:, sl]

    last, state = model.prefill(cut(tokens, slice(0, S)),
                                positions=cut(positions, slice(0, S)),
                                embeds=cut(embeds, slice(0, S)),
                                cache_capacity=S + 1)
    np.testing.assert_allclose(last.numpy(), full[:, S - 1].numpy(),
                               rtol=2e-3, atol=2e-3)
    got, _ = model.decode_step(
        state, None if tokens is None else tokens[:, S], S,
        positions=cut(positions, slice(S, S + 1)),
        embed=cut(embeds, slice(S, S + 1)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), full[:, -1].numpy(), rtol=2e-3,
                               atol=2e-3)


def test_generate_matches_reference_greedy_loop():
    """8 greedy tokens of ``generate`` == the reference's prefill +
    decode_step loop (its serve CLI's loop), with the same weights."""
    jc, tc, tree = _reference("qwen3-1.7b")
    B, S, gen = 2, 16, 8
    tokens, _, _ = _inputs(tc, B, S, seed=3)
    params = jax.tree.map(jnp.asarray, tree)
    logits, state = jlm.prefill(jc, params, jnp.asarray(tokens),
                                cache_capacity=S + gen)
    decode = jax.jit(lambda p, st, tok, pos: jlm.decode_step(
        jc, p, st, tok, pos))
    want, margins = [], []
    for i in range(gen):
        top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[:, -2:]
        margins.append(float((top2[:, 1] - top2[:, 0]).min()))
        tok = jnp.argmax(logits, axis=-1)
        want.append(np.asarray(tok))
        logits, state = decode(params, state, tok, jnp.int32(S + i))
    assert min(margins) > 10 * TOL["atol"]
    _build.reset_launches()
    got = tlm.generate(_port_model("qwen3-1.7b"),
                       torch.from_numpy(tokens).long(), gen)
    assert got.shape == (gen, B)
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    assert _build.LAUNCHES["flash_attention"] == 0   # the CPU runs plain


def test_generate_emits_only_vocabulary_ids():
    """A vocabulary of 500 padded to 512, the padding columns of lm_head
    made to win every argmax: the reference's loop would emit padding ids;
    ``generate`` takes the argmax over the 500 tokens."""
    cfg = dataclasses.replace(treg.get_config("hymba-1.5b").scaled_down(),
                              vocab_size=500)
    assert cfg.vocab_padded == 512
    sd = convert.init_params(cfg, torch.Generator().manual_seed(0))
    sd["lm_head"][:, 500:] = 100.0
    model = convert.build(cfg, sd, "cpu")
    tokens = torch.randint(0, 500, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    logits, _ = model.prefill(tokens)
    assert (logits.argmax(dim=-1) >= 500).all()
    got = tlm.generate(model, tokens, 4)
    assert ((0 <= got) & (got < 500)).all()


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "rwkv6-7b",
                                  "hymba-1.5b"])
def test_generate_new_mixers_match_reference_greedy_loop(arch):
    """8 greedy tokens of ``generate`` for a MoE arch and the recurrent
    archs == the reference's prefill + decode_step loop with the same
    weights, each step's top-two margin above the logits' tolerance.
    granite's prefill routes its 16-token group with drops (capacity factor
    1.25), its decode steps one token at a time, as the reference's do."""
    jc, tc, tree = _reference(arch)
    B, S, gen = 2, 16, 8
    tokens, _, _ = _inputs(tc, B, S, seed=3)
    params = jax.tree.map(jnp.asarray, tree)
    logits, state = jlm.prefill(jc, params, jnp.asarray(tokens),
                                cache_capacity=S + gen)
    decode = jax.jit(lambda p, st, tok, pos: jlm.decode_step(
        jc, p, st, tok, pos))
    want, margins = [], []
    for i in range(gen):
        top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[:, -2:]
        margins.append(float((top2[:, 1] - top2[:, 0]).min()))
        tok = jnp.argmax(logits, axis=-1)
        want.append(np.asarray(tok))
        logits, state = decode(params, state, tok, jnp.int32(S + i))
    assert min(margins) > 10 * TOL["atol"]
    _build.reset_launches()
    got = tlm.generate(_port_model(arch), torch.from_numpy(tokens).long(),
                       gen)
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    assert not any(_build.LAUNCHES.values())        # the CPU runs plain


# ---------------------------------------------------------------------------
# reduce_dtype="bfloat16": the reference rounds the attention output
# projection (attention_train) and the SwiGLU down-projection to bf16 before
# the activations' type; attention_decode does not round. With fp32
# activations the two frameworks' fp32 sums differ in their last bits, so a
# value near a bf16 rounding boundary may land one bf16 step (2^-8
# relative) apart: layers are held at REDUCE_TOL, and each result differs
# from the float32 setting's by more than the fp32 tolerance.
# ---------------------------------------------------------------------------

REDUCE_TOL = dict(rtol=2 ** -7, atol=2 ** -7)


def _differs_from_fp32(got, fp32):
    assert not np.allclose(got, fp32, **TOL)


def test_swiglu_mlp_reduce_bf16_matches_reference(rng):
    w = {"w_gate": rng.standard_normal((32, 64)) * 0.2,
         "w_up": rng.standard_normal((32, 64)) * 0.2,
         "w_down": rng.standard_normal((64, 32)) * 0.1}
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    got = tcommon.swiglu_mlp(_Params(w), _t(x), torch.bfloat16)
    want = jcommon.swiglu_mlp({k: _j(v) for k, v in w.items()}, _j(x),
                              reduce_dtype=jnp.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **REDUCE_TOL)
    # every value is a bf16 value, and not the fp32 setting's
    assert torch.equal(got, got.to(torch.bfloat16).float())
    _differs_from_fp32(got.numpy(), tcommon.swiglu_mlp(_Params(w),
                                                       _t(x)).numpy())


@pytest.mark.parametrize("arch,window", [("qwen3-1.7b", 1 << 30),
                                         ("gemma3-4b", 24)])
def test_attention_train_reduce_bf16_matches_reference(rng, arch, window):
    jc, tc, w = _block0_attn(arch)
    jc = dataclasses.replace(jc, reduce_dtype="bfloat16")
    B, S = 2, 48
    x = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()

    def port(cfg):
        return tattn.attention_train(_Params(w), _t(x), cfg,
                                     positions=_t(pos, torch.int32),
                                     window=window)

    got = port(dataclasses.replace(tc, reduce_dtype="bfloat16"))
    want = jattn.attention_train({k: _j(v) for k, v in w.items()}, _j(x), jc,
                                 positions=_j(pos, jnp.int32), window=window)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **REDUCE_TOL)
    assert torch.equal(got, got.to(torch.bfloat16).float())
    _differs_from_fp32(got.numpy(), port(tc).numpy())


def test_prefill_and_decode_reduce_bf16_match_reference():
    """A small whole model (qwen3-1.7b scaled down, fp32 activations,
    reduce_dtype bf16): the prefill's last logits and one decode step's
    against the reference's prefill and decode_step. A layer output that
    lands one bf16 step apart moves the logits (magnitude about 4): by
    0.0019 at most here (0.0002 for the decode step). REDUCE_LOGITS_TOL
    allows twice that, and the logits of the float32 setting lie outside
    it (0.0097 and 0.0077 from the reference's)."""
    jc, tc, tree = _reference("qwen3-1.7b")
    jc = dataclasses.replace(jc, reduce_dtype="bfloat16")
    B, S = 2, 16
    tokens, _, _ = _inputs(tc, B, S + 1, seed=5)
    params = jax.tree.map(jnp.asarray, tree)
    jlast, jstate = jlm.prefill(jc, params, jnp.asarray(tokens[:, :S]),
                                cache_capacity=S + 1)
    jstep, _ = jlm.decode_step(jc, params, jstate,
                               jnp.asarray(tokens[:, S]), jnp.int32(S))
    got = {}
    for reduce in ("bfloat16", "float32"):
        cfg = dataclasses.replace(tc, reduce_dtype=reduce)
        model = convert.build(cfg, convert.params_from_jax(cfg, tree), "cpu")
        last, state = model.prefill(torch.from_numpy(tokens[:, :S]),
                                    cache_capacity=S + 1)
        step, _ = model.decode_step(state, torch.from_numpy(tokens[:, S]),
                                    S)
        got[reduce] = (last.numpy(), step.numpy())
    for g, w, fp32 in zip(got["bfloat16"], (jlast, jstep), got["float32"]):
        np.testing.assert_allclose(g, np.asarray(w), **REDUCE_LOGITS_TOL)
        assert not np.allclose(fp32, np.asarray(w), **REDUCE_LOGITS_TOL)


REDUCE_LOGITS_TOL = dict(rtol=0, atol=4e-3)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-1.7b", "starcoder2-15b",
                                  "fourierpim-lm"])
def test_params_from_jax_uses_every_leaf(arch):
    _, tc, tree = _reference(arch)
    sd = convert.params_from_jax(tc, tree)
    n_leaves = sum(np.asarray(x).size for x in jax.tree.leaves(tree))
    assert sum(t.numel() for t in sd.values()) == n_leaves
    assert set(sd) == set(convert.expected_shapes(tc))
    mixer, leaf = (("fourier", "gate") if tc.mixer == "fourier"
                   else ("attn", "wq"))
    np.testing.assert_array_equal(
        sd[f"blocks.{tc.num_layers - 1}.{mixer}.{leaf}"].numpy(),
        tree["blocks"][mixer][leaf][-1])
    extra = dict(tree, blocks=dict(tree["blocks"],
                                   extra=tree["blocks"]["ln1"]))
    with pytest.raises(ValueError, match="unused"):
        convert.params_from_jax(tc, extra)
    missing = dict(tree, blocks={k: v for k, v in tree["blocks"].items()
                                 if k != "ln2"})
    with pytest.raises(ValueError, match="missing"):
        convert.params_from_jax(tc, missing)


def test_init_params_follow_reference_distributions():
    _, tc, tree = _reference("qwen3-1.7b")
    sd = convert.init_params(tc, torch.Generator().manual_seed(0))
    want = convert.params_from_jax(tc, tree)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    for name in ("embed", "lm_head", "blocks.0.attn.wq", "blocks.1.attn.wo",
                 "blocks.0.mlp.w_down"):
        assert abs(sd[name].std().item() / want[name].std().item() - 1) \
            < 0.05, name
    for name in ("final_norm", "blocks.0.ln1", "blocks.1.attn.q_norm"):
        assert not sd[name].any()
    # the same generator seed gives the same weights on every call
    again = convert.init_params(tc, torch.Generator().manual_seed(0))
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_fourier_init_params_follow_reference_distributions():
    """fourierpim-lm's leaves: taps N(0, 1) * 0.02, gate N(0, 1) * d^-0.5,
    and no attention weights."""
    _, tc, tree = _reference("fourierpim-lm")
    sd = convert.init_params(tc, torch.Generator().manual_seed(0))
    want = convert.params_from_jax(tc, tree)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert not any(".attn." in k for k in sd)
    for name in ("embed", "lm_head", "blocks.0.fourier.taps",
                 "blocks.1.fourier.gate", "blocks.0.mlp.w_up"):
        assert abs(sd[name].std().item() / want[name].std().item() - 1) \
            < 0.05, name
    assert abs(sd["blocks.0.fourier.taps"].std().item() - 0.02) < 0.002
    assert abs(sd["blocks.0.fourier.gate"].std().item()
               - tc.d_model ** -0.5) < 0.01


def test_fourier_prefill_rejects_unaligned_ring():
    """A prefill longer than the taps fills the ring only when S % K == 0
    (the reference asserts it)."""
    _, tc, _ = _reference("fourierpim-lm")
    model = _port_model("fourierpim-lm")
    K = tc.fourier_taps
    tokens = torch.zeros((1, K + K // 2), dtype=torch.long)
    with pytest.raises(ValueError, match="only when S % C == 0"):
        model.prefill(tokens)
    model.prefill(tokens[:, :K // 2])                 # S < K: padded ring
    model.prefill(torch.zeros((1, 2 * K), dtype=torch.long))


def test_fourier_prefill_and_decode_match_reference():
    """fourierpim-lm's prefill of S == K positions and 20 decode steps fed
    the prompt's continuation, past one wrap of the ring, against the
    reference's prefill and decode_step: every step's logits and the ring
    state at the fp32 tolerance."""
    jc, tc, tree = _reference("fourierpim-lm")
    K, steps = tc.fourier_taps, 20
    tokens, _, _ = _inputs(tc, 2, K + steps, seed=5)
    params = jax.tree.map(jnp.asarray, tree)
    want, jstate = jlm.prefill(jc, params, jnp.asarray(tokens[:, :K]),
                               cache_capacity=K + steps)
    model = _port_model("fourierpim-lm")
    t = torch.from_numpy(tokens).long()
    got, state = model.prefill(t[:, :K], cache_capacity=K + steps)
    assert set(state) == set(jstate) == {"ring"}
    assert state["ring"].shape == (tc.num_layers, 2, K, tc.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i in range(steps):
        pos = K + i
        want, jstate = jlm.decode_step(jc, params, jstate,
                                       jnp.asarray(tokens[:, pos]),
                                       jnp.int32(pos))
        got, state = model.decode_step(state, t[:, pos], pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(state["ring"].numpy(),
                               np.asarray(jstate["ring"]), **TOL)


def test_fourier_bf16_forward_matches_reference():
    """fourierpim-lm in the served type, bf16 activations: the mixer's
    output within one bf16 step (BF16_TOL) of the reference's on the same
    bf16 input, the logits within four bf16 steps, as for qwen3 in
    ``test_bf16_forward_matches_reference``."""
    jc, tc, tree = _reference("fourierpim-lm")
    jc = dataclasses.replace(jc, dtype="bfloat16")
    tc = dataclasses.replace(tc, dtype="bfloat16")
    model = convert.build(tc, convert.params_from_jax(tc, tree), "cpu")
    rng = np.random.default_rng(6)
    h = torch.from_numpy(rng.standard_normal((2, 32, tc.d_model)).astype(
        np.float32)).bfloat16()
    got = tcommon.fourier_mixing(model.blocks[0].fourier, h)
    want = jcommon.fourier_mixing(
        {k: jnp.asarray(v[0]) for k, v in tree["blocks"]["fourier"].items()},
        jnp.asarray(h.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)
    tokens, _, _ = _inputs(tc, 2, 32)
    want, _, _ = jlm.forward(jc, jax.tree.map(jnp.asarray, tree),
                             jnp.asarray(tokens))
    got = model(torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=0.125)


def test_weights_held_in_the_activation_type():
    """The matrices are cast once at load (the reference casts at every
    use, to the same values); norm scales stay in the parameter type."""
    cfg = dataclasses.replace(treg.get_config("qwen3-1.7b").scaled_down(),
                              dtype="bfloat16")
    sd = convert.init_params(cfg, torch.Generator().manual_seed(0))
    model = convert.build(cfg, sd, "cpu")
    assert model.blocks[0].attn.wq.dtype == torch.bfloat16
    assert model.embed.dtype == torch.bfloat16
    assert model.blocks[0].ln1.dtype == torch.float32
    assert model.blocks[0].attn.q_norm.dtype == torch.float32
    assert torch.equal(model.lm_head, sd["lm_head"].to(torch.bfloat16))


def test_bf16_forward_matches_reference():
    """The served type: bf16 activations, fp32 parameters cast to bf16."""
    jc, tc, tree = _reference("qwen3-1.7b")
    jc = dataclasses.replace(jc, dtype="bfloat16")
    tc = dataclasses.replace(tc, dtype="bfloat16")
    tokens, _, _ = _inputs(tc, 2, 32)
    want, _, _ = jlm.forward(jc, jax.tree.map(jnp.asarray, tree),
                             jnp.asarray(tokens))
    got = convert.build(tc, convert.params_from_jax(tc, tree), "cpu")(
        torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    # bf16 logits of magnitude 4 to 8 are spaced 2^-5; a rounding that
    # differs in one of two layers of bf16 activations may move a logit by
    # a step or two (observed 0.055): four steps
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=0.125)


def test_unknown_mixer_raises():
    """Every mixer of the registry is served; another raises, as the
    reference's ``block_forward`` does."""
    cfg = dataclasses.replace(treg.get_config("qwen3-1.7b").scaled_down(),
                              mixer="nope")
    with pytest.raises(ValueError, match="unknown mixer 'nope'"):
        tlm.DecoderLM(cfg, device="meta")
    with pytest.raises(ValueError, match="unknown mixer"):
        convert.init_params(cfg, torch.Generator())
    with pytest.raises(ValueError, match="unknown mixer"):
        convert.params_from_jax(cfg, {})


#: each new family's subtree and one of its leaves
FAMILY_LEAF = {"granite-moe-3b-a800m": ("moe", "router"),
               "mixtral-8x22b": ("moe", "w_down"),
               "rwkv6-7b": ("rwkv_c", "wk"),
               "hymba-1.5b": ("ssm", "a_log")}


@pytest.mark.parametrize("arch", sorted(FAMILY_LEAF))
def test_params_from_jax_new_families(arch):
    """The MoE, RWKV and SSM leaves (and hymba's ln_attn_out, ln_ssm_out)
    are carried over, every one used; a missing leaf of the family or an
    extra one in its subtree raises."""
    _, tc, tree = _reference(arch)
    sd = convert.params_from_jax(tc, tree)
    n_leaves = sum(np.asarray(x).size for x in jax.tree.leaves(tree))
    assert sum(t.numel() for t in sd.values()) == n_leaves
    family, leaf = FAMILY_LEAF[arch]
    np.testing.assert_array_equal(
        sd[f"blocks.{tc.num_layers - 1}.{family}.{leaf}"].numpy(),
        tree["blocks"][family][leaf][-1])
    if arch == "hymba-1.5b":
        assert "blocks.0.ln_ssm_out" in sd and "blocks.0.attn.wq" in sd
    sub = tree["blocks"][family]
    missing = dict(tree, blocks=dict(
        tree["blocks"], **{family: {k: v for k, v in sub.items()
                                    if k != leaf}}))
    with pytest.raises(ValueError, match=rf"missing .*{family}\.{leaf}"):
        convert.params_from_jax(tc, missing)
    extra = dict(tree, blocks=dict(
        tree["blocks"], **{family: dict(sub, spare=sub[leaf])}))
    with pytest.raises(ValueError, match=rf"unused .*{family}\.spare"):
        convert.params_from_jax(tc, extra)


@pytest.mark.parametrize("arch", sorted(FAMILY_LEAF))
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_params_dtypes_and_shapes_match_reference(arch, param_dtype):
    """``convert.init_params`` gives every leaf the type and shape of the
    reference's ``init_params`` (``jax.eval_shape``, no allocation): the
    MoE router and the recurrences' fp32 leaves in fp32 whatever the
    parameter type; and a model holds them in the same types, the matrices
    the reference casts in the activation type."""
    jc = dataclasses.replace(jreg.get_config(arch).scaled_down(),
                             param_dtype=param_dtype)
    tc = dataclasses.replace(treg.get_config(arch).scaled_down(),
                             param_dtype=param_dtype, dtype="bfloat16")
    shapes = jax.eval_shape(lambda k: jlm.init_params(jc, k),
                            jax.random.key(0))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        name = ".".join(p.key for p in path)
        if name.startswith("blocks."):
            for i in range(jc.num_layers):
                want[f"blocks.{i}.{name[7:]}"] = (leaf.shape[1:],
                                                  str(leaf.dtype))
        else:
            want[name] = (leaf.shape, str(leaf.dtype))
    sd = convert.init_params(tc, torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in sd.items()} == want
    model = convert.build(tc, sd, "cpu")
    fp32 = {"moe.router", "rwkv_t.w0", "rwkv_t.u", "ssm.a_log",
            "ssm.d_skip", "ssm.dt_bias"}
    in_param_type = {"rwkv_t.ww1", "rwkv_t.ww2", "ssm.w_dt", "ssm.w_b",
                     "ssm.w_c", "ln1", "ln2", "ln_attn_out", "ln_ssm_out"}
    for name, p in model.blocks[0].named_parameters():
        want_dt = (torch.float32 if name in fp32
                   else tlm.dtype_of(param_dtype) if name in in_param_type
                   else torch.bfloat16)
        assert p.dtype == want_dt, name


def test_recurrent_init_constants():
    """The reference's constant leaves: mu 0.5, w0 -6, u 0.1 N(0, 1) in
    fp32; a_log log(1 .. n) on every row, d_skip 1, dt_bias -4."""
    for arch in ("rwkv6-7b", "hymba-1.5b"):
        tc = treg.get_config(arch).scaled_down()
        sd = convert.init_params(tc, torch.Generator().manual_seed(0))
        if arch == "rwkv6-7b":
            assert (sd["blocks.1.rwkv_t.mu"] == 0.5).all()
            assert (sd["blocks.1.rwkv_c.mu_c"] == 0.5).all()
            assert (sd["blocks.0.rwkv_t.w0"] == -6).all()
            assert abs(sd["blocks.0.rwkv_t.u"].std().item() - 0.1) < 0.02
        else:
            n = tc.ssm_state
            want = torch.log(torch.linspace(1.0, float(n), n))
            assert torch.equal(sd["blocks.0.ssm.a_log"],
                               want.expand(tc.d_model, n))
            assert (sd["blocks.0.ssm.d_skip"] == 1).all()
            assert (sd["blocks.1.ssm.dt_bias"] == -4).all()


# ---------------------------------------------------------------------------
# gemma3-4b's head shape: head_dim 320 (its 2560 / 8), which the card serves
# on the wgmma flash kernel's 48-key instance in bf16
# ---------------------------------------------------------------------------

def _gemma_hd320(dtype: str):
    """gemma3-4b at small width with its head_dim: 6 layers (5 local with
    the smoke window of 64, layer 5 global), 2 heads of 320 over 1 kv
    head; the reference's config and weights, and the port's config."""
    cut = dict(num_layers=6, num_heads=2, num_kv_heads=1, head_dim=320,
               dtype=dtype)
    jc = dataclasses.replace(jreg.get_config("gemma3-4b").scaled_down(),
                             **cut)
    tc = dataclasses.replace(treg.get_config("gemma3-4b").scaled_down(),
                             **cut)
    tree = jax.tree.map(np.asarray, jlm.init_params(jc, jax.random.key(0)))
    return jc, tc, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma_hd320_forward_matches_reference(dtype):
    """Logits of the gemma3-4b-shaped model at S = 96, past the local
    window, with one global layer: fp32 activations (the 3xTF32 kernel's
    plain version: 8-key tiles, s summed over the halves of head_dim) at
    the fp32 tolerance; bf16 (the wgmma kernel's plain version: 48-key
    tiles, p split in two bf16 parts) at four bf16 steps of the logits, as
    for the served type in ``test_bf16_forward_matches_reference``."""
    jc, tc, tree = _gemma_hd320(dtype)
    assert tlm._layer_windows(tc) == [64] * 5 + [tlm.BIG_WINDOW]
    assert kattn.kernel_for(tlm.dtype_of(dtype), 320) == (
        "wgmma" if dtype == "bfloat16" else "tf32")
    tokens, _, _ = _inputs(tc, 2, 96)
    want, _, _ = jlm.forward(jc, jax.tree.map(jnp.asarray, tree),
                             jnp.asarray(tokens))
    _build.reset_launches()
    got = convert.build(tc, convert.params_from_jax(tc, tree), "cpu")(
        torch.from_numpy(tokens))
    assert not any(_build.LAUNCHES.values())      # the CPU runs plain
    assert got.shape == (2, 96, tc.vocab_padded)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=0.125)


def test_gemma_hd320_prefill_decode_matches_reference():
    """bf16 prefill of 96 positions and one decode step of the
    gemma3-4b-shaped model against the reference's prefill and
    decode_step, with the same weights: the last logits within four bf16
    steps."""
    jc, tc, tree = _gemma_hd320("bfloat16")
    B, S = 2, 96
    tokens, _, _ = _inputs(tc, B, S + 1, seed=4)
    params = jax.tree.map(jnp.asarray, tree)
    want_last, jstate = jlm.prefill(jc, params, jnp.asarray(tokens[:, :S]),
                                    cache_capacity=S + 1)
    want_step, _ = jlm.decode_step(jc, params, jstate,
                                   jnp.asarray(tokens[:, S]), jnp.int32(S))
    model = convert.build(tc, convert.params_from_jax(tc, tree), "cpu")
    t = torch.from_numpy(tokens).long()
    last, state = model.prefill(t[:, :S], cache_capacity=S + 1)
    step, _ = model.decode_step(state, t[:, S], S)
    np.testing.assert_allclose(last.float().numpy(),
                               np.asarray(want_last, np.float32), rtol=0,
                               atol=0.125)
    np.testing.assert_allclose(step.numpy(), np.asarray(want_step,
                                                        np.float32),
                               rtol=0, atol=0.125)
