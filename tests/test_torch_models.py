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
from repro_torch.models import convert, lm as tlm
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import common as tcommon

ALL_ARCHS = list(jreg.ARCH_MODULES)
#: the dense attention family this slice serves
DENSE = ["qwen3-1.7b", "gemma3-4b", "starcoder2-15b", "llama3-405b",
         "musicgen-medium", "qwen2-vl-72b"]
UNPORTED = {"granite-moe-3b-a800m": "11b", "mixtral-8x22b": "11b",
            "rwkv6-7b": "11c", "hymba-1.5b": "11d", "fourierpim-lm": "11e"}
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

def _port_model(arch):
    _, tc, tree = _reference(arch)
    return convert.build(tc, convert.params_from_jax(tc, tree), "cpu")


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


@pytest.mark.parametrize("arch", DENSE)
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


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_parity(arch):
    """decode_step(token S | prefill(tokens[:S])) == forward(tokens[:S+1])
    in the port alone, as tests/test_arch_smoke.py pins the reference; the
    prefill's last logits (lm_head on the last position only) equal the
    full forward's row S - 1."""
    _, tc, _ = _reference(arch)
    model = _port_model(arch)
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


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-1.7b", "starcoder2-15b"])
def test_params_from_jax_uses_every_leaf(arch):
    _, tc, tree = _reference(arch)
    sd = convert.params_from_jax(tc, tree)
    n_leaves = sum(np.asarray(x).size for x in jax.tree.leaves(tree))
    assert sum(t.numel() for t in sd.values()) == n_leaves
    assert set(sd) == set(convert.expected_shapes(tc))
    np.testing.assert_array_equal(
        sd[f"blocks.{tc.num_layers - 1}.attn.wq"].numpy(),
        tree["blocks"]["attn"]["wq"][-1])
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


@pytest.mark.parametrize("arch", sorted(UNPORTED))
def test_unported_archs_raise_with_their_roadmap_item(arch):
    cfg = treg.get_config(arch).scaled_down()
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP queue 1, items? .*{UNPORTED[arch]}"):
        tlm.DecoderLM(cfg, device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        convert.init_params(cfg, torch.Generator())
