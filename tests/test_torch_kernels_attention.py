"""The port's flash attention (``repro_torch.kernels.attention``) against the
reference's Pallas kernel (interpret mode, as
``tests/test_kernels_attention.py`` runs it), its naive oracle, and the
model layer's ``blockwise_attention``.

On the CPU the wrappers run their plain versions, which fold the same fp32
online softmax over key blocks as the kernels. Tolerances: fp32 2e-4 (the
reference tests' bound; sums are taken in another order, the observed
difference is below 1e-6); bf16 outputs 1e-2, one bf16 rounding step of an
O(1) value (2^-7), because both sides round the same fp32 result to bf16
and may land on neighbouring values.
"""
import contextlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from repro.kernels import attention as jattn
from repro.models.layers import attention as jlayer
from repro_torch.kernels import _build
from repro_torch.kernels import attention as tattn
from repro_torch.models.layers import attention as tlayer

TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def _qkv(rng, H, S, hd):
    return [rng.standard_normal((H, S, hd)).astype(np.float32)
            for _ in range(3)]


def _torch(arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _jax(arrs, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrs]


@pytest.mark.parametrize("S,bq,bk", [(64, 16, 16), (100, 32, 16),
                                     (128, 128, 64)])
@pytest.mark.parametrize("window", [1 << 30, 24])
def test_flash_plain_matches_pallas_kernel(rng, S, bq, bk, window):
    arrs = _qkv(rng, 3, S, 32)
    got = tattn.flash_attention(*_torch(arrs), window=window, bq=bq, bk=bk)
    want = jattn.flash_attention(*_jax(arrs), window=window, bq=bq, bk=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    oracle = jattn.attention_ref(*_jax(arrs), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)
    np.testing.assert_allclose(
        tattn.attention_ref(*_torch(arrs), window=window).numpy(),
        np.asarray(oracle), **TOL)


def test_flash_plain_bf16(rng):
    arrs = _qkv(rng, 2, 64, 32)
    got = tattn.flash_attention(*_torch(arrs, torch.bfloat16), bq=32, bk=32)
    assert got.dtype == torch.bfloat16
    want = jattn.flash_attention(*_jax(arrs, jnp.bfloat16), bq=32, bk=32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


def test_flash_plain_noncausal(rng):
    arrs = _qkv(rng, 2, 48, 16)
    got = tattn.flash_attention(*_torch(arrs), causal=False, bq=16, bk=16)
    want = jattn.flash_attention(*_jax(arrs), causal=False, bq=16, bk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jattn.attention_ref(*_jax(arrs),
                                                    causal=False)), **TOL)


def test_flash_matches_model_blockwise(rng):
    """The public (H, S, hd) function == the layer's blockwise attention
    with one kv head per head, as the reference test pins them."""
    q, k, v = _torch(_qkv(rng, 4, 64, 16))
    got = tattn.flash_attention(q, k, v, bq=16, bk=16)
    want = tlayer.blockwise_attention(*(x.transpose(0, 1)[None]
                                        for x in (q, k, v)),
                                      window=1 << 30, kv_block=16)
    np.testing.assert_allclose(got.numpy(), want[0].transpose(0, 1).numpy(),
                               **TOL)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       S=st.sampled_from([16, 40, 64]),
       window=st.sampled_from([8, 1 << 30]))
def test_flash_plain_property(seed, S, window):
    arrs = _qkv(np.random.default_rng(seed), 2, S, 16)
    got = tattn.flash_attention(*_torch(arrs), window=window, bq=16, bk=16)
    want = jattn.attention_ref(*_jax(arrs), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=3e-4, atol=3e-4)


def _gqa(rng, B, S, H, KV, hd):
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("H,KV", [(4, 2), (8, 2), (4, 1), (4, 4)])
@pytest.mark.parametrize("window,kv_block", [(1 << 30, 16), (24, 32),
                                             (64, 1024)])
def test_blockwise_gqa_matches_reference_layer(rng, H, KV, window, kv_block):
    arrs = _gqa(rng, 2, 80, H, KV, 32)
    got = tlayer.blockwise_attention(*_torch(arrs), window=window,
                                     kv_block=kv_block)
    want = jlayer.blockwise_attention(*_jax(arrs), window=window,
                                      kv_block=kv_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hd", [32, 128, 320])
def test_blockwise_bf16_prescale_matches_reference_layer(rng, hd):
    """bf16 activations: the layer scales q in bf16 before the fp32 cast, as
    the reference does (at hd = 128 the scale itself rounds to bf16). The
    kernel's other convention, the scale applied to the fp32 scores, misses
    the reference by more than the bf16 tolerance (about 0.1 on these
    inputs), so this tolerance tells the two apart."""
    arrs = _gqa(rng, 1, 64, 4, 2, hd)
    arrs = [a * 3.0 for a in arrs]   # logits of a few units
    got = tlayer.blockwise_attention(*_torch(arrs, torch.bfloat16),
                                     window=1 << 30, kv_block=16)
    want = np.asarray(jlayer.blockwise_attention(
        *_jax(arrs, jnp.bfloat16), window=1 << 30, kv_block=16), np.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)
    q, k, v = _torch(arrs, torch.bfloat16)
    scores_scaled = tattn.attention(q, k, v, window=1 << 30,
                                    scale=hd ** -0.5, kv_block=16)
    assert not np.allclose(scores_scaled.float().numpy(), want, **BF16_TOL)


def test_cpu_path_launches_no_kernel(rng):
    _build.reset_launches()
    q, k, v = _torch(_qkv(rng, 2, 32, 32))
    tattn.flash_attention(q, k, v)
    tattn.attention(q[None], k[None], v[None], window=8, scale=1.0)
    assert _build.LAUNCHES["flash_attention"] == 0


def test_wrappers_raise_on_bad_input(rng):
    q, k, v = _torch(_gqa(rng, 1, 16, 4, 2, 32))
    # the meta device (the dry-run's) runs the plain version's ops: a meta
    # result of q's shape and type, nothing computed
    out = tattn.attention(*(x.to("meta") for x in (q, k, v)), window=4,
                          scale=1.0)
    assert out.device.type == "meta" and out.shape == q.shape \
        and out.dtype == q.dtype
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tattn.attention(q.double(), k.double(), v.double(), window=4,
                        scale=1.0)
    with pytest.raises(ValueError, match=r"with KV \| H"):
        tattn.attention(q, k[:, :, :1].expand(1, 16, 3, 32).contiguous(),
                        v[:, :, :1].expand(1, 16, 3, 32).contiguous(),
                        window=4, scale=1.0)
    with pytest.raises(ValueError, match="window"):
        tattn.attention(q, k, v, window=0, scale=1.0)
    with pytest.raises(ValueError, match=r"takes \(H, S, hd\)"):
        tattn.flash_attention(q, k, v)


@pytest.fixture
def fake_launch(monkeypatch):
    """Record what the card path would pass to the C launcher: the kernel
    cannot run here, the argument marshalling can."""
    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda name, counter, *args: calls.append(args))
    monkeypatch.setattr(tattn.torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    return calls


def test_launcher_arguments_model_layout(fake_launch):
    B, S, H, KV, hd = 2, 40, 8, 2, 128
    q = torch.zeros(B, S, H, hd)
    k = torch.zeros(B, S, KV, hd)
    v = torch.zeros(B, S, KV, hd)
    o = tattn._launch(q, k, v, window=1 << 40, causal=True, scale=1.0)
    assert o.shape == q.shape
    (args,) = fake_launch
    assert args[4:9] == (B, S, H, KV, hd)
    assert args[9:21] == (S * H * hd, H * hd, hd, S * KV * hd, KV * hd, hd,
                          S * KV * hd, KV * hd, hd, S * H * hd, H * hd, hd)
    assert args[21:] == (1 << 30, 1, 1.0, 0)


def test_launcher_arguments_public_layout(fake_launch):
    """(H, S, hd) reaches the kernel as strided (1, S, H, hd) views, with
    no copy of q, k or v."""
    H, S, hd = 3, 20, 64
    q = torch.zeros(H, S, hd, dtype=torch.bfloat16)
    q4 = q.permute(1, 0, 2)[None]
    tattn._launch(q4, q4, q4, window=7, causal=False, scale=hd ** -0.5)
    (args,) = fake_launch
    assert args[0] == q.data_ptr()
    assert args[4:9] == (1, S, H, H, hd)
    assert args[10:12] == (hd, S * hd)
    assert args[21:] == (7, 0, hd ** -0.5, 1)


def test_launcher_rejects_what_the_kernel_does_not_take(fake_launch):
    with pytest.raises(ValueError, match="head_dim 48"):
        tattn._launch(*(torch.zeros(1, 8, 2, 48) for _ in range(3)),
                      window=4, causal=True, scale=1.0)
    x = torch.zeros(1, 8, 64, 2).transpose(2, 3)
    with pytest.raises(ValueError, match="must be contiguous"):
        tattn._launch(x, x, x, window=4, causal=True, scale=1.0)
    x = torch.zeros(1, 8, 2, 65)[..., 1:]
    with pytest.raises(ValueError, match="16 bytes"):
        tattn._launch(x, x, x, window=4, causal=True, scale=1.0)
    assert fake_launch == []


# ---------------------------------------------------------------------------
# The tensor-core kernel's route: bf16 at head_dim 64, 128 and 320
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128, 320])
def test_kernel_for_every_type_and_head_dim(dtype, hd):
    """bf16 at 32, 64, 128 and 320 on the wgmma kernel, fp32 at the same
    head_dims on the 3xTF32 kernel (the CUDA-core kernel serves none);
    each with its key tile."""
    want = "wgmma" if dtype == torch.bfloat16 else "tf32"
    assert tattn.kernel_for(dtype, hd) == want
    keys = {"wgmma": {32: 128, 64: 128, 128: 128, 320: 48},
            "tf32": {32: 64, 64: 64, 128: 32, 320: 8}}[want][hd]
    assert tattn.kernel_keys(dtype, hd) == keys


def test_split_bf16_keeps_16_bits():
    """p_hi + p_lo holds p to 2^-16 relative: each bf16 rounding keeps 8
    significant bits, and p_lo rounds a residual of at most 2^-8 p."""
    rng = np.random.default_rng(5)
    p = np.concatenate([rng.random(200_000), np.exp(-40 * rng.random(1000)),
                        [0.0, 1.0, 0.5]]).astype(np.float32)
    got = tattn.split_bf16(torch.from_numpy(p)).numpy()
    assert np.all(np.abs(p - got) <= 2.0 ** -16 * np.abs(p))
    # a single bf16 pass would not meet the bound
    single = torch.from_numpy(p).to(torch.bfloat16).float().numpy()
    assert not np.all(np.abs(p - single) <= 2.0 ** -16 * np.abs(p))


@pytest.mark.parametrize("hd", [64, 128, 320, 32])
@pytest.mark.parametrize("S,window", [(160, 1 << 30), (96, 24),
                                      (150, 1 << 30), (100, 24)])
def test_wgmma_plain_matches_pallas_kernel(rng, hd, S, window):
    """bf16 at the wgmma kernel's head_dims: the plain version with the
    kernel's key tile (128 keys; 48 at hd 320) and p split in two bf16
    parts against the Pallas kernel in interpret mode and the naive
    oracle; S = 150 and 100 are ragged against both tiles."""
    arrs = _qkv(rng, 2, S, hd)
    got = tattn.flash_attention(*_torch(arrs, torch.bfloat16), window=window)
    assert got.dtype == torch.bfloat16
    want = jattn.flash_attention(*_jax(arrs, jnp.bfloat16), window=window,
                                 bq=32, bk=32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)
    oracle = jattn.attention_ref(*_jax(arrs, jnp.bfloat16), window=window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(oracle, np.float32), **BF16_TOL)


@pytest.mark.parametrize("hd", [64, 128, 320, 32])
@pytest.mark.parametrize("H,KV,window", [(4, 2, 1 << 30), (4, 4, 40),
                                         (6, 2, 1 << 30)])
def test_wgmma_plain_matches_reference_layer(rng, hd, H, KV, window):
    """The GQA layout in bf16: the port's layer (which runs the split plain
    version on the CPU) and the plain version itself against the
    reference's ``blockwise_attention``."""
    arrs = [a * 2.0 for a in _gqa(rng, 2, 150, H, KV, hd)]
    want = np.asarray(jlayer.blockwise_attention(
        *_jax(arrs, jnp.bfloat16), window=window, kv_block=64), np.float32)
    got = tlayer.blockwise_attention(*_torch(arrs, torch.bfloat16),
                                     window=window, kv_block=64)
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)
    q, k, v = _torch(arrs, torch.bfloat16)
    plain = tattn.attention_plain(tlayer._scale_q(q), k, v, window=window,
                                  scale=1.0)
    np.testing.assert_allclose(plain.float().numpy(), want, **BF16_TOL)


@pytest.mark.parametrize("S,window", [(100, 1 << 30), (37, 1 << 30),
                                      (300, 24)])
def test_wgmma_hd32_plain_noncausal_matches_pallas_kernel(rng, S, window):
    """bf16 at head_dim 32 (the reduced configs), non-causal: the plain
    version of the wgmma kernel's dataflow (128-key tiles, p split in two
    bf16 parts) against the Pallas kernel in interpret mode and the naive
    oracle, S ragged against the tile and below 64."""
    arrs = _qkv(rng, 3, S, 32)
    got = tattn.flash_attention(*_torch(arrs, torch.bfloat16), window=window,
                                causal=False)
    assert tattn.kernel_for(torch.bfloat16, 32) == "wgmma"
    want = jattn.flash_attention(*_jax(arrs, jnp.bfloat16), window=window,
                                 causal=False, bq=32, bk=32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)
    oracle = jattn.attention_ref(*_jax(arrs, jnp.bfloat16), window=window,
                                 causal=False)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(oracle, np.float32), **BF16_TOL)


@pytest.mark.parametrize("hd", [64, 320])
def test_wgmma_plain_folds_the_kernels_key_tile(rng, hd):
    """By default the plain version folds the key tile of the kernel that
    ``kernel_for`` picks: for the wgmma kernel 128 keys (48 at hd 320),
    for fp32 the tf32 kernel's (64 keys at hd 64, 8 at hd 320)."""
    q, k, v = _torch(_gqa(rng, 1, 200, 2, 1, hd), torch.bfloat16)
    kw = dict(window=1 << 30, scale=hd ** -0.5)
    got = tattn.attention_plain(q, k, v, **kw)
    assert torch.equal(got, tattn.attention_plain(
        q, k, v, kv_block=tattn.WGMMA_KERNEL_KEYS[hd], **kw))
    q, k, v = (x.float() for x in (q, k, v))
    assert torch.equal(tattn.attention_plain(q, k, v, **kw),
                       tattn.attention_plain(
                           q, k, v, kv_block=tattn.TF32_KERNEL_KEYS[hd],
                           **kw))


def test_plain_follows_the_kernel_it_is_named(rng):
    """``kernel`` picks the dataflow the plain version follows: at bf16 hd
    320, "cuda_core" folds 64-key tiles with p in fp32 (the fp32 inputs'
    CUDA-core plain version, rounded to bf16), "wgmma" is the default;
    for fp32 at hd 320 "tf32" is the default, three TF32 products summed
    over the halves of head_dim on 8-key tiles, not the CUDA-core
    dataflow."""
    q, k, v = _torch(_gqa(rng, 1, 200, 2, 1, 320), torch.bfloat16)
    kw = dict(window=40, scale=320 ** -0.5)
    core = tattn.attention_plain(q, k, v, kernel="cuda_core", **kw)
    q32, k32, v32 = (x.float() for x in (q, k, v))
    core32 = tattn.attention_plain(q32, k32, v32, kernel="cuda_core", **kw)
    assert torch.equal(core, core32.bfloat16())
    tf32 = tattn.attention_plain(q32, k32, v32, **kw)
    assert torch.equal(tf32, tattn.attention_plain(q32, k32, v32,
                                                   kernel="tf32", **kw))
    assert not torch.equal(tf32, core32)
    assert torch.equal(tattn.attention_plain(q, k, v, kernel="wgmma", **kw),
                       tattn.attention_plain(q, k, v, **kw))
    assert tattn.kernel_keys(torch.bfloat16, 320, "cuda_core") == 64


def test_hd320_key_tile_changes_where_the_softmax_rounds(rng):
    """At hd 320 the fold at the kernel's 48-key tile is not the fold at
    128 keys: the tile is part of the plain version's dataflow (both stay
    within one bf16 step of the naive oracle)."""
    arrs = [a * 3.0 for a in _gqa(rng, 1, 200, 2, 1, 320)]
    q, k, v = _torch(arrs, torch.bfloat16)
    kw = dict(window=1 << 30, scale=320 ** -0.5)
    at48 = tattn.attention_plain(q, k, v, **kw)
    at128 = tattn.attention_plain(q, k, v, kv_block=128, **kw)
    assert not torch.equal(at48, at128)
    oracle = tattn.attention_ref(*(x[0].transpose(0, 1) for x in (q, k, v)))
    for got in (at48, at128):
        np.testing.assert_allclose(
            got[0].transpose(0, 1).float().numpy(), oracle.float().numpy(),
            **BF16_TOL)


def test_cpu_path_launches_no_wgmma_kernel(rng):
    _build.reset_launches()
    q, k, v = _torch(_qkv(rng, 2, 32, 64), torch.bfloat16)
    tattn.flash_attention(q, k, v)
    tattn.attention(q[None], k[None], v[None], window=8, scale=1.0)
    assert _build.LAUNCHES["flash_attention_wgmma"] == 0
    assert _build.LAUNCHES["flash_attention"] == 0


@pytest.fixture
def fake_named_launch(monkeypatch):
    """As ``fake_launch``, recording the C launcher and the counter too."""
    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda name, counter, *args:
                        calls.append((name, counter, args)))
    monkeypatch.setattr(tattn.torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    return calls


#: (H, KV, hd) of the served archs' heads: qwen3-1.7b and gemma3-4b
SERVED_HEADS = [(16, 8, 128), (8, 4, 320)]


@pytest.mark.parametrize("H,KV,hd", SERVED_HEADS)
def test_wgmma_launcher_arguments_model_layout(fake_named_launch, H, KV, hd):
    """The model's layout reaches the wgmma launcher with its element
    strides."""
    B, S = 2, 40
    q = torch.zeros(B, S, H, hd, dtype=torch.bfloat16)
    k = torch.zeros(B, S, KV, hd, dtype=torch.bfloat16)
    o = tattn._launch(q, k, k, window=1 << 40, causal=True, scale=1.0)
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    ((name, counter, args),) = fake_named_launch
    assert name == counter == "flash_attention_wgmma"
    assert args[4:9] == (B, S, H, KV, hd)
    assert args[9:21] == (S * H * hd, H * hd, hd, S * KV * hd, KV * hd, hd,
                          S * KV * hd, KV * hd, hd, S * H * hd, H * hd, hd)
    assert args[21:] == (1 << 30, 1, 1.0, 1)


@pytest.mark.parametrize("hd", [64, 320])
def test_wgmma_launcher_arguments_public_layout(fake_named_launch, hd):
    """(H, S, hd) bf16 at head_dim 64 and 320 reaches the wgmma kernel as
    strided (1, S, H, hd) views, with no copy; fp32 at the same shape goes
    to the 3xTF32 kernel."""
    H, S = 3, 20
    q = torch.zeros(H, S, hd, dtype=torch.bfloat16)
    q4 = q.permute(1, 0, 2)[None]
    tattn._launch(q4, q4, q4, window=7, causal=False, scale=hd ** -0.5)
    x = torch.zeros(H, S, hd).permute(1, 0, 2)[None]
    tattn._launch(x, x, x, window=7, causal=False, scale=hd ** -0.5)
    (name, _, args), (name32, _, args32) = fake_named_launch
    assert (name, name32) == ("flash_attention_wgmma",
                              "flash_attention_tf32")
    assert args[0] == q.data_ptr()
    assert args[4:9] == args32[4:9] == (1, S, H, H, hd)
    assert args[10:12] == (hd, S * hd)
    assert args[21:] == (7, 0, hd ** -0.5, 1)
    assert args32[21:] == (7, 0, hd ** -0.5, 0)


@pytest.mark.parametrize("hd", [64, 320])
def test_wgmma_launcher_rejects_what_tma_does_not_take(fake_named_launch,
                                                       hd):
    """TMA takes a base on 16 bytes and strides of 16 bytes: 8 bf16
    elements. A stride of 4 elements, which the CUDA-core kernel takes,
    is refused for bf16 at head_dim 64 and 320."""
    x = torch.zeros(1, 8, 2, hd + 4, dtype=torch.bfloat16)[..., :hd]
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        tattn._launch(x, x, x, window=4, causal=True, scale=1.0)
    x = torch.zeros(1, 8, 2, 2 * hd + 8, dtype=torch.bfloat16)[..., 4:hd + 4]
    with pytest.raises(ValueError, match="16 bytes"):
        tattn._launch(x, x, x, window=4, causal=True, scale=1.0)
    assert fake_named_launch == []
    # fp32: 4 elements are 16 bytes (the tf32 kernel's TMA)
    x = torch.zeros(1, 8, 2, hd + 4)[..., :hd]
    tattn._launch(x, x, x, window=4, causal=True, scale=1.0)
    x = torch.zeros(1, 8, 2, hd + 8, dtype=torch.bfloat16)[..., :hd]
    tattn._launch(x, x, x, window=4, causal=True, scale=1.0)
    assert [c[0] for c in fake_named_launch] == [
        "flash_attention_tf32", "flash_attention_wgmma"]


def test_wgmma_hd32_launcher_arguments(fake_named_launch):
    """bf16 at head_dim 32 reaches the wgmma launcher in the model's layout
    and, as strided (1, S, H, hd) views, in the public one, with no copy;
    TMA's 16-byte strides refuse a row of hd + 4 elements before any
    launch; fp32 at head_dim 32 goes to the 3xTF32 kernel."""
    B, S, H, KV, hd = 2, 40, 4, 2, 32
    q = torch.zeros(B, S, H, hd, dtype=torch.bfloat16)
    k = torch.zeros(B, S, KV, hd, dtype=torch.bfloat16)
    o = tattn._launch(q, k, k, window=1 << 40, causal=True, scale=1.0)
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    x = torch.zeros(3, 20, hd, dtype=torch.bfloat16)
    x4 = x.permute(1, 0, 2)[None]
    tattn._launch(x4, x4, x4, window=7, causal=False, scale=hd ** -0.5)
    (name, counter, args), (name_pub, _, args_pub) = fake_named_launch
    assert name == counter == name_pub == "flash_attention_wgmma"
    assert args[4:9] == (B, S, H, KV, hd)
    assert args[9:21] == (S * H * hd, H * hd, hd, S * KV * hd, KV * hd, hd,
                          S * KV * hd, KV * hd, hd, S * H * hd, H * hd, hd)
    assert args[21:] == (1 << 30, 1, 1.0, 1)
    assert args_pub[0] == x.data_ptr()
    assert args_pub[4:9] == (1, 20, 3, 3, hd)
    assert args_pub[10:12] == (hd, 20 * hd)
    assert args_pub[21:] == (7, 0, hd ** -0.5, 1)
    fake_named_launch.clear()
    y = torch.zeros(1, 8, 2, hd + 4, dtype=torch.bfloat16)[..., :hd]
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        tattn._launch(y, y, y, window=4, causal=True, scale=1.0)
    assert fake_named_launch == []
    y = torch.zeros(1, 8, 2, hd + 4)[..., :hd]
    tattn._launch(y, y, y, window=4, causal=True, scale=1.0)
    assert [c[0] for c in fake_named_launch] == ["flash_attention_tf32"]


# ---------------------------------------------------------------------------
# The 3xTF32 kernel's route: fp32 at head_dim 32, 64, 128 and 320
# ---------------------------------------------------------------------------

def _tf32_reference(x: np.ndarray) -> np.ndarray:
    """fp32 x rounded to 10 fraction bits, to nearest with ties away from
    zero, in float64 arithmetic (finite, normal x)."""
    x64 = x.astype(np.float64)
    ulp = np.exp2(np.floor(np.log2(np.abs(x64))) - 10)
    return (np.sign(x64) * np.floor(np.abs(x64) / ulp + 0.5) * ulp
            ).astype(np.float32)


def _low_bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32) & 0x1FFF


def test_split_tf32_rounds_as_cvt_rna():
    """hi = tf32(x) and lo = tf32(x - hi) keep the low 13 bits zero; x - hi
    is exact in fp32; hi + lo holds x to 2^-22 relative (lo rounds a
    residual of up to 12 significant bits to TF32's 11, so it is not exact
    in general); the rounding is to nearest, ties away from zero, as
    cvt.rna.tf32.f32 rounds; sign, zero and inf pass through hi."""
    rng = np.random.default_rng(6)
    x = np.concatenate([rng.standard_normal(200_000) * 10.0 ** rng.integers(
        -30, 30, 200_000), rng.random(1000)]).astype(np.float32)
    hi, lo = tattn.split_tf32(torch.from_numpy(x))
    assert not _low_bits(hi).any() and not _low_bits(lo).any()
    np.testing.assert_array_equal(hi.numpy(), _tf32_reference(x))
    resid = x.astype(np.float64) - hi.numpy().astype(np.float64)
    np.testing.assert_array_equal(resid.astype(np.float32).astype(np.float64),
                                  resid)
    total = hi.double().numpy() + lo.double().numpy()
    assert np.all(np.abs(x - total) <= 2.0 ** -22 * np.abs(x))
    # one TF32 part alone misses that bound
    assert not np.all(np.abs(x - hi.double().numpy())
                      <= 2.0 ** -22 * np.abs(x))
    # ties go away from zero: 1 + 2^-11 and 1 + 3 * 2^-11 sit half way
    ties = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                         -(1 + 3 * 2 ** -11)], dtype=torch.float32)
    got, _ = tattn.split_tf32(ties)
    assert got.tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9,
                            -(1 + 2 ** -9)]
    special = torch.tensor([0.0, -0.0, float("inf"), float("-inf")])
    got, low = tattn.split_tf32(special)
    assert got.tolist() == special.tolist()
    assert torch.equal(torch.signbit(got), torch.signbit(special))
    assert low[:2].tolist() == [0.0, 0.0]


@pytest.mark.parametrize("hd", [32, 64, 128, 320])
@pytest.mark.parametrize("S,window,causal", [(160, 1 << 30, True),
                                             (96, 24, True),
                                             (150, 1 << 30, True),
                                             (100, 1 << 30, False)])
def test_tf32_plain_matches_pallas_kernel(rng, hd, S, window, causal):
    """fp32 at the tf32 kernel's head_dims: the plain version (both
    products as three TF32 products, the kernel's key tile: 64 keys at hd
    32 and 64, 32 at 128) against the Pallas kernel in interpret mode and the
    naive oracle within the reference tests' 2e-4; causal, window 24,
    non-causal, and S = 150 ragged against both tiles."""
    arrs = _qkv(rng, 2, S, hd)
    got = tattn.flash_attention(*_torch(arrs), window=window, causal=causal)
    assert got.dtype == torch.float32
    want = jattn.flash_attention(*_jax(arrs), window=window, causal=causal,
                                 bq=32, bk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    oracle = jattn.attention_ref(*_jax(arrs), window=window, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("hd", [32, 64, 128, 320])
@pytest.mark.parametrize("H,KV,window", [(4, 2, 1 << 30), (4, 4, 24),
                                         (6, 2, 1 << 30)])
def test_tf32_plain_matches_reference_layer(rng, hd, H, KV, window):
    """The GQA layout in fp32 at S = 150 (ragged): the port's layer (which
    runs the 3xTF32 plain version on the CPU) and the plain version itself
    against the reference's ``blockwise_attention``."""
    arrs = [a * 2.0 for a in _gqa(rng, 2, 150, H, KV, hd)]
    want = np.asarray(jlayer.blockwise_attention(
        *_jax(arrs), window=window, kv_block=64))
    got = tlayer.blockwise_attention(*_torch(arrs), window=window,
                                     kv_block=64)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    q, k, v = _torch(arrs)
    plain = tattn.attention_plain(tlayer._scale_q(q), k, v, window=window,
                                  scale=1.0)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_tf32_plain_folds_the_kernels_key_tile(rng, hd):
    """By default the fp32 plain version folds the tf32 kernel's key tile
    (64 keys at hd 32 and 64, 32 at 128) with both products as three TF32
    products: that is not the CUDA-core kernel's dataflow (fp32 products,
    64-key tiles), though both stay within 2e-4 of each other."""
    q, k, v = _torch(_gqa(rng, 1, 200, 4, 2, hd))
    kw = dict(window=1 << 30, scale=hd ** -0.5)
    got = tattn.attention_plain(q, k, v, **kw)
    assert torch.equal(got, tattn.attention_plain(
        q, k, v, kv_block=tattn.TF32_KERNEL_KEYS[hd], kernel="tf32", **kw))
    core = tattn.attention_plain(q, k, v, kernel="cuda_core", **kw)
    assert not torch.equal(got, core)
    np.testing.assert_allclose(got.numpy(), core.numpy(), **TOL)


def test_tf32_products_hold_fp32_where_one_tf32_pass_does_not(rng):
    """Three TF32 products of fp32 operands keep the fp32 product to about
    2^-21, where one TF32 pass (10 fraction bits) misses the reference's
    2e-4 on logits of a few units."""
    a = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((128, 64)).astype(np.float32))
    exact = a.double() @ b.double()
    three = tattn._product_3xtf32("ij,jk->ik", a, b).double()
    one = (tattn._tf32(a) @ tattn._tf32(b)).double()
    scale = exact.abs().max()
    assert float((three - exact).abs().max() / scale) < 2 ** -19
    assert float((one - exact).abs().max() / scale) > 2e-4


def test_cpu_path_launches_no_tf32_kernel(rng):
    _build.reset_launches()
    q, k, v = _torch(_qkv(rng, 2, 40, 128))
    tattn.flash_attention(q, k, v)
    tattn.attention(q[None], k[None], v[None], window=8, scale=1.0)
    assert not any(_build.LAUNCHES.values())


@pytest.mark.parametrize("H,KV,hd", [(16, 8, 128), (24, 8, 64), (8, 4, 320),
                                     (4, 4, 32)])
def test_tf32_launcher_arguments_model_layout(fake_named_launch, H, KV, hd):
    """fp32 in the model's layout reaches the tf32 launcher, counted under
    its own counter, with its element strides and bf16 = 0."""
    B, S = 2, 40
    q = torch.zeros(B, S, H, hd)
    k = torch.zeros(B, S, KV, hd)
    o = tattn._launch(q, k, k, window=1 << 40, causal=True, scale=0.5)
    assert o.shape == q.shape and o.dtype == torch.float32
    ((name, counter, args),) = fake_named_launch
    assert name == counter == "flash_attention_tf32"
    assert args[:4] == (q.data_ptr(), k.data_ptr(), k.data_ptr(),
                        o.data_ptr())
    assert args[4:9] == (B, S, H, KV, hd)
    assert args[9:21] == (S * H * hd, H * hd, hd, S * KV * hd, KV * hd, hd,
                          S * KV * hd, KV * hd, hd, S * H * hd, H * hd, hd)
    assert args[21:] == (1 << 30, 1, 0.5, 0)


@pytest.mark.parametrize("hd", [32, 64, 128, 320])
def test_tf32_launcher_arguments_public_layout(fake_named_launch, hd):
    """(H, S, hd) fp32 reaches the tf32 kernel as strided (1, S, H, hd)
    views of the same storage, with no copy."""
    H, S = 3, 20
    q = torch.zeros(H, S, hd)
    k = torch.zeros(H, S, hd)
    tattn._launch(*(x.permute(1, 0, 2)[None] for x in (q, k, k)), window=7,
                  causal=False, scale=hd ** -0.5)
    ((name, _, args),) = fake_named_launch
    assert name == "flash_attention_tf32"
    assert args[:3] == (q.data_ptr(), k.data_ptr(), k.data_ptr())
    assert args[4:9] == (1, S, H, H, hd)
    assert args[10:12] == (hd, S * hd)  # seq and head strides
    assert args[21:] == (7, 0, hd ** -0.5, 0)


@pytest.mark.parametrize("hd", [32, 64, 128, 320])
def test_tf32_launcher_rejects_what_tma_does_not_take(fake_named_launch, hd):
    """TMA takes a base on 16 bytes and strides of 16 bytes, 4 fp32
    elements: a row stride of hd + 2 or a base 8 bytes off is refused
    before any launch; hd + 4 is taken."""
    x = torch.zeros(1, 8, 2, hd + 2)[..., :hd]
    with pytest.raises(ValueError, match="multiples of 4 elements"):
        tattn._launch(x, x, x, window=4, causal=True, scale=1.0)
    x = torch.zeros(1, 8, 2, hd + 4)[..., 2:hd + 2]
    with pytest.raises(ValueError, match="16 bytes"):
        tattn._launch(x, x, x, window=4, causal=True, scale=1.0)
    assert fake_named_launch == []
    x = torch.zeros(1, 8, 2, hd + 4)[..., :hd]
    tattn._launch(x, x, x, window=4, causal=True, scale=1.0)
    assert [c[0] for c in fake_named_launch] == ["flash_attention_tf32"]


def test_tf32_hd320_sums_s_over_head_dim_halves(rng, monkeypatch):
    """At fp32 hd 320 the plain version forms s as the kernel's two
    warpgroups do: three TF32 products over head_dim 0..159, plus the same
    over 160..319 (``TF32_SPLIT_HEAD_DIMS``), on 8-key tiles. It equals
    that sum written out, differs from one 3xTF32 product over all of
    head_dim in its last bits, and both stay within 2e-4 of the naive
    oracle."""
    assert tattn.TF32_SPLIT_HEAD_DIMS == (320,)
    assert tattn.TF32_KERNEL_KEYS[320] == 8
    q, k, v = _torch(_gqa(rng, 1, 40, 2, 1, 320))
    kw = dict(window=1 << 30, scale=320 ** -0.5)
    got = tattn.attention_plain(q, k, v, **kw)
    # the same fold written out: one 8-key block after another
    qh = q.reshape(1, 40, 1, 2, 320)
    m = torch.full((1, 1, 2, 40), tattn.NEG)
    l = torch.zeros((1, 1, 2, 40))
    acc = torch.zeros((1, 1, 2, 40, 320))
    pos = torch.arange(40)
    for j0 in range(0, 40, 8):
        kj, vj = k[:, j0:j0 + 8], v[:, j0:j0 + 8]
        s = (tattn._product_3xtf32("bqkgh,bnkh->bkgqn", qh[..., :160],
                                   kj[..., :160])
             + tattn._product_3xtf32("bqkgh,bnkh->bkgqn", qh[..., 160:],
                                     kj[..., 160:])) * kw["scale"]
        valid = (j0 + torch.arange(8))[None, :] <= pos[:, None]
        s = torch.where(valid, s, tattn.NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + tattn._product_3xtf32(
            "bkgqn,bnkh->bkgqh", p, vj)
        m = m_new
    want = (acc / l[..., None]).permute(0, 3, 1, 2, 4).reshape(1, 40, 2, 320)
    assert torch.equal(got, want)
    monkeypatch.setattr(tattn, "TF32_SPLIT_HEAD_DIMS", ())
    whole = tattn.attention_plain(q, k, v, **kw)
    assert not torch.equal(got, whole)
    oracle = tattn.attention_ref(*(x[0].transpose(0, 1) for x in (q, k, v)))
    for out in (got, whole):
        np.testing.assert_allclose(out[0].transpose(0, 1).numpy(),
                                   oracle.numpy(), **TOL)
