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


@pytest.mark.parametrize("hd", [32, 128])
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
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tattn.attention(*(x.to("meta") for x in (q, k, v)), window=4,
                        scale=1.0)
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
