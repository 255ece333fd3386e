"""The port's CUDA kernels on the card (skipped on hosts without one).

This file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same card
tensors, and the wrapper must count exactly one launch; the LM's greedy
tokens on the card must equal those on the CPU. Tolerances: fft,
rfft and irfft rtol 1e-4, atol 1e-4 * sqrt(n); the products rtol 1e-3,
atol 1e-4 * n (the reference tests' bounds). The kernels are built with
-fmad=false and perform the plain versions' fp32 operations in the same
order, so on the card they agree far inside these bounds. The NTT kernels
are exact: they equal their plain versions and the numpy reference bit
for bit (``==``).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import ntt as tntt
from repro_torch.kernels import _build
from repro_torch.kernels import attention as tattn
from repro_torch.kernels import fft as tfft
from repro_torch.kernels import ntt as tknt
from repro_torch.kernels import polymul as tpoly
from repro_torch.launch import engine, serve
from repro_torch.models import convert, lm

pytestmark = pytest.mark.cuda

NS = [2, 8, 4096, 8192, 65536]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _planes(rng, batch, n, k, device):
    return [torch.from_numpy(rng.standard_normal((batch, n)).astype(
        np.float32)).to(device) for _ in range(k)]


def _close(got, want, rtol, atol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=rtol, atol=atol)


def _launched(name, fn):
    before = _build.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    return out


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_kernel_matches_plain(cuda, rng, n, radix, inverse):
    xr, xi = _planes(rng, 5, n, 2, cuda)
    got = _launched("fft_planes", lambda: tfft.fft_planes(
        xr, xi, inverse=inverse, radix=radix))
    scale = n if inverse else 1
    _close([g * scale for g in got],
           [w * scale for w in tfft.fft_planes_plain(xr, xi, inverse=inverse,
                                                     radix=radix)],
           1e-4, 1e-4 * np.sqrt(n))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("radix", [2, 4])
def test_rfft_kernel_matches_plain(cuda, rng, n, radix):
    (x,) = _planes(rng, 5, n, 1, cuda)
    got = _launched("rfft_planes", lambda: tfft.rfft_planes(x, radix=radix))
    _close(got, tfft.rfft_planes_plain(x, radix=radix), 1e-4,
           1e-4 * np.sqrt(n))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("batch", [1, 4, 5])
def test_irfft_kernel_matches_plain(cuda, rng, n, radix, batch):
    """Odd batches pair their last spectrum with a zero spectrum."""
    (x,) = _planes(rng, batch, n, 1, cuda)
    yr, yi = tfft.rfft_planes(x, radix=radix)
    got = _launched("irfft_planes",
                    lambda: tfft.irfft_planes(yr, yi, radix=radix))
    _close([got], [tfft.irfft_planes_plain(yr, yi, radix=radix)], 1e-4,
           1e-4 * np.sqrt(n))
    _close([got], [x], 1e-4, 1e-4 * n)


NTT_NS = [2, 8, 4096, 16384, 32768, 65536]


def _residues(rng, shape, q, device):
    return torch.from_numpy(rng.integers(0, q, shape).astype(
        np.uint32)).to(device)


@pytest.mark.parametrize("n", NTT_NS)
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_kernel_matches_plain_and_reference(cuda, rng, n, inverse):
    p = tntt.NTTParams.make(n)
    x = _residues(rng, (5, n), p.q, cuda)
    got = _launched("ntt_batched",
                    lambda: tknt.ntt_batched(x, p, inverse=inverse))
    assert got.dtype == torch.int32
    assert torch.equal(got, tknt.ntt_batched_plain(x, p, inverse=inverse))
    want = (tntt.intt if inverse else tntt.ntt)(x.cpu().numpy(), p)
    assert (tknt.residues_to_numpy(got) == want).all()


@pytest.mark.parametrize("n", NTT_NS)
@pytest.mark.parametrize("negacyclic", [True, False])
@pytest.mark.parametrize("batch,block", [(1, None), (5, None), (5, 2)])
def test_ntt_polymul_kernel_matches_plain_and_reference(
        cuda, rng, n, negacyclic, batch, block):
    p = tntt.NTTParams.make(n)
    a, b = (_residues(rng, (batch, n), p.q, cuda) for _ in range(2))
    got = _launched("ntt_polymul", lambda: tknt.ntt_polymul(
        a, b, p, negacyclic=negacyclic, block_b=block))
    assert torch.equal(got, tknt.ntt_polymul_plain(a, b, p,
                                                   negacyclic=negacyclic))
    fn = tntt.negacyclic_polymul if negacyclic else tntt.cyclic_polymul
    assert (tknt.residues_to_numpy(got)
            == fn(a.cpu().numpy(), b.cpu().numpy(), p)).all()


@pytest.mark.parametrize("n,kw", [(64, {"modulus": 17}),
                                  (4096, {"modulus_bits": 109}),
                                  (65536, {"modulus_bits": 60})])
@pytest.mark.parametrize("negacyclic", [True, False])
def test_rns_kernel_matches_plain_and_reference(cuda, rng, n, kw,
                                                negacyclic):
    r = tntt.RNSParams.make(n, **kw)
    a, b = (np.stack([tntt.random_poly(rng, n, r.modulus)
                      for _ in range(3)]) for _ in range(2))
    ar, br = (torch.from_numpy(tntt.to_rns(x, r).astype(np.uint32)).to(cuda)
              for x in (a, b))
    got = _launched("rns_ntt_polymul", lambda: tknt.rns_ntt_polymul(
        ar, br, r, negacyclic=negacyclic))
    assert torch.equal(got, tknt.rns_ntt_polymul_plain(
        ar, br, r, negacyclic=negacyclic))
    want = tntt.rns_polymul_reference(a, b, r, negacyclic=negacyclic)
    assert (tntt.crt_to_modulus(tknt.residues_to_numpy(got), r)
            == want).all()


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("radix", [2, 4])
def test_polymul_kernels_match_plain(cuda, rng, n, radix):
    ar, ai, br, bi = _planes(rng, 5, n, 4, cuda)
    got = _launched("polymul_complex_planes",
                    lambda: tpoly.polymul_complex_planes(ar, ai, br, bi,
                                                         radix=radix))
    _close(got, tpoly.polymul_complex_planes_plain(ar, ai, br, bi,
                                                   radix=radix),
           1e-3, 1e-4 * n)
    got = _launched("polymul_real_planes",
                    lambda: tpoly.polymul_real_planes(ar, br, radix=radix))
    _close([got], [tpoly.polymul_real_planes_plain(ar, br, radix=radix)],
           1e-3, 1e-4 * n)


@pytest.mark.parametrize("op,bits", [
    ("fft", None), ("rfft", None), ("polymul", None),
    ("polymul-real", None), ("polymul-mod", None), ("polymul-mod", 109)])
def test_service_on_card_matches_cpu(cuda, rng, op, bits):
    """The same payloads served on the card and on the CPU: each result
    within the op's tolerance of the other, and the card's kernels ran."""
    n, cap, total = 4096, 4, 6
    on_card = serve.FFTService(n, cap, op, modulus_bits=bits, device="cuda")
    on_cpu = serve.FFTService(n, cap, op, modulus_bits=bits, device="cpu")
    payloads = [on_card.bound.random_payload(rng) for _ in range(total)]
    _build.reset_launches()
    for svc in (on_card, on_cpu):
        for rid, p in enumerate(payloads):
            svc.submit(rid, p)
        assert svc.run(total)["served"] == total
    assert sum(_build.LAUNCHES.values()) == 2      # batches [4, 2]
    tol = (dict(rtol=1e-3, atol=1e-4 * n) if op.startswith("polymul")
           else dict(rtol=1e-4, atol=1e-4 * np.sqrt(n)))
    for rid, p in enumerate(payloads):
        if op == "polymul-mod":      # exact: bit for bit
            assert (on_card.results[rid] == on_cpu.results[rid]).all()
        else:
            np.testing.assert_allclose(on_card.results[rid],
                                       on_cpu.results[rid], **tol)
        on_card.bound.verify(p, on_card.results[rid])


def test_engine_copies_results_back_without_blocking(cuda, rng):
    """A dispatched batch's results go to pinned host memory, and the event
    the engine waits on comes after that copy: once it has passed, the
    buffer holds exactly what a direct, synchronous dispatch returns."""
    svc = serve.FFTService(4096, 4, "polymul-real", device="cuda")
    payloads = [svc.bound.random_payload(rng) for _ in range(3)]
    flight = svc.engine._dispatch(
        svc.bound.key, [engine._Request(i, p, 0.0)
                        for i, p in enumerate(payloads)])
    assert flight.host.is_pinned() and flight.done is not None
    flight.done.synchronize()
    np.testing.assert_array_equal(
        flight.host.numpy(), svc.bound.to_numpy(svc.bound.execute(payloads)))


@pytest.mark.parametrize("name,block", [
    ("fft_planes", 1), ("rfft_planes", 2), ("polymul_complex_planes", 1),
    ("polymul_real_planes", 2), ("irfft_planes", 2)])
@pytest.mark.parametrize("staged", [False, True])
def test_occupancy_matches_launch_configuration(cuda, name, block, staged):
    """The occupancy query reports the launchers' own configuration at
    n = 4096: one thread per radix-4 butterfly of the CTA's rows (at most
    1024), 16 bytes of shared memory per point of each complex row it
    holds (none when staged), and at least one CTA per SM."""
    slots = {"fft_planes": block, "rfft_planes": block // 2,
             "polymul_complex_planes": 2 * block,
             "polymul_real_planes": block, "irfft_planes": block // 2}[name]
    occ = _build.occupancy(name, 12, block, staged)
    assert occ["threads"] == min(1024, slots * 4096 // 4)
    assert occ["smem_bytes"] == (0 if staged else 16 * 4096 * slots)
    assert occ["regs"] > 0 and occ["ctas_per_sm"] >= 1


@pytest.mark.parametrize("name,slots", [
    ("ntt_batched", 1), ("ntt_polymul", 2), ("rns_ntt_polymul", 2)])
@pytest.mark.parametrize("staged", [False, True])
def test_ntt_occupancy_matches_launch_configuration(cuda, name, slots,
                                                    staged):
    """At n = 4096 and one row per CTA: one thread per butterfly (at most
    1024), 8 bytes of shared memory per residue of each row the CTA holds
    (none when staged), and at least one CTA per SM."""
    occ = _build.occupancy(name, 12, 1, staged)
    assert occ["threads"] == min(1024, slots * 4096 // 2)
    assert occ["smem_bytes"] == (0 if staged else 8 * 4096 * slots)
    assert occ["regs"] > 0 and occ["ctas_per_sm"] >= 1


# ---------------------------------------------------------------------------
# Flash attention and the LM on the card
# ---------------------------------------------------------------------------

#: bf16: kernel and plain version round the same fp32 result once; a
#: difference of fp32 sums may move it to the neighbouring bf16 value, a
#: step of at most 2^-8 relative. fp32: the reference tests' 2e-4.
ATTN_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
            torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


@pytest.mark.parametrize("hd", [32, 64, 128, 320])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,KV,window,causal", [
    (200, 4, 2, 1 << 30, True), (130, 2, 1, 24, True),
    (100, 2, 2, 1 << 30, False), (64, 4, 4, 1, True)])
def test_flash_kernel_matches_plain(cuda, hd, dtype, S, H, KV, window,
                                    causal):
    g = torch.Generator(device=cuda).manual_seed(hd + S)
    q = torch.randn(2, S, H, hd, device=cuda, generator=g).to(dtype)
    k, v = (torch.randn(2, S, KV, hd, device=cuda, generator=g).to(dtype)
            for _ in range(2))
    kw = dict(window=window, causal=causal, scale=hd ** -0.5)
    got = _launched("flash_attention", lambda: tattn.attention(q, k, v,
                                                               **kw))
    want = tattn.attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **ATTN_TOL[dtype])


def test_flash_public_layout_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(6, 96, 64, device=cuda, generator=g)
               for _ in range(3))
    got = _launched("flash_attention",
                    lambda: tattn.flash_attention(q, k, v, window=40))
    np.testing.assert_allclose(
        got.cpu().numpy(),
        tattn.flash_attention_plain(q, k, v, window=40, bk=64).cpu().numpy(),
        **ATTN_TOL[torch.float32])
    np.testing.assert_allclose(
        got.cpu().numpy(),
        tattn.attention_ref(q, k, v, window=40).cpu().numpy(),
        **ATTN_TOL[torch.float32])


def test_flash_kernel_raises_on_unsupported_head_dim(cuda):
    x = torch.zeros(1, 8, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim 48"):
        tattn.attention(x, x, x, window=4, scale=1.0)


@pytest.mark.parametrize("hd,bf16,ctas", [(128, 1, 2), (320, 0, 1)])
def test_attention_occupancy(cuda, hd, bf16, ctas):
    occ = _build.occupancy("flash_attention", hd, bf16, 0)
    assert occ["threads"] == 256
    assert occ["smem_bytes"] == 4 * (64 * (hd + 4) * 2 + 64 * 68)
    assert occ["ctas_per_sm"] == ctas


def test_generate_on_card_matches_cpu(cuda):
    """The smoke qwen3 in fp32 with the same weights on the card and on the
    CPU: the same greedy tokens, one flash-attention launch per layer per
    prefill."""
    cfg = get_config("qwen3-1.7b").scaled_down()
    sd = convert.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 48),
                           generator=torch.Generator().manual_seed(1))
    want = lm.generate(convert.build(cfg, sd, "cpu"), tokens, 6)
    _build.reset_launches()
    got = lm.generate(convert.build(cfg, sd, cuda), tokens.to(cuda), 6)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == cfg.num_layers
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
