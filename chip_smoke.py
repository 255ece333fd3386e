#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. Build: compile ``kernels/csrc/stockham.cu``, ``kernels/csrc/ntt.cu``
     and ``kernels/csrc/attention.cu`` with nvcc into ``build/``, one nvcc
     per source, all started together, and print the build time, the
     card's name and its power limit.
  2. Kernels vs plain: each of the five float kernels against its plain
     PyTorch version on the card and against float64 numpy.fft, radix 2 and
     4, n = 2 .. 2^18 (shared-memory resident and staged rows), odd and even
     batches including 1, and the serve batch with the planner's block at
     the serve lengths, with the reference tests' tolerances; the rfft ->
     irfft round trip too. Then the three NTT kernels against their plain
     versions and the ported numpy reference, bit for bit (``==``): forward
     and inverse NTT, cyclic and negacyclic products, n = 2 .. 2^19
     (resident and staged), batches 1, 2, 5 and a capped block, and the
     serve batch with the planner's block; the RNS kernel at k = 9
     (109-bit Q) and at k = 1. Then the flash-attention kernel against its
     plain version (``ATTN_CASES``): the served prefill shape, windows 1024
     and 24, non-causal, ragged S = 1000, G = 1, head_dims 64 and 320, and
     fp32 inputs, bf16 within one bf16 step and fp32 within 2e-4; and the
     public (H, S, hd) layout against the naive oracle.
  3. Serve: ``FFTService`` per op at n = 4096 and 65536 (batch 64, 256
     requests each), ``polymul-mod`` single-limb at both lengths and RNS at
     n = 4096 with a 109-bit modulus, then one mixed ``ServeEngine`` over
     all five ops and both lengths. Every served result is checked against
     the registry's numpy oracle (bit for bit for ``polymul-mod``), and the
     launch counters, zeroed just before this phase, must show one kernel
     launch per dispatched batch of the kernel's route besides the warmups'
     launches. Then the library path, counters zeroed again: the rfft ->
     irfft round trip through ``core.fft`` and the NTT -> inverse NTT round
     trip through ``kernels.ntt.ntt_batched`` at the serve shapes.
     A separate traced run per serve cell then gives the card's idle share
     during serving, and the kernels and copies each served batch puts on
     the card besides its own kernel. Then the LM, counters zeroed just
     before: the serve CLI's ``--service lm`` for qwen3-1.7b at full width
     (bf16, random weights from a seeded generator), batch 8, prompt 2048,
     gen 32, which must launch the flash kernel 28 times (one prefill, one
     launch per layer) and nothing else; prefill/decode parity at full
     width in fp32 (B = 2, S = 512) within the reference's 2e-3; and the
     same 2-layer full-width weights on the card and on the CPU (plain
     versions) within 2e-3.
  4. Timings at the serve shapes: kernel, plain version and, where one
     exists, the PyTorch library call on the same inputs -- device time per
     call from torch.profiler, for a kernel the mean over the launches
     the trace holds (the trace drops some; one without device time is
     taken again, and the run fails if five in a row hold none), with
     the CUDA-event wall time per call beside it -- held against the least
     time the card could take: bytes over 3.35 TB/s, or operations over
     67 TFLOP/s fp32 (the H100 SXM data sheet) for the float kernels, over
     the card's 32-bit integer rate (``INT32_OPS_PER_S``) for the NTT
     kernels, and over 989 TFLOP/s bf16 for flash attention, whose
     yardstick is ``scaled_dot_product_attention`` (causal, GQA; it and
     the plain version timed by CUDA events, as their traces drop
     events); each
     kernel must agree with its plain version within phase 2's tolerance
     (exactly, for the NTT kernels). Each kernel's launch configuration and
     the CTAs an SM holds come from the CUDA occupancy API. Then the LM
     cell: prefill ms, decode ms per token and tok/s, and a traced run for
     the card's idle share and the flash kernel's share of the prefill.

The line before the last is the card's name and power limit; the line
before that a JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1
and prints no result.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, fp32 without tensor cores
#: 32-bit integer operations per second. The data sheet's 67 TFLOP/s fp32 is
#: 132 SMs x 128 fp32 lanes x 2 (fused multiply-add) x 1.98 GHz; a Hopper SM
#: retires 64 32-bit integer adds, compares or multiplies per clock (the
#: CUDA programming guide's throughput table for compute capability 9.0),
#: so 132 x 64 x 1.98e9.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: 32-bit integer operations of the NTT arithmetic (csrc/ntt.cu): a
#: Montgomery multiply is two multiplies for the 64-bit product, one for m,
#: one high-half multiply, two adds and a compare for the carry, a compare
#: and a subtract; a radix-2 butterfly is one of those plus a modular add
#: and subtract (3 each); the reduction of an input word on load counts 1.
MONT_OPS = 9
BUTTERFLY_OPS = MONT_OPS + 6
SERVE_NS = (4096, 65536)
SERVE_BATCH = 64
SERVE_REQUESTS = 256
ENGINE_REQUESTS = 512
#: the RNS cell: the largest log Q the HomomorphicEncryption.org standard
#: allows at n = 4096 for 128-bit security; 9 limbs of 30 bits cover it
RNS_N, RNS_BITS = 4096, 109
OPS = ("fft", "rfft", "polymul", "polymul-real")
#: serve cells: (op, n, modulus_bits)
SERVE_CELLS = ([(op, n, None) for op in OPS + ("polymul-mod",)
                for n in SERVE_NS] + [("polymul-mod", RNS_N, RNS_BITS)])
STOCKHAM = "src/repro_torch/kernels/csrc/stockham.cu"
NTT = "src/repro_torch/kernels/csrc/ntt.cu"
ATTENTION = "src/repro_torch/kernels/csrc/attention.cu"
#: transform-service wrapper -> (serve route that launches it, or None for
#: the library path; source; TPU kernel it replaces)
TRANSFORM_KERNELS = {
    "fft_planes": ("fft", STOCKHAM, "src/repro/kernels/fft.py:146"),
    "rfft_planes": ("rfft-real", STOCKHAM, "src/repro/kernels/fft.py:260"),
    "polymul_complex_planes": ("polymul", STOCKHAM,
                               "src/repro/kernels/polymul.py:33"),
    "polymul_real_planes": ("polymul-real-packed", STOCKHAM,
                            "src/repro/kernels/polymul.py:52"),
    "irfft_planes": (None, STOCKHAM, "src/repro/kernels/fft.py:275"),
    "ntt_polymul": ("polymul-mod-single", NTT,
                    "src/repro/kernels/ntt.py:179"),
    "rns_ntt_polymul": ("polymul-mod-rns", NTT,
                        "src/repro/kernels/ntt.py:142"),
    "ntt_batched": (None, NTT, "src/repro/kernels/ntt.py:134"),
}
#: the LM's kernel: (source, TPU kernel it replaces)
FLASH = ("flash_attention", ATTENTION, "src/repro/kernels/attention.py:30")
BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet, dense bf16 tensor cores
#: the served LM cell: qwen3-1.7b at full width, bf16 activations
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "qwen3-1.7b", 8, 2048, 32
#: flash kernel vs plain: fp32 at the reference tests' 2e-4; bf16 at one
#: bf16 step (kernel and plain version round the same fp32 value once, and
#: a difference of fp32 sums may move it to the neighbouring bf16 value,
#: 2^-8 relative)
ATTN_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
            "bfloat16": dict(rtol=1e-2, atol=1e-2)}
#: LM parity (prefill/decode, card/CPU): the reference's own
#: prefill/decode parity bound (tests/test_arch_smoke.py)
LM_TOL = dict(rtol=2e-3, atol=2e-3)
FLOAT_KERNELS = ("fft_planes", "rfft_planes", "polymul_complex_planes",
                 "polymul_real_planes", "irfft_planes")
NTT_KERNELS = ("ntt_polymul", "rns_ntt_polymul", "ntt_batched")


def tolerance(name: str, n: int) -> dict[str, float]:
    """The reference tests' bounds: fft rtol 1e-4, atol 1e-4 sqrt(n);
    the products rtol 1e-3, atol 1e-4 n."""
    if name.startswith("polymul"):
        return dict(rtol=1e-3, atol=1e-4 * n)
    return dict(rtol=1e-4, atol=1e-4 * math.sqrt(n))


def blocks(core_fft, n: int, b: int, cap) -> dict[str, int | None]:
    """Rows per CTA to pass each wrapper: None for its default, "plan" for
    the planner's block at batch b (what the serve path passes), or a cap
    (doubled for the two-for-one kernels, which take rows in pairs)."""
    if cap == "plan":
        real = core_fft.plan(n, b, real=True).block_b
        return {"fft_planes": core_fft.plan(n, b).block_b,
                "rfft_planes": real, "irfft_planes": real,
                "polymul_complex_planes":
                    core_fft.plan(n, b, product=True).block_b,
                "polymul_real_planes":
                    core_fft.plan(n, b, real=True, product=True).block_b}
    paired = ("rfft_planes", "irfft_planes", "polymul_real_planes")
    return {name: cap and (2 * cap if name in paired else cap)
            for name in FLOAT_KERNELS}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 2: kernels vs plain versions vs float64 numpy
# ---------------------------------------------------------------------------

def check_kernels(torch, kfft, kpoly, core_fft) -> dict[str, float]:
    """Sweep every float kernel; returns the worst |kernel - plain| per
    kernel."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    worst = dict.fromkeys(FLOAT_KERNELS, 0.0)

    def close(name, got, plain, want, rtol, atol):
        got = np.asarray(got)
        np.testing.assert_allclose(got, plain, rtol=rtol, atol=atol,
                                   err_msg=f"{name} vs plain")
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=f"{name} vs numpy")
        worst[name] = max(worst[name], float(np.max(np.abs(got - plain))))

    def cplx(r, i):
        return r.cpu().numpy().astype(np.float64) + 1j * i.cpu().numpy()

    for log2n in range(1, 19):
        n = 1 << log2n
        # (batch, block cap), see blocks(). The capped odd batch leaves a
        # partly filled last CTA; at the serve lengths the serve batch runs
        # with the planner's block, as the serve path launches it.
        cases = [(1, None), (2, None), (5, None), (5, 2)]
        if n > 4096:
            cases = [(1, None), (3, None)]
        if n in SERVE_NS:
            cases.append((SERVE_BATCH, "plan"))
        for radix in (2, 4):
            for b, cap in cases:
                blk = blocks(core_fft, n, b, cap)
                xr = rng.standard_normal((b, n)).astype(np.float32)
                xi = rng.standard_normal((b, n)).astype(np.float32)
                tr, ti = (torch.from_numpy(v).to(dev) for v in (xr, xi))
                x64 = xr.astype(np.float64) + 1j * xi
                tol = tolerance("fft_planes", n)
                ptol = tolerance("polymul_real_planes", n)
                # fft forward; the inverse is held as n * ifft (the same
                # transform with conjugate twiddles) at the fft tolerance
                got = cplx(*kfft.fft_planes(tr, ti, radix=radix,
                                            block_b=blk["fft_planes"]))
                plain = cplx(*kfft.fft_planes_plain(tr, ti, radix=radix))
                close("fft_planes", got, plain, np.fft.fft(x64), **tol)
                got = cplx(*kfft.fft_planes(tr, ti, inverse=True, radix=radix,
                                            block_b=blk["fft_planes"])) * n
                plain = cplx(*kfft.fft_planes_plain(tr, ti, inverse=True,
                                                    radix=radix)) * n
                close("fft_planes", got, plain, np.fft.ifft(x64) * n, **tol)
                # rfft: packed planes against numpy's half spectrum
                half = np.fft.rfft(xr.astype(np.float64))
                want = np.concatenate([half[:, :n // 2].real,
                                       half[:, :n // 2].imag], axis=1)
                want[:, n // 2] = half[:, n // 2].real
                yr, yi = kfft.rfft_planes(tr, radix=radix,
                                          block_b=blk["rfft_planes"])
                pr, pi = kfft.rfft_planes_plain(tr, radix=radix)
                close("rfft_planes", torch.cat([yr, yi], 1).cpu(),
                      torch.cat([pr, pi], 1).cpu().numpy(), want, **tol)
                # irfft of the kernel's packed planes, against its plain
                # version and numpy.fft.irfft of the same half spectrum,
                # and the round trip at the reference's bound
                got = kfft.irfft_planes(yr, yi, radix=radix,
                                        block_b=blk["irfft_planes"])
                half = np.zeros((b, n // 2 + 1), np.complex128)
                half[:, :n // 2] = cplx(yr, yi)
                half[:, 0] = yr[:, 0].cpu().numpy()
                half[:, n // 2] = yi[:, 0].cpu().numpy()
                close("irfft_planes", got.cpu(),
                      kfft.irfft_planes_plain(yr, yi, radix=radix).cpu()
                      .numpy(), np.fft.irfft(half, n=n), **tol)
                np.testing.assert_allclose(got.cpu().numpy(), xr, rtol=1e-4,
                                           atol=1e-4 * n,
                                           err_msg="rfft -> irfft")
                # complex product, operands (x, conj-swapped x)
                got = cplx(*kpoly.polymul_complex_planes(
                    tr, ti, ti, tr, radix=radix,
                    block_b=blk["polymul_complex_planes"]))
                plain = cplx(*kpoly.polymul_complex_planes_plain(
                    tr, ti, ti, tr, radix=radix))
                y64 = xi.astype(np.float64) + 1j * xr
                want = np.fft.ifft(np.fft.fft(x64) * np.fft.fft(y64))
                close("polymul_complex_planes", got, plain, want, **ptol)
                # real product
                got = kpoly.polymul_real_planes(
                    tr, ti, radix=radix, block_b=blk["polymul_real_planes"])
                plain = kpoly.polymul_real_planes_plain(tr, ti, radix=radix)
                want = np.fft.ifft(np.fft.fft(xr.astype(np.float64))
                                   * np.fft.fft(xi.astype(np.float64))).real
                close("polymul_real_planes", got.cpu(), plain.cpu().numpy(),
                      want, **ptol)
        print(f"[kernels] n=2^{log2n:<2d} radix 2,4 batches "
              f"{sorted({c[0] for c in cases})} resident="
              f"{kfft.resident(n)}/{kfft.resident(n, product=True)} ok",
              flush=True)
    torch.cuda.synchronize()
    return worst


def check_ntt_kernels(torch, kntt, ntt_core, core_fft) -> dict[str, int]:
    """Sweep the three NTT kernels: each result must equal its plain
    version and the numpy reference bit for bit. Returns the worst
    |kernel - plain| per kernel (0 when exact)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    worst = dict.fromkeys(NTT_KERNELS, 0)

    def exact(name, got, plain, want):
        diff = int((got.to(torch.int64) - plain.to(torch.int64)).abs().max())
        worst[name] = max(worst[name], diff)
        if diff or not (kntt.residues_to_numpy(got) == want).all():
            raise SystemExit(f"{name}: kernel, plain version and numpy "
                             f"reference differ (max |kernel - plain| "
                             f"{diff}, shape {tuple(got.shape)})")

    def words(shape, q):
        host = rng.integers(0, q, shape).astype(np.uint32)
        return host, torch.from_numpy(host).to(dev)

    for log2n in range(1, 20):
        n = 1 << log2n
        p = ntt_core.NTTParams.make(n)
        # (batch, block cap): None is the wrapper's default, "plan" the
        # planner's block at the serve batch; the capped odd batch leaves
        # a partly filled last CTA. The longest rows run at batch 1.
        cases = [(1, None), (2, None), (5, None), (5, 2)]
        if n > 4096:
            cases = [(1, None), (3, None)] if n < 1 << 19 else [(1, None)]
        if n in SERVE_NS:
            cases.append((SERVE_BATCH, "plan"))
        for b, cap in cases:
            block = core_fft.plan(n, b, exact=True).block_b \
                if cap == "plan" else cap
            xa, ta = words((b, n), p.q)
            xb, tb = words((b, n), p.q)
            for inverse in (False, True):
                got = kntt.ntt_batched(ta, p, inverse=inverse, block_b=block)
                exact("ntt_batched", got,
                      kntt.ntt_batched_plain(ta, p, inverse=inverse),
                      (ntt_core.intt if inverse else ntt_core.ntt)(xa, p))
            for neg in (True, False):
                got = kntt.ntt_polymul(ta, tb, p, negacyclic=neg,
                                       block_b=block)
                fn = (ntt_core.negacyclic_polymul if neg
                      else ntt_core.cyclic_polymul)
                exact("ntt_polymul", got,
                      kntt.ntt_polymul_plain(ta, tb, p, negacyclic=neg),
                      fn(xa, xb, p))
        print(f"[ntt] n=2^{log2n:<2d} batches {sorted({c[0] for c in cases})}"
              f" resident={kntt.ntt_resident(n, product=False)}/"
              f"{kntt.ntt_resident(n)} forward, inverse, cyclic and "
              f"negacyclic == plain == numpy reference", flush=True)
    # RNS: k = 9 limbs (the serve cell, resident), one limb, and a staged
    # multi-limb case
    for n, kw, cases in ((RNS_N, {"modulus_bits": RNS_BITS},
                          [(1, None), (5, 2), (SERVE_BATCH, "plan")]),
                         (256, {"modulus": 17}, [(3, None)]),
                         (65536, {"modulus_bits": 40}, [(2, None)])):
        r = ntt_core.RNSParams.make(n, **kw)
        for b, cap in cases:
            block = core_fft.plan(n, b, exact=True).block_b \
                if cap == "plan" else cap
            a = np.stack([ntt_core.random_poly(rng, n, r.modulus)
                          for _ in range(b)])
            bb = np.stack([ntt_core.random_poly(rng, n, r.modulus)
                           for _ in range(b)])
            ta, tb = (torch.from_numpy(ntt_core.to_rns(v, r).astype(
                np.uint32)).to(dev) for v in (a, bb))
            for neg in (True, False):
                got = kntt.rns_ntt_polymul(ta, tb, r, negacyclic=neg,
                                           block_b=block)
                plain = kntt.rns_ntt_polymul_plain(ta, tb, r, negacyclic=neg)
                fn = (ntt_core.negacyclic_polymul if neg
                      else ntt_core.cyclic_polymul)
                limbs = np.stack([fn(ta[i].cpu().numpy(), tb[i].cpu().numpy(),
                                     lp) for i, lp in enumerate(r.limbs)])
                exact("rns_ntt_polymul", got, plain, limbs)
                if (ntt_core.crt_to_modulus(kntt.residues_to_numpy(got), r)
                        != ntt_core.rns_polymul_reference(
                            a, bb, r, negacyclic=neg)).any():
                    raise SystemExit(f"rns_ntt_polymul n={n} {kw}: CRT of "
                                     f"the kernel's limbs is not the "
                                     f"reference product mod Q")
        print(f"[ntt] rns n={n} k={r.k} ({kw}) batches "
              f"{[c[0] for c in cases]} resident={kntt.ntt_resident(n)} "
              f"== plain == numpy reference, CRT == reference mod Q",
              flush=True)
    torch.cuda.synchronize()
    return worst


# ---------------------------------------------------------------------------
# Phase 3: the serve path
# ---------------------------------------------------------------------------

def serve_phase(serve, engine_mod, build) -> tuple[dict, dict]:
    """Drive FFTService per serve cell, then one mixed engine; verify every
    result. Returns the batches each route dispatched while serving, and
    the launches each kernel made in the warmups, for the launch-counter
    check."""
    expected: dict[str, int] = {}
    warm = dict.fromkeys(TRANSFORM_KERNELS, 0)

    def warmup(eng):
        before = dict(build.LAUNCHES)
        eng.warmup()
        for name in warm:
            warm[name] += build.LAUNCHES[name] - before[name]

    def drain(eng, combos, n_requests, seed):
        kept, stats = serve.produce(eng, combos, n_requests,
                                    np.random.default_rng(seed))
        for rid, (op, n, payload) in kept.items():
            eng.bound(op, n).verify(payload, eng.results[rid])
        for b in stats["buckets"].values():
            expected[b["route"]] = expected.get(b["route"], 0) + b["batches"]
        return stats

    for op, n, bits in SERVE_CELLS:
        svc = serve.FFTService(n, SERVE_BATCH, op, modulus_bits=bits,
                               device="cuda")
        warmup(svc.engine)
        stats = drain(svc.engine, [(op, n)], SERVE_REQUESTS, n)
        lat = stats["latency_ms"]
        print(f"[serve] op={op} n={n} modulus_bits={bits} route={svc.route} "
              f"batch={SERVE_BATCH} requests={stats['served']} verified=all "
              f"{stats['throughput_per_s']:.1f} req/s "
              f"p50={lat['p50']:.3f}ms p99={lat['p99']:.3f}ms "
              f"[{svc.plan.describe()}]", flush=True)
    eng = engine_mod.ServeEngine(max_batch=SERVE_BATCH, device="cuda")
    ops = OPS + ("polymul-mod",)
    combos = [(op, n) for op in ops for n in SERVE_NS]
    for op, n in combos:
        eng.register(op, n)
    warmup(eng)
    stats = drain(eng, combos, ENGINE_REQUESTS, 1)
    lat = stats["latency_ms"]
    print(f"[serve] engine ops={','.join(ops)} ns={SERVE_NS} "
          f"requests={stats['served']} verified=all "
          f"{stats['throughput_per_s']:.1f} req/s p50={lat['p50']:.3f}ms "
          f"p99={lat['p99']:.3f}ms buckets={len(stats['buckets'])}",
          flush=True)
    return expected, warm


def library_phase(torch, core_fft, kntt, ntt_core) -> None:
    """The library path at the serve shapes: the rfft -> irfft round trip
    through ``core.fft`` (the reference tests' round-trip bound) and the
    NTT -> inverse NTT round trip through ``ntt_batched`` (exact)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    for n in SERVE_NS:
        x = torch.from_numpy(rng.standard_normal((SERVE_BATCH, n)).astype(
            np.float32)).to(dev)
        back = core_fft.irfft(core_fft.rfft(x, packed=True), packed=True)
        np.testing.assert_allclose(back.cpu().numpy(), x.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4 * n,
                                   err_msg=f"rfft -> irfft n={n}")
        p = ntt_core.NTTParams.make(n)
        r = torch.from_numpy(rng.integers(0, p.q, (SERVE_BATCH, n)).astype(
            np.uint32)).to(dev)
        back = kntt.ntt_batched(kntt.ntt_batched(r, p), p, inverse=True)
        if not torch.equal(back, r.view(torch.int32)):
            raise SystemExit(f"ntt_batched round trip n={n} is not exact")
        print(f"[library] n={n} batch={SERVE_BATCH}: core.fft rfft -> irfft "
              f"within rtol 1e-4, atol 1e-4 n; ntt_batched forward -> "
              f"inverse exact", flush=True)
    torch.cuda.synchronize()


#: Device-side names of the serve routes' own kernels in a profiler trace.
ROUTE_KERNEL = re.compile(
    r"(^|::)(fft|rfft|polymul_complex|polymul_real|ntt_polymul|"
    r"rns_ntt_polymul)_kernel\b")


def idle_shares(torch, serve, card: str) -> dict:
    """A separate traced run per serve cell (profiler on, so its req/s is
    not the measured one): the share of the serve loop's wall time during
    which no kernel or copy ran on the card, and what each served batch put
    on the card: the route's own kernel, the other kernels (splitting
    complex batches into planes, joining and repacking the results) and
    copies, with their device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    traced = {}
    for op, n, bits in SERVE_CELLS:
        svc = serve.FFTService(n, SERVE_BATCH, op, modulus_bits=bits,
                               device="cuda")
        svc.warmup()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, stats = serve.produce(svc.engine, [(op, n)], SERVE_REQUESTS,
                                     np.random.default_rng(n))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        per = {k: [0, 0.0] for k in ("kernel", "other", "copies")}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            kind = ("kernel" if ROUTE_KERNEL.search(e.key) else
                    "copies" if e.key.startswith(("Memcpy", "Memset"))
                    else "other")
            per[kind][0] += e.count
            per[kind][1] += e.self_device_time_total / 1e3
        busy_ms = sum(ms for _, ms in per.values())
        batches = stats["batches"]
        traced[svc.route, n] = {
            "idle_share": 1 - busy_ms / wall_ms,
            **{f"{k}_per_batch": c / batches for k, (c, _) in per.items()},
            **{f"{k}_ms_per_batch": ms / batches
               for k, (_, ms) in per.items()}}
        print(f"[trace] op={op} n={n} route={svc.route} batch={SERVE_BATCH} "
              f"requests={SERVE_REQUESTS}: device busy "
              f"{busy_ms:.3f}ms of {wall_ms:.3f}ms wall -> idle share "
              f"{1 - busy_ms / wall_ms:.4f} (traced run); per batch "
              f"({batches} batches): " + ", ".join(
                  f"{k} {c / batches:.2f} ({ms / batches:.4f}ms)"
                  for k, (c, ms) in per.items())
              + f"; on {card}", flush=True)
    return traced


# ---------------------------------------------------------------------------
# Phase 4: timings and bounds
# ---------------------------------------------------------------------------

def transform_flops(n: int, radix: int) -> float:
    """Flops of one n-point transform in the sweeps the kernels run: a
    radix-2 sweep does n/2 butterflies of 10 flops, a radix-4 sweep n/4 of
    34 (three complex products and eight complex additions)."""
    lg, flops = n.bit_length() - 1, 0.0
    if radix == 4 and lg % 2:
        flops, lg = 5.0 * n, lg - 1
    while lg > 0:
        if radix == 4 and lg >= 2:
            flops, lg = flops + 8.5 * n, lg - 2
        else:
            flops, lg = flops + 5.0 * n, lg - 1
    return flops


def work(name: str, n: int, b: int, radix: int) -> tuple[float, float]:
    """(bytes, flops) one call must move and do: each input read once, each
    output written once, the twiddle tables read once."""
    t = transform_flops(n, radix)
    pairs = (b + 1) // 2
    if name == "fft_planes":
        return 4 * (4 * b * n + 2 * n), b * (t + 2 * n)
    if name == "rfft_planes":
        return 4 * (2 * b * n + 2 * n), pairs * (t + 8 * (n // 2))
    if name == "irfft_planes":       # unpack: ar - bi, ai + br; 1/n scale
        return 4 * (2 * b * n + 2 * n), pairs * (t + 4 * n)
    if name == "polymul_complex_planes":
        return 4 * (6 * b * n + 2 * n), b * (3 * t + 8 * n)
    return (4 * (3 * b * n + 4 * n),
            2 * pairs * (t + 14 * n) + pairs * (t + 4 * n))


def ntt_work(name: str, n: int, b: int, k: int = 1) -> tuple[float, float]:
    """(bytes, 32-bit integer operations) one call must move and do: each
    input word read once, each output written once, the tables read once;
    n/2 butterflies per sweep and log2 n sweeps per transform."""
    transform = (n // 2) * (n.bit_length() - 1) * BUTTERFLY_OPS
    if name == "ntt_batched":         # forward: load reduction, sweeps
        return 4 * (2 * b * n + n), b * (n + transform)
    # per row: two loads, the twist of both operands, two NTTs, the r2 hop
    # and the pointwise product, the inverse NTT and the untwist
    per_row = 2 * n + 5 * n * MONT_OPS + 3 * transform
    return 4 * k * (3 * b * n + 4 * n + 4), k * b * per_row


def time_ms(torch, fn, arg_sets, reps: int) -> float:
    """Mean ms of one call, by CUDA events around ``reps`` calls that cycle
    through ``arg_sets`` (together larger than the 50 MB L2, so each call
    finds its inputs in device memory, as a freshly copied batch may)."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, arg_sets, reps: int, *,
              launches_per_call: int | None = None,
              tries: int = 5) -> tuple[float, int]:
    """Mean device time of one call in ms, and the device events traced:
    the summed duration of the kernels the calls ran, traced by
    torch.profiler (CUPTI), without the host's launch gaps. The trace
    drops some device events (traces of 20 launches of one kernel on an
    H100 held 9 to 20 of them), so where the caller knows the kernels a
    call launches (``launches_per_call``) the mean is taken over the
    launches the trace holds; otherwise over the calls made, which a
    dropped event lowers. A
    trace without device time is reported and taken again, up to
    ``tries`` times in all; if none holds any, the run fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(*arg_sets[i % len(arg_sets)])
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in events)
        seen = sum(e.count for e in events)
        if us > 0:
            calls = reps if launches_per_call is None \
                else seen / launches_per_call
            return us / 1e3 / calls, seen
        print(f"[time] trace {attempt + 1} of {tries} held no device time; "
              f"tracing again", flush=True)
        time.sleep(1.0)
    raise SystemExit(f"torch.profiler traced no device time in {tries} "
                     f"tries")


def occupancy(build, kfft, name: str, n: int, b: int, plan) -> dict:
    """Launch configuration and CTAs per SM of kernel ``name`` as its
    wrapper launches it for a batch of b rows under ``plan``."""
    real = name in ("rfft_planes", "irfft_planes", "polymul_real_planes")
    product = name.startswith("polymul")
    rows, staged = kfft.cta_rows(n, b, plan.block_b, real=real,
                                 product=product)
    return {"rows_per_cta": rows, "staged": staged,
            **build.occupancy(name, n.bit_length() - 1, rows, staged)}


def measure(torch, name: str, n: int, kern, plain, sets, lib, lib_sets,
            *, exact: bool, bound: tuple[float, float, str]) -> dict:
    """Hold the kernel against its plain version on ``sets[0]`` (exactly,
    or within phase 2's tolerance), then time kernel, plain version and
    library call (None: no PyTorch call computes the function). ``bound``
    is (ms for the bytes, ms for the operations, what the operations are)."""
    reps = max(len(sets), 20)
    got, want = (torch.cat([t.flatten() for t in _as_tuple(f(*sets[0]))])
                 for f in (kern, plain))
    if exact:
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        ok = err == 0
    else:
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, **tolerance(name, n))
    if not ok:
        raise SystemExit(f"{name} n={n}: kernel and plain version differ "
                         f"(max abs difference {err})")
    # wall time per call (CUDA events, host launch gaps included): plain,
    # kernel, kernel, plain within this call; best of two
    plain_ev = time_ms(torch, plain, sets, reps)
    kern_ev = min(time_ms(torch, kern, sets, reps),
                  time_ms(torch, kern, sets, reps))
    plain_ev = min(plain_ev, time_ms(torch, plain, sets, reps))
    t_bytes, t_ops, ops_kind = bound
    ms, traced = device_ms(torch, kern, sets, reps, launches_per_call=1)
    return {"ms": ms, "traced_launches": f"{traced} of {reps}",
            "plain_ms": device_ms(torch, plain, sets, reps)[0],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "operations_ms": t_ops,
            "operations": ops_kind,
            "library_ms": lib and device_ms(torch, lib, lib_sets, reps)[0],
            "max_abs_err": err, "event_ms": kern_ev,
            "plain_event_ms": plain_ev,
            "library_event_ms": lib and time_ms(torch, lib, lib_sets, reps)}


def report_line(name: str, n: int, entry: dict, card: str) -> None:
    lib = entry["library_ms"]
    print(f"[time] {name} n={n} batch={SERVE_BATCH} "
          f"resident={entry['resident']} device ms (profiler): "
          f"kernel={entry['ms']:.4f} (mean of {entry['traced_launches']} "
          f"launches traced) plain={entry['plain_ms']:.4f} "
          f"library={'none' if lib is None else f'{lib:.4f}'} "
          f"[{entry['library']}] bound={entry['bound_ms']:.4f} "
          f"({entry['bound_by']}; bytes {entry['bytes_ms']:.4f}, "
          f"{entry['operations']} {entry['operations_ms']:.4f}); event ms "
          f"per call: kernel={entry['event_ms']:.4f} "
          f"plain={entry['plain_event_ms']:.4f}; |kernel-plain|max="
          f"{entry['max_abs_err']:.3g}; launch: {entry['rows_per_cta']} "
          f"rows/CTA, {entry['threads']} threads, {entry['smem_bytes']} B "
          f"shared, {entry['regs']} regs/thread -> {entry['ctas_per_sm']} "
          f"CTAs/SM; on {card}", flush=True)


def timings(torch, kfft, kpoly, core_fft, build, card: str) -> dict:
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    out: dict[str, dict] = {name: {} for name in FLOAT_KERNELS}
    for n in SERVE_NS:
        b = SERVE_BATCH
        set_bytes = 6 * b * n * 4
        n_sets = max(2, math.ceil(128e6 / set_bytes))
        sets = []
        for _ in range(n_sets):
            planes = [torch.from_numpy(rng.standard_normal((b, n)).astype(
                np.float32)).to(dev) for _ in range(4)]
            sets.append(planes)
        plan_c = core_fft.plan(n, b)
        plan_r = core_fft.plan(n, b, real=True)
        plan_pc = core_fft.plan(n, b, product=True)
        plan_pr = core_fft.plan(n, b, real=True, product=True)
        tf = torch.fft
        # library inputs: the complex tensors built from the same planes
        lib_sets = [(torch.complex(p, q), p, q, torch.complex(r, s))
                    for p, q, r, s in sets]
        # irfft inputs: packed half spectra, and numpy's layout of the same
        half_sets = [kfft.rfft_planes(p) for p, *_ in sets]
        half_lib = [(tf.rfft(p),) for p, *_ in sets]
        cases = {
            "fft_planes": (
                plan_c,
                lambda p, q, *_: kfft.fft_planes(
                    p, q, radix=plan_c.radix, block_b=plan_c.block_b),
                lambda p, q, *_: kfft.fft_planes_plain(p, q,
                                                       radix=plan_c.radix),
                sets, lambda z, *_: tf.fft(z), lib_sets, "torch.fft.fft"),
            "rfft_planes": (
                plan_r,
                lambda p, *_: kfft.rfft_planes(p, radix=plan_r.radix,
                                               block_b=plan_r.block_b),
                lambda p, *_: kfft.rfft_planes_plain(p, radix=plan_r.radix),
                sets, lambda z, p, *_: tf.rfft(p), lib_sets,
                "torch.fft.rfft"),
            "irfft_planes": (
                plan_r,
                lambda p, q: kfft.irfft_planes(p, q, radix=plan_r.radix,
                                               block_b=plan_r.block_b),
                lambda p, q: kfft.irfft_planes_plain(p, q,
                                                     radix=plan_r.radix),
                half_sets, lambda h: tf.irfft(h, n=n), half_lib,
                "torch.fft.irfft"),
            "polymul_complex_planes": (
                plan_pc,
                lambda p, q, r, s: kpoly.polymul_complex_planes(
                    p, q, r, s, radix=plan_pc.radix,
                    block_b=plan_pc.block_b),
                lambda p, q, r, s: kpoly.polymul_complex_planes_plain(
                    p, q, r, s, radix=plan_pc.radix),
                sets, lambda z, p, q, w: tf.ifft(tf.fft(z) * tf.fft(w)),
                lib_sets, "composite ifft(fft(a)*fft(b)), three cuFFT calls"),
            "polymul_real_planes": (
                plan_pr,
                lambda p, q, *_: kpoly.polymul_real_planes(
                    p, q, radix=plan_pr.radix, block_b=plan_pr.block_b),
                lambda p, q, *_: kpoly.polymul_real_planes_plain(
                    p, q, radix=plan_pr.radix),
                sets, lambda z, p, q, w: tf.irfft(tf.rfft(p) * tf.rfft(q),
                                                  n=n),
                lib_sets,
                "composite irfft(rfft(a)*rfft(b)), three cuFFT calls"),
        }
        for name, (plan, kern, plain, ksets, lib, lsets, lib_name) in \
                cases.items():
            nbytes, flops = work(name, n, b, plan.radix)
            entry = measure(torch, name, n, kern, plain, ksets, lib, lsets,
                            exact=False,
                            bound=(nbytes / HBM_BYTES_PER_S * 1e3,
                                   flops / FP32_FLOPS_PER_S * 1e3,
                                   "fp32 flops"))
            entry.update(library=lib_name, bytes=nbytes, flops=flops,
                         radix=plan.radix, block_b=plan.block_b,
                         resident=plan.resident,
                         **occupancy(build, kfft, name, n, b, plan))
            out[name][n] = entry
            report_line(name, n, entry, card)
    return out


def ntt_timings(torch, kntt, ntt_core, core_fft, build, card: str) -> dict:
    """The three NTT kernels at the serve shapes: ntt_polymul and
    ntt_batched at n = 4096 and 65536, rns_ntt_polymul at the RNS cell,
    batch 64, on uint32 words as the serve path stages them. No PyTorch
    call computes an NTT mod q, so there is no library time."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    out: dict[str, dict] = {name: {} for name in NTT_KERNELS}
    b = SERVE_BATCH
    shapes = [("ntt_polymul", n) for n in SERVE_NS] + \
        [("ntt_batched", n) for n in SERVE_NS] + [("rns_ntt_polymul", RNS_N)]
    for name, n in shapes:
        plan = core_fft.plan(n, b, exact=True)
        operands = 1 if name == "ntt_batched" else 2
        if name == "rns_ntt_polymul":
            r = ntt_core.RNSParams.make(n, modulus_bits=RNS_BITS)
            k, qs = r.k, r.qs
            kern = functools.partial(kntt.rns_ntt_polymul, rns=r,
                                     block_b=plan.block_b)
            plain = functools.partial(kntt.rns_ntt_polymul_plain, rns=r)
        else:
            p = ntt_core.NTTParams.make(n)
            k, qs = 1, (p.q,)
            if name == "ntt_batched":
                plan = dataclasses.replace(
                    plan, block_b=kntt.plan_ntt_block(n, product=False),
                    resident=kntt.ntt_resident(n, product=False))
            kern = functools.partial(getattr(kntt, name), params=p,
                                     block_b=plan.block_b)
            plain = functools.partial(getattr(kntt, f"{name}_plain"),
                                      params=p)
        sets = []
        for _ in range(max(2, math.ceil(128e6 / (operands * k * b * n * 4)))):
            words = [np.stack([rng.integers(0, q, (b, n)) for q in qs])
                     for _ in range(operands)]
            sets.append([torch.from_numpy(
                (w if k > 1 else w[0]).astype(np.uint32)).to(dev)
                for w in words])
        nbytes, ops = ntt_work(name, n, b, k)
        entry = measure(torch, name, n, kern, plain, sets, None, None,
                        exact=True,
                        bound=(nbytes / HBM_BYTES_PER_S * 1e3,
                               ops / INT32_OPS_PER_S * 1e3,
                               "int32 operations"))
        rows, staged = kntt.ntt_cta_rows(n, b, plan.block_b,
                                         product=name != "ntt_batched")
        entry.update(library="none: no PyTorch call computes an NTT mod q",
                     bytes=nbytes, int32_ops=ops, limbs=k,
                     block_b=plan.block_b, resident=plan.resident,
                     rows_per_cta=rows, staged=staged,
                     **build.occupancy(name, n.bit_length() - 1, rows,
                                       staged))
        out[name][n] = entry
        report_line(name, n, entry, card)
    return out


# ---------------------------------------------------------------------------
# The LM: flash attention on the card, and serving qwen3-1.7b
# ---------------------------------------------------------------------------

#: phase 2's flash-attention cases: (label, B, S, H, KV, hd, dtype, window,
#: causal). The first is the served prefill's shape.
ATTN_CASES = [
    ("served", LM_BATCH, LM_PROMPT, 16, 8, 128, "bfloat16", 1 << 30, True),
    ("window 1024", 2, LM_PROMPT, 16, 8, 128, "bfloat16", 1024, True),
    ("window 24", 2, LM_PROMPT, 16, 8, 128, "bfloat16", 24, True),
    ("non-causal", 2, 1024, 16, 8, 128, "bfloat16", 1 << 30, False),
    ("ragged S", 2, 1000, 16, 8, 128, "bfloat16", 1 << 30, True),
    ("G = 1", 2, 1024, 8, 8, 128, "bfloat16", 1 << 30, True),
    ("hd 64", 2, 1024, 24, 8, 64, "bfloat16", 1 << 30, True),
    ("hd 320", 2, 1024, 8, 4, 320, "bfloat16", 1024, True),
    ("fp32", 2, 1000, 16, 8, 128, "float32", 1 << 30, True),
    ("fp32 hd 320 window 24", 1, 300, 8, 4, 320, "float32", 24, True),
]


def attention_inputs(torch, B, S, H, KV, hd, dtype, seed):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn(B, S, H, hd, device=dev, generator=g).to(dt)
    k, v = (torch.randn(B, S, KV, hd, device=dev, generator=g).to(dt)
            for _ in range(2))
    return q, k, v


def check_attention(torch, kattn) -> float:
    """The flash kernel against its plain version (key blocks of the
    kernel's tile) on every case of ATTN_CASES, and the public (H, S, hd)
    layout against the naive oracle too. Returns the worst |kernel - plain|
    at the served shape."""
    served_err = None
    for i, (label, B, S, H, KV, hd, dtype, window, causal) in \
            enumerate(ATTN_CASES):
        q, k, v = attention_inputs(torch, B, S, H, KV, hd, dtype, i)
        kw = dict(window=window, causal=causal, scale=hd ** -0.5)
        got = kattn.attention(q, k, v, **kw).float()
        want = kattn.attention_plain(q, k, v, **kw).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, **ATTN_TOL[dtype]):
            raise SystemExit(f"flash_attention {label} (B={B} S={S} H={H} "
                             f"KV={KV} hd={hd} {dtype} window={window} "
                             f"causal={causal}): kernel and plain version "
                             f"differ, max |diff| {err}")
        served_err = err if served_err is None else served_err
        print(f"[attention] {label}: B={B} S={S} H={H} KV={KV} hd={hd} "
              f"{dtype} window={window} causal={causal} |kernel-plain|max="
              f"{err:.3g} within {ATTN_TOL[dtype]}", flush=True)
    q, k, v = (x[0].transpose(0, 1) for x in attention_inputs(
        torch, 1, 500, 6, 6, 64, "float32", 99))
    got = kattn.flash_attention(q, k, v, window=100)
    for want in (kattn.flash_attention_plain(q, k, v, window=100),
                 kattn.attention_ref(q, k, v, window=100)):
        if not torch.allclose(got, want, **ATTN_TOL["float32"]):
            raise SystemExit("flash_attention (H, S, hd) layout differs "
                             "from its plain version or the oracle")
    print("[attention] public (H, S, hd) layout, S=500 window=100 fp32: "
          "== plain and naive oracle within 2e-4", flush=True)
    torch.cuda.synchronize()
    return served_err


def full_width_state(torch, convert, cfg):
    """qwen3-1.7b's weights drawn on the card from seed 0, as the serve
    CLI draws them (fp32, the parameter type)."""
    return convert.init_params(
        cfg, torch.Generator(device=torch.device("cuda")).manual_seed(0))


def lm_phase(torch, build, serve, convert, lm, get_config) -> dict:
    """Phase 3 for the LM: (1) the served run through the serve CLI, the
    launch counters zeroed just before; (2) prefill/decode parity at full
    width in fp32; (3) the same 2-layer full-width weights on the card and
    on the CPU. Returns what the report needs."""
    import dataclasses
    dev = torch.device("cuda")
    build.reset_launches()
    t0 = time.perf_counter()
    res = serve.main(["--service", "lm", "--arch", LM_ARCH, "--batch",
                      str(LM_BATCH), "--prompt-len", str(LM_PROMPT), "--gen",
                      str(LM_GEN)])
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    cfg = get_config(LM_ARCH)
    gen = res["generated"]
    if launches["flash_attention"] != cfg.num_layers:
        raise SystemExit(f"served LM run: flash_attention launched "
                         f"{launches['flash_attention']} times, expected "
                         f"{cfg.num_layers} (one per layer, one prefill)")
    if others := {k: n for k, n in launches.items()
                  if n and k != "flash_attention"}:
        raise SystemExit(f"served LM run launched other kernels: {others}")
    if gen.shape != (LM_GEN, LM_BATCH) or not (
            (gen >= 0) & (gen < cfg.vocab_size)).all():
        raise SystemExit(f"served LM run: generated {gen.shape} "
                         f"{gen.min()}..{gen.max()}")
    print(f"[lm] served {LM_ARCH} (full width, {cfg.num_layers} layers, "
          f"bf16) batch={LM_BATCH} prompt={LM_PROMPT} gen={LM_GEN}: "
          f"generated {gen.shape}, {res['tokens_per_s']:.1f} tok/s "
          f"(first call, incl. prefill) in {wall:.1f}s with set-up; "
          f"launches {launches}", flush=True)

    # (2) parity at full width, fp32 activations
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    sd = full_width_state(torch, convert, cfg)
    model = convert.build(cfg32, sd, dev)
    del sd
    B, S = 2, 512
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(2))
    full = model(tokens)
    last, state = model.prefill(tokens[:, :S], cache_capacity=S + 1)
    step, _ = model.decode_step(state, tokens[:, S], S)
    errs = (float((last - full[:, S - 1]).abs().max()),
            float((step - full[:, -1]).abs().max()))
    if not (torch.isfinite(full).all()
            and torch.allclose(last, full[:, S - 1], **LM_TOL)
            and torch.allclose(step, full[:, -1], **LM_TOL)):
        raise SystemExit(f"full-width prefill/decode parity failed: "
                         f"|prefill - forward| {errs[0]}, |decode - "
                         f"forward| {errs[1]}")
    print(f"[lm] parity {LM_ARCH} full width fp32 B={B} S={S}: "
          f"prefill last logits vs forward |diff|max={errs[0]:.3g}, "
          f"decode_step(S) vs forward(S+1)[-1] |diff|max={errs[1]:.3g}, "
          f"within {LM_TOL}", flush=True)
    del model, full, state

    # (3) the same weights on the card and on the CPU
    cfg2 = dataclasses.replace(cfg32, num_layers=2)
    sd = convert.init_params(cfg2, torch.Generator().manual_seed(3))
    tokens = torch.randint(0, cfg.vocab_size, (1, 128),
                           generator=torch.Generator().manual_seed(4))
    on_cpu = convert.build(cfg2, sd, "cpu")(tokens)
    on_card = convert.build(cfg2, sd, dev)(tokens.to(dev)).cpu()
    err = float((on_card - on_cpu).abs().max())
    if not torch.allclose(on_card, on_cpu, **LM_TOL):
        raise SystemExit(f"2-layer full-width logits: card and CPU differ "
                         f"by {err}")
    print(f"[lm] {LM_ARCH} full width, 2 layers, fp32, B=1 S=128: card "
          f"(flash kernel) vs CPU (plain) logits |diff|max={err:.3g} within "
          f"{LM_TOL}", flush=True)
    torch.cuda.synchronize()
    return {"launches": launches["flash_attention"],
            "first_call_tokens_per_s": res["tokens_per_s"],
            "parity_max_abs": errs, "card_vs_cpu_max_abs": err}


#: Device-side name of the flash kernel in a profiler trace.
FLASH_KERNEL = re.compile(r"flash_attention_kernel")


def attention_timing(torch, kattn, build, card: str) -> dict:
    """The flash kernel at the served prefill shape: device time (mean over
    the launches traced), its plain version, and
    scaled_dot_product_attention (causal, GQA) on the same inputs as the
    yardstick; bound: bytes of q, k, v and o over 3.35 TB/s, or the causal
    pairs' flops (4 hd per pair: q.k and p.v) over 989 TFLOP/s bf16.

    The plain version's and SDPA's times are CUDA-event time per call over
    back-to-back calls: each call runs far longer than the host takes to
    launch it, so the card never waits on the host, while their traces
    drop device events and read low (on an H100 the trace of SDPA at this
    shape read half its event time, below the bound). Their traced time
    over calls is printed beside."""
    _, B, S, H, KV, hd, dtype, window, causal = ATTN_CASES[0]
    sets = [attention_inputs(torch, B, S, H, KV, hd, dtype, 100 + i)
            for i in range(2)]
    scale = hd ** -0.5
    kern = functools.partial(kattn.attention, window=window, scale=scale)
    plain = functools.partial(kattn.attention_plain, window=window,
                              scale=scale)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_sets = [tuple(x.transpose(1, 2) for x in s) for s in sets]

    def lib(q, k, v):
        return sdpa(q, k, v, is_causal=True, enable_gqa=True)

    got, want = kern(*sets[0]).float(), plain(*sets[0]).float()
    ref = lib(*lib_sets[0]).transpose(1, 2).float()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, **ATTN_TOL[dtype]):
        raise SystemExit(f"flash_attention served shape: |kernel - plain| "
                         f"{err}")
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    flops = 4 * hd * (S * (S + 1) // 2) * B * H
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    reps = 10
    ms, traced = device_ms(torch, kern, sets, reps, launches_per_call=1)
    entry = {
        "ms": ms, "traced_launches": f"{traced} of {reps}",
        "plain_ms": time_ms(torch, plain, sets, 4),
        "library_ms": time_ms(torch, lib, lib_sets, reps),
        "library": "torch.nn.functional.scaled_dot_product_attention("
                   "is_causal=True, enable_gqa=True)",
        "event_ms": time_ms(torch, kern, sets, reps),
        "plain_traced_ms": device_ms(torch, plain, sets, 4)[0],
        "library_traced_ms": device_ms(torch, lib, lib_sets, reps)[0],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes_ms": t_bytes, "operations_ms": t_ops,
        "operations": "bf16 flops", "bytes": nbytes, "flops": flops,
        "max_abs_err": err,
        "sdpa_vs_plain_max_abs": float((ref - want).abs().max()),
        "shape": {"B": B, "S": S, "H": H, "KV": KV, "hd": hd,
                  "dtype": dtype, "causal": causal},
        **build.occupancy("flash_attention", hd, 1, 0)}
    print(f"[time] flash_attention B={B} S={S} H={H} KV={KV} hd={hd} "
          f"{dtype} causal: kernel={entry['ms']:.4f} device ms (profiler, "
          f"mean of {entry['traced_launches']} launches traced); event ms "
          f"per call: kernel={entry['event_ms']:.4f} "
          f"plain={entry['plain_ms']:.4f} sdpa={entry['library_ms']:.4f}; "
          f"bound={entry['bound_ms']:.4f} ({entry['bound_by']}; bytes "
          f"{t_bytes:.4f}, bf16 flops {t_ops:.4f}); traced ms over calls: "
          f"plain={entry['plain_traced_ms']:.4f} "
          f"sdpa={entry['library_traced_ms']:.4f}; "
          f"{flops / entry['ms'] / 1e9:.1f} TFLOP/s; |kernel-plain|max="
          f"{err:.3g}; launch: {entry['threads']} threads, "
          f"{entry['smem_bytes']} B shared, {entry['regs']} regs/thread -> "
          f"{entry['ctas_per_sm']} CTAs/SM; on {card}", flush=True)
    return entry


def lm_timing(torch, convert, lm, get_config, card: str) -> dict:
    """The served cell's prefill ms, decode ms per token and tok/s (host
    clock around work that ends in a synchronize, after one warm call),
    then a traced generate: the card's idle share and the flash kernel's
    share of the prefill's device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    cfg = get_config(LM_ARCH)
    model = convert.build(cfg, full_width_state(torch, convert, cfg), dev)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    cap = LM_PROMPT + LM_GEN
    model.prefill(tokens, cache_capacity=cap)
    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = model.prefill(tokens, cache_capacity=cap)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    tok = logits.argmax(dim=-1)
    model.decode_step(state, tok, LM_PROMPT)      # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(LM_GEN):
        logits, state = model.decode_step(state, tok, LM_PROMPT + i)
        tok = logits.argmax(dim=-1)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / LM_GEN
    pre = min(prefill_ms)
    tok_s = LM_BATCH * LM_GEN / ((pre + LM_GEN * decode_ms) / 1e3)

    def device_time(prof):
        """(device ms, flash kernel ms, flash launches traced)"""
        total = flash = 0.0
        seen = 0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                total += e.self_device_time_total / 1e3
                if FLASH_KERNEL.search(e.key):
                    flash += e.self_device_time_total / 1e3
                    seen += e.count
        return total, flash, seen

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill(tokens, cache_capacity=cap)
        torch.cuda.synchronize()
    pre_dev, pre_flash, flash_seen = device_time(prof)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lm.generate(model, tokens, LM_GEN)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, _, _ = device_time(prof)
    out = {"prefill_ms": pre, "prefill_ms_runs": prefill_ms,
           "decode_ms_per_token": decode_ms, "tokens_per_s": tok_s,
           "prefill_device_ms": pre_dev, "prefill_flash_ms": pre_flash,
           "prefill_flash_launches_traced": flash_seen,
           "flash_share_of_prefill": pre_flash / pre_dev if pre_dev else None,
           "idle_share": 1 - busy_ms / wall_ms,
           "traced_generate_wall_ms": wall_ms, "traced_busy_ms": busy_ms}
    print(f"[time] lm {LM_ARCH} batch={LM_BATCH} prompt={LM_PROMPT} "
          f"gen={LM_GEN} bf16: prefill {pre:.2f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in prefill_ms)}), decode "
          f"{decode_ms:.3f} ms/token, {tok_s:.1f} tok/s incl. prefill; "
          f"traced prefill: device {pre_dev:.2f} ms, flash kernel "
          f"{pre_flash:.2f} ms in {flash_seen} of {cfg.num_layers} "
          f"launches traced ({out['flash_share_of_prefill'] or 0:.3f}); "
          f"traced generate: "
          f"device busy {busy_ms:.2f} of {wall_ms:.2f} ms wall -> idle "
          f"share {out['idle_share']:.4f}; on {card}", flush=True)
    return out


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.core import fft as core_fft
    from repro_torch.core import ntt as ntt_core
    from repro_torch.kernels import _build
    from repro_torch.kernels import fft as kfft
    from repro_torch.kernels import ntt as kntt
    from repro_torch.kernels import polymul as kpoly
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import attention as kattn
    from repro_torch.launch import engine as engine_mod
    from repro_torch.launch import serve
    from repro_torch.models import convert, lm

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    _build.load()
    card = card_line()
    print(f"[build] {STOCKHAM}, {NTT}, {ATTENTION} -> "
          f"{', '.join(str(v) for v in libs.values())} in "
          f"{time.perf_counter() - t0:.1f}s; card: {card}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- phase 2: kernels vs plain vs numpy ----------------------------------
    _build.reset_launches()
    worst = check_kernels(torch, kfft, kpoly, core_fft)
    worst.update(check_ntt_kernels(torch, kntt, ntt_core, core_fft))
    attn_err = check_attention(torch, kattn)
    moved = dict(_build.LAUNCHES)
    if not all(moved.values()):
        raise SystemExit(f"a kernel never launched in the sweep: {moved}")
    print(f"[kernels] all nine held against their plain versions (the "
          f"transform kernels against numpy too); launches {moved}; worst "
          f"|kernel-plain| {worst}, flash_attention at the served shape "
          f"{attn_err:.3g}", flush=True)

    # -- phase 3: serve, launch counters zeroed just before --------------------
    _build.reset_launches()
    expected, warm = serve_phase(serve, engine_mod, _build)
    launches = dict(_build.LAUNCHES)
    for name, (route, _, _) in TRANSFORM_KERNELS.items():
        served = launches[name] - warm[name]
        want = expected.get(route, 0)
        if route is not None and (served == 0 or served != want):
            raise SystemExit(f"{name}: {served} launches while serving, "
                             f"expected {want} (one per dispatched batch "
                             f"of route {route})")
    print(f"[serve] launch counters {launches}: warmups {warm}, the rest "
          f"== dispatched batches per route {expected}", flush=True)
    # the library path, counters zeroed just before
    _build.reset_launches()
    library_phase(torch, core_fft, kntt, ntt_core)
    for name, (route, _, _) in TRANSFORM_KERNELS.items():
        if route is None:
            if _build.LAUNCHES[name] == 0:
                raise SystemExit(f"{name}: never launched on the library "
                                 f"path")
            launches[name] = _build.LAUNCHES[name]
    print(f"[library] launch counters {dict(_build.LAUNCHES)}", flush=True)
    traced = idle_shares(torch, serve, card)
    # the LM: its served run zeroes the counters just before
    lm_run = lm_phase(torch, _build, serve, convert, lm, get_config)

    # -- phase 4: timings ----------------------------------------------------
    times = timings(torch, kfft, kpoly, core_fft, _build, card)
    times.update(ntt_timings(torch, kntt, ntt_core, core_fft, _build, card))
    attn = attention_timing(torch, kattn, _build, card)
    lm_times = lm_timing(torch, convert, lm, get_config, card)
    report = []
    for name, (route, source, replaces) in TRANSFORM_KERNELS.items():
        shapes = sorted(times[name])
        at = times[name][shapes[0]]
        report.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": at["max_abs_err"], "ms": at["ms"],
            "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"], "library_ms": at["library_ms"],
            "n": shapes[0], "batch": SERVE_BATCH,
            "per_served_batch": {n: traced[route, n] for n in SERVE_NS
                                 if (route, n) in traced},
            **{f"at_n{n}": times[name][n] for n in shapes[1:]}})
    name, source, replaces = FLASH
    report.append({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": lm_run["launches"],
        **{k: attn[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")},
        "launches_per": "one served prefill (28 layers)",
        "at_served_shape": attn, "lm": {**lm_run, **lm_times}})
    torch.cuda.synchronize()
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
