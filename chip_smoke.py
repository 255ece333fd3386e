#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. Build: compile ``kernels/csrc/stockham.cu`` with nvcc into ``build/``
     and print the build time, the card's name and its power limit.
  2. Kernels vs plain: each of the four kernels against its plain PyTorch
     version on the card and against float64 numpy.fft, radix 2 and 4,
     n = 2 .. 2^18 (shared-memory resident and staged rows), odd and even
     batches including 1, and the serve batch with the planner's block at
     the serve lengths, with the reference tests' tolerances.
  3. Serve: ``FFTService`` per op at n = 4096 and 65536 (batch 64, 256
     requests each), then one mixed ``ServeEngine`` over all four ops and
     both lengths. Every served result is checked against the registry's
     numpy oracle, and the launch counters, zeroed just before this phase,
     must show one kernel launch per dispatched batch besides the
     warmups' launches.
     A separate traced run per op and length then gives the card's idle
     share during serving, and the kernels and copies each served batch
     puts on the card besides its Stockham kernel.
  4. Timings at the serve shapes: kernel, plain version and the PyTorch
     library call (cuFFT) on the same inputs -- device time per call from
     torch.profiler (the run fails if the trace holds none), with the
     CUDA-event wall time per call beside it -- held against the least
     time the card could take (bytes over 3.35 TB/s or operations over
     67 TFLOP/s fp32, the H100 SXM data sheet); the kernel must agree
     with its plain version within phase 2's tolerance. Each kernel's
     launch configuration and the CTAs an SM holds come from the CUDA
     occupancy API.

The line before the last is the card's name and power limit; the line
before that a JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1
and prints no result.
"""
from __future__ import annotations

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
SERVE_NS = (4096, 65536)
SERVE_BATCH = 64
SERVE_REQUESTS = 256
ENGINE_REQUESTS = 512
OPS = ("fft", "rfft", "polymul", "polymul-real")
SOURCE = "src/repro_torch/kernels/csrc/stockham.cu"
#: wrapper -> (op it serves, TPU kernel it replaces)
KERNELS = {
    "fft_planes": ("fft", "src/repro/kernels/fft.py:146"),
    "rfft_planes": ("rfft", "src/repro/kernels/fft.py:260"),
    "polymul_complex_planes": ("polymul", "src/repro/kernels/polymul.py:33"),
    "polymul_real_planes": ("polymul-real",
                            "src/repro/kernels/polymul.py:52"),
}


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
        return {"fft_planes": core_fft.plan(n, b).block_b,
                "rfft_planes": core_fft.plan(n, b, real=True).block_b,
                "polymul_complex_planes":
                    core_fft.plan(n, b, product=True).block_b,
                "polymul_real_planes":
                    core_fft.plan(n, b, real=True, product=True).block_b}
    paired = ("rfft_planes", "polymul_real_planes")
    return {name: cap and (2 * cap if name in paired else cap)
            for name in KERNELS}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 2: kernels vs plain versions vs float64 numpy
# ---------------------------------------------------------------------------

def check_kernels(torch, kfft, kpoly, core_fft) -> dict[str, float]:
    """Sweep every kernel; returns the worst |kernel - plain| per kernel."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    worst = dict.fromkeys(KERNELS, 0.0)

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


# ---------------------------------------------------------------------------
# Phase 3: the serve path
# ---------------------------------------------------------------------------

def serve_phase(serve, engine_mod, build) -> tuple[dict, dict]:
    """Drive FFTService per op and length, then one mixed engine; verify
    every result. Returns the batches each op dispatched while serving,
    and the launches each kernel made in the warmups, for the
    launch-counter check."""
    expected = dict.fromkeys(OPS, 0)
    warm = dict.fromkeys(KERNELS, 0)

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
            expected[b["op"]] += b["batches"]
        return stats

    for op in OPS:
        for n in SERVE_NS:
            svc = serve.FFTService(n, SERVE_BATCH, op, device="cuda")
            warmup(svc.engine)
            stats = drain(svc.engine, [(op, n)], SERVE_REQUESTS, n)
            lat = stats["latency_ms"]
            print(f"[serve] op={op} n={n} batch={SERVE_BATCH} "
                  f"requests={stats['served']} verified=all "
                  f"{stats['throughput_per_s']:.1f} req/s "
                  f"p50={lat['p50']:.3f}ms p99={lat['p99']:.3f}ms "
                  f"[{svc.plan.describe()}]", flush=True)
    eng = engine_mod.ServeEngine(max_batch=SERVE_BATCH, device="cuda")
    combos = [(op, n) for op in OPS for n in SERVE_NS]
    for op, n in combos:
        eng.register(op, n)
    warmup(eng)
    stats = drain(eng, combos, ENGINE_REQUESTS, 1)
    lat = stats["latency_ms"]
    print(f"[serve] engine ops={','.join(OPS)} ns={SERVE_NS} "
          f"requests={stats['served']} verified=all "
          f"{stats['throughput_per_s']:.1f} req/s p50={lat['p50']:.3f}ms "
          f"p99={lat['p99']:.3f}ms buckets={len(stats['buckets'])}",
          flush=True)
    return expected, warm


#: Device-side names of the four kernels in a profiler trace.
STOCKHAM_KERNEL = re.compile(
    r"(^|::)(fft|rfft|polymul_complex|polymul_real)_kernel\b")


def idle_shares(torch, serve, card: str) -> dict:
    """A separate traced run per op and length (profiler on, so its
    req/s is not the measured one): the share of the serve loop's wall
    time during which no kernel or copy ran on the card, and what each
    served batch put on the card: Stockham kernels, the other kernels
    (splitting complex batches into planes, joining and repacking the
    results) and copies, with their device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    traced = {}
    for op in OPS:
        for n in SERVE_NS:
            svc = serve.FFTService(n, SERVE_BATCH, op, device="cuda")
            svc.warmup()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                _, stats = serve.produce(svc.engine, [(op, n)],
                                         SERVE_REQUESTS,
                                         np.random.default_rng(n))
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            per = {k: [0, 0.0] for k in ("stockham", "other", "copies")}
            for e in prof.key_averages():
                if e.device_type != DeviceType.CUDA:
                    continue
                kind = ("stockham" if STOCKHAM_KERNEL.search(e.key) else
                        "copies" if e.key.startswith(("Memcpy", "Memset"))
                        else "other")
                per[kind][0] += e.count
                per[kind][1] += e.self_device_time_total / 1e3
            busy_ms = sum(ms for _, ms in per.values())
            batches = stats["batches"]
            traced[(op, n)] = {
                "idle_share": 1 - busy_ms / wall_ms,
                **{f"{k}_per_batch": c / batches for k, (c, _) in per.items()},
                **{f"{k}_ms_per_batch": ms / batches
                   for k, (_, ms) in per.items()}}
            print(f"[trace] op={op} n={n} batch={SERVE_BATCH} "
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
    if name == "polymul_complex_planes":
        return 4 * (6 * b * n + 2 * n), b * (3 * t + 8 * n)
    return (4 * (3 * b * n + 4 * n),
            2 * pairs * (t + 14 * n) + pairs * (t + 4 * n))


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


def device_ms(torch, fn, arg_sets, reps: int) -> float:
    """Mean device time of one call in ms: the summed duration of every
    kernel the call ran, traced by torch.profiler (CUPTI), without the
    host's launch gaps. A trace that holds no device time is taken once
    more; if that one holds none either, the run fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(*arg_sets[i % len(arg_sets)])
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps
    raise SystemExit("torch.profiler traced no device time in two tries")


def occupancy(build, kfft, name: str, n: int, b: int, plan) -> dict:
    """Launch configuration and CTAs per SM of kernel ``name`` as its
    wrapper launches it for a batch of b rows under ``plan``."""
    real = name in ("rfft_planes", "polymul_real_planes")
    product = name.startswith("polymul")
    rows, staged = kfft.cta_rows(n, b, plan.block_b, real=real,
                                 product=product)
    return {"rows_per_cta": rows, "staged": staged,
            **build.occupancy(name, n.bit_length() - 1, rows, staged)}


def timings(torch, kfft, kpoly, core_fft, build, card: str) -> dict:
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    out: dict[str, dict] = {name: {} for name in KERNELS}
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
        cases = {
            "fft_planes": (
                plan_c,
                lambda p, q, *_: kfft.fft_planes(
                    p, q, radix=plan_c.radix, block_b=plan_c.block_b),
                lambda p, q, *_: kfft.fft_planes_plain(p, q,
                                                       radix=plan_c.radix),
                lambda z, *_: tf.fft(z), "torch.fft.fft"),
            "rfft_planes": (
                plan_r,
                lambda p, *_: kfft.rfft_planes(p, radix=plan_r.radix,
                                               block_b=plan_r.block_b),
                lambda p, *_: kfft.rfft_planes_plain(p, radix=plan_r.radix),
                lambda z, p, *_: tf.rfft(p), "torch.fft.rfft"),
            "polymul_complex_planes": (
                plan_pc,
                lambda p, q, r, s: kpoly.polymul_complex_planes(
                    p, q, r, s, radix=plan_pc.radix,
                    block_b=plan_pc.block_b),
                lambda p, q, r, s: kpoly.polymul_complex_planes_plain(
                    p, q, r, s, radix=plan_pc.radix),
                lambda z, p, q, w: tf.ifft(tf.fft(z) * tf.fft(w)),
                "composite ifft(fft(a)*fft(b)), three cuFFT calls"),
            "polymul_real_planes": (
                plan_pr,
                lambda p, q, *_: kpoly.polymul_real_planes(
                    p, q, radix=plan_pr.radix, block_b=plan_pr.block_b),
                lambda p, q, *_: kpoly.polymul_real_planes_plain(
                    p, q, radix=plan_pr.radix),
                lambda z, p, q, w: tf.irfft(tf.rfft(p) * tf.rfft(q), n=n),
                "composite irfft(rfft(a)*rfft(b)), three cuFFT calls"),
        }
        # library inputs: the complex tensors built from the same planes
        lib_sets = [(torch.complex(p, q), p, q, torch.complex(r, s))
                    for p, q, r, s in sets]
        for name, (plan, kern, plain, lib, lib_name) in cases.items():
            reps = max(n_sets, 20)
            got, want = (torch.cat([t.flatten() for t in _as_tuple(f(*sets[0]))])
                         for f in (kern, plain))
            err = float((got - want).abs().max())
            tol = tolerance(name, n)
            if not torch.allclose(got, want, **tol):
                raise SystemExit(f"{name} n={n} batch={b}: kernel and plain "
                                 f"version differ beyond {tol} (max abs "
                                 f"difference {err})")
            # wall time per call (CUDA events, host launch gaps included):
            # plain, kernel, kernel, plain within this call; best of two
            plain_ev = time_ms(torch, plain, sets, reps)
            kern_ev = time_ms(torch, kern, sets, reps)
            kern_ev = min(kern_ev, time_ms(torch, kern, sets, reps))
            plain_ev = min(plain_ev, time_ms(torch, plain, sets, reps))
            lib_ev = time_ms(torch, lib, lib_sets, reps)
            # device time per call (profiler)
            timed = {k: device_ms(torch, f, s, reps)
                     for k, f, s in (("kernel", kern, sets),
                                     ("plain", plain, sets),
                                     ("library", lib, lib_sets))}
            occ = occupancy(build, kfft, name, n, b, plan)
            nbytes, flops = work(name, n, b, plan.radix)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / FP32_FLOPS_PER_S * 1e3
            entry = {"ms": timed["kernel"], "plain_ms": timed["plain"],
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else
                     "operations",
                     "library_ms": timed["library"], "library": lib_name,
                     "max_abs_err": err,
                     "event_ms": kern_ev, "plain_event_ms": plain_ev,
                     "library_event_ms": lib_ev, "bytes": nbytes,
                     "flops": flops, "radix": plan.radix,
                     "block_b": plan.block_b, "resident": plan.resident,
                     **occ}
            out[name][n] = entry
            print(f"[time] {name} n={n} batch={b} radix={plan.radix} "
                  f"resident={plan.resident} device ms (profiler): "
                  f"kernel={entry['ms']:.4f} plain={entry['plain_ms']:.4f} "
                  f"library={entry['library_ms']:.4f} [{lib_name}] "
                  f"bound={entry['bound_ms']:.4f} ({entry['bound_by']}); "
                  f"event ms per call: kernel={kern_ev:.4f} "
                  f"plain={plain_ev:.4f} library={lib_ev:.4f}; "
                  f"|kernel-plain|max={err:.3g}; launch: {occ['rows_per_cta']} "
                  f"rows/CTA, {occ['threads']} threads, {occ['smem_bytes']} B "
                  f"shared, {occ['regs']} regs/thread -> "
                  f"{occ['ctas_per_sm']} CTAs/SM; on {card}", flush=True)
    return out


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.core import fft as core_fft
    from repro_torch.kernels import _build
    from repro_torch.kernels import fft as kfft
    from repro_torch.kernels import polymul as kpoly
    from repro_torch.launch import engine as engine_mod
    from repro_torch.launch import serve

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    card = card_line()
    print(f"[build] {SOURCE} -> {_build.library_path()} in "
          f"{time.perf_counter() - t0:.1f}s; card: {card}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- phase 2: kernels vs plain vs numpy ----------------------------------
    _build.reset_launches()
    worst = check_kernels(torch, kfft, kpoly, core_fft)
    moved = dict(_build.LAUNCHES)
    if not all(moved.values()):
        raise SystemExit(f"a kernel never launched in the sweep: {moved}")
    print(f"[kernels] all four held against plain and numpy; launches "
          f"{moved}; worst |kernel-plain| {worst}", flush=True)

    # -- phase 3: serve, launch counters zeroed just before --------------------
    _build.reset_launches()
    expected, warm = serve_phase(serve, engine_mod, _build)
    launches = dict(_build.LAUNCHES)
    for name, (op, _) in KERNELS.items():
        served = launches[name] - warm[name]
        if served == 0 or served != expected[op]:
            raise SystemExit(f"{name}: {served} launches while serving, "
                             f"expected {expected[op]} (one per dispatched "
                             f"batch)")
    print(f"[serve] launch counters {launches}: warmups {warm}, the rest "
          f"== dispatched batches {expected}", flush=True)
    traced = idle_shares(torch, serve, card)

    # -- phase 4: timings ----------------------------------------------------
    times = timings(torch, kfft, kpoly, core_fft, _build, card)
    report = []
    for name, (op, replaces) in KERNELS.items():
        at = times[name][SERVE_NS[0]]
        report.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": at["max_abs_err"], "ms": at["ms"],
            "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"], "library_ms": at["library_ms"],
            "n": SERVE_NS[0], "batch": SERVE_BATCH,
            "per_served_batch": {n: traced[(op, n)] for n in SERVE_NS},
            f"at_n{SERVE_NS[1]}": times[name][SERVE_NS[1]]})
    torch.cuda.synchronize()
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
