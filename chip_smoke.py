#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root, on a machine with one NVIDIA H100:

    python3 chip_smoke.py                 # every phase, the result lines
    python3 chip_smoke.py --phases 1,3    # only those phases, no result
    python3 chip_smoke.py --tile-ab       # phase 1, then the A/B of tiles

Phase 1 always runs; phase 5 reads phase 4's times and brings it along.
``--tile-ab`` (not taken by the default run; alone it runs phase 1 and
the A/B, and no other phase unless ``--phases`` names it) builds
``kernels/csrc/attention.cu`` once per ``TILE_AB`` choice of the fp32
hd-32 instance's key tile and stages (``-DTF32_HD32_KEYS``,
``-DTF32_HD32_STAGES``, one nvcc each with ``-Xptxas -v``, all started
together), holds each against the plain version folded at its tile, and
times them, the ``TILE_PROBES`` builds (``-DTF32_PROBE``: the shipped tile
without the softmax and split of p, without the prep of K and V, or both:
where the time goes) and the CUDA-core kernel in turns on the same inputs
at ``ATTN_TIMED["fp32 hd 32"]``'s shape (lines ``[tile ab]``).

Phases (any failure exits non-zero):
  1. Build: compile ``kernels/csrc/stockham.cu``, ``kernels/csrc/ntt.cu``
     and ``kernels/csrc/attention.cu`` with nvcc into ``build/``, one nvcc
     per source, all started together (and beside them a second nvcc of
     each with ``-Xptxas -v``), and print the build time, the card's name
     and its power limit; then ptxas's registers and spills for every
     Stockham and NTT kernel, and its
     registers, shared memory and spills for each of the eight instances
     of the two tensor-core flash kernels (wgmma on bf16 at head_dim 32,
     64, 128 and 320; 3xTF32 on fp32 at 32, 64, 128 and 320) and the count of
     HGMMA and UTMALDG instructions in its SASS (``cuobjdump -sass``),
     which must hold HGMMA.
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
     (109-bit Q) and at k = 1. Then the NTT kernels' split schedules
     (``check_ntt_two_pass``), cyclic and negacyclic (the NTT forward and
     inverse), batches 1, 2, 5 and 64, == plain == numpy reference: the
     NTT product's split-pass schedule at every n from its threshold to
     2^19, the RNS product's planned schedule at k = 9 and k = 1 from its
     split threshold to 2^17 (the CRT == ``rns_polymul_reference``), the
     NTT's two passes from its threshold to 2^19, and every schedule of
     each at 4096 and 8192 (the RNS product: single-CTA, register steps,
     split-pass). Then the three
     flash-attention kernels
     against their plain versions (``ATTN_CASES``), each case launching
     the kernel its (dtype, head_dim) dispatches to and the others never:
     the wgmma kernel (bf16, head_dim 32, 64, 128 and 320) at the served
     prefill shape, windows 1024 and 24, non-causal, ragged S, G = 1,
     S = 1 and S < 64, at gemma3-4b's heads (hd 320, 8 heads over 4 kv
     heads, S = 2048, window 1024 and global) and at head_dim 32 (the
     reduced configs') at the served batch and prompt and the same edge
     cases; the 3xTF32 kernel (fp32, head_dim 32, 64, 128 and 320) at the
     served shape, window 24, non-causal, ragged S, S = 1, S < 64, G = 1,
     hd 64, and hd 320 (the head_dim-split instance) and hd 32 (the
     reduced configs') at the same edge cases, and gemma3-4b's local and
     global shapes; the CUDA-core kernel, which no (type, head_dim)
     dispatches to, launched directly (``CUDA_CORE_DIRECT``, the in-turn
     baseline of phase 4) at fp32 head_dim 32, 128 and 320 and bf16
     head_dim 32; hymba-1.5b's heads (25 over 5 kv heads: G = 5, H
     odd; hd 64; window 2048) at its served shape and past the window and
     mixtral-8x22b's (48 over 8, hd 128) past its window of 4096, in bf16
     and fp32; the heads of ``rest_phase``'s archs, musicgen-medium's (24
     over 24: G = 1 at hd 64), starcoder2-15b's (48 over 4: G = 12),
     qwen2-vl-72b's (64 over 8) and llama3-405b's (128 over 8: G = 16),
     at the served batch and prompt in bf16 (llama3-405b at B 2) and at
     B 2 x 2048 in fp32; bf16 within one bf16 step and fp32 within 2e-4; and
     the public (H, S, hd) layout against the naive oracle. Then the two-pass
     schedules of the fft, rfft and irfft kernels and the products'
     split-pass schedule (``check_two_pass``; three launches, four at odd
     log2 n and radix 4): n = 2^14 .. 2^18 (two passes) and 4096, 8192
     under both schedules (the one the planner does not pick through the
     launch helper the wrapper calls), radix 2 and 4, batches 1, 2, 5 and
     64, the fft forward and inverse, each result equal to the plain
     version bit for bit (``==``), within tolerance of float64 numpy, and
     the rfft -> irfft round trips.
  3. Serve: ``FFTService`` per op at n = 4096 and 65536 (batch 64, 256
     requests each), ``polymul-mod`` single-limb at both lengths and RNS at
     n = 4096 with a 109-bit modulus, then one mixed ``ServeEngine`` over
     all five ops and both lengths. Every served result is checked against
     the registry's numpy oracle (bit for bit for ``polymul-mod``), and the
     launch counters, zeroed just before this phase, must show one kernel
     launch per dispatched batch of the kernel's route besides the warmups'
     launches, and the RNS route's calls all under its planned schedule
     (``_build.SCHEDULES``). Then the library path, counters zeroed again:
     the rfft ->
     irfft round trip through ``core.fft`` and the NTT -> inverse NTT round
     trip through ``kernels.ntt.ntt_batched`` at the serve shapes.
     A separate traced run per serve cell then gives the card's idle share
     during serving, and the kernels and copies each served batch puts on
     the card besides its own kernel. Then the LM, counters zeroed just
     before: the serve CLI's ``--service lm`` for qwen3-1.7b at full width
     (bf16, random weights from a seeded generator), batch 8, prompt 2048,
     gen 32, which must launch the wgmma flash kernel 28 times (one
     prefill, one launch per layer) and nothing else; prefill/decode
     parity at full width in fp32 (B = 2, S = 512) within the reference's
     2e-3, counters zeroed just before, which must launch the 3xTF32
     flash kernel 56 times (a forward and a prefill) and nothing else; and
     the same 2-layer full-width weights on the card and on the CPU (plain
     versions) within 2e-3. Then gemma3-4b the same way, counters zeroed
     just before: ``--service lm --arch gemma3-4b`` at full width (34
     layers, head_dim 320), batch 8, prompt 2048, gen 32, which must launch
     the wgmma kernel 34 times and nothing else; and a 6-layer full-width
     bf16 prefill (B = 2, S = 2048: five local layers and the global layer
     5) once through the kernel and once with the plain version swapped in
     for ``kernels.attention.attention``, whose last logits must agree
     within ``GEMMA_PARITY_TOL``; then the same prefill in fp32, the 3xTF32
     kernel's head_dim-split instance (6 launches, nothing else), within
     2e-3. Then the reduced qwen3-1.7b config (head_dim 32) the same way
     at B = 2, S = ``REDUCED_PROMPT``: in bf16 on the wgmma kernel's hd-32
     instance (2 launches, nothing else), in fp32 on the 3xTF32 kernel's
     hd-32 instance (2 launches, nothing else). Then fourierpim-lm (``fourier_phase``).
     Then the MoE FFN and the recurrent mixers (``mixer_phase``), each
     step with the counters zeroed just before: ``--service lm`` at full
     width and depth (bf16, batch 8, prompt 2048, gen 32) for
     granite-moe-3b-a800m and hymba-1.5b (32 launches each of the wgmma
     kernel, nothing else) and rwkv6-7b (no launch); mixtral-8x22b at full
     width on 2 of its 56 layers, a cut of depth (2 launches); 2
     full-width fp32 layers of granite, hymba and rwkv6 with the same
     weights on the card and on the CPU (B 1 x S 128) within 2e-3, the
     card launching the 3xTF32 kernel once a layer (none for rwkv6), and
     for granite each token's chosen experts and kept slots equal on both,
     each token's k-th to (k+1)-th probability margin above the two runs'
     rounding of the probabilities; and prefill/decode parity on the card
     at full width in fp32 for the four (granite, rwkv6 all 32 layers at
     B 2 x 512; hymba B 1 x 2048, its window; mixtral 2 layers; the MoE
     archs at capacity factor E / k) within 2e-3. Then the registry's
     other four archs (``rest_phase``, ``REST_ARCHS``), each step with the
     counters zeroed just before: at full width (bf16, batch 8, prompt
     2048, gen 32, seed-0 weights drawn on the card) starcoder2-15b on 8 of
     its 40 layers and llama3-405b on 4 of its 126 (cuts of depth) through
     ``--service lm --layers``, musicgen-medium (all 48 layers) and
     qwen2-vl-72b (8 of 80, with (B, S, 3) M-RoPE streams) through
     ``prefill(embeds=)`` and 32 ``decode_step(embed=)`` calls over seeded
     embeddings (``drive_embeddings``): one launch of the wgmma kernel a
     layer and nothing else, ids in the vocabulary, tok/s, prefill ms and
     decode ms per token (CUDA events) and peak device memory; a bf16
     prefill (B 2 x 2048) of 2 to 6 full-width layers through the kernel
     against the plain version swapped in, within ``GEMMA_PARITY_TOL``;
     2 full-width fp32 layers (llama3-405b 1) on the card against the CPU
     (B 1 x S 128) within 2e-3, the host's MemAvailable printed before;
     and prefill/decode parity on 2 full-width fp32 layers at B 2 x 512
     within 2e-3, the embeddings archs' decode step fed the forward's own
     embeddings and positions; the fp32 steps launch the 3xTF32 kernel
     once a layer and nothing else.
  4. Timings at the serve shapes: kernel, plain version and, where one
     exists, the PyTorch library call on the same inputs -- device time per
     call from torch.profiler, for a kernel the mean over the launches
     the trace holds (the trace drops some; one without device time is
     taken again, and the run fails if five in a row hold none), with
     the CUDA-event wall time per call beside it -- held against the least
     time the card could take: bytes over 3.35 TB/s, or operations over
     67 TFLOP/s fp32 (the H100 SXM data sheet) for the float kernels, over
     the card's 32-bit integer rate (``INT32_OPS_PER_S``) for the NTT
     kernels, and over 989 TFLOP/s bf16 (the wgmma kernel, at the served
     prefill shape, at gemma3-4b's local and global shapes and at head_dim
     32), three times the flops over 495 TFLOP/s TF32 (the 3xTF32 kernel,
     at the served shape in fp32, at gemma3-4b's global and local
     shapes in fp32 and at head_dim 32 in fp32; beside each tensor-core
     kernel, in turns on the same inputs, the CUDA-core kernel, whose
     bound is its fp32 flops over 67 TFLOP/s) for flash
     attention, whose yardstick is ``scaled_dot_product_attention``
     (causal, GQA; the flash kernels, their plain versions and SDPA timed
     by CUDA events over back-to-back calls, as their traces drop events;
     the traced times are printed beside where the trace holds any); each
     kernel must agree with its plain version within phase 2's tolerance
     (exactly, for the NTT kernels and the fft and rfft kernels). Each
     kernel's launch configuration and the CTAs an SM holds come from the
     CUDA occupancy API, for each launch of a two-pass call, whose traced
     time counts the call's launches (and a trace splits it by kernel,
     with the bytes and TB/s of the irfft's and the NTT kernels'
     launches); the two-pass kernels and the NTT kernels (the RNS product
     also at n = 65536, k = 9) also by CUDA events around a CUDA-graph
     replay. Then the A/B of the schedules of the fft, the rfft, the
     irfft, both products and the NTT product at n = 4096 and 8192, of the
     RNS product at k = 9 (``RNS_AB_NS``: single-CTA, register steps,
     split-pass) and of ntt_batched forward and inverse (``NTT_AB_NS``)
     (``schedule_ab``: in turns single-CTA, two-pass, two-pass,
     single-CTA, the register steps between), which sets the planner's
     thresholds.
     The flash kernels' shapes are ``ATTN_TIMED``. Then the LM cells,
     qwen3-1.7b and gemma3-4b: prefill ms, decode ms per token and tok/s,
     a traced prefill for the wgmma flash kernel's share of it, and 4
     traced decode steps (``LM_TRACED_STEPS``) for the card's idle share;
     the full-width fp32 qwen3-1.7b and gemma3-4b prefills (batch 8 x
     2048; gemma3-4b's 34 layers through the head_dim-split instance)
     through the 3xTF32 kernel, with its share of a traced prefill;
     fourierpim-lm; then granite-moe-3b, hymba-1.5b, rwkv6-7b and the
     2-layer mixtral-8x22b the same way,
     granite's traced prefill split by the MoE's stages (routing, scatter,
     expert products, gather: ``MOE_STAGES``) and rwkv6-7b's by its scan
     (``SCAN_STAGES``) against the matmuls outside them. Each LM timing
     first counts one prefill's launches, the counters zeroed just before:
     the kernel ``kernel_for`` picks, once per layer (none for rwkv6-7b),
     and nothing else.
  5. The cost model on the card (lines ``[cost model]``), each line with
     the card's name and power limit: (a) the paper's cuFFT model
     (``core/pim/gpu_model.py`` on the H100 config of
     ``core/pim/hopper.py``) beside phase 4's ``torch.fft.fft``,
     ``fft_planes`` and product times (batch 64, n = 4096 and 65536;
     6144 x 4096), and FourierPIM-8/40's modelled fp32 throughput over the
     card's measured ``torch.fft.fft`` and over ``fft_planes`` (phase 4's
     numbers, not timed again); (b) for each of the five workloads at
     batch 64 and both lengths, ``plan(n, 64, workload=...)``'s predicted
     seconds for each candidate on both backends, each candidate's route
     as auto mode binds it (the complex-packing routes ``rfft-complex``
     and ``polymul-real-complex`` among them) checked against the numpy
     oracle and timed by CUDA events around a CUDA-graph replay, and
     whether the predicted-best packing is the measured best (a
     disagreement is printed, not raised); (c) ``serve --service engine
     --auto`` over the five ops at both lengths, 400 requests, the
     counters zeroed just before: every result verified, each route
     kernel's launches == its dispatched batches, each bucket's predicted
     against observed seconds per request.
  6. Fault tolerance on the card (lines ``[ft]``, then one ``[ft json]``
     line), each number beside the card's name and power limit:
     (a) ``ServeEngine(verified=True)`` over the five ops at n = 4096 and
     65536 and ``polymul-mod`` RNS (109 bits) at 4096, batch 64, every
     request submitted before the run (full batches), in turns with the
     unverified engine on the same traffic (verified, unverified,
     unverified, verified): every batch checked, no detection, every
     result of the first verified turn equal to its oracle, each route
     kernel's launches == its batches in every turn (counters zeroed
     before each), req/s and p50/p99 of each turn, and per bucket the
     check's host ms per batch (``BoundOp.integrity`` timed alone over the
     delivered batches) and the worst float residual against
     ``abft.FLOAT_TOL``; (b) ``serve --service engine --verify
     --inject-faults --inject-stuck 1`` over three ops through
     ``serve.main``: every result equal to its oracle, detected, retried
     and fell_back >= 1, each route kernel's launches == batches +
     retries + fallback re-runs besides the warmups'; (c) the CLI as a
     subprocess with ``--snapshot-dir``, SIGTERM after its sync marker: it
     exits 0 with a snapshot, the time from SIGTERM to exit printed, and a
     second run warm-restarts (``warm restart #1``) with the lifetime
     counters carried; (d) a request with a 1e-4 s deadline queued behind
     a full batch gets ``deadline_exceeded``, and ``--inject-straggler-ms``
     with ``--watchdog-*`` and ``--elastic`` records an eviction and
     warm-restarts at one shard.
  7. The multi-device tier (lines ``[dist]``, then one ``[dist json]``
     line), each number beside the card's name and power limit: (a) the
     device map of an 8-shard mesh (every shard on ``cuda:0`` on a
     one-card host: the exchanges are copies in device memory, not
     NVLink); (b) for D = 2, 4, 8 at n = 65536 (batch 1) and 2^20 (batch
     4; the real tier 1 and 3 rows, odd): the sharded fft
     (ordered and Z-order, forward and inverse), the complex product, the
     real tier (rfft, irfft, product; odd batches) and the NTT (forward,
     Z-order, inverse; negacyclic and cyclic products), each through the
     kernels ``==`` the same call with the plain versions swapped in
     (``swapped_fft_planes``, ``swapped_ntt_batched``), launching
     ``fft_planes`` / ``ntt_batched`` the calls' local transforms' times;
     the float results within 1e-3 of the local route at 65536 and within
     2e-6 (relative) of fp64 numpy at 2^20, the NTT ``==`` the local
     ``ntt_polymul`` and the numpy reference; (c) each call's ledger
     counts and bytes ``==`` ``four_step_collective_stats``; (d)
     ``FFTService`` with ``model_shards=8``: ``polymul-real`` at 2^20,
     batch 16, and single-limb ``polymul-mod`` at 65536, batch 16, 64
     requests each, counters zeroed just before, every result checked,
     req/s, p50/p99, device ms a call against the local route's and the
     cost model's prediction, and a traced call split into local
     transforms, exchanges and glue; one ``polymul-real`` call at 2^24
     (past the real product's on-chip ceiling) on 8 shards against the
     local ``polymul-real-complex`` route within 2e-6; (e) an engine on
     ``polymul-real`` at 8 shards evicted by the watchdog (injected
     stragglers) restarts at 4 and serves the rest, every result checked;
     (f) the phase's ``[clock]`` line.
  8. Training (lines ``[train]``, then one ``[train json]`` line), each
     number beside the card's name and power limit: (a) ``fft_causal_conv``
     forward and backward at fourierpim-lm's shapes (x (8, 768, 2048),
     taps (1, 768, 256), n = 4096) and at a two-pass length (T = 6000,
     n = 8192): three ``fft_planes`` launches forward and three backward,
     y, dx and dk == the same with the plain version swapped in (bit for
     bit), dx and dk within 1e-4 of float64 numpy's correlation; (b) one
     training step (``lm.value_and_grad``) of 2 full-width fp32 layers of
     fourierpim-lm and of the reduced qwen3-1.7b config on the card
     against the CPU: loss, gradient norm and each leaf within 1e-4 (a
     sound step reads about 2e-6), the card's launches exactly
     ``fft_planes`` 9 a layer and ``flash_attention_tf32`` 2 a layer; then
     the
     control, the same card step with the model's matmuls in TF32, which
     must read outside 1e-4; (c) ``python -m repro_torch.launch.train
     --arch fourierpim-lm --batch 8 --seq 2048`` for 20 steps (through its
     ``run``, the counters zeroed just before): ``fft_planes`` 9 times a
     layer a step and nothing else, the loss falls, step ms, tokens/s and
     peak memory; then a run resumed from its step-10 checkpoint, whose
     losses must equal the uninterrupted run's within 1e-3 (and the line
     says whether bit for bit); (d) one traced full-width step split into
     the fft kernel (graph replays at the step's shapes), the
     convolution's glue, matmuls, the optimizer and the rest, with the
     card's idle share; (e) the phase's ``[clock]`` line.
  9. The model axis (lines ``[axis]``, then one ``[axis json]`` line), each
     number beside the card's name and power limit; every shard of the
     mesh sits on ``cuda:0``, so each shard's launches are 1/M of the work
     and the collectives are copies in device memory (no interconnect is
     measured): (a) one training step of 2 full-width fp32 fourierpim-lm
     layers and of the reduced qwen3-1.7b config, split over a model axis
     of 2 and of 4 (``models/sharded.py``), against the same step
     unsharded on the card: loss, gradient norm and each leaf within
     TRAIN_STEP_TOL, the launches exactly M x the unsharded step's
     (``fft_planes`` 9 a layer a shard, ``flash_attention_tf32`` 2), the
     byte
     ledger == ``sharded.collective_form``; (b) ``python -m
     repro_torch.launch.train --arch fourierpim-lm --batch 8 --seq 2048
     --mesh 1x2`` for 20 steps and a resume from step 10: step ms,
     tokens/s, peak memory, launches a step, the first and last loss,
     whether the resumed losses equal the uninterrupted run's bit for bit,
     beside phase 8's unsharded run; (c) qwen3-1.7b's bf16 prefill at full
     width (B 2 x S 2048) on a model axis of 2: 8 q heads over 4 kv heads
     a shard, 56 launches of the wgmma kernel, the last logits within
     AXIS_PREFILL_TOL of the unsharded card prefill (bf16: phase 3's bf16
     bound; fp32, on the 3xTF32 kernel, 56 launches: LM_TOL) and the same
     greedy tokens where the top two are clear of it, its ms; (d) the
     dry-run's ``run_cell`` on the meta (2, 2, 2)
     mesh for qwen3-1.7b x decode_32k and fourierpim-lm x train_4k, its
     argument bytes against the reference's compiled numbers; (e) the
     phase's ``[clock]`` line.

The line before the last is the card's name and power limit; the line
before that a JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}, all three on a full run only. Without a
CUDA device the script exits 1 and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import types

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
#: the LM's three Hopper kernels for TPU kernel 9, by launch counter: the
#: bf16 tensor-core kernel (head_dim 32, 64, 128 and 320: the served
#: prefills and the reduced configs'), the 3xTF32 tensor-core kernel (fp32
#: at the same head_dims) and the CUDA-core kernel (none: the yardstick
#: timed in turns on the same inputs)
FLASH_REPLACES = "src/repro/kernels/attention.py:30"
FLASH_KERNELS = ("flash_attention_wgmma", "flash_attention_tf32",
                 "flash_attention")
BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet, dense bf16 tensor cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM data sheet, dense TF32 tensor cores
#: the served LM cells: qwen3-1.7b and gemma3-4b at full width, bf16
#: activations, the same batch, prompt and generated tokens
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "qwen3-1.7b", 8, 2048, 32
#: decode steps of the traced decode that gives an LM cell's idle share
#: (PR 21-25 traced a whole generate of LM_GEN tokens: its post-processing
#: took about a minute a cell on the host)
LM_TRACED_STEPS = 4
#: timed prefills of an LM cell, after a warm one (3 until PR 25; the
#: recurrent archs' take seconds on the host)
LM_PREFILL_RUNS = 2
#: layers of rwkv6-7b's traced prefill (its scan puts 2,200 kernels a
#: layer in the trace)
SCAN_TRACE_LAYERS = 4
GEMMA_ARCH = "gemma3-4b"
#: gemma3-4b's kernel-vs-plain prefill: 6 layers at full width (five local
#: layers, then the global layer 5), batch 2, the served prompt
GEMMA_PARITY_LAYERS, GEMMA_PARITY_BATCH = 6, 2
#: the reduced configs' prefill (head_dim 32): batch 2 of this many tokens
REDUCED_PROMPT = 1000
#: its last logits are bf16 of magnitude up to about 8, spaced 2^-5 at 4..8;
#: a bf16 rounding that differs in one of six layers' activations may move
#: a logit by a step or two: four steps (as tests/test_torch_models.py holds
#: the bf16 forward against the reference)
GEMMA_PARITY_TOL = dict(rtol=0, atol=0.125)
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


#: phase 2's host oracles (float64 numpy.fft, the numpy NTT reference and
#: the CRT) hold the first ORACLE_ROWS rows of each case, one from 2^17 on
#: (the kernels stay held against their plain versions on every row): at
#: the serve batch of 64 rows the oracles took most of the phase
ORACLE_ROWS = 2


def oracle_rows(n: int) -> int:
    return ORACLE_ROWS if n <= 1 << 16 else 1


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
        """Every row against the plain version; the first ORACLE_ROWS
        against numpy (``want`` holds those rows only)."""
        got = np.asarray(got)
        np.testing.assert_allclose(got, plain, rtol=rtol, atol=atol,
                                   err_msg=f"{name} vs plain")
        np.testing.assert_allclose(got[:ORACLE_ROWS], want, rtol=rtol,
                                   atol=atol, err_msg=f"{name} vs numpy")
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
                x64 = (xr.astype(np.float64) + 1j * xi)[:ORACLE_ROWS]
                xr64 = xr[:ORACLE_ROWS].astype(np.float64)
                xi64 = xi[:ORACLE_ROWS].astype(np.float64)
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
                half = np.fft.rfft(xr64)
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
                rows = min(b, ORACLE_ROWS)
                half = np.zeros((rows, n // 2 + 1), np.complex128)
                half[:, :n // 2] = cplx(yr[:rows], yi[:rows])
                half[:, 0] = yr[:rows, 0].cpu().numpy()
                half[:, n // 2] = yi[:rows, 0].cpu().numpy()
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
                y64 = xi64 + 1j * xr64
                want = np.fft.ifft(np.fft.fft(x64) * np.fft.fft(y64))
                close("polymul_complex_planes", got, plain, want, **ptol)
                # real product
                got = kpoly.polymul_real_planes(
                    tr, ti, radix=radix, block_b=blk["polymul_real_planes"])
                plain = kpoly.polymul_real_planes_plain(tr, ti, radix=radix)
                want = np.fft.ifft(np.fft.fft(xr64) * np.fft.fft(xi64)).real
                close("polymul_real_planes", got.cpu(), plain.cpu().numpy(),
                      want, **ptol)
        print(f"[kernels] n=2^{log2n:<2d} radix 2,4 batches "
              f"{sorted({c[0] for c in cases})} resident="
              f"{kfft.resident(n)}/{kfft.resident(n, product=True)} ok",
              flush=True)
    torch.cuda.synchronize()
    return worst


#: phase 2's two-pass cases: the lengths where the wrappers plan two passes
#: (the products: their split-pass schedule) on the serve path and past it,
#: and the lengths below 2^14 where both schedules run (the planner's, and
#: the other through the launch helper)
TWO_PASS_NS = tuple(1 << k for k in range(14, 19))
BOTH_SCHEDULES_NS = (4096, 8192)
TWO_PASS_BATCHES = (1, 2, 5, SERVE_BATCH)
#: the float kernels with a two-pass (split-pass) schedule
TWO_PASS_KERNELS = ("fft_planes", "rfft_planes", "irfft_planes",
                    "polymul_complex_planes", "polymul_real_planes")


def _kinds(name: str) -> tuple[bool, bool]:
    """(real, product) of a two-pass kernel's wrapper."""
    return (name in ("rfft_planes", "irfft_planes", "polymul_real_planes"),
            name.startswith("polymul"))


def planned_two_pass(kfft, kpoly, name: str, n: int, radix: int):
    """The two-pass launch the wrapper ``name`` plans at n, or None."""
    real, product = _kinds(name)
    if product:
        return kpoly.product_two_pass_plan(n, radix, real=real)
    if name == "irfft_planes":
        return kfft.irfft_two_pass_plan(n, radix)
    return kfft.two_pass_plan(n, radix, real=real)


def schedules(kfft, kpoly, name: str, n: int, radix: int) -> dict:
    """The schedules phase 2 and the A/B run ``name`` under at length n:
    {"two-pass" or "resident" (or "staged"): the ``TwoPass`` /
    ``ProductTwoPass`` or None}; the planner's first."""
    real, product = _kinds(name)
    planned = planned_two_pass(kfft, kpoly, name, n, radix)
    single = ("resident" if kfft.resident(n, real=real, product=product)
              else "staged")
    out = {("two-pass" if planned else single): planned}
    if n in BOTH_SCHEDULES_NS:
        out.setdefault(single, None)
        split = kfft.two_pass_split(n, radix, real=real, product=product)
        out.setdefault("two-pass", kpoly.product_two_pass_launch(
            *split, radix, real=real) if product else
            kfft.two_pass_launch(*split, real=real and name == "rfft_planes"))
    return out


def launch_under(kfft, kpoly, name: str, schedule, radix: int, *,
                 inverse=False):
    """A two-pass kernel's wrapper on card tensors under a given schedule:
    through the wrapper where it is the planner's, else through the launch
    helper the wrapper calls (the C entry point, one count on the wrapper's
    counter), so the schedule the planner did not pick runs too."""
    real, product = _kinds(name)

    def run(*planes):
        n = planes[0].shape[1]
        planned = schedule == planned_two_pass(kfft, kpoly, name, n, radix)
        if name == "fft_planes":
            return (kfft.fft_planes(*planes[:2], inverse=inverse, radix=radix)
                    if planned else kfft._launch_fft(
                        *planes[:2], inverse, radix,
                        kfft.plan_batch_block(n), schedule))
        if name == "rfft_planes":
            return (kfft.rfft_planes(planes[0], radix=radix) if planned
                    else kfft._launch_rfft(planes[0], radix,
                                           kfft.plan_batch_block(n, real=True),
                                           schedule))
        if name == "irfft_planes":      # packed planes (B, n / 2)
            n = 2 * planes[0].shape[1]
            planned = schedule == planned_two_pass(kfft, kpoly, name, n,
                                                   radix)
            return (kfft.irfft_planes(*planes[:2], radix=radix) if planned
                    else kfft._launch_irfft(
                        *planes[:2], radix,
                        kfft.plan_batch_block(n, real=True), schedule))
        if name == "polymul_complex_planes":
            return (kpoly.polymul_complex_planes(*planes[:4], radix=radix)
                    if planned else kpoly._launch_polymul_complex(
                        *planes[:4], radix, kpoly.default_complex_block(n),
                        schedule))
        return (kpoly.polymul_real_planes(*planes[:2], radix=radix)
                if planned else kpoly._launch_polymul_real(
                    *planes[:2], radix, kpoly.default_real_block(n),
                    schedule))
    return run


def check_two_pass(torch, kfft, kpoly) -> dict[str, int]:
    """fft_planes (forward and inverse), rfft_planes, irfft_planes (of the
    rfft's packed planes) and the two products under every schedule of
    ``schedules`` -- two passes (the products' split-pass schedule: three
    launches, four at odd log2 n and radix 4) at n = 2^14 .. 2^18, both
    schedules at n = 4096 and 8192 -- radix 2 and 4, batches 1, 2, 5 and
    the serve batch: each result equal to its plain version bit for bit
    (``==``), the first ORACLE_ROWS rows within the reference tests'
    tolerance of float64 numpy, and the rfft -> irfft round trips
    (through the planned irfft, and through each irfft schedule) within
    rtol 1e-4, atol 1e-4 n.
    Returns the cases held per kernel."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    held = dict.fromkeys(TWO_PASS_KERNELS, 0)
    rows = ORACLE_ROWS

    def equal(label, got, want):
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            diff = max(float((g - w).abs().max()) for g, w in zip(got, want))
            raise SystemExit(f"{label}: kernel and plain version differ "
                             f"(max |diff| {diff}); the two-pass schedule "
                             f"must equal them bit for bit")

    def f64(*planes):
        return [p[:rows].cpu().numpy().astype(np.float64) for p in planes]

    for n in sorted(BOTH_SCHEDULES_NS + TWO_PASS_NS):
        tol = tolerance("fft_planes", n)
        ptol = tolerance("polymul_real_planes", n)
        done = set()
        for radix in (2, 4):
            for b in TWO_PASS_BATCHES:
                xr, xi, yr_, yi_ = (torch.from_numpy(rng.standard_normal(
                    (b, n)).astype(np.float32)).to(dev) for _ in range(4))
                hr, hi, gr, gi = f64(xr, xi, yr_, yi_)
                head = hr + 1j * hi
                for inverse in (False, True):
                    plain = kfft.fft_planes_plain(xr, xi, inverse=inverse,
                                                  radix=radix)
                    want = (np.fft.ifft(head) * n if inverse
                            else np.fft.fft(head))
                    for label, sched in schedules(kfft, kpoly, "fft_planes",
                                                  n, radix).items():
                        got = launch_under(kfft, kpoly, "fft_planes", sched,
                                           radix, inverse=inverse)(xr, xi)
                        case = (f"fft_planes n={n} radix={radix} batch={b} "
                                f"inverse={inverse} {label}")
                        equal(case, got, plain)
                        g = (got[0][:rows].cpu().numpy().astype(np.complex128)
                             + 1j * got[1][:rows].cpu().numpy())
                        np.testing.assert_allclose(
                            g * (n if inverse else 1), want, **tol,
                            err_msg=case)
                        held["fft_planes"] += 1
                        done.add(f"fft {label}")
                plain = kfft.rfft_planes_plain(xr, radix=radix)
                half = np.fft.rfft(head.real)
                for label, sched in schedules(kfft, kpoly, "rfft_planes", n,
                                              radix).items():
                    yr, yi = launch_under(kfft, kpoly, "rfft_planes", sched,
                                          radix)(xr)
                    case = (f"rfft_planes n={n} radix={radix} batch={b} "
                            f"{label}")
                    equal(case, (yr, yi), plain)
                    pr, pi = yr[:rows].cpu().numpy(), yi[:rows].cpu().numpy()
                    np.testing.assert_allclose(pr, half[:, :n // 2].real,
                                               **tol, err_msg=case)
                    np.testing.assert_allclose(pi[:, 0], half[:, n // 2].real,
                                               **tol, err_msg=case)
                    np.testing.assert_allclose(pi[:, 1:],
                                               half[:, 1:n // 2].imag, **tol,
                                               err_msg=case)
                    back = kfft.irfft_planes(yr, yi, radix=radix)
                    np.testing.assert_allclose(
                        back.cpu().numpy(), xr.cpu().numpy(), rtol=1e-4,
                        atol=1e-4 * n, err_msg=f"{case}: rfft -> irfft")
                    held["rfft_planes"] += 1
                    done.add(f"rfft {label}")
                # irfft of the packed planes: == plain, within tolerance of
                # numpy.fft.irfft of the same half spectrum, and back to x
                packed = plain
                want = kfft.irfft_planes_plain(*packed, radix=radix)
                hp = [v[:rows].cpu().numpy().astype(np.float64)
                      for v in packed]
                half = hp[0] + 1j * hp[1]
                half = np.concatenate([half, hp[1][:, :1]], axis=1)
                half[:, 0] = hp[0][:, 0]
                back_want = np.fft.irfft(half, n=n)
                for label, sched in schedules(kfft, kpoly, "irfft_planes", n,
                                              radix).items():
                    got = launch_under(kfft, kpoly, "irfft_planes", sched,
                                       radix)(*packed)
                    case = (f"irfft_planes n={n} radix={radix} batch={b} "
                            f"{label}")
                    equal(case, (got,), (want,))
                    np.testing.assert_allclose(got[:rows].cpu().numpy(),
                                               back_want, **tol, err_msg=case)
                    np.testing.assert_allclose(
                        got.cpu().numpy(), xr.cpu().numpy(), rtol=1e-4,
                        atol=1e-4 * n, err_msg=f"{case}: rfft -> irfft")
                    held["irfft_planes"] += 1
                    done.add(f"irfft {label}")
                # the products: (x, y) complex, (xr, xi) real
                plain = kpoly.polymul_complex_planes_plain(
                    xr, xi, yr_, yi_, radix=radix)
                want = np.fft.ifft(np.fft.fft(head)
                                   * np.fft.fft(gr + 1j * gi))
                for label, sched in schedules(
                        kfft, kpoly, "polymul_complex_planes", n,
                        radix).items():
                    got = launch_under(kfft, kpoly, "polymul_complex_planes",
                                       sched, radix)(xr, xi, yr_, yi_)
                    case = (f"polymul_complex_planes n={n} radix={radix} "
                            f"batch={b} {label}")
                    equal(case, got, plain)
                    np.testing.assert_allclose(
                        got[0][:rows].cpu().numpy()
                        + 1j * got[1][:rows].cpu().numpy(), want, **ptol,
                        err_msg=case)
                    held["polymul_complex_planes"] += 1
                    done.add(f"polymul {label}")
                plain = kpoly.polymul_real_planes_plain(xr, xi, radix=radix)
                want = np.fft.ifft(np.fft.fft(hr) * np.fft.fft(hi)).real
                for label, sched in schedules(
                        kfft, kpoly, "polymul_real_planes", n,
                        radix).items():
                    got = launch_under(kfft, kpoly, "polymul_real_planes",
                                       sched, radix)(xr, xi)
                    case = (f"polymul_real_planes n={n} radix={radix} "
                            f"batch={b} {label}")
                    equal(case, (got,), (plain,))
                    np.testing.assert_allclose(got[:rows].cpu().numpy(), want,
                                               **ptol, err_msg=case)
                    held["polymul_real_planes"] += 1
                    done.add(f"polymul-real {label}")
        products = {r: kfft.two_pass_split(n, r, product=True)
                    for r in (2, 4)}
        print(f"[two-pass] n={n} radix 2,4 batches {TWO_PASS_BATCHES} "
              f"schedules {sorted(done)}: fft (forward, inverse), rfft, "
              f"irfft and both products == plain, within tolerance of "
              f"numpy, rfft -> irfft round trips ok; product splits "
              f"{products}, launches "
              f"per call (radix 2, 4) "
              f"{[kpoly.product_two_pass_launch(*products[r], r).launches for r in (2, 4)]}",
              flush=True)
    torch.cuda.synchronize()
    return held


def check_ntt_kernels(torch, kntt, ntt_core, core_fft) -> dict[str, int]:
    """Sweep the three NTT kernels: each result must equal its plain
    version and the numpy reference bit for bit. Returns the worst
    |kernel - plain| per kernel (0 when exact)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    worst = dict.fromkeys(NTT_KERNELS, 0)

    def exact(name, got, plain, want):
        """Every row against the plain version; the first rows (those
        ``want`` holds) against the numpy reference."""
        diff = int((got.to(torch.int64) - plain.to(torch.int64)).abs().max())
        worst[name] = max(worst[name], diff)
        head = kntt.residues_to_numpy(got[..., :want.shape[-2], :])
        if diff or not (head == want).all():
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
        rows = oracle_rows(n)
        for b, cap in cases:
            block = core_fft.plan(n, b, exact=True).block_b \
                if cap == "plan" else cap
            xa, ta = words((b, n), p.q)
            xb, tb = words((b, n), p.q)
            xa, xb = xa[:rows], xb[:rows]
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
    # RNS: k = 9 limbs (the serve cell, register steps), one limb, and a
    # split-pass multi-limb case
    for n, kw, cases in ((RNS_N, {"modulus_bits": RNS_BITS},
                          [(1, None), (5, 2), (SERVE_BATCH, "plan")]),
                         (256, {"modulus": 17}, [(3, None)]),
                         (65536, {"modulus_bits": 40}, [(2, None)])):
        r = ntt_core.RNSParams.make(n, **kw)
        for b, cap in cases:
            block = core_fft.plan(n, b, exact=True, rns=True).block_b \
                if cap == "plan" else cap
            a = np.stack([ntt_core.random_poly(rng, n, r.modulus)
                          for _ in range(b)])
            bb = np.stack([ntt_core.random_poly(rng, n, r.modulus)
                           for _ in range(b)])
            ta, tb = (torch.from_numpy(ntt_core.to_rns(v, r).astype(
                np.uint32)).to(dev) for v in (a, bb))
            rows = oracle_rows(n)
            for neg in (True, False):
                got = kntt.rns_ntt_polymul(ta, tb, r, negacyclic=neg,
                                           block_b=block)
                plain = kntt.rns_ntt_polymul_plain(ta, tb, r, negacyclic=neg)
                fn = (ntt_core.negacyclic_polymul if neg
                      else ntt_core.cyclic_polymul)
                limbs = np.stack([fn(ta[i, :rows].cpu().numpy(),
                                     tb[i, :rows].cpu().numpy(), lp)
                                  for i, lp in enumerate(r.limbs)])
                exact("rns_ntt_polymul", got, plain, limbs)
                if (ntt_core.crt_to_modulus(kntt.residues_to_numpy(
                        got[:, :rows]), r) != ntt_core.rns_polymul_reference(
                            a[:rows], bb[:rows], r, negacyclic=neg)).any():
                    raise SystemExit(f"rns_ntt_polymul n={n} {kw}: CRT of "
                                     f"the kernel's limbs is not the "
                                     f"reference product mod Q")
        print(f"[ntt] rns n={n} k={r.k} ({kw}) batches "
              f"{[c[0] for c in cases]} resident={kntt.ntt_resident(n)} "
              f"== plain == numpy reference, CRT == reference mod Q",
              flush=True)
    torch.cuda.synchronize()
    return worst


def ntt_schedules(kntt, kfft, n: int) -> dict:
    """The schedules of ``ntt_polymul`` at length n that phase 2 and the
    A/B run: {"split-pass" or "resident" (or "staged"): the ``NTTTwoPass``
    or None}, the planner's first; both at n = 4096 and 8192."""
    planned = kntt.ntt_two_pass_plan(n)
    single = "resident" if kntt.ntt_resident(n) else "staged"
    out = {("split-pass" if planned else single): planned}
    if n in BOTH_SCHEDULES_NS:
        out.setdefault(single, None)
        out.setdefault("split-pass", kntt.ntt_two_pass_launch(
            *kfft.two_pass_split(n, 2, product=True)))
    return out


def ntt_launch_under(kntt, schedule, params, negacyclic: bool):
    """``ntt_polymul`` on card residues under a given schedule: through the
    wrapper where it is the planner's, else through the launch helper the
    wrapper calls (one count on its counter)."""
    def run(a, b):
        if schedule == kntt.ntt_two_pass_plan(params.n):
            return kntt.ntt_polymul(a, b, params, negacyclic=negacyclic)
        return kntt._launch_ntt_polymul(a, b, params, negacyclic,
                                        kntt.plan_ntt_block(params.n),
                                        schedule)
    return run


def rns_schedules(kntt, kfft, n: int, every: bool = False) -> dict:
    """The schedules of ``rns_ntt_polymul`` at length n, the planner's
    first: {"resident" or "staged" (the single-CTA kernel), "register-step"
    or "split-pass": the ``rns_schedule`` kind}; with ``every`` each one
    that runs at n."""
    single = "resident" if kntt.ntt_resident(n) else "staged"

    def label(sched):
        return single if sched is None else kntt.schedule_name(sched)
    planned = kntt.rns_schedule(n)
    out = {label(planned): planned}
    if every:
        out.setdefault(single, None)
        if kntt.rns_steps_smem_bytes(n) <= kfft.SMEM_MAX_BYTES:
            out.setdefault("register-step", kntt.RNSRegisterSteps(n))
        split = kfft.two_pass_split(n, 2, product=True)
        if split is not None:
            out.setdefault("split-pass", kntt.ntt_two_pass_launch(*split))
    return out


def rns_launch_under(kntt, schedule, rns, negacyclic: bool):
    """``rns_ntt_polymul`` under a given schedule: through the wrapper
    where it is the planner's, else through the launch helper the wrapper
    calls (one count on its counter)."""
    def run(a, b):
        if schedule == kntt.rns_schedule(rns.n):
            return kntt.rns_ntt_polymul(a, b, rns, negacyclic=negacyclic)
        return kntt._launch_rns_ntt_polymul(a, b, rns, negacyclic,
                                            kntt.plan_ntt_block(rns.n),
                                            schedule)
    return run


def ntt_batched_schedules(kntt, kfft, n: int, every: bool = False
                          ) -> dict:
    """The schedules of ``ntt_batched`` at length n, the planner's first:
    {"two-pass": the ``TwoPass``, "resident" or "staged": None}; with
    ``every`` both."""
    planned = kntt.ntt_batched_two_pass_plan(n)
    single = "resident" if kntt.ntt_resident(n, product=False) else "staged"
    out = {("two-pass" if planned else single): planned}
    if every:
        out.setdefault(single, None)
        out.setdefault("two-pass", kfft.two_pass_launch(
            *kfft.two_pass_split(n, 2)))
    return out


def ntt_batched_launch_under(kntt, schedule, params, inverse: bool):
    """``ntt_batched`` under a given schedule, as ``rns_launch_under``."""
    def run(x):
        if schedule == kntt.ntt_batched_two_pass_plan(params.n):
            return kntt.ntt_batched(x, params, inverse=inverse)
        return kntt._launch_ntt_batched(
            x, params, inverse, kntt.plan_ntt_block(params.n, product=False),
            schedule)
    return run


#: lengths at which check_ntt_two_pass holds the RNS product's schedules
#: (from its split-pass threshold) and ntt_batched's (from its two-pass
#: threshold), besides BOTH_SCHEDULES_NS
RNS_TWO_PASS_TOP, NTT_TWO_PASS_TOP = 1 << 17, 1 << 19


def check_ntt_two_pass(torch, kntt, ntt_core, kfft) -> dict[str, int]:
    """The NTT kernels' split schedules, cyclic and negacyclic (forward and
    inverse for the NTT), batches 1, 2, 5 and the serve batch, each result
    equal to the plain version (``==``), whose first rows
    (``oracle_rows``: ORACLE_ROWS; one from 2^17 on, where the host's numpy
    takes seconds a row) equal the numpy reference: ``ntt_polymul``'s
    split-pass schedule at every n from its
    threshold to 2^19; ``rns_ntt_polymul``'s planned schedule at k = 9
    (109-bit Q) and k = 1 from its split threshold to 2^17, the CRT of the
    first row of the first batch == ``rns_polymul_reference``;
    ``ntt_batched``'s two passes from its threshold to 2^19; and every
    schedule of each at 4096 and 8192. Returns the cases held per
    kernel."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    held = dict.fromkeys(("ntt_polymul", "rns_ntt_polymul", "ntt_batched"),
                         0)

    def lengths(name, top):
        lo = kfft.TWO_PASS_FROM[name].bit_length() - 1
        return sorted(set(BOTH_SCHEDULES_NS)
                      | {1 << k for k in range(lo, top.bit_length())})

    for n in lengths("ntt_polymul", 1 << 19):
        p = ntt_core.NTTParams.make(n)
        rows = oracle_rows(n)
        done = set()
        for b in TWO_PASS_BATCHES:
            ta, tb = (torch.from_numpy(rng.integers(0, p.q, (b, n)).astype(
                np.uint32)).to(dev) for _ in range(2))
            ha, hb = (t[:rows].cpu().numpy() for t in (ta, tb))
            for neg in (True, False):
                plain = kntt.ntt_polymul_plain(ta, tb, p, negacyclic=neg)
                fn = (ntt_core.negacyclic_polymul if neg
                      else ntt_core.cyclic_polymul)
                if not (kntt.residues_to_numpy(plain[:rows])
                        == fn(ha, hb, p)).all():
                    raise SystemExit(f"ntt_polymul_plain n={n}: not the "
                                     f"numpy reference")
                for label, sched in ntt_schedules(kntt, kfft, n).items():
                    got = ntt_launch_under(kntt, sched, p, neg)(ta, tb)
                    if not torch.equal(got, plain):
                        raise SystemExit(
                            f"ntt_polymul n={n} batch={b} negacyclic={neg} "
                            f"{label}: kernel and plain version differ")
                    held["ntt_polymul"] += 1
                    done.add(label)
        print(f"[ntt two-pass] ntt_polymul n={n} batches {TWO_PASS_BATCHES} "
              f"cyclic and negacyclic, schedules {sorted(done)} "
              f"(split {kfft.two_pass_split(n, 2, product=True)}): kernel "
              f"== plain == numpy reference", flush=True)
    for n in lengths("rns_ntt_polymul", RNS_TWO_PASS_TOP):
        rows = oracle_rows(n)
        scheds = rns_schedules(kntt, kfft, n, every=n in BOTH_SCHEDULES_NS)
        for kw in ({"modulus_bits": RNS_BITS}, {"modulus": 17}):
            r = ntt_core.RNSParams.make(n, **kw)
            for b in TWO_PASS_BATCHES:
                # the first rows from polynomials mod Q (for the CRT), the
                # rest any residues of each limb
                polys = [np.stack([ntt_core.random_poly(rng, n, r.modulus)
                                   for _ in range(min(b, rows))])
                         for _ in range(2)]
                ta, tb = (torch.from_numpy(np.concatenate(
                    [ntt_core.to_rns(x, r).astype(np.uint32),
                     np.stack([rng.integers(0, q, (b - len(x), n))
                               for q in r.qs]).astype(np.uint32)],
                    axis=1)).to(dev) for x in polys)
                for neg in (True, False):
                    plain = kntt.rns_ntt_polymul_plain(ta, tb, r,
                                                       negacyclic=neg)
                    fn = (ntt_core.negacyclic_polymul if neg
                          else ntt_core.cyclic_polymul)
                    want = np.stack([fn(ta[i, :rows].cpu().numpy(),
                                        tb[i, :rows].cpu().numpy(), lp)
                                     for i, lp in enumerate(r.limbs)])
                    if not (kntt.residues_to_numpy(plain[:, :rows])
                            == want).all():
                        raise SystemExit(f"rns_ntt_polymul_plain n={n} "
                                         f"{kw}: not the numpy reference")
                    if b == TWO_PASS_BATCHES[0] and (
                            ntt_core.crt_to_modulus(kntt.residues_to_numpy(
                                plain[:, :1]), r)
                            != ntt_core.rns_polymul_reference(
                                polys[0][:1], polys[1][:1], r,
                                negacyclic=neg)).any():
                        raise SystemExit(f"rns_ntt_polymul n={n} {kw}: CRT "
                                         f"is not the reference mod Q")
                    for label, sched in scheds.items():
                        got = rns_launch_under(kntt, sched, r, neg)(ta, tb)
                        if not torch.equal(got, plain):
                            raise SystemExit(
                                f"rns_ntt_polymul n={n} k={r.k} batch={b} "
                                f"negacyclic={neg} {label}: kernel and "
                                f"plain version differ")
                        held["rns_ntt_polymul"] += 1
        print(f"[ntt two-pass] rns_ntt_polymul n={n} k=9 and k=1 batches "
              f"{TWO_PASS_BATCHES} cyclic and negacyclic, schedules "
              f"{list(scheds)} (the planner's first): kernel == plain == "
              f"numpy reference, CRT == reference mod Q", flush=True)
    for n in lengths("ntt_batched", NTT_TWO_PASS_TOP):
        p = ntt_core.NTTParams.make(n)
        rows = oracle_rows(n)
        scheds = ntt_batched_schedules(kntt, kfft, n,
                                       every=n in BOTH_SCHEDULES_NS)
        for b in TWO_PASS_BATCHES:
            x = torch.from_numpy(rng.integers(0, 2**32, (b, n)).astype(
                np.uint32)).to(dev)
            for inverse in (False, True):
                plain = kntt.ntt_batched_plain(x, p, inverse=inverse)
                want = (ntt_core.intt if inverse else ntt_core.ntt)(
                    x[:rows].cpu().numpy(), p)
                if not (kntt.residues_to_numpy(plain[:rows]) == want).all():
                    raise SystemExit(f"ntt_batched_plain n={n}: not the "
                                     f"numpy reference")
                for label, sched in scheds.items():
                    got = ntt_batched_launch_under(kntt, sched, p,
                                                   inverse)(x)
                    if not torch.equal(got, plain):
                        raise SystemExit(
                            f"ntt_batched n={n} batch={b} inverse={inverse} "
                            f"{label}: kernel and plain version differ")
                    held["ntt_batched"] += 1
        print(f"[ntt two-pass] ntt_batched n={n} batches {TWO_PASS_BATCHES} "
              f"forward and inverse, schedules {list(scheds)} (split "
              f"{kfft.two_pass_split(n, 2)}): kernel == plain == numpy "
              f"reference", flush=True)
    torch.cuda.synchronize()
    return held


#: fft_causal_conv at fourierpim-lm's shapes: x (B, d 768, T) with the taps
#: (1, 768, 256). The served prefill's x (8, 768, 2048) pads to n = 4096,
#: resident (one kernel a transform); x (2, 768, 8192) pads to n = 16384,
#: the two-pass schedule (two kernels a transform, one launcher call).
FOURIER_CONV_SHAPES = (((8, 768, 2048), 256), ((2, 768, 8192), 256))
#: the reference tests' bound of the FFT compositions
#: (tests/test_kernels_fft.py): rtol 1e-3, atol 1e-3
FOURIER_OPS_TOL = dict(rtol=1e-3, atol=1e-3)


def plain_fft_planes(kfft):
    """``kernels.fft.fft_planes`` with its plain version in place of the
    kernel on the card: the whole-row sweeps, which its two-pass mirror
    equals bit for bit."""
    def fft_planes(xr, xi, *, inverse=False, radix=2, block_b=None):
        del block_b
        return kfft.fft_planes_plain(xr, xi, inverse=inverse, radix=radix)
    return fft_planes


def swapped_fft_planes(kfft, fn):
    """Run ``fn`` with ``plain_fft_planes`` swapped in for
    ``kernels.fft.fft_planes``."""
    kernel = kfft.fft_planes
    kfft.fft_planes = plain_fft_planes(kfft)
    try:
        return fn()
    finally:
        kfft.fft_planes = kernel


def causal_numpy(x, k):
    """Causal depthwise convolution in float64 (np.convolve), x (..., T)
    and k (..., K) broadcast against each other."""
    T = x.shape[-1]
    lead = np.broadcast_shapes(x.shape[:-1], k.shape[:-1])
    xb = np.broadcast_to(x, lead + (T,)).reshape(-1, T).astype(np.float64)
    kb = np.broadcast_to(k, lead + k.shape[-1:]).reshape(-1, k.shape[-1])
    return np.stack([np.convolve(a, b)[:T] for a, b in zip(xb, kb)]
                    ).reshape(lead + (T,))


def check_fourier_ops(torch, build, kfft, kops, radix: int
                      ) -> dict[str, float]:
    """The FFT compositions of ``kernels.ops`` on the card, every transform
    a launch of ``fft_planes``: ``realpack_fft``, ``fft2`` forward and
    inverse, ``fft_conv2d`` and ``fft_causal_conv`` against float64 numpy
    at FOURIER_OPS_TOL; then ``fft_causal_conv`` at FOURIER_CONV_SHAPES
    through the kernel == with ``plain_fft_planes`` swapped in (bit for
    bit), its first rows within FOURIER_OPS_TOL of numpy. Returns the
    worst |op - numpy| per op."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    worst = {}

    def held(name, got, want, tol=FOURIER_OPS_TOL):
        got = got.cpu().numpy()
        np.testing.assert_allclose(got, want, **tol, err_msg=name)
        worst[name] = max(worst.get(name, 0.0),
                          float(np.max(np.abs(got - want))))

    def card(a):
        return torch.from_numpy(a).to(dev)

    for n in (8, 256, 4096, 16384):
        x, y = (rng.standard_normal((4, n)).astype(np.float32)
                for _ in range(2))
        xk, yk = kops.realpack_fft(card(x), card(y), radix=radix)
        # whole spectra of random rows: atol scaled by n, as the reference
        held("realpack_fft", xk, np.fft.fft(x.astype(np.float64)),
             dict(rtol=1e-3, atol=1e-3 * n))
        held("realpack_fft", yk, np.fft.fft(y.astype(np.float64)),
             dict(rtol=1e-3, atol=1e-3 * n))
    for shape in ((2, 16, 32), (1, 256, 512), (4, 64, 64)):
        z = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(np.complex64)
        f = kops.fft2(card(z), radix=radix)
        held("fft2", f, np.fft.fft2(z.astype(np.complex128)),
             dict(rtol=1e-3, atol=1e-3 * math.sqrt(shape[-1] * shape[-2])))
        held("fft2 inverse", kops.fft2(f, inverse=True, radix=radix), z,
             dict(rtol=1e-3, atol=1e-4))
    for H, W, kh, kw in ((12, 20, 3, 5), (100, 60, 7, 3), (255, 255, 5, 5)):
        img = rng.standard_normal((2, H, W)).astype(np.float32)
        kern = rng.standard_normal((kh, kw)).astype(np.float32)
        want = np.zeros((2, H + kh - 1, W + kw - 1))
        for i in range(kh):
            for j in range(kw):
                want[:, i:i + H, j:j + W] += kern[i, j] * img
        r0, c0 = kh // 2, kw // 2
        held("fft_conv2d", kops.fft_conv2d(card(img), card(kern),
                                           radix=radix),
             want[:, r0:r0 + H, c0:c0 + W])
    for xs, ks in (((3, 100), (3, 17)), ((2, 8, 40), (1, 8, 16)),
                   ((2, 16, 600), (1, 16, 256))):
        x = rng.standard_normal(xs).astype(np.float32)
        k = rng.standard_normal(ks).astype(np.float32)
        held("fft_causal_conv", kops.fft_causal_conv(card(x), card(k),
                                                     radix=radix),
             causal_numpy(x, k))
    equal = []
    for xs, K in FOURIER_CONV_SHAPES:
        g = torch.Generator(device=dev).manual_seed(K + xs[-1])
        x = torch.randn(*xs, device=dev, generator=g)
        k = torch.randn(1, xs[1], K, device=dev, generator=g) * 0.02
        n = kops._next_pow2(xs[-1] + K)
        before = dict(build.LAUNCHES)
        got = kops.fft_causal_conv(x, k, radix=radix)
        torch.cuda.synchronize()
        moved = {name: c - before[name]
                 for name, c in build.LAUNCHES.items()
                 if c != before[name]}
        # the counter counts launcher calls: two kernels each at n >=
        # TWO_PASS_FROM["fft"]
        per = 1 if kfft.two_pass_plan(n, radix) is None else 2
        if moved != {"fft_planes": 3}:
            raise SystemExit(f"fft_causal_conv x {xs} taps {K}: launches "
                             f"{moved}, expected fft_planes 3 times and "
                             f"nothing else")
        want = swapped_fft_planes(
            kfft, lambda: kops.fft_causal_conv(x, k, radix=radix))
        if not torch.equal(got, want):
            raise SystemExit(
                f"fft_causal_conv x {xs} taps {K} (n = {n}): kernel and "
                f"plain version differ by "
                f"{float((got - want).abs().max())}")
        held("fft_causal_conv", got[0, :4],
             causal_numpy(x[0, :4].cpu().numpy(), k[0, :4].cpu().numpy()))
        equal.append(f"x {xs} taps {K}: n = {n}, {per} kernel(s) a "
                     f"transform")
        del x, k, got, want
    torch.cuda.synchronize()
    print(f"[fourier ops] realpack_fft, fft2 and its inverse, fft_conv2d "
          f"and fft_causal_conv (radix {radix}) within {FOURIER_OPS_TOL} "
          f"of float64 numpy (atol scaled by n for whole spectra); "
          f"fft_causal_conv through the kernel == with the plain version "
          f"swapped in at {'; '.join(equal)}; worst |op - numpy| {worst}",
          flush=True)
    return worst


# ---------------------------------------------------------------------------
# Phase 3: the serve path
# ---------------------------------------------------------------------------

def serve_phase(serve, engine_mod, build
                ) -> tuple[dict, dict, collections.Counter]:
    """Drive FFTService per serve cell, then one mixed engine; verify every
    result. Returns the batches each route dispatched while serving, and
    the launches each kernel made in the warmups, in all and per schedule
    (``build.SCHEDULES``), for the launch-counter check."""
    expected: dict[str, int] = {}
    warm = dict.fromkeys(TRANSFORM_KERNELS, 0)
    warm_schedules: collections.Counter = collections.Counter()

    def warmup(eng):
        before = dict(build.LAUNCHES)
        before_schedules = collections.Counter(build.SCHEDULES)
        eng.warmup()
        for name in warm:
            warm[name] += build.LAUNCHES[name] - before[name]
        warm_schedules.update(collections.Counter(build.SCHEDULES)
                              - before_schedules)

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
    return expected, warm, warm_schedules


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
    r"(^|::)(fft|rfft|polymul|polymul_complex|polymul_real|ntt_polymul|"
    r"rns_ntt_polymul)(_pass[12]|_mid|_steps)?_kernel\b")


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


def time_ms(torch, fn, arg_sets, reps: int, *, warm=None) -> float:
    """Mean ms of one call, by CUDA events around ``reps`` calls that cycle
    through ``arg_sets`` (together larger than the 50 MB L2, so each call
    finds its inputs in device memory, as a freshly copied batch may),
    after warm calls on ``warm`` (default: the first two sets)."""
    for args in arg_sets[:2] if warm is None else warm:
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


def graph_ms(torch, fn, arg_sets, reps: int) -> float:
    """Mean ms of one call by CUDA events around the replay of a CUDA graph
    that holds ``reps`` calls cycling through ``arg_sets``: the card's time
    for the calls back to back, the host's launch gaps left out (the
    launches are captured once). The best of two replays, after a warm
    one."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    del graph
    torch.cuda.synchronize()
    return best


def device_ms(torch, fn, arg_sets, reps: int, *,
              launches_per_call: int | None = None,
              tries: int = 5, required: bool = True, warm=None
              ) -> tuple[float | None, int]:
    """Mean device time of one call in ms, and the device events traced:
    the summed duration of the kernels the calls ran, traced by
    torch.profiler (CUPTI), without the host's launch gaps. The trace
    drops some device events (traces of 20 launches of one kernel on an
    H100 held 9 to 20 of them), so where the caller knows the kernels a
    call launches (``launches_per_call``) the mean is taken over the
    launches the trace holds; otherwise over the calls made, which a
    dropped event lowers. A
    trace without device time is reported and taken again, up to
    ``tries`` times in all; if none holds any, the run fails, or, where
    the caller times the call by CUDA events and the trace is only a
    side figure (``required=False``), None is returned. The warm calls
    are on ``warm`` (default: the first two sets), as ``time_ms``'s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for args in arg_sets[:2] if warm is None else warm:
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
    if not required:
        return None, 0
    raise SystemExit(f"torch.profiler traced no device time in {tries} "
                     f"tries")


def occupancy(build, kfft, kpoly, name: str, n: int, b: int, plan) -> dict:
    """Launch configuration and CTAs per SM of kernel ``name`` as its
    wrapper launches it for a batch of b rows under ``plan``: under the
    two-pass schedule each launch's, in order (``passes``)."""
    real = name in ("rfft_planes", "irfft_planes", "polymul_real_planes")
    if name in TWO_PASS_KERNELS and planned_two_pass(kfft, kpoly, name, n,
                                                     plan.radix):
        return pass_occupancy(build, kfft, kpoly, name, n, plan.radix)
    product = name.startswith("polymul")
    rows, staged = kfft.cta_rows(n, b, plan.block_b, real=real,
                                 product=product)
    return {"rows_per_cta": rows, "staged": staged, "launches_per_call": 1,
            **build.occupancy(name, n.bit_length() - 1, rows, staged)}


def pass_occupancy(build, kfft, kpoly, name: str, n: int, radix: int
                   ) -> dict:
    """Each launch of ``name``'s two-pass (split-pass) schedule at length
    n, in order, with what the occupancy API reports for it."""
    real, product = _kinds(name)
    tp = planned_two_pass(kfft, kpoly, name, n, radix)
    # (label, sub-problems a CTA holds, their points, and the occupancy
    # query: counter, sub-problems it takes, launch of the schedule)
    if not product:     # the rfft's pass 2 holds each one with its mirror
        launches = [("pass 1", tp.c1, tp.n1, name, tp.c1, 2),
                    ("pass 2", (2 if name == "rfft_planes" else 1) * tp.c2,
                     tp.n2, name, tp.c2, 3)]
    else:
        li2 = n // tp.inverse_n1
        launches = [("F1: forward pass 1", tp.c1, tp.n1, name, tp.c1, 2),
                    ("M: forward pass 2, product" + (
                        ", inverse pass 1" if tp.fused else ""),
                     (4 if real else 2) * tp.cm, tp.n2, name, tp.cm, 3)]
        if not tp.fused:
            launches.append(("I1: inverse pass 1", tp.c1, tp.n1,
                             "fft_planes", tp.c1, 2))
        launches.append(("I2: inverse pass 2", tp.ci, li2, name, tp.ci, 4))
    return passes_entry(build, tp, launches)


def passes_entry(build, tp, launches) -> dict:
    """The occupancy report of a multi-launch call: ``launches`` is (label,
    sub-problems a CTA holds, their points, occupancy counter, sub-problems
    it takes, launch of the schedule) per launch."""
    passes = [{"launch": label, "sub_problems_per_cta": held, "points": m,
               **build.occupancy(counter, m.bit_length() - 1, takes, mode)}
              for label, held, m, counter, takes, mode in launches]
    return {"rows_per_cta": f"{tp.c1} of {tp.n1} points",
            "staged": False, "launches_per_call": len(passes),
            "two_pass": f"{tp.n1} x {tp.n2}", "passes": passes}


def ntt_pass_occupancy(build, tp, name: str = "ntt_polymul") -> dict:
    """Each launch of the split-pass schedule ``tp`` of ``ntt_polymul`` (or
    ``rns_ntt_polymul``, the same launches with the limb as grid row y), in
    order, with what the occupancy API reports for it."""
    return passes_entry(build, tp, [
        ("F1: forward pass 1 of a and b", 2 * tp.c1, tp.n1, name, tp.c1, 2),
        ("M: forward pass 2, product, inverse pass 1", 2 * tp.cm, tp.n2,
         name, tp.cm, 3),
        ("I2: inverse pass 2, untwist", tp.ci, tp.n1, name, tp.ci, 4)])


#: Bytes one launch of a kernel moves for a batch of b rows of n points
#: (each array it reads or writes once; the twiddle tables left out): the
#: launches of the irfft and of the three NTT kernels under their
#: schedules (for the RNS product b counts rows times limbs).
LAUNCH_BYTES = {
    "irfft_kernel": lambda n, b: 8 * b * n,
    "irfft_pass1_kernel": lambda n, b: 16 * n * ((b + 1) // 2),
    "irfft_pass2_kernel": lambda n, b: 16 * n * ((b + 1) // 2),
    "ntt_polymul_kernel": lambda n, b: 12 * b * n,
    "ntt_polymul_pass1_kernel": lambda n, b: 16 * b * n,
    "ntt_polymul_mid_kernel": lambda n, b: 12 * b * n,
    "ntt_polymul_pass2_kernel": lambda n, b: 8 * b * n,
    "rns_ntt_polymul_kernel": lambda n, b: 12 * b * n,
    "rns_ntt_polymul_steps_kernel": lambda n, b: 12 * b * n,
    "ntt_kernel": lambda n, b: 8 * b * n,
    "ntt_pass1_kernel": lambda n, b: 8 * b * n,
    "ntt_pass2_kernel": lambda n, b: 8 * b * n,
}


def add_launch_rates(entry: dict, n: int, b: int) -> None:
    """Bytes and TB/s beside each traced launch of ``LAUNCH_BYTES``."""
    for kernel, v in (entry.get("by_kernel") or {}).items():
        if kernel in LAUNCH_BYTES:
            v["bytes"] = LAUNCH_BYTES[kernel](n, b)
            v["tb_per_s"] = v["bytes"] / (v["ms_per_launch"] * 1e9)


def launch_text(entry: dict) -> str:
    """The launch configuration of a timed kernel, for its report line."""
    def one(e, rows):
        return (f"{rows}, {e['threads']} threads, {e['smem_bytes']} B "
                f"shared, {e['regs']} regs/thread -> {e['ctas_per_sm']} "
                f"CTAs/SM")
    if entry.get("register_steps"):
        return one(entry, "register steps, 1 row and limb/CTA")
    if "passes" not in entry:
        return one(entry, f"{entry['rows_per_cta']} rows/CTA")
    return (f"two-pass {entry['two_pass']}, {entry['launches_per_call']} "
            f"kernel launches per call; " + "; ".join(
                f"{p['launch']}: " + one(p, f"{p['sub_problems_per_cta']} "
                                            f"sub-problems of {p['points']} "
                                            f"points/CTA")
                for p in entry["passes"]))


def by_kernel(torch, fn, arg_sets, reps: int) -> dict[str, dict]:
    """One trace of ``reps`` calls: device ms per launch and launches
    traced, by kernel name (how a multi-launch call's time splits)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.count:
            # "(anonymous namespace)::fft_pass1_kernel(float const*, ...)"
            found = re.search(r"(\w+)\(", e.key)
            name = found.group(1) if found else e.key
            out[name] = {"ms_per_launch": e.self_device_time_total / 1e3
                         / e.count, "launches_traced": e.count}
    return out


#: calls of a plain version each timing of ``measure`` runs (20 for the
#: kernels): the plain NTT and RNS products run hundreds of small torch ops
#: a call, whose traces took minutes to read (cut in PR 26 for run time)
PLAIN_REPS = 5


def spread_sets(sets: list) -> list:
    """PLAIN_REPS of ``sets`` spread evenly over the whole pool, in its
    order, leaving out the first two (which the check and the kernel's
    warm calls read last): each is then in device memory when the plain
    version reads it, as each set is for the kernel, which cycles through
    them all. Sets 0 and 1 only where the pool has no others."""
    rest = sets[2:] or sets
    step = max(1, len(rest) // PLAIN_REPS)
    return rest[::step][:PLAIN_REPS]


def measure(torch, name: str, n: int, kern, plain, sets, lib, lib_sets,
            *, exact: bool, bound: tuple[float, float, str],
            launches_per_call: int = 1, graph: bool = False) -> dict:
    """Hold the kernel against its plain version on ``sets[0]`` (exactly:
    bit for bit, or within phase 2's tolerance), then time kernel, plain
    version and library call (None: no PyTorch call computes the
    function). ``bound`` is (ms for the bytes, ms for the operations, what
    the operations are);
    ``launches_per_call`` the kernel launches one call of the wrapper makes
    (2 under the two-pass schedule, 3 or 4 under the products' split-pass
    one), by which the traced launches are counted into calls, and where
    it is above 1 a trace splits the call's time by kernel (``by_kernel``);
    ``graph`` adds the kernel's CUDA-graph replay time (``graph_ms``)
    beside the others, and the trace by kernel even of a single launch."""
    reps = max(len(sets), 20)
    plain_reps = min(reps, PLAIN_REPS)
    # the plain version's inputs: spread over the pool, its warm call on
    # the set the check has just read
    plain_sets, plain_warm = spread_sets(sets), sets[:1]
    got, want = (torch.cat([t.flatten() for t in _as_tuple(f(*sets[0]))])
                 for f in (kern, plain))
    if not got.is_floating_point():
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        ok = err == 0
    else:
        err = float((got - want).abs().max())
        ok = (torch.equal(got, want) if exact
              else torch.allclose(got, want, **tolerance(name, n)))
    if not ok:
        raise SystemExit(f"{name} n={n}: kernel and plain version differ "
                         f"(max abs difference {err})")
    # wall time per call (CUDA events, host launch gaps included): plain,
    # kernel, kernel, plain within this call; best of two
    plain_ev = time_ms(torch, plain, plain_sets, plain_reps,
                       warm=plain_warm)
    kern_ev = min(time_ms(torch, kern, sets, reps),
                  time_ms(torch, kern, sets, reps))
    plain_ev = min(plain_ev, time_ms(torch, plain, plain_sets, plain_reps,
                                     warm=plain_warm))
    t_bytes, t_ops, ops_kind = bound
    ms, traced = device_ms(torch, kern, sets, reps,
                           launches_per_call=launches_per_call)
    return {"ms": ms,
            "traced_launches": f"{traced} of {reps * launches_per_call}",
            "plain_ms": device_ms(torch, plain, plain_sets, plain_reps,
                                  warm=plain_warm)[0],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "operations_ms": t_ops,
            "operations": ops_kind,
            "library_ms": lib and device_ms(torch, lib, lib_sets, reps)[0],
            "max_abs_err": err, "event_ms": kern_ev,
            "graph_event_ms": graph_ms(torch, kern, sets, reps) if graph
            else None,
            "library_graph_event_ms": graph_ms(torch, lib, lib_sets, reps)
            if graph and lib else None,
            "by_kernel": by_kernel(torch, kern, sets, reps)
            if launches_per_call > 1 or graph else None,
            "plain_event_ms": plain_ev,
            "library_event_ms": lib and time_ms(torch, lib, lib_sets, reps)}


def report_line(name: str, n: int, entry: dict, card: str) -> None:
    lib = entry["library_ms"]
    print(f"[time] {name} n={n} batch={SERVE_BATCH} "
          f"resident={entry['resident']} device ms (profiler): "
          f"kernel={entry['ms']:.4f} (a call's {entry['launches_per_call']} "
          f"launch(es), over the {entry['traced_launches']} launches "
          f"traced) plain={entry['plain_ms']:.4f} "
          f"library={'none' if lib is None else f'{lib:.4f}'} "
          f"[{entry['library']}] bound={entry['bound_ms']:.4f} "
          f"({entry['bound_by']}; bytes {entry['bytes_ms']:.4f}, "
          f"{entry['operations']} {entry['operations_ms']:.4f}); event ms "
          f"per call: kernel={entry['event_ms']:.4f} "
          + ("" if entry.get("graph_event_ms") is None else
             f"(graph replay {entry['graph_event_ms']:.4f}) ")
          + ("" if entry.get("library_graph_event_ms") is None else
             f"library (graph replay "
             f"{entry['library_graph_event_ms']:.4f}) ")
          + f"plain={entry['plain_event_ms']:.4f}; |kernel-plain|max="
          f"{entry['max_abs_err']:.3g}; launch: {launch_text(entry)}"
          + ("" if not entry.get("by_kernel") else "; traced by kernel: "
             + ", ".join(f"{k} {v['ms_per_launch']:.4f} ms/launch "
                         f"({v['launches_traced']} traced"
                         + (f"; {v['bytes']} B, {v['tb_per_s']:.3f} TB/s"
                            if "bytes" in v else "") + ")"
                         for k, v in entry["by_kernel"].items()))
          + f"; on {card}", flush=True)


def timings(torch, kfft, kpoly, core_fft, build, card: str) -> dict:
    """Every float kernel at the serve shapes (batch 64, n = 4096 and
    65536, radix 4 as planned): ``measure`` with its bound, occupancy and,
    for the kernels with a two-pass schedule, the graph-replay time."""
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
                dataclasses.replace(
                    plan_r, resident=kfft.irfft_two_pass_plan(
                        n, plan_r.radix) is None
                    and kfft.resident(n, real=True)),
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
            occ = occupancy(build, kfft, kpoly, name, n, b, plan)
            entry = measure(torch, name, n, kern, plain, ksets, lib, lsets,
                            exact=name in TWO_PASS_KERNELS,
                            bound=(nbytes / HBM_BYTES_PER_S * 1e3,
                                   flops / FP32_FLOPS_PER_S * 1e3,
                                   "fp32 flops"),
                            launches_per_call=occ["launches_per_call"],
                            graph=name in TWO_PASS_KERNELS)
            entry.update(library=lib_name, bytes=nbytes, flops=flops,
                         radix=plan.radix, block_b=plan.block_b,
                         resident=plan.resident, **occ)
            add_launch_rates(entry, n, b)
            out[name][n] = entry
            report_line(name, n, entry, card)
    return out


#: the order of a kernel's schedules in the A/B turns: its single-CTA
#: kernel, the RNS product's register steps, the split
AB_ORDER = {"resident": 0, "staged": 0, "register-step": 1}


def ab_turns(torch, name: str, n: int, fns: dict, launches: dict, sets,
             want, planned: str, card: str) -> dict:
    """One A/B of a kernel's schedules ``fns`` (label -> call) at length n,
    batch 64: each schedule's result must equal the plain version's
    ``want`` bit for bit; then in turns single-CTA, (register-step,)
    two-pass, two-pass, (register-step,) single-CTA the time per call by
    CUDA events around a CUDA-graph replay of the calls (``graph_ms``: the
    card's time, without the host's launch gaps, which at these sizes
    exceed the kernels'), the device time from the profiler (a call's
    launches counted) and the CUDA-event time of calls issued one by one
    (host gaps included). A schedule is faster where each of its turns
    beats each of every other's."""
    order = sorted(fns, key=lambda label: AB_ORDER.get(label, 2))
    for label, fn in fns.items():
        got = fn(*sets[0])
        if not all(torch.equal(g, w) for g, w in
                   zip(_as_tuple(got), _as_tuple(want))):
            raise SystemExit(f"{name} n={n} {label}: not equal to the plain "
                             f"version")
    reps = max(len(sets), 20)
    runs = {label: {"graph_ms": [], "device_ms": [], "event_ms": []}
            for label in order}
    for label in order + order[::-1]:
        runs[label]["graph_ms"].append(graph_ms(torch, fns[label], sets,
                                                reps))
        ms, _ = device_ms(torch, fns[label], sets, reps,
                          launches_per_call=launches[label])
        runs[label]["device_ms"].append(ms)
        runs[label]["event_ms"].append(time_ms(torch, fns[label], sets,
                                               reps))
    best = {label: min(r["graph_ms"]) for label, r in runs.items()}
    # faster: every turn of one schedule below every turn of the others;
    # otherwise the fastest are within the turns' spread
    faster = next((label for label in order if all(
        max(runs[label]["graph_ms"]) < min(runs[other]["graph_ms"])
        for other in order if other != label)),
        "neither (within the turns' spread)")

    def fmt(ts):
        return ", ".join(f"{t:.4f}" for t in ts)

    print(f"[ab] {name} n={n} batch={SERVE_BATCH}, in turns "
          f"{', '.join(order + order[::-1])}: ms per call by CUDA events "
          f"around a CUDA-graph replay "
          + "; ".join(f"{label} ({launches[label]} launch(es)) "
                      f"{fmt(r['graph_ms'])} (profiler device ms "
                      f"{fmt(r['device_ms'])}; event ms with host gaps "
                      f"{fmt(r['event_ms'])})" for label, r in runs.items())
          + f" -> faster on the card: {faster}; the planner serves "
          f"{planned}; on {card}", flush=True)
    return {"runs": runs, "best_graph_ms": best, "faster": faster,
            "planned": planned, "launches_per_call": launches}


#: the A/B lengths of the RNS product (k = 9 limbs, 109-bit Q) and of
#: ntt_batched: where the thresholds of ``kernels.fft.TWO_PASS_FROM`` and
#: ``REGISTER_STEPS_FROM`` could fall, and 65536, where the single-CTA
#: kernel (staged) is timed beside the split
RNS_AB_NS = (16, 32, 4096, 8192, 16384, 65536)
NTT_AB_NS = (1024, 2048, 4096, 8192, 65536)


def schedule_ab(torch, kfft, kpoly, kntt, ntt_core, card: str) -> dict:
    """The kernels with several schedules, batch 64, under each
    (``ab_turns``): at n = 4096 and 8192 the float ones (the fft forward,
    the rfft, the irfft, both products) at radix 4, the planner's -- the
    single-CTA schedule (resident; for the products staged at 8192)
    against the two-pass one (split-pass for the products) -- and the NTT
    product (negacyclic, radix 2), resident against split-pass; at
    ``RNS_AB_NS`` the RNS product (negacyclic, k = 9), single-CTA, register
    steps (where two rows fit a CTA) and split-pass; at ``NTT_AB_NS``
    ntt_batched, forward and inverse, single-CTA against two passes. The
    planner's thresholds (``kernels.fft.TWO_PASS_FROM`` and
    ``REGISTER_STEPS_FROM``) are set from the graph times of such a run: a
    schedule only where it is faster."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    out: dict[str, dict] = {}
    plains = {"fft_planes": kfft.fft_planes_plain,
              "rfft_planes": kfft.rfft_planes_plain,
              "irfft_planes": kfft.irfft_planes_plain,
              "polymul_complex_planes": kpoly.polymul_complex_planes_plain,
              "polymul_real_planes": kpoly.polymul_real_planes_plain}
    planes = {"fft_planes": 2, "rfft_planes": 1, "irfft_planes": 2,
              "polymul_complex_planes": 4, "polymul_real_planes": 2}
    b = SERVE_BATCH
    for name in TWO_PASS_KERNELS:
        plain = functools.partial(plains[name], radix=4)
        out[name] = {}
        for n in BOTH_SCHEDULES_NS:
            k = planes[name]
            cols = n // 2 if name == "irfft_planes" else n
            sets = [[torch.from_numpy(rng.standard_normal((b, cols)).astype(
                np.float32)).to(dev) for _ in range(k)]
                for _ in range(max(2, math.ceil(128e6 / (k * b * cols * 4))))]
            scheds = schedules(kfft, kpoly, name, n, 4)
            fns = {label: launch_under(kfft, kpoly, name, sched, 4)
                   for label, sched in scheds.items()}
            launches = {label: 1 if sched is None else sched.launches
                        for label, sched in scheds.items()}
            out[name][n] = ab_turns(torch, name, n, fns, launches, sets,
                                    plain(*sets[0]), next(iter(scheds)),
                                    card)
    out["ntt_polymul"] = {}
    for n in BOTH_SCHEDULES_NS:
        p = ntt_core.NTTParams.make(n)
        sets = [[torch.from_numpy(rng.integers(0, p.q, (b, n)).astype(
            np.uint32)).to(dev) for _ in range(2)]
            for _ in range(max(2, math.ceil(128e6 / (2 * b * n * 4))))]
        scheds = ntt_schedules(kntt, kfft, n)
        fns = {label: ntt_launch_under(kntt, sched, p, True)
               for label, sched in scheds.items()}
        launches = {label: 1 if sched is None else sched.launches
                    for label, sched in scheds.items()}
        out["ntt_polymul"][n] = ab_turns(
            torch, "ntt_polymul", n, fns, launches, sets,
            kntt.ntt_polymul_plain(*sets[0], p), next(iter(scheds)), card)
    out["rns_ntt_polymul"] = {}
    for n in RNS_AB_NS:
        r = ntt_core.RNSParams.make(n, modulus_bits=RNS_BITS)
        sets = [[torch.from_numpy(np.stack(
            [rng.integers(0, q, (b, n)) for q in r.qs]).astype(
                np.uint32)).to(dev) for _ in range(2)]
            for _ in range(max(2, math.ceil(128e6 / (2 * r.k * b * n * 4))))]
        scheds = rns_schedules(kntt, kfft, n, every=True)
        fns = {label: rns_launch_under(kntt, sched, r, True)
               for label, sched in scheds.items()}
        launches = {label: 1 if sched is None else sched.launches
                    for label, sched in scheds.items()}
        out["rns_ntt_polymul"][n] = ab_turns(
            torch, "rns_ntt_polymul", n, fns, launches, sets,
            kntt.rns_ntt_polymul_plain(*sets[0], r), next(iter(scheds)),
            card)
    out["ntt_batched"] = {}
    for n in NTT_AB_NS:
        p = ntt_core.NTTParams.make(n)
        sets = [[torch.from_numpy(rng.integers(0, p.q, (b, n)).astype(
            np.uint32)).to(dev)]
            for _ in range(max(2, math.ceil(128e6 / (b * n * 4))))]
        scheds = ntt_batched_schedules(kntt, kfft, n, every=True)
        out["ntt_batched"][n] = {}
        for inverse in (False, True):
            fns = {label: ntt_batched_launch_under(kntt, sched, p, inverse)
                   for label, sched in scheds.items()}
            launches = {label: 1 if sched is None else sched.launches
                        for label, sched in scheds.items()}
            key = "inverse" if inverse else "forward"
            out["ntt_batched"][n][key] = ab_turns(
                torch, f"ntt_batched ({key})", n, fns, launches, sets,
                kntt.ntt_batched_plain(sets[0][0], p, inverse=inverse),
                next(iter(scheds)), card)
    return out


def ntt_occupancy(build, kntt, name: str, n: int, b: int, block: int
                  ) -> dict:
    """Launch configuration and CTAs per SM of NTT kernel ``name`` as its
    wrapper launches it at length n, batch b, under the planned schedule:
    each launch of a split, the register-step kernel, or one CTA per
    ``block`` rows at most."""
    lg = n.bit_length() - 1
    if name == "ntt_batched":
        tp = kntt.ntt_batched_two_pass_plan(n)
        if tp is not None:
            return passes_entry(build, tp, [
                ("pass 1", tp.c1, tp.n1, name, tp.c1, 2),
                ("pass 2, bins in natural order", tp.c2, tp.n2, name, tp.c2,
                 3)])
    else:
        tp = (kntt.rns_schedule(n) if name == "rns_ntt_polymul"
              else kntt.ntt_two_pass_plan(n))
        if isinstance(tp, kntt.NTTTwoPass):
            return ntt_pass_occupancy(build, tp, name)
        if isinstance(tp, kntt.RNSRegisterSteps):
            return {"rows_per_cta": 1, "register_steps": True,
                    "staged": False, "launches_per_call": 1,
                    **build.occupancy(name, lg, 1, 5)}
    rows, staged = kntt.ntt_cta_rows(n, b, block,
                                     product=name != "ntt_batched")
    return {"rows_per_cta": rows, "staged": staged, "launches_per_call": 1,
            **build.occupancy(name, lg, rows, staged)}


def ntt_timings(torch, kntt, ntt_core, core_fft, build, card: str) -> dict:
    """The three NTT kernels at the serve lengths, batch 64, on uint32
    words as the serve path stages them, each under its planned schedule:
    ntt_polymul and ntt_batched at n = 4096 and 65536, rns_ntt_polymul at
    the RNS cell (n = 4096, k = 9 at 109-bit Q) and at n = 65536 (k = 9).
    No PyTorch call computes an NTT mod q, so there is no library time.
    Each also gets its CUDA-graph replay time and each launch's traced
    time, bytes, TB/s and occupancy."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    out: dict[str, dict] = {name: {} for name in NTT_KERNELS}
    b = SERVE_BATCH
    shapes = [(name, n) for name in ("ntt_polymul", "ntt_batched",
                                     "rns_ntt_polymul") for n in SERVE_NS]
    for name, n in shapes:
        plan = core_fft.plan(n, b, exact=True,
                             rns=name == "rns_ntt_polymul")
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
                    resident=kntt.ntt_batched_two_pass_plan(n) is None
                    and kntt.ntt_resident(n, product=False))
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
        occ = ntt_occupancy(build, kntt, name, n, b, plan.block_b)
        entry = measure(torch, name, n, kern, plain, sets, None, None,
                        exact=True,
                        bound=(nbytes / HBM_BYTES_PER_S * 1e3,
                               ops / INT32_OPS_PER_S * 1e3,
                               "int32 operations"),
                        launches_per_call=occ["launches_per_call"],
                        graph=True)
        entry.update(library="none: no PyTorch call computes an NTT mod q",
                     bytes=nbytes, int32_ops=ops, limbs=k,
                     block_b=plan.block_b, resident=plan.resident, **occ)
        add_launch_rates(entry, n, b * k)
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
    ("S = 1", 2, 1, 16, 8, 128, "bfloat16", 1 << 30, True),
    ("S < 64", 3, 37, 16, 8, 128, "bfloat16", 1 << 30, True),
    ("hd 64", 2, 1024, 24, 8, 64, "bfloat16", 1 << 30, True),
    ("hd 64 ragged S window 24", 2, 333, 24, 8, 64, "bfloat16", 24, True),
    ("hd 64 non-causal S < 64", 2, 50, 8, 2, 64, "bfloat16", 1 << 30, False),
    ("hd 32", 2, 500, 8, 4, 32, "bfloat16", 1 << 30, True),
    ("hd 320", 2, 1024, 8, 4, 320, "bfloat16", 1024, True),
    ("hd 320 ragged S window 24", 2, 333, 8, 4, 320, "bfloat16", 24, True),
    ("gemma3-4b local", 2, LM_PROMPT, 8, 4, 320, "bfloat16", 1024, True),
    ("gemma3-4b global", 2, LM_PROMPT, 8, 4, 320, "bfloat16", 1 << 30,
     True),
    ("fp32 ragged S", 2, 1000, 16, 8, 128, "float32", 1 << 30, True),
    ("fp32 served", LM_BATCH, LM_PROMPT, 16, 8, 128, "float32", 1 << 30,
     True),
    ("fp32 window 24", 2, LM_PROMPT, 16, 8, 128, "float32", 24, True),
    ("fp32 non-causal", 2, 1024, 16, 8, 128, "float32", 1 << 30, False),
    ("fp32 S = 1", 2, 1, 16, 8, 128, "float32", 1 << 30, True),
    ("fp32 S < 64", 3, 37, 16, 8, 128, "float32", 1 << 30, True),
    ("fp32 G = 1", 2, 1024, 8, 8, 128, "float32", 1 << 30, True),
    ("fp32 hd 64", 2, 1024, 24, 8, 64, "float32", 1 << 30, True),
    ("fp32 hd 64 ragged S window 24", 2, 333, 24, 8, 64, "float32", 24,
     True),
    ("fp32 hd 64 non-causal S < 64", 2, 50, 8, 2, 64, "float32", 1 << 30,
     False),
    ("fp32 hd 320 window 24", 1, 300, 8, 4, 320, "float32", 24, True),
    # the reduced configs' head_dim in bf16 (the wgmma kernel's hd-32
    # instance) and gemma3-4b's in fp32 (the tf32 kernel's split instance)
    ("hd 32 served heads", LM_BATCH, LM_PROMPT, 16, 8, 32, "bfloat16",
     1 << 30, True),
    ("hd 32 window 24", 2, LM_PROMPT, 16, 8, 32, "bfloat16", 24, True),
    ("hd 32 non-causal", 2, 1024, 16, 8, 32, "bfloat16", 1 << 30, False),
    ("hd 32 ragged S", 2, 1000, 16, 8, 32, "bfloat16", 1 << 30, True),
    ("hd 32 S = 1", 2, 1, 16, 8, 32, "bfloat16", 1 << 30, True),
    ("hd 32 S < 64", 3, 37, 16, 8, 32, "bfloat16", 1 << 30, True),
    ("hd 32 G = 1", 2, 1024, 8, 8, 32, "bfloat16", 1 << 30, True),
    ("fp32 hd 320 ragged S", 2, 1000, 8, 4, 320, "float32", 1 << 30, True),
    ("fp32 hd 320 non-causal", 2, 1024, 8, 4, 320, "float32", 1 << 30,
     False),
    ("fp32 hd 320 S = 1", 2, 1, 8, 4, 320, "float32", 1 << 30, True),
    ("fp32 hd 320 S < 64", 3, 37, 8, 4, 320, "float32", 1 << 30, True),
    ("fp32 hd 320 G = 1", 2, 1024, 4, 4, 320, "float32", 1 << 30, True),
    ("fp32 gemma3-4b local", 2, LM_PROMPT, 8, 4, 320, "float32", 1024,
     True),
    ("fp32 gemma3-4b global", 2, LM_PROMPT, 8, 4, 320, "float32", 1 << 30,
     True),
    # the reduced configs' head_dim in fp32: the tf32 kernel's hd-32
    # instance at bf16 hd 32's cases
    ("fp32 hd 32", 2, 1000, 16, 8, 32, "float32", 1 << 30, True),
    ("fp32 hd 32 served heads", LM_BATCH, LM_PROMPT, 16, 8, 32, "float32",
     1 << 30, True),
    ("fp32 hd 32 window 24", 2, LM_PROMPT, 16, 8, 32, "float32", 24, True),
    ("fp32 hd 32 non-causal", 2, 1024, 16, 8, 32, "float32", 1 << 30,
     False),
    ("fp32 hd 32 ragged S", 2, 1000, 16, 8, 32, "float32", 1 << 30, True),
    ("fp32 hd 32 S = 1", 2, 1, 16, 8, 32, "float32", 1 << 30, True),
    ("fp32 hd 32 S < 64", 3, 37, 16, 8, 32, "float32", 1 << 30, True),
    ("fp32 hd 32 G = 1", 2, 1024, 8, 8, 32, "float32", 1 << 30, True),
    # hymba-1.5b's heads (25 over 5 kv heads: G = 5, H odd; hd 64; window
    # 2048) at its served batch and prompt, and past the window; and
    # mixtral-8x22b's (48 over 8: G = 6; hd 128; window 4096), past it
    ("hymba-1.5b served", LM_BATCH, LM_PROMPT, 25, 5, 64, "bfloat16", 2048,
     True),
    ("hymba-1.5b past the window", 1, 2304, 25, 5, 64, "bfloat16", 2048,
     True),
    ("mixtral-8x22b past the window", 1, 4224, 48, 8, 128, "bfloat16",
     4096, True),
    ("fp32 hymba-1.5b", 2, LM_PROMPT, 25, 5, 64, "float32", 2048, True),
    ("fp32 hymba-1.5b past the window", 1, 2304, 25, 5, 64, "float32",
     2048, True),
    ("fp32 mixtral-8x22b past the window", 1, 4224, 48, 8, 128, "float32",
     4096, True),
    # the shapes phase 3's main path launches the kernels with: the served
    # bf16 prefills of granite-moe-3b (24 over 8, hd 64) and mixtral-8x22b
    # (48 over 8, hd 128, window 4096 > S); the fp32 card-vs-CPU prefills
    # (MIXER_CPU) and the parity runs' prefills (S) and forwards (S + 1)
    # (MIXER_PARITY)
    ("granite-moe-3b served", LM_BATCH, LM_PROMPT, 24, 8, 64, "bfloat16",
     1 << 30, True),
    ("mixtral-8x22b served", LM_BATCH, LM_PROMPT, 48, 8, 128, "bfloat16",
     4096, True),
    ("fp32 granite-moe-3b card vs CPU", 1, 128, 24, 8, 64, "float32",
     1 << 30, True),
    ("fp32 hymba-1.5b card vs CPU", 1, 128, 25, 5, 64, "float32", 2048,
     True),
    ("fp32 granite-moe-3b parity prefill", 2, 512, 24, 8, 64, "float32",
     1 << 30, True),
    ("fp32 granite-moe-3b parity forward", 2, 513, 24, 8, 64, "float32",
     1 << 30, True),
    ("fp32 hymba-1.5b parity prefill", 1, 2048, 25, 5, 64, "float32", 2048,
     True),
    ("fp32 hymba-1.5b parity forward", 1, 2049, 25, 5, 64, "float32", 2048,
     True),
    ("fp32 mixtral-8x22b parity prefill", 2, 512, 48, 8, 128, "float32",
     4096, True),
    ("fp32 mixtral-8x22b parity forward", 2, 513, 48, 8, 128, "float32",
     4096, True),
    # the heads of REST_ARCHS (phase 3's rest_phase), at the served batch
    # and prompt in bf16 (llama3-405b at B 2) and at B 2 in fp32:
    # musicgen-medium's MHA (24 over 24: G = 1 at hd 64), starcoder2-15b's
    # (48 over 4: G = 12), qwen2-vl-72b's (64 over 8: G = 8) and
    # llama3-405b's (128 over 8: G = 16), hd 128
    ("musicgen-medium served", LM_BATCH, LM_PROMPT, 24, 24, 64, "bfloat16",
     1 << 30, True),
    ("starcoder2-15b served", LM_BATCH, LM_PROMPT, 48, 4, 128, "bfloat16",
     1 << 30, True),
    ("qwen2-vl-72b served", LM_BATCH, LM_PROMPT, 64, 8, 128, "bfloat16",
     1 << 30, True),
    ("llama3-405b served heads", 2, LM_PROMPT, 128, 8, 128, "bfloat16",
     1 << 30, True),
    ("fp32 musicgen-medium", 2, LM_PROMPT, 24, 24, 64, "float32", 1 << 30,
     True),
    ("fp32 starcoder2-15b", 2, LM_PROMPT, 48, 4, 128, "float32", 1 << 30,
     True),
    ("fp32 qwen2-vl-72b", 2, LM_PROMPT, 64, 8, 128, "float32", 1 << 30,
     True),
    ("fp32 llama3-405b", 2, LM_PROMPT, 128, 8, 128, "float32", 1 << 30,
     True),
]
#: the CUDA-core kernel launched directly on inputs the wrappers send to a
#: tensor-core kernel, against its own plain version: (label, B, S, H, KV,
#: hd, dtype, window); fp32 hd 32 first, the case it served until the tf32
#: kernel's hd-32 instance took it
CUDA_CORE_DIRECT = [
    ("fp32 hd 32 (the tf32 kernel's)", 2, 1000, 16, 8, 32, "float32",
     1 << 30),
    ("fp32 hd 32 window 24", 2, 700, 16, 8, 32, "float32", 24),
    ("fp32 hd 128 (the tf32 kernel's)", 2, 1000, 16, 8, 128, "float32",
     1 << 30),
    ("fp32 hd 128 window 24", 2, 700, 16, 8, 128, "float32", 24),
    ("fp32 hd 320 (the tf32 kernel's)", 2, 1000, 8, 4, 320, "float32",
     1 << 30),
    ("bf16 hd 32 (the wgmma kernel's)", 2, 1000, 16, 8, 32, "bfloat16",
     1 << 30),
    ("bf16 hd 32 window 24", 2, 700, 16, 8, 32, "bfloat16", 24)]


def attention_inputs(torch, B, S, H, KV, hd, dtype, seed):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn(B, S, H, hd, device=dev, generator=g).to(dt)
    k, v = (torch.randn(B, S, KV, hd, device=dev, generator=g).to(dt)
            for _ in range(2))
    return q, k, v


def flash_counter(kattn, dtype, hd: int) -> str:
    """The launch counter of the kernel that (dtype, hd) dispatches to."""
    return kattn.LAUNCHERS[kattn.kernel_for(dtype, hd)]


def check_attention(torch, kattn, build) -> dict[str, float]:
    """Each flash kernel against its plain version (key blocks of the
    kernel's tile; p split in two bf16 parts for the wgmma kernel, both
    products as three TF32 products for the tf32 kernel) on every case of
    ATTN_CASES, each case launching the kernel its (dtype, hd) dispatches
    to once and the others never; the CUDA-core kernel launched directly
    on CUDA_CORE_DIRECT against the plain version of its own dataflow; and
    the public (H, S, hd) layout against the naive oracle too. Returns the
    worst |kernel - plain| per kernel."""
    worst = dict.fromkeys(FLASH_KERNELS, 0.0)
    for i, (label, B, S, H, KV, hd, dtype, window, causal) in \
            enumerate(ATTN_CASES):
        q, k, v = attention_inputs(torch, B, S, H, KV, hd, dtype, i)
        kw = dict(window=window, causal=causal, scale=hd ** -0.5)
        name = flash_counter(kattn, q.dtype, hd)
        before = dict(build.LAUNCHES)
        got = kattn.attention(q, k, v, **kw).float()
        torch.cuda.synchronize()
        moved = {n: build.LAUNCHES[n] - before[n] for n in FLASH_KERNELS}
        if moved != {n: int(n == name) for n in FLASH_KERNELS}:
            raise SystemExit(f"flash_attention {label}: launches {moved}, "
                             f"expected one of {name} alone")
        want = kattn.attention_plain(q, k, v, **kw).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, **ATTN_TOL[dtype]):
            raise SystemExit(f"{name} {label} (B={B} S={S} H={H} "
                             f"KV={KV} hd={hd} {dtype} window={window} "
                             f"causal={causal}): kernel and plain version "
                             f"differ, max |diff| {err}")
        worst[name] = max(worst[name], err)
        print(f"[attention] {label}: B={B} S={S} H={H} KV={KV} hd={hd} "
              f"{dtype} window={window} causal={causal} -> {name} "
              f"|kernel-plain|max={err:.3g} within {ATTN_TOL[dtype]}",
              flush=True)
    for label, B, S, H, KV, hd, dtype, window in CUDA_CORE_DIRECT:
        q, k, v = attention_inputs(torch, B, S, H, KV, hd, dtype, 7 + S)
        got = cuda_core_on(torch, build, q, k, v, hd ** -0.5, window).float()
        want = kattn.attention_plain(q, k, v, window=window, scale=hd ** -0.5,
                                     kernel="cuda_core").float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, **ATTN_TOL[dtype]):
            raise SystemExit(f"flash_attention launched directly on {label}: "
                             f"kernel and plain version differ by {err}")
        worst["flash_attention"] = max(worst["flash_attention"], err)
        print(f"[attention] {label}, CUDA-core kernel launched directly: "
              f"B={B} S={S} H={H} KV={KV} hd={hd} {dtype} window={window} "
              f"|kernel-plain|max={err:.3g} within {ATTN_TOL[dtype]}",
              flush=True)
    q, k, v = (x[0].transpose(0, 1) for x in attention_inputs(
        torch, 1, 500, 6, 6, 64, "float32", 99))
    got = kattn.flash_attention(q, k, v, window=100)
    for want in (kattn.flash_attention_plain(q, k, v, window=100),
                 kattn.attention_ref(q, k, v, window=100)):
        if not torch.allclose(got, want, **ATTN_TOL["float32"]):
            raise SystemExit("flash_attention (H, S, hd) layout differs "
                             "from its plain version or the oracle")
    q, k, v = (x[0].transpose(0, 1) for x in attention_inputs(
        torch, 1, 500, 6, 6, 128, "bfloat16", 98))
    got = kattn.flash_attention(q, k, v, window=100)
    for want in (kattn.flash_attention_plain(q, k, v, window=100),
                 kattn.attention_ref(q, k, v, window=100)):
        if not torch.allclose(got.float(), want.float(),
                              **ATTN_TOL["bfloat16"]):
            raise SystemExit("flash_attention (H, S, hd) layout bf16 hd 128 "
                             "differs from its plain version or the oracle")
    print("[attention] public (H, S, hd) layout, S=500 window=100: fp32 "
          "hd 64 (the tf32 kernel) == plain and naive oracle within 2e-4, "
          "bf16 hd 128 within one bf16 step", flush=True)
    torch.cuda.synchronize()
    return worst


def full_width_state(torch, convert, cfg):
    """The arch's weights drawn on the card from seed 0, as the serve CLI
    draws them (fp32, the parameter type)."""
    return convert.init_params(
        cfg, torch.Generator(device=torch.device("cuda")).manual_seed(0))


def serve_lm(torch, build, serve, get_config, arch: str,
             counter: str | None = "flash_attention_wgmma",
             per_layer: int = 1, layers: int | None = None) -> dict:
    """The serve CLI's ``--service lm`` for ``arch`` at full width (batch 8,
    prompt 2048, gen 32; ``layers``: a cut of depth, ``--layers``), the
    launch counters zeroed just before: ``per_layer`` launches of
    ``counter`` per layer (one prefill: the wgmma flash kernel once, or for
    fourierpim-lm fft_planes three times; ``counter`` None: rwkv6-7b, no
    kernel of the port) and nothing else, and LM_GEN tokens in the
    vocabulary for each prompt."""
    build.reset_launches()
    t0 = time.perf_counter()
    res = serve.main(["--service", "lm", "--arch", arch, "--batch",
                      str(LM_BATCH), "--prompt-len", str(LM_PROMPT), "--gen",
                      str(LM_GEN)]
                     + ([] if layers is None else ["--layers", str(layers)]))
    wall = time.perf_counter() - t0
    torch.cuda.empty_cache()
    launches = dict(build.LAUNCHES)
    cfg = get_config(arch)
    L = layers or cfg.num_layers
    gen = res["generated"]
    want = {counter: per_layer * L} if counter else {}
    if {k: n for k, n in launches.items() if n} != want:
        raise SystemExit(f"served {arch} run: launches {launches}, "
                         f"expected {want or 'none'} ({per_layer} per "
                         f"layer, one prefill) and nothing else")
    if gen.shape != (LM_GEN, LM_BATCH) or not (
            (gen >= 0) & (gen < cfg.vocab_size)).all():
        raise SystemExit(f"served {arch} run: generated {gen.shape} "
                         f"{gen.min()}..{gen.max()}")
    shape = (f"{cfg.fourier_taps} taps" if cfg.mixer == "fourier"
             else "no attention" if cfg.mixer == "rwkv6"
             else f"head_dim {cfg.head_dim}")
    depth = (f"{L} layers" if layers is None
             else f"{L} of {cfg.num_layers} layers: a cut of depth")
    print(f"[lm] served {arch} (full width, {depth}, {shape}, bf16) "
          f"batch={LM_BATCH} "
          f"prompt={LM_PROMPT} gen={LM_GEN}: generated {gen.shape}, "
          f"{res['tokens_per_s']:.1f} tok/s (first call, incl. prefill) in "
          f"{wall:.1f}s with set-up; launches {launches}", flush=True)
    return {"launches": launches, "tokens_per_s": res["tokens_per_s"],
            "layers": L}


def lm_phase(torch, build, serve, convert, lm, get_config) -> dict:
    """Phase 3 for qwen3-1.7b: (1) the served run (``serve_lm``): 28
    launches of the wgmma kernel and nothing else; (2) prefill/decode
    parity at full width in fp32, the 3xTF32 kernel's path, counters
    zeroed just before: one forward and one prefill, 2 x 28 launches of
    that kernel and nothing else; (3) the same 2-layer full-width weights
    on the card and on the CPU. Returns what the report needs."""
    dev = torch.device("cuda")
    served = serve_lm(torch, build, serve, get_config, LM_ARCH)
    launches = served["launches"]
    cfg = get_config(LM_ARCH)

    # (2) parity at full width, fp32 activations: the 3xTF32 kernel
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    sd = full_width_state(torch, convert, cfg)
    model = convert.build(cfg32, sd, dev)
    del sd
    B, S = 2, 512
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    build.reset_launches()
    full = model(tokens)
    last, state = model.prefill(tokens[:, :S], cache_capacity=S + 1)
    step, _ = model.decode_step(state, tokens[:, S], S)
    torch.cuda.synchronize()
    fp32_launches = dict(build.LAUNCHES)
    if fp32_launches["flash_attention_tf32"] != 2 * cfg.num_layers or any(
            n for k, n in fp32_launches.items()
            if k != "flash_attention_tf32"):
        raise SystemExit(f"fp32 parity path: launches {fp32_launches}, "
                         f"expected flash_attention_tf32 "
                         f"{2 * cfg.num_layers} times (one forward, one "
                         f"prefill) and nothing else")
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
          f"within {LM_TOL}; launches {fp32_launches}", flush=True)
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
    return {"launches": {"flash_attention_wgmma":
                         launches["flash_attention_wgmma"],
                         "flash_attention_tf32":
                         fp32_launches["flash_attention_tf32"]},
            "first_call_tokens_per_s": served["tokens_per_s"],
            "parity_max_abs": errs, "card_vs_cpu_max_abs": err}


def plain_attention(kattn):
    """``kernels.attention.attention`` with the plain version in place of
    the kernel on the card, folded at the kernel's own key tile (the
    layer's ``kv_block`` is the CPU path's)."""
    def attention(q, k, v, *, window, causal=True, scale, kv_block=None):
        del kv_block
        return kattn.attention_plain(q, k, v, window=window, causal=causal,
                                     scale=scale)
    return attention


def prefill_vs_plain(torch, build, convert, kattn, cfg, counter: str,
                     tol: dict, prompt: int = LM_PROMPT) -> tuple[float, int]:
    """A prefill of ``cfg`` (seed-0 weights, batch GEMMA_PARITY_BATCH,
    ``prompt`` tokens, the served prompt, or embeddings and M-RoPE
    positions: ``lm_inputs``), counters zeroed just before:
    once through the kernel (one launch of ``counter`` per layer, nothing
    else) and once with ``plain_attention`` swapped in for
    ``kernels.attention.attention`` (no launch); the last logits finite, of
    the vocabulary's width, and within ``tol`` of each other. Returns the
    largest difference and the launches of ``counter``."""
    dev = torch.device("cuda")
    model = convert.build(cfg, full_width_state(torch, convert, cfg), dev)
    inputs = lm_inputs(torch, cfg, GEMMA_PARITY_BATCH, prompt, dev, seed=5)
    torch.cuda.synchronize()
    build.reset_launches()
    with_kernel, _ = model.prefill(**inputs)
    torch.cuda.synchronize()
    kernel_launches = dict(build.LAUNCHES)
    kernel = kattn.attention
    kattn.attention = plain_attention(kattn)
    try:
        with_plain, _ = model.prefill(**inputs)
        torch.cuda.synchronize()
    finally:
        kattn.attention = kernel
    plain_launches = {k: n - kernel_launches[k]
                      for k, n in build.LAUNCHES.items()}
    want = {k: cfg.num_layers * (k == counter) for k in build.LAUNCHES}
    name = f"{cfg.name} {cfg.num_layers}-layer {cfg.dtype} prefill"
    if kernel_launches != want or any(plain_launches.values()):
        raise SystemExit(f"{name}: launches {kernel_launches} with the "
                         f"kernel, {plain_launches} with the plain version "
                         f"swapped in; expected {want} and none")
    got, ref = with_kernel.float(), with_plain.float()
    err = float((got - ref).abs().max())
    if got.shape != (GEMMA_PARITY_BATCH, cfg.vocab_padded) or not (
            torch.isfinite(got).all() and torch.isfinite(ref).all()
            and torch.allclose(got, ref, **tol)):
        raise SystemExit(f"{name}: kernel and plain version's last logits "
                         f"{got.shape} differ by {err}")
    print(f"[lm] {cfg.name} (d_model {cfg.d_model}, head_dim "
          f"{cfg.head_dim}), {cfg.num_layers} layers (windows "
          f"{[lm_window(cfg, i) for i in range(cfg.num_layers)]}), "
          f"{cfg.dtype}, B={GEMMA_PARITY_BATCH} S={prompt}: prefill last "
          f"logits with {counter} vs the plain version swapped in "
          f"|diff|max={err:.3g} within {tol} (|logit|max "
          f"{float(ref.abs().max()):.3g}); launches {kernel_launches}",
          flush=True)
    del model
    torch.cuda.empty_cache()
    return err, kernel_launches[counter]


def gemma_phase(torch, build, serve, convert, kattn, get_config) -> dict:
    """Phase 3 for gemma3-4b: (1) the served run (``serve_lm``): 34
    launches of the wgmma kernel (its hd-320 instance) and nothing else;
    (2) ``prefill_vs_plain`` on GEMMA_PARITY_LAYERS layers (five local,
    window 1024, then the global layer 5) in bf16, through the wgmma
    kernel, within GEMMA_PARITY_TOL; (3) the same in fp32, the tf32
    kernel's head_dim-split instance (one launch per layer, nothing else),
    within LM_TOL."""
    served = serve_lm(torch, build, serve, get_config, GEMMA_ARCH)
    cfg = dataclasses.replace(get_config(GEMMA_ARCH),
                              num_layers=GEMMA_PARITY_LAYERS)
    err, _ = prefill_vs_plain(torch, build, convert, kattn, cfg,
                              "flash_attention_wgmma", GEMMA_PARITY_TOL)
    err32, tf32_launches = prefill_vs_plain(
        torch, build, convert, kattn,
        dataclasses.replace(cfg, dtype="float32"), "flash_attention_tf32",
        LM_TOL)
    return {"launches": served["launches"]["flash_attention_wgmma"],
            "first_call_tokens_per_s": served["tokens_per_s"],
            "parity_layers": GEMMA_PARITY_LAYERS,
            "kernel_vs_plain_last_logits_max_abs": err,
            "fp32_tf32_launches": tf32_launches,
            "fp32_kernel_vs_plain_last_logits_max_abs": err32}


def reduced_phase(torch, build, convert, kattn, get_config) -> dict:
    """Phase 3 for the reduced configs (``ModelConfig.scaled_down`` of
    qwen3-1.7b: 2 layers, 4 heads over 4 kv heads, head_dim 32):
    ``prefill_vs_plain`` at batch GEMMA_PARITY_BATCH x REDUCED_PROMPT, in
    bf16 (the wgmma kernel's hd-32 instance, one launch per layer, nothing
    else; within GEMMA_PARITY_TOL) and in fp32 (the tf32 kernel's hd-32
    instance, likewise; within LM_TOL)."""
    cfg = get_config(LM_ARCH).scaled_down()
    out = {}
    for dtype, counter, tol in (("bfloat16", "flash_attention_wgmma",
                                 GEMMA_PARITY_TOL),
                                ("float32", "flash_attention_tf32", LM_TOL)):
        err, launched = prefill_vs_plain(
            torch, build, convert, kattn,
            dataclasses.replace(cfg, dtype=dtype), counter, tol,
            prompt=REDUCED_PROMPT)
        out[dtype] = {"launches": launched, "counter": counter,
                      "kernel_vs_plain_last_logits_max_abs": err}
    return out


def lm_window(cfg, i: int) -> str:
    """Layer i's attention window, as printed."""
    return "global" if cfg.layer_is_global(i) else str(cfg.window)


#: fourierpim-lm's checks beside its served run: the card against the CPU
#: (layers, batch, prompt), fp32; and a prefill at n = 16384, the two-pass
#: schedule, through the kernel against the plain version, bf16
FOURIER_ARCH = "fourierpim-lm"
FOURIER_PARITY = (2, 1, 512)
FOURIER_LONG = (2, 2, 8192)


def fourier_phase(torch, build, serve, convert, kfft, kops, get_config,
                  radix: int) -> dict:
    """Phase 3 for fourierpim-lm: (1) the served run (``serve_lm``):
    fft_planes three times a layer (one prefill) and nothing else; (2) the
    same FOURIER_PARITY full-width fp32 weights on the card and on the CPU
    (plain versions): the prefill's last logits and one decode step within
    LM_TOL, the card's prefill launching fft_planes three times a layer and
    the CPU's nothing; (3) a FOURIER_LONG full-width bf16 prefill (n =
    16384, two kernels a transform) through the kernel and again with
    ``plain_fft_planes`` swapped in (no launch): last logits equal."""
    dev = torch.device("cuda")
    served = serve_lm(torch, build, serve, get_config, FOURIER_ARCH,
                      counter="fft_planes", per_layer=3)
    cfg = get_config(FOURIER_ARCH)

    # (2) the card against the CPU, fp32
    layers, B, S = FOURIER_PARITY
    cfg32 = dataclasses.replace(cfg, num_layers=layers, dtype="float32")
    sd = convert.init_params(cfg32, torch.Generator().manual_seed(3))
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1),
                           generator=torch.Generator().manual_seed(4))
    outs = {}
    for where, place in (("cpu", torch.device("cpu")), ("cuda", dev)):
        model = convert.build(cfg32, sd, place)
        t = tokens.to(place)
        torch.cuda.synchronize()
        build.reset_launches()
        last, state = model.prefill(t[:, :S], cache_capacity=S + 1)
        step, _ = model.decode_step(state, t[:, S], S)
        outs[where] = (last.float().cpu(), step.float().cpu(),
                       {k: n for k, n in build.LAUNCHES.items() if n})
        del model, state
    if outs["cpu"][2] or outs["cuda"][2] != {"fft_planes": 3 * layers}:
        raise SystemExit(f"{FOURIER_ARCH} card vs CPU: launches "
                         f"{outs['cuda'][2]} on the card, "
                         f"{outs['cpu'][2]} on the CPU; expected "
                         f"fft_planes {3 * layers} times and none")
    errs = [float((a - b).abs().max())
            for a, b in zip(outs["cuda"][:2], outs["cpu"][:2])]
    if not all(torch.isfinite(a).all() and torch.allclose(a, b, **LM_TOL)
               for a, b in zip(outs["cuda"][:2], outs["cpu"][:2])):
        raise SystemExit(f"{FOURIER_ARCH} {layers}-layer full width fp32: "
                         f"card and CPU differ by {errs} (prefill, decode)")
    print(f"[lm] {FOURIER_ARCH} full width, {layers} layers, fp32, B={B} "
          f"S={S}: card (fft kernel) vs CPU (plain) prefill last logits "
          f"|diff|max={errs[0]:.3g}, decode_step(S) |diff|max="
          f"{errs[1]:.3g}, within {LM_TOL}; card launches "
          f"{outs['cuda'][2]}", flush=True)

    # (3) the two-pass schedule: kernel against plain version, bf16
    layers, B, S = FOURIER_LONG
    cfg16 = dataclasses.replace(cfg, num_layers=layers)
    n = kops._next_pow2(S + cfg.fourier_taps)
    per = 1 if kfft.two_pass_plan(n, radix) is None else 2
    model = convert.build(cfg16, full_width_state(torch, convert, cfg16),
                          dev)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(5))
    torch.cuda.synchronize()
    build.reset_launches()
    with_kernel, _ = model.prefill(tokens)
    torch.cuda.synchronize()
    kernel_launches = {k: c for k, c in build.LAUNCHES.items() if c}
    with_plain, _ = swapped_fft_planes(kfft, lambda: model.prefill(tokens))
    torch.cuda.synchronize()
    plain_launches = {k: c - kernel_launches.get(k, 0)
                      for k, c in build.LAUNCHES.items()
                      if c != kernel_launches.get(k, 0)}
    if kernel_launches != {"fft_planes": 3 * layers} or plain_launches:
        raise SystemExit(f"{FOURIER_ARCH} {layers}-layer prefill B={B} "
                         f"S={S}: launches {kernel_launches} with the "
                         f"kernel, {plain_launches} with the plain version; "
                         f"expected fft_planes {3 * layers} times and none")
    got, ref = with_kernel.float(), with_plain.float()
    long_err = float((got - ref).abs().max())
    if got.shape != (B, cfg.vocab_padded) or not (
            torch.isfinite(got).all() and torch.equal(with_kernel,
                                                      with_plain)):
        raise SystemExit(f"{FOURIER_ARCH} {layers}-layer bf16 prefill at "
                         f"n = {n}: last logits {tuple(got.shape)} through "
                         f"the kernel and the plain version differ by "
                         f"{long_err}")
    print(f"[lm] {FOURIER_ARCH} full width, {layers} layers, bf16, B={B} "
          f"S={S} (n = {n}, {per} kernels a transform): prefill last "
          f"logits through the kernel == with the plain version swapped in "
          f"(|logit|max {float(ref.abs().max()):.3g}); launches "
          f"{kernel_launches}", flush=True)
    del model
    torch.cuda.empty_cache()
    return {"launches": served["launches"]["fft_planes"],
            "first_call_tokens_per_s": served["tokens_per_s"],
            "card_vs_cpu_max_abs": errs,
            "two_pass_prefill": {"layers": layers, "batch": B, "prompt": S,
                                 "n": n, "launches": kernel_launches,
                                 "kernel_equals_plain": True}}


# ---------------------------------------------------------------------------
# The MoE FFN and the recurrent mixers: granite-moe-3b, hymba-1.5b and
# rwkv6-7b at full width and depth, mixtral-8x22b cut to 2 of its 56 layers
# ---------------------------------------------------------------------------

#: the archs served at full width and depth, each with the kernel its
#: prefill launches once a layer (None: no kernel of the port runs)
MIXER_ARCHS = {"granite-moe-3b-a800m": "flash_attention_wgmma",
               "hymba-1.5b": "flash_attention_wgmma",
               "rwkv6-7b": None}
#: mixtral-8x22b (1.4e11 parameters) is served at full width on this many
#: of its 56 layers: a cut of depth
MIXTRAL_ARCH, MIXTRAL_LAYERS = "mixtral-8x22b", 2
#: the card against the CPU: (layers, batch, prompt), fp32, full width
MIXER_CPU = (2, 1, 128)
#: prefill/decode parity on the card, fp32, full width: arch -> (layers
#: (None: all), batch, prompt). hymba's prompt is its window, so its ring
#: fills and the decode step's window leaves out key 0.
MIXER_PARITY = {"granite-moe-3b-a800m": (None, 2, 512),
                "hymba-1.5b": (None, 1, 2048),
                "rwkv6-7b": (None, 2, 512),
                MIXTRAL_ARCH: (MIXTRAL_LAYERS, 2, 512)}


def attention_counter(torch, kattn, cfg) -> str | None:
    """The flash kernel a prefill of ``cfg`` launches once a layer, or None
    where its mixer has no attention."""
    if cfg.mixer not in ("attn", "hymba"):
        return None
    return flash_counter(kattn, getattr(torch, cfg.dtype), cfg.head_dim)


@contextlib.contextmanager
def recorded_routing(moe_mod):
    """Every ``moe.route`` call's ``Routing``, in order, while the block
    runs (one a layer a forward)."""
    calls = []
    route = moe_mod.route

    def recording(*args, **kwargs):
        calls.append(route(*args, **kwargs))
        return calls[-1]

    moe_mod.route = recording
    try:
        yield calls
    finally:
        moe_mod.route = route


def routing_check(torch, cfg, S: int, cpu_calls, card_calls) -> dict:
    """The card's routing against the CPU's, layer by layer. The rounding
    is the largest difference of the two runs' probabilities; each of the
    S tokens' margin between its k-th and (k+1)-th probability (on the
    CPU) must be above twice it (each of the two may move by the
    rounding), so that equal routing is what the logits' tolerance
    implies, and then each token's chosen experts and kept slots
    must be equal. A margin at or under twice the rounding fails as
    such. (A
    group's padding rows are zero on both: their probabilities tie exactly
    and both take the lower experts.)"""
    k = cfg.experts_per_token
    if len(cpu_calls) != len(card_calls) or not cpu_calls:
        raise SystemExit(f"{cfg.name}: {len(cpu_calls)} routings on the "
                         f"CPU, {len(card_calls)} on the card")
    rounding = max(float((a.probs - b.probs.cpu()).abs().max())
                   for a, b in zip(cpu_calls, card_calls))
    margins = []
    for layer, (a, b) in enumerate(zip(cpu_calls, card_calls)):
        top = torch.sort(a.probs.flatten(1, 2)[:, :S], dim=-1,
                         descending=True).values
        margins.append(float((top[..., k - 1] - top[..., k]).min()))
        if margins[-1] <= 2 * rounding:
            raise SystemExit(
                f"{cfg.name} layer {layer}: a token's margin between its "
                f"{k}th and {k + 1}th probability, {margins[-1]:.3g}, is not "
                f"above twice the card-CPU rounding of the probabilities "
                f"{rounding:.3g}: equal routing is not implied")
        if not (torch.equal(a.expert, b.expert.cpu())
                and torch.equal(a.kept, b.kept.cpu())):
            raise SystemExit(f"{cfg.name} layer {layer}: the card's chosen "
                             f"experts or kept slots differ from the CPU's")
    kept = sum(int(a.kept.sum()) for a in cpu_calls)
    slots = sum(a.kept.numel() for a in cpu_calls)
    return {"layers": len(cpu_calls), "min_margin": min(margins),
            "probs_rounding": rounding, "kept_slots": kept,
            "slots": slots, "capacity": cpu_calls[0].capacity}


def mixer_card_vs_cpu(torch, build, convert, kattn, moe_mod, get_config,
                      arch: str) -> dict:
    """MIXER_CPU's full-width fp32 layers of ``arch`` with the same weights
    (seed 3, drawn on the CPU) on the card and on the CPU (plain versions):
    the logits within LM_TOL, the card launching the fp32 flash kernel once
    a layer (3xTF32 at head_dim 64; none for rwkv6-7b) and the CPU nothing;
    for a MoE arch the routing first (``routing_check``)."""
    layers, B, S = MIXER_CPU
    cfg = get_config(arch)
    cfg32 = dataclasses.replace(cfg, num_layers=layers, dtype="float32")
    counter = attention_counter(torch, kattn, cfg32)
    sd = convert.init_params(cfg32, torch.Generator().manual_seed(3))
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(4))
    outs = {}
    for where, place in (("cpu", torch.device("cpu")),
                         ("cuda", torch.device("cuda"))):
        model = convert.build(cfg32, sd, place)
        torch.cuda.synchronize()
        build.reset_launches()
        with recorded_routing(moe_mod) as calls:
            logits = model(tokens.to(place))
        torch.cuda.synchronize()
        outs[where] = (logits.float().cpu(),
                       {k: n for k, n in build.LAUNCHES.items() if n}, calls)
        del model, logits
    want = {counter: layers} if counter else {}
    if outs["cpu"][1] or outs["cuda"][1] != want:
        raise SystemExit(f"{arch} card vs CPU: launches {outs['cuda'][1]} "
                         f"on the card, {outs['cpu'][1]} on the CPU; "
                         f"expected {want or 'none'} and none")
    out = {"launches": outs["cuda"][1]}
    text = ""
    if cfg.is_moe:
        out["routing"] = r = routing_check(torch, cfg, S, outs["cpu"][2],
                                           outs["cuda"][2])
        text = (f"; routing equal in {r['layers']} layers ({r['kept_slots']} "
                f"of {r['slots']} slots kept, C {r['capacity']}), smallest "
                f"k-th to (k+1)-th margin {r['min_margin']:.3g} above twice the "
                f"probabilities' card-CPU rounding {r['probs_rounding']:.3g}")
    got, ref = outs["cuda"][0], outs["cpu"][0]
    out["max_abs"] = err = float((got - ref).abs().max())
    if got.shape != (B, S, cfg.vocab_padded) or not (
            torch.isfinite(got).all() and torch.allclose(got, ref, **LM_TOL)):
        raise SystemExit(f"{arch} {layers}-layer full width fp32: card and "
                         f"CPU logits {tuple(got.shape)} differ by {err}")
    print(f"[lm] {arch} full width, {layers} layers, fp32, B={B} S={S}: "
          f"card vs CPU (plain) logits |diff|max={err:.3g} within {LM_TOL}; "
          f"card launches {outs['cuda'][1]}{text}", flush=True)
    return out


def mixer_parity(torch, build, convert, kattn, get_config, arch: str,
                 layers: int | None, B: int, S: int) -> dict:
    """Prefill/decode parity of ``arch`` on the card at full width in fp32
    (``layers`` (None: all), batch B, prompt S; seed-0 weights drawn on
    the card; a MoE arch at its no-drop capacity factor E / k, as the
    reference's own parity test takes it), the counters zeroed just
    before: decode_step(S) after prefill(S) against forward(S + 1)[-1],
    and the prefill's last logits against forward's row S - 1, within
    LM_TOL; the decode step takes position S of the forward's own tokens,
    or its embeddings and M-RoPE positions (``lm_inputs``,
    ``step_inputs``); the fp32 flash kernel launched once a layer in each
    of the forward and the prefill, and nothing else."""
    dev = torch.device("cuda")
    cfg = get_config(arch)
    cut = {} if layers is None else {"num_layers": layers}
    if cfg.is_moe:
        cut["capacity_factor"] = cfg.num_experts / cfg.experts_per_token
    cfg32 = dataclasses.replace(cfg, dtype="float32", **cut)
    counter = attention_counter(torch, kattn, cfg32)
    sd = full_width_state(torch, convert, cfg32)
    model = convert.build(cfg32, sd, dev)
    del sd
    torch.cuda.empty_cache()
    inputs = lm_inputs(torch, cfg32, B, S + 1, dev, seed=2)
    token, kw = step_inputs(inputs, S)
    torch.cuda.synchronize()
    build.reset_launches()
    full = model(**inputs)
    last, state = model.prefill(**{k: v[:, :S] for k, v in inputs.items()},
                                cache_capacity=S + 1)
    step, _ = model.decode_step(state, token, S, **kw)
    torch.cuda.synchronize()
    launches = {k: n for k, n in build.LAUNCHES.items() if n}
    want = {counter: 2 * cfg32.num_layers} if counter else {}
    if launches != want:
        raise SystemExit(f"{arch} fp32 parity: launches {launches}, "
                         f"expected {want or 'none'} (one forward, one "
                         f"prefill) and nothing else")
    errs = (float((last - full[:, S - 1]).abs().max()),
            float((step - full[:, -1]).abs().max()))
    if not (torch.isfinite(full).all()
            and torch.allclose(last, full[:, S - 1], **LM_TOL)
            and torch.allclose(step, full[:, -1], **LM_TOL)):
        raise SystemExit(f"{arch} full-width prefill/decode parity failed: "
                         f"|prefill - forward| {errs[0]}, |decode - "
                         f"forward| {errs[1]}")
    print(f"[lm] parity {arch} full width fp32, {cfg32.num_layers}"
          f"{'' if layers is None else f' of {cfg.num_layers}'} layers"
          f"{' (capacity factor E / k: no drops)' if cfg.is_moe else ''}, "
          f"B={B} S={S}: prefill last logits vs forward |diff|max="
          f"{errs[0]:.3g}, decode_step(S) vs forward(S+1)[-1] |diff|max="
          f"{errs[1]:.3g}, within {LM_TOL}; launches {launches}", flush=True)
    del model, full, state
    torch.cuda.empty_cache()
    return {"launches": launches, "parity_max_abs": errs, "batch": B,
            "prompt": S, "layers": cfg32.num_layers}


def mixer_phase(torch, build, serve, convert, kattn, moe_mod, get_config
                ) -> dict:
    """Phase 3 for the MoE FFN and the recurrent mixers, each step with
    the counters zeroed just before: (a) the served runs at full width and
    depth (``serve_lm``): granite-moe-3b and hymba-1.5b 32 launches each of
    the wgmma kernel, rwkv6-7b none, and nothing else; (b) mixtral-8x22b
    served at full width on MIXTRAL_LAYERS of its 56 layers (a cut of
    depth): 2 launches; (c) the card against the CPU
    (``mixer_card_vs_cpu``) for the three; (d) prefill/decode parity on
    the card (``mixer_parity``) for all four."""
    out = {}
    for arch, counter in MIXER_ARCHS.items():
        out[arch] = {"served": serve_lm(torch, build, serve, get_config,
                                        arch, counter=counter)}
    out[MIXTRAL_ARCH] = {"served": serve_lm(
        torch, build, serve, get_config, MIXTRAL_ARCH,
        layers=MIXTRAL_LAYERS)}
    for arch in MIXER_ARCHS:
        out[arch]["card_vs_cpu"] = mixer_card_vs_cpu(
            torch, build, convert, kattn, moe_mod, get_config, arch)
    for arch, (layers, B, S) in MIXER_PARITY.items():
        out[arch]["parity"] = mixer_parity(torch, build, convert, kattn,
                                           get_config, arch, layers, B, S)
    return out


#: the registry's four archs no other step runs: each served at full width
#: (bf16, batch 8, prompt 2048, gen 32) on this many of its layers (None:
#: all), a cut of depth where its weights would not fit the card beside
#: the rest. The embeddings archs (musicgen-medium, qwen2-vl-72b) take
#: seeded frame or patch embeddings, and qwen2-vl-72b (B, S, 3) M-RoPE
#: streams, through ``prefill(embeds=)`` and ``decode_step(embed=)``: no
#: serve CLI of either package serves them (their ``generate`` feeds back
#: tokens). Weights a served run draws: starcoder2-15b 8 x 535 M + 604 M
#: fp32 (19.5 GB), llama3-405b 4 x 3.19 G + 4.2 G bf16 (34 GB),
#: musicgen-medium 48 x 37.8 M + 6.3 M fp32 (7.3 GB), qwen2-vl-72b 8 x
#: 878 M + 2.49 G bf16 (19 GB).
REST_ARCHS = {"starcoder2-15b": 8, "llama3-405b": 4, "musicgen-medium": None,
              "qwen2-vl-72b": 8}
#: the bf16 prefill through the kernel against the plain version swapped
#: in (``prefill_vs_plain``, B GEMMA_PARITY_BATCH x LM_PROMPT): layers
REST_PLAIN_LAYERS = {"starcoder2-15b": 4, "llama3-405b": 2,
                     "musicgen-medium": 6, "qwen2-vl-72b": 2}
#: the card against the CPU, fp32, B 1 x S 128: layers (llama3-405b's one
#: fp32 layer with its embeddings and head is about 30 GB of host memory)
REST_CPU_LAYERS = {"starcoder2-15b": 2, "llama3-405b": 1,
                   "musicgen-medium": 2, "qwen2-vl-72b": 2}
REST_CPU = (1, 128)
#: prefill/decode parity on the card, fp32: (layers, batch, prompt)
REST_PARITY = (2, 2, 512)
#: the embeddings' scale, as tests/test_torch_models.py makes them
EMBED_SCALE = 0.02


def lm_inputs(torch, cfg, B: int, S: int, device, seed: int) -> dict:
    """A prompt of ``cfg``'s kind as keyword arguments of ``forward`` and
    ``prefill``, drawn from ``seed`` on ``device``: (B, S) tokens, or for
    an embeddings arch (B, S, d_model) embeddings of scale EMBED_SCALE, and
    for an M-RoPE arch (B, S, 3) position streams, each stream 0 .. S - 1
    (as tests/test_torch_models.py makes them)."""
    g = torch.Generator(device=device).manual_seed(seed)
    if cfg.frontend != "embeddings":
        return {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                        device=device, generator=g)}
    out = {"embeds": torch.randn(B, S, cfg.d_model, device=device,
                                 generator=g) * EMBED_SCALE}
    if cfg.mrope_sections is not None:
        out["positions"] = torch.arange(
            S, dtype=torch.int32, device=device)[None, :, None].expand(
                B, S, 3).contiguous()
    return out


def step_inputs(inputs: dict, i: int) -> tuple:
    """Position ``i`` of ``lm_inputs``'s prompt as ``decode_step``'s token
    and keyword arguments: the token, or its embedding row and M-RoPE
    positions."""
    if "tokens" in inputs:
        return inputs["tokens"][:, i], {}
    out = {"embed": inputs["embeds"][:, i:i + 1]}
    if "positions" in inputs:
        out["positions"] = inputs["positions"][:, i:i + 1]
    return None, out


def drive_embeddings(torch, model, B: int, S: int, gen: int, seed: int
                     ) -> dict:
    """An embeddings arch's serving path: a prefill of S seeded embeddings
    (``lm_inputs``) with room for ``gen`` more positions, then ``gen``
    ``decode_step`` calls, step i fed the seeded embedding row of position
    S + i (and M-RoPE positions S + i); each step's greedy id is the
    argmax over the vocabulary. Returns the inputs, the prefill's last
    logits, each step's logits, the (gen, B) ids and the prefill's and the
    decode loop's host ms, each ending in a synchronize on the card. Runs
    on the CPU too (the tests hold it against the reference there)."""
    cfg = model.cfg

    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize()

    inputs = lm_inputs(torch, cfg, B, S + gen, model.device, seed)
    prompt = {k: v[:, :S] for k, v in inputs.items()}
    sync()
    t0 = time.perf_counter()
    last, state = model.prefill(**prompt, cache_capacity=S + gen)
    sync()
    t1 = time.perf_counter()
    steps = []
    for i in range(gen):
        token, kw = step_inputs(inputs, S + i)
        logits, state = model.decode_step(state, token, S + i, **kw)
        steps.append(logits)
    ids = torch.stack([s[:, :cfg.vocab_size].argmax(dim=-1) for s in steps])
    sync()
    t2 = time.perf_counter()
    return {"inputs": inputs, "prefill_logits": last, "step_logits": steps,
            "ids": ids, "prefill_ms": (t1 - t0) * 1e3,
            "decode_ms_per_token": (t2 - t1) * 1e3 / gen}


@contextlib.contextmanager
def timed_calls(torch, lm):
    """CUDA events recorded around every ``DecoderLM.prefill`` and
    ``decode_step`` call while the block runs, so a served run is timed
    on the card's clock without a synchronize of its own: the prefill's
    ms, and the decode loop's from its first step's start to its last
    step's end (host gaps included) over the steps."""
    marks: dict[str, list] = {"prefill": [], "decode_step": []}
    originals = {name: getattr(lm.DecoderLM, name) for name in marks}

    def timed(name, fn):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            marks[name].append((start, end))
            return out
        return call

    for name, fn in originals.items():
        setattr(lm.DecoderLM, name, timed(name, fn))
    try:
        yield marks
    finally:
        for name, fn in originals.items():
            setattr(lm.DecoderLM, name, fn)


def rest_served(torch, build, serve, convert, lm, get_config, arch: str,
                card: str) -> dict:
    """REST_ARCHS's served run of ``arch``, the counters zeroed just
    before: a token arch through the serve CLI (``serve_lm``, ``--layers``
    for a cut), an embeddings arch through ``drive_embeddings`` on weights
    drawn on the card from seed 0 as the CLI draws them. Either launches
    the wgmma kernel once a layer (one prefill) and nothing else and gives
    (LM_GEN, LM_BATCH) ids in the vocabulary. Prints tok/s, prefill ms,
    decode ms per token (CUDA events, ``timed_calls``) and peak device
    memory beside the card."""
    layers = REST_ARCHS[arch]
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers or full.num_layers)
    L = cfg.num_layers
    weight_bytes = cfg.param_count() * torch.finfo(
        getattr(torch, cfg.param_dtype)).bits // 8
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with timed_calls(torch, lm) as marks:
        if cfg.frontend != "embeddings":
            res = serve_lm(torch, build, serve, get_config, arch,
                           layers=layers)
            launches, tokens_per_s = res["launches"], res["tokens_per_s"]
        else:
            dev = torch.device("cuda")
            sd = full_width_state(torch, convert, cfg)
            model = convert.build(cfg, sd, dev)
            del sd
            torch.cuda.synchronize()
            build.reset_launches()
            t0 = time.perf_counter()
            out = drive_embeddings(torch, model, LM_BATCH, LM_PROMPT, LM_GEN,
                                   seed=1)
            tokens_per_s = LM_BATCH * LM_GEN / (time.perf_counter() - t0)
            launches = dict(build.LAUNCHES)
            ids = out["ids"].cpu()
            del model, out
            want = {"flash_attention_wgmma": L}
            if {k: n for k, n in launches.items() if n} != want:
                raise SystemExit(f"driven {arch} run: launches {launches}, "
                                 f"expected {want} (one prefill) and "
                                 f"nothing else")
            if ids.shape != (LM_GEN, LM_BATCH) or not (
                    (ids >= 0) & (ids < cfg.vocab_size)).all():
                raise SystemExit(f"driven {arch} run: ids {tuple(ids.shape)} "
                                 f"{int(ids.min())}..{int(ids.max())}")
    torch.cuda.synchronize()
    (p0, p1), = marks["prefill"]
    steps = marks["decode_step"]
    prefill_ms = p0.elapsed_time(p1)
    decode_ms = steps[0][0].elapsed_time(steps[-1][1]) / len(steps)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    depth = (f"{L} layers" if layers is None
             else f"{L} of {full.num_layers} layers: a cut of depth")
    how = ("serve --service lm" if cfg.frontend != "embeddings" else
           "prefill(embeds=) + decode_step(embed=)"
           + (", M-RoPE (B, S, 3)" if cfg.mrope_sections else ""))
    print(f"[lm] {arch} (full width, {depth}; {how}; heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads} hd {cfg.head_dim}; bf16; "
          f"weights {weight_bytes / 1e9:.2f} GB {cfg.param_dtype}) batch="
          f"{LM_BATCH} prompt={LM_PROMPT} gen={LM_GEN}: {tokens_per_s:.1f} "
          f"tok/s (first call, incl. prefill); prefill {prefill_ms:.2f} ms, "
          f"decode {decode_ms:.3f} ms/token (CUDA events); peak device "
          f"memory {peak / 2**30:.2f} GiB; launches "
          f"{ {k: n for k, n in launches.items() if n} }; on {card}",
          flush=True)
    return {"layers": L, "of": full.num_layers,
            "launches": {k: n for k, n in launches.items() if n},
            "tokens_per_s": tokens_per_s, "prefill_ms": prefill_ms,
            "decode_ms_per_token": decode_ms, "peak_bytes": peak,
            "weight_bytes": weight_bytes, "driven_by": how}


def host_available_bytes() -> int:
    """The host's MemAvailable (``/proc/meminfo``), in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable")


def rest_card_vs_cpu(torch, build, convert, get_config, arch: str,
                     card: str) -> dict:
    """REST_CPU_LAYERS's full-width fp32 layers of ``arch`` with the same
    weights (seed 3, drawn on the card, the CPU's a copy) on the CPU
    (plain versions) and on the card, B 1 x S 128 (``lm_inputs``, seed 4,
    made on the CPU): the logits within LM_TOL, the card launching the
    3xTF32 kernel once a layer and nothing else, the CPU nothing. The
    host's MemAvailable and the bytes the step holds on the host (the
    drawn weights and the fp32 model) are printed before the CPU run."""
    B, S = REST_CPU
    layers = REST_CPU_LAYERS[arch]
    cfg32 = dataclasses.replace(get_config(arch), num_layers=layers,
                                dtype="float32")
    dev = torch.device("cuda")
    sd = convert.init_params(cfg32,
                             torch.Generator(device=dev).manual_seed(3))
    drawn = sum(v.numel() * v.element_size() for v in sd.values())
    reckoned = drawn + 4 * cfg32.param_count()
    print(f"[lm] {arch} card vs CPU: host MemAvailable "
          f"{host_available_bytes() / 2**30:.1f} GiB, the step holds "
          f"{reckoned / 2**30:.1f} GiB on the host ({drawn / 2**30:.1f} GiB "
          f"of drawn {cfg32.param_dtype} weights, {4 * cfg32.param_count() / 2**30:.1f} "
          f"GiB of the fp32 model)", flush=True)
    inputs = lm_inputs(torch, cfg32, B, S, "cpu", seed=4)
    model = convert.build(cfg32, {k: v.cpu() for k, v in sd.items()}, "cpu")
    build.reset_launches()
    on_cpu = model(**inputs).float()
    cpu_launches = {k: n for k, n in build.LAUNCHES.items() if n}
    del model
    model = convert.build(cfg32, sd, dev)
    del sd
    torch.cuda.synchronize()
    build.reset_launches()
    on_card = model(**{k: v.to(dev) for k, v in inputs.items()}).float().cpu()
    torch.cuda.synchronize()
    launches = {k: n for k, n in build.LAUNCHES.items() if n}
    del model
    torch.cuda.empty_cache()
    want = {"flash_attention_tf32": layers}
    if cpu_launches or launches != want:
        raise SystemExit(f"{arch} card vs CPU: launches {launches} on the "
                         f"card, {cpu_launches} on the CPU; expected {want} "
                         f"and none")
    err = float((on_card - on_cpu).abs().max())
    if on_card.shape != (B, S, cfg32.vocab_padded) or not (
            torch.isfinite(on_card).all()
            and torch.allclose(on_card, on_cpu, **LM_TOL)):
        raise SystemExit(f"{arch} {layers}-layer full width fp32: card and "
                         f"CPU logits {tuple(on_card.shape)} differ by {err}")
    print(f"[lm] {arch} full width, {layers} of {get_config(arch).num_layers} "
          f"layers, fp32, B={B} S={S}: card vs CPU (plain) logits "
          f"|diff|max={err:.3g} within {LM_TOL}; card launches {launches}; "
          f"on {card}", flush=True)
    return {"layers": layers, "max_abs": err, "launches": launches,
            "host_bytes": reckoned}


def rest_phase(torch, build, serve, convert, lm, kattn, get_config,
               card: str) -> dict:
    """Phase 3 for REST_ARCHS, each step with the counters zeroed just
    before: (a) the served runs at full width (``rest_served``): L
    launches of the wgmma kernel each and nothing else; (b) the bf16
    prefill through the kernel against the plain version swapped in
    (``prefill_vs_plain``, REST_PLAIN_LAYERS) within GEMMA_PARITY_TOL;
    (c) the card against the CPU in fp32 (``rest_card_vs_cpu``); (d)
    prefill/decode parity on the card in fp32 (``mixer_parity``,
    REST_PARITY)."""
    out = {arch: {"served": rest_served(torch, build, serve, convert, lm,
                                        get_config, arch, card)}
           for arch in REST_ARCHS}
    for arch, layers in REST_PLAIN_LAYERS.items():
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        err, launched = prefill_vs_plain(torch, build, convert, kattn, cfg,
                                         "flash_attention_wgmma",
                                         GEMMA_PARITY_TOL)
        out[arch]["kernel_vs_plain"] = {
            "layers": layers, "launches": launched,
            "last_logits_max_abs": err}
    for arch in REST_ARCHS:
        out[arch]["card_vs_cpu"] = rest_card_vs_cpu(
            torch, build, convert, get_config, arch, card)
        out[arch]["parity"] = mixer_parity(torch, build, convert, kattn,
                                           get_config, arch, *REST_PARITY)
    return out


#: Device-side names of the flash kernels in a profiler trace, by launch
#: counter (every instance of each).
FLASH_TRACE_NAMES = {
    name: re.compile(name + "_kernel") for name in FLASH_KERNELS}


#: Phase 4's flash-attention shapes: label -> (kernel, (B, S, H, KV, hd,
#: dtype, window)), causal, at the served batch and prompt. The wgmma
#: kernel at the served prefills: the qwen3-1.7b one, and gemma3-4b's heads
#: (8 heads, 4 kv heads, head_dim 320) at its local layers' window 1024 and
#: at its global layers, and at the reduced configs' head_dim 32 (at qwen3's
#: 16 heads, 8 kv heads); the tf32 kernel at the qwen3 shape in fp32 (the
#: fp32 parity path's), at gemma3-4b's in fp32, global and local, and at
#: head_dim 32 in fp32 (the reduced configs'). Beside each tensor-core
#: kernel the CUDA-core kernel runs in turns on the same inputs; at
#: CUDA_CORE_TIMED its plain version is timed too, for its own entry.
ATTN_TIMED = {
    "served prefill": ("flash_attention_wgmma",
                       (LM_BATCH, LM_PROMPT, 16, 8, 128, "bfloat16",
                        1 << 30)),
    "gemma3-4b local, window 1024": (
        "flash_attention_wgmma", (LM_BATCH, LM_PROMPT, 8, 4, 320,
                                  "bfloat16", 1024)),
    "gemma3-4b global": (
        "flash_attention_wgmma", (LM_BATCH, LM_PROMPT, 8, 4, 320,
                                  "bfloat16", 1 << 30)),
    "fp32": ("flash_attention_tf32",
             (LM_BATCH, LM_PROMPT, 16, 8, 128, "float32", 1 << 30)),
    "fp32 hd 320": ("flash_attention_tf32",
                    (LM_BATCH, LM_PROMPT, 8, 4, 320, "float32", 1 << 30)),
    "fp32 hd 320 local, window 1024": (
        "flash_attention_tf32", (LM_BATCH, LM_PROMPT, 8, 4, 320, "float32",
                                 1024)),
    "bf16 hd 32": ("flash_attention_wgmma",
                   (LM_BATCH, LM_PROMPT, 16, 8, 32, "bfloat16", 1 << 30)),
    "fp32 hd 32": ("flash_attention_tf32",
                   (LM_BATCH, LM_PROMPT, 16, 8, 32, "float32", 1 << 30))}
#: the ATTN_TIMED label whose CUDA-core turns give that kernel's entry
CUDA_CORE_TIMED = "fp32 hd 32"


def cuda_core_on(torch, build, q, k, v, scale: float, window: int = 1 << 30):
    """The CUDA-core kernel on causal inputs at a head_dim the wrappers send
    to a tensor-core kernel: the previous design on the same inputs, to
    compare the two within one run."""
    B, S, H, hd = q.shape
    o = torch.empty_like(q)
    build.launch("flash_attention", "flash_attention", q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H,
                 k.shape[2], hd, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *o.stride()[:3], min(window, 1 << 30), 1,
                 float(scale), int(q.dtype == torch.bfloat16))
    return o


def attention_timing(torch, kattn, build, card: str, label: str) -> dict:
    """Flash kernel of ATTN_TIMED[label] at its shape, causal (within its
    window): device time (mean over the launches traced), its plain
    version, and scaled_dot_product_attention (causal, GQA; with the
    window, the same mask as a boolean ``attn_mask``) on the same inputs as
    the yardstick; bound: bytes of q, k, v and o over 3.35 TB/s, or the
    operations the kernel does on them: the pairs' flops (4 hd per pair
    within the causal window: q.k and p.v) over 989 TFLOP/s bf16 (the
    wgmma kernel) or 67 TFLOP/s fp32 (the CUDA-core kernel), or three
    times those flops over 495 TFLOP/s TF32 (the tf32 kernel: each fp32
    product as three TF32 products, which the reference's fp32 products
    need; one TF32 pass keeps 10 bits). For a tensor-core kernel, the
    CUDA-core kernel on the same inputs too, in turns.

    The kernel's, the plain version's and SDPA's times are CUDA-event
    time per call over back-to-back calls: each call runs far longer than
    the host takes to launch it, so the card never waits on the host,
    while their traces drop device events (on an H100 the flash kernels'
    traces held 1 of 10 launches, or none in five tries, and SDPA's read
    half its event time, below the bound). The traced times are printed
    beside, where the trace holds any."""
    name, (B, S, H, KV, hd, dtype, window) = ATTN_TIMED[label]
    sets = [attention_inputs(torch, B, S, H, KV, hd, dtype, 100 + i)
            for i in range(2)]
    if flash_counter(kattn, sets[0][0].dtype, hd) != name:
        raise SystemExit(f"{name}: ATTN_TIMED shape dispatches elsewhere")
    scale = hd ** -0.5
    kern = functools.partial(kattn.attention, window=window, scale=scale)
    plain = functools.partial(kattn.attention_plain, window=window,
                              scale=scale)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_sets = [tuple(x.transpose(1, 2) for x in s) for s in sets]
    pos = torch.arange(S, device=sets[0][0].device)
    mask = ((pos[None, :] <= pos[:, None])
            & (pos[None, :] > pos[:, None] - window)) if window < S else None

    def lib(q, k, v):
        if mask is None:
            return sdpa(q, k, v, is_causal=True, enable_gqa=True)
        return sdpa(q, k, v, attn_mask=mask, enable_gqa=True)

    before = build.LAUNCHES[name]
    got = kern(*sets[0]).float()
    torch.cuda.synchronize()
    if build.LAUNCHES[name] != before + 1:
        raise SystemExit(f"{name}: the timed call did not launch it")
    t0 = time.perf_counter()
    want = plain(*sets[0]).float()
    torch.cuda.synchronize()
    # a plain version that takes long a call (at fp32 hd 320 it folds 8-key
    # tiles: about 0.7 s) is timed by one call and not traced
    slow_plain = time.perf_counter() - t0 > 0.25
    ref = lib(*lib_sets[0]).transpose(1, 2).float()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, **ATTN_TOL[dtype]):
        raise SystemExit(f"{name} at {ATTN_TIMED[label]}: |kernel - plain| "
                         f"{err}")
    bf16 = dtype == "bfloat16"
    nbytes = (2 if bf16 else 4) * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    pairs = sum(min(q + 1, window) for q in range(S))
    flops = 4 * hd * pairs * B * H
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_fp32 = flops / FP32_FLOPS_PER_S * 1e3
    operations, t_ops = {
        "flash_attention_wgmma": ("bf16 flops",
                                  flops / BF16_FLOPS_PER_S * 1e3),
        "flash_attention_tf32": ("3 x TF32 flops",
                                 3 * flops / TF32_FLOPS_PER_S * 1e3),
        "flash_attention": ("fp32 flops", t_fp32)}[name]
    reps = 10
    traced_ms, traced = device_ms(torch, kern, sets, reps,
                                  launches_per_call=1, tries=2,
                                  required=False)
    entry = {
        "ms": time_ms(torch, kern, sets, reps),
        "traced_ms": traced_ms, "traced_launches": f"{traced} of {reps}",
        "plain_ms": (time_ms(torch, plain, sets[:1], 1) if slow_plain
                     else time_ms(torch, plain, sets, 4)),
        "library_ms": time_ms(torch, lib, lib_sets, reps),
        "library": "torch.nn.functional.scaled_dot_product_attention("
                   + ("is_causal=True" if mask is None else
                      "attn_mask=<causal window>") + ", enable_gqa=True)",
        "plain_traced_ms": None if slow_plain else device_ms(
            torch, plain, sets, 4, tries=2, required=False)[0],
        "library_traced_ms": device_ms(torch, lib, lib_sets, reps, tries=2,
                                       required=False)[0],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes_ms": t_bytes, "operations_ms": t_ops,
        "operations": operations, "fp32_cuda_core_ms": t_fp32,
        "bytes": nbytes, "flops": flops, "max_abs_err": err,
        "sdpa_vs_plain_max_abs": float((ref - want).abs().max()),
        "shape": {"B": B, "S": S, "H": H, "KV": KV, "hd": hd,
                  "dtype": dtype, "causal": True, "window": window},
        **build.occupancy(name, hd, int(bf16), 0)}
    extra = ""
    if name != "flash_attention":
        # the CUDA-core kernel on the same inputs, held against the plain
        # version of its own dataflow (64-key tiles, fp32 products); then in
        # turns: this kernel, the CUDA-core kernel twice, this kernel again
        core = functools.partial(cuda_core_on, torch, build, scale=scale,
                                 window=window)
        out = core(*sets[0]).float()
        torch.cuda.synchronize()
        ref = kattn.attention_plain(*sets[0], window=window, scale=scale,
                                    kernel="cuda_core").float()
        core_err = float((out - ref).abs().max())
        if not torch.allclose(out, ref, **ATTN_TOL[dtype]):
            raise SystemExit(f"the CUDA-core kernel differs from its plain "
                             f"version on {label}'s inputs: {core_err}")
        kernel_turns = [entry["ms"]]
        core_turns = [time_ms(torch, core, sets, reps) for _ in range(2)]
        kernel_turns.append(time_ms(torch, kern, sets, reps))
        entry.update(ms=min(kernel_turns), ms_turns=kernel_turns,
                     cuda_core_max_abs_err=core_err,
                     cuda_core_same_inputs_event_ms=min(core_turns),
                     cuda_core_turns=core_turns)
        if label == CUDA_CORE_TIMED:
            core_plain = functools.partial(kattn.attention_plain,
                                           window=window, scale=scale,
                                           kernel="cuda_core")
            entry.update(cuda_core_plain_ms=time_ms(torch, core_plain, sets,
                                                    4),
                         cuda_core_bound_ms=max(t_bytes, t_fp32),
                         cuda_core_bound_by="bytes" if t_bytes >= t_fp32
                         else "operations")
        extra = ("; on the same inputs, in turns (this kernel, CUDA core, "
                 "CUDA core, this kernel): kernel "
                 + ", ".join(f"{t:.4f}" for t in kernel_turns)
                 + "; cuda_core " + ", ".join(f"{t:.4f}" for t in core_turns)
                 + " event ms")
    def fmt(x):
        return "none" if x is None else f"{x:.4f}"

    print(f"[time] {name} ({label}) B={B} S={S} H={H} KV={KV} hd={hd} "
          f"{dtype} causal window={window}: "
          f"event ms per call: kernel={entry['ms']:.4f} "
          f"plain={entry['plain_ms']:.4f} sdpa={entry['library_ms']:.4f}; "
          f"bound={entry['bound_ms']:.4f} ({entry['bound_by']}; bytes "
          f"{t_bytes:.4f}, {entry['operations']} {t_ops:.4f}, fp32 flops "
          f"on the CUDA cores {t_fp32:.4f}); traced: "
          f"kernel={fmt(traced_ms)} ms (mean of {entry['traced_launches']} "
          f"launches traced), plain={fmt(entry['plain_traced_ms'])} and "
          f"sdpa={fmt(entry['library_traced_ms'])} ms over calls; "
          f"{flops / entry['ms'] / 1e9:.1f} TFLOP/s; |kernel-plain|max="
          f"{err:.3g}; launch: {entry['threads']} threads, "
          f"{entry['smem_bytes']} B shared, {entry['regs']} regs/thread -> "
          f"{entry['ctas_per_sm']} CTAs/SM{extra}; on {card}", flush=True)
    return entry


#: Stages of a prefill labelled in its trace (``labelled``): functions of
#: granite-moe-3b's MoE FFN (``models/layers/moe.py``: routing, scatter,
#: the experts' products, gather) and rwkv6-7b's scan
#: (``models/layers/recurrent.py``)
MOE_STAGES = ("route", "dispatch", "experts", "combine")
SCAN_STAGES = ("_wkv_scan",)


def stage_labels(stages) -> list[str]:
    """``stages`` = (module, function names): each function's label."""
    if not stages:
        return []
    module, names = stages
    return [f"{module.__name__.rsplit('.', 1)[-1]}.{n}" for n in names]


@contextlib.contextmanager
def labelled(torch, stages):
    """Each of ``stages``' functions (module, names) wrapped in a
    ``record_function`` of its label (``stage_labels``) while the block
    runs; the module looks them up at call time."""
    saved = []
    if stages:
        module, names = stages
        for name, label in zip(names, stage_labels(stages)):
            original = getattr(module, name)

            def wrapper(*args, _original=original, _label=label, **kwargs):
                with torch.profiler.record_function(_label):
                    return _original(*args, **kwargs)

            saved.append((name, original))
            setattr(module, name, wrapper)
    try:
        yield
    finally:
        for name, original in saved:
            setattr(stages[0], name, original)


def stage_split(prof, labels) -> dict:
    """Device ms and kernel launches under each label's ranges (their
    kernels and their children's), and the matmul kernels' share."""
    out = {label: {"ms": 0.0, "launches": 0, "matmul_ms": 0.0}
           for label in labels}

    def walk(ev, entry):
        for kernel in ev.kernels:
            entry["ms"] += kernel.duration / 1e3
            entry["launches"] += 1
            if MATMUL_TRACE_NAME.search(kernel.name):
                entry["matmul_ms"] += kernel.duration / 1e3
        for child in ev.cpu_children:
            walk(child, entry)

    for ev in prof.events():
        if ev.name in out:
            walk(ev, out[ev.name])
    return out


def lm_timing(torch, build, convert, lm, kattn, get_config, card: str,
              arch: str, dtype: str = "bfloat16", decode: bool = True,
              layers: int | None = None, trace: bool = True,
              trace_layers: int | None = None,
              stages: tuple | None = None) -> dict:
    """The cell's prefill ms (batch LM_BATCH x LM_PROMPT, activations in
    ``dtype``, ``layers`` a cut of depth; host clock around work that ends
    in a synchronize, best of LM_PREFILL_RUNS after one warm call, which
    must launch the kernel ``kernel_for`` picks once per layer, or none for
    a mixer without attention, and nothing else, the counters zeroed just
    before it). With ``trace``, a traced prefill (of its first ``trace_layers`` layers
    where given): the flash kernel's share of its device time, the
    matmuls', and with ``stages`` (module, functions: ``labelled``) each
    stage's. With ``decode``, decode ms per token and tok/s, and a traced
    decode of LM_TRACED_STEPS steps for the card's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(arch), dtype=dtype,
                              **({} if layers is None
                                 else {"num_layers": layers}))
    counter = attention_counter(torch, kattn, cfg)
    flash = FLASH_TRACE_NAMES[counter] if counter else None
    labels = stage_labels(stages)
    model = convert.build(cfg, full_width_state(torch, convert, cfg), dev)
    torch.cuda.empty_cache()
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    cap = LM_PROMPT + LM_GEN

    def prefills() -> list[float]:
        runs = []
        for _ in range(LM_PREFILL_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.prefill(tokens, cache_capacity=cap)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        return runs, out

    def device_time(prof):
        """(device ms, flash kernel ms, flash launches traced, matmul ms)
        over the kernels; a ``record_function`` range also shows as a
        device-side span of its label, which is not a kernel."""
        total = flash_ms = matmul_ms = 0.0
        seen = 0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.key not in labels:
                ms = e.self_device_time_total / 1e3
                total += ms
                if flash is not None and flash.search(e.key):
                    flash_ms += ms
                    seen += e.count
                elif MATMUL_TRACE_NAME.search(e.key):
                    matmul_ms += ms
        return total, flash_ms, seen, matmul_ms

    torch.cuda.synchronize()
    build.reset_launches()
    model.prefill(tokens, cache_capacity=cap)
    torch.cuda.synchronize()
    launches = {k: n for k, n in build.LAUNCHES.items() if n}
    want = {counter: cfg.num_layers} if counter else {}
    if launches != want:
        raise SystemExit(f"{arch} {dtype} prefill (B={LM_BATCH}, "
                         f"S={LM_PROMPT}): launches {launches}, expected "
                         f"{want or 'none'} and nothing else")
    prefill_ms, (logits, state) = prefills()
    pre = min(prefill_ms)
    out = {"arch": arch, "dtype": dtype, "layers": cfg.num_layers,
           "launches": launches, "prefill_ms": pre,
           "prefill_ms_runs": prefill_ms}
    text = traced = ""
    if decode:
        tok = logits.argmax(dim=-1)
        model.decode_step(state, tok, LM_PROMPT)      # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(LM_GEN):
            logits, state = model.decode_step(state, tok, LM_PROMPT + i)
            tok = logits.argmax(dim=-1)
        torch.cuda.synchronize()
        out["decode_ms_per_token"] = (time.perf_counter() - t0) * 1e3 / LM_GEN
        out["tokens_per_s"] = LM_BATCH * LM_GEN / (
            (pre + LM_GEN * out["decode_ms_per_token"]) / 1e3)
        text = (f"decode {out['decode_ms_per_token']:.3f} ms/token, "
                f"{out['tokens_per_s']:.1f} tok/s incl. prefill")
    if decode:
        # the card's idle share while decoding: the first positions again,
        # their slots of the state written anew
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(LM_TRACED_STEPS):
                logits, state = model.decode_step(state, tok,
                                                   LM_PROMPT + i)
                tok = logits.argmax(dim=-1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = device_time(prof)[0]
        del prof
        out.update(idle_share=1 - busy_ms / wall_ms,
                   traced_decode_steps=LM_TRACED_STEPS,
                   traced_decode_wall_ms=wall_ms, traced_busy_ms=busy_ms)
        traced = (f"; traced decode ({LM_TRACED_STEPS} steps): device busy "
                  f"{busy_ms:.2f} of {wall_ms:.2f} ms wall -> idle share "
                  f"{out['idle_share']:.4f}")
    del state, logits
    if trace:
        blocks = model.blocks
        if trace_layers is not None:
            model.blocks = blocks[:trace_layers]
        try:
            with labelled(torch, stages):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    model.prefill(tokens, cache_capacity=cap)
                    torch.cuda.synchronize()
        finally:
            model.blocks = blocks
        pre_dev, pre_flash, flash_seen, pre_mm = device_time(prof)
        n_traced = trace_layers or cfg.num_layers
        out.update(prefill_device_ms=pre_dev, prefill_flash_ms=pre_flash,
                   prefill_flash_launches_traced=flash_seen,
                   prefill_matmul_ms=pre_mm, traced_layers=n_traced,
                   flash_share_of_prefill=pre_flash / pre_dev if pre_dev
                   else None)
        split = ""
        if labels:
            out["prefill_stages"] = parts = stage_split(prof, labels)
            outside = pre_mm - sum(p["matmul_ms"] for p in parts.values())
            out["prefill_matmul_outside_stages_ms"] = outside
            out["prefill_rest_ms"] = rest = (
                pre_dev - pre_flash - outside
                - sum(p["ms"] for p in parts.values()))
            split = ("; by stage: " + ", ".join(
                f"{label} {p['ms']:.2f} ms in {p['launches']} launches "
                f"(matmuls {p['matmul_ms']:.2f})"
                for label, p in parts.items())
                + f", matmuls outside them {outside:.2f} ms, the rest "
                f"{rest:.2f} ms")
        del prof
        flash_text = (f"{flash.pattern} {pre_flash:.2f} ms in {flash_seen} "
                      f"of {n_traced} launches traced "
                      f"({out['flash_share_of_prefill'] or 0:.3f}), "
                      if flash else "no flash kernel, ")
        of = ("" if trace_layers is None
              else f" of its first {trace_layers} layers")
        traced = (f"traced prefill{of}: device {pre_dev:.2f} ms, "
                  f"{flash_text}matmuls {pre_mm:.2f} ms{split}" + traced)
    depth = "" if layers is None else f" ({layers} layers: a cut of depth)"
    print(f"[time] lm {arch}{depth} batch={LM_BATCH} prompt={LM_PROMPT} "
          f"gen={LM_GEN if decode else 0} {dtype}: one prefill launched "
          f"{launches or 'no kernel of the port'}; prefill {pre:.2f} ms "
          f"(runs {', '.join(f'{t:.2f}' for t in out['prefill_ms_runs'])})"
          + "".join(f"; {part}" for part in (text, traced.lstrip("; "))
                    if part)
          + f"; on {card}", flush=True)
    del model
    torch.cuda.empty_cache()
    return out


#: trace names: the fft kernel's launches (one CTA per row block, or the
#: two passes) and the matmuls' (cuBLAS and CUTLASS kernels)
FFT_TRACE_NAME = re.compile(r"(?<![a-z])fft_(pass[12]_)?kernel")
MATMUL_TRACE_NAME = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|cublas",
                               re.IGNORECASE)
#: fft_planes at fourierpim-lm's shapes (rows, n): a served prefill's x
#: (8 x 768 channel rows) and its taps (768 rows), padded to n = 4096
FOURIER_FFT_SHAPES = ((LM_BATCH * 768, 4096), (768, 4096))


def trace_split(torch, fn) -> dict:
    """One traced call of ``fn``: the device ms in all, in the fft kernel's
    launches (and how many the trace holds), in the matmuls, and the rest,
    with the rest's five largest kernels (ms, launches, name). The trace
    drops some or all events of the ctypes-launched kernels, so the fft
    kernel's traced time is a side figure: callers take its time from
    graph replays (``fft_at_lm_shapes``) and from the trace only the rest,
    whose kernels are PyTorch's own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"device_ms": 0.0, "fft_ms": 0.0, "fft_launches_traced": 0,
           "matmul_ms": 0.0}
    other = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        out["device_ms"] += ms
        if FFT_TRACE_NAME.search(e.key):
            out["fft_ms"] += ms
            out["fft_launches_traced"] += e.count
        elif MATMUL_TRACE_NAME.search(e.key):
            out["matmul_ms"] += ms
        else:
            other.append((ms, e.count, e.key[:100]))
    out["other_ms"] = out["device_ms"] - out["fft_ms"] - out["matmul_ms"]
    out["other_top"] = sorted(other, reverse=True)[:5]
    return out


def fft_at_lm_shapes(torch, kfft, radix: int, card: str) -> dict:
    """``fft_planes`` forward and inverse at FOURIER_FFT_SHAPES: == its
    plain version, then CUDA events around a CUDA-graph replay of the
    kernel and of ``torch.fft.fft`` / ``ifft`` on the complex tensors of
    the same planes, beside the bound (``work``)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    out = {}
    for rows, n in FOURIER_FFT_SHAPES:
        sets = [[torch.from_numpy(rng.standard_normal((rows, n)).astype(
            np.float32)).to(dev) for _ in range(2)]
            for _ in range(max(1, math.ceil(128e6 / (8 * rows * n))))]
        lib_sets = [(torch.complex(p, q),) for p, q in sets]
        nbytes, flops = work("fft_planes", n, rows, radix)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        for inverse in (False, True):
            def kern(p, q, inverse=inverse):
                return kfft.fft_planes(p, q, inverse=inverse, radix=radix)
            lib = torch.fft.ifft if inverse else torch.fft.fft
            got = kern(*sets[0])
            want = kfft.fft_planes_plain(*sets[0], inverse=inverse,
                                         radix=radix)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise SystemExit(f"fft_planes {rows} x {n} inverse="
                                 f"{inverse}: kernel and plain version "
                                 f"differ")
            del got, want
            reps = max(len(sets), 10)
            entry = {"rows": rows, "n": n, "inverse": inverse,
                     "radix": radix,
                     "graph_ms": graph_ms(torch, kern, sets, reps),
                     "library_graph_ms": graph_ms(torch, lib, lib_sets,
                                                  reps),
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "bytes": nbytes, "flops": flops}
            entry["share_of_bound"] = entry["bound_ms"] / entry["graph_ms"]
            entry["over_library"] = (entry["graph_ms"]
                                     / entry["library_graph_ms"])
            out[f"{rows}x{n}{' inverse' if inverse else ''}"] = entry
            print(f"[time] fft_planes at fourierpim-lm's shape {rows} x {n} "
                  f"{'inverse' if inverse else 'forward'} radix {radix} "
                  f"(graph replay, CUDA events): kernel "
                  f"{entry['graph_ms']:.4f} ms, torch.fft."
                  f"{'ifft' if inverse else 'fft'} "
                  f"{entry['library_graph_ms']:.4f} ms, bound "
                  f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}) -> "
                  f"{entry['share_of_bound']:.3f} of the bound, "
                  f"{entry['over_library']:.2f}x the library; kernel == "
                  f"plain; on {card}", flush=True)
        del sets, lib_sets
        torch.cuda.empty_cache()
    return out


def conv_timing(torch, kops, radix: int, card: str,
                fft_ms: float) -> dict:
    """``fft_causal_conv`` at the served prefill's shape (x (8, 768, 2048)
    fp32, taps (1, 768, 256)) by graph replay, against the same composite
    of ``torch.fft`` calls (pad, complex cast, fft of both, product, ifft,
    real part of the first T points); and the glue around its three fft
    launches (pads, the zero imaginary planes, the spectral product, the
    cut of the real part): the call's graph time less ``fft_ms``, the
    graph-replay time of its three fft launches. (A trace of the call
    late in a run may hold none of its kernels, the glue's included.)"""
    dev = torch.device("cuda")
    (xs, K), = [s for s in FOURIER_CONV_SHAPES if s[0][-1] == LM_PROMPT]
    g = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn(*xs, device=dev, generator=g)
    k = torch.randn(1, xs[1], K, device=dev, generator=g) * 0.02
    T = xs[-1]
    n = kops._next_pow2(T + K)
    pad = torch.nn.functional.pad
    tf = torch.fft

    def ours(x, k):
        return kops.fft_causal_conv(x, k, radix=radix)

    def composite(x, k):
        fa = tf.fft(pad(x, (0, n - T)).to(torch.complex64))
        fb = tf.fft(pad(k, (0, n - K)).to(torch.complex64))
        return tf.ifft(fa * fb)[..., :T].real

    err = float((ours(x, k) - composite(x, k)).abs().max())
    if err > FOURIER_OPS_TOL["atol"]:
        raise SystemExit(f"fft_causal_conv and the torch.fft composite "
                         f"differ by {err}")
    out = {"x": list(xs), "taps": K, "n": n, "radix": radix,
           "graph_ms": graph_ms(torch, ours, [(x, k)], 10),
           "library_graph_ms": graph_ms(torch, composite, [(x, k)], 10),
           "fft_graph_ms": fft_ms, "vs_library_max_abs": err}
    out["glue_ms"] = out["graph_ms"] - fft_ms
    print(f"[time] fft_causal_conv x {xs} taps {K} (n = {n}, radix "
          f"{radix}): graph replay {out['graph_ms']:.4f} ms against the "
          f"torch.fft composite's {out['library_graph_ms']:.4f} ms; its "
          f"three fft launches {fft_ms:.4f} ms (graph replays at their "
          f"shapes), the glue {out['glue_ms']:.4f} ms; |ours - "
          f"composite|max {err:.3g}; on {card}", flush=True)
    del x, k
    torch.cuda.empty_cache()
    return out


def fourier_timing(torch, build, convert, lm, kfft, kops, get_config,
                   card: str, radix: int) -> dict:
    """fourierpim-lm's cell at full width (bf16, batch LM_BATCH x
    LM_PROMPT, LM_GEN tokens): the prefill's launches (the counters zeroed
    just before a warm prefill: fft_planes three times a layer, nothing
    else), prefill ms (CUDA events, best of 3), decode ms per token (host
    clock around work that ends in a synchronize) and tok/s; the prefill's device time
    split into the fft kernel (``fft_at_lm_shapes``' graph replays of its
    three launches a layer), the matmuls and the rest (a traced prefill),
    and the convolution's glue (``conv_timing``, per call, times the
    layers); a traced generate for the card's idle share, its fft
    launches counted as in the prefill."""
    dev = torch.device("cuda")
    cfg = get_config(FOURIER_ARCH)
    model = convert.build(cfg, full_width_state(torch, convert, cfg), dev)
    torch.cuda.empty_cache()
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    cap = LM_PROMPT + LM_GEN
    torch.cuda.synchronize()
    build.reset_launches()
    model.prefill(tokens, cache_capacity=cap)
    torch.cuda.synchronize()
    launches = {k: n for k, n in build.LAUNCHES.items() if n}
    if launches != {"fft_planes": 3 * cfg.num_layers}:
        raise SystemExit(f"{FOURIER_ARCH} prefill (B={LM_BATCH}, "
                         f"S={LM_PROMPT}): launches {launches}, expected "
                         f"fft_planes {3 * cfg.num_layers} times and "
                         f"nothing else")
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        logits, state = model.prefill(tokens, cache_capacity=cap)
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end))
    pre = min(runs)
    tok = logits.argmax(dim=-1)
    model.decode_step(state, tok, LM_PROMPT)          # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(LM_GEN):
        logits, state = model.decode_step(state, tok, LM_PROMPT + i)
        tok = logits.argmax(dim=-1)
    torch.cuda.synchronize()
    decode = (time.perf_counter() - t0) * 1e3 / LM_GEN
    del state, logits
    split = trace_split(torch, lambda: model.prefill(tokens,
                                                     cache_capacity=cap))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lm.generate(model, tokens, LM_GEN)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # busy: the traced kernels but the fft kernel's, whose launches (one
    # prefill's) are counted from their graph replays below
    busy_traced = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not FFT_TRACE_NAME.search(e.key)) / 1e3
    del model
    torch.cuda.empty_cache()
    # the fft kernel's time in a prefill from graph replays at its shapes:
    # each layer transforms the 6144 channel rows forward, the 768 tap rows
    # forward and the 6144 product rows back
    shapes = fft_at_lm_shapes(torch, kfft, radix, card)
    (x_rows, n), (k_rows, _) = FOURIER_FFT_SHAPES
    fft_layer = (shapes[f"{x_rows}x{n}"]["graph_ms"]
                 + shapes[f"{k_rows}x{n}"]["graph_ms"]
                 + shapes[f"{x_rows}x{n} inverse"]["graph_ms"])
    conv = conv_timing(torch, kops, radix, card, fft_layer)
    glue = conv["glue_ms"] * cfg.num_layers
    fft = fft_layer * cfg.num_layers
    device = split["device_ms"] - split["fft_ms"] + fft
    busy = busy_traced + fft
    out = {"arch": FOURIER_ARCH, "dtype": cfg.dtype, "launches": launches,
           "prefill_ms": pre, "prefill_ms_runs": runs,
           "decode_ms_per_token": decode,
           "tokens_per_s": LM_BATCH * LM_GEN / ((pre + LM_GEN * decode)
                                                / 1e3),
           "traced_prefill": split, "fft_ms_per_prefill": fft,
           "device_ms_per_prefill": device,
           "fft_share_of_prefill": fft / device,
           "matmul_share_of_prefill": split["matmul_ms"] / device,
           "conv_glue_ms_per_prefill": glue,
           "glue_share_of_prefill": glue / device,
           "idle_share": 1 - busy / wall, "traced_generate_wall_ms": wall,
           "traced_busy_ms": busy, "conv": conv, "fft_at_lm_shapes": shapes}
    print(f"[time] lm {FOURIER_ARCH} batch={LM_BATCH} prompt={LM_PROMPT} "
          f"gen={LM_GEN} {cfg.dtype}: one prefill launched {launches}; "
          f"prefill {pre:.2f} ms (runs {', '.join(f'{t:.2f}' for t in runs)}"
          f"), decode {decode:.3f} ms/token, {out['tokens_per_s']:.1f} tok/s "
          f"incl. prefill; prefill device time {device:.2f} ms: the fft "
          f"kernel {fft:.2f} ms (graph replays at its shapes, "
          f"{cfg.num_layers} layers; "
          f"{out['fft_share_of_prefill']:.3f}; the trace held "
          f"{split['fft_launches_traced']} of its "
          f"{launches['fft_planes']} launches, {split['fft_ms']:.2f} ms), "
          f"traced: matmuls "
          f"{split['matmul_ms']:.2f} ms ({out['matmul_share_of_prefill']:.3f}"
          f"), the rest {split['other_ms']:.2f} ms, of which the "
          f"convolution's glue {glue:.2f} ms "
          f"({out['glue_share_of_prefill']:.3f}; {conv['glue_ms']:.4f} ms "
          f"a layer; the rest's largest kernels "
          f"{[(round(ms, 3), c, k) for ms, c, k in split['other_top']]}); "
          f"traced generate: device "
          f"busy {busy:.2f} of {wall:.2f} ms wall -> idle share "
          f"{out['idle_share']:.4f}; on {card}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 5: the cost model on the card
# ---------------------------------------------------------------------------

#: the kernel (launch counter) each served route runs: the routes of
#: TRANSFORM_KERNELS, and the two complex-packing routes auto mode binds
#: where the cost model picks complex packing for a real op
ROUTE_COUNTER = {**{route: name
                    for name, (route, _, _) in TRANSFORM_KERNELS.items()
                    if route is not None},
                 "rfft-complex": "fft_planes",
                 "polymul-real-complex": "polymul_complex_planes"}
#: the kernel whose phase-4 bound each workload's candidates are read beside
WORKLOAD_KERNEL = {"fft": "fft_planes", "rfft": "rfft_planes",
                   "polymul": "polymul_complex_planes",
                   "polymul-real": "polymul_real_planes",
                   "polymul-mod": "ntt_polymul"}
#: requests of the auto engine run (the five ops at both serve lengths)
AUTO_REQUESTS = 400
#: rows of each timed candidate's first input set checked against the
#: registry's numpy oracle (every row for the complex-packing routes, which
#: the engine run below does not serve)
AUTO_CHECK_ROWS = 8


def paper_gpu_model(times: dict, fourier_times: dict, card: str) -> dict:
    """(a) The paper's cuFFT model (``gpu_model``, bandwidth-bound passes
    at 0.90 of the peak) on the H100 config beside what phase 4 measured:
    ``torch.fft.fft`` and ``fft_planes`` at batch 64 and at fourierpim-lm's
    6144 x 4096, the products against their cuFFT composites, and
    FourierPIM-8/40's modelled throughput over the card's measured
    ``torch.fft.fft`` and over the port's kernel. No timing here: the
    measured numbers are phase 4's."""
    from repro_torch.core import pim
    from repro_torch.core.pim import gpu_model
    from repro_torch.core.pim.hopper import H100
    word = pim.FULL_COMPLEX_BITS // 8
    b = SERVE_BATCH
    out: dict = {"gpu": dataclasses.asdict(H100)}

    def row(label, model_ms, lib_ms, lib_graph_ms, kern_ms, kern_graph_ms,
            lib_name):
        entry = {"model_ms": model_ms, "library_ms": lib_ms,
                 "library_graph_ms": lib_graph_ms, "kernel_ms": kern_ms,
                 "kernel_graph_ms": kern_graph_ms,
                 "library_over_model": lib_ms / model_ms,
                 "kernel_over_model": kern_ms / model_ms}
        print(f"[cost model] (a) {label}: the paper's cuFFT model on the "
              f"H100 config {model_ms:.4f} ms; measured {lib_name} "
              f"{lib_ms:.4f} ms (graph replay {lib_graph_ms:.4f}) = "
              f"{entry['library_over_model']:.2f}x the model; the port's "
              f"kernel {kern_ms:.4f} ms (graph replay {kern_graph_ms:.4f})"
              f" = {entry['kernel_over_model']:.2f}x; on {card}",
              flush=True)
        return entry

    for n in SERVE_NS:
        t = times["fft_planes"][n]
        out[f"fft n={n}"] = row(
            f"fft batch {b} n={n} ({H100.fft_passes(n, word)} pass(es))",
            gpu_model.fft_time_s(n, H100, word) * b * 1e3,
            t["library_ms"], t["library_graph_event_ms"], t["ms"],
            t["graph_event_ms"], "torch.fft.fft")
        for name, real in (("polymul_complex_planes", False),
                           ("polymul_real_planes", True)):
            t = times[name][n]
            out[f"{name} n={n}"] = row(
                f"{'real' if real else 'complex'} product batch {b} n={n}",
                gpu_model.polymul_time_s(n, H100, word, real=real) * b
                * 1e3, t["library_ms"], t["library_graph_event_ms"],
                t["ms"], t["graph_event_ms"], t["library"])
    (rows, n), _ = FOURIER_FFT_SHAPES
    s = fourier_times["fft_at_lm_shapes"][f"{rows}x{n}"]
    out[f"fft {rows}x{n}"] = row(
        f"fft {rows} x {n} (fourierpim-lm's rows)",
        gpu_model.fft_time_s(n, H100, word) * rows * 1e3,
        s["library_graph_ms"], s["library_graph_ms"], s["graph_ms"],
        s["graph_ms"], "torch.fft.fft (graph replay)")
    for n in SERVE_NS:
        t = times["fft_planes"][n]
        card_rate = b / (t["library_ms"] / 1e3)
        kernel_rate = b / (t["ms"] / 1e3)
        model_rate = gpu_model.fft_throughput_per_s(n, H100, word)
        for cfg in (pim.FOURIERPIM_8, pim.FOURIERPIM_40):
            rate = pim.fft_throughput_per_s(n, cfg, pim.FP32)
            entry = out[f"{cfg.name} n={n}"] = {
                "pim_per_s": rate, "torch_fft_per_s": card_rate,
                "fft_planes_per_s": kernel_rate,
                "h100_model_per_s": model_rate,
                "over_torch_fft": rate / card_rate,
                "over_fft_planes": rate / kernel_rate,
                "over_h100_model": rate / model_rate}
            print(f"[cost model] (a) {cfg.name} fft n={n} fp32: "
                  f"{rate:.4g} transforms/s (the paper's closed forms) = "
                  f"{entry['over_torch_fft']:.3f}x the card's measured "
                  f"torch.fft.fft ({card_rate:.4g}/s), "
                  f"{entry['over_fft_planes']:.3f}x the port's fft_planes "
                  f"({kernel_rate:.4g}/s), {entry['over_h100_model']:.3f}x "
                  f"the H100 model ({model_rate:.4g}/s); the paper reports "
                  f"5-15x over the RTX 3070 and the A100; on {card}",
                  flush=True)
    return out


def auto_vs_card(torch, op_registry, core_fft, times: dict,
                 card: str) -> dict:
    """(b) For each workload at batch 64 and both serve lengths: the cost
    model's predicted seconds for each candidate on both backends, and the
    candidate's route as auto mode binds it, checked against the
    registry's numpy oracle and timed on the card by CUDA events around a
    CUDA-graph replay; whether the predicted-best packing is the measured
    best (a disagreement is printed, not raised); the model's card term
    beside the kernel's phase-4 bound."""
    rng = np.random.default_rng(21)
    b = SERVE_BATCH
    out: dict = {}
    for wl in WORKLOAD_KERNEL:
        spec = op_registry.get_op(wl)
        for n in SERVE_NS:
            cost = core_fft.plan(n, b, workload=wl).cost
            measured = {}
            for c in cost["candidates"]:
                ctx = op_registry.OpContext(auto=True, packings=(c["real"],))
                bound = spec.bind(n, ctx, batch=b, device="cuda")
                itemsize = np.dtype(bound.payload_dtype).itemsize
                n_sets = max(2, math.ceil(
                    128e6 / (spec.arity * b * n * itemsize)))
                payloads = [[bound.random_payload(rng) for _ in range(b)]
                            for _ in range(n_sets)]
                sets = [bound.stack(p) for p in payloads]
                rows = bound.to_numpy(bound.fn(*sets[0]))
                checked = (b if bound.route.endswith("complex")
                           else AUTO_CHECK_ROWS)
                for payload, got in zip(payloads[0][:checked], rows):
                    bound.verify(payload, got)
                ms = graph_ms(torch, bound.fn, sets, max(len(sets), 20))
                cuda = c["backends"]["cuda"]["total_s"]
                pim = c["backends"]["pim"].get("total_s")
                packing = ("real" if c["real"] else "complex"
                           if len(cost["candidates"]) > 1 else "its one")
                measured[c["real"]] = ms
                out[f"{wl} n={n} {packing}"] = entry = {
                    "route": bound.route, "graph_ms": ms,
                    "predicted_cuda_s": cuda, "predicted_pim_s": pim,
                    "pim_infeasible": c["backends"]["pim"].get("infeasible"),
                    "predicted_s": c["total_s"],
                    "backend_best": c["backend_best"],
                    "measured_over_cuda_model": ms / 1e3 / cuda,
                    "rows_checked": checked}
                print(f"[cost model] (b) {wl} n={n} batch {b} {packing} "
                      f"packing, route {bound.route}: predicted "
                      f"cuda {cuda:.6g} s, pim "
                      + (f"{pim:.6g} s" if pim is not None
                         else "infeasible")
                      + f" (best {c['backend_best']}); measured "
                      f"{ms:.4f} ms a batch (graph replay) = "
                      f"{entry['measured_over_cuda_model']:.2f}x the card "
                      f"term; {checked} rows == the numpy oracle; on {card}",
                      flush=True)
                del sets
            predicted = cost["best"]["real"]
            best = min(measured, key=measured.get)
            kernel = times[WORKLOAD_KERNEL[wl]][n]
            model_ms = cost["best"]["backends"]["cuda"]["total_s"] * 1e3
            out[f"{wl} n={n}"] = summary = {
                "predicted_best_real": predicted,
                "measured_best_real": best, "agree": predicted == best,
                "cuda_model_ms": model_ms,
                "kernel_bound_ms": kernel["bound_ms"],
                "model_over_bound": model_ms / kernel["bound_ms"]}
            print(f"[cost model] (b) {wl} n={n}: predicted-best packing "
                  f"{'real' if predicted else 'complex'}, measured best "
                  f"{'real' if best else 'complex'}: "
                  f"{'agree' if summary['agree'] else 'DISAGREE'}; the "
                  f"model's card term {model_ms:.4f} ms against the "
                  f"kernel's bound {kernel['bound_ms']:.4f} ms "
                  f"({summary['model_over_bound']:.3f}); on {card}",
                  flush=True)
            torch.cuda.empty_cache()
    return out


def auto_engine(torch, build, serve, card: str) -> dict:
    """(c) ``serve --service engine --auto`` over the five ops at both
    serve lengths: the CLI's engine (``serve.engine_for``), warmed up, the
    launch counters zeroed just before AUTO_REQUESTS requests; every
    result checked against its numpy oracle (``polymul-mod`` bit for bit),
    each route kernel's launches == its dispatched batches and no other
    kernel launched, and each bucket's predicted against observed
    seconds per request."""
    args = serve.parse_args([
        "--service", "engine", "--auto", "--ops",
        ",".join(WORKLOAD_KERNEL), "--ns", ",".join(map(str, SERVE_NS)),
        "--batch", str(SERVE_BATCH), "--requests", str(AUTO_REQUESTS),
        "--device", "cuda"])
    engine, combos = serve.engine_for(args)
    engine.warmup()
    torch.cuda.synchronize()
    build.reset_launches()
    kept, stats = serve.produce(engine, combos, args.requests,
                                np.random.default_rng(5))
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    for rid, (op, n, payload) in kept.items():
        engine.bound(op, n).verify(payload, engine.results[rid])
    expected = collections.Counter()
    for bucket in stats["buckets"].values():
        expected[ROUTE_COUNTER[bucket["route"]]] += bucket["batches"]
    if stats["served"] != AUTO_REQUESTS or launches != dict(expected):
        raise SystemExit(f"auto engine: served {stats['served']} of "
                         f"{AUTO_REQUESTS}; launches {launches}, expected "
                         f"one per dispatched batch of each route "
                         f"{dict(expected)}")
    serve.print_engine_stats(stats)
    print(f"[cost model] (c) serve --service engine --auto: "
          f"{stats['served']} requests, every result verified, launches "
          f"{launches} == dispatched batches per route kernel; on {card}",
          flush=True)
    return {"launches": launches, "stats": {
        k: v for k, v in stats.items() if k != "buckets"},
        "buckets": {name: {k: v for k, v in bucket.items()
                           if k != "batch_sizes"}
                    for name, bucket in stats["buckets"].items()}}


def start_ptxas_report(build, source: str):
    """A second nvcc of ``source`` with ``-Xptxas -v``, started beside the
    build: ptxas's registers, shared memory and spills per kernel."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = os.path.splitext(os.path.basename(source))[0]
    out = build.BUILD_DIR / f"{stem}-ptxas-{os.getpid()}.so"
    proc = subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
         os.path.join(ROOT, source)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return out, proc


def kernel_report(ptxas, source: str) -> dict[str, dict]:
    """Registers and spill bytes of every kernel of ``source`` from
    ptxas's report, one line each: {kernel: {"registers", "spill_stores",
    "spill_loads"}}."""
    out, proc = ptxas
    stdout, stderr = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"nvcc -Xptxas -v of {source} failed:\n"
                         f"{stdout}\n{stderr}")
    out.unlink()
    def demangle(symbol):
        """The kernel's own <length><name>: the innermost one that ends in
        _kernel (the anonymous namespace before it may hold digits)."""
        names = [symbol[m.end():m.end() + int(m.group(1))]
                 for m in re.finditer(r"(\d+)(?=[A-Za-z_])", symbol)]
        names = [n for n in names if n.endswith("_kernel")]
        return min(names, key=len) if names else symbol

    kernels, name = {}, None
    for line in (stdout + stderr).splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = demangle(entry.group(1))
            kernels[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                      r"bytes spill loads", line)):
            kernels[name].update(spill_stores=int(m.group(1)),
                                 spill_loads=int(m.group(2)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            kernels[name]["registers"] = int(m.group(1))
    for name, k in kernels.items():
        print(f"[build] ptxas {name}: {k.get('registers')} registers, "
              f"{k.get('spill_stores')} bytes spill stores, "
              f"{k.get('spill_loads')} bytes spill loads", flush=True)
    return kernels


#: The template arguments of a tensor-core kernel instance in its mangled
#: name: WgCfg<head_dim, keys per tile, stages> (bf16) or Tf32Cfg<head_dim,
#: keys per tile, stages, head_dim split> (fp32).
TC_INSTANCE = re.compile(
    r"(WgCfg|Tf32Cfg)ILi(\d+)ELi(\d+)ELi(\d+)E(?:Lb([01])E)?E")
#: tensor-core instances in attention.cu: bf16 and fp32 at hd 32, 64, 128
#: and 320
TC_INSTANCES = 8
TC_KERNELS = ("flash_attention_wgmma_kernel", "flash_attention_tf32_kernel")


def tc_instance(symbol: str) -> str | None:
    """'bf16 hd 320, 48 keys, 2 stages' or 'tf32 hd 320, 8 keys, 3 stages,
    head_dim split' for a tensor-core kernel instance's mangled name."""
    m = TC_INSTANCE.search(symbol)
    if m is None:
        return None
    cfg, hd, keys, stages, split = m.groups()
    name = (f"{'tf32' if cfg == 'Tf32Cfg' else 'bf16'} hd {hd}, {keys} keys, "
            f"{stages} stages")
    return name + (", head_dim split" if split == "1" else "")


def tc_kernel_report(ptxas, library) -> dict:
    """Print ptxas's report for each instance of the two tensor-core flash
    kernels (registers, shared memory, spills, and any warning) and the
    count of HGMMA (wgmma) and UTMALDG (TMA load) instructions in its SASS
    (``cuobjdump -sass`` of the attention library). Fails if an instance's
    SASS holds no HGMMA. Returns the lines and, per instance, its
    registers, spill bytes and SASS counts."""
    out, proc = ptxas
    stdout, stderr = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"nvcc -Xptxas -v of {ATTENTION} failed:\n"
                         f"{stdout}\n{stderr}")
    out.unlink()
    report, instances, keep = [], {}, None
    for line in (stdout + stderr).splitlines():
        if "Compiling entry function" in line:
            keep = tc_instance(line) \
                if any(k in line for k in TC_KERNELS) else None
            if keep:
                instances[keep] = {}
        if keep and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                    r"bytes spill loads", line)):
            instances[keep].update(spill_stores=int(m.group(1)),
                                   spill_loads=int(m.group(2)))
        elif keep and (m := re.search(r"Used (\d+) registers", line)):
            instances[keep]["registers"] = int(m.group(1))
        if keep or "warning" in line.lower():
            report.append(line.strip())
    for line in report:
        print(f"[build] ptxas: {line}", flush=True)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(cuobjdump):
        print("[build] cuobjdump is missing: no SASS count of HGMMA and "
              "UTMALDG", flush=True)
        return {"ptxas": report, "instances": instances, "sass": None}
    sass = subprocess.run([cuobjdump, "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            if not any(k in fn for k in TC_KERNELS):
                fn = None
            else:
                counts[fn] = {"HGMMA": 0, "UTMALDG": 0}
        elif fn is not None:
            for op in ("HGMMA", "UTMALDG"):
                counts[fn][op] += line.count(op)
    for fn, c in counts.items():
        name = tc_instance(fn)
        if name in instances:
            instances[name].update(c)
        print(f"[build] SASS {name or fn}: {c['HGMMA']} HGMMA, "
              f"{c['UTMALDG']} UTMALDG", flush=True)
    for name, k in instances.items():
        print(f"[build] tensor-core instance {name}: {k.get('registers')} "
              f"registers, {k.get('spill_stores')} / {k.get('spill_loads')} "
              f"bytes spill stores / loads, {k.get('HGMMA')} HGMMA, "
              f"{k.get('UTMALDG')} UTMALDG", flush=True)
    if len(counts) < TC_INSTANCES or not all(c["HGMMA"]
                                             for c in counts.values()):
        raise SystemExit(f"tensor-core flash kernels: an instance without "
                         f"HGMMA in its SASS ({counts})")
    return {"ptxas": report, "instances": instances, "sass": counts}


# ---------------------------------------------------------------------------
# --tile-ab: the fp32 hd-32 instance's key tile and stages, in turns
# ---------------------------------------------------------------------------

#: (keys per tile, stages) of the tf32 kernel's hd-32 instance: 64 keys at
#: 2, 3 and 4 stages and 128 at 2 (Q_lo takes 16 KB and a stage 640 bytes
#: a key, so 128 keys leave no room for a third), and 32 keys at 4
TILE_AB = ((64, 2), (64, 3), (64, 4), (128, 2), (32, 4))
#: builds of the shipped tile with attention.cu's TF32_PROBE bits, which
#: drop work and so give wrong results (not checked): where the time goes
TILE_PROBES = {"products and prep, no softmax or split of p": 1,
               "no prep of K and V": 2, "products alone": 3}
#: timed calls a turn; the order is the builds, the CUDA-core kernel
#: twice, then the builds backwards
TILE_AB_REPS = 20
#: beside the timed shape, each TILE_AB choice is held against its plain
#: version at a ragged S under window 24 and at S < 64: (B, S, H, KV,
#: window)
TILE_AB_CHECKS = ((2, 1000, 16, 8, 24), (3, 37, 16, 8, 1 << 30))


def build_tile_variants(build, variants: dict) -> dict:
    """``attention.cu`` built once per entry of ``variants`` (label -> its
    ``-D`` flags), with ``-Xptxas -v``, into ``build/``, every nvcc started
    together: {label: (its ``flash_attention_tf32``, its
    ``attention_occupancy``, ptxas's registers and spill bytes of its tf32
    hd-32 instance, that instance's name)}."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, (label, flags) in enumerate(variants.items()):
        out = build.BUILD_DIR / f"attention-tile-{n}-{os.getpid()}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", *flags,
               "-o", str(out), os.path.join(ROOT, ATTENTION)]
        procs[label] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    built = {}
    for label, (out, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc of {ATTENTION} for {label} failed:\n"
                             f"{stdout}\n{stderr}")
        ptxas, instance, keep = {}, None, False
        for line in (stdout + stderr).splitlines():
            if "Compiling entry function" in line:
                name = tc_instance(line)
                keep = bool(name) and name.startswith("tf32 hd 32,")
                instance = name if keep else instance
            elif keep and (m := re.search(r"(\d+) bytes spill stores, "
                                          r"(\d+) bytes spill loads", line)):
                ptxas.update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
            elif keep and (m := re.search(r"Used (\d+) registers", line)):
                ptxas["registers"] = int(m.group(1))
        lib = ctypes.CDLL(str(out))
        fn = lib.flash_attention_tf32
        fn.argtypes = build.LIBRARIES["attention"]["flash_attention_tf32"][1]
        fn.restype = ctypes.c_int
        occ = lib.attention_occupancy
        occ.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 4
        occ.restype = ctypes.c_int
        built[label] = (fn, occ, ptxas, instance)
    return built


def tile_launch(torch, fn, q, k, v, *, window: int, scale: float):
    """One causal launch of a ``build_tile_variants`` build's tf32 launcher
    on (B, S, H, 32) fp32 q and (B, S, KV, 32) k, v; raises if the launch is
    refused."""
    B, S, H, hd = q.shape
    o = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S,
             H, k.shape[2], hd, *q.stride()[:3], *k.stride()[:3],
             *v.stride()[:3], *o.stride()[:3], min(window, 1 << 30), 1,
             float(scale), 0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"flash_attention_tf32 of a --tile-ab build: launch "
                         f"failed with CUDA error {err}")
    return o


def tile_ab(torch, kattn, build, card: str) -> dict:
    """The A/B of TILE_AB at ATTN_TIMED["fp32 hd 32"]'s shape: each choice
    held against the plain version folded at its key tile (within
    ATTN_TOL, at that shape and at TILE_AB_CHECKS); then every choice, the
    TILE_PROBES builds and the CUDA-core kernel timed by CUDA events on the
    same inputs in turns, each beside its registers, spills, shared memory
    and CTAs an SM, and the bound (three times the pairs' flops over 495
    TFLOP/s TF32)."""
    t0 = time.perf_counter()
    variants = {f"{keys} keys, {stages} stages":
                [f"-DTF32_HD32_KEYS={keys}", f"-DTF32_HD32_STAGES={stages}"]
                for keys, stages in TILE_AB}
    variants.update({f"probe: {label}": [f"-DTF32_PROBE={bits}"]
                     for label, bits in TILE_PROBES.items()})
    built = build_tile_variants(build, variants)
    print(f"[tile ab] {len(built)} builds of {ATTENTION} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    _, (B, S, H, KV, hd, dtype, window) = ATTN_TIMED["fp32 hd 32"]
    scale = hd ** -0.5
    sets = [attention_inputs(torch, B, S, H, KV, hd, dtype, 200 + i)
            for i in range(2)]
    results = {}
    for label, (fn, occ, ptxas, instance) in built.items():
        errs = []
        if not label.startswith("probe"):
            keys = int(label.split()[0])
            for i, (b, s, h, kv, w) in enumerate(((B, S, H, KV, window),)
                                                 + TILE_AB_CHECKS):
                q, k, v = sets[0] if i == 0 else attention_inputs(
                    torch, b, s, h, kv, hd, dtype, 300 + i)
                got = tile_launch(torch, fn, q, k, v, window=w, scale=scale)
                want = kattn.attention_plain(q, k, v, window=w, scale=scale,
                                             kv_block=keys, kernel="tf32")
                torch.cuda.synchronize()
                errs.append(float((got - want).abs().max()))
                if not torch.allclose(got, want, **ATTN_TOL[dtype]):
                    raise SystemExit(f"tf32 hd 32, {label}, B={b} S={s} "
                                     f"window={w}: kernel and plain version "
                                     f"differ by {errs[-1]}")
        out = [ctypes.c_int() for _ in range(4)]
        err = occ(2, hd, 0, 0, *(ctypes.byref(x) for x in out))
        if err:
            raise SystemExit(f"attention_occupancy of {label}: CUDA error "
                             f"{err}")
        results[label] = {
            "instance": instance, "max_abs_err": max(errs, default=None),
            **ptxas, **dict(zip(("threads", "smem_bytes", "regs",
                                 "ctas_per_sm"), (x.value for x in out))),
            "turns": []}
    calls = {label: functools.partial(tile_launch, torch, built[label][0],
                                      window=window, scale=scale)
             for label in results}
    core = functools.partial(cuda_core_on, torch, build, scale=scale,
                             window=window)
    core_turns = []
    order = list(calls)
    for label in order + [None, None] + order[::-1]:
        fn = core if label is None else calls[label]
        t = time_ms(torch, fn, sets, TILE_AB_REPS)
        (core_turns if label is None else results[label]["turns"]).append(t)
    pairs = sum(min(q + 1, window) for q in range(S))
    bound = 3 * 4 * hd * pairs * B * H / TF32_FLOPS_PER_S * 1e3
    for label, r in results.items():
        r.update(ms=min(r["turns"]), bound_ms=bound,
                 over_bound=min(r["turns"]) / bound)
        err = ("not checked (a probe)" if r["max_abs_err"] is None
               else f"{r['max_abs_err']:.3g}")
        print(f"[tile ab] {r['instance']} ({label}): event ms "
              + ", ".join(f"{t:.4f}" for t in r["turns"])
              + f" (best {r['ms']:.4f}; bound {bound:.4f}, 3 x TF32 flops: "
              f"{r['over_bound']:.2f}x); |kernel-plain|max {err}; "
              f"{r.get('registers')} registers, {r.get('spill_stores')} / "
              f"{r.get('spill_loads')} bytes spill stores / loads, "
              f"{r['smem_bytes']} B shared, {r['ctas_per_sm']} CTA/SM; B={B} "
              f"S={S} H={H} KV={KV} causal; on {card}", flush=True)
    best = min((label for label in results if not label.startswith("probe")),
               key=lambda label: results[label]["ms"])
    print(f"[tile ab] CUDA-core kernel on the same inputs: event ms "
          + ", ".join(f"{t:.4f}" for t in core_turns) + f"; fastest tile: "
          f"{best}; on {card}", flush=True)
    return {"card": card, "shape": {"B": B, "S": S, "H": H, "KV": KV,
                                    "hd": hd, "dtype": dtype,
                                    "causal": True, "window": window},
            "builds": results, "cuda_core_turns": core_turns,
            "fastest": best}


# ---------------------------------------------------------------------------
# Phase 6: fault tolerance on the card
# ---------------------------------------------------------------------------

#: (a): requests a bucket (three full batches of 64), two batches for RNS
FT_REQUESTS, FT_RNS_REQUESTS = 3 * SERVE_BATCH, 2 * SERVE_BATCH
#: (b): the chaos run's ops at n = 4096, its requests, transient rate and
#: seed; ``--inject-stuck 1`` makes every array's fault permanent
FT_CHAOS_OPS = ("fft", "polymul-real", "polymul-mod")
FT_CHAOS_REQUESTS, FT_CHAOS_RATE, FT_CHAOS_SEED = 600, 1e-9, 11
#: (c): the drain's snapshot directory (``build/`` is not committed)
FT_SNAPSHOTS = os.path.join(ROOT, "build", "chip_smoke_snapshots")
FT_SUBPROCESS_S = 300
#: (d): the elastic run's watchdog flags and straggler. A batch of four
#: rows at n = 4096 takes a fraction of a millisecond, and the host's own
#: jitter (the producer thread holds the GIL for milliseconds at a time) is
#: many times that, so the threshold is 50x the EWMA and an eviction needs
#: three flags in a row; each straggling launch sleeps a second, far above
#: 50x any clean batch. The first straggler is served batch 7 (K less the
#: one bucket, plus 1): a batch's sample holds the next batch's launch, so
#: batch 6 would put a sleep into the watchdog's fifth warmup sample.
FT_ELASTIC_FLAGS = ("--watchdog-threshold", "50", "--watchdog-evict-after",
                    "3", "--watchdog-warmup", "5", "--inject-straggler-ms",
                    "1000", "--inject-straggler-after", "7")


def ft_traffic(engine, combos, per_bucket: int, seed: int) -> list[tuple]:
    """per_bucket payloads for each bucket, round-robin, made once so that
    every turn serves the same traffic."""
    rng = np.random.default_rng(seed)
    return [(op, n, engine.bound(op, n).random_payload(rng))
            for _ in range(per_bucket) for op, n in combos]


def ft_turn(torch, build, engine, traffic, label: str, card: str,
            check_all: bool) -> dict:
    """Serve ``traffic`` once, every request submitted before the run, the
    launch counters zeroed just before; check the results (all of them, or
    the first of each bucket), the launches against the batches and, when
    verified, that every batch was checked and none failed. The engine
    keeps this turn's results only."""
    before = engine.stats(seconds=1, busy_s=1)["buckets"]
    engine.results.clear()
    torch.cuda.synchronize()
    build.reset_launches()
    rids = [engine.submit(op, n, payload) for op, n, payload in traffic]
    stats = engine.run(engine._served + len(traffic))
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    lat = np.asarray(list(engine._latencies_s)[-len(traffic):]) * 1e3
    seen = set()
    for rid, (op, n, payload) in zip(rids, traffic):
        if check_all or (op, n) not in seen:
            engine.bound(op, n).verify(payload, engine.results[rid])
            seen.add((op, n))
    expected = collections.Counter()
    for name, b in stats["buckets"].items():
        batches = b["batches"] - before[name]["batches"]
        expected[ROUTE_COUNTER[b["route"]]] += batches
        integ, was = b["integrity"], before[name]["integrity"]
        if engine.verified and (
                integ["checked"] - was["checked"] != batches
                or integ["corrupted"] or integ["retried"]
                or integ["fell_back"]):
            raise SystemExit(f"[ft] {label} {name}: {batches} batches but "
                             f"integrity {integ} (before {was}): a clean "
                             f"verified run must check every batch once "
                             f"and detect nothing")
    if launches != dict(expected):
        raise SystemExit(f"[ft] {label}: launches {launches}, expected one "
                         f"per dispatched batch {dict(expected)}")
    turn = {"requests": len(traffic), "seconds": stats["seconds"],
            "req_per_s": len(traffic) / stats["seconds"],
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "launches": launches}
    print(f"[ft] (a) {label}: {len(traffic)} requests, "
          f"{'every result' if check_all else 'one result a bucket'} == its "
          f"oracle, launches {launches} == batches; "
          f"{turn['req_per_s']:.1f} req/s p50={turn['p50_ms']:.3f}ms "
          f"p99={turn['p99_ms']:.3f}ms; on {card}", flush=True)
    return turn


def ft_check_cost(engine, traffic, card: str) -> dict:
    """Per bucket, ``BoundOp.integrity`` timed alone over each delivered
    batch of 64 rows (the rows of the engine's last turn), the worst
    residual over them against its tolerance (``abft.FLOAT_TOL``; 0 for
    the exact checks)."""
    rows: dict[tuple, list] = collections.defaultdict(list)
    for rid, (op, n, payload) in zip(sorted(engine.results), traffic):
        rows[op, n].append((payload, engine.results[rid]))
    out = {}
    for (op, n), items in rows.items():
        bound = engine.bound(op, n)
        ms, worst = [], 0.0
        for i in range(0, len(items), SERVE_BATCH):
            payloads = [p for p, _ in items[i:i + SERVE_BATCH]]
            batch = np.stack([r for _, r in items[i:i + SERVE_BATCH]])
            t = time.perf_counter()
            verdict = bound.integrity(payloads, batch)
            ms.append((time.perf_counter() - t) * 1e3)
            if not verdict.ok:
                raise SystemExit(f"[ft] {op} n={n}: clean rows fail their "
                                 f"check: {verdict}")
            worst = max(worst, verdict.residual)
        out[f"{bound.route}/n={n}"] = {
            "check": verdict.check, "ms_per_batch": float(np.mean(ms)),
            "batches": len(ms), "worst_residual": worst, "tol": verdict.tol}
        print(f"[ft] (a) check {verdict.check} {bound.route} n={n}: "
              f"{np.mean(ms):.3f} ms per batch of {SERVE_BATCH} on the host "
              f"(mean of {len(ms)}); worst residual {worst:.3e} against tol "
              f"{verdict.tol if verdict.tol else 'exact (0)'}; on {card}",
              flush=True)
    return out


def ft_verified(torch, build, engine_mod, card: str) -> dict:
    """(a) Verified against unverified serving of the same traffic."""
    cells = {"float and single-limb": (None, [(op, n) for op in
                                              WORKLOAD_KERNEL
                                              for n in SERVE_NS],
                                       FT_REQUESTS),
             "rns": (RNS_BITS, [("polymul-mod", RNS_N)], FT_RNS_REQUESTS)}
    out = {}
    for cell, (bits, combos, per_bucket) in cells.items():
        engines = {}
        for verified in (True, False):
            eng = engine_mod.ServeEngine(
                max_batch=SERVE_BATCH, modulus_bits=bits, verified=verified,
                max_pending=per_bucket * len(combos), device="cuda")
            for op, n in combos:
                eng.register(op, n)
            eng.warmup()
            engines[verified] = eng
        traffic = ft_traffic(engines[True], combos, per_bucket, 7)
        turns = {True: [], False: []}
        for i, verified in enumerate((True, False, False, True)):
            label = (f"{cell} {'verified' if verified else 'unverified'} "
                     f"turn {i + 1}")
            turns[verified].append(ft_turn(torch, build, engines[verified],
                                           traffic, label, card,
                                           check_all=i == 0))
        checks = ft_check_cost(engines[True], traffic, card)
        ratio = (np.mean([t["req_per_s"] for t in turns[True]])
                 / np.mean([t["req_per_s"] for t in turns[False]]))
        print(f"[ft] (a) {cell}: verified / unverified req/s {ratio:.3f} "
              f"(means of two turns each); on {card}", flush=True)
        out[cell] = {"turns": {"verified": turns[True],
                               "unverified": turns[False]},
                     "verified_over_unverified": ratio, "checks": checks}
    return out


def ft_chaos(torch, build, engine_mod, serve, card: str) -> dict:
    """(b) The chaos CLI through ``serve.main``: every result checked
    against its oracle by the CLI, the recovery counters, and the route
    kernels' launches == batches + retries + fallback re-runs besides the
    warmups' (counted around ``ServeEngine.warmup``)."""
    warm = collections.Counter()
    warmup = engine_mod.ServeEngine.warmup

    def counted(self):
        before = dict(build.LAUNCHES)
        warmup(self)
        warm.update({k: v - before[k] for k, v in build.LAUNCHES.items()})

    argv = ["--service", "engine", "--verify", "--inject-faults",
            str(FT_CHAOS_RATE), "--inject-stuck", "1", "--inject-fault-seed",
            str(FT_CHAOS_SEED), "--ops", ",".join(FT_CHAOS_OPS), "--ns",
            str(SERVE_NS[0]), "--batch", str(SERVE_BATCH), "--requests",
            str(FT_CHAOS_REQUESTS), "--device", "cuda"]
    torch.cuda.synchronize()
    build.reset_launches()
    engine_mod.ServeEngine.warmup = counted
    try:
        stats = serve.main(argv)
    finally:
        engine_mod.ServeEngine.warmup = warmup
    torch.cuda.synchronize()
    served = {k: v - warm[k] for k, v in build.LAUNCHES.items()
              if v - warm[k]}
    expected = collections.Counter()
    totals = collections.Counter()
    for b in stats["buckets"].values():
        integ = b["integrity"]
        expected[ROUTE_COUNTER[b["route"]]] += (
            b["batches"] + integ["retried"] + integ["fell_back"])
        totals.update({k: integ[k] for k in ("corrupted", "retried",
                                              "fell_back")})
    if stats["served"] != FT_CHAOS_REQUESTS or min(
            totals[k] for k in ("corrupted", "retried", "fell_back")) < 1:
        raise SystemExit(f"[ft] (b) chaos: served {stats['served']} of "
                         f"{FT_CHAOS_REQUESTS}, recovery {dict(totals)}: "
                         f"expected detected, retried and fell_back >= 1")
    if served != dict(expected):
        raise SystemExit(f"[ft] (b) chaos: launches while serving {served}, "
                         f"expected batches + retries + fallback re-runs "
                         f"{dict(expected)}")
    print(f"[ft] (b) serve --verify --inject-faults {FT_CHAOS_RATE} "
          f"--inject-stuck 1 over {','.join(FT_CHAOS_OPS)} at "
          f"n={SERVE_NS[0]}: {stats['served']} requests, every result == its "
          f"oracle; detected={totals['corrupted']} "
          f"retried={totals['retried']} fell_back={totals['fell_back']}; "
          f"launches {served} == batches + retries + fallback re-runs "
          f"(warmups {dict(+warm)} apart); on {card}", flush=True)
    return {"recovery": dict(totals), "launches": served,
            "warmup_launches": dict(+warm),
            "req_per_s": stats["throughput_per_s"],
            "buckets": {k: b["integrity"] for k, b in
                        stats["buckets"].items()}}


def ft_cli(requests: int) -> list[str]:
    return [sys.executable, "-m", "repro_torch.launch.serve", "--service",
            "engine", "--ops", "fft", "--ns", str(SERVE_NS[0]), "--batch",
            str(SERVE_BATCH), "--requests", str(requests), "--snapshot-dir",
            FT_SNAPSHOTS, "--device", "cuda"]


def ft_drain_restart(engine_mod, ckpt_lib, card: str) -> dict:
    """(c) SIGTERM drain, snapshot and warm restart of the CLI."""
    shutil.rmtree(FT_SNAPSHOTS, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    marker = "serving 2000000 requests"
    proc = subprocess.Popen(ft_cli(2_000_000), cwd=ROOT, env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    guard = threading.Timer(FT_SUBPROCESS_S, proc.kill)
    guard.start()
    try:
        lines = []
        while marker not in (lines[-1] if lines else ""):
            line = proc.stdout.readline()
            if not line:
                raise SystemExit("[ft] (c) the CLI exited before its sync "
                                 "marker:\n" + "".join(lines))
            lines.append(line)
        time.sleep(1.0)
        t = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=FT_SUBPROCESS_S)[0]
        exit_s = time.perf_counter() - t
    finally:
        guard.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    step = ckpt_lib.latest_step(FT_SNAPSHOTS)
    if proc.returncode != 0 or "snapshot ->" not in out or not step:
        raise SystemExit(f"[ft] (c) SIGTERM: exit {proc.returncode}, "
                         f"snapshot step {step}:\n{''.join(lines)}{out}")
    second = subprocess.run(ft_cli(SERVE_REQUESTS), cwd=ROOT, env=env,
                            capture_output=True, text=True,
                            timeout=FT_SUBPROCESS_S)
    want = f"warm restart #1 from {FT_SNAPSHOTS} (lifetime served: {step})"
    final = ckpt_lib.latest_step(FT_SNAPSHOTS)
    restored = engine_mod.ServeEngine.from_snapshot(FT_SNAPSHOTS,
                                                    device="cuda")
    if (second.returncode != 0 or want not in second.stdout
            or final != step + SERVE_REQUESTS or restored.restarts != 2
            or restored._prev_served != final):
        raise SystemExit(f"[ft] (c) warm restart: exit {second.returncode}, "
                         f"snapshot steps {step} -> {final}, restarts "
                         f"{restored.restarts}:\n{second.stdout}"
                         f"{second.stderr}")
    print(f"[ft] (c) SIGTERM after the sync marker: drained and snapshotted "
          f"{step} served requests, exit 0, {exit_s:.3f}s from SIGTERM to "
          f"exit; the second run printed '{want}' and served "
          f"{SERVE_REQUESTS} more (lifetime {final}); on {card}", flush=True)
    return {"sigterm_to_exit_s": exit_s, "drained_served": step,
            "lifetime_after_restart": final}


def ft_deadline_watchdog(engine_mod, serve, card: str) -> dict:
    """(d) A deadline-expired request and a watchdog eviction that
    warm-restarts the CLI's engine at one shard."""
    n = SERVE_NS[0]
    eng = engine_mod.ServeEngine(max_batch=SERVE_BATCH, device="cuda")
    bound = eng.register("fft", n)
    eng.warmup()
    rng = np.random.default_rng(13)
    kept = {eng.submit("fft", n, p): p for p in
            [bound.random_payload(rng) for _ in range(SERVE_BATCH)]}
    late = eng.submit("fft", n, bound.random_payload(rng), deadline_s=1e-4)
    time.sleep(0.01)
    stats = eng.run(SERVE_BATCH + 1)
    err = eng.errors.get(late, {})
    if (err.get("error") != "deadline_exceeded" or late in eng.results
            or stats["expired"] != 1):
        raise SystemExit(f"[ft] (d) deadline: error {err}, expired "
                         f"{stats['expired']}")
    for rid, payload in kept.items():
        bound.verify(payload, eng.results[rid])
    snap = FT_SNAPSHOTS + "_elastic"
    shutil.rmtree(snap, ignore_errors=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--service", "engine", "--ops", "fft", "--ns", str(n),
                    "--requests", "96", "--batch", "4", "--max-pending", "8",
                    "--model-shards", "2", "--snapshot-dir", snap,
                    "--elastic", *FT_ELASTIC_FLAGS, "--device", "cuda"])
    out = buf.getvalue()
    restored = engine_mod.ServeEngine.from_snapshot(snap, device="cuda")
    if ("watchdog evicted batch" not in out
            or "elastic restart: model_shards 2 -> 1" not in out
            or restored._prev_served != 96 or restored.restarts != 2
            or restored.ctx.model_shards != 1):
        raise SystemExit(f"[ft] (d) elastic: served "
                         f"{restored._prev_served}, restarts "
                         f"{restored.restarts}:\n{out}")
    evicted = [ln for ln in out.splitlines() if "evicted" in ln]
    flagged = ", ".join(f"batch {e['step']} {e['dt'] * 1e3:.3f} ms "
                        f"(EWMA {e['ewma'] * 1e3:.3f} ms)"
                        for e in restored.watchdog.events)
    print(f"[ft] (d) a request with a 1e-4 s deadline behind a full batch: "
          f"{err['error']} after {err['waited_s'] * 1e3:.3f} ms; stragglers: "
          f"{evicted[0].split('] ')[1]}, warm restart at 1 shard served the "
          f"rest (96 lifetime); flagged: {flagged}; EWMA at the end "
          f"{restored.watchdog.ewma * 1e3:.3f} ms; on {card}", flush=True)
    return {"deadline_error": err, "evicted": evicted,
            "watchdog_events": restored.watchdog.events,
            "watchdog_ewma_s": restored.watchdog.ewma,
            "elastic_lifetime_served": restored._prev_served}


def ft_phase(torch, build, engine_mod, serve, card: str) -> dict:
    from repro_torch.ft import checkpoint as ckpt_lib
    return {"verified": ft_verified(torch, build, engine_mod, card),
            "chaos": ft_chaos(torch, build, engine_mod, serve, card),
            "drain_restart": ft_drain_restart(engine_mod, ckpt_lib, card),
            "deadline_watchdog": ft_deadline_watchdog(engine_mod, serve,
                                                      card)}


# ---------------------------------------------------------------------------
# Phase 7: the multi-device tier
# ---------------------------------------------------------------------------

#: (b): the shard counts, and the lengths with the rows the complex and
#: exact calls take there (the real tier one fewer, at least one: odd, so
#: its zero-row pad runs); one row merges the batch into the transposed
#: rows of the first local transform
DIST_SHARDS = (2, 4, 8)
DIST_NS = {65536: 1, 1 << 20: 4}
#: the reference tests' bounds: 1e-3 against the local route at small n
#: (tests/test_distributed_fft.py:24; relative to max(1, |want|), as the
#: registry's checks take it), 2e-6 relative against fp64 numpy at 2^20
#: (tests/test_distributed_fft.py:89, tests/test_dist_real.py:274)
DIST_LOCAL_TOL, DIST_ORACLE_TOL = 1e-3, 2e-6
#: (d): the served cells (op, n, batch), DIST_REQUESTS each on
#: DIST_SERVE_SHARDS shards
DIST_SERVE_SHARDS, DIST_REQUESTS = 8, 64
DIST_SERVE = (("polymul-real", 1 << 20, 16), ("polymul-mod", 65536, 16))
#: the one polymul-real call past the real product's on-chip ceiling
DIST_LONG_N, DIST_LONG_BATCH = 1 << 24, 2
#: calls a CUDA-event timing of a route averages
DIST_TIMED_REPS = 10
#: (e): the elastic engine's cell (op, n, batch, requests), snapshot
#: directory, watchdog threshold (x EWMA; three flags evict) and
#: straggler. A clean distributed batch of four rows at 4096 takes some
#: 10 ms of host time (its sample also holds the producer's share of the
#: interpreter), so 10x sits above its jitter and far below a two-second
#: straggler. Stragglers start at served batch 7, as FT_ELASTIC_FLAGS's.
DIST_ELASTIC = ("polymul-real", 4096, 4, 96)
DIST_ELASTIC_THRESHOLD, DIST_STRAGGLER_MS = 10.0, 2000.0
DIST_SNAPSHOTS = os.path.join(ROOT, "build", "chip_smoke_dist_snapshots")
#: the kernel a distributed route's local transforms launch
DIST_COUNTER = {"polymul-real": "fft_planes", "polymul-mod": "ntt_batched"}


def plain_ntt_batched(kntt):
    """``kernels.ntt.ntt_batched`` with its plain version in place of the
    kernel on the card."""
    def ntt_batched(x, params, *, inverse=False, block_b=None):
        del block_b
        return kntt.ntt_batched_plain(kntt._as_residues(x, params.q), params,
                                      inverse=inverse)
    return ntt_batched


def swapped_ntt_batched(kntt, fn):
    """Run ``fn`` with ``plain_ntt_batched`` swapped in for
    ``kernels.ntt.ntt_batched``."""
    kernel = kntt.ntt_batched
    kntt.ntt_batched = plain_ntt_batched(kntt)
    try:
        return fn()
    finally:
        kntt.ntt_batched = kernel


def zorder(x, d: int):
    """The joined Z-order layout of ``d`` shards of a natural-order last
    axis: shard k holds x[k::d]."""
    n = x.shape[-1]
    return x.reshape(*x.shape[:-1], n // d, d).swapaxes(-1, -2).reshape(
        x.shape)


def _rel(got, want) -> float:
    """max |got - want| over max(1, max |want|): the registry's checks'."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want))
                 / max(1.0, float(np.max(np.abs(want)))))


def _oracle_rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / float(np.max(np.abs(want))))


#: rows of the exact calls held against the numpy NTT reference at 2^20
#: (about 5 s of host time a row; every row is == the local kernels)
DIST_EXACT_ORACLE_ROWS = 1


def dist_oracles(host: dict, n: int, params, exact_rows: int) -> dict:
    """fp64 numpy of each float call, and the numpy NTT reference of the
    first ``exact_rows`` rows of each exact call, on the phase's inputs."""
    from repro_torch.core.ntt.ref import (cyclic_polymul, negacyclic_polymul,
                                          ntt)
    f64 = {k: v.astype(np.complex128 if np.iscomplexobj(v) else np.float64)
           for k, v in host.items() if k not in ("u", "v")}
    full = np.fft.rfft(f64["a"])
    packed = full[:, :n // 2].copy()
    packed[:, 0] = full[:, 0].real + 1j * full[:, n // 2].real
    half = np.concatenate([f64["p"], f64["p"][:, :1].imag + 0j], axis=1)
    half[:, 0] = f64["p"][:, 0].real
    u, v = host["u"], host["v"]
    rows = range(exact_rows)
    return {
        "fft": np.fft.fft(f64["x"]), "ifft": np.fft.ifft(f64["x"]),
        "polymul": np.fft.ifft(np.fft.fft(f64["x"]) * np.fft.fft(f64["y"])),
        "rfft": packed, "irfft": np.fft.irfft(half, n),
        "polymul_real": np.fft.ifft(np.fft.fft(f64["a"])
                                    * np.fft.fft(f64["c"])).real,
        "ntt": np.stack([ntt(u[i], params) for i in rows]),
        "ntt_polymul": np.stack([negacyclic_polymul(u[i], v[i], params)
                                 for i in rows]),
        "ntt_polymul_cyclic": np.stack([cyclic_polymul(u[i], v[i], params)
                                        for i in rows])}


def dist_parity(torch, build, card: str, *, device: str = "cuda",
                ns=None, shards=DIST_SHARDS) -> dict:
    """(b) and (c): every sharded call through the kernels == with the
    plain versions swapped in, within the local route's / fp64 numpy's
    bounds (``==`` the local kernels and numpy on the exact tier), its
    local transforms' launches counted, its ledger == the closed form."""
    from repro_torch.core.fft import distributed as dfft
    from repro_torch.core.ntt import distributed as dntt
    from repro_torch.core.ntt.ref import NTTParams
    from repro_torch.dist import collectives, sharding
    from repro_torch.kernels import fft as kfft
    from repro_torch.kernels import ntt as kntt
    from repro_torch.kernels import ops as kops
    dev = torch.device(device)
    rng = np.random.default_rng(23)
    report: dict = {}

    def cplx(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    for n, b in (DIST_NS if ns is None else ns).items():
        params = NTTParams.make(n)
        br = max(1, b - 1)
        host = {"x": cplx(b, n), "y": cplx(b, n),
                "a": rng.standard_normal((br, n)).astype(np.float32),
                "c": rng.standard_normal((br, n)).astype(np.float32),
                "p": cplx(br, n // 2),
                "u": rng.integers(0, params.q, (b, n)).astype(np.uint32),
                "v": rng.integers(0, params.q, (b, n)).astype(np.uint32)}
        t = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        oracle = dist_oracles(host, n, params, DIST_EXACT_ORACLE_ROWS) \
            if n >= 1 << 20 else None
        exact_oracle = oracle or dist_oracles(
            {**host, **{k: host[k][:1] for k in ("x", "y", "a", "c", "p")}},
            n, params, b)
        p_planes = (t["p"].real.contiguous(), t["p"].imag.contiguous())
        local = {
            "fft": kops.fft(t["x"]), "ifft": kops.fft(t["x"], inverse=True),
            "polymul": kops.polymul(t["x"], t["y"], mode="circular"),
            "rfft": torch.complex(*kops.rfft(t["a"], packed=True)),
            "irfft": kops.irfft(p_planes, packed=True),
            "polymul_real": kops.polymul_real(t["a"], t["c"],
                                              mode="circular"),
            "ntt": kntt.ntt_batched(t["u"], params),
            "intt": kntt.ntt_batched(t["u"], params, inverse=True),
            "ntt_polymul": kntt.ntt_polymul(t["u"], t["v"], params),
            "ntt_polymul_cyclic": kntt.ntt_polymul(t["u"], t["v"], params,
                                                   negacyclic=False)}
        for name in ("ntt", "ntt_polymul", "ntt_polymul_cyclic"):
            ref = exact_oracle[name]
            if not (kntt.residues_to_numpy(local[name])[:len(ref)]
                    == ref).all():
                raise SystemExit(f"[dist] local {name} at n={n} is not the "
                                 f"numpy reference")
        for d in shards:
            mm = sharding.make_mesh((d,), ("model",), device=device)
            md = sharding.make_mesh((d,), ("data",), device=device)
            pz = zorder(t["p"], d)
            real_rows = br + br % 2
            # name -> (sharded call, operands, local value it equals,
            #          counter, local transforms a shard, ledger closed form)
            calls = {
                "fft": (dfft.make_sharded_fft(mm), (t["x"],), local["fft"],
                        "fft_planes", 1, ("fft", b, True)),
                "fft_z": (dfft.make_sharded_fft(mm, ordered=False),
                          (t["x"],), zorder(local["fft"], d), "fft_planes",
                          1, ("fft", b, False)),
                "ifft": (dfft.make_sharded_fft(mm, inverse=True), (t["x"],),
                         local["ifft"], "fft_planes", 1, ("ifft", b, True)),
                "polymul": (dfft.make_sharded_polymul(mm),
                            (t["x"], t["y"]), local["polymul"],
                            "fft_planes", 3, ("polymul", b, True)),
                "rfft": (dfft.make_sharded_rfft(mm), (t["a"],),
                         local["rfft"], "fft_planes", 1,
                         ("rfft", real_rows, True)),
                "rfft_z": (dfft.make_sharded_rfft(mm, ordered=False),
                           (t["a"],), zorder(local["rfft"], d),
                           "fft_planes", 1, ("rfft", real_rows, False)),
                "irfft": (dfft.make_sharded_irfft(mm), (t["p"],),
                          local["irfft"], "fft_planes", 1,
                          ("irfft", real_rows, True)),
                "irfft_z": (dfft.make_sharded_irfft(mm, ordered=False),
                            (pz,), local["irfft"], "fft_planes", 1,
                            ("irfft", real_rows, False)),
                "polymul_real": (dfft.make_sharded_polymul_real(mm),
                                 (t["a"], t["c"]), local["polymul_real"],
                                 "fft_planes", 2,
                                 ("polymul_real", real_rows, True)),
                "ntt": (dntt.make_sharded_ntt(md, params), (t["u"],),
                        local["ntt"], "ntt_batched", 1, ("ntt", b, True)),
                "ntt_z": (dntt.make_sharded_ntt(md, params, ordered=False),
                          (t["u"],), zorder(local["ntt"], d), "ntt_batched",
                          1, ("ntt", b, False)),
                "intt": (dntt.make_sharded_ntt(md, params, inverse=True),
                         (t["u"],), local["intt"], "ntt_batched", 1,
                         ("intt", b, True)),
                "ntt_polymul": (dntt.make_sharded_ntt_polymul(md, params),
                                (t["u"], t["v"]), local["ntt_polymul"],
                                "ntt_batched", 3, ("polymul", b, True)),
                "ntt_polymul_cyclic": (
                    dntt.make_sharded_ntt_polymul(md, params,
                                                  negacyclic=False),
                    (t["u"], t["v"]), local["ntt_polymul_cyclic"],
                    "ntt_batched", 3, ("polymul", b, True))}
            for name, (fn, args, want, counter, per_shard,
                       (op, rows, ordered)) in calls.items():
                exact = counter == "ntt_batched"
                build.reset_launches()
                with collectives.ledger() as led:
                    got = fn(*args)
                launched = dict(build.LAUNCHES)
                swap = swapped_ntt_batched if exact else swapped_fft_planes
                plain = swap(kntt if exact else kfft, lambda: fn(*args))
                if not torch.equal(got, plain):
                    raise SystemExit(f"[dist] {name} n={n} D={d}: the "
                                     f"kernels' result is not the plain "
                                     f"versions' bit for bit")
                calls_made = d * 2 * per_shard
                others = {k: v for k, v in launched.items()
                          if k != counter and v}
                # (the CPU runs the plain versions: no launch to count)
                if dev.type == "cuda" and (launched[counter] != calls_made
                                           or others):
                    raise SystemExit(f"[dist] {name} n={n} D={d}: launches "
                                     f"{launched}, expected {calls_made} "
                                     f"of {counter} and nothing else")
                if exact:
                    stats = dntt.four_step_collective_stats(
                        n, rows, d, op=op, ordered=ordered)
                    ledger_want = [stats["count"], stats["bytes"], 0, 0]
                else:
                    stats = dfft.four_step_collective_stats(
                        n, rows, d, op=op, ordered=ordered)
                    ledger_want = [stats["a2a_count"], stats["a2a_bytes"],
                                   stats["ppermute_count"],
                                   stats["ppermute_bytes"]]
                ledger = [led.counts["all-to-all"],
                          led.bytes_by_kind["all-to-all"],
                          led.counts["ppermute"],
                          led.bytes_by_kind["ppermute"]]
                if ledger != ledger_want:
                    raise SystemExit(f"[dist] {name} n={n} D={d}: ledger "
                                     f"{ledger} != closed form "
                                     f"{ledger_want}")
                entry = {"launches": launched[counter], "ledger": ledger}
                if exact:
                    if not torch.equal(got, want):
                        raise SystemExit(f"[dist] {name} n={n} D={d}: not "
                                         f"== the local kernel")
                    entry["equal_local"] = True
                else:
                    entry["rel_local"] = _rel(got.cpu().numpy(),
                                              want.cpu().numpy())
                    if oracle is None and not \
                            entry["rel_local"] < DIST_LOCAL_TOL:
                        raise SystemExit(f"[dist] {name} n={n} D={d}: "
                                         f"{entry['rel_local']:.3e} from "
                                         f"the local route")
                ref = None if oracle is None else oracle.get(
                    name.removesuffix("_z"))
                if ref is not None:
                    if name.endswith("_z") and name != "irfft_z":
                        ref = zorder(ref, d)
                    g = got.cpu().numpy()
                    if exact:
                        if not (kntt.residues_to_numpy(got)[:len(ref)]
                                == ref).all():
                            raise SystemExit(f"[dist] {name} n={n} D={d}: "
                                             f"not == the numpy reference")
                    else:
                        entry["rel_oracle"] = _oracle_rel(g, ref)
                        if not entry["rel_oracle"] < DIST_ORACLE_TOL:
                            raise SystemExit(
                                f"[dist] {name} n={n} D={d}: "
                                f"{entry['rel_oracle']:.3e} from fp64 "
                                f"numpy (bound {DIST_ORACLE_TOL})")
                report[f"{name}/n={n}/D={d}"] = entry
            worst = max(report[f"{name}/n={n}/D={d}"].get(
                "rel_oracle", report[f"{name}/n={n}/D={d}"].get(
                    "rel_local", 0.0)) for name in calls)
            against = ("fp64 numpy, bound 2e-6; NTT == the local kernels "
                       "and numpy" if oracle else
                       "the local route, bound 1e-3; NTT == the local "
                       "kernels")
            print(f"[dist] (b, c) n={n} D={d}: {len(calls)} sharded calls "
                  f"== their plain-swapped runs bit for bit, each launching "
                  f"its {d} shards x 2 local calls a transform and nothing "
                  f"else, ledgers == the closed forms; worst float error "
                  f"{worst:.3e} against {against}; on {card}", flush=True)
    return report


def traced_split(torch, fn, args) -> dict:
    """One traced call split by device time into the local transforms,
    the exchanges (all-to-alls and ppermutes) and the glue: the kernels
    under ``record_function`` ranges around each local transform and each
    collective, the rest of the call's kernels glue. The trace may drop
    device events of the ctypes-launched kernels; the kernel events it
    holds are counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core.fft import distributed as dfft
    from repro_torch.core.ntt import distributed as dntt
    from repro_torch.dist import collectives

    def ranged(label, f):
        def wrapped(*a, **kw):
            with record_function(label):
                return f(*a, **kw)
        return wrapped

    saved = [(collectives, name, getattr(collectives, name))
             for name in ("all_to_all", "ppermute")]
    saved += [(dfft, "_local_fft", dfft._local_fft),
              (dntt, "_local_ntt", dntt._local_ntt)]
    fn(*args)
    torch.cuda.synchronize()
    try:
        for mod, name, f in saved:
            setattr(mod, name, ranged(
                "exchange" if mod is collectives else "local transform", f))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)
    events = prof.events()
    total = sum(e.self_device_time_total for e in events
                if e.device_type == DeviceType.CUDA)
    kernels = sum(1 for e in events if e.device_type == DeviceType.CUDA)
    part = {label: sum(e.device_time_total for e in events
                       if e.name == label)
            for label in ("local transform", "exchange")}
    ms = {k.replace(" ", "_") + "_ms": v / 1e3 for k, v in part.items()}
    return {"traced_ms": total / 1e3, **ms,
            "glue_ms": (total - sum(part.values())) / 1e3,
            "kernel_events": kernels}


def dist_serve(torch, build, serve, op_registry, card: str, *,
               device: str = "cuda", cells=DIST_SERVE,
               shards: int = DIST_SERVE_SHARDS,
               requests: int = DIST_REQUESTS,
               long_cell=(DIST_LONG_N, DIST_LONG_BATCH)) -> dict:
    """(d): the distributed routes served and timed, and the call past
    the real product's on-chip ceiling."""
    from repro_torch.core import cost as core_cost
    out: dict = {"cells": {}}
    for op, n, batch in cells:
        svc = serve.FFTService(n, batch, op, model_shards=shards,
                               device=device)
        svc.warmup()
        counter = DIST_COUNTER[op]
        # every request submitted before the run: full batches of `batch`
        rng = np.random.default_rng(n)
        kept = {svc.engine.submit(op, n, p): (op, n, p) for p in
                [svc.bound.random_payload(rng) for _ in range(requests)]}
        build.reset_launches()
        stats = svc.engine.run(requests)
        launched = dict(build.LAUNCHES)
        bucket = next(iter(stats["buckets"].values()))
        per_call = shards * 2 * (2 if svc.plan.real else 3)
        others = {k: v for k, v in launched.items() if k != counter and v}
        if torch.device(device).type == "cuda" and (
                launched[counter] != bucket["batches"] * per_call or others):
            raise SystemExit(f"[dist] (d) {op}: launches {launched}, "
                             f"expected {bucket['batches']} batches x "
                             f"{per_call} of {counter} and nothing else")
        for rid, (_, _, payload) in kept.items():
            svc.bound.verify(payload, svc.results[rid])
        rng = np.random.default_rng(n + 1)
        payloads = [svc.bound.random_payload(rng) for _ in range(batch)]
        local = op_registry.get_op(op).bind(n, batch=batch, device=device)
        fns = {"distributed": (svc.bound.fn, svc.bound.stack(payloads)),
               "local": (local.fn, local.stack(payloads))}
        timed: dict = {"distributed": [], "local": []}
        for which in ("distributed", "local", "local", "distributed"):
            fn, args = fns[which]
            timed[which].append(time_ms(torch, fn, [args], DIST_TIMED_REPS))
        split = traced_split(torch, *fns["distributed"])
        pred = core_cost.cuda_cost(op, n, batch, tier="distributed",
                                   n_devices=shards, real=svc.plan.real)
        pred_local = core_cost.cuda_cost(op, n, batch, real=local.plan.real)
        lat = stats["latency_ms"]
        entry = {"op": op, "route": svc.route,
                 "plan": svc.plan.describe(),
                 "mesh": svc.bound.mesh.describe(), "n": n, "batch": batch,
                 "requests": stats["served"], "verified": len(kept),
                 "req_per_s": stats["throughput_per_s"],
                 "p50_ms": lat["p50"], "p99_ms": lat["p99"],
                 "launches": launched[counter], "batches": bucket["batches"],
                 "launches_per_call": per_call,
                 "ms_per_call": timed["distributed"],
                 "local_route": local.route,
                 "local_ms_per_call": timed["local"], "traced": split,
                 "predicted_ms": pred.total_s * 1e3,
                 "predicted_exchange_ms": pred.t_collective_s * 1e3,
                 "predicted_local_route_ms": pred_local.total_s * 1e3}
        out["cells"][f"{op}/{n}"] = entry
        print(f"[dist] (d) op={op} n={n} batch={batch} model_shards="
              f"{shards} route={svc.route} [{entry['plan']}]: "
              f"{stats['served']} requests, all verified, "
              f"{entry['req_per_s']:.1f} req/s p50={lat['p50']:.3f}ms "
              f"p99={lat['p99']:.3f}ms; {counter} launched "
              f"{launched[counter]} times ({bucket['batches']} batches x "
              f"{per_call}); device ms a call by CUDA events (in turns "
              f"d, l, l, d) {timed['distributed']} against the local "
              f"route {local.route} {timed['local']}; traced call "
              f"{split['traced_ms']:.4f} ms = local transforms "
              f"{split['local_transform_ms']:.4f} + exchanges "
              f"{split['exchange_ms']:.4f} + glue {split['glue_ms']:.4f} "
              f"({split['kernel_events']} kernel events); cost model "
              f"{entry['predicted_ms']:.4f} ms (exchanges "
              f"{entry['predicted_exchange_ms']:.4f}, copies in device "
              f"memory), local route {entry['predicted_local_route_ms']:.4f}"
              f" ms; on {card}", flush=True)
    n, batch = long_cell
    spec = op_registry.get_op("polymul-real")
    dist = spec.bind(n, op_registry.OpContext(model_shards=shards),
                     batch=batch, device=device)
    local = spec.bind(n, op_registry.OpContext(auto=True, packings=(False,)),
                      batch=batch, device=device)
    if (dist.route, local.route) != ("polymul-real-distributed",
                                     "polymul-real-complex"):
        raise SystemExit(f"[dist] (d) n={n}: routes {dist.route}, "
                         f"{local.route}")
    payloads = [dist.random_payload(np.random.default_rng(29))
                for _ in range(batch)]
    got = dist.to_numpy(dist.execute(payloads))
    want = local.to_numpy(local.execute(payloads))
    rel = _oracle_rel(got, want)
    if not rel < DIST_ORACLE_TOL:
        raise SystemExit(f"[dist] (d) polymul-real n={n} on {shards} "
                         f"shards: {rel:.3e} from the local complex route "
                         f"(bound {DIST_ORACLE_TOL})")
    ms = time_ms(torch, dist.fn, [dist.stack(payloads)], 3)
    local_ms = time_ms(torch, local.fn, [local.stack(payloads)], 3)
    ceiling = core_cost.local_ceiling(True, True, False)
    out["long"] = {"n": n, "batch": batch, "rel_local_complex": rel,
                   "ms": ms, "local_complex_ms": local_ms,
                   "ceiling": ceiling}
    print(f"[dist] (d) polymul-real n={n} (past the real product's on-chip "
          f"ceiling {ceiling}) batch "
          f"{batch} on {shards} shards: {rel:.3e} from the local "
          f"polymul-real-complex route (bound {DIST_ORACLE_TOL}); "
          f"{ms:.4f} ms a call against {local_ms:.4f}; on {card}",
          flush=True)
    return out


def dist_elastic(serve, engine_mod, card: str, *, device: str = "cuda",
                 cell=DIST_ELASTIC,
                 straggler_ms: float = DIST_STRAGGLER_MS) -> dict:
    """(e): an engine on the distributed route at 8 shards, stragglers
    injected after the warmup, evicted by the watchdog; it drains,
    snapshots and warm-restarts at 4 shards and serves the rest. Every
    result of both generations is checked."""
    from repro_torch.ft.watchdog import WatchdogConfig
    op, n, batch, requests = cell
    shutil.rmtree(DIST_SNAPSHOTS, ignore_errors=True)
    cfg = WatchdogConfig(threshold=DIST_ELASTIC_THRESHOLD, evict_after=3,
                         warmup_steps=5)
    evicted: list[int] = []

    def on_evict(eng, batch_idx):
        evicted.append(batch_idx)
        threading.Thread(target=eng.request_stop, daemon=True).start()

    engine = engine_mod.ServeEngine(max_batch=batch, max_pending=2 * batch,
                                    model_shards=8, watchdog_cfg=cfg,
                                    on_evict=on_evict, device=device)
    engine.register(op, n)
    rng = np.random.default_rng(31)
    chaos = types.SimpleNamespace(inject_straggler_ms=straggler_ms,
                                  inject_straggler_after=7)
    generations, remaining = [], requests
    while remaining > 0:
        bound = engine.bound(op, n)
        engine.warmup()
        serve.arm_chaos(engine, chaos)
        kept, stats = serve.produce(engine, [(op, n)], remaining, rng)
        for rid, (_, _, payload) in kept.items():
            bound.verify(payload, engine.results[rid])
        generations.append({"model_shards": engine.ctx.model_shards,
                            "route": bound.route,
                            "mesh": bound.mesh.size if bound.mesh else 1,
                            "served": stats["served"],
                            "verified": len(kept)})
        remaining -= stats["served"]
        if remaining > 0:
            engine = engine.elastic_restart(
                DIST_SNAPSHOTS, model_shards=engine.ctx.model_shards // 2)
    shards = [g["model_shards"] for g in generations]
    wd = engine.watchdog
    if not evicted or shards[:2] != [8, 4] or \
            sum(g["served"] for g in generations) != requests:
        raise SystemExit(f"[dist] (e) elastic: evictions {evicted}, "
                         f"generations {generations}, watchdog EWMA "
                         f"{wd.ewma}, flags {wd.events}")
    print(f"[dist] (e) {op} n={n} batch {batch}: evicted at batch "
          f"{evicted[0]} ({straggler_ms:.0f} ms stragglers, watchdog "
          f"{DIST_ELASTIC_THRESHOLD:g}x, 3 flags; EWMA at the end "
          f"{wd.ewma * 1e3:.3f} ms), generations {generations}: every "
          f"result verified; on {card}", flush=True)
    return {"evicted": evicted, "generations": generations,
            "watchdog_events": wd.events, "watchdog_ewma_s": wd.ewma}


def dist_phase(torch, build, serve, engine_mod, op_registry,
               card: str) -> dict:
    from repro_torch.dist import sharding
    mesh = sharding.make_mesh((8,), ("model",))
    print(f"[dist] (a) {mesh.describe()}: on a one-card host every shard "
          f"shares the card, so each exchange is a copy in its device "
          f"memory, not an NVLink transfer, and no time below is "
          f"interconnect time; {torch.cuda.device_count()} card(s): "
          f"{card}", flush=True)
    return {"mesh": mesh.describe(),
            "parity": dist_parity(torch, build, card),
            "served": dist_serve(torch, build, serve, op_registry, card),
            "elastic": dist_elastic(serve, engine_mod, card)}


# ---------------------------------------------------------------------------
# Phase 8: training
# ---------------------------------------------------------------------------

#: fft_causal_conv's forward and backward at fourierpim-lm's shapes, x (B,
#: d, T) and taps (1, d, K): the full-width training step's (n = 4096,
#: one kernel a transform) and one two-pass length (T = 6000: n = 8192, two
#: kernels a transform)
TRAIN_CONV_SHAPES = (((8, 768, 2048), 256), ((2, 768, 6000), 256))
#: dx and dk held against float64 numpy on their first channels, within
#: this share of the largest magnitude: fp32 transforms at n = 4096 and
#: 8192 round the correlation to about 1e-6 of it
TRAIN_CONV_CHANNELS = 4
TRAIN_GRAD_TOL = 1e-4
#: one training step of 2 full-width fp32 layers of fourierpim-lm (B 1 x
#: S 512) and of the reduced qwen3-1.7b config (B 2 x S 128), on the card
#: against the CPU: the loss and the gradients' global norm within rtol
#: TRAIN_STEP_TOL, each leaf's gradient within TRAIN_STEP_TOL of its
#: largest magnitude. A sound fp32 step reads about 2e-6 (fp32 sums in
#: other orders); the same step with TF32 matmuls, the control run after
#: it, must read above the bound, so a step that fell back to TF32 or to
#: lower-precision products fails
TRAIN_PARITY = {FOURIER_ARCH: (2, 1, 512), LM_ARCH: (None, 2, 128)}
TRAIN_STEP_TOL = 1e-4
#: the kernel each parity step launches, and its launches a layer:
#: fourierpim-lm's convolution 3 forward, 3 again under remat and 3
#: backward; the reduced qwen3-1.7b's flash kernel (the tf32 kernel's hd-32
#: instance) forward and again under remat (its backward recomputes the
#: plain attention)
TRAIN_PARITY_LAUNCHES = {FOURIER_ARCH: ("fft_planes", 9),
                         LM_ARCH: ("flash_attention_tf32", 2)}
#: the full-width run: ``python -m repro_torch.launch.train`` through its
#: ``run``, in this process so the launch counters see it
TRAIN_ARGS = ["--arch", FOURIER_ARCH, "--batch", str(LM_BATCH),
              "--seq", str(LM_PROMPT)]
TRAIN_STEPS = 20
#: the checkpoint the resumed run starts from
TRAIN_RESUME_AT = 10
#: the resumed run's losses against the uninterrupted run's: equal bit for
#: bit is what the card gave (the run prints which); the bound, if not
TRAIN_RESUME_RTOL = 1e-3
TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_train")
#: fourierpim-lm's transforms a layer in a training step under remat
#: "block": rows and direction of each fft_planes call (x's 8 x 768 channel
#: rows, the 768 tap rows), n = 4096. Forward: X, K, Y back; the forward
#: again in the backward; then G, dx back and dk back (its batch summed)
TRAIN_FFT_CALLS = ((LM_BATCH * 768, False), (768, False),
                   (LM_BATCH * 768, True)) * 2 + (
    (LM_BATCH * 768, False), (LM_BATCH * 768, True), (768, True))


def correlate_numpy(g, x, k):
    """The convolution's gradients in float64: dx[b, c, u] = sum_s k[c, s]
    g[b, c, u + s] and dk[c, s] = sum_b sum_u g[b, c, u + s] x[b, c, u],
    for x, g (B, C, T) and taps k (C, K)."""
    g, x, k = (a.astype(np.float64) for a in (g, x, k))
    T, K = g.shape[-1], k.shape[-1]
    dx = np.zeros_like(x)
    dk = np.zeros(k.shape)
    for s in range(K):
        dx[..., :T - s] += k[None, :, s:s + 1] * g[..., s:]
        dk[:, s] = np.sum(g[..., s:] * x[..., :T - s], axis=(0, 2))
    return dx, dk


def train_conv_check(torch, build, kfft, kops, radix: int, card: str
                     ) -> dict:
    """(a) ``fft_causal_conv``'s forward and backward at
    TRAIN_CONV_SHAPES through the kernel: three ``fft_planes`` launches
    forward and three backward, y, dx and dk == the same with the plain
    version swapped in (bit for bit), dx and dk on the first channels
    within TRAIN_GRAD_TOL of float64 numpy."""
    dev = torch.device("cuda")
    out = {}
    for xs, K in TRAIN_CONV_SHAPES:
        g = torch.Generator(device=dev).manual_seed(xs[-1] + K)
        x = torch.randn(*xs, device=dev, generator=g)
        k = torch.randn(1, xs[1], K, device=dev, generator=g) * 0.02
        gy = torch.randn(*xs, device=dev, generator=g)
        n = kops._next_pow2(xs[-1] + K)
        counts = []

        def run():
            xr, kr = x.clone().requires_grad_(), k.clone().requires_grad_()
            before = build.LAUNCHES["fft_planes"]
            y = kops.fft_causal_conv(xr, kr, radix=radix)
            torch.cuda.synchronize()
            mid = build.LAUNCHES["fft_planes"]
            y.backward(gy)
            torch.cuda.synchronize()
            counts.append((mid - before, build.LAUNCHES["fft_planes"] - mid))
            return y.detach(), xr.grad, kr.grad

        got = run()
        want = swapped_fft_planes(kfft, run)
        if counts != [(3, 3), (0, 0)]:
            raise SystemExit(f"fft_causal_conv x {xs} taps {K}: fft_planes "
                             f"launches (forward, backward) {counts[0]}, "
                             f"expected (3, 3), and none with the plain "
                             f"version swapped in ({counts[1]})")
        for name, a, b in zip(("y", "dx", "dk"), got, want):
            if not torch.equal(a, b):
                raise SystemExit(
                    f"fft_causal_conv x {xs} taps {K} (n = {n}): {name} "
                    f"through the kernel and the plain version differ by "
                    f"{float((a - b).abs().max())}")
        c = TRAIN_CONV_CHANNELS
        dx, dk = correlate_numpy(gy[:, :c].cpu().numpy(),
                                 x[:, :c].cpu().numpy(),
                                 k[0, :c].cpu().numpy())
        errs = {}
        for name, a, b in (("dx", got[1][:, :c], dx), ("dk", got[2][0, :c],
                                                       dk)):
            err = float(np.max(np.abs(a.cpu().numpy() - b)))
            scale = float(np.max(np.abs(b)))
            if err > TRAIN_GRAD_TOL * scale:
                raise SystemExit(f"fft_causal_conv x {xs} taps {K}: {name} "
                                 f"off float64 numpy by {err} (largest "
                                 f"{scale}, bound {TRAIN_GRAD_TOL} of it)")
            errs[name] = err / scale
        per = 1 if kfft.two_pass_plan(n, radix) is None else 2
        out[f"x {xs} taps {K}"] = {
            "n": n, "kernels_per_transform": per,
            "launches_forward": counts[0][0],
            "launches_backward": counts[0][1],
            "vs_numpy_rel": errs}
        print(f"[train] fft_causal_conv x {xs} taps {K} (n = {n}, {per} "
              f"kernel(s) a transform): fft_planes launched "
              f"{counts[0][0]} times forward and {counts[0][1]} backward; "
              f"y, dx and dk == the plain version swapped in, bit for bit; "
              f"dx, dk against float64 numpy on {c} channels: "
              f"{errs['dx']:.3g}, {errs['dk']:.3g} of the largest "
              f"(bound {TRAIN_GRAD_TOL}); on {card}", flush=True)
        del x, k, gy, got, want
        torch.cuda.empty_cache()
    return out


def train_card_vs_cpu(torch, build, convert, lm, adamw, pipeline,
                      get_config, arch: str, card: str,
                      device: str = "cuda") -> dict:
    """(b) one training step's loss and gradients (``lm.value_and_grad``,
    the step's remat) with the same weights and batch on the card and on
    the CPU (plain versions), within TRAIN_STEP_TOL; the card's launches
    of the step, the counters zeroed just before, exactly
    TRAIN_PARITY_LAUNCHES. Then the control: the card's step again with
    the model's matmuls in TF32, which must fall outside the bound.
    (``device="cpu"`` rehearses it on the CPU, up to the control.)"""
    layers, B, S = TRAIN_PARITY[arch]
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=layers, dtype="float32") \
        if layers else cfg.scaled_down()
    params = convert.init_params(cfg, torch.Generator().manual_seed(0))
    raw = pipeline.SyntheticLM(cfg.vocab_size, S, B, seed=0).batch_at(0)
    model = lm.DecoderLM(cfg, device="meta")      # the structure only

    def step_on(dev: str):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
        build.reset_launches()
        loss, grads = lm.value_and_grad(
            model, {k: v.to(dev) for k, v in params.items()}, batch)
        torch.cuda.synchronize()
        return (float(loss), float(adamw.global_norm(grads)),
                {k: g.cpu() for k, g in grads.items()},
                {k: c for k, c in build.LAUNCHES.items() if c})

    def off(run) -> tuple[float, float, float]:
        """(loss, gradient norm, worst leaf) relative to the CPU's."""
        return (abs(run[0] - l0) / abs(l0), abs(run[1] - n0) / abs(n0),
                max(float((run[2][k] - g0[k]).abs().max())
                    / max(float(g0[k].abs().max()), 1e-30) for k in g0))

    l0, n0, g0, _ = step_on("cpu")
    card_run = step_on(device)
    l1, n1, _, launches = card_run
    errs = off(card_run)
    if max(errs) > TRAIN_STEP_TOL:
        raise SystemExit(f"{cfg.name} training step, card against CPU: loss "
                         f"{l1} vs {l0}, gradient norm {n1} vs {n0}; "
                         f"relative (loss, norm, worst leaf) {errs} (bound "
                         f"{TRAIN_STEP_TOL})")
    kernel, per_layer = TRAIN_PARITY_LAUNCHES[arch]
    want = {kernel: per_layer * cfg.num_layers}
    if launches != want:
        raise SystemExit(f"{cfg.name} training step on the card launched "
                         f"{launches}, expected {want}")
    # the model sets its matmuls' precision at each forward
    # (``lm.exact_matmuls``), so the control sets TF32 in its place
    exact = lm.exact_matmuls

    def tf32_matmuls() -> None:
        exact()
        torch.backends.cuda.matmul.allow_tf32 = True

    lm.exact_matmuls = tf32_matmuls
    try:
        control = off(step_on(device))
    finally:
        lm.exact_matmuls = exact
        exact()
    if max(control) <= TRAIN_STEP_TOL:
        raise SystemExit(f"{cfg.name} training step with TF32 matmuls, the "
                         f"control: relative (loss, norm, worst leaf) "
                         f"{control} within the bound {TRAIN_STEP_TOL}, "
                         f"which so does not tell fp32 from TF32")
    out = {"config": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "batch": B, "seq": S, "remat": cfg.remat,
           "loss_card": l1, "loss_cpu": l0, "grad_norm_card": n1,
           "grad_norm_cpu": n0, "loss_rel": errs[0], "grad_norm_rel": errs[1],
           "worst_leaf_rel": errs[2], "bound": TRAIN_STEP_TOL,
           "tf32_control": dict(zip(("loss_rel", "grad_norm_rel",
                                     "worst_leaf_rel"), control)),
           "launches": launches}
    print(f"[train] one step of {cfg.name} ({cfg.num_layers} layers, d "
          f"{cfg.d_model}, fp32, B {B} x S {S}, remat {cfg.remat}), card "
          f"against CPU: loss {l1:.6f} vs {l0:.6f}, gradient norm {n1:.6f} "
          f"vs {n0:.6f}; relative loss {errs[0]:.3g}, norm {errs[1]:.3g}, "
          f"worst leaf {errs[2]:.3g} of its largest (bound "
          f"{TRAIN_STEP_TOL}); the TF32 control reads {control[0]:.3g}, "
          f"{control[1]:.3g}, {control[2]:.3g}, outside it; the card's step "
          f"launched {launches}; on {card}", flush=True)
    return out


def train_full_width(torch, build, train, get_config, card: str) -> dict:
    """(c) ``python -m repro_torch.launch.train --arch fourierpim-lm
    --batch 8 --seq 2048`` for TRAIN_STEPS steps, the counters zeroed just
    before: fft_planes and nothing else, the loss falls, the step ms,
    tokens/s and peak memory; then a run resumed from its step
    TRAIN_RESUME_AT checkpoint, its losses held to the uninterrupted
    run's."""
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    first, second = (os.path.join(TRAIN_DIR, d) for d in ("run", "resume"))
    build.reset_launches()
    t0 = time.perf_counter()
    run = train.run(TRAIN_ARGS + [
        "--steps", str(TRAIN_STEPS), "--ckpt-dir", first,
        "--ckpt-every", str(TRAIN_RESUME_AT), "--log-every", "5"])
    wall = time.perf_counter() - t0
    launches = {k: c for k, c in build.LAUNCHES.items() if c}
    per_step = launches.get("fft_planes", 0) / TRAIN_STEPS
    want = len(TRAIN_FFT_CALLS) * get_config(FOURIER_ARCH).num_layers
    if set(launches) != {"fft_planes"} or per_step != want:
        raise SystemExit(f"full-width training: launches {launches} in "
                         f"{TRAIN_STEPS} steps, expected fft_planes {want} "
                         f"a step and nothing else")
    losses = run.losses
    if not losses[-1] < losses[0]:
        raise SystemExit(f"full-width training: loss {losses[0]} -> "
                         f"{losses[-1]} did not fall")
    steady = sorted(run.step_ms[2:])
    step_ms = steady[len(steady) // 2]
    os.makedirs(second)
    shutil.copytree(os.path.join(first, f"step_{TRAIN_RESUME_AT}"),
                    os.path.join(second, f"step_{TRAIN_RESUME_AT}"))
    resumed = train.run(TRAIN_ARGS + ["--steps", str(TRAIN_STEPS),
                                      "--ckpt-dir", second,
                                      "--log-every", "5"])
    if resumed.start_step != TRAIN_RESUME_AT:
        raise SystemExit(f"the resumed run started at step "
                         f"{resumed.start_step}, not {TRAIN_RESUME_AT}")
    tail = losses[TRAIN_RESUME_AT:]
    bitwise = resumed.losses == tail
    worst = max(abs(a - b) / abs(b) for a, b in zip(resumed.losses, tail))
    if worst > TRAIN_RESUME_RTOL:
        raise SystemExit(f"resumed losses {resumed.losses} off the "
                         f"uninterrupted run's {tail} by {worst} (bound "
                         f"{TRAIN_RESUME_RTOL})")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    out = {"args": TRAIN_ARGS, "steps": TRAIN_STEPS, "wall_s": wall,
           "launches": launches, "fft_planes_per_step": per_step,
           "step_ms_median": step_ms, "step_ms": run.step_ms,
           "tokens_per_step": run.tokens_per_step,
           "tokens_per_s": run.tokens_per_step / step_ms * 1e3,
           "peak_gib": run.peak_bytes / 2**30, "loss_first": losses[0],
           "loss_last": losses[-1], "losses": losses,
           "resumed_from": TRAIN_RESUME_AT,
           "resumed_bitwise": bitwise, "resumed_worst_rel": worst}
    print(f"[train] full width: {' '.join(TRAIN_ARGS)} --steps "
          f"{TRAIN_STEPS}: step {step_ms:.2f} ms (median of steps 2 on; "
          f"first two {run.step_ms[0]:.1f}, {run.step_ms[1]:.1f} ms), "
          f"{out['tokens_per_s']:.0f} tokens/s, peak memory "
          f"{out['peak_gib']:.2f} GiB, fft_planes {per_step:.0f} launches a "
          f"step and nothing else; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; resumed from step {TRAIN_RESUME_AT}: losses "
          f"{'equal bit for bit' if bitwise else f'within {worst:.3g}'} "
          f"of the uninterrupted run's; on {card}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 9: the model axis
# ---------------------------------------------------------------------------

#: (a) the model axes each TRAIN_PARITY step is split over
AXIS_SHARDS = (2, 4)
#: (b) the full-width run on a model axis of 2
AXIS_TRAIN_ARGS = TRAIN_ARGS + ["--mesh", "1x2"]
AXIS_TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_axis")
#: (c) qwen3-1.7b's prefill: its model axis, and the last logits' bound
#: against the unsharded card prefill by dtype. fp32: LM_TOL (the shards'
#: fp32 partial sums in another order). bf16: GEMMA_PARITY_TOL, phase 3's
#: bound for two bf16 prefills that round at other points: the row-parallel
#: products are summed in fp32 across the shards and rounded to bf16 once,
#: where the unsharded matmul rounds its own fp32 sum, so activations move
#: by a bf16 step now and then through 28 layers (measured on one H100:
#: 0.09375 at |logit| 4.75, outside LM_TOL)
AXIS_PREFILL_SHARDS = 2
AXIS_PREFILL_TOL = {"bfloat16": GEMMA_PARITY_TOL, "float32": LM_TOL}
#: (d) the reference's compiled ``run_cell`` argument bytes per device on
#: a (2, 2, 2) pod x data x model mesh
AXIS_DRYRUN = {("qwen3-1.7b", "decode_32k"): 61_145_757_828,
               ("fourierpim-lm", "train_4k"): 222_748_932}


def axis_mesh(sharding, shards: int, device: str = "cuda"):
    """A (data, model) mesh of one data shard and ``shards`` model shards,
    all on the first card (or the CPU)."""
    return sharding.make_mesh((1, shards), ("data", "model"), device=device)


def axis_steps(torch, build, convert, lm, sharded, sharding, collectives,
               adamw, pipeline, get_config, arch: str, card: str,
               device: str = "cuda") -> dict:
    """(a) TRAIN_PARITY's step of ``arch`` on the card, unsharded and then
    over each of AXIS_SHARDS model shards: the loss, the gradient norm and
    each leaf against the unsharded step's within TRAIN_STEP_TOL, the
    launches M x the unsharded step's (counters zeroed just before each),
    the ledger == ``sharded.collective_form``."""
    dev = torch.device(device)
    layers, B, S = TRAIN_PARITY[arch]
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=layers, dtype="float32") \
        if layers else cfg.scaled_down()
    params = {k: v.to(dev) for k, v in convert.init_params(
        cfg, torch.Generator().manual_seed(0)).items()}
    raw = pipeline.SyntheticLM(cfg.vocab_size, S, B, seed=0).batch_at(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}

    def counted(fn):
        build.reset_launches()
        with collectives.ledger() as led:
            loss, grads = fn()
        torch.cuda.synchronize()
        return (float(loss), float(adamw.global_norm(grads)), grads,
                {k: c for k, c in build.LAUNCHES.items() if c}, led)

    l0, n0, g0, base, _ = counted(lambda: lm.value_and_grad(
        lm.DecoderLM(cfg, device="meta"), params, batch))
    kernel, per_layer = TRAIN_PARITY_LAUNCHES[arch]
    if device == "cuda" and base != {kernel: per_layer * cfg.num_layers}:
        raise SystemExit(f"{cfg.name} unsharded step launched {base}")
    out = {"config": cfg.name, "layers": cfg.num_layers, "batch": B,
           "seq": S, "loss": l0, "grad_norm": n0, "launches": base,
           "shards": {}}
    for M in AXIS_SHARDS:
        sh = sharded.Shards(cfg, axis_mesh(sharding, M, device), params)
        l1, n1, g1, launches, led = counted(
            lambda: sharded.value_and_grad(sh, batch))
        errs = (abs(l1 - l0) / abs(l0), abs(n1 - n0) / abs(n0),
                max(float((g1[k] - g0[k]).abs().max())
                    / max(float(g0[k].abs().max()), 1e-30) for k in g0))
        if max(errs) > TRAIN_STEP_TOL:
            raise SystemExit(f"{cfg.name} step on {M} model shards against "
                             f"unsharded: relative (loss, norm, worst leaf) "
                             f"{errs} (bound {TRAIN_STEP_TOL})")
        want = {k: M * c for k, c in base.items()}
        if launches != want:
            raise SystemExit(f"{cfg.name} step on {M} model shards launched "
                             f"{launches}, expected {want} (M x unsharded)")
        ledger = {k: [led.counts[k], led.bytes_by_kind[k]]
                  for k in led.counts if led.counts[k]}
        form = sharded.collective_form(cfg, M, B, S, step=True)
        if ledger != form:
            raise SystemExit(f"{cfg.name} step on {M} model shards: ledger "
                             f"{ledger}, closed form {form}")
        out["shards"][M] = {"loss": l1, "grad_norm": n1,
                            "loss_rel": errs[0], "grad_norm_rel": errs[1],
                            "worst_leaf_rel": errs[2], "launches": launches,
                            "ledger": ledger}
        print(f"[axis] one step of {cfg.name} ({cfg.num_layers} layers, d "
              f"{cfg.d_model}, fp32, B {B} x S {S}) on {M} model shards "
              f"against unsharded, both on the card: relative loss "
              f"{errs[0]:.3g}, norm {errs[1]:.3g}, worst leaf {errs[2]:.3g} "
              f"(bound {TRAIN_STEP_TOL}); launches {launches} = {M} x "
              f"{base}; ledger {ledger} == the closed form; on {card}",
              flush=True)
    return out


def axis_full_width(torch, build, train, get_config, card: str,
                    unsharded: dict | None) -> dict:
    """(b) ``launch.train`` at full width with ``--mesh 1x2`` for TRAIN_STEPS
    steps (counters zeroed just before), then resumed from its step
    TRAIN_RESUME_AT checkpoint; ``unsharded``: phase 8's run, printed
    beside."""
    shutil.rmtree(AXIS_TRAIN_DIR, ignore_errors=True)
    first, second = (os.path.join(AXIS_TRAIN_DIR, d)
                     for d in ("run", "resume"))
    build.reset_launches()
    run = train.run(AXIS_TRAIN_ARGS + [
        "--steps", str(TRAIN_STEPS), "--ckpt-dir", first,
        "--ckpt-every", str(TRAIN_RESUME_AT), "--log-every", "10"])
    launches = {k: c for k, c in build.LAUNCHES.items() if c}
    per_step = launches.get("fft_planes", 0) / TRAIN_STEPS
    want = 2 * len(TRAIN_FFT_CALLS) * get_config(FOURIER_ARCH).num_layers
    if set(launches) != {"fft_planes"} or per_step != want:
        raise SystemExit(f"--mesh 1x2 training: launches {launches}, "
                         f"expected fft_planes {want} a step (2 shards x "
                         f"{want // 2}) and nothing else")
    losses = run.losses
    if not losses[-1] < losses[0]:
        raise SystemExit(f"--mesh 1x2 training: loss {losses[0]} -> "
                         f"{losses[-1]} did not fall")
    steady = sorted(run.step_ms[2:])
    step_ms = steady[len(steady) // 2]
    os.makedirs(second)
    shutil.copytree(os.path.join(first, f"step_{TRAIN_RESUME_AT}"),
                    os.path.join(second, f"step_{TRAIN_RESUME_AT}"))
    resumed = train.run(AXIS_TRAIN_ARGS + ["--steps", str(TRAIN_STEPS),
                                           "--ckpt-dir", second,
                                           "--log-every", "10"])
    tail = losses[TRAIN_RESUME_AT:]
    bitwise = resumed.start_step == TRAIN_RESUME_AT and resumed.losses == tail
    if not bitwise:
        raise SystemExit(f"--mesh 1x2 resumed from step {resumed.start_step}:"
                         f" losses {resumed.losses}, the uninterrupted run's "
                         f"{tail}")
    shutil.rmtree(AXIS_TRAIN_DIR, ignore_errors=True)
    out = {"args": AXIS_TRAIN_ARGS, "steps": TRAIN_STEPS,
           "launches": launches, "fft_planes_per_step": per_step,
           "step_ms_median": step_ms, "step_ms": run.step_ms,
           "tokens_per_s": run.tokens_per_step / step_ms * 1e3,
           "peak_gib": run.peak_bytes / 2**30, "loss_first": losses[0],
           "loss_last": losses[-1], "resumed_bitwise": bitwise}
    beside = ""
    if unsharded:
        out["unsharded"] = {k: unsharded[k] for k in (
            "step_ms_median", "tokens_per_s", "peak_gib",
            "fft_planes_per_step", "loss_first", "loss_last")}
        beside = (f"; phase 8's unsharded run: step "
                  f"{unsharded['step_ms_median']:.2f} ms, "
                  f"{unsharded['tokens_per_s']:.0f} tokens/s, peak "
                  f"{unsharded['peak_gib']:.2f} GiB, "
                  f"{unsharded['fft_planes_per_step']:.0f} launches a step")
    print(f"[axis] full width: {' '.join(AXIS_TRAIN_ARGS)} --steps "
          f"{TRAIN_STEPS}: step {step_ms:.2f} ms (median of steps 2 on), "
          f"{out['tokens_per_s']:.0f} tokens/s, peak memory "
          f"{out['peak_gib']:.2f} GiB, fft_planes {per_step:.0f} launches a "
          f"step (2 shards on one card) and nothing else; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; resumed from step "
          f"{TRAIN_RESUME_AT}: equal bit for bit{beside}; on {card}",
          flush=True)
    return out


def axis_prefill(torch, build, convert, sharded, sharding, get_config,
                 card: str) -> dict:
    """(c) qwen3-1.7b's prefill at full width (B GEMMA_PARITY_BATCH x
    LM_PROMPT), unsharded and on AXIS_PREFILL_SHARDS model shards
    (counters zeroed just before each), in bf16 (the wgmma kernel) and in
    fp32 (the 3xTF32 kernel): one launch a layer, then one a layer a shard
    (8 q heads over 4 kv heads each); the last logits within
    AXIS_PREFILL_TOL of the unsharded card prefill's for the dtype, and
    the same greedy token wherever the unsharded top two are more than
    twice the bound apart; the sharded bf16 prefill's ms (CUDA events, the
    second of two runs)."""
    dev = torch.device("cuda")
    M = AXIS_PREFILL_SHARDS
    out = {}
    for dtype, counter in (("bfloat16", "flash_attention_wgmma"),
                           ("float32", "flash_attention_tf32")):
        cfg = dataclasses.replace(get_config(LM_ARCH), dtype=dtype)
        tol = AXIS_PREFILL_TOL[dtype]
        model = convert.build(cfg, full_width_state(torch, convert, cfg),
                              dev)
        tokens = torch.randint(
            0, cfg.vocab_size, (GEMMA_PARITY_BATCH, LM_PROMPT), device=dev,
            generator=torch.Generator(device=dev).manual_seed(5))
        build.reset_launches()
        want, _ = model.prefill(tokens)
        torch.cuda.synchronize()
        base = {k: c for k, c in build.LAUNCHES.items() if c}
        sh = sharded.Shards(cfg, axis_mesh(sharding, M),
                            dict(model.named_parameters()))
        build.reset_launches()
        got, _ = sharded.prefill(sh, tokens)
        torch.cuda.synchronize()
        launches = {k: c for k, c in build.LAUNCHES.items() if c}
        if base != {counter: cfg.num_layers} or \
                launches != {counter: M * cfg.num_layers}:
            raise SystemExit(f"qwen3-1.7b {dtype} prefill: launches {base} "
                             f"unsharded, {launches} on {M} shards; expected "
                             f"{counter} once a layer, and once a layer a "
                             f"shard")
        ms = None
        if dtype == "bfloat16":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            sharded.prefill(sh, tokens)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
        g, w = got.float(), want.float()
        V = cfg.vocab_size
        err = float((g - w).abs().max())
        top2 = torch.topk(w[:, :V], 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * tol["atol"]
        same = bool((g[:, :V].argmax(-1) == w[:, :V].argmax(-1))[clear]
                    .all())
        within = bool(torch.isfinite(g).all()) and bool(
            torch.allclose(g, w, **tol))
        out[dtype] = {"batch": GEMMA_PARITY_BATCH, "prompt": LM_PROMPT,
                      "shards": M, "launches": launches,
                      "last_logits_max_abs": err,
                      "logit_max_abs": float(w.abs().max()), "bound": tol,
                      "greedy_rows_held": int(clear.sum()),
                      "greedy_equal": same, "prefill_ms": ms}
        print(f"[axis] {cfg.name} {dtype} prefill at full width (B "
              f"{GEMMA_PARITY_BATCH} x S {LM_PROMPT}) on {M} model shards "
              f"(8 q heads over 4 kv heads a shard): launches {launches}; "
              f"last logits against the unsharded card prefill |diff|max "
              f"{err:.4g} (|logit|max {out[dtype]['logit_max_abs']:.3g}; "
              f"bound {tol}), greedy tokens "
              f"{'equal' if same else 'DIFFER'} on the {int(clear.sum())} "
              f"of {GEMMA_PARITY_BATCH} rows whose top two are apart by "
              f"more than twice the bound"
              + (f"; prefill {ms:.2f} ms" if ms else "") + f"; on {card}",
              flush=True)
        del model, sh
        torch.cuda.empty_cache()
        if not (within and same):
            raise SystemExit(f"qwen3-1.7b {dtype} prefill on {M} model "
                             f"shards: last logits off the unsharded by "
                             f"{err} (bound {tol}) or greedy tokens differ")
    return out


def axis_dryrun(dryrun, sharding, card: str) -> dict:
    """(d) ``run_cell`` on the meta (2, 2, 2) mesh: the argument bytes a
    device against the reference's compiled ``run_cell``'s."""
    mesh = sharding.make_mesh((2, 2, 2), ("pod", "data", "model"),
                              device="meta")
    out = {}
    for (arch, shape), want in AXIS_DRYRUN.items():
        r = dryrun.run_cell(arch, shape, mesh, verbose=False)
        got = r["argument_bytes_per_device"]
        if got != want:
            raise SystemExit(f"dry-run {arch} x {shape}: argument bytes "
                             f"{got}, the reference's {want}")
        out[f"{arch} x {shape}"] = {
            k: r[k] for k in ("argument_bytes_per_device",
                              "output_bytes_per_device", "flops_per_device",
                              "collective_bytes", "run_s")}
        coll = {k: v for k, v in r["collective_bytes"].items()
                if k != "counts"}
        print(f"[axis] dry-run {arch} x {shape} on the meta (2, 2, 2) mesh: "
              f"argument bytes a device {got} == the reference's {want}; "
              f"flops a device {r['flops_per_device']:.4g}, collectives "
              f"{coll} in {r['run_s']} s (host, nothing on {card})",
              flush=True)
    return out


def axis_phase(torch, build, convert, lm, train, adamw, pipeline,
               get_config, card: str, unsharded: dict | None) -> dict:
    """Phase 9: (a) steps against unsharded, (b) the full-width run with a
    resume, (c) the sharded bf16 prefill, (d) the dry-run's bytes."""
    from repro_torch.dist import collectives, sharding
    from repro_torch.launch import dryrun
    from repro_torch.models import sharded
    out = {"device_map": axis_mesh(sharding, 4).describe(),
           "steps": {arch: axis_steps(torch, build, convert, lm, sharded,
                                      sharding, collectives, adamw, pipeline,
                                      get_config, arch, card)
                     for arch in TRAIN_PARITY}}
    print(f"[axis] {out['device_map']}: the collectives are copies in the "
          f"card's memory, no interconnect is measured", flush=True)
    torch.cuda.empty_cache()
    out["full_width"] = axis_full_width(torch, build, train, get_config,
                                        card, unsharded)
    torch.cuda.empty_cache()
    out["dryrun"] = axis_dryrun(dryrun, sharding, card)
    out["prefill"] = axis_prefill(torch, build, convert, sharded, sharding,
                                  get_config, card)
    return out


@contextlib.contextmanager
def conv_labelled(torch, common, kops):
    """The Fourier mixer's convolution under a ``record_function`` label
    "conv": its forward (looked up by ``fourier_mixing`` in ``common``)
    and its backward (``kops._CausalConv.backward``), while the block
    runs."""
    forward, backward = common.fft_causal_conv, kops._CausalConv.backward

    def fwd(*args, **kwargs):
        with torch.profiler.record_function("conv"):
            return forward(*args, **kwargs)

    def bwd(ctx, *grads):
        with torch.profiler.record_function("conv"):
            return backward(ctx, *grads)

    common.fft_causal_conv = fwd
    kops._CausalConv.backward = staticmethod(bwd)
    try:
        yield
    finally:
        common.fft_causal_conv = forward
        kops._CausalConv.backward = staticmethod(backward)


def train_traced_step(torch, build, convert, kfft, kops, common, adamw,
                      step_mod, pipeline, get_config, card: str,
                      radix: int) -> dict:
    """(d) One traced full-width training step of fourierpim-lm (B 8 x S
    2048), after a warm one: its device time split into the fft kernel
    (graph replays of fft_planes at the step's TRAIN_FFT_CALLS shapes:
    the trace drops events of the ctypes-launched kernels), the
    convolution's glue (the other kernels under the "conv" label), the
    matmuls, the optimizer (``adamw.apply`` and ``clip_by_global_norm``)
    and the rest; and the card's idle share of the step's wall time."""
    dev = torch.device("cuda")
    cfg = get_config(FOURIER_ARCH)
    opt_cfg = adamw.OptConfig(lr=1e-3, warmup_steps=20, total_steps=100)
    step = step_mod.make_train_step(cfg, opt_cfg)
    params = full_width_state(torch, convert, cfg)
    state = adamw.init_state(params, opt_cfg)
    raw = pipeline.SyntheticLM(cfg.vocab_size, LM_PROMPT, LM_BATCH,
                               seed=0).batch_at(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    params, state, metrics = step(params, state, batch)        # warm
    float(metrics["loss"])
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    stages = (adamw, ("apply", "clip_by_global_norm"))
    labels = ["conv"] + stage_labels(stages)
    torch.cuda.synchronize()
    with conv_labelled(torch, common, kops), labelled(torch, stages), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        float(metrics["loss"])
        wall = (time.perf_counter() - t0) * 1e3
    del params, state, batch
    torch.cuda.empty_cache()
    split = stage_split(prof, labels)
    traced, fft_traced, fft_count, matmul = 0.0, 0.0, 0, 0.0
    kernels = []
    for e in prof.key_averages():
        # a record_function range also shows as a device-side span of its
        # label, which is not a kernel
        if e.device_type != DeviceType.CUDA or e.key in labels:
            continue
        ms = e.self_device_time_total / 1e3
        if FFT_TRACE_NAME.search(e.key):
            fft_traced += ms
            fft_count += e.count
            continue
        traced += ms
        if MATMUL_TRACE_NAME.search(e.key):
            matmul += ms
        else:
            kernels.append((ms, e.count, e.key[:100]))
    # the fft kernel's time from graph replays at the step's shapes
    rng = np.random.default_rng(19)
    n = kops._next_pow2(LM_PROMPT + cfg.fourier_taps)
    replay = {}
    for rows, inverse in sorted(set(TRAIN_FFT_CALLS)):
        planes = [torch.from_numpy(rng.standard_normal((rows, n)).astype(
            np.float32)).to(dev) for _ in range(2)]
        replay[f"{rows}x{n}{' inverse' if inverse else ''}"] = graph_ms(
            torch, lambda p, q, inv=inverse: kfft.fft_planes(
                p, q, inverse=inv, radix=radix), [planes], 10)
        del planes
    fft = cfg.num_layers * sum(
        replay[f"{rows}x{n}{' inverse' if inverse else ''}"]
        for rows, inverse in TRAIN_FFT_CALLS)
    # the conv label's kernels less the fft kernel's traced launches
    conv_glue = split["conv"]["ms"] - fft_traced
    optimizer = sum(split[label]["ms"] for label in labels[1:])
    matmul_outside = matmul - split["conv"]["matmul_ms"] - sum(
        split[label]["matmul_ms"] for label in labels[1:])
    device = traced + fft
    rest = device - fft - conv_glue - matmul_outside - optimizer
    out = {"device_ms": device, "wall_ms": wall, "fft_ms": fft,
           "fft_graph_ms": replay, "fft_launches_traced": fft_count,
           "fft_ms_traced": fft_traced, "conv_glue_ms": conv_glue,
           "matmul_ms": matmul_outside, "optimizer_ms": optimizer,
           "rest_ms": rest, "idle_share": max(0.0, 1 - device / wall),
           "top_other_kernels": sorted(kernels, reverse=True)[:8]}
    print(f"[train] one traced full-width step (B {LM_BATCH} x S "
          f"{LM_PROMPT}): wall {wall:.2f} ms, device {device:.2f} ms -> idle "
          f"share {out['idle_share']:.4f}; the fft kernel {fft:.2f} ms "
          f"(graph replays at the step's {len(TRAIN_FFT_CALLS)} calls a "
          f"layer; the trace held {fft_count} launches, "
          f"{fft_traced:.2f} ms), the convolution's glue {conv_glue:.2f} "
          f"ms, matmuls {matmul_outside:.2f} ms, the optimizer "
          f"{optimizer:.2f} ms, the rest {rest:.2f} ms; the largest kernels "
          f"but the fft and the matmuls (ms, launches, name) "
          f"{[(round(ms, 2), c, k) for ms, c, k in out['top_other_kernels']]}"
          f"; on {card}", flush=True)
    return out


def train_phase(torch, build, convert, lm, kfft, kops, common, adamw,
                step_mod, pipeline, train, get_config, card: str,
                radix: int) -> dict:
    """Phase 8: (a) the convolution's gradient on the kernel, (b) card
    against CPU, (c) the slice at full width with a resume, (d) one traced
    step. Each LM step zeroes the counters just before it."""
    out = {"conv": train_conv_check(torch, build, kfft, kops, radix, card)}
    out["card_vs_cpu"] = {
        arch: train_card_vs_cpu(torch, build, convert, lm, adamw, pipeline,
                                get_config, arch, card)
        for arch in TRAIN_PARITY}
    torch.cuda.empty_cache()
    out["full_width"] = train_full_width(torch, build, train, get_config,
                                         card)
    torch.cuda.empty_cache()
    out["traced_step"] = train_traced_step(
        torch, build, convert, kfft, kops, common, adamw, step_mod, pipeline,
        get_config, card, radix)
    return out


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


#: the phases, in order; phase 1 (the build) always runs
PHASES = (1, 2, 3, 4, 5, 6, 7, 8, 9)


def parse_phases(argv=None) -> tuple[set[int], bool]:
    """``--phases 1,3``: the phases to run, for a card call that needs only
    some (phase 1 always runs; phase 5 reads phase 4's times, so it brings
    phase 4). With no argument every phase runs, and only such a full run
    prints the result lines. ``--tile-ab``: the A/B of the fp32 hd-32
    instance's tiles after phase 1 (``tile_ab``); without ``--phases`` it
    runs no other phase. Returns the phases and whether to run the A/B."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--tile-ab", action="store_true",
                    help="after phase 1, the A/B of the fp32 head_dim-32 "
                         "instance's key tile and stages (TILE_AB)")
    args = ap.parse_args(argv)
    if args.phases is None:
        return ({1} if args.tile_ab else set(PHASES)), args.tile_ab
    try:
        phases = {int(p) for p in args.phases.split(",")}
    except ValueError:
        ap.error(f"--phases {args.phases!r}: comma-separated integers")
    if not phases <= set(PHASES):
        ap.error(f"--phases {args.phases!r}: phases are {list(PHASES)}")
    return phases | {1} | ({4} if 5 in phases else set()), args.tile_ab


def main(argv=None) -> int:
    phases, run_tile_ab = parse_phases(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.core import fft as core_fft
    from repro_torch.core import ntt as ntt_core
    from repro_torch.kernels import _build
    from repro_torch.kernels import fft as kfft
    from repro_torch.kernels import ntt as kntt
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import polymul as kpoly
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import attention as kattn
    from repro_torch.launch import engine as engine_mod
    from repro_torch.launch import ops as op_registry
    from repro_torch.launch import serve
    from repro_torch.models import convert, lm
    from repro_torch.data import pipeline
    from repro_torch.launch import train
    from repro_torch.models.layers import common
    from repro_torch.models.layers import moe as moe_mod
    from repro_torch.models.layers import recurrent as rec_mod
    from repro_torch.models.layers.common import MIXING_RADIX
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod

    start = time.perf_counter()

    def clock(label: str) -> None:
        """Seconds since the start, after each step: the run time by
        phase."""
        print(f"[clock] {label}: {time.perf_counter() - start:.1f}s",
              flush=True)

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    ptxas = start_ptxas_report(_build, ATTENTION)
    kernel_ptxas = {src: start_ptxas_report(_build, src)
                    for src in (STOCKHAM, NTT)}
    libs = _build.build()
    _build.load()
    card = card_line()
    print(f"[build] {STOCKHAM}, {NTT}, {ATTENTION} -> "
          f"{', '.join(str(v) for v in libs.values())} in "
          f"{time.perf_counter() - t0:.1f}s; card: {card}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    tc_build = tc_kernel_report(ptxas, libs["attention"])
    registers = {src: kernel_report(proc, src)
                 for src, proc in kernel_ptxas.items()}

    clock("phase 1, build")
    if run_tile_ab:
        print(f"[tile ab json] "
              f"{json.dumps(tile_ab(torch, kattn, _build, card))}",
              flush=True)
        clock("the A/B of the fp32 hd-32 tiles")
    # -- phase 2: kernels vs plain vs numpy ----------------------------------
    if 2 in phases:
        _build.reset_launches()
        worst = check_kernels(torch, kfft, kpoly, core_fft)
        clock("phase 2, float kernels")
        worst.update(check_ntt_kernels(torch, kntt, ntt_core, core_fft))
        clock("phase 2, NTT kernels")
        worst.update(check_attention(torch, kattn, _build))
        clock("phase 2, flash attention")
        two_pass_held = check_two_pass(torch, kfft, kpoly)
        clock("phase 2, float two-pass schedules")
        two_pass_held.update(check_ntt_two_pass(torch, kntt, ntt_core, kfft))
        clock("phase 2, NTT two-pass schedules")
        worst.update(check_fourier_ops(torch, _build, kfft, kops,
                                       MIXING_RADIX))
        clock("phase 2, FFT compositions")
        moved = dict(_build.LAUNCHES)
        if not all(moved.values()):
            raise SystemExit(f"a kernel never launched in the sweep: {moved}")
        print(f"[kernels] all eleven held against their plain versions (the "
              f"transform kernels against numpy too; fft, rfft, irfft, both "
              f"products and the three NTT kernels bit for bit under every "
              f"schedule in {two_pass_held} cases); launches {moved}; worst "
              f"|kernel-plain| {worst}", flush=True)

        clock("phase 2, kernels vs plain")
    # -- phase 3: serve, launch counters zeroed just before --------------------
    if 3 in phases:
        _build.reset_launches()
        expected, warm, warm_schedules = serve_phase(serve, engine_mod, _build)
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
        # the RNS route's calls while serving, by schedule: each dispatched
        # batch under the planned one (its kernel launches: the plan's)
        served = collections.Counter(_build.SCHEDULES) - warm_schedules
        rns_route = TRANSFORM_KERNELS["rns_ntt_polymul"][0]
        planned = kntt.rns_schedule(RNS_N)
        took = {sched: c for (name, sched), c in served.items()
                if name == "rns_ntt_polymul"}
        if took != {kntt.schedule_name(planned): expected[rns_route]}:
            raise SystemExit(f"rns_ntt_polymul: calls by schedule while "
                             f"serving {took}, expected "
                             f"{expected[rns_route]} under the planned "
                             f"{kntt.schedule_name(planned)}")
        print(f"[serve] calls by schedule while serving {dict(served)}: "
              f"the RNS route's {expected[rns_route]} batches all under its "
              f"planned {kntt.schedule_name(planned)} schedule "
              f"({1 if planned is None else planned.launches} kernel "
              f"launch(es) each)", flush=True)
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
        clock("phase 3, serve and library path")
        traced = idle_shares(torch, serve, card)
        clock("phase 3, traced serve cells")
        # the LMs: each served run zeroes the counters just before
        lm_run = lm_phase(torch, _build, serve, convert, lm, get_config)
        clock("phase 3, qwen3-1.7b")
        gemma_run = gemma_phase(torch, _build, serve, convert, kattn,
                                get_config)
        clock("phase 3, gemma3-4b")
        reduced_run = reduced_phase(torch, _build, convert, kattn, get_config)
        clock("phase 3, reduced config")
        fourier_run = fourier_phase(torch, _build, serve, convert, kfft, kops,
                                    get_config, MIXING_RADIX)
        clock("phase 3, fourierpim-lm")
        mixer_run = mixer_phase(torch, _build, serve, convert, kattn, moe_mod,
                                get_config)
        clock("phase 3, the MoE and recurrent archs")
        rest_run = rest_phase(torch, _build, serve, convert, lm, kattn,
                              get_config, card)
        clock("phase 3, starcoder2-15b, llama3-405b, musicgen-medium and "
              "qwen2-vl-72b")
    # -- phase 4: timings ----------------------------------------------------
    if 4 in phases:
        times = timings(torch, kfft, kpoly, core_fft, _build, card)
        clock("phase 4, transform timings")
        ab = schedule_ab(torch, kfft, kpoly, kntt, ntt_core, card)
        clock("phase 4, schedule A/B")
        times.update(ntt_timings(torch, kntt, ntt_core, core_fft, _build,
                                 card))
        clock("phase 4, NTT timings")
        attn = {label: attention_timing(torch, kattn, _build, card, label)
                for label in ATTN_TIMED}
        clock("phase 4, flash attention timings")
        timed = functools.partial(lm_timing, torch, _build, convert, lm,
                                  kattn, get_config, card)
        lm_times = timed(LM_ARCH)
        gemma_times = timed(GEMMA_ARCH)
        fp32_times = timed(LM_ARCH, dtype="float32", decode=False)
        clock("phase 4, qwen3-1.7b and gemma3-4b bf16, qwen3-1.7b fp32")
        gemma_fp32_times = timed(GEMMA_ARCH, dtype="float32", decode=False)
        clock("phase 4, gemma3-4b fp32")
        fourier_times = fourier_timing(torch, _build, convert, lm, kfft, kops,
                                       get_config, card, MIXING_RADIX)
        clock("phase 4, fourierpim-lm")
        mixer_times = {
            "granite-moe-3b-a800m": timed("granite-moe-3b-a800m",
                                          stages=(moe_mod, MOE_STAGES)),
            "hymba-1.5b": timed("hymba-1.5b", trace=False),
            "rwkv6-7b": timed("rwkv6-7b", trace_layers=SCAN_TRACE_LAYERS,
                              stages=(rec_mod, SCAN_STAGES)),
            MIXTRAL_ARCH: timed(MIXTRAL_ARCH, layers=MIXTRAL_LAYERS,
                                trace=False)}
        clock("phase 4, the MoE and recurrent archs")
    # -- phase 5: the cost model on the card -------------------------------
    if 5 in phases:
        cost_model = {"paper_gpu_model": paper_gpu_model(times, fourier_times,
                                                         card),
                      "auto_vs_card": auto_vs_card(torch, op_registry,
                                                   core_fft, times, card),
                      "auto_engine": auto_engine(torch, _build, serve, card)}
        print(f"[cost model json] {json.dumps(cost_model)}", flush=True)
        clock("phase 5, cost model on the card")
    # -- phase 6: fault tolerance on the card --------------------------------
    if 6 in phases:
        ft = ft_phase(torch, _build, engine_mod, serve, card)
        print(f"[ft json] {json.dumps(ft)}", flush=True)
        clock("phase 6, fault tolerance")
    # -- phase 7: the multi-device tier --------------------------------------
    if 7 in phases:
        t7 = time.perf_counter()
        dist = dist_phase(torch, _build, serve, engine_mod, op_registry, card)
        print(f"[dist json] {json.dumps(dist)}", flush=True)
        clock(f"phase 7, multi-device tier ({time.perf_counter() - t7:.1f}s)")
    # -- phase 8: training ---------------------------------------------------
    if 8 in phases:
        t8 = time.perf_counter()
        training = train_phase(torch, _build, convert, lm, kfft, kops, common,
                               adamw, step_mod, pipeline, train, get_config,
                               card, MIXING_RADIX)
        print(f"[train json] {json.dumps(training)}", flush=True)
        clock(f"phase 8, training ({time.perf_counter() - t8:.1f}s)")
    # -- phase 9: the model axis -------------------------------------------
    if 9 in phases:
        t9 = time.perf_counter()
        axis = axis_phase(torch, _build, convert, lm, train, adamw, pipeline,
                          get_config, card, training["full_width"]
                          if 8 in phases else None)
        print(f"[axis json] {json.dumps(axis)}", flush=True)
        clock(f"phase 9, the model axis ({time.perf_counter() - t9:.1f}s)")
    if phases != set(PHASES):
        print(f"[phases] ran {sorted(phases)} of {list(PHASES)}: a partial "
              f"run prints no result lines", flush=True)
        return 0
    dist_runs: dict = collections.defaultdict(dict)
    for key, entry in dist["served"]["cells"].items():
        dist_runs[DIST_COUNTER[entry["op"]]][key] = {
            k: entry[k] for k in ("route", "launches", "batches",
                                  "launches_per_call", "ms_per_call")}
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
            **({"schedule_ab": ab[name]} if name in ab else {}),
            # a multi-launch call's launches under their own kernel names
            "device_kernels": {n: times[name][n]["by_kernel"]
                               for n in shapes
                               if times[name][n].get("by_kernel")},
            **({"ptxas": {k: registers[source].get(k) for n in shapes
                          for k in times[name][n].get("by_kernel") or {}}}
               if source in registers else {}),
            # phase 7: the distributed route's served run, counters zeroed
            # just before it
            **({"distributed": dist_runs[name]} if name in dist_runs
               else {}),
            # the LM path: fourierpim-lm's prefill, 3 calls a layer; its
            # training step (phase 8), 9 calls a layer under remat
            **({FOURIER_ARCH: {
                "launches_per_prefill": fourier_run["launches"],
                **fourier_run, "lm": fourier_times},
                f"{FOURIER_ARCH} training": {
                    "launches_per_step":
                        training["full_width"]["fft_planes_per_step"],
                    "full_width": training["full_width"],
                    "traced_step": training["traced_step"],
                    "conv_forward_backward": training["conv"]},
                # phase 9: the step on a model axis of 2 on one card, 9
                # calls a layer a shard
                f"{FOURIER_ARCH} training, model axis": {
                    "launches_per_step":
                        axis["full_width"]["fft_planes_per_step"],
                    "launches_per_shard_per_step":
                        axis["full_width"]["fft_planes_per_step"] / 2,
                    "full_width": axis["full_width"],
                    "steps": axis["steps"][FOURIER_ARCH]}}
               if name == "fft_planes" else {}),
            **{f"at_n{n}": times[name][n] for n in shapes[1:]}})
    # kernel 9's entries, each at its ATTN_TIMED labels (the first is the
    # entry's numbers): the wgmma kernel at hd 64/128 (qwen3-1.7b's served
    # prefill), at hd 320 (gemma3-4b's) and at hd 32 (the reduced configs'
    # bf16 prefill), the tf32 kernel at hd 64/128 (the fp32 parity path),
    # at hd 320 (the full-width fp32 gemma3-4b prefill) and at hd 32 (the
    # reduced configs' fp32 prefill and training step); then the CUDA-core
    # kernel, which no path launches, from its turns at CUDA_CORE_TIMED
    instances = tc_build["instances"]

    def built(*prefixes):
        return {k: v for k, v in instances.items() if k.startswith(prefixes)}

    entries = {
        "flash_attention_wgmma": (
            "flash_attention_wgmma",
            lm_run["launches"]["flash_attention_wgmma"],
            "one served qwen3-1.7b prefill (28 layers)", ["served prefill"],
            {"build": built("bf16 hd 64,", "bf16 hd 128,"),
             "lm": {**lm_run, **lm_times},
             # phase 9: the bf16 prefill on a model axis of 2, one launch
             # a layer a shard
             "model_axis_prefill": {
                 **axis["prefill"]["bfloat16"],
                 "launches_per_shard": axis["prefill"]["bfloat16"][
                     "launches"]["flash_attention_wgmma"]
                 // AXIS_PREFILL_SHARDS},
             # the MoE and hybrid archs' served prefills (mixtral cut to
             # MIXTRAL_LAYERS layers), one launch a layer
             "moe_and_hybrid": {
                 arch: {"launches_per_served_prefill":
                        run["served"]["launches"]["flash_attention_wgmma"],
                        "layers": run["served"]["layers"],
                        "lm": mixer_times[arch]}
                 for arch, run in mixer_run.items()
                 if arch != "rwkv6-7b"},
             # REST_ARCHS's served or driven prefills (cut in depth where
             # REST_ARCHS says), one launch a layer, and the bf16 prefills
             # against the plain version swapped in
             "rest_archs": {
                 arch: {"launches_per_served_prefill":
                        run["served"]["launches"]["flash_attention_wgmma"],
                        "served": run["served"],
                        "kernel_vs_plain": run["kernel_vs_plain"]}
                 for arch, run in rest_run.items()}}),
        "flash_attention_wgmma[hd320]": (
            "flash_attention_wgmma", gemma_run["launches"],
            "one served gemma3-4b prefill (34 layers: 29 local, window "
            "1024, and 5 global)",
            ["gemma3-4b local, window 1024", "gemma3-4b global"],
            {"build": built("bf16 hd 320,"),
             "lm": {**gemma_run, **gemma_times}}),
        "flash_attention_wgmma[hd32]": (
            "flash_attention_wgmma", reduced_run["bfloat16"]["launches"],
            f"one bf16 prefill of the reduced qwen3-1.7b config (2 layers, "
            f"head_dim 32; B {GEMMA_PARITY_BATCH} x {REDUCED_PROMPT})",
            ["bf16 hd 32"],
            {"build": built("bf16 hd 32,"), "reduced": reduced_run}),
        "flash_attention_tf32": (
            "flash_attention_tf32", lm_run["launches"]["flash_attention_tf32"],
            "the full-width fp32 parity path: one forward and one prefill "
            "(28 layers each)", ["fp32"],
            {"build": built("tf32 hd 64,", "tf32 hd 128,"),
             "lm_fp32_prefill": fp32_times,
             # phase 9: the fp32 prefill on a model axis of 2
             "model_axis_prefill": axis["prefill"]["float32"],
             # the MoE and hybrid archs' fp32 checks: parity (a forward
             # and a prefill) and the 2 layers held against the CPU
             "moe_and_hybrid": {
                 arch: {"parity": run["parity"],
                        **({"card_vs_cpu": run["card_vs_cpu"]}
                           if "card_vs_cpu" in run else {})}
                 for arch, run in mixer_run.items()
                 if arch != "rwkv6-7b"},
             # REST_ARCHS's fp32 checks: the card against the CPU and
             # parity (a forward and a prefill)
             "rest_archs": {
                 arch: {"card_vs_cpu": run["card_vs_cpu"],
                        "parity": run["parity"]}
                 for arch, run in rest_run.items()}}),
        "flash_attention_tf32[hd320]": (
            "flash_attention_tf32",
            gemma_fp32_times["launches"]["flash_attention_tf32"],
            "one full-width fp32 gemma3-4b prefill (34 layers; B 8 x 2048)",
            ["fp32 hd 320", "fp32 hd 320 local, window 1024"],
            {"build": built("tf32 hd 320,"),
             "parity_6_layers": {
                 "launches": gemma_run["fp32_tf32_launches"],
                 "last_logits_max_abs":
                     gemma_run["fp32_kernel_vs_plain_last_logits_max_abs"]},
             "lm_fp32_prefill": gemma_fp32_times}),
        "flash_attention_tf32[hd32]": (
            "flash_attention_tf32", reduced_run["float32"]["launches"],
            f"one fp32 prefill of the reduced qwen3-1.7b config (2 layers, "
            f"head_dim 32; B {GEMMA_PARITY_BATCH} x {REDUCED_PROMPT})",
            ["fp32 hd 32"],
            {"build": built("tf32 hd 32,"), "reduced": reduced_run,
             # phase 8: one training step of the same config, card against
             # CPU (the forward and its recomputation under remat)
             "training_step": training["card_vs_cpu"][LM_ARCH],
             # phase 9: the same step on model axes of 2 and 4
             "training_step_model_axis": axis["steps"][LM_ARCH]})}
    for entry_name, (name, launched, per, labels, more) in entries.items():
        first = attn[labels[0]]
        report.append({
            "name": entry_name, "route": "cuda", "source": ATTENTION,
            "replaces": FLASH_REPLACES, "launches": launched,
            **{k: first[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
            "launches_per": per, "at_timed_shape": first,
            **{f"at {label}": attn[label] for label in labels[1:]}, **more})
    # the CUDA-core kernel: phase 3's runs each require the launches of
    # their own kernel and none of another, so none of it
    core = attn[CUDA_CORE_TIMED]
    report.append({
        "name": "flash_attention", "route": "cuda", "source": ATTENTION,
        "replaces": FLASH_REPLACES, "launches": 0,
        "max_abs_err": core["cuda_core_max_abs_err"],
        "ms": core["cuda_core_same_inputs_event_ms"],
        "plain_ms": core["cuda_core_plain_ms"],
        "bound_ms": core["cuda_core_bound_ms"],
        "bound_by": core["cuda_core_bound_by"],
        "library_ms": core["library_ms"],
        "launches_per": "no path: every (type, head_dim) goes to a "
                        "tensor-core kernel; launched directly on "
                        "CUDA_CORE_DIRECT and in turns beside them",
        "at_timed_shape": {"label": CUDA_CORE_TIMED, **core["shape"],
                           "turns": core["cuda_core_turns"]}})
    torch.cuda.synchronize()
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
