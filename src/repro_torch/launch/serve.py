"""Serving drivers (port of ``repro.launch.serve``).

--service fft    : single-op batched transform service. The op, its route,
                   payload dtype, warmup shape, traffic generator and result
                   verifier all come from the op-dispatch registry
                   (``launch/ops.py``).

--service engine : multiplexing continuous-batching engine
                   (``launch/engine.py``): a mixed stream of requests, each
                   with its own (op, n), shape-bucketed and served from one
                   process with tail batches at actual size, a deferred
                   device sync, bounded-queue backpressure, and per-request
                   p50/p99 latency beside throughput.

--service lm     : LM serving: random weights from a seed (``--arch``, full
                   width, or ``--smoke`` for the reduced config), a
                   (batch, prompt-len) prompt, one prefill whose attention
                   runs the flash-attention kernel in every layer (for
                   fourierpim-lm: whose token mixing runs the FFT kernel
                   three times in every layer), then ``--gen`` greedy
                   decode steps (``models/lm.py``).

All run on the card unless ``--device cpu`` is given; without a card they
raise rather than fall back to the CPU. ``--auto`` (fft and engine
services) lets the cost model (``core.cost``) choose each bucket's route
and prints its predicted seconds per request beside the observed ones.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --service fft \
      --n 4096 --batch 64 --requests 256 --op polymul-real
  PYTHONPATH=src python -m repro_torch.launch.serve --service engine \
      --ops fft,rfft,polymul,polymul-real --ns 4096,65536 --batch 64
  PYTHONPATH=src python -m repro_torch.launch.serve --service fft \
      --n 4096 --batch 64 --op polymul-mod --modulus-bits 109
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --n 256 --batch 4 --requests 16
  PYTHONPATH=src python -m repro_torch.launch.serve --service engine \
      --auto --ops fft,rfft,polymul,polymul-real,polymul-mod \
      --ns 4096,65536 --batch 64 --requests 400
  PYTHONPATH=src python -m repro_torch.launch.serve --service lm \
      --arch qwen3-1.7b --batch 8 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --service lm \
      --arch fourierpim-lm --batch 8 --prompt-len 2048 --gen 32
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch import ops as op_registry
from repro_torch.launch.engine import ServeEngine
from repro_torch.models import convert, lm


class FFTService:
    """Single-op transform service: one registry bucket on the engine.

    All op dispatch flows through ``launch/ops.py``; this class pins ONE
    (op, n) bucket, bound strictly (knobs the op does not consume are
    config errors, raised here at construction).
    """

    def __init__(self, n: int, batch: int, op: str = "fft",
                 modulus_bits: int | None = None, model_shards: int = 1,
                 max_pending: int = 1024, auto: bool = False,
                 device: str | torch.device | None = None):
        self.n = n
        self.op = op
        self.engine = ServeEngine(max_batch=batch, max_pending=max_pending,
                                  modulus_bits=modulus_bits,
                                  model_shards=model_shards, auto=auto,
                                  device=device)
        self.bound = self.engine.register(op, n, strict=True)
        self.plan = self.bound.plan
        self.route = self.bound.route
        self.results = self.engine.results

    def warmup(self) -> None:
        """Run the batch function once before serving."""
        self.engine.warmup()

    def submit(self, req_id: int, payload) -> None:
        self.engine.submit(self.op, self.n, payload, rid=req_id)

    def run(self, total_requests: int) -> dict:
        return self.engine.run(total_requests)


def produce(engine: ServeEngine, combos: list[tuple[str, int]],
            n_requests: int, rng: np.random.Generator
            ) -> tuple[dict[int, tuple[str, int, object]], dict]:
    """Submit ``n_requests`` payloads round-robin over ``combos`` from a
    producer thread while the engine serves them. Returns the payloads by
    rid and the engine's stats."""
    kept: dict[int, tuple[str, int, object]] = {}

    def producer():
        for i in range(n_requests):
            op, n = combos[i % len(combos)]
            payload = engine.bound(op, n).random_payload(rng)
            kept[engine.submit(op, n, payload)] = (op, n, payload)

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    stats = engine.run(n_requests)
    th.join()
    return kept, stats


def cost_text(bucket: dict) -> str:
    """A bucket's predicted against observed seconds per request, where the
    cost model chose its route (``--auto``); else nothing."""
    pred = bucket.get("predicted_s_per_req")
    if pred is None:
        return ""
    return (f" predicted={pred:.6g}s/req "
            f"({bucket['predicted_tier']}/{bucket['predicted_backend']}) "
            f"observed={bucket['observed_s_per_req']:.6g}s/req")


def run_fft_service(args) -> dict:
    svc = FFTService(args.n, args.batch, args.op,
                     modulus_bits=args.modulus_bits,
                     model_shards=args.model_shards,
                     max_pending=args.max_pending, auto=args.auto,
                     device=args.device)
    svc.warmup()
    kept, stats = produce(svc.engine, [(args.op, args.n)], args.requests,
                          np.random.default_rng(0))
    # verify one served result against the registry's numpy oracle
    rid = min(kept)
    svc.bound.verify(kept[rid][2], svc.results[rid])
    lat = stats["latency_ms"]
    print(f"[serve:fft] op={args.op} route={svc.route} n={args.n} "
          f"batch={args.batch} device={stats['device']} "
          f"served={stats['served']} in {stats['seconds']:.2f}s "
          f"-> {stats['throughput_per_s']:.1f} req/s "
          f"(compute-only {stats['compute_throughput_per_s']:.1f} req/s) "
          f"p50={lat['p50']:.2f}ms p99={lat['p99']:.2f}ms "
          f"[{svc.plan.describe()}]"
          + cost_text(next(iter(stats["buckets"].values()))))
    return stats


def engine_for(args) -> tuple[ServeEngine, list[tuple[str, int]]]:
    """The engine service's engine, every (op, n) bucket of the cross
    product of ``--ops`` and ``--ns`` registered, not yet warmed up."""
    ops = [s.strip() for s in args.ops.split(",") if s.strip()]
    ns = [int(s) for s in (args.ns or str(args.n)).split(",") if s.strip()]
    engine = ServeEngine(max_batch=args.batch, max_pending=args.max_pending,
                         modulus_bits=args.modulus_bits,
                         model_shards=args.model_shards, auto=args.auto,
                         device=args.device)
    combos = [(op, n) for op in ops for n in ns]
    for op, n in combos:
        engine.register(op, n)
    return engine, combos


def print_engine_stats(stats: dict) -> None:
    lat = stats["latency_ms"]
    print(f"[serve:engine] buckets={len(stats['buckets'])} "
          f"device={stats['device']} served={stats['served']} in "
          f"{stats['seconds']:.2f}s "
          f"-> {stats['throughput_per_s']:.1f} req/s "
          f"(compute-only {stats['compute_throughput_per_s']:.1f} req/s) "
          f"p50={lat['p50']:.2f}ms p90={lat['p90']:.2f}ms "
          f"p99={lat['p99']:.2f}ms")
    for name, b in stats["buckets"].items():
        print(f"[serve:engine]   {name} route={b['route']} "
              f"served={b['served']} batches={b['batches']} "
              f"mean_batch={b['mean_batch']:.1f} "
              f"utilization={b['utilization']:.2f}{cost_text(b)}")


def run_engine_service(args) -> dict:
    """Serve a mixed (op, n) stream from one engine process. Buckets come
    from the cross product of ``--ops`` and ``--ns``; one result per bucket
    is verified against the registry's numpy oracle after the drain."""
    engine, combos = engine_for(args)
    engine.warmup()
    kept, stats = produce(engine, combos, args.requests,
                          np.random.default_rng(0))
    first: dict[tuple[str, int], int] = {}
    for rid, (op, n, _) in sorted(kept.items()):
        first.setdefault((op, n), rid)
    for (op, n), rid in first.items():
        engine.bound(op, n).verify(kept[rid][2], engine.results[rid])
    print_engine_stats(stats)
    return stats


def run_lm_service(args) -> dict:
    """Prefill a random (batch, prompt_len) prompt and decode ``gen`` tokens
    greedily, with weights drawn from seed 0 and the prompt from seed 1, as
    the reference's CLI does from its keys. The time covers prefill and
    decode, not the weights' set-up."""
    device = op_registry.resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.scaled_down()
    weights = convert.init_params(
        cfg, torch.Generator(device=device).manual_seed(0))
    model = convert.build(cfg, weights, device)
    del weights
    B, S = args.batch, args.prompt_len
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device=device,
                           generator=torch.Generator(
                               device=device).manual_seed(1))
    t0 = time.perf_counter()
    generated = lm.generate(model, tokens, args.gen)
    out = generated.cpu().numpy()      # waits for the card
    dt = time.perf_counter() - t0
    toks = B * args.gen
    print(f"[serve:lm] arch={cfg.name} batch={B} prompt={S} gen={args.gen} "
          f"device={device.type} -> {toks / dt:.1f} tok/s (incl. prefill)")
    return {"tokens_per_s": toks / dt, "generated": out}


def parse_args(argv=None) -> argparse.Namespace:
    return _parser().parse_args(argv)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--service", choices=["fft", "engine", "lm"],
                    default="fft")
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=32,
                    help="single-op batch / engine continuous-batching "
                         "block cap (tail batches run at actual size)")
    ap.add_argument("--requests", type=int, default=256)
    # the op surface is derived from the registry
    ap.add_argument("--op", default="fft", choices=op_registry.op_names(),
                    help=op_registry.cli_help())
    ap.add_argument("--ops", default="fft,rfft,polymul-real",
                    help="engine service: comma-separated op mix "
                         f"(choices: {', '.join(op_registry.op_names())})")
    ap.add_argument("--ns", default=None,
                    help="engine service: comma-separated sequence "
                         "lengths (default: --n)")
    ap.add_argument("--max-pending", type=int, default=1024,
                    help="bounded admission queue: producers block "
                         "(backpressure) when it is full")
    ap.add_argument("--modulus-bits", type=int, default=None,
                    help=op_registry.cli_knob_help(
                        "modulus_bits", "target modulus width"))
    ap.add_argument("--model-shards", type=int, default=1,
                    help=op_registry.cli_knob_help(
                        "model_shards",
                        "shard the sequence over this many devices"))
    ap.add_argument("--auto", action="store_true",
                    help="fft and engine services: the cost model chooses "
                         "each bucket's route (core/cost.py), and each "
                         "bucket prints its predicted against its "
                         "observed seconds per request")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the kernels run; cuda raises when no card "
                         "is present")
    ap.add_argument("--arch", default="qwen3-1.7b",
                    help="lm service: architecture (configs/registry.py)")
    ap.add_argument("--smoke", action="store_true",
                    help="lm service: the arch's reduced config")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    return ap


def main(argv=None) -> dict:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.service == "lm":
        return run_lm_service(args)
    try:
        if args.service == "engine":
            return run_engine_service(args)
        return run_fft_service(args)
    except op_registry.OpConfigError as e:
        # the registry's own validation message, as a clean CLI exit
        ap.error(str(e))


if __name__ == "__main__":
    main()
