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
                   p50/p99 latency beside throughput. ``--verify`` gates
                   every batch on its ABFT check, ``--inject-faults`` /
                   ``--inject-stuck`` corrupt delivered rows from a seeded
                   fault model (chaos), ``--snapshot-dir`` makes the
                   process preemption-safe (SIGTERM drains, snapshots; the
                   next run warm-restarts), and ``--elastic`` closes the
                   straggler watchdog's loop at the CLI.

--service lm     : LM serving: random weights from a seed (``--arch``, full
                   width, or ``--smoke`` for the reduced config; every
                   arch of the registry; ``--layers`` cuts the depth), a
                   (batch, prompt-len) prompt, one prefill whose attention
                   runs the flash-attention kernel in every layer (for
                   fourierpim-lm: whose token mixing runs the FFT kernel
                   three times in every layer; rwkv6-7b has no attention
                   and runs no kernel of the port), then ``--gen`` greedy
                   decode steps (``models/lm.py``). An arch whose weights
                   do not fit the card (mixtral-8x22b: 1.4e11 parameters)
                   raises unless cut.

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
  PYTHONPATH=src python -m repro_torch.launch.serve --service engine \
      --verify --inject-faults 1e-9 --inject-stuck 1 \
      --ops fft,polymul,polymul-mod --ns 4096 --batch 64 --requests 512
  PYTHONPATH=src python -m repro_torch.launch.serve --service engine \
      --ops fft --ns 4096 --batch 64 --requests 100000 \
      --snapshot-dir /path/to/snapshots   # SIGTERM drains and snapshots
  PYTHONPATH=src python -m repro_torch.launch.serve --service lm \
      --arch qwen3-1.7b --batch 8 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --service lm \
      --arch fourierpim-lm --batch 8 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --service lm \
      --arch mixtral-8x22b --layers 2 --batch 8 --prompt-len 2048 --gen 32
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import threading
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.pim import FaultModel
from repro_torch.ft import checkpoint as ckpt_lib
from repro_torch.ft.watchdog import WatchdogConfig
from repro_torch.launch import ops as op_registry
from repro_torch.launch.engine import EngineStopped, ServeEngine
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
    producer thread while the engine serves them; once the engine drains
    toward a stop, the rest is shed. Returns the payloads by rid and the
    engine's stats."""
    kept: dict[int, tuple[str, int, object]] = {}

    def producer():
        try:
            for i in range(n_requests):
                op, n = combos[i % len(combos)]
                payload = engine.bound(op, n).random_payload(rng)
                kept[engine.submit(op, n, payload)] = (op, n, payload)
        except EngineStopped:
            pass    # draining toward a snapshot: shed the rest

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
    # verify every served result against the registry's numpy oracle
    for rid, (_, _, payload) in kept.items():
        svc.bound.verify(payload, svc.results[rid])
    lat = stats["latency_ms"]
    print(f"[serve:fft] op={args.op} route={svc.route} n={args.n} "
          f"batch={args.batch} device={stats['device']} "
          f"served={stats['served']} verified={len(kept)} in "
          f"{stats['seconds']:.2f}s "
          f"-> {stats['throughput_per_s']:.1f} req/s "
          f"(compute-only {stats['compute_throughput_per_s']:.1f} req/s) "
          f"p50={lat['p50']:.2f}ms p99={lat['p99']:.2f}ms "
          f"[{svc.plan.describe()}]"
          + cost_text(next(iter(stats["buckets"].values()))))
    return stats


def combos_for(args) -> list[tuple[str, int]]:
    """The engine service's buckets: the cross product of ``--ops`` and
    ``--ns``."""
    ops = [s.strip() for s in args.ops.split(",") if s.strip()]
    ns = [int(s) for s in (args.ns or str(args.n)).split(",") if s.strip()]
    return [(op, n) for op in ops for n in ns]


def fault_model_for(args, n_buckets: int) -> FaultModel | None:
    """The chaos fault model of ``--inject-faults`` / ``--inject-stuck``:
    one virtual crossbar array per bucket plus enough spares to quarantine
    every one of them; None without injection."""
    if not (args.inject_faults or args.inject_stuck):
        return None
    n_arrays = max(4, n_buckets)
    return FaultModel(seed=args.inject_fault_seed,
                      bitflip_per_gate=args.inject_faults,
                      stuck_per_array=args.inject_stuck,
                      n_arrays=n_arrays, spares=n_arrays)


def watchdog_cfg_from_args(args) -> WatchdogConfig | None:
    if (args.watchdog_threshold is None and args.watchdog_evict_after
            is None and args.watchdog_warmup is None):
        return None
    base = WatchdogConfig()
    return WatchdogConfig(
        threshold=(base.threshold if args.watchdog_threshold is None
                   else args.watchdog_threshold),
        evict_after=(base.evict_after if args.watchdog_evict_after is None
                     else args.watchdog_evict_after),
        warmup_steps=(base.warmup_steps if args.watchdog_warmup is None
                      else args.watchdog_warmup))


def engine_for(args, *, fault_model: FaultModel | None = None,
               on_evict=None) -> tuple[ServeEngine, list[tuple[str, int]]]:
    """The engine service's engine, every bucket of ``combos_for``
    registered, not yet warmed up: a warm restart from ``--snapshot-dir``
    where it holds a snapshot (on the restart-time ``--model-shards``,
    ``--batch`` and device), else a new engine."""
    wd_cfg = watchdog_cfg_from_args(args)
    if args.snapshot_dir and ckpt_lib.latest_step(args.snapshot_dir) \
            is not None:
        engine = ServeEngine.from_snapshot(
            args.snapshot_dir, model_shards=args.model_shards,
            max_batch=args.batch, watchdog_cfg=wd_cfg, on_evict=on_evict,
            device=args.device)
        life = engine.stats(seconds=1, busy_s=1)["lifetime"]
        print(f"[serve:engine] warm restart #{engine.restarts} from "
              f"{args.snapshot_dir} (lifetime served: {life['served']})",
              flush=True)
    else:
        engine = ServeEngine(max_batch=args.batch,
                             max_pending=args.max_pending,
                             modulus_bits=args.modulus_bits,
                             model_shards=args.model_shards, auto=args.auto,
                             verified=args.verify, fault_model=fault_model,
                             watchdog_cfg=wd_cfg, on_evict=on_evict,
                             device=args.device)
    combos = combos_for(args)
    for op, n in combos:
        engine.register(op, n)
    return engine, combos


def arm_chaos(engine: ServeEngine, args) -> None:
    """Deterministic straggler injection for exercising the elastic path
    at the CLI: each launch after ``--inject-straggler-after`` sleeps
    ``--inject-straggler-ms`` first, so the watchdog sees a run of
    breaches. Armed after the warmup, with the counter started at the
    reference's warmup count, one launch per registered bucket (its
    counter sees its warmup; the port's warmup runs many more launches,
    which it does not count), so the same served batches sleep as in the
    reference: the first is served batch K - buckets + 1. Armed only on
    the FIRST generation: after an elastic restart the engine serves
    cleanly."""
    if not args.inject_straggler_ms or engine.restarts > 0:
        return
    counter = {"i": len(engine._bound)}

    def make_slow(fn):
        def slow(*a):
            counter["i"] += 1
            if counter["i"] > args.inject_straggler_after:
                time.sleep(args.inject_straggler_ms / 1e3)
            return fn(*a)
        return slow

    for bound in engine._bound.values():
        bound.fn = make_slow(bound.fn)


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
        integ = b["integrity"]
        checks = (f" integrity=checked:{integ['checked']},corrupted:"
                  f"{integ['corrupted']},retried:{integ['retried']},"
                  f"fell_back:{integ['fell_back']}"
                  if integ["checked"] else "")
        print(f"[serve:engine]   {name} route={b['route']} "
              f"served={b['served']} batches={b['batches']} "
              f"mean_batch={b['mean_batch']:.1f} "
              f"utilization={b['utilization']:.2f}{checks}{cost_text(b)}")


def chaos_summary(stats: dict, fault_model: FaultModel) -> dict[str, int]:
    """The chaos run's recovery trajectory over every bucket."""
    integ = [b["integrity"] for b in stats["buckets"].values()]
    return {"detected": sum(v["corrupted"] for v in integ),
            "retried": sum(v["retried"] for v in integ),
            "fell_back": sum(v["fell_back"] for v in integ),
            "quarantined": len(fault_model.quarantined)}


def run_engine_service(args) -> dict:
    """Serve a mixed (op, n) stream from one engine process.

    Buckets come from the cross product of ``--ops`` and ``--ns``; one
    result per bucket is verified against the registry's numpy oracle after
    the drain, and a chaos run (``--inject-faults`` / ``--inject-stuck``)
    verifies EVERY delivered result and fails unless the gate detected and
    retried at least once.

    With ``--snapshot-dir`` the process is preemption-safe: SIGTERM stops
    admission, the engine drains every admitted request, and the lifetime
    stats, bucket config and watchdog state are snapshotted there; a run
    with the same directory warm-restarts from it. ``--elastic`` (needs
    ``--snapshot-dir``) closes the watchdog loop: an eviction drains the
    engine, snapshots, and warm-restarts it with ``--model-shards`` halved
    (floor 1), then serves the remaining requests.
    """
    fault_model = fault_model_for(args, len(combos_for(args)))
    holder: dict = {"engine": None, "evicted": False}

    def on_evict(eng, batch_idx):
        if not args.elastic:
            return
        holder["evicted"] = True
        print(f"[serve:engine] watchdog evicted batch {batch_idx}: "
              f"draining for elastic resize", flush=True)
        # request_stop on a thread of its own, as in the SIGTERM handler:
        # never take the engine's condition lock from a frame that may
        # already hold it
        threading.Thread(target=eng.request_stop, daemon=True).start()

    engine, combos = engine_for(args, fault_model=fault_model,
                                on_evict=on_evict)
    holder["engine"] = engine
    prev_term = None
    if args.snapshot_dir:
        def on_term(signum, frame):
            # drain-and-snapshot: stop admitting; run() finishes the
            # admitted backlog and returns, then the snapshot lands below.
            # Installed before the warmup, so a preemption there still
            # drains (an empty backlog) and snapshots. request_stop runs on
            # a thread of its own: the handler runs on the main thread's
            # frame, which may be inside the engine's condition lock.
            threading.Thread(target=holder["engine"].request_stop,
                             daemon=True).start()
        prev_term = signal.signal(signal.SIGTERM, on_term)

    rng = np.random.default_rng(0)

    def serve_round(engine: ServeEngine, n_requests: int) -> dict:
        """One engine generation: warmup, produce, drain, verify one result
        per bucket (every result under chaos)."""
        engine.warmup()
        arm_chaos(engine, args)
        # sync marker for supervisors: warmup done, handler armed
        print(f"[serve:engine] serving {n_requests} requests "
              f"across {len(combos)} buckets", flush=True)
        kept, stats = produce(engine, combos, n_requests, rng)
        checked: set[tuple[str, int]] = set()
        for rid, (op, n, payload) in sorted(kept.items()):
            if fault_model is None and (op, n) in checked:
                continue
            checked.add((op, n))
            engine.bound(op, n).verify(payload, engine.results[rid])
        return stats

    try:
        remaining = args.requests
        while True:
            holder["evicted"] = False
            stats = serve_round(engine, remaining)
            remaining -= stats["served"]
            if args.elastic and holder["evicted"] and remaining > 0:
                new_shards = max(1, engine.ctx.model_shards // 2)
                print(f"[serve:engine] elastic restart: model_shards "
                      f"{engine.ctx.model_shards} -> {new_shards}, "
                      f"{remaining} requests left", flush=True)
                engine = engine.elastic_restart(args.snapshot_dir,
                                                model_shards=new_shards)
                holder["engine"] = engine
                continue
            break
        if fault_model is not None:
            chaos = chaos_summary(stats, fault_model)
            print("[serve:engine] chaos: " + " ".join(
                f"{k}={v}" for k, v in chaos.items()), flush=True)
            if chaos["detected"] < 1 or chaos["retried"] < 1:
                raise SystemExit(
                    "chaos run produced no detected->retried event: the "
                    "injection settings are not exercising the ABFT "
                    "recovery path (raise --inject-faults or set "
                    "--inject-stuck)")
        if args.snapshot_dir:
            path = engine.snapshot(args.snapshot_dir)
            print(f"[serve:engine] snapshot -> {path}", flush=True)
    finally:
        if prev_term is not None:
            # the handler closes over the engine holder: left installed it
            # would take SIGTERM for any later engine in the process
            signal.signal(signal.SIGTERM, prev_term)
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
    cut = ""
    if args.layers is not None:
        if not 0 < args.layers <= cfg.num_layers:
            raise ValueError(f"--layers {args.layers}: {cfg.name} has "
                             f"{cfg.num_layers} layers")
        cut = f" layers={args.layers} of {cfg.num_layers} (cut)"
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    try:
        weights = convert.init_params(
            cfg, torch.Generator(device=device).manual_seed(0))
        model = convert.build(cfg, weights, device)
    except torch.cuda.OutOfMemoryError as exc:
        raise torch.cuda.OutOfMemoryError(
            f"{cfg.name}: {cfg.param_count():.3g} parameters do not fit "
            f"{device} in {cfg.param_dtype}: serve it --smoke or cut its "
            f"depth (--layers)") from exc
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
          f"device={device.type}{cut} -> {toks / dt:.1f} tok/s (incl. "
          f"prefill)")
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
    ap.add_argument("--snapshot-dir", default=None,
                    help="engine service: preemption-safe state dir -- "
                         "SIGTERM drains the admitted requests and "
                         "snapshots the engine's stats, buckets and "
                         "watchdog there; a run with the same dir "
                         "warm-restarts from it")
    ap.add_argument("--elastic", action="store_true",
                    help="engine service: on a watchdog eviction, drain, "
                         "snapshot and warm-restart with --model-shards "
                         "halved, floor 1 (requires --snapshot-dir)")
    ap.add_argument("--watchdog-threshold", type=float, default=None,
                    help="engine service: straggler threshold (x EWMA)")
    ap.add_argument("--watchdog-evict-after", type=int, default=None,
                    help="engine service: consecutive breaches before "
                         "eviction")
    ap.add_argument("--watchdog-warmup", type=int, default=None,
                    help="engine service: EWMA warmup batches")
    ap.add_argument("--inject-straggler-ms", type=float, default=0.0,
                    help="chaos: sleep this long before each launch after "
                         "--inject-straggler-after launches (first engine "
                         "generation only; drives --elastic)")
    ap.add_argument("--inject-straggler-after", type=int, default=0,
                    help="chaos: launches served cleanly before the "
                         "injected straggling starts")
    ap.add_argument("--verify", action="store_true",
                    help="engine service: ABFT integrity gate -- every "
                         "deliverable batch passes its op's check before "
                         "any client sees a result; detected corruption "
                         "triggers bounded re-execution, then a "
                         "circuit-breaker re-bind with the PIM backend "
                         "quarantined")
    ap.add_argument("--inject-faults", type=float, default=0.0,
                    metavar="RATE",
                    help="chaos: per-gate transient bit-flip rate of a "
                         "seeded fault model behind each engine bucket; "
                         "delivered rows are corrupted deterministically "
                         "per (seed, array, execution) (requires --verify)")
    ap.add_argument("--inject-fault-seed", type=int, default=0,
                    help="chaos: fault model seed (replays exactly)")
    ap.add_argument("--inject-stuck", type=int, default=0,
                    help="chaos: stuck-at cells per simulated array -- a "
                         "PERMANENT fault, so the bucket's retries fail "
                         "and the circuit breaker must trip (requires "
                         "--verify)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the kernels run; cuda raises when no card "
                         "is present")
    ap.add_argument("--arch", default="qwen3-1.7b",
                    help="lm service: architecture (configs/registry.py)")
    ap.add_argument("--smoke", action="store_true",
                    help="lm service: the arch's reduced config")
    ap.add_argument("--layers", type=int, default=None,
                    help="lm service: serve only the first N layers (a cut "
                         "of depth, printed as such)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    return ap


def main(argv=None) -> dict:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.elastic and not args.snapshot_dir:
        ap.error("--elastic requires --snapshot-dir (the eviction path "
                 "is snapshot -> resize -> restore)")
    if (args.inject_faults or args.inject_stuck) and not args.verify:
        ap.error("--inject-faults/--inject-stuck without --verify would "
                 "deliver corrupted results: chaos injection requires "
                 "the ABFT gate")
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
