"""End-to-end training CLI (port of ``repro.launch.train``).

Trains an arch of the registry on the synthetic token stream
(``data/pipeline.py``) from seeded random weights: fp32 master parameters
(``models/convert.py::init_params``), cast to the activation type at each
step, AdamW (``optim/adamw.py``) through ``train/step.py``. Features, as
in the reference: checkpoint and auto-resume (atomic; the manifest
``extra`` carries the watchdog state and the data cursor, and a resume
that would switch the stream is refused), the straggler watchdog, the
prefetched synthetic data, and the optional cross-pod gradient
compression.

Runs on the card unless ``--device cpu`` is given; without a card it
raises rather than fall back to the CPU. ``--smoke`` takes the reduced
config. On the card fourierpim-lm's token mixing runs the FFT kernel
(``fft_planes``) three times a layer in the forward, three more in its
backward, and three again where ``remat`` recomputes the forward; the
attention archs run the flash kernel's forward and differentiate its
plain version.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen3-1.7b --smoke --steps 40 --batch 8 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --arch fourierpim-lm \\
      --batch 8 --seq 2048 --steps 20

With ``--mesh DxM`` the run enters a mesh context of the port's one
process (``dist/sharding.py``); the step is the same function. With
``--mesh PxDxM --compress-grads`` the step becomes the pod-mesh variant
(``train.step.make_train_step(pod_axis="pod")``): each (pod, data)
shard's gradients on its slice of the batch, the data shards' mean, and
the pods' mean through the int8 error-feedback compressed psum, with the
quantization residual ``grad_err`` carried step to step (a leading pod
axis on every leaf) and saved in the checkpoint. A model axis M > 1
(``--mesh 1x2``, ``2x4``) splits the LM over M shards of the process
(``models/sharded.py``): each shard's heads, hidden columns, channels and
vocabulary block, its own kernel launches on them, and the collectives
between them in the byte ledger; the parameters, the optimizer state and
the checkpoints stay whole. ``--compress-grads`` with a model axis is
refused, as the reference's CLI refuses it.

``--loss-log`` appends one ``step <float.hex>`` line a step, flushed, so
a SIGKILLed run resumed from its last checkpoint can be compared bit for
bit with an uninterrupted one.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.dist import batching, collectives, sharding
from repro_torch.ft import checkpoint as ckpt_lib
from repro_torch.ft.watchdog import StepWatchdog
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.launch.ops import resolve_device
from repro_torch.models import convert
from repro_torch.optim import adamw
from repro_torch.train import step as step_lib

#: the seed of the frontend stub's pseudo-embeddings, with the step
EMBED_SEED = 7


@dataclasses.dataclass
class TrainRun:
    """What a run did: the losses of its steps, each step's host time
    (ending in the loss's copy to the host, which waits for the card),
    tokens a step, and the card's peak memory (None on the CPU)."""
    losses: list
    step_ms: list
    start_step: int
    tokens_per_step: int
    peak_bytes: Optional[int]


def _check_resume_stream(extra: dict, args, start_step: int) -> None:
    """Refuse a resume that would silently switch the data stream: the
    synthetic pipeline is deterministic per (seed, step, batch, seq), so a
    changed knob means the resumed trajectory is not a continuation."""
    cursor = extra.get("data")
    if not cursor:
        return
    want = {"seed": args.seed, "global_batch": args.batch, "seq": args.seq}
    got = {k: cursor.get(k) for k in want}
    if got != want:
        raise RuntimeError(
            f"checkpoint data cursor {got} does not match the resume flags "
            f"{want}; resuming would replay a DIFFERENT stream — restart "
            f"with matching --seed/--batch/--seq or a fresh --ckpt-dir")
    if cursor.get("next_step") is not None \
            and int(cursor["next_step"]) != start_step:
        raise RuntimeError(
            f"checkpoint step {start_step} disagrees with its own data "
            f"cursor {cursor['next_step']} — corrupt manifest")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--loss-log", default=None, metavar="PATH",
                    help="append one 'step <float.hex>' line per step "
                         "(flushed per step — survives SIGKILL)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None, metavar="DxM|PxDxM",
                    help="enter a (data, model) mesh of this process, e.g. "
                         "2x1; a model axis M > 1 splits the LM over M "
                         "shards (e.g. 1x2); a three-part PxDxM spec adds "
                         "a leading pod axis (e.g. 2x1x1) for "
                         "--compress-grads")
    ap.add_argument("--compress-grads", action="store_true",
                    help="reduce gradients across the pod axis through the "
                         "int8 error-feedback compressed psum "
                         "(dist.collectives). Requires a pod axis: "
                         "--mesh PxDxM")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; without a card the "
                         "run raises rather than move to the CPU")
    return ap


def _mesh(ap, args, device: torch.device) -> Optional[sharding.Mesh]:
    if not args.mesh:
        if args.compress_grads:
            ap.error("--compress-grads needs a pod axis: use --mesh PxDxM "
                     "(e.g. 2x1x1)")
        return None
    try:
        sizes = tuple(int(v) for v in args.mesh.lower().split("x"))
        if len(sizes) not in (2, 3) or min(sizes) < 1:
            raise ValueError
    except ValueError:
        ap.error(f"--mesh wants DxM or PxDxM (e.g. 2x1 or 2x1x1), got "
                 f"{args.mesh!r}")
    if sizes[-1] > 1 and args.compress_grads:
        ap.error(f"--mesh {args.mesh} --compress-grads: the pod-mesh step "
                 f"shards the batch only; use a model axis of 1")
    mesh = make_dev_mesh(*sizes[-2:], device=device,
                         n_pods=sizes[0] if len(sizes) == 3 else None)
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    n_batch = 1
    for a in batch_axes:
        n_batch *= mesh.shape[a]
    if args.batch % n_batch:
        ap.error(f"--batch {args.batch} must divide the batch axes "
                 f"({n_batch})")
    if args.compress_grads and "pod" not in mesh.shape:
        ap.error("--compress-grads needs a pod axis: use --mesh PxDxM "
                 "(e.g. 2x1x1)")
    plan = batching.shard_batch(args.batch, mesh, axes=batch_axes)
    print(f"[train] mesh={mesh.shape} per-device batch={plan.per_device} "
          f"utilization={plan.utilization:.2f}")
    return mesh


def _restore_state(args, params, opt_state, grad_err, watchdog):
    """Resume from the newest checkpoint: parameters, optimizer state and
    (under --compress-grads) the pods' residuals, each leaf back in its
    type on its device; then the watchdog baseline, and the data cursor
    checked against the flags."""
    like = {"params": params, "opt": opt_state}
    if grad_err is not None:
        like["grad_err"] = grad_err
    step0, restored = ckpt_lib.restore_latest(args.ckpt_dir, like)
    if step0 is None:
        return 0, params, opt_state, grad_err
    extra = ckpt_lib.read_extra(args.ckpt_dir, step0)
    _check_resume_stream(extra, args, step0)
    params, opt_state = restored["params"], restored["opt"]
    if grad_err is not None:
        grad_err = restored["grad_err"]
    if extra.get("watchdog"):
        watchdog.load_state_dict(extra["watchdog"])
    print(f"[train] resumed from step {step0}"
          + (" (grad_err restored)" if grad_err is not None else ""))
    return step0, params, opt_state, grad_err


def _device_batch(cfg, raw: dict, step: int, device) -> dict:
    """The step's batch on the device, with the frontend stub's
    pseudo-embeddings (seeded by (EMBED_SEED, step)) in place of tokens
    and M-RoPE positions where the arch takes them, as the reference's
    loop adds them."""
    batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
    B, S = raw["labels"].shape
    if cfg.frontend == "embeddings":
        rng = np.random.default_rng([EMBED_SEED, step])
        embeds = rng.standard_normal((B, S, cfg.d_model), np.float32) * 0.02
        batch["embeds"] = torch.from_numpy(embeds).to(device)
        batch.pop("tokens")
    if cfg.mrope_sections is not None:
        batch["positions"] = torch.arange(
            S, dtype=torch.int32, device=device)[None, :, None].expand(
                B, S, 3)
    return batch


def run(argv=None) -> TrainRun:
    """Parse ``argv`` and train; see the module docstring."""
    ap = parser()
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = _mesh(ap, args, device)
    ctx = sharding.use_mesh(mesh) if mesh is not None and \
        not args.compress_grads else contextlib.nullcontext()
    with ctx:
        return _run(args, mesh, device)


def _run(args, mesh, device) -> TrainRun:
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(cfg.scaled_down(), max_seq_len=args.seq)
    opt_cfg = adamw.OptConfig(lr=args.lr, warmup_steps=20,
                              total_steps=args.steps)
    # drawn on the CPU from the seed, so the card and the CPU start alike
    params = {k: v.to(device) for k, v in convert.init_params(
        cfg, torch.Generator().manual_seed(args.seed)).items()}
    opt_state = adamw.init_state(params, opt_cfg)
    n_params = sum(p.numel() for p in params.values())
    print(f"[train] arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"batch={args.batch} seq={args.seq} device={device}")

    watchdog = StepWatchdog()
    grad_err = None
    if args.compress_grads:
        n_pods = mesh.shape["pod"]
        # the pods' residuals, one per pod on a leading axis
        grad_err = {k: torch.zeros((n_pods, *p.shape), dtype=p.dtype,
                                   device=device)
                    for k, p in params.items()}

    start_step = 0
    if args.ckpt_dir:
        start_step, params, opt_state, grad_err = _restore_state(
            args, params, opt_state, grad_err, watchdog)

    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    prefetch = Prefetcher(data, start_step=start_step)
    if args.compress_grads:
        train_step = step_lib.make_train_step(
            cfg, opt_cfg, pod_axis="pod", mesh=mesh,
            data_axis="data" if "data" in mesh.shape else None)
    else:
        train_step = step_lib.make_train_step(cfg, opt_cfg, mesh=mesh)

    def save_ckpt(at_step: int) -> None:
        tree = {"params": params, "opt": opt_state}
        if grad_err is not None:
            tree["grad_err"] = grad_err
        ckpt_lib.save(args.ckpt_dir, at_step, tree, extra={
            "watchdog": watchdog.state_dict(),
            "data": {"next_step": at_step, "seed": args.seed,
                     "global_batch": args.batch, "seq": args.seq},
            "compress_grads": bool(args.compress_grads),
        })

    losses, step_ms = [], []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    loss_log = open(args.loss_log, "a") if args.loss_log else None
    t_start = time.time()
    try:
        for step in range(start_step, args.steps):
            got_step, raw = prefetch.next()
            if got_step != step:
                raise RuntimeError(f"prefetcher at step {got_step}, the "
                                   f"loop at {step}")
            t0 = time.perf_counter()
            batch = _device_batch(cfg, raw, step, device)
            watchdog.start_step()
            if args.compress_grads:
                errs = [{k: e[i] for k, e in grad_err.items()}
                        for i in range(mesh.shape["pod"])]
                params, opt_state, errs, metrics = train_step(
                    params, opt_state, errs, batch)
                grad_err = {k: torch.stack([e[k] for e in errs])
                            for k in grad_err}
            else:
                params, opt_state, metrics = train_step(params, opt_state,
                                                        batch)
            losses.append(float(metrics["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            flagged = watchdog.end_step(step)
            if loss_log is not None:
                loss_log.write(f"{step} {losses[-1].hex()}\n")
                loss_log.flush()
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step={step} loss={losses[-1]:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"ms={step_ms[-1]:.1f}"
                      + (" STRAGGLER" if flagged else ""), flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                save_ckpt(step + 1)
    finally:
        prefetch.stop()
        if loss_log is not None:
            loss_log.close()

    dt = time.time() - t_start
    steps_done = args.steps - start_step
    span = f"loss {losses[0]:.4f} -> {losses[-1]:.4f}" if losses \
        else "already complete"
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else None
    tokens = args.batch * args.seq
    steady = sorted(step_ms[2:] or step_ms)
    rate = ""
    if steady:
        mid = steady[len(steady) // 2]
        rate = (f"; median step {mid:.1f} ms, {tokens / mid * 1e3:.0f} "
                f"tok/s (steps after the first two)")
    print(f"[train] done: {steps_done} steps in {dt:.1f}s "
          f"({steps_done / max(dt, 1e-9):.2f} steps/s); {span}{rate}"
          + (f"; peak memory {peak / 2**30:.2f} GiB" if peak else ""),
          flush=True)
    if args.ckpt_dir:
        save_ckpt(args.steps)
    return TrainRun(losses=losses, step_ms=step_ms, start_step=start_step,
                    tokens_per_step=tokens, peak_bytes=peak)


def main(argv=None) -> list:
    """The CLI: train, and return the losses of the steps run (the
    reference's return value)."""
    return run(argv).losses


if __name__ == "__main__":
    main()
