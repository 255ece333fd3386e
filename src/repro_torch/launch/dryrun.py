"""Multi-pod dry-run: run every (arch x shape) cell's step once on the
production meshes, on the ``meta`` device, and record its per-device
memory, flops and collective bytes (port of ``repro.launch.dryrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k [--multi-pod] [--out artifacts/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Nothing is allocated: parameters, optimizer state, decode state and
inputs are meta tensors, and the step (``models/sharded.py`` in its
``specs`` layout: parameters stored as their sanitized ``param_specs``
blocks, all-gathered over (pod, data) before use, the batch cut over (pod,
data), the model split over ``model``) runs on them. Every shard's work
is alike, so one representative shard runs, its collectives standing in
for the mesh's (``collectives.gather_over``, ``psum_over``, ...: the
shapes and the ledger records the whole mesh's would give). Each layer's
work is the same, so the step runs at ``probe_layers`` k and 2k layers
(k the attention pattern's period, as the reference's cost probe takes
it) and every count is extended affinely to the arch's depth: exact for
costs of the form fixed + per layer x L.

Each cell reports the reference's keys where the port has the number:
  * ``status`` / ``reason``: ``configs/registry.py::cell_supported``;
  * ``argument_bytes_per_device``: the sum over the reference's leaves
    (parameters with block leaves stacked over the layers; the optimizer
    state for train, the decode state for decode; the batch or the decode
    inputs) of the leaf's bytes over the product of the mesh axes in its
    sanitized spec: what XLA's memory analysis reports for the reference
    on a mesh, byte for byte;
  * ``output_bytes_per_device``: the same sum over the step's outputs in
    the port's layout (parameters and state as their specs; logits cut
    over the batch's (pod, data));
  * ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``
    over the representative shard's run. It counts the products (matmuls,
    attention's einsums on the meta device; the FFT and the scans are
    not products), forward and backward, remat's recomputation included;
    XLA's count also holds elementwise work;
  * ``collective_bytes``: the byte ledger of the run (``dist/
    collectives.py``), each collective once, backward included, by the
    reference's five kinds (psum -> all-reduce, ppermute ->
    collective-permute), with ``counts``;
  * ``model_params`` and ``active_params``.
``temp_bytes_per_device``, ``alias_bytes_per_device``,
``peak_bytes_per_device`` and the cost probe come from XLA's compiler,
which the port does not have: they are null, with a ``not_measured``
reason.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.registry import (ASSIGNED, SHAPES, cell_supported,
                                          get_config)
from repro_torch.dist import collectives
from repro_torch.dist.sharding import P
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import convert, lm, sharded
from repro_torch.optim import adamw

#: the ledger's kinds under the reference's names
KINDS = {"psum": "all-reduce", "all-gather": "all-gather",
         "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
         "ppermute": "collective-permute"}
NOT_MEASURED = ("XLA's memory analysis and cost probe come from the "
                "reference's compiler; the port runs no compiler and does "
                "not estimate them")


def _inputs(cfg, shape) -> tuple[dict, dict]:
    """The cell's batch (train, prefill) or decode inputs: (meta tensors,
    specs), Nones dropped."""
    if shape.kind == "decode":
        sds, sp = S.decode_input_specs(cfg, shape)
    else:
        sds, sp = S.batch_specs(cfg, shape,
                                with_labels=shape.kind == "train")
    return ({k: v for k, v in sds.items() if v is not None},
            {k: sp[k] for k, v in sds.items() if v is not None})


def argument_bytes(cfg, shape, mesh) -> int:
    """The reference's argument bytes per device from the sanitized specs
    of its leaves (see the module docstring)."""
    params, pspecs = S.reference_params(cfg)
    leaves, specs = dict(params), dict(pspecs)
    if shape.kind == "train":
        state, ospecs = S.reference_opt_state(cfg)
        leaves.update({f"opt/{k}": v for k, v in state.items()})
        specs.update({f"opt/{k}": ospecs[k] for k in state})
    if shape.kind == "decode":
        state = S.abstract_decode_state(cfg, shape)
        sspecs = lm.decode_state_specs(cfg)
        leaves.update({f"state/{k}": v for k, v in state.items()})
        specs.update({f"state/{k}": sspecs[k] for k in state})
    sds, sp = _inputs(cfg, shape)
    leaves.update({f"in/{k}": v for k, v in sds.items()})
    specs.update({f"in/{k}": sp[k] for k in sds})
    return S.bytes_per_device(leaves, specs, mesh)


def output_bytes(cfg, shape, mesh) -> int:
    """The step's outputs' bytes per device in the port's layout."""
    params, pspecs = S.reference_params(cfg)
    B = shape.global_batch
    if shape.kind == "train":
        state, ospecs = S.reference_opt_state(cfg)
        leaves = {**params, **{f"opt/{k}": v for k, v in state.items()}}
        specs = {**pspecs, **{f"opt/{k}": ospecs[k] for k in state}}
        # loss, grad_norm, lr: fp32 scalars, replicated
        return S.bytes_per_device(leaves, specs, mesh) + 12
    state = S.abstract_decode_state(cfg, shape)
    sspecs = lm.decode_state_specs(cfg)
    dt = torch.float32 if shape.kind == "decode" else \
        lm.dtype_of(cfg.dtype)
    leaves = {**state, "logits": torch.empty((B, cfg.vocab_padded),
                                             dtype=dt, device="meta")}
    specs = {**sspecs, "logits": P(S.DP, None)}
    return S.bytes_per_device(leaves, specs, mesh)


def probe_layers(cfg) -> int:
    """The layer unit k of the probe: the attention pattern's period
    (gemma3's 5:1 local:global layout needs whole periods), else 2."""
    if cfg.attention == "local_global":
        return cfg.local_global_ratio + 1
    return 2


def _run_step(cfg, shape, mesh) -> tuple[float, collectives.Ledger]:
    """The cell's step once on the representative shard: (its flops, the
    ledger)."""
    params = S.abstract_params(cfg)
    blocks = convert.shard_params(cfg, params, mesh, shards=[0])
    sh = sharded.Shards(cfg, mesh, blocks, layout="specs",
                        representative=True)
    sds, _ = _inputs(cfg, shape)
    with collectives.ledger() as led, \
            FlopCounterMode(display=False) as flops:
        if shape.kind == "train":
            _, grads = sharded.value_and_grad(sh, sds)
            opt_cfg = S.opt_config_for(cfg)
            norms = sh.psum([adamw.global_norm(g) for g in grads])
            for g, n, p in zip(grads, norms, blocks):
                factor = torch.clamp(opt_cfg.grad_clip
                                     / torch.clamp(n, min=1e-9), max=1.0)
                adamw.apply(p, {k: x * factor for k, x in g.items()},
                            adamw.init_state(p, opt_cfg), opt_cfg)
        elif shape.kind == "prefill":
            sharded.prefill(sh, sds.get("tokens"),
                            positions=sds.get("positions"),
                            embeds=sds.get("embeds"))
        else:
            rows = shape.global_batch // sh.batch_parts(shape.global_batch)
            states = sharded.init_decode_state(sh, rows, shape.seq_len)
            sharded.decode_step(sh, states, sds.get("token"),
                                shape.seq_len - 1,
                                positions=sds.get("positions"),
                                embed=sds.get("embed"))
    return flops.get_total_flops(), led


def _probe(cfg, shape, mesh) -> tuple[float, dict, dict]:
    """(flops, bytes by kind, counts by kind) of the step at the arch's
    depth, from runs at k and 2k layers extended affinely (exactly where
    the depth is below 2k: one run at the depth)."""
    k = probe_layers(cfg)
    L = cfg.num_layers
    if L <= 2 * k:
        flops, led = _run_step(cfg, shape, mesh)
        return flops, dict(led.bytes_by_kind), dict(led.counts)
    runs = [_run_step(dataclasses.replace(cfg, num_layers=n), shape, mesh)
            for n in (k, 2 * k)]

    def extend(a, b):
        return a + (b - a) // k * (L - k)

    (f1, l1), (f2, l2) = runs
    kinds = set(l1.counts) | set(l2.counts)
    return (extend(int(f1), int(f2)),
            {q: extend(l1.bytes_by_kind.get(q, 0), l2.bytes_by_kind.get(q, 0))
             for q in kinds},
            {q: extend(l1.counts.get(q, 0), l2.counts.get(q, 0))
             for q in kinds})


def run_cell(arch: str, shape_name: str, mesh, *, verbose: bool = True,
             overrides: dict | None = None) -> dict:
    """One cell on ``mesh`` (a meta mesh: ``make_production_mesh`` or
    ``dist.sharding.make_mesh(..., device="meta")``); see the module
    docstring for the keys."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": reason}
    t0 = time.time()
    flops, nbytes, counts = _probe(cfg, shape, mesh)
    run_s = time.time() - t0
    coll = {name: nbytes.get(kind, 0) for kind, name in KINDS.items()}
    coll["counts"] = {name: counts.get(kind, 0)
                      for kind, name in KINDS.items()}
    result = {
        "arch": arch, "shape": shape_name, "status": "ok",
        "mesh": dict(mesh.shape), "run_s": round(run_s, 2),
        "probe_layers": [probe_layers(cfg), 2 * probe_layers(cfg)],
        "flops_per_device": flops,
        "argument_bytes_per_device": argument_bytes(cfg, shape, mesh),
        "output_bytes_per_device": output_bytes(cfg, shape, mesh),
        "temp_bytes_per_device": None, "alias_bytes_per_device": None,
        "peak_bytes_per_device": None, "probe": None,
        "not_measured": {k: NOT_MEASURED for k in (
            "temp_bytes_per_device", "alias_bytes_per_device",
            "peak_bytes_per_device", "probe")},
        "collective_bytes": coll,
        "model_params": get_config(arch).param_count(),
        "active_params": get_config(arch).active_param_count(),
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} mesh="
              f"{tuple(mesh.shape.values())} run={run_s:.1f}s "
              f"flops/dev={flops:.3e} argument_bytes/dev="
              f"{result['argument_bytes_per_device']:.3e}", flush=True)
        print(f"  collectives: "
              f"{ {k: v for k, v in coll.items() if k != 'counts'} }",
              flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    mesh = make_production_mesh(multi_pod=args.multi_pod)
    tag = "multipod" if args.multi_pod else "singlepod"
    outdir = os.path.join(args.out, tag)
    os.makedirs(outdir, exist_ok=True)
    if args.all:
        cells = [(arch, s) for arch in ASSIGNED for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    failures = []
    t0 = time.time()
    for arch, shape_name in cells:
        path = os.path.join(outdir, f"{arch}__{shape_name}.json")
        try:
            res = run_cell(arch, shape_name, mesh)
        except Exception as e:  # a failure here is a bug in the sharding
            traceback.print_exc()
            res = {"arch": arch, "shape": shape_name, "status": "error",
                   "error": f"{type(e).__name__}: {e}"}
            failures.append((arch, shape_name))
        with open(path, "w") as f:
            json.dump(res, f, indent=2)
    if failures:
        raise SystemExit(f"FAILED cells: {failures}")
    print(f"dry-run complete: {len(cells)} cells -> {outdir} in "
          f"{time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
