"""Train and eval step functions (port of ``repro.train.step``).

``make_train_step`` builds: loss -> grads -> global-norm clip -> (optional
int8 error-feedback cross-pod gradient compression) -> AdamW update. The
returned callable is step(params, opt_state, batch) -> (params, opt_state,
metrics): ``params`` the fp32 master parameters (``{name: tensor}``),
``batch`` a dict of tensors on their device (``tokens`` or ``embeds``,
``labels``, and ``positions`` for M-RoPE archs).

With ``pod_axis`` set, the step is the POD-MESH variant over the port's
one-process mesh (``dist/sharding.py``): the batch is cut into one slice
per (pod, data) shard, each shard's gradients are computed on its slice
with the same parameters, the data-axis shards of a pod are mean-reduced
(``collectives.pmean``), each pod's gradients are clipped by their own
global norm, and the pods' gradients are mean-reduced through
``collectives.compressed_psum`` (int8 wire format, 4x fewer bytes than an
fp32 all-reduce), whose quantization error rides each pod's residual
``grad_err`` into the next step. Both reductions record their bytes in
the collectives' ledger. They go over the reference's leaves: a block
parameter's layers are stacked into one leaf, as the reference's pytree
holds them, so each leaf is quantized with the reference's one scale and
recorded as the reference records it. Its signature is step(params,
opt_state, grad_err, batch) -> (params, opt_state, grad_err, metrics),
``grad_err`` one residual tree per pod in the port's parameter names
(``collectives.zeros_like_errs`` for step 0).
The reduced gradients are the same for every pod, so one update serves
them all; the metrics are the pods' means.

With a ``mesh`` whose ``model`` axis is larger than 1 (and no
``pod_axis``), the loss and gradients come from the LM split over that
axis (``models/sharded.py``, its ``replicated`` layout): the fp32 masters
stay whole, each model shard computes its part, and the collectives'
backward assembles the whole gradients, so the clip and the update are
the unsharded step's. The data axis does not cut the batch, as without a
model axis. The pod-mesh step refuses a model axis, as the reference's CLI
does.

The prefill and decode steps of the reference are the model's own entry
points here (``DecoderLM.prefill``, ``DecoderLM.decode_step``), and
``models/sharded.py``'s on a mesh.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from repro_torch.dist import collectives
from repro_torch.dist.sharding import Mesh
from repro_torch.models import lm, sharded
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw

Params = Mapping[str, torch.Tensor]


def structure(cfg: ModelConfig) -> lm.DecoderLM:
    """The model's structure for the training forward, on the ``meta``
    device: its weights are the master parameters passed to each step."""
    return lm.DecoderLM(cfg, device="meta")


def _split(batch: Mapping[str, torch.Tensor], parts: int) -> list[dict]:
    """The batch cut along its leading axis into ``parts`` equal slices."""
    rows = next(iter(batch.values())).shape[0]
    if rows % parts:
        raise ValueError(f"batch of {rows} rows does not split into "
                         f"{parts} equal parts")
    return [{k: v[i * (rows // parts):(i + 1) * (rows // parts)]
             for k, v in batch.items()} for i in range(parts)]


def _unflat(trees: list[dict], leaves: dict[str, list]) -> list[dict]:
    """One dict a shard from ``leaves``' per-shard lists."""
    return [{k: v[i] for k, v in leaves.items()} for i in range(len(trees))]


def reference_leaves(names) -> dict[str, list[str]]:
    """The port's parameter names grouped into the reference's pytree
    leaves: a block's ``blocks.{i}.rest`` goes, in layer order, under
    ``blocks.rest`` (the reference stacks the blocks over a leading layer
    axis), every other name is a leaf of its own."""
    groups: dict[str, list[tuple[int, str]]] = {}
    for name in names:
        head, _, rest = name.partition(".")
        if head == "blocks":
            layer, _, rest = rest.partition(".")
            groups.setdefault("blocks." + rest, []).append((int(layer), name))
        else:
            groups[name] = [(0, name)]
    return {key: [n for _, n in sorted(v)] for key, v in groups.items()}


def _stack(tree: Params, groups: dict[str, list[str]]) -> dict:
    return {key: torch.stack([tree[n] for n in names])
            for key, names in groups.items()}


def _unstack(tree: Params, groups: dict[str, list[str]]) -> dict:
    return {n: tree[key][i] for key, names in groups.items()
            for i, n in enumerate(names)}


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.OptConfig,
                    grad_transform: Optional[Callable] = None, *,
                    pod_axis: Optional[str] = None,
                    data_axis: Optional[str] = None,
                    mesh: Optional[Mesh] = None) -> Callable:
    """``cfg.grad_accum_steps`` > 1 cuts the batch into that many
    microbatches and averages their losses and fp32 gradients, as the
    reference's scan does. ``pod_axis`` (with ``mesh``, whose ``pod_axis``
    and optional ``data_axis`` shard the batch, every other axis of size
    1) selects the pod-mesh variant; without it, a ``mesh`` with a
    ``model`` axis larger than 1 splits the LM over that axis (see the
    module docstring)."""
    model = structure(cfg)
    accum = max(1, cfg.grad_accum_steps)
    split_model = pod_axis is None and mesh is not None and \
        mesh.shape.get("model", 1) > 1
    run = sharded.Shards(cfg, mesh, None) if split_model else None

    def value_and_grad(params: Params, batch):
        if run is not None:
            return sharded.value_and_grad(run.bound(params), batch)
        return lm.value_and_grad(model, params, batch)

    def compute_grads(params: Params, batch) -> tuple[torch.Tensor, dict]:
        if accum == 1:
            return value_and_grad(params, batch)
        lsum, gsum = None, None
        for mb in _split(batch, accum):
            loss, grads = value_and_grad(params, mb)
            if gsum is None:
                lsum = torch.zeros((), dtype=torch.float32,
                                   device=loss.device)
                gsum = {k: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                        for k, p in params.items()}
            lsum = lsum + loss
            gsum = {k: gsum[k] + grads[k].to(torch.float32) for k in gsum}
        return lsum / accum, {k: g / accum for k, g in gsum.items()}

    def update(params, grads, opt_state, loss, gnorm):
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state = adamw.apply(params, grads, opt_state, opt_cfg)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": adamw.lr_schedule(opt_cfg, opt_state["step"])}
        return params, opt_state, metrics

    def train_step(params: Params, opt_state: dict, batch):
        loss, grads = compute_grads(params, batch)
        grads, gnorm = adamw.clip_by_global_norm(grads, opt_cfg.grad_clip)
        return update(params, grads, opt_state, loss, gnorm)

    if pod_axis is None:
        return train_step
    if mesh is None:
        raise ValueError("the pod-mesh step needs the mesh its pod axis "
                         "names")
    sizes = mesh.shape
    others = {a: s for a, s in sizes.items()
              if a not in (pod_axis, data_axis) and s > 1}
    if others:
        raise ValueError(f"the pod-mesh step shards the batch over "
                         f"{pod_axis!r} and {data_axis!r}; the mesh also "
                         f"has {others}")
    n_pods = sizes[pod_axis]
    n_data = sizes[data_axis] if data_axis is not None else 1

    def train_step_pod(params: Params, opt_state: dict, grad_err: list,
                       batch):
        """Per pod: each data shard's grads on its slice -> the data
        shards' mean -> clip -> the int8 compressed cross-pod mean (error
        feedback in grad_err) -> one replicated update."""
        if len(grad_err) != n_pods:
            raise ValueError(f"{len(grad_err)} residual trees for "
                             f"{n_pods} pods")
        shards = [compute_grads(params, part)
                  for part in _split(batch, n_pods * n_data)]
        # the collectives go over the reference's leaves, so each leaf's
        # quantization scale and the ledger's records are the reference's
        groups = reference_leaves(params)
        losses = [loss for loss, _ in shards]
        grads = [_stack(g, groups) for _, g in shards]
        if data_axis is not None:
            # the data shards' mean within each pod, one call a leaf
            losses = collectives.pmean(losses, group=n_data)
            grads = _unflat(grads, {k: collectives.pmean(
                [g[k] for g in grads], group=n_data) for k in grads[0]})
        losses, grads = losses[::n_data], grads[::n_data]
        clipped = [adamw.clip_by_global_norm(g, opt_cfg.grad_clip)
                   for g in grads]
        pod_grads = [g for g, _ in clipped]
        gnorms = [n for _, n in clipped]
        reduced, errs = collectives.compressed_psum(
            pod_grads, [_stack(e, groups) for e in grad_err])
        params, opt_state, metrics = update(
            params, _unstack(reduced[0], groups), opt_state,
            collectives.pmean(losses)[0], collectives.pmean(gnorms)[0])
        return (params, opt_state, [_unstack(e, groups) for e in errs],
                metrics)

    return train_step_pod


def make_eval_step(cfg: ModelConfig) -> Callable:
    """eval_step(params, batch) -> the loss, without gradients."""
    model = structure(cfg)

    def eval_step(params: Params, batch):
        with torch.no_grad():
            return lm.loss_fn(model, params, batch)
    return eval_step
