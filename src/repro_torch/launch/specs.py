"""Meta-tensor stand-ins and partition specs for every (arch x shape) cell
(port of ``repro.launch.specs``).

The reference's ``ShapeDtypeStruct``s are tensors on the ``meta`` device
here: shapes and types, nothing allocated. ``sanitize_spec`` (re-exported
from ``dist/sharding.py``) drops the mesh axes that do not divide a
dimension (batch 1 at long_500k, 25 heads on a 16-way model axis), so
every cell has a layout on both production meshes.

The trees are the port's flat ``{name: tensor}`` dicts. ``reference_params``
stacks the block leaves over a leading layer axis, as the reference's
pytree holds them, for the dry-run's argument bytes: the int8 optimizer
state has one ``orig_last`` scalar a stacked leaf there.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.configs.registry import ShapeSpec
from repro_torch.dist.sharding import (NamedSharding, P,  # noqa: F401
                                       sanitize_spec, sanitize_tree)
from repro_torch.models import convert, lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw

DP = ("pod", "data")
META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def shardings_for(specs: dict, shapes: dict, mesh) -> dict:
    """The sanitized specs as placements on ``mesh``."""
    return {k: NamedSharding(mesh, sp)
            for k, sp in sanitize_tree(specs, shapes, mesh).items()}


# ---------------------------------------------------------------------------
# Per-cell inputs
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, shape: ShapeSpec, *,
                with_labels: bool) -> tuple[dict, dict]:
    """(meta tensors, specs) for a train or prefill batch; ``tokens`` is
    None for the archs that take embeddings, as in the reference."""
    B, S = shape.global_batch, shape.seq_len
    sds: dict = {}
    sp: dict = {}
    if cfg.frontend == "embeddings":
        sds["embeds"] = _sds((B, S, cfg.d_model), torch.bfloat16)
        sp["embeds"] = P(DP, None, None)
        sds["tokens"] = None
        sp["tokens"] = None
    else:
        sds["tokens"] = _sds((B, S), torch.int32)
        sp["tokens"] = P(DP, None)
    if cfg.mrope_sections is not None:
        sds["positions"] = _sds((B, S, 3), torch.int32)
        sp["positions"] = P(DP, None, None)
    if with_labels:
        sds["labels"] = _sds((B, S), torch.int32)
        sp["labels"] = P(DP, None)
    return sds, sp


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec
                       ) -> tuple[dict, dict]:
    """(meta tensors, specs) for a decode step's (token, pos[, positions,
    embed])."""
    B = shape.global_batch
    sds: dict = {"pos": _sds((), torch.int32)}
    sp: dict = {"pos": P()}
    if cfg.frontend == "embeddings":
        sds["embed"] = _sds((B, 1, cfg.d_model), torch.bfloat16)
        sp["embed"] = P(DP, None, None)
        sds["token"] = None
        sp["token"] = None
    else:
        sds["token"] = _sds((B,), torch.int32)
        sp["token"] = P(DP)
    if cfg.mrope_sections is not None:
        sds["positions"] = _sds((B, 1, 3), torch.int32)
        sp["positions"] = P(DP, None, None)
    return sds, sp


def abstract_params(cfg: ModelConfig) -> dict:
    """The master parameters on the meta device, each in the type
    ``convert.init_params`` creates it in: one layer's drawn on the meta
    device, the others' made alike."""
    first = convert.init_params(dataclasses.replace(cfg, num_layers=1),
                                torch.Generator().manual_seed(0),
                                device=META)
    out = {}
    for name in convert.expected_shapes(cfg):
        head, _, rest = name.partition(".")
        key = f"blocks.0.{rest.partition('.')[2]}" if head == "blocks" \
            else name
        out[name] = torch.empty_like(first[key])
    return out


def abstract_opt_state(cfg: ModelConfig, opt_cfg: adamw.OptConfig,
                       params: Optional[dict] = None) -> dict:
    return adamw.init_state(abstract_params(cfg) if params is None
                            else params, opt_cfg)


def abstract_decode_state(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The decode state, stacked over the layers as the reference's."""
    model = lm.DecoderLM(cfg, device=META)
    return model.init_decode_state(shape.global_batch, shape.seq_len)


def opt_config_for(cfg: ModelConfig) -> adamw.OptConfig:
    """8-bit moments for the >=70B archs so the optimizer state fits."""
    big = cfg.param_count() > 7e10
    return adamw.OptConfig(state_dtype="int8" if big else "float32")


# ---------------------------------------------------------------------------
# The reference's tree: block leaves stacked over the layers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def reference_params(cfg: ModelConfig) -> tuple[dict, dict]:
    """(meta leaves, specs) of the parameters as the reference's pytree
    holds them: ``blocks.<rest>`` (L, ...) with a leading ``None`` spec.
    Cached by config: callers copy the dicts before adding to them."""
    params = abstract_params(cfg)
    specs = lm.param_specs(cfg)
    leaves, out_specs = {}, {}
    for name, x in params.items():
        head, _, rest = name.partition(".")
        if head != "blocks":
            leaves[name], out_specs[name] = x, specs[name]
            continue
        layer, _, rest = rest.partition(".")
        if layer != "0":
            continue
        key = f"blocks.{rest}"
        leaves[key] = x.new_empty((cfg.num_layers, *x.shape))
        out_specs[key] = P(None, *specs[name])
    return leaves, out_specs


@functools.lru_cache(maxsize=16)
def reference_opt_state(cfg: ModelConfig) -> tuple[dict, dict]:
    """(flat meta leaves, flat specs) of the optimizer state over
    ``reference_params``, in ``opt_config_for``'s moments."""
    params, pspecs = reference_params(cfg)
    opt_cfg = opt_config_for(cfg)
    return (flatten(adamw.init_state(params, opt_cfg)),
            flatten(adamw.state_specs(pspecs, opt_cfg)))


def flatten(tree, prefix: str = "") -> dict:
    """A nested dict of tensors (and Nones) as ``{path: tensor}``."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "/"))
        elif v is not None:
            out[name] = v
    return out


def bytes_per_device(leaves: dict, specs: dict, mesh) -> int:
    """Sum over leaves of its bytes over the product of the mesh axes its
    sanitized spec names (the reference's per-device argument bytes)."""
    total = 0
    for name, x in leaves.items():
        spec = sanitize_spec(specs[name], tuple(x.shape), mesh)
        parts = 1
        for entry in spec:
            if entry is not None:
                for a in entry if isinstance(entry, tuple) else (entry,):
                    parts *= mesh.shape[a]
        total += x.numel() * x.element_size() // parts
    return total
