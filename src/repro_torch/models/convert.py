"""Weights for ``DecoderLM``: carried over from the reference's parameter
tree, or drawn at random with the reference's distributions.

Both return a state dict for ``DecoderLM.load_state_dict``, which casts each
tensor to its parameter's type (the matrices to the activation type). The
reference's tree stacks every block leaf on a leading layer axis
(``blocks/attn/wq`` is (L, d, H hd)); the port's names are
``blocks.<i>.attn.wq``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.attention import init_attention_params
from repro_torch.models.lm import DecoderLM, check_supported, dtype_of


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, f"{name}."))
        else:
            out[name] = np.asarray(value)
    return out


def expected_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Name -> shape of every parameter of ``DecoderLM(cfg)``."""
    model = DecoderLM(cfg, device="meta")
    return {name: tuple(p.shape) for name, p in model.state_dict().items()}


def params_from_jax(cfg: ModelConfig,
                    tree: Mapping) -> dict[str, torch.Tensor]:
    """The reference's ``init_params`` tree, its leaves as numpy arrays, as a
    state dict: each ``blocks`` leaf is cut along its leading layer axis
    into the blocks. Raises if a leaf is left unused, a parameter is
    missing, or a shape differs."""
    check_supported(cfg)
    want = expected_shapes(cfg)
    sd: dict[str, torch.Tensor] = {}
    unused = []
    for name, arr in _flatten(tree).items():
        if name.startswith("blocks."):
            rest = name[len("blocks."):]
            if arr.shape[0] != cfg.num_layers:
                raise ValueError(f"{name}: leading axis {arr.shape[0]}, "
                                 f"expected {cfg.num_layers} layers")
            names = [f"blocks.{i}.{rest}" for i in range(cfg.num_layers)]
            values = list(arr)
        else:
            names, values = [name], [arr]
        for n, val in zip(names, values):
            if n not in want:
                unused.append(n)
                continue
            if tuple(val.shape) != want[n]:
                raise ValueError(f"{n}: shape {tuple(val.shape)}, expected "
                                 f"{want[n]}")
            sd[n] = torch.from_numpy(np.array(val, dtype=np.float32))
    missing = sorted(set(want) - set(sd))
    if unused or missing:
        raise ValueError(f"{cfg.name}: reference leaves unused {unused}, "
                         f"parameters missing {missing}")
    return sd


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict[str, torch.Tensor]:
    """Random weights of the reference's distributions (``init_params`` and
    ``init_block_params``, lm.py), in ``cfg.param_dtype``, drawn from
    ``generator`` on ``device`` (the generator's device by default)."""
    check_supported(cfg)
    device = generator.device if device is None else device
    pdt = dtype_of(cfg.param_dtype)
    d, f = cfg.d_model, cfg.d_ff

    def normal(shape, std):
        return torch.randn(shape, generator=generator, dtype=pdt,
                           device=device) * std

    def zeros(shape):
        return torch.zeros(shape, dtype=pdt, device=device)

    sd = {"embed": normal((cfg.vocab_padded, d), 0.02),
          "lm_head": normal((d, cfg.vocab_padded), d ** -0.5),
          "final_norm": zeros((d,))}
    for i in range(cfg.num_layers):
        block = {"ln1": zeros((d,)), "ln2": zeros((d,)),
                 "mlp.w_gate": normal((d, f), d ** -0.5),
                 "mlp.w_up": normal((d, f), d ** -0.5),
                 "mlp.w_down": normal((f, d), f ** -0.5)}
        block.update({f"attn.{k}": v for k, v in init_attention_params(
            cfg, generator, pdt, device).items()})
        sd.update({f"blocks.{i}.{k}": v for k, v in block.items()})
    return sd


def build(cfg: ModelConfig, state_dict: Mapping[str, torch.Tensor],
          device) -> DecoderLM:
    """A ``DecoderLM`` on ``device`` holding ``state_dict``'s weights."""
    model = DecoderLM(cfg, device=device)
    model.load_state_dict(state_dict)
    return model
