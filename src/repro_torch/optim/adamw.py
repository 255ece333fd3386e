"""AdamW with optional 8-bit (block-quantized) moments (port of
``repro.optim.adamw``).

A parameter tree here is a flat ``{name: tensor}`` dict (the port's
parameter names, ``models/convert.py``); the optimizer state mirrors it:
``{"m": {name: moment}, "v": {name: moment}, "step": int32 scalar}``. With
``state_dtype="int8"`` each moment is ``{"q": int8 (..., blocks, 128),
"scale": fp32 (..., blocks, 1), "orig_last": int32 scalar}``: symmetric
int8 with one fp32 scale per block of 128 along the last axis, dequantized
on use and requantized after the update. The arithmetic is the
reference's, op for op, in fp32; ``torch.round`` rounds half to even, as
``jnp.round`` does. Leaves of fewer than 2 dims (norm scales, biases) get
no weight decay.

``state_specs`` gives the state's partition specs from the parameters'
(``models/lm.py::param_specs``), as the reference's does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"     # float32 | int8
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


BLOCK = 128
STATE_DTYPES = ("float32", "int8")


def _quantize(x: torch.Tensor) -> dict:
    """Blockwise symmetric int8 quantization along the last axis."""
    if x.ndim == 0:
        x = x.reshape(1)
    last = x.shape[-1]
    pad = (-last) % BLOCK
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    xb = x.reshape(*x.shape[:-1], x.shape[-1] // BLOCK, BLOCK)
    scale = torch.amax(torch.abs(xb), dim=-1, keepdim=True) / 127.0
    q = torch.round(xb / torch.clamp(scale, min=1e-20)).to(torch.int8)
    return {"q": q, "scale": scale.to(torch.float32),
            "orig_last": torch.tensor(last, dtype=torch.int32)}


def _quantized_meta(p: torch.Tensor) -> dict:
    """``_quantize``'s layout for a moment of ``p`` on the meta device,
    without running it (the dry-run's abstract state)."""
    shape = tuple(p.shape) or (1,)
    blocks = -(-shape[-1] // BLOCK)
    lead = shape[:-1]
    return {"q": torch.empty((*lead, blocks, BLOCK), dtype=torch.int8,
                             device=p.device),
            "scale": torch.empty((*lead, blocks, 1), dtype=torch.float32,
                                 device=p.device),
            "orig_last": torch.tensor(shape[-1], dtype=torch.int32)}


def _dequantize(d: dict, last: int, scalar: bool = False) -> torch.Tensor:
    x = d["q"].to(torch.float32) * d["scale"]
    x = x.reshape(*x.shape[:-2], -1)[..., :last]
    return x.reshape(()) if scalar else x


def _check(cfg: OptConfig) -> None:
    if cfg.state_dtype not in STATE_DTYPES:
        raise ValueError(f"state_dtype={cfg.state_dtype!r}: one of "
                         f"{STATE_DTYPES}")


def init_state(params: Mapping[str, torch.Tensor], cfg: OptConfig) -> dict:
    """Zero moments beside each parameter (on its device), step 0."""
    _check(cfg)

    def zero_like(p):
        if cfg.state_dtype == "int8" and p.device.type == "meta":
            return _quantized_meta(p)
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _quantize(z) if cfg.state_dtype == "int8" else z

    device = next(iter(params.values())).device
    return {"m": {k: zero_like(p) for k, p in params.items()},
            "v": {k: zero_like(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def lr_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac (fp32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in fp32."""
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """Scale every leaf by min(1, max_norm / global norm); returns (the
    scaled leaves, the norm before scaling)."""
    g = global_norm(grads)
    factor = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    return {k: (x.to(torch.float32) * factor).to(x.dtype)
            for k, x in grads.items()}, g


def apply(params: Mapping[str, torch.Tensor],
          grads: Mapping[str, torch.Tensor], state: dict, cfg: OptConfig
          ) -> tuple[dict[str, torch.Tensor], dict]:
    """One AdamW update: (new parameters, new state). Nothing is updated in
    place."""
    _check(cfg)
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=stepf.device), stepf)
    int8 = cfg.state_dtype == "int8"
    new_p, new_m, new_v = {}, {}, {}
    for name, p in params.items():
        last = p.shape[-1] if p.ndim else 1
        scalar = p.ndim == 0
        gf = grads[name].to(torch.float32)
        m, v = state["m"][name], state["v"][name]
        mf = _dequantize(m, last, scalar) if int8 else m
        vf = _dequantize(v, last, scalar) if int8 else v
        mf = cfg.b1 * mf + (1 - cfg.b1) * gf
        vf = cfg.b2 * vf + (1 - cfg.b2) * gf * gf
        mhat = mf / b1c
        vhat = vf / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.ndim >= 2:  # no decay on norms/scalars
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p[name] = (p.to(torch.float32) - lr * delta).to(p.dtype)
        new_m[name] = _quantize(mf) if int8 else mf
        new_v[name] = _quantize(vf) if int8 else vf
    return new_p, {"m": new_m, "v": new_v, "step": step}


def state_specs(param_specs: Mapping, cfg: OptConfig) -> dict:
    """Partition specs for the optimizer state mirroring the parameters'
    (the reference's ``state_specs``): the moments take their parameter's
    spec; int8 moments put the last axis's sharding on the BLOCK axis of
    ``q`` (the block count often does not divide a 32-way FSDP axis) and
    none on ``scale``; ``orig_last`` and ``step`` are replicated."""
    from repro_torch.dist.sharding import PartitionSpec as P
    if cfg.state_dtype == "int8":
        def qspec(ps):
            parts = list(ps) if ps else []
            last = parts[-1] if parts else None
            lead = parts[:-1] if parts else []
            return {"q": P(*lead, None, last), "scale": P(*lead, None, None),
                    "orig_last": P()}
        m = {name: qspec(ps) for name, ps in param_specs.items()}
        return {"m": m, "v": m, "step": P()}
    return {"m": dict(param_specs), "v": dict(param_specs), "step": P()}

