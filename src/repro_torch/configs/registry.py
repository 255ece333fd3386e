"""Architecture registry (--arch <id>) and the assigned input-shape grid.

A copy of ``repro.configs.registry``, pinned to it entry by entry by
``tests/test_torch_models.py``.

40 dry-run cells = 10 architectures x 4 shapes. ``cell_supported`` encodes
the long_500k sub-quadratic rule: run for SSM/hybrid/linear-attn and
sliding-window archs, skip (with a reason) for pure full-attention archs —
see DESIGN.md §5.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

from repro_torch.models.config import ModelConfig

ARCH_MODULES = {
    "llama3-405b": "llama3_405b",
    "qwen3-1.7b": "qwen3_1p7b",
    "starcoder2-15b": "starcoder2_15b",
    "gemma3-4b": "gemma3_4b",
    "hymba-1.5b": "hymba_1p5b",
    "musicgen-medium": "musicgen_medium",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "mixtral-8x22b": "mixtral_8x22b",
    "rwkv6-7b": "rwkv6_7b",
    # paper-native extra (not part of the 40-cell grid)
    "fourierpim-lm": "fourierpim_lm",
}

ASSIGNED = [k for k in ARCH_MODULES if k != "fourierpim-lm"]


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{ARCH_MODULES[arch]}")
    return mod.CONFIG


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(supported, reason-if-not). The only skips are long_500k on pure
    full-attention archs (O(S) KV with dense global attention at 500K has no
    sub-quadratic path; DESIGN.md §5)."""
    if shape.name == "long_500k":
        subquadratic = (cfg.mixer in ("rwkv6", "hymba", "fourier")
                        or cfg.attention in ("swa", "local_global"))
        if not subquadratic:
            return False, ("pure full-attention arch: long_500k needs "
                           "sub-quadratic attention (skip per DESIGN.md §5)")
    return True, ""
