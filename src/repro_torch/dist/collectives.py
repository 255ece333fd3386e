"""Collectives over a mesh's blocks, with byte accounting, and the
error-feedback compressed psum (port of ``repro.dist.collectives``).

A sharded value is the list of its blocks, one a shard, each on its
shard's device (``dist/sharding.py``). Each collective here takes such a
list and returns the list every shard holds afterwards: across cards the
blocks move by peer copies, on one card by copies in device memory.

The byte ledger is the reference's, in the reference's unit: each call
records ONCE (not once a shard) the bytes of one shard's input block;
``all_gather`` and the compressed psum record that times D. So a call of a
``make_sharded_*`` builder records what one trace of the reference's
records, and ``four_step_collective_stats`` is its closed form.

``compressed_psum_leaf`` is the cross-pod gradient reduction: each shard
adds its carried residual to the leaf, quantizes to int8 with one f32
scale a leaf, the int8 payloads and scales are gathered (4x fewer wire
bytes than an f32 all-reduce), dequantized and averaged, and each shard
keeps what quantization dropped as its new residual (error feedback).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Sequence

import torch

from repro_torch.ft.checkpoint import _flatten_with_paths, _unflatten

KINDS = ("psum", "all-gather", "all-to-all", "ppermute", "compressed-psum")

Blocks = Sequence[torch.Tensor]


# ---------------------------------------------------------------------------
# Byte ledger
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Ledger:
    """Accumulated collective traffic, by kind, in bytes of one shard's
    block a call (the reference's unit)."""
    bytes_by_kind: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))
    counts: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))

    def record(self, kind: str, nbytes: int) -> None:
        self.bytes_by_kind[kind] += int(nbytes)
        self.counts[kind] += 1

    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def as_dict(self) -> dict:
        return {"bytes": dict(self.bytes_by_kind),
                "counts": dict(self.counts),
                "total_bytes": self.total_bytes()}


class _State(threading.local):
    def __init__(self):
        self.stack: list[Ledger] = []


_STATE = _State()


@contextlib.contextmanager
def ledger():
    """Collect byte counts from every collective called inside the block."""
    led = Ledger()
    _STATE.stack.append(led)
    try:
        yield led
    finally:
        _STATE.stack.pop()


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _record(kind: str, nbytes: int) -> None:
    if _STATE.stack:
        _STATE.stack[-1].record(kind, nbytes)


# ---------------------------------------------------------------------------
# Collectives over the list of blocks (byte-accounted)
# ---------------------------------------------------------------------------

def psum(xs: Blocks) -> list[torch.Tensor]:
    """Every shard gets the sum of all blocks."""
    _record("psum", _nbytes(xs[0]))
    return [_sum_on(xs, x.device) for x in xs]


def pmean(xs: Blocks, *, group: int | None = None) -> list[torch.Tensor]:
    """Every shard gets the mean of all blocks, or with ``group``, of the
    blocks of its run of ``group`` consecutive shards (a mean over a
    mesh's last batch axis, the reference's ``pmean`` over that axis:
    recorded once, as one call)."""
    _record("psum", _nbytes(xs[0]))
    g = len(xs) if group is None else group
    if len(xs) % g:
        raise ValueError(f"pmean: {len(xs)} blocks do not form runs of "
                         f"{g}")
    return [_sum_on(xs[i - i % g:i - i % g + g], x.device) / g
            for i, x in enumerate(xs)]


def _sum_on(xs: Blocks, device: torch.device) -> torch.Tensor:
    total = xs[0].to(device)
    for x in xs[1:]:
        total = total + x.to(device)
    return total


def all_to_all(xs: Blocks, split_axis: int, concat_axis: int, *,
               tiled: bool = True) -> list[torch.Tensor]:
    """Shard j's block is cut into D chunks along ``split_axis``; shard i
    gets chunk i of every shard's block, joined in shard order along
    ``concat_axis`` (``tiled=True``) or stacked on a new axis there."""
    _record("all-to-all", _nbytes(xs[0]))
    d = len(xs)
    if xs[0].shape[split_axis] % d:
        raise ValueError(f"all_to_all: axis {split_axis} of size "
                         f"{xs[0].shape[split_axis]} does not split into "
                         f"{d} chunks")
    chunks = [torch.chunk(x, d, dim=split_axis) for x in xs]
    join = torch.cat if tiled else torch.stack
    return [join([chunks[j][i].to(x.device) for j in range(d)],
                 dim=concat_axis) for i, x in enumerate(xs)]


def all_gather(xs: Blocks, *, axis: int = 0,
               tiled: bool = False) -> list[torch.Tensor]:
    """Every shard gets all blocks, stacked on a new ``axis`` (or joined
    along it with ``tiled=True``)."""
    _record("all-gather", _nbytes(xs[0]) * len(xs))
    join = torch.cat if tiled else torch.stack
    return [join([y.to(x.device) for y in xs], dim=axis) for x in xs]


def ppermute(xs: Blocks, perm) -> list[torch.Tensor]:
    """Shard ``dst`` gets shard ``src``'s block for each (src, dst) pair of
    ``perm``; a shard no pair names gets zeros. A block that stays on its
    device is handed over, not copied."""
    _record("ppermute", _nbytes(xs[0]))
    out = [torch.zeros_like(x) for x in xs]
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device)
    return out


# ---------------------------------------------------------------------------
# Error-feedback compressed psum
# ---------------------------------------------------------------------------

def _quantize_leaf(c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, f32 scale) with one scale per leaf."""
    tiny = torch.finfo(torch.float32).tiny
    scale = torch.clamp(torch.max(torch.abs(c)), min=tiny)
    q = torch.clamp(torch.round(c / scale * 127.0), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * (scale / 127.0)


def compressed_psum_leaf(grads: Blocks, errs: Blocks
                         ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Mean-reduce one gradient leaf across the shards in int8.

    ``grads`` and ``errs`` hold one block a shard. Returns
    ``(means, new_residuals)``, one a shard: the mean is the same on every
    shard, the residual is the shard's own, carried into the next call's
    ``errs``."""
    comp = [g.to(torch.float32) + e.to(torch.float32)
            for g, e in zip(grads, errs)]
    qs = [_quantize_leaf(c) for c in comp]
    new_err = [(c - _dequantize_leaf(q, s)).to(g.dtype)
               for c, (q, s), g in zip(comp, qs, grads)]
    d = len(grads)
    # Wire format: int8 payload + one f32 scale per shard.
    _record("compressed-psum", (_nbytes(qs[0][0]) + 4) * d)
    red = []
    for g in grads:
        q_all = torch.stack([q.to(g.device) for q, _ in qs])
        s_all = torch.stack([s.to(g.device) for _, s in qs])
        bshape = (d,) + (1,) * g.ndim
        deq = q_all.to(torch.float32) * (s_all.reshape(bshape) / 127.0)
        red.append(torch.mean(deq, dim=0).to(g.dtype))
    return red, new_err


def compressed_psum(grads: Sequence, errs: Sequence
                    ) -> tuple[list, list]:
    """``compressed_psum_leaf`` over every leaf of a gradient tree: ``grads``
    and ``errs`` hold one tree a shard (dicts, lists and tuples of
    tensors, the same structure on every shard)."""
    flat_g = [dict(_flatten_with_paths(t)) for t in grads]
    flat_e = [dict(_flatten_with_paths(t)) for t in errs]
    red = [dict() for _ in grads]
    new = [dict() for _ in grads]
    for key in flat_g[0]:
        r, e = compressed_psum_leaf([f[key] for f in flat_g],
                                    [f[key] for f in flat_e])
        for i in range(len(grads)):
            red[i][key], new[i][key] = r[i], e[i]
    return ([_unflatten(t, r) for t, r in zip(grads, red)],
            [_unflatten(t, e) for t, e in zip(grads, new)])


def zeros_like_errs(grads: Sequence) -> list:
    """Initial (all-zero) error-feedback residual trees for ``grads``."""
    return [_unflatten(t, {k: torch.zeros_like(v)
                           for k, v in _flatten_with_paths(t)})
            for t in grads]
