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

``psum``, ``all_gather`` and the new ``reduce_scatter``, ``pbroadcast``
(a replicated value entering per-shard work) and ``split`` (each shard's
chunk of a replicated value) are autograd functions over groups of shards
(the model axis of ``models/sharded.py``): each backward runs its
transpose and records it in the same ledger, so a training step's ledger
holds both directions. ``psum`` of partial sums passes its gradient
through; ``pbroadcast`` psums it; ``all_gather`` reduce-scatters it (with
``invariant``, a result every shard uses whole, each shard takes its own
piece); ``reduce_scatter`` and ``split`` all-gather it. A reduce-scatter
records the bytes of one result chunk (XLA's unit). ``replaying()``: the
recomputation of a checkpointed forward records nothing. The ``*_over``
functions stand in, on the meta device, for the shards a dry-run does
not run: shapes and records only.

``compressed_psum_leaf`` is the cross-pod gradient reduction: each shard
adds its carried residual to the leaf, quantizes to int8 with one f32
scale a leaf, the int8 payloads and scales are gathered (4x fewer wire
bytes than an f32 all-reduce), dequantized and averaged, and each shard
keeps what quantization dropped as its new residual (error feedback).
"""
from __future__ import annotations

import contextlib
import dataclasses
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
        # "reduce-scatter" (the transpose of the model axis's all-gather)
        # appears once one is recorded: the reference's ledger has no such
        # kind, and the dist tier's tests compare the two ledgers whole
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + int(
            nbytes)
        self.counts[kind] = self.counts.get(kind, 0) + 1

    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def as_dict(self) -> dict:
        return {"bytes": dict(self.bytes_by_kind),
                "counts": dict(self.counts),
                "total_bytes": self.total_bytes()}


class _State:
    """The open ledgers and the replay depth. Process-wide, not one a
    thread: autograd runs a CUDA graph's backward, and the recomputation
    of a checkpointed forward, on its own worker thread, whose collectives
    must reach the ledger the step opened."""

    def __init__(self):
        self.stack: list[Ledger] = []
        self.replaying = 0


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


@contextlib.contextmanager
def replaying():
    """Collectives called inside record nothing: the recomputation of a
    checkpointed forward (``torch.utils.checkpoint``) replays collectives
    the ledger already holds."""
    _STATE.replaying += 1
    try:
        yield
    finally:
        _STATE.replaying -= 1


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _record(kind: str, nbytes: int) -> None:
    if _STATE.stack and not _STATE.replaying:
        _STATE.stack[-1].record(kind, nbytes)


# ---------------------------------------------------------------------------
# Collectives over the list of blocks (byte-accounted)
# ---------------------------------------------------------------------------

Groups = Sequence[Sequence[int]]


def _groups(n: int, groups: Groups | None) -> list[tuple[int, ...]]:
    """The shards' index groups a collective runs over: each group on its
    own, every shard in one group (``groups=None``: the whole list)."""
    out = [tuple(range(n))] if groups is None else \
        [tuple(g) for g in groups]
    if sorted(i for g in out for i in g) != list(range(n)):
        raise ValueError(f"groups {out} do not cover {n} blocks once each")
    if len({len(g) for g in out}) != 1:
        raise ValueError(f"groups of unequal sizes: {out}")
    return out


def _moves(groups: list[tuple[int, ...]]) -> bool:
    """Whether a collective over ``groups`` moves anything: a group of one
    shard is no collective, and records nothing."""
    return len(groups[0]) > 1


class _Psum(torch.autograd.Function):
    """Partial sums in, their sum out on every shard of the group. The
    backward hands each partial its shard's gradient of the sum: a
    replicated value has the same gradient on every shard, the loss's
    (the gradient passed through; nothing moves)."""

    @staticmethod
    def forward(ctx, groups, *xs):
        if _moves(groups):
            _record("psum", _nbytes(xs[0]))
        out = list(xs)
        for g in groups:
            for i in g:
                out[i] = _sum_on([xs[j] for j in g], xs[i].device) \
                    if len(g) > 1 else xs[i].clone()
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)


def psum(xs: Blocks, *, groups: Groups | None = None) -> list[torch.Tensor]:
    """Every shard gets the sum of its group's blocks (one group of all
    blocks by default). Differentiable: each block's gradient is its
    shard's gradient of the sum (the partial sums' transpose, nothing
    moves)."""
    return list(_Psum.apply(_groups(len(xs), groups), *xs))


class _Pbroadcast(torch.autograd.Function):
    """A replicated value entering per-shard work: the same values out;
    the backward sums the shards' gradients over the group (a psum)."""

    @staticmethod
    def forward(ctx, groups, *xs):
        ctx.groups = groups
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        if _moves(ctx.groups):
            _record("psum", _nbytes(grads[0]))
        out = list(grads)
        for g in ctx.groups:
            for i in g:
                out[i] = _sum_on([grads[j] for j in g], grads[i].device)
        return (None, *out)


def pbroadcast(xs: Blocks, *, groups: Groups | None = None
               ) -> list[torch.Tensor]:
    """A value replicated over each group, handed to work that each shard
    does on its part (a column block of a weight, its heads): the values
    as they are; the backward psums the shards' partial gradients (the
    transpose of a psum of a replicated value)."""
    return list(_Pbroadcast.apply(_groups(len(xs), groups), *xs))


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


def _piece(x: torch.Tensor, axis: int, k: int, width: int,
           tiled: bool) -> torch.Tensor:
    """Piece k of a joined block: its slice along ``axis`` (tiled) or its
    index on the stacked axis."""
    return x.narrow(axis, k * width, width) if tiled else x.select(axis, k)


class _AllGather(torch.autograd.Function):
    """Every shard gets its group's blocks joined. The backward is the
    transpose: each block's gradient is the sum over the group of its
    piece of each shard's gradient (a reduce-scatter), or, for a result
    every shard uses whole in the same way (``invariant``), the shard's
    own piece (nothing moves)."""

    @staticmethod
    def forward(ctx, groups, axis, tiled, invariant, *xs):
        ctx.groups, ctx.axis, ctx.tiled = groups, axis, tiled
        ctx.invariant = invariant
        ctx.width = xs[0].shape[axis] if tiled else 1
        if _moves(groups):
            _record("all-gather", _nbytes(xs[0]) * len(groups[0]))
        join = torch.cat if tiled else torch.stack
        out = list(xs)
        for g in groups:
            for i in g:
                out[i] = join([xs[j].to(xs[i].device) for j in g], dim=axis)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        out = list(grads)
        moved = False
        for g in ctx.groups:
            for k, i in enumerate(g):
                def part(j):
                    return _piece(grads[j], ctx.axis, k, ctx.width,
                                  ctx.tiled).to(grads[i].device)
                if ctx.invariant:
                    out[i] = part(i).contiguous()
                else:
                    out[i] = _sum_on([part(j) for j in g], grads[i].device)
                    moved = moved or len(g) > 1
        if moved:
            _record("reduce-scatter", _nbytes(out[0]))
        return (None, None, None, None, *out)


def all_gather(xs: Blocks, *, axis: int = 0, tiled: bool = False,
               groups: Groups | None = None,
               invariant: bool = False) -> list[torch.Tensor]:
    """Every shard gets its group's blocks (all blocks by default), stacked
    on a new ``axis`` (or joined along it with ``tiled=True``).
    Differentiable: the backward is a reduce-scatter of the gradients (the
    blocks of a parameter gathered for shards that each work on their own
    data), or with ``invariant=True`` each shard's own piece of its
    gradient (a result every shard uses whole, as a replicated
    activation)."""
    return list(_AllGather.apply(_groups(len(xs), groups), axis, tiled,
                                 invariant, *xs))


class _ReduceScatter(torch.autograd.Function):
    """Shard k of each group gets the sum over the group of the k-th
    chunk along ``axis`` of every block; the backward all-gathers the
    chunks' gradients."""

    @staticmethod
    def forward(ctx, groups, axis, *xs):
        ctx.groups, ctx.axis = groups, axis
        size = len(groups[0])
        if xs[0].shape[axis] % size:
            raise ValueError(f"reduce_scatter: axis {axis} of size "
                             f"{xs[0].shape[axis]} does not split into "
                             f"{size} chunks")
        width = xs[0].shape[axis] // size
        out = list(xs)
        for g in groups:
            for k, i in enumerate(g):
                out[i] = _sum_on([xs[j].narrow(axis, k * width, width)
                                  for j in g], xs[i].device).contiguous()
        if _moves(groups):
            _record("reduce-scatter", _nbytes(out[0]))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        if _moves(ctx.groups):
            _record("all-gather", _nbytes(grads[0]) * len(ctx.groups[0]))
        out = list(grads)
        for g in ctx.groups:
            for i in g:
                out[i] = torch.cat([grads[j].to(grads[i].device) for j in g],
                                   dim=ctx.axis)
        return (None, None, *out)


def reduce_scatter(xs: Blocks, *, axis: int = 0,
                   groups: Groups | None = None) -> list[torch.Tensor]:
    """Shard k of each group (all blocks by default) gets the sum over the
    group of chunk k of every block along ``axis``. Records the bytes of
    one result chunk, the unit XLA's collective count reads; the backward
    is an all-gather."""
    return list(_ReduceScatter.apply(_groups(len(xs), groups), axis, *xs))


class _Split(torch.autograd.Function):
    """Each shard of a group takes its chunk of a value replicated over the
    group; the backward all-gathers the chunks' gradients, so every shard
    holds the whole gradient of the replicated value."""

    @staticmethod
    def forward(ctx, groups, axis, *xs):
        ctx.groups, ctx.axis = groups, axis
        size = len(groups[0])
        if xs[0].shape[axis] % size:
            raise ValueError(f"split: axis {axis} of size "
                             f"{xs[0].shape[axis]} does not split into "
                             f"{size} chunks")
        width = xs[0].shape[axis] // size
        out = list(xs)
        for g in groups:
            for k, i in enumerate(g):
                out[i] = xs[i].narrow(axis, k * width, width).contiguous()
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        if _moves(ctx.groups):
            _record("all-gather", _nbytes(grads[0]) * len(ctx.groups[0]))
        out = list(grads)
        for g in ctx.groups:
            for i in g:
                out[i] = torch.cat([grads[j].to(grads[i].device) for j in g],
                                   dim=ctx.axis)
        return (None, None, *out)


def split(xs: Blocks, *, axis: int, groups: Groups | None = None
          ) -> list[torch.Tensor]:
    """Shard k of each group takes chunk k along ``axis`` of its copy of a
    value replicated over the group: nothing moves. The backward
    all-gathers the chunks' gradients (recorded), so each shard holds the
    replicated value's whole gradient."""
    return list(_Split.apply(_groups(len(xs), groups), axis, *xs))


class _GatherOver(torch.autograd.Function):
    """The all-gather of a block with ``factor - 1`` blocks of shards that
    are not run, on the ``meta`` device: the joined shape (or the blocks
    stacked on a new leading axis), no values."""

    @staticmethod
    def forward(ctx, axis, factor, invariant, stacked, x):
        _meta_only(x, "gather_over")
        ctx.shape, ctx.invariant = x.shape, invariant
        _record("all-gather", _nbytes(x) * factor)
        if stacked:
            return x.new_empty((factor, *x.shape))
        shape = list(x.shape)
        shape[axis] *= factor
        return x.new_empty(shape)

    @staticmethod
    def backward(ctx, grad):
        out = grad.new_empty(ctx.shape)
        if not ctx.invariant:
            _record("reduce-scatter", _nbytes(out))
        return None, None, None, None, out


def _meta_only(x: torch.Tensor, name: str) -> None:
    if x.device.type != "meta":
        raise ValueError(f"{name} stands in for shards that are not run: "
                         f"it makes shapes without values, on the meta "
                         f"device only")


def gather_over(xs: Blocks, *, axis: int, factor: int,
                invariant: bool = False, stacked: bool = False
                ) -> list[torch.Tensor]:
    """``all_gather(tiled=True)`` (``stacked``: on a new leading axis) of
    each block with ``factor - 1`` blocks of shards that are not run, on
    the meta device (shapes only): records one all-gather of ``factor``
    blocks, and its backward one reduce-scatter (none if ``invariant``),
    whatever the number of blocks given."""
    if factor == 1:
        return [x[None] for x in xs] if stacked else list(xs)
    return [_GatherOver.apply(axis, factor, invariant, stacked, x)
            for x in xs]


class _PsumOver(torch.autograd.Function):
    """``psum`` over ``factor`` shards of which one is run, on the meta
    device: the block's shape, and the record of the psum."""

    @staticmethod
    def forward(ctx, factor, x):
        _meta_only(x, "psum_over")
        _record("psum", _nbytes(x))
        return x.new_empty(x.shape)

    @staticmethod
    def backward(ctx, grad):
        return None, grad


def psum_over(xs: Blocks, *, factor: int) -> list[torch.Tensor]:
    """``psum`` over groups of ``factor`` shards of which one is run, on the
    meta device: records one psum; the backward passes through."""
    if factor == 1:
        return list(xs)
    return [_PsumOver.apply(factor, x) for x in xs]


class _SplitOver(torch.autograd.Function):
    """``split`` for the first of ``factor`` shards, on the meta device: its
    chunk's shape; the backward records the all-gather of the chunks'
    gradients."""

    @staticmethod
    def forward(ctx, axis, factor, x):
        _meta_only(x, "split_over")
        if x.shape[axis] % factor:
            raise ValueError(f"split: axis {axis} of size {x.shape[axis]} "
                             f"does not split into {factor} chunks")
        ctx.shape = x.shape
        return x.narrow(axis, 0, x.shape[axis] // factor).contiguous()

    @staticmethod
    def backward(ctx, grad):
        out = grad.new_empty(ctx.shape)
        _record("all-gather", _nbytes(out))
        return None, None, out


def split_over(xs: Blocks, *, axis: int, factor: int) -> list[torch.Tensor]:
    """``split`` for the first shard of groups of ``factor``, on the meta
    device: its chunk; the backward records one all-gather."""
    if factor == 1:
        return list(xs)
    return [_SplitOver.apply(axis, factor, x) for x in xs]


class _PbroadcastOver(torch.autograd.Function):
    """``pbroadcast`` over shards that are not run, on the ``meta`` device:
    the values as they are, and in the backward the record of the psum of
    the gradients over the group."""

    @staticmethod
    def forward(ctx, factor, x):
        _meta_only(x, "pbroadcast_over")
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        _record("psum", _nbytes(grad))
        return None, grad


def pbroadcast_over(xs: Blocks, *, factor: int) -> list[torch.Tensor]:
    """``pbroadcast`` over groups of ``factor`` shards of which one is run,
    on the meta device: its backward records one psum."""
    if factor == 1:
        return list(xs)
    return [_PbroadcastOver.apply(factor, x) for x in xs]


class _Replicate(torch.autograd.Function):
    """One tensor handed to ``len(devices)`` shards that each use it
    alike: a copy on each shard's device (the tensor itself on its own
    device). The shards' gradients are the same, so the backward takes
    the first shard's."""

    @staticmethod
    def forward(ctx, devices, x):
        ctx.device = x.device
        return tuple(x.view_as(x) if torch.device(d) == x.device
                     else x.to(d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        return None, grads[0].to(ctx.device)


def replicate(x: torch.Tensor, devices: Sequence) -> list[torch.Tensor]:
    """``x`` on each of ``devices``, one a shard, for work every shard does
    alike on the whole of it (a parameter replicated over the mesh):
    nothing is recorded; the gradient is the first shard's, which equals
    every shard's."""
    return list(_Replicate.apply(tuple(devices), x))


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
