"""The port's device mesh, logical-axis sharding and the shard-map helper
(port of ``repro.dist.sharding``).

The reference runs its multi-device tiers single-controller: one process
calls ``shard_map`` over a jax mesh. The port does the same with a mesh of
its own, held by one process:

  * a :class:`Mesh` is axis names, their sizes and one ``torch.device`` a
    shard. Shards go round-robin over the cards ``torch.cuda.device_count``
    reports, or all onto the CPU, or all onto the ``meta`` device (the
    dry-run's: shapes, no values) where the caller asks for it, so on a
    host with one card every shard lives on ``cuda:0``;
  * a sharded value is the list of its blocks, in shard order, each on its
    shard's device. ``shard_map`` splits a global tensor's last axis into
    those blocks, calls a per-shard body with the lists and the shards'
    axis indices, and joins the result on the caller's device. The body is
    plain code over the lists: the mesh runs no threads, so a failing shard
    raises at once and nothing waits on a rendezvous;
  * collectives (``dist/collectives.py``) move blocks between list entries:
    a peer copy across cards, a copy in device memory on one card.

The logical->mesh rules table (``register_rule``, ``axis_rules``,
``reset_rules``), ``sanitize_spec`` and ``logical_to_spec`` are the
reference's, unchanged, over the port's own :class:`PartitionSpec`.
``constrain`` validates its arguments and, outside a mesh, returns the
tensor unchanged as the reference's does; inside a mesh it checks that the
tensor lies on one of the mesh's devices. ``device_put`` places a tensor
on a mesh by spec (the blocks of a :class:`NamedSharding`), as
``ft/checkpoint.restore(..., shardings=)`` does for each restored leaf;
``shard_tree`` and ``join_tree`` cut a named-leaf dict into one dict of
blocks a shard by specs and join it again (``models/convert.py``'s
``shard_params`` / ``gather_params``); ``axis_groups`` gives the shards
that differ only in some axes (a collective's groups).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Callable, Sequence

import torch

#: Default logical->mesh rules. ``batch`` spans the pure-data axes (FSDP and
#: the paper-§6 batch-over-arrays dimension both extend over (pod, data));
#: ``sp`` (sequence parallel) reuses the tensor axis, as do experts/vocab.
_DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "data": ("data",),
    "pod": ("pod",),
    "model": ("model",),
    "sp": ("model",),
    "expert": ("model",),
    "vocab": ("model",),
}


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (not sharded), a mesh axis
    name, or a tuple of them (sharded over their product)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names, their sizes, and one device a shard, in row-major order
    over the axes (the last axis varies fastest)."""
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} axis sizes")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if any(s < 1 for s in self.axis_sizes):
            raise ValueError(f"axis sizes must be >= 1: {self.axis_sizes}")
        if len(self.devices) != math.prod(self.axis_sizes):
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{math.prod(self.axis_sizes)} shards")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    def holds(self, device: torch.device) -> bool:
        """Whether ``device`` is one of the mesh's devices."""
        return any(_same_device(device, d) for d in self.devices)

    def axis_devices(self, axis_name: str) -> tuple[torch.device, ...]:
        """The shards' devices along ``axis_name``, in axis-index order.
        The port's builders shard one axis; every other axis must have
        size 1."""
        if axis_name not in self.shape:
            raise ValueError(f"mesh axes {self.axis_names} have no "
                             f"{axis_name!r}")
        others = {a: s for a, s in self.shape.items()
                  if a != axis_name and s > 1}
        if others:
            raise ValueError(f"the sharded builders split one axis "
                             f"({axis_name!r}); the mesh also has {others}")
        return self.devices

    def describe(self) -> str:
        """The device map: which shards each device holds."""
        held: dict[str, list[int]] = {}
        for i, d in enumerate(self.devices):
            held.setdefault(str(d), []).append(i)
        axes = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        where = "; ".join(f"{d} holds shards {_ranges(ix)}"
                          for d, ix in held.items())
        return (f"mesh ({axes}): {self.size} shard(s) on {len(held)} "
                f"device(s): {where}")


def _ranges(ix: list[int]) -> str:
    if ix == list(range(ix[0], ix[-1] + 1)) and len(ix) > 2:
        return f"{ix[0]}-{ix[-1]}"
    return ", ".join(str(i) for i in ix)


def _same_device(a: torch.device, b: torch.device) -> bool:
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type == "cpu":
        return True
    return (a.index or 0) == (b.index or 0)


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device: str | torch.device | None = None) -> Mesh:
    """A mesh of ``prod(axis_shapes)`` shards: round-robin over the visible
    cards (``device`` None or CUDA), or all on the CPU (``device="cpu"``),
    or all on the ``meta`` device (``device="meta"``: shapes without
    values, the dry-run's). Raises when CUDA is wanted and absent."""
    kind = torch.device("cuda" if device is None else device).type
    n = math.prod(axis_shapes)
    if kind in ("cpu", "meta"):
        devices = (torch.device(kind),) * n
    elif kind == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if cards == 0:
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' for a mesh on the CPU")
        devices = tuple(torch.device("cuda", i % cards) for i in range(n))
    else:
        raise ValueError(f"device {device}: a mesh runs on cuda, cpu or "
                         f"meta")
    return Mesh(tuple(axis_names), tuple(int(s) for s in axis_shapes),
                devices)


class _State(threading.local):
    def __init__(self):
        self.mesh_stack: list[Mesh] = []
        self.rules: dict[str, tuple[str, ...]] = dict(_DEFAULT_RULES)


_STATE = _State()


# ---------------------------------------------------------------------------
# Rules table
# ---------------------------------------------------------------------------

def register_rule(logical: str, *mesh_axes: str) -> None:
    """Add or override one logical->mesh rule (process-wide for this thread).

    ``register_rule("expert", "data", "model")`` shards the expert dimension
    over both axes; ``register_rule("sp")`` makes "sp" a no-op.
    """
    if not isinstance(logical, str) or not logical:
        raise ValueError(f"logical axis must be a non-empty str: {logical!r}")
    for a in mesh_axes:
        if not isinstance(a, str):
            raise ValueError(f"mesh axes must be strs: {mesh_axes!r}")
    _STATE.rules[logical] = tuple(mesh_axes)


def current_rules() -> dict[str, tuple[str, ...]]:
    """Snapshot of the active logical->mesh rules table."""
    return dict(_STATE.rules)


@contextlib.contextmanager
def axis_rules(rules: dict[str, tuple[str, ...]], *, extend: bool = True):
    """Temporarily override the rules table (extend=False replaces it)."""
    saved = _STATE.rules
    merged = {**saved, **rules} if extend else dict(rules)
    _STATE.rules = {k: tuple(v) for k, v in merged.items()}
    try:
        yield current_rules()
    finally:
        _STATE.rules = saved


def reset_rules() -> None:
    """Restore the built-in default rules table."""
    _STATE.rules = dict(_DEFAULT_RULES)


# ---------------------------------------------------------------------------
# Ambient mesh
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` the ambient mesh ``constrain`` resolves against."""
    _STATE.mesh_stack.append(mesh)
    try:
        yield mesh
    finally:
        _STATE.mesh_stack.pop()


def current_mesh() -> Mesh | None:
    """The ambient mesh of ``use_mesh``, or None."""
    return _STATE.mesh_stack[-1] if _STATE.mesh_stack else None


# ---------------------------------------------------------------------------
# Spec construction
# ---------------------------------------------------------------------------

def sanitize_spec(spec: P, shape: tuple, mesh) -> P:
    """Drop mesh axes that don't exist in ``mesh`` or don't divide the dim.

    For tuple entries the longest dividing prefix of present axes is kept,
    so ``("pod", "data")`` degrades gracefully on a single-pod mesh.
    ``mesh`` needs only a ``shape`` mapping of axis name to size.
    """
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept: list[str] = []
        prod = 1
        for a in axes:
            if a not in mesh.shape:
                continue
            if dim % (prod * mesh.shape[a]) == 0:
                kept.append(a)
                prod *= mesh.shape[a]
            else:
                break
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    return P(*out)


def _validate(logical_axes: tuple, rules: dict) -> None:
    for a in logical_axes:
        if a is None:
            continue
        if not isinstance(a, str):
            raise ValueError(
                f"logical axis must be a str or None, got {a!r}")
        if a not in rules:
            raise ValueError(
                f"unknown logical axis {a!r}; known: {sorted(rules)} "
                f"(register_rule() to add)")


def logical_to_spec(logical_axes: tuple, shape: tuple, mesh) -> P:
    """Resolve logical names through the rules table into a sanitized
    ``PartitionSpec`` for a tensor of ``shape`` on ``mesh``."""
    rules = _STATE.rules
    _validate(tuple(logical_axes), rules)
    if len(logical_axes) != len(shape):
        raise ValueError(
            f"{len(logical_axes)} logical axes for rank-{len(shape)} array")
    raw = []
    for a in logical_axes:
        if a is None:
            raw.append(None)
            continue
        mesh_axes = rules[a]
        if len(mesh_axes) == 0:
            raw.append(None)
        elif len(mesh_axes) == 1:
            raw.append(mesh_axes[0])
        else:
            raw.append(mesh_axes)
    return sanitize_spec(P(*raw), tuple(shape), mesh)


def constrain(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """Check ``x``'s placement by logical axis names, one per dimension.

    ``constrain(x, "batch", None, "model")`` resolves dim 0 through the
    "batch" rule and dim 2 through the "model" rule. A no-op (after
    validation) outside any mesh context, on a 1-device mesh, or where
    every rule resolves to no axis; otherwise ``x`` must lie on one of the
    ambient mesh's devices, the ones ``shard_map`` splits it over. Returns
    ``x`` unchanged.
    """
    _validate(logical_axes, _STATE.rules)
    if len(logical_axes) != x.ndim:
        raise ValueError(
            f"constrain got {len(logical_axes)} logical axes for a rank-"
            f"{x.ndim} array (shape {tuple(x.shape)})")
    mesh = current_mesh()
    if mesh is None or mesh.size == 1:
        return x
    spec = logical_to_spec(logical_axes, tuple(x.shape), mesh)
    if all(e is None for e in spec):
        return x
    if not mesh.holds(x.device):
        raise ValueError(f"constrain: a tensor on {x.device} cannot be "
                         f"sharded by {spec} over {mesh.describe()}")
    return x


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A placement: ``spec`` over ``mesh``."""
    mesh: Mesh
    spec: P


def device_put(x: torch.Tensor, sharding: NamedSharding, *,
               shards: Sequence[int] | None = None) -> list[torch.Tensor]:
    """Place ``x`` on the mesh by spec: one block a shard, in mesh order,
    each on its shard's device. A dimension sharded over axes (a, b) is
    cut into size(a) * size(b) slices, shard (.., i_a, .., i_b, ..) taking
    slice i_a * size(b) + i_b; axes the spec does not name replicate.
    The spec is sanitized against ``x``'s shape first. ``shards``: only
    those shards' blocks, in that order."""
    mesh = sharding.mesh
    spec = sanitize_spec(sharding.spec, tuple(x.shape), mesh)
    blocks = []
    for shard in range(mesh.size) if shards is None else shards:
        device = mesh.devices[shard]
        coord = dict(zip(mesh.axis_names,
                         _unravel(shard, mesh.axis_sizes)))
        block = x
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            parts, index = 1, 0
            for a in axes:
                index = index * mesh.shape[a] + coord[a]
                parts *= mesh.shape[a]
            width = x.shape[dim] // parts
            block = block.narrow(dim, index * width, width)
        blocks.append(block.to(device).contiguous())
    return blocks


def _unravel(i: int, sizes: tuple[int, ...]) -> tuple[int, ...]:
    coord = []
    for s in reversed(sizes):
        coord.append(i % s)
        i //= s
    return tuple(reversed(coord))


def coords(mesh: Mesh, shard: int) -> dict[str, int]:
    """Shard ``shard``'s index on each axis."""
    return dict(zip(mesh.axis_names, _unravel(shard, mesh.axis_sizes)))


def axis_groups(mesh: Mesh, axes: Sequence[str]) -> list[tuple[int, ...]]:
    """The shards in groups that differ only in ``axes`` (the axes the mesh
    lacks are left out): each group ordered by its shards' index over
    ``axes`` in that order (row-major, as ``device_put`` numbers the
    slices of a dimension sharded over several axes), the groups by the
    other axes' indices."""
    axes = [a for a in axes if a in mesh.shape]
    groups: dict[tuple, list[tuple[int, int]]] = {}
    for shard in range(mesh.size):
        c = coords(mesh, shard)
        rest = tuple(c[a] for a in mesh.axis_names if a not in axes)
        index = 0
        for a in axes:
            index = index * mesh.shape[a] + c[a]
        groups.setdefault(rest, []).append((index, shard))
    return [tuple(s for _, s in sorted(v)) for _, v in sorted(groups.items())]


def spec_axes(spec: P) -> list[str]:
    """The mesh axes a (sanitized) spec names, in order."""
    out = []
    for entry in spec:
        if entry is not None:
            out.extend(entry if isinstance(entry, tuple) else (entry,))
    return out


def sanitize_tree(specs: dict, shapes: dict, mesh) -> dict:
    """``sanitize_spec`` leaf by leaf: ``specs`` and ``shapes`` map the same
    names to a spec and to a shape (or a tensor)."""
    return {name: sanitize_spec(spec, tuple(getattr(shapes[name], "shape",
                                                    shapes[name])), mesh)
            for name, spec in specs.items()}


def shard_tree(tree: dict, specs: dict, mesh: Mesh, *,
               shards: Sequence[int] | None = None) -> list[dict]:
    """A named-leaf dict placed on ``mesh`` by spec (``device_put`` leaf by
    leaf): one dict of blocks a shard, in mesh order (or for ``shards``
    only, in that order). The specs are sanitized against the leaves'
    shapes first."""
    n = mesh.size if shards is None else len(shards)
    blocks = [dict() for _ in range(n)]
    for name, x in tree.items():
        for i, block in enumerate(device_put(x, NamedSharding(
                mesh, specs[name]), shards=shards)):
            blocks[i][name] = block
    return blocks


def join_tree(blocks: Sequence[dict], specs: dict, mesh: Mesh, *,
              device=None) -> dict:
    """The inverse of ``shard_tree``: each leaf whole again from its blocks,
    on ``device`` (the first block's by default). ``specs`` are the
    sanitized specs the blocks were cut by (``sanitize_tree``); a block
    replicated over an axis is read from the axis's index 0."""
    out = {}
    for name, first in blocks[0].items():
        spec = tuple(specs[name]) + (None,) * (first.ndim - len(specs[name]))
        shape = list(first.shape)
        for dim, entry in enumerate(spec):
            if entry is not None:
                axes = entry if isinstance(entry, tuple) else (entry,)
                shape[dim] *= math.prod(mesh.shape[a] for a in axes)
        dev = first.device if device is None else device
        full = first.new_empty(shape, device=dev)
        named = set(spec_axes(P(*spec)))
        for shard, block in enumerate(blocks):
            c = coords(mesh, shard)
            if any(c[a] for a in mesh.axis_names if a not in named):
                continue
            view = full
            for dim, entry in enumerate(spec):
                if entry is None:
                    continue
                axes = entry if isinstance(entry, tuple) else (entry,)
                index = 0
                for a in axes:
                    index = index * mesh.shape[a] + c[a]
                width = block[name].shape[dim]
                view = view.narrow(dim, index * width, width)
            view.copy_(block[name])
        out[name] = full
    return out


# ---------------------------------------------------------------------------
# shard_map over one axis
# ---------------------------------------------------------------------------

def shard_map(body: Callable[..., list[torch.Tensor]], mesh: Mesh, *,
              axis_name: str) -> Callable[..., torch.Tensor]:
    """``body(*block_lists, idx=[0 .. D-1])`` over ``mesh``'s ``axis_name``:
    the returned function splits each global (..., n) argument into D
    last-axis blocks on the shards' devices, calls ``body`` with the lists
    and the shards' axis indices, and joins the list it returns (last-axis
    blocks again) on the first argument's device."""
    devices = mesh.axis_devices(axis_name)
    d = len(devices)

    def split(x: torch.Tensor) -> list[torch.Tensor]:
        if x.shape[-1] % d:
            raise ValueError(f"last axis {x.shape[-1]} does not split into "
                             f"{d} shards")
        w = x.shape[-1] // d
        return [x[..., i * w:(i + 1) * w].to(dev).contiguous()
                for i, dev in enumerate(devices)]

    def mapped(*args: torch.Tensor) -> torch.Tensor:
        out = body(*[split(a) for a in args], idx=list(range(d)))
        return torch.cat([b.to(args[0].device) for b in out], dim=-1)
    return mapped
