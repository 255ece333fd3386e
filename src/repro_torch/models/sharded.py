"""The LM split over a mesh's ``model`` axis (the reference's ``constrain``
calls, run as per-shard work), and in the ``specs`` layout its parameters
over (pod, data) as well.

The mesh is one process's (``dist/sharding.py``): a sharded value is a
list of tensors, one a running shard, each on its shard's device. Every
shard does its own work, as an SPMD program would: what the reference
leaves replicated (the residual stream, the norms, the routing) each shard
computes alike on its copy; what a ``constrain`` puts on ``model`` each
shard computes for its part:

  * attention: q heads by column blocks of ``wq``; k and v for the kv heads
    those read (``wk``, ``wv``'s blocks, or k and v whole and the heads
    taken when the kv heads do not divide); ``wo`` by row blocks and a psum
    (``layers/attention.py::head_plan``; a mixer whose q heads do not
    divide, hymba's 25 at 2 or 4 shards, runs whole on every shard, its
    weights gathered whole);
  * the SwiGLU and the MoE's experts: hidden width by columns, the down
    projection by rows, partial sums in the reduce type and a psum;
  * the Fourier mixer: channels (the convolution's rows) and the gate's
    columns, then an all-gather of the channels;
  * RWKV6: time-mix heads, the decay's low rank; the channel mix's hidden
    width and ``wr``'s columns; hymba's SSM: channels;
  * the embedding and ``lm_head``: vocabulary blocks. The embedding is a
    masked lookup in each shard's rows and a psum; the loss is a
    cross-shard logsumexp (the shards' logsumexps all-gathered, B S fp32
    each) and the label's logit psummed (B S fp32); the served logits are
    the vocabulary blocks all-gathered.

The collectives (``dist/collectives.py``) are autograd functions: a psum of
partial sums passes its gradient through, a replicated value entering
per-shard work (``pbroadcast``) psums its gradient, an all-gather of a
result every shard uses whole hands each shard its piece, ``split`` (each
shard's chunk of a replicated value) all-gathers its gradient, and the
all-gather of parameter blocks over (pod, data) reduce-scatters its
gradient. The objective is the sum of the shards' equal losses, so each
shard seeds its own replica, as each device of an SPMD program does; a
shard's gradient is then the loss's, and a parameter replicated on every
shard takes the first shard's (``collectives.replicate``).

Two parameter layouts:
  * ``replicated`` (the training CLI's, as the reference's CLI replicates
    ``P()``): the fp32 masters whole, cast, handed to every shard, each
    shard cutting its block; their gradients come back whole (the blocks'
    all-gathered). The batch is not cut: each model group runs all of it.
  * ``specs`` (the dry-run's): the masters stored as their sanitized
    ``lm.param_specs`` blocks (``convert.shard_params``), one dict a shard
    of the whole mesh; before use a leaf's blocks are all-gathered over the
    (pod, data) axes its spec names, and the batch is cut over (pod, data).
    With ``representative`` one shard runs, on the ``meta`` device: the
    shards' work is alike, so one shard's numbers are every shard's; its
    collectives stand in for those over the shards that do not run
    (``collectives.gather_over``, ``psum_over``, ``split_over``,
    ``pbroadcast_over``: the shapes, and the records, of the whole
    mesh's).

Collectives replayed by a checkpointed block's recomputation record
nothing (``collectives.replaying``), so the ledger of a step holds each
collective once, forward and backward.

On one card every shard sits on ``cuda:0``: each shard's kernel launches
are 1/M of the work, and the collectives are copies in device memory.
"""
from __future__ import annotations

import functools
import math
import types
from typing import Mapping, Optional, Sequence

import torch

from repro_torch.dist import collectives
from repro_torch.dist.sharding import (Mesh, P, axis_groups, coords,
                                       sanitize_spec, sanitize_tree)
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers import moe as moe_lib
from repro_torch.models.layers import recurrent as rec_lib
from repro_torch.models.layers.common import (fourier_mixing_sharded,
                                              rms_norm, swiglu_mlp_sharded)

LAYOUTS = ("replicated", "specs")
BATCH = ("pod", "data")


def _model_dim(spec: P) -> Optional[int]:
    for dim, entry in enumerate(spec):
        if entry == lm.TP or (isinstance(entry, tuple) and lm.TP in entry):
            return dim
    return None


def _fsdp(spec: P) -> tuple[Optional[int], tuple[str, ...]]:
    """The dimension the spec puts on (pod, data) axes, and those axes."""
    for dim, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept = tuple(a for a in axes if a in BATCH)
        if entry is not None and kept:
            return dim, kept
    return None, ()


class Shards:
    """One run of the sharded LM: ``cfg`` on ``mesh`` (its last axis
    ``model``, or no model axis: one shard), ``params`` in ``layout``.

    ``params``: the replicated layout's ``{name: master}``, or the specs
    layout's list of ``{name: block}`` dicts, one a shard of the mesh (the
    first shard's only with ``representative``). The running shards are
    the first model group (replicated layout), the first shard
    (representative), or all."""

    def __init__(self, cfg: ModelConfig, mesh: Mesh, params, *,
                 layout: str = "replicated", representative: bool = False):
        if layout not in LAYOUTS:
            raise ValueError(f"layout={layout!r}: one of {LAYOUTS}")
        if "model" in mesh.shape and mesh.axis_names[-1] != "model":
            raise ValueError(f"the model axis must be the mesh's last: "
                             f"{mesh.axis_names}")
        lm.check_supported(cfg)
        self.cfg, self.mesh, self.layout = cfg, mesh, layout
        self.params = params
        self.shards = M = mesh.shape.get("model", 1)
        whole = layout == "specs" and not representative
        self.representative = representative
        self.parts = 1
        if representative and layout == "specs" and mesh.devices[0].type \
                != "meta":
            raise ValueError("a representative run makes shapes without "
                             "values: its mesh is on the meta device")
        self.run = [0] if representative else \
            list(range(mesh.size if whole else M))
        if layout == "specs" and len(params) != len(self.run):
            raise ValueError(f"{len(params)} parameter dicts for "
                             f"{len(self.run)} running shards")
        self.devices = [mesh.devices[s] for s in self.run]
        self.model_index = [coords(mesh, s).get("model", 0)
                            for s in self.run]
        m = 1 if representative else M
        self.groups = [tuple(range(i, i + m))
                       for i in range(0, len(self.run), m)]
        # the running data groups' shards of one model index
        self.data_groups = [tuple(range(i, len(self.run), m))
                            for i in range(m)]
        structure = lm.DecoderLM(cfg, device="meta")
        self.dtypes = {n: p.dtype for n, p in structure.named_parameters()}
        shapes = {n: tuple(p.shape) for n, p in structure.named_parameters()}
        self.ndims = {n: len(sh) for n, sh in shapes.items()}
        self.specs = sanitize_tree(lm.param_specs(cfg), shapes, mesh)
        self.model_dims = {n: _model_dim(sp) for n, sp in self.specs.items()}

    def bound(self, params) -> "Shards":
        """The same run over other parameters (of the same layout)."""
        out = Shards.__new__(Shards)
        out.__dict__.update(self.__dict__, params=params)
        return out

    # -- the batch --------------------------------------------------------
    def batch_parts(self, rows: int) -> int:
        """Into how many slices the batch's ``rows`` are cut (the specs
        layout's sanitized ``P((pod, data))``; 1 in the replicated)."""
        if self.layout == "replicated":
            return 1
        spec = sanitize_spec(P(BATCH), (rows,), self.mesh)
        parts = math.prod(self.mesh.shape[a] for a in
                          (spec[0] if isinstance(spec[0], tuple)
                           else (spec[0],) if spec[0] else ()))
        if not self.representative and parts != len(self.groups):
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"the {len(self.groups)} data groups")
        self.parts = parts
        return parts

    def local(self, x: Optional[torch.Tensor]) -> Optional[list]:
        """A batch tensor (its rows first) as each running shard's slice, on
        the shard's device."""
        if x is None:
            return None
        parts = self.batch_parts(x.shape[0])
        rows = x.shape[0] // parts
        return [x[(i // self.shards % parts) * rows:
                  (i // self.shards % parts + 1) * rows].to(d)
                for i, d in enumerate(self.devices)]

    # -- the parameters -----------------------------------------------------
    def _base(self, name: str) -> list:
        """The specs layout: each running shard's block of ``name`` along
        its spec's model dimension (the whole leaf where the spec leaves it
        replicated over ``model``), cast to its parameter's type."""
        dt = self.dtypes[name]
        blocks = [p[name].to(dt) for p in self.params]
        dim, axes = _fsdp(self.specs[name])
        if dim is None:
            # replicated over (pod, data), used by data groups that each
            # run their slice of the batch: the gradients psummed over them
            if self.representative:
                return collectives.pbroadcast_over(blocks,
                                                   factor=self.parts)
            return collectives.pbroadcast(blocks, groups=self.data_groups)
        if self.representative:
            return collectives.gather_over(
                blocks, axis=dim,
                factor=math.prod(self.mesh.shape[a] for a in axes))
        return collectives.all_gather(blocks, axis=dim, tiled=True,
                                      groups=axis_groups(self.mesh, axes))

    def view(self, name: str, dim: Optional[int] = None) -> list:
        """Each running shard's part of parameter ``name``: its block along
        ``dim`` (cut from a leaf the spec leaves whole: ``split``), or with
        ``dim`` None the whole leaf (all-gathered where the spec splits
        it)."""
        if dim is not None and dim < 0:
            dim += self.ndims[name]
        if self.layout == "replicated":
            xs = collectives.replicate(self.params[name].to(self.dtypes[name]),
                                       self.devices)
            return xs if dim is None else self.split(xs, dim)
        xs = self._base(name)
        md = self.model_dims[name]
        if md == dim:
            return xs
        if md is not None:
            xs = self.gather(xs, md)
        return xs if dim is None else self.split(xs, dim)

    def namespaces(self, prefix: str, names: Sequence[str]) -> list:
        """One namespace a running shard holding the whole leaves
        ``prefix + name`` that the model has (for a mixer run whole)."""
        have = [n for n in names if prefix + n in self.dtypes]
        views = {n: self.view(prefix + n) for n in have}
        return [types.SimpleNamespace(**{n: v[i] for n, v in views.items()})
                for i in range(len(self.run))]

    # -- collectives over the model axis, and the data groups ---------------
    def enter(self, xs: list) -> list:
        if self.representative:
            return collectives.pbroadcast_over(xs, factor=self.shards)
        return collectives.pbroadcast(xs, groups=self.groups)

    def psum(self, xs: list) -> list:
        if self.representative:
            return collectives.psum_over(xs, factor=self.shards)
        return collectives.psum(xs, groups=self.groups)

    def split(self, xs: list, dim: int) -> list:
        if self.representative:
            return collectives.split_over(xs, axis=dim, factor=self.shards)
        return collectives.split(xs, axis=dim, groups=self.groups)

    def gather(self, xs: list, dim: int, *, stacked: bool = False) -> list:
        """The all-gather of each shard's block (``stacked``: on a new
        leading axis) for a result every shard uses whole."""
        if self.representative:
            return collectives.gather_over(xs, axis=dim, factor=self.shards,
                                           invariant=True, stacked=stacked)
        return collectives.all_gather(xs, axis=dim, tiled=not stacked,
                                      groups=self.groups, invariant=True)

    def own(self, xs: list, dim: int) -> list:
        """Each shard's block along ``dim`` of a replicated value, outside
        autograd (a decode state's part)."""
        out = []
        for x, m in zip(xs, self.model_index):
            w = x.shape[dim] // self.shards
            out.append(x.narrow(dim, m * w, w))
        return out

    def data_sum(self, xs: list) -> list:
        """The psum over the data groups' slices of the batch (nothing when
        one slice runs)."""
        if self.representative:
            return collectives.psum_over(xs, factor=self.parts)
        return collectives.psum(xs, groups=self.data_groups)

    def data_mean(self, xs: list) -> list:
        n = self.parts
        return xs if n == 1 else [x / n for x in self.data_sum(xs)]


# ---------------------------------------------------------------------------
# The forward, the loss, prefill and decode
# ---------------------------------------------------------------------------

def _embed(sh: Shards, tokens: Optional[list], embeds: Optional[list]
           ) -> list:
    cfg = sh.cfg
    adt = lm.dtype_of(cfg.dtype)
    if cfg.frontend == "embeddings":
        if embeds is None:
            raise ValueError(f"{cfg.name} takes precomputed embeddings, not "
                             f"tokens")
        return [e.to(adt) for e in embeds]
    if sh.devices[0].type == "cuda":
        lm.exact_matmuls()
    scale = torch.tensor(math.sqrt(float(cfg.d_model)),
                         dtype=torch.float32).to(adt)
    if sh.model_dims["embed"] != 0:
        return [t[tok] * scale for t, tok in zip(sh.view("embed"), tokens)]
    rows = []
    for table, tok, m in zip(sh.view("embed", 0), tokens, sh.model_index):
        n = table.shape[0]
        local = tok.long() - m * n
        inside = (local >= 0) & (local < n)
        rows.append(torch.where(inside[..., None],
                                table[local.clamp(0, n - 1)], 0.0))
    return [x * scale for x in sh.psum(rows)]


def _state_shapes(sh: Shards, batch: int, seq_len: int) -> dict:
    """Each shard's decode state entry by entry: (shape, type), stacked
    over the layers. The KV caches hold the kv heads the shard's attention
    reads; the Fourier rings and hymba's SSM state the shard's channels;
    RWKV's state S its heads, its last inputs whole."""
    cfg = sh.cfg
    L, d, M = cfg.num_layers, cfg.d_model, sh.shards
    adt, f32 = lm.dtype_of(cfg.dtype), torch.float32
    out = {}
    if cfg.mixer in ("attn", "hymba"):
        plan, _, kv = attn_lib.head_plan(cfg, M)
        kv = kv if plan == "split" else cfg.num_kv_heads
        C = lm.cache_len(cfg, seq_len)
        out["cache_k"] = out["cache_v"] = ((L, batch, C, kv, cfg.head_dim),
                                           adt)
    if cfg.mixer == "hymba":
        out["ssm_h"] = ((L, batch, d // M, cfg.ssm_state), f32)
    if cfg.mixer == "rwkv6":
        hd = rec_lib.RWKV_HEAD_DIM
        H = d // hd // (M if rec_lib.rwkv_heads_split(cfg, M) else 1)
        out["prev_x"] = out["prev_x_c"] = ((L, batch, d), adt)
        out["S"] = ((L, batch, H, hd, hd), f32)
    if cfg.mixer == "fourier":
        out["ring"] = ((L, batch, cfg.fourier_taps, d // M), adt)
    return out


def init_decode_state(sh: Shards, batch: int, seq_len: int) -> list:
    """The zeroed decode state, one dict a running shard (``batch`` rows
    each: the shard's slice of the batch)."""
    shapes = _state_shapes(sh, batch, seq_len)
    return [{k: torch.zeros(s, dtype=t, device=d)
             for k, (s, t) in shapes.items()} for d in sh.devices]


def _block(sh: Shards, i: int, xs: list, *, positions: list, window: int,
           states: Optional[list] = None) -> tuple[list, list]:
    """Block i over the whole sequence on every shard: (outputs, aux
    losses, zeros without a MoE). ``states``: each shard's layer-i decode
    state to fill (prefill)."""
    cfg = sh.cfg
    p = f"blocks.{i}."
    hs = [rms_norm(x, ln) for x, ln in zip(xs, sh.view(p + "ln1"))]
    if cfg.mixer == "fourier":
        ys = fourier_mixing_sharded(sh, p + "fourier.", hs)
        if states is not None:
            for st, h in zip(states, sh.own(hs, -1)):
                lm._fill_cache((st["ring"],), h)
    elif cfg.mixer == "rwkv6":
        ys, new = rec_lib.rwkv_time_mix_sharded(sh, p + "rwkv_t.", hs, cfg)
        for st, n in zip(states or (), new):
            st["prev_x"].copy_(n["prev_x"])
            st["S"].copy_(n["S"])
    else:
        ys = attn_lib.attention_sharded(sh, p + "attn.", hs, cfg,
                                        positions=positions, window=window,
                                        want_cache=states is not None)
        if states is not None:
            ys, caches = ys
            for st, (k, v) in zip(states, caches):
                lm._fill_cache((st["cache_k"], st["cache_v"]), k, v)
        if cfg.mixer == "hymba":
            y_ssm, fin = rec_lib.ssm_mix_sharded(sh, p + "ssm.", hs)
            for st, h in zip(states or (), fin):
                st["ssm_h"].copy_(h)
            ys = _hymba_out(sh, p, ys, y_ssm)
    xs = [x + y for x, y in zip(xs, ys)]
    h2 = [rms_norm(x, ln) for x, ln in zip(xs, sh.view(p + "ln2"))]
    zero = [torch.zeros((), dtype=torch.float32, device=x.device)
            for x in xs]
    if cfg.mixer == "rwkv6":
        y2, last = rec_lib.rwkv_channel_mix_sharded(
            sh, p + "rwkv_c.", h2, [torch.zeros_like(h[:, 0]) for h in h2])
        for st, x in zip(states or (), last):
            st["prev_x_c"].copy_(x)
        return [x + y for x, y in zip(xs, y2)], zero
    if cfg.is_moe:
        y2, aux = moe_lib.moe_ffn_sharded(sh, p + "moe.", h2, cfg,
                                          lm._reduce_dtype(cfg))
        return [x + y for x, y in zip(xs, y2)], aux
    y2 = swiglu_mlp_sharded(sh, p + "mlp.", h2, lm._reduce_dtype(cfg))
    return [x + y for x, y in zip(xs, y2)], zero


def _hymba_out(sh: Shards, p: str, y_attn: list, y_ssm: list) -> list:
    return [0.5 * (rms_norm(a, la) + rms_norm(s, ls)) for a, s, la, ls in
            zip(y_attn, y_ssm, sh.view(p + "ln_attn_out"),
                sh.view(p + "ln_ssm_out"))]


def _positions(xs: list, positions: Optional[list]) -> list:
    if positions is not None:
        return positions
    return [lm.DecoderLM._positions(x, None) for x in xs]


def _replays_quietly(fn):
    """``fn``, whose second and later calls (a checkpoint's recomputation)
    record no collectives."""
    calls = [0]

    @functools.wraps(fn)
    def run(*args):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*args)
        with collectives.replaying():
            return fn(*args)
    return run


def _run_blocks(sh: Shards, xs: list, positions: list, remat: str
                ) -> tuple[list, list]:
    """The blocks' training forward under ``lm._run_blocks``' remat
    policies, each shard's activations and aux losses handed through the
    checkpoints as tensors."""
    if remat not in lm.REMATS:
        raise ValueError(f"remat={remat!r}: one of {lm.REMATS}")
    n = len(xs)
    windows = lm._layer_windows(sh.cfg)

    def layer(i, *args):
        ys, aux = _block(sh, i, list(args[:n]), positions=positions,
                         window=windows[i])
        return (*ys, *[a + b for a, b in zip(args[n:], aux)])

    calls = [functools.partial(layer, i) for i in range(sh.cfg.num_layers)]
    aux = [torch.zeros((), dtype=torch.float32, device=x.device) for x in xs]
    state = (*xs, *aux)
    if remat == "sqrt":
        Li = len(calls) // lm._best_outer(len(calls))
        inner = [lm._checkpointed(_replays_quietly(fn)) for fn in calls]

        def group(fns, *args):
            for fn in fns:
                args = fn(*args)
            return args

        for g in range(0, len(calls), Li):
            state = lm._checkpointed(_replays_quietly(functools.partial(
                group, inner[g:g + Li])))(*state)
    else:
        if remat != "none":
            calls = [lm._checkpointed(_replays_quietly(fn),
                                      lm._BLOCK_SAVES if remat == "block"
                                      else None) for fn in calls]
        for fn in calls:
            state = fn(*state)
    return list(state[:n]), list(state[n:])


def _head(sh: Shards, xs: list) -> tuple[list, bool]:
    """``lm_head`` on each shard's final activations: its vocabulary block
    (the activations entering per-shard work), or the whole head where the
    spec leaves it whole. Returns (logits, whether they are blocks)."""
    if sh.model_dims["lm_head"] != 1:
        return [x @ w for x, w in zip(xs, sh.view("lm_head"))], False
    return [x @ w for x, w in zip(sh.enter(xs), sh.view("lm_head", 1))], True


def forward_train(sh: Shards, tokens: Optional[torch.Tensor] = None, *,
                  positions: Optional[torch.Tensor] = None,
                  embeds: Optional[torch.Tensor] = None,
                  remat: Optional[str] = None) -> tuple[list, bool, list]:
    """The training forward on every running shard: (logits, one (B, S,
    V/M) vocabulary block a shard in the activation type, or the whole
    (B, S, V) where ``lm_head`` is not split; whether they are blocks; the
    aux losses). The batch is the global one; each shard takes its
    slice."""
    xs = _embed(sh, sh.local(tokens), sh.local(embeds))
    pos = _positions(xs, sh.local(positions))
    xs, aux = _run_blocks(sh, xs, pos,
                          sh.cfg.remat if remat is None else remat)
    xs = [rms_norm(x, n) for x, n in zip(xs, sh.view("final_norm"))]
    return (*_head(sh, xs), aux)


def forward(sh: Shards, tokens: Optional[torch.Tensor] = None, *,
            positions: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``DecoderLM.forward`` sharded: the (B, S, vocab_padded) logits,
    the vocabulary blocks all-gathered, the data slices joined (the first
    model shard's of each data group)."""
    with torch.no_grad():
        logits, split, _ = forward_train(sh, tokens, positions=positions,
                                         embeds=embeds, remat="none")
        if split:
            logits = sh.gather(logits, -1)
    return torch.cat([logits[g[0]].to(logits[0].device)
                      for g in sh.groups])


def loss_fn(sh: Shards, batch: Mapping[str, torch.Tensor], *,
            remat: Optional[str] = None) -> list:
    """``lm.loss_fn`` on every running shard (each shard's replica of the
    loss): the cross entropy over vocabulary-split logits by a cross-shard
    logsumexp, the label's logit psummed; the sums over the batch psummed
    over the data groups."""
    cfg = sh.cfg
    logits, split, aux = forward_train(
        sh, batch.get("tokens"), positions=batch.get("positions"),
        embeds=batch.get("embeds"), remat=remat)
    labels = [lab.long() for lab in sh.local(batch["labels"])]
    nums, dens = [], []
    lses, picks = [], []
    for z, lab, m in zip(logits, labels, sh.model_index):
        z = z.float()
        V = z.shape[-1]
        off = m * V if split else 0
        if cfg.vocab_padded != cfg.vocab_size:
            col = torch.arange(off, off + V, device=z.device)
            z = z + torch.where(col >= cfg.vocab_size, -1e9, 0.0)
        local = lab.clamp(min=0) - off
        inside = (local >= 0) & (local < V)
        picked = z.gather(-1, local.clamp(0, V - 1)[..., None])[..., 0]
        picks.append(torch.where(inside, picked, 0.0))
        lses.append(torch.logsumexp(z, dim=-1))
    if split:
        lses = [torch.logsumexp(a, dim=0)
                for a in sh.gather(lses, 0, stacked=True)]
        picks = sh.psum(picks)
    for lse, pick, lab in zip(lses, picks, labels):
        mask = (lab >= 0).float()
        nums.append(torch.sum((lse - pick) * mask))
        dens.append(mask.sum())
    nums, dens = sh.data_sum(nums), sh.data_sum(dens)
    return [n / torch.clamp(d, min=1.0) + 0.01 * a
            for n, d, a in zip(nums, dens, aux)]


def leaves_of(sh: Shards):
    """The parameters as leaves that require grad, in ``sh.params``'
    structure, and flat."""
    if sh.layout == "replicated":
        tree = {k: p.detach().requires_grad_(True)
                for k, p in sh.params.items()}
        return tree, list(tree.values())
    tree = [{k: p.detach().requires_grad_(True) for k, p in d.items()}
            for d in sh.params]
    return tree, [p for d in tree for p in d.values()]


def value_and_grad(sh: Shards, batch: Mapping[str, torch.Tensor], *,
                   remat: Optional[str] = None):
    """(loss, gradients in ``sh.params``' structure): the loss is the first
    shard's replica; the objective differentiated is the sum of the
    shards' replicas, each shard seeding its own (see the module
    docstring)."""
    tree, flat = leaves_of(sh)
    with torch.enable_grad():
        losses = loss_fn(sh.bound(tree), batch, remat=remat)
        total = losses[0]
        for x in losses[1:]:
            total = total + x.to(total.device)
        grads = torch.autograd.grad(total, flat, allow_unused=True)
    it = iter(grads)

    def take(p):
        g = next(it)
        return torch.zeros_like(p) if g is None else g

    if sh.layout == "replicated":
        out = {k: take(p) for k, p in tree.items()}
    else:
        out = [{k: take(p) for k, p in d.items()} for d in tree]
    return losses[0].detach(), out


@torch.no_grad()
def prefill(sh: Shards, tokens: Optional[torch.Tensor] = None, *,
            positions: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            cache_capacity: Optional[int] = None) -> tuple[torch.Tensor, list]:
    """``DecoderLM.prefill`` sharded: (the last position's (B,
    vocab_padded) logits in the activation type, each running shard's
    decode state)."""
    xs = _embed(sh, sh.local(tokens), sh.local(embeds))
    B, S = xs[0].shape[:2]
    states = init_decode_state(sh, B, cache_capacity or S)
    pos = _positions(xs, sh.local(positions))
    windows = lm._layer_windows(sh.cfg)
    for i in range(sh.cfg.num_layers):
        xs, _ = _block(sh, i, xs, positions=pos, window=windows[i],
                       states=[lm._layer_state(st, i) for st in states])
    xs = [rms_norm(x[:, -1:], n) for x, n in zip(xs, sh.view("final_norm"))]
    return _logits(sh, xs)[:, 0], states


def _logits(sh: Shards, xs: list) -> torch.Tensor:
    logits, split = _head(sh, xs)
    if split:
        logits = sh.gather(logits, -1)
    return torch.cat([logits[g[0]].to(logits[0].device) for g in sh.groups])


def _block_decode(sh: Shards, i: int, xs: list, states: list, *, pos: int,
                  window: int, positions: Optional[list]) -> list:
    cfg = sh.cfg
    p = f"blocks.{i}."
    hs = [rms_norm(x, ln) for x, ln in zip(xs, sh.view(p + "ln1"))]
    if cfg.mixer == "fourier":
        rings = [st["ring"] for st in states]
        outs = []
        for h, hc, ring, taps, gate in zip(
                hs, sh.own(hs, -1), rings, sh.view(p + "fourier.taps", 1),
                sh.view(p + "fourier.gate", 1)):
            ns = types.SimpleNamespace(taps=taps, gate=gate)
            y = lm._fourier_decode(ns, hc, ring, pos=pos, gate_input=h)
            outs.append(y.to(h.dtype))
        ys = sh.gather(outs, -1)
    elif cfg.mixer == "rwkv6":
        ys, new = rec_lib.rwkv_time_mix_sharded(
            sh, p + "rwkv_t.", hs, cfg,
            [{"prev_x": st["prev_x"], "S": st["S"]} for st in states])
        for st, n in zip(states, new):
            st["prev_x"].copy_(n["prev_x"])
            st["S"].copy_(n["S"])
    else:
        ys = attn_lib.attention_decode_sharded(
            sh, p + "attn.", hs, cfg,
            caches=[(st["cache_k"], st["cache_v"]) for st in states],
            pos=pos, window=window, positions=positions)
        if cfg.mixer == "hymba":
            y_ssm, new = rec_lib.ssm_mix_sharded(
                sh, p + "ssm.", hs, [st["ssm_h"] for st in states])
            for st, h in zip(states, new):
                st["ssm_h"].copy_(h)
            ys = _hymba_out(sh, p, ys, y_ssm)
    xs = [x + y.to(x.dtype) for x, y in zip(xs, ys)]
    h2 = [rms_norm(x, ln) for x, ln in zip(xs, sh.view(p + "ln2"))]
    if cfg.mixer == "rwkv6":
        y2, last = rec_lib.rwkv_channel_mix_sharded(
            sh, p + "rwkv_c.", h2, [st["prev_x_c"] for st in states])
        for st, x in zip(states, last):
            st["prev_x_c"].copy_(x)
    elif cfg.is_moe:
        y2, _ = moe_lib.moe_ffn_sharded(sh, p + "moe.", h2, cfg,
                                        lm._reduce_dtype(cfg))
    else:
        y2 = swiglu_mlp_sharded(sh, p + "mlp.", h2, lm._reduce_dtype(cfg))
    return [x + y for x, y in zip(xs, y2)]


@torch.no_grad()
def decode_step(sh: Shards, states: list, token: Optional[torch.Tensor],
                pos: int, *, positions: Optional[torch.Tensor] = None,
                embed: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, list]:
    """``DecoderLM.decode_step`` sharded: (logits (B, vocab_padded) fp32,
    the states updated in place)."""
    if sh.cfg.frontend == "embeddings":
        xs = _embed(sh, None, sh.local(embed))
    else:
        xs = [x[:, None] for x in _embed(sh, sh.local(token), None)]
    pos_l = sh.local(positions)
    windows = lm._layer_windows(sh.cfg)
    for i in range(sh.cfg.num_layers):
        xs = _block_decode(sh, i, xs, [lm._layer_state(st, i)
                                       for st in states],
                           pos=pos, window=windows[i], positions=pos_l)
    xs = [rms_norm(x, n) for x, n in zip(xs, sh.view("final_norm"))]
    return _logits(sh, xs)[:, 0].float(), states


@torch.no_grad()
def generate(sh: Shards, tokens: torch.Tensor, gen: int) -> torch.Tensor:
    """``lm.generate`` sharded: the (gen, B) greedy tokens."""
    S, V = tokens.shape[1], sh.cfg.vocab_size
    logits, states = prefill(sh, tokens, cache_capacity=S + gen)
    tok = logits[:, :V].argmax(dim=-1)
    out = []
    for i in range(gen):
        out.append(tok)
        logits, states = decode_step(sh, states, tok, S + i)
        tok = logits[:, :V].argmax(dim=-1)
    return torch.stack(out)


# ---------------------------------------------------------------------------
# The collectives' closed form
# ---------------------------------------------------------------------------

def collective_form(cfg: ModelConfig, shards: int, batch: int, seq: int, *,
                    step: bool) -> dict:
    """What the byte ledger holds after one ``forward`` (``step=False``) or
    one ``value_and_grad`` (``step=True``, the backward included) in the
    replicated layout on ``shards`` model shards: {kind: [count, bytes]},
    in the ledger's unit (a psum: one shard's block; an all-gather: the
    gathered result). T = batch x seq tokens, a the activations' bytes:

      * the embedding (vocabulary split): a psum of T d a; its leaf's
        gradient all-gathered (as every leaf a shard uses a block of);
      * attention ("split"): the psum of the output projection's partial
        sums, T d fp32 (bf16 under reduce_dtype); backward, the psum of the
        input's gradient (T d a) and of the qk-norm scales'; "select" adds
        k's and v's; a mixer run whole (attention, RWKV6's time mix)
        records nothing, its leaves being whole on every shard;
      * the SwiGLU: a psum of T d fp32 partial sums; backward its input's;
        the MoE the same over the experts' (E, B nG C, d) slots;
      * the Fourier mixer: an all-gather of its T d a output; backward the
        psum of its input's gradient and the all-gather of its channel
        blocks' (split);
      * RWKV6: psums of the decay's low rank and the output (T d fp32),
        backward five inputs' psums and the decay's all-gather (fp32); the
        channel mix an all-gather of r and a psum; hymba's SSM an
        all-gather of its output, backward four psums and an all-gather;
      * the loss: the shards' logsumexps all-gathered (T fp32 a shard) and
        the label's logit psummed (T fp32); backward the psum of the final
        activations' gradient (T d a). ``forward`` all-gathers the logits
        (T V a) instead."""
    M = shards
    T, d, f, V = batch * seq, cfg.d_model, cfg.d_ff, cfg.vocab_padded
    a = torch.finfo(lm.dtype_of(cfg.dtype)).bits // 8
    pn = torch.finfo(lm.dtype_of(cfg.param_dtype)).bits // 8
    partial = 2 if cfg.reduce_dtype == "bfloat16" else 4
    out = {"psum": [0, 0], "all-gather": [0, 0]}

    def rec(kind, nbytes, n=1):
        out[kind][0] += n
        out[kind][1] += nbytes * n

    def fwd(kind, nbytes, n=1):
        rec(kind, nbytes, n)

    def bwd(kind, nbytes, n=1):
        if step:
            rec(kind, nbytes, n)

    def split_leaf(numel, nbytes, n=1):
        """A leaf each shard takes a block of: its gradient all-gathered."""
        bwd("all-gather", numel * nbytes, n)

    if cfg.frontend != "embeddings" and V % M == 0:
        fwd("psum", T * d * a)
        split_leaf(V * d, a)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for _ in range(cfg.num_layers):
        if cfg.mixer in ("attn", "hymba"):
            plan, h, kv = attn_lib.head_plan(cfg, M)
            if plan != "whole":         # a whole mixer records nothing
                fwd("psum", T * d * partial)
                bwd("psum", T * d * a)
                split_leaf(d * H * hd, a)
                split_leaf(H * hd * d, a)
                if cfg.qk_norm:
                    bwd("psum", hd * pn, 2 if plan == "split" else 1)
                if plan == "split":
                    split_leaf(d * KV * hd, a, 2)
                else:
                    bwd("psum", T * KV * hd * a, 2)
        if cfg.mixer == "hymba":
            n = cfg.ssm_state
            fwd("all-gather", T * d * a)
            bwd("psum", T * n * 4, 2)
            bwd("psum", T * d * 4)
            bwd("all-gather", T * d * 4)
            split_leaf(d * d, pn)
            split_leaf(d, 4, 2)
            split_leaf(d * n, 4)
        if cfg.mixer == "fourier":
            fwd("all-gather", T * d * a)
            bwd("psum", T * d * a)
            bwd("all-gather", T * d * a)
            split_leaf(cfg.fourier_taps * d, pn)
            split_leaf(d * d, a)
        if cfg.mixer == "rwkv6":
            lora = rec_lib.RWKV_LORA
            if rec_lib.rwkv_heads_split(cfg, M):
                fwd("psum", T * d * 4, 2)
                bwd("psum", T * d * a, 5)
                bwd("all-gather", T * d * 4)
                split_leaf(d * d, a, 5)
                split_leaf(d * lora, pn, 2)
                split_leaf(d, 4)
            fwd("all-gather", T * d * a)
            fwd("psum", T * d * 4)
            bwd("psum", T * d * a, 2)
            split_leaf(d * f, a, 2)
            split_leaf(d * d, a)
        elif cfg.is_moe:
            E, k = cfg.num_experts, cfg.experts_per_token
            g = min(cfg.moe_group_size, seq)
            C = max(1, math.ceil(g * k / E * cfg.capacity_factor))
            N = batch * -(-seq // g) * C
            fwd("psum", E * N * d * partial)
            bwd("psum", E * N * d * a)
            split_leaf(E * d * f, a, 3)
        elif cfg.mixer != "rwkv6":
            fwd("psum", T * d * partial)
            bwd("psum", T * d * a)
            split_leaf(d * f, a, 3)
    if V % M == 0:
        if step:
            fwd("all-gather", T * 4 * M)
            fwd("psum", T * 4)
            bwd("psum", T * d * a)
            split_leaf(d * V, a)
        else:
            fwd("all-gather", T * V * a)
    return out
