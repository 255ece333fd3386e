"""Op-dispatch registry for serving (port of ``repro.launch.ops``).

Every transform endpoint this package serves is described once here as an
:class:`OpSpec` and resolved into a :class:`BoundOp` (plan + route + batch
fn + payload conventions) by ``OpSpec.bind``. ``launch/serve.py`` and
``launch/engine.py`` dispatch through this table, never through per-op
branches.

The OpSpec contract:

  * ``arity``            -- payload operands per request (1 = transform,
                            2 = product); the engine stacks them host-side.
  * ``bind(n, ctx)``     -- validate the ``(op, n, modulus_bits,
                            model_shards)`` combination, raising
                            :class:`OpConfigError` with the registry's own
                            message, and build the executable route: plan,
                            route tag, batch fn, device.
  * ``warmup`` payload   -- one request of zeros in the payload dtype.
  * ``random_payload``   -- the traffic generator the producers draw from.
  * ``verify``           -- a numpy-oracle check of one served result.
  * ``integrity``        -- the batch-level ABFT check (``ft/abft.py``) the
                            verified engine runs on the rows a batch
                            delivers, after its host step, before any
                            client sees them.

This package serves the float ops ``fft``, ``rfft``, ``polymul`` and
``polymul-real`` and the exact ``polymul-mod`` (single-limb and RNS) on the
local tier, and ``polymul-real`` and single-limb ``polymul-mod`` on the
distributed four-step tier with ``model_shards > 1``
(``polymul-real-distributed``, ``polymul-mod-distributed``: the sequence
sharded over a mesh of that many shards, ``BoundOp.mesh``). Knobs an op
does not consume are rejected by ``bind`` (strict mode) or stripped by
``OpSpec.narrow`` (the mixed engine). With
``OpContext.auto`` each bind lets the cost model choose among the routes
the op has: where it picks complex packing for a real op, ``rfft`` binds
``rfft-complex`` (the fft kernel on cast-up rows, then the half spectrum)
and ``polymul-real`` binds ``polymul-real-complex`` (the complex product
kernel on cast-up rows, then the real part).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import fft as fft_core
from repro_torch.core import ntt as ntt_core
from repro_torch.core.fft import distributed as dfft
from repro_torch.core.ntt import distributed as dntt
from repro_torch.dist import sharding
from repro_torch.ft import abft
from repro_torch.kernels import ntt as kntt


#: Torch dtypes of the staged numpy dtypes, for the pinned staging buffers.
_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.complex64): torch.complex64,
                 np.dtype(np.uint32): torch.uint32}


class OpConfigError(ValueError):
    """Invalid (op, n, modulus_bits, model_shards) combination, raised at
    registry-validation time with a message that names the offending
    knob."""


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device a serve entry point runs on: CUDA unless the caller asks
    for the CPU. Raises when CUDA is wanted and absent: the service never
    moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev}: the service runs on cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to serve on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class OpContext:
    """Process-level route parameterization shared by every op of a serve
    process (CLI flags); ``OpSpec.narrow`` strips the knobs an op ignores.

    ``model_shards > 1`` binds the distributed four-step route of the ops
    that have one. ``auto=True`` hands the tier and packing choice to the
    cost model: ``model_shards`` becomes the AVAILABLE shard count rather
    than a demand, each bind asks ``plan(n, batch, workload=<op name>,
    ...)`` for the predicted-cheapest executable route, and the plan
    carries the cost breakdown (``FFTPlan.cost``). ``packings`` narrows the
    candidates the model may choose from (the ``real`` values: ``(False,)``
    binds the complex-packing route of a real op), ``pim_ok=False`` plans
    with the PIM backend off the table (the circuit-breaker context: the
    re-bind a serve bucket gets after its simulated crossbar array is
    quarantined).

    ``verified=True`` binds the route with ABFT integrity pricing: auto
    plans carry the check's overhead in their cost breakdown, and the RNS
    route proves its modulus is checkable (it factors over the limb
    primes) at bind time. All four apply to every op, so ``narrow`` keeps
    them."""
    modulus_bits: int | None = None
    model_shards: int = 1
    auto: bool = False
    packings: tuple[bool, ...] | None = None
    verified: bool = False
    pim_ok: bool = True


@dataclasses.dataclass
class BoundOp:
    """A resolved (op, n): everything an executor needs.

    ``fn`` takes the stacked operand tensors (``stack``'s output, one per
    operand) at ANY batch size: tail batches run at their actual size, the
    kernels fit their block to the batch instead of padding.

    Host steps around the card: ``encode`` (None: the rows are staged as
    they are) turns one operand's stacked (B, n) rows into the array that
    is staged, and ``host_step`` turns the batch's output, once on the
    host, into its (B, ...) result rows. The RNS route splits big-int rows
    into (k, B, n) limb residues and runs the CRT there.
    """
    spec: "OpSpec"
    n: int
    plan: fft_core.FFTPlan
    route: str
    fn: Callable[..., torch.Tensor]
    payload_dtype: Any              # numpy dtype
    device: torch.device
    encode: Callable[[np.ndarray], np.ndarray] | None = None
    host_step: Callable[[np.ndarray], np.ndarray] = lambda rows: rows
    ntt_params: ntt_core.NTTParams | None = None   # single-limb modulus
    rns: ntt_core.RNSParams | None = None          # multi-limb RNS route
    mesh: sharding.Mesh | None = None              # distributed routes

    @property
    def key(self) -> tuple[str, int]:
        return (self.spec.name, self.n)

    def stack(self, payloads: Sequence[Any]) -> tuple[torch.Tensor, ...]:
        """Host-side batch assembly: per-request payloads -> the operand
        tensors ``fn`` consumes, on the bound device, at the list's actual
        length. For the card the rows are stacked into pinned host memory
        and copied without blocking the host, so the copy queues on the
        stream behind the batch in flight instead of waiting for it."""
        cols = ([payloads] if self.spec.arity == 1 else
                [[p[i] for p in payloads] for i in range(self.spec.arity)])
        return tuple(self._column(c) for c in cols)

    def _column(self, rows: Sequence[Any]) -> torch.Tensor:
        rows = [np.asarray(r, self.payload_dtype) for r in rows]
        if self.encode is not None:
            rows = self.encode(np.stack(rows))
        # np.stack of a list of rows, or of an encoded array's first axis
        if self.device.type == "cpu":
            return torch.from_numpy(np.stack(rows))
        host = torch.empty((len(rows), *rows[0].shape), pin_memory=True,
                           dtype=_TORCH_DTYPES[rows[0].dtype])
        np.stack(rows, out=host.numpy())
        return host.to(self.device, non_blocking=True)

    def execute(self, payloads: Sequence[Any]) -> torch.Tensor:
        """Dispatch one batch (asynchronous on the card)."""
        return self.fn(*self.stack(payloads))

    @staticmethod
    def to_host(out: torch.Tensor) -> torch.Tensor:
        """Start the copy of a dispatched batch to the host. From the card
        it goes into pinned memory without blocking the host, ordered on
        the stream after the batch's kernels: read it only once the stream
        has passed that point. A CPU batch is returned as it is."""
        if out.device.type == "cpu":
            return out
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        return host

    def to_numpy(self, out: torch.Tensor) -> np.ndarray:
        """Materialize a dispatched batch's result rows on the host (waits
        for it)."""
        return self.host_step(out.cpu().numpy())

    def warmup(self, batch: int) -> None:
        """Run the route as the engine serves it at one batch size, two
        batches queued at once (deploy warmup: builds and loads the
        kernels, fills the twiddle caches, and leaves the pinned host
        buffers and device memory of that batch size cached, as one batch
        in flight needs them)."""
        payloads = [self.spec.warmup_payload(self)] * batch
        for _ in range(2):
            self.to_host(self.execute(payloads))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def random_payload(self, rng: np.random.Generator):
        return self.spec.random_payload(self, rng)

    def verify(self, payload, result: np.ndarray) -> None:
        self.spec.verify(self, payload, result)

    def integrity(self, payloads: Sequence[Any],
                  rows: np.ndarray) -> abft.IntegrityVerdict:
        """Run the op's ABFT check on one deliverable batch: the result
        rows (after ``host_step``) against the request payloads."""
        return self.spec.integrity(self, payloads, rows)

    def check_payload(self, payload) -> None:
        """Admission guard: reject non-finite float/complex operands with
        an :class:`OpConfigError` BEFORE they join a batch -- a NaN poisons
        every row it batches with. Integer and big-int operands carry no
        NaN and pass."""
        operands = (payload,) if self.spec.arity == 1 else tuple(payload)
        for i, op in enumerate(operands):
            arr = np.asarray(op)
            if arr.dtype == object or not np.issubdtype(arr.dtype,
                                                        np.inexact):
                continue
            if not np.isfinite(arr).all():
                raise OpConfigError(
                    f"op {self.spec.name!r}: operand {i} contains "
                    f"non-finite values (NaN/Inf) -- rejected at submit "
                    f"(it would poison the whole batch)")


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """Registry entry: the full contract of one serveable op."""
    name: str
    arity: int
    summary: str
    uses_modulus_bits: bool
    uses_model_shards: bool
    _validate: Callable[["OpSpec", int, OpContext], None]
    _bind: Callable[["OpSpec", int, int, torch.device, OpContext], BoundOp]
    warmup_payload: Callable[[BoundOp], Any]
    random_payload: Callable[[BoundOp, np.random.Generator], Any]
    verify: Callable[[BoundOp, Any, np.ndarray], None]
    #: batch-level ABFT check: ``integrity(bound, payloads, rows) ->
    #: IntegrityVerdict``, O(n) a row, the gate the verified serve engine
    #: runs before delivering any result
    integrity: Callable[[BoundOp, Sequence[Any], np.ndarray],
                        abft.IntegrityVerdict]

    def validate(self, n: int, ctx: OpContext = OpContext()) -> None:
        """Raise :class:`OpConfigError` unless (n, ctx) is serveable."""
        if ctx.modulus_bits is not None and not self.uses_modulus_bits:
            raise OpConfigError(
                f"--modulus-bits applies to "
                f"{', '.join(ops_using('modulus_bits'))}; "
                f"op {self.name!r} has no modular route")
        if ctx.model_shards != 1 and not self.uses_model_shards:
            raise OpConfigError(
                f"--model-shards applies to "
                f"{', '.join(ops_using('model_shards'))}; "
                f"op {self.name!r} has no distributed route")
        self._validate(self, n, ctx)

    def narrow(self, ctx: OpContext) -> OpContext:
        """Strip the knobs this op ignores: the mixed engine resolves one
        process-level context against ops with different routes."""
        return OpContext(
            modulus_bits=ctx.modulus_bits if self.uses_modulus_bits else None,
            model_shards=ctx.model_shards if self.uses_model_shards else 1,
            auto=ctx.auto, packings=ctx.packings, verified=ctx.verified,
            pim_ok=ctx.pim_ok)

    def bind(self, n: int, ctx: OpContext = OpContext(), *, batch: int = 0,
             strict: bool = True,
             device: str | torch.device | None = None) -> BoundOp:
        """Validate and resolve the executable route on ``device`` (CUDA
        unless the caller passes the CPU).

        ``strict=True`` (the single-op CLI path) rejects knobs this op does
        not consume; ``strict=False`` narrows them away first (the mixed
        engine's per-bucket bind). Every call of the bound ``fn`` is a span
        ``repro_torch.op/<route>`` (``repro_torch/spans.py``).
        """
        if not strict:
            ctx = self.narrow(ctx)
        self.validate(n, ctx)
        bound = self._bind(self, n, batch, resolve_device(device), ctx)
        bound.fn = spans.spanned(f"repro_torch.op/{bound.route}", bound.fn)
        return bound


_REGISTRY: dict[str, OpSpec] = {}


def register_op(**kw) -> OpSpec:
    spec = OpSpec(**kw)
    if spec.name in _REGISTRY:
        raise ValueError(f"op {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def op_names() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def get_op(name: str) -> OpSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise OpConfigError(
            f"unknown op {name!r}; registered: {', '.join(_REGISTRY)}"
        ) from None


def ops_using(knob: str) -> tuple[str, ...]:
    flag = {"modulus_bits": "uses_modulus_bits",
            "model_shards": "uses_model_shards"}[knob]
    return tuple(s.name for s in _REGISTRY.values() if getattr(s, flag))


def cli_help() -> str:
    """--op help text, derived from the registry."""
    return "; ".join(f"{s.name}: {s.summary}" for s in _REGISTRY.values())


def cli_knob_help(knob: str, base: str) -> str:
    return f"{base} (applies to: {', '.join(ops_using(knob))})"


# ---------------------------------------------------------------------------
# Shared payload / verification helpers
# ---------------------------------------------------------------------------

def _rel_err(got: np.ndarray, want: np.ndarray) -> float:
    scale = max(1.0, float(np.max(np.abs(want))))
    return float(np.max(np.abs(np.asarray(got) - want))) / scale


def _float_verify(want_of: Callable[..., np.ndarray], tol: float,
                  bound: BoundOp, payload, result: np.ndarray) -> None:
    want = want_of(payload) if bound.spec.arity == 1 else want_of(*payload)
    err = _rel_err(result, want)
    if not err < tol:
        raise AssertionError(f"{bound.spec.name} route {bound.route} "
                             f"diverged from the numpy oracle: rel err "
                             f"{err:.2e} >= {tol}")


def _zeros(bound: BoundOp):
    z = np.zeros(bound.n, bound.payload_dtype)
    return z if bound.spec.arity == 1 else (z,) * bound.spec.arity


def _cnormal(rng: np.random.Generator, n: int) -> np.ndarray:
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64)


def _circular_real(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.fft.ifft(np.fft.fft(a) * np.fft.fft(b)).real


def _circular_complex(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.fft.ifft(np.fft.fft(a) * np.fft.fft(b))


def _stack_operands(bound: BoundOp,
                    payloads: Sequence[Any]) -> tuple[np.ndarray, ...]:
    """Host-side numpy stacking for the integrity checks: ``stack``
    without the encoding and the copy to the device."""
    if bound.spec.arity == 1:
        return (np.stack([np.asarray(p, bound.payload_dtype)
                          for p in payloads]),)
    return tuple(
        np.stack([np.asarray(p[i], bound.payload_dtype) for p in payloads])
        for i in range(bound.spec.arity))


def _integrity_fft(bound: BoundOp, payloads, rows):
    (x,) = _stack_operands(bound, payloads)
    return abft.check_fft(x, rows)


def _integrity_rfft(bound: BoundOp, payloads, rows):
    (x,) = _stack_operands(bound, payloads)
    return abft.check_rfft(x, rows)


def _integrity_polymul(bound: BoundOp, payloads, rows):
    a, b = _stack_operands(bound, payloads)
    return abft.check_polymul(a, b, rows)


def _integrity_polymul_real(bound: BoundOp, payloads, rows):
    a, b = _stack_operands(bound, payloads)
    return abft.check_polymul_real(a, b, rows)


def _integrity_polymul_mod(bound: BoundOp, payloads, rows):
    a, b = _stack_operands(bound, payloads)
    if bound.rns is not None:
        return abft.check_polymul_rns(a, b, rows, bound.rns)
    return abft.check_polymul_mod(a, b, rows, bound.ntt_params)


def _local_only(spec: OpSpec, n: int, ctx: OpContext) -> None:
    pass


def _plan_or_config_error(**kw) -> fft_core.FFTPlan:
    """Run the planner, lifting its ValueError into the registry's own
    error type so callers see one failure surface."""
    try:
        return fft_core.plan(**kw)
    except ValueError as e:
        raise OpConfigError(str(e)) from e


def _route_plan(spec: OpSpec, n: int, batch: int, ctx: OpContext,
                **legacy) -> fft_core.FFTPlan:
    """The plan a bind executes: in auto mode the cost model's choice for
    the op's workload over ``ctx.model_shards`` available shards (``rns``
    passes through to the planner), else the legacy plan of the knobs
    ``legacy`` names, pinned to the distributed tier where the context
    asks for shards (``force_distributed``)."""
    if ctx.auto:
        return _plan_or_config_error(
            n=n, batch=batch, workload=spec.name,
            model_shards=ctx.model_shards,
            rns=legacy.get("rns", False), packings=ctx.packings,
            verified=ctx.verified, pim_ok=ctx.pim_ok)
    if ctx.packings is not None:
        raise OpConfigError("packings narrows the cost model's choice: it "
                            "needs auto mode (--auto)")
    if ctx.model_shards > 1:
        legacy.update(model_shards=ctx.model_shards, force_distributed=True)
    return _plan_or_config_error(n=n, batch=batch, **legacy)


def _mesh(plan: fft_core.FFTPlan, axis_name: str,
          device: torch.device) -> sharding.Mesh:
    """The mesh a distributed plan runs on: ``plan.seq_shards`` shards
    round-robin over the cards, or on the CPU."""
    return sharding.make_mesh((plan.seq_shards,), (axis_name,),
                              device=device)


# ---------------------------------------------------------------------------
# fft -- complex transform endpoint
# ---------------------------------------------------------------------------

def _bind_fft(spec: OpSpec, n: int, batch: int,
              device: torch.device, ctx: OpContext) -> BoundOp:
    plan = _route_plan(spec, n, batch, ctx)
    return BoundOp(spec=spec, n=n, plan=plan, route="fft",
                   fn=lambda x: fft_core.fft(x, radix=plan.radix,
                                             block_b=plan.block_b),
                   payload_dtype=np.complex64, device=device)


register_op(
    name="fft", arity=1,
    summary="batched complex FFT (local CUDA tier)",
    uses_modulus_bits=False, uses_model_shards=False,
    _validate=_local_only, _bind=_bind_fft,
    warmup_payload=_zeros,
    random_payload=lambda b, rng: _cnormal(rng, b.n),
    verify=functools.partial(_float_verify, np.fft.fft, 1e-3),
    integrity=_integrity_fft,
)


# ---------------------------------------------------------------------------
# rfft -- real-Hermitian half-spectrum endpoint (two-for-one packed kernel)
# ---------------------------------------------------------------------------

def _bind_rfft(spec: OpSpec, n: int, batch: int,
               device: torch.device, ctx: OpContext) -> BoundOp:
    plan = _route_plan(spec, n, batch, ctx, real=True)
    if not plan.real:
        # the cost model chose complex packing: the fft kernel on cast-up
        # rows, then the half spectrum (the same payload/result contract)
        return BoundOp(
            spec=spec, n=n, plan=plan, route="rfft-complex",
            fn=lambda x: fft_core.fft(
                x.to(torch.complex64), radix=plan.radix,
                block_b=plan.block_b)[..., :n // 2 + 1],
            payload_dtype=np.float32, device=device)
    return BoundOp(spec=spec, n=n, plan=plan, route="rfft-real",
                   fn=lambda x: fft_core.rfft(x, radix=plan.radix,
                                              block_b=plan.block_b),
                   payload_dtype=np.float32, device=device)


register_op(
    name="rfft", arity=1,
    summary="real-input half-spectrum FFT (two-for-one Hermitian packing)",
    uses_modulus_bits=False, uses_model_shards=False,
    _validate=_local_only, _bind=_bind_rfft,
    warmup_payload=_zeros,
    random_payload=lambda b, rng: rng.standard_normal(b.n).astype(np.float32),
    verify=functools.partial(_float_verify, np.fft.rfft, 1e-3),
    integrity=_integrity_rfft,
)


# ---------------------------------------------------------------------------
# polymul -- complex circular product (three-transform kernel)
# ---------------------------------------------------------------------------

def _bind_polymul(spec: OpSpec, n: int, batch: int,
                  device: torch.device, ctx: OpContext) -> BoundOp:
    plan = _route_plan(spec, n, batch, ctx, product=True)
    return BoundOp(
        spec=spec, n=n, plan=plan, route="polymul",
        fn=lambda a, b: fft_core.polymul(a, b, mode="circular",
                                         radix=plan.radix,
                                         block_b=plan.block_b),
        payload_dtype=np.complex64, device=device)


register_op(
    name="polymul", arity=2,
    summary="complex circular polynomial product (convolution theorem)",
    uses_modulus_bits=False, uses_model_shards=False,
    _validate=_local_only, _bind=_bind_polymul,
    warmup_payload=_zeros,
    random_payload=lambda b, rng: (_cnormal(rng, b.n), _cnormal(rng, b.n)),
    verify=functools.partial(_float_verify, _circular_complex, 1e-3),
    integrity=_integrity_polymul,
)


# ---------------------------------------------------------------------------
# polymul-real -- paired-inverse real product; the distributed four-step
# route with model_shards > 1 (odd batches padded internally)
# ---------------------------------------------------------------------------

def _validate_polymul_real(spec: OpSpec, n: int, ctx: OpContext) -> None:
    if ctx.model_shards > 1 or ctx.auto:
        _route_plan(spec, n, 0, ctx, real=True, product=True)


def _bind_polymul_real(spec: OpSpec, n: int, batch: int,
                       device: torch.device, ctx: OpContext) -> BoundOp:
    plan = _route_plan(spec, n, batch, ctx, real=True, product=True)
    if plan.tier == "distributed":
        # the distributed tier serves the real packing, as the reference's
        # does (its real candidate is always the cheaper distributed one)
        mesh = _mesh(plan, "model", device)
        return BoundOp(
            spec=spec, n=n, plan=plan, route="polymul-real-distributed",
            fn=dfft.make_sharded_polymul_real(mesh, radix=plan.radix),
            payload_dtype=np.float32, device=device, mesh=mesh)
    if not plan.real:
        # the cost model chose complex packing: the complex product kernel
        # on cast-up rows, then the real part
        return BoundOp(
            spec=spec, n=n, plan=plan, route="polymul-real-complex",
            fn=lambda a, b: fft_core.polymul(
                a.to(torch.complex64), b.to(torch.complex64),
                mode="circular", radix=plan.radix,
                block_b=plan.block_b).real,
            payload_dtype=np.float32, device=device)
    return BoundOp(
        spec=spec, n=n, plan=plan, route="polymul-real-packed",
        fn=lambda a, b: fft_core.polymul_real(a, b, mode="circular",
                                              radix=plan.radix,
                                              block_b=plan.block_b),
        payload_dtype=np.float32, device=device)


register_op(
    name="polymul-real", arity=2,
    summary="real circular product via the paired-inverse Hermitian fast "
            "path; --model-shards > 1 runs the distributed four-step tier",
    uses_modulus_bits=False, uses_model_shards=True,
    _validate=_validate_polymul_real, _bind=_bind_polymul_real,
    warmup_payload=_zeros,
    random_payload=lambda b, rng: (
        rng.standard_normal(b.n).astype(np.float32),
        rng.standard_normal(b.n).astype(np.float32)),
    verify=functools.partial(_float_verify, _circular_real, 1e-3),
    integrity=_integrity_polymul_real,
)


# ---------------------------------------------------------------------------
# polymul-mod -- exact negacyclic product mod (x^n + 1, q): the single-limb
# fused NTT kernel (modulus_bits <= 30), multi-limb RNS with the CRT on
# the host (modulus_bits > 30), or the distributed four-step NTT
# (model_shards > 1, single-limb only).
# ---------------------------------------------------------------------------

def _rns_route(ctx: OpContext) -> bool:
    return ctx.modulus_bits is not None and ctx.modulus_bits > 30


def _validate_polymul_mod(spec: OpSpec, n: int, ctx: OpContext) -> None:
    bits = ctx.modulus_bits
    if _rns_route(ctx) and ctx.model_shards > 1:
        raise OpConfigError(
            "distributed polymul-mod is single-limb: RNS "
            "(modulus_bits > 30) shards limbs, not the sequence — drop "
            "--model-shards or use modulus_bits <= 30")
    if ctx.model_shards > 1 or ctx.auto:
        _route_plan(spec, n, 0, ctx, exact=True, rns=_rns_route(ctx))
    try:
        if _rns_route(ctx):
            ntt_core.RNSParams.make(n, modulus_bits=bits)
        else:
            ntt_core.NTTParams.make(n, bits=30 if bits is None else bits)
    except ValueError as e:
        raise OpConfigError(
            f"no NTT modulus for n={n}, modulus_bits={bits}: {e}") from e


def _bind_polymul_mod(spec: OpSpec, n: int, batch: int, device: torch.device,
                      ctx: OpContext) -> BoundOp:
    plan = _route_plan(spec, n, batch, ctx, exact=True, rns=_rns_route(ctx))
    if _rns_route(ctx):
        rns = ntt_core.RNSParams.make(n, modulus_bits=ctx.modulus_bits)
        if ctx.verified:
            # A verified bind must be CHECKABLE: the per-factor
            # eval-at-psi check needs Q to factor over the limb primes.
            # Prove it here, not on the first served batch.
            try:
                abft.check_limbs_for(rns)
            except abft.ABFTUnsupportedModulus as e:
                raise OpConfigError(
                    f"verified polymul-mod (RNS) bind rejected: {e}"
                ) from e
        return BoundOp(
            spec=spec, n=n, plan=plan, route="polymul-mod-rns",
            fn=lambda a, b: kntt.rns_ntt_polymul(a, b, rns,
                                                 block_b=plan.block_b),
            payload_dtype=object, device=device, rns=rns,
            # limb residues < 2^30 go to the card; the CRT runs on the host
            encode=lambda rows: ntt_core.to_rns(rows, rns).astype(np.uint32),
            host_step=lambda res: ntt_core.crt_to_modulus(
                res.view(np.uint32), rns))
    bits = ctx.modulus_bits
    params = ntt_core.NTTParams.make(n, bits=30 if bits is None else bits)
    if plan.tier == "distributed":
        mesh = _mesh(plan, "data", device)
        return BoundOp(
            spec=spec, n=n, plan=plan, route="polymul-mod-distributed",
            fn=dntt.make_sharded_ntt_polymul(mesh, params),
            payload_dtype=np.uint32, device=device, ntt_params=params,
            mesh=mesh, host_step=lambda res: res.view(np.uint32))
    return BoundOp(
        spec=spec, n=n, plan=plan, route="polymul-mod-single",
        fn=lambda a, b: kntt.ntt_polymul(a, b, params, block_b=plan.block_b),
        payload_dtype=np.uint32, device=device, ntt_params=params,
        host_step=lambda res: res.view(np.uint32))


def _random_mod_payload(bound: BoundOp, rng: np.random.Generator):
    if bound.rns is not None:
        return (ntt_core.random_poly(rng, bound.n, bound.rns.modulus),
                ntt_core.random_poly(rng, bound.n, bound.rns.modulus))
    q = bound.ntt_params.q
    return (rng.integers(0, q, bound.n).astype(np.uint32),
            rng.integers(0, q, bound.n).astype(np.uint32))


def _verify_mod(bound: BoundOp, payload, result: np.ndarray) -> None:
    a, b = payload
    if bound.rns is not None:
        want = ntt_core.rns_polymul_reference(np.asarray(a, object),
                                              np.asarray(b, object),
                                              bound.rns)
    else:
        want = ntt_core.negacyclic_polymul(np.asarray(a), np.asarray(b),
                                           bound.ntt_params)
    assert (np.asarray(result) == want).all(), \
        f"{bound.route} is not bit-exact against the reference NTT"


register_op(
    name="polymul-mod", arity=2,
    summary="exact negacyclic product mod (x^n+1, q); --modulus-bits > 30 "
            "routes through multi-limb RNS/CRT, --model-shards > 1 the "
            "distributed four-step NTT",
    uses_modulus_bits=True, uses_model_shards=True,
    _validate=_validate_polymul_mod, _bind=_bind_polymul_mod,
    warmup_payload=_zeros,
    random_payload=_random_mod_payload,
    verify=_verify_mod,
    integrity=_integrity_polymul_mod,
)
