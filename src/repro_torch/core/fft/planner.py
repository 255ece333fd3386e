"""Execution planner for the Fourier ops (port of ``repro.core.fft.planner``,
legacy mode).

Given (n, batch) it decides the kernel configuration that executes on the
card: radix (2 or 4), rows per CTA, and the schedule: a row resident in
one CTA's shared memory, the two-pass schedule (each CTA holding whole
sub-problems of a split n = n1 x n2: two launches for the FFT and the real
FFT, three or four for the products' split-pass schedule, three for the
exact products'), the RNS product's register-step schedule (one CTA per
row and limb, its sweeps in registers), or one CTA per row staging its
sweeps through a device-memory scratch. With ``model_shards > 1`` it plans
the distributed four-step tier (``core/fft/distributed.py``,
``core/ntt/distributed.py``): the sequence sharded over a mesh of that
many shards, each shard's local transforms one kernel call at radix 2.

``plan(..., workload=)`` is the auto mode (port of the reference's
``_plan_auto``): the cost model (``core.cost``) scores every (tier,
packing) candidate the kernels execute on the PIM twin and the card's
roofline, and the predicted-cheapest comes back as the plan the legacy
mode gives for that candidate, field for field, with the breakdown on
``FFTPlan.cost``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import cost as cost_model
from repro_torch.kernels.fft import plan_batch_block, resident, two_pass_plan
from repro_torch.kernels.ntt import (RNSRegisterSteps,
                                     ntt_batched_two_pass_plan,
                                     ntt_resident, ntt_two_pass_plan,
                                     plan_ntt_block, rns_schedule)
from repro_torch.kernels.polymul import (default_complex_block,
                                         default_real_block,
                                         product_two_pass_plan)



@dataclasses.dataclass(frozen=True)
class FFTPlan:
    tier: str           # "local" | "distributed"
    radix: int          # 2 or 4 (2 on the exact and distributed tiers)
    block_b: int        # rows per CTA at most (a cap; fitted to each batch)
    seq_shards: int = 1  # mesh shards of the sequence (distributed tier)
    #: real-Hermitian route: the two-for-one packed rfft kernel and the
    #: paired-inverse real product, with the doubled block the halved
    #: working set buys.
    real: bool = False
    #: fused-product route (polymul kernels): both operands' spectra share
    #: the CTA, so half the rows per CTA of the transform route.
    product: bool = False
    #: True when a row (a row pair on the real route) stays in one CTA's
    #: shared memory for every sweep; False when the kernel runs two passes
    #: (``two_pass``) or stages its sweeps through a device-memory scratch.
    resident: bool = True
    #: exact modular route: the fused Montgomery NTT product of uint32
    #: residues (polymul-mod), bit-exact where the FFT routes round.
    exact: bool = False
    #: (n1, n2) where the kernel runs its two-pass schedule
    #: (``kernels.fft.two_pass_plan``; for the products
    #: ``kernels.polymul.product_two_pass_plan``, for the exact product
    #: ``kernels.ntt.ntt_two_pass_plan``, for the RNS product
    #: ``kernels.ntt.rns_schedule``); None where one CTA takes whole rows.
    two_pass: tuple[int, int] | None = None
    #: the RNS product's register-step schedule (``kernels.ntt.
    #: RNSRegisterSteps``): one CTA per row and limb, shared-memory
    #: resident, up to four radix-2 sweeps a step in registers.
    register_steps: bool = False
    #: the kernel launches a call makes: 1 for one CTA per row block, 2
    #: for the transforms' two passes, 3 or 4 for the products' split-pass
    #: schedule (3 where the mirrored split n2 x n1 is on the sweep sequence
    #: too, and the middle launch runs the inverse's first pass; always 3
    #: on the exact tier, whose radix-2 sweeps put every split on it). On
    #: the distributed tier, its shards' local transforms' launches
    #: (``four_step_launches``).
    launches: int = 1
    #: machine-readable cost breakdown from ``core.cost.workload_cost``
    #: when the plan was auto-chosen (``plan(..., workload=...)``); None
    #: for explicit-knob plans. Excluded from eq/hash so an auto plan and
    #: the legacy plan of the same candidate compare equal (the serve
    #: engine keys buckets on plans).
    cost: dict | None = dataclasses.field(default=None, compare=False)

    def describe(self) -> str:
        if self.tier == "distributed":
            kind = ("NTT (exact mod-q) product" if self.exact else
                    {(False, False): "FFT",
                     (True, False): "real-packed FFT (two-for-one "
                                    "Hermitian)",
                     (False, True): "complex product",
                     (True, True): "real product (paired inverse)",
                     }[(self.real, self.product)])
            local = "NTT" if self.exact else "FFT"
            return (f"four-step distributed {kind} over {self.seq_shards} "
                    f"shards, radix-{self.radix} local {local} kernel calls "
                    f"({self.launches} launches a call)")
        kind = ("NTT (exact mod-q) fused product" if self.exact else
                {(False, False): "FFT",
                 (True, False): "real-packed FFT (two-for-one Hermitian)",
                 (False, True): "fused complex product",
                 (True, True): "fused real product (paired inverse)",
                 }[(self.real, self.product)])
        if self.two_pass is not None:
            n1, n2 = self.two_pass
            steps = {2: "pass 1; pass 2",
                     3: "forward pass 1; forward pass 2, product and "
                        "inverse pass 1; inverse pass 2",
                     4: "forward pass 1; forward pass 2 and product; "
                        "inverse pass 1; inverse pass 2"}[self.launches]
            return (f"local CUDA {kind} kernel, radix-{self.radix}, "
                    f"two-pass {n1} x {n2} ({self.launches} launches: "
                    f"{steps}; whole sub-problems per CTA)")
        if self.register_steps:
            return (f"local CUDA {kind} kernel, radix-{self.radix}, one row "
                    f"and limb per CTA (shared-memory resident; register "
                    f"steps of up to four sweeps)")
        where = ("shared-memory resident" if self.resident
                 else "single-CTA staged through device memory")
        return (f"local CUDA {kind} kernel, radix-{self.radix}, "
                f"{self.block_b} rows per CTA ({where})")


def plan(n: int, batch: int, *, model_shards: int = 1, exact: bool = False,
         real: bool = False, product: bool = False, rns: bool = False,
         force_distributed: bool = False, workload: str | None = None,
         packings: tuple[bool, ...] | None = None,
         verified: bool = False, pim_ok: bool = True) -> FFTPlan:
    """Execution plan for a batch of n-point transforms.

    ``real=True`` plans the two-for-one packed kernels; ``product=True`` the
    fused products, which hold both operands' spectra and so take half the
    rows per CTA and reach shared-memory residency at half the n. Radix 4
    whenever n >= 4, as in the reference planner. Every float route
    records the two-pass split its kernel launches (from ``TWO_PASS_FROM``
    points on, where a split fits: ``kernels.fft.two_pass_plan``, for the
    products ``kernels.polymul.product_two_pass_plan``) and its launches
    per call, and is then not resident.

    ``exact=True`` plans the modular tier: the fused NTT product of
    ``polymul-mod``, radix 2, its block from shared memory for two uint32
    operands in two ping-pong buffers (16n bytes a row), and from
    ``TWO_PASS_FROM["ntt_polymul"]`` points on its split-pass schedule
    (``kernels.ntt.ntt_two_pass_plan``, three launches); with ``rns=True``
    it plans the RNS product of the multi-limb route under
    ``kernels.ntt.rns_schedule``: the same split-pass launches with the
    limb as grid row y from ``TWO_PASS_FROM["rns_ntt_polymul"]`` points,
    below that the register-step kernel (one row and limb per CTA, block
    1) from ``REGISTER_STEPS_FROM["rns_ntt_polymul"]``, else one CTA per
    row block and limb. One device plans every n locally; rows past the
    splits are staged.

    ``model_shards > 1`` plans the distributed four-step tier where the
    kernels do not keep a row on chip (past ``core.cost.local_ceiling``),
    or always with ``force_distributed=True`` (serve's ``--model-shards``):
    the reference's plan, radix 2, block 1, ``seq_shards=model_shards``,
    with ``exact``, ``real`` and ``product`` as passed and the launches
    of its shards' local kernel calls. Its shape guard is the kernel
    layer's (``D^2 | n``), so the plan returned is one the distributed
    builders execute. The RNS product shards limbs, not the sequence: it
    has no distributed plan.

    ``workload=`` switches to AUTO mode: the cost model
    (``core.cost.workload_cost``) scores every executable (tier, packing)
    candidate on the PIM twin and the card's roofline, and the plan of the
    predicted-cheapest comes back, equal field for field to this function's
    legacy plan of that candidate (``real`` from the candidate, ``product``
    and ``exact`` from the workload, ``rns`` as passed: the registry's
    ``polymul-mod`` route takes it from the modulus), with the breakdown on
    ``FFTPlan.cost``. ``real=True`` keeps only real-packed candidates and
    ``packings`` any subset of the packings (the ``real`` values) the
    workload has; ``verified=True`` prices the ABFT integrity check
    (``core.cost.abft_check_cycles``) into every candidate on both
    backends, and ``pim_ok=False`` plans with the PIM backend off the
    table (the circuit-breaker re-bind of a quarantined serve bucket).
    Both are auto mode's: the legacy plan ignores them, as the reference's
    does. A workload with no executable candidate raises ValueError naming
    every pruned candidate's constraint.

    In auto mode ``model_shards`` is the shard count the distributed
    candidates may use, and ``force_distributed=True`` keeps only them.

    Raises ValueError on a non-power-of-two n, a negative batch,
    ``exact`` with ``real``, ``rns`` without ``exact`` (or, in auto mode,
    without the ``polymul-mod`` workload), ``force_distributed`` without
    shards, and a distributed ``rns`` plan.
    """
    if n <= 0 or n & (n - 1):
        raise ValueError(f"n={n} must be a power of two")
    if batch < 0:
        raise ValueError(f"batch={batch} must be non-negative")
    if exact and real:
        raise ValueError("exact (mod-q) and real (Hermitian) tiers are "
                         "mutually exclusive")
    if force_distributed and model_shards == 1:
        raise ValueError("force_distributed needs model_shards > 1")
    if workload is not None:
        return _plan_auto(n, batch, workload, model_shards, exact=exact,
                          real=real, product=product, rns=rns,
                          force_distributed=force_distributed,
                          packings=packings, verified=verified,
                          pim_ok=pim_ok)
    if rns and not exact:
        raise ValueError("rns plans the exact tier's multi-limb product: "
                         "pass exact=True")
    on_chip = n <= cost_model.local_ceiling(real and not exact, product,
                                            exact)
    if model_shards > 1 and (force_distributed or not on_chip):
        return _distributed_plan(n, model_shards, exact=exact, real=real,
                                 product=product, rns=rns)
    if exact:      # the fused NTT product of polymul-mod, radix 2
        radix, product = 2, True
        block, res = plan_ntt_block(n), ntt_resident(n)
    else:
        radix = 4 if (n.bit_length() - 1) >= 2 else 2
        if product:
            block = (default_real_block(n) if real
                     else default_complex_block(n))
        else:
            block = plan_batch_block(n, real=real)
        res = resident(n, real=real, product=product)
    two_pass, launches, steps = None, 1, False
    if exact and rns:
        launch = rns_schedule(n)
        if isinstance(launch, RNSRegisterSteps):
            launch, steps, block = None, True, 1
    elif exact:
        launch = ntt_two_pass_plan(n)
    elif product:
        launch = product_two_pass_plan(n, radix, real=real)
    else:
        launch = two_pass_plan(n, radix, real=real)
    if launch is not None:
        two_pass = (launch.n1, launch.n2)
        launches = launch.launches
        res = False
    # repro: noqa[bare-plan-literal]: this is the port's planner, the one module that builds plans
    return FFTPlan(tier="local", radix=radix, block_b=block, real=real,
                   product=product, resident=res, exact=exact,
                   two_pass=two_pass, launches=launches,
                   register_steps=steps)


def four_step_launches(n: int, shards: int, *, exact: bool, real: bool,
                       product: bool) -> int:
    """Kernel launches of one distributed call: each shard runs each
    four-step transform as two local kernel calls, over rows of ``shards``
    points and of n / shards points (``fft_planes``; ``ntt_batched`` on
    the exact tier), each one launch or its two passes. A product makes
    three transforms (the real product two: its pairs share the
    inverse), a transform one."""
    def calls(m: int) -> int:
        split = (ntt_batched_two_pass_plan(m) if exact
                 else two_pass_plan(m, 2))
        return 1 if split is None else split.launches
    transforms = (3 if exact or (product and not real)
                  else 2 if product else 1)
    return shards * transforms * (calls(shards) + calls(n // shards))


def _distributed_plan(n: int, shards: int, *, exact: bool, real: bool,
                      product: bool, rns: bool) -> FFTPlan:
    """The distributed four-step plan, after the kernel layer's shape
    guard."""
    # lazy: the distributed tier imports the kernels' ops surface
    from repro_torch.core.fft.distributed import check_four_step_shape
    if rns:
        raise ValueError("the RNS product shards limbs, not the sequence: "
                         "it has no distributed plan")
    try:
        check_four_step_shape(n, shards)
    except ValueError as e:
        raise ValueError(
            f"cannot plan a distributed {'real ' if real else ''}FFT for "
            f"n={n} over {shards} shards: {e}") from e
    # repro: noqa[bare-plan-literal]: this is the port's planner, the one module that builds plans
    return FFTPlan(tier="distributed", radix=2, block_b=1,
                   seq_shards=shards, real=real, product=product,
                   resident=False, exact=exact,
                   launches=four_step_launches(n, shards, exact=exact,
                                               real=real, product=product))


def _plan_auto(n: int, batch: int, workload: str, model_shards: int, *,
               exact: bool, real: bool, product: bool, rns: bool,
               force_distributed: bool,
               packings: tuple[bool, ...] | None, verified: bool,
               pim_ok: bool) -> FFTPlan:
    """Cost-model-driven choice (the reference's ``_plan_auto``). Explicit
    knobs narrow the candidate space rather than being ignored:
    ``force_distributed=True`` keeps only distributed candidates, and
    ``exact=``, ``product=`` and ``rns=`` must agree with the workload: the
    modular route is the ``polymul-mod`` workload, the fused products its
    three product workloads."""
    if workload not in cost_model.WORKLOADS:
        raise ValueError(f"unknown workload {workload!r}; "
                         f"expected one of {cost_model.WORKLOADS}")
    wl_exact = workload == "polymul-mod"
    if exact and not wl_exact:
        raise ValueError(f"exact=True conflicts with workload="
                         f"{workload!r}: the exact mod-q route is the "
                         f"'polymul-mod' workload")
    if rns and not wl_exact:
        raise ValueError(f"rns=True conflicts with workload={workload!r}: "
                         f"the RNS product is the 'polymul-mod' workload's")
    if product and workload not in cost_model.PRODUCTS:
        raise ValueError(f"product=True conflicts with workload="
                         f"{workload!r}: the fused products are the "
                         f"{', '.join(cost_model.PRODUCTS)} workloads")
    if real and workload not in ("rfft", "polymul-real"):
        raise ValueError(f"real=True conflicts with workload="
                         f"{workload!r}: only 'rfft'/'polymul-real' "
                         f"have a real-packed route")
    if real:
        packings = (True,)
    tiers = (("distributed",) if force_distributed
             else ("local", "distributed"))
    breakdown = cost_model.workload_cost(
        workload, n, batch, n_devices=model_shards, tiers=tiers,
        packings=None if packings is None else list(packings),
        verified=verified, pim_ok=pim_ok)
    best = breakdown["best"]
    if best is None:
        lines = [
            f"  - tier={p['tier']}"
            f"{', real-packed' if p['real'] else ''}: {p['reason']}"
            for p in breakdown["pruned"]]
        raise ValueError(
            f"no executable tier for workload={workload!r} n={n} over "
            f"{model_shards} shard(s); every candidate was pruned:\n"
            + "\n".join(lines))
    dist = best["tier"] == "distributed"
    chosen = plan(n, batch, exact=wl_exact, real=best["real"],
                  product=workload in cost_model.PRODUCTS, rns=rns,
                  model_shards=model_shards if dist else 1,
                  force_distributed=dist)
    return dataclasses.replace(chosen, cost=breakdown)
