"""Execution planner for the Fourier ops (port of ``repro.core.fft.planner``,
legacy mode).

Given (n, batch) it decides the kernel configuration that executes on the
card: radix (2 or 4), rows per CTA, and the schedule: a row resident in
one CTA's shared memory, the two-pass schedule (each CTA holding whole
sub-problems of a split n = n1 x n2: two launches for the FFT and the real
FFT, three or four for the products' split-pass schedule, three for the
exact products'), the RNS product's register-step schedule (one CTA per
row and limb, its sweeps in registers), or one CTA per row staging its
sweeps through a device-memory scratch. Only the local tiers exist in
this package, float and exact (NTT): the distributed four-step tiers
raise and name the slice that ports them.

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
from repro_torch.kernels.ntt import (RNSRegisterSteps, ntt_resident,
                                     ntt_two_pass_plan, plan_ntt_block,
                                     rns_schedule)
from repro_torch.kernels.polymul import (default_complex_block,
                                         default_real_block,
                                         product_two_pass_plan)



@dataclasses.dataclass(frozen=True)
class FFTPlan:
    tier: str           # "local" (the only tier this package runs)
    radix: int          # 2 or 4 (2 on the exact tier)
    block_b: int        # rows per CTA at most (a cap; fitted to each batch)
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
    #: on the exact tier, whose radix-2 sweeps put every split on it).
    launches: int = 1
    #: machine-readable cost breakdown from ``core.cost.workload_cost``
    #: when the plan was auto-chosen (``plan(..., workload=...)``); None
    #: for explicit-knob plans. Excluded from eq/hash so an auto plan and
    #: the legacy plan of the same candidate compare equal (the serve
    #: engine keys buckets on plans).
    cost: dict | None = dataclasses.field(default=None, compare=False)

    def describe(self) -> str:
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
         workload: str | None = None,
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
    row block and limb. As in the reference, one device
    plans every n locally (the reference's 512K-point exact ceiling only
    picks its distributed tier when model_shards > 1); rows past the
    splits are staged.

    ``workload=`` switches to AUTO mode: the cost model
    (``core.cost.workload_cost``) scores every executable (tier, packing)
    candidate on the PIM twin and the card's roofline, and the plan of the
    predicted-cheapest comes back, equal field for field to this function's
    legacy plan of that candidate (``real`` from the candidate, ``product``
    and ``exact`` from the workload, ``rns`` as passed: the registry's
    ``polymul-mod`` route takes it from the modulus), with the breakdown on
    ``FFTPlan.cost``. ``real=True`` keeps only real-packed candidates and
    ``packings`` any subset of the packings (the ``real`` values) the
    workload has; ``pim_ok=False`` plans with the PIM backend off the
    table. A workload with no executable candidate raises ValueError
    naming every pruned candidate's constraint.

    Raises ValueError on a non-power-of-two n, a negative batch,
    ``exact`` with ``real``, ``rns`` without ``exact`` (or, in auto mode,
    without the ``polymul-mod`` workload), and on what this package does
    not run yet: ``model_shards > 1`` and ``verified=True``.
    """
    if n <= 0 or n & (n - 1):
        raise ValueError(f"n={n} must be a power of two")
    if batch < 0:
        raise ValueError(f"batch={batch} must be non-negative")
    if exact and real:
        raise ValueError("exact (mod-q) and real (Hermitian) tiers are "
                         "mutually exclusive")
    if model_shards != 1:
        raise ValueError(f"model_shards={model_shards}: distributed tier not "
                         f"yet ported; it comes with {cost_model.DIST_SLICE}")
    if verified:
        raise ValueError(f"verified=True: ABFT-priced planning not yet "
                         f"ported; it comes with {cost_model.FT_SLICE}")
    if workload is not None:
        return _plan_auto(n, batch, workload, exact=exact, real=real,
                          product=product, rns=rns, packings=packings,
                          pim_ok=pim_ok)
    if rns and not exact:
        raise ValueError("rns plans the exact tier's multi-limb product: "
                         "pass exact=True")
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


def _plan_auto(n: int, batch: int, workload: str, *, exact: bool,
               real: bool, product: bool, rns: bool,
               packings: tuple[bool, ...] | None, pim_ok: bool) -> FFTPlan:
    """Cost-model-driven choice (the reference's ``_plan_auto``, one
    device). Explicit knobs narrow the candidate space rather than being
    ignored; ``exact=``, ``product=`` and ``rns=`` must agree with the
    workload: the modular route is the ``polymul-mod`` workload, the fused
    products its three product workloads."""
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
    breakdown = cost_model.workload_cost(
        workload, n, batch,
        packings=None if packings is None else list(packings),
        pim_ok=pim_ok)
    best = breakdown["best"]
    if best is None:
        lines = [
            f"  - tier={p['tier']}"
            f"{', real-packed' if p['real'] else ''}: {p['reason']}"
            for p in breakdown["pruned"]]
        raise ValueError(
            f"no executable tier for workload={workload!r} n={n} over "
            f"1 shard(s); every candidate was pruned:\n"
            + "\n".join(lines))
    chosen = plan(n, batch, exact=wl_exact, real=best["real"],
                  product=workload in cost_model.PRODUCTS, rns=rns)
    return dataclasses.replace(chosen, cost=breakdown)
