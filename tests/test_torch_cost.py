"""The port's cost model (``repro_torch.core.cost``), the planner's auto
mode, the registry's and the engine's auto mode and ``serve --auto``
against the reference's (``repro.core.cost``, ``repro.core.fft.planner``,
``repro.launch``).

The port prices the card where the reference prices a v5e: its backend is
``"cuda"`` where the reference's is ``"xla"`` (``BACKEND``), with the same
flop and byte formulas over the H100's rates. Tolerances: flops, bytes,
PIM cycles, pruned-candidate reasons and plans ``==``; the PIM backend's
``total_s`` within 1e-12 relative (the same closed forms, divided in the
same order); the card's roofline within 1e-12 of its own formula; served
results against the registry's numpy oracles (rel 1e-3 for the float
ops, bit for bit for ``polymul-mod``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from repro.core import cost as jcost
from repro.core.fft import planner as jplanner
from repro.launch import ops as jops
from repro_torch.core import cost as tcost
from repro_torch.core import fft as tcore
from repro_torch.core.fft import planner as tplanner
from repro_torch.launch import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.launch.engine import ServeEngine

#: the port's backend name for the reference's
BACKEND = {"xla": "cuda", "pim": "pim"}
WORKLOADS = tcost.WORKLOADS
NS = [1 << k for k in range(1, 19)]          # 2 .. 256K
BATCHES = (1, 7, 64)
REL = 1e-12


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


# ---------------------------------------------------------------------------
# The formulas: flops and bytes ==, PIM terms == the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workload", WORKLOADS + ("dct",))
def test_flop_and_byte_formulas_equal_reference(workload):
    """``_cuda_local_terms`` is the reference's ``_xla_local_terms`` for
    every workload and packing (and refuses what it refuses); the card's
    roofline divides them by the H100's rates."""
    for n in NS:
        for batch in BATCHES:
            for real in (False, True):
                try:
                    want = jcost._xla_local_terms(workload, n, batch,
                                                  real=real)
                except ValueError as e:
                    with pytest.raises(ValueError, match=str(e)):
                        tcost._cuda_local_terms(workload, n, batch,
                                                real=real)
                    continue
                got = tcost._cuda_local_terms(workload, n, batch, real=real)
                assert got == want
                c = tcost.cuda_cost(workload, n, batch, real=real)
                peak = (tcost.PEAK_INT_OPS if workload == "polymul-mod"
                        else tcost.PEAK_FLOPS)
                assert c.t_compute_s == got[0] / peak
                assert c.t_memory_s == got[1] / tcost.HBM_BW
                assert c.total_s == max(c.t_compute_s, c.t_memory_s)
                assert (c.backend, c.tier, c.seq_shards) == \
                    ("cuda", "local", 1)


def _try(f, *args, **kw):
    """f's value, or its refusal as (type name, message)."""
    try:
        return f(*args, **kw)
    except Exception as e:  # the refusal itself is compared
        return (type(e).__name__, str(e))


def _pim_terms(mod, workload):
    """Every PIM term of a cost module at one workload, over the grid."""
    out = []
    for n in NS:
        out.append(_try(mod.pim_local_unit_cycles, workload, n, batch=5))
        out.append(_try(mod._pim_local_throughput, workload, n))
        out.append(mod.pim_local_infeasible(workload, n))
        for real in (False, True):
            out.append(mod._pim_workload(workload, real))
        for d in (1, 2, 4, 8):
            out.append(mod.pim_dist_infeasible(n, d))
            out.append(_try(mod.pim_dist_unit_cycles, workload, n, d))
            out.append(_try(mod.pim_dist_unit_bytes, workload, n, d))
    return out


@pytest.mark.parametrize("workload", WORKLOADS)
def test_pim_terms_equal_reference(workload):
    """The PIM twin's local and distributed closed forms and verdicts ==,
    and its local ``TierCost`` field for field."""
    assert _pim_terms(tcost, workload) == _pim_terms(jcost, workload)
    for n in NS:
        for batch in BATCHES:
            for real in (False, True):
                got = tcost.pim_cost(workload, n, batch, real=real)
                want = jcost.pim_cost(workload, n, batch, tier="local",
                                      real=real)
                assert got.as_dict() == want.as_dict()


# ---------------------------------------------------------------------------
# The chooser: the reference's choice at D = 1, n <= 256K
# ---------------------------------------------------------------------------

def _key(c):
    return (c["tier"], c["real"])


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("pim_ok", [True, False])
def test_auto_choice_equals_reference(workload, pim_ok):
    """At one device and n <= 256K: the same candidates and pruned
    (tier, packing) pairs, the same best (tier, packing), every PIM total
    within 1e-12 relative, the distributed tier pruned with the
    reference's reason, and the auto plan == the legacy plan of the chosen
    candidate, field for field."""
    for n in NS:
        for batch in BATCHES:
            got = tcost.workload_cost(workload, n, batch, pim_ok=pim_ok)
            want = jcost.workload_cost(workload, n, batch, pim_ok=pim_ok)
            assert sorted(map(_key, got["candidates"])) == \
                sorted(map(_key, want["candidates"]))
            assert _key(got["best"]) == _key(want["best"]), (n, batch)
            assert [p["reason"] for p in got["pruned"]] == \
                [p["reason"] for p in want["pruned"]]
            by_key = {_key(c): c for c in want["candidates"]}
            for c in got["candidates"]:
                ref = by_key[_key(c)]
                assert set(c["backends"]) == {BACKEND[b]
                                              for b in ref["backends"]}
                pim, ref_pim = c["backends"]["pim"], ref["backends"]["pim"]
                if "infeasible" in ref_pim:
                    assert pim == ref_pim
                else:
                    assert _rel(pim["total_s"], ref_pim["total_s"]) < REL
                    assert pim["pim_cycles"] == ref_pim["pim_cycles"]
                best = min(c["backends"][b]["total_s"]
                           for b in c["backends"]
                           if "total_s" in c["backends"][b])
                assert c["total_s"] == best
            auto = tcore.plan(n, batch, workload=workload, pim_ok=pim_ok)
            legacy = tcore.plan(n, batch, real=got["best"]["real"],
                                exact=workload == "polymul-mod",
                                product=workload in tcost.PRODUCTS)
            assert auto == legacy
            assert [getattr(auto, f.name) for f in
                    dataclasses.fields(auto) if f.name != "cost"] == \
                [getattr(legacy, f.name) for f in
                 dataclasses.fields(legacy) if f.name != "cost"]
            assert auto.cost == got and legacy.cost is None


def test_rns_and_packing_knobs_plan_the_legacy_route():
    """``polymul-mod`` takes ``rns=True`` from the registry; ``packings``
    pins the complex-packing candidate, ``real=True`` the real one."""
    for n in (16, 4096, 65536):
        auto = tcore.plan(n, 64, workload="polymul-mod", rns=True)
        assert auto == tcore.plan(n, 64, exact=True, rns=True)
        assert auto.register_steps == \
            tcore.plan(n, 64, exact=True, rns=True).register_steps
        for wl in ("rfft", "polymul-real"):
            cplx = tcore.plan(n, 64, workload=wl, packings=(False,))
            assert cplx == tcore.plan(n, 64, product=wl != "rfft")
            assert [c["real"] for c in cplx.cost["candidates"]] == [False]
            assert tcore.plan(n, 64, workload=wl, real=True).real
    with pytest.raises(ValueError, match="rns=True conflicts"):
        tcore.plan(1024, 4, workload="polymul", rns=True)
    with pytest.raises(ValueError, match="rns plans the exact tier"):
        tcore.plan(1024, 4, rns=True)


def test_cost_rides_without_breaking_plan_equality():
    auto = tcore.plan(1024, 4, workload="fft")
    explicit = tcore.plan(1024, 4)
    assert auto.cost is not None and explicit.cost is None
    assert auto == explicit and hash(auto) == hash(explicit)


@pytest.mark.parametrize("kw,match", [
    ({"workload": "dct"}, "unknown workload"),
    ({"workload": "fft", "exact": True}, "exact.*polymul-mod"),
    ({"workload": "polymul", "real": True}, "real-packed route"),
    ({"workload": "fft", "product": True}, "product=True conflicts"),
])
def test_auto_knob_conflicts_raise_as_the_reference(kw, match):
    jkw = {k: v for k, v in kw.items() if k != "product"}
    if "product" not in kw:
        with pytest.raises(ValueError, match=match):
            jplanner.plan(1024, 4, **jkw)
    with pytest.raises(ValueError, match=match):
        tcore.plan(1024, 4, **kw)


@pytest.mark.parametrize("call,item", [
    (lambda: tcore.plan(1024, 8, workload="fft", verified=True).cost,
     "item 8"),
    (lambda: tcost.workload_cost("fft", 1024, 8, verified=True), "item 8"),
    (lambda: tcore.plan(1024, 8, workload="fft", model_shards=2), "item 9"),
    (lambda: tcost.workload_cost("fft", 1024, 8, n_devices=4), "item 9"),
])
def test_unported_slices_raise_naming_their_roadmap_item(call, item):
    """Both items are ported. Item 8's verified pricing: both calls give
    the breakdown priced with the ABFT check, its PIM backend the
    reference's. Item 9's distributed candidates: the auto plan over two
    shards is the reference's choice, and the four-shard breakdown lists
    the reference's candidates and prunes, its PIM terms the reference's
    but for the link."""
    if item == "item 8":
        got = call()
        want = jcost.workload_cost("fft", 1024, 8, verified=True,
                                   tiers=("local",))
        assert got == tcost.workload_cost("fft", 1024, 8, verified=True)
        assert got["best"]["backends"]["pim"] == \
            want["best"]["backends"]["pim"]
        assert got["best"]["backends"]["pim"]["pim_cycles"] == \
            tcost.pim_local_unit_cycles("fft", 1024, batch=8) \
            + tcost.abft_check_cycles("fft", 1024)
        return
    got = call()
    if isinstance(got, dict):
        want = jcost.workload_cost("fft", 1024, 8, n_devices=4)
        assert [(c["tier"], c["real"], c["seq_shards"])
                for c in got["candidates"]] == \
            [(c["tier"], c["real"], c["seq_shards"])
             for c in want["candidates"]]
        assert got["pruned"] == want["pruned"]
        dist = [c for c in got["candidates"] if c["tier"] == "distributed"]
        assert dist and dist[0]["backends"]["cuda"]["collective_bytes"] == \
            tcost._cuda_collective_bytes("fft", 1024, 8, 4, real=False)
        return
    want = jplanner.plan(1024, 8, workload="fft", model_shards=2)
    assert (got.tier, got.real, got.exact, got.seq_shards) == \
        (want.tier, want.real, want.exact, want.seq_shards)
    assert got == tcore.plan(1024, 8)


def test_local_ceiling_is_the_kernels_and_the_error_names_every_prune():
    """Past the kernels' on-chip ceiling the local tier is pruned with the
    constraint's name, and auto mode fails listing every pruned candidate
    in the reference's words; the real product's lower ceiling leaves the
    complex packing as its only candidate."""
    caps = {wl: tcost.local_ceiling(*tcost.route_kind(
        wl, wl in ("rfft", "polymul-real"))) for wl in WORKLOADS}
    assert caps == {"fft": 1 << 25, "rfft": 1 << 25, "polymul": 1 << 25,
                    "polymul-real": 1 << 23, "polymul-mod": 1 << 25}
    assert tcost.local_prune_reason("fft", 1 << 25, real=False) is None
    reason = tcost.local_prune_reason("fft", 1 << 26, real=False)
    assert "on-chip ceiling" in reason and "TWO_PASS_MAX_SUB" in reason
    with pytest.raises(ValueError) as got:
        tcore.plan(1 << 26, 4, workload="fft")
    with pytest.raises(ValueError) as want:
        jplanner.plan(1 << 20, 4, workload="fft")
    got_lines = str(got.value).splitlines()
    want_lines = str(want.value).splitlines()
    assert got_lines[0] == want_lines[0].replace(str(1 << 20),
                                                 str(1 << 26))
    assert [line.split(":")[0] for line in got_lines[1:]] == \
        [line.split(":")[0] for line in want_lines[1:]]
    assert got_lines[2] == want_lines[2]      # the distributed tier's
    p = tcore.plan(1 << 24, 64, workload="polymul-real")
    assert not p.real and p.product
    assert [c["real"] for c in p.cost["candidates"]] == [False]


def test_model_prices_the_kernel_tables_bound_within_3_percent():
    """At batch 64, n = 4096 and 65536, the card's roofline for fft,
    rfft, polymul and polymul-real is the byte bound ``chip_smoke.py``
    holds the kernels to (``work()`` adds the twiddle tables: within 3%)."""
    kernels = {"fft": "fft_planes", "rfft": "rfft_planes",
               "polymul": "polymul_complex_planes",
               "polymul-real": "polymul_real_planes"}
    for wl, kernel in kernels.items():
        for n in chip_smoke.SERVE_NS:
            nbytes, flops = chip_smoke.work(kernel, n, 64, 4)
            bound = max(nbytes / chip_smoke.HBM_BYTES_PER_S,
                        flops / chip_smoke.FP32_FLOPS_PER_S)
            model = tcore.plan(n, 64, workload=wl).cost["best"][
                "backends"]["cuda"]["total_s"]
            assert abs(model / bound - 1) < 0.03, (wl, n, model, bound)


# ---------------------------------------------------------------------------
# The registry, the engine and serve --auto on the CPU
# ---------------------------------------------------------------------------

def test_context_narrow_keeps_the_auto_knobs():
    ctx = tops.OpContext(modulus_bits=40, auto=True, packings=(False,),
                         pim_ok=False)
    narrowed = tops.get_op("fft").narrow(ctx)
    assert (narrowed.auto, narrowed.packings, narrowed.pim_ok,
            narrowed.modulus_bits) == (True, (False,), False, None)
    jnarrowed = jops.get_op("fft").narrow(jops.OpContext(
        modulus_bits=40, auto=True, pim_ok=False))
    assert (jnarrowed.auto, jnarrowed.pim_ok) == (True, False)
    with pytest.raises(tops.OpConfigError, match="needs auto mode"):
        tops.get_op("rfft").bind(64, tops.OpContext(packings=(False,)),
                                 device="cpu")


@pytest.mark.parametrize("op,packings,route", [
    ("rfft", None, "rfft-real"),
    ("rfft", (False,), "rfft-complex"),
    ("polymul-real", None, "polymul-real-packed"),
    ("polymul-real", (False,), "polymul-real-complex"),
])
def test_complex_fallback_routes_serve_against_numpy(op, packings, route):
    """Both packings of the real ops bind in auto mode, run their kernels'
    plain versions on the CPU, and agree with numpy at n = 256, batch 5;
    the complex route is the one the reference binds when the model
    picks complex packing (the fft or the complex product on cast-up
    rows, then the half spectrum or the real part)."""
    ctx = tops.OpContext(auto=True, packings=packings)
    bound = tops.get_op(op).bind(256, ctx, batch=5, device="cpu")
    assert bound.route == route and bound.plan.cost is not None
    assert bound.plan.real == (packings is None)
    rng = np.random.default_rng(3)
    payloads = [bound.random_payload(rng) for _ in range(5)]
    out = bound.to_numpy(bound.execute(payloads))
    for payload, row in zip(payloads, out):
        bound.verify(payload, row)
    if op == "rfft":
        want = np.fft.rfft(np.stack(payloads))
    else:
        a, b = (np.stack([p[i] for p in payloads]) for i in (0, 1))
        want = np.fft.ifft(np.fft.fft(a) * np.fft.fft(b)).real
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)


def test_engine_auto_mode_binds_serves_and_reports_predictions():
    """The reference's test of the same name, on the port: every op binds
    in auto mode at n = 256, serves, verifies against its numpy oracle,
    and reports predicted against observed cost in ``stats()``."""
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    ops = WORKLOADS
    engine = ServeEngine(max_batch=4, auto=True, device="cpu")
    for op in ops:
        engine.register(op, 256)
        assert engine.bound(op, 256).plan.cost is not None
    engine.warmup()
    kept = {}
    for op in ops:
        payload = engine.bound(op, 256).random_payload(rng)
        kept[op] = (engine.submit(op, 256, payload), payload)
    stats = engine.run(len(ops))
    assert stats["served"] == len(ops)
    for op, (rid, payload) in kept.items():
        engine.bound(op, 256).verify(payload, engine.results[rid])
    for name, b in stats["buckets"].items():
        assert b["predicted_s_per_req"] is not None, name
        assert b["predicted_tier"] == "local", name
        assert b["predicted_backend"] in ("pim", "cuda"), name
        assert b["observed_s_per_req"] > 0, name
    plain = ServeEngine(max_batch=4, device="cpu")
    plain.register("fft", 256)
    assert plain.bound("fft", 256).plan.cost is None


def test_cli_auto_prints_predicted_against_observed(capsys):
    """``serve --auto`` on the CPU, the engine service over the five ops
    (the RNS route too) and the single-op service: each bucket's line
    carries the predicted and the observed seconds per request."""
    stats = tserve.main(["--device", "cpu", "--service", "engine",
                         "--auto", "--ops", ",".join(WORKLOADS), "--ns",
                         "64,256", "--batch", "4", "--requests", "30"])
    assert stats["served"] == 30
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[serve:engine]   ")]
    assert len(lines) == 10
    assert all("predicted=" in ln and "observed=" in ln for ln in lines)
    stats = tserve.main(["--device", "cpu", "--auto", "--op",
                         "polymul-mod", "--modulus-bits", "109", "--n",
                         "64", "--batch", "4", "--requests", "8"])
    out = capsys.readouterr().out
    assert "route=polymul-mod-rns" in out and "predicted=" in out
    bucket = next(iter(stats["buckets"].values()))
    assert bucket["predicted_backend"] in ("pim", "cuda")
    assert tplanner.plan(64, 4, workload="polymul-mod", rns=True) == \
        tplanner.plan(64, 4, exact=True, rns=True)
