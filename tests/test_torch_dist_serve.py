"""The distributed tier through the port's cost model, planner, registry,
engine and CLI, against the reference where it plans or prices the same
thing.

* The cost model's collective bytes ``==`` the port's live ledger for the
  seven cases of the reference's ``test_xla_collective_bytes_match_live_
  ledger`` at D = 4 (that reference test cannot trace its mesh on the
  installed jax; here the port's builders run on a CPU mesh), and ``==``
  the reference's closed forms.
* ``dist_prune_reason``'s strings, the distributed PIM terms and the auto
  plans over D shards are the reference's.
* ``polymul-real`` and ``polymul-mod`` serve on the distributed routes,
  and the elastic resize halves the mesh down to the local route.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import cost as jcost
from repro.core.fft import planner as jplanner
from repro_torch.core import cost as tcost
from repro_torch.core import fft as tcore
from repro_torch.core.fft import distributed as tdfft
from repro_torch.core.ntt import distributed as tdntt
from repro_torch.core.ntt.ref import NTTParams
from repro_torch.dist import collectives as tcoll
from repro_torch.dist import sharding
from repro_torch.ft import checkpoint as ckpt_lib
from repro_torch.launch import ops as op_registry
from repro_torch.launch import serve
from repro_torch.launch.engine import ServeEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu"}

LEDGER_CASES = [("fft", False), ("rfft", True), ("rfft", False),
                ("polymul", False), ("polymul-real", True),
                ("polymul-real", False), ("polymul-mod", False)]


def _live_ledger(workload, real, n, batch, d):
    """Run the sharded builder the candidate executes and read its ledger:
    the all-to-all and ppermute bytes."""
    mesh = sharding.make_mesh((d,), ("model",), device="cpu")
    rng = np.random.default_rng(0)
    f32 = lambda: torch.from_numpy(  # noqa: E731
        rng.standard_normal((batch, n)).astype(np.float32))
    c64 = lambda: f32().to(torch.complex64)  # noqa: E731
    if workload == "polymul-mod":
        params = NTTParams.make(n)
        fn = tdntt.make_sharded_ntt_polymul(mesh, params, axis_name="model")
        u32 = lambda: torch.from_numpy(  # noqa: E731
            rng.integers(0, params.q, (batch, n)).astype(np.uint32))
        args = (u32(), u32())
    elif workload == "rfft" and real:
        fn, args = tdfft.make_sharded_rfft(mesh), (f32(),)
    elif workload == "polymul-real" and real:
        fn, args = tdfft.make_sharded_polymul_real(mesh), (f32(), f32())
    elif workload in ("polymul", "polymul-real"):
        fn, args = tdfft.make_sharded_polymul(mesh), (c64(), c64())
    else:
        fn, args = tdfft.make_sharded_fft(mesh), (c64(),)
    with tcoll.ledger() as led:
        fn(*args)
    return led.bytes_by_kind["all-to-all"] + led.bytes_by_kind["ppermute"]


@pytest.mark.parametrize("workload,real", LEDGER_CASES)
def test_collective_bytes_match_live_ledger(workload, real):
    n, batch, d = 1024, 4, 4
    got = _live_ledger(workload, real, n, batch, d)
    assert got == tcost._cuda_collective_bytes(workload, n, batch, d,
                                               real=real)
    assert got == jcost._xla_collective_bytes(workload, n, batch, d,
                                              real=real)


@pytest.mark.parametrize("workload", ["rfft", "polymul-real"])
def test_collective_bytes_pad_odd_real_batches(workload):
    """The real tiers pair an odd batch's last row with a zero row; the
    byte model charges the padded batch, as the live ledger records."""
    odd = tcost._cuda_collective_bytes(workload, 1024, 3, 4, real=True)
    assert odd == tcost._cuda_collective_bytes(workload, 1024, 4, 4,
                                               real=True)
    assert odd == _live_ledger(workload, True, 1024, 3, 4)
    assert odd == jcost._xla_collective_bytes(workload, 1024, 3, 4,
                                              real=True)


def test_prune_reasons_are_the_reference():
    for wl in tcost.WORKLOADS:
        for n, d in ((4096, 8), (1024, 1), (1 << 20, 3), (1 << 20, 1024),
                     (64, 8), (128, 8)):
            for real in (False, True):
                assert tcost.dist_prune_reason(wl, n, d, real=real) == \
                    jcost.dist_prune_reason(wl, n, d, real=real)


@pytest.mark.parametrize("workload", ["fft", "rfft", "polymul",
                                      "polymul-real", "polymul-mod"])
@pytest.mark.parametrize("real", [False, True])
def test_pim_distributed_terms_are_the_reference(workload, real):
    """The PIM twin's distributed candidate: cycles, bytes and the compute
    term ``==`` the reference's; the link term is the same bytes over the
    card's ``LINK_BW`` instead of the TPU's."""
    n, d = 8192, 8
    assert tcost.pim_dist_infeasible(n, d) is None
    for batch in (1, 3, 8):
        got = tcost.pim_cost(workload, n, batch, tier="distributed",
                             n_devices=d, real=real)
        want = jcost.pim_cost(workload, n, batch, tier="distributed",
                              n_devices=d, real=real)
        for field in ("tier", "backend", "real", "exact", "seq_shards",
                      "pim_cycles", "collective_bytes", "t_compute_s"):
            assert getattr(got, field) == getattr(want, field), field
        assert got.t_collective_s * tcost.LINK_BW == pytest.approx(
            want.t_collective_s * jcost.LINK_BW, rel=1e-12)
        assert tcost._pim_units(workload, batch, real=real) == \
            jcost._pim_units(workload, batch, real=real)


def test_card_cost_of_the_distributed_tier(monkeypatch):
    """One card holds every shard: the whole call's on-chip work plus a
    copy in device memory of every shard's ledger bytes; one shard a card:
    a D-th of the work plus the ledger bytes over NVLink."""
    local = tcost.cuda_cost("polymul-real", 1 << 20, 16, real=True)
    coll = tcost._cuda_collective_bytes("polymul-real", 1 << 20, 16, 8,
                                        real=True)
    monkeypatch.setattr(tcost, "mesh_cards", lambda d: 1)
    shared = tcost.cuda_cost("polymul-real", 1 << 20, 16, tier="distributed",
                             n_devices=8, real=True)
    assert (shared.t_compute_s, shared.t_memory_s) == \
        (local.t_compute_s, local.t_memory_s)
    assert shared.collective_bytes == coll
    assert shared.t_collective_s == pytest.approx(8 * coll * 2
                                                  / tcost.HBM_BW)
    monkeypatch.setattr(tcost, "mesh_cards", lambda d: d)
    spread = tcost.cuda_cost("polymul-real", 1 << 20, 16,
                             tier="distributed", n_devices=8, real=True)
    assert spread.t_memory_s == pytest.approx(local.t_memory_s / 8)
    assert spread.t_collective_s == pytest.approx(coll / tcost.LINK_BW)
    assert spread.total_s == pytest.approx(
        max(spread.t_compute_s, spread.t_memory_s) + spread.t_collective_s)
    b = tcost.workload_cost("polymul-real", 4096, 8, n_devices=8)
    assert b["constants"]["link_bw"] == tcost.LINK_BW
    assert {(c["tier"], c["seq_shards"]) for c in b["candidates"]} == \
        {("local", 1), ("distributed", 8)}


@pytest.mark.parametrize("workload", ["fft", "rfft", "polymul",
                                      "polymul-real", "polymul-mod"])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_auto_plan_over_shards_is_the_reference(workload, d):
    """Auto mode with ``model_shards`` available and with the distributed
    tier forced: the reference's (tier, real, exact, seq_shards) for
    n <= 256K, the auto plan the legacy plan of its candidate, and an
    untileable shard count raises naming every prune as the reference's
    does."""
    for n in (64, 1024, 65536, 262144):
        for force in (False, True):
            want = jplanner.plan(n, 8, workload=workload, model_shards=d,
                                 force_distributed=force)
            got = tcore.plan(n, 8, workload=workload, model_shards=d,
                             force_distributed=force)
            assert (got.tier, got.real, got.exact, got.seq_shards) == \
                (want.tier, want.real, want.exact, want.seq_shards)
            legacy = tcore.plan(
                n, 8, exact=got.exact, real=got.real,
                product=workload in tcost.PRODUCTS,
                model_shards=got.seq_shards if got.tier == "distributed"
                else 1, force_distributed=got.tier == "distributed")
            assert got == legacy
    with pytest.raises(ValueError, match="every candidate was pruned") as e:
        tcore.plan(1 << 20, 4, workload=workload, model_shards=3,
                   force_distributed=True)
    assert "D^2 | n" in str(e.value)


def test_distributed_plan_describes_its_launches():
    got = tcore.plan(1 << 20, 16, real=True, product=True, model_shards=8,
                     force_distributed=True)
    # 8 shards x 2 transforms x (a launch over 8-point rows + the two
    # passes over 131072-point rows)
    assert got.launches == 8 * 2 * (1 + 2)
    assert got.describe() == (
        "four-step distributed real product (paired inverse) over 8 "
        "shards, radix-2 local FFT kernel calls (48 launches a call)")
    mod = tcore.plan(65536, 64, exact=True, model_shards=8,
                     force_distributed=True)
    assert mod.launches == 8 * 3 * (1 + 2)
    with pytest.raises(ValueError, match="shards limbs"):
        tcore.plan(4096, 4, exact=True, rns=True, model_shards=2,
                   force_distributed=True)
    with pytest.raises(ValueError, match="needs model_shards > 1"):
        tcore.plan(4096, 4, force_distributed=True)
    # past the kernels' on-chip ceiling the legacy plan shards by itself
    big = tcost.local_ceiling(True, True, False) * 2
    assert tcore.plan(big, 2, real=True, product=True,
                      model_shards=8).tier == "distributed"


@pytest.mark.parametrize("op", ["polymul-real", "polymul-mod"])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_engine_serves_the_distributed_route(op, shards):
    """The engine binds the distributed route and every result equals its
    oracle; polymul-mod's equal the local route's, ``==``."""
    eng = ServeEngine(max_batch=5, model_shards=shards, **CPU)
    bound = eng.register(op, 256)
    assert bound.route == f"{op}-distributed"
    assert bound.mesh.size == shards and bound.plan.seq_shards == shards
    rng = np.random.default_rng(shards)
    payloads = {eng.submit(op, 256, p): p
                for p in (bound.random_payload(rng) for _ in range(7))}
    eng.run(len(payloads))
    local = op_registry.get_op(op).bind(256, **CPU)
    for rid, p in payloads.items():
        bound.verify(p, eng.results[rid])
        if op == "polymul-mod":
            want = local.to_numpy(local.execute([p]))[0]
            assert (eng.results[rid] == want).all()


def test_rns_with_shards_keeps_the_reference_message():
    from repro.launch import ops as jops
    ctx = dict(modulus_bits=109, model_shards=2)
    with pytest.raises(jops.OpConfigError) as want:
        jops.get_op("polymul-mod").bind(256, jops.OpContext(**ctx))
    with pytest.raises(op_registry.OpConfigError) as got:
        op_registry.get_op("polymul-mod").bind(
            256, op_registry.OpContext(**ctx), **CPU)
    assert str(got.value) == str(want.value)


def test_auto_engine_binds_the_distributed_route_past_the_ceiling():
    """With shards available and the row past the real product's on-chip
    ceiling, auto mode prices every candidate and binds what it chose."""
    n = tcost.local_ceiling(True, True, False) * 2
    bound = op_registry.get_op("polymul-real").bind(
        n, op_registry.OpContext(model_shards=8, auto=True), batch=2, **CPU)
    best = bound.plan.cost["best"]
    assert (bound.plan.tier, bound.plan.real) == (best["tier"],
                                                  best["real"])
    assert bound.route == {("local", False): "polymul-real-complex",
                           ("distributed", True):
                               "polymul-real-distributed"}[
        bound.plan.tier, bound.plan.real]


def test_elastic_restart_halves_the_mesh_down_to_the_local_route(tmp_path):
    """elastic_restart(model_shards=D/2) re-binds the distributed routes
    on the halved mesh; at one shard the route is the local one. Each
    generation serves and every result is checked."""
    d = str(tmp_path / "snap")
    eng = ServeEngine(max_batch=4, model_shards=8, **CPU)
    for op in ("polymul-real", "polymul-mod"):
        eng.register(op, 256)
    rng = np.random.default_rng(5)
    shards = 8
    while True:
        payloads = {}
        for op in ("polymul-real", "polymul-mod"):
            bound = eng.bound(op, 256)
            if shards > 1:
                assert bound.route == f"{op}-distributed"
                assert bound.mesh.size == shards
            else:
                assert bound.mesh is None and bound.plan.tier == "local"
            for _ in range(3):
                p = bound.random_payload(rng)
                payloads[eng.submit(op, 256, p)] = (bound, p)
        eng.run(len(payloads))
        for rid, (bound, p) in payloads.items():
            bound.verify(p, eng.results[rid])
        if shards == 1:
            break
        shards //= 2
        eng = eng.elastic_restart(d, model_shards=shards)
        assert eng.ctx.model_shards == shards
    assert eng.bound("polymul-real", 256).route == "polymul-real-packed"
    assert eng.bound("polymul-mod", 256).route == "polymul-mod-single"
    assert eng.restarts == 3


def test_cli_engine_elastic_resize_8_to_4(tmp_path):
    """--elastic at --model-shards 8 on the distributed route, in a
    subprocess with its own time limit: 300 ms stragglers trip the
    watchdog, the CLI drains, snapshots and warm-restarts at 4 shards, and
    the second generation serves the rest on the halved mesh."""
    d = str(tmp_path / "snap")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--service",
         "engine", "--ops", "polymul-real", "--ns", "64", "--requests", "48",
         "--batch", "4", "--max-pending", "8", "--model-shards", "8",
         "--snapshot-dir", d, "--elastic", "--watchdog-threshold", "5",
         "--watchdog-evict-after", "3", "--watchdog-warmup", "5",
         "--inject-straggler-ms", "300", "--inject-straggler-after", "7",
         "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout
    assert "watchdog evicted batch" in out, out
    assert "elastic restart: model_shards 8 -> 4" in out, out
    assert "route=polymul-real-distributed" in out, out
    eng = ServeEngine.from_snapshot(d, **CPU)
    assert eng._prev_served == 48
    assert eng.ctx.model_shards <= 4
    assert ckpt_lib.latest_step(d) == 48


def test_cli_serves_the_distributed_routes_checked(capsys):
    """The acceptance run: 16 requests a route at --model-shards 8, every
    result checked against the numpy oracle."""
    for op in ("polymul-real", "polymul-mod"):
        stats = serve.main(["--service", "fft", "--op", op, "--n", "1024",
                            "--batch", "4", "--requests", "16",
                            "--model-shards", "8", "--device", "cpu"])
        assert stats["served"] == 16
        out = capsys.readouterr().out
        assert f"route={op}-distributed" in out
        assert "served=16 verified=16" in out
