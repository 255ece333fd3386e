"""The port's fault-tolerance package (``repro_torch.ft``) and the cost
model's verified pricing, on the CPU, against the reference's
(``repro.ft``, ``repro.core.cost``).

``ft/abft.py`` and ``ft/watchdog.py`` are copies: every check's verdict on
the same seeded clean and corrupted batches, every check's cycle count and
its charged counters, and the watchdog's config and state are ``==``.
``ft/checkpoint.py`` writes the reference's format without jax: each side
restores what the other saved (the reference's reader is used only here).
Verified pricing: the PIM terms ``==`` the reference's field by field; the
card's term is the reference's formula on the port's rates, within 1e-12
as ``tests/test_torch_cost.py`` holds the unverified roofline.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core import cost as jcost
from repro.core.fft import planner as jplanner
from repro.core.ntt import NTTParams as JNTTParams
from repro.core.ntt import RNSParams as JRNSParams
from repro.ft import abft as jabft
from repro.ft import checkpoint as jckpt
from repro.ft import watchdog as jwatchdog
from repro_torch.core import cost as tcost
from repro_torch.core import fft as tcore
from repro_torch.core.ntt import NTTParams, RNSParams
from repro_torch.core.pim import FOURIERPIM_8, FP32, INT32
from repro_torch.core.pim.crossbar import CrossbarSim
from repro_torch.ft import abft
from repro_torch.ft import checkpoint as ckpt_lib
from repro_torch.ft.watchdog import StepWatchdog, WatchdogConfig

WORKLOADS = tcost.WORKLOADS
REL = 1e-12


def _verdict(v) -> dict:
    return dataclasses.asdict(v)


# ---------------------------------------------------------------------------
# ft/abft.py == the reference's
# ---------------------------------------------------------------------------

def test_check_tables_equal_reference():
    assert abft.CHECKS == jabft.CHECKS
    assert abft.FLOAT_TOL == jabft.FLOAT_TOL
    assert [f.name for f in dataclasses.fields(abft.IntegrityVerdict)] == \
        [f.name for f in dataclasses.fields(jabft.IntegrityVerdict)]


def _float_batches(rng, n: int, rows: int):
    """Clean rows of every float check, and one corrupted copy of each."""
    x = (rng.standard_normal((rows, n))
         + 1j * rng.standard_normal((rows, n))).astype(np.complex64)
    xr = rng.standard_normal((rows, n)).astype(np.float32)
    a = rng.standard_normal((rows, n)) + 1j * rng.standard_normal((rows, n))
    b = rng.standard_normal((rows, n)) + 1j * rng.standard_normal((rows, n))
    return {
        "check_fft": ((x,), np.fft.fft(x).astype(np.complex64)),
        "check_rfft": ((xr,), np.fft.rfft(xr).astype(np.complex64)),
        "check_polymul": ((a, b), np.fft.ifft(np.fft.fft(a)
                                              * np.fft.fft(b))),
        "check_polymul_real": ((a.real, b.real), np.fft.irfft(
            np.fft.rfft(a.real) * np.fft.rfft(b.real), n)),
    }


@pytest.mark.parametrize("name", ["check_fft", "check_rfft", "check_polymul",
                                  "check_polymul_real"])
@pytest.mark.parametrize("n", [16, 128, 1024])
def test_float_check_verdicts_equal_reference(name, n, rng):
    """Clean, one-element-corrupted (every row in turn) and tolerance-moved
    batches: the same verdict, residual, failed rows and detail."""
    operands, out = _float_batches(rng, n, 5)[name]
    cases = [out]
    for r in range(out.shape[0]):
        bad = out.copy()
        bad[r, (7 * r) % out.shape[1]] += 50.0 * (r + 1)
        cases.append(bad)
    for rows in cases:
        want = getattr(jabft, name)(*operands, rows)
        got = getattr(abft, name)(*operands, rows)
        assert _verdict(got) == _verdict(want)
        tight = getattr(abft, name)(*operands, rows, tol=1e-9)
        assert _verdict(tight) == _verdict(
            getattr(jabft, name)(*operands, rows, tol=1e-9))
    # a single row (1-D) is checked as one batch row
    one = getattr(abft, name)(*(o[0] for o in operands), out[0])
    assert _verdict(one) == _verdict(
        getattr(jabft, name)(*(o[0] for o in operands), out[0]))


@pytest.mark.parametrize("n", [16, 64, 1024])
def test_polymul_mod_verdicts_equal_reference(n, rng):
    """The exact eval-at-psi check on the same residues: clean, and every
    coefficient of a row corrupted by one."""
    params, jparams = NTTParams.make(n), JNTTParams.make(n)
    assert (params.q, params.psi) == (jparams.q, jparams.psi)
    from repro_torch.core.ntt import negacyclic_polymul
    a = rng.integers(0, params.q, (4, n)).astype(np.uint32)
    b = rng.integers(0, params.q, (4, n)).astype(np.uint32)
    r = negacyclic_polymul(a, b, params)
    assert abft.check_polymul_mod(a, b, r, params).ok
    bad = np.tile(r[0], (n, 1))
    idx = np.arange(n)
    bad[idx, idx] = (bad[idx, idx] + 1) % params.q
    aa, bb = np.tile(a[0], (n, 1)), np.tile(b[0], (n, 1))
    for rows, (x, y) in ((r, (a, b)), (bad, (aa, bb))):
        got = abft.check_polymul_mod(x, y, rows, params)
        want = jabft.check_polymul_mod(x, y, rows, jparams)
        assert _verdict(got) == _verdict(want)
    assert abft.check_polymul_mod(aa, bb, bad, params).failed_rows == \
        tuple(range(n))


@pytest.mark.parametrize("bits", [60, 109])
def test_polymul_rns_verdicts_and_factors_equal_reference(bits, rng):
    n = 64
    rns, jrns = RNSParams.make(n, modulus_bits=bits), \
        JRNSParams.make(n, modulus_bits=bits)
    assert [p.q for p in abft.check_limbs_for(rns)] == \
        [p.q for p in jabft.check_limbs_for(jrns)]
    from repro_torch.core.ntt import random_poly, rns_polymul_reference
    Q = rns.modulus
    a = np.stack([random_poly(rng, n, Q) for _ in range(3)])
    b = np.stack([random_poly(rng, n, Q) for _ in range(3)])
    r = np.stack([rns_polymul_reference(a[i], b[i], rns) for i in range(3)])
    bad = r.copy()
    bad[1, 17] = (bad[1, 17] + 1) % Q
    for rows in (r, bad):
        assert _verdict(abft.check_polymul_rns(a, b, rows, rns)) == \
            _verdict(jabft.check_polymul_rns(a, b, rows, jrns))
    assert abft.check_polymul_rns(a, b, bad, rns).failed_rows == (1,)


def test_unsupported_rns_modulus_raises_as_the_reference():
    rns = RNSParams.make(64, modulus=(1 << 61) - 1)
    jrns = JRNSParams.make(64, modulus=(1 << 61) - 1)
    with pytest.raises(jabft.ABFTUnsupportedModulus) as want:
        jabft.check_limbs_for(jrns)
    with pytest.raises(abft.ABFTUnsupportedModulus) as got:
        abft.check_limbs_for(rns)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("workload", sorted(abft.CHECKS))
@pytest.mark.parametrize("n", [1024, 4096])
def test_check_cycles_and_charge_parity_equal_reference(workload, n):
    """One schedule, both views: the closed form == the reference's ==
    the port's sim charged with ``charge_check`` == the reference's sim
    charged with its own, counter for counter."""
    from repro.core.pim import FOURIERPIM_8 as JCFG
    from repro.core.pim import FP32 as JFP32
    from repro.core.pim import INT32 as JINT32
    from repro.core.pim.crossbar import CrossbarSim as JCrossbarSim
    exact = workload == "polymul-mod"
    spec, jspec = (INT32, JINT32) if exact else (FP32, JFP32)
    assert abft._schedule(workload, n, FOURIERPIM_8) == \
        jabft._schedule(workload, n, JCFG)
    closed = abft.check_cycles(workload, n, FOURIERPIM_8, spec)
    assert closed == jabft.check_cycles(workload, n, JCFG, jspec)
    sim, jsim = CrossbarSim(FOURIERPIM_8, spec), JCrossbarSim(JCFG, jspec)
    abft.charge_check(sim, workload, n)
    jabft.charge_check(jsim, workload, n)
    assert sim.ctr.cycles == closed
    assert dataclasses.asdict(sim.ctr) == dataclasses.asdict(jsim.ctr)
    assert tcost.abft_check_cycles(workload, n) == \
        jcost.abft_check_cycles(workload, n) == closed


def test_check_schedule_refuses_as_the_reference():
    with pytest.raises(ValueError, match="unknown workload"):
        jabft._schedule("dct", 64, FOURIERPIM_8)
    with pytest.raises(ValueError, match="unknown workload"):
        abft._schedule("dct", 64, FOURIERPIM_8)


# ---------------------------------------------------------------------------
# ft/watchdog.py == the reference's
# ---------------------------------------------------------------------------

def test_watchdog_config_equals_reference_and_is_not_shared():
    assert dataclasses.asdict(WatchdogConfig()) == \
        dataclasses.asdict(jwatchdog.WatchdogConfig())
    a, b = StepWatchdog(), StepWatchdog()
    assert a.cfg is not b.cfg
    a.cfg.threshold = 99.0
    assert b.cfg.threshold == WatchdogConfig().threshold
    cfg = WatchdogConfig(threshold=1.5)
    assert StepWatchdog(cfg).cfg is cfg


@pytest.mark.parametrize("dts", [
    [0.1, 0.1, 0.1, 0.9, 0.9, 0.1, 0.9, 0.9, 0.9, 0.2],
    [0.05] * 3 + [0.5] * 7,
    [0.2, 0.1, 0.3, 0.1, 0.1, 0.1],
])
def test_watchdog_flags_evictions_and_state_equal_reference(dts):
    kw = dict(warmup_steps=2, threshold=2.0, evict_after=2)
    got_ev, want_ev = [], []
    wd = StepWatchdog(WatchdogConfig(**kw), on_evict=got_ev.append)
    jwd = jwatchdog.StepWatchdog(jwatchdog.WatchdogConfig(**kw),
                                 on_evict=want_ev.append)
    flags = [wd.observe(i, dt) for i, dt in enumerate(dts)]
    assert flags == [jwd.observe(i, dt) for i, dt in enumerate(dts)]
    assert got_ev == want_ev
    state = wd.state_dict()
    assert state == jwd.state_dict()
    assert json.loads(json.dumps(state)) == state
    restored = StepWatchdog(WatchdogConfig(**kw))
    restored.load_state_dict(state)
    assert restored.state_dict() == state
    # the restored baseline flags a slow step at once, without re-warming
    if restored.ewma is not None and restored.seen > kw["warmup_steps"]:
        assert restored.observe(len(dts), 100 * restored.ewma) is True


def test_watchdog_timed_steps():
    wd = StepWatchdog(WatchdogConfig(warmup_steps=1))
    wd.start_step()
    assert wd.end_step(0) is False and wd.seen == 1
    with pytest.raises(AssertionError, match="start_step"):
        wd.end_step(1)


# ---------------------------------------------------------------------------
# Verified pricing: the cost model and the planner
# ---------------------------------------------------------------------------

def _by_key(breakdown):
    return {(c["tier"], c["real"]): c for c in breakdown["candidates"]}


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("n", [64, 1024, 4096, 65536])
def test_verified_workload_cost_equals_reference(workload, n):
    """``workload_cost(..., verified=True)``: the PIM backend of every
    candidate == the reference's field by field, and the card's term is
    the reference's verified formula on the port's rates."""
    for batch in (1, 8, 64):
        got = tcost.workload_cost(workload, n, batch, verified=True)
        want = jcost.workload_cost(workload, n, batch, verified=True,
                                   tiers=("local",))
        g, w = _by_key(got), _by_key(want)
        assert set(g) == set(w)
        for k, cw in w.items():
            assert g[k]["backends"]["pim"] == cw["backends"]["pim"]
            real = k[1]
            flops, nbytes = jcost._xla_local_terms(workload, n, batch,
                                                   real=real)
            ops = {"fft": 2, "rfft": 2}.get(workload, 3)
            flops += batch * ops * 4.0 * n
            nbytes += batch * n * 8
            peak = (tcost.PEAK_INT_OPS if workload == "polymul-mod"
                    else tcost.PEAK_FLOPS)
            card = g[k]["backends"]["cuda"]
            assert abs(card["t_compute_s"] - flops / peak) <= \
                REL * flops / peak
            assert abs(card["t_memory_s"] - nbytes / tcost.HBM_BW) <= \
                REL * nbytes / tcost.HBM_BW


@pytest.mark.parametrize("workload", WORKLOADS)
def test_verified_pricing_adds_exactly_the_check(workload):
    n, batch = 1024, 8
    base = _by_key(tcost.workload_cost(workload, n, batch))
    ver = _by_key(tcost.workload_cost(workload, n, batch, verified=True))
    assert set(base) == set(ver)
    for k, cb in base.items():
        pb, pv = cb["backends"]["pim"], ver[k]["backends"]["pim"]
        wl = tcost._pim_workload(workload, k[1])
        assert pv["pim_cycles"] - pb["pim_cycles"] == \
            tcost.abft_check_cycles(wl, n)
        assert pv["total_s"] > pb["total_s"]
        assert ver[k]["backends"]["cuda"]["t_compute_s"] > \
            cb["backends"]["cuda"]["t_compute_s"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_planner_verified_and_pim_ok_pass_through_as_the_reference(workload):
    """``plan(..., verified=True)`` plans the reference's candidate, its
    breakdown priced with the check; with ``pim_ok=False`` every candidate
    is quarantined to the card; the legacy plan ignores both."""
    for n in (1024, 65536):
        got = tcore.plan(n, 64, workload=workload, verified=True)
        want = jplanner.plan(n, 64, workload=workload, verified=True)
        assert (got.tier, got.real, got.exact) == \
            (want.tier, want.real, want.exact)
        assert got.cost == tcost.workload_cost(workload, n, 64,
                                               verified=True)
        off = tcore.plan(n, 64, workload=workload, verified=True,
                         pim_ok=False)
        for cand in off.cost["candidates"]:
            assert cand["backend_best"] == "cuda"
            assert "quarantined" in cand["backends"]["pim"]["infeasible"]
    assert tcore.plan(1024, 8, verified=True, pim_ok=False) == \
        tcore.plan(1024, 8)


# ---------------------------------------------------------------------------
# ft/checkpoint.py: the reference's format and guarantees, without jax
# ---------------------------------------------------------------------------

def test_checkpoint_refuses_truncated_manifest(tmp_path):
    d = str(tmp_path / "ck")
    ckpt_lib.save(d, 3, {"w": np.arange(4.0)}, extra={"k": 1})
    man = os.path.join(d, "step_3", "manifest.json")
    with open(man, "rb") as f:
        raw = f.read()
    with open(man, "wb") as f:
        f.write(raw[:len(raw) // 2])        # torn write
    with pytest.raises(ckpt_lib.CheckpointCorruptError, match="truncated"):
        ckpt_lib.read_manifest(d, 3)
    with pytest.raises(ckpt_lib.CheckpointCorruptError):
        ckpt_lib.restore(d, 3, {"w": np.zeros(4)})


def test_checkpoint_refuses_partial_manifest(tmp_path):
    d = str(tmp_path / "ck")
    ckpt_lib.save(d, 1, {"w": np.arange(4.0)})
    man = os.path.join(d, "step_1", "manifest.json")
    with open(man, "w") as f:
        json.dump({"extra": {}}, f)         # parses, but missing keys
    with pytest.raises(ckpt_lib.CheckpointCorruptError, match="missing"):
        ckpt_lib.read_manifest(d, 1)


def test_checkpoint_save_publishes_manifest_last_and_clean(tmp_path,
                                                            monkeypatch):
    """Every file lands by its rename, the manifest's last: the order of
    the renames is the arrays, then the manifest, then the step."""
    d = str(tmp_path / "ck")
    renames = []
    real_replace = os.replace

    def spy(src, dst):
        renames.append(os.path.basename(dst))
        return real_replace(src, dst)

    monkeypatch.setattr(ckpt_lib.os, "replace", spy)
    path = ckpt_lib.save(d, 2, {"w": np.arange(8.0)}, extra={"s": "x"})
    assert renames == ["arrays.npz", "manifest.json", "step_2"]
    assert not [f for f in os.listdir(path) if f.endswith(".part")]
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
    man = ckpt_lib.read_manifest(d, 2)
    assert man["step"] == 2 and man["extra"] == {"s": "x"}
    _, tree = ckpt_lib.restore_latest(d, {"w": np.zeros(8)})
    np.testing.assert_array_equal(tree["w"], np.arange(8.0))


def test_checkpoint_resave_overwrites(tmp_path):
    d = str(tmp_path)
    ckpt_lib.save(d, 5, {"w": torch.zeros(3)}, extra={"gen": 1})
    ckpt_lib.save(d, 5, {"w": torch.full((3,), 7.0)}, extra={"gen": 2})
    _, restored = ckpt_lib.restore_latest(d, {"w": torch.zeros(3)})
    assert torch.equal(restored["w"], torch.full((3,), 7.0))
    assert ckpt_lib.read_extra(d, 5) == {"gen": 2}
    assert [n for n in os.listdir(d) if n.endswith(".tmp")] == []
    assert ckpt_lib.all_steps(d) == [5]


def test_checkpoint_retention_and_tmp_gc(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step_9.tmp"))      # a crashed save
    for step in range(1, 6):
        ckpt_lib.save(d, step, {"w": np.full(2, step)}, keep=2)
    assert ckpt_lib.all_steps(d) == [4, 5]
    assert ckpt_lib.latest_step(d) == 5
    assert sorted(os.listdir(d)) == ["step_4", "step_5"]
    assert ckpt_lib.restore_latest(str(tmp_path / "none"), {"w": 1}) == \
        (None, {"w": 1})


def test_restore_missing_key_names_the_hazard(tmp_path):
    d = str(tmp_path)
    ckpt_lib.save(d, 1, {"params": torch.ones(2)})
    with pytest.raises(KeyError, match="grad_err"):
        ckpt_lib.restore(d, 1, {"params": torch.ones(2),
                                "grad_err": torch.zeros(2)})


def _tree(gen: torch.Generator):
    return {"params": {"w": torch.randn(4, 3, generator=gen),
                       "b": torch.randn(3, generator=gen).double()},
            "steps": [torch.arange(5, dtype=torch.int32),
                      (np.arange(3, dtype=np.uint32), None)],
            "lat": np.linspace(0, 1, 7)}


def test_restore_keeps_like_structure_dtype_and_device(tmp_path):
    """A tensor leaf comes back as a tensor of ``like``'s dtype on its
    device, a numpy leaf as an array of its dtype; tuples stay tuples and
    ``None`` holds no leaf. Keys are the reference's: sorted dict keys and
    indices joined by '/'."""
    d = str(tmp_path)
    tree = _tree(torch.Generator().manual_seed(0))
    ckpt_lib.save(d, 4, tree)
    keys = [e["key"] for e in ckpt_lib.read_manifest(d, 4)["arrays"]]
    assert keys == ["lat", "params/b", "params/w", "steps/0", "steps/1/0"]
    like = {"params": {"w": torch.zeros(4, 3, dtype=torch.float64),
                       "b": torch.zeros(3)},
            "steps": [torch.zeros(5, dtype=torch.int64),
                      (np.zeros(3, np.int64), None)],
            "lat": np.zeros(7, np.float32)}
    got = ckpt_lib.restore(d, 4, like)
    assert got["params"]["w"].dtype == torch.float64
    assert got["params"]["b"].dtype == torch.float32
    assert torch.equal(got["params"]["w"], tree["params"]["w"].double())
    assert torch.equal(got["steps"][0], torch.arange(5))
    assert isinstance(got["steps"][1], tuple) and got["steps"][1][1] is None
    assert got["steps"][1][0].dtype == np.int64
    assert got["lat"].dtype == np.float32
    assert all(t.device.type == "cpu" for t in
               (got["params"]["w"], got["steps"][0]))


def test_bf16_leaf_names_its_roadmap_item(tmp_path):
    """Item 11f (training checkpoints) stores a bf16 leaf as its uint16
    bits with dtype "bfloat16" in the manifest: it comes back bit for bit,
    and an fp32 leaf restores into a bf16 one by a cast."""
    d = str(tmp_path)
    w = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    ckpt_lib.save(d, 1, {"w": w})
    assert [e["dtype"] for e in ckpt_lib.read_manifest(d, 1)["arrays"]] \
        == ["bfloat16"]
    got = ckpt_lib.restore(d, 1, {"w": torch.zeros(3, 5,
                                                   dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))
    ckpt_lib.save(d, 2, {"w": np.full(2, 1.5, np.float32)})
    got = ckpt_lib.restore(d, 2, {"w": torch.zeros(2, dtype=torch.bfloat16)})
    assert torch.equal(got["w"], torch.full((2,), 1.5, dtype=torch.bfloat16))


def test_checkpoint_cross_reads_with_the_reference(tmp_path):
    """Same format both ways: a tree the port saves restores under the
    reference's reader, and one the reference saves restores under the
    port's, with the manifests' keys, shapes and dtypes equal."""
    tree = _tree(torch.Generator().manual_seed(1))
    numpy_tree = ckpt_lib._unflatten(tree, {
        k: ckpt_lib._to_numpy(k, v)
        for k, v in ckpt_lib._flatten_with_paths(tree)})
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt_lib.save(port_dir, 7, tree, extra={"who": "port"})
    jckpt.save(ref_dir, 7, numpy_tree, extra={"who": "ref"})
    assert ckpt_lib.read_manifest(port_dir, 7)["arrays"] == \
        jckpt.read_manifest(ref_dir, 7)["arrays"]
    like = ckpt_lib._unflatten(numpy_tree, {
        k: np.zeros_like(v)
        for k, v in ckpt_lib._flatten_with_paths(numpy_tree)})
    flat_want = dict(ckpt_lib._flatten_with_paths(numpy_tree))
    from_port = jckpt.restore(port_dir, 7, like)
    assert jckpt.read_extra(port_dir, 7) == {"who": "port"}
    from_ref = ckpt_lib.restore(ref_dir, 7, tree)
    assert ckpt_lib.read_extra(ref_dir, 7) == {"who": "ref"}
    for key, leaf in ckpt_lib._flatten_with_paths(from_ref):
        assert torch.is_tensor(leaf) == torch.is_tensor(
            dict(ckpt_lib._flatten_with_paths(tree))[key])
        np.testing.assert_array_equal(ckpt_lib._to_numpy(key, leaf),
                                      flat_want[key])
    # the reference hands back jax arrays (float64 as float32 without x64)
    got = jckpt._flatten_with_paths(from_port)[0]
    assert [k for k, _ in got] == sorted(flat_want)
    for key, leaf in got:
        leaf = np.asarray(leaf)
        np.testing.assert_array_equal(leaf,
                                      flat_want[key].astype(leaf.dtype))
