"""The port's verified serve engine under injected faults, its deadlines,
drain, snapshot and warm restart, on the CPU (``repro_torch.launch``),
held against the reference's (``repro.launch``) where both run.

The pin: under seeded stuck-at / bit-flip / dead-array injection, a
mixed-op engine run serves EVERY request with a result that matches the
fault-free oracle -- corruption is always detected by the ABFT gate,
recovery is bounded (retry cap, then the circuit breaker re-binds the
bucket with the PIM backend off the table and quarantines the array), and
no corrupted batch is delivered. The replay test runs the reference engine
and the port's on the same fault seed, requests and batches: the
integrity ledgers and quarantined arrays are equal, and the results agree
within the ops' tolerances (fft/rfft rtol 1e-4, atol 1e-4 sqrt(n);
products rtol 1e-3, atol 1e-4 n; ``polymul-mod`` bit for bit).
"""
import os
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

from repro.core.pim import FaultModel as JFaultModel
from repro.launch import serve as jserve
from repro.launch.engine import ServeEngine as JServeEngine
from repro_torch.core.pim import FaultModel
from repro_torch.ft import abft
from repro_torch.ft import checkpoint as ckpt_lib
from repro_torch.ft.watchdog import WatchdogConfig
from repro_torch.launch import ops as op_registry
from repro_torch.launch import serve
from repro_torch.launch.engine import (LATENCY_WINDOW, EngineStopped,
                                       ServeEngine)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 128
CPU = dict(device="cpu")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    return env


def _cx(rng, n=64):
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64)


def _chaos_model(**kw):
    defaults = dict(seed=1, stuck_per_array=1, n_arrays=4, spares=4)
    defaults.update(kw)
    return FaultModel(**defaults)


def _run_verified(engine, combos, rng, per_bucket=6):
    """Submit per_bucket requests to each (op, n), run, and oracle-verify
    EVERY delivered result."""
    kept = {}
    already = engine._served
    for op, n in combos:
        bound = engine.register(op, n)
        for _ in range(per_bucket):
            payload = bound.random_payload(rng)
            kept[engine.submit(op, n, payload)] = (op, n, payload)
    stats = engine.run(already + len(kept))
    for rid, (op, n, payload) in kept.items():
        engine.bound(op, n).verify(payload, engine.results[rid])
    return stats


# ---------------------------------------------------------------------------
# Chaos: mixed ops, permanent faults, every result correct
# ---------------------------------------------------------------------------

def test_chaos_mixed_ops_all_results_match_oracles(rng):
    """fft + polymul-real + polymul-mod (RNS) under permanent stuck-cell
    faults on every array: detection -> bounded retries -> breaker ->
    clean re-execution; every delivered result matches its oracle."""
    fm = _chaos_model(bitflip_per_gate=1e-4)
    engine = ServeEngine(max_batch=4, auto=True, modulus_bits=60,
                         verified=True, fault_model=fm,
                         collect_timeout_s=0.01, **CPU)
    combos = [("fft", N), ("polymul-real", N), ("polymul-mod", N)]
    assert engine.bound("polymul-mod", N).rns is not None
    stats = _run_verified(engine, combos, rng)
    total = {k: sum(b["integrity"][k] for b in stats["buckets"].values())
             for k in ("checked", "corrupted", "retried", "fell_back")}
    assert total["corrupted"] >= len(combos)
    assert total["retried"] >= len(combos)
    assert total["fell_back"] == len(combos)
    for key, b in stats["buckets"].items():
        assert b["integrity"]["breaker_open"], key
    assert len(fm.quarantined) == len(combos)


def test_chaos_single_limb_mod(rng):
    fm = _chaos_model()
    engine = ServeEngine(max_batch=4, auto=True, verified=True,
                         fault_model=fm, collect_timeout_s=0.01, **CPU)
    assert engine.bound("polymul-mod", N).rns is None
    stats = _run_verified(engine, [("polymul-mod", N)], rng)
    b = stats["buckets"][f"polymul-mod/n={N}"]["integrity"]
    assert b["corrupted"] >= 1 and b["fell_back"] == 1 and b["breaker_open"]


def test_permanent_fault_pins_breaker_to_the_card(rng):
    """A dead array: after the breaker the bucket's re-bound plan has the
    PIM backend marked infeasible by the quarantine, so the fallback is
    pinned to the card, and the breaker stays open."""
    fm = FaultModel(seed=5, dead_arrays=(0,), n_arrays=2, spares=1)
    engine = ServeEngine(max_batch=4, auto=True, verified=True,
                         fault_model=fm, collect_timeout_s=0.01, **CPU)
    _run_verified(engine, [("fft", N)], rng, per_bucket=4)
    assert fm.is_quarantined(0)
    best = engine.bound("fft", N).plan.cost["best"]
    assert best["backend_best"] == "cuda"
    assert "quarantined" in best["backends"]["pim"]["infeasible"]
    stats = _run_verified(engine, [("fft", N)], rng, per_bucket=3)
    b = stats["buckets"][f"fft/n={N}"]["integrity"]
    assert b["breaker_open"] and b["fell_back"] == 1


def test_spares_exhausted_still_isolates_the_bucket(rng):
    """More faulty buckets than spares: the breaker re-binds the bucket
    anyway, and every result is still correct."""
    fm = FaultModel(seed=2, dead_arrays=(0, 1), n_arrays=2, spares=1)
    engine = ServeEngine(max_batch=4, verified=True, fault_model=fm,
                         collect_timeout_s=0.01, **CPU)
    stats = _run_verified(engine, [("fft", 64), ("rfft", 64)], rng,
                          per_bucket=4)
    assert len(fm.quarantined) == 1
    assert all(b["integrity"]["breaker_open"]
               for b in stats["buckets"].values())


def test_fault_model_requires_verified():
    with pytest.raises(ValueError, match="verified"):
        ServeEngine(fault_model=_chaos_model(), **CPU)


def test_clean_verified_run_counts_checks_only(rng):
    engine = ServeEngine(max_batch=4, auto=True, verified=True,
                         collect_timeout_s=0.01, **CPU)
    combos = [(op, N) for op in op_registry.op_names()]
    stats = _run_verified(engine, combos, rng)
    for b in stats["buckets"].values():
        integ = b["integrity"]
        assert integ["checked"] == b["batches"] >= 1
        assert integ["corrupted"] == integ["retried"] == 0
        assert integ["fell_back"] == 0 and not integ["breaker_open"]


def test_unverified_stats_report_zero_integrity(rng):
    engine = ServeEngine(max_batch=4, auto=True, collect_timeout_s=0.01,
                         **CPU)
    stats = _run_verified(engine, [("fft", N)], rng, per_bucket=2)
    assert stats["buckets"][f"fft/n={N}"]["integrity"] == {
        "checked": 0, "corrupted": 0, "retried": 0, "fell_back": 0,
        "breaker_open": False}


def test_verified_survives_snapshot_roundtrip(tmp_path, rng):
    d = str(tmp_path / "snap")
    engine = ServeEngine(max_batch=4, auto=True, verified=True,
                         collect_timeout_s=0.01, **CPU)
    _run_verified(engine, [("fft", N)], rng, per_bucket=2)
    engine.snapshot(d)
    restored = ServeEngine.from_snapshot(d, **CPU)
    assert restored.verified and restored.ctx.verified


def test_integrity_checks_the_delivered_rows(rng):
    """``BoundOp.integrity`` runs on the rows after the host step: for the
    RNS route the CRT's mod-Q big ints, which one corrupted coefficient
    fails; narrow keeps ``verified``."""
    ctx = op_registry.OpContext(modulus_bits=109, verified=True)
    assert op_registry.get_op("fft").narrow(ctx).verified
    bound = op_registry.get_op("polymul-mod").bind(64, ctx, **CPU)
    payloads = [bound.random_payload(rng) for _ in range(3)]
    rows = bound.to_numpy(bound.execute(payloads))
    assert rows.dtype == object
    assert bound.integrity(payloads, rows).ok
    rows[2, 5] += 1
    assert bound.integrity(payloads, rows).failed_rows == (2,)


def test_verified_rns_bind_refuses_an_uncheckable_modulus(monkeypatch):
    def refuse(rns):
        raise abft.ABFTUnsupportedModulus("no factor")
    monkeypatch.setattr(abft, "check_limbs_for", refuse)
    spec = op_registry.get_op("polymul-mod")
    with pytest.raises(op_registry.OpConfigError, match="verified"):
        spec.bind(64, op_registry.OpContext(modulus_bits=60,
                                            verified=True), **CPU)
    spec.bind(64, op_registry.OpContext(modulus_bits=60), **CPU)


# ---------------------------------------------------------------------------
# Replay against the reference engine
# ---------------------------------------------------------------------------

def _replay(Engine, Model, combos, seed, rate, stuck, per_bucket, *,
            warm=False, **kw):
    fm = Model(seed=seed, bitflip_per_gate=rate, stuck_per_array=stuck,
               n_arrays=4, spares=4)
    engine = Engine(max_batch=4, verified=True, fault_model=fm,
                    collect_timeout_s=0.01, **kw)
    rng = np.random.default_rng(seed)
    kept = {}
    for op, n in combos:
        engine.register(op, n)
    if warm:
        engine.warmup()
    for i in range(per_bucket * len(combos)):
        op, n = combos[i % len(combos)]
        payload = engine.bound(op, n).random_payload(rng)
        kept[engine.submit(op, n, payload)] = (op, n, payload)
    stats = engine.run(len(kept))
    ledger = {k: b["integrity"] for k, b in stats["buckets"].items()}
    sizes = {k: b["batch_sizes"] for k, b in stats["buckets"].items()}
    return engine, fm, kept, ledger, sizes


REPLAY_CASES = pytest.mark.parametrize("combos,seed,rate,stuck,kw", [
    ([(op, 64) for op in ("fft", "rfft", "polymul", "polymul-real",
                          "polymul-mod")], 2, 1e-3, 0, {}),
    ([("fft", 128)], 5, 0.0, 1, {}),
    ([("polymul-mod", 64)], 7, 2e-3, 0, {"modulus_bits": 60}),
    ([("polymul-mod", 64), ("rfft", 64)], 4, 1e-3, 1,
     {"modulus_bits": 109}),
], ids=["five-ops-transient", "stuck-one-bucket", "rns-transient",
        "rns-stuck"])


@REPLAY_CASES
def test_replay_equals_the_reference_engine(combos, seed, rate, stuck, kw):
    """Every request submitted before ``run``, so both engines form the
    same batches: the same fault seed gives the same per-bucket ledger and
    quarantined arrays (a batch launched behind a tripped breaker's is
    detected and retried in both), and every delivered result agrees with
    the reference's and with its oracle."""
    _assert_replays_equal(combos, seed, rate, stuck, kw)


@REPLAY_CASES
def test_warmed_replay_equals_the_reference_engine(combos, seed, rate, stuck,
                                                   kw):
    """Both engines warmed up before the replay, as the serve CLI warms
    its engine: the reference's warmup runs each bucket once through its
    injector, and the port's throws one draw away for it, so the served
    batches draw the same executions' faults and the ledgers, quarantined
    arrays and results are equal."""
    _assert_replays_equal(combos, seed, rate, stuck, kw, warm=True)


def _assert_replays_equal(combos, seed, rate, stuck, kw, warm=False):
    jeng, jfm, jkept, jledger, jsizes = _replay(
        JServeEngine, JFaultModel, combos, seed, rate, stuck, 10, warm=warm,
        **kw)
    teng, tfm, tkept, tledger, tsizes = _replay(
        ServeEngine, FaultModel, combos, seed, rate, stuck, 10, warm=warm,
        **kw, **CPU)
    assert tsizes == jsizes
    assert tledger == jledger
    assert sum(v["corrupted"] for v in tledger.values()) >= 1
    assert tfm.quarantined == jfm.quarantined
    assert set(tkept) == set(jkept)
    for rid, (op, n, payload) in tkept.items():
        got, want = teng.results[rid], jeng.results[rid]
        teng.bound(op, n).verify(payload, got)
        if op == "polymul-mod":
            assert (got == want).all(), rid
        else:
            tol = (dict(rtol=1e-3, atol=1e-4 * n) if op.startswith("polymul")
                   else dict(rtol=1e-4, atol=1e-4 * np.sqrt(n)))
            np.testing.assert_allclose(got, np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# Deadlines, admission and stop
# ---------------------------------------------------------------------------

def test_deadline_expired_request_gets_structured_error(rng):
    engine = ServeEngine(max_batch=4, auto=True, collect_timeout_s=0.01,
                         **CPU)
    bound = engine.register("fft", N)
    rid_ok = engine.submit("fft", N, bound.random_payload(rng))
    rid_exp = engine.submit("fft", N, bound.random_payload(rng),
                            deadline_s=1e-4)
    time.sleep(0.01)
    stats = engine.run(2)
    assert stats["expired"] == 1
    assert stats["buckets"][f"fft/n={N}"]["expired"] == 1
    err = engine.errors[rid_exp]
    assert err["error"] == "deadline_exceeded"
    assert err["op"] == "fft" and err["n"] == N and err["waited_s"] > 0
    assert rid_exp not in engine.results and rid_ok in engine.results
    assert len(engine._latencies_s) == 1
    with pytest.raises(ValueError):
        engine.submit("fft", N, bound.random_payload(rng), deadline_s=0)


def test_request_stop_unblocks_waiting_submit(rng):
    """A submit blocked on a FULL queue raises EngineStopped promptly when
    request_stop lands."""
    engine = ServeEngine(max_batch=4, max_pending=1, auto=True,
                         collect_timeout_s=0.01, **CPU)
    bound = engine.register("fft", N)
    engine.submit("fft", N, bound.random_payload(rng))
    outcome: list = []

    def blocked_submit():
        try:
            engine.submit("fft", N, bound.random_payload(rng))
            outcome.append("admitted")
        except EngineStopped:
            outcome.append("stopped")

    th = threading.Thread(target=blocked_submit, daemon=True)
    th.start()
    time.sleep(0.15)
    assert th.is_alive()
    t0 = time.perf_counter()
    engine.request_stop()
    th.join(timeout=5.0)
    assert not th.is_alive() and outcome == ["stopped"]
    assert time.perf_counter() - t0 < 1.0
    engine.run(1)


def test_engine_stop_drains_backlog_then_rejects(rng):
    engine = ServeEngine(max_batch=4, max_pending=64, **CPU)
    engine.register("fft", 64)
    for rid in range(6):
        engine.submit("fft", 64, _cx(rng), rid=rid)
    engine.request_stop()
    assert engine.stopping
    with pytest.raises(EngineStopped):
        engine.submit("fft", 64, _cx(rng))
    stats = engine.run(10_000)   # target unreachable: exit is the drain
    assert stats["served"] == 6
    assert set(engine.results) == set(range(6))


# ---------------------------------------------------------------------------
# Snapshot, warm restart, watchdog
# ---------------------------------------------------------------------------

def test_engine_snapshot_refuses_pending(rng, tmp_path):
    engine = ServeEngine(max_batch=4, max_pending=64, **CPU)
    engine.register("fft", 64)
    engine.submit("fft", 64, _cx(rng), rid=0)
    with pytest.raises(RuntimeError, match="pending"):
        engine.snapshot(str(tmp_path))
    engine.request_stop()
    engine.run(10_000)
    engine.snapshot(str(tmp_path))


def test_engine_warm_restart_carries_lifetime(rng, tmp_path):
    d = str(tmp_path)
    engine = ServeEngine(max_batch=4, max_pending=64, **CPU)
    engine.register("fft", 64)
    engine.register("rfft", 128, strict=True)
    for _ in range(5):
        engine.submit("fft", 64, _cx(rng))
    engine.run(5)
    engine.request_stop()
    engine.run(10_000)
    engine.snapshot(d)
    assert ckpt_lib.read_extra(d, 5)["schema"] == "serve_engine_snapshot/v1"

    eng2 = ServeEngine.from_snapshot(d, **CPU)
    assert set(eng2._bound) == {("fft", 64), ("rfft", 128)}
    assert eng2._strict[("rfft", 128)] is True
    assert eng2.restarts == 1 and eng2._next_rid == 5
    for _ in range(3):
        eng2.submit("fft", 64, _cx(rng))
    stats = eng2.run(3)
    assert stats["served"] == 3
    assert stats["lifetime"] == {"served": 8,
                                 "batches": stats["batches"] + 2,
                                 "restarts": 1}
    assert stats["buckets"]["fft/n=64"]["lifetime_served"] == 8
    assert len(eng2._prev_latencies_s) == 5
    assert stats["latency_ms"]["p50"] > 0
    eng2.request_stop()
    eng2.run(10_000)
    eng2.snapshot(d)
    eng3 = ServeEngine.from_snapshot(d, **CPU)
    assert eng3.restarts == 2 and eng3._prev_served == 8


def test_engine_snapshot_latency_record_plateaus(rng, tmp_path):
    """Across restart generations the persisted latency record plateaus at
    ``LATENCY_WINDOW`` samples instead of growing."""
    d = str(tmp_path)
    engine = ServeEngine(max_batch=4, max_pending=64, **CPU)
    engine.register("fft", 64)
    sizes = []
    for _ in range(3):
        engine.submit("fft", 64, _cx(rng))
        engine.run(1)
        engine._latencies_s.extend([1e-4] * (LATENCY_WINDOW + 500))
        engine.request_stop()
        engine.run(10_000)
        engine.snapshot(d)
        engine = ServeEngine.from_snapshot(d, **CPU)
        sizes.append(len(engine._prev_latencies_s))
    assert sizes == [LATENCY_WINDOW] * 3
    engine.submit("fft", 64, _cx(rng))
    assert engine.run(1)["latency_ms"]["p50"] > 0


def test_engine_from_snapshot_rejects_foreign_checkpoint(tmp_path):
    d = str(tmp_path)
    ckpt_lib.save(d, 3, {"params": np.ones(2)}, extra={"data": {}})
    with pytest.raises(ValueError, match="schema"):
        ServeEngine.from_snapshot(d, **CPU)
    with pytest.raises(FileNotFoundError):
        ServeEngine.from_snapshot(str(tmp_path / "empty"), **CPU)


def test_engine_watchdog_eviction_and_elastic_restart(rng, tmp_path):
    hooked = []
    engine = ServeEngine(
        max_batch=4, max_pending=64,
        watchdog_cfg=WatchdogConfig(warmup_steps=2, threshold=2.0,
                                    evict_after=2),
        on_evict=lambda eng, idx: hooked.append((eng, idx)), **CPU)
    engine.register("fft", 64)
    for i, dt in enumerate([0.1, 0.1, 0.1, 0.9, 0.9]):
        engine.watchdog.observe(i, dt)
    assert engine.evictions == [4]
    assert hooked and hooked[0][0] is engine and hooked[0][1] == 4
    engine.request_stop()
    engine.run(10_000)
    eng2 = engine.elastic_restart(str(tmp_path), max_batch=8)
    assert eng2.restarts == 1 and eng2.max_batch == 8
    assert eng2.device == engine.device
    assert eng2.watchdog.ewma == pytest.approx(engine.watchdog.ewma)
    assert len(eng2.watchdog.events) == len(engine.watchdog.events)
    assert eng2.watchdog.cfg.evict_after == 2
    eng2.submit("fft", 64, _cx(rng), rid=100)
    stats = eng2.run(1)
    assert stats["served"] == 1
    assert stats["watchdog"]["ewma_s"] == eng2.watchdog.ewma


def test_engine_watchdog_sample_leaves_out_idle_wait(rng):
    """A gap in the traffic is not a slow batch: the first batch resolves
    only after the second request arrives 0.5 s later, and the watchdog's
    samples leave that wait out."""
    engine = ServeEngine(max_batch=4, collect_timeout_s=1.0, **CPU)
    engine.register("fft", 64)
    engine.warmup()
    engine.submit("fft", 64, _cx(rng))
    late = threading.Timer(0.5, lambda: engine.submit("fft", 64, _cx(rng)))
    late.start()
    t0 = time.perf_counter()
    engine.run(2)
    late.join()
    assert time.perf_counter() - t0 >= 0.5
    assert engine.watchdog.seen == 2 and engine.watchdog.ewma < 0.25


# ---------------------------------------------------------------------------
# The CLI: chaos, SIGTERM drain, warm restart, elastic restart
# ---------------------------------------------------------------------------

def test_cli_chaos_verifies_every_result(capsys):
    stats = serve.main(["--service", "engine", "--ops",
                        "fft,polymul-real,polymul-mod", "--ns", "64",
                        "--requests", "36", "--batch", "4", "--verify",
                        "--inject-faults", "1e-4", "--inject-stuck", "1",
                        "--device", "cpu"])
    assert stats["served"] == 36
    out = capsys.readouterr().out
    assert "[serve:engine] chaos: detected=" in out
    assert "quarantined=3" in out
    assert all(b["integrity"]["fell_back"] == 1
               for b in stats["buckets"].values())


def test_cli_chaos_flags_need_the_gate(capsys):
    for argv in (["--inject-faults", "1e-4"], ["--inject-stuck", "1"],
                 ["--elastic"]):
        with pytest.raises(SystemExit) as exc:
            serve.main(["--service", "engine", "--device", "cpu"] + argv)
        assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "requires the ABFT gate" in err and "requires --snapshot-dir" \
        in err


def test_cli_engine_sigterm_drains_and_snapshots(tmp_path):
    """SIGTERM mid-stream: the CLI drains the admitted backlog, snapshots,
    and exits 0; its handler hands request_stop to a thread."""
    d = str(tmp_path / "snap")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--service",
         "engine", "--ops", "fft", "--ns", "64", "--requests", "2000000",
         "--batch", "8", "--snapshot-dir", d, "--device", "cpu"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        while True:
            line = proc.stdout.readline()
            assert line, "serve exited before the ready marker"
            if "serving 2000000 requests across 1 buckets" in line:
                break
        time.sleep(0.5)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=180)
    finally:
        proc.kill()
    assert proc.returncode == 0, out
    assert "snapshot ->" in out, out
    step = ckpt_lib.latest_step(d)
    assert step is not None and step > 0
    eng = ServeEngine.from_snapshot(d, **CPU)
    assert eng.restarts == 1 and eng._prev_served == step


def test_cli_engine_snapshot_warm_restart(tmp_path, capsys):
    d = str(tmp_path / "snap")
    argv = ["--service", "engine", "--ops", "fft,rfft", "--ns", "64",
            "--requests", "8", "--batch", "4", "--snapshot-dir", d,
            "--device", "cpu"]
    first = serve.main(argv)
    assert first["served"] == 8 and first["lifetime"]["restarts"] == 0
    assert ckpt_lib.latest_step(d) == 8
    second = serve.main(argv)
    assert "warm restart #1" in capsys.readouterr().out
    assert second["served"] == 8
    assert second["lifetime"] == {"served": 16, "batches":
                                  first["batches"] + second["batches"],
                                  "restarts": 1}
    assert ckpt_lib.latest_step(d) == 16


def test_cli_engine_elastic_restart_at_one_shard(tmp_path):
    """Injected stragglers trip the watchdog; the CLI drains, snapshots and
    warm-restarts at half the shards (floor 1: one card), and the second
    generation serves the rest without another eviction. The threshold and
    the straggler's sleep sit far from a clean batch's host jitter. The
    first straggler is served batch 7 (K - 1 bucket + 1): a batch's sample
    holds the next batch's launch, so batch 6 would put a sleep into the
    watchdog's fifth warmup sample."""
    d = str(tmp_path / "snap")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--service",
         "engine", "--ops", "fft", "--ns", "64", "--requests", "48",
         "--batch", "4", "--max-pending", "8", "--model-shards", "2",
         "--snapshot-dir", d, "--elastic", "--watchdog-threshold", "50",
         "--watchdog-evict-after", "3", "--watchdog-warmup", "5",
         "--inject-straggler-ms", "1000", "--inject-straggler-after", "7",
         "--device", "cpu"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "watchdog evicted batch" in res.stdout, res.stdout
    assert "elastic restart: model_shards 2 -> 1" in res.stdout, res.stdout
    eng = ServeEngine.from_snapshot(d, **CPU)
    assert eng._prev_served == 48 and eng.restarts == 2
    assert eng.ctx.model_shards == 1


def _slowed_batches(monkeypatch, cli, Engine, arm: str, argv) -> list[bool]:
    """Run ``cli.main(argv)`` with its straggler injector's ``time.sleep``
    recorded instead of slept: for each launch after the warmup, in order,
    whether it was slowed. The launches are recorded from outside the
    injector (``arm`` wraps each bucket once it has armed), and the
    engine's warmup is marked, since the reference arms before it."""
    state = {"warm": False, "slept": False}
    served: list[bool] = []
    fake = types.ModuleType("time")
    fake.__dict__.update(vars(time))
    fake.sleep = lambda s: state.update(slept=True)
    monkeypatch.setattr(cli, "time", fake)
    warmup = Engine.warmup

    def marked(engine):
        state["warm"] = True
        try:
            warmup(engine)
        finally:
            state["warm"] = False

    def record(fn):
        def launch(*a):
            state["slept"] = False
            out = fn(*a)
            if not state["warm"]:
                served.append(state["slept"])
            return out
        return launch

    armed = getattr(cli, arm)

    def arm_and_record(engine, args):
        armed(engine, args)
        for bound in engine._bound.values():
            bound.fn = record(bound.fn)

    monkeypatch.setattr(Engine, "warmup", marked)
    monkeypatch.setattr(cli, arm, arm_and_record)
    cli.main(argv)
    monkeypatch.undo()
    return served


@pytest.mark.parametrize("after", [1, 4])
def test_cli_straggler_slows_the_reference_batches(monkeypatch, after):
    """``--inject-straggler-after K`` slows the same served batches in both
    packages' CLIs on the same two buckets: the first is served batch
    K - 2 + 1 (the reference's counter counts its warmup, one launch a
    bucket; at K = 1 a warmup launch sleeps there too) and every one
    after it."""
    argv = ["--service", "engine", "--ops", "fft,rfft", "--ns", "64",
            "--requests", "32", "--batch", "4",
            "--inject-straggler-ms", "1",
            "--inject-straggler-after", str(after)]
    want = _slowed_batches(monkeypatch, jserve, JServeEngine, "_arm_chaos",
                           argv)
    got = _slowed_batches(monkeypatch, serve, ServeEngine, "arm_chaos",
                          argv + ["--device", "cpu"])
    first = max(after - 2, 0)
    assert len(got) >= first + 2 and len(want) >= first + 2
    assert want == [False] * first + [True] * (len(want) - first)
    assert got == [False] * first + [True] * (len(got) - first)
