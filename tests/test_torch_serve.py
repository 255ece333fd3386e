"""The port's serve layer (``repro_torch.launch``: registry, engine,
service, CLI) on the CPU, against the reference ``repro.launch``.

Tolerances: engine vs direct dispatch in the port is bitwise (the same
kernels on the same batches); the port's service vs the reference's
service on the same payloads is within the op's tolerance -- fft/rfft
rtol 1e-4, atol 1e-4 * sqrt(n), products rtol 1e-3, atol 1e-4 * n (the
reference tests' bounds; the reference serves its XLA Stockham at radix 2
with fp32 phases, the port its kernels at the plan's radix 4) -- except
the exact ``polymul-mod``, which equals the reference bit for bit.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.launch import ops as jops_registry
from repro.launch import serve as jserve
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tkops
from repro_torch.launch import ops as op_registry
from repro_torch.launch import serve
from repro_torch.launch.engine import Backpressure, ServeEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ("fft", "rfft", "polymul", "polymul-real")
#: polymul-mod's two local routes: single-limb (modulus_bits <= 30) and RNS
MOD_ROUTES = [(None, 256, "polymul-mod-single"),
              (100, 64, "polymul-mod-rns")]


def _tol(op, n):
    if op.startswith("polymul"):
        return dict(rtol=1e-3, atol=1e-4 * n)
    return dict(rtol=1e-4, atol=1e-4 * np.sqrt(n))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    return env


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def test_registry_serves_the_float_ops_without_a_ladder():
    assert op_registry.op_names() == OPS + ("polymul-mod",)
    assert op_registry.op_names() == jops_registry.op_names()
    for name in op_registry.op_names():
        assert name in op_registry.cli_help()
    from repro import analysis
    launch_dir = os.path.dirname(op_registry.__file__)
    res = analysis.analyze_paths([launch_dir])
    assert [f for f in res.findings if f.rule == "dispatch-ladder"] == []
    # knob applicability reads as in the reference registry
    for knob in ("modulus_bits", "model_shards"):
        assert op_registry.ops_using(knob) == jops_registry.ops_using(knob)


@pytest.mark.parametrize("op,kw", [
    ("fft", {"modulus_bits": 40}), ("rfft", {"modulus_bits": 40}),
    ("polymul", {"modulus_bits": 40}), ("polymul-real", {"modulus_bits": 30}),
    ("fft", {"model_shards": 4}), ("rfft", {"model_shards": 4}),
    ("polymul", {"model_shards": 2})])
def test_foreign_knob_messages_match_reference(op, kw):
    with pytest.raises(jops_registry.OpConfigError) as want:
        jops_registry.get_op(op).bind(64, jops_registry.OpContext(**kw))
    with pytest.raises(op_registry.OpConfigError) as got:
        op_registry.get_op(op).bind(64, op_registry.OpContext(**kw),
                                    device="cpu")
    assert str(got.value) == str(want.value)


def test_unknown_op_and_unported_routes_are_config_errors():
    with pytest.raises(op_registry.OpConfigError, match="unknown op"):
        op_registry.get_op("polymul-nope")
    with pytest.raises(op_registry.OpConfigError,
                       match="model_shards=8: distributed tier not yet "
                             "ported; it comes with the multi-device slice"):
        op_registry.get_op("polymul-mod").bind(
            1024, op_registry.OpContext(model_shards=8), device="cpu")
    with pytest.raises(op_registry.OpConfigError,
                       match="distributed tier not yet ported"):
        op_registry.get_op("polymul-real").bind(
            1024, op_registry.OpContext(model_shards=8), device="cpu")
    ctx = op_registry.OpContext(modulus_bits=100, model_shards=8)
    assert op_registry.get_op("fft").narrow(ctx) == op_registry.OpContext()
    assert op_registry.get_op("polymul-real").narrow(ctx) == \
        op_registry.OpContext(model_shards=8)


@pytest.mark.parametrize("op", OPS)
def test_bind_passes_the_plan_into_the_kernel(op, monkeypatch):
    """The bound fn hands plan.radix and plan.block_b to the kernel
    wrapper (the reference binds drop both)."""
    seen = []
    for mod, name in ((tkops._kfft, "fft_planes"),
                      (tkops._kfft, "rfft_planes"),
                      (tkops._kpoly, "polymul_complex_planes"),
                      (tkops._kpoly, "polymul_real_planes")):
        real = getattr(mod, name)

        def spy(*a, _real=real, **kw):
            seen.append((kw["radix"], kw["block_b"]))
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    svc = serve.FFTService(256, 8, op, device="cpu")
    svc.warmup()
    assert seen and set(seen) == {(svc.plan.radix, svc.plan.block_b)}
    assert svc.plan.radix == 4


# ---------------------------------------------------------------------------
# Engine parity and scheduling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", OPS)
def test_engine_matches_direct_dispatch(op, rng):
    """Served through the engine == the direct BoundOp call on the same
    batches (batches [4, 2]: the tail runs at its actual size); bitwise."""
    n, cap, total = 64, 4, 6
    svc = serve.FFTService(n, cap, op, device="cpu")
    payloads = [svc.bound.random_payload(rng) for _ in range(total)]
    for rid, p in enumerate(payloads):
        svc.submit(rid, p)
    stats = svc.run(total)
    assert stats["served"] == total
    assert stats["buckets"][f"{op}/n={n}"]["batch_sizes"] == [4, 2]
    direct = [svc.bound.to_numpy(svc.bound.execute(payloads[:4])),
              svc.bound.to_numpy(svc.bound.execute(payloads[4:]))]
    flat = [row for arr in direct for row in arr]
    for rid in range(total):
        np.testing.assert_array_equal(svc.results[rid], flat[rid])
        svc.bound.verify(payloads[rid], svc.results[rid])


@pytest.mark.parametrize("op", OPS)
def test_service_matches_reference_service(op, rng):
    """The port's FFTService and the reference's FFTService, fed the same
    payloads, serve results within the op's tolerance."""
    n, cap, total = 256, 4, 5
    port = serve.FFTService(n, cap, op, device="cpu")
    ref = jserve.FFTService(n, cap, op)
    payloads = [port.bound.random_payload(rng) for _ in range(total)]
    for svc in (port, ref):
        for rid, p in enumerate(payloads):
            svc.submit(rid, p)
        assert svc.run(total)["served"] == total
    for rid in range(total):
        assert port.results[rid].shape == ref.results[rid].shape
        assert port.results[rid].dtype == ref.results[rid].dtype
        np.testing.assert_allclose(port.results[rid], ref.results[rid],
                                   **_tol(op, n))


@pytest.mark.parametrize("bits,n,route", MOD_ROUTES)
def test_polymul_mod_service_equals_reference_service(rng, bits, n, route):
    """The exact product served by the port and by the reference registry
    on the same payloads: equal bit for bit, in the reference's result
    dtype (uint32 residues single-limb, object big ints mod Q on RNS), and
    each equal to the numpy reference product."""
    port = serve.FFTService(n, 4, "polymul-mod", modulus_bits=bits,
                            device="cpu")
    ref = jserve.FFTService(n, 4, "polymul-mod", modulus_bits=bits)
    assert port.route == ref.route == route
    payloads = [port.bound.random_payload(rng) for _ in range(5)]
    for svc in (port, ref):
        for rid, p in enumerate(payloads):
            svc.submit(rid, p)
        assert svc.run(5)["served"] == 5
    for rid in range(5):
        got, want = port.results[rid], ref.results[rid]
        assert got.dtype == want.dtype and got.shape == want.shape == (n,)
        assert (got == want).all()
        port.bound.verify(payloads[rid], got)


@pytest.mark.parametrize("bits,n,route", MOD_ROUTES)
def test_polymul_mod_engine_matches_direct_dispatch(rng, bits, n, route):
    """Served through the engine (batches [4, 2], the RNS route's CRT as the
    host step after the sync) == the direct BoundOp call; bit for bit."""
    svc = serve.FFTService(n, 4, "polymul-mod", modulus_bits=bits,
                           device="cpu")
    payloads = [svc.bound.random_payload(rng) for _ in range(6)]
    for rid, p in enumerate(payloads):
        svc.submit(rid, p)
    stats = svc.run(6)
    bucket = stats["buckets"][f"polymul-mod/n={n}"]
    assert bucket["batch_sizes"] == [4, 2] and bucket["route"] == route
    direct = [svc.bound.to_numpy(svc.bound.execute(payloads[:4])),
              svc.bound.to_numpy(svc.bound.execute(payloads[4:]))]
    flat = [row for arr in direct for row in arr]
    for rid in range(6):
        assert (svc.results[rid] == flat[rid]).all()
        svc.bound.verify(payloads[rid], svc.results[rid])
    if bits is not None:       # (k, B, n) limb residues went to the kernel
        a, _ = svc.bound.stack(payloads[:1])
        assert a.shape == (svc.bound.rns.k, 1, n) and a.dtype == torch.uint32


def test_polymul_mod_payloads_pass_admission(rng):
    """Integer and big-int operands carry no NaN: the admission guard lets
    them through (it used to call np.isfinite on object arrays)."""
    for bits, n, _ in MOD_ROUTES:
        bound = op_registry.get_op("polymul-mod").bind(
            n, op_registry.OpContext(modulus_bits=bits), device="cpu")
        bound.check_payload(bound.random_payload(rng))
        bound.check_payload((np.arange(n), -np.arange(n)))


@pytest.mark.parametrize("kw,n", [
    ({"modulus_bits": 100, "model_shards": 8}, 1024),
    ({"modulus_bits": 10}, 4096), ({"modulus_bits": 7}, 64),
    ({}, 48), ({"modulus_bits": 100}, 48)])
def test_polymul_mod_config_errors_match_reference(kw, n):
    with pytest.raises(jops_registry.OpConfigError) as want:
        jops_registry.get_op("polymul-mod").bind(
            n, jops_registry.OpContext(**kw))
    with pytest.raises(op_registry.OpConfigError) as got:
        op_registry.get_op("polymul-mod").bind(
            n, op_registry.OpContext(**kw), device="cpu")
    assert str(got.value) == str(want.value)


def test_mixed_stream_with_polymul_mod(rng):
    """The five ops in one engine with a process-level modulus_bits: the
    float ops narrow it away, polymul-mod takes the RNS route, and every
    result passes its oracle."""
    engine = ServeEngine(max_batch=4, max_pending=64, modulus_bits=100,
                         device="cpu")
    combos = [(op, 64) for op in OPS + ("polymul-mod",)]
    for op, n in combos:
        engine.register(op, n)
    assert engine.bound("polymul-mod", 64).route == "polymul-mod-rns"
    engine.warmup()
    kept = {}
    for rid in range(15):
        op, n = combos[rid % len(combos)]
        p = engine.bound(op, n).random_payload(rng)
        kept[rid] = (op, n, p)
        engine.submit(op, n, p, rid=rid)
    assert engine.run(15)["served"] == 15
    for rid, (op, n, p) in kept.items():
        engine.bound(op, n).verify(p, engine.results[rid])


def test_mixed_stream_bucketing(rng):
    """One engine, four ops x two lengths interleaved: every request lands
    in its bucket, keeps its bucket's shape and passes its oracle."""
    engine = ServeEngine(max_batch=4, max_pending=64, device="cpu")
    combos = [(op, n) for op in OPS for n in (64, 128)]
    for op, n in combos:
        engine.register(op, n)
    engine.warmup()
    kept = {}
    for rid in range(24):
        op, n = combos[rid % len(combos)]
        p = engine.bound(op, n).random_payload(rng)
        kept[rid] = (op, n, p)
        engine.submit(op, n, p, rid=rid)
    stats = engine.run(24)
    assert stats["served"] == 24 and len(stats["buckets"]) == len(combos)
    for b in stats["buckets"].values():
        assert all(1 <= s <= 4 for s in b["batch_sizes"])
        assert 0 < b["utilization"] <= 1.0
    for rid, (op, n, p) in kept.items():
        engine.bound(op, n).verify(p, engine.results[rid])
        width = n // 2 + 1 if op == "rfft" else n
        assert engine.results[rid].shape == (width,)


def test_tail_batch_runs_at_actual_size(rng):
    engine = ServeEngine(max_batch=8, max_pending=64, device="cpu")
    engine.register("rfft", 64)
    for rid in range(11):
        engine.submit("rfft", 64,
                      rng.standard_normal(64).astype(np.float32), rid=rid)
    stats = engine.run(11)
    b = stats["buckets"]["rfft/n=64"]
    assert b["batch_sizes"] == [8, 3]
    assert abs(b["utilization"] - 11 / 16) < 1e-12


def test_backpressure_bounded_queue(rng):
    engine = ServeEngine(max_batch=4, max_pending=3, device="cpu")
    x = (rng.standard_normal(64) + 0j).astype(np.complex64)
    for rid in range(3):
        engine.submit("fft", 64, x, rid=rid)
    with pytest.raises(Backpressure):
        engine.submit("fft", 64, x, rid=99, block=False)
    with pytest.raises(Backpressure):
        engine.submit("fft", 64, x, rid=99, timeout=0.05)
    assert engine.run(3)["served"] == 3          # draining frees the queue
    engine.submit("fft", 64, x, rid=3, block=False)
    assert engine.run(4)["served"] == 4


def test_latency_percentiles_monotone_and_nan_rejected(rng):
    engine = ServeEngine(max_batch=4, device="cpu")
    for rid in range(10):
        engine.submit("fft", 64, (rng.standard_normal(64)
                                  + 0j).astype(np.complex64), rid=rid)
    stats = engine.run(10)
    lat = stats["latency_ms"]
    assert 0 < lat["p50"] <= lat["p90"] <= lat["p99"] <= lat["max"]
    assert stats["compute_throughput_per_s"] >= stats["throughput_per_s"] > 0
    bad = np.full(64, np.nan, np.complex64)
    with pytest.raises(op_registry.OpConfigError, match="non-finite"):
        engine.submit("fft", 64, bad)


def test_cpu_serving_launches_no_kernel(rng):
    _build.reset_launches()
    serve.main(["--service", "engine", "--ops",
                ",".join(OPS + ("polymul-mod",)), "--ns", "32",
                "--batch", "2", "--requests", "10", "--device", "cpu"])
    serve.main(["--op", "polymul-mod", "--modulus-bits", "100", "--n", "32",
                "--batch", "2", "--requests", "3", "--device", "cpu"])
    assert set(_build.LAUNCHES.values()) == {0}


# ---------------------------------------------------------------------------
# Device choice: CUDA unless the caller asks for the CPU, never a fallback
# ---------------------------------------------------------------------------

def test_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.FFTService(64, 4, "fft")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(max_batch=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        op_registry.get_op("rfft").bind(64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--n", "64", "--requests", "2", "--batch", "2"])
    # asking for the CPU works on the same host
    assert serve.FFTService(64, 4, "fft", device="cpu").bound.device.type \
        == "cpu"


# ---------------------------------------------------------------------------
# CLI and import hygiene (subprocesses)
# ---------------------------------------------------------------------------

def test_cli_engine_on_cpu_subprocess():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--service",
         "engine", "--ops", ",".join(OPS), "--ns", "64,128", "--batch", "4",
         "--requests", "24", "--device", "cpu"],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert res.returncode == 0, res.stderr
    assert "[serve:engine] buckets=8 device=cpu served=24" in res.stdout


@pytest.mark.parametrize("bits,route", [("30", "polymul-mod-single"),
                                        ("109", "polymul-mod-rns")])
def test_cli_modulus_bits_reaches_the_route_subprocess(bits, route):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--op",
         "polymul-mod", "--modulus-bits", bits, "--n", "64", "--batch", "4",
         "--requests", "6", "--device", "cpu"],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert res.returncode == 0, res.stderr
    assert f"op=polymul-mod route={route} n=64" in res.stdout
    assert "served=6" in res.stdout and "NTT (exact mod-q)" in res.stdout


def test_cli_exits_with_registry_validation_error(capsys):
    for argv in (["--op", "fft", "--modulus-bits", "40"],
                 ["--op", "polymul-real", "--model-shards", "8"],
                 ["--op", "polymul-mod", "--modulus-bits", "109",
                  "--model-shards", "2"],
                 ["--service", "engine", "--ops", "fft,nope", "--ns", "64"]):
        with pytest.raises(SystemExit) as exc:
            serve.main(argv + ["--device", "cpu"])
        assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "has no modular route" in err
    assert "distributed tier not yet ported" in err
    assert "distributed polymul-mod is single-limb" in err


def test_port_sources_import_neither_jax_nor_the_reference():
    """Static check of every import statement, including those inside
    functions, in the port's sources and in chip_smoke.py."""
    import ast
    import pathlib
    root = pathlib.Path(REPO)
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [(path.name, m) for m in names
                    if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert len(files) >= 19 and bad == []


def test_port_never_imports_jax_or_the_reference():
    """Import every module of the port, and chip_smoke.py, in a fresh
    interpreter: neither jax nor any module of the reference package may be
    loaded."""
    prog = (
        "import pkgutil, sys, importlib\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for m in ('repro_torch.core.ntt', 'repro_torch.core.ntt.rns', "
        "'repro_torch.kernels.ntt', 'repro_torch.core.cost', "
        "'repro_torch.core.pim.ntt_pim', 'repro_torch.core.pim.hopper', "
        "'repro_torch.dist.batching'):\n"
        "    assert m in sys.modules, m\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('modules', sum(k.startswith('repro_torch') "
        "for k in sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, env=_env(), timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 18


# ---------------------------------------------------------------------------
# --service lm
# ---------------------------------------------------------------------------

LM_ARGS = ["--service", "lm", "--smoke", "--batch", "2", "--prompt-len",
           "16", "--gen", "4"]


def test_lm_service_on_cpu_returns_what_the_reference_returns():
    """``generated`` is (gen, batch), token ids below the vocabulary, as the
    reference's CLI returns it (its random weights and prompt come from
    other generators, so the ids themselves differ)."""
    _build.reset_launches()
    got = serve.main(LM_ARGS + ["--device", "cpu"])
    want = jserve.main(LM_ARGS)
    assert set(got) == set(want) == {"tokens_per_s", "generated"}
    assert got["generated"].shape == np.asarray(want["generated"]).shape \
        == (4, 2)
    assert got["generated"].dtype.kind == "i"
    assert ((0 <= got["generated"]) & (got["generated"] < 512)).all()
    assert got["tokens_per_s"] > 0
    assert _build.LAUNCHES["flash_attention"] == 0


def test_lm_service_is_seeded():
    a = serve.main(LM_ARGS + ["--device", "cpu"])["generated"]
    b = serve.main(LM_ARGS + ["--device", "cpu"])["generated"]
    np.testing.assert_array_equal(a, b)


def test_lm_service_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(LM_ARGS)


def test_cli_lm_service_subprocess():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *LM_ARGS,
         "--arch", "gemma3-4b", "--device", "cpu"],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert res.returncode == 0, res.stderr
    assert "[serve:lm] arch=gemma3-4b-smoke batch=2 prompt=16 gen=4 " \
           "device=cpu" in res.stdout


def test_lm_service_serves_fourierpim_on_cpu():
    """fourierpim-lm's reduced config (K 16 taps, prompt 16): greedy tokens
    of the served shape in the vocabulary, no kernel launched on the CPU."""
    _build.reset_launches()
    got = serve.main(LM_ARGS + ["--arch", "fourierpim-lm", "--device", "cpu"])
    assert got["generated"].shape == (4, 2)
    assert ((0 <= got["generated"]) & (got["generated"] < 512)).all()
    assert not any(_build.LAUNCHES.values())


def test_cli_lm_service_fourierpim_subprocess():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *LM_ARGS,
         "--arch", "fourierpim-lm", "--device", "cpu"],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert res.returncode == 0, res.stderr
    assert "[serve:lm] arch=fourierpim-lm-smoke batch=2 prompt=16 gen=4 " \
           "device=cpu" in res.stdout


def test_cli_lm_service_unported_arch_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 11b"):
        serve.main(["--service", "lm", "--smoke", "--arch", "mixtral-8x22b",
                    "--device", "cpu"])
