"""The port's distributed four-step FFT and real tier
(``repro_torch.core.fft.distributed``) against the reference's
(``repro.core.fft.distributed``).

D > 1: the reference runs on 8 forced host devices in one subprocess a
module (``conftest.run_in_subprocess_devices``), which writes every output
and every call's live byte ledger to an ``.npz``; the port computes the
same calls in-process on a CPU mesh of D shards. D = 1: both in-process.

Tolerances are the reference tests' own: the forward transforms and the
products within 1e-5 of the largest output magnitude (``tests/
test_dist_real.py``'s bound of its real tier), round trips within 1e-4
(``tests/test_distributed_fft.py``), the real tier at D = 1 within 2e-3
of numpy's half spectrum. Ledger counts and bytes are ``==``, and ``==``
the ``four_step_collective_stats`` closed form.
"""
import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_in_subprocess_devices
from repro.core.fft import distributed as jdfft
from repro.dist import collectives as jcoll
from repro_torch.core.fft import distributed as tdfft
from repro_torch.dist import collectives as tcoll
from repro_torch.dist import sharding

#: (op, n, batch, D): every length at every shard count, the batches 1, 3
#: and 4 in turn; the ordered real tier needs 2*D^2 | n, so 64 over 8
#: shards has only its Z-order forms
OPS = ("fft", "fft_z", "ifft", "polymul", "rfft", "rfft_z", "irfft",
       "irfft_z", "polymul_real")
CASES = []
for _i, (_n, _d) in enumerate((n, d) for n in (64, 1024, 16384)
                              for d in (2, 4, 8)):
    for _j, _op in enumerate(OPS):
        if _op in ("rfft", "irfft") and _n % (2 * _d * _d):
            continue
        CASES.append((_op, _n, (1, 3, 4)[(_i + _j) % 3], _d))

#: the ledger's closed-form op and whether the call is ordered
STATS_OP = {"fft": ("fft", True), "fft_z": ("fft", False),
            "ifft": ("ifft", True), "polymul": ("polymul", True),
            "rfft": ("rfft", True), "rfft_z": ("rfft", False),
            "irfft": ("irfft", True), "irfft_z": ("irfft", False),
            "polymul_real": ("polymul_real", True)}


def _key(op, n, b, d):
    return f"{op}_{n}_{b}_{d}"


def _inputs(op, n, b):
    """The call's operands, from a seed of its own."""
    rng = np.random.default_rng(zlib.crc32(f"{op}/{n}/{b}".encode()))
    if op in ("fft", "fft_z", "ifft", "polymul"):
        shape = (b, n)
        cx = lambda: (rng.standard_normal(shape)  # noqa: E731
                      + 1j * rng.standard_normal(shape)).astype(np.complex64)
        return (cx(), cx()) if op == "polymul" else (cx(),)
    if op in ("irfft", "irfft_z"):
        return ((rng.standard_normal((b, n // 2))
                 + 1j * rng.standard_normal((b, n // 2))
                 ).astype(np.complex64),)
    real = lambda: rng.standard_normal((b, n)).astype(np.float32)  # noqa
    return (real(), real()) if op == "polymul_real" else (real(),)


def _builder(mod, op, mesh, **kw):
    return {"fft": lambda: mod.make_sharded_fft(mesh, **kw),
            "fft_z": lambda: mod.make_sharded_fft(mesh, ordered=False, **kw),
            "ifft": lambda: mod.make_sharded_fft(mesh, inverse=True, **kw),
            "polymul": lambda: mod.make_sharded_polymul(mesh, **kw),
            "rfft": lambda: mod.make_sharded_rfft(mesh, **kw),
            "rfft_z": lambda: mod.make_sharded_rfft(mesh, ordered=False,
                                                    **kw),
            "irfft": lambda: mod.make_sharded_irfft(mesh, **kw),
            "irfft_z": lambda: mod.make_sharded_irfft(mesh, ordered=False,
                                                      **kw),
            "polymul_real": lambda: mod.make_sharded_polymul_real(mesh,
                                                                  **kw),
            }[op]()


REFERENCE = """
import json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core.fft import distributed as dfft
from repro.dist import collectives

cases = json.loads({cases!r})
inputs = np.load({inputs!r})
out = {{}}
builders = {{
    "fft": lambda m: dfft.make_sharded_fft(m, batch_axes=()),
    "fft_z": lambda m: dfft.make_sharded_fft(m, ordered=False,
                                             batch_axes=()),
    "ifft": lambda m: dfft.make_sharded_fft(m, inverse=True, batch_axes=()),
    "polymul": lambda m: dfft.make_sharded_polymul(m, batch_axes=()),
    "rfft": lambda m: dfft.make_sharded_rfft(m, batch_axes=()),
    "rfft_z": lambda m: dfft.make_sharded_rfft(m, ordered=False,
                                               batch_axes=()),
    "irfft": lambda m: dfft.make_sharded_irfft(m, batch_axes=()),
    "irfft_z": lambda m: dfft.make_sharded_irfft(m, ordered=False,
                                                 batch_axes=()),
    "polymul_real": lambda m: dfft.make_sharded_polymul_real(
        m, batch_axes=()),
}}
for op, n, b, d in cases:
    key = f"{{op}}_{{n}}_{{b}}_{{d}}"
    mesh = Mesh(np.array(jax.devices()[:d]), ("model",))
    args = [jnp.asarray(inputs[f"{{key}}_{{i}}"]) for i in range(2)
            if f"{{key}}_{{i}}" in inputs]
    with collectives.ledger() as led:
        compiled = jax.jit(builders[op](mesh)).lower(*args).compile()
    out[key] = np.asarray(compiled(*args))
    out[key + "_ledger"] = np.array(
        [led.counts["all-to-all"], led.bytes_by_kind["all-to-all"],
         led.counts["ppermute"], led.bytes_by_kind["ppermute"]])
np.savez({result!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's reference output and live ledger, from one
    8-device subprocess."""
    d = tmp_path_factory.mktemp("dist_fft")
    inputs = {}
    for op, n, b, _ in CASES:
        for i, arr in enumerate(_inputs(op, n, b)):
            inputs[f"{_key(op, n, b, _)}_{i}"] = arr
    np.savez(d / "inputs.npz", **inputs)
    out = run_in_subprocess_devices(REFERENCE.format(
        cases=json.dumps(CASES), inputs=str(d / "inputs.npz"),
        result=str(d / "result.npz")), n_devices=8)
    assert "OK" in out
    return dict(np.load(d / "result.npz"))


def _port(op, n, b, d):
    mesh = sharding.make_mesh((d,), ("model",), device="cpu")
    args = [torch.from_numpy(a) for a in _inputs(op, n, b)]
    with tcoll.ledger() as led:
        got = _builder(tdfft, op, mesh)(*args).numpy()
    return got, led


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want))))


@pytest.mark.parametrize("op,n,b,d", CASES)
def test_sharded_op_matches_the_reference(reference, op, n, b, d):
    """Output within the reference's bound and the ledger ``==`` the
    reference's live ledger and the closed form."""
    got, led = _port(op, n, b, d)
    key = _key(op, n, b, d)
    want = reference[key]
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = 1e-4 if op in ("ifft", "irfft", "irfft_z") else 1e-5
    assert _rel(got, want) < tol, (key, _rel(got, want))
    live = [led.counts["all-to-all"], led.bytes_by_kind["all-to-all"],
            led.counts["ppermute"], led.bytes_by_kind["ppermute"]]
    assert live == reference[key + "_ledger"].tolist()
    stats_op, ordered = STATS_OP[op]
    padded = b + b % 2 if op in ("rfft", "rfft_z", "irfft", "irfft_z",
                                 "polymul_real") else b
    want_stats = tdfft.four_step_collective_stats(n, padded, d, op=stats_op,
                                                  ordered=ordered)
    assert live == [want_stats["a2a_count"], want_stats["a2a_bytes"],
                    want_stats["ppermute_count"],
                    want_stats["ppermute_bytes"]]


@pytest.mark.parametrize("n,d", [(1024, 2), (16384, 8)])
def test_round_trips_and_oracles(n, d):
    """fft then ifft and rfft then irfft return the input (1e-4); the
    forward transforms and products agree with fp64 numpy."""
    mesh = sharding.make_mesh((d,), ("model",), device="cpu")
    rng = np.random.default_rng(n + d)
    x = (rng.standard_normal((3, n))
         + 1j * rng.standard_normal((3, n))).astype(np.complex64)
    y = tdfft.make_sharded_fft(mesh)(torch.from_numpy(x))
    assert _rel(y.numpy(), np.fft.fft(x.astype(np.complex128))) < 1e-5
    back = tdfft.make_sharded_fft(mesh, inverse=True)(y).numpy()
    assert np.max(np.abs(back - x)) < 1e-4
    a = rng.standard_normal((3, n)).astype(np.float32)
    p = tdfft.make_sharded_rfft(mesh)(torch.from_numpy(a))
    assert np.max(np.abs(tdfft.make_sharded_irfft(mesh)(p).numpy() - a)) \
        < 1e-4
    b = rng.standard_normal((3, n)).astype(np.float32)
    c = tdfft.make_sharded_polymul_real(mesh)(torch.from_numpy(a),
                                              torch.from_numpy(b)).numpy()
    want = np.fft.ifft(np.fft.fft(a.astype(np.float64))
                       * np.fft.fft(b.astype(np.float64))).real
    assert _rel(c, want) < 1e-5


@pytest.mark.parametrize("op", OPS)
def test_single_shard_matches_the_reference_in_process(op):
    """D = 1: the reference's builders on a 1-device mesh in this process,
    the port's on one CPU shard; the real tier also within 2e-3 of
    numpy's half spectrum."""
    n, b = 512, 4
    args = _inputs(op, n, b)
    mesh = jax.make_mesh((1,), ("model",))
    with jcoll.ledger() as jled:
        want = np.asarray(jax.jit(_builder(jdfft, op, mesh, batch_axes=()))(
            *[jnp.asarray(a) for a in args]))
    got, led = _port(op, n, b, 1)
    tol = 1e-4 if op in ("ifft", "irfft", "irfft_z") else 1e-5
    assert _rel(got, want) < tol
    assert led.as_dict() == jled.as_dict()
    if op == "rfft":
        full = np.fft.rfft(args[0].astype(np.float64))
        packed = full[:, :n // 2].copy()
        packed[:, 0] = full[:, 0].real + 1j * full[:, n // 2].real
        np.testing.assert_allclose(got, packed, atol=2e-3)


@pytest.mark.parametrize("n,d", [(4096, 8), (1 << 20, 8), (1024, 4),
                                 (256, 2)])
@pytest.mark.parametrize("inverse", [False, True])
def test_twiddle_tables_equal_the_reference(n, d, inverse):
    """The step-3 tables are the reference's numpy, ``==``; each shard's
    table is their complex64 product, as the reference forms it."""
    width = (n // d) // d
    got = tdfft._twiddle_tables(n, d, width, inverse)
    want = jdfft._twiddle_tables(n, d, width, inverse)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.complex64
        assert (g == w).all()
    for idx in range(d):
        t = tdfft._twiddle(n, d, width, idx, inverse, torch.device("cpu"))
        r = np.asarray(jdfft._twiddle(n, d, width, jnp.int32(idx), inverse))
        np.testing.assert_allclose(t.numpy(), r, rtol=0, atol=1e-7)


def test_shape_guard_and_odd_batches_match_the_reference():
    """``check_four_step_shape`` accepts and refuses what the reference's
    does, with its message; the real builders pad an odd batch."""
    for n, d, real in ((512, 8, False), (1024, 8, True), (32, 8, False),
                       (96, 8, False), (8, 4, False), (64, 8, True),
                       (2048, 3, False)):
        try:
            jdfft.check_four_step_shape(n, d, real=real)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tdfft.check_four_step_shape(n, d, real=real)
            assert str(got.value) == str(e)
        else:
            tdfft.check_four_step_shape(n, d, real=real)
    mesh = sharding.make_mesh((4,), ("model",), device="cpu")
    x = np.random.default_rng(1).standard_normal((3, 256)).astype(np.float32)
    assert tdfft.make_sharded_rfft(mesh)(torch.from_numpy(x)).shape == \
        (3, 128)
    with pytest.raises(ValueError, match="four-step"):
        tdfft.make_sharded_fft(mesh)(torch.zeros(2, 8, dtype=torch.complex64))


@pytest.mark.parametrize("n,b,d", [(4096, 4, 1), (4096, 8, 8),
                                   ((1 << 20), 2, 8), (1024, 6, 4)])
@pytest.mark.parametrize("op", ["fft", "ifft", "polymul", "rfft", "irfft",
                                "polymul_real"])
def test_collective_stats_closed_form_is_the_reference(n, b, d, op):
    for ordered in (True, False):
        assert tdfft.four_step_collective_stats(n, b, d, op=op,
                                                ordered=ordered) == \
            jdfft.four_step_collective_stats(n, b, d, op=op, ordered=ordered)


def test_batch_plan_is_the_reference():
    import types
    mesh = types.SimpleNamespace(shape={"data": 4, "model": 2})
    got = tdfft.batch_plan(mesh, 10, transforms_per_device=3).report()
    want = jdfft.batch_plan(mesh, 10, transforms_per_device=3).report()
    assert got == want
