"""The port's distributed four-step NTT (``repro_torch.core.ntt.
distributed``) against the reference's (``repro.core.ntt.distributed``).

D > 1: the reference runs on 8 forced host devices in one subprocess a
module, which writes every output and every call's live byte ledger to an
``.npz``; the port computes the same calls in-process on a CPU mesh of D
shards, its local transforms through ``ntt_batched``'s plain version.
Every result is ``==``: the reference's, the local product's and the numpy
reference's; the ledger ``==`` the reference's and the closed form.
"""
import json
import zlib

import jax
import numpy as np
import pytest
import torch

from conftest import run_in_subprocess_devices
from repro.core.ntt import NTTParams as JParams
from repro.core.ntt import distributed as jdntt
from repro_torch.core.ntt import distributed as tdntt
from repro_torch.core.ntt.ref import (NTTParams, cyclic_polymul,
                                      negacyclic_polymul, ntt)
from repro_torch.dist import collectives as tcoll
from repro_torch.dist import sharding
from repro_torch.kernels import ntt as tkntt

OPS = ("ntt", "ntt_z", "intt", "polymul", "polymul_cyclic")
CASES = []
for _i, (_n, _d) in enumerate((n, d) for n in (64, 1024, 16384)
                              for d in (2, 4, 8)):
    for _j, _op in enumerate(OPS):
        CASES.append((_op, _n, (1, 3, 4)[(_i + _j) % 3], _d))

#: the closed form's (op, ordered) of each call
STATS_OP = {"ntt": ("ntt", True), "ntt_z": ("ntt", False),
            "intt": ("intt", True), "polymul": ("polymul", True),
            "polymul_cyclic": ("polymul", True)}


def _key(op, n, b, d):
    return f"{op}_{n}_{b}_{d}"


def _inputs(op, n, b):
    q = NTTParams.make(n).q
    rng = np.random.default_rng(zlib.crc32(f"{op}/{n}/{b}".encode()))
    draw = lambda: rng.integers(0, q, (b, n)).astype(np.uint32)  # noqa
    return (draw(), draw()) if op.startswith("polymul") else (draw(),)


def _builder(mod, op, mesh, params, **kw):
    return {"ntt": lambda: mod.make_sharded_ntt(mesh, params, **kw),
            "ntt_z": lambda: mod.make_sharded_ntt(mesh, params,
                                                  ordered=False, **kw),
            "intt": lambda: mod.make_sharded_ntt(mesh, params, inverse=True,
                                                 **kw),
            "polymul": lambda: mod.make_sharded_ntt_polymul(mesh, params,
                                                            **kw),
            "polymul_cyclic": lambda: mod.make_sharded_ntt_polymul(
                mesh, params, negacyclic=False, **kw)}[op]()


REFERENCE = """
import json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core.ntt import NTTParams
from repro.core.ntt import distributed as dntt
from repro.dist import collectives

cases = json.loads({cases!r})
inputs = np.load({inputs!r})
out = {{}}
builders = {{
    "ntt": lambda m, p: dntt.make_sharded_ntt(m, p, axis_name="model"),
    "ntt_z": lambda m, p: dntt.make_sharded_ntt(m, p, axis_name="model",
                                                ordered=False),
    "intt": lambda m, p: dntt.make_sharded_ntt(m, p, axis_name="model",
                                               inverse=True),
    "polymul": lambda m, p: dntt.make_sharded_ntt_polymul(
        m, p, axis_name="model"),
    "polymul_cyclic": lambda m, p: dntt.make_sharded_ntt_polymul(
        m, p, negacyclic=False, axis_name="model"),
}}
for op, n, b, d in cases:
    key = f"{{op}}_{{n}}_{{b}}_{{d}}"
    mesh = Mesh(np.array(jax.devices()[:d]), ("model",))
    args = [jnp.asarray(inputs[f"{{key}}_{{i}}"]) for i in range(2)
            if f"{{key}}_{{i}}" in inputs]
    with collectives.ledger() as led:
        compiled = jax.jit(builders[op](mesh, NTTParams.make(n))).lower(
            *args).compile()
    out[key] = np.asarray(compiled(*args))
    out[key + "_ledger"] = np.array(
        [led.counts["all-to-all"], led.bytes_by_kind["all-to-all"]])
np.savez({result!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_ntt")
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
        got = _builder(tdntt, op, mesh, NTTParams.make(n),
                       axis_name="model")(*args)
    return tkntt.residues_to_numpy(got), led


@pytest.mark.parametrize("op,n,b,d", CASES)
def test_sharded_ntt_equals_the_reference(reference, op, n, b, d):
    got, led = _port(op, n, b, d)
    key = _key(op, n, b, d)
    assert got.dtype == reference[key].dtype
    assert (got == reference[key]).all()
    live = [led.counts["all-to-all"], led.bytes_by_kind["all-to-all"]]
    assert live == reference[key + "_ledger"].tolist()
    stats_op, ordered = STATS_OP[op]
    want = tdntt.four_step_collective_stats(n, b, d, op=stats_op,
                                            ordered=ordered)
    assert live == [want["count"], want["bytes"]]
    assert led.total_bytes() == want["bytes"]      # all-to-alls only


@pytest.mark.parametrize("n,d", [(64, 8), (4096, 4), (16384, 2)])
@pytest.mark.parametrize("negacyclic", [True, False])
def test_sharded_product_equals_the_local_kernel_and_numpy(n, d,
                                                           negacyclic):
    """The distributed product == ``ntt_polymul`` (its plain version here)
    == the numpy reference; the forward transform and its inverse ==
    numpy's ``ntt`` and the input."""
    params = NTTParams.make(n)
    mesh = sharding.make_mesh((d,), ("data",), device="cpu")
    rng = np.random.default_rng(n + d)
    a = rng.integers(0, params.q, (3, n)).astype(np.uint32)
    b = rng.integers(0, params.q, (3, n)).astype(np.uint32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = tkntt.residues_to_numpy(tdntt.make_sharded_ntt_polymul(
        mesh, params, negacyclic=negacyclic)(ta, tb))
    local = tkntt.residues_to_numpy(tkntt.ntt_polymul(
        ta, tb, params, negacyclic=negacyclic))
    oracle = negacyclic_polymul if negacyclic else cyclic_polymul
    want = np.stack([oracle(a[i], b[i], params) for i in range(3)])
    assert (got == local).all() and (got == want).all()
    fwd = tdntt.make_sharded_ntt(mesh, params)(ta)
    assert (tkntt.residues_to_numpy(fwd)
            == np.stack([ntt(a[i], params) for i in range(3)])).all()
    back = tdntt.make_sharded_ntt(mesh, params, inverse=True)(fwd)
    assert (tkntt.residues_to_numpy(back) == a).all()


@pytest.mark.parametrize("n,d", [(64, 2), (1024, 8), (16384, 4)])
def test_tables_equal_the_reference(n, d):
    """The step-3 tables and the twist/untwist/scale tables ``==`` the
    reference's numpy; the inverse step-3 table with the factor n the
    scaled sub-transforms take out is the reference's times n mod q."""
    tp, jp = NTTParams.make(n), JParams.make(n)
    for inverse in (False, True):
        got = tdntt._step3_twiddle(tp, d, inverse)
        want = jdntt._step3_twiddle(jp, d, inverse)
        assert got.dtype == want.dtype and (got == want).all()
    for kind in ("twist", "untwist", "scale"):
        got, want = tdntt._edge_table(tp, kind), jdntt._edge_table(jp, kind)
        assert got.dtype == want.dtype and (got == want).all()
    inv = tdntt._step3_twiddle(tp, d, True).astype(np.int64)
    n_mont = n * (1 << 32) % tp.q
    folded = tkntt.mont_mul(torch.from_numpy(inv), n_mont, tp.q, tp.qinv)
    assert (folded.numpy() == tdntt._inverse_step3(tp, d)).all()


def test_one_shard_refuses_as_the_reference():
    """D = 1 has no four-step split: both raise from ``subparams(1)``."""
    n = 64
    a = np.arange(2 * n, dtype=np.uint32).reshape(2, n)
    with pytest.raises(ValueError, match="must divide"):
        jdntt.make_sharded_ntt(jax.make_mesh((1,), ("data",)),
                               JParams.make(n))(a)
    with pytest.raises(ValueError, match="must divide"):
        tdntt.make_sharded_ntt(sharding.make_mesh((1,), ("data",),
                                                  device="cpu"),
                               NTTParams.make(n))(torch.from_numpy(a))


@pytest.mark.parametrize("op,ordered", list(STATS_OP.values()) +
                         [("ntt", False), ("intt", False)])
def test_collective_stats_closed_form_is_the_reference(op, ordered):
    for n, b, d in ((1024, 4, 8), (65536, 3, 4)):
        assert tdntt.four_step_collective_stats(n, b, d, op=op,
                                                ordered=ordered) == \
            jdntt.four_step_collective_stats(n, b, d, op=op, ordered=ordered)


def test_residues_come_back_contiguous():
    """The kernels read rows of contiguous words: a transposed view's
    residues are copied into rows (``to`` alone keeps its strides). The
    four-step NTT's first transform at batch 1 hands ``ntt_batched`` such
    a view."""
    x = torch.arange(8 * 1024, dtype=torch.int32).reshape(1, 8, 1024)
    view = x.swapaxes(-1, -2).reshape(-1, 8)
    assert not view.is_contiguous()
    got = tkntt._as_residues(view, 12289)
    assert got.is_contiguous() and torch.equal(got, view % 12289)
    assert tkntt._as_residues(view.to(torch.uint32), 12289).is_contiguous()
