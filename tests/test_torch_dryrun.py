"""The port's dry-run (``repro_torch.launch.dryrun``, ``launch/specs.py``,
``lm.param_specs``, ``lm.decode_state_specs``, ``adamw.state_specs``) on
the CPU, against the reference's own functions.

The reference's meshes are duck-typed here (its ``sanitize_spec`` reads a
mesh's ``shape`` only), so no forced host devices are needed: the
production meshes (16, 16) and (2, 16, 16) and the (2, 2, 2) test mesh.
The specs are compared leaf for leaf through the port's names (a block
leaf's spec is the reference's stacked leaf's without its leading layer
entry); the argument bytes per device are the reference's spec arithmetic
over its own abstract trees, and on (2, 2, 2) the reference's compiled
``run_cell`` numbers, which that arithmetic gives byte for byte:
61,145,757,828 for qwen3-1.7b x decode_32k and 222,748,932 for
fourierpim-lm x train_4k.
"""
import functools
import json
import math
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax

from repro.configs import registry as jreg
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch.configs import registry as treg
from repro_torch.dist import sharding
from repro_torch.launch import dryrun
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as tadamw

ARCHS = list(jreg.ARCH_MODULES)
SHAPES = list(jreg.SHAPES)
MESHES = {"singlepod": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}}
REFERENCE_BYTES = {("qwen3-1.7b", "decode_32k"): 61_145_757_828,
                   ("fourierpim-lm", "train_4k"): 222_748_932}


def _duck(shape: dict):
    return types.SimpleNamespace(shape=dict(shape))


def _meta_mesh(shape: dict) -> sharding.Mesh:
    return sharding.make_mesh(tuple(shape.values()), tuple(shape),
                              device="meta")


def _flat(tree, prefix=""):
    """A reference pytree (dicts, PartitionSpec or array leaves) by
    '/'-joined keys."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = v
    return out


def _port_key(name: str) -> tuple[str, bool]:
    """A port parameter name -> (the reference's '/'-key, whether it is a
    block leaf, stacked over the layers there)."""
    head, _, rest = name.partition(".")
    if head != "blocks":
        return name, False
    _, _, rest = rest.partition(".")
    return "blocks/" + rest.replace(".", "/"), True


@functools.lru_cache(maxsize=None)
def _reference_abstract(arch: str):
    jc = jreg.get_config(arch)
    opt = {dt: jadamw.OptConfig(state_dtype=dt)
           for dt in ("float32", "int8")}
    return (jc, jlm.abstract_params(jc),
            {dt: jspecs.abstract_opt_state(jc, o) for dt, o in opt.items()},
            opt)


@functools.lru_cache(maxsize=None)
def _port_abstract(arch: str):
    tc = treg.get_config(arch)
    params = tspecs.abstract_params(tc)
    opt = {dt: tadamw.OptConfig(state_dtype=dt)
           for dt in ("float32", "int8")}
    return tc, params, {dt: tadamw.init_state(params, o)
                        for dt, o in opt.items()}, opt


def test_cells_status_matches_reference():
    """``status``/``reason`` of all 44 (arch x shape) cells: the port's
    ``cell_supported`` == the reference's, and ``run_cell`` returns the
    skip with its reason without running."""
    mesh = _meta_mesh(MESHES["2x2x2"])
    for arch in ARCHS:
        for shape in SHAPES:
            ok, reason = jreg.cell_supported(jreg.get_config(arch),
                                             jreg.SHAPES[shape])
            assert treg.cell_supported(treg.get_config(arch),
                                       treg.SHAPES[shape]) == (ok, reason)
            if not ok:
                assert dryrun.run_cell(arch, shape, mesh) == {
                    "arch": arch, "shape": shape, "status": "skipped",
                    "reason": reason}


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch):
    """On both production meshes and (2, 2, 2): the sanitized
    ``param_specs``, ``state_specs`` (float32 and int8) and
    ``decode_state_specs`` == the reference's, leaf for leaf."""
    jc, jparams, jopt, jcfg = _reference_abstract(arch)
    tc, tparams, topt, tcfg = _port_abstract(arch)
    jdec = jspecs.abstract_decode_state(jc, jreg.SHAPES["decode_32k"])
    tdec = tspecs.abstract_decode_state(tc, treg.SHAPES["decode_32k"])
    for shape in MESHES.values():
        jm, tm = _duck(shape), _meta_mesh(shape)
        jp = _flat(jspecs.sanitize_tree(jlm.param_specs(jc), jparams, jm))
        tp = sharding.sanitize_tree(tlm.param_specs(tc), tparams, tm)
        assert len(tp) == sum(tc.num_layers if k.startswith("blocks/") else 1
                              for k in jp)
        for name, spec in tp.items():
            key, block = _port_key(name)
            want = tuple(jp[key])[1:] if block else tuple(jp[key])
            assert tuple(spec) == want, (name, spec, want)
        for dt in ("float32", "int8"):
            jo = _flat(jspecs.sanitize_tree(
                jadamw.state_specs(jspecs.sanitize_tree(
                    jlm.param_specs(jc), jparams, jm), jcfg[dt]),
                jopt[dt], jm))
            shapes = tspecs.flatten(topt[dt])
            to = tspecs.flatten(tadamw.state_specs(tp, tcfg[dt]))
            to = {k: sharding.sanitize_spec(v, tuple(shapes[k].shape), tm)
                  for k, v in to.items()}
            for name, spec in to.items():
                part, _, rest = name.partition("/")
                if part == "step":
                    assert tuple(spec) == tuple(jo["step"]) == ()
                    continue
                leaf, _, sub = rest.partition("/")
                key, block = _port_key(leaf)
                want = jo["/".join(filter(None, [part, key, sub]))]
                if block and sub != "orig_last":
                    want = tuple(want)[1:]
                assert tuple(spec) == tuple(want), (dt, name)
        jd = jspecs.sanitize_tree(jlm.decode_state_specs(jc), jdec, jm)
        td = sharding.sanitize_tree(tlm.decode_state_specs(tc), tdec, tm)
        assert {k: tuple(v) for k, v in td.items()} == \
            {k: tuple(v) for k, v in jd.items()}


def _reference_argument_bytes(arch: str, shape_name: str, mesh) -> int:
    """The reference's per-device argument bytes: each leaf of its own
    abstract trees over the product of its sanitized spec's mesh axes."""
    jc, jparams, jopt, jcfg = _reference_abstract(arch)
    shape = jreg.SHAPES[shape_name]
    pspecs = jspecs.sanitize_tree(jlm.param_specs(jc), jparams, mesh)
    trees = [(jparams, pspecs)]
    if shape.kind == "train":
        dt = jspecs.opt_config_for(jc).state_dtype
        trees.append((jopt[dt], jspecs.sanitize_tree(
            jadamw.state_specs(pspecs, jcfg[dt]), jopt[dt], mesh)))
    if shape.kind == "decode":
        st = jspecs.abstract_decode_state(jc, shape)
        trees.append((st, jspecs.sanitize_tree(jlm.decode_state_specs(jc),
                                                st, mesh)))
        sds, sp = jspecs.decode_input_specs(jc, shape)
    else:
        sds, sp = jspecs.batch_specs(jc, shape,
                                     with_labels=shape.kind == "train")
    sds = {k: v for k, v in sds.items() if v is not None}
    trees.append((sds, {k: jspecs.sanitize_spec(sp[k], sds[k].shape, mesh)
                        for k in sds}))
    total = 0
    for leaves, specs in trees:
        lf, sf = _flat(leaves), _flat(specs)
        for k, x in lf.items():
            parts = math.prod(mesh.shape[a] for e in sf[k] if e is not None
                              for a in (e if isinstance(e, tuple) else (e,)))
            total += int(np.prod(x.shape)) * x.dtype.itemsize // parts
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_match_reference_arithmetic(arch):
    """Every cell's ``argument_bytes_per_device`` on both production
    meshes == the reference's spec arithmetic."""
    tc = treg.get_config(arch)
    for name in ("singlepod", "multipod"):
        shape = MESHES[name]
        for cell in SHAPES:
            got = dryrun.argument_bytes(tc, treg.SHAPES[cell],
                                        _meta_mesh(shape))
            assert got == _reference_argument_bytes(arch, cell,
                                                    _duck(shape)), \
                (name, cell)


@pytest.mark.parametrize("arch,shape", list(REFERENCE_BYTES))
def test_run_cell_on_2x2x2_gives_the_reference_bytes(arch, shape):
    """``run_cell`` on the meta (2, 2, 2) mesh: the argument bytes the
    reference's compiled ``run_cell`` reports, the keys only XLA gives
    null with their reason, the ledger's kinds under the reference's
    names."""
    r = dryrun.run_cell(arch, shape, _meta_mesh(MESHES["2x2x2"]),
                        verbose=False)
    assert r["status"] == "ok"
    assert r["mesh"] == MESHES["2x2x2"]
    assert r["argument_bytes_per_device"] == REFERENCE_BYTES[arch, shape]
    for key in ("temp_bytes_per_device", "alias_bytes_per_device",
                "peak_bytes_per_device", "probe"):
        assert r[key] is None and key in r["not_measured"]
    assert set(r["collective_bytes"]) == set(dryrun.KINDS.values()) | \
        {"counts"}
    assert r["collective_bytes"]["all-reduce"] > 0
    assert r["flops_per_device"] > 0 and r["output_bytes_per_device"] > 0
    assert r["model_params"] == treg.get_config(arch).param_count()
    json.dumps(r)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "fourierpim-lm"])
def test_flops_per_device_halve_on_two_model_shards(arch):
    """On (1, 1, 2) every product is split in two: the flops a device are
    exactly half the unsharded meta run's."""
    one, two = (dryrun.run_cell(arch, "train_4k", _meta_mesh(
        {"pod": 1, "data": 1, "model": m}), verbose=False)
        for m in (1, 2))
    assert one["flops_per_device"] > 0
    assert two["flops_per_device"] * 2 == one["flops_per_device"]


class _Allocations(TorchDispatchMode):
    """The largest tensor an op makes off the meta device."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in jax.tree_util.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.largest = max(self.largest, t.numel())
        return out


def test_dry_run_allocates_nothing():
    """A cell's run makes no tensor off the meta device but scalars."""
    with _Allocations() as mode:
        dryrun.run_cell("granite-moe-3b-a800m", "decode_32k",
                        _meta_mesh(MESHES["2x2x2"]), verbose=False)
    assert mode.largest <= 1


def test_cli_writes_a_cell(tmp_path):
    dryrun.main(["--arch", "fourierpim-lm", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    with open(tmp_path / "singlepod" / "fourierpim-lm__decode_32k.json") as f:
        r = json.load(f)
    assert r["status"] == "ok" and r["mesh"] == MESHES["singlepod"]
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "fourierpim-lm"])


def test_production_meshes():
    assert make_production_mesh().shape == MESHES["singlepod"]
    m = make_production_mesh(multi_pod=True)
    assert m.shape == MESHES["multipod"] and m.size == 512
    assert all(d.type == "meta" for d in m.devices)
