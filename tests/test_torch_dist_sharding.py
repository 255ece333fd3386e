"""The port's mesh, sharding rules and collectives (``repro_torch.dist``)
against the reference's (``repro.dist``).

The rules table, ``sanitize_spec`` and ``logical_to_spec`` are copies:
they give the reference's spec, result for result, on a grid of meshes,
shapes and logical axes, and raise its messages. The collectives, the
compressed psum and ``device_put``'s placement are held against the
reference on 8 forced host devices: one subprocess a module writes the
reference's outputs and ledger to an ``.npz``.
"""
import itertools
import json
import types

import numpy as np
import pytest
import torch

from conftest import run_in_subprocess_devices
from repro.dist import sharding as jsharding
from repro_torch.dist import collectives as tcoll
from repro_torch.dist import sharding as tsharding
from repro_torch.ft import checkpoint as ckpt

MESHES = [{"data": 2, "model": 4}, {"pod": 2, "data": 2, "model": 2},
          {"model": 8}, {"data": 1, "model": 1}, {"data": 4}]
SHAPES = [(8, 32), (8, 30), (6, 12), (16, 16), (1, 4)]
LOGICAL = [None, "batch", "data", "pod", "model", "sp", "expert", "vocab"]


def _mesh_like(shape):
    return types.SimpleNamespace(shape=dict(shape))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    f"{k}{v}" for k, v in m.items()))
def test_logical_to_spec_is_the_reference_on_a_grid(mesh):
    """Every pair of logical axes on every shape: the same spec."""
    m = _mesh_like(mesh)
    for shape in SHAPES:
        for axes in itertools.product(LOGICAL, repeat=2):
            got = tsharding.logical_to_spec(axes, shape, m)
            want = jsharding.logical_to_spec(axes, shape, m)
            assert tuple(got) == tuple(want), (mesh, shape, axes)
            spec = tsharding.P(("pod", "data"), "model")
            assert tuple(tsharding.sanitize_spec(spec, shape, m)) == \
                tuple(jsharding.sanitize_spec(jsharding.P(("pod", "data"),
                                                          "model"),
                                              shape, m))


def test_rules_table_and_errors_are_the_reference():
    m = _mesh_like({"data": 2, "model": 4})
    for mod in (tsharding, jsharding):
        with mod.axis_rules({"sp": ("data",)}):
            assert mod.current_rules()["sp"] == ("data",)
        with mod.axis_rules({"only": ("model",)}, extend=False):
            assert set(mod.current_rules()) == {"only"}
    assert tsharding.current_rules() == jsharding.current_rules()
    with tsharding.axis_rules({"sp": ("data",)}), \
            jsharding.axis_rules({"sp": ("data",)}):
        assert tuple(tsharding.logical_to_spec((None, "sp"), (32, 8), m)) \
            == tuple(jsharding.logical_to_spec((None, "sp"), (32, 8), m))
    try:
        for mod in (tsharding, jsharding):
            mod.register_rule("rows", "data")
        assert tsharding.current_rules() == jsharding.current_rules()
    finally:
        tsharding.reset_rules()
        jsharding.reset_rules()
    assert "rows" not in tsharding.current_rules()
    for bad in [lambda mod: mod.logical_to_spec(("bogus", None), (2, 2), m),
                lambda mod: mod.logical_to_spec(("batch",), (2, 2), m),
                lambda mod: mod.logical_to_spec((3, None), (2, 2), m),
                lambda mod: mod.register_rule(""),
                lambda mod: mod.register_rule("x", 3)]:
        with pytest.raises(ValueError) as want:
            bad(jsharding)
        with pytest.raises(ValueError) as got:
            bad(tsharding)
        assert str(got.value) == str(want.value)


def test_constrain_outside_and_inside_a_mesh():
    """Outside a mesh: validated, returned unchanged (the reference's
    contract). Inside: the tensor must lie on the mesh's devices."""
    x = torch.zeros(8, 32)
    assert tsharding.constrain(x, "batch", "model") is x
    with pytest.raises(ValueError, match="unknown logical axis"):
        tsharding.constrain(x, "bogus", None)
    with pytest.raises(ValueError, match="rank"):
        tsharding.constrain(x, "batch")
    mesh = tsharding.make_mesh((2, 4), ("data", "model"), device="cpu")
    with tsharding.use_mesh(mesh):
        assert tsharding.current_mesh() is mesh
        assert tsharding.constrain(x, "batch", "model") is x
        assert tsharding.constrain(x, "pod", None) is x
        foreign = types.SimpleNamespace(ndim=2, shape=(8, 32),
                                        device=torch.device("meta"))
        with pytest.raises(ValueError, match="cannot be sharded"):
            tsharding.constrain(foreign, "batch", "model")
    assert tsharding.current_mesh() is None
    one = tsharding.make_mesh((1,), ("data",), device="cpu")
    with tsharding.use_mesh(one):
        assert tsharding.constrain(torch.zeros(4), "batch") is not None


def test_mesh_places_and_describes_its_shards():
    mesh = tsharding.make_mesh((8,), ("model",), device="cpu")
    assert mesh.shape == {"model": 8} and mesh.size == 8
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert mesh.describe() == ("mesh (model=8): 8 shard(s) on 1 device(s): "
                               "cpu holds shards 0-7")
    assert mesh.axis_devices("model") == mesh.devices
    two = tsharding.make_mesh((2, 4), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="split one axis"):
        two.axis_devices("model")
    with pytest.raises(ValueError, match="have no 'seq'"):
        mesh.axis_devices("seq")
    with pytest.raises(ValueError, match="devices for a mesh"):
        tsharding.Mesh(("a",), (2,), (torch.device("cpu"),))
    meta = tsharding.make_mesh((2,), ("a",), device="meta")
    assert all(d.type == "meta" for d in meta.devices)
    with pytest.raises(ValueError, match="cuda, cpu or meta"):
        tsharding.make_mesh((2,), ("a",), device="mps")


def test_cuda_mesh_needs_a_card():
    """Without a card a CUDA mesh raises rather than landing on the CPU;
    with one, shards go round-robin over the cards."""
    if torch.cuda.is_available():
        mesh = tsharding.make_mesh((8,), ("model",))
        cards = torch.cuda.device_count()
        assert [d.index for d in mesh.devices] == [i % cards
                                                   for i in range(8)]
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsharding.make_mesh((8,), ("model",))


def test_shard_map_splits_calls_and_joins():
    mesh = tsharding.make_mesh((4,), ("model",), device="cpu")
    seen = {}

    def body(xs, ys, *, idx):
        seen["idx"] = idx
        return [x * 10 + y for x, y in zip(xs, ys)]

    x = torch.arange(24.0).reshape(2, 12)
    got = tsharding.shard_map(body, mesh, axis_name="model")(x, x + 1)
    assert seen["idx"] == [0, 1, 2, 3]
    assert torch.equal(got, x * 11 + 1)
    with pytest.raises(ValueError, match="does not split"):
        tsharding.shard_map(body, mesh, axis_name="model")(
            torch.zeros(2, 6), torch.zeros(2, 6))


REFERENCE = """
import json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.dist import collectives
from repro.dist.compat import shard_map

inputs = np.load({inputs!r})
specs = json.loads({specs!r})
out = {{}}
mesh = Mesh(np.array(jax.devices()[:4]), ("pod",))
x = jnp.asarray(inputs["x"])

def f(v):
    return (collectives.psum(v, "pod"), collectives.pmean(v, "pod"),
            collectives.all_gather(v, "pod", axis=0),
            collectives.all_gather(v, "pod", axis=1, tiled=True),
            collectives.all_to_all(v, "pod", split_axis=2, concat_axis=1),
            collectives.ppermute(v, "pod", [(0, 1), (1, 2), (2, 3), (3, 0)]),
            collectives.ppermute(v, "pod", [(0, 2), (1, 3)]))

fn = shard_map(f, mesh=mesh, in_specs=(P("pod"),), out_specs=P("pod"),
               check_vma=False)
with collectives.ledger() as led:
    compiled = jax.jit(fn).lower(x).compile()
for i, r in enumerate(compiled(x)):
    out[f"coll_{{i}}"] = np.asarray(r)
out["coll_ledger"] = np.array([[led.counts[k], led.bytes_by_kind[k]]
                               for k in collectives.KINDS])

def g(gl, el):
    return collectives.compressed_psum_leaf(gl, el, "pod")

cp = shard_map(g, mesh=mesh, in_specs=(P("pod"), P("pod")),
               out_specs=(P("pod"), P("pod")), check_vma=False)
grads = jnp.asarray(inputs["grads"])
with collectives.ledger() as led:
    compiled = jax.jit(cp).lower(grads, jnp.zeros_like(grads)).compile()
red, err = compiled(grads, jnp.zeros_like(grads))
red2, err2 = compiled(grads, err)
out.update(red=np.asarray(red), err=np.asarray(err), red2=np.asarray(red2),
           err2=np.asarray(err2),
           cp_ledger=np.array([led.counts["compressed-psum"],
                               led.bytes_by_kind["compressed-psum"]]))

grid = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
for i, spec in enumerate(specs):
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    idx = NamedSharding(grid, spec).devices_indices_map((8, 16))
    out[f"place_{{i}}"] = np.array(
        [[(s.start or 0, s.stop if s.stop is not None else dim)
          for s, dim in zip(idx[d], (8, 16))]
         for d in grid.devices.flat])
np.savez({result!r}, **out)
print("OK")
"""

PLACE_SPECS = [("data", "model"), (None, "model"), ("model", None),
               (None, ("data", "model")), (None, None), ("data", None)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_sharding")
    rng = np.random.default_rng(7)
    inputs = {"x": rng.standard_normal((4, 8, 16)).astype(np.float32),
              "grads": rng.standard_normal((4, 64)).astype(np.float32)
              * np.float32(3)}
    np.savez(d / "inputs.npz", **inputs)
    out = run_in_subprocess_devices(REFERENCE.format(
        inputs=str(d / "inputs.npz"), specs=json.dumps(PLACE_SPECS),
        result=str(d / "result.npz")), n_devices=8)
    assert "OK" in out
    return inputs, dict(np.load(d / "result.npz"))


def _blocks(a, d):
    return [torch.from_numpy(b.copy()) for b in np.split(a, d)]


def test_collectives_equal_the_reference(reference):
    """psum, pmean, all_gather (stacked and tiled), all_to_all and two
    ppermutes (one leaves shards without a source: zeros) over four shards
    give the reference's blocks, and the ledger the reference's counts and
    bytes."""
    inputs, want = reference
    xs = _blocks(inputs["x"], 4)
    with tcoll.ledger() as led:
        got = [tcoll.psum(xs), tcoll.pmean(xs),
               tcoll.all_gather(xs, axis=0),
               tcoll.all_gather(xs, axis=1, tiled=True),
               tcoll.all_to_all(xs, split_axis=2, concat_axis=1),
               tcoll.ppermute(xs, [(0, 1), (1, 2), (2, 3), (3, 0)]),
               tcoll.ppermute(xs, [(0, 2), (1, 3)])]
    for i, blocks in enumerate(got):
        joined = torch.cat(blocks).numpy()
        np.testing.assert_allclose(joined, want[f"coll_{i}"], rtol=1e-6,
                                   atol=1e-6)
    assert [[led.counts[k], led.bytes_by_kind[k]] for k in tcoll.KINDS] == \
        want["coll_ledger"].tolist()


def test_compressed_psum_leaf_equals_the_reference(reference):
    """Two error-feedback steps at D = 4 on the same seeded gradients: the
    reduced mean and the residuals the reference's, and its ledger."""
    inputs, want = reference
    grads = _blocks(inputs["grads"], 4)
    with tcoll.ledger() as led:
        red, err = tcoll.compressed_psum_leaf(
            grads, [torch.zeros_like(g) for g in grads])
    red2, err2 = tcoll.compressed_psum_leaf(grads, err)
    for got, key in ((red, "red"), (err, "err"), (red2, "red2"),
                     (err2, "err2")):
        np.testing.assert_allclose(torch.cat(got).numpy(), want[key],
                                   rtol=0, atol=1e-6)
    assert [led.counts["compressed-psum"],
            led.bytes_by_kind["compressed-psum"]] == \
        want["cp_ledger"].tolist()
    # the mean plus the residual recovers the compensated gradient's mean
    assert all(torch.equal(r, red[0]) for r in red)


def test_compressed_psum_over_trees():
    rng = np.random.default_rng(2)
    trees = [{"w": torch.from_numpy(rng.standard_normal((3, 4))
                                    .astype(np.float32)),
              "b": [torch.from_numpy(rng.standard_normal(4)
                                     .astype(np.float32))]}
             for _ in range(4)]
    errs = tcoll.zeros_like_errs(trees)
    assert all(torch.count_nonzero(e["w"]) == 0 for e in errs)
    red, new = tcoll.compressed_psum(trees, errs)
    want, want_err = tcoll.compressed_psum_leaf([t["w"] for t in trees],
                                                [e["w"] for e in errs])
    for i in range(4):
        assert torch.equal(red[i]["w"], want[i])
        assert torch.equal(new[i]["w"], want_err[i])
        assert isinstance(red[i]["b"], list) and red[i]["b"][0].shape == (4,)


def test_device_put_places_blocks_as_jax_does(reference):
    """Each shard's block of ``device_put`` on a (data 2, model 4) mesh is
    the slice jax's ``NamedSharding`` gives that device."""
    _, want = reference
    mesh = tsharding.make_mesh((2, 4), ("data", "model"), device="cpu")
    x = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    for i, spec in enumerate(PLACE_SPECS):
        blocks = tsharding.device_put(
            x, tsharding.NamedSharding(mesh, tsharding.P(*spec)))
        assert len(blocks) == 8
        for block, ((r0, r1), (c0, c1)) in zip(blocks, want[f"place_{i}"]):
            assert torch.equal(block, x[r0:r1, c0:c1])


def test_restore_places_leaves_by_spec(tmp_path):
    """``restore(..., shardings=)`` returns a placed leaf as its blocks on
    the mesh and leaves the rest as they are."""
    d = str(tmp_path / "ck")
    tree = {"w": np.arange(32, dtype=np.float32).reshape(4, 8),
            "s": np.float32(3.0)}
    ckpt.save(d, 5, tree)
    mesh = tsharding.make_mesh((4,), ("model",), device="cpu")
    like = {"w": torch.zeros(4, 8), "s": np.float32(0)}
    step, got = ckpt.restore_latest(
        d, like, shardings={"w": tsharding.NamedSharding(
            mesh, tsharding.P(None, "model")), "s": None})
    assert step == 5
    assert [b.shape for b in got["w"]] == [(4, 2)] * 4
    assert torch.equal(torch.cat(got["w"], dim=1),
                       torch.from_numpy(tree["w"]))
    assert got["s"] == np.float32(3.0)
    assert torch.equal(ckpt.restore(d, 5, like)["w"],
                       torch.from_numpy(tree["w"]))
