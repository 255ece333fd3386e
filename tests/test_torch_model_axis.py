"""The LM split over a mesh's ``model`` axis (``models/sharded.py``) on the
CPU, against the reference's UNSHARDED ``lm.loss_fn``, its gradient,
``lm.forward`` and its greedy prefill + decode loop: what the reference's
``tests/test_dist_system.py::test_loss_invariant_under_sharding`` claims
its sharded loss equals.

Every arch of the registry at its smoke size, on CPU meshes (pod, data,
model) = (1, 1, 2), (1, 2, 2) and (1, 1, 4), in both parameter layouts:
``replicated`` (the training CLI's) and ``specs`` (the dry-run's: the
masters stored as their sanitized ``param_specs`` blocks, gathered over
(pod, data), the batch cut over (pod, data)). The weights are the
reference's own (``convert.params_from_jax``); inputs are made with numpy
from a seed. Tolerances, the unsharded port's (``test_torch_train.py``,
``test_torch_models.py``): the loss rtol 1e-5, each gradient within 1e-4
of its largest magnitude, the logits rtol = atol = 1e-4 (the model
shards' fp32 partial sums are summed in another order: seen under 3e-6).
The greedy tokens are ``==`` wherever the reference's top two logits are
more than ten times the logits' tolerance apart.

Also: the collectives' backward (each transpose, and what it records), the
byte ledger of a forward and of a training step against
``sharded.collective_form`` for every arch, remat replaying collectives
without recording them twice, the MoE's kept and dropped slots ``==`` the
unsharded port's, the train step under ``--mesh 1x2`` and ``2x2`` against
the reference's unsharded step, a resume under ``--mesh 1x2`` bit for bit,
the parameter layouts' round trip, and the kernel wrappers on ``meta``.
"""
import concurrent.futures
import dataclasses
import functools
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.data import pipeline as jpipe
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.configs import registry as treg
from repro_torch.dist import collectives, sharding
from repro_torch.ft import checkpoint as ckpt_lib
from repro_torch.kernels import _build
from repro_torch.kernels import attention as tkattn
from repro_torch.kernels import fft as tkfft
from repro_torch.kernels import ntt as tkntt
from repro_torch.launch import train as train_mod
from repro_torch.models import convert, lm as tlm, sharded
from repro_torch.models.layers import moe as tmoe
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep

ARCHS = list(jreg.ARCH_MODULES)
MESHES = [(1, 1, 2), (1, 2, 2), (1, 1, 4)]
LAYOUTS = ["replicated", "specs"]
#: the archs whose greedy loop the reference runs here: the attention
#: family's representative, the MoE, the recurrences and the Fourier mixer
GREEDY = ["qwen3-1.7b", "granite-moe-3b-a800m", "rwkv6-7b", "hymba-1.5b",
          "fourierpim-lm"]
B, S, GEN = 2, 16, 4
TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL, GRAD_REL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread a worker (under xdist several
    workers' thread pools contend, as ``test_torch_two_pass.py`` notes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(cfg, seed=1) -> dict:
    """Tokens (or embeddings), labels (a few -1) and M-RoPE positions, as
    numpy."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    out["labels"][0, :3] = -1
    if cfg.frontend == "embeddings":
        out["embeds"] = (rng.standard_normal((B, S, cfg.d_model))
                         * 0.02).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    if cfg.mrope_sections is not None:
        out["positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32)[None, :, None], (B, S, 3)).copy()
    return out


def _compiled(fn, *args):
    """``fn`` jitted for ``args`` with XLA's CPU backend at optimization
    level 0: the reference's own program, compiled in about half the time
    (its values agree with the default level's within fp32 rounding)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})


@functools.lru_cache(maxsize=None)
def _references() -> dict:
    """Every arch's reference numbers, computed in a few threads (XLA
    compiles outside the interpreter lock), once: {arch: future}."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=3)
    futures = {arch: pool.submit(_run_reference, arch) for arch in ARCHS}
    pool.shutdown(wait=False)
    return futures


def _reference(arch: str) -> dict:
    """The reference's numbers for ``arch`` (numpy)."""
    return _references()[arch].result()


def _run_reference(arch: str) -> dict:
    """The reference, unsharded, in one jit: its ``init_params`` (the
    weights both sides use), the loss, every parameter's gradient, the
    forward's logits and (GREEDY archs) the greedy loop's logits, its
    prefill's and GEN decode steps'. Returns numpy arrays only."""
    jc = jreg.get_config(arch).scaled_down()
    tc = treg.get_config(arch).scaled_down()
    inp = _inputs(tc)
    greedy = arch in GREEDY

    def everything(key, b):
        p = jlm.init_params(jc, key)
        loss, grads = jax.value_and_grad(lambda q: jlm.loss_fn(jc, q, b))(p)
        logits = jlm.forward(jc, p, b.get("tokens"),
                             positions=b.get("positions"),
                             embeds=b.get("embeds"))[0]
        steps = []
        if greedy:
            out, state = jlm.prefill(jc, p, b["tokens"],
                                     cache_capacity=S + GEN)
            steps.append(out)
            for i in range(GEN):
                out, state = jlm.decode_step(jc, p, state,
                                             jnp.argmax(out, axis=-1),
                                             jnp.int32(S + i))
                steps.append(out)
        return p, loss, grads, logits, steps

    args = (jax.random.key(0), {k: jnp.asarray(v) for k, v in inp.items()})
    tree, loss, grads, logits, steps = jax.tree.map(
        np.asarray, _compiled(everything, *args)(*args))
    return dict(jc=jc, tc=tc, tree=tree, inputs=inp, loss=float(loss),
                grads=convert.params_from_jax(tc, grads), logits=logits,
                steps=[s.astype(np.float32) for s in steps])


def _shards(tc, params, mesh_shape, layout) -> sharded.Shards:
    mesh = sharding.make_mesh(mesh_shape, ("pod", "data", "model"),
                              device="cpu")
    held = params if layout == "replicated" else \
        convert.shard_params(tc, params, mesh)
    return sharded.Shards(tc, mesh, held, layout=layout)


def _torch(inp: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in inp.items()}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_grads_and_logits_match_reference(arch, mesh, layout):
    """The sharded loss and every parameter's gradient (gathered whole)
    against ``jax.value_and_grad(lm.loss_fn)``, and the sharded forward's
    logits against ``lm.forward``, all unsharded."""
    ref = _reference(arch)
    tc = ref["tc"]
    sh = _shards(tc, convert.params_from_jax(tc, ref["tree"]), mesh, layout)
    batch = _torch(ref["inputs"])
    loss, grads = sharded.value_and_grad(sh, batch)
    if layout == "specs":
        grads = convert.gather_params(tc, grads, sh.mesh)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=LOSS_RTOL)
    assert set(grads) == set(ref["grads"])
    for name, want in ref["grads"].items():
        scale = float(want.abs().max()) or 1.0
        np.testing.assert_allclose(grads[name].numpy(), want.numpy(),
                                   rtol=GRAD_REL, atol=GRAD_REL * scale,
                                   err_msg=name)
    logits = sharded.forward(sh, batch.get("tokens"),
                             positions=batch.get("positions"),
                             embeds=batch.get("embeds"))
    assert logits.shape == (B, S, tc.vocab_padded)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], **TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", GREEDY)
def test_sharded_greedy_loop_matches_reference(arch, mesh):
    """The sharded prefill and GEN decode steps, fed the reference's greedy
    tokens, in both layouts: each step's logits within the tolerance and
    its argmax the reference's wherever the reference's top two are apart
    by more than ten times it and its argmax is a token."""
    ref = _reference(arch)
    tc = ref["tc"]
    params = convert.params_from_jax(tc, ref["tree"])
    tokens = torch.from_numpy(ref["inputs"]["tokens"])
    for layout in LAYOUTS:
        sh = _shards(tc, params, mesh, layout)
        logits, states = sharded.prefill(sh, tokens, cache_capacity=S + GEN)
        for i, want in enumerate(ref["steps"]):
            got = logits.float().numpy()
            np.testing.assert_allclose(got, want, **TOL,
                                       err_msg=f"{layout} step {i}")
            top2 = np.sort(want, axis=-1)[:, -2:]
            pick = want.argmax(axis=-1)
            clear = (top2[:, 1] - top2[:, 0] > 10 * TOL["atol"]) & \
                (pick < tc.vocab_size)
            assert clear.any()
            np.testing.assert_array_equal(got.argmax(axis=-1)[clear],
                                          pick[clear])
            if i < GEN:
                logits, states = sharded.decode_step(
                    sh, states, torch.from_numpy(pick).long(), S + i)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mixtral-8x22b"])
def test_moe_kept_and_dropped_slots_equal_unsharded(arch, mesh,
                                                    monkeypatch):
    """The routing every shard computes (experts, queue positions, kept
    slots) ``==`` the unsharded port's, layer by layer (the unsharded
    routing is held to the reference's by ``test_torch_moe.py``), at a
    capacity that drops slots, in both layouts (the specs layout's data
    groups each route their rows of the batch)."""
    ref = _reference(arch)
    tc = dataclasses.replace(ref["tc"], capacity_factor=0.5)
    params = convert.params_from_jax(tc, ref["tree"])
    calls = []
    real = tmoe.route

    def recorded(router, xg, cfg):
        r = real(router, xg, cfg)
        calls.append((r.expert.clone(), r.pos.clone(), r.kept.clone()))
        return r

    monkeypatch.setattr(tmoe, "route", recorded)
    tokens = torch.from_numpy(ref["inputs"]["tokens"])
    convert.build(tc, params, "cpu")(tokens)
    want = list(calls)
    assert any(not bool(k.all()) for _, _, k in want)      # slots dropped
    for layout in LAYOUTS:
        calls.clear()
        sh = _shards(tc, params, mesh, layout)
        sharded.forward(sh, tokens)
        n = len(sh.run)
        assert len(calls) == n * len(want)
        for layer, w in enumerate(want):
            got = calls[layer * n:(layer + 1) * n]
            for group in sh.groups:      # each model shard alike
                assert all(torch.equal(a, b) for g in group
                           for a, b in zip(got[g], got[group[0]]))
            for a, b in zip(zip(*[got[g[0]] for g in sh.groups]), w):
                assert torch.equal(torch.cat(a), b), layout


# ---------------------------------------------------------------------------
# The collectives' backward and the ledger
# ---------------------------------------------------------------------------

def _blocks(n, shape, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g, requires_grad=True)
            for _ in range(n)]


def test_collectives_backward_are_their_transposes():
    """psum passes its gradient through; pbroadcast psums it; all_gather
    reduce-scatters it (``invariant``: each shard's piece); reduce_scatter
    all-gathers it; split all-gathers it; each records its kind once, in
    the reference's unit."""
    groups = [(0, 1), (2, 3)]
    xs = _blocks(4, (3, 2), 0)
    gs = [torch.randn(3, 2) for _ in range(4)]

    def grads(fn, outs_like=None):
        with collectives.ledger() as led:
            ys = fn([x for x in xs])
            seeds = outs_like or [torch.ones_like(y) * (i + 1)
                                  for i, y in enumerate(ys)]
            got = torch.autograd.grad(ys, xs, seeds)
        return ys, got, seeds, led

    ys, got, seeds, led = grads(lambda v: collectives.psum(v, groups=groups))
    assert torch.equal(ys[0], xs[0] + xs[1]) and torch.equal(ys[3],
                                                             xs[2] + xs[3])
    assert all(torch.equal(a, b) for a, b in zip(got, seeds))
    assert led.counts["psum"] == 1 and led.bytes_by_kind["psum"] == 24
    ys, got, seeds, led = grads(
        lambda v: collectives.pbroadcast(v, groups=groups), gs)
    assert all(torch.equal(y, x) for y, x in zip(ys, xs))
    assert torch.equal(got[0], gs[0] + gs[1]) and torch.equal(got[2],
                                                              gs[2] + gs[3])
    assert led.counts["psum"] == 1
    for invariant in (False, True):
        ys, got, seeds, led = grads(lambda v: collectives.all_gather(
            v, axis=0, tiled=True, groups=groups, invariant=invariant))
        assert torch.equal(ys[1], torch.cat([xs[0], xs[1]]))
        if invariant:
            assert torch.equal(got[1], seeds[1][3:])
            assert "reduce-scatter" not in led.counts
        else:
            assert torch.equal(got[1], seeds[0][3:] + seeds[1][3:])
            assert led.counts["reduce-scatter"] == 1
            assert led.bytes_by_kind["reduce-scatter"] == 24
        assert led.bytes_by_kind["all-gather"] == 48
    ys, got, seeds, led = grads(lambda v: collectives.reduce_scatter(
        [torch.cat([x, x]) for x in v], axis=0, groups=groups))
    assert torch.equal(ys[0], xs[0] + xs[1])
    assert torch.equal(got[0], seeds[0] + seeds[1])
    assert led.counts["reduce-scatter"] == 1 and \
        led.counts["all-gather"] == 1
    ys, got, seeds, led = grads(lambda v: collectives.split(
        v, axis=1, groups=groups))
    assert torch.equal(ys[1], xs[1][:, 1:])
    assert torch.equal(got[0], torch.cat([seeds[0], seeds[1]], dim=1))
    assert led.counts["all-gather"] == 1 and led.counts["psum"] == 0


def test_replaying_records_nothing_and_ledger_reaches_threads():
    xs = _blocks(2, (4,), 1)
    with collectives.ledger() as led:
        with collectives.replaying():
            collectives.psum(xs)
        collectives.psum(xs)
    assert led.counts["psum"] == 1


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_ledger_matches_closed_form(arch, M):
    """The ledger's counts and bytes by kind of one sharded forward and of
    one training step (backward included, under the arch's remat) equal
    ``sharded.collective_form``; nothing else is recorded."""
    tc = treg.get_config(arch).scaled_down()
    params = convert.init_params(tc, torch.Generator().manual_seed(0))
    batch = _torch(_inputs(tc))
    sh = _shards(tc, params, (1, 1, M), "replicated")
    for step in (False, True):
        with collectives.ledger() as led:
            if step:
                sharded.value_and_grad(sh, batch)
            else:
                sharded.forward(sh, batch.get("tokens"),
                                positions=batch.get("positions"),
                                embeds=batch.get("embeds"))
        got = {k: [led.counts.get(k, 0), led.bytes_by_kind.get(k, 0)]
               for k in led.counts if led.counts[k]}
        assert got == sharded.collective_form(tc, M, B, S, step=step), step


def test_remat_replays_collectives_once():
    """Under every remat policy the step's gradients equal ``none``'s bit
    for bit and its ledger is ``none``'s: the recomputed forward's
    collectives are not recorded again."""
    tc = treg.get_config("fourierpim-lm").scaled_down()
    params = convert.init_params(tc, torch.Generator().manual_seed(0))
    batch = _torch(_inputs(tc))
    sh = _shards(tc, params, (1, 1, 2), "replicated")
    runs = {}
    for remat in tlm.REMATS:
        with collectives.ledger() as led:
            loss, grads = sharded.value_and_grad(sh, batch, remat=remat)
        runs[remat] = (loss, grads, led.as_dict())
    for remat, (loss, grads, ledger) in runs.items():
        assert ledger == runs["none"][2], remat
        assert torch.equal(loss, runs["none"][0])
        for k, g in grads.items():
            assert torch.equal(g, runs["none"][1][k]), (remat, k)


# ---------------------------------------------------------------------------
# The step and the CLI
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_steps():
    """The reference's three unsharded steps, computed once."""
    return _run_reference_steps()


def _run_reference_steps():
    """The reference's jitted train step, three steps, unsharded: the
    (loss, grad_norm) of each and the final parameters (numpy)."""
    ref = _reference("qwen3-1.7b")
    opt = jadamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    data = jpipe.SyntheticLM(ref["tc"].vocab_size, S, 4, seed=5)
    jp = jax.tree.map(jnp.asarray, ref["tree"])
    js = jadamw.init_state(jp, opt)
    batches = [{k: jnp.asarray(v) for k, v in data.batch_at(step).items()}
               for step in range(3)]
    jfn = _compiled(jstep.make_train_step(ref["jc"], opt), jp, js,
                    batches[0])
    losses = []
    for batch in batches:
        jp, js, jm = jfn(jp, js, batch)
        losses.append((float(jm["loss"]), float(jm["grad_norm"])))
    return losses, convert.params_from_jax(ref["tc"],
                                           jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)],
                         ids=lambda m: "x".join(map(str, m)))
def test_train_step_under_model_axis_matches_reference(mesh):
    """Three ``make_train_step(..., mesh=)`` steps on a (data, model) mesh
    against the reference's unsharded jitted step, at
    ``test_train_step_matches_reference``'s tolerances: losses rtol 1e-5,
    gradient norms rtol 1e-4, parameters atol 1e-5, but for an element
    whose gradient is within fp32 rounding of zero: AdamW's first steps
    move it by lr g / (|g| + eps), and eps (1e-8) makes that step amplify
    the gradient's last bits, which the model shards' partial sums round
    differently from one matmul (seen: 1 of 32768 elements of one leaf,
    1.06e-5 apart). At most one element in 10^4 of a leaf may pass 1e-5,
    and none 2 lr (the size of one step's update)."""
    ref = _reference("qwen3-1.7b")
    tc = ref["tc"]
    want_losses, want_params = _reference_steps()
    opt = tadamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    fn = tstep.make_train_step(tc, opt, mesh=sharding.make_mesh(
        mesh, ("data", "model"), device="cpu"))
    params = convert.params_from_jax(tc, ref["tree"])
    state = tadamw.init_state(params, opt)
    data = jpipe.SyntheticLM(tc.vocab_size, S, 4, seed=5)
    for step, (loss, norm) in enumerate(want_losses):
        params, state, m = fn(params, state, _torch(data.batch_at(step)))
        np.testing.assert_allclose(float(m["loss"]), loss, rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), norm, rtol=1e-4)
    for name, p in params.items():
        diff = np.abs(p.numpy() - want_params[name].numpy())
        assert (diff > 1e-5).mean() <= 1e-4, (name, diff.max())
        assert diff.max() < 2 * opt.lr, name


def test_train_cli_model_axis_resumes_bit_for_bit(tmp_path):
    """``--mesh 1x2``: a run resumed from its step-3 checkpoint gives the
    uninterrupted run's losses bit for bit; the checkpoint holds whole
    leaves."""
    flags = ["--device", "cpu", "--arch", "fourierpim-lm", "--smoke",
             "--batch", "4", "--seq", "16", "--steps", "6", "--mesh", "1x2",
             "--log-every", "100"]
    first, second = tmp_path / "a", tmp_path / "b"
    full = train_mod.main(flags + ["--ckpt-dir", str(first),
                                   "--ckpt-every", "3"])
    os.makedirs(second)
    shutil.copytree(first / "step_3", second / "step_3")
    resumed = train_mod.main(flags + ["--ckpt-dir", str(second)])
    assert resumed == full[3:]
    tc = treg.get_config("fourierpim-lm").scaled_down()
    shapes = {e["key"]: e["shape"] for e in
              ckpt_lib.read_manifest(str(first), 3)["arrays"]}
    for name, shape in convert.expected_shapes(tc).items():
        assert shapes[f"params/{name}"] == list(shape), name


# ---------------------------------------------------------------------------
# Layouts, meshes and the kernel wrappers on meta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [(2, 2, 2), (1, 4, 2), (2, 1, 4)],
                         ids=lambda m: "x".join(map(str, m)))
def test_shard_params_round_trip(mesh):
    """``shard_params`` cuts each leaf by its sanitized spec (a block a
    shard, replicated over the axes the spec leaves out) and
    ``gather_params`` joins them back, equal."""
    tc = treg.get_config("hymba-1.5b").scaled_down()
    params = convert.init_params(tc, torch.Generator().manual_seed(0))
    m = sharding.make_mesh(mesh, ("pod", "data", "model"), device="cpu")
    blocks = convert.shard_params(tc, params, m)
    assert len(blocks) == m.size
    specs = sharding.sanitize_tree(tlm.param_specs(tc), params, m)
    for name, spec in specs.items():
        parts = 1
        for a in sharding.spec_axes(spec):
            parts *= m.shape[a]
        assert blocks[0][name].numel() * parts == params[name].numel()
    back = convert.gather_params(tc, blocks, m)
    assert all(torch.equal(back[k], params[k]) for k in params)


def test_axis_groups_and_meta_mesh():
    m = sharding.make_mesh((2, 2, 2), ("pod", "data", "model"),
                           device="meta")
    assert all(d.type == "meta" for d in m.devices)
    assert sharding.axis_groups(m, ("model",)) == [(0, 1), (2, 3), (4, 5),
                                                   (6, 7)]
    assert sharding.axis_groups(m, ("pod", "data")) == [(0, 2, 4, 6),
                                                        (1, 3, 5, 7)]
    with pytest.raises(ValueError, match="cuda, cpu or meta"):
        sharding.make_mesh((2,), ("model",), device="xla")


def test_kernel_wrappers_on_meta_compute_nothing():
    """A meta input: a meta result of the output's shape and type, and no
    launch; CPU inputs still run the plain versions."""
    _build.reset_launches()
    meta = torch.device("meta")
    x = torch.empty(3, 64, device=meta)
    yr, yi = tkfft.fft_planes(x, x, radix=4)
    assert yr.device == meta and yr.shape == (3, 64)
    q = torch.empty(2, 32, 4, 16, dtype=torch.bfloat16, device=meta)
    k = torch.empty(2, 32, 2, 16, dtype=torch.bfloat16, device=meta)
    out = tkattn.attention(q, k, k, window=1 << 30, scale=1.0)
    assert out.device == meta and out.shape == q.shape and \
        out.dtype == torch.bfloat16
    from repro_torch.core.ntt import ref as ntt_ref
    params = ntt_ref.NTTParams.make(64, ntt_ref.choose_modulus(64))
    r = torch.empty(3, 64, dtype=torch.int32, device=meta)
    assert tkntt.ntt_batched(r, params).shape == (3, 64)
    assert not any(_build.LAUNCHES.values())
