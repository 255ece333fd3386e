"""The port's training stack on the CPU, against the reference's: the FFT
convolution's gradient, the attention's, the loss and every parameter's
gradient of six reduced archs, ``remat``, AdamW (fp32 and int8 moments),
the train and eval steps (with and without gradient accumulation, and the
pod-mesh variant over the port's one-process mesh against the reference's
under shard_map on forced host devices, in a subprocess), the synthetic
pipeline, and a training checkpoint with int8 optimizer state.

Inputs are made with numpy from a seed and handed to both sides; the
model's weights are the reference's own (``convert.params_from_jax``).
Tolerances, each stated where it is used:
  * the convolution's gradients: rtol 1e-4 and atol 1e-4 x the gradient's
    largest magnitude (both sides round the same exact correlation in
    fp32, in transforms of other radices; seen: under 2e-6 of it);
  * the loss rtol 1e-5, and each parameter's gradient within 1e-4 of that
    leaf's largest magnitude (fp32 sums in other orders; seen: under
    3e-6);
  * AdamW on the same gradients rtol 1e-6 (one fp32 rounding apart); its
    int8 moments within one quantization step of the block (a value on a
    rounding boundary may round either way);
  * three train steps: losses rtol 1e-5; parameters atol 1e-5 (a
    fiftieth of one step's update, about the learning rate, 5e-4 to
    1e-3 here); the pod step's residuals and the elements that round to
    the other int8 neighbour as its docstring says.
Remat changes what the backward keeps, not what it computes: the
gradients under ``block``, ``full`` and ``sqrt`` equal those under
``none`` bit for bit.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.data import pipeline as jpipe
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro.models.layers import attention as jattn
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as tpipe
from repro_torch.dist import collectives, sharding
from repro_torch.ft import checkpoint as ckpt_lib
from repro_torch.kernels import fft as tkfft
from repro_torch.kernels import ops as tops
from repro_torch.models import convert, lm as tlm
from repro_torch.models.layers import attention as tattn
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep

from conftest import run_in_subprocess_devices

#: the reduced archs whose loss and gradients are held to the reference
ARCHS = ["qwen3-1.7b", "gemma3-4b", "fourierpim-lm",
         "granite-moe-3b-a800m", "rwkv6-7b", "hymba-1.5b"]


def _grad_close(got: torch.Tensor, want, rel: float) -> None:
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=rel, atol=rel * scale)


# ---------------------------------------------------------------------------
# The convolution's gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_shape,k_shape", [
    ((2, 3, 40), (1, 3, 8)),          # the mixer's broadcast taps
    ((3, 100), (3, 28)),              # n = 128
    ((2, 4, 64), (4, 64)),            # K = T, taps without a batch dim
    ((1, 2, 8190), (1, 2, 16)),       # n = 16384: the two-pass schedule
])
def test_fft_causal_conv_grad_matches_reference(rng, x_shape, k_shape):
    x = rng.standard_normal(x_shape).astype(np.float32)
    k = rng.standard_normal(k_shape).astype(np.float32)
    T, K = x_shape[-1], k_shape[-1]
    if T + K > tkfft.TWO_PASS_FROM["fft"]:
        assert tkfft.two_pass_plan(tops._next_pow2(T + K), 4) is not None
    w = rng.standard_normal(np.broadcast_shapes(x_shape[:-1], k_shape[:-1])
                            + (T,)).astype(np.float32)

    def jloss(a, b):
        return jnp.sum(jops.fft_causal_conv(a, b, backend="xla") * w)

    want_dx, want_dk = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(k))
    tx = torch.from_numpy(x).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    y = tops.fft_causal_conv(tx, tk, radix=4)
    (y * torch.from_numpy(w)).sum().backward()
    _grad_close(tx.grad, want_dx, 1e-4)
    _grad_close(tk.grad, want_dk, 1e-4)


def test_fft_causal_conv_backward_runs_three_transforms(rng, monkeypatch):
    """The backward makes three ``fft_planes`` calls: G, dx's inverse and
    dk's inverse, the last over k's rows only (the batch summed first)."""
    calls = []
    real = tkfft.fft_planes

    def counted(xr, xi, **kw):
        calls.append(tuple(xr.shape))
        return real(xr, xi, **kw)

    monkeypatch.setattr(tkfft, "fft_planes", counted)
    x = torch.randn(4, 3, 20, requires_grad=True)
    k = torch.randn(1, 3, 12, requires_grad=True)
    y = tops.fft_causal_conv(x, k)
    assert len(calls) == 3
    y.sum().backward()
    assert calls[3:] == [(12, 32), (12, 32), (3, 32)]


# ---------------------------------------------------------------------------
# The attention's gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,G", [(1 << 30, 2), (8, 1)])
def test_blockwise_attention_grad_matches_reference(rng, window, G):
    B, S, KV, hd = 2, 24, 2, 32
    q, k, v = (rng.standard_normal((B, S, n, hd)).astype(np.float32)
               for n in (KV * G, KV, KV))
    w = rng.standard_normal((B, S, KV * G, hd)).astype(np.float32)

    def jloss(a, b, c):
        return jnp.sum(jattn.blockwise_attention(a, b, c, window=window,
                                                 kv_block=16) * w)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tattn.blockwise_attention(*ts, window=window, kv_block=16)
    (out * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, want):
        _grad_close(t.grad, g, 1e-4)


# ---------------------------------------------------------------------------
# Loss and gradients of the model
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """(reference config, port config, reference params as numpy)."""
    jc = jreg.get_config(arch).scaled_down()
    params = jlm.init_params(jc, jax.random.key(0))
    return jc, treg.get_config(arch).scaled_down(), \
        jax.tree.map(np.asarray, params)


def _batch(cfg, B=2, S=32, seed=1) -> dict:
    """Tokens and labels (a few -1), as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32)}
    batch["labels"][0, :3] = -1
    return batch


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """The loss and every parameter's gradient against
    ``jax.value_and_grad(lm.loss_fn)`` on the reference's weights; the MoE
    arch's loss holds its aux term. Then the same gradients under each
    remat policy, bit for bit."""
    jc, tc, tree = _reference(arch)
    batch = _batch(tc)
    want_loss, want_g = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jc, p, b)))(
            jax.tree.map(jnp.asarray, tree),
            {k: jnp.asarray(v) for k, v in batch.items()})
    want_g = convert.params_from_jax(tc, jax.tree.map(np.asarray, want_g))
    model = tstep.structure(tc)
    params = convert.params_from_jax(tc, tree)
    loss, grads = tlm.value_and_grad(model, params, _torch_batch(batch),
                                     remat="none")
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert set(grads) == set(want_g)
    for name, g in grads.items():
        assert g.dtype == torch.float32
        _grad_close(g, want_g[name].numpy(), 1e-4)
    for remat in ("block", "full", "sqrt"):
        again, regrads = tlm.value_and_grad(model, params,
                                            _torch_batch(batch), remat=remat)
        assert torch.equal(again, loss)
        assert all(torch.equal(regrads[k], grads[k]) for k in grads), remat


def test_loss_masks_labels_and_padded_vocab():
    """Labels of -1 drop out of the mean; a padded vocabulary's extra
    logits get no probability (the reference's -1e9 bias). A config whose
    vocabulary is not a multiple of 256 pads it."""
    _, tc, _ = _reference("qwen3-1.7b")
    tc = dataclasses.replace(tc, vocab_size=500, num_layers=1)
    assert tc.vocab_padded == 512
    params = convert.init_params(tc, torch.Generator().manual_seed(0))
    model = tstep.structure(tc)
    batch = _torch_batch(_batch(tc, B=1, S=8))
    loss, grads = tlm.value_and_grad(model, params, batch)
    logits, _ = tlm.forward_train(model, tlm.cast_params(model, params),
                                  batch["tokens"], remat="none")
    logp = torch.log_softmax(logits[..., :500].double(), dim=-1)
    labels = batch["labels"].long()
    keep = labels >= 0
    want = -logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0][keep]
    np.testing.assert_allclose(float(loss), float(want.mean()), rtol=1e-5)
    assert torch.count_nonzero(grads["lm_head"][:, 500:]) == 0


def test_serving_weights_stay_frozen():
    """Training leaves the serving path as it was: the module's weights
    never require grad, and its forward records nothing."""
    _, tc, tree = _reference("fourierpim-lm")
    model = convert.build(tc, convert.params_from_jax(tc, tree), "cpu")
    assert not any(p.requires_grad for p in model.parameters())
    logits = model(torch.zeros((1, 16), dtype=torch.long))
    assert logits.grad_fn is None


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _tree_and_grads(rng, steps: int):
    """A small parameter dict (a matrix, a vector, a scalar, a leaf whose
    last axis is not a multiple of the block) and per-step gradients."""
    shapes = {"w": (4, 300), "b": (7,), "s": (), "t": (3, 2, 130)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_adamw_apply_matches_reference(rng, state_dtype):
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10,
                  state_dtype=state_dtype)
    jcfg, tcfg = jadamw.OptConfig(**cfg_kw), tadamw.OptConfig(**cfg_kw)
    params, grads = _tree_and_grads(rng, 3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jadamw.init_state(jp, jcfg), tadamw.init_state(tp, tcfg)
    for g in grads:
        jp, js = jadamw.apply(jp, {k: jnp.asarray(v) for k, v in g.items()},
                              js, jcfg)
        tp, ts = tadamw.apply(tp, {k: torch.from_numpy(v)
                                   for k, v in g.items()}, ts, tcfg)
    assert int(ts["step"]) == int(js["step"]) == 3
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)
        for mom in ("m", "v"):
            got, want = ts[mom][k], js[mom][k]
            if state_dtype == "float32":
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-12)
                continue
            assert got["q"].dtype == torch.int8
            assert tuple(got["q"].shape) == want["q"].shape
            assert int(got["orig_last"]) == int(want["orig_last"])
            scale = np.asarray(want["scale"])
            np.testing.assert_allclose(got["scale"].numpy(), scale,
                                       rtol=1e-6)
            step = np.abs(got["q"].numpy().astype(np.int32)
                          - np.asarray(want["q"]).astype(np.int32))
            assert step.max() <= 1


def test_adamw_schedule_norm_and_clip_match_reference(rng):
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=50, min_lr_frac=0.1)
    for step in (0, 1, 5, 10, 11, 30, 50, 80):
        np.testing.assert_allclose(
            float(tadamw.lr_schedule(tadamw.OptConfig(**cfg),
                                     torch.tensor(step, dtype=torch.int32))),
            float(jadamw.lr_schedule(jadamw.OptConfig(**cfg),
                                     jnp.int32(step))), rtol=1e-6)
    _, (g,) = _tree_and_grads(rng, 1)
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    np.testing.assert_allclose(float(tadamw.global_norm(tg)),
                               float(jadamw.global_norm(jg)), rtol=1e-6)
    for max_norm in (0.5, 1e6):
        got, gn = tadamw.clip_by_global_norm(tg, max_norm)
        want, jn = jadamw.clip_by_global_norm(jg, max_norm)
        np.testing.assert_allclose(float(gn), float(jn), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)


def test_adamw_refuses_unknown_state_dtype():
    with pytest.raises(ValueError, match="state_dtype"):
        tadamw.init_state({"w": torch.zeros(2)},
                          tadamw.OptConfig(state_dtype="int4"))


# ---------------------------------------------------------------------------
# Train and eval steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    """Three steps of ``make_train_step`` against the reference's jitted
    step on the same weights and batches: the loss trajectory and the
    final parameters."""
    jc, tc, tree = _reference("qwen3-1.7b")
    jc = dataclasses.replace(jc, grad_accum_steps=accum)
    tc = dataclasses.replace(tc, grad_accum_steps=accum)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    data = jpipe.SyntheticLM(tc.vocab_size, 16, 4, seed=5)
    jfn = jax.jit(jstep.make_train_step(jc, jadamw.OptConfig(**opt)))
    tfn = tstep.make_train_step(tc, tadamw.OptConfig(**opt))
    jp = jax.tree.map(jnp.asarray, tree)
    js = jadamw.init_state(jp, jadamw.OptConfig(**opt))
    tp = convert.params_from_jax(tc, tree)
    ts = tadamw.init_state(tp, tadamw.OptConfig(**opt))
    for step in range(3):
        b = data.batch_at(step)
        jp, js, jm = jfn(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tfn(tp, ts, _torch_batch(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    want = convert.params_from_jax(tc, jax.tree.map(np.asarray, jp))
    for name, p in tp.items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5)


def test_eval_step_is_the_loss():
    jc, tc, tree = _reference("fourierpim-lm")
    batch = _batch(tc)
    want = jstep.make_eval_step(jc)(jax.tree.map(jnp.asarray, tree),
                                    {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    got = tstep.make_eval_step(tc)(convert.params_from_jax(tc, tree),
                                   _torch_batch(batch))
    assert got.grad_fn is None
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


#: the reference's pod-mesh step under shard_map, as its training CLI runs
#: it (``repro/launch/train.py``: the residual with a leading pod axis,
#: P("pod"); the batch over (pod, data)), on forced host devices
POD_REFERENCE = """
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs.registry import get_config
from repro.data.pipeline import SyntheticLM
from repro.dist import collectives, compat
from repro.models import lm
from repro.optim import adamw
from repro.train import step as step_lib

inp = np.load({inputs!r})
cfg = get_config("fourierpim-lm").scaled_down()
treedef = jax.tree.structure(
    jax.eval_shape(lambda: lm.init_params(cfg, jax.random.key(0))))
params0 = treedef.unflatten(
    [jnp.asarray(inp[f"p{{i}}"]) for i in range(treedef.num_leaves)])
opt_cfg = adamw.OptConfig(**{opt!r})
out = {{}}
for n_pods, n_data in {meshes!r}:
    tag = f"{{n_pods}}x{{n_data}}"
    mesh = Mesh(np.array(jax.devices()[:n_pods * n_data]).reshape(
        n_pods, n_data, 1), ("pod", "data", "model"))
    pod_step = step_lib.make_train_step(cfg, opt_cfg, pod_axis="pod",
                                        data_axis="data")

    def body(p, o, err_blk, batch):
        err = jax.tree.map(lambda e: e[0], err_blk)
        p, o, err, m = pod_step(p, o, err, batch)
        return p, o, jax.tree.map(lambda e: e[None], err), m

    fn = jax.jit(compat.shard_map(
        body, mesh=mesh, in_specs=(P(), P(), P("pod"), P(("pod", "data"))),
        out_specs=(P(), P(), P("pod"), P()), check_vma=False))
    params, opt = params0, adamw.init_state(params0, opt_cfg)
    errs = jax.tree.map(lambda z: jnp.zeros((n_pods, *z.shape), z.dtype),
                        params0)
    data = SyntheticLM(cfg.vocab_size, {seq}, {batch}, seed={seed})
    for s in range({steps}):
        batch = {{k: jnp.asarray(v) for k, v in data.batch_at(s).items()}}
        if s == 0:     # the ledger records at trace time, once a step
            with collectives.ledger() as led:
                fn.lower(params, opt, errs, batch)
            out[f"{{tag}}_ledger"] = np.array(
                [[led.counts[k], led.bytes_by_kind[k]]
                 for k in collectives.KINDS])
        params, opt, errs, m = fn(params, opt, errs, batch)
        for name, tree in (("p", params), ("e", errs)):
            for i, leaf in enumerate(jax.tree.leaves(tree)):
                out[f"{{tag}}_{{s}}_{{name}}{{i}}"] = np.asarray(leaf)
        out[f"{{tag}}_{{s}}_loss"] = np.asarray(m["loss"])
        out[f"{{tag}}_{{s}}_grad_norm"] = np.asarray(m["grad_norm"])
np.savez({result!r}, **out)
print("OK")
"""
POD_MESHES = [(2, 1), (2, 2)]
POD_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
POD_STEPS, POD_BATCH, POD_SEQ, POD_SEED = 3, 4, 16, 2


@pytest.fixture(scope="module")
def pod_reference(tmp_path_factory):
    """The reference's pod step over meshes 2x1 and 2x2 (one subprocess,
    4 forced host devices), from the weights of ``_reference``: per step
    the parameters' and the residuals' leaves, the loss and grad_norm
    metrics, and the ledger of one step."""
    d = tmp_path_factory.mktemp("pod_step")
    _, _, tree = _reference("fourierpim-lm")
    np.savez(d / "inputs.npz", **{f"p{i}": leaf for i, leaf
                                  in enumerate(jax.tree.leaves(tree))})
    out = run_in_subprocess_devices(POD_REFERENCE.format(
        inputs=str(d / "inputs.npz"), opt=POD_OPT, meshes=POD_MESHES,
        seq=POD_SEQ, batch=POD_BATCH, seed=POD_SEED, steps=POD_STEPS,
        result=str(d / "result.npz")), n_devices=4)
    assert "OK" in out
    return dict(np.load(d / "result.npz"))


@pytest.mark.parametrize("sizes", [(2, 1, 1), (2, 2, 1)])
def test_pod_step_carries_the_residual_and_ledgers_bytes(pod_reference,
                                                         sizes):
    """The port's pod-mesh step on the one-process mesh against the
    reference's under shard_map (the same weights and ``SyntheticLM``
    batches, three steps): the parameters, each pod's ``grad_err``
    residual, the loss and grad_norm metrics, and the ledger's bytes and
    counts by kind.

    Tolerances: the loss rtol 1e-5, grad_norm rtol 1e-4 (as three plain
    steps). A leaf's int8 step is its largest compensated gradient over
    127, and a residual lies within half a step, so a residual is held
    within 2e-2 of its reference leaf's largest magnitude: 1e-4 of the
    leaf's largest gradient, the bound on the gradients themselves (fp32
    sums in other orders). An element that sits on a rounding boundary
    may round to either neighbour: then the two residuals are the two
    halves of one step, ``got == -want`` within the same bound, and the
    difference rides on in the residual, which later steps hold only to
    half a step. At most a thousandth of the elements may round apart.
    The parameters match within atol 1e-5 everywhere else, and where an
    element rounded apart (its reduced gradient off by up to a step)
    within 4 x lr a step, AdamW's normalized update."""
    jc, tc, tree = _reference("fourierpim-lm")
    P, D, _ = sizes
    tag = f"{P}x{D}"
    want = pod_reference
    treedef = jax.tree.structure(tree)
    mesh = sharding.make_mesh(sizes, ("pod", "data", "model"), device="cpu")
    opt = tadamw.OptConfig(**POD_OPT)
    step_fn = tstep.make_train_step(tc, opt, pod_axis="pod", data_axis="data",
                                    mesh=mesh)
    params = convert.params_from_jax(tc, tree)
    state = tadamw.init_state(params, opt)
    errs = collectives.zeros_like_errs([params] * P)
    data = tpipe.SyntheticLM(tc.vocab_size, POD_SEQ, POD_BATCH, seed=POD_SEED)
    rounded_apart = {k: np.zeros(p.shape, bool) for k, p in params.items()}
    n_elements = sum(p.numel() for p in params.values())

    def leaves(kind: str, step: int) -> list:
        return [want[f"{tag}_{step}_{kind}{i}"]
                for i in range(treedef.num_leaves)]

    for step in range(POD_STEPS):
        with collectives.ledger() as led:
            params, state, errs, metrics = step_fn(
                params, state, errs, _torch_batch(data.batch_at(step)))
        assert [[led.counts[k], led.bytes_by_kind[k]]
                for k in collectives.KINDS] == want[f"{tag}_ledger"].tolist()
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(want[f"{tag}_{step}_loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(want[f"{tag}_{step}_grad_norm"]),
                                   rtol=1e-4)
        stacked = leaves("e", step)
        assert len(errs) == P
        for pod in range(P):
            want_e = convert.params_from_jax(tc, treedef.unflatten(
                [leaf[pod] for leaf in stacked]))
            assert set(errs[pod]) == set(want_e)
            for group in tstep.reference_leaves(want_e).values():
                half = max(float(want_e[n].abs().max()) for n in group)
                tol = 2e-2 * half
                for name in group:
                    got, ref = errs[pod][name].numpy(), want_e[name].numpy()
                    close = np.abs(got - ref) <= tol
                    halves = np.abs(got + ref) <= tol
                    carried = rounded_apart[name] & (np.abs(got) <= half + tol)
                    assert (close | halves | carried).all(), \
                        (step, pod, name)
                    rounded_apart[name] |= ~close
        assert sum(int(m.sum()) for m in rounded_apart.values()) \
            <= n_elements // 1000
        want_p = convert.params_from_jax(
            tc, treedef.unflatten(leaves("p", step)))
        for name, p in params.items():
            diff = np.abs(p.numpy() - want_p[name].numpy())
            bound = np.where(rounded_apart[name], 4 * opt.lr * (step + 1),
                             1e-5)
            assert (diff <= bound).all(), (step, name, float(diff.max()))
        assert int(state["step"]) == step + 1
    assert any(float(e[k].abs().max()) > 0 for e in errs for k in e)


def test_pod_step_refuses_a_model_axis():
    _, tc, _ = _reference("fourierpim-lm")
    mesh = sharding.make_mesh((2, 1, 2), ("pod", "data", "model"),
                              device="cpu")
    with pytest.raises(ValueError, match="model"):
        tstep.make_train_step(tc, tadamw.OptConfig(), pod_axis="pod",
                              data_axis="data", mesh=mesh)


# ---------------------------------------------------------------------------
# Pipeline and checkpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,n_hosts,host", [
    (0, 0, 1, 0), (3, 17, 1, 0), (7, 5, 4, 2), (11, 1000, 2, 1)])
def test_synthetic_lm_batches_equal_reference(seed, step, n_hosts, host):
    args = (512, 24, 8)
    kw = dict(seed=seed, n_hosts=n_hosts, host_id=host)
    got = tpipe.SyntheticLM(*args, **kw).batch_at(step)
    want = jpipe.SyntheticLM(*args, **kw).batch_at(step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert (got[k] == want[k]).all()


def test_prefetcher_yields_steps_in_order():
    data = tpipe.SyntheticLM(64, 8, 2, seed=1)
    pre = tpipe.Prefetcher(data, start_step=5)
    try:
        for step in range(5, 9):
            got_step, batch = pre.next()
            assert got_step == step
            assert (batch["tokens"] == data.batch_at(step)["tokens"]).all()
    finally:
        pre.stop()
    assert not pre.thread.is_alive()


def test_checkpoint_round_trips_int8_training_tree(tmp_path):
    """A training tree: fp32 parameters, int8 optimizer moments (nested
    dicts of int8, fp32 and int32 leaves), a stacked grad_err residual,
    and a bf16 leaf, saved and restored bit for bit."""
    g = torch.Generator().manual_seed(3)
    params = {"w": torch.randn(3, 200, generator=g), "b": torch.randn(5,
                                                                     generator=g)}
    opt = tadamw.OptConfig(state_dtype="int8")
    state = tadamw.init_state(params, opt)
    params, state = tadamw.apply(params, {k: torch.randn(v.shape, generator=g)
                                          for k, v in params.items()},
                                 state, opt)
    tree = {"params": params, "opt": state,
            "grad_err": {k: torch.randn((2, *v.shape), generator=g)
                         for k, v in params.items()},
            "act": torch.randn(4, generator=g).to(torch.bfloat16)}
    ckpt_lib.save(str(tmp_path), 7, tree, extra={"data": {"next_step": 7}})
    like = {"params": {k: torch.zeros_like(v) for k, v in params.items()},
            "opt": tadamw.init_state(params, opt),
            "grad_err": {k: torch.zeros_like(v)
                         for k, v in tree["grad_err"].items()},
            "act": torch.zeros(4, dtype=torch.bfloat16)}
    step, got = ckpt_lib.restore_latest(str(tmp_path), like)
    assert step == 7
    want = dict(ckpt_lib._flatten_with_paths(tree))
    for key, leaf in ckpt_lib._flatten_with_paths(got):
        assert leaf.dtype == want[key].dtype, key
        assert torch.equal(leaf, want[key]), key
    assert ckpt_lib.read_extra(str(tmp_path), 7) == {"data": {"next_step": 7}}
