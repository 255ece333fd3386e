"""The registry's four archs that ``chip_smoke.py``'s ``rest_phase`` runs on
the card -- starcoder2-15b, llama3-405b, musicgen-medium and qwen2-vl-72b
-- at smoke size on the CPU, against the reference (``repro.models``).

The two embeddings archs (musicgen-medium; qwen2-vl-72b with (B, S, 3)
M-RoPE streams) go through ``chip_smoke.drive_embeddings``, the card
step's own code: a prefill of seeded embeddings, then decode steps each
fed the next seeded row. The two token archs go through the serve CLI
(``--service lm --smoke --device cpu``) with the reference's own weights.
Either is held against the reference's ``prefill`` and ``decode_step``
loop on the same inputs: logits within ``TOL`` (as
tests/test_torch_models.py holds them), greedy ids equal, each step's
top-two margin above ten times the tolerance so equality is what the
tolerance implies. And every arch of the registry has a card step.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro_torch.configs import registry as treg
from repro_torch.kernels import _build
from repro_torch.launch import serve
from repro_torch.models import convert
from repro_torch.models import lm as tlm

TOL = dict(rtol=1e-4, atol=1e-4)


def _reference(arch: str):
    """(reference config, port config, reference params as numpy)."""
    jc = jreg.get_config(arch).scaled_down()
    tree = jax.tree.map(np.asarray, jlm.init_params(jc, jax.random.key(0)))
    return jc, treg.get_config(arch).scaled_down(), tree


def _margin(logits) -> float:
    top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-72b"])
def test_drive_embeddings_matches_reference_loop(arch):
    """``drive_embeddings`` (prefill of 16 embeddings, then 4 decode steps
    at positions 16 .. 19) == the reference's prefill + decode_step loop
    on its inputs: the prefill's last logits, every step's logits and
    greedy ids; the M-RoPE streams of qwen2-vl-72b are (B, S, 3)."""
    jc, tc, tree = _reference(arch)
    B, S, gen = 2, 16, 4
    model = convert.build(tc, convert.params_from_jax(tc, tree), "cpu")
    _build.reset_launches()
    got = chip_smoke.drive_embeddings(torch, model, B, S, gen, seed=1)
    assert not any(_build.LAUNCHES.values())        # the CPU runs plain
    inputs = {k: v.numpy() for k, v in got["inputs"].items()}
    embeds, positions = inputs["embeds"], inputs.get("positions")
    assert embeds.shape == (B, S + gen, tc.d_model)
    if arch == "qwen2-vl-72b":
        assert positions.shape == (B, S + gen, 3)
        np.testing.assert_array_equal(
            positions, np.broadcast_to(np.arange(S + gen)[None, :, None],
                                       (B, S + gen, 3)))
    else:
        assert positions is None

    def cut(x, sl):
        return None if x is None else jnp.asarray(x[:, sl])

    params = jax.tree.map(jnp.asarray, tree)
    logits, state = jlm.prefill(jc, params, None,
                                embeds=cut(embeds, slice(0, S)),
                                positions=cut(positions, slice(0, S)),
                                cache_capacity=S + gen)
    np.testing.assert_allclose(got["prefill_logits"].numpy(),
                               np.asarray(logits), **TOL)
    decode = jax.jit(lambda p, st, pos, e, ps: jlm.decode_step(
        jc, p, st, None, pos, positions=ps, embed=e))
    ids, margins = [], []
    for i in range(gen):
        sl = slice(S + i, S + i + 1)
        logits, state = decode(params, state, jnp.int32(S + i),
                               cut(embeds, sl), cut(positions, sl))
        np.testing.assert_allclose(got["step_logits"][i].numpy(),
                                   np.asarray(logits), **TOL)
        margins.append(_margin(logits[:, :tc.vocab_size]))
        ids.append(np.asarray(jnp.argmax(logits[:, :tc.vocab_size], -1)))
    assert min(margins) > 10 * TOL["atol"]
    assert got["ids"].shape == (gen, B)
    np.testing.assert_array_equal(got["ids"].numpy(), np.stack(ids))


@pytest.mark.parametrize("arch", ["starcoder2-15b", "llama3-405b"])
def test_cli_lm_smoke_matches_reference_greedy_loop(monkeypatch, arch):
    """``serve --service lm --smoke --device cpu`` with the reference's own
    weights in place of its seed-0 draw: 8 greedy tokens == the
    reference's prefill + decode_step loop on the prompt the CLI drew."""
    jc, tc, tree = _reference(arch)
    B, S, gen = 2, 16, 8
    monkeypatch.setattr(convert, "init_params",
                        lambda cfg, generator: convert.params_from_jax(
                            cfg, tree))
    prompts = []
    generate = tlm.generate

    def recorded(model, tokens, n):
        prompts.append(tokens.numpy())
        return generate(model, tokens, n)

    monkeypatch.setattr(tlm, "generate", recorded)
    _build.reset_launches()
    got = serve.main(["--service", "lm", "--arch", arch, "--smoke",
                      "--batch", str(B), "--prompt-len", str(S), "--gen",
                      str(gen), "--device", "cpu"])["generated"]
    assert not any(_build.LAUNCHES.values())        # the CPU runs plain
    tokens, = prompts
    assert tokens.shape == (B, S)
    params = jax.tree.map(jnp.asarray, tree)
    logits, state = jlm.prefill(jc, params, jnp.asarray(tokens, jnp.int32),
                                cache_capacity=S + gen)
    decode = jax.jit(lambda p, st, tok, pos: jlm.decode_step(
        jc, p, st, tok, pos))
    want, margins = [], []
    for i in range(gen):
        margins.append(_margin(logits))
        tok = jnp.argmax(logits, axis=-1)
        want.append(np.asarray(tok))
        logits, state = decode(params, state, tok, jnp.int32(S + i))
    assert min(margins) > 10 * TOL["atol"]
    assert got.shape == (gen, B)
    np.testing.assert_array_equal(got, np.stack(want))


def test_every_registry_arch_has_a_card_step():
    """Each arch of the registry is named by the constants of one of
    ``chip_smoke.py``'s phase-3 LM steps, and ``main`` runs that step."""
    steps = {chip_smoke.LM_ARCH: "lm_phase",
             chip_smoke.GEMMA_ARCH: "gemma_phase",
             chip_smoke.FOURIER_ARCH: "fourier_phase",
             chip_smoke.MIXTRAL_ARCH: "mixer_phase",
             **dict.fromkeys(chip_smoke.MIXER_ARCHS, "mixer_phase"),
             **dict.fromkeys(chip_smoke.REST_ARCHS, "rest_phase")}
    assert set(steps) == set(treg.ARCH_MODULES)
    main = inspect.getsource(chip_smoke.main)
    for step in set(steps.values()):
        assert f"{step}(torch" in main, step
    assert set(chip_smoke.REST_ARCHS) == set(chip_smoke.REST_PLAIN_LAYERS) \
        == set(chip_smoke.REST_CPU_LAYERS)
