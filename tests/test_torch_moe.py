"""The port's MoE FFN (``repro_torch.models.layers.moe``) against the
reference's (``repro.models.layers.moe``) on the CPU, at smoke sizes.

The same numpy inputs and reference weights go to both. Tolerances: fp32
outputs 1e-4 (absolute and relative): the port sums each token's k slots
in another order, and the router's fp32 products may differ in the last
bit; the aux loss 1e-6. bf16 outputs one bf16 step (1e-2): an expert
product summed in another order may round to the neighbouring bf16 value.

Besides the outputs, the kept and dropped slots are held against the
reference token by token: each expert's output on each token is computed
in numpy, and the reference's combine weight of each (token, expert) is
recovered from its output by least squares (d >= E); its nonzero weights
must be the port's kept slots, and equal their gates.

A kept slot whose gate rounds to 0 in a bf16 ``moe_dispatch_dtype``
cannot be built against this reference: XLA on the CPU flushes subnormal
results to zero, so every positive gate the reference holds is a normal
fp32 number, and bf16 has fp32's exponent range. The case it leaves is a
gate the port computes as subnormal and the reference as 0
(``test_subnormal_gate_is_dropped_as_in_the_reference``).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models.layers import moe as jmoe
from repro_torch.configs import registry as treg
from repro_torch.models import lm as tlm
from repro_torch.models.layers import moe as tmoe

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def _configs(E=4, k=2, **kw):
    """granite-moe-3b's reduced config (d 128, f 256, groups of 32) with E
    experts, top k, for the reference and the port."""
    cut = dict(num_experts=E, experts_per_token=k, **kw)
    return (dataclasses.replace(
                jreg.get_config("granite-moe-3b-a800m").scaled_down(), **cut),
            dataclasses.replace(
                treg.get_config("granite-moe-3b-a800m").scaled_down(),
                **cut))


def _weights(jc, seed=0):
    return jax.tree.map(np.asarray,
                        jmoe.init_moe_params(jax.random.key(seed), jc,
                                             jnp.float32))


def _holder(tc, w, dtype=torch.float32):
    """The port's MoE parameters as ``DecoderLM`` holds them: the router in
    fp32, the experts in the activation type."""
    m = tlm.MoE(tc, dtype, "cpu")
    m.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                       for k, v in w.items()})
    return m


def _run(jc, tc, w, x, dtype):
    """(port y, port aux, port routing, reference y, reference aux)."""
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    routings = []
    route = tmoe.route

    def recording(*a, **kw):
        routings.append(route(*a, **kw))
        return routings[-1]

    tmoe.route = recording
    try:
        y, aux = tmoe.moe_ffn(_holder(tc, w, tdt),
                              torch.from_numpy(x).to(tdt), tc)
    finally:
        tmoe.route = route
    jy, jaux = jmoe.moe_ffn({k: jnp.asarray(v) for k, v in w.items()},
                            jnp.asarray(x).astype(jdt), jc)
    return y, aux, routings[0], np.asarray(jy, np.float32), float(jaux)


CAPACITY = [1.25, 0.5, None]           # None: E / k, no drops
SHAPES = [(2, 64), (1, 40), (3, 24)]   # S % g == 0; padded; S < g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", CAPACITY)
@pytest.mark.parametrize("B,S", SHAPES)
def test_moe_ffn_matches_reference(dtype, cf, B, S):
    jc, tc = _configs()
    cf = cf or jc.num_experts / jc.experts_per_token
    jc, tc = (dataclasses.replace(c, capacity_factor=cf) for c in (jc, tc))
    w = _weights(jc)
    x = np.random.default_rng(S + B).standard_normal(
        (B, S, jc.d_model)).astype(np.float32)
    y, aux, r, jy, jaux = _run(jc, tc, w, x, dtype)
    assert y.shape == (B, S, jc.d_model)
    assert y.dtype == (torch.float32 if dtype == "float32"
                       else torch.bfloat16)
    np.testing.assert_allclose(y.float().numpy(), jy,
                               **(TOL if dtype == "float32" else BF16_TOL))
    assert abs(aux.item() - jaux) < 1e-6
    g = min(jc.moe_group_size, S)
    assert r.capacity == max(1, math.ceil(g * 2 / 4 * cf))
    if cf < 1:
        assert not r.kept.all()        # the case drops slots


def _expert_outputs(w, x):
    """Every expert's SwiGLU output on every token, in float64: (T, E, d)."""
    x = x.astype(np.float64)
    gate = np.einsum("td,edf->tef", x, w["w_gate"])
    up = np.einsum("td,edf->tef", x, w["w_up"])
    h = gate / (1 + np.exp(-gate)) * up
    return np.einsum("tef,efd->ted", h, w["w_down"])


def _recovered_weights(w, x, jy):
    """The reference's combine weight of each (token, expert), by least
    squares of its output on the experts' outputs: (T, E)."""
    outs = _expert_outputs(w, x)
    return np.stack([np.linalg.lstsq(outs[t].T, jy[t].astype(np.float64),
                                     rcond=None)[0]
                     for t in range(len(x))])


def _port_weights(r, S, E):
    """The port's gate of each kept (token, expert), zero elsewhere:
    (B S, E)."""
    B = r.expert.shape[0]
    out = torch.zeros(B, r.expert.shape[1] * r.expert.shape[2], E,
                      dtype=torch.float64)
    idx = r.expert.reshape(B, -1, r.expert.shape[-1])
    val = torch.where(r.kept, r.gate, 0.0).reshape(idx.shape).double()
    out.scatter_(-1, idx, val)
    return out[:, :S].reshape(-1, E).numpy()


@pytest.mark.parametrize("E,k", [(4, 2), (8, 3)])
@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("B,S", [(2, 64), (1, 40)])
def test_kept_slots_match_reference_token_by_token(E, k, cf, B, S):
    """The reference's kept (token, expert) pairs, recovered from its
    output, are the port's kept slots, with the port's gates as their
    weights; the port's experts are ``lax.top_k``'s, and its queue
    positions the reference's slot-major cumsum."""
    jc, tc = _configs(E, k, capacity_factor=cf)
    w = _weights(jc, seed=E)
    x = np.random.default_rng(7 * S + E).standard_normal(
        (B, S, jc.d_model)).astype(np.float32)
    y, _, r, jy, _ = _run(jc, tc, w, x, "float32")
    got = _port_weights(r, S, E)
    want = _recovered_weights(w, x.reshape(-1, jc.d_model),
                              jy.reshape(-1, jc.d_model))
    np.testing.assert_array_equal(got > 0, np.abs(want) > 1e-3)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert (got > 0).sum() < B * S * k          # some slots dropped
    # the experts, by lax.top_k on the reference's probabilities, and the
    # queue positions by the reference's slot-major cumsum
    g = min(jc.moe_group_size, S)
    pad = (-S) % g
    xg = jnp.pad(jnp.asarray(x), ((0, 0), (0, pad), (0, 0))).reshape(
        B, -1, g, jc.d_model)
    probs = jax.nn.softmax(xg @ jnp.asarray(w["router"]), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    np.testing.assert_array_equal(r.expert.numpy(), np.asarray(idx))
    onehot = jax.nn.one_hot(idx, E)
    flat = jnp.swapaxes(onehot, 3, 2).reshape(B, -1, g * k, E)
    pos = jnp.cumsum(flat, axis=2) - flat
    pos = jnp.sum(pos * flat, axis=-1).reshape(B, -1, k, g)
    np.testing.assert_array_equal(r.pos.numpy(),
                                  np.swapaxes(np.asarray(pos), 2, 3))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tied_probabilities_pick_lax_top_k_order(dtype):
    """A zero router: all 40 probabilities equal. ``lax.top_k`` picks
    experts 0..7 for every token, lower index first, where ``torch.topk``
    keeps no order among ties; the port picks as lax.top_k does, so every
    token queues on experts 0..7 and only the first C tokens are kept."""
    jc, tc = _configs(40, 8, capacity_factor=1.25)
    w = dict(_weights(jc), router=np.zeros((jc.d_model, 40), np.float32))
    x = np.random.default_rng(3).standard_normal(
        (2, 32, jc.d_model)).astype(np.float32)
    y, aux, r, jy, jaux = _run(jc, tc, w, x, dtype)
    _, idx = jax.lax.top_k(jnp.full((40,), 1 / 40, jnp.float32), 8)
    assert (r.expert == torch.from_numpy(np.array(idx))).all()
    C = r.capacity
    assert C == 8
    assert r.kept[:, :, :C].all() and not r.kept[:, :, C:].any()
    np.testing.assert_allclose(y.float().numpy(), jy,
                               **(TOL if dtype == "float32" else BF16_TOL))
    assert not y[:, C:].any()                  # every slot dropped
    assert abs(aux.item() - jaux) < 1e-6
    if dtype == "float32":
        got = _port_weights(r, 32, 40)
        want = _recovered_weights(w, x.reshape(-1, jc.d_model),
                                  jy.reshape(-1, jc.d_model))
        np.testing.assert_array_equal(got > 0, np.abs(want) > 1e-3)


@pytest.mark.parametrize("dispatch", ["float32", "bfloat16"])
def test_subnormal_gate_is_dropped_as_in_the_reference(dispatch):
    """Token 0's logits are [0, -92, -200, -200]: its second gate is
    exp(-92), subnormal in fp32. The reference flushes it to 0 and
    dispatches the slot nowhere; the port computes it as a positive
    subnormal and drops the slot as well. The outputs agree."""
    jc, tc = _configs()
    jc, tc = (dataclasses.replace(c, moe_dispatch_dtype=dispatch)
              for c in (jc, tc))
    w = _weights(jc)
    router = np.zeros_like(w["router"])
    router[0] = [0.0, -92.0, -200.0, -200.0]
    w = dict(w, router=router)
    x = np.random.default_rng(5).standard_normal(
        (1, 32, jc.d_model)).astype(np.float32) * 0.01
    x[0, 0] = 0.0
    x[0, 0, 0] = 1.0
    y, _, r, jy, _ = _run(jc, tc, w, x, "float32")
    assert r.expert[0, 0, 0].tolist() == [0, 1]
    gate = r.gate[0, 0, 0, 1].item()
    assert 0 < gate < torch.finfo(torch.float32).tiny
    assert r.kept[0, 0, 0].tolist() == [True, False]
    np.testing.assert_allclose(y.numpy(), jy, **TOL)


def test_reduce_dtype_bf16_matches_reference():
    """reduce_dtype "bfloat16" on fp32 activations: the reference rounds
    the dispatched tokens and each expert product to bf16; values may land
    one bf16 step apart (2^-7 relative)."""
    jc, tc = _configs(reduce_dtype="bfloat16")
    w = _weights(jc)
    x = np.random.default_rng(11).standard_normal(
        (2, 64, jc.d_model)).astype(np.float32)
    jy, _ = jmoe.moe_ffn({k: jnp.asarray(v) for k, v in w.items()},
                         jnp.asarray(x), jc)
    y, _ = tmoe.moe_ffn(_holder(tc, w), torch.from_numpy(x), tc,
                        torch.bfloat16)
    assert torch.equal(y, y.to(torch.bfloat16).float())
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2 ** -7,
                               atol=2 ** -7)


def test_init_moe_params_follow_reference():
    """The router is fp32 whatever the parameter type; the experts' shapes
    and spreads are the reference's."""
    jc, tc = _configs()
    want = _weights(jc)
    got = tmoe.init_moe_params(tc, torch.Generator().manual_seed(0),
                               torch.bfloat16, "cpu")
    assert got["router"].dtype == torch.float32
    assert all(got[k].dtype == torch.bfloat16
               for k in ("w_gate", "w_up", "w_down"))
    for name, v in want.items():
        assert tuple(got[name].shape) == v.shape
        assert abs(got[name].float().std().item() / v.std() - 1) < 0.1, name
