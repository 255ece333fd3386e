"""The port's span helper (``repro_torch/spans.py``) and the spans it puts
on the registry's routes, the kernel wrappers and Python's collections,
on the CPU under ``torch.profiler`` (the launch spans need the card:
``portbench/tests/test_portbench_spans_card.py``)."""
from __future__ import annotations

import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import spans
from repro_torch.launch import ops


def _host_events(prof) -> list[tuple[str, int, int, bool]]:
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()]


def _named(events, prefix: str):
    return [e for e in events if e[0].startswith(prefix)]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture
def ranges(monkeypatch):
    """Every range the helper opens, by name."""
    opened = []
    real = spans._Range

    def record(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(spans, "_Range", record)
    return opened


def test_off_hands_out_one_object_and_opens_nothing(ranges):
    assert not torch._C._autograd._profiler_enabled()
    first = spans.span("repro_torch.op/a")
    assert first is spans.span("repro_torch.glue/b") is spans._OFF
    with first as entered:
        assert entered is None
    assert spans.spanned("repro_torch.op/c", lambda x: x + 1)(41) == 42
    gc.collect()
    assert ranges == []


def test_on_opens_function_scope_ranges(ranges):
    """While the profiler records, ``span`` and ``spanned`` open ranges
    under their names; neither is a user annotation, the kind whose
    mirror lands on the device's timeline."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("repro_torch.glue/x"):
            torch.ones(4).sum()
        assert spans.spanned("repro_torch.op/y", lambda: 7)() == 7
    assert ranges == ["repro_torch.glue/x", "repro_torch.op/y"]
    events = _named(_host_events(prof), "repro_torch.")
    assert sorted(e[0] for e in events) == ["repro_torch.glue/x",
                                           "repro_torch.op/y"]
    assert not any(e[3] for e in events)


def _operands(bound, batch: int, seed: int):
    rng = np.random.default_rng(seed)
    return bound.stack([bound.random_payload(rng) for _ in range(batch)])


@pytest.mark.parametrize("op,ctx,route,glue", [
    ("polymul-real", ops.OpContext(), "polymul-real-packed",
     "polymul_real_planes"),
    ("polymul-mod", ops.OpContext(modulus_bits=40), "polymul-mod-rns",
     "rns_ntt_polymul"),
])
def test_bound_fn_is_one_op_span_inside_the_callers_label(op, ctx, route,
                                                          glue):
    """A call of ``BoundOp.fn`` is one ``repro_torch.op/<route>`` span
    inside the caller's label, holding its wrapper's glue span; off the
    card no launch span; the result is the unspanned call's."""
    bound = ops.get_op(op).bind(64, ctx, batch=4, device="cpu")
    args = _operands(bound, 4, seed=3)
    want = bound.fn(*args)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            got = bound.fn(*args)
    assert torch.equal(got, want)
    events = _host_events(prof)
    (caller,) = [e for e in events if e[0] == "caller"]
    (op_span,) = _named(events, "repro_torch.op/")
    (glue_span,) = _named(events, "repro_torch.glue/")
    assert op_span[0] == f"repro_torch.op/{route}"
    assert glue_span[0] == f"repro_torch.glue/{glue}"
    assert _inside(op_span, caller) and _inside(glue_span, op_span)
    assert _named(events, "repro_torch.launch/") == []


@pytest.mark.parametrize("generation", [0, 2])
def test_a_collection_is_one_gc_span(generation):
    enabled = gc.isenabled()
    gc.disable()                     # no collection but the one asked for
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            gc.collect(generation)
    finally:
        if enabled:
            gc.enable()
    got = _named(_host_events(prof), "repro_torch.gc/")
    assert [e[0] for e in got] == [f"repro_torch.gc/{generation}"]
    assert spans._gc_open == []


def test_the_gc_hook_is_installed_once():
    assert [cb for cb in gc.callbacks
            if getattr(cb, "__module__", None) == spans.__name__] == [
                spans._on_gc]
