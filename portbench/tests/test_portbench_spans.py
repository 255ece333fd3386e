"""The reading of the program's spans (``lib/spans.py``) on synthetic
timelines, and the tool that reads them (``tools/spans.py``) on cells run
on the CPU at small sizes."""
from __future__ import annotations

import random
import sys

import pytest
import torch

from portbench.lib import spans, trace
from portbench.lib.spec import BENCH_DIR, load_module

TRACE_EVENTS = load_module(BENCH_DIR / "tests"
                           / "test_portbench_trace.py").EVENTS

# One request of a closed loop: the dispatch label holds the route, the
# route its wrapper's glue, the glue the C launch and a collection.
#   window 0-1000; kernel 300-600 and 800-900 on the device
#   dispatch 100-400 > op 110-390 > glue 150-380 > launch 200-250
#                                              > gc/0 300-340
#   wait 400-800 (idle 600-800 there); nothing labelled 900-1000
PROGRAM = [
    ("portbench.window", False, 0, 1000),
    ("portbench.dispatch", False, 100, 400),
    ("repro_torch.op/polymul-mod-rns", False, 110, 390),
    ("repro_torch.glue/rns_ntt_polymul", False, 150, 380),
    ("repro_torch.launch/ntt_rns_polymul", False, 200, 250),
    ("repro_torch.gc/0", False, 300, 340),
    ("aten::empty", False, 160, 170),
    ("kern", True, 300, 600),
    ("portbench.wait", False, 400, 800),
    ("kern", True, 800, 900),
]


class _Event:
    def __init__(self, name, device, start, dur, annotation):
        self._v = (name, device, start, dur, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_device_annotations_are_dropped_whatever_their_name():
    from torch.autograd import DeviceType
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    prof = _Prof([
        _Event("portbench.dispatch", cpu, 0, 10, True),
        _Event("portbench.dispatch", cuda, 2, 8, True),
        _Event("repro_torch.op/x", cuda, 2, 8, True),
        _Event("any_label", cuda, 3, 4, True),
        _Event("kern", cuda, 3, 4, False),
        _Event("repro_torch.op/x", cpu, 1, 9, False),
    ])
    assert spans.events_of(prof) == [
        ("portbench.dispatch", False, 0, 10), ("kern", True, 3, 7),
        ("repro_torch.op/x", False, 1, 10)]
    # the harness drops the first mirror by its name and keeps the rest
    assert [e for e in trace.events_of(prof) if e[1]] == [
        ("repro_torch.op/x", True, 2, 10), ("any_label", True, 3, 7),
        ("kern", True, 3, 7)]


def test_self_time_subtracts_the_children():
    s = spans.summarize(PROGRAM, idle_label="host: other")
    assert s["span_calls"] == {
        "repro_torch.op/polymul-mod-rns": 1,
        "repro_torch.glue/rns_ntt_polymul": 1,
        "repro_torch.launch/ntt_rns_polymul": 1, "repro_torch.gc/0": 1}
    assert s["span_self_s"] == pytest.approx({
        "repro_torch.op/polymul-mod-rns": (280 - 230) * 1e-9,
        "repro_torch.glue/rns_ntt_polymul": (230 - 50 - 40) * 1e-9,
        "repro_torch.launch/ntt_rns_polymul": 50e-9,
        "repro_torch.gc/0": 40e-9})


def test_idle_goes_to_the_innermost_span():
    s = spans.summarize(PROGRAM, idle_label="host: other")
    # idle: 0-300 and 600-800 and 900-1000
    assert s["idle_in_s"] == pytest.approx({
        "host: other": 200e-9,                       # 0-100, 900-1000
        "portbench.dispatch": 10e-9,                 # 100-110
        "repro_torch.op/polymul-mod-rns": 40e-9,     # 110-150
        "repro_torch.glue/rns_ntt_polymul": 100e-9,  # 150-200, 250-300
        "repro_torch.launch/ntt_rns_polymul": 50e-9,  # 200-250
        "portbench.wait": 200e-9})                   # 600-800
    assert sum(s["idle_in_s"].values()) == pytest.approx(
        s["window_s"] - s["busy_s"])
    # 0-300: the glue's 100 ties the unlabelled 100, and a span comes
    # first in a tie, as in trace._gap_name
    assert sorted((round(g[1] * 1e9), g[0]) for g in s["idle_gaps"]) == [
        (100, "host: other"), (200, "portbench.wait"),
        (300, "repro_torch.glue/rns_ntt_polymul")]


def test_the_readings():
    s = spans.summarize(PROGRAM, idle_label="host: other")
    r = spans.readings(s, requests=2)
    assert r == pytest.approx({"route_us": 50e-3 / 2, "glue_us": 140e-3 / 2,
                               "launch_us": 50e-3 / 2,
                               "gc_idle_share": 0.0})
    # the collection ran while the kernel did; here it stalls the card
    stalled = [e for e in PROGRAM if e[0] != "kern"] + [
        ("kern", True, 340, 600), ("kern", True, 800, 900)]
    s = spans.summarize(stalled, idle_label="host: other")
    assert spans.readings(s, 1)["gc_idle_share"] == pytest.approx(4.0)
    # a program without spans reads nothing
    bare = [e for e in PROGRAM if not e[0].startswith(spans.PREFIX)]
    assert spans.readings(spans.summarize(bare, idle_label="x"), 1) == {
        "route_us": None, "glue_us": None, "launch_us": None,
        "gc_idle_share": None}
    assert spans.readings(None, 1)["route_us"] is None


def _random_timeline(seed: int) -> list:
    """Harness labels and device activity as a closed or open loop makes
    them, no program span; some labels and kernels straddle the window."""
    rng = random.Random(seed)
    out = [("portbench.window", False, 1000, 90_000)]
    t = 0
    while t < 100_000:
        label = rng.choice(trace.HOST_LABELS)
        d = rng.randrange(1, 800)
        out.append((label, False, t, t + d))
        t += d + rng.randrange(0, 300)
    t = 0
    while t < 100_000:
        d = rng.randrange(1, 2000)
        out.append((rng.choice(["k1", "k2"]), True, t, t + d))
        t += d + rng.choice([0, 0, rng.randrange(1, 3000)])
    out.append(("aten::empty", False, 5000, 5010))
    rng.shuffle(out)
    return out


@pytest.mark.parametrize("events", [TRACE_EVENTS] + [
    _random_timeline(s) for s in range(6)], ids=["trace-test", *map(
        "random-{}".format, range(6))])
@pytest.mark.parametrize("idle_label", ["host: pacing", "host: other"])
def test_without_program_spans_nothing_changes(events, idle_label):
    """On a trace with no program span every key ``trace.summarize``
    returns keeps its value, the gaps their names, and nothing is read."""
    before = trace.summarize(events, idle_label=idle_label)
    after = spans.summarize(events, idle_label=idle_label)
    assert {k: after[k] for k in before} == before
    assert after["span_calls"] == after["span_self_s"] == {}
    assert sum(after["idle_in_s"].values()) == pytest.approx(
        before["window_s"] - before["busy_s"])


def _tool():
    sys.path.insert(0, str(BENCH_DIR / "tools"))
    try:
        return load_module(BENCH_DIR / "tools" / "spans.py")
    finally:
        sys.path.remove(str(BENCH_DIR / "tools"))


@pytest.mark.parametrize("name", ["rlwe4096.sat", "polyreal16384.sat",
                                  "rlwe4096.load80"])
def test_tool_reads_one_op_and_one_glue_span_a_request(small_cell, name):
    """Off the card: every request one op span and one glue span, no
    launch (the wrappers run their plain versions), nothing on a device,
    and the window's slices hold every request."""
    tool = _tool()
    cell = small_cell(name)
    got = tool.traced_run(torch, cell, seed=2**31 + 5, seconds=0.3,
                          device="cpu")
    r = tool.reading(*got)
    assert r["correct"] is True and r["requests"] > 0
    assert r["span_calls"] == {"op": r["requests"], "glue": r["requests"]}
    assert r["launches_in_window"] == 0
    assert r["device_events"] == {"by_kind": 0, "by_name": 0,
                                  "program_named_by_name": 0}
    assert r["spans"]["route_us"] > 0 and r["spans"]["glue_us"] > 0
    assert r["spans"]["launch_us"] is None
    assert r["spans"]["route_us"] + r["spans"]["glue_us"] <= \
        r["dispatch_us"]
    assert sum(s["requests"] for s in r["slices"]) == r["requests"]
    assert len(r["gaps"]) == 1 and r["gaps"][0]["name"] != ""
