"""The trace reader on a synthetic timeline."""
from __future__ import annotations

import pytest

from portbench.lib import trace

EVENTS = [
    ("portbench.window", False, 1000, 2000),
    ("kern_a", True, 900, 1100),          # starts before the window
    ("kern_b", True, 1400, 1500),
    ("portbench.dispatch", False, 1390, 1400),
    ("kern_a", True, 1450, 1700),         # overlaps kern_b
    ("portbench.wait", False, 1700, 1950),
    ("aten::empty", False, 1300, 1310),
    ("kern_c", True, 2100, 2200),         # after the window
]


def test_busy_is_the_union_inside_the_window():
    s = trace.summarize(EVENTS, idle_label="host: pacing")
    assert s["window_s"] == pytest.approx(1000e-9)
    assert s["busy_s"] == pytest.approx((100 + 300) * 1e-9)
    assert s["device_events"] == 3
    assert s["device_s"] == pytest.approx((100 + 100 + 250) * 1e-9)
    assert s["device_ops"][0] == ["kern_a", pytest.approx(350e-9)]


def test_gaps_are_named_by_what_the_host_did_most():
    s = trace.summarize(EVENTS, idle_label="host: pacing")
    gaps = sorted((round(g[1] * 1e9), g[0]) for g in s["idle_gaps"])
    # 1100-1400: 10 of dispatch, 290 unlabelled; 1700-2000: 250 of wait
    assert gaps == [(300, "host: pacing"), (300, "portbench.wait")]


def test_no_window_no_summary():
    assert trace.summarize(EVENTS[1:], idle_label="x") is None
