"""Reads the program's own spans in a traced window, beside the harness's
labels.

The port opens ``repro_torch.<boundary>/<what>`` ranges on the profiler's
clock (``src/repro_torch/spans.py``): ``op`` a bound route (``BoundOp.fn``),
``glue`` a kernel wrapper from entry to return, ``launch`` the C launch
(library lookup, launcher, error check), ``gc`` a collection of Python's
garbage. They nest: in a window every ``op`` span lies inside one
``portbench.dispatch`` label, its request.

``summarize`` takes the events ``trace.summarize`` takes and returns
what that returns, each idle gap named by the innermost span (a program
span or a harness label) the host was in for most of it, and:

  span_calls   {program span: how many overlap the window}
  span_self_s  {program span: seconds in it, less its child spans}
  idle_in_s    {span, or the idle label: seconds the device was idle
                while that was the innermost span the host was in}

``events_of`` drops every device-side mirror of a host range by its kind,
not by its name. ``readings`` gives the numbers a cell reads per request.
"""
from __future__ import annotations

import bisect
import itertools
import math

from portbench.lib import trace

PREFIX = "repro_torch."


def events_of(prof) -> list[tuple[str, bool, int, int]]:
    """``trace.events_of``, with every user annotation on the device's
    timeline (the mirror of a host range) dropped, whatever its name."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == DeviceType.CUDA
        if dev and e.is_user_annotation():
            continue
        out.append((e.name(), dev, e.start_ns(),
                    e.start_ns() + e.duration_ns()))
    return out


def window(events) -> tuple[int, int] | None:
    """The traced window, as ``trace.summarize`` finds it."""
    return next(((s, e) for name, dev, s, e in events
                 if name == trace.WINDOW and not dev), None)


def host_spans(events, w0: int, w1: int) -> list[tuple[str, int, int]]:
    """Program spans and harness labels overlapping [w0, w1], cut to it,
    parents before their children."""
    keep = [(name, max(s, w0), min(e, w1)) for name, dev, s, e in events
            if not dev and e > w0 and s < w1
            and (name.startswith(PREFIX) or name in trace.HOST_LABELS)]
    keep.sort(key=lambda t: (t[1], -t[2]))
    return keep


def innermost(spans) -> list[tuple[str, int, int]]:
    """(name, start, end) pieces of the timeline in time order, each named
    by the innermost span open over it; time no span covers has no piece.
    ``spans`` as ``host_spans`` gives them, nested (one thread); a child
    that outlasts its parent is cut at the parent's end."""
    out: list[tuple[str, int, int]] = []
    stack: list[tuple[str, int]] = []
    now = 0

    def close(until: float) -> None:
        nonlocal now
        while stack and stack[-1][1] <= until:
            name, end = stack.pop()
            if end > now:
                out.append((name, now, end))
                now = end

    for name, s, e in spans:
        close(s)
        if stack:
            if s > now:
                out.append((stack[-1][0], now, s))
            e = min(e, stack[-1][1])
        now = s
        stack.append((name, e))
    close(math.inf)
    return out


def idle_gaps(events, w0: int, w1: int) -> list[tuple[int, int]]:
    """The intervals of [w0, w1] in which no device activity ran, in time
    order (``trace.summarize``'s gaps)."""
    busy = trace._union([(max(s, w0), min(e, w1))
                         for _, dev, s, e in events
                         if dev and e > w0 and s < w1])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def first_piece(ends: list[int], t: int) -> int:
    """Index of the first piece that ends after ``t`` (``ends``: the
    pieces' ends, in order)."""
    return bisect.bisect_right(ends, t)


def spent_in(gap: tuple[int, int], pieces, start: int = 0
             ) -> dict[str, int]:
    """ns of ``gap`` under each innermost span, from ``pieces[start]`` on
    (sorted, disjoint)."""
    spent: dict[str, int] = {}
    for i in range(start, len(pieces)):
        name, s, e = pieces[i]
        if s >= gap[1]:
            break
        ov = trace._overlap(gap, (s, e))
        if ov:
            spent[name] = spent.get(name, 0) + ov
    return spent


def gap_name(gap: tuple[int, int], pieces, ends: list[int],
             idle_label: str) -> str:
    """``trace._gap_name`` over the pieces, skipping those that end before
    the gap (they add no time, and a name with none never wins)."""
    return trace._gap_name(
        gap, itertools.islice(pieces, first_piece(ends, gap[0]), None),
        idle_label)


def summarize(events, *, idle_label: str) -> dict | None:
    """``trace.summarize`` with the gaps named by the innermost span, and
    the program's spans read (see the module's docstring)."""
    out = trace.summarize(events, idle_label=idle_label)
    if out is None:
        return None
    w0, w1 = window(events)
    spans = host_spans(events, w0, w1)
    pieces = innermost(spans)
    ends = [p[2] for p in pieces]
    gaps = idle_gaps(events, w0, w1)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:trace.TOP]
    out["idle_gaps"] = [[gap_name(g, pieces, ends, idle_label),
                         (g[1] - g[0]) / 1e9] for g in longest]
    calls: dict[str, int] = {}
    for name, _, _ in spans:
        if name.startswith(PREFIX):
            calls[name] = calls.get(name, 0) + 1
    self_s = dict.fromkeys(calls, 0.0)
    for name, s, e in pieces:
        if name in self_s:
            self_s[name] += (e - s) / 1e9
    idle: dict[str, float] = {}
    for g in gaps:
        spent = spent_in(g, pieces, first_piece(ends, g[0]))
        spent[idle_label] = (g[1] - g[0]) - sum(spent.values())
        for name, ns in spent.items():
            idle[name] = idle.get(name, 0.0) + ns / 1e9
    out.update(span_calls=calls, span_self_s=self_s, idle_in_s=idle)
    return out


def per_request_us(summary: dict | None, requests: int,
                   boundary: str) -> float | None:
    """Mean host µs a request spent in the ``boundary`` spans (op, glue,
    launch), their children subtracted; None without such spans."""
    if summary is None or not requests:
        return None
    head = f"{PREFIX}{boundary}/"
    names = [n for n in summary.get("span_self_s", {}) if n.startswith(head)]
    if not names:
        return None
    return sum(summary["span_self_s"][n] for n in names) / requests * 1e6


def gc_idle_share(summary: dict | None) -> float | None:
    """% of the window in which the device was idle while the host was
    inside a collection; None where the program put no span at all in
    the window (a program without spans)."""
    if summary is None or not summary.get("span_calls"):
        return None
    head = f"{PREFIX}gc/"
    idle = sum(v for n, v in summary["idle_in_s"].items()
               if n.startswith(head))
    return 100.0 * idle / summary["window_s"]


def readings(summary: dict | None, requests: int) -> dict:
    """The four per-layer numbers the program's spans give a window."""
    return {"route_us": per_request_us(summary, requests, "op"),
            "glue_us": per_request_us(summary, requests, "glue"),
            "launch_us": per_request_us(summary, requests, "launch"),
            "gc_idle_share": gc_idle_share(summary)}
