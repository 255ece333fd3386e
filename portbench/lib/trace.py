"""Reads a ``torch.profiler`` trace of one window.

The window is the span labelled ``portbench.window``; the harness labels
its own host work inside it (``portbench.dispatch``: the call into the
bound entry; ``portbench.wait``: waiting for a queued request). Device
activity (kernels, copies, sets) is read from the trace's device events,
on the host's clock as the profiler aligns them.
"""
from __future__ import annotations

WINDOW = "portbench.window"
HOST_LABELS = ("portbench.dispatch", "portbench.wait")
TOP = 10


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _overlap(a: tuple[int, int], b: tuple[int, int]) -> int:
    return max(0, min(a[1], b[1]) - max(a[0], b[0]))


def _gap_name(gap: tuple[int, int], labelled: list[tuple[str, int, int]],
              idle: str) -> str:
    """What the host spent most of the gap on: one of its labels, or
    ``idle`` for the time no label covers."""
    spent: dict[str, int] = {}
    for lab, s, e in labelled:
        if s > gap[1]:
            break
        spent[lab] = spent.get(lab, 0) + _overlap(gap, (s, e))
    spent[idle] = (gap[1] - gap[0]) - sum(spent.values())
    return max(spent, key=spent.get)


def summarize(events, *, idle_label: str) -> dict | None:
    """``events``: (name, is_device, start_ns, end_ns) of the whole trace.
    Returns the window's length, the device's busy time (the union of its
    activities), its activities, the top device ops by time and the
    longest idle gaps named by what the host was doing (``idle_label``
    where the harness was doing none of its labelled work). None where
    the trace holds no window."""
    win = [(s, e) for name, dev, s, e in events if name == WINDOW and not dev]
    if not win:
        return None
    w0, w1 = win[0]
    device = [(name, max(s, w0), min(e, w1)) for name, dev, s, e in events
              if dev and e > w0 and s < w1]
    busy = _union([(s, e) for _, s, e in device])
    by_op: dict[str, float] = {}
    for name, s, e in device:
        by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e9
    labelled = sorted(((name, s, e) for name, dev, s, e in events
                       if not dev and name in HOST_LABELS),
                      key=lambda t: t[1])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "device_events": len(device),
        "device_s": sum(e - s for _, s, e in device) / 1e9,
        "device_ops": sorted(([k, v] for k, v in by_op.items()),
                             key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": [[_gap_name(g, labelled, idle_label), (g[1] - g[0]) / 1e9]
                      for g in gaps[:TOP]],
    }


def events_of(prof) -> list[tuple[str, bool, int, int]]:
    """(name, is_device, start_ns, end_ns) of every event of a finished
    ``torch.profiler.profile``. The harness's own labels also appear on
    the device's timeline (as annotations spanning the work launched
    inside them); those copies are not device work and are dropped."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == DeviceType.CUDA
        if dev and e.name().startswith("portbench."):
            continue
        out.append((e.name(), dev, e.start_ns(),
                    e.start_ns() + e.duration_ns()))
    return out
