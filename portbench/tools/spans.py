"""The program's own spans in traced runs of a cell: what each request
spends in the route, the wrapper glue and the C launch, where the device
idles, and how that moves over the window.

    python3 portbench/tools/spans.py --workload rlwe4096.load80 \
        --seeds 11,12 --seconds 51 --out spans.jsonl

Each run is the benchmark's own traced run (``cell.run`` with
``traced=True``), read twice: by the cell's per-layer metrics, as
``run.py --trace 1`` reads it, and by ``portbench/lib/spans.py`` on the
same events, which the tool takes from the harness's ``trace.events_of``
call; the kernel launches the window added (``_build.LAUNCHES``) are
counted from the window's start. One JSON line a run.
"""
from __future__ import annotations

import argparse
import time

from common import Log, card_line

from portbench.lib import cell as cell_mod
from portbench.lib import loadgen, spans, spec, trace

#: the window is cut into this many slices of equal length for ``slices``
SLICES = 5


def traced_run(torch, cell, *, seed: int, seconds: float, device: str):
    """``cell.run`` traced, with the window's events (``spans.events_of``),
    the device events of the harness's own ``trace.events_of`` and the
    launches counted over the window: (outcome, events, harness's device
    events, launches)."""
    from repro_torch.kernels import _build
    got: dict = {}
    labeller, events_of = loadgen.labeller, trace.events_of

    def at_window(on):              # first called as the window opens
        got.setdefault("launches", sum(_build.LAUNCHES.values()))
        return labeller(on)

    def capture(prof):
        got["events"] = spans.events_of(prof)
        got["launches"] = sum(_build.LAUNCHES.values()) - got["launches"]
        harness = events_of(prof)
        got["device"] = [e for e in harness if e[1]]
        return harness

    loadgen.labeller, trace.events_of = at_window, capture
    try:
        out = cell_mod.run(torch, cell, seed=seed, seconds=seconds,
                           traced=True, device=device,
                           started=time.perf_counter())
    finally:
        loadgen.labeller, trace.events_of = labeller, events_of
    return out, got["events"], got["device"], got["launches"]


def _per_request(self_s: dict, boundary: str, requests: int) -> float:
    head = f"{spans.PREFIX}{boundary}/"
    return sum(v for k, v in self_s.items()
               if k.startswith(head)) / max(1, requests) * 1e6


def slices(events, count: int = SLICES) -> list[dict]:
    """The window cut into ``count`` equal slices: in each, the requests
    dispatched, their mean dispatch label, the µs a request spent in each
    boundary's spans (self time) and the seconds in collections."""
    w0, w1 = spans.window(events)
    pieces = spans.innermost(spans.host_spans(events, w0, w1))
    width = (w1 - w0) / count
    rows = [{"requests": 0, "dispatch_ns": 0, "self_s": {}}
            for _ in range(count)]
    for name, s, e in pieces:
        row = rows[min(count - 1, int((s - w0) // width))]
        row["self_s"][name] = row["self_s"].get(name, 0.0) + (e - s) / 1e9
    for name, dev, s, e in events:
        if not dev and name == "portbench.dispatch" and w0 <= s < w1:
            row = rows[min(count - 1, int((s - w0) // width))]
            row["requests"] += 1
            row["dispatch_ns"] += e - s
    out = []
    for row in rows:
        n, self_s = row["requests"], row["self_s"]
        out.append({
            "requests": n,
            "dispatch_us": row["dispatch_ns"] / max(1, n) / 1e3,
            **{f"{b}_us": _per_request(self_s, b, n)
               for b in ("op", "glue", "launch")},
            "gc_s": sum(v for k, v in self_s.items()
                        if k.startswith(f"{spans.PREFIX}gc/"))})
    return out


def gap_detail(events, idle_label: str) -> list[dict]:
    """The ten longest idle gaps: each one's name (the innermost span
    over most of it) and its three largest shares."""
    w0, w1 = spans.window(events)
    pieces = spans.innermost(spans.host_spans(events, w0, w1))
    ends = [p[2] for p in pieces]
    gaps = sorted(spans.idle_gaps(events, w0, w1),
                  key=lambda g: g[0] - g[1])[:trace.TOP]
    out = []
    for g in gaps:
        spent = spans.spent_in(g, pieces, spans.first_piece(ends, g[0]))
        spent[idle_label] = (g[1] - g[0]) - sum(spent.values())
        top = sorted(spent.items(), key=lambda kv: -kv[1])[:3]
        out.append({"name": spans.gap_name(g, pieces, ends, idle_label),
                    "ms": (g[1] - g[0]) / 1e6,
                    "at_s": (g[0] - w0) / 1e9,
                    "shares": {k: round(v / (g[1] - g[0]), 4)
                               for k, v in top}})
    return out


def reading(out, events, harness_device, launches: int) -> dict:
    """What one traced run gives: the cell's per-layer metrics, the four
    span readings, span counts a request, gaps and slices, and the device
    events the harness kept beside those ``spans.events_of`` kept."""
    rec = out.record
    idle_label = "host: pacing" if rec["due"] is not None else "host: other"
    summary = spans.summarize(events, idle_label=idle_label)
    requests = rec["requests"]
    calls: dict[str, int] = {}
    for name, n in summary["span_calls"].items():
        boundary = name[len(spans.PREFIX):].split("/")[0]
        calls[boundary] = calls.get(boundary, 0) + n
    dispatch = [e - s for s, e in zip(rec["dispatch_start"],
                                      rec["dispatch_end"])]
    program_on_device = sum(1 for e in harness_device
                            if e[0].startswith(spans.PREFIX))
    return {
        "correct": out.correct, "requests": requests,
        "metrics": {k: v["value"] for k, v in out.metrics.items()},
        "dispatch_us": sum(dispatch) / max(1, len(dispatch)) * 1e6,
        "spans": spans.readings(summary, requests),
        "span_calls": calls, "launches_in_window": launches,
        "device_events": {
            "by_kind": sum(1 for e in events if e[1]),
            "by_name": len(harness_device),
            "program_named_by_name": program_on_device},
        "idle_in_s": dict(sorted(summary["idle_in_s"].items(),
                                 key=lambda kv: -kv[1])[:8]),
        "gaps": gap_detail(events, idle_label),
        "slices": slices(events),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    log = Log(args.out)
    cell = spec.cell(args.workload)
    log(card=card_line(), workload=args.workload)
    for seed in (int(s) for s in args.seeds.split(",") if s):
        got = traced_run(torch, cell, seed=seed, seconds=args.seconds,
                         device="cuda")
        log(workload=args.workload, seed=seed, **reading(*got))


if __name__ == "__main__":
    main()
