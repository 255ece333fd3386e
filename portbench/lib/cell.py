"""One run of one cell: set-up, the measured window, the check, the
metrics. ``run.py`` calls ``run`` on the card; the tests call it on the
CPU at small sizes, with the entry replaced or broken underneath.
"""
from __future__ import annotations

import dataclasses
import gc
import time

from portbench.lib import loadgen, trace
from portbench.lib.spec import BENCH_DIR, Cell, load_json, reader

PEAKS = BENCH_DIR / "roofline" / "peaks.json"


@dataclasses.dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    breakdown: dict | None
    compared: dict          # name -> {"value": ..., "limit": ...}
    detail: str
    record: dict            # what the metric readers read

    def line(self) -> dict:
        out = {"correct": self.correct, "attempted": self.attempted,
               "failed": self.failed, "metrics": self.metrics,
               "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["compared"] = self.compared
        return out


def mixed_seed(seed: int, stream: int) -> int:
    """A 64-bit generator seed per stream of one run's seed."""
    return (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) % 2**64


def run(torch, cell: Cell, *, seed: int, seconds: float, traced: bool,
        device: str, started: float, fn=None, wrap=None) -> Outcome:
    """``started``: the process's start on the host clock, the origin of
    ``setup_s``. ``fn`` replaces the bound entry (a control); ``wrap``
    breaks it (the tests' planted faults)."""
    cfg, mix = cell.config, cell.traffic
    ops = cell.module("ops")
    products = mix["products_per_request"]
    on_card = device != "cpu"
    stages = [("entered", time.perf_counter())]
    if fn is None:
        fn, route = ops.bind(cfg, products, device)
    else:
        route = "replaced"
    if wrap is not None:
        fn = wrap(fn)
    stages.append(("bound", time.perf_counter()))
    gen = torch.Generator(device=device)
    gen.manual_seed(mixed_seed(seed, 1))
    pool = ops.make_pool(torch, cfg, products, mix["operand_sets"], gen,
                         device)
    sync = loadgen.CardSync(torch) if on_card else loadgen.HostSync()
    sync.settle()
    stages.append(("operands", time.perf_counter()))
    for s in pool:                          # the cell's one shape, warm
        fn(*s)
    sync.settle()
    stages.append(("warm", time.perf_counter()))
    keep = loadgen.Reservoir(mix["check_requests"], mixed_seed(seed, 2))
    due = None
    if mix["loop"] == "open":
        due = loadgen.schedule(mix["rate_rps"], seconds, mixed_seed(seed, 3))
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if on_card:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    setup_s = time.perf_counter() - started
    stages.append(("window", time.perf_counter()))
    kw = dict(products=products, sync=sync, keep=keep, traced=traced,
              late_after_s=mix["late_after_s"])
    with loadgen.labeller(traced)(trace.WINDOW):
        if due is None:
            win = loadgen.run_closed(fn, pool, seconds=seconds,
                                     depth=mix["queue_depth"], **kw)
        else:
            win = loadgen.run_open(fn, pool, due=due, **kw)
    sync.settle()
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        summary = trace.summarize(
            trace.events_of(prof),
            idle_label="host: pacing" if due is not None else "host: other")
        del prof
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    del fn                                  # the program's state goes
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    values, wrong, detail = ops.check(torch, cfg, pool, win.kept)
    compared = {name: {"value": v, "limit": cfg["limits"][name]}
                for name, v in values.items()}
    compared["unfinished_requests"] = {"value": win.missing, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    roof = cell.module("roofline")
    rec = {
        "loop": win.loop, "requests": win.requests, "products": win.products,
        "products_per_request": products, "window_s": win.window_s,
        "setup_s": setup_s, "due": win.due,
        "dispatch_start": win.dispatch_start,
        "dispatch_end": win.dispatch_end, "done": win.done,
        "trace": summary, "bytes_per_product": roof.bytes_per_product(cfg),
        "peak_bytes_per_s": load_json(PEAKS)["devices"].get(
            kind, {}).get("hbm_bytes_per_s"),
    }
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": peak}
    breakdown = None
    if summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        breakdown = {"device_ops": summary["device_ops"],
                     "idle_gaps": summary["idle_gaps"]}
    spans = [e - s for s, e in zip(win.dispatch_start, win.dispatch_end)]
    setup = ", ".join(f"{name} {t - started:.3f}" for name, t in stages)
    return Outcome(correct, win.requests, win.missing + wrong, metrics, dev,
                   breakdown, compared,
                   f"route {route}; {detail}; {win.requests} requests in "
                   f"{win.window_s:.3f} s; dispatch mean "
                   f"{sum(spans) / max(1, len(spans)) * 1e6:.1f} us; set-up "
                   f"(s from start): {setup}", rec)
