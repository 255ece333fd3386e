"""The knee of a load cell's configuration: the closed loop's rate of
requests, then the open loop at fractions of it, each window reporting
its latency quantiles and whether the backlog grew (the last tenth of the
requests against the first tenth).

    python3 portbench/tools/knee.py --workload rlwe4096.load80 \
        --fractions 0.6,0.8,0.9,1.0 --seconds 4 --seed 7 \
        --out knee.jsonl
"""
from __future__ import annotations

import argparse
import statistics
import time

from common import Log, card_line, with_traffic

from portbench.lib import cell as cell_mod
from portbench.lib import spec
from portbench.lib.loadgen import nearest_rank


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fractions", default="0.6,0.7,0.8,0.85,0.9,0.95,1.0")
    ap.add_argument("--rates", default="", help="absolute rates instead")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    log = Log(args.out)
    cell = spec.cell(args.workload)
    log(card=card_line(), workload=args.workload)
    closed = with_traffic(cell, loop="closed", queue_depth=3)
    closed.end_to_end = [{"name": "products_per_s", "unit": "products/s"}]
    out = cell_mod.run(torch, closed, seed=args.seed, seconds=args.seconds,
                       traced=False, device="cuda", started=time.perf_counter())
    cap = out.record["requests"] / out.record["window_s"]
    log(closed_rps=cap, correct=out.correct)
    rates = ([float(r) for r in args.rates.split(",")] if args.rates else
             [f * cap for f in map(float, args.fractions.split(","))])
    for rate in rates:
        c = with_traffic(cell, rate_rps=rate)
        out = cell_mod.run(torch, c, seed=args.seed, seconds=args.seconds,
                           traced=False, device="cuda",
                           started=time.perf_counter())
        r = out.record
        lat = [float("inf") if d is None else d - t
               for t, d in zip(r["due"], r["done"])]
        tenth = max(1, len(lat) // 10)
        log(rate_rps=rate, of_closed=rate / cap, correct=out.correct,
            requests=r["requests"],
            p50_ms=nearest_rank(lat, 0.5) * 1e3,
            p95_ms=nearest_rank(lat, 0.95) * 1e3,
            p99_ms=nearest_rank(lat, 0.99) * 1e3,
            first_tenth_ms=statistics.median(lat[:tenth]) * 1e3,
            last_tenth_ms=statistics.median(lat[-tenth:]) * 1e3,
            lag_p95_ms=nearest_rank([s - t for t, s in
                                     zip(r["due"], r["dispatch_start"])],
                                    0.95) * 1e3)


if __name__ == "__main__":
    main()
