"""Readings that set a cell's limits (how `correct` is decided), at the
cell's own size, in one process: the program's compared numbers over many
seeds, and each control's (the reference in the program's place, computed
below the configuration's precision or with its guarantee broken).

    python3 portbench/tools/readings.py --workload rlwe4096.sat \
        --seeds 11,12,13 --control-seeds 21,22,23 --seconds 2 \
        --out readings.jsonl
"""
from __future__ import annotations

import argparse
import time

from common import Log, card_line  # noqa: F401  (sets sys.path)

from portbench.lib import cell as cell_mod
from portbench.lib import spec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--controls", default="", help="default: every one")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    log = Log(args.out)
    cell = spec.cell(args.workload)
    ops = cell.module("ops")
    log(card=card_line(), workload=args.workload)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    runs = [("program", s, None) for s in ints(args.seeds)]
    controls = args.controls.split(",") if args.controls else ops.CONTROLS
    runs += [(c, s, ops.control(torch, cell.config, c))
             for c in controls for s in ints(args.control_seeds)]
    for who, seed, fn in runs:
        t = time.perf_counter()
        try:
            out = cell_mod.run(torch, cell, seed=seed, seconds=args.seconds,
                               traced=False, device="cuda", started=t,
                               fn=fn)
        except Exception as e:      # a control that crashes has failed
            log(who=who, seed=seed, error=repr(e)[:300])
            continue
        log(who=who, seed=seed, correct=out.correct,
            compared={k: v["value"] for k, v in out.compared.items()},
            metrics={k: v["value"] for k, v in out.metrics.items()},
            detail=out.detail)


if __name__ == "__main__":
    main()
