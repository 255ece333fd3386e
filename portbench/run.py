#!/usr/bin/env python3
"""One run of one cell of the PyTorch/CUDA port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. Prints the check's numbers beside their limits as the last lines of
standard error, and one JSON object as the last line of standard output:
the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
with ``--trace 1``. Exits non-zero, printing no result, without CUDA or
enough cards, or if JAX or the JAX package was loaded.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded in a run
BANNED = ("jax", "jaxlib", "flax", "repro")


def _caches() -> None:
    """Kernel and compiler caches at fixed paths inside the checkout (the
    port builds its own kernels into ``build/`` there)."""
    base = ROOT / "build" / "portbench-cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(base / "nv")


def banned_modules() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in BANNED})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.lib import cell as cell_mod
    from portbench.lib import spec
    cell = spec.cell(args.workload)
    _caches()
    import torch
    print(f"portbench: torch imported at "
          f"{time.perf_counter() - STARTED:.3f} s", file=sys.stderr)
    if not torch.cuda.is_available():
        print("portbench: CUDA is not available", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    out = cell_mod.run(torch, cell, seed=args.seed, seconds=args.seconds,
                       traced=bool(args.trace), device="cuda",
                       started=STARTED)
    loaded = banned_modules()
    if loaded:
        print(f"portbench: loaded in this process: {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    print(f"portbench: {args.workload} seed {args.seed}: {out.detail}",
          file=sys.stderr)
    for name, c in out.compared.items():
        print(f"compared {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out.line()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
