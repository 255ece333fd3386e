"""Cell kind ``real_circular``: the circular product of real fp32 rows.

The entry is the registry's bound ``polymul-real`` route (``launch/ops.py``
-> ``kernels/ops.py`` -> ``kernels/polymul.py`` -> ``csrc/stockham.cu``):
(R, n) float32 rows in and out. The operands are standard normal rows, on
the card from the seed. The check recomputes every product of each
sampled request in float64 and takes, per row, the largest error over the
row's largest magnitude.
"""
from __future__ import annotations

from portbench.lib.spec import BENCH_DIR, load_module

REF = load_module(BENCH_DIR / "reference" / "real_circular.py")
CONTROLS = ("bf16", "fp16")


def bind(cfg: dict, products: int, device: str):
    from repro_torch.launch import ops
    bound = ops.get_op(cfg["op"]).bind(cfg["n"], ops.OpContext(),
                                       batch=products, device=device)
    return bound.fn, bound.route


def make_pool(torch, cfg: dict, products: int, sets: int, gen, device):
    """``sets`` operand pairs (a, b), each (products, n) float32."""
    pool = []
    for _ in range(sets):
        x = torch.randn((2, products, cfg["n"]), generator=gen, device=device,
                        dtype=torch.float32)
        pool.append((x[0], x[1]))
    return pool


def check(torch, cfg: dict, pool, kept) -> tuple[dict, int, str]:
    worst, wrong = 0.0, 0
    limit = cfg["limits"]["max_rel_err"]
    for s in sorted({k[1] for k in kept}):
        want = REF.product(*pool[s])
        for _, _, out in (k for k in kept if k[1] == s):
            err = float(REF.row_errors(out, want).max().item())
            worst = max(worst, err)
            wrong += not err <= limit
        del want
    return ({"max_rel_err": worst}, wrong,
            f"{len(kept)} requests of {tuple(kept[0][2].shape)[0]} products "
            f"checked" if kept else "no request kept")


def control(torch, cfg: dict, variant: str):
    dtype = {"bf16": torch.bfloat16, "fp16": torch.float16}[variant]
    return lambda a, b: REF.low_precision_product(a, b, dtype)
