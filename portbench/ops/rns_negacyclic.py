"""Cell kind ``rns_negacyclic``: the exact RLWE ring product in RNS form.

The entry is the registry's bound ``polymul-mod`` route with the RNS
modulus (``launch/ops.py``: plan, then ``kernels/ntt.py`` and
``csrc/ntt.cu``): k uint32 residue stacks (k, R, n) in, int32 out. The
operands are each limb's residues drawn uniformly below its prime, on the
card from the seed. The check recomputes every product of each sampled
request with the plain reference and counts the residues that differ.
"""
from __future__ import annotations

from portbench.lib.spec import BENCH_DIR, load_module

REF = load_module(BENCH_DIR / "reference" / "rns_negacyclic.py")
CONTROLS = ("float64_fft",)


def primes(cfg: dict) -> tuple[int, ...]:
    _, qs = REF.limbs(cfg["n"], cfg["modulus_bits"], cfg["limb_bits"])
    if len(qs) != cfg["limbs"]:
        raise ValueError(f"{cfg['name']}: the modulus needs {len(qs)} limbs, "
                         f"the file says {cfg['limbs']}")
    return qs


def bind(cfg: dict, products: int, device: str):
    """The registry's bound entry at this batch, and its route's name."""
    from repro_torch.launch import ops
    bound = ops.get_op(cfg["op"]).bind(
        cfg["n"], ops.OpContext(modulus_bits=cfg["modulus_bits"]),
        batch=products, device=device)
    return bound.fn, bound.route


def make_pool(torch, cfg: dict, products: int, sets: int, gen, device):
    """``sets`` operand pairs (a, b), each (k, products, n) uint32."""
    qs = torch.tensor(primes(cfg), dtype=torch.int64, device=device)
    shape = (2, len(qs), products, cfg["n"])
    pool = []
    for _ in range(sets):
        x = torch.randint(0, 2**62, shape, generator=gen, device=device,
                          dtype=torch.int64)
        x = (x % qs.view(1, -1, 1, 1)).to(torch.int32).view(torch.uint32)
        pool.append((x[0], x[1]))
    return pool


def check(torch, cfg: dict, pool, kept) -> tuple[dict, int, str]:
    """Compares each kept output with the reference: (compared numbers,
    requests found wrong, a line of detail)."""
    qs = primes(cfg)
    mismatches = wrong = 0
    for s in sorted({k[1] for k in kept}):
        want = REF.product(*pool[s], qs)
        for _, _, out in (k for k in kept if k[1] == s):
            bad = int((out.to(torch.int64) != want).sum().item())
            mismatches += bad
            wrong += bad > 0
        del want
    return ({"residue_mismatches": mismatches}, wrong,
            f"{len(kept)} requests of {cfg['limbs']} x "
            f"{tuple(kept[0][2].shape)[1]} products checked"
            if kept else "no request kept")


def control(torch, cfg: dict, variant: str):
    """The reference in the program's place with the guarantee broken."""
    qs = primes(cfg)
    if variant != "float64_fft":
        raise ValueError(f"no control {variant!r}")
    return lambda a, b: REF.float_product(a, b, qs)
