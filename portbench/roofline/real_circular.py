"""Work of one circular product of real fp32 rows, from its shapes alone.

Bytes: each operand read once and the result written once, 4-byte words:

    bytes = 3 n * 4                      (196,608 at n = 16384)

Operations (a count for PERF.md, no bound is drawn from it): Eq. (10)'s
route does one complex transform of z = a + ib per product and one
inverse per pair of products, 1.5 complex length-n transforms of
5 n log2 n flops each, plus the Hermitian split and the complex product,
about 10 n flops:

    flops = 1.5 * 5 n log2 n + 10 n       (1,884,160 at n = 16384)
"""


def bytes_per_product(cfg: dict) -> int:
    return 3 * cfg["n"] * 4


def ops_per_product(cfg: dict) -> int:
    n = cfg["n"]
    return int(1.5 * 5 * n * (n.bit_length() - 1) + 10 * n)
