"""Work of one exact RLWE ring product in RNS form, from its shapes alone.

Bytes: each operand word read once and each result word written once,
whatever the kernels read again (the twiddle tables are not counted: they
serve every product of a batch). k limbs of n residues, 4-byte words:
two uint32 operands in, one int32 result out:

    bytes = (2 k n + k n) * 4            (442,368 at n = 4096, k = 9)

Operations (a count for PERF.md, no bound is drawn from it): per limb,
three length-n NTTs of (n/2) log2 n butterflies, each one modular
multiplication; the twist of both operands, the pointwise product and
the untwist with the 1/n scale, n modular multiplications each:

    modmuls = k * (3 (n/2) log2 n + 4 n)  (811,008 at n = 4096, k = 9)
"""


def bytes_per_product(cfg: dict) -> int:
    k, n = cfg["limbs"], cfg["n"]
    return (2 * k * n + k * n) * 4


def ops_per_product(cfg: dict) -> int:
    k, n = cfg["limbs"], cfg["n"]
    return k * (3 * (n // 2) * (n.bit_length() - 1) + 4 * n)
