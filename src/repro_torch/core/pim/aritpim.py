"""AritPIM-style cost model: cycles & gate counts for element-parallel
bit-serial arithmetic on a memristive crossbar (paper §2.2, [12]).

Port of ``repro.core.pim.aritpim``: a numpy copy that imports nothing of
the reference, pinned equal to the original by
``tests/test_torch_pim.py``.

The paper adopts AritPIM's algorithms verbatim; we reproduce their cost
structure as closed forms in the bit widths. One stateful logic gate (MAGIC
NOR) executes per cycle per row, in parallel across all rows of a crossbar
(and across all crossbars), so

    latency_cycles  = gate sequence length          (per vectored op)
    gates_executed  = cycles * active_rows          (per crossbar)
    energy          = gates_executed * gate_energy

Gate-sequence lengths (documented derivations; constants are the knobs the
reproduction calibrates, see EXPERIMENTS.md §Repro-calibration):

  fixed add (N bits)      9N + 1        MAGIC full-adder: 9 NOR/bit, serial carry
  fixed mul (N bits)      12N^2 + 3N    shift-and-add: N partial products,
                                        each AND row (3 gates/bit) + add
  copy (N bits)           2N            double-NOT per bit
  swap (N bits)           3N            three NOT-copies via a temp column
  float add (E, M)        2*barrel + 9(M+4) + 9E + 9M + 2M
                          barrel = 3 (M+2) ceil(log2 (M+2))   (align + renorm)
  float mul (E, M)        12 (M+1)^2 + 9E + 3M + 9M           (mantissa product
                          dominates; exponent add, normalize, round)

Complex arithmetic (paper §4.1, rectangular form):
  cadd = 2 float adds;  cmul = 4 float muls + 2 float adds (Eq. (8)).
Butterfly (paper §4.2): u +- w v = 1 cmul + 2 cadd = 4 fmul + 6 fadd.

Modular (fixed-point) arithmetic — the exact-NTT counterpart (NTT-PIM
[arXiv:2310.09715] maps the same butterfly structure onto integer residues):
  mod add   a+b mod q:   fixed add + compare-subtract-q select
                         = 2 (9N+1) + 2
  mod mul   a*b mod q:   Barrett reduction on the 2N-bit product:
                         t = a*b, qhat = (t * mu) >> 2N, r = t - qhat*q,
                         then <=2 conditional subtracts
                         = 3 fixed muls + 2 fixed adds + 4 select cycles
  NTT butterfly (u, v) -> (u + w v, u - w v) mod q = 1 mod mul + 2 mod adds
— the same shape as the complex butterfly with fmul/fadd swapped for their
integer versions and no FLOAT_FIXED_OVERHEAD (no IEEE special cases).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class FloatSpec:
    """IEEE-style float layout used for each real component."""
    exp_bits: int
    man_bits: int

    @property
    def total_bits(self) -> int:
        return 1 + self.exp_bits + self.man_bits


FP32 = FloatSpec(exp_bits=8, man_bits=23)
FP16 = FloatSpec(exp_bits=5, man_bits=10)

#: paper §6: full precision complex = 2 x fp32, half = 2 x fp16
SPEC_BY_PRECISION = {"full": FP32, "half": FP16}


@dataclasses.dataclass(frozen=True)
class IntSpec:
    """Unsigned fixed-point residue layout for the modular NTT: one
    ``word_bits``-wide residue in [0, q) per element (q < 2^(word_bits-1)
    so the conditional-subtract trick needs no extra carry column)."""
    word_bits: int


INT32 = IntSpec(word_bits=32)
INT16 = IntSpec(word_bits=16)

#: modular-NTT words: 32-bit residues carry the ~30-bit RLWE moduli the
#: kernels target; 16-bit serves toy/teaching moduli.
INT_SPEC_BY_WIDTH = {32: INT32, 16: INT16}


def fixed_add_cycles(n_bits: int) -> int:
    return 9 * n_bits + 1


def fixed_mul_cycles(n_bits: int) -> int:
    return 12 * n_bits * n_bits + 3 * n_bits


def copy_cycles(n_bits: int) -> int:
    return 2 * n_bits


def swap_cycles(n_bits: int) -> int:
    return 3 * n_bits


def _barrel_shift_cycles(m: int) -> int:
    return 3 * m * max(1, math.ceil(math.log2(max(2, m))))


#: Width-independent gate-sequence overhead per float op: IEEE special-case
#: handling (NaN/inf/subnormal/zero detection, sign logic, exponent
#: saturation) that AritPIM's sequences carry regardless of mantissa width.
#: This term is why half precision does not speed PIM up by the full
#: quadratic mantissa factor (observable in the paper's half/full ratios).
FLOAT_FIXED_OVERHEAD = 350


def float_add_cycles(spec: FloatSpec) -> int:
    m, e = spec.man_bits, spec.exp_bits
    barrel = _barrel_shift_cycles(m + 2)
    return (2 * barrel            # align + renormalize shifts
            + 9 * (m + 4)         # mantissa add (guard/round/sticky bits)
            + 9 * e               # exponent difference / adjust
            + 9 * m               # rounding add
            + 2 * m               # pack/copy
            + FLOAT_FIXED_OVERHEAD)


def float_mul_cycles(spec: FloatSpec) -> int:
    m, e = spec.man_bits, spec.exp_bits
    return (12 * (m + 1) ** 2     # mantissa partial-product accumulation
            + 9 * e               # exponent add
            + 3 * m               # normalize (1-bit shift + sticky)
            + 9 * m               # rounding add
            + FLOAT_FIXED_OVERHEAD)


def complex_add_cycles(spec: FloatSpec) -> int:
    return 2 * float_add_cycles(spec)


def complex_mul_cycles(spec: FloatSpec) -> int:
    """(a+bi)(a'+b'i) per Eq. (8): 4 real muls + 2 real adds."""
    return 4 * float_mul_cycles(spec) + 2 * float_add_cycles(spec)


def butterfly_cycles(spec: FloatSpec) -> int:
    """In-place vectored butterfly (u, v) -> (u + w v, u - w v), §4.2."""
    return complex_mul_cycles(spec) + 2 * complex_add_cycles(spec)


def complex_word_bits(spec: FloatSpec) -> int:
    return 2 * spec.total_bits


# -- modular fixed-point ops (IntSpec) --------------------------------------

def mod_add_cycles(spec: IntSpec) -> int:
    """a + b mod q: fixed add, then compare/subtract-q select."""
    return 2 * fixed_add_cycles(spec.word_bits) + 2


def mod_mul_cycles(spec: IntSpec) -> int:
    """a * b mod q via Barrett: product + two reduction muls + 2 subtracts
    + select cycles (see module docstring)."""
    w = spec.word_bits
    return 3 * fixed_mul_cycles(w) + 2 * fixed_add_cycles(w) + 4


def ntt_butterfly_cycles(spec: IntSpec) -> int:
    """In-place modular butterfly (u, v) -> (u + w v, u - w v) mod q."""
    return mod_mul_cycles(spec) + 2 * mod_add_cycles(spec)


def storage_word_bits(spec) -> int:
    """Per-element storage on the crossbar: a complex float word for
    FloatSpec, a single residue word for IntSpec."""
    if isinstance(spec, IntSpec):
        return spec.word_bits
    return complex_word_bits(spec)


# Convenience table used by benchmarks / tests. The op names are shared
# between the float-FFT and modular-NTT layers ("butterfly"/"copy"/"swap")
# so the crossbar simulator and the group loops are spec-agnostic.
def op_cycles(op: str, spec) -> int:
    if isinstance(spec, IntSpec):
        return {
            "modadd": mod_add_cycles(spec),
            "modmul": mod_mul_cycles(spec),
            "butterfly": ntt_butterfly_cycles(spec),
            "copy": copy_cycles(storage_word_bits(spec)),
            "swap": swap_cycles(storage_word_bits(spec)),
        }[op]
    return {
        "fadd": float_add_cycles(spec),
        "fmul": float_mul_cycles(spec),
        "cadd": complex_add_cycles(spec),
        "cmul": complex_mul_cycles(spec),
        "butterfly": butterfly_cycles(spec),
        "copy": copy_cycles(complex_word_bits(spec)),
        "swap": swap_cycles(complex_word_bits(spec)),
    }[op]
