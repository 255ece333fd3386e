"""Algorithm-based fault tolerance (ABFT) checks for the Fourier ops.

Port of ``repro.ft.abft``: a numpy copy that imports nothing of the
reference, pinned equal to the original by ``tests/test_torch_ft.py``.
The checks run on the host, over the rows a batch delivers once they are
there (``launch/engine.py``'s verified gate).

Every serveable workload gets a CHEAP integrity check — O(n) work against
the O(n log n) transform — that validates a delivered result against its
request payload without recomputing the op:

  fft           Parseval: sum |X_k|^2 == n * sum |x_j|^2.
  rfft          Half-spectrum Parseval: |X_0|^2 + |X_{n/2}|^2
                + 2 * sum_{0<k<n/2} |X_k|^2 == n * sum x_j^2
                (the Hermitian half carries the full energy).
  polymul[-real]  Evaluate-at-one: a circular product satisfies
                r(1) = a(1) * b(1) (the DC identity of the convolution
                theorem), checked as a toleranced residual.
  polymul-mod   Evaluate-at-psi, EXACT: the negacyclic product satisfies
                r(x) = a(x) b(x) mod (x^n + 1, q), and psi (NTTParams.psi,
                psi^n = -1 mod q) is a root of x^n + 1 — so
                r(psi) = a(psi) b(psi) mod q, bit-for-bit. (x = 1 is NOT a
                root of x^n + 1: the cyclic eval-at-one identity does not
                transfer to the negacyclic ring.)
  polymul-mod (RNS)  The same eval-at-psi per PRIME FACTOR p of Q: the
                result rows are already reduced mod Q, so the working-limb
                residues are gone, but r = a b mod (x^n + 1, Q) reduces
                mod every p | Q and each factor has its own 2n-th root
                psi_p. Scheme-style Q (built by ``RNSParams.make(
                modulus_bits=...)``) is a product of the limb primes, so
                the factors are recovered from ``rns.limbs`` directly; a
                modulus that does not factor over its limbs raises
                :class:`ABFTUnsupportedModulus` at bind time, not at
                check time.

Guarantee (docs/fault_tolerance.md): a point check is a homomorphism from
the DELIVERED coefficients — any corruption of a delivered value moves
r(psi) by delta * psi^j != 0 mod q (modular: always detected) or moves the
checked sums (float: detected above the residual tolerance). It is a check
on what the client receives, not a tamper-proof audit of transform
internals: corruption injected in the frequency domain that cancels out of
the checked functional (e.g. a lone spectral bin != 0 under eval-at-one)
is only caught when it reaches the delivered coefficients — which is the
event that matters for serving.

Cost model: every check has a closed-form crossbar cycle cost
(:func:`check_cycles`) and a charging twin (:func:`charge_check`) built
from ONE schedule (:func:`_schedule`) — the column-parallel layout: the
per-element multiplies are vectored column ops over the resident rows, the
sum is a log-depth reduction tree, never a serial Horner sweep (a serial
eval would cost ~n modmuls and dwarf the transform it is checking).
``core.cost.abft_check_cycles`` re-exports the closed form so
``plan(..., verified=True)`` prices the overhead, and the
counter-parity gate (tests/test_abft.py) pins charged == closed-form.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from repro_torch.core.pim import aritpim
from repro_torch.core.pim.device_model import PIMConfig

#: Registry-name -> check-name map (the verdict taxonomy, docs).
CHECKS = {
    "fft": "parseval",
    "rfft": "parseval-half",
    "polymul": "eval-at-one",
    "polymul-real": "eval-at-one",
    "polymul-mod": "eval-at-psi",
}

#: Default relative-residual tolerance for the float checks — matches the
#: serve layer's oracle tolerance (launch/ops.py ``_float_verify``).
FLOAT_TOL = 1e-3


class ABFTUnsupportedModulus(ValueError):
    """RNS modulus Q does not factor over its own limb primes — the
    per-factor eval-at-psi check has no valid evaluation points. Raised
    at verified-bind time so an unverifiable route never starts serving
    with a check that cannot run."""


@dataclasses.dataclass(frozen=True)
class IntegrityVerdict:
    """Uniform outcome of one batch-level integrity check."""
    ok: bool
    check: str                          # CHECKS[...] name
    residual: float = 0.0               # worst relative residual (float)
    tol: float = 0.0                    # threshold applied (0 = exact)
    failed_rows: tuple[int, ...] = ()   # batch rows that failed
    detail: str = ""

    def __bool__(self) -> bool:
        return self.ok


def _rows(x, dtype=None) -> np.ndarray:
    a = np.asarray(x) if dtype is None else np.asarray(x, dtype)
    return a if a.ndim == 2 else a[np.newaxis, :]


def _verdict(check: str, residual: np.ndarray, tol: float,
             detail: str = "") -> IntegrityVerdict:
    bad = np.flatnonzero(residual > tol)
    return IntegrityVerdict(
        ok=bad.size == 0, check=check,
        residual=float(residual.max()) if residual.size else 0.0,
        tol=tol, failed_rows=tuple(int(i) for i in bad), detail=detail)


# ---------------------------------------------------------------------------
# Float checks (toleranced residuals, batch rows)
# ---------------------------------------------------------------------------

def check_fft(x, out, *, tol: float = FLOAT_TOL) -> IntegrityVerdict:
    """Parseval residual per batch row: |sum|X|^2 - n sum|x|^2| / scale."""
    x, out = _rows(x, np.complex128), _rows(out, np.complex128)
    n = x.shape[1]
    lhs = n * np.sum(np.abs(x) ** 2, axis=1)
    rhs = np.sum(np.abs(out) ** 2, axis=1)
    residual = np.abs(rhs - lhs) / np.maximum(1.0, lhs)
    return _verdict(CHECKS["fft"], residual, tol)


def check_rfft(x, out, *, tol: float = FLOAT_TOL) -> IntegrityVerdict:
    """Half-spectrum Parseval: the interior bins carry double weight
    (their conjugate mirrors are not materialized)."""
    x, out = _rows(x, np.float64), _rows(out, np.complex128)
    n = x.shape[1]
    assert out.shape[1] == n // 2 + 1, \
        f"rfft result width {out.shape[1]} != n//2+1 = {n // 2 + 1}"
    e = np.abs(out) ** 2
    rhs = e[:, 0] + e[:, -1] + 2.0 * np.sum(e[:, 1:-1], axis=1)
    lhs = n * np.sum(x ** 2, axis=1)
    residual = np.abs(rhs - lhs) / np.maximum(1.0, lhs)
    return _verdict(CHECKS["rfft"], residual, tol)


def _check_eval_at_one(a, b, r, check: str, tol: float) -> IntegrityVerdict:
    a, b, r = (_rows(v, np.complex128) for v in (a, b, r))
    p1, q1, r1 = a.sum(axis=1), b.sum(axis=1), r.sum(axis=1)
    want = p1 * q1
    # Robust scale: the product magnitude, or the Cauchy–Schwarz bound on
    # it when p1/q1 themselves cancel to ~0 (sums of zero-mean inputs).
    scale = np.maximum.reduce([
        np.ones(len(a)), np.abs(want),
        np.sqrt(np.sum(np.abs(a) ** 2, axis=1)
                * np.sum(np.abs(b) ** 2, axis=1))])
    residual = np.abs(r1 - want) / scale
    return _verdict(check, residual, tol)


def check_polymul(a, b, r, *, tol: float = FLOAT_TOL) -> IntegrityVerdict:
    """Circular complex product: r(1) = a(1) b(1)."""
    return _check_eval_at_one(a, b, r, CHECKS["polymul"], tol)


def check_polymul_real(a, b, r, *,
                       tol: float = FLOAT_TOL) -> IntegrityVerdict:
    """Circular real product: same DC identity on real coefficients."""
    return _check_eval_at_one(a, b, r, CHECKS["polymul-real"], tol)


# ---------------------------------------------------------------------------
# Exact modular checks
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=128)
def _psi_powers(params) -> np.ndarray:
    """(n,) uint64 table of psi^j mod q for Horner-free vectored eval."""
    return params.powers(params.psi)


def _eval_at_psi(rows: np.ndarray, params) -> np.ndarray:
    """Vectored p(psi) mod q per row. Exact in uint64: residues < q < 2^31
    so products < 2^62; the per-element mod keeps partial sums < n * q
    < 2^43 for every supported n."""
    pw = _psi_powers(params)
    q = np.uint64(params.q)
    terms = (rows.astype(np.uint64) * pw) % q
    return terms.sum(axis=1) % q


def check_polymul_mod(a, b, r, params) -> IntegrityVerdict:
    """Exact negacyclic identity r(psi) = a(psi) b(psi) mod q."""
    a, b, r = _rows(a), _rows(b), _rows(r)
    q = np.uint64(params.q)
    ea, eb, er = (_eval_at_psi(v, params) for v in (a, b, r))
    bad = np.flatnonzero((ea * eb) % q != er)
    return IntegrityVerdict(
        ok=bad.size == 0, check=CHECKS["polymul-mod"],
        residual=float(bad.size), tol=0.0,
        failed_rows=tuple(int(i) for i in bad),
        detail=f"q={params.q}")


@functools.lru_cache(maxsize=32)
def check_limbs_for(rns) -> tuple:
    """The NTTParams of the prime factors of Q, recovered from the RNS
    working-limb set (``RNSParams.make(modulus_bits=...)`` builds Q as a
    product of a prefix of those limbs). Raises
    :class:`ABFTUnsupportedModulus` when Q has any other factor."""
    q = rns.modulus
    out = []
    for limb in rns.limbs:
        if q % limb.q == 0:
            out.append(limb)
            q //= limb.q
        if q == 1:
            return tuple(out)
    raise ABFTUnsupportedModulus(
        f"RNS modulus Q~2^{rns.modulus.bit_length()} does not factor over "
        f"its limb primes (remainder ~2^{q.bit_length()}); the per-factor "
        f"eval-at-psi check needs a scheme-style Q = product of NTT limb "
        f"primes — rebuild the route with RNSParams.make(modulus_bits=...)")


def check_polymul_rns(a, b, r, rns) -> IntegrityVerdict:
    """Exact eval-at-psi per prime factor p | Q on the mod-Q result rows
    (object arrays of python ints in [0, Q))."""
    limbs = check_limbs_for(rns)
    a, b, r = _rows(a), _rows(b), _rows(r)
    bad: set[int] = set()
    for limb in limbs:
        p = limb.q
        ra, rb, rr = ((v % p).astype(np.uint64) for v in (a, b, r))
        ea, eb, er = (_eval_at_psi(v, limb) for v in (ra, rb, rr))
        bad |= {int(i) for i in
                np.flatnonzero((ea * eb) % np.uint64(p) != er)}
    return IntegrityVerdict(
        ok=not bad, check=CHECKS["polymul-mod"], residual=float(len(bad)),
        tol=0.0, failed_rows=tuple(sorted(bad)),
        detail=f"rns k={len(limbs)} factors of Q~2^"
               f"{rns.modulus.bit_length()}")


# ---------------------------------------------------------------------------
# Check cost: one schedule, two views (closed form + sim charging)
# ---------------------------------------------------------------------------

def _serial_units(m: int, cfg: PIMConfig) -> int:
    """Column-unit serialization for an m-element check vector, matching
    the transforms' convention (two elements per row, beta column units,
    partitions fire concurrently)."""
    beta = max(1, math.ceil(m / (2 * cfg.crossbar_rows)))
    return math.ceil(beta / cfg.partitions)


def _schedule(workload: str, n: int,
              cfg: PIMConfig) -> list[tuple]:
    """The check's crossbar op sequence — the single source of truth for
    both :func:`check_cycles` and :func:`charge_check`.

    Entries: ("col", op, active_rows, serial) vectored column op;
             ("row", n_rows, cycles_per_row, tag) serial row moves;
             ("twiddle", count) periphery constant writes.
    """
    s: list[tuple] = []
    rows = cfg.crossbar_rows

    def reduce_tree(m: int, add_op: str) -> None:
        # Log-depth sum of m resident values: fold the live rows pairwise
        # (row-granularity moves to align), one vectored add per level.
        live = min(m, rows)
        if live > 1:
            s.append(("row", live - 1, 2, "abft-reduce"))
        if m > 1:
            s.append(("col", add_op, live,
                      math.ceil(math.log2(m)) * _serial_units(m, cfg)))

    def energy(m: int, complex_vals: bool) -> None:
        live = min(m, rows)
        if complex_vals:                 # |z|^2 = re^2 + im^2
            s.append(("col", "fmul", live, 2 * _serial_units(m, cfg)))
            s.append(("col", "fadd", live, _serial_units(m, cfg)))
        else:                            # x^2
            s.append(("col", "fmul", live, _serial_units(m, cfg)))
        reduce_tree(m, "fadd")

    def eval_mod(m: int) -> None:
        s.append(("twiddle", m))         # psi^j constant column
        s.append(("col", "modmul", min(m, rows), _serial_units(m, cfg)))
        reduce_tree(m, "modadd")

    # repro: noqa[dispatch-ladder]: per-workload check-SCHEDULE construction (cost data, not op dispatch) — serving binds these checks through the launch/ops.py registry
    if workload == "fft":  # repro_torch: noqa[dispatch-ladder]: per-workload check-SCHEDULE construction (cost data, not op dispatch); serving binds these checks through the launch/ops.py registry
        energy(n, True)                  # input energy
        energy(n, True)                  # output energy
        s.append(("col", "fmul", 1, 1))  # scale lhs by n
        s.append(("row", 1, 2, "abft-compare"))
    elif workload == "rfft":
        energy(n, False)                 # real input energy
        energy(n // 2 + 1, True)         # half-spectrum energy
        s.append(("col", "fadd", 1, 1))  # interior double-weight fold
        s.append(("col", "fmul", 1, 1))  # scale lhs by n
        s.append(("row", 1, 2, "abft-compare"))
    elif workload == "polymul":
        for _ in range(3):               # a(1), b(1), r(1)
            reduce_tree(n, "cadd")
        s.append(("col", "cmul", 1, 1))  # a(1) * b(1)
        s.append(("row", 1, 2, "abft-compare"))
    elif workload == "polymul-real":
        for _ in range(3):
            reduce_tree(n, "fadd")
        s.append(("col", "fmul", 1, 1))
        s.append(("row", 1, 2, "abft-compare"))
    elif workload == "polymul-mod":
        for _ in range(3):               # a(psi), b(psi), r(psi)
            eval_mod(n)
        s.append(("col", "modmul", 1, 1))
        s.append(("col", "modadd", 1, 1))
        s.append(("row", 1, 2, "abft-compare"))
    else:
        raise ValueError(f"unknown workload {workload!r}")
    return s


def check_cycles(workload: str, n: int, cfg: PIMConfig, spec) -> int:
    """Closed-form latency cycles of one integrity check (per batch unit;
    batch rows ride the same vectored ops, exactly like the transforms)."""
    total = 0
    for entry in _schedule(workload, n, cfg):
        if entry[0] == "col":
            _, op, _rows_, serial = entry
            total += aritpim.op_cycles(op, spec) * serial
        elif entry[0] == "row":
            _, n_rows, per_row, _tag = entry
            total += n_rows * per_row
        else:                            # ("twiddle", count)
            total += entry[1]
    return total


def charge_check(sim, workload: str, n: int) -> None:
    """Charge the check schedule on a live ``CrossbarSim`` — the
    counter-parity twin of :func:`check_cycles` (same ``_schedule``, so
    charged cycles == closed form by construction; the test pins it
    against drift in the sim's charging conventions)."""
    for entry in _schedule(workload, n, sim.cfg):
        if entry[0] == "col":
            _, op, rows, serial = entry
            sim.charge_column_op(op, rows, serial=serial)
        elif entry[0] == "row":
            _, n_rows, per_row, tag = entry
            sim.charge_row_ops(n_rows, cycles_per_row=per_row, tag=tag)
        else:
            sim.charge_twiddle_writes(entry[1])
