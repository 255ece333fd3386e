"""Logical (value-level) crossbar simulator with cycle/energy counters.

Port of ``repro.core.pim.crossbar``: a numpy copy that imports nothing of
the reference, pinned equal to the original by
``tests/test_torch_pim.py``.

The paper verifies FourierPIM on a cycle-accurate simulator that "logically
models a memristive crossbar array and performs the sequence of operations
that correspond to the proposed algorithms" (§6). This module is that
simulator, reproduced at the same abstraction level:

  * values are tracked numerically (a crossbar is an (rows, word-slots)
    complex array) — correctness of the FFT/polymul mapping is checked
    against ``numpy.fft`` on random inputs, exactly like the paper checks
    against baseline implementations;
  * every vectored operation charges latency cycles and gate executions per
    the AritPIM cost model (aritpim.py), which drive the throughput/energy
    numbers in the benchmarks;
  * the bit-level gate sequences themselves are NOT re-simulated per value —
    they are memristor-circuit facts imported as costs (their own validation
    is AritPIM's [12]); a narrow bit-exact NOR-adder check lives in
    tests/test_pim.py to pin the cost model's structural assumptions.

Cost conventions (see DESIGN.md §PIM):
  column op  (bitline voltages): 1 gate/row/cycle, all rows in parallel.
  row op     (wordline voltages): whole row in 1 gate-step/cycle, rows serial.
  partitions: p independent column-units may fire gates concurrently.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.pim import aritpim
from repro_torch.core.pim.device_model import PIMConfig


@dataclasses.dataclass
class Counters:
    cycles: int = 0
    gates: int = 0

    def energy_j(self, cfg: PIMConfig) -> float:
        return self.gates * cfg.gate_energy_j

    def latency_s(self, cfg: PIMConfig) -> float:
        return self.cycles / cfg.clock_hz


class CrossbarSim:
    """One crossbar: (rows x word-slot) values + cost counters.

    Works for both number domains: complex floats (FloatSpec, the paper's
    FFT) and modular residues (IntSpec, the exact NTT) — the spec only
    enters through ``aritpim.op_cycles`` and the storage word width.

    Every charge appends a ``(tag, cycles)`` record to ``self.log`` so tests
    can assert *ordering* contracts (e.g. the input bit-reversal permutation
    is charged before the first butterfly in every layout), not just totals.
    """

    def __init__(self, cfg: PIMConfig, spec, *, faults=None,
                 array_id: int = 0):
        self.cfg = cfg
        self.spec = spec
        self.word_bits = aritpim.storage_word_bits(spec)
        self.slots = cfg.crossbar_cols // self.word_bits
        self.values = np.zeros((cfg.crossbar_rows, self.slots), np.complex128)
        self.ctr = Counters()
        self.log: list[tuple[str, int]] = []
        # Fault hook (core/pim/faults.py): resolved ONCE at construction so
        # the common fault-free path costs a single ``is None`` check per
        # butterfly — zero overhead when disabled.
        self.array_id = array_id
        self.faults = (faults.for_array(array_id)
                       if faults is not None else None)
        self._fault_rng = (faults.rng_for(array_id, salt=1)
                           if self.faults is not None else None)

    # -- cost charging ------------------------------------------------------
    def charge_column_op(self, op: str, active_rows: int, serial: int = 1):
        c = aritpim.op_cycles(op, self.spec) * serial
        self.ctr.cycles += c
        self.ctr.gates += c * active_rows
        self.log.append((op, c))

    def charge_row_ops(self, n_rows: int, cycles_per_row: int = 2,
                       tag: str = "row"):
        """Serial row-granularity moves (copy=2 NOT cycles, swap=6)."""
        self.ctr.cycles += n_rows * cycles_per_row
        self.ctr.gates += n_rows * cycles_per_row * self.word_bits
        self.log.append((tag, n_rows * cycles_per_row))

    def charge_twiddle_writes(self, n_values: int):
        """Constants written by the periphery (paper footnote 3): one row
        write per value, parallel across crossbars, negligible energy."""
        self.ctr.cycles += n_values
        self.ctr.gates += n_values * self.word_bits
        self.log.append(("twiddle", n_values))

    # -- value-level ops (verified numerically) -----------------------------
    def load(self, x: np.ndarray, slot0: int = 0):
        """Store a sequence into slots (snake over rows within each slot
        pair); no cost — DMA into memory is outside the kernel, as in the
        paper's batched setup."""
        r = self.cfg.crossbar_rows
        x = np.asarray(x, np.complex128)
        cols = math.ceil(len(x) / r)
        assert slot0 + cols <= self.slots, "sequence does not fit"
        for c in range(cols):
            chunk = x[c * r:(c + 1) * r]
            self.values[:len(chunk), slot0 + c] = chunk
        return cols

    def butterfly_rows(self, u: np.ndarray, v: np.ndarray, w: np.ndarray,
                       active_rows: int, serial_units: int = 1):
        """Vectored in-place butterfly on value vectors (u,v,w aligned rows).

        Returns (u + w v, u - w v); charges one butterfly per serial unit
        group (paper §4.2: O(1) vector ops regardless of row count).
        """
        t = w * v
        self.charge_column_op("butterfly", active_rows, serial=serial_units)
        hi, lo = u + t, u - t
        if self.faults is not None:
            hi, lo = self._inject_float(hi, lo)
        return hi, lo

    def butterfly_rows_mod(self, u: np.ndarray, v: np.ndarray, w: np.ndarray,
                           q: int, active_rows: int, serial_units: int = 1):
        """Modular butterfly (u + w v, u - w v) mod q on uint64 residue
        vectors; one ``ntt_butterfly``-costed vectored op per serial unit.
        Exact: all operands < q < 2^31, products < 2^62 fit uint64."""
        qq = np.uint64(q)
        t = (w * v) % qq
        self.charge_column_op("butterfly", active_rows, serial=serial_units)
        hi, lo = (u + t) % qq, (u + qq - t) % qq
        if self.faults is not None:
            hi, lo = self._inject_mod(hi, lo, qq)
        return hi, lo

    # -- fault injection (core/pim/faults.py; ledger entries cost 0) --------
    def _fault_log(self, kind: str) -> None:
        self.log.append((f"fault:{kind}:a{self.array_id}", 0))

    def _transient_fires(self) -> bool:
        """Per-op transient coin: p = 1 - (1-rate)^gates for the gates the
        butterfly just charged (the last log entry's cycles x its rows are
        folded into one op-level draw — bit-level gates are costs here,
        not simulated state, so the flip lands on one stored value)."""
        f = self.faults
        if f.bitflip_per_gate <= 0.0:
            return False
        gates = self.log[-1][1] * max(1, self.cfg.crossbar_rows // 2)
        p = 1.0 - (1.0 - f.bitflip_per_gate) ** gates
        return bool(self._fault_rng.random() < p)

    def _inject_float(self, hi: np.ndarray, lo: np.ndarray):
        f = self.faults
        hv, lv = hi.reshape(-1), lo.reshape(-1)
        if f.dead:
            hv[:] = 0.0
            lv[:] = 0.0
            self._fault_log("dead")
            return hi, lo
        for pos, val in zip(f.stuck_pos, f.stuck_val):
            tgt = hv if (pos >> 1) % 2 == 0 else lv
            forced = 1.0 if val else 0.0
            i = pos % tgt.size
            if tgt[i] != forced:
                tgt[i] = forced
                self._fault_log("stuck")
        if self._transient_fires():
            tgt = hv if self._fault_rng.random() < 0.5 else lv
            i = int(self._fault_rng.integers(0, tgt.size))
            tgt[i] *= 2.0           # exponent-bit flip: magnitude doubles
            self._fault_log("flip")
        return hi, lo

    def _inject_mod(self, hi: np.ndarray, lo: np.ndarray, qq: np.uint64):
        f = self.faults
        hv, lv = hi.reshape(-1), lo.reshape(-1)
        if f.dead:
            hv[:] = np.uint64(0)
            lv[:] = np.uint64(0)
            self._fault_log("dead")
            return hi, lo
        for pos, val, bit in zip(f.stuck_pos, f.stuck_val, f.stuck_bit):
            tgt = hv if (pos >> 1) % 2 == 0 else lv
            i = pos % tgt.size
            mask = np.uint64(1 << bit)
            forced = ((tgt[i] | mask) if val
                      else (tgt[i] & ~mask)) % qq
            if forced != tgt[i]:
                tgt[i] = forced
                self._fault_log("stuck")
        if self._transient_fires():
            tgt = hv if self._fault_rng.random() < 0.5 else lv
            i = int(self._fault_rng.integers(0, tgt.size))
            bit = int(self._fault_rng.integers(0, 20))
            tgt[i] = (tgt[i] ^ np.uint64(1 << bit)) % qq
            self._fault_log("flip")
        return hi, lo
