"""Seeded, deterministic device-fault models for the crossbar simulator.

Port of ``repro.core.pim.faults``: a numpy copy that imports nothing of
the reference, pinned equal to the original by
``tests/test_torch_pim.py``.

Real memristor arrays are not the perfect machine ``CrossbarSim`` models:
cells get stuck at 0/1 (endurance wear, forming failures), gate ops
suffer transient bit flips, and whole arrays die. This module is the
fault INJECTION side of the repo's ABFT story (docs/fault_tolerance.md):
a :class:`FaultModel` describes a fleet-level fault population; the sim
resolves its own array's slice of it (:meth:`FaultModel.for_array`) and
corrupts butterfly outputs behind a zero-overhead-when-disabled hook
(``crossbar.CrossbarSim``), appending ``("fault:<kind>:a<id>", 0)``
ledger entries to the charge log so tests can assert exactly which array
misbehaved and how often.

Everything is seeded and replayable: the same ``(seed, array_id)`` pair
always yields the same stuck cells, and transients draw from a generator
seeded per array — re-executing the same op sequence reproduces the same
corruption, which is what lets the chaos tests pin "corruption is always
detected" instead of sampling it.

Value-level fidelity (same abstraction as the sim itself): a stuck cell
forces one vector element to a fixed value (0 for SA0; 1 for SA1 in the
float domain, a forced word bit in the modular domain), a transient flip
perturbs one element's stored word (an exponent-bit flip doubles a float;
an xor of a low bit shifts a residue by ±1) — bit-level gate sequences
are costs, not re-simulated state, so faults land on values.

Recovery (``launch/engine.py``): a circuit breaker that gives up on an
array calls :meth:`FaultModel.quarantine` — the logical array id remaps
to a spare PHYSICAL array beyond the faulty population, so subsequent
``for_array`` lookups come back clean. Spares are finite
(:class:`SparesExhausted`), like on real dies.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: Bit lanes a stuck/transient fault may land on in the modular domain:
#: kept below the 2^30 modulus width so a forced bit stays a plausible
#: residue perturbation rather than a guaranteed out-of-range value.
_FAULT_BIT_LANES = 24


class SparesExhausted(RuntimeError):
    """Quarantine requested but every spare array is already mapped."""


@dataclasses.dataclass(frozen=True)
class ArrayFaults:
    """One physical array's resolved fault state (what the sim consumes).

    ``stuck_pos`` are position SEEDS, reduced mod the live vector length
    at injection time — the sim's vectored ops span different row counts
    per stage, and a fixed cell must keep hitting the same relative slot
    deterministically across all of them.
    """
    array_id: int
    dead: bool
    stuck_pos: tuple[int, ...]
    stuck_val: tuple[int, ...]      # 0 = SA0, 1 = SA1, per cell
    stuck_bit: tuple[int, ...]      # forced bit lane (modular domain)
    bitflip_per_gate: float

    @property
    def permanent(self) -> bool:
        """True when this array corrupts EVERY op (dead / stuck cells) —
        the failure class that must trip the engine's circuit breaker
        rather than be retried away."""
        return self.dead or bool(self.stuck_pos)


class FaultModel:
    """A seeded fleet-level fault population over ``n_arrays`` + spares.

    Mutable on purpose: quarantine state (logical -> spare remap) is the
    one piece of recovery state that must survive across re-executions,
    so it lives here rather than in any single sim instance.
    """

    def __init__(self, *, seed: int = 0, stuck_per_array: int = 0,
                 bitflip_per_gate: float = 0.0,
                 dead_arrays: tuple[int, ...] = (),
                 n_arrays: int = 16, spares: int = 4):
        if n_arrays < 1:
            raise ValueError(f"n_arrays={n_arrays} must be >= 1")
        if stuck_per_array < 0:
            raise ValueError(f"stuck_per_array={stuck_per_array} < 0")
        if not 0.0 <= bitflip_per_gate <= 1.0:
            raise ValueError(
                f"bitflip_per_gate={bitflip_per_gate} not a probability")
        if spares < 0:
            raise ValueError(f"spares={spares} < 0")
        bad = [a for a in dead_arrays if not 0 <= a < n_arrays]
        if bad:
            raise ValueError(f"dead_arrays {bad} outside [0, {n_arrays})")
        self.seed = seed
        self.stuck_per_array = stuck_per_array
        self.bitflip_per_gate = float(bitflip_per_gate)
        self.dead_arrays = tuple(dead_arrays)
        self.n_arrays = n_arrays
        self.spares = spares
        self._quarantined: dict[int, int] = {}
        self._spares_used = 0

    # -- quarantine / spare remap ------------------------------------------
    def physical(self, array_id: int) -> int:
        """Logical -> physical array id (identity until quarantined)."""
        return self._quarantined.get(array_id, array_id)

    def is_quarantined(self, array_id: int) -> bool:
        return array_id in self._quarantined

    @property
    def quarantined(self) -> dict[int, int]:
        return dict(self._quarantined)

    def quarantine(self, array_id: int) -> int:
        """Remap a faulty logical array onto the next spare; idempotent.

        Spares live beyond the faulty population (ids >= ``n_arrays``),
        so a quarantined array resolves clean in :meth:`for_array`.
        """
        if array_id in self._quarantined:
            return self._quarantined[array_id]
        if self._spares_used >= self.spares:
            raise SparesExhausted(
                f"array {array_id}: all {self.spares} spare arrays are "
                f"already mapped ({sorted(self._quarantined)})")
        spare = self.n_arrays + self._spares_used
        self._spares_used += 1
        self._quarantined[array_id] = spare
        return spare

    # -- per-array resolution ----------------------------------------------
    def for_array(self, array_id: int):
        """Resolve the fault state a sim bound to ``array_id`` sees, or
        None when that array is clean (the zero-overhead fast path: the
        sim holds None and its op hooks cost one identity check)."""
        phys = self.physical(array_id)
        if phys >= self.n_arrays:
            return None             # spare: clean by construction
        dead = phys in self.dead_arrays
        stuck_pos: tuple[int, ...] = ()
        stuck_val: tuple[int, ...] = ()
        stuck_bit: tuple[int, ...] = ()
        if self.stuck_per_array:
            rng = np.random.default_rng([self.seed, phys])
            stuck_pos = tuple(
                int(v) for v in rng.integers(0, 1 << 30,
                                             self.stuck_per_array))
            stuck_val = tuple(
                int(v) for v in rng.integers(0, 2, self.stuck_per_array))
            stuck_bit = tuple(
                int(v) for v in rng.integers(0, _FAULT_BIT_LANES,
                                             self.stuck_per_array))
        if not dead and not stuck_pos and self.bitflip_per_gate <= 0.0:
            return None
        return ArrayFaults(array_id=array_id, dead=dead,
                           stuck_pos=stuck_pos, stuck_val=stuck_val,
                           stuck_bit=stuck_bit,
                           bitflip_per_gate=self.bitflip_per_gate)

    def rng_for(self, array_id: int, salt: int = 0) -> np.random.Generator:
        """Deterministic transient-fault stream for one array: seeded by
        (model seed, PHYSICAL id, salt), so a quarantined array's spare
        draws a different — still replayable — stream."""
        return np.random.default_rng([self.seed, self.physical(array_id),
                                      salt])

    def __repr__(self) -> str:
        return (f"FaultModel(seed={self.seed}, "
                f"stuck_per_array={self.stuck_per_array}, "
                f"bitflip_per_gate={self.bitflip_per_gate}, "
                f"dead_arrays={self.dead_arrays}, "
                f"n_arrays={self.n_arrays}, spares={self.spares}, "
                f"quarantined={self._quarantined})")
