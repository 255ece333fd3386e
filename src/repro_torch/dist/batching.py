"""Crossbar-batch scheduling (paper §6) on arrays and meshes.

Port of ``repro.dist.batching``: a copy that imports nothing of the
reference, pinned equal to the original by ``tests/test_torch_pim.py``.

FourierPIM's throughput headline comes from running one transform per
crossbar array, all arrays in parallel; a batch of B transforms therefore
executes in ``ceil(B / num_arrays)`` *waves*, and the last (tail) wave
leaves arrays idle. The same shape appears one level up on a device mesh:
B transforms map onto the ``(pod, data)`` device axes, then onto each
device's local arrays (crossbars for the PIM model).

This module is pure scheduling arithmetic -- no tensor ops -- so the
numpy-based PIM simulator (``core.pim.fft_pim`` and ``core.pim.ntt_pim``)
uses it to report per-array utilization and to convert single-transform
latency into batched throughput; ``shard_batch`` duck-types
``mesh.shape``, so the multi-device tiers can reuse it.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["WaveSchedule", "MeshBatchPlan", "CrossbarBatchPlan",
           "schedule_waves", "shard_batch", "plan_crossbar_batch"]


@dataclasses.dataclass(frozen=True)
class WaveSchedule:
    """B transforms over ``num_arrays`` parallel arrays, in waves."""
    batch: int
    num_arrays: int
    waves: int
    tail: int               # transforms in the final partial wave (0 = none)

    @property
    def wave_sizes(self) -> tuple[int, ...]:
        full = [self.num_arrays] * (self.batch // self.num_arrays)
        return tuple(full + ([self.tail] if self.tail else []))

    @property
    def utilization(self) -> float:
        """Busy array-waves / provisioned array-waves."""
        if self.batch == 0:
            return 0.0
        return self.batch / (self.waves * self.num_arrays)

    def latency(self, wave_latency: float) -> float:
        return self.waves * wave_latency

    def throughput(self, wave_latency: float) -> float:
        """Completed transforms per unit time at ``wave_latency`` each."""
        if self.batch == 0:
            return 0.0
        return self.batch / self.latency(wave_latency)


def schedule_waves(batch: int, num_arrays: int) -> WaveSchedule:
    if batch < 0 or num_arrays < 1:
        raise ValueError(f"bad schedule: batch={batch} arrays={num_arrays}")
    waves = max(1, math.ceil(batch / num_arrays)) if batch else 0
    tail = batch % num_arrays if batch else 0
    return WaveSchedule(batch=batch, num_arrays=num_arrays,
                        waves=waves, tail=tail)


@dataclasses.dataclass(frozen=True)
class MeshBatchPlan:
    """B transforms over the mesh's batch-bearing device axes."""
    global_batch: int
    axes: tuple[str, ...]   # mesh axes actually present and used
    n_devices: int          # product of their sizes
    per_device: int         # ceil share per device
    pad: int                # ghost transforms added to even out the shards

    @property
    def utilization(self) -> float:
        if self.global_batch == 0:
            return 0.0
        return self.global_batch / (self.per_device * self.n_devices)


def shard_batch(batch: int, mesh, axes=("pod", "data")) -> MeshBatchPlan:
    """Partition ``batch`` transforms over the mesh axes in ``axes``.

    Axes absent from the mesh are skipped (single-pod meshes have no "pod"),
    mirroring the ``sharding.sanitize_spec`` contract. A batch that doesn't
    divide is padded up; the pad shows up as lost utilization, not an error.
    """
    present = tuple(a for a in axes if a in mesh.shape)
    n_dev = 1
    for a in present:
        n_dev *= int(mesh.shape[a])
    per_device = math.ceil(batch / n_dev) if batch else 0
    return MeshBatchPlan(global_batch=batch, axes=present, n_devices=n_dev,
                         per_device=per_device,
                         pad=per_device * n_dev - batch)


@dataclasses.dataclass(frozen=True)
class CrossbarBatchPlan:
    """Combined plan: mesh sharding, then per-device waves over arrays."""
    mesh_plan: MeshBatchPlan
    wave: WaveSchedule      # the per-device schedule

    @property
    def waves(self) -> int:
        return self.wave.waves

    @property
    def utilization(self) -> float:
        """Fraction of provisioned array-waves doing real work, across the
        whole installation (mesh padding x tail-wave idling)."""
        if self.mesh_plan.global_batch == 0:
            return 0.0
        provisioned = (self.mesh_plan.n_devices * self.wave.waves
                       * self.wave.num_arrays)
        return self.mesh_plan.global_batch / provisioned

    def latency(self, wave_latency: float) -> float:
        return self.wave.latency(wave_latency)

    def throughput(self, wave_latency: float) -> float:
        """Global transforms/sec: every device runs its waves in parallel."""
        if self.mesh_plan.global_batch == 0:
            return 0.0
        return self.mesh_plan.global_batch / self.latency(wave_latency)

    def report(self) -> dict:
        return {
            "global_batch": self.mesh_plan.global_batch,
            "mesh_axes": list(self.mesh_plan.axes),
            "n_devices": self.mesh_plan.n_devices,
            "per_device_batch": self.mesh_plan.per_device,
            "arrays_per_device": self.wave.num_arrays,
            "waves": self.wave.waves,
            "tail": self.wave.tail,
            "utilization": self.utilization,
        }


def plan_crossbar_batch(batch: int, *, num_arrays: int, mesh=None,
                        axes=("pod", "data")) -> CrossbarBatchPlan:
    """Plan B transforms onto (optionally) a mesh, then onto per-device
    arrays. ``mesh=None`` plans for a single device's arrays — the paper's
    §6 setting, where ``num_arrays`` is the crossbar count."""
    if mesh is not None:
        mp = shard_batch(batch, mesh, axes)
        per_device = mp.per_device
    else:
        mp = MeshBatchPlan(global_batch=batch, axes=(), n_devices=1,
                           per_device=batch, pad=0)
        per_device = batch
    return CrossbarBatchPlan(mesh_plan=mp,
                             wave=schedule_waves(per_device, num_arrays))
