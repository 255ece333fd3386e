"""Mesh construction (port of ``repro.launch.mesh``): the training CLI's
``make_dev_mesh`` and the dry-run's ``make_production_mesh``.

Functions, not module-level constants: importing this module touches no
device.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.dist import sharding


def make_dev_mesh(n_data: int = 2, n_model: int = 4, *,
                  n_pods: Optional[int] = None, device=None
                  ) -> sharding.Mesh:
    """A (data, model) mesh of the port's one process, or with ``n_pods``
    a (pod, data, model) mesh (the training CLI's ``--mesh PxDxM``):
    shards round-robin over the visible cards, or all on the CPU with
    ``device="cpu"``."""
    if n_pods is None:
        return sharding.make_mesh((n_data, n_model), ("data", "model"),
                                  device=device)
    return sharding.make_mesh((n_pods, n_data, n_model),
                              ("pod", "data", "model"), device=device)


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> sharding.Mesh:
    """The dry-run's meshes, as the reference's: 16 x 16 = 256 shards
    (data, model), or with ``multi_pod`` 2 x 16 x 16 = 512 (pod, data,
    model; FSDP extends over (pod, data)). On the ``meta`` device by
    default: shapes without values, nothing allocated."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return sharding.make_mesh(shape, axes, device=device)

