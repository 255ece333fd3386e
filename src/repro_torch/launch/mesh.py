"""Mesh construction for the training CLI (port of ``repro.launch.mesh``'s
``make_dev_mesh``).

A function, not a module-level constant: importing this module touches no
device. The reference's ``make_production_mesh`` (the 256- and 512-chip
dry-run meshes) comes with the dry-run tools, ROADMAP queue 1, item 11g.
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
