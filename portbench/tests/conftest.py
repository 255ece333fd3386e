"""Shared fixtures of the benchmark's own tests (run them with
``python -m pytest portbench/tests``; the repository's suite does not
collect this folder)."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def shrink(cell, n: int = 64, products: int = 8):
    """A cell at a size the CPU runs in well under a second."""
    cell.config["n"] = n
    if cell.kind == "rns_negacyclic":
        cell.config["modulus_bits"] = 40
        ref = cell.module("ops").REF
        cell.config["limbs"] = len(ref.limbs(n, 40, 30)[1])
    cell.traffic.update(products_per_request=products, operand_sets=2,
                        check_requests=3)
    if cell.traffic["loop"] == "open":
        cell.traffic["rate_rps"] = 100.0
    return cell


@pytest.fixture
def small_cell():
    from portbench.lib import spec
    return lambda name: shrink(spec.cell(name))


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the port's kernels have no CPU "
                    "mode on the card path")
    return torch.device("cuda")
