"""The check decides `correct`: a run with the timed entry broken
underneath comes out false, once for each fault the cells can have (a
step that returns its input unchanged; half of the batch left out; an
answer altered where it is produced; one chip only, so no exchange to
leave out), and the controls fail the limits that sound runs pass."""
from __future__ import annotations

import pytest
import torch

from portbench.lib import cell as cell_mod

CELLS = ["rlwe4096.sat", "polyreal16384.sat", "rlwe4096.load80"]


def unchanged(fn):
    """Returns its first operand as the product (int32 words for RNS)."""
    def broken(a, b):
        out = fn(a, b)
        return a.view(out.dtype).clone()
    return broken


def half_batch(fn):
    """Computes the first half of the products and repeats them."""
    def broken(a, b):
        rows = a.shape[-2] // 2
        out = fn(a[..., :rows, :].contiguous(), b[..., :rows, :].contiguous())
        return torch.cat([out, out], dim=-2)
    return broken


def altered(fn):
    """Every request's product number (request count mod R) has one
    coefficient changed by one unit."""
    calls = [0]

    def broken(a, b):
        out = fn(a, b).clone()
        row = calls[0] % out.shape[-2]
        calls[0] += 1
        out[..., row, 7] += 1
        return out
    return broken


def run(cell, **kw):
    return cell_mod.run(torch, cell, seed=2**31 + 17, seconds=0.2,
                        traced=False, device="cpu", started=0.0, **kw)


@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_pass(small_cell, name):
    out = run(small_cell(name))
    assert out.correct and out.failed == 0


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [unchanged, half_batch, altered])
def test_faults_come_out_not_correct(small_cell, name, fault):
    out = run(small_cell(name), wrap=fault)
    assert not out.correct and out.failed > 0


@pytest.mark.parametrize("name", ["rlwe4096.sat", "polyreal16384.sat"])
def test_controls_come_out_not_correct(small_cell, name):
    cell = small_cell(name)
    ops = cell.module("ops")
    for variant in ops.CONTROLS:
        out = run(cell, fn=ops.control(torch, cell.config, variant))
        assert not out.correct, variant
        assert all(c["value"] > c["limit"]
                   for k, c in out.compared.items()
                   if k != "unfinished_requests")


def test_an_unfinished_request_is_not_correct(small_cell):
    from portbench.lib import loadgen
    cell = small_cell("rlwe4096.load80")

    class Never(loadgen.HostSync):
        class _Never(loadgen.HostSync._Done):
            def synchronize(self):
                import time
                time.sleep(3600)

            def query(self):
                return False

        def event(self):
            return self._Never()

    cell.traffic["late_after_s"] = 0.2
    orig = loadgen.HostSync
    loadgen.HostSync = Never
    try:
        out = run(cell)
    finally:
        loadgen.HostSync = orig
    assert not out.correct
    assert out.compared["unfinished_requests"]["value"] == out.attempted
