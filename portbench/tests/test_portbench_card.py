"""Runs of the benchmark on the card (skipped without one): each cell
once, short, traced and not, and correct."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.lib.spec import ROOT

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", ["rlwe4096.sat", "polyreal16384.sat",
                                  "rlwe4096.load80"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(cuda, name, trace):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(2**31 + 11), "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]
