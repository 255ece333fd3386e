"""The result's line: its keys, and the run's refusals."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.lib import cell as cell_mod
from portbench.lib.spec import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", ["rlwe4096.sat", "rlwe4096.load80"])
@pytest.mark.parametrize("traced", [False, True])
def test_last_line_keys(small_cell, name, traced):
    cell = small_cell(name)
    out = cell_mod.run(torch, cell, seed=2**31 + 99, seconds=0.1,
                       traced=traced, device="cpu", started=0.0)
    line = json.loads(json.dumps(out.line()))
    want = KEYS + (["breakdown"] if traced else []) + ["compared"]
    assert list(line) == want        # the compared numbers come last
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    e2e = {m["name"] for m in cell.end_to_end}
    layer = {m["name"] for m in cell.per_layer}
    assert set(line["metrics"]) <= (layer if traced else e2e)
    if not traced:
        assert set(line["metrics"]) == e2e
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"}
    if traced:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])


def test_no_result_without_cuda_or_in_a_bare_tree(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "rlwe4096.sat",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
