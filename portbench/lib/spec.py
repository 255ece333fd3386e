"""Finds every file of a cell by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix. Its files:

  portbench/workloads/<cell>.json     the cell's own parameters (a rate)
  <configs[].file>                    the configuration's sizes; its
                                      ``kind`` names the next three
  portbench/ops/<kind>.py             operands, the bound entry, the check
  portbench/reference/<kind>.py       the plain reference and its control
  portbench/roofline/<kind>.py        bytes and operations a product
  portbench/traffic/<traffic>.json    the mix's parameters
  portbench/metrics/<metric>.py       one reader per metric

So a cell, a configuration, a mix or a metric is added by adding files and
entries, never by editing one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """Import a file by its path (names may hold '.' and '-')."""
    name = "portbench_" + re.sub(r"\W", "_", str(path.relative_to(BENCH_DIR)))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict          # the mix's parameters, the cell's own on top
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def kind(self) -> str:
        return self.config["kind"]

    def module(self, folder: str) -> ModuleType:
        return load_module(BENCH_DIR / folder / f"{self.kind}.py")


def _reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(metric: str) -> ModuleType:
    return load_module(BENCH_DIR / "metrics" / f"{metric}.py")


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with every file it names."""
    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have "
                         + ", ".join(w["name"] for w in bench["workloads"]))
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    traffic.update(load_json(BENCH_DIR / "workloads" / f"{name}.json"))
    return Cell(
        name=name, chips=entry["chips"], config=load_json(ROOT / conf["file"]),
        traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reported_in(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported_in(m, name)])
