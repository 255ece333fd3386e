"""Nothing the benchmark runs loads JAX or the JAX package (``repro``),
compared by whole top-level names since ``repro_torch`` begins with
``repro``; the reference loads nothing of the program either."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from portbench.lib.spec import BENCH_DIR, ROOT

BANNED = {"jax", "jaxlib", "flax", "repro"}


def _top_level_imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_of_the_benchmark_imports_jax_or_repro():
    for p in BENCH_DIR.rglob("*.py"):
        assert not _top_level_imports(p) & BANNED, p


def test_the_reference_imports_nothing_of_the_program():
    for p in (BENCH_DIR / "reference").glob("*.py"):
        assert not _top_level_imports(p) & (BANNED | {"repro_torch",
                                                      "portbench"}), p


_PROBE = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
import torch
torch.set_num_threads(1)
{body}
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in {banned!r})
print('LOADED', bad)
"""


def _loaded(body: str) -> str:
    code = _PROBE.format(root=str(ROOT), src=str(ROOT / "src"), body=body,
                         banned=sorted(BANNED))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("name", ["rlwe4096.sat", "rlwe4096.load80"])
def test_a_run_loads_no_jax(name):
    body = f"""
sys.path.insert(0, {str(BENCH_DIR / 'tests')!r})
from conftest import shrink
from portbench.lib import cell, spec
import portbench.run as run
c = shrink(spec.cell({name!r}))
cell.run(torch, c, seed=5, seconds=0.05, traced=True, device='cpu',
         started=0.0)
assert run.banned_modules() == []
"""
    assert _loaded(body) == "LOADED []"


def test_the_reference_loads_no_program():
    body = f"""
from portbench.lib.spec import BENCH_DIR, load_module
load_module(BENCH_DIR / 'reference' / 'rns_negacyclic.py')
load_module(BENCH_DIR / 'reference' / 'real_circular.py')
assert not any(m.split('.')[0] == 'repro_torch' for m in sys.modules)
"""
    assert _loaded(body) == "LOADED []"
