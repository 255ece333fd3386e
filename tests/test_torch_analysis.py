"""The port's invariant linter (``repro_torch.analysis``).

Layers, as ``tests/test_analysis.py`` has them for the reference:
  * fixture pairs — for EVERY registered rule, one snippet it MUST flag
    and one near-miss that passes every rule; the meta test makes the
    pairing a closed loop and requires each rule's docstring to name the
    PR it encodes;
  * the copy pinned to the original — the rules whose logic the port
    keeps (``mutable-default``, ``signal-lock``) and the suppression
    parser give the reference's (line, col) lists on the same sources;
  * engine mechanics — suppression placement, mandatory reasons,
    unused-noqa, meta rules, and the two markers (``# repro: noqa`` and
    ``# repro_torch: noqa``) that neither engine reads across;
  * the gate — ``src/repro_torch``, ``chip_smoke.py`` and the port's
    tests are clean, and a seeded raw write under ``ft/`` turns it red.

Imports no jax: ``repro.analysis`` and ``repro_torch.analysis`` are
stdlib-only.
"""
from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro import analysis as ref_analysis
from repro.analysis import engine as ref_engine
from repro.analysis import rules as ref_rules
from repro_torch import analysis
from repro_torch.analysis import engine, rules

ROOT = Path(__file__).resolve().parent.parent
GATE = ["src/repro_torch", "chip_smoke.py",
        *sorted(str(p.relative_to(ROOT))
                for p in (ROOT / "tests").glob("test_torch_*.py"))]

# ---------------------------------------------------------------------------
# Fixture pairs: rule id -> {flag: (source, path), ok: (source, path)}
# Paths are virtual — placement rules match on suffix.
# ---------------------------------------------------------------------------

_P = "src/repro_torch/somepkg/snippet.py"
_P_FT = "src/repro_torch/ft/snippet.py"
#: rules of the port's own, with no counterpart in the reference's table
PORT_ONLY = {"one-tracer"}

FIXTURES: dict[str, dict[str, tuple[str, str]]] = {
    "device-cache": {
        "flag": ("""\
import functools
import torch


@functools.lru_cache(maxsize=8)
def tables(n):
    return torch.arange(n).to("cuda")
""", _P),
        # numpy cached; the device copy keyed by its device; a dtype
        # conversion; a structure on the meta device — the port's shapes
        "ok": ("""\
import functools
import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def host_table(n):
    return np.arange(n)


@functools.lru_cache(maxsize=8)
def device_table(n, device):
    return torch.from_numpy(host_table(n)).to(device).to(torch.float32)


@functools.lru_cache(maxsize=8)
def shapes(cfg):
    return build(cfg, device="meta")
""", _P),
    },
    "fp32-phase": {
        "flag": ("""\
import math
import torch


def twiddles(n):
    return torch.exp(-2j * math.pi * torch.arange(n, dtype=torch.float32) / n)
""", _P),
        # f64 host trig, rounded ONCE after, then copied — the PR-5 fix
        # shape the port's four-step twiddles keep
        "ok": ("""\
import numpy as np
import torch


def twiddles(n, device):
    w = np.exp(-2j * np.pi * np.arange(n) / n).astype(np.complex64)
    return torch.from_numpy(w).to(device)
""", _P),
    },
    "mutable-default": {
        "flag": ("""\
def make_watchdog(cfg=WatchdogConfig()):
    return StepWatchdog(cfg)
""", _P),
        "ok": ("""\
def make_watchdog(cfg=None):
    return StepWatchdog(WatchdogConfig() if cfg is None else cfg)


def bind(n, ctx=OpContext()):
    return ctx
""", _P),
    },
    "raw-collective": {
        "flag": ("""\
import torch.distributed as dist


def reduce_grads(x):
    dist.all_reduce(x)
    return x
""", _P),
        # the ledgered wrapper; barrier moves no payload
        "ok": ("""\
import torch.distributed as dist
from repro_torch.dist import collectives


def reduce_grads(xs):
    dist.barrier()
    return collectives.psum(xs)
""", _P),
    },
    "dispatch-ladder": {
        "flag": ("""\
def dispatch(o, x):
    if o == "fft":
        return run_fft(x)
    elif o == "polymul-real":
        return run_polymul_real(x)
    raise ValueError(o)
""", _P),
        "ok": ("""\
def dispatch(o, x):
    if o == "fft":
        return run_fft(x)
    return registry.bind(o).fn(x)
""", _P),
    },
    "signal-lock": {
        "flag": ("""\
import signal


def install(engine):
    def _on_term(signum, frame):
        engine.request_stop()
    signal.signal(signal.SIGTERM, _on_term)
""", _P),
        # the port's serve.py hand-off: a thread takes the locky call
        "ok": ("""\
import signal
import threading


def install(holder):
    def on_term(signum, frame):
        threading.Thread(target=holder["engine"].request_stop,
                         daemon=True).start()
    signal.signal(signal.SIGTERM, on_term)
""", _P),
    },
    "durable-write": {
        "flag": ("""\
import torch


def write_state(path, state):
    torch.save(state, path)
""", _P_FT),
        "ok": ("""\
import torch


def read_state(path):
    with open(path, "rb") as f:
        return torch.load(f)
""", _P_FT),
    },
    "bare-plan-literal": {
        "flag": ("""\
def forced_plan():
    return FFTPlan(tier="distributed", radix=2, block_b=1)
""", _P),
        "ok": ("""\
from repro_torch.core.fft.planner import plan


def forced_plan(n):
    return plan(n, 8, force_distributed=True)
""", _P),
    },
    "one-tracer": {
        "flag": ("""\
import torch


def run(fn):
    with torch.profiler.record_function("repro_torch.op/x"):
        return fn()
""", _P),
        "ok": ("""\
from repro_torch import spans


def run(fn):
    with spans.span("repro_torch.op/x"):
        return fn()
""", _P),
    },
    "noqa-reason": {
        "flag": ("""\
import torch.distributed as dist


def reduce_grads(x):
    dist.all_reduce(x)  # repro_torch: noqa[raw-collective]
""", _P),
        "ok": ("""\
import torch.distributed as dist


def reduce_grads(x):
    dist.all_reduce(x)  # repro_torch: noqa[raw-collective]: fixture exercising the raw call
""", _P),
    },
    "unused-noqa": {
        "flag": ("""\
def clean():
    return 1  # repro_torch: noqa[raw-collective]: nothing here needs excusing
""", _P),
        "ok": ("""\
import torch.distributed as dist


def reduce_grads(x):
    dist.all_reduce(x)  # repro_torch: noqa[raw-collective]: fixture exercising the raw call
""", _P),
    },
}


def _rules_hit(src: str, path: str = _P) -> list[str]:
    return sorted(f.rule for f in analysis.analyze_source(src, path).findings)


@pytest.mark.parametrize("rule_id", analysis.RULE_IDS)
def test_rule_fixture_pair(rule_id):
    """Each rule flags its must-flag snippet (message naming the
    historical PR) and stays silent on its near-miss."""
    flag_src, flag_path = FIXTURES[rule_id]["flag"]
    res = analysis.analyze_source(flag_src, flag_path)
    hits = [f for f in res.findings if f.rule == rule_id]
    assert hits, (f"rule {rule_id} missed its must-flag fixture; got "
                  f"{[f.format() for f in res.findings]}")
    if rule_id in PORT_ONLY:
        assert "repro_torch/spans.py" in hits[0].message, \
            f"finding message must name the one allowed place: " \
            f"{hits[0].message}"
    else:
        assert re.search(r"PR \d|noqa", hits[0].message), \
            f"finding message must name the historical bug: " \
            f"{hits[0].message}"
    ok_src, ok_path = FIXTURES[rule_id]["ok"]
    res_ok = analysis.analyze_source(ok_src, ok_path)
    assert res_ok.findings == [], \
        (f"rule {rule_id}'s near-miss fixture must pass every rule; got "
         f"{[f.format() for f in res_ok.findings]}")


def test_meta_every_rule_has_fixtures_and_docstring():
    """>= 10 rules, unique ids, every registered rule carries BOTH
    fixtures and a docstring naming the PR it encodes (the port's own
    rules, which encode no PR of the reference, say so); no orphan
    fixtures."""
    ids = list(analysis.RULE_IDS)
    assert len(ids) == len(set(ids)), "duplicate rule ids"
    assert len(ids) >= 10, f"need >= 10 rules, have {len(ids)}"
    for rule in analysis.RULES:
        assert rule.id in FIXTURES, f"rule {rule.id} has no fixture pair"
        assert {"flag", "ok"} <= set(FIXTURES[rule.id]), \
            f"rule {rule.id} needs both a must-flag and a must-pass fixture"
        doc = type(rule).__doc__ or ""
        if rule.id in PORT_ONLY:
            assert "no counterpart in the reference" in " ".join(
                doc.split()), \
                f"rule {rule.id} docstring must say it is the port's own"
        else:
            assert re.search(r"PR \d", doc), \
                f"rule {rule.id} docstring must name the PR/bug it encodes"
        assert rule.summary, f"rule {rule.id} has no summary line"
    assert set(FIXTURES) == set(ids), \
        f"orphan fixtures: {set(FIXTURES) - set(ids)}"


def test_one_rule_for_each_of_the_reference():
    """The port keeps the reference's rule table: the same count and kinds,
    the same ids except tracer-leak, whose port form is device-cache, in
    the same order, with the port's own rules (``PORT_ONLY``) beside
    them."""
    kept = [r for r in analysis.RULES if r.id not in PORT_ONLY]
    assert len(kept) == len(ref_analysis.RULES)
    renamed = {"tracer-leak": "device-cache"}
    assert [renamed.get(i, i) for i in ref_analysis.RULE_IDS] == \
        [r.id for r in kept]
    assert [r.kind for r in ref_analysis.RULES] == [r.kind for r in kept]
    assert PORT_ONLY <= set(analysis.RULE_IDS)
    assert not PORT_ONLY & set(ref_analysis.RULE_IDS)


def test_op_name_set_matches_registry():
    """The ladder rule's literal op-name set cannot drift from the port's
    launch/ops.py registry."""
    from repro_torch.launch import ops as op_registry
    assert set(analysis.OP_NAMES) == set(op_registry.op_names())


# ---------------------------------------------------------------------------
# More shapes of the port's own rules
# ---------------------------------------------------------------------------

_CACHED = "import functools\nimport torch\n\n\n@functools.lru_cache\n"

DEVICE_CACHE_FLAG = {
    "cuda-call": "def t(n):\n    return torch.ones(n).cuda()\n",
    "cuda-index": "def t(n):\n    return torch.ones(n).cuda(0)\n",
    "device-kw": "def t(n):\n    return torch.ones(n, device='cuda')\n",
    "torch-device": ("def t(n):\n"
                     "    return torch.ones(n).to(torch.device('cuda', 1))\n"),
    "global-device": "def t(n):\n    return torch.ones(n).to(DEVICE)\n",
    "other-tensor": "def t(n):\n    return torch.ones(n).to(REF.device)\n",
    "device-to-kw": "def t(n):\n    return torch.ones(n).to(device=DEV)\n",
}

DEVICE_CACHE_OK = {
    "device-param": ("def t(n, device):\n"
                     "    return torch.ones(n, device=device)\n"),
    "index-param": ("def t(n, idx):\n"
                    "    return torch.ones(n).to(torch.device('cuda', idx))\n"),
    "tensor-param": "def t(n, ref):\n    return torch.ones(n).to(ref.device)\n",
    "cuda-param": "def t(n, i):\n    return torch.ones(n).cuda(i)\n",
    "dtype": "def t(n):\n    return torch.ones(n).to(torch.int64)\n",
    "meta": ("def t(n):\n"
             "    return torch.empty(n, device=torch.device('meta'))\n"),
    "default-device": "def t(n):\n    return torch.ones(n, device=None)\n",
}


@pytest.mark.parametrize("case", sorted(DEVICE_CACHE_FLAG))
def test_device_cache_flags_unkeyed_placements(case):
    assert _rules_hit(_CACHED + DEVICE_CACHE_FLAG[case]) == ["device-cache"]
    # the same body without the cache is no finding
    assert _rules_hit(DEVICE_CACHE_FLAG[case]) == []


@pytest.mark.parametrize("case", sorted(DEVICE_CACHE_OK))
def test_device_cache_passes_keyed_placements(case):
    assert _rules_hit(_CACHED + DEVICE_CACHE_OK[case]) == []


COLLECTIVE_FLAG = {
    "torch-dotted": ("import torch\n\n\ndef f(x):\n"
                     "    torch.distributed.all_gather_into_tensor(x, x)\n"),
    "alias": ("import torch.distributed as tdist\n\n\ndef f(x):\n"
              "    tdist.reduce_scatter_tensor(x, x)\n"),
    "from-torch": ("from torch import distributed as d\n\n\ndef f(x):\n"
                   "    d.broadcast(x, 0)\n"),
    "functional": ("import torch.distributed._functional_collectives as fc\n"
                   "\n\ndef f(x):\n    return fc.all_reduce(x, 'sum', [0, 1])\n"),
    "imported-name": ("from torch.distributed import all_to_all_single as a2a"
                      "\n\n\ndef f(out, x):\n    a2a(out, x)\n"),
    "p2p": ("import torch.distributed as dist\n\n\ndef f(x):\n"
            "    return [dist.isend(x, 1), dist.irecv(x, 0)]\n"),
}


@pytest.mark.parametrize("case", sorted(COLLECTIVE_FLAG))
def test_raw_collective_sees_every_spelling(case):
    res = analysis.analyze_source(COLLECTIVE_FLAG[case], _P)
    assert {f.rule for f in res.findings} == {"raw-collective"}
    # the ledger module itself may call them
    allowed = analysis.analyze_source(COLLECTIVE_FLAG[case],
                                      "src/repro_torch/dist/collectives.py")
    assert allowed.findings == []


def test_raw_collective_leaves_the_ledger_wrappers_alone():
    src = ("from repro_torch.dist import collectives as dist\n\n\n"
           "def f(xs):\n    return dist.all_gather(xs, axis=0)\n")
    assert _rules_hit(src) == []


TRACER_FLAG = {
    "import": "import torch.profiler\n",
    "from-import": "from torch.profiler import record_function\n",
    "from-torch": "from torch import profiler\n",
    "autograd": "from torch.autograd import profiler as p\n",
    "dotted": ("import torch\n\n\ndef f():\n"
               "    with torch.autograd.profiler.record_function('x'):\n"
               "        pass\n"),
    "fast": ("import torch\n\n\ndef f():\n"
             "    return torch._C._profiler._RecordFunctionFast('x')\n"),
    "gc-hook": "import gc\n\ngc.callbacks.append(print)\n",
    "gc-name": "from gc import callbacks\n",
}


@pytest.mark.parametrize("case", sorted(TRACER_FLAG))
def test_one_tracer_sees_every_spelling(case):
    """Each path into the profiler or the collector's hooks is one finding
    anywhere in the port, none in the span helper, and none outside the
    port (its tests and ``chip_smoke.py`` time with the profiler)."""
    res = analysis.analyze_source(TRACER_FLAG[case], _P)
    assert [f.rule for f in res.findings] == ["one-tracer"]
    for path in ("src/repro_torch/spans.py", "chip_smoke.py",
                 "tests/test_torch_spans.py"):
        assert analysis.analyze_source(TRACER_FLAG[case], path).findings \
            == []


def test_one_tracer_would_flag_the_helper_itself():
    """The helper holds what the rule forbids elsewhere: moved anywhere
    else in the port, it is flagged."""
    src = (ROOT / "src" / "repro_torch" / "spans.py").read_text()
    hits = analysis.analyze_source(src, _P).findings
    assert {f.rule for f in hits} == {"one-tracer"} and len(hits) >= 2


FP32_FLAG = {
    "host-f32": ("import numpy as np\n\n\ndef w(k, n):\n"
                 "    return np.cos(2 * np.pi * k.astype(np.float32) / n)\n"),
    "host-torch": ("import math\nimport torch\n\n\ndef w(k, n):\n"
                   "    return math.sin(float(torch.tensor(k)) / n)\n"),
    "polar": ("import torch\n\n\ndef w(ang):\n"
              "    return torch.polar(torch.ones_like(ang), "
              "ang.to(torch.float32))\n"),
    "device-cos": ("import torch\n\n\ndef w(k, n):\n"
                   "    return torch.cos(k.to(dtype=torch.float32) / n)\n"),
}


@pytest.mark.parametrize("case", sorted(FP32_FLAG))
def test_fp32_phase_flags_host_and_device_forms(case):
    assert _rules_hit(FP32_FLAG[case]) == ["fp32-phase"]


def test_fp32_phase_passes_f64_phases_rounded_once():
    src = ("import math\nimport numpy as np\nimport torch\n\n\n"
           "def w(k, n, device):\n"
           "    ang = np.cos(2 * np.pi * k / n).astype(np.float32)\n"
           "    rope = torch.cos(torch.arange(n, dtype=torch.float64))\n"
           "    return torch.from_numpy(ang).to(device), rope, "
           "torch.exp(-2j * math.pi * k / n)\n")
    assert _rules_hit(src) == []


# ---------------------------------------------------------------------------
# The copy pinned to the original
# ---------------------------------------------------------------------------

def _pinned_sources() -> list[tuple[str, str]]:
    """Every source file of both packages and every fixture of both test
    files, as (path, source)."""
    out = []
    for base in ("src/repro", "src/repro_torch"):
        for p in sorted((ROOT / base).rglob("*.py")):
            out.append((str(p.relative_to(ROOT)), p.read_text()))
    ref_tests = (ROOT / "tests" / "test_analysis.py").read_text()
    ref_fixtures = re.findall(r'\("""\\\n(.*?)""", _P', ref_tests, re.S)
    assert len(ref_fixtures) >= 16
    out += [(f"ref-fixture-{i}", s) for i, s in enumerate(ref_fixtures)]
    out += [(f"{rid}-{kind}", src) for rid, pair in FIXTURES.items()
            for kind, (src, _) in pair.items()]
    return out


@pytest.mark.parametrize("rule_id", ["mutable-default", "signal-lock"])
def test_kept_rules_find_what_the_reference_finds(rule_id):
    """The port's copy of a rule the reference's logic carries over gives
    the reference's (line, col) list on every source of both packages and
    every fixture of both test files."""
    mine = next(r for r in rules.RULES if r.id == rule_id)
    ref = next(r for r in ref_rules.RULES if r.id == rule_id)
    n_hits = 0
    for path, src in _pinned_sources():
        ctx = engine.FileContext(path, ast.parse(src), src)
        got = [(line, col) for line, col, _ in mine.check(ctx)]
        want = [(line, col) for line, col, _ in ref.check(ctx)]
        assert got == want, path
        n_hits += len(got)
    assert n_hits >= 2      # both fixture sets flag the rule


def _to_port_marker(src: str) -> str:
    return re.sub(r"#(\s*)repro:(\s*)noqa\[", r"#\1repro_torch:\2noqa[", src)


NOQA_CASES = [
    "x = 1  # repro: noqa[raw-collective]: why\n",
    "x = 1  #repro:noqa[raw-collective]:why\n",
    "    # repro: noqa[dispatch-ladder, durable-write]: two ids\nx = 1\n",
    "x = 1  # repro: noqa[raw-collective]\n",
    "x = 1  # repro: noqa[raw-collective]:   \n",
    "x = 1  # repro: noqa[]: no id\n",
    "x = 1  # repro: noqa[not-a-rule]: unknown\n",
    "x = 1  # repro: noqa[unused-noqa]: meta\n",
    "s = '# repro: noqa[raw-collective]: in a string'\n",
    "x = 1  # a comment, then # repro: noqa[raw-collective]: late\n",
]


def test_suppression_parser_matches_the_reference():
    """On the reference's marker syntax (rewritten to the port's marker),
    the port's parser gives the reference's (line, col), ids, reason and
    placement on the cases above, on every file of the reference package
    and on the reference's fixtures; and the same verdict wherever the ids
    name rules the two tables share."""
    shared = set(ref_analysis.RULE_IDS) & set(analysis.RULE_IDS)
    sources = NOQA_CASES + [s for p, s in _pinned_sources()
                            if not p.startswith("src/repro_torch")
                            and "repro_torch:" not in s]
    n = 0
    for src in sources:
        want = ref_engine._parse_noqas(src)
        got = engine._parse_noqas(_to_port_marker(src))
        assert [(q.line, q.col, q.ids, q.reason, q.standalone)
                for q in got] == \
            [(q.line, q.col, q.ids, q.reason, q.standalone) for q in want]
        for g, w in zip(got, want):
            if set(w.ids) <= shared:
                assert (g.problem is None) == (w.problem is None), src
        n += len(got)
    assert n >= 20


# ---------------------------------------------------------------------------
# Suppression mechanics
# ---------------------------------------------------------------------------

_RAW = ("import torch.distributed as dist\n\n\ndef f(x):\n"
        "    dist.all_reduce(x)")


def test_noqa_same_line_suppresses_and_keeps_reason():
    src = _RAW + "  # repro_torch: noqa[raw-collective]: ledgered by hand\n"
    res = analysis.analyze_source(src, _P)
    assert res.findings == []
    assert len(res.suppressed) == 1
    assert res.suppressed[0]["reason"] == "ledgered by hand"
    assert res.suppressed[0]["rule"] == "raw-collective"


def test_noqa_standalone_line_above_suppresses():
    src = ("import torch.distributed as dist\n\n\ndef f(x):\n"
           "    # repro_torch: noqa[raw-collective]: ledgered by hand\n"
           "    dist.all_reduce(x)\n")
    assert _rules_hit(src) == []


def test_noqa_two_lines_above_does_not_reach():
    src = ("import torch.distributed as dist\n\n\ndef f(x):\n"
           "    # repro_torch: noqa[raw-collective]: too far away\n"
           "    y = x\n"
           "    dist.all_reduce(y)\n")
    assert _rules_hit(src) == ["raw-collective", "unused-noqa"]


def test_noqa_wrong_rule_id_does_not_suppress():
    src = _RAW + "  # repro_torch: noqa[device-cache]: mismatched excuse\n"
    assert _rules_hit(src) == ["raw-collective", "unused-noqa"]


def test_noqa_unknown_rule_id_reported():
    # tracer-leak is the reference's id; the port's table has no such rule
    res = analysis.analyze_source(
        "x = 1  # repro_torch: noqa[tracer-leak]: whatever\n", _P)
    assert [f.rule for f in res.findings] == ["noqa-reason"]
    assert "unknown rule id" in res.findings[0].message


def test_meta_rules_cannot_be_suppressed():
    res = analysis.analyze_source(
        "x = 1  # repro_torch: noqa[unused-noqa]: silencing the police\n", _P)
    assert [f.rule for f in res.findings] == ["noqa-reason"]
    assert "cannot itself be suppressed" in res.findings[0].message


def test_noqa_without_reason_does_not_suppress():
    res = analysis.analyze_source(
        _RAW + "  # repro_torch: noqa[raw-collective]\n", _P)
    assert sorted(f.rule for f in res.findings) == ["noqa-reason",
                                                    "raw-collective"]
    assert "repro_torch: noqa[rule-id]" in next(
        f.message for f in res.findings if f.rule == "noqa-reason")


def test_markers_do_not_cross():
    """A reference suppression excuses nothing in the port's engine (and
    is neither malformed nor unused there); a port suppression is not read
    by the reference's engine."""
    port_src = _RAW + "  # repro: noqa[raw-collective]: the reference's marker\n"
    assert _rules_hit(port_src) == ["raw-collective"]
    assert analysis.analyze_source(port_src, _P).suppressed == []

    ref_src = ('import jax\n\n\ndef f(x):\n    return jax.lax.psum(x, "d")'
               "  # repro_torch: noqa[raw-collective]: the port's marker\n")
    res = ref_analysis.analyze_source(ref_src, "src/repro/somepkg/s.py")
    assert [f.rule for f in res.findings] == ["raw-collective"]
    assert res.suppressed == []


def test_both_markers_on_one_ladder():
    """The layout of the port's two per-workload ladders: the reference's
    comment-only noqa above the flagged line, the port's at its end. Each
    engine absorbs the finding with its own marker and reports nothing."""
    src = ('def cost(workload):\n'
           '    # repro: noqa[dispatch-ladder]: formulas, not dispatch\n'
           '    if workload == "fft":  # repro_torch: noqa[dispatch-ladder]: '
           'formulas, not dispatch\n'
           '        return 1\n'
           '    elif workload == "rfft":\n'
           '        return 2\n'
           '    return 3\n')
    port = analysis.analyze_source(src, "src/repro_torch/core/x.py")
    ref = ref_analysis.analyze_source(src, "src/repro_torch/core/x.py")
    for res in (port, ref):
        assert res.findings == []
        assert [s["rule"] for s in res.suppressed] == ["dispatch-ladder"]
    assert port.suppressed[0]["noqa_line"] == 3
    assert ref.suppressed[0]["noqa_line"] == 2


def test_parse_error_is_a_finding():
    res = analysis.analyze_source("def broken(:\n", _P)
    assert [f.rule for f in res.findings] == ["parse-error"]


def test_json_report_shape():
    res = analysis.analyze_source(_RAW + "\n", _P)
    rep = analysis.to_json(res)
    assert rep["schema"] == "repro_torch.analysis/v1"
    assert rep["rule_count"] == len(analysis.RULES)
    assert rep["ok"] is False
    assert {r["id"] for r in rep["rules"]} == set(analysis.RULE_IDS)
    f = rep["findings"][0]
    assert {"path", "line", "col", "rule", "message"} <= set(f)
    json.dumps(rep)
    assert analysis.to_text(res).splitlines()[-1].startswith(
        "[repro_torch.analysis] 1 finding(s), 0 suppressed")


# ---------------------------------------------------------------------------
# CLI exit codes and the gate
# ---------------------------------------------------------------------------

def _run_cli(*argv, module="repro_torch.analysis"):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", module, *argv],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=120)


def test_cli_exit_codes_and_json(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(FIXTURES["raw-collective"]["flag"][0])
    good = tmp_path / "good.py"
    good.write_text(FIXTURES["raw-collective"]["ok"][0])

    res = _run_cli(str(good))
    assert res.returncode == 0, res.stdout + res.stderr
    res = _run_cli(str(bad))
    assert res.returncode == 1
    assert "[raw-collective]" in res.stdout

    res = _run_cli(str(bad), "--format", "json")
    assert res.returncode == 1
    rep = json.loads(res.stdout)
    assert rep["ok"] is False and len(rep["findings"]) == 1

    assert _run_cli().returncode == 2                        # no paths
    assert _run_cli(str(tmp_path / "nope")).returncode == 2  # missing path
    res = _run_cli("--list-rules")
    assert res.returncode == 0
    assert res.stdout.splitlines()[-1] == "11 rules"


def test_port_tree_is_clean_and_suppressions_carry_reasons():
    """The port's gate, as a test: zero findings over src/repro_torch,
    chip_smoke.py and the port's tests, and every suppression states why
    the historical bug does not apply at its site."""
    res = analysis.analyze_paths([str(ROOT / p) for p in GATE])
    assert res.ok, "invariant linter findings:\n" + \
        "\n".join(f.format() for f in res.findings)
    assert res.n_files > 90
    assert res.suppressed
    for s in res.suppressed:
        assert s["reason"].strip(), f"reasonless suppression at {s}"


def test_cli_gate_exits_zero():
    res = _run_cli(*GATE)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.splitlines()[-1].startswith(
        "[repro_torch.analysis] 0 finding(s)")


def test_seeded_bug_fails_gate_naming_rule_and_origin(tmp_path):
    """Re-shipping PR 9's bug — a raw torch.save in a file laid out like
    the port's ft/ — turns the gate red, naming the rule and the PR."""
    pkg = tmp_path / "src" / "repro_torch" / "ft"
    pkg.mkdir(parents=True)
    (pkg / "seeded.py").write_text(FIXTURES["durable-write"]["flag"][0])
    res = _run_cli(str(tmp_path / "src"))
    assert res.returncode == 1
    assert "[durable-write]" in res.stdout and "PR 9" in res.stdout


RAW_WRITES = {
    "torch-save": "import torch\n\n\ndef w(p, s):\n    torch.save(s, p)\n",
    "open-w": ("def w(p, s):\n    with open(p, 'w') as f:\n"
               "        f.write(s)\n"),
    "json-dump": ("import json\n\n\ndef w(f, s):\n"
                  "    json.dump(s, f)\n"),
}


@pytest.mark.parametrize("case", sorted(RAW_WRITES))
def test_raw_write_under_port_ft_only_the_port_sees(case):
    """A raw write added under src/repro_torch/ft/ is the port's finding;
    the reference's rule is scoped to repro/ft/ and stays silent on it."""
    path = "src/repro_torch/ft/seeded.py"
    assert _rules_hit(RAW_WRITES[case], path) == ["durable-write"]
    assert ref_analysis.analyze_source(RAW_WRITES[case], path).findings == []


def test_import_pulls_in_neither_torch_nor_jax():
    code = ("import sys, repro_torch.analysis\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'numpy', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=60)
    assert res.returncode == 0, res.stderr
