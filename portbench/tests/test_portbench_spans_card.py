"""The program's spans in short traced runs of each cell on the card
(skipped without one), read by ``tools/spans.py``: one route span and one
glue span a request, a launch span for every launch ``_build.LAUNCHES``
counted, no program span on the device's timeline, and the accepted
per-layer metrics as they were."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.lib.spec import ROOT

pytestmark = pytest.mark.cuda

#: kernels a request launches on the card
LAUNCHES = {"rlwe4096.sat": 1.0, "polyreal16384.sat": 3.0}


@pytest.mark.parametrize("name", ["rlwe4096.sat", "polyreal16384.sat",
                                  "rlwe4096.load80"])
def test_spans_of_a_traced_run_on_the_card(cuda, name):
    proc = subprocess.run(
        [sys.executable, "portbench/tools/spans.py", "--workload", name,
         "--seeds", str(2**31 + 21), "--seconds", "3"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    calls, n = r["span_calls"], r["requests"]
    assert calls["op"] == n and calls["glue"] == n
    assert calls["launch"] == r["launches_in_window"] >= n
    dev = r["device_events"]
    assert dev["program_named_by_name"] == 0
    assert dev["by_kind"] == dev["by_name"]
    s = r["spans"]
    assert None not in (s["route_us"], s["glue_us"], s["launch_us"],
                        s["gc_idle_share"])
    if name in LAUNCHES:
        assert r["metrics"]["launches_per_request.sat"] == LAUNCHES[name]
    else:
        share = (s["route_us"] + s["glue_us"] + s["launch_us"]) \
            / r["metrics"]["dispatch_us.load"]
        assert 0.85 <= share <= 1.0, share
