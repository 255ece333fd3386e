"""repro_torch.analysis — AST-based invariant linter for the port's contracts.

The port's counterpart of ``repro.analysis``: the same engine and CLI,
with each of the reference's rules rewritten for the port's own modules
and idioms (``rules.py``). Each rule encodes a bug class this repository
actually shipped and fixed; ``python -m repro_torch.analysis src/repro_torch
chip_smoke.py tests/test_torch_*.py`` gates at zero findings, so
reintroducing one of those bugs fails with a message naming the rule and
the original PR.

Its suppression marker is ``# repro_torch: noqa[rule-id]: reason``. The
reference's linter sweeps the port's files as well, with its own marker
and rules; neither engine reads the other's marker.

Stdlib-only by design: importing this package pulls in neither torch nor
jax, nor anything of ``repro``, so the linter runs in a bare environment
and linting cannot be broken by the code it lints.
"""
from repro_torch.analysis.engine import (AnalysisResult, Finding,
                                         analyze_files, analyze_paths,
                                         analyze_source, iter_python_files,
                                         render, to_json, to_text)
from repro_torch.analysis.rules import (OP_NAMES, RULE_IDS, RULES,
                                        TORCH_COLLECTIVES)

__all__ = [
    "AnalysisResult", "Finding", "analyze_files", "analyze_paths",
    "analyze_source", "iter_python_files", "render", "to_json", "to_text",
    "TORCH_COLLECTIVES", "OP_NAMES", "RULE_IDS", "RULES",
]
