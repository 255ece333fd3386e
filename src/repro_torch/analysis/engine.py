"""Analysis engine of the port's linter: file walking, suppression
handling, reporters. A copy of ``repro.analysis.engine`` with the port's
own suppression marker.

Pipeline per file (``analyze_source``):

1. ``ast.parse`` — a file that does not parse yields a single
   ``parse-error`` finding (engine-level, not a registered rule).
2. Every ``kind == 'ast'`` rule in ``rules.RULES`` runs over the tree.
3. ``# repro_torch: noqa[rule-id]: reason`` comments are tokenized out.
   The reference's ``# repro: noqa[...]`` comments are not read: the
   reference's linter sweeps the port's files too, and each linter's
   suppressions answer only to its own rules.  A
   malformed suppression (missing reason, unknown rule id, or naming one
   of the engine-hosted meta rules) becomes a ``noqa-reason`` finding and
   suppresses nothing.
4. Valid suppressions absorb matching findings — same line, or a
   comment-only noqa line directly above — and the absorbed finding is
   kept in ``AnalysisResult.suppressed`` with its reason so the JSON
   report shows every excused site.
5. A valid suppression that absorbed nothing becomes ``unused-noqa``.

Exit-code contract of the CLI (``repro_torch.analysis.__main__``): 0
clean, 1 findings, 2 usage error.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize
from typing import Iterable, Sequence

from repro_torch.analysis import rules as rules_mod

SCHEMA = "repro_torch.analysis/v1"

_NOQA_RE = re.compile(
    r"#\s*repro_torch:\s*noqa\[(?P<ids>[^\]]*)\]"
    r"(?P<sep>\s*:\s*)?(?P<reason>.*)$")

#: ids a noqa may name: the AST rules only — the meta rules keep the
#: suppression machinery itself honest and cannot be suppressed.
_SUPPRESSIBLE = frozenset(
    r.id for r in rules_mod.RULES if r.kind == "ast")
_KNOWN_IDS = frozenset(r.id for r in rules_mod.RULES)


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] " \
               f"{self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Noqa:
    line: int
    col: int
    ids: tuple[str, ...]
    reason: str
    standalone: bool        # comment-only line: also covers the line below
    problem: str | None     # set when malformed (reported as noqa-reason)


@dataclasses.dataclass
class AnalysisResult:
    findings: list[Finding]
    suppressed: list[dict]      # finding dict + reason + noqa_line
    n_files: int

    @property
    def ok(self) -> bool:
        return not self.findings


@dataclasses.dataclass(frozen=True)
class FileContext:
    path: str
    tree: ast.AST
    source: str


def _parse_noqas(source: str) -> list[Noqa]:
    out: list[Noqa] = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [t for t in tokens if t.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError):    # pragma: no cover
        return out
    for tok in comments:
        m = _NOQA_RE.search(tok.string)
        if not m:
            continue
        ids = tuple(s.strip() for s in m.group("ids").split(",") if s.strip())
        reason = (m.group("reason") or "").strip()
        problem = None
        if not ids:
            problem = "suppression names no rule id"
        elif not m.group("sep") or not reason:
            problem = (f"suppression of [{', '.join(ids)}] carries no "
                       "reason — write '# repro_torch: noqa[rule-id]: why "
                       "the historical bug does not apply here'")
        else:
            unknown = [i for i in ids if i not in _KNOWN_IDS]
            meta = [i for i in ids if i in _KNOWN_IDS
                    and i not in _SUPPRESSIBLE]
            if unknown:
                problem = (f"suppression names unknown rule id "
                           f"{', '.join(unknown)} (known: "
                           f"{', '.join(sorted(_SUPPRESSIBLE))})")
            elif meta:
                problem = (f"rule {', '.join(meta)} keeps suppressions "
                           "honest and cannot itself be suppressed")
        line, col = tok.start
        standalone = tok.line[:col].strip() == ""
        out.append(Noqa(line=line, col=col, ids=ids, reason=reason,
                        standalone=standalone, problem=problem))
    return out


def _covers(nq: Noqa, finding: Finding) -> bool:
    if finding.rule not in nq.ids:
        return False
    return nq.line == finding.line or \
        (nq.standalone and nq.line == finding.line - 1)


def analyze_source(source: str, path: str) -> AnalysisResult:
    """Run every rule plus the suppression machinery over one file.
    ``path`` may be virtual (fixtures) — placement rules match suffixes."""
    path = path.replace(os.sep, "/")
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        f = Finding(path, e.lineno or 0, (e.offset or 1) - 1, "parse-error",
                    f"file does not parse: {e.msg}")
        return AnalysisResult(findings=[f], suppressed=[], n_files=1)
    ctx = FileContext(path=path, tree=tree, source=source)

    raw: list[Finding] = []
    for rule in rules_mod.RULES:
        if rule.kind != "ast":
            continue
        for line, col, msg in rule.check(ctx):
            raw.append(Finding(path, line, col, rule.id, msg))

    noqas = _parse_noqas(source)
    findings: list[Finding] = []
    for nq in noqas:
        if nq.problem:
            findings.append(Finding(path, nq.line, nq.col, "noqa-reason",
                                    nq.problem))
    valid = [nq for nq in noqas if nq.problem is None]

    suppressed: list[dict] = []
    used: set[int] = set()
    for f in raw:
        hit = next((nq for nq in valid if _covers(nq, f)), None)
        if hit is None:
            findings.append(f)
        else:
            used.add(id(hit))
            suppressed.append({**f.to_dict(), "reason": hit.reason,
                               "noqa_line": hit.line})
    for nq in valid:
        if id(nq) not in used:
            findings.append(Finding(
                path, nq.line, nq.col, "unused-noqa",
                f"suppression of [{', '.join(nq.ids)}] matches no finding "
                "on its line (or the line below, for a comment-only line) "
                "— stale noqas are latent holes; delete it"))

    findings.sort()
    return AnalysisResult(findings=findings, suppressed=suppressed,
                          n_files=1)


def iter_python_files(paths: Sequence[str]) -> list[str]:
    """Every .py under the given files/dirs, sorted, __pycache__ and
    dot-dirs skipped. Raises FileNotFoundError for a missing path."""
    out: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d != "__pycache__"
                                 and not d.startswith("."))
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
        else:
            raise FileNotFoundError(p)
    return sorted(dict.fromkeys(out))


def analyze_files(files: Iterable[str]) -> AnalysisResult:
    findings: list[Finding] = []
    suppressed: list[dict] = []
    n = 0
    for fp in files:
        with open(fp, encoding="utf-8") as f:
            source = f.read()
        res = analyze_source(source, fp)
        findings.extend(res.findings)
        suppressed.extend(res.suppressed)
        n += 1
    findings.sort()
    return AnalysisResult(findings=findings, suppressed=suppressed,
                          n_files=n)


def analyze_paths(paths: Sequence[str]) -> AnalysisResult:
    return analyze_files(iter_python_files(paths))


# ---------------------------------------------------------------------------
# Reporters
# ---------------------------------------------------------------------------

def to_text(result: AnalysisResult) -> str:
    lines = [f.format() for f in result.findings]
    lines.append(
        f"[repro_torch.analysis] {len(result.findings)} finding(s), "
        f"{len(result.suppressed)} suppressed (with reasons), "
        f"{result.n_files} file(s), {len(rules_mod.RULES)} rules")
    return "\n".join(lines)


def to_json(result: AnalysisResult) -> dict:
    return {
        "schema": SCHEMA,
        "rule_count": len(rules_mod.RULES),
        "rules": [{"id": r.id, "kind": r.kind, "summary": r.summary}
                  for r in rules_mod.RULES],
        "n_files": result.n_files,
        "findings": [f.to_dict() for f in result.findings],
        "suppressed": result.suppressed,
        "ok": result.ok,
    }


def render(result: AnalysisResult, fmt: str) -> str:
    if fmt == "json":
        return json.dumps(to_json(result), indent=2)
    return to_text(result)
