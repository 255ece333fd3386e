"""The port's rule set: one class for each rule of ``repro.analysis``.

Each rule is an executable postmortem of a bug the reference shipped and
fixed, keyed to the port's own modules and idioms: its paths
(``repro_torch/...``), its collectives (``torch.distributed`` beside the
byte ledger of ``repro_torch/dist/collectives.py``), its in-graph namespace
(``torch``) and its caches (numpy tables, device copies keyed by device).
Each rule's docstring names the reference's PR, and the port's PR where
the port has a history of its own, so a finding reads as "you are about
to reship this", not as style nagging.

Rules are pure: ``check(ctx)`` yields ``(line, col, message)`` tuples from
the stdlib ``ast`` tree in ``ctx.tree`` (no third-party deps, no imports of
the code under analysis).  ``ctx.path`` is the forward-slash-normalized
file path; rules that encode *placement* contracts (the one module allowed
to do X) match on path suffixes.

Suppression: ``# repro_torch: noqa[rule-id]: reason`` on the finding line,
or on a comment-only line directly above it.  The reason is mandatory
(``noqa-reason``) and the suppression must actually hit (``unused-noqa``)
— see ``repro_torch.analysis.engine``.
"""
from __future__ import annotations

import ast
from typing import Iterable, Iterator, Tuple

RawFinding = Tuple[int, int, str]

#: The served op names of the launch/ops.py registry. Kept literal so the
#: analyzer stays importable without torch; tests/test_torch_analysis.py
#: asserts this set == repro_torch.launch.ops.op_names() so the two cannot
#: drift.
OP_NAMES = frozenset({"fft", "rfft", "polymul", "polymul-real",
                      "polymul-mod"})

#: Data-moving ``torch.distributed`` collectives (and their
#: ``_functional_collectives`` forms). ``barrier`` is deliberately absent —
#: it moves no payload, so calling it raw cannot break ledger parity.
TORCH_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_to_all",
    "all_to_all_single", "reduce_scatter", "reduce_scatter_tensor",
    "broadcast", "reduce", "gather", "scatter", "send", "recv", "isend",
    "irecv", "batch_isend_irecv", "all_gather_tensor",
    "all_reduce_coalesced", "all_gather_object", "broadcast_object_list",
    "gather_object", "scatter_object_list",
})

_DIST_MODULES = ("torch.distributed",
                 "torch.distributed._functional_collectives")


def _dotted(node: ast.AST) -> str | None:
    """'torch.distributed.all_reduce' for an Attribute/Name chain, else
    None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_torch_ref(node: ast.AST) -> bool:
    d = _dotted(node)
    return bool(d) and (d == "torch" or d.startswith("torch."))


def _mentions_float32(node: ast.AST) -> bool:
    if isinstance(node, ast.Attribute) and node.attr == "float32":
        return True
    if isinstance(node, ast.Name) and node.id == "float32":
        return True
    return isinstance(node, ast.Constant) and node.value == "float32"


def _walk_skip_nested(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk a function body without descending into nested function
    definitions (their bodies run on whatever thread *calls* them, not on
    the enclosing frame)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


class Rule:
    """Base: ``id`` is the noqa key; ``kind`` is 'ast' for tree rules or
    'noqa' for the engine-hosted suppression-hygiene rules."""

    id: str = ""
    kind: str = "ast"

    def check(self, ctx) -> Iterable[RawFinding]:
        return ()

    @property
    def summary(self) -> str:
        return (self.__doc__ or "").strip().splitlines()[0]


class DeviceCacheRule(Rule):
    """lru_cache / functools.cache over a function that puts a tensor on a
    device it does not take as a parameter — the port's form of PR 3's
    tracer-leak rule (cached tables stay numpy). The port caches numpy
    tables and keys each device copy by its device (``device_twiddles``,
    port PR 11; the four-step twiddles, port PR 25): a copy cached without
    its device in the key hands a shard on one card a table that lives on
    another (``dist/sharding.py`` puts shards round-robin over the cards).
    Flags ``device=``, ``.to(<device>)`` and ``.cuda()``; ``meta`` holds
    no data and is exempt."""

    id = "device-cache"
    _CACHE_DECOS = frozenset({"functools.lru_cache", "lru_cache",
                              "functools.cache", "cache"})

    def check(self, ctx) -> Iterable[RawFinding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            cached = any(
                _dotted(d.func if isinstance(d, ast.Call) else d)
                in self._CACHE_DECOS
                for d in node.decorator_list)
            if not cached:
                continue
            a = node.args
            params = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
            params |= {p.arg for p in (a.vararg, a.kwarg) if p is not None}
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    where = self._unkeyed_placement(sub, params)
                    if where:
                        yield (sub.lineno, sub.col_offset,
                               f"cached function places a tensor with "
                               f"{where}, a device its parameters do not "
                               "key: cache numpy tables and key each "
                               "device copy by its device, or a shard on "
                               "one card reads a table on another (PR 3, "
                               "RNS table cache; port PR 11/25, "
                               "device-keyed twiddles)")

    @classmethod
    def _unkeyed_placement(cls, node: ast.AST, params: set[str]
                           ) -> str | None:
        if not isinstance(node, ast.Call):
            return None
        for kw in node.keywords:
            if kw.arg == "device" and cls._unkeyed(kw.value, params):
                return f"device={ast.unparse(kw.value)}"
        if not isinstance(node.func, ast.Attribute):
            return None
        if node.func.attr == "to" and node.args:
            dev = node.args[0]
            if cls._is_device(dev) and cls._unkeyed(dev, params):
                return f".to({ast.unparse(dev)})"
        elif node.func.attr == "cuda":
            if not node.args and not node.keywords:
                return ".cuda()"
            if node.args and cls._unkeyed(node.args[0], params):
                return f".cuda({ast.unparse(node.args[0])})"
        return None

    @staticmethod
    def _is_device(node: ast.AST) -> bool:
        """Whether a positional ``.to`` argument names a device (and not a
        dtype such as ``torch.float32``)."""
        if isinstance(node, ast.Constant):
            return isinstance(node.value, str)
        if isinstance(node, ast.Call):
            return (_dotted(node.func) or "").rpartition(".")[2] == "device"
        if isinstance(node, ast.Attribute):
            return node.attr == "device"
        if isinstance(node, ast.Name):
            return "device" in node.id.lower() or node.id == "dev"
        return False

    @staticmethod
    def _unkeyed(node: ast.AST, params: set[str]) -> bool:
        """Whether a device expression is neither ``None``, nor ``meta``,
        nor built from a parameter of the cached function."""
        if isinstance(node, ast.Constant):
            return node.value not in (None, "meta")
        if (isinstance(node, ast.Call) and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == "meta"):
            return False
        return not any(isinstance(s, ast.Name) and s.id in params
                       for s in ast.walk(node))


class Fp32PhaseRule(Rule):
    """Twiddle/root phases built with float32 or device operands — PR 5:
    the four-step FFT's step-3 twiddles were f32 ``k1*j2`` products with a
    separately-rounded in-graph device phase (~4e-7 error at n=2^20); the
    fix computes exact integer exponents with f64 host trig, rounded ONCE.
    The port builds its four-step twiddles the same way (f64 numpy, one
    rounding; ``core/fft/distributed.py``, port PR 25)."""

    id = "fp32-phase"
    _TRIG = frozenset({"exp", "cos", "sin"})
    _GRAPH_TRIG = _TRIG | {"polar"}
    _HOST = frozenset({"np", "numpy", "math"})

    def check(self, ctx) -> Iterable[RawFinding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func)
            if not d or "." not in d:
                continue
            base, _, fn = d.rpartition(".")
            args = list(node.args) + [kw.value for kw in node.keywords]
            subs = [s for a in args for s in ast.walk(a)]
            has_f32 = any(_mentions_float32(s) for s in subs)
            if base in self._HOST and fn in self._TRIG:
                if has_f32:
                    yield (node.lineno, node.col_offset,
                           f"host {d}() over a float32 phase: twiddle/root "
                           "angles must be exact-integer exponents in f64, "
                           "rounded once after the trig (PR 5, fp32 "
                           "four-step twiddle bug)")
                elif any(_is_torch_ref(s) for s in subs):
                    yield (node.lineno, node.col_offset,
                           f"host {d}() fed a torch operand: phase tables "
                           "are built host-side from integer exponents, "
                           "never from device values (PR 5, fp32 "
                           "four-step twiddle bug)")
            elif base == "torch" and fn in self._GRAPH_TRIG and has_f32:
                yield (node.lineno, node.col_offset,
                       f"device {d}() over an explicitly float32 phase: "
                       "separately-rounded f32 phases cost ~10x twiddle "
                       "accuracy (PR 5, fp32 four-step twiddle bug)")


class MutableDefaultRule(Rule):
    """Mutable or config-dataclass default arguments — PR 7: a shared
    ``WatchdogConfig()`` default meant every StepWatchdog mutated the same
    config instance; the fix is a None sentinel. Flags mutable literals,
    mutable constructors, and calls to ``*Config`` names in defaults."""

    id = "mutable-default"
    _LITERALS = (ast.List, ast.Dict, ast.Set,
                 ast.ListComp, ast.SetComp, ast.DictComp)
    _CTORS = frozenset({"list", "dict", "set", "bytearray", "deque",
                        "defaultdict", "Counter", "OrderedDict"})

    def check(self, ctx) -> Iterable[RawFinding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                continue
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]
            for default in defaults:
                what = None
                if isinstance(default, self._LITERALS):
                    what = "mutable literal"
                elif isinstance(default, ast.Call):
                    last = (_dotted(default.func) or "").rpartition(".")[2]
                    if last in self._CTORS:
                        what = f"mutable {last}() constructor"
                    elif last.endswith("Config"):
                        what = f"config-dataclass instance {last}()"
                if what:
                    yield (default.lineno, default.col_offset,
                           f"{what} as a default argument is shared "
                           "across every call — use a None sentinel "
                           "(PR 7, shared-mutable WatchdogConfig bug)")


class RawCollectiveRule(Rule):
    """torch.distributed collectives outside repro_torch/dist/collectives.py
    — PR 1 built the byte-ledger wrappers and PRs 5/8 pinned closed-form
    byte formulas against that ledger; the port's ledger and its closed
    forms are held to the live ledger the same way (port PR 25). A raw
    ``torch.distributed`` call (``torch.distributed.X``, ``dist.X`` after
    ``import torch.distributed as dist``, the functional collectives, or a
    name imported from either) moves bytes the ledger never sees."""

    id = "raw-collective"
    _ALLOWED = ("repro_torch/dist/collectives.py",)

    def check(self, ctx) -> Iterable[RawFinding]:
        if ctx.path.endswith(self._ALLOWED):
            return
        modules = set(_DIST_MODULES)
        names: dict[str, str] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name in _DIST_MODULES and a.asname:
                        modules.add(a.asname)
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    full = f"{node.module}.{a.name}"
                    if full in _DIST_MODULES:
                        modules.add(a.asname or a.name)
                    elif (node.module in _DIST_MODULES
                          and a.name in TORCH_COLLECTIVES):
                        names[a.asname or a.name] = a.name
        for node in ast.walk(ctx.tree):
            what = None
            if (isinstance(node, ast.Attribute)
                    and node.attr in TORCH_COLLECTIVES
                    and _dotted(node.value) in modules):
                what = node.attr
            elif (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in names):
                what = names[node.func.id]
            if what:
                yield (node.lineno, node.col_offset,
                       f"raw torch.distributed {what}: collectives must go "
                       "through the byte-ledgered wrappers in "
                       "repro_torch.dist.collectives, or their bytes never "
                       "hit the ledger the closed forms are pinned against "
                       "(PR 1 ledger, PR 5/8 parity gates; port PR 25)")


class DispatchLadderRule(Rule):
    """if/elif string ladders over the served op names outside the
    repro_torch/launch/ops.py registry — PR 6 replaced serve.py's per-op
    ladders with the OpSpec registry; a new ladder is a second dispatch
    surface that drifts from registry validation/binding. The port serves
    through its own copy of that registry (``launch/ops.py``)."""

    id = "dispatch-ladder"
    _ALLOWED = ("repro_torch/launch/ops.py",)

    def check(self, ctx) -> Iterable[RawFinding]:
        if ctx.path.endswith(self._ALLOWED):
            return
        elif_nodes = set()
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.If) and len(node.orelse) == 1
                    and isinstance(node.orelse[0], ast.If)):
                elif_nodes.add(id(node.orelse[0]))
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.If) or id(node) in elif_nodes:
                continue
            subjects: dict[str, set[str]] = {}
            cur = node
            while True:
                m = self._str_eq(cur.test)
                if m:
                    subjects.setdefault(m[0], set()).add(m[1])
                if len(cur.orelse) == 1 and isinstance(cur.orelse[0], ast.If):
                    cur = cur.orelse[0]
                else:
                    break
            for vals in subjects.values():
                hit = sorted(vals & OP_NAMES)
                if len(hit) >= 2:
                    yield (node.lineno, node.col_offset,
                           f"op-name dispatch ladder ({', '.join(hit)}): "
                           "dispatch belongs in the launch/ops.py OpSpec "
                           "registry, not string switches (PR 6, serve "
                           "ladder removal)")
                    break

    @staticmethod
    def _str_eq(test: ast.AST) -> tuple[str, str] | None:
        if (isinstance(test, ast.Compare) and len(test.ops) == 1
                and isinstance(test.ops[0], ast.Eq)):
            left, right = test.left, test.comparators[0]
            if isinstance(right, ast.Constant) and isinstance(right.value,
                                                             str):
                return ast.dump(left), right.value
            if isinstance(left, ast.Constant) and isinstance(left.value,
                                                             str):
                return ast.dump(right), left.value
        return None


class SignalLockRule(Rule):
    """Taking a non-reentrant lock inside a signal handler body — PR 7:
    the serve SIGTERM handler called ``engine.request_stop()`` on the
    interrupted main thread, whose frame may already hold the engine's
    Condition — a self-deadlock. The fix hands the call to a separate
    thread; nested defs are exempt (they run on whichever thread calls
    them, which is the hand-off pattern). The port's handler hands off
    the same way (``launch/serve.py``, port PR 24)."""

    id = "signal-lock"
    _LOCKY_CALLS = frozenset({"acquire", "wait", "notify", "notify_all",
                              "request_stop", "submit", "snapshot"})
    _LOCKY_NAMES = ("lock", "cv", "cond", "mutex")

    def check(self, ctx) -> Iterable[RawFinding]:
        handler_names: set[str] = set()
        handler_lambdas: list[ast.Lambda] = []
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call)
                    and _dotted(node.func) == "signal.signal"
                    and len(node.args) >= 2):
                h = node.args[1]
                if isinstance(h, ast.Name):
                    handler_names.add(h.id)
                elif isinstance(h, ast.Lambda):
                    handler_lambdas.append(h)
        bodies: list[ast.AST] = list(handler_lambdas)
        bodies += [n for n in ast.walk(ctx.tree)
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                   and n.name in handler_names]
        for fn in bodies:
            yield from self._scan(fn)

    def _scan(self, fn: ast.AST) -> Iterator[RawFinding]:
        for sub in _walk_skip_nested(fn):
            if isinstance(sub, ast.With):
                for item in sub.items:
                    name = ((_dotted(item.context_expr) or "")
                            .rpartition(".")[2].lower())
                    if any(k in name for k in self._LOCKY_NAMES):
                        yield (sub.lineno, sub.col_offset,
                               "signal handler enters a lock: the handler "
                               "runs on the interrupted main thread, which "
                               "may already hold it — self-deadlock (PR 7, "
                               "SIGTERM drain bug); hand off to a thread")
            elif (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in self._LOCKY_CALLS):
                yield (sub.lineno, sub.col_offset,
                       f"signal handler calls .{sub.func.attr}() directly: "
                       "engine methods take the non-reentrant Condition — "
                       "on the interrupted main thread that self-deadlocks "
                       "(PR 7, SIGTERM drain bug); spawn a thread for it")


class DurableWriteRule(Rule):
    """Raw writes inside repro_torch/ft/ — PR 9: a crash between payload
    and manifest writes left torn checkpoints that restore half-read; every
    durable file must go through the fsync+rename, manifest-LAST helper in
    ft/checkpoint.py (``_write_durable``; warm restart and bit-for-bit
    resume rest on it, port PRs 24 and 27). Flags open(..., 'w'/'a'/'x'/
    '+'), json.dump, np.save* and torch.save in ft modules; the helper's
    callers carry noqa reasons."""

    id = "durable-write"
    _SCOPE = "repro_torch/ft/"
    _WRITE_FNS = frozenset({"json.dump", "np.save", "np.savez",
                            "np.savez_compressed", "numpy.save",
                            "numpy.savez", "numpy.savez_compressed",
                            "torch.save"})

    def check(self, ctx) -> Iterable[RawFinding]:
        if self._SCOPE not in ctx.path:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func)
            if d == "open":
                mode = None
                if len(node.args) >= 2 and isinstance(node.args[1],
                                                      ast.Constant):
                    mode = node.args[1].value
                for kw in node.keywords:
                    if kw.arg == "mode" and isinstance(kw.value,
                                                       ast.Constant):
                        mode = kw.value.value
                if isinstance(mode, str) and any(c in mode for c in "wax+"):
                    yield (node.lineno, node.col_offset,
                           f"raw open(..., {mode!r}) under ft/: durable "
                           "state must go through the fsync+rename "
                           "manifest-last helper, or a crash tears the "
                           "checkpoint (PR 9, torn-manifest bug)")
            elif d in self._WRITE_FNS:
                yield (node.lineno, node.col_offset,
                       f"raw {d}() under ft/: durable state must go "
                       "through the fsync+rename manifest-last helper "
                       "(PR 9, torn-manifest bug)")


class BarePlanLiteralRule(Rule):
    """Hand-built FFTPlan(...) literals outside the port's planner.py and
    cost.py — PR 5: serve carried literal plans that silently skipped
    planner validation (the exact tier's shard checks among them); the fix
    routes every forced plan through ``plan(..., force_distributed=True)``
    so the constraints fire. Only ``repro_torch/core/fft/planner.py`` and
    ``repro_torch/core/cost.py`` may construct FFTPlan."""

    id = "bare-plan-literal"
    _ALLOWED = ("repro_torch/core/fft/planner.py", "repro_torch/core/cost.py")

    def check(self, ctx) -> Iterable[RawFinding]:
        if ctx.path.endswith(self._ALLOWED):
            return
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call)
                    and (_dotted(node.func) or "").rpartition(".")[2]
                    == "FFTPlan"):
                yield (node.lineno, node.col_offset,
                       "hand-built FFTPlan literal: construct plans via "
                       "plan(n, batch, ...) so planner validation "
                       "(shard divisibility, shared-memory ceilings) runs "
                       "(PR 5, serve literal-plan bug)")


class OneTracerRule(Rule):
    """Profiler ranges or ``gc.callbacks`` hooks in a module of the port
    other than ``repro_torch/spans.py`` — the port's own rule, with no
    counterpart in the reference: the benchmark that first traced the port
    counted the device-side mirrors of its user-scope profiler labels as
    device work (two and four "launches" a request), and one more path
    into the profiler brings that back. ``spans.py`` opens function-scope
    ranges, which get no mirror, checks the profiler's flag before each,
    and hooks the collector once. Flags imports of ``torch.profiler``,
    ``torch.autograd.profiler`` and ``torch._C._profiler`` (and of names
    from them), ``record_function`` and ``_RecordFunctionFast`` by any
    spelling, and ``gc.callbacks``."""

    id = "one-tracer"
    _SCOPE = "repro_torch/"
    _ALLOWED = ("repro_torch/spans.py",)
    _MODULES = ("torch.profiler", "torch.autograd.profiler",
                "torch._C._profiler")
    _NAMES = frozenset({"record_function", "_RecordFunctionFast",
                        "RecordFunctionFast"})

    def _profiler_module(self, dotted: str) -> bool:
        return any(dotted == m or dotted.startswith(m + ".")
                   for m in self._MODULES)

    def _what(self, node: ast.AST) -> str | None:
        if isinstance(node, ast.Import):
            for alias in node.names:
                if self._profiler_module(alias.name):
                    return f"import {alias.name}"
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = {a.name for a in node.names}
            if (self._profiler_module(node.module)
                    or names & self._NAMES
                    or (node.module == "gc" and "callbacks" in names)
                    or any(self._profiler_module(f"{node.module}.{n}")
                           for n in names)):
                return f"from {node.module} import " + ", ".join(
                    sorted(names))
        elif isinstance(node, ast.Attribute):
            d = _dotted(node)
            if d and (d == "gc.callbacks" or node.attr in self._NAMES
                      or any(d == m for m in self._MODULES)):
                return d
        elif isinstance(node, ast.Name) and node.id in self._NAMES:
            return node.id
        return None

    def check(self, ctx) -> Iterable[RawFinding]:
        if self._SCOPE not in ctx.path or ctx.path.endswith(self._ALLOWED):
            return
        seen = set()            # torch.profiler.x flags once, not twice
        for node in ast.walk(ctx.tree):
            what = self._what(node)
            if what is not None and (node.lineno, node.col_offset) not in seen:
                seen.add((node.lineno, node.col_offset))
                yield (node.lineno, node.col_offset,
                       f"{what} outside repro_torch/spans.py: the port has "
                       "one tracing system; open a range with spans.span "
                       "or spans.spanned (a user-scope range's device "
                       "mirror reads as device work)")


class NoqaReasonRule(Rule):
    """Suppression without a reason (or naming an unknown/meta rule) —
    PR 10's own contract: every ``# repro_torch: noqa[rule]`` must carry
    ``: reason`` explaining why the historical bug does not apply here;
    a bare suppression is how contracts silently rot. Engine-hosted: the
    malformed suppression is reported and does NOT suppress."""

    id = "noqa-reason"
    kind = "noqa"


class UnusedNoqaRule(Rule):
    """Suppression that suppresses nothing — PR 10's own contract: a noqa
    left behind after the code it excused was fixed (or that never matched)
    is a latent hole; the engine reports it so suppressions track the code.
    Engine-hosted post-pass over the suppression table."""

    id = "unused-noqa"
    kind = "noqa"


RULES: tuple[Rule, ...] = (
    DeviceCacheRule(),
    Fp32PhaseRule(),
    MutableDefaultRule(),
    RawCollectiveRule(),
    DispatchLadderRule(),
    SignalLockRule(),
    DurableWriteRule(),
    BarePlanLiteralRule(),
    OneTracerRule(),
    NoqaReasonRule(),
    UnusedNoqaRule(),
)

RULE_IDS = tuple(r.id for r in RULES)
