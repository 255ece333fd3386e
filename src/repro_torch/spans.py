"""Host spans of the port on the profiler's clock: its one tracing system.

``span(name)`` opens a range in the buffer of a ``torch.profiler`` that is
recording, and does nothing otherwise: one check of the profiler's flag,
then the same preallocated no-op context manager, which allocates nothing,
dispatches no profiler op and takes no lock. The spans go nowhere but that
buffer: a caller that wants them runs the profiler around its calls.

Names are ``repro_torch.<boundary>/<what>``; a span's parent, and the
request it belongs to, come from nesting:

  repro_torch.op/<route>        a bound registry route, ``BoundOp.fn``
                                (``launch/ops.py``)
  repro_torch.glue/<wrapper>    a kernel wrapper from entry to return;
                                ``<wrapper>`` is its ``_build.LAUNCHES`` key
  repro_torch.launch/<launcher> ``_build.launch``: the library lookup, the
                                C launcher, the check of its error code
  repro_torch.gc/<generation>   a collection of Python's garbage, through
                                the ``gc.callbacks`` hook installed here

The ranges are the profiler's function-scope records. A user-scope range
(``torch.profiler.record_function``) also gets a mirror on the device's
timeline, spanning the kernels launched inside it, which a reader of
device activity would count as device work; a function-scope range gets
none. No other module of the port touches the profiler or
``gc.callbacks`` (the ``one-tracer`` rule of ``repro_torch.analysis``).
"""
from __future__ import annotations

import gc
from typing import Callable

import torch

_enabled = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


class _Off:
    """The context manager ``span`` hands out while nothing records."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_OFF = _Off()


def span(name: str):
    """A profiler range named ``name`` while the profiler records, else
    the shared no-op."""
    if not _enabled():
        return _OFF
    return _Range(name)


def spanned(name: str, fn: Callable) -> Callable:
    """``fn`` with every call inside ``span(name)``."""
    def call(*args, **kwargs):
        if not _enabled():
            return fn(*args, **kwargs)
        with _Range(name):
            return fn(*args, **kwargs)
    return call


_GC_NAMES = tuple(f"repro_torch.gc/{g}" for g in range(3))
#: the range of the collection under way, while the profiler records
_gc_open: list = []


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        if _enabled():
            r = _Range(_GC_NAMES[info["generation"]])
            r.__enter__()
            _gc_open.append(r)
    elif _gc_open:
        _gc_open.pop().__exit__(None, None, None)


gc.callbacks.append(_on_gc)
