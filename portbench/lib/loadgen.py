"""The one load generator: every traffic mix is a set of its parameters.

A request is one call of the bound entry on one operand set of the pool.
Two loops:

  closed  (``"loop": "closed"``): ``queue_depth`` requests stay queued on
          the stream; request i is dispatched once request i - depth has
          completed. The window ends when the last request dispatched
          before ``seconds`` has completed, and all its work counts.
  open    (``"loop": "open"``): requests fall due on a Poisson schedule at
          ``rate_rps`` and are dispatched when due; between dispatches the
          same thread watches for completions, in order. A request's
          latency runs from its due time to the host's seeing it done.

Every request is recorded: due (open loop), dispatch start and end, and
completion as the host saw it, in seconds from the window's start. A
request still incomplete ``late_after_s`` past the window's close is
missing. Outputs of ``check_requests`` requests, a sample drawn from the
seed over the whole window, are kept for the check.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import random
import time

import numpy as np


def gaps(rate: float, seconds: float) -> np.ndarray:
    """The round(rate * seconds) gaps of a Poisson process at ``rate``,
    taken at evenly spaced quantiles of the exponential distribution."""
    count = max(1, round(rate * seconds))
    return -np.log1p(-(np.arange(count) + 0.5) / count) / rate


def schedule(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s), the first at 0: every seed offers the same set of
    gaps (``gaps``), in an order drawn from the seed."""
    g = gaps(rate, seconds)
    g = g[np.random.default_rng(seed % 2**64).permutation(len(g))]
    return np.concatenate([[0.0], np.cumsum(g[:-1])])


class Reservoir:
    """Keeps a uniform sample of ``size`` requests' outputs over a stream
    of unknown length (algorithm R), drawn from the seed."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.kept: dict[int, tuple] = {}     # slot -> (request, set, out)

    def offer(self, i: int, set_index: int, out) -> None:
        if i < self.size:
            self.kept[i] = (i, set_index, out)
            return
        j = self.rng.randrange(i + 1)
        if j < self.size:
            self.kept[j] = (i, set_index, out)

    def sample(self) -> list[tuple]:
        return sorted(self.kept.values(), key=lambda t: t[0])


@dataclasses.dataclass
class Window:
    """What the generator recorded over one window."""
    loop: str
    requests: int
    products: int
    window_s: float
    due: list[float] | None
    dispatch_start: list[float]
    dispatch_end: list[float]
    done: list[float | None]
    kept: list[tuple]

    @property
    def missing(self) -> int:
        return sum(d is None for d in self.done)


class CardSync:
    """Events and waits on the card (the stream the entry launches on)."""

    def __init__(self, torch):
        self.torch = torch

    def event(self):
        return self.torch.cuda.Event()

    def settle(self) -> None:
        self.torch.cuda.synchronize()


class HostSync:
    """The same on the CPU, where every call has finished on return."""

    class _Done:
        def record(self):
            pass

        def synchronize(self):
            pass

        def query(self):
            return True

    def event(self):
        return self._Done()

    def settle(self) -> None:
        pass


def labeller(profiler_on: bool):
    """``record_function`` labels in a traced run, nothing otherwise."""
    if not profiler_on:
        return lambda name: contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function


def run_closed(fn, pool, *, products: int, seconds: float, depth: int,
               sync, keep: Reservoir, traced: bool = False,
               late_after_s: float = 60.0) -> Window:
    label = labeller(traced)
    events = [sync.event() for _ in range(depth)]
    starts, ends = [], []
    i = 0
    t0 = time.perf_counter()
    stop = t0 + seconds
    while time.perf_counter() < stop:
        if i >= depth:
            with label("portbench.wait"):
                events[i % depth].synchronize()
        s = pool[i % len(pool)]
        with label("portbench.dispatch"):
            ts = time.perf_counter()
            out = fn(*s)
            te = time.perf_counter()
        events[i % depth].record()
        keep.offer(i, i % len(pool), out)
        starts.append(ts - t0)
        ends.append(te - t0)
        i += 1
    deadline = time.perf_counter() + late_after_s
    last = events[(i - 1) % depth]
    while not last.query() and time.perf_counter() < deadline:
        time.sleep(1e-4)
    complete = last.query()
    t_end = time.perf_counter()
    done = [t_end - t0 if complete else None] * i
    return Window("closed", i, i * products, t_end - t0, None, starts, ends,
                  done, keep.sample())


#: how often the open loop asks whether the oldest request has completed
POLL_S = 2e-5


def run_open(fn, pool, *, products: int, due: np.ndarray, sync,
             keep: Reservoir, traced: bool = False,
             late_after_s: float = 60.0) -> Window:
    """One thread offers the load and observes completions: between
    dispatches it asks the oldest incomplete request's event, at most
    every ``POLL_S``, and stamps the first time the answer is yes."""
    label = labeller(traced)
    count = len(due)
    events = [sync.event() for _ in range(count)]
    starts, ends = [0.0] * count, [0.0] * count
    done: list[float | None] = [None] * count
    head = 0
    clock = time.perf_counter
    t0 = clock()

    def observe(until: float) -> None:
        """Stamp completions, in order, until ``until`` (s from t0) or
        until every dispatched request is seen past the last dispatch."""
        nonlocal head
        asked = -math.inf
        while True:
            now = clock() - t0
            if now >= until or head == count:
                return
            if head < dispatched and now - asked >= POLL_S:
                asked = now
                if events[head].query():
                    done[head] = clock() - t0
                    head += 1
                    asked = -math.inf

    dispatched = 0
    for i, at in enumerate(due.tolist()):
        observe(at)
        s = pool[i % len(pool)]
        with label("portbench.dispatch"):
            ts = clock()
            out = fn(*s)
            te = clock()
        events[i].record()
        dispatched = i + 1
        keep.offer(i, i % len(pool), out)
        starts[i], ends[i] = ts - t0, te - t0
    close = clock() - t0
    observe(close + late_after_s)
    window = max([close] + [d for d in done if d is not None])
    return Window("open", count, count * products, window,
                  due.tolist(), starts, ends, done, keep.sample())


def nearest_rank(values, share: float) -> float:
    """The value at rank ceil(share * N) of the sorted values."""
    vals = sorted(values)
    return vals[max(0, math.ceil(share * len(vals)) - 1)]
