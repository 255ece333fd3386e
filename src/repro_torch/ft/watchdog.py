"""Straggler / hang detection for the training loop.

Port of ``repro.ft.watchdog``: a stdlib copy, pinned equal to the original
by ``tests/test_torch_ft.py``. The port's serve engine feeds it each
batch's dispatch -> on-host time (``launch/engine.py``).

Per-step wall-times feed an EWMA; a step exceeding ``threshold x EWMA`` is
flagged as a straggler event. In a multi-host deployment the driver uses
this to (a) emit telemetry, (b) skip the lagging host's data shard for the
next step (the synthetic pipeline is stateless so no data is lost), and
(c) after ``evict_after`` consecutive flags, request the elastic controller
to re-mesh without the straggling host (checkpoint -> resize -> restore via
ft.checkpoint's elastic re-shard).

On this single-host container the detector itself is exercised by tests;
the eviction hook is a callback.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


@dataclasses.dataclass
class WatchdogConfig:
    ewma_alpha: float = 0.2
    threshold: float = 2.5       # x EWMA counts as a straggler step
    evict_after: int = 3         # consecutive flags before eviction request
    warmup_steps: int = 3        # ignore compile/first-step noise


class StepWatchdog:
    def __init__(self, cfg: Optional[WatchdogConfig] = None,
                 on_evict: Optional[Callable[[int], None]] = None):
        # None sentinel: a dataclass default here would be evaluated ONCE at
        # class-definition time and shared (mutably) by every watchdog.
        self.cfg = WatchdogConfig() if cfg is None else cfg
        self.on_evict = on_evict
        self.ewma: Optional[float] = None
        self.seen = 0
        self.consecutive_flags = 0
        self.events: list[dict] = []
        self._t0: Optional[float] = None

    def start_step(self):
        self._t0 = time.perf_counter()

    def end_step(self, step: int) -> bool:
        """Returns True if this step was flagged as a straggler."""
        assert self._t0 is not None, "start_step not called"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(step, dt)

    # -- checkpointable state (manifest ``extra``, json-serializable) -------

    def state_dict(self) -> dict:
        """EWMA/flag/event state for the checkpoint manifest: a resumed run
        keeps its timing baseline instead of re-warming and re-learning it
        (and keeps the straggler event log across preemptions)."""
        return {"ewma": self.ewma, "seen": self.seen,
                "consecutive_flags": self.consecutive_flags,
                "events": list(self.events)}

    def load_state_dict(self, state: dict) -> None:
        self.ewma = state.get("ewma")
        self.seen = int(state.get("seen", 0))
        self.consecutive_flags = int(state.get("consecutive_flags", 0))
        self.events = list(state.get("events", []))

    def observe(self, step: int, dt: float) -> bool:
        """Pure observation API (used by tests with synthetic timings)."""
        self.seen += 1
        if self.seen <= self.cfg.warmup_steps:
            self.ewma = dt if self.ewma is None else \
                (1 - self.cfg.ewma_alpha) * self.ewma + self.cfg.ewma_alpha * dt
            return False
        flagged = dt > self.cfg.threshold * self.ewma
        if flagged:
            self.consecutive_flags += 1
            self.events.append({"step": step, "dt": dt, "ewma": self.ewma})
            if (self.consecutive_flags >= self.cfg.evict_after
                    and self.on_evict is not None):
                self.on_evict(step)
                self.consecutive_flags = 0
        else:
            self.consecutive_flags = 0
            # stragglers do not poison the EWMA
            self.ewma = ((1 - self.cfg.ewma_alpha) * self.ewma
                         + self.cfg.ewma_alpha * dt)
        return flagged
