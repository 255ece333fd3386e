"""Continuous-batching serve engine over the op-dispatch registry (port of
``repro.launch.engine``).

One engine multiplexes a mixed request stream: every request carries its
own ``(op, n)``, is admitted against a bounded queue, and lands in a
per-``(op, n)`` shape bucket. A single scheduler loop drains the buckets:

  * **shape bucketing** -- requests only batch with shape-compatible peers;
    each bucket dispatches through its :class:`~repro_torch.launch.ops.
    BoundOp`, resolved once from the registry;
  * **tail batches at actual size** -- a bucket holding 3 requests
    dispatches 3 rows; nothing is padded to the block cap;
  * **async dispatch, deferred sync** -- batch k is stacked in pinned host
    memory, copied to the card, run, and copied back into pinned host
    memory, all queued on the stream without blocking the host; a CUDA
    event recorded after the copy back marks it done. The engine waits on
    that event only after batch k+1 has been stacked and queued, so the
    host's work on batch k (its host step, its integrity check) overlaps
    batch k+1 on the card, and resolving batch k does not wait for batch
    k+1 (one batch in flight);
  * **oldest-head scheduling** -- among non-empty buckets the one whose
    head request has waited longest dispatches next;
  * **backpressure** -- ``submit`` blocks (or raises :class:`Backpressure`
    with ``block=False``) while ``max_pending`` requests are queued.

Metrics: per-request latency (submit -> result on the host) percentiles
p50/p90/p99, end-to-end and busy-only throughput, and per-bucket batch
sizes with utilization (mean dispatched batch / block cap). With
``auto=True`` the cost model picks each bucket's route, and each bucket
reports the model's predicted seconds per request, tier and backend beside
the observed ones.

Fault tolerance: the engine is preemption-safe. ``request_stop`` (the
SIGTERM path in ``launch/serve.py``) stops admission and lets ``run``
DRAIN: every already-admitted request is dispatched, resolved and
delivered before ``run`` returns; ``snapshot`` then persists the lifetime
stats, bucket config and watchdog state through ``ft.checkpoint`` (atomic
step dirs, the reference's format), and ``ServeEngine.from_snapshot``
warm-restarts: buckets re-register and re-bind on the restart-time
context while served counters, the latency record and the watchdog's
timing baseline carry over. A :class:`~repro_torch.ft.watchdog.
StepWatchdog` observes each batch's dispatch -> on-host time, less the
time the scheduler sat idle waiting for the next request to arrive (a gap
in the traffic is not a slow batch); its ``on_evict`` hook is the elastic
trigger (checkpoint -> resize -> restore).

Integrity (``verified=True``): every deliverable batch passes its op's
ABFT check (``ft/abft.py``) on the host, on the rows it delivers (after
the route's host step: the RNS route's CRT), before any client sees a
result. A failed check triggers bounded re-execution with exponential
backoff; each re-execution is staged, launched, copied back and waited
for on the same stream (behind the batch in flight, whose rows stay its
own). When the retry budget is exhausted the bucket's circuit breaker
trips: it re-binds on a ``pim_ok=False`` context, the simulated crossbar
array behind it is quarantined to a spare, and the batch re-runs on the
clean route. ``fault_model=`` chaos testing drives this path
deterministically through a seeded :class:`~repro_torch.core.pim.
FaultModel`: each bucket's virtual array draws, per execution, in the
reference's order, and the draw corrupts the delivered rows where the
reference corrupts them, so a seed corrupts the same (execution, row,
column) as the reference engine's. Per-request deadlines
(``submit(..., deadline_s=...)``) complete expired requests with a
structured timeout error instead of a result; expired requests never
enter the latency record.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.pim import ArrayFaults, FaultModel, SparesExhausted
from repro_torch.ft import checkpoint as ckpt_lib
from repro_torch.ft.watchdog import StepWatchdog, WatchdogConfig
from repro_torch.launch import ops as op_registry

SNAPSHOT_SCHEMA = "serve_engine_snapshot/v1"
#: Latency samples kept for the percentiles and persisted by ``snapshot``:
#: they describe recent service, and a snapshot -> restart -> snapshot loop
#: plateaus at this many instead of growing by each generation's traffic.
LATENCY_WINDOW = 4096


class Backpressure(RuntimeError):
    """Admission rejected: the bounded request queue is full."""


class EngineStopped(RuntimeError):
    """Admission rejected: the engine is draining toward a stop/snapshot."""


@dataclasses.dataclass
class _Request:
    rid: int
    payload: Any
    t_submit: float
    # absolute perf_counter() deadline; expired requests complete with a
    # structured error instead of a result (and never batch)
    deadline: float | None = None


@dataclasses.dataclass
class _BucketStats:
    served: int = 0
    batches: int = 0
    batch_sizes: list = dataclasses.field(default_factory=list)
    # accumulated dispatch -> on-host seconds of this bucket's batches
    service_s: float = 0.0
    # deadline-expired requests swept from this bucket's queue
    expired: int = 0
    # ABFT ledger (verified=True): checks run / failures detected /
    # re-executions / breaker trips
    checked: int = 0
    corrupted: int = 0
    retried: int = 0
    fell_back: int = 0


@dataclasses.dataclass
class _Fault:
    """One execution's draw from a bucket's faulty array: applied to the
    rows that execution delivers."""
    faults: ArrayFaults
    rng: np.random.Generator

    def apply(self, arr: np.ndarray) -> np.ndarray:
        """The reference injector's corruption: permanent faults corrupt
        every execution, transient bit-flips fire with probability
        ``1 - (1 - rate)^gates`` where gates scales with the batch's work
        (rows * width * log2 width); the damage is a magnitude change
        (float/complex) or a low-bit flip (modular) on one element."""
        arr = np.array(arr, copy=True)
        rows = arr if arr.ndim > 1 else arr.reshape(1, -1)
        if self.faults.permanent:
            corrupt = True
        else:
            n = rows.shape[1]
            gates = rows.shape[0] * n * max(1, n.bit_length() - 1)
            p = 1.0 - (1.0 - self.faults.bitflip_per_gate) ** gates
            corrupt = bool(self.rng.random() < p)
        if corrupt:
            r = int(self.rng.integers(rows.shape[0]))
            j = int(self.rng.integers(rows.shape[1]))
            row = rows[r]
            if row.dtype == object:
                row[j] = row[j] + 1
            elif np.issubdtype(row.dtype, np.complexfloating):
                row[j] += (1.0 + float(np.abs(row).max())) * (3.0 + 3.0j)
            elif np.issubdtype(row.dtype, np.floating):
                row[j] += (1.0 + float(np.abs(row).max())) * 3.0
            else:
                row[j] = row.dtype.type(int(row[j]) ^ 1)
        return arr


class _FaultInjector:
    """Chaos hook for one serve bucket: its virtual array in the engine's
    seeded :class:`FaultModel`. Each execution of the bucket (first runs
    and retries, counted from 0) draws ``for_array`` and the transient
    stream ``rng_for(array, salt=1000 + execution)`` at launch, as the
    reference's injector does, so a chaos run replays exactly."""

    def __init__(self, model: FaultModel, array_id: int):
        self.model = model
        self.array_id = array_id
        self.dispatches = 0

    def draw(self) -> _Fault | None:
        idx = self.dispatches
        self.dispatches += 1
        faults = self.model.for_array(self.array_id)
        if faults is None:
            return None     # quarantined-to-spare or clean array
        return _Fault(faults, self.model.rng_for(self.array_id,
                                                 salt=1000 + idx))


@dataclasses.dataclass
class _Flight:
    """A launched execution: ``host`` holds its outputs once ``done`` has
    passed (at once on the CPU, where ``done`` is None)."""
    bound: op_registry.BoundOp
    host: torch.Tensor
    done: torch.cuda.Event | None
    fault: _Fault | None
    t_dispatch: float


class ServeEngine:
    """Multiplexing continuous-batching executor for registry ops.

    ``max_batch`` caps one dispatch; ``max_pending`` bounds the admission
    queue across all buckets. The process-level ``modulus_bits`` /
    ``model_shards`` / ``auto`` / ``verified`` context feeds each op
    through ``OpSpec.narrow`` unless a bucket is registered with
    ``strict=True``; ``auto=True`` lets the cost model choose each bucket's
    route, costed at the ``max_batch`` block. ``verified=True`` gates every
    batch on its ABFT check (``retry_cap`` re-executions ``retry_backoff_s
    * 2^attempt`` apart, then the circuit breaker); ``fault_model`` needs
    it. Every bucket runs on ``device``: CUDA unless the caller passes the
    CPU.
    """

    def __init__(self, *, max_batch: int = 64, max_pending: int = 1024,
                 modulus_bits: int | None = None, model_shards: int = 1,
                 auto: bool = False,
                 collect_timeout_s: float = 0.05,
                 watchdog_cfg: Optional[WatchdogConfig] = None,
                 on_evict: Optional[Callable[["ServeEngine", int], None]]
                 = None,
                 verified: bool = False,
                 fault_model: Optional[FaultModel] = None,
                 retry_cap: int = 2,
                 retry_backoff_s: float = 0.001,
                 device: str | torch.device | None = None):
        if max_batch < 1:
            raise ValueError(f"max_batch={max_batch} must be >= 1")
        if max_pending < 1:
            raise ValueError(f"max_pending={max_pending} must be >= 1")
        if retry_cap < 0:
            raise ValueError(f"retry_cap={retry_cap} must be >= 0")
        if fault_model is not None and not verified:
            raise ValueError(
                "fault_model without verified=True would deliver corrupted "
                "results: chaos injection requires the ABFT gate")
        self.device = op_registry.resolve_device(device)
        self.max_batch = max_batch
        self.max_pending = max_pending
        # how long the scheduler waits for a request before it resolves
        # the batch in flight
        self.collect_timeout_s = collect_timeout_s
        self.ctx = op_registry.OpContext(modulus_bits=modulus_bits,
                                         model_shards=model_shards,
                                         auto=auto, verified=verified)
        self.verified = verified
        self.fault_model = fault_model
        self.retry_cap = retry_cap
        self.retry_backoff_s = retry_backoff_s
        self._injectors: dict[tuple[str, int], _FaultInjector] = {}
        self._breaker_open: set[tuple[str, int]] = set()
        self._next_array_id = 0
        # rid -> structured error for requests completed WITHOUT a result
        # (deadline_exceeded); disjoint from ``results``
        self.errors: dict[int, dict] = {}
        self._bound: dict[tuple[str, int], op_registry.BoundOp] = {}
        self._strict: dict[tuple[str, int], bool] = {}
        self._bucket_stats: dict[tuple[str, int], _BucketStats] = {}
        self._buckets: dict[tuple[str, int], deque[_Request]] = {}
        self._bind_lock = threading.Lock()
        self._cv = threading.Condition()
        self._pending = 0
        self._served = 0
        self._next_rid = 0
        self._stopping = False
        self.results: dict[int, np.ndarray] = {}
        self._latencies_s: deque[float] = deque(maxlen=LATENCY_WINDOW)
        # Warm-restart carry-over (``from_snapshot`` fills these): lifetime
        # counters from before the restart, so the trajectory a deployment
        # reports survives preemption instead of resetting to zero.
        self.restarts = 0
        self._prev_served = 0
        self._prev_batches = 0
        self._prev_bucket_served: dict[str, int] = {}
        self._prev_latencies_s: list[float] = []
        # Straggler watchdog over each batch's dispatch -> on-host time;
        # ``on_evict(engine, batch_idx)`` is the elastic hook (the caller
        # drains, snapshots and warm-restarts: ``elastic_restart``).
        self.evictions: list[int] = []
        self._user_on_evict = on_evict
        self.watchdog = StepWatchdog(watchdog_cfg,
                                     on_evict=self._handle_evict)
        self._batch_idx = 0
        # seconds ``_pop_batch`` has waited on an empty queue, all told
        self._idle_s = 0.0

    def _handle_evict(self, batch_idx: int) -> None:
        self.evictions.append(batch_idx)
        if self._user_on_evict is not None:
            self._user_on_evict(self, batch_idx)

    # -- registration -------------------------------------------------------

    def register(self, op: str, n: int, *, strict: bool = False
                 ) -> op_registry.BoundOp:
        """Resolve (op, n) against the registry and open its bucket.
        Validation errors surface here as :class:`~repro_torch.launch.ops.
        OpConfigError`, at admission of the SHAPE, not mid-stream."""
        key = (op, n)
        with self._bind_lock:
            if key not in self._bound:
                spec = op_registry.get_op(op)
                self._bound[key] = spec.bind(n, self.ctx,
                                             batch=self.max_batch,
                                             strict=strict,
                                             device=self.device)
                if self.fault_model is not None:
                    # one virtual crossbar array per bucket, assigned
                    # round-robin over the model's array space
                    aid = self._next_array_id % self.fault_model.n_arrays
                    self._next_array_id += 1
                    self._injectors[key] = _FaultInjector(self.fault_model,
                                                          aid)
                self._strict[key] = strict
                self._buckets[key] = deque()
                self._bucket_stats[key] = _BucketStats()
            return self._bound[key]

    def bound(self, op: str, n: int) -> op_registry.BoundOp:
        return self.register(op, n)

    def warmup(self) -> None:
        """Run every registered bucket at each batch size a tail can round
        up to in the host's pinned-memory cache (the powers of two below
        the block cap, and the cap), so reported throughput is steady
        state: kernels built and loaded, buffers of every size cached.
        Each armed bucket's injector then throws away one draw: the
        reference's warmup runs each bucket once, at the block cap, through
        its injector, so its first served batch is execution 1. The other
        sizes draw nothing."""
        sizes = {min(1 << k, self.max_batch)
                 for k in range(self.max_batch.bit_length() + 1)}
        for bound in list(self._bound.values()):
            for batch in sorted(sizes):
                bound.warmup(batch)
        for inj in list(self._injectors.values()):
            inj.draw()

    # -- admission ----------------------------------------------------------

    def submit(self, op: str, n: int, payload, *, rid: int | None = None,
               block: bool = True, timeout: float | None = None,
               deadline_s: float | None = None) -> int:
        """Enqueue one request; returns its rid.

        Blocks while the bounded queue is full (``block=False`` raises
        :class:`Backpressure` instead). ``timeout`` bounds this call's wait
        for queue space; ``deadline_s`` bounds the REQUEST's time to
        result: a request still queued past its deadline is completed with
        a structured ``deadline_exceeded`` error (``engine.errors[rid]``)
        instead of a result, and is excluded from the latency record.
        """
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s={deadline_s} must be > 0")
        if self._stopping:
            raise EngineStopped(
                "engine is draining (request_stop/SIGTERM); submit after "
                "the warm restart")
        bound = self.register(op, n)     # validates shape/route once
        bound.check_payload(payload)     # reject NaN/Inf before it batches
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._cv:
            while self._pending >= self.max_pending:
                if self._stopping:
                    raise EngineStopped(
                        "engine is draining (request_stop/SIGTERM); "
                        "submit after the warm restart")
                if not block:
                    raise Backpressure(
                        f"queue full ({self._pending}/{self.max_pending} "
                        f"pending); retry or shed load")
                remaining = (None if deadline is None
                             else deadline - time.perf_counter())
                if remaining is not None and remaining <= 0:
                    raise Backpressure(
                        f"queue full after {timeout}s "
                        f"({self._pending}/{self.max_pending} pending)")
                self._cv.wait(remaining if remaining is not None else 0.1)
            if rid is None:
                rid = self._next_rid
            self._next_rid = max(self._next_rid, rid + 1)
            now = time.perf_counter()
            self._buckets[bound.key].append(
                _Request(rid, payload, now,
                         None if deadline_s is None else now + deadline_s))
            self._pending += 1
            self._cv.notify_all()
        return rid

    # -- scheduling ---------------------------------------------------------

    def _sweep_expired_locked(self) -> None:
        """Complete deadline-expired queued requests with a structured
        error (caller holds ``_cv``). Expired requests count as served --
        they are COMPLETED, just without a result -- so ``run`` terminates;
        they never enter the latency record."""
        now = time.perf_counter()
        for key, q in self._buckets.items():
            if not any(r.deadline is not None and r.deadline < now
                       for r in q):
                continue
            keep: deque[_Request] = deque()
            for r in q:
                if r.deadline is not None and r.deadline < now:
                    self.errors[r.rid] = {
                        "error": "deadline_exceeded",
                        "op": key[0], "n": key[1],
                        "waited_s": now - r.t_submit,
                    }
                    self._bucket_stats[key].expired += 1
                    self._pending -= 1
                    self._served += 1
                else:
                    keep.append(r)
            self._buckets[key] = keep
        self._cv.notify_all()

    def _pop_batch(self, timeout: float
                   ) -> tuple[tuple[str, int], list[_Request]] | None:
        """Take up to ``max_batch`` requests from the non-empty bucket whose
        head has waited longest; None if nothing arrives within timeout."""
        with self._cv:
            if not any(self._buckets.values()):
                t = time.perf_counter()
                self._cv.wait(timeout)
                self._idle_s += time.perf_counter() - t
            self._sweep_expired_locked()
            ready = [(q[0].t_submit, key)
                     for key, q in self._buckets.items() if q]
            if not ready:
                return None
            _, key = min(ready)
            q = self._buckets[key]
            take = min(len(q), self.max_batch)
            reqs = [q.popleft() for _ in range(take)]
            self._pending -= take
            self._cv.notify_all()
            return key, reqs

    def _dispatch(self, key: tuple[str, int], reqs: list[_Request]
                  ) -> _Flight:
        """Stage and launch one execution of the bucket's current route at
        its ACTUAL size, queue the copy of its results to the host and, on
        the card, record an event after that copy for the deferred sync;
        draw the execution's fault where the bucket has an injector."""
        t = time.perf_counter()
        bound = self._bound[key]
        host = bound.to_host(bound.execute([r.payload for r in reqs]))
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        inj = self._injectors.get(key)
        return _Flight(bound, host, done, None if inj is None else inj.draw(),
                       t)

    @staticmethod
    def _delivered(flight: _Flight) -> np.ndarray:
        """Wait for an execution and return the rows it delivers: the
        route's host step (the RNS route's CRT), then the drawn fault."""
        if flight.done is not None:
            flight.done.synchronize()
        # an array of its own, so the pinned buffer returns to the cache
        arr = flight.bound.host_step(flight.host.numpy().copy())
        return arr if flight.fault is None else flight.fault.apply(arr)

    def _verified_rows(self, key: tuple[str, int], reqs: list[_Request],
                       arr: np.ndarray) -> np.ndarray:
        """ABFT gate for one deliverable batch: check, then on detected
        corruption re-execute up to ``retry_cap`` times with exponential
        backoff; exhausted retries trip the bucket's circuit breaker and
        re-run once on the clean route. Raises RuntimeError only if even
        the fallback route fails its check: no corrupted batch is ever
        delivered."""
        payloads = [r.payload for r in reqs]
        bs = self._bucket_stats[key]
        verdict = self._bound[key].integrity(payloads, arr)
        bs.checked += 1
        if verdict.ok:
            return arr
        bs.corrupted += 1
        for attempt in range(self.retry_cap):
            time.sleep(self.retry_backoff_s * (2 ** attempt))
            bs.retried += 1
            arr = self._delivered(self._dispatch(key, reqs))
            verdict = self._bound[key].integrity(payloads, arr)
            bs.checked += 1
            if verdict.ok:
                return arr
            bs.corrupted += 1
        bs.fell_back += 1
        bound = self._trip_breaker(key)
        arr = self._delivered(self._dispatch(key, reqs))
        verdict = bound.integrity(payloads, arr)
        bs.checked += 1
        if not verdict.ok:
            bs.corrupted += 1
            raise RuntimeError(
                f"integrity check still failing after circuit-breaker "
                f"fallback for {key[0]}/n={key[1]}: "
                f"{verdict.detail or verdict.check}")
        return arr

    def _trip_breaker(self, key: tuple[str, int]) -> op_registry.BoundOp:
        """Open the bucket's circuit breaker: re-bind on a ``pim_ok=False``
        context (the cost model marks the PIM backend infeasible for this
        bucket from now on) and quarantine the bucket's simulated array to
        a spare. The new bound is CLEAN: no injector draws for it."""
        op, n = key
        with self._bind_lock:
            ctx = dataclasses.replace(self.ctx, pim_ok=False)
            bound = op_registry.get_op(op).bind(
                n, ctx, batch=self.max_batch, strict=self._strict[key],
                device=self.device)
            self._bound[key] = bound
            self._breaker_open.add(key)
            inj = self._injectors.pop(key, None)
            if inj is not None:
                try:
                    self.fault_model.quarantine(inj.array_id)
                except SparesExhausted:
                    pass    # breaker still isolates the bucket via re-bind
        return bound

    def _resolve(self, key: tuple[str, int], reqs: list[_Request],
                 flight: _Flight) -> None:
        """Wait for a dispatched batch, gate it (``verified``), and record
        results and latencies."""
        arr = self._delivered(flight)
        if self.verified:
            arr = self._verified_rows(key, reqs, arr)
        t_done = time.perf_counter()
        if arr.shape[0] != len(reqs):
            raise RuntimeError(f"batch executed at {arr.shape[0]} rows for "
                               f"{len(reqs)} requests")
        for j, req in enumerate(reqs):
            self.results[req.rid] = arr[j]
            self._latencies_s.append(t_done - req.t_submit)
        stats = self._bucket_stats[key]
        stats.served += len(reqs)
        stats.batches += 1
        stats.batch_sizes.append(len(reqs))
        self._served += len(reqs)

    # -- the serve loop -----------------------------------------------------

    def request_stop(self) -> None:
        """SIGTERM path: stop ADMITTING (submit raises
        :class:`EngineStopped`) but keep serving: ``run`` drains every
        already-admitted request, resolves the batch in flight, and
        returns. The caller then ``snapshot``s and warm-restarts."""
        with self._cv:
            self._stopping = True
            self._cv.notify_all()

    @property
    def stopping(self) -> bool:
        return self._stopping

    def run(self, total_requests: int) -> dict:
        """Serve until ``total_requests`` requests have completed in this
        engine instance (lifetime counters from before a warm restart do
        not count), or, after ``request_stop``, until the admitted backlog
        has drained.

        One batch is kept in flight: batch k+1 is staged and launched
        before batch k is waited for. Each batch's dispatch -> on-host time,
        less the scheduler's idle wait for arrivals meanwhile, feeds the
        straggler watchdog. Returns the stats dict (``stats``).
        """
        t0 = time.perf_counter()
        busy_s = 0.0
        inflight: tuple | None = None

        def finish(flight) -> float:
            key, reqs, launched, idle0 = flight
            tb = time.perf_counter()
            self._resolve(key, reqs, launched)
            t_done = time.perf_counter()
            self._batch_idx += 1
            self.watchdog.observe(self._batch_idx,
                                  t_done - launched.t_dispatch
                                  - (self._idle_s - idle0))
            self._bucket_stats[key].service_s += t_done - launched.t_dispatch
            return t_done - tb

        while self._served < total_requests:
            if self._stopping and self._pending == 0:
                break   # drained: nothing left to admit or schedule
            picked = self._pop_batch(
                0.0 if self._stopping else self.collect_timeout_s)
            if picked is None:
                if inflight is not None:
                    busy_s += finish(inflight)
                    inflight = None
                continue
            key, reqs = picked
            tb = time.perf_counter()
            idle0 = self._idle_s
            launched = self._dispatch(key, reqs)
            if inflight is not None:
                finish(inflight)
            busy_s += time.perf_counter() - tb
            inflight = (key, reqs, launched, idle0)
        if inflight is not None:
            busy_s += finish(inflight)
        return self.stats(seconds=time.perf_counter() - t0, busy_s=busy_s)

    # -- metrics ------------------------------------------------------------

    def _latency_record(self) -> list[float]:
        """The carried and this generation's samples, the most recent
        ``LATENCY_WINDOW``."""
        return (self._prev_latencies_s
                + list(self._latencies_s))[-LATENCY_WINDOW:]

    def stats(self, *, seconds: float, busy_s: float) -> dict:
        lat = np.asarray(self._latency_record(), np.float64) * 1e3
        if lat.size:
            p50, p90, p99 = np.percentile(lat, [50, 90, 99])
            latency_ms = {"p50": float(p50), "p90": float(p90),
                          "p99": float(p99), "mean": float(lat.mean()),
                          "max": float(lat.max())}
        else:
            latency_ms = {"p50": 0.0, "p90": 0.0, "p99": 0.0,
                          "mean": 0.0, "max": 0.0}
        buckets = {}
        for key, bs in self._bucket_stats.items():
            op, n = key
            sizes = bs.batch_sizes
            entry = buckets[f"{op}/n={n}"] = {
                "op": op, "n": n, "served": bs.served,
                "lifetime_served": (self._prev_bucket_served.get(
                    f"{op}/{n}", 0) + bs.served),
                "batches": bs.batches,
                "route": self._bound[key].route,
                "max_block": self.max_batch,
                "mean_batch": (sum(sizes) / len(sizes)) if sizes else 0.0,
                # fill of the continuous-batching block: 1.0 means every
                # dispatch ran at the cap
                "utilization": (sum(sizes) / (len(sizes) * self.max_batch))
                               if sizes else 0.0,
                "batch_sizes": list(sizes),
                "observed_s_per_req": (bs.service_s / bs.served
                                       if bs.served else None),
                "expired": bs.expired,
                # ABFT ledger (all zeros when verified=False): the
                # detected -> retried -> fell_back recovery trajectory
                "integrity": {
                    "checked": bs.checked,
                    "corrupted": bs.corrupted,
                    "retried": bs.retried,
                    "fell_back": bs.fell_back,
                    "breaker_open": key in self._breaker_open,
                },
            }
            cost = self._bound[key].plan.cost
            if cost is not None and cost["best"] is not None:
                best = cost["best"]
                # the bind-time batch the plan was costed at
                per = max(1, cost["batch"])
                entry["predicted_s_per_req"] = best["total_s"] / per
                entry["predicted_tier"] = best["tier"]
                entry["predicted_backend"] = best["backend_best"]
        batches = sum(b.batches for b in self._bucket_stats.values())
        return {
            "device": str(self.device),
            "served": self._served,
            "batches": batches,
            # requests completed with a deadline_exceeded error (included
            # in ``served``, never in latency_ms)
            "expired": sum(b.expired for b in self._bucket_stats.values()),
            "seconds": seconds,
            "throughput_per_s": self._served / max(seconds, 1e-9),
            # busy-only rate: excludes queue-collection waits
            "compute_seconds": busy_s,
            "compute_throughput_per_s": self._served / max(busy_s, 1e-9),
            "latency_ms": latency_ms,
            "buckets": buckets,
            # counters carried across warm restarts (``from_snapshot``)
            "lifetime": {
                "served": self._prev_served + self._served,
                "batches": self._prev_batches + batches,
                "restarts": self.restarts,
            },
            "watchdog": {"events": list(self.watchdog.events),
                         "evictions": list(self.evictions),
                         "ewma_s": self.watchdog.ewma},
        }

    # -- snapshot / warm restart --------------------------------------------

    def snapshot(self, ckpt_dir: str) -> str:
        """Persist the engine's durable state through ``ft.checkpoint``.

        Must be called DRAINED (after ``request_stop`` + ``run`` returned):
        a snapshot with admitted-but-unserved requests would silently drop
        them on restart, so pending requests are a hard error. The saved
        tree carries the recent latency record (``LATENCY_WINDOW``); the
        manifest ``extra`` carries bucket config (op, n, strict), engine
        knobs, counters and the watchdog state. Results themselves are not
        snapshotted: delivered results belong to the clients that
        collected them.
        """
        if self._pending:
            raise RuntimeError(
                f"snapshot with {self._pending} pending requests would "
                f"drop them: request_stop() and let run() drain first")
        extra = {
            "schema": SNAPSHOT_SCHEMA,
            "engine": {"max_batch": self.max_batch,
                       "max_pending": self.max_pending,
                       "collect_timeout_s": self.collect_timeout_s,
                       "modulus_bits": self.ctx.modulus_bits,
                       "model_shards": self.ctx.model_shards,
                       "auto": self.ctx.auto,
                       "verified": self.verified},
            "buckets": [{"op": op, "n": n, "strict": self._strict[(op, n)]}
                        for op, n in self._bound],
            "counters": {
                "served": self._prev_served + self._served,
                "batches": self._prev_batches
                           + sum(b.batches for b in
                                 self._bucket_stats.values()),
                "next_rid": self._next_rid,
                "restarts": self.restarts,
                "bucket_served": {
                    f"{op}/{n}": (self._prev_bucket_served.get(
                        f"{op}/{n}", 0) + self._bucket_stats[(op, n)].served)
                    for op, n in self._bound},
            },
            "watchdog": self.watchdog.state_dict(),
        }
        return ckpt_lib.save(
            ckpt_dir, self._prev_served + self._served,
            {"latencies_s": np.asarray(self._latency_record(), np.float64)},
            extra=extra)

    @classmethod
    def from_snapshot(cls, ckpt_dir: str, *,
                      model_shards: int | None = None,
                      max_batch: int | None = None,
                      watchdog_cfg: Optional[WatchdogConfig] = None,
                      on_evict: Optional[Callable[["ServeEngine", int],
                                                  None]] = None,
                      device: str | torch.device | None = None
                      ) -> "ServeEngine":
        """Warm-restart from ``snapshot``: rebuild the engine on ``device``,
        re-register and re-BIND every bucket on the restart-time context
        (``model_shards`` resizes it: the resize leg of the watchdog's
        checkpoint -> resize -> restore path), and carry the lifetime
        counters, latency record and watchdog baseline over."""
        step = ckpt_lib.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no engine snapshot under {ckpt_dir}")
        extra = ckpt_lib.read_extra(ckpt_dir, step)
        if extra.get("schema") != SNAPSHOT_SCHEMA:
            raise ValueError(
                f"{ckpt_dir} step {step} is not an engine snapshot "
                f"(schema={extra.get('schema')!r})")
        restored = ckpt_lib.restore(
            ckpt_dir, step, {"latencies_s": np.zeros(0, np.float64)})
        eng_cfg = extra["engine"]
        engine = cls(
            max_batch=max_batch or eng_cfg["max_batch"],
            max_pending=eng_cfg["max_pending"],
            collect_timeout_s=eng_cfg["collect_timeout_s"],
            modulus_bits=eng_cfg["modulus_bits"],
            model_shards=(eng_cfg["model_shards"] if model_shards is None
                          else model_shards),
            auto=bool(eng_cfg.get("auto", False)),
            verified=bool(eng_cfg.get("verified", False)),
            watchdog_cfg=watchdog_cfg, on_evict=on_evict, device=device)
        for b in extra["buckets"]:
            engine.register(b["op"], int(b["n"]), strict=bool(b["strict"]))
        counters = extra["counters"]
        engine._prev_served = int(counters["served"])
        engine._prev_batches = int(counters["batches"])
        engine._prev_bucket_served = dict(counters["bucket_served"])
        engine._next_rid = int(counters["next_rid"])
        engine.restarts = int(counters["restarts"]) + 1
        engine._prev_latencies_s = [
            float(v) for v in restored["latencies_s"]]
        engine.watchdog.load_state_dict(extra.get("watchdog", {}))
        return engine

    def elastic_restart(self, ckpt_dir: str, *,
                        model_shards: int | None = None,
                        max_batch: int | None = None) -> "ServeEngine":
        """The on_evict path in one move: snapshot this (drained) engine,
        then warm-restart it with a resized context on the same device.
        Returns the NEW engine; this one stays stopped."""
        self.snapshot(ckpt_dir)
        return ServeEngine.from_snapshot(
            ckpt_dir, model_shards=model_shards, max_batch=max_batch,
            watchdog_cfg=self.watchdog.cfg, on_evict=self._user_on_evict,
            device=self.device)
