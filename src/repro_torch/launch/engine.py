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
    host's work on batch k+1 overlaps batch k on the card, and resolving
    batch k does not wait for batch k+1 (one batch in flight);
  * **oldest-head scheduling** -- among non-empty buckets the one whose
    head request has waited longest dispatches next;
  * **backpressure** -- ``submit`` blocks (or raises :class:`Backpressure`
    with ``block=False``) while ``max_pending`` requests are queued.

Metrics: per-request latency (submit -> result on the host) percentiles
p50/p90/p99, end-to-end and busy-only throughput, and per-bucket batch
sizes with utilization (mean dispatched batch / block cap).

Verified serving, fault injection, snapshot and warm restart, the
straggler watchdog and request deadlines come with the fault-tolerance
slice.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.launch import ops as op_registry

#: Latency samples kept for the percentiles: they describe recent service.
LATENCY_WINDOW = 4096
#: How long the scheduler waits for a request before it resolves the batch
#: in flight.
COLLECT_TIMEOUT_S = 0.05


class Backpressure(RuntimeError):
    """Admission rejected: the bounded request queue is full."""


@dataclasses.dataclass
class _Request:
    rid: int
    payload: Any
    t_submit: float


@dataclasses.dataclass
class _BucketStats:
    served: int = 0
    batches: int = 0
    batch_sizes: list = dataclasses.field(default_factory=list)
    # accumulated dispatch -> on-host seconds of this bucket's batches
    service_s: float = 0.0


@dataclasses.dataclass
class _Flight:
    """A dispatched batch: ``host`` holds its outputs once ``done`` has
    passed (at once on the CPU, where ``done`` is None)."""
    key: tuple[str, int]
    reqs: list[_Request]
    host: torch.Tensor
    done: torch.cuda.Event | None
    t_dispatch: float


class ServeEngine:
    """Multiplexing continuous-batching executor for registry ops.

    ``max_batch`` caps one dispatch; ``max_pending`` bounds the admission
    queue across all buckets. The process-level ``modulus_bits`` /
    ``model_shards`` context feeds each op through ``OpSpec.narrow`` unless
    a bucket is registered with ``strict=True``. Every bucket runs on
    ``device``: CUDA unless the caller passes the CPU.
    """

    def __init__(self, *, max_batch: int = 64, max_pending: int = 1024,
                 modulus_bits: int | None = None, model_shards: int = 1,
                 device: str | torch.device | None = None):
        if max_batch < 1:
            raise ValueError(f"max_batch={max_batch} must be >= 1")
        if max_pending < 1:
            raise ValueError(f"max_pending={max_pending} must be >= 1")
        self.device = op_registry.resolve_device(device)
        self.max_batch = max_batch
        self.max_pending = max_pending
        self.ctx = op_registry.OpContext(modulus_bits=modulus_bits,
                                         model_shards=model_shards)
        self._bound: dict[tuple[str, int], op_registry.BoundOp] = {}
        self._bucket_stats: dict[tuple[str, int], _BucketStats] = {}
        self._buckets: dict[tuple[str, int], deque[_Request]] = {}
        self._bind_lock = threading.Lock()
        self._cv = threading.Condition()
        self._pending = 0
        self._served = 0
        self._next_rid = 0
        self.results: dict[int, np.ndarray] = {}
        self._latencies_s: deque[float] = deque(maxlen=LATENCY_WINDOW)

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
                self._buckets[key] = deque()
                self._bucket_stats[key] = _BucketStats()
            return self._bound[key]

    def bound(self, op: str, n: int) -> op_registry.BoundOp:
        return self.register(op, n)

    def warmup(self) -> None:
        """Run every registered bucket at each batch size a tail can round
        up to in the host's pinned-memory cache (the powers of two below
        the block cap, and the cap), so reported throughput is steady
        state: kernels built and loaded, buffers of every size cached."""
        sizes = {min(1 << k, self.max_batch)
                 for k in range(self.max_batch.bit_length() + 1)}
        for bound in list(self._bound.values()):
            for batch in sorted(sizes):
                bound.warmup(batch)

    # -- admission ----------------------------------------------------------

    def submit(self, op: str, n: int, payload, *, rid: int | None = None,
               block: bool = True, timeout: float | None = None) -> int:
        """Enqueue one request; returns its rid.

        Blocks while the bounded queue is full (``block=False`` raises
        :class:`Backpressure` instead). ``timeout`` bounds this call's wait
        for queue space.
        """
        bound = self.register(op, n)     # validates shape/route once
        bound.check_payload(payload)     # reject NaN/Inf before it batches
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._cv:
            while self._pending >= self.max_pending:
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
            self._buckets[bound.key].append(
                _Request(rid, payload, time.perf_counter()))
            self._pending += 1
            self._cv.notify_all()
        return rid

    # -- scheduling ---------------------------------------------------------

    def _pop_batch(self, timeout: float
                   ) -> tuple[tuple[str, int], list[_Request]] | None:
        """Take up to ``max_batch`` requests from the non-empty bucket whose
        head has waited longest; None if nothing arrives within timeout."""
        with self._cv:
            if not any(self._buckets.values()):
                self._cv.wait(timeout)
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
        """Stage and launch one batch at its ACTUAL size and queue the copy
        of its results to the host; on the card, record an event after that
        copy for the deferred sync."""
        t = time.perf_counter()
        bound = self._bound[key]
        host = bound.to_host(bound.execute([r.payload for r in reqs]))
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return _Flight(key, reqs, host, done, t)

    def _resolve(self, flight: _Flight) -> None:
        """Wait for a dispatched batch, run its route's host step (the RNS
        route's CRT), and record results and latencies."""
        if flight.done is not None:
            flight.done.synchronize()
        # an array of its own, so the pinned buffer returns to the cache
        arr = self._bound[flight.key].host_step(flight.host.numpy().copy())
        t_done = time.perf_counter()
        if arr.shape[0] != len(flight.reqs):
            raise RuntimeError(f"batch executed at {arr.shape[0]} rows for "
                               f"{len(flight.reqs)} requests")
        for j, req in enumerate(flight.reqs):
            self.results[req.rid] = arr[j]
            self._latencies_s.append(t_done - req.t_submit)
        stats = self._bucket_stats[flight.key]
        stats.served += len(flight.reqs)
        stats.batches += 1
        stats.batch_sizes.append(len(flight.reqs))
        stats.service_s += t_done - flight.t_dispatch
        self._served += len(flight.reqs)

    # -- the serve loop -----------------------------------------------------

    def run(self, total_requests: int) -> dict:
        """Serve until ``total_requests`` results have reached the host.

        One batch is kept in flight: batch k+1 is staged and launched
        before batch k is waited for. Returns the stats dict (``stats``).
        """
        t0 = time.perf_counter()
        busy_s = 0.0
        inflight: _Flight | None = None
        while self._served < total_requests:
            picked = self._pop_batch(COLLECT_TIMEOUT_S)
            if picked is None:
                if inflight is not None:
                    tb = time.perf_counter()
                    self._resolve(inflight)
                    busy_s += time.perf_counter() - tb
                    inflight = None
                continue
            tb = time.perf_counter()
            flight = self._dispatch(*picked)
            if inflight is not None:
                self._resolve(inflight)
            busy_s += time.perf_counter() - tb
            inflight = flight
        if inflight is not None:
            tb = time.perf_counter()
            self._resolve(inflight)
            busy_s += time.perf_counter() - tb
        return self.stats(seconds=time.perf_counter() - t0, busy_s=busy_s)

    # -- metrics ------------------------------------------------------------

    def stats(self, *, seconds: float, busy_s: float) -> dict:
        lat = np.asarray(self._latencies_s, np.float64) * 1e3
        if lat.size:
            p50, p90, p99 = np.percentile(lat, [50, 90, 99])
            latency_ms = {"p50": float(p50), "p90": float(p90),
                          "p99": float(p99), "mean": float(lat.mean()),
                          "max": float(lat.max())}
        else:
            latency_ms = {"p50": 0.0, "p90": 0.0, "p99": 0.0,
                          "mean": 0.0, "max": 0.0}
        buckets = {}
        for (op, n), bs in self._bucket_stats.items():
            sizes = bs.batch_sizes
            buckets[f"{op}/n={n}"] = {
                "op": op, "n": n, "served": bs.served,
                "batches": bs.batches,
                "route": self._bound[(op, n)].route,
                "max_block": self.max_batch,
                "mean_batch": (sum(sizes) / len(sizes)) if sizes else 0.0,
                # fill of the continuous-batching block: 1.0 means every
                # dispatch ran at the cap
                "utilization": (sum(sizes) / (len(sizes) * self.max_batch))
                               if sizes else 0.0,
                "batch_sizes": list(sizes),
                "observed_s_per_req": (bs.service_s / bs.served
                                       if bs.served else None),
            }
        return {
            "device": str(self.device),
            "served": self._served,
            "batches": sum(b.batches for b in self._bucket_stats.values()),
            "seconds": seconds,
            "throughput_per_s": self._served / max(seconds, 1e-9),
            # busy-only rate: excludes queue-collection waits
            "compute_seconds": busy_s,
            "compute_throughput_per_s": self._served / max(busy_s, 1e-9),
            "latency_ms": latency_ms,
            "buckets": buckets,
        }
