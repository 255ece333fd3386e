"""Synthetic deterministic token pipeline with host sharding + prefetch
(a numpy copy of ``repro.data.pipeline``, pinned to it by
``tests/test_torch_train.py``).

Each host generates only its shard of the global batch, deterministically
from (seed, step, host_id), so restarts resume exactly and elastic
re-sharding re-partitions the same logical stream; a background thread
prefetches ahead of the training loop so input latency overlaps compute.

The "dataset" is a synthetic integer-sequence language: spans of arithmetic
progressions with noise, giving a learnable next-token structure (loss
decreases) without external data.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class SyntheticLM:
    """Deterministic, restartable synthetic token stream."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, seed: int = 0, n_hosts: int = 1, host_id: int = 0):
        if global_batch % n_hosts:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {n_hosts} hosts")
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // n_hosts
        self.seed = seed
        self.host_id = host_id

    def batch_at(self, step: int) -> dict:
        """Batch for `step`, independent of history (pure function)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        b, s, v = self.local_batch, self.seq, self.vocab
        # arithmetic-progression spans: x[t] = (a + d*t) % v with occasional
        # re-draws -- predictable structure a model can learn
        starts = rng.integers(0, v, (b, 1))
        deltas = rng.integers(1, 7, (b, 1))
        t = np.arange(s + 1)[None, :]
        toks = (starts + deltas * t) % v
        noise = rng.random((b, s + 1)) < 0.02
        toks = np.where(noise, rng.integers(0, v, (b, s + 1)), toks)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of a batch iterator."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple[int, dict]:
        return self.q.get()

    def stop(self):
        self._stop.set()
        self.thread.join(timeout=2.0)
