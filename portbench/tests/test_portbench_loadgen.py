"""The load generator's schedule, sample and loops (on the CPU)."""
from __future__ import annotations

import collections

import numpy as np

from portbench.lib import loadgen


def test_schedule_is_the_same_for_one_seed_and_differs_for_two():
    a = loadgen.schedule(600.0, 10.0, 2**31 + 7)
    assert np.array_equal(a, loadgen.schedule(600.0, 10.0, 2**31 + 7))
    assert not np.array_equal(a, loadgen.schedule(600.0, 10.0, 2**31 + 8))


def test_every_seed_offers_the_same_gaps_at_the_rate():
    g = loadgen.gaps(500.0, 20.0)
    assert len(g) == 10_000 and np.all(np.diff(g) > 0)
    for seed in (1, 2):
        due = loadgen.schedule(500.0, 20.0, seed)
        assert len(due) == 10_000 and due[0] == 0
        d = np.diff(due)
        i = np.clip(np.searchsorted(g, d), 1, len(g) - 1)
        near = np.minimum(abs(g[i] - d), abs(g[i - 1] - d))
        assert near.max() < 1e-9           # every gap is one of the set
        assert abs(due[-1] - 20.0) < 0.1
    # exponential: the mean gap is 1/rate and the gaps' spread equals it
    assert abs(g.mean() * 500 - 1) < 0.01
    assert abs(g.std() * 500 - 1) < 0.05


def test_huge_and_negative_seeds_are_accepted():
    for seed in (2**33 + 5, -3):
        assert len(loadgen.schedule(10.0, 1.0, seed)) == 10


def test_reservoir_keeps_a_uniform_sample_from_the_seed():
    hits = collections.Counter()
    for seed in range(2000):
        keep = loadgen.Reservoir(4, seed)
        for i in range(40):
            keep.offer(i, i % 3, i)
        kept = keep.sample()
        assert len(kept) == 4 and [k[0] for k in kept] == sorted(
            k[0] for k in kept)
        hits.update(k[0] for k in kept)
    assert min(hits.values()) > 0.7 * 200 and max(hits.values()) < 1.3 * 200
    a, b = loadgen.Reservoir(4, 9), loadgen.Reservoir(4, 9)
    for i in range(100):
        a.offer(i, 0, i)
        b.offer(i, 0, i)
    assert a.sample() == b.sample()


def test_closed_and_open_loops_record_every_request():
    calls = []
    fn = lambda x: calls.append(x) or x  # noqa: E731
    keep = loadgen.Reservoir(2, 0)
    win = loadgen.run_closed(fn, [(1,), (2,)], products=4, seconds=0.05,
                             depth=3, sync=loadgen.HostSync(), keep=keep)
    assert win.requests == len(calls) and win.products == 4 * len(calls)
    assert win.missing == 0 and win.window_s >= 0.05
    due = loadgen.schedule(400.0, 0.1, 3)
    win = loadgen.run_open(fn, [(1,), (2,)], products=4, due=due,
                           sync=loadgen.HostSync(),
                           keep=loadgen.Reservoir(2, 0))
    assert win.requests == len(due) and win.missing == 0
    assert all(s >= t for t, s in zip(win.due, win.dispatch_start))
    assert all(d >= e for d, e in zip(win.done, win.dispatch_end))


def test_nearest_rank():
    vals = list(range(1, 101))
    assert loadgen.nearest_rank(vals, 0.95) == 95
    assert loadgen.nearest_rank(vals[:10], 0.95) == 10
    assert loadgen.nearest_rank([1.0, float("inf")], 0.95) == float("inf")
