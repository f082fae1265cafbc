"""The seeded generators repeat exactly, give every seed the same work
in another order, and the latency arithmetic times open-loop requests
from their due time and counts a failure as a miss."""
from __future__ import annotations

import math
import time
from concurrent.futures import Future

import numpy as np
import pytest

from portbench import clients

OPEN = {"kind": "open_loop", "arrivals": "poisson", "requests_per_s": 100,
        "sizes": {"dist": "uniform_int", "lo": 1, "hi": 8}}


def test_open_schedule_repeats_for_a_seed():
    a = clients.open_schedule(OPEN, 1000.0, 3.0, 64,
                              np.random.default_rng([2**31 + 5, 2]))
    b = clients.open_schedule(OPEN, 1000.0, 3.0, 64,
                              np.random.default_rng([2**31 + 5, 2]))
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_every_seed_sends_the_same_work_in_another_order():
    rate = 500.0
    horizon = clients.GAP_BLOCK / rate * 0.999
    runs = [clients.open_schedule(OPEN, rate, 10 * horizon, 64,
                                  np.random.default_rng([s, 2]))
            for s in (1, 2)]
    (due1, n1, _), (due2, n2, _) = runs
    # whole gap blocks: the same gaps, shuffled
    g1, g2 = np.diff(due1[:clients.GAP_BLOCK + 1]), \
        np.diff(due2[:clients.GAP_BLOCK + 1])
    assert not np.array_equal(g1, g2)
    assert np.allclose(np.sort(np.diff(np.concatenate([[0], due1]))
                               [:clients.GAP_BLOCK]),
                       np.sort(np.diff(np.concatenate([[0], due2]))
                               [:clients.GAP_BLOCK]))
    # whole size blocks: each size equally often
    k = 8 * (min(len(n1), len(n2)) // 8)
    assert np.array_equal(np.bincount(n1[:k]), np.bincount(n2[:k]))
    assert not np.array_equal(n1[:k], n2[:k])


def test_gaps_mean_is_the_rate():
    assert clients.exp_gaps(250.0).mean() == pytest.approx(1 / 250.0)


def test_size_levels():
    assert clients.size_levels({"dist": "uniform_int", "lo": 1,
                                "hi": 8}) == list(range(1, 9))
    lv = clients.size_levels({"dist": "log_uniform", "lo": 256,
                              "hi": 2048, "levels": 64})
    assert len(lv) == 64 and 256 <= min(lv) and max(lv) <= 2048
    assert lv == sorted(lv)


def test_closed_loop_streams_repeat():
    a = clients.SizeStream([1, 2, 3, 4], 100, np.random.default_rng([9, 1]))
    b = clients.SizeStream([1, 2, 3, 4], 100, np.random.default_rng([9, 1]))
    sa = [a.next() for _ in range(12)]
    assert sa == [b.next() for _ in range(12)]
    assert sorted(n for _, n in sa[:4]) == [1, 2, 3, 4]


def test_percentile_counts_a_miss_above_every_success():
    lat = [0.001 * i for i in range(1, 20)] + [math.inf]
    assert clients.percentile(lat, 0.95) == pytest.approx(0.019)
    assert math.isinf(clients.percentile(lat + [math.inf], 0.95))
    assert clients.percentile([3.0, 1.0, 2.0], 0.5) == 2.0


class _Late:
    """A server that answers every request 20 ms after it is sent and
    fails every fifth."""

    pool_rows = 64

    def __init__(self):
        self.i = 0

    def payload(self, off, n):
        return (off, n)

    def submit(self, x):
        import threading

        self.i += 1
        fut: Future = Future()
        fail = self.i % 5 == 0

        def answer():
            if fail:
                fut.set_exception(RuntimeError("boom"))
            else:
                fut.set_result(x)
        threading.Timer(0.02, answer).start()
        return fut


def test_open_loop_times_from_due_and_counts_failures():
    sampler = clients.Sampler(4, 0)
    loop = clients.OpenLoop(_Late(), OPEN, 3, sampler, rate=100.0)
    t = time.perf_counter()
    loop.start(t, t + 0.2, t + 1.2)
    out = loop.finish(t + 5.0)
    assert out.attempted > 50
    assert out.failed == pytest.approx(out.attempted / 5, abs=2)
    ok = [v for v in out.latencies_s if not math.isinf(v)]
    assert len(ok) + out.failed == out.attempted
    # timed from the due time: at least the server's 20 ms
    assert min(ok) >= 0.02
    assert math.isinf(clients.percentile(out.latencies_s, 0.95))
    assert sampler.sample()
