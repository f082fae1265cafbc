"""Traffic: seeded schedules and the clients that send them.

A traffic file names its generator by ``kind``:

* ``closed_loop``: ``clients`` threads, each sending its next request
  when the last one has returned (callers that wait for their reply);
* ``open_loop``: one sender that sends each request when it is due,
  whatever the server does (independent users); arrivals ``poisson`` at
  ``requests_per_s``.

Request sizes come from ``sizes``: ``{"dist": "log_uniform", "lo",
"hi", "levels"}`` or ``{"dist": "uniform_int", "lo", "hi"}``.  Every
seed gets the same sizes and the same gaps between arrivals, in another
order: a size block holds each size level once (log-uniform quantiles,
or every integer of the range) and a gap block the quantiles of the
exponential distribution, scaled to the rate; the seed shuffles each
block anew.  So the seed changes the order of the work and the data,
never its amount.

Latency is taken on the client's side.  An open-loop request is timed
from the moment it was due on the schedule to the moment its result is
in the client's hands (the future's completion), so a stall also counts
against every request due behind it; a request that fails, is refused
or never returns is a miss, above every success.
"""
from __future__ import annotations

import math
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

GAP_BLOCK = 1024          # arrivals whose gaps are one shuffled block


def size_levels(sizes: Dict) -> List[int]:
    """One block of request sizes, each level once."""
    lo, hi = int(sizes["lo"]), int(sizes["hi"])
    if not 1 <= lo <= hi:
        raise ValueError(f"sizes need 1 <= lo <= hi, got {lo}, {hi}")
    if sizes["dist"] == "uniform_int":
        return list(range(lo, hi + 1))
    if sizes["dist"] == "log_uniform":
        n = int(sizes["levels"])
        qs = (np.arange(n) + 0.5) / n
        return [int(round(v)) for v in np.exp(np.log(lo) + qs *
                                              (np.log(hi) - np.log(lo)))]
    raise ValueError(f"unknown size distribution {sizes['dist']!r}")


def max_size(sizes: Dict) -> int:
    return int(sizes["hi"])


def exp_gaps(rate: float, n: int = GAP_BLOCK) -> np.ndarray:
    """``n`` gaps at the exponential distribution's mid-quantiles,
    scaled so that their mean is exactly ``1 / rate``."""
    q = (np.arange(n) + 0.5) / n
    g = -np.log1p(-q)
    return g / g.mean() / rate


class SizeStream:
    """Sizes and pool offsets for one client: the size block, shuffled
    anew for each pass by the client's generator."""

    def __init__(self, levels: Sequence[int], pool_rows: int,
                 rng: np.random.Generator):
        self.levels = np.asarray(levels)
        self.pool_rows = pool_rows
        self.rng = rng
        self._block: List[int] = []

    def next(self) -> Tuple[int, int]:
        if not self._block:
            self._block = list(self.rng.permutation(self.levels))
        n = int(self._block.pop())
        off = int(self.rng.integers(0, self.pool_rows - n + 1))
        return off, n


def open_schedule(traffic: Dict, rate: float, horizon_s: float,
                  pool_rows: int, rng: np.random.Generator
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Due times (seconds from the start), sizes and offsets of every
    arrival within ``horizon_s``."""
    if traffic.get("arrivals", "poisson") != "poisson":
        raise ValueError(f"unknown arrivals {traffic['arrivals']!r}")
    gaps: List[np.ndarray] = []
    total = 0.0
    while total < horizon_s:
        g = rng.permutation(exp_gaps(rate))
        gaps.append(g)
        total += float(g.sum())
    due = np.cumsum(np.concatenate(gaps))
    due = due[due < horizon_s]
    stream = SizeStream(size_levels(traffic["sizes"]), pool_rows, rng)
    offs, sizes = zip(*(stream.next() for _ in range(len(due))))
    return due, np.asarray(sizes), np.asarray(offs)


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q``
    of the values at or below it (``inf`` for a miss sorts last)."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    return s[max(0, math.ceil(q * len(s)) - 1)]


class Sampler:
    """A seeded uniform sample of ``k`` answered requests (reservoir
    sampling over the answers as they come), plus the largest request:
    what the check compares once the window has closed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 0x5A17])
        self.lock = threading.Lock()
        self.seen = 0
        self.items: List[Tuple[int, int, Any]] = []
        self.longest: Optional[Tuple[int, int, Any]] = None

    def offer(self, off: int, n: int, y: Any) -> None:
        with self.lock:
            self.seen += 1
            if len(self.items) < self.k:
                self.items.append((off, n, y))
            else:
                j = int(self.rng.integers(self.seen))
                if j < self.k:
                    self.items[j] = (off, n, y)
            if self.longest is None or n > self.longest[1]:
                self.longest = (off, n, y)

    def sample(self) -> List[Tuple[int, int, Any]]:
        with self.lock:
            out = list(self.items)
            if self.longest is not None and \
                    not any(it is self.longest for it in out):
                out.append(self.longest)
            return out


@dataclass
class Outcome:
    """What the clients saw of the window ``[t0, t1)``."""
    attempted: int = 0              # requests sent (closed) or due (open)
    failed: int = 0                 # of those: raised, refused or lost
    images: int = 0                 # images whose result came in the window
    requests_done: int = 0          # requests whose result came in it
    latencies_s: List[float] = field(default_factory=list)  # open loop
    lateness_s: List[float] = field(default_factory=list)   # open loop
    # (time, images) of each answer that came in the window
    answers: List[Tuple[float, int]] = field(default_factory=list)
    errors: Dict[str, int] = field(default_factory=dict)

    def error(self, e: BaseException) -> None:
        k = type(e).__name__
        self.errors[k] = self.errors.get(k, 0) + 1


class ClosedLoop:
    """``clients`` callers, each sending its next request the moment its
    last one has returned, from ``start()`` on.  A caller is a chain of
    callbacks on the answers' futures, not a thread: the run's host
    threads stay the server's own, so the clients take no share of the
    interpreter lock beyond the submit itself."""

    def __init__(self, system: Any, traffic: Dict, seed: int,
                 sampler: Sampler):
        self.system = system
        self.sampler = sampler
        levels = size_levels(traffic["sizes"])
        self.streams = [SizeStream(levels, system.pool_rows,
                                   np.random.default_rng([seed, 1, c]))
                        for c in range(int(traffic["clients"]))]
        self.cond = threading.Condition()
        self.out = Outcome()
        self.busy = 0                  # callers with a request out
        self.t0 = self.t1 = self.until = math.inf

    def start(self, t0: float, t1: float, until: Optional[float] = None
              ) -> None:
        """Send until ``until`` (default ``t1``); the window is ``[t0,
        t1)``."""
        self.t0, self.t1 = t0, t1
        self.until = t1 if until is None else until
        for stream in self.streams:
            self._send(stream)

    def _send(self, stream: SizeStream) -> None:
        """The caller's next request, unless its time is up; a request
        refused at once is a failure, and the caller tries the next."""
        while True:
            t_sent = time.perf_counter()
            if t_sent >= self.until:
                return
            off, n = stream.next()
            counted = self.t0 <= t_sent < self.t1
            with self.cond:
                self.busy += 1
                if counted:
                    self.out.attempted += 1
            try:
                fut = self.system.submit(self.system.payload(off, n))
            except Exception as e:
                self._settle(counted, e)
                continue
            fut.add_done_callback(
                lambda f, st=stream, off=off, n=n, c=counted:
                self._done(f, st, off, n, c))
            return

    def _done(self, fut: Future, stream: SizeStream, off: int, n: int,
              counted: bool) -> None:
        t_done = time.perf_counter()
        exc = fut.exception()
        if exc is not None:
            self._settle(counted, exc)
        else:
            in_window = self.t0 <= t_done < self.t1
            if in_window:
                self.sampler.offer(off, n, fut.result())
            with self.cond:
                self.busy -= 1
                if in_window:
                    self.out.images += n
                    self.out.requests_done += 1
                    self.out.answers.append((t_done, n))
                self.cond.notify_all()
        self._send(stream)

    def _settle(self, counted: bool, exc: BaseException) -> None:
        with self.cond:
            self.busy -= 1
            if counted:
                self.out.failed += 1
            self.out.error(exc)
            self.cond.notify_all()

    def finish(self, give_up: float) -> Outcome:
        """Wait for every caller's last request (until ``give_up``); one
        still out then is lost, and counts as failed."""
        with self.cond:
            self.cond.wait_for(lambda: self.busy == 0,
                               timeout=max(0.0, give_up - time.perf_counter()))
            self.out.failed += self.busy
            return self.out


class OpenLoop:
    """One sender thread that sends each arrival when it is due, from
    ``start()`` on; requests due in ``[t0, t1)`` are the window's.

    Nothing of an answer is kept but its time (and, for the sampled
    ones, the answer itself): a run holds tens of thousands of requests,
    and holding their futures would hold their results and grow the
    collector's work with the run."""

    def __init__(self, system: Any, traffic: Dict, seed: int,
                 sampler: Sampler, rate: Optional[float] = None):
        self.system = system
        self.traffic = traffic
        self.rate = float(rate if rate is not None
                          else traffic["requests_per_s"])
        self.seed = seed
        self.sampler = sampler
        self.cond = threading.Condition()
        self.out = Outcome()
        self.sent = self.answered = self.pending = 0
        self.thread: Optional[threading.Thread] = None

    def start(self, t_start: float, t0: float, t1: float,
              until: Optional[float] = None) -> None:
        """Send from ``t_start`` until ``until`` (default ``t1``); the
        requests due in ``[t0, t1)`` are the window's."""
        until = t1 if until is None else until
        due, self.sizes, self.offs = open_schedule(
            self.traffic, self.rate, until - t_start, self.system.pool_rows,
            np.random.default_rng([self.seed, 2]))
        self.t0, self.t1 = t0, t1
        self.due = t_start + due
        self.done = np.full(len(due), math.nan)     # answer time; inf: miss
        self.in_window = (self.due >= t0) & (self.due < t1)
        self.pending = int(self.in_window.sum())
        self.thread = threading.Thread(target=self._send, daemon=True)
        self.thread.start()

    def outstanding(self) -> int:
        """Requests sent and not yet answered (the backlog)."""
        with self.cond:
            return self.sent - self.answered

    def _send(self) -> None:
        for i in range(len(self.due)):
            wait_s = self.due[i] - time.perf_counter()
            if wait_s > 0:
                time.sleep(wait_s)
            t_sent = time.perf_counter()
            with self.cond:
                self.sent += 1
                if self.in_window[i]:
                    self.out.lateness_s.append(t_sent - self.due[i])
            n, off = int(self.sizes[i]), int(self.offs[i])
            try:
                fut = self.system.submit(self.system.payload(off, n))
            except Exception as e:        # refused: a miss
                self._answer(i, math.inf, e)
                continue
            fut.add_done_callback(lambda f, i=i: self._done(i, f))

    def _done(self, i: int, fut: Future) -> None:
        t = time.perf_counter()
        exc = fut.exception()
        if exc is None and self.in_window[i]:
            self.sampler.offer(int(self.offs[i]), int(self.sizes[i]),
                               fut.result())
        self._answer(i, t if exc is None else math.inf, exc)

    def _answer(self, i: int, t: float, exc: Optional[BaseException]
                ) -> None:
        with self.cond:
            self.done[i] = t
            self.answered += 1
            if exc is not None:
                self.out.error(exc)
            if self.t0 <= t < self.t1:
                self.out.images += int(self.sizes[i])
                self.out.requests_done += 1
                self.out.answers.append((t, int(self.sizes[i])))
            if self.in_window[i]:
                self.pending -= 1
                if self.pending == 0:
                    self.cond.notify_all()

    def finish(self, give_up: float) -> Outcome:
        """Wait for every request due in the window (until ``give_up``),
        then time them all: one never answered is a miss."""
        if self.thread is not None:
            self.thread.join()
        with self.cond:
            self.cond.wait_for(lambda: self.pending == 0,
                               timeout=max(0.0, give_up - time.perf_counter()))
            done = self.done[self.in_window]
            lat = done - self.due[self.in_window]
            lat[np.isnan(lat)] = math.inf
            self.out.attempted = int(len(lat))
            self.out.failed = int(np.isinf(lat).sum())
            self.out.latencies_s = lat.tolist()
            return self.out
