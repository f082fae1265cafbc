"""Where BNNServer's host threads spend a flight: cumulative counters,
latency histograms and, when switched on, spans.

Three kinds of record, all on ``time.perf_counter_ns()``:

* :class:`HostTimes`, always on: for each boundary a flight crosses, how
  many times it was crossed and the ns spent inside it
  (``stats()["host_ns"]``).  The dispatcher's ``admit`` (first request
  taken to the launch decision, the admission window included),
  ``concat`` (the flight's rows joined into one payload), ``ahead_wait``
  (the dispatch-ahead semaphore) and ``launch`` (the semaphore's return
  to the last event record, the slot held); ``enqueue``, one per chunk
  on every path (its count is ``stats()["batches"]``); the completer's
  ``sync`` (``event.synchronize()``) and ``resolve`` (the sync's return
  to the slot's release: the gather and slicing, every
  ``future.set_result`` — which runs the callers' done-callbacks — and
  the watchdog).  Cumulative, so two snapshots give a window exactly.
* :class:`Histogram`, always on: count, sum and max of per-request
  durations, and buckets of a sixteenth of an octave that place a
  percentile within a few percent (``latency``: submit to result;
  ``queue_wait``: submit to the start of its flight's ``launch``, after
  the dispatch-ahead wait).
* :class:`SpanRecorder`, off until ``BNNServer.trace_spans(True)``: one
  :class:`Span` a boundary crossed, in a list per thread of at most
  ``SPAN_CAP`` records between two drains (more are counted as
  dropped).

Spans.  ``name`` is one of :data:`SPANS`; ``role`` the thread that
recorded it (:func:`role_of` its name: ``dispatcher``, ``completer``,
else ``caller``); ``flight`` the id the flight got once admitted, which
all of its spans share across threads, a request's ``queue`` span too.
The span that caused a span is the innermost span of the same flight
and thread that encloses it (each ``enqueue`` inside ``launch``; an
``enqueue`` of a re-execution inside ``recover``), and across threads
the flight's previous step: ``queue`` (each request) -> ``admit`` ->
``concat`` -> ``ahead_wait`` -> ``launch`` on the dispatcher, then
``sync`` -> ``resolve`` on the completer; ``recover`` wraps the recovery
ladder of a failed flight on whichever thread met the failure.
``tools/server_spans.py`` reads them all: the device's idle time
labelled by the dispatcher's and by the completer's span, each kind's
µs a flight, and a request's wait split at the moment it was taken.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, NamedTuple, Tuple

ADMIT = "admit"
AHEAD_WAIT = "ahead_wait"
LAUNCH = "launch"
ENQUEUE = "enqueue"
SYNC = "sync"
RESOLVE = "resolve"
QUEUE = "queue"
CONCAT = "concat"
RECOVER = "recover"
# the counted boundaries, in the order a flight crosses them
BOUNDARIES = (ADMIT, CONCAT, AHEAD_WAIT, LAUNCH, ENQUEUE, SYNC, RESOLVE)
SPANS = BOUNDARIES + (QUEUE, RECOVER)

DISPATCHER, COMPLETER, CALLER = "dispatcher", "completer", "caller"
# the names BNNServer gives its threads, by role
THREAD_NAMES = {DISPATCHER: "BNNServer-dispatcher",
                COMPLETER: "BNNServer-completer"}
_ROLE_OF_NAME = {v: k for k, v in THREAD_NAMES.items()}

SPAN_CAP = 1_000_000      # records kept a thread between two drains
_SUB_BITS = 4             # 2**4 buckets an octave
_SUB = 1 << _SUB_BITS
_BUCKETS = (64 - _SUB_BITS + 1) * _SUB   # every non-negative int64


def role_of(thread_name: str) -> str:
    return _ROLE_OF_NAME.get(thread_name, CALLER)


class Histogram:
    """Cumulative histogram of ns durations, with their count, sum and
    max.  A value below 16 has a bucket of its own; above, an octave
    ``[2**e, 2**(e+1))`` is cut into 16 buckets of equal width, so a
    bucket is at most a sixteenth of its lower edge wide."""

    __slots__ = ("buckets", "count", "sum_ns", "max_ns")

    def __init__(self) -> None:
        self.buckets = [0] * _BUCKETS
        self.count = 0
        self.sum_ns = 0
        self.max_ns = 0

    def add(self, ns: int) -> None:
        ns = max(ns, 0)
        shift = ns.bit_length() - 1 - _SUB_BITS
        self.buckets[ns if shift < 0 else
                     (shift + 1) * _SUB + (ns >> shift) - _SUB] += 1
        self.count += 1
        self.sum_ns += ns
        if ns > self.max_ns:
            self.max_ns = ns

    def copy(self) -> "Histogram":
        h = Histogram()
        h.buckets = list(self.buckets)
        h.count, h.sum_ns, h.max_ns = self.count, self.sum_ns, self.max_ns
        return h

    def percentile_ns(self, q: float) -> float:
        """An estimate of the nearest-rank ``q`` percentile: placed
        linearly inside its bucket (exact below 16 ns, else within a
        sixteenth of the value) and never above the max."""
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for b, n in enumerate(self.buckets):
            if n and seen + n >= rank:
                if b < _SUB:
                    return float(b)
                shift = b // _SUB - 1
                lo = (_SUB + b % _SUB) << shift
                return min(float(self.max_ns),
                           lo + (1 << shift) * (rank - seen) / n)
            seen += n
        return float(self.max_ns)

    def summary(self) -> Dict[str, object]:
        """``mean`` and ``max`` in seconds, exact; ``p50``/``p95``/
        ``p99`` in seconds, bucket estimates (``percentile_ns``); and
        the exact ``count`` and ``sum_ns`` a window's mean is taken
        from."""
        return {"mean": self.sum_ns / self.count / 1e9,
                "p50": self.percentile_ns(0.50) / 1e9,
                "p95": self.percentile_ns(0.95) / 1e9,
                "p99": self.percentile_ns(0.99) / 1e9,
                "max": self.max_ns / 1e9,
                "count": self.count, "sum_ns": self.sum_ns}


class HostTimes:
    """Per boundary of :data:`BOUNDARIES`: crossings and ns inside."""

    __slots__ = ("count", "total_ns")

    def __init__(self) -> None:
        self.count = dict.fromkeys(BOUNDARIES, 0)
        self.total_ns = dict.fromkeys(BOUNDARIES, 0)

    def add(self, name: str, ns: int) -> None:
        self.count[name] += 1
        self.total_ns[name] += ns

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        return {k: {"count": self.count[k], "total_ns": self.total_ns[k]}
                for k in BOUNDARIES}


class Span(NamedTuple):
    name: str
    role: str
    flight: int
    t0_ns: int
    t1_ns: int


class _Buffer:
    """One thread's records; only that thread appends and counts."""

    __slots__ = ("role", "records", "dropped", "reported")

    def __init__(self, role: str):
        self.role = role
        self.records: List[Tuple] = []
        self.dropped = 0
        self.reported = 0


class SpanRecorder:
    """Spans in a list per thread, lock-free on the recording side (a
    thread takes the recorder's lock once, for its first record)."""

    def __init__(self, cap: int = SPAN_CAP):
        self.cap = cap
        self._local = threading.local()
        self._buffers: List[_Buffer] = []
        self._lock = threading.Lock()

    def record(self, name: str, flight: int, t0_ns: int, t1_ns: int
               ) -> None:
        buf = getattr(self._local, "buf", None)
        if buf is None:
            buf = _Buffer(role_of(threading.current_thread().name))
            self._local.buf = buf
            with self._lock:
                self._buffers.append(buf)
        if len(buf.records) >= self.cap:
            buf.dropped += 1
        else:
            buf.records.append((name, buf.role, flight, t0_ns, t1_ns))

    def drain(self) -> Tuple[List[Span], int]:
        """Every span kept since the last drain, by start, and how many
        were dropped past the cap in that time; the lists are emptied
        (a span recorded meanwhile stays for the next drain)."""
        with self._lock:
            buffers = list(self._buffers)
        out: List[Tuple] = []
        dropped = 0
        for buf in buffers:
            n = len(buf.records)
            out.extend(buf.records[:n])
            del buf.records[:n]
            d = buf.dropped
            dropped += d - buf.reported
            buf.reported = d
        out.sort(key=lambda r: r[3])
        return [Span._make(r) for r in out], dropped

