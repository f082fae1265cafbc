"""BNNServer: continuously-batched, data-parallel, fault-tolerant
serving over the port's ``compile()`` (DESIGN.md §9 bucketing/sharding,
§10 continuous batching, §11 failure handling).

The counterpart of ``repro.serving.server``, with the same constructor
(less donation), ``submit``, ``apply_batch``, ``flush``,
``start``/``stop``, ``health`` and ``stats``.  The translations:

* **one CUDA graph per dispatch level** — where the reference jits
  ``CompiledBNN.apply`` once per (bucket, valid_rows) level, the port
  captures a :class:`~repro_torch.graph.replay.GraphedApply` per
  (bucket, valid_rows) level and replays it; ``jit_traces()`` counts
  the levels captured, at most ``trace_bound(max_batch, ragged=True)``
  (a request of another input kind is a payload error).
  ``prewarm=True`` first resolves the launch plan of every key those
  levels launch (``kernels.autotune.warm`` over
  ``compiled.tuning_keys_for_batches``: the tuning table, the rules and
  the fused stack's occupancy query, none of them inside a capture),
  then captures every ``dispatch_grid`` level at construction.  A
  replayed graph keeps the plan it was captured with: a tuning table
  changed afterwards changes no replay;
* **data-parallel sharding over a mesh** — ``mesh`` is a
  :class:`~repro_torch.launch.mesh.Mesh` whose slots may repeat a
  device (4 slots on one card run the split of 4 cards).  Where
  ``fit_spec`` splits a bucket over the data axes, its rows are cut into
  as many pieces, and piece *i* replays on its slot a graph of ``bucket
  // n`` rows with ``clamp(valid - i * bucket // n, 0, bucket // n)``
  valid rows; where the mesh does not divide the bucket (a 1- or 2-row
  bucket on 4 slots) the flight runs whole on the first slot, which is
  what replication computes.  The pieces are gathered on the first
  slot's device and sliced to the request's rows: bit for bit the
  single-device ``apply`` wherever the forward's sums do not depend on
  the batch (every binary layer; a float entry conv on integer images),
  and the ``apply`` of the pieces where they do (AlexNet's conv2, whose
  float sums cuDNN orders by the batch).  Each slot has its own
  streams, graph memory pool and graphs (``slots()``); the params and
  the CompiledBNN are placed once per distinct device.  A slot's graphs
  share its pool and replay in turn on its stream (a pool shared by the
  slots of a card would make all their replays run in turn), and one
  dispatch lock keeps each flight's copies, replays and output clones
  together, so the pieces of a flight run at once on their slots'
  streams, on one card or several;
* **streams and events for jax's async dispatch** — a flight's pieces
  are enqueued on their slots' ``torch.cuda.Stream``s and each records
  a ``torch.cuda.Event``; only the completer thread (or a synchronous
  ``apply_batch`` / ``flush`` caller) blocks, in ``event.synchronize()``,
  before a future resolves.  Results are ready for the device's default
  stream (their memory is recorded on it, so a caller freeing one can
  never hand it to a later flight while its own kernels still read it);
* **the caller's buffer is never written** — every flight copies its
  rows into the graph's static input buffer (or, on the degraded and
  CPU paths, pads into a fresh tensor), so there is no donation;
* **the degraded step** re-executes a flight whose kernels failed,
  eagerly, without a graph and whole on the first slot, counted in
  ``stats()["faults"]["backend_fallbacks"]``.  On the card it launches
  the same kernels again, one by one, through ``compiled.apply``: the
  port never gives way to a kernel's plain version there, so a flight
  that fails again climbs the rest of the ladder and ends in a typed
  ``BackendFault``.  On the CPU it runs
  ``compiled.with_backend(fallback_backend)``, the reference's
  fallback.  Backend faults are
  :class:`~repro_torch.serving.errors.BackendFault`, a refused kernel
  launch (``kernels._build.LaunchError``) and a CUDA error the runtime
  reports at synchronisation; such an error poisons the CUDA context,
  so it is neither retried nor bisected, and its requests fail with a
  typed ``BackendFault``.  Payload errors still reach bisection.  A graph whose capture fails raises
  :class:`~repro_torch.graph.replay.CaptureError` to its requests.

On the CPU (``device="cpu"``, as the tests run it) a flight pads and
runs ``apply`` synchronously, with the same bookkeeping.

Inputs are float ``[B, H, W, C]`` tensors for image specs or
``PackedArray [B, K]`` (packed on the last axis) for dense-entry specs;
outputs keep the compiled pipeline's type (float logits or a
PackedArray), always sliced back to the request's true row count.

Host timing (``serving/spans.py``): ``stats()["host_ns"]`` counts each
boundary a flight crosses and the ns spent inside it, ``latency_s`` and
``queue_wait_s`` summarise cumulative histograms over every request
since start, and ``trace_spans(True)`` records a span at each boundary
until ``trace_spans(False)``; ``spans()`` hands them back.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from queue import Empty, Queue
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.graph.replay import (CaptureError, GraphedApply, kind_of,
                                      rows_of, spec_kind, tensor_of)
from repro_torch.kernels._build import LaunchError
from repro_torch.kernels.autotune import warm
from repro_torch.kernels.packed import PackedArray, resolve_device
from repro_torch.runtime.sharding import BATCH_AXES, NamedSharding, fit_spec
from repro_torch.runtime.straggler import StepWatchdog, WatchdogConfig
from repro_torch.serving.bucketing import (
    bucket_for,
    dispatch_grid,
    pow2_ceil,
    ragged_valid,
    split_rows,
    trace_bound,
)
from repro_torch.serving.errors import (
    BackendFault,
    PoisonRequest,
    RequestTimeout,
    ServerOverloaded,
    ServingError,
)
from repro_torch.serving.placement import (check_mesh, replicate,
                                           shard_batch)
from repro_torch.serving.spans import (ADMIT, AHEAD_WAIT, COMPLETER, CONCAT,
                                       DISPATCHER, ENQUEUE, LAUNCH, QUEUE,
                                       RECOVER, RESOLVE, SYNC,
                                       THREAD_NAMES, Histogram, HostTimes,
                                       Span, SpanRecorder)

__all__ = ["BNNServer"]


def _pad_rows(x: Any, rows: int) -> Any:
    """Right-pad the batch axis to ``rows`` with zeros (zero words are
    all-(-1) under pm1; pad rows are masked off by ``valid_rows``).
    Returns ``x`` itself when already sized."""
    t = tensor_of(x)
    n = int(t.shape[0])
    if n == rows:
        return x
    t = torch.cat([t, t.new_zeros((rows - n, *t.shape[1:]))])
    return x.with_words(t) if isinstance(x, PackedArray) else t


def _slice_rows(x: Any, start: int, stop: int) -> Any:
    if isinstance(x, PackedArray):
        return x.with_words(x.words[start:stop])
    return x[start:stop]


def _to(x: Any, device: torch.device) -> Any:
    return x.with_words(x.words.to(device)) if isinstance(x, PackedArray) \
        else x.to(device)


def _with_index(device: torch.device) -> torch.device:
    """``device`` with its index (a bare "cuda" is the current card)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _concat_rows(xs: Sequence[Any]) -> Any:
    """Concatenate request payloads along the batch axis (PackedArray
    metadata must agree — same spec, so it always does)."""
    if len(xs) == 1:
        return xs[0]
    first = xs[0]
    if isinstance(first, PackedArray):
        meta = (first.length, first.axis, first.values)
        for x in xs[1:]:
            if (x.length, x.axis, x.values) != meta:
                raise ValueError("cannot coalesce differently-laid-out rows")
        return first.with_words(torch.cat([x.words for x in xs]))
    return torch.cat(list(xs))


def _is_kill(e: BaseException) -> bool:
    """A chaos-injected thread kill.  robustness/chaos.py raises it as
    a BaseException precisely so the ordinary ``except Exception``
    recovery paths cannot swallow it; matched by name so the server
    never imports the chaos layer (no serving -> robustness cycle)."""
    return type(e).__name__ == "ThreadKill"


def _is_sticky(e: BaseException) -> bool:
    """A CUDA error the runtime reported at synchronisation (torch's
    ``AcceleratorError``, or a RuntimeError naming a CUDA error): the
    context is poisoned, so nothing on this card can succeed again."""
    if isinstance(e, (BackendFault, LaunchError)):
        return False
    return type(e).__name__ == "AcceleratorError" or (
        isinstance(e, RuntimeError) and "CUDA error" in str(e))


def _is_backend_fault(e: BaseException) -> bool:
    """Classify a flight failure as the *backend* failing (a refused
    kernel launch, a CUDA runtime fault) rather than the payload: these
    re-execute on the fallback backend.  Matched narrowly — payload
    errors (shape/value problems) must reach bisection instead."""
    return isinstance(e, (BackendFault, LaunchError)) or _is_sticky(e)


def _is_retryable(e: BaseException) -> bool:
    """Deterministic payload errors re-raise identically — retrying
    them wastes device time, as does retrying on a poisoned context;
    anything else may be transient."""
    return not isinstance(e, (ValueError, TypeError)) and not _is_sticky(e)


class _Request:
    """One submitted request; its times are ``perf_counter_ns``: when it
    was submitted, when the dispatcher took it off the queue, and its
    deadline (or None)."""

    __slots__ = ("x", "rows", "kind", "future", "t_enqueue", "t_taken",
                 "deadline")

    def __init__(
        self,
        x: Any,
        rows: int,
        kind: Tuple,
        future: Future,
        t_enqueue: int,
        deadline: Optional[int] = None,
    ):
        self.x = x
        self.rows = rows
        self.kind = kind
        self.future = future
        self.t_enqueue = t_enqueue
        self.t_taken = t_enqueue
        self.deadline = deadline

    def expired(self, now: int) -> bool:
        return self.deadline is not None and now >= self.deadline


def _record_queue(sp: SpanRecorder, flight: int,
                  taken: List[_Request]) -> None:
    """Each request's ``queue`` span: submitted -> taken."""
    for r in taken:
        sp.record(QUEUE, flight, r.t_enqueue, r.t_taken)


class _Slot:
    """One slot of the serving mesh: its device, the CompiledBNN and
    params there (one object per distinct device, shared by its slots),
    its own streams and graph memory pool, and the graphs captured for
    it, keyed by (rows, valid rows)."""

    __slots__ = ("index", "device", "compiled", "params", "stream",
                 "capture_stream", "pool", "callers", "graphs")

    def __init__(self, index: int, device: torch.device, compiled: Any,
                 params: Any):
        cuda = device.type == "cuda"
        self.index = index
        self.device = device
        self.compiled = compiled
        self.params = params
        # flights replay on stream; graphs are captured on capture_stream
        # into the slot's memory pool
        self.stream = torch.cuda.Stream(device) if cuda else None
        self.capture_stream = torch.cuda.Stream(device) if cuda else None
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        self.callers = torch.cuda.default_stream(device) if cuda else None
        self.graphs: Dict[Tuple[int, int], GraphedApply] = {}


class _Level:
    """One (bucket, valid) dispatch level: each piece its rows split
    into as (slot, first row, graph), in row order."""

    __slots__ = ("pieces",)

    def __init__(self, pieces: Tuple[Tuple[_Slot, int, GraphedApply], ...]):
        self.pieces = pieces

    @property
    def launches(self) -> Dict[str, int]:
        """The kernel launches of one replay of every piece."""
        out: Dict[str, int] = {}
        for _, _, g in self.pieces:
            for k, v in g.launches.items():
                out[k] = out.get(k, 0) + v
        return out


# one chunk's pieces: (unresolved output, event or None, slot) each
_Parts = List[Tuple[Any, Any, _Slot]]


class _Flight:
    """One launched-but-unresolved micro-batch: its id, its admitted
    requests, for each chunk its pieces (each output with the event its
    slot's stream recorded after it; None on the CPU, where a piece is
    computed at launch) and its row count, and the ``perf_counter_ns``
    at which the dispatcher began it (the watchdog's wall time)."""

    __slots__ = ("id", "reqs", "outs", "t_start")

    def __init__(
        self, id: int, reqs: List[_Request], outs: List[Tuple[_Parts, int]],
        t_start: int,
    ):
        self.id = id
        self.reqs = reqs
        self.outs = outs
        self.t_start = t_start


class BNNServer:
    """Serving front door over a compiled BNN (see module docstring).

    compiled: the CompiledBNN to serve; params: its bound parameter
    tree (moved to the server's device, or to each device of the mesh,
    at construction); max_batch: bucket ceiling, rounded up to a power
    of two; mesh: a :class:`~repro_torch.launch.mesh.Mesh` to split
    flights over (``serving.data_mesh``), or None for one device;
    dispatch_ahead: max
    launched-but-unresolved batches the dispatcher may run ahead of the
    completer; admit_window_s: how long a partial batch may be held
    open for late-arriving rows WHILE the device is busy (a partial
    batch launches immediately when the device is idle); prewarm:
    resolve every dispatch level's launch plans
    (``kernels.autotune.warm``), then capture the CUDA graph of every
    (bucket, valid) dispatch level at construction instead of on first
    touch (a graph keeps the plans it was captured with); device: the server's
    device — None means the card (with a mesh: its first slot's
    device), and a host without one raises; pass ``"cpu"`` (with a
    CompiledBNN compiled for the CPU) to serve there.

    Robustness knobs (DESIGN.md §11): max_queue_rows bounds the queue
    (None: unbounded; ``submit`` raises ServerOverloaded past it);
    fallback_backend enables the degraded step for a backend-faulted
    flight (None disables it): on the card an eager rerun of the same
    kernels, on the CPU an eager run on the backend it names; max_retries/retry_backoff_s bound the transient-fault
    retry ladder (backoff doubles per attempt); chaos is a
    fault-injection hook (duck-typed: ``on_flight(payloads, fallback=)``
    before every execution and ``maybe_kill(role)`` in the worker loops
    — see repro_torch.robustness.chaos.ChaosMonkey); watchdog_cfg
    configures the straggler StepWatchdog fed per-flight wall times;
    supervise_interval_s is the supervisor's liveness-check period.
    """

    def __init__(
        self,
        compiled: Any,
        params: Dict[str, Any],
        max_batch: int = 32,
        mesh: Optional[Any] = None,
        dispatch_ahead: int = 2,
        admit_window_s: float = 0.002,
        prewarm: bool = False,
        max_queue_rows: Optional[int] = 65536,
        fallback_backend: Optional[str] = "torch",
        max_retries: int = 2,
        retry_backoff_s: float = 0.05,
        chaos: Any = None,
        watchdog_cfg: Optional[WatchdogConfig] = None,
        supervise_interval_s: float = 0.05,
        device: Any = None,
    ):
        if dispatch_ahead < 1:
            raise ValueError(f"dispatch_ahead must be >= 1, got {dispatch_ahead}")
        if max_queue_rows is not None and max_queue_rows < 1:
            raise ValueError(f"max_queue_rows must be >= 1, got {max_queue_rows}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if mesh is None:
            self.device = resolve_device(device)
            slot_devices = [self.device]
        else:
            slot_devices = [resolve_device(d)
                            for d in check_mesh(mesh).slots()]
            self.device = slot_devices[0]
            if device is not None and \
                    resolve_device(device).type != self.device.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{self.device}")
        if compiled.device.type != self.device.type:
            raise ValueError(f"the CompiledBNN runs on {compiled.device}, "
                             f"the server on {self.device}")
        self.compiled = compiled
        self.mesh = mesh
        self.max_batch = pow2_ceil(max_batch)
        self.dispatch_ahead = dispatch_ahead
        self.admit_window_s = admit_window_s
        self.max_queue_rows = max_queue_rows
        self.fallback_backend = fallback_backend
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.supervise_interval_s = supervise_interval_s
        # the params and the CompiledBNN once per distinct device
        placed: Dict[torch.device, Tuple[Any, Any]] = {}
        for dev in dict.fromkeys(_with_index(d) for d in slot_devices):
            same = dev == _with_index(compiled.device)
            placed[dev] = (compiled if same else compiled.to(dev),
                           replicate(params, dev))
        self._slots = [_Slot(i, dev, *placed[dev]) for i, dev in
                       enumerate(_with_index(d) for d in slot_devices)]
        self.params = self._slots[0].params
        self._graphs: Dict[Tuple[int, int], _Level] = {}
        self._dispatch_lock = threading.Lock()
        self._chaos = chaos
        self._watchdog = StepWatchdog(watchdog_cfg or WatchdogConfig())
        self._fallback: Any = None
        self._fallback_lock = threading.Lock()
        self._queue: deque = deque()
        self._qlock = threading.Lock()
        self._trace_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self._completer: Optional[threading.Thread] = None
        self._supervisor: Optional[threading.Thread] = None
        self._sup_stop = threading.Event()
        self._dispatcher_exited = False
        self._completer_done = False
        self._launched: Queue = Queue()
        self._ahead_sem = threading.Semaphore(dispatch_ahead)
        self._latency = Histogram()
        self._queue_wait = Histogram()
        self._host_ns = HostTimes()
        # spans: recorded while _spans is the recorder (trace_spans)
        self._recorder = SpanRecorder()
        self._spans: Optional[SpanRecorder] = None
        self._flight_ids = itertools.count()
        self._traffic_cache: Dict[int, int] = {}
        self._queued_rows = 0
        self._n_requests = 0
        self._n_rows = 0
        self._n_batches = 0
        self._bucket_hits = 0
        self._bucket_misses = 0
        self._padded_rows = 0
        self._valid_rows = 0
        self._real_rows = 0
        self._slot_rows = [0] * len(self._slots)
        self._hbm_bytes = 0
        self._inflight_n = 0
        self._inflight_peak = 0
        self._flight_faults = 0
        self._backend_fallbacks = 0
        self._retries = 0
        self._bisections = 0
        self._poisoned = 0
        self._timeouts = 0
        self._rejected = 0
        self._thread_restarts = 0
        if prewarm:
            kind = spec_kind(compiled.spec)
            grid = dispatch_grid(self.max_batch)
            valids: Dict[torch.device, set] = {}
            for bucket, valid in grid:
                for slot, _, _, pv in self._layout(bucket, valid):
                    valids.setdefault(slot.device, set()).add(pv)
            for dev, vs in valids.items():
                warm(compiled.tuning_keys_for_batches(sorted(vs)), dev)
            for bucket, valid in grid:
                self._graph(bucket, valid, kind)
            for slot in self._slots:
                if slot.stream is None:
                    continue
                # a graph's first replay uploads it to the card: pay that
                # here, not in the first flight of each level
                with torch.cuda.stream(slot.stream):
                    for g in slot.graphs.values():
                        g.graph.replay()
                slot.stream.synchronize()

    # -- the bucketed, masked dispatch core -------------------------- #
    def trace_bound(self) -> int:
        """Max graphs this server can ever capture: one per (bucket,
        ragged-valid) level."""
        return trace_bound(self.max_batch, ragged=True)

    def jit_traces(self) -> int:
        """The dispatch levels captured, the port's count of the
        reference's jit traces (on one device, one graph each)."""
        with self._trace_lock:
            return len(self._graphs)

    def graphs(self) -> List[GraphedApply]:
        """The captured graphs of every slot (capture time, launches per
        replay)."""
        with self._trace_lock:
            return [g for s in self._slots for g in s.graphs.values()]

    def slots(self) -> List[Dict[str, Any]]:
        """Per slot, in mesh order: its device, the graphs captured for
        it and the request rows it has received (padding not counted)."""
        with self._trace_lock:
            graphs = [len(s.graphs) for s in self._slots]
        with self._stats_lock:
            rows = list(self._slot_rows)
        return [{"device": str(s.device), "graphs": g, "rows": r}
                for s, g, r in zip(self._slots, graphs, rows)]

    def split(self, rows: int) -> List[Tuple[int, int, int, int, int]]:
        """How a flight of ``rows`` rows (at most ``max_batch``) is cut:
        for each piece that receives rows, in row order, ``(slot index,
        first row, stop row, graph rows, graph valid rows)`` — the piece
        runs as ``apply`` of its rows padded to the graph's rows with
        ``valid_rows`` the graph's valid rows."""
        bucket = bucket_for(rows, self.max_batch)
        return [(slot.index, lo, min(rows, lo + pb), pb, pv)
                for slot, lo, pb, pv in
                self._layout(bucket, ragged_valid(rows, bucket)) if lo < rows]

    def _owners(self, bucket: int) -> List[_Slot]:
        """The slot of each piece a bucket's rows are cut into: where
        ``fit_spec`` splits the bucket over the mesh's data axes, the
        first slot holding each block of rows, else the first slot."""
        if self.mesh is None:
            return self._slots[:1]
        spec = fit_spec((bucket,), (BATCH_AXES,), self.mesh)
        first: Dict[int, _Slot] = {}
        for slot, block in zip(self._slots, NamedSharding(
                self.mesh, spec).blocks((bucket,))):
            first.setdefault(block[0][0], slot)
        return [first[lo] for lo in sorted(first)]

    def _layout(self, bucket: int, valid: int
                ) -> List[Tuple[_Slot, int, int, int]]:
        """The pieces of a (bucket, valid) level that hold valid rows:
        (slot, first row, rows, valid rows) each."""
        owners = self._owners(bucket)
        pb = bucket // len(owners)
        return [(slot, i * pb, pb, min(valid - i * pb, pb))
                for i, slot in enumerate(owners) if i * pb < valid]

    def _inflight(self) -> int:
        with self._stats_lock:
            return self._inflight_n

    def _graph(self, bucket: int, valid: int, kind: Tuple
               ) -> Tuple[_Level, bool]:
        """The graphs of one dispatch level, one per piece, each captured
        on its slot's first touch of the piece's (rows, valid) under the
        trace lock (concurrent first touches cannot capture twice, so
        the per-level bound holds); returns (level, hit)."""
        if kind != spec_kind(self.compiled.spec):
            raise ValueError(f"request kind {kind} is not the spec's input "
                             f"{spec_kind(self.compiled.spec)}")
        key = (bucket, valid)
        with self._trace_lock:
            level = self._graphs.get(key)
            if level is not None:
                return level, True
            pieces = []
            for slot, lo, pb, pv in self._layout(bucket, valid):
                g = slot.graphs.get((pb, pv))
                if g is None:
                    g = GraphedApply(slot.compiled, slot.params, pb, pv,
                                     pool=slot.pool,
                                     stream=slot.capture_stream)
                    slot.graphs[(pb, pv)] = g
                pieces.append((slot, lo, g))
            level = _Level(tuple(pieces))
            self._graphs[key] = level
            return level, False

    def _fallback_apply(self) -> Any:
        """The degraded path, chosen on the first backend fault and run
        eagerly, without a graph.  On the card it is the served
        CompiledBNN itself: the same kernels launched one by one, never
        their plain versions.  On the CPU it is the spec recompiled for
        ``fallback_backend`` (``CompiledBNN.with_backend`` —
        bit-identical by the backend registry contract)."""
        with self._fallback_lock:
            if self._fallback is None:
                first = self._slots[0].compiled
                self._fallback = (
                    first if self.device.type == "cuda"
                    else first.with_backend(self.fallback_backend))
            return self._fallback

    def _enqueue(self, work: List[Tuple[_Slot, Any, Any]]) -> _Parts:
        """Run each ``(slot, run, payload)``'s ``run()`` on its slot's
        stream, after the work the calling thread has queued on that
        device (the payload's producers), and record its event; returns
        [(output, event, slot)].  The dispatch lock keeps a flight's
        copies, replays and clones together: a slot's graphs share its
        memory pool."""
        if work[0][0].stream is None:
            return [(run(), None, slot) for slot, run, _ in work]
        parts: _Parts = []
        with self._dispatch_lock:
            for slot, run, x in work:
                slot.stream.wait_stream(torch.cuda.current_stream(slot.device))
                if tensor_of(x).device == slot.device:
                    # the payload is read on the slot's stream
                    tensor_of(x).record_stream(slot.stream)
                # the stream's context makes its card the current device
                with torch.cuda.stream(slot.stream):
                    out = run()
                    ev = torch.cuda.Event()
                    ev.record(slot.stream)
                parts.append((out, ev, slot))
        return parts

    def _launch(self, x: Any, rows: int, fallback: bool = False,
                flight: int = -1) -> _Parts:
        """Enqueue one micro-batch at its (bucket, valid) level, a piece
        on each slot that receives rows; returns the UNRESOLVED pieces
        (together ``valid`` >= ``rows`` rows).  Degraded dispatches skip
        the graph cache: they run ``_fallback_apply()`` eagerly and
        whole on the first slot (same bounded level set).  Timed as an
        ``enqueue`` of ``flight``."""
        t0 = time.perf_counter_ns()
        bucket = bucket_for(rows, self.max_batch)
        valid = ragged_valid(rows, bucket)
        hit: Optional[bool] = None
        if fallback:
            fb, first = self._fallback_apply(), self._slots[0]
            work = [(first, lambda: fb.apply(
                first.params, _pad_rows(shard_batch(x, first.device),
                                        bucket), valid_rows=valid), x)]
        else:
            level, hit = self._graph(bucket, valid, kind_of(x))
            work = []
            for slot, lo, g in level.pieces:
                if lo >= rows:
                    break
                piece = x if len(level.pieces) == 1 else \
                    _slice_rows(x, lo, lo + g.batch)
                work.append((slot, lambda g=g, p=piece: g(p), piece))
        parts = self._enqueue(work)
        t1 = time.perf_counter_ns()
        with self._stats_lock:
            self._host_ns.add(ENQUEUE, t1 - t0)
            for slot, _, p in work:
                self._slot_rows[slot.index] += rows_of(p)
            if hit is True:
                self._bucket_hits += 1
            elif hit is False:
                self._bucket_misses += 1
            self._n_batches += 1
            self._padded_rows += bucket
            self._valid_rows += valid
            self._real_rows += rows
            self._hbm_bytes += self._level_traffic(valid)
        sp = self._spans
        if sp is not None:
            sp.record(ENQUEUE, flight, t0, t1)
        return parts

    def _launch_chunks(
        self, x: Any, rows: int, fallback: bool = False, flight: int = -1
    ) -> List[Tuple[_Parts, int]]:
        """Enqueue a payload as max_batch chunks + remainder; returns
        [(unresolved pieces, chunk rows)]."""
        outs: List[Tuple[_Parts, int]] = []
        chunks = split_rows(rows, self.max_batch)
        off = 0
        for chunk in chunks:
            piece = x if len(chunks) == 1 else _slice_rows(x, off, off + chunk)
            outs.append((self._launch(piece, chunk, fallback, flight), chunk))
            off += chunk
        return outs

    @staticmethod
    def _sync(outs: List[Tuple[_Parts, int]]) -> None:
        """Block until every piece of the launched chunks is computed
        (``event.synchronize()``)."""
        for parts, _ in outs:
            for _, ev, _ in parts:
                if ev is not None:
                    ev.synchronize()

    def _gather(self, outs: List[Tuple[_Parts, int]]) -> Any:
        """Gather each synchronised chunk's pieces on the first slot's
        device and reassemble the true-row-count result.  Each piece's
        memory is recorded on its device's default stream, where callers
        (and the gather) use it."""
        first = self._slots[0].device
        results = []
        for parts, chunk in outs:
            ys = []
            for out, ev, slot in parts:
                if ev is not None:
                    tensor_of(out).record_stream(slot.callers)
                ys.append(out)
            y = ys[0] if len(ys) == 1 else \
                _concat_rows([_to(p, first) for p in ys])
            results.append(_slice_rows(y, 0, chunk))
        return results[0] if len(results) == 1 else _concat_rows(results)

    def _finish_chunks(self, outs: List[Tuple[_Parts, int]]) -> Any:
        """Resolve launched chunks: ``_sync``, then ``_gather``."""
        self._sync(outs)
        return self._gather(outs)

    def _level_traffic(self, valid: int) -> int:
        b = self._traffic_cache.get(valid)
        if b is None:
            b = int(self.compiled.traffic(batch=valid)["packed_bytes"])
            self._traffic_cache[valid] = b
        return b

    def apply_batch(self, x: Any) -> Any:
        """Synchronous bucketed+masked forward of one request
        batch (chunked through ``max_batch`` when larger);
        bit-identical to ``compiled.apply(params, x)``."""
        rows = rows_of(x)
        t0 = time.perf_counter_ns()
        out = self._finish_chunks(self._launch_chunks(x, rows))
        t1 = time.perf_counter_ns()
        with self._stats_lock:
            self._n_requests += 1
            self._n_rows += rows
            self._latency.add(t1 - t0)
        return out

    # -- the continuous-batching request queue ----------------------- #
    def submit(self, x: Any, deadline_s: Optional[float] = None) -> Future:
        """Enqueue one request batch; the returned future resolves to
        the sliced result once a micro-batch containing it completes.
        The row count and kind signature are computed HERE so a payload
        the server cannot even inspect fails fast in the caller, never
        in the worker loop.

        deadline_s bounds how long the request may wait: a request
        whose deadline passes before its flight launches is shed
        without touching the device and its future resolves with
        RequestTimeout.  Raises ServerOverloaded (without enqueueing)
        when admission would push the queue past max_queue_rows."""
        now = time.perf_counter_ns()
        deadline = None if deadline_s is None else now + int(deadline_s * 1e9)
        req = _Request(x, rows_of(x), kind_of(x), Future(), now, deadline)
        with self._qlock:
            full = (
                self.max_queue_rows is not None
                and self._queued_rows + req.rows > self.max_queue_rows
            )
            if not full:
                self._queue.append(req)
                self._queued_rows += req.rows
        if full:
            with self._stats_lock:
                self._rejected += 1
            raise ServerOverloaded(
                f"admitting {req.rows} rows would exceed "
                f"max_queue_rows={self.max_queue_rows}"
            )
        self._wake.set()
        return req.future

    def queue_depth(self) -> int:
        with self._qlock:
            return len(self._queue)

    def _pop(self, taken: List[_Request]) -> Tuple[int, bool]:
        """Move the queue's head requests onto ``taken`` while their rows
        coalesce with it under ``max_batch`` (an oversized head request
        comes alone and is chunked by ``_launch_chunks``), stamping each
        with the time it was taken; returns (rows taken in all, whether
        requests stay queued).  Only same-kind payloads coalesce: a
        request whose trailing shape/dtype differs from the head's
        starts its own micro-batch, so one malformed request can never
        fail its neighbors' futures."""
        n = len(taken)
        total = sum(r.rows for r in taken)
        with self._qlock:
            while self._queue:
                nxt = self._queue[0]
                if taken and (total + nxt.rows > self.max_batch
                              or nxt.kind != taken[0].kind):
                    break
                taken.append(self._queue.popleft())
                self._queued_rows -= nxt.rows
                total += nxt.rows
                if total >= self.max_batch:
                    break
            backlog = bool(self._queue)
        if len(taken) > n:
            now = time.perf_counter_ns()
            for r in taken[n:]:
                r.t_taken = now
        return total, backlog

    def _take_microbatch(self) -> List[_Request]:
        """Pop a FIFO run of requests whose rows coalesce (``_pop``)."""
        taken: List[_Request] = []
        self._pop(taken)
        return taken

    def _admit(self) -> List[_Request]:
        """Continuous-batching admission: build the next micro-batch,
        holding it open (the admission window) so rows arriving while
        the device is busy join the not-yet-launched batch instead of
        starting their own.  The window is keyed on queue state and
        never delays latency-bound traffic — a partial batch launches
        IMMEDIATELY when

        * it is full (``max_batch`` rows), or
        * other requests are already queued behind it (backlog: a
          different-kind head, or rows that did not fit), or
        * no batch is in flight (the device is idle — holding the
          batch would serialize, not overlap).

        Only while at least one batch is in flight does the batch stay
        open, for at most ``admit_window_s`` — time that is fully
        overlapped with device compute."""
        taken: List[_Request] = []
        deadline: Optional[int] = None
        while not self._stop.is_set():
            self._chaos_kill("dispatcher")
            total, backlog = self._pop(taken)
            if taken and (total >= self.max_batch or backlog):
                break
            if taken:
                if self._inflight() == 0:
                    break
                now = time.perf_counter_ns()
                if deadline is None:
                    deadline = now + int(self.admit_window_s * 1e9)
                if now >= deadline:
                    break
                timeout = min(deadline - now, 500_000) / 1e9
            else:
                timeout = 0.05
            self._wake.wait(timeout=timeout)
            self._wake.clear()
        return taken

    # -- fault handling (DESIGN.md §11) ------------------------------ #
    def _chaos_flight(self, reqs: List[_Request], fallback: bool) -> None:
        if self._chaos is not None:
            self._chaos.on_flight([r.x for r in reqs], fallback=fallback)

    def _chaos_kill(self, role: str) -> None:
        if self._chaos is not None:
            self._chaos.maybe_kill(role)

    def _shed_expired(self, reqs: List[_Request]) -> List[_Request]:
        """Resolve requests whose deadline already passed with
        RequestTimeout — BEFORE any device work — and return the
        still-live remainder."""
        now = time.perf_counter_ns()
        live: List[_Request] = []
        for r in reqs:
            if r.expired(now):
                late = (now - r.deadline) / 1e9
                r.future.set_exception(
                    RequestTimeout(f"deadline expired {late:.3f}s before launch")
                )
                with self._stats_lock:
                    self._timeouts += 1
            else:
                live.append(r)
        return live

    def _execute(self, reqs: List[_Request], fallback: bool = False,
                 flight: int = -1) -> Any:
        """Synchronously run one coalesced flight end to end (launch +
        block) and return the concatenated result — the re-execution
        primitive the recovery ladder is built from.  Safe to call
        repeatedly for the same requests: payloads are only ever read
        (copied into a graph's input buffer, or padded into a fresh
        tensor on the degraded and CPU paths)."""
        self._chaos_flight(reqs, fallback)
        x = _concat_rows([r.x for r in reqs])
        rows = sum(r.rows for r in reqs)
        outs = self._launch_chunks(x, rows, fallback, flight)
        return self._finish_chunks(outs)

    def _recover(
        self, reqs: List[_Request], exc: BaseException, flight: int
    ) -> None:
        """The recovery ladder for a failed flight: degraded step ->
        bounded retry with backoff -> bisection -> typed singleton
        failure.  Every future in ``reqs`` is resolved (value or typed
        error) by the time this returns — the zero-lost-futures
        invariant.

        * A *backend* fault (kernel launch / runtime failure) first
          re-executes the flight eagerly (``_fallback_apply``: on the
          card the same kernels without the graph, on the CPU the
          fallback backend) — graceful degradation, counted in stats().
          A CUDA error reported at synchronisation poisons the context:
          after the degraded step it is neither retried nor bisected,
          and every request of the flight fails with BackendFault.
        * A graph whose capture failed fails every request with the
          CaptureError: no ladder hides it.
        * A transient fault retries up to ``max_retries`` times with
          exponential backoff.  Deterministic payload errors
          (ValueError/TypeError) skip straight past the retries.
        * A multi-request flight that still fails is bisected: each
          half re-executes independently, recursing until exactly the
          poison request(s) hold the exception (wrapped as
          PoisonRequest with the original chained as ``__cause__``)
          and every healthy neighbor has resolved normally.  The full
          ladder applies at every bisection level — a backend fault
          landing on a half mid-bisection still takes the degraded
          step instead of failing healthy requests.

        Counted once a failed flight and timed as its ``recover`` span.
        """
        t0 = time.perf_counter_ns()
        with self._stats_lock:
            self._flight_faults += 1
        try:
            self._climb(reqs, exc, flight)
        finally:
            sp = self._spans
            if sp is not None:
                sp.record(RECOVER, flight, t0, time.perf_counter_ns())

    def _climb(self, reqs: List[_Request], exc: BaseException,
               flight: int) -> None:
        """One climb of the ladder (``_recover``) over ``reqs``; each
        half of a bisection climbs it again."""
        if isinstance(exc, CaptureError):
            for r in reqs:
                r.future.set_exception(exc)
            return
        if self.fallback_backend is not None and _is_backend_fault(exc):
            try:
                out = self._execute(reqs, True, flight)
            except Exception as e:
                exc = e
            else:
                with self._stats_lock:
                    self._backend_fallbacks += 1
                self._resolve(reqs, out)
                return
        if _is_retryable(exc):
            for attempt in range(self.max_retries):
                time.sleep(self.retry_backoff_s * (2**attempt))
                with self._stats_lock:
                    self._retries += 1
                try:
                    out = self._execute(reqs, flight=flight)
                except Exception as e:
                    exc = e
                else:
                    self._resolve(reqs, out)
                    return
        if len(reqs) > 1 and not _is_sticky(exc):
            with self._stats_lock:
                self._bisections += 1
            mid = len(reqs) // 2
            for half in (reqs[:mid], reqs[mid:]):
                try:
                    out = self._execute(half, flight=flight)
                except Exception as e:
                    self._climb(half, e, flight)
                else:
                    self._resolve(half, out)
            return
        if isinstance(exc, ServingError):
            err: BaseException = exc
        elif _is_backend_fault(exc):
            err = BackendFault(f"the card failed the flight: {exc!r}")
            err.__cause__ = exc
        else:
            err = PoisonRequest(f"request payload makes the forward raise: {exc!r}")
            err.__cause__ = exc
            with self._stats_lock:
                self._poisoned += 1
        for r in reqs:
            r.future.set_exception(err)

    def _observe_wall(self, wall: float) -> None:
        """Feed one flight's wall time to the straggler watchdog
        (runtime/straggler.py): a flight slower than ``slow_factor`` x
        the trailing-window median is flagged in
        ``stats()["straggler_flags"]``."""
        with self._stats_lock:
            self._watchdog.observe(wall)

    def _launch_flight(self, taken: List[_Request]) -> None:
        """Coalesce one admitted micro-batch and ENQUEUE its device
        computation without waiting (dispatch-ahead): the completer
        thread blocks on results in launch order while this thread
        returns to admission for the next batch.  The dispatch-ahead
        semaphore bounds launched-but-unresolved flights; the rows are
        concatenated before a slot is asked for, so the join overlaps
        the wait.  A launch failure runs the recovery ladder here,
        synchronously — rare by construction, and recovery must not race
        admission.  Timed as the flight's ``admit`` (its first request
        taken to this call), ``concat``, ``ahead_wait`` and ``launch``;
        each request's queue wait ends where ``launch`` starts."""
        t_decided = time.perf_counter_ns()
        t_admit = taken[0].t_taken
        taken = self._shed_expired(taken)
        if not taken:
            return
        flight = next(self._flight_ids)
        acquired = False
        try:
            self._chaos_flight(taken, False)
            t_concat = time.perf_counter_ns()
            x = _concat_rows([r.x for r in taken])
            rows = sum(r.rows for r in taken)
            t_wait = time.perf_counter_ns()
            self._ahead_sem.acquire()
            acquired = True
            t_launch = time.perf_counter_ns()
            outs = self._launch_chunks(x, rows, flight=flight)
        except Exception as e:
            if acquired:
                self._ahead_sem.release()
            self._recover(taken, e, flight)
            self._observe_wall((time.perf_counter_ns() - t_decided) / 1e9)
            return
        t_end = time.perf_counter_ns()
        with self._stats_lock:
            self._inflight_n += 1
            self._inflight_peak = max(self._inflight_peak, self._inflight_n)
            self._host_ns.add(ADMIT, t_decided - t_admit)
            self._host_ns.add(CONCAT, t_wait - t_concat)
            self._host_ns.add(AHEAD_WAIT, t_launch - t_wait)
            self._host_ns.add(LAUNCH, t_end - t_launch)
            for r in taken:
                self._queue_wait.add(t_launch - r.t_enqueue)
        sp = self._spans
        if sp is not None:
            _record_queue(sp, flight, taken)
            sp.record(ADMIT, flight, t_admit, t_decided)
            sp.record(CONCAT, flight, t_concat, t_wait)
            sp.record(AHEAD_WAIT, flight, t_wait, t_launch)
            sp.record(LAUNCH, flight, t_launch, t_end)
        self._launched.put(_Flight(flight, taken, outs, t_decided))

    def _serve_one(self, taken: List[_Request]) -> None:
        """Run one coalesced micro-batch synchronously and resolve its
        futures (the ``flush`` path — no dispatch-ahead); failures run
        the recovery ladder."""
        taken = self._shed_expired(taken)
        if not taken:
            return
        flight = next(self._flight_ids)
        t_start = time.perf_counter_ns()
        with self._stats_lock:
            for r in taken:
                self._queue_wait.add(t_start - r.t_enqueue)
        sp = self._spans
        if sp is not None:
            _record_queue(sp, flight, taken)
        try:
            out = self._execute(taken, flight=flight)
        except Exception as e:
            self._recover(taken, e, flight)
        else:
            self._resolve(taken, out)
        self._observe_wall((time.perf_counter_ns() - t_start) / 1e9)

    def _resolve(self, taken: List[_Request], out: Any) -> None:
        """Slice a completed micro-batch result back to its requests,
        counted first; ``set_result`` runs each caller's done-callbacks
        here, on this thread."""
        t_done = time.perf_counter_ns()
        with self._stats_lock:
            self._n_requests += len(taken)
            for r in taken:
                self._n_rows += r.rows
                self._latency.add(t_done - r.t_enqueue)
        off = 0
        for r in taken:
            r.future.set_result(_slice_rows(out, off, off + r.rows))
            off += r.rows

    def flush(self) -> int:
        """Drain the queue synchronously; returns micro-batches run.
        Terminates even under backpressure: every iteration removes
        the requests it takes from the bounded queue, and concurrent
        ``submit`` calls cannot grow it past ``max_queue_rows``."""
        n = 0
        while True:
            taken = self._take_microbatch()
            if not taken:
                return n
            self._serve_one(taken)
            n += 1

    # -- async dispatcher + completer + supervisor ------------------- #
    def start(self) -> "BNNServer":
        """Spawn the dispatcher, completer, and supervisor threads
        (idempotent)."""
        if self._worker is not None and self._worker.is_alive():
            return self
        self._stop.clear()
        self._sup_stop.clear()
        self._dispatcher_exited = False
        self._completer_done = False
        self._launched = Queue()
        self._ahead_sem = threading.Semaphore(self.dispatch_ahead)
        self._completer = self._thread(COMPLETER)
        self._worker = self._thread(DISPATCHER)
        self._supervisor = threading.Thread(target=self._supervise_loop,
                                            name="BNNServer-supervisor",
                                            daemon=True)
        self._completer.start()
        self._worker.start()
        self._supervisor.start()
        return self

    def _thread(self, role: str) -> threading.Thread:
        """A new (not started) dispatcher or completer loop thread, named
        for its role (``spans.THREAD_NAMES``)."""
        loop = self._dispatch_loop if role == DISPATCHER else self._complete_loop
        return threading.Thread(target=loop, name=THREAD_NAMES[role],
                                daemon=True)

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._chaos_kill("dispatcher")
                taken = self._admit()
                if taken:
                    self._launch_flight(taken)
            except Exception:
                # per-request failures already resolve their own
                # futures through the recovery ladder; anything that
                # still escapes must not kill the dispatcher and strand
                # the queue
                continue
            except BaseException as e:
                if _is_kill(e):
                    # simulated thread death: exit WITHOUT the clean-
                    # exit flag, so the supervisor restarts the loop
                    return
                raise
        self._dispatcher_exited = True

    def _complete_loop(self) -> None:
        while True:
            try:
                self._chaos_kill("completer")
                fl = self._launched.get(timeout=0.05)
            except Empty:
                continue
            except BaseException as e:
                if _is_kill(e):
                    return  # dead without _completer_done: restarted
                raise
            if fl is None:
                self._completer_done = True
                return
            self._complete_one(fl)

    def _complete_one(self, fl: _Flight) -> None:
        """Resolve one launched flight (failures climb the recovery
        ladder); ALWAYS releases its dispatch-ahead slot.  Timed as its
        ``sync`` and ``resolve``."""
        t_sync = time.perf_counter_ns()
        t_synced = None
        try:
            try:
                self._sync(fl.outs)
                t_synced = time.perf_counter_ns()
                out = self._gather(fl.outs)
            except Exception as e:
                self._recover(fl.reqs, e, fl.id)
            else:
                self._resolve(fl.reqs, out)
        finally:
            wall = (time.perf_counter_ns() - fl.t_start) / 1e9
            with self._stats_lock:
                self._watchdog.observe(wall)
                t_end = time.perf_counter_ns()
                self._inflight_n -= 1
                if t_synced is not None:
                    self._host_ns.add(SYNC, t_synced - t_sync)
                    self._host_ns.add(RESOLVE, t_end - t_synced)
            self._ahead_sem.release()
            sp = self._spans
            if sp is not None and t_synced is not None:
                sp.record(SYNC, fl.id, t_sync, t_synced)
                sp.record(RESOLVE, fl.id, t_synced, t_end)

    def _supervise_loop(self) -> None:
        """Thread watchdog: a dispatcher or completer that died without
        reaching its clean exit point (a chaos kill, an unexpected
        BaseException) is restarted, so a dead loop can never strand
        the queue or the in-flight batches.  Clean exits set their exit
        flag before returning and are never restarted."""
        while not self._sup_stop.is_set():
            w, c = self._worker, self._completer
            if w is not None and not w.is_alive() and not self._dispatcher_exited:
                # started before it is published: stop() may join it
                t = self._thread(DISPATCHER)
                t.start()
                self._worker = t
                with self._stats_lock:
                    self._thread_restarts += 1
            if c is not None and not c.is_alive() and not self._completer_done:
                t = self._thread(COMPLETER)
                t.start()
                self._completer = t
                with self._stats_lock:
                    self._thread_restarts += 1
            self._sup_stop.wait(timeout=self.supervise_interval_s)

    def stop(self) -> None:
        """Stop the worker threads, drain what is already queued, and
        resolve every launched batch before returning — even with
        chaos-killed loops mid-flight: the supervisor stays up until
        both loops reach their clean exit points, restarting dead ones,
        so stop() cannot deadlock on a dead completer's unreleased
        dispatch-ahead slot."""
        if self._worker is None:
            return
        self._stop.set()
        self._wake.set()
        while not self._dispatcher_exited:
            w = self._worker
            if w is None:
                break
            w.join(timeout=0.05)
        # the dispatcher is gone for good: launch everything still
        # queued (no admission window), then hand the completer its
        # stop sentinel — batches in flight resolve before we return
        while True:
            taken = self._take_microbatch()
            if not taken:
                break
            self._launch_flight(taken)
        self._launched.put(None)
        while not self._completer_done:
            c = self._completer
            if c is None:
                break
            c.join(timeout=0.05)
        self._sup_stop.set()
        if self._supervisor is not None:
            self._supervisor.join()
            self._supervisor = None
        self._worker = None
        self._completer = None
        self.flush()  # anything submitted after the drain began

    # -- observability ----------------------------------------------- #
    def trace_spans(self, on: bool = True) -> None:
        """Record a span at every boundary a flight crosses from now on
        (``on``), or stop recording; what was kept stays for ``spans()``
        (at most ``spans.SPAN_CAP`` a thread between two calls, the rest
        counted as dropped)."""
        self._spans = self._recorder if on else None

    def spans(self) -> Tuple[List[Span], int]:
        """The spans kept since the last call, by start, and how many
        were dropped past the cap; they are cleared (``serving/spans.py``
        says what each span is)."""
        return self._recorder.drain()

    def health(self) -> Dict[str, Any]:
        """Readiness probe: thread liveness, queue pressure, restart
        count.  ``healthy`` is True when the server can make progress —
        worker loops alive (or not started: flush-mode serving) and
        admission not saturated.  A loop the chaos layer just killed
        reads unhealthy until the supervisor restarts it."""
        w, c = self._worker, self._completer
        running = w is not None
        d_alive = bool(w is not None and w.is_alive())
        c_alive = bool(c is not None and c.is_alive())
        with self._qlock:
            depth = len(self._queue)
            qrows = self._queued_rows
        with self._stats_lock:
            inflight = self._inflight_n
            restarts = self._thread_restarts
        overloaded = self.max_queue_rows is not None and qrows >= self.max_queue_rows
        return {
            "healthy": (not running or (d_alive and c_alive)) and not overloaded,
            "running": running,
            "dispatcher_alive": d_alive,
            "completer_alive": c_alive,
            "queue_depth": depth,
            "queued_rows": qrows,
            "overloaded": overloaded,
            "inflight_batches": inflight,
            "thread_restarts": restarts,
        }

    def stats(self) -> Dict[str, Any]:
        """The serving counters (DESIGN.md §9/§10/§11 schema): request/
        row totals, dispatch and bucket-reuse counts, jit trace count
        vs the policy bound, padded-vs-valid-vs-real occupancy, HBM
        bytes/request from the compiled traffic model, the in-flight
        gauge, the host ns of each boundary a flight crosses
        (``host_ns``), queue-wait / end-to-end latency over every
        request since start (mean, max, count and ns sum exact; the
        percentiles bucket estimates within a few percent,
        ``spans.Histogram``), the fault-recovery counters, and the
        straggler watchdog flags."""
        with self._stats_lock:  # snapshot: writers hold the same locks
            lat = self._latency.copy()
            waits = self._queue_wait.copy()
            host_ns = self._host_ns.snapshot()
            requests, rows = self._n_requests, self._n_rows
            batches = self._n_batches
            hits, misses = self._bucket_hits, self._bucket_misses
            padded, valid = self._padded_rows, self._valid_rows
            real = self._real_rows
            hbm = self._hbm_bytes
            inflight, inflight_peak = self._inflight_n, self._inflight_peak
            faults = {
                "flights": self._flight_faults,
                "backend_fallbacks": self._backend_fallbacks,
                "retries": self._retries,
                "bisections": self._bisections,
                "poisoned_requests": self._poisoned,
                "timeouts": self._timeouts,
                "rejected": self._rejected,
                "thread_restarts": self._thread_restarts,
            }
            straggler_flags = list(self._watchdog.flags)
            straggler_median = self._watchdog.median
        with self._trace_lock:
            buckets = sorted({key[0] for key in self._graphs})
        dispatches = hits + misses
        stats = {
            "requests": requests,
            "rows": rows,
            "batches": batches,
            "queue_depth": self.queue_depth(),
            "inflight_batches": inflight,
            "inflight_peak": inflight_peak,
            "buckets_traced": buckets,
            "bucket_hits": hits,
            "bucket_misses": misses,
            "bucket_hit_rate": hits / dispatches if dispatches else 0.0,
            "jit_traces": self.jit_traces(),
            "trace_bound": self.trace_bound(),
            "padded_rows": padded,
            "valid_rows": valid,
            "real_rows": real,
            "occupancy": real / padded if padded else 0.0,
            "compute_occupancy": real / valid if valid else 0.0,
            "hbm_bytes": hbm,
            "hbm_bytes_per_request": hbm / max(requests, 1),
            "devices": 1 if self.mesh is None else self.mesh.size,
            "faults": faults,
            "straggler_flags": straggler_flags,
            "straggler_median_s": straggler_median,
            "host_ns": host_ns,
        }
        if lat.count:
            stats["latency_s"] = lat.summary()
        if waits.count:
            stats["queue_wait_s"] = waits.summary()
        return stats
