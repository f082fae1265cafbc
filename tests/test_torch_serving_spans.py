"""BNNServer's host timing: the ``host_ns`` counters, the latency and
queue-wait histograms, and the spans of ``trace_spans``.

On the CPU: with spans off nothing is recorded and the counters still
count every flight and chunk; with spans on there is one ``launch`` a
flight and one ``enqueue`` a chunk, one ``queue`` span a request with
its flight's id, children inside their parents and a flight's
dispatcher spans in order, ``sync`` and ``resolve`` after their
``launch``, a ``recover`` span for a chaos fault with every future
resolved, the cap drops and counts, and two ``stats()`` snapshots give
a window's mean queue wait equal to its spans'.  The histograms'
percentiles come within a few percent of the exact ones.  On a CUDA card (``-m gpu``): after the clock anchor, the
slice's ``cudaGraphLaunch`` calls fall inside ``enqueue`` spans.

    PYTHONPATH=src python -m pytest -q tests/test_torch_serving_spans.py
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import graph as tgraph  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.kernels.ops import binarize_pack  # noqa: E402
from repro_torch.robustness import ChaosMonkey  # noqa: E402
from repro_torch.serving import BackendFault, BNNServer  # noqa: E402
from repro_torch.serving import spans as sp  # noqa: E402

SIZES = (2, 5, 3, 8, 1, 7, 4, 6, 2, 3, 5, 1)


def _server(max_batch=8, device="cpu", backend="torch", **kw):
    cb = tgraph.compile(tgraph.from_dense_stack(256, [128, 64],
                                                name="span_mlp"),
                        backend=backend, device=device, batch=4)
    params = cb.init(torch.Generator(device=device).manual_seed(0))
    kw.setdefault("retry_backoff_s", 0.0)
    return cb, params, BNNServer(cb, params, max_batch=max_batch,
                                 device=device, **kw)


def _packed(rng, rows, device="cpu"):
    x = rng.normal(size=(rows, 256)).astype(np.float32)
    return binarize_pack(torch.from_numpy(x).to(device),
                         backend="torch" if device == "cpu" else "cuda")


def _serve(srv, sizes, seed=0, stop=True):
    """Submit ``sizes`` to the started server, wait for every result."""
    rng = np.random.default_rng(seed)
    futs = [srv.submit(_packed(rng, n)) for n in sizes]
    for f in futs:
        f.result(timeout=60)
    if stop:
        srv.stop()
    return futs


def _by(spans, name):
    return [s for s in spans if s.name == name]


def _inside(child, parent):
    return parent.t0_ns <= child.t0_ns <= child.t1_ns <= parent.t1_ns


# ------------------------------------------------------------------ #
# the always-on counters                                               #
# ------------------------------------------------------------------ #
def test_spans_off_records_nothing_and_counters_count_every_flight():
    _, _, srv = _server()
    srv.start()
    _serve(srv, SIZES)
    assert srv.spans() == ([], 0)
    st = srv.stats()
    host = st["host_ns"]
    assert set(host) == set(sp.BOUNDARIES)
    # no request exceeds max_batch: one chunk a flight
    flights = host[sp.LAUNCH]["count"]
    assert 1 <= flights <= len(SIZES)
    assert st["batches"] == flights == host[sp.ENQUEUE]["count"]
    for name in (sp.ADMIT, sp.CONCAT, sp.AHEAD_WAIT, sp.SYNC, sp.RESOLVE):
        assert host[name]["count"] == flights
    assert all(v["total_ns"] >= 0 for v in host.values())
    assert host[sp.LAUNCH]["total_ns"] > 0
    assert st["queue_wait_s"]["count"] == st["latency_s"]["count"] \
        == st["requests"] == len(SIZES)


def test_enqueue_counts_chunks_of_an_oversized_request():
    _, _, srv = _server(max_batch=4)
    srv.start()
    _serve(srv, (11, 3, 9))                         # 3 + 1 + 3 chunks at most
    st = srv.stats()
    host = st["host_ns"]
    assert host[sp.ENQUEUE]["count"] == st["batches"]
    assert host[sp.LAUNCH]["count"] < st["batches"]


def test_apply_and_flush_count_enqueues_and_latency():
    _, _, srv = _server()
    rng = np.random.default_rng(4)
    srv.apply_batch(_packed(rng, 3))
    futs = [srv.submit(_packed(rng, n)) for n in (2, 3)]
    srv.flush()
    assert all(f.done() for f in futs)
    st = srv.stats()
    assert st["host_ns"][sp.ENQUEUE]["count"] == st["batches"] == 2
    assert st["host_ns"][sp.LAUNCH]["count"] == 0   # no dispatcher ran
    assert st["latency_s"]["count"] == 3 and st["queue_wait_s"]["count"] == 2
    assert {"mean", "p50", "p95", "p99", "max", "count",
            "sum_ns"} == set(st["latency_s"])


# ------------------------------------------------------------------ #
# the spans                                                            #
# ------------------------------------------------------------------ #
def test_spans_one_launch_a_flight_and_one_enqueue_a_chunk():
    _, _, srv = _server(max_batch=4)
    srv.trace_spans(True)
    srv.start()
    sizes = SIZES + (11, 9)
    _serve(srv, sizes, seed=1, stop=False)
    st = srv.stats()
    srv.stop()
    spans, dropped = srv.spans()
    assert dropped == 0
    launches = _by(spans, sp.LAUNCH)
    ids = [s.flight for s in launches]
    assert len(ids) == len(set(ids)) == st["host_ns"][sp.LAUNCH]["count"]
    assert all(s.role == sp.DISPATCHER for s in launches)
    enqueues = _by(spans, sp.ENQUEUE)
    assert len(enqueues) == st["batches"] == st["host_ns"][sp.ENQUEUE]["count"]
    assert {s.name for s in spans} <= set(sp.SPANS)
    assert all(s.t0_ns <= s.t1_ns for s in spans)
    # each request: one queue span, carrying the id of a launched flight
    queues = _by(spans, sp.QUEUE)
    assert len(queues) == len(sizes) == st["requests"]
    assert {s.flight for s in queues} == set(ids)


def test_span_children_nest_and_completer_spans_follow_launch():
    _, _, srv = _server(max_batch=4)
    srv.trace_spans(True)
    srv.start()
    _serve(srv, SIZES + (11,), seed=2)
    spans, _ = srv.spans()
    flights = {s.flight: {} for s in _by(spans, sp.LAUNCH)}
    for s in spans:
        if s.name in (sp.QUEUE, sp.ENQUEUE):
            flights[s.flight].setdefault(s.name, []).append(s)
        else:
            assert s.name not in flights[s.flight], s
            flights[s.flight][s.name] = s
    for fid, f in flights.items():
        launch, admit, concat = f[sp.LAUNCH], f[sp.ADMIT], f[sp.CONCAT]
        assert f[sp.ENQUEUE] and all(_inside(e, launch)
                                     for e in f[sp.ENQUEUE])
        # admit -> concat -> ahead_wait -> launch: the rows are joined
        # before a slot is asked for
        assert admit.t1_ns <= concat.t0_ns
        assert concat.t1_ns == f[sp.AHEAD_WAIT].t0_ns
        assert f[sp.AHEAD_WAIT].t1_ns == launch.t0_ns
        for q in f[sp.QUEUE]:
            assert q.t1_ns <= admit.t1_ns and q.t0_ns <= launch.t0_ns
        assert min(q.t1_ns for q in f[sp.QUEUE]) == admit.t0_ns
        sync, resolve = f[sp.SYNC], f[sp.RESOLVE]
        assert sync.role == resolve.role == sp.COMPLETER
        assert launch.t1_ns <= sync.t0_ns <= sync.t1_ns == resolve.t0_ns


def test_chaos_fault_yields_a_recover_span_and_every_future_resolves():
    chaos = ChaosMonkey()
    cb, params, srv = _server(chaos=chaos)
    chaos.fail_next(BackendFault("chaos: injected"))
    srv.trace_spans(True)
    srv.start()
    rng = np.random.default_rng(3)
    xs = [_packed(rng, n) for n in (3, 2, 5)]
    futs = [srv.submit(x) for x in xs]
    srv.stop()
    for f, x in zip(futs, xs):
        assert f.done() and torch.equal(f.result().words,
                                        cb.apply(params, x).words)
    spans, _ = srv.spans()
    (rec,) = _by(spans, sp.RECOVER)
    assert rec.flight >= 0
    assert srv.stats()["faults"]["backend_fallbacks"] == 1
    # the degraded re-execution's enqueue is a child of the recover span
    redo = [s for s in _by(spans, sp.ENQUEUE) if s.flight == rec.flight]
    assert redo and all(_inside(e, rec) for e in redo)
    assert not [s for s in _by(spans, sp.LAUNCH) if s.flight == rec.flight]


def test_cap_drops_spans_and_counts_them():
    _, _, srv = _server()
    srv._recorder = sp.SpanRecorder(cap=3)
    srv.trace_spans(True)
    srv.start()
    _serve(srv, SIZES, seed=5)
    st = srv.stats()
    spans, dropped = srv.spans()
    flights = st["host_ns"][sp.LAUNCH]["count"]
    # queue a request; admit, concat, ahead_wait, launch, enqueue,
    # sync, resolve a flight (one chunk each)
    assert len(spans) + dropped == len(SIZES) + 7 * flights
    # the dispatcher and the completer each keep their first 3
    assert dropped > 0 and len(spans) == 6
    assert sorted(s.role for s in spans) == [sp.COMPLETER] * 3 + \
        [sp.DISPATCHER] * 3
    assert srv.spans() == ([], 0)


def test_trace_spans_off_stops_recording_and_keeps_what_was_kept():
    _, _, srv = _server()
    srv.trace_spans(True)
    srv.start()
    _serve(srv, (2, 3), seed=6, stop=False)
    srv.trace_spans(False)
    _serve(srv, (4, 1), seed=7)
    spans, dropped = srv.spans()
    assert dropped == 0
    assert len(_by(spans, sp.QUEUE)) == 2


def test_window_mean_queue_wait_equals_the_spans_of_the_window():
    _, _, srv = _server()
    srv.start()
    _serve(srv, SIZES[:4], seed=8, stop=False)
    s0 = srv.stats()
    srv.trace_spans(True)
    _serve(srv, SIZES, seed=9, stop=False)
    s1 = srv.stats()
    srv.trace_spans(False)
    srv.stop()
    spans, _ = srv.spans()
    launch_t0 = {s.flight: s.t0_ns for s in _by(spans, sp.LAUNCH)}
    waits = [launch_t0[q.flight] - q.t0_ns for q in _by(spans, sp.QUEUE)]
    a, b = s0["queue_wait_s"], s1["queue_wait_s"]
    assert b["count"] - a["count"] == len(waits) == len(SIZES)
    assert b["sum_ns"] - a["sum_ns"] == sum(waits)
    assert (b["sum_ns"] - a["sum_ns"]) / (b["count"] - a["count"]) == \
        pytest.approx(np.mean(waits))


def test_span_threads_record_lock_free_into_their_own_lists():
    rec = sp.SpanRecorder()

    def work(k):
        for i in range(100):
            rec.record(sp.ENQUEUE, k, i, i + 1)

    threads = [threading.Thread(target=work, args=(k,),
                                name=sp.THREAD_NAMES[sp.DISPATCHER])
               for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans, dropped = rec.drain()
    assert len(spans) == 400 and dropped == 0
    assert {s.role for s in spans} == {sp.DISPATCHER}
    assert [s.t0_ns for s in spans] == sorted(s.t0_ns for s in spans)
    assert rec.drain() == ([], 0)


# ------------------------------------------------------------------ #
# the histogram and the gap labels                                    #
# ------------------------------------------------------------------ #
def test_histogram_buckets_percentiles_and_max():
    h = sp.Histogram()
    values = [0, 1, 2, 3, 15, 16, 17, 31, 32, 1000, 1500, 10**6, 5 * 10**9]
    for v in values:
        h.add(v)
    assert h.count == len(values) and h.sum_ns == sum(values)
    assert h.max_ns == 5 * 10**9
    # one bucket a value below 16; 16 buckets an octave above
    assert h.buckets[:4] == [1, 1, 1, 1] and h.buckets[15] == 1
    assert h.buckets[16] == h.buckets[17] == h.buckets[31] == 1
    assert h.buckets[32] == 1                      # 32: the next octave
    assert sum(h.buckets) == len(values)
    s = h.summary()
    assert set(s) == {"mean", "p50", "p95", "p99", "max", "count", "sum_ns"}
    assert s["max"] == 5.0 and s["mean"] == pytest.approx(
        sum(values) / len(values) / 1e9)
    # the nearest-rank value (the 7th, 17) placed in its bucket [17, 18]
    assert 17 <= s["p50"] * 1e9 <= 18
    assert s["p99"] == 5.0
    assert s["p50"] <= s["p95"] <= s["p99"] <= s["max"]
    h2 = sp.Histogram()
    h2.add(2**63 - 1)
    assert h2.percentile_ns(0.5) == float(2**63 - 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_percentiles_within_a_few_percent(seed):
    rng = np.random.default_rng(seed)
    values = rng.lognormal(14.0, 1.5, 20_000).astype(np.int64)
    h = sp.Histogram()
    for v in values.tolist():
        h.add(v)
    ranked = np.sort(values)
    for q in (0.5, 0.95, 0.99):
        exact = ranked[int(np.ceil(q * len(values))) - 1]
        assert h.percentile_ns(q) == pytest.approx(exact, rel=1 / 16)
    c = h.copy()
    h.add(1)
    assert c.count == len(values) and c.buckets != h.buckets


def _span(name, t0, t1, role=sp.DISPATCHER, flight=0):
    return sp.Span(name, role, flight, t0, t1)


def test_label_gaps_sums_to_the_idle_time():
    spans = [_span(sp.ADMIT, 0, 10), _span(sp.CONCAT, 10, 14),
             _span(sp.AHEAD_WAIT, 14, 30), _span(sp.LAUNCH, 30, 60),
             _span(sp.ENQUEUE, 35, 55),
             _span(sp.SYNC, 0, 40, sp.COMPLETER),
             _span(sp.RESOLVE, 40, 70, sp.COMPLETER),
             _span(sp.ADMIT, 80, 90)]
    gaps = [(1005, 1015), (1025, 1040), (1058, 1085), (1200, 1210)]
    got = trace.label_gaps(gaps, spans, offset_ns=1000)
    assert got == {sp.LAUNCH: 10 + 2, sp.AHEAD_WAIT: 1 + 5, sp.CONCAT: 4,
                   sp.ADMIT: 5 + 5, sp.RECOVER: 0, "none": 20 + 10}
    assert sum(got.values()) == sum(e - s for s, e in gaps)
    done = trace.label_gaps(gaps, spans, 1000, sp.COMPLETER)
    assert done == {sp.SYNC: 10 + 15, sp.RESOLVE: 12, sp.RECOVER: 0,
                    "none": 15 + 10}
    assert trace.label_gaps([], spans, 0) == dict.fromkeys(
        (sp.LAUNCH, sp.AHEAD_WAIT, sp.CONCAT, sp.ADMIT, sp.RECOVER, "none"),
        0)


def test_clock_anchor_maps_perf_counter_onto_the_epoch():
    p, w = trace.clock_anchor()
    assert abs((time.time_ns() - w) - (time.perf_counter_ns() - p)) < 5e7


# ------------------------------------------------------------------ #
# on the card: the spans on the device trace's clock                   #
# ------------------------------------------------------------------ #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_graph_launches_fall_inside_enqueue_spans(cuda):
    from torch.profiler import ProfilerActivity, profile

    _, _, srv = _server(max_batch=64, device="cuda", backend="cuda",
                        prewarm=True)
    srv.start()
    rng = np.random.default_rng(10)
    pool = [_packed(rng, n, "cuda") for n in (1, 5, 17, 33, 64, 3)]
    stop = threading.Event()

    def caller(k):
        i = k
        while not stop.is_set():
            srv.submit(pool[i % len(pool)]).result(timeout=60)
            i += 1

    callers = [threading.Thread(target=caller, args=(k,)) for k in range(4)]
    for t in callers:
        t.start()
    try:
        time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
        srv.spans()
        srv.trace_spans(True)
        p, w = trace.clock_anchor()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(1.0)
        srv.trace_spans(False)
    finally:
        stop.set()
        for t in callers:
            t.join()
        srv.stop()
    spans, dropped = srv.spans()
    assert dropped == 0
    enq = sorted((s.t0_ns + w - p, s.t1_ns + w - p)
                 for s in _by(spans, sp.ENQUEUE))
    launches = [(e.start_ns(), e.start_ns() + e.duration_ns())
                for e in prof.profiler.kineto_results.events()
                if e.name() == "cudaGraphLaunch"]
    assert len(launches) > 50 and enq
    starts = [s for s, _ in enq]
    import bisect
    inside = 0
    for s, e in launches:
        i = bisect.bisect_right(starts, s) - 1
        inside += i >= 0 and enq[i][0] <= s and e <= enq[i][1]
    assert inside >= 0.99 * len(launches), (inside, len(launches))


def test_server_spans_tool_reads_windows_and_alignment():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "server_spans.py"
    spec = importlib.util.spec_from_file_location("server_spans", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    _, _, srv = _server()
    srv.start()
    _serve(srv, SIZES[:3], seed=11, stop=False)
    s0 = srv.stats()
    _serve(srv, SIZES, seed=12, stop=False)
    s1 = srv.stats()
    srv.stop()
    got = tool.window_numbers(s0, s1, 2.0, 100)
    assert got["images_per_s"] == 50.0
    assert got["enqueue_count"] == got["batches"] == got["launch_count"]
    assert got["launch_us_per_crossing"] > 0 and got["queue_wait_ms"] >= 0
    assert got["rows_per_flight"] == sum(SIZES) / got["batches"]
    assert tool.inside_share([(1, 2), (5, 6), (9, 12)],
                             [(0, 3), (4, 7), (10, 20)]) == 2 / 3
    spans = [_span(sp.QUEUE, 0, 4, sp.CALLER, 7),
             _span(sp.QUEUE, 2, 6, sp.CALLER, 7),
             _span(sp.ADMIT, 4, 8, flight=7),
             _span(sp.CONCAT, 8, 10, flight=7),
             _span(sp.AHEAD_WAIT, 10, 20, flight=7),
             _span(sp.LAUNCH, 20, 30, flight=7),
             _span(sp.SYNC, 30, 40, sp.COMPLETER, 7),
             _span(sp.RESOLVE, 40, 44, sp.COMPLETER, 7),
             _span(sp.RECOVER, 41, 43, sp.COMPLETER, 7)]
    got = tool.span_numbers(spans, [(15, 25), (38, 50)], 0)
    assert got["idle_by_dispatcher_span"] == {
        "launch": 5e-9, "ahead_wait": 5e-9, "concat": 0.0, "admit": 0.0,
        "recover": 0.0, "none": 12e-9}
    assert got["idle_by_completer_span"] == {
        "sync": 2e-9, "resolve": 4e-9, "recover": 0.0, "none": 16e-9}
    assert got["idle_in_launch_share"] == 100 * 5 / 22
    assert got["span_us"][sp.AHEAD_WAIT] == 10e-3
    assert got["queue_until_taken_ms"] == 4e-6
    assert got["taken_until_launch_ms"] == 15e-6     # 20 - 4, 20 - 6
    assert got["recovers"] == 1
