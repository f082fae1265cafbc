"""Where BNNServer's host threads are while the card idles, in one cell
of the benchmark.

    python3 tools/server_spans.py --workload binarynet-bulk --seed 7
        [--seconds 20] [--windows off,on,on,off] [--slices on,off]
        [--out chiprun_out/server_spans.jsonl]

Builds the cell as ``portbench/run.py`` does (its configuration and
closed-loop traffic from this checkout's ``BENCHMARK.json``, the server
of ``portbench/systems/<family>.py``, on the CUDA card), warms up for
the traffic's ``warmup_s``, then measures back-to-back windows of
``--seconds``, the server's spans on or off in each as ``--windows``
says.  For a window: the images answered in it a second (the
benchmark's ``images_per_s``) and, from ``stats()`` deltas, the host µs
a flight of each boundary of ``stats()["host_ns"]``, the mean queue
wait, and the ``enqueue`` count against the ``batches`` delta.  Then,
with the traffic still on, one torch.profiler slice of ``SLICE_S`` for
each entry of ``--slices`` (spans on or off in it): the device idle
share; with spans on, the idle seconds labelled by the dispatcher's
and by the completer's span at each instant
(``repro_torch.trace.label_gaps`` after ``clock_anchor``), the share of
idle in ``launch``, the mean µs of each kind of span, a request's mean
wait split where it was taken (its ``queue`` span, then to its flight's
``launch``), the ``recover`` spans, and the share of ``cudaGraphLaunch``
calls that fall inside an ``enqueue`` span (the clocks' alignment).
Prints one JSON object and appends it to ``--out``.

The slice's profiler loop copies ``portbench/profiling.profile_slice``,
and ``trace.idle_gaps`` its busy-interval union: both go once the
benchmark's traced runs switch the spans on and read them.
"""
from __future__ import annotations

import argparse
import bisect
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
SLICE_S = 2.0             # a profiled slice, as the benchmark's


def window_numbers(s0: Dict, s1: Dict, seconds: float, images: int
                   ) -> Dict[str, float]:
    """A window's numbers from two ``stats()`` snapshots around it."""
    out: Dict[str, float] = {"images_per_s": images / seconds}
    h0, h1 = s0["host_ns"], s1["host_ns"]
    for name in h1:
        n = h1[name]["count"] - h0[name]["count"]
        ns = h1[name]["total_ns"] - h0[name]["total_ns"]
        out[f"{name}_us_per_crossing"] = ns / n / 1e3 if n else None
        out[f"{name}_count"] = n
    out["batches"] = s1["batches"] - s0["batches"]
    q0, q1 = s0.get("queue_wait_s"), s1["queue_wait_s"]
    n = q1["count"] - (q0["count"] if q0 else 0)
    ns = q1["sum_ns"] - (q0["sum_ns"] if q0 else 0)
    out["queue_wait_ms"] = ns / n / 1e6 if n else None
    out["rows_per_flight"] = (s1["real_rows"] - s0["real_rows"]) / \
        out["batches"] if out["batches"] else None
    return out


def inside_share(calls: Sequence[Tuple[int, int]],
                 spans: Sequence[Tuple[int, int]]) -> float:
    """The share of ``calls`` that fall wholly inside one of ``spans``
    (sorted, not overlapping)."""
    starts = [s for s, _ in spans]
    n = 0
    for s, e in calls:
        i = bisect.bisect_right(starts, s) - 1
        n += i >= 0 and spans[i][0] <= s and e <= spans[i][1]
    return n / len(calls) if calls else float("nan")


def span_numbers(spans: Sequence, gaps: Sequence[Tuple[int, int]],
                 offset: int) -> Dict:
    """What a slice's spans say: the idle ns labelled by the
    dispatcher's and by the completer's span, the mean µs of each kind
    of span, a request's mean wait until taken (``queue``) and from
    then to its flight's ``launch``, and the ``recover`` spans."""
    from repro_torch import trace
    from repro_torch.serving import spans as sp

    idle_ns = sum(e - s for s, e in gaps)
    out: Dict = {}
    for role in (sp.DISPATCHER, sp.COMPLETER):
        labels = trace.label_gaps(gaps, spans, offset, role)
        out[f"idle_by_{role}_span"] = {k: v / 1e9 for k, v in labels.items()}
        if role == sp.DISPATCHER:
            out["idle_in_launch_share"] = \
                100 * labels[sp.LAUNCH] / idle_ns if idle_ns else None
    by_name: Dict[str, List[int]] = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s.t1_ns - s.t0_ns)
    out["span_us"] = {k: statistics.mean(v) / 1e3
                      for k, v in sorted(by_name.items())}
    launch_t0 = {s.flight: s.t0_ns for s in spans if s.name == sp.LAUNCH}
    queued = [s for s in spans if s.name == sp.QUEUE]
    after = [launch_t0[q.flight] - q.t1_ns for q in queued
             if q.flight in launch_t0]
    out["queue_until_taken_ms"] = statistics.mean(
        q.t1_ns - q.t0_ns for q in queued) / 1e6 if queued else None
    out["taken_until_launch_ms"] = \
        statistics.mean(after) / 1e6 if after else None
    out["recovers"] = len(by_name.get(sp.RECOVER, ()))
    return out


def profiled_slice(server, spans_on: bool, tries: int = 10) -> Dict:
    """One profiled slice of the running traffic (asked again after a
    session without a device event, as the benchmark does)."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import profiling
    from repro_torch import trace
    from repro_torch.serving import spans as sp

    for attempt in range(tries):
        server.spans()
        server.trace_spans(spans_on)
        perf, wall = trace.clock_anchor()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            r0 = server.stats()["real_rows"]
            time.sleep(SLICE_S)
            r1 = server.stats()["real_rows"]
        server.trace_spans(False)
        events = list(prof.profiler.kineto_results.events())
        sl = profiling.analyse(events, r1 - r0)
        spans, dropped = server.spans()
        if sl is None:
            time.sleep(0.05 * (attempt + 1))
            continue
        gaps = trace.idle_gaps(events)
        out = {"spans": spans_on, "sessions": attempt + 1,
               "window_s": sl.window_s, "busy_s": sl.busy_s,
               "device_idle_share": 100 * (1 - sl.busy_s / sl.window_s),
               "idle_s": sum(e - s for s, e in gaps) / 1e9,
               "idle_gaps": sl.idle_by_host[:6],
               "rows": sl.rows, "spans_kept": len(spans),
               "spans_dropped": dropped}
        if spans_on:
            offset = wall - perf
            out.update(span_numbers(spans, gaps, offset))
            enq = sorted((s.t0_ns + offset, s.t1_ns + offset)
                         for s in spans if s.name == sp.ENQUEUE)
            calls = [(e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in events if e.name() == "cudaGraphLaunch"]
            out["graph_launches"] = len(calls)
            out["graph_launches_in_enqueue"] = inside_share(calls, enq)
        return out
    return {"spans": spans_on, "sessions": tries, "empty": True}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--windows", default="off,on,on,off")
    ap.add_argument("--slices", default="on,off")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "server_spans.jsonl")
    args = ap.parse_args(argv)
    windows = [w == "on" for w in args.windows.split(",") if w]
    slices = [w == "on" for w in args.slices.split(",") if w]

    from portbench import clients, harness, profiling

    cell = harness.load_cell(ROOT, args.workload)
    traffic = cell.traffic
    if traffic["kind"] != "closed_loop":
        raise SystemExit("only closed-loop cells are measured here")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()
    profiling.warm()
    adapter = harness.load_module(
        ROOT / "portbench" / "systems" / f"{cell.config['family']}.py",
        "server_spans_system")
    system = adapter.System(cell.config, traffic, args.seed, "cuda")
    server = system.server
    gc.collect()
    gc.freeze()
    sampler = clients.Sampler(int(traffic["check_requests"]), args.seed)
    t_start = time.perf_counter()
    t0 = t_start + float(traffic["warmup_s"])
    edges = [t0 + i * args.seconds for i in range(len(windows) + 1)]
    slice_total = len(slices) * 3 * SLICE_S
    until = edges[-1] + slice_total + 1.0
    loop = clients.ClosedLoop(system, traffic, args.seed, sampler)
    loop.start(edges[0], edges[-1], until=until)
    snaps = []
    for i, on in enumerate(windows):
        time.sleep(max(0.0, edges[i] - time.perf_counter()))
        server.trace_spans(on)
        snaps.append(server.stats())
    time.sleep(max(0.0, edges[-1] - time.perf_counter()))
    server.trace_spans(False)
    snaps.append(server.stats())
    kept, dropped = server.spans()
    sliced = [profiled_slice(server, on) for on in slices]
    out = loop.finish(until + 60.0)
    system.close()
    gc.unfreeze()

    images = [0] * len(windows)
    for t, n in out.answers:
        images[min(len(windows) - 1, int((t - edges[0]) // args.seconds))] \
            += n
    rows: List[Dict] = []
    for i, on in enumerate(windows):
        r = window_numbers(snaps[i], snaps[i + 1], args.seconds, images[i])
        r["spans"] = on
        rows.append(r)
    result = {"workload": args.workload, "seed": args.seed, "card": card,
              "seconds": args.seconds, "failed": out.failed,
              "windows": rows, "window_spans_kept": len(kept),
              "window_spans_dropped": dropped, "slices": sliced}
    for on in (False, True):
        v = [r["images_per_s"] for r in rows if r["spans"] == on]
        if v:
            result[f"images_per_s_spans_{'on' if on else 'off'}"] = \
                statistics.mean(v)
    line = json.dumps(result)
    print(line, flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("a") as f:
        f.write(line + "\n")
    return 0 if out.failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
