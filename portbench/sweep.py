"""Find the knee of an open-loop cell: the highest rate whose backlog
does not grow through the window.

    python3 portbench/sweep.py --workload alexnet-online --seed 7
        --seconds 8 --rates 2000 4000 6000 ...

Sets up the cell's server once, then for each rate (requests per second)
runs the cell's traffic at that rate: ``warmup_s`` seconds, then the
window, then one second more under torch.profiler (after the window, so
that the profiler's own stalls time no request).  One JSON line per
rate: the p95 of the requests due in the window, the images answered per
second, the backlog (requests sent and unanswered) at the window's start
and end, the share of the traced second the card was busy, and the
generator's lateness.  The cell's own rate is set once from this, at
about four fifths of the knee, and written into its traffic file.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:] = [str(ROOT), str(ROOT / "src")] + \
    [p for p in sys.path[1:] if Path(p or ".").resolve() != ROOT / "portbench"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    from portbench import clients, harness, profiling

    if not torch.cuda.is_available():
        print("the sweep runs on a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    if cell.traffic["kind"] != "open_loop":
        raise SystemExit(f"{args.workload} is not an open-loop cell")
    adapter = harness.load_module(
        ROOT / "portbench" / "systems" / f"{cell.config['family']}.py",
        "portbench_system")
    profiling.warm()
    system = adapter.System(cell.config, cell.traffic, args.seed, "cuda")
    gc.collect()
    gc.freeze()                  # as a run does after its set-up
    warmup = float(cell.traffic["warmup_s"])
    for rate in args.rates:
        sampler = clients.Sampler(1, args.seed)
        loop = clients.OpenLoop(system, cell.traffic, args.seed, sampler,
                                rate=rate)
        t_start = time.perf_counter()
        t0, t1 = t_start + warmup, t_start + warmup + args.seconds
        loop.start(t_start, t0, t1, until=t1 + 2.0)
        time.sleep(max(0.0, t0 - time.perf_counter()))
        backlog0 = loop.outstanding()
        time.sleep(max(0.0, t1 - time.perf_counter()))
        backlog1 = loop.outstanding()
        sl, _, _ = profiling.profile_slice(
            1.0, lambda: system.stats()["real_rows"], t1 + 2.0)
        out = loop.finish(t1 + harness.GIVE_UP_S)
        lat = sorted(out.latencies_s)
        line = {
            "workload": args.workload, "requests_per_s": rate,
            "images_per_s_offered": rate * sum(
                clients.size_levels(cell.traffic["sizes"])) / len(
                clients.size_levels(cell.traffic["sizes"])),
            "images_per_s_answered": out.images / args.seconds,
            "p50_ms": clients.percentile(lat, 0.5) * 1e3,
            "p95_ms": clients.percentile(lat, 0.95) * 1e3,
            "requests": out.attempted, "failed": out.failed,
            "backlog_start": backlog0, "backlog_end": backlog1,
            "busy_share": None if sl is None else sl.busy_s / sl.window_s,
            "lateness_p99_ms": clients.percentile(out.lateness_s, 0.99) * 1e3
            if out.lateness_s else None}
        print(json.dumps(line), flush=True)
        drained = time.perf_counter() + harness.GIVE_UP_S
        while loop.outstanding() > 0 and time.perf_counter() < drained:
            time.sleep(0.1)
    system.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
