"""One run of one cell: set-up, warm-up, the measured window, the check,
the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives
it, under the checkout's ``portbench/``:

* the cell (``workloads`` entry) names its configuration and traffic;
* the configuration's ``file`` holds its layer table, its ``family``
  (the adapter ``portbench/systems/<family>.py`` that builds the program
  and checks it against ``portbench/reference/<family>.py``) and its
  check limits;
* the traffic is ``portbench/traffic/<traffic>.json``;
* each metric, end-to-end or per-layer, is read by
  ``portbench/metrics/<name>.py``, whose ``read(run)`` returns a number,
  or None where it finds nothing to read, and then the metric is left
  out of the line.  A run without trace reports the cell's end-to-end
  metrics, a traced run its per-layer ones.

A run: the adapter builds the weights and the input pool from the seed
on the device, compiles, prewarms and starts the server; the cell's own
traffic runs ``warmup_s`` seconds, then ``seconds`` are measured; with
``trace``, the same traffic runs on and torch.profiler watches a slice
of up to ``SLICE_S`` seconds right after the window (the profiler's
start and its reading stall the host, which must not fall into the
window).  Then the program's peak memory is read, its state freed, and
the sampled answers are compared with the reference.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from portbench import clients, profiling

# how long past the close an answer is waited for (a later answer is
# late, not wrong; one that never comes is a failure)
GIVE_UP_S = 60.0
SLICE_S = 2.0             # the profiled slice of a traced run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class _GcPauses:
    """The cyclic collector's passes inside the window, timed (a pass
    holds the interpreter lock, so every thread of the run waits)."""

    def __init__(self, t0: float, t1: float):
        self.t0, self.t1 = t0, t1
        self.count = 0
        self.total = self.longest = 0.0
        self._start = 0.0

    def __call__(self, phase: str, info: Dict) -> None:
        now = time.perf_counter()
        if phase == "start":
            self._start = now
        elif self.t0 <= self._start < self.t1:
            self.count += 1
            self.total += now - self._start
            self.longest = max(self.longest, now - self._start)


@dataclass
class Cell:
    name: str
    workload: Dict
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


@dataclass
class Run:
    """What a per-layer reader may read: the cell, the window's counts
    and the traced slice."""
    cell: Cell
    seconds: float
    setup_s: float
    outcome: clients.Outcome
    stats: Dict[str, float] = field(default_factory=dict)  # window deltas
    slice: Optional[profiling.SliceTrace] = None

    @property
    def layers(self) -> List[Dict]:
        return self.cell.config["layers"]


def _reports(metric: Dict, cell: str, e2e: List[Dict]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return any(m["name"] == metric.get("moves") for m in e2e)


def load_cell(root: Path, name: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; cells: "
                         f"{[w['name'] for w in bench['workloads']]}")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" /
                          f"{wl['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, e2e)]
    return Cell(name, wl, config, traffic, e2e, per_layer)


def load_module(path: Path, name: str) -> Any:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise SystemExit(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stat_delta(a: Dict, b: Dict) -> Dict[str, float]:
    return {k: b[k] - a[k] for k in ("requests", "rows", "batches",
                                     "padded_rows", "valid_rows",
                                     "real_rows")}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (the whole name compared, so ``repro_torch`` passes)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _metric(value: float, unit: str) -> Dict:
    return {"value": value, "unit": unit}


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str, t_process: float, log=print,
             probe: Optional[Callable[[], str]] = None) -> Dict:
    """Run cell ``name`` once; returns the result object (the last line
    the benchmark prints).  ``log`` takes the lines for standard error;
    ``probe``, where given, reads the card's state (clocks, temperature,
    power) before the warm-up and once the window has closed."""
    cell = load_cell(root, name)
    config, traffic = cell.config, cell.traffic
    family = config["family"]
    adapter = load_module(root / "portbench" / "systems" / f"{family}.py",
                          f"portbench_system_{family}")
    metric_set = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: load_module(root / "portbench" / "metrics" /
                                      f"{m['name']}.py",
                                      f"portbench_metric_{m['name']}")
               for m in metric_set}
    if trace and device == "cuda":
        profiling.warm()
    system = adapter.System(config, traffic, seed, device)
    # what set-up made lives as long as the run: out of the collector's
    # reach, as a long-running server puts it after start-up, so that a
    # full pass does not walk all of torch inside the window
    gc.collect()
    gc.freeze()
    if probe is not None:
        log(f"card before the warm-up: {probe()}")
    sampler = clients.Sampler(int(traffic["check_requests"]), seed)
    kind = traffic["kind"]
    warmup = float(traffic["warmup_s"])
    t_start = time.perf_counter()
    t0, t1 = t_start + warmup, t_start + warmup + seconds
    # traced, the traffic runs on past the window for the profiled slice,
    # so that the profiler's own stalls fall outside the window
    slice_s = min(SLICE_S, seconds / 3)
    until = t1 + 3 * slice_s if trace else t1
    if kind == "closed_loop":
        loop: Any = clients.ClosedLoop(system, traffic, seed, sampler)
        loop.start(t0, t1, until=until)
    elif kind == "open_loop":
        loop = clients.OpenLoop(system, traffic, seed, sampler)
        loop.start(t_start, t0, t1, until=until)
    else:
        raise SystemExit(f"unknown traffic kind {kind!r}")
    time.sleep(max(0.0, t0 - time.perf_counter()))
    s0 = system.stats()
    setup_s = t0 - t_process
    pauses = _GcPauses(t0, t1)
    gc.callbacks.append(pauses)
    time.sleep(max(0.0, t1 - time.perf_counter()))
    s1 = system.stats()
    gc.callbacks.remove(pauses)
    sl = None
    if trace:
        sl, opened, empty = profiling.profile_slice(
            slice_s, lambda: system.stats()["real_rows"], until)
        log(f"profiler: {opened} sessions, {empty} without a device event")
    out = loop.finish(until + GIVE_UP_S)
    if probe is not None:
        log(f"card after the window: {probe()}")
    peak = system.memory_peak()
    device_kind = system.device_name()
    system.close()
    gc.unfreeze()
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package are loaded: {bad}")
        raise SystemExit(3)

    if out.lateness_s:
        log(f"generator lateness: p50 "
            f"{clients.percentile(out.lateness_s, 0.5) * 1e3:.4f} ms, p99 "
            f"{clients.percentile(out.lateness_s, 0.99) * 1e3:.4f} ms over "
            f"{len(out.lateness_s)} sends")
    if out.errors:
        log(f"request errors: {out.errors}")
    log(f"collector in the window: {pauses.count} passes, longest "
        f"{pauses.longest * 1e3:.3f} ms, {pauses.total * 1e3:.3f} ms in all")
    per_s = [0] * max(1, int(math.ceil(seconds)))
    for t, n in out.answers:
        per_s[min(len(per_s) - 1, int(t - t0))] += n
    log(f"images answered in each second of the window: {per_s}")
    run = Run(cell, seconds, setup_s, out, _stat_delta(s0, s1), sl)
    metrics: Dict[str, Dict] = {}
    for m in metric_set:
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = _metric(v, m["unit"])
    log(f"window: {out.requests_done} requests, {out.images} images "
        f"answered in {seconds} s; server flights {run.stats['batches']}, "
        f"real rows {run.stats['real_rows']}, padded rows "
        f"{run.stats['padded_rows']}")

    sample = sampler.sample()
    found = system.check(sample)
    checks = {
        "failed": {"value": out.failed,
                   "limit": config["check"]["failed_limit"]},
        "mismatch_share": {"value": found["mismatch_share"],
                           "limit": config["check"]["mismatch_share_limit"]},
    }
    log(f"check: {found['images']} images of {len(sample)} requests "
        f"compared with the reference; worst logit gap "
        f"{found['max_abs_diff']}")
    correct = bool(found["images"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": device_kind, "count": 1, "memory_peak_bytes": peak}
    result: Dict[str, Any] = {"correct": correct,
                              "attempted": out.attempted,
                              "failed": out.failed, "metrics": metrics,
                              "device": dev}
    if trace and sl is not None:
        dev["busy_s"] = sl.busy_s
        dev["window_s"] = sl.window_s
        result["breakdown"] = {
            "device_ops": sorted(sl.group_s.items(),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": sl.idle_by_host[:10]}
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k}: {c['value']} (limit {c['limit']})")
    return result
