"""Puts the checkout's root (for ``portbench``) and ``src`` (for the
port the benchmark measures) on the path, and gives the tests a small
checkout of their own: ``BENCHMARK.json`` plus a tiny configuration
and CPU-sized traffic, beside links to this ``portbench``."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "name": "tiny", "source": "a test configuration", "family": "bnn",
    "reduced": [], "input_shape": [8, 8, 3],
    "check": {"mismatch_share_limit": 0.0, "failed_limit": 0},
    "control": "int4",
    "layers": [
        {"op": "conv", "name": "conv1", "kind": "integer", "c_in": 3,
         "c_out": 32, "k": 3, "stride": 1, "pad": 1, "in_hw": 8,
         "out_hw": 8},
        {"op": "conv", "name": "conv2", "kind": "binary", "c_in": 32,
         "c_out": 32, "k": 3, "stride": 1, "pad": 1, "in_hw": 8,
         "out_hw": 8},
        {"op": "maxpool", "window": 2, "stride": 2},
        {"op": "dense", "name": "fc1", "n_in": 512, "n_out": 64},
        {"op": "dense", "name": "fc2", "n_in": 64, "n_out": 10}]}

TINY_CLOSED = {"kind": "closed_loop", "clients": 2,
               "sizes": {"dist": "log_uniform", "lo": 4, "hi": 32,
                         "levels": 8},
               "warmup_s": 0.3, "server": {"max_batch": 32},
               "check_requests": 4}
TINY_OPEN = {"kind": "open_loop", "arrivals": "poisson",
             "requests_per_s": 40, "sizes": {"dist": "uniform_int",
                                             "lo": 1, "hi": 4},
             "warmup_s": 0.3, "server": {"max_batch": 8},
             "check_requests": 16}


def add_files(root: Path, config=None, traffic=None, cells=()) -> None:
    """Drop a configuration, a traffic file and cells into the checkout
    at ``root``: new files and new entries only."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if config is not None:
        path = root / "portbench" / "configs" / f"{config['name']}.json"
        path.write_text(json.dumps(config))
        bench["configs"].append({"name": config["name"],
                                 "source": config["source"],
                                 "file": str(path.relative_to(root)),
                                 "reduced": [], "why": "test"})
    for name, body in (traffic or {}).items():
        (root / "portbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(body))
    for cell, cfg, mix, like in cells:
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": mix, "chips": 1,
                                   "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and like in m["workloads"]:
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


# the open-loop cell's metrics, whose readers wait in portbench/metrics
# for an online cell (PERF.md, Open questions)
ONLINE_METRICS = {
    "end_to_end": [{"name": "p95_latency_ms", "unit": "ms",
                    "better": "lower", "bound": 0.25,
                    "source": "host_clock", "workloads": ["tiny-online"]}],
    "per_layer": [{"name": f"{m}.online", "unit": u, "better": b,
                   "source": src, "layer": layer,
                   "moves": "p95_latency_ms", "workloads": ["tiny-online"]}
                  for m, u, b, src, layer in (
                      ("rows_per_flight", "rows", "higher",
                       "program_counter", "server"),
                      ("device_idle_share", "%", "lower", "device_trace",
                       "device"))]}


@pytest.fixture
def checkout(tmp_path: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``portbench/`` with the tiny
    configuration and its two cells, ``tiny-bulk`` (with the bulk cells'
    metrics) and ``tiny-online`` (with the open-loop metrics), added as
    new files and entries."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_files(tmp_path, TINY, {"tiny-closed": TINY_CLOSED,
                               "tiny-open": TINY_OPEN},
              [("tiny-bulk", "tiny", "tiny-closed", "alexnet-bulk"),
               ("tiny-online", "tiny", "tiny-open", None)])
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for key, ms in ONLINE_METRICS.items():
        bench[key] += ms
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path
