"""The benchmark is driven by data: every cell's configuration, traffic
and metrics are found by name, and a new configuration, traffic mix and
per-layer metric are picked up as new files alone."""
from __future__ import annotations

import hashlib
import json
import re
from pathlib import Path

import pytest
from conftest import ROOT, add_files

from portbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_contract_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"])
               for m in BENCH["end_to_end"] + BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    c = harness.load_cell(ROOT, cell)
    assert c.config["name"] == c.workload["config"]
    assert c.traffic["kind"] in ("closed_loop", "open_loop")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    # every per-layer metric's end-to-end metric is reported in the cell
    assert all(m["moves"] in names for m in c.per_layer)
    for m in c.end_to_end + c.per_layer:
        reader = harness.load_module(
            ROOT / "portbench" / "metrics" / f"{m['name']}.py", "reader")
        assert callable(reader.read)
    fam = c.config["family"]
    assert (ROOT / "portbench" / "systems" / f"{fam}.py").exists()
    assert (ROOT / "portbench" / "reference" / f"{fam}.py").exists()


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_matches_entry(cfg):
    body = json.loads((ROOT / cfg["file"]).read_text())
    assert body["name"] == cfg["name"]
    assert body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"] == []


def _digests(root: Path):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_config_traffic_and_metric_are_new_files_alone(checkout):
    """A configuration, a traffic mix and a per-layer metric, each
    added as a new file with new entries, are found and run; no file
    that was there changes but ``BENCHMARK.json``'s entries."""
    before = _digests(checkout / "portbench")
    new_cfg = dict(json.loads(
        (checkout / "portbench/configs/tiny.json").read_text()),
        name="tiny2")
    add_files(checkout, new_cfg,
              {"tiny-closed2": {"kind": "closed_loop", "clients": 1,
                                "sizes": {"dist": "uniform_int", "lo": 2,
                                          "hi": 6},
                                "warmup_s": 0.2,
                                "server": {"max_batch": 8},
                                "check_requests": 2}},
              [("tiny2-bulk", "tiny2", "tiny-closed2", "alexnet-bulk")])
    (checkout / "portbench/metrics/flights.py").write_text(
        "def read(run):\n    return run.stats['batches']\n")
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "flights", "unit": "flights",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "server", "moves": "images_per_s",
                               "workloads": ["tiny2-bulk"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(checkout / "portbench")
    assert all(after[p] == d for p, d in before.items())

    r = harness.run_cell(checkout, "tiny2-bulk", 11, 1.0, True, "cpu", 0.0,
                         log=lambda s: None)
    assert r["correct"] is True
    assert r["metrics"]["flights"]["value"] > 0
    assert "rows_per_flight.bulk" in r["metrics"]
    # device-trace metrics find nothing to read on the CPU: left out
    assert "packed_conv2d_roofline" not in r["metrics"]
