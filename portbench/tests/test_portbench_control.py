"""The check fails what it must fail.

* The control: the reference in the precision below the one the
  configuration states, put in the program's place, comes out as not
  correct (int4 pixels for BinaryNet, on the CPU; TF32 for AlexNet,
  which exists only on the card).
* A run whose timed path is broken underneath comes out as not
  correct: an answer altered where it is produced, and half of each
  flight's rows left out.  (The other faults of the list are a
  training step's or an exchange between chips', which no cell has.)
"""
from __future__ import annotations

import json

import pytest
import torch
from conftest import ROOT, TINY

from portbench import harness
from portbench.systems import bnn


def _sample(pool, sizes):
    out, off = [], 0
    for n in sizes:
        out.append((off, n, None))
        off += n
    return out


@pytest.mark.parametrize("name,rows", [("tiny", 64),
                                       ("binarynet-cifar10", 16)])
def test_int4_control_is_not_correct(name, rows):
    config = TINY if name == "tiny" else json.loads(
        (ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    assert config["control"] == "int4"
    weights, pool = bnn.make_data(
        config, {"sizes": {"dist": "uniform_int", "lo": 1, "hi": rows}},
        2**31 + 3, "cpu")
    found = bnn.compare(config["layers"], weights, pool,
                        _sample(pool, [rows // 2, rows // 2]), "int4")
    assert found["images"] == rows
    assert found["mismatch_share"] > config["check"]["mismatch_share_limit"]


@pytest.mark.gpu
def test_tf32_control_is_not_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on a CUDA card")
    config = json.loads((ROOT / "portbench" / "configs" /
                         "xnor-alexnet.json").read_text())
    assert config["control"] == "tf32"
    weights, pool = bnn.make_data(
        config, {"sizes": {"dist": "uniform_int", "lo": 1, "hi": 512}},
        2**31 + 7, "cuda")
    found = bnn.compare(config["layers"], weights, pool,
                        _sample(pool, [256, 256]), "tf32")
    assert found["mismatch_share"] > config["check"]["mismatch_share_limit"]


def _run(checkout, cell):
    return harness.run_cell(checkout, cell, 2**31 + 1, 1.0, False, "cpu",
                            0.0, log=lambda s: None)


@pytest.mark.parametrize("cell,metric", [("tiny-bulk", "images_per_s"),
                                         ("tiny-online", "p95_latency_ms")])
def test_sound_run_is_correct(checkout, cell, metric):
    r = _run(checkout, cell)
    assert r["correct"] is True
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["metrics"][metric]["value"] > 0
    assert r["metrics"]["setup_s"]["value"] > 0
    assert list(r)[-1] == "checks"


def _altered(apply):
    def broken(self, params, x, valid_rows=None):
        y = apply(self, params, x, valid_rows=valid_rows)
        y = y.clone()
        y[:, 0] += 2.0             # one logit of every answer, changed
        return y
    return broken


def _half_left_out(apply):
    def broken(self, params, x, valid_rows=None):
        y = apply(self, params, x, valid_rows=valid_rows)
        keep = (y.shape[0] + 1) // 2
        return torch.cat([y[:keep], torch.zeros_like(y[keep:])])
    return broken


@pytest.mark.parametrize("fault", [_altered, _half_left_out])
@pytest.mark.parametrize("cell", ["tiny-bulk", "tiny-online"])
def test_broken_timed_path_is_not_correct(checkout, cell, fault,
                                          monkeypatch):
    from repro_torch.graph.compile import CompiledBNN

    monkeypatch.setattr(CompiledBNN, "apply", fault(CompiledBNN.apply))
    r = _run(checkout, cell)
    assert r["correct"] is False
    assert r["checks"]["mismatch_share"]["value"] > \
        r["checks"]["mismatch_share"]["limit"]
