"""The plain reference equals the port's plain-torch forward
(``backend="torch"``) on the same float weights and images, on the
CPU: the tiny configuration at a few rows, and the two benchmark
configurations at their full widths on one or two images."""
from __future__ import annotations

import json

import pytest
import torch
from conftest import ROOT, TINY

from portbench.reference import bnn as reference
from portbench.systems import bnn


def _config(name):
    if name == "tiny":
        return TINY
    return json.loads((ROOT / "portbench" / "configs" /
                       f"{name}.json").read_text())


@pytest.mark.parametrize("name,rows", [("tiny", 6),
                                       ("binarynet-cifar10", 2),
                                       ("xnor-alexnet", 1)])
def test_reference_equals_the_ports_torch_forward(name, rows):
    from repro_torch import graph

    config = _config(name)
    traffic = {"sizes": {"dist": "uniform_int", "lo": 1, "hi": rows}}
    weights, pool = bnn.make_data(config, traffic, 2**31 + 11, "cpu")
    x = pool[:rows]
    cb = graph.compile(bnn.workload_of(config), backend="torch",
                       device="cpu", batch=rows)
    params = bnn.port_params(cb, config["layers"], weights)
    with torch.no_grad():
        got = cb.apply(params, x)
    want = reference.logits(config["layers"], weights, x)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)


def test_reference_tracks_each_threshold():
    """Moving one threshold of the tiny net's last hidden layer moves
    the reference's logits (the thresholds are read, not ignored)."""
    weights, pool = bnn.make_data(TINY, {"sizes": {"dist": "uniform_int",
                                                   "lo": 1, "hi": 4}},
                                  5, "cpu")
    a = reference.logits(TINY["layers"], weights, pool[:8])
    weights[2]["t"] = weights[2]["t"] + 40
    b = reference.logits(TINY["layers"], weights, pool[:8])
    assert not torch.equal(a, b)
