"""The copied operation counts equal the hand-computed totals of the
paper's count (§V-C) and the program's own ``core/workloads.py``."""
from __future__ import annotations

import json

import pytest
from conftest import ROOT

from portbench import counts


def _layers(name):
    return json.loads((ROOT / "portbench" / "configs" /
                       f"{name}.json").read_text())["layers"]


def _conv(c_in, c_out, k, out):
    return 2 * c_in * k * k * out * out * c_out + out * out * c_out


BINARYNET = (_conv(3, 128, 3, 32) + _conv(128, 128, 3, 32)
             + _conv(128, 256, 3, 16) + _conv(256, 256, 3, 16)
             + _conv(256, 512, 3, 8) + _conv(512, 512, 3, 8)
             + 2 * 8192 * 1024 + 1024 + 2 * 1024 * 1024 + 1024
             + 2 * 1024 * 10 + 10)
ALEXNET = (_conv(3, 96, 11, 55) + _conv(96, 256, 5, 27)
           + _conv(256, 384, 3, 13) + _conv(384, 384, 3, 13)
           + _conv(384, 256, 3, 13)
           + 2 * 9216 * 4096 + 4096 + 2 * 4096 * 4096 + 4096
           + 2 * 4096 * 1000 + 1000)


@pytest.mark.parametrize("name,total,workload", [
    ("binarynet-cifar10", BINARYNET, "binarynet"),
    ("xnor-alexnet", ALEXNET, "alexnet")])
def test_total_ops(name, total, workload):
    from repro_torch.core.workloads import WORKLOADS

    layers = counts.compute_layers(_layers(name))
    assert counts.total_ops(layers) == total
    assert total == WORKLOADS[workload].total_ops


def test_least_seconds_per_image():
    assert counts.least_s_per_image(_layers("binarynet-cifar10")) == \
        pytest.approx(0.0810e-6, rel=2e-3)
    assert counts.least_s_per_image(_layers("xnor-alexnet")) == \
        pytest.approx(0.6330e-6, rel=2e-3)


def test_bounds_are_below_the_ops_alone_never():
    """A bound is at least each layer's operations at its peak, and
    grows with the rows."""
    layers = _layers("xnor-alexnet")
    ints = [ly for ly in layers if counts.is_integer(ly)]
    b = counts.bound_s(layers, 256, integer=True)
    assert b >= 256 * counts.total_ops(ints) / counts.INT8_OPS_PER_S
    assert b == pytest.approx(143e-6, rel=0.01)
    assert counts.bound_s(layers, 512, integer=False) > \
        counts.bound_s(layers, 256, integer=False)
