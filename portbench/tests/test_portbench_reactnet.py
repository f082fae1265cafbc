"""The ``reactnet`` family's adapter at a tiny size on the CPU: a run of
a tiny ReActNet cell is correct, its check fails an altered answer, and
the control (the reference with 4-bit pixels, which the CPU can run)
reads above the limit; the adapter's table is the program's IR."""
from __future__ import annotations

import json

import pytest
from conftest import ROOT, add_files

from portbench import counts, counts_reactnet, harness
from portbench.reference import reactnet as reference
from portbench.systems import reactnet

CONFIG = json.loads((ROOT / "portbench" / "configs" /
                     "reactnet-a.json").read_text())


def _tiny():
    """ReActNet's structure on 16x16 images: the stem to 32 channels, a
    doubling, a stride-2 block (average shortcut, then a doubling) and
    an identity block, a head of 10."""
    rows = [{"op": "real_conv", "name": "stem", "c_in": 3, "c_out": 32,
             "k": 3, "stride": 2, "pad": 1, "in_hw": 16, "out_hw": 8}]
    hw, c = 8, 32
    for i, (p, s) in enumerate(((64, 1), (128, 2), (128, 1))):
        ho = hw // s
        rows.append({"op": "conv", "kind": "binary",
                     "name": f"block{i}.conv3x3", "c_in": c, "c_out": c,
                     "k": 3, "stride": s, "pad": 1, "in_hw": hw,
                     "out_hw": ho, "rprelu": True,
                     "shortcut": "avgpool" if s == 2 else "identity"})
        rows.append({"op": "conv", "kind": "binary",
                     "name": f"block{i}.conv1x1", "c_in": c, "c_out": p,
                     "k": 1, "stride": 1, "pad": 0, "in_hw": ho,
                     "out_hw": ho, "rprelu": True,
                     "shortcut": "duplicate" if p == 2 * c else "identity"})
        hw, c = ho, p
    rows += [{"op": "avgpool", "name": "avgpool", "in_hw": hw, "out_hw": 1},
             {"op": "real_dense", "name": "fc", "n_in": c, "n_out": 10}]
    return dict(CONFIG, name="tiny-reactnet", source="a test configuration",
                input_shape=[16, 16, 3], layers=rows)


TRAFFIC = {"kind": "closed_loop", "clients": 2,
           "sizes": {"dist": "log_uniform", "lo": 2, "hi": 8, "levels": 4},
           "warmup_s": 0.3, "server": {"max_batch": 8},
           "check_requests": 3}


@pytest.fixture
def rcheckout(checkout):
    add_files(checkout, _tiny(), {"tiny-rn": TRAFFIC},
              [("tiny-rn-bulk", "tiny-reactnet", "tiny-rn", "reactnet-bulk")])
    return checkout


def test_tiny_run_is_correct(rcheckout):
    r = harness.run_cell(rcheckout, "tiny-rn-bulk", 2**31 + 5, 1.0, False,
                         "cpu", 0.0, log=lambda s: None)
    assert r["correct"] is True and r["failed"] == 0
    assert r["metrics"]["images_per_s"]["value"] > 0
    assert r["checks"]["mismatch_share"]["value"] == 0.0


def test_altered_answer_is_not_correct(rcheckout, monkeypatch):
    from repro_torch.graph.compile import CompiledBNN

    apply = CompiledBNN.apply

    def broken(self, params, x, valid_rows=None):
        y = apply(self, params, x, valid_rows=valid_rows).clone()
        y[:, 0] += 0.01 * y.abs().amax(dim=1)
        return y
    monkeypatch.setattr(CompiledBNN, "apply", broken)
    r = harness.run_cell(rcheckout, "tiny-rn-bulk", 2**31 + 6, 1.0, False,
                         "cpu", 0.0, log=lambda s: None)
    assert r["correct"] is False


def test_int4_control_reads_above_the_limit():
    config = _tiny()
    weights, pool = reactnet.make_data(config, TRAFFIC, 2**31 + 9, "cpu")
    sample = [(0, 8, None), (8, 8, None)]
    found = reactnet.compare(config["layers"], weights, pool, sample, "int4")
    assert found["images"] == 16
    assert found["mismatch_share"] > config["check"]["mismatch_share_limit"]


@pytest.mark.parametrize("precision", ["fp32_cudnn", "fp32_fma"])
def test_float32_stem_orders_change_only_rounding(precision):
    """The two float32 readings change only how the stem rounds: its
    map within 1e-5 of the exact map's largest magnitude."""
    config = _tiny()
    weights, pool = reactnet.make_data(config, TRAFFIC, 2**31 + 11, "cpu")
    x = pool[:4]
    want = reference._stem(x, weights[0], config["layers"][0], "exact")
    got = reference._stem(x, weights[0], config["layers"][0], precision)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_table_is_the_programs_ir():
    from repro_torch.graph.ir import reactnet_a

    spec = reactnet.spec_of(CONFIG)
    assert spec.nodes == reactnet_a().nodes


def test_counts_read_the_table():
    layers = CONFIG["layers"]
    # the binary convs' operations, as published: 4.82e9 BOPs, plus one
    # compare an output
    assert round(counts.total_ops(layers) / 2 / 1e9, 2) == 4.82
    b = counts_reactnet.epilogue_bytes(layers)
    n_out = sum(ly["out_hw"] ** 2 * ly["c_out"] for ly in layers
                if ly["op"] == "conv")
    assert 12 * n_out < b < 17 * n_out
    assert counts_reactnet.epilogue_bound_s(layers, 2) == \
        pytest.approx(2 * b / counts.HBM_BYTES_PER_S)
