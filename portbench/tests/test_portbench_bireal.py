"""The ``bireal`` family's adapter at a tiny size on the CPU: a run of a
tiny Bi-Real cell is correct, its check fails an altered answer, and the
control (the reference with 4-bit pixels, which the CPU can run) reads
above the limit; the adapter's table is the program's IR; the counts
give the stem's and the projections' bounds; the benchmark's copy of the
reference is the program's; the two new readers find nothing to read
where no kernel of theirs ran."""
from __future__ import annotations

import importlib.util
import json

import pytest
import torch
from conftest import ROOT, add_files

from portbench import counts_bireal, harness, profiling
from portbench.reference import bireal as reference
from portbench.systems import bireal

CONFIG = json.loads((ROOT / "portbench" / "configs" /
                     "bireal-net-18.json").read_text())


def _tiny():
    """Bi-Real Net's structure on 32x32 images: the 7x7 stem to 32
    channels and its pool (16 -> 8), an identity half-step, a projection
    half-step to 64 channels at stride 2, a head of 10."""
    rows = [{"op": "real_conv", "name": "conv1", "c_in": 3, "c_out": 32,
             "k": 7, "stride": 2, "pad": 3, "in_hw": 32, "out_hw": 16},
            {"op": "maxpool", "name": "maxpool", "window": 3, "stride": 2,
             "pad": 1, "in_hw": 16, "out_hw": 8}]
    for name, c, f, s in (("layer1.0", 32, 32, 1), ("layer2.0", 32, 64, 2)):
        hw = rows[-1]["out_hw"]
        rows.append({"op": "conv", "kind": "binary", "name": name,
                     "c_in": c, "c_out": f, "k": 3, "stride": s, "pad": 1,
                     "in_hw": hw, "out_hw": hw // s, "rprelu": False,
                     "shortcut": "projection" if s == 2 else "identity"})
    rows += [{"op": "avgpool", "name": "avgpool", "in_hw": 4, "out_hw": 1},
             {"op": "real_dense", "name": "fc", "n_in": 64, "n_out": 10}]
    return dict(CONFIG, name="tiny-bireal", source="a test configuration",
                input_shape=[32, 32, 3], layers=rows)


TRAFFIC = {"kind": "closed_loop", "clients": 2,
           "sizes": {"dist": "log_uniform", "lo": 2, "hi": 8, "levels": 4},
           "warmup_s": 0.3, "server": {"max_batch": 8},
           "check_requests": 3}


@pytest.fixture
def bcheckout(checkout):
    add_files(checkout, _tiny(), {"tiny-br": TRAFFIC},
              [("tiny-br-bulk", "tiny-bireal", "tiny-br", "bireal18-bulk")])
    return checkout


def test_tiny_run_is_correct(bcheckout):
    r = harness.run_cell(bcheckout, "tiny-br-bulk", 2**31 + 5, 1.0, False,
                         "cpu", 0.0, log=lambda s: None)
    assert r["correct"] is True and r["failed"] == 0
    assert r["metrics"]["images_per_s"]["value"] > 0
    assert r["checks"]["mismatch_share"]["value"] == 0.0


def test_tiny_traced_run_leaves_out_what_it_cannot_read(bcheckout):
    """Traced on the CPU: the program counters are read, the device
    traces (the two rooflines among them) find nothing and are left out."""
    r = harness.run_cell(bcheckout, "tiny-br-bulk", 2**31 + 7, 1.0, True,
                         "cpu", 0.0, log=lambda s: None)
    assert r["correct"] is True
    assert "rows_per_flight.bulk" in r["metrics"]
    assert "stem_conv_roofline" not in r["metrics"]
    assert "shortcut_conv_roofline" not in r["metrics"]


def test_altered_answer_is_not_correct(bcheckout, monkeypatch):
    from repro_torch.graph.compile import CompiledBNN

    apply = CompiledBNN.apply

    def broken(self, params, x, valid_rows=None):
        y = apply(self, params, x, valid_rows=valid_rows).clone()
        y[:, 0] += 0.01 * y.abs().amax(dim=1)
        return y
    monkeypatch.setattr(CompiledBNN, "apply", broken)
    r = harness.run_cell(bcheckout, "tiny-br-bulk", 2**31 + 6, 1.0, False,
                         "cpu", 0.0, log=lambda s: None)
    assert r["correct"] is False


def test_int4_control_reads_above_the_limit():
    config = _tiny()
    weights, pool = bireal.make_data(config, TRAFFIC, 2**31 + 9, "cpu")
    sample = [(0, 8, None), (8, 8, None)]
    found = bireal.compare(config["layers"], weights, pool, sample, "int4")
    assert found["images"] == 16
    assert found["mismatch_share"] > config["check"]["mismatch_share_limit"]


def test_table_is_the_programs_ir():
    from repro_torch.graph.ir import bireal_net18

    spec = bireal.spec_of(CONFIG)
    spec.validate()
    assert spec.nodes == bireal_net18().nodes


def test_data_fill_every_weight_once():
    """The draws cover every weight and per-channel number: projections
    carry their own 1x1 weights and batch norm."""
    config = _tiny()
    weights, pool = bireal.make_data(config, TRAFFIC, 2**31 + 3, "cpu")
    assert pool.shape == (1024, 32, 32, 3)
    assert [sorted(w) for w in weights] == [
        ["beta", "gamma", "mean", "var", "w"],
        ["beta", "gamma", "mean", "var", "w"],
        ["beta", "gamma", "mean", "proj", "var", "w"], ["b", "w"]]
    assert weights[2]["proj"]["w"].shape == (32, 64)
    assert not torch.equal(weights[2]["proj"]["gamma"], weights[2]["gamma"])


def test_counts_give_the_stem_and_projection_bounds():
    layers = CONFIG["layers"]
    # stem: 236.0 MFLOP an image at 67 TFLOP/s, 3.52 us; its bytes
    # (pixels, pooled map, words) 1.43 MB, 0.43 us
    assert round(counts_bireal.stem_s_per_image(layers) * 1e6, 2) == 3.52
    # projections: layer 2 by bytes (0.360 us), layers 3 and 4 by
    # operations (0.192 us each)
    assert round(counts_bireal.projection_s_per_image(layers) * 1e6,
                 3) == 0.743
    assert counts_bireal.stem_bound_s(layers, 256) == pytest.approx(
        256 * counts_bireal.stem_s_per_image(layers))
    assert counts_bireal.projection_bound_s(_tiny()["layers"], 1) > 0
    # a table without such layers has no bound
    rc = json.loads((ROOT / "portbench" / "configs" /
                     "reactnet-a.json").read_text())["layers"]
    assert counts_bireal.projection_s_per_image(rc) == 0.0


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reference_copy_is_the_programs_reference():
    prog = _load(ROOT / "src" / "repro_torch" / "reference" / "bireal.py",
                 "program_bireal_reference")
    config = _tiny()
    weights, pool = bireal.make_data(config, TRAFFIC, 2**31 + 13, "cpu")
    x = pool[:3]
    assert torch.equal(reference.logits(config["layers"], weights, x),
                       prog.logits(config["layers"], weights, x))
    assert (ROOT / "portbench" / "reference" / "bireal.py").read_text() == \
        (ROOT / "src" / "repro_torch" / "reference" / "bireal.py").read_text()


def test_reference_equals_the_ports_torch_forward():
    from repro_torch import graph

    config = _tiny()
    weights, pool = bireal.make_data(config, TRAFFIC, 2**31 + 17, "cpu")
    cb = graph.compile(bireal.spec_of(config), backend="torch",
                       device="cpu", batch=4)
    params = cb.bind(bireal.published_params(config["layers"], weights))
    got = cb.apply(params, pool[:4])
    want = reference.logits(config["layers"], weights, pool[:4])
    d = (got - want).abs().amax(dim=1)
    assert bool((d <= reference.LOGIT_REL_TOL *
                 want.abs().amax(dim=1)).all())


class _Run:
    def __init__(self, layers, kernels):
        self.layers = layers
        self.slice = profiling.SliceTrace(window_s=2.0, busy_s=1.5, rows=512,
                                          kernel_s=dict(kernels))


@pytest.mark.parametrize("name,frag", [
    ("stem_conv_roofline", "pooled::stem_conv_pool_kernel(float const*)"),
    ("shortcut_conv_roofline", "(anonymous)::shortcut_conv_kernel(int)")])
def test_readers_find_nothing_without_their_kernel(name, frag):
    reader = harness.load_module(ROOT / "portbench" / "metrics" /
                                 f"{name}.py", f"reader_{name}")
    layers = CONFIG["layers"]
    other = {"packed_conv_kernel_residual_epilogue<64, 64>": 0.5}
    assert reader.read(_Run(layers, other)) is None
    got = reader.read(_Run(layers, {**other, frag: 0.25}))
    bound = (counts_bireal.stem_bound_s if name.startswith("stem")
             else counts_bireal.projection_bound_s)(layers, 512)
    assert got == pytest.approx(100.0 * bound / 0.25)
    # a table without the layer (the parent's cells) reads nothing either
    rc = json.loads((ROOT / "portbench" / "configs" /
                     "xnor-alexnet.json").read_text())["layers"]
    assert reader.read(_Run(rc, {**other, frag: 0.25})) is None


def test_epilogue_roofline_reads_the_projected_map_as_identity():
    """``residual_epilogue_roofline`` takes the cell: a projection row
    counts the map the fused half-step reads as its identity shortcut,
    the projected [out_hw, out_hw, c_out] map, so one image's 16
    epilogues need 5.447 us at 3.35 TB/s."""
    from portbench import counts_reactnet
    layers = CONFIG["layers"]
    proj = [ly for ly in layers if ly.get("shortcut") == "projection"]
    assert len(proj) == 3
    for ly in proj:
        assert counts_reactnet.shortcut_elems(ly) == \
            ly["out_hw"] ** 2 * ly["c_out"]
    assert counts_reactnet.epilogue_bound_s(layers, 1) * 1e6 == \
        pytest.approx(5.4473, abs=1e-4)
    reader = harness.load_module(ROOT / "portbench" / "metrics" /
                                 "residual_epilogue_roofline.py",
                                 "reader_residual_epilogue_roofline")
    got = reader.read(_Run(layers, {
        "packed_conv_kernel_residual_epilogue<64, 64>": 0.5}))
    assert got == pytest.approx(
        100.0 * counts_reactnet.epilogue_bound_s(layers, 512) / 0.5)
