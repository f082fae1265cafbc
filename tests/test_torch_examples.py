"""The four example twins (``examples/torch_*.py``) against the
reference's examples, on the CPU.

Each twin's ``main(device="cpu")`` runs (the training twin at 20 steps:
the reference example's ``--steps`` flag) and its deterministic
outputs equal the reference's:

* quickstart — the ASIC line, the conv byte line and the DSE Pareto
  rows, text for text; the port's own plan for the MLP;
* tulip_asic_sim — the SIMD window line and every Table II, III and
  IV/V row, character for character;
* serve_bnn — the Engine's dense and packed tokens on the reference's
  params carried across (``params_from_numpy``);
* train_bnn_lm — the example's assert (the loss falls).

The reference's lines are built here with the reference's modules in
the reference example's own steps (its scripts run at import).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.convert import params_from_numpy  # noqa: E402

from test_torch_models import np_tree  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _twin(name):
    return _load(ROOT / "examples" / f"torch_{name}.py", f"torch_{name}")


# ------------------------------------------------------------------ #
# quickstart                                                           #
# ------------------------------------------------------------------ #
def _reference_quickstart_lines():
    """The reference quickstart's ASIC line, conv byte line and Pareto
    rows, by its own steps on its own modules."""
    from repro.core.adder_tree import make_ext_inputs, schedule_tree
    from repro.core.bnn_layers import maxpool_packed
    from repro.core.binarize import PackedArray
    from repro.core.energy import (CellSpecs, calibrate, calibrate_tulip,
                                   evaluate)
    from repro.core.tulip_pe import run_numpy
    from repro.core.workloads import WORKLOADS
    from repro.kernels.ops import binarize_pack, binary_conv2d
    from repro.sim.dse import pareto_front, sweep_configs

    rng = np.random.default_rng(0)
    n, T = 96, 40
    sched = schedule_tree(n, threshold=T, compact=True)
    x_bits = (rng.random((8, n)) < 0.5).astype(np.int32)
    w_bits = (rng.random(n) < 0.5).astype(np.int32)
    products = 1 - (x_bits ^ w_bits)
    ext = make_ext_inputs(sched.ext_layout, products, sched.cycles)
    run_numpy(sched.program, ext, trace=True)
    asic = (f"[ASIC] 96-input BNN node on a TULIP-PE: {sched.cycles} "
            f"cycles, {sched.fine_peak_bits}-bit peak storage, output == "
            f"reference ✓")

    nb, hh, ww_, cc, ff = 2, 16, 16, 128, 256
    xs = jnp.asarray(rng.choice([-1.0, 1.0], size=(nb, hh, ww_, cc))
                     .astype(np.float32))
    wc = jnp.asarray(rng.choice([-1.0, 1.0], size=(3, 3, cc, ff))
                     .astype(np.float32))
    ap = binarize_pack(xs)
    out = binary_conv2d(ap, PackedArray.pack(wc, axis=2), threshold=0,
                        pack_out=True)
    pooled = maxpool_packed(out)
    bf16_bytes = 2 * (xs.size + wc.size + out.shape[0] * 16 * 16 * ff)
    conv = (f"[conv] binary conv {cc}->{ff} + OR-pool: "
            f"{ap.nbytes + out.nbytes} activation bytes in HBM vs "
            f"{bf16_bytes} bf16 "
            f"({bf16_bytes // (ap.nbytes + out.nbytes)}x less), out "
            f"{pooled.shape} still packed ✓")

    cells = CellSpecs()
    system = calibrate_tulip(WORKLOADS, calibrate(WORKLOADS, cells), cells)
    wl = WORKLOADS["binarynet"]
    pts = []
    for cfg in sweep_configs(smoke=True):
        rep = evaluate(wl, cfg.arch(), cells, system,
                       cfg.pe_node_cycles if cfg.n_pes else None)
        pts.append({"name": cfg.name, "energy_uj": rep.energy_j() * 1e6,
                    "time_ms": rep.time_s() * 1e3,
                    "area_mm2": cfg.area_um2(cells) / 1e6})
    rows = [f"[dse]  Pareto: {p['name']:<18s} {p['energy_uj']:7.1f} uJ  "
            f"{p['time_ms']:6.1f} ms  {p['area_mm2']:.2f} mm2"
            for p in pareto_front(pts,
                                  keys=("energy_uj", "time_ms", "area_mm2"))]
    return asic, conv, rows


def test_quickstart_twin_prints_the_references_lines():
    lines = []
    out = _twin("quickstart").main(device="cpu", log=lines.append)
    asic, conv, rows = _reference_quickstart_lines()
    assert out["asic"]["line"] == asic and asic in lines
    assert out["binarynet"]["conv_line"] == conv and conv in lines
    assert out["sim"]["pareto_rows"] == rows and rows
    assert out["mlp"]["plan"] == ["fused_stack", "dense"]
    assert out["binarynet"]["launches"] == 8
    assert out["serve"]["stats"]["faults"]["backend_fallbacks"] == 0
    assert lines[-1] == "quickstart OK"


# ------------------------------------------------------------------ #
# tulip_asic_sim                                                       #
# ------------------------------------------------------------------ #
def test_tulip_twin_prints_the_references_rows(capsys, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    ref_example = _load(ROOT / "examples" / "tulip_asic_sim.py",
                        "reference_tulip_asic_sim")
    ref_example.conv_window_on_pe_array()
    window = capsys.readouterr().out.strip()
    ref = []
    for table in ("table2", "table3", "table4_5"):
        _load(ROOT / "benchmarks" / f"{table}.py",
              f"reference_{table}").run(log=ref.append)
    lines = []
    twin = _twin("tulip_asic_sim")
    out = twin.main(device="cpu", log=lines.append)
    assert lines[0] == window
    rows = lines[3:]                      # after the window and bridge
    assert rows == ref
    assert out["table3"]["match"]
    assert [b["workload"] for b in out["bridge"]] == ["BinaryNet",
                                                      "AlexNet"]


# ------------------------------------------------------------------ #
# serve_bnn                                                            #
# ------------------------------------------------------------------ #
def test_serve_twin_gives_the_reference_engines_tokens():
    from repro.configs import get_arch, reduced
    from repro.launch.serve import Engine, Request
    from repro.models import init_params

    cfg = reduced(get_arch("qwen1.5-0.5b")).replace(dtype="float32")
    jparams = init_params(jax.random.PRNGKey(0), cfg)
    want = {}
    for packed in (False, True):
        rng = np.random.default_rng(0)
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, 10).astype(
            np.int32), 6) for i in range(4)]
        Engine(cfg, jparams, batch_slots=2, capacity=32,
               packed=packed).run(reqs, log=lambda s: None)
        want["packed" if packed else "dense"] = [list(r.out) for r in reqs]
    lines = []
    out = _twin("serve_bnn").main(
        device="cpu", params=params_from_numpy(np_tree(jparams), "cpu"),
        log=lines.append)
    assert out["dense"] == want["dense"]
    assert out["packed"] == want["packed"]
    assert all(len(t) == 6 for t in out["dense"])
    assert out["packed_param_bytes"] < out["dense_param_bytes"]


# ------------------------------------------------------------------ #
# train_bnn_lm                                                         #
# ------------------------------------------------------------------ #
def test_train_twin_loss_falls(tmp_path):
    lines = []
    out = _twin("train_bnn_lm").main(steps=20, device="cpu",
                                     ckpt_dir=str(tmp_path),
                                     log=lines.append)
    assert len(out["losses"]) == 20
    assert out["last10"] < out["first10"]
    assert any(tmp_path.iterdir())           # its checkpoints
    assert lines[0].startswith("training bnn-lm-small")


def test_twins_run_on_the_card_by_default(monkeypatch):
    """No device means the card: without one every twin raises, never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("quickstart", "serve_bnn", "tulip_asic_sim"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _twin(name).main(log=lambda s: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _twin("train_bnn_lm").main(steps=2, log=lambda s: None)
