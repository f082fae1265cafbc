"""The port's mesh simulator and DSE against the JAX package's.

Pins (1) the mesh model (``tree_capacity``, ``MeshConfig``) and the
sweep: the calibration, every row of the full 33-configuration sweep
and both Pareto fronts equal the committed
``benchmarks/BENCH_dse.json`` (rel_tol 1e-9); (2) ``simulate`` on the
CPU with the reference's params carried across by params_from_numpy,
on the dense-entry MLP spec (packed x, batch 3) and on full-width
BinaryNet (integer images, batch 1, one PE sample a layer): logits
equal to the reference simulate's and to the port's ``apply``, every
measured and predicted ``UnitCounts`` row and every ``LayerReport``
equal, the same PE-check counts, ``counts_match_mapping`` and the
``run_torch`` twin check; (3) the layering rule (sim imports neither
serving nor robustness) and the device rule (an input off the
compiled's device raises).  The ``gpu`` tests (skipped on a host
without CUDA) hold simulate of BinaryNet at batch 2 on ``"cuda"`` bit
for bit against ``apply``'s kernels, and ``run_torch`` on the card
against ``run_numpy``.  The BinaryNet runs schedule the sampled nodes'
adder trees (576 to 922 inputs, pure Python) in both packages, which
is most of this file's time.
"""
import ast
import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on one host: one torch thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import graph as jgraph  # noqa: E402
from repro.core.workloads import WORKLOADS as JWORKLOADS  # noqa: E402
from repro.kernels.ops import binarize_pack  # noqa: E402
from repro.kernels.packed import PackedArray as JPacked  # noqa: E402
from repro.sim import simulate as jsimulate  # noqa: E402
from repro.sim.dse import pareto_front as jpareto_front  # noqa: E402
from repro.sim.dse import sweep_configs as jsweep_configs  # noqa: E402
from repro.sim.mesh import MeshConfig as JMesh  # noqa: E402
from repro.sim.mesh import tree_capacity as jtree_capacity  # noqa: E402
from repro_torch import graph as tgraph  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.adder_tree import (make_ext_inputs,  # noqa: E402
                                         schedule_tree)
from repro_torch.core.energy import (CellSpecs, calibrate,  # noqa: E402
                                     calibrate_tulip)
from repro_torch.core.tulip_pe import run_numpy, run_torch  # noqa: E402
from repro_torch.core.workloads import WORKLOADS  # noqa: E402
from repro_torch.kernels.packed import PackedArray, from_uint32  # noqa: E402
from repro_torch.sim import MeshConfig, simulate, tree_capacity  # noqa: E402
from repro_torch.sim.dse import (COMPARISON_POINTS,  # noqa: E402
                                 MIN_ENERGY_RATIO, pareto_front, sweep,
                                 sweep_configs)

ROOT = Path(__file__).resolve().parents[1]


def np_tree(tree):
    """The reference params with every leaf as numpy — the form
    params_from_numpy takes."""
    if isinstance(tree, JPacked):
        return {"words": np.asarray(tree.words), "length": tree.length,
                "axis": tree.axis}
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(np_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(np_tree(v) for v in tree)
    return np.asarray(tree)


def _close(got, want, rel):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k], rel)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rel)
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=rel), (got, want)
    else:
        assert got == want


# ------------------------------------------------------------------ #
# mesh model and sweep                                                 #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("reg_bits", [5, 6, 7, 8, 10, 12, 16, 20])
def test_tree_capacity_equals_reference(reg_bits):
    if reg_bits < 6:
        with pytest.raises(ValueError):
            tree_capacity(reg_bits)
        with pytest.raises(ValueError):
            MeshConfig(reg_bits=reg_bits)
        return
    assert tree_capacity(reg_bits) == jtree_capacity(reg_bits)
    m, jm = MeshConfig(reg_bits=reg_bits), JMesh(reg_bits=reg_bits)
    assert (m.capacity, m.name, m.area_um2()) == \
        (jm.capacity, jm.name, jm.area_um2())
    for n in (100, 288, 1152, 8192):
        assert m.chunk_sizes(n) == jm.chunk_sizes(n)


def test_mesh_config_validation():
    with pytest.raises(ValueError):
        MeshConfig(schedule="greedy")
    with pytest.raises(ValueError):
        MeshConfig(n_pes=-1)
    assert MeshConfig.mac_baseline().arch().name == "YodaNN"
    assert MeshConfig().arch().name == "TULIP"
    assert MeshConfig(n_pes=64).arch().ofm_batch_pe == 64
    assert [dataclasses.asdict(c) for c in sweep_configs()] == \
        [dataclasses.asdict(c) for c in jsweep_configs()]


def test_pe_node_cycles_matches_energy_model():
    from repro_torch.core.energy import pe_cycles
    m = MeshConfig()
    for n in (1, 2, 3, 17, 255, 288, 1024):
        for acc in (False, True):
            for cmp_ in (False, True):
                assert m.pe_node_cycles(n, accumulate=acc, compare=cmp_) \
                    == pe_cycles(n, accumulate=acc, compare=cmp_), n
    sched = m.node_schedule(288)
    assert sched is m.node_schedule(288)      # the module-level cache
    with pytest.raises(ValueError):
        MeshConfig(reg_bits=8).node_schedule(300)


def test_pareto_front_equals_reference():
    rng = np.random.default_rng(0)
    pts = [{"name": str(i), "energy_uj": float(e), "time_ms": float(t),
            "area_mm2": float(a)}
           for i, (e, t, a) in enumerate(rng.integers(0, 5, (40, 3)))]
    assert [p["name"] for p in pareto_front(pts)] == \
        [p["name"] for p in jpareto_front(pts)]


def test_sweep_equals_committed_bench_dse():
    """The calibration, every row of the full sweep and both fronts equal
    the reference's committed artifact (a fresh least-squares fit may
    round differently in the last digits: rel_tol 1e-9)."""
    bench = json.loads((ROOT / "benchmarks" / "BENCH_dse.json").read_text())
    dse = bench["dse"]
    cells = CellSpecs()
    system = calibrate_tulip(WORKLOADS, calibrate(WORKLOADS, cells), cells)
    _close(dataclasses.asdict(system), dse["calibration"], 1e-9)
    rows, fronts = sweep(["binarynet", "alexnet"], sweep_configs(), cells,
                         system)
    assert len(rows) == 2 * 33
    _close(rows, dse["sweep"], 1e-9)
    assert fronts == dse["pareto_fronts"]
    assert COMPARISON_POINTS == dse["comparison_points"]
    assert MIN_ENERGY_RATIO == dse["min_energy_ratio"]


# ------------------------------------------------------------------ #
# simulate against the reference                                       #
# ------------------------------------------------------------------ #
def assert_sim_equal(got, want, port_apply):
    np.testing.assert_array_equal(got.logits.numpy(), want.logits)
    np.testing.assert_array_equal(got.logits.numpy(), port_apply)
    assert got.oracle_bit_identical and want.oracle_bit_identical in (
        True, None)
    assert got.counts_match_mapping and want.counts_match_mapping
    assert len(got.layers) == len(want.layers)
    for g, w in zip(got.layers, want.layers):
        assert (g.name, g.kind, g.uses_pe) == (w.name, w.kind, w.uses_pe)
        assert dataclasses.asdict(g.measured) == \
            dataclasses.asdict(w.measured)
        assert dataclasses.asdict(g.predicted) == \
            dataclasses.asdict(w.predicted)
        assert dataclasses.asdict(g.report) == dataclasses.asdict(w.report)
        assert (g.pe_nodes_checked, g.pe_nodes_passed) == \
            (w.pe_nodes_checked, w.pe_nodes_passed)
    assert got.pe_nodes_checked == want.pe_nodes_checked > 0
    assert got.pe_programs_ok and want.pe_programs_ok
    assert got.run_torch_crosschecked and want.run_jax_crosschecked
    assert got.conv_pz() == want.conv_pz()
    for f in ("wall_cycles", "busy_cycles", "time_s", "energy_per_class_j",
              "area_um2", "batch", "arch_name", "workload"):
        assert getattr(got, f) == getattr(want, f), f


def test_mlp_sim_equals_reference():
    """The dense-entry spec on a packed x, as tests/test_sim.py runs it."""
    ref = jgraph.compile_dense_stack(256, [128, 64, 16], backend="xla")
    jparams = ref.init(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (3, 256), jnp.float32)
    jxp = binarize_pack(x)
    want = jsimulate(ref, jparams, jxp, pe_samples=2, seed=0)
    cb = tgraph.compile_dense_stack(256, [128, 64, 16], backend="torch",
                                    device="cpu")
    params = params_from_numpy(np_tree(jparams), "cpu")
    xp = PackedArray(from_uint32(np.asarray(jxp.words), "cpu"),
                     length=jxp.length, axis=jxp.axis)
    got = simulate(cb, params, xp, pe_samples=2, seed=0)
    assert_sim_equal(got, want, cb.apply(params, xp).unpack(torch.int8)
                     .to(torch.float32).numpy())
    assert got.energy_per_class_j > 0 and got.time_s > 0


@pytest.fixture(scope="module")
def binarynet_pair():
    """The reference's BinaryNet, its params and its simulate (no oracle
    run: its apply is the reference's own tests' business) on one
    integer image, shared by the tests below."""
    ref = jgraph.compile(JWORKLOADS["binarynet"], backend="xla")
    jparams = ref.init(jax.random.PRNGKey(0))
    x = np.random.default_rng(0).integers(-3, 4, (1, 32, 32, 3)
                                          ).astype(np.float32)
    want = jsimulate(ref, jparams, x, pe_samples=1, seed=0,
                     check_oracle=False)
    return params_from_numpy(np_tree(jparams), "cpu"), x, want


def test_binarynet_sim_equals_reference(binarynet_pair):
    params, x, want = binarynet_pair
    cb = tgraph.compile(WORKLOADS["binarynet"], backend="torch",
                        device="cpu")
    xt = torch.from_numpy(x)
    got = simulate(cb, params, xt, pe_samples=1, seed=0)
    assert_sim_equal(got, want, cb.apply(params, xt).numpy())
    rows = cb.table3_rows()
    assert {d["layer"]: (d["P"], d["Z"]) for d in got.conv_pz()} == \
        {r["layer"]: (r["TULIP_P"], r["TULIP_Z"]) for r in rows}
    mac = simulate(cb, params, xt, mesh=MeshConfig.mac_baseline(),
                   pe_samples=0, check_oracle=False)
    assert torch.equal(mac.logits, got.logits) and mac.counts_match_mapping
    assert {d["layer"]: (d["P"], d["Z"]) for d in mac.conv_pz()} == \
        {r["layer"]: (r["YodaNN_P"], r["YodaNN_Z"]) for r in rows}
    assert mac.oracle_bit_identical is None
    assert mac.pe_nodes_checked == 0 and not mac.run_torch_crosschecked


def test_simulate_rejects_input_off_the_compiled_device():
    cb = tgraph.compile_dense_stack(64, [32], backend="torch", device="cpu")
    params = cb.init(torch.Generator().manual_seed(0))
    xp = PackedArray(torch.zeros(2, 2, dtype=torch.int32, device="meta"),
                     length=64)
    with pytest.raises(ValueError):
        simulate(cb, params, xp)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sim_layering():
    """sim may import core, graph and kernels; never serving or
    robustness (the reference's layering rule)."""
    files = sorted((ROOT / "src" / "repro_torch" / "sim").glob("*.py"))
    assert len(files) == 4
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.startswith(("repro_torch.serving", "repro_torch.robustness"))]
    assert not bad, bad


# ------------------------------------------------------------------ #
# on the card                                                          #
# ------------------------------------------------------------------ #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_binarynet_sim_bit_identical_to_apply(cuda):
    cb = tgraph.compile(WORKLOADS["binarynet"], device=cuda, batch=2)
    params = cb.init(torch.Generator().manual_seed(0))
    x = torch.randint(-3, 4, (2, 32, 32, 3), generator=torch.Generator()
                      .manual_seed(1)).to(torch.float32).to(cuda)
    r = simulate(cb, params, x, pe_samples=2, seed=0)
    assert r.logits.device.type == "cuda"
    assert r.oracle_bit_identical and r.counts_match_mapping
    assert r.pe_programs_ok and r.run_torch_crosschecked
    assert torch.equal(r.logits, cb.apply(params, x))


@pytest.mark.gpu
@pytest.mark.parametrize("n,threshold", [(9, None), (288, 144), (288, None)])
def test_gpu_run_torch_equals_run_numpy(cuda, n, threshold):
    sched = schedule_tree(n, threshold=threshold)
    bits = np.random.default_rng(n).integers(0, 2, (256, n))
    ext = make_ext_inputs(sched.ext_layout, bits, sched.cycles)
    got = run_torch(sched.program, ext, device=cuda)
    for g, w in zip(got, run_numpy(sched.program, ext, trace=True)):
        assert g.device.type == "cuda"
        np.testing.assert_array_equal(g.cpu().numpy(), w)
