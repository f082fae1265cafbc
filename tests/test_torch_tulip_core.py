"""The port's TULIP model against the JAX package's.

Pins (1) the threshold algebra on exhaustive truth tables; (2) every
schedule fragment and ``schedule_tree(n, threshold, compact)``: the
packed micro-op arrays, ext layouts and schedule fields equal the
reference's; (3) the PE interpreter: ``run_torch`` on the CPU equals
the reference's ``run_jax`` and both packages' ``run_numpy`` (regs,
outs and every cycle's latched outputs) on those programs with random
external bits, and ``run_numpy`` on random valid programs with random
starting registers (fresh reads, inversions, HOLD, every threshold);
(4) the model numbers: ``table3_rows``, ``CompiledBNN.tulip_mapping``
and ``spec_to_workload`` equal field for field, ``evaluate`` on both
workloads for TULIP, YodaNN and every ``sweep_configs(smoke=True)``
mesh within rel_tol 1e-12, and the calibration within 1e-9.  The
reference's ``run_jax`` compiles a scan per program (seconds each on a
CPU), which is most of this file's time.
"""
import dataclasses
import itertools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on one host: one torch thread each
torch.set_num_threads(1)

from repro import graph as jgraph  # noqa: E402
from repro.core import adder_tree as jtree  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import isa as jisa  # noqa: E402
from repro.core import mapping as jmapping  # noqa: E402
from repro.core import schedules as jsched  # noqa: E402
from repro.core import threshold as jth  # noqa: E402
from repro.core import tulip_pe as jpe  # noqa: E402
from repro.core.workloads import WORKLOADS as JWORKLOADS  # noqa: E402
from repro.sim.dse import sweep_configs as jsweep_configs  # noqa: E402
from repro.sim.mesh import MeshConfig as JMesh  # noqa: E402
from repro_torch import graph as tgraph  # noqa: E402
from repro_torch.core import adder_tree as ttree  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core import isa as tisa  # noqa: E402
from repro_torch.core import mapping as tmapping  # noqa: E402
from repro_torch.core import schedules as tsched  # noqa: E402
from repro_torch.core import threshold as tth  # noqa: E402
from repro_torch.core import tulip_pe as tpe  # noqa: E402
from repro_torch.core.workloads import WORKLOADS  # noqa: E402
from repro_torch.sim.dse import sweep_configs  # noqa: E402
from repro_torch.sim.mesh import MeshConfig  # noqa: E402

TREES = [(n, None, c) for n in (1, 3, 9, 33, 100, 288)
         for c in (False, True)] + [(9, 5, True), (100, 51, True)]


def _ids(case):
    n, t, c = case
    return f"n{n}-T{t}-{'compact' if c else 'naive'}"


def assert_packed_equal(got, want):
    pg, pw = got.pack(), want.pack()
    assert pg.keys() == pw.keys()
    for k in pw:
        np.testing.assert_array_equal(pg[k], pw[k], err_msg=k)
    assert got.n_ext == want.n_ext
    assert [c.label for c in got.cycles] == [c.label for c in want.cycles]


# ------------------------------------------------------------------ #
# threshold algebra                                                    #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("name,arity", [
    ("carry_fn", 3), ("sum_fn", 4), ("cmp_step_fn", 3), ("or4_fn", 4),
    ("and2_fn", 2), ("identity_fn", 1)])
def test_threshold_functions_equal_reference(name, arity):
    bits = np.asarray(list(itertools.product((0, 1), repeat=arity)))
    cols = [bits[:, i] for i in range(arity)]
    np.testing.assert_array_equal(getattr(tth, name)(*cols),
                                  getattr(jth, name)(*cols))


def test_neuron_and_node_reference_equal_reference():
    bits = np.asarray(list(itertools.product((0, 1), repeat=4)))
    for t in range(0, 7):
        np.testing.assert_array_equal(tth.neuron_eval(*bits.T, T=t),
                                      jth.neuron_eval(*bits.T, T=t))
    fn = tth.ThresholdFn((2, 1, 1, 1), 3)
    assert fn.truth_table() == jth.ThresholdFn((2, 1, 1, 1), 3).truth_table()
    rng = np.random.default_rng(0)
    x, w = rng.integers(0, 2, (16, 40)), rng.integers(0, 2, 40)
    for t in (0, 13, 20, 41):
        np.testing.assert_array_equal(tth.bnn_node_reference(x, w, t),
                                      jth.bnn_node_reference(x, w, t))
        assert tth.popcount_threshold(x[0], t) == \
            jth.popcount_threshold(x[0], t)


# ------------------------------------------------------------------ #
# fragments and schedules                                              #
# ------------------------------------------------------------------ #
FRAGMENTS = {
    "add": ("add_fragment", (0, 1, 2, 3, [0, 1, 2], [4, 5], [6, 7, 8, 9])),
    "leaf3": ("leaf_fragment", (1, 2, [0, 1, 2], [3, 4])),
    "leaf1": ("leaf_fragment", (0, 3, [5], [0, 1], (3, 4, 5))),
    "accumulate": ("accumulate_fragment",
                   (0, 1, 2, [0, 1, 2, 3], 3, [4, 5, 6, 7, 8], 1,
                    [10, 11, 12])),
    "compare_const": ("compare_fragment", (0, 1, [0, 1, 2, 3], 11)),
    "compare_reg": ("compare_fragment",
                    (0, 1, [0, 1, 2], None, 2, [5, 6], 9)),
    "maxpool9": ("maxpool_fragment", (2, list(range(9)), 3)),
    "maxpool4": ("maxpool_fragment", (0, [0, 1, 2, 3])),
    "relu": ("relu_fragment", (0, 1, 2, [0, 1, 2], [3, 4, 5])),
    "copy": ("copy_fragment", (3, 0, [1, 2], [7, 8])),
}


@pytest.mark.parametrize("kind", sorted(FRAGMENTS))
def test_fragment_equals_reference(kind):
    fn, args = FRAGMENTS[kind]
    got, want = getattr(tsched, fn)(*args), getattr(jsched, fn)(*args)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.neuron_busy() == want.neuron_busy()
    prog, layout = tsched.fragments_to_program([got, got], [0, 40])
    jprog, jlayout = jsched.fragments_to_program([want, want], [0, 40])
    assert_packed_equal(prog, jprog)
    assert layout == jlayout


def test_program_validate_rejects_like_reference():
    def bad(isa):
        return [
            lambda c: setattr(c, "bus_b", isa.REG(3)),
            lambda c: setattr(c.neurons[1], "thr", 7),
            lambda c: setattr(c.neurons[2], "a", isa.EXT(9)),
            lambda c: setattr(c.neurons[0], "write_bit", 16),
            lambda c: (setattr(c.neurons[0], "a", isa.N(1, fresh=True)),
                       setattr(c.neurons[1], "stage", 1)),
        ]
    for make_t, make_j in zip(bad(tisa), bad(jisa)):
        progs = []
        for isa, make in ((tisa, make_t), (jisa, make_j)):
            b = isa.ProgramBuilder(n_ext=4)
            make(b.cycle())
            progs.append(b.program)
        with pytest.raises(ValueError) as got:
            progs[0].validate()
        with pytest.raises(ValueError) as want:
            progs[1].validate()
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", TREES, ids=_ids)
def test_schedule_tree_equals_reference(case):
    n, t, compact = case
    got = ttree.schedule_tree(n, threshold=t, compact=compact)
    want = jtree.schedule_tree(n, threshold=t, compact=compact)
    assert_packed_equal(got.program, want.program)
    for f in ("ext_layout", "result_neuron", "result_bits", "cycles",
              "peak_storage_bits", "fine_peak_bits", "n_ops",
              "cmp_result_cycle", "cmp_neuron"):
        assert getattr(got, f) == getattr(want, f), f
    assert ttree.storage_bound(n) == jtree.storage_bound(n)
    assert dataclasses.asdict(ttree.build_tree(n)) == \
        dataclasses.asdict(jtree.build_tree(n))


def _tree_ext(sched, n, seed):
    bits = np.random.default_rng(seed).integers(0, 2, (6, n))
    ext = ttree.make_ext_inputs(sched.ext_layout, bits, sched.cycles)
    np.testing.assert_array_equal(
        ext, jtree.make_ext_inputs(sched.ext_layout, bits, sched.cycles))
    return bits, ext


@pytest.mark.parametrize("case", TREES, ids=_ids)
def test_run_torch_equals_run_jax_and_numpy(case):
    n, t, compact = case
    sched = ttree.schedule_tree(n, threshold=t, compact=compact)
    jsched_ = jtree.schedule_tree(n, threshold=t, compact=compact)
    bits, ext = _tree_ext(sched, n, seed=n + (t or 0))
    regs, outs, hist = tpe.run_torch(sched.program, ext, device="cpu")
    assert regs.dtype == outs.dtype == hist.dtype == torch.int32
    want = jpe.run_numpy(jsched_.program, ext, trace=True)
    for got, w in zip((regs, outs, hist),
                      tpe.run_numpy(sched.program, ext, trace=True)):
        np.testing.assert_array_equal(got.numpy(), w)
    for got, w in zip((regs, outs, hist), want):
        np.testing.assert_array_equal(got.numpy(), w)
    for got, w in zip((regs, outs, hist), jpe.run_jax(jsched_.program, ext)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    # and the schedule computes what it should
    pc = tpe.read_value(regs.numpy(), sched.result_neuron, sched.result_bits)
    np.testing.assert_array_equal(pc, bits.sum(1))
    if t is not None:
        np.testing.assert_array_equal(
            hist[:, sched.cmp_result_cycle, sched.cmp_neuron].numpy(),
            (bits.sum(1) >= t).astype(np.int32))


def _random_program(isa, rng, n_cycles):
    """A valid random program: fresh reads (direct or through a bus) only
    from a neuron at a smaller stage, HOLD and every threshold, register
    reads and writes, per-port and per-bus inversions."""
    b = isa.ProgramBuilder(n_ext=4)
    for _ in range(n_cycles):
        cy = b.cycle()
        stages = [int(s) for s in rng.integers(0, 4, isa.N_NEURONS)]

        def src(n, reg_ok):
            kind = int(rng.integers(0, 5 if reg_ok else 4))
            inv = bool(rng.integers(0, 2))
            if kind == 0:
                s = isa.Src(int(rng.integers(0, 2)))
            elif kind == 1:
                s = isa.EXT(int(rng.integers(0, 4)))
            elif kind == 4:
                s = isa.REG(int(rng.integers(0, isa.N_REG_BITS)))
            else:
                k = int(rng.integers(0, isa.N_NEURONS))
                fresh = kind == 3 and (n is None or stages[k] < stages[n])
                s = isa.N(k, fresh=fresh)
            return ~s if inv else s

        cy.bus_b, cy.bus_c = src(None, False), src(None, False)
        for n in range(isa.N_NEURONS):
            ok = []
            for bus in (cy.bus_b, cy.bus_c):
                fresh_ok = not (bus.is_neuron and bus.fresh) or \
                    stages[bus.code - isa.NEURON_BASE] < stages[n]
                ok.append(fresh_ok and bool(rng.integers(0, 2)))
            wb = int(rng.integers(0, isa.N_REG_BITS)) \
                if rng.integers(0, 3) == 0 else None
            b.neuron(cy, n, a=src(n, True), d=src(n, True), b=ok[0],
                     b_inv=bool(rng.integers(0, 2)), c=ok[1],
                     c_inv=bool(rng.integers(0, 2)),
                     thr=int(rng.integers(0, 7)), stage=stages[n],
                     write_bit=wb)
    return b.finish()


@pytest.mark.parametrize("seed", range(4))
def test_run_torch_random_programs(seed):
    prog = _random_program(tisa, np.random.default_rng(seed), 60)
    jprog = _random_program(jisa, np.random.default_rng(seed), 60)
    assert_packed_equal(prog, jprog)
    rng = np.random.default_rng(100 + seed)
    ext = rng.integers(0, 2, (16, 64, 4))
    regs0 = rng.integers(0, 2, (16, 4, 16)).astype(np.int32)
    got = tpe.run_torch(prog, ext, init_regs=regs0, device="cpu")
    want = jpe.run_numpy(jprog, ext, init_regs=regs0, trace=True)
    for g, w, t in zip(got, want,
                       tpe.run_numpy(prog, ext, init_regs=regs0, trace=True)):
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(t, w)


def test_run_torch_rejects_short_ext():
    sched = ttree.schedule_tree(9)
    with pytest.raises(ValueError):
        tpe.run_torch(sched.program, np.zeros((2, sched.cycles - 1, 4)),
                      device="cpu")


def test_read_write_value_equal_reference():
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 2 ** 10, 8)
    regs, jregs = (np.zeros((8, 4, 16), np.int32) for _ in range(2))
    tpe.write_value(regs, 2, [3, 4, 5, 9, 10, 11, 12, 13, 14, 15], vals)
    jpe.write_value(jregs, 2, [3, 4, 5, 9, 10, 11, 12, 13, 14, 15], vals)
    np.testing.assert_array_equal(regs, jregs)
    np.testing.assert_array_equal(
        tpe.read_value(regs, 2, [3, 4, 5, 9, 10, 11, 12, 13, 14, 15]), vals)


# ------------------------------------------------------------------ #
# the model numbers                                                    #
# ------------------------------------------------------------------ #
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


@pytest.mark.parametrize("key", ["binarynet", "alexnet"])
def test_table3_mapping_and_workload_equal_reference(key):
    wl = WORKLOADS[key]
    assert tmapping.table3_rows(wl) == jmapping.table3_rows(JWORKLOADS[key])
    cb = tgraph.compile(wl, device="cpu")
    jcb = jgraph.compile(JWORKLOADS[key], backend="xla")
    assert cb.table3_rows() == jcb.table3_rows()
    got, want = cb.tulip_mapping(), jcb.tulip_mapping()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        m, jm = g.pop("mapping"), w.pop("mapping")
        assert g == w
        assert (m is None) == (jm is None)
        if m is not None:
            assert dataclasses.asdict(m) == dataclasses.asdict(jm)
            assert m.refetch_product == jm.refetch_product
    for arch, jarch in ((tmapping.YODANN, jmapping.YODANN),
                        (tmapping.TULIP, jmapping.TULIP)):
        assert dataclasses.asdict(arch) == dataclasses.asdict(jarch)
        assert [dataclasses.asdict(r["mapping"]) for r in
                cb.tulip_mapping(arch) if r["mapping"]] == \
            [dataclasses.asdict(r["mapping"]) for r in
             jcb.tulip_mapping(jarch) if r["mapping"]]
    got_wl = tgraph.spec_to_workload(cb.spec)
    assert dataclasses.asdict(got_wl) == dataclasses.asdict(
        jgraph.spec_to_workload(jcb.spec))
    assert got_wl == wl


@pytest.fixture(scope="module")
def calibrated():
    cells, jcells = tenergy.CellSpecs(), jenergy.CellSpecs()
    base = tenergy.calibrate(WORKLOADS, cells)
    jbase = jenergy.calibrate(JWORKLOADS, jcells)
    return (tenergy.calibrate_tulip(WORKLOADS, base, cells),
            jenergy.calibrate_tulip(JWORKLOADS, jbase, jcells), base, jbase)


def test_calibration_equals_reference(calibrated):
    system, jsystem, base, jbase = calibrated
    _close(dataclasses.asdict(base), dataclasses.asdict(jbase), 1e-9)
    _close(dataclasses.asdict(system), dataclasses.asdict(jsystem), 1e-9)
    assert system.pe_act == jsystem.pe_act


def _evaluate_pairs():
    return [("TULIP", None), ("YodaNN", None)] + list(
        zip(sweep_configs(smoke=True), jsweep_configs(smoke=True)))


@pytest.mark.parametrize("key", ["binarynet", "alexnet"])
@pytest.mark.parametrize("point", range(2 + 9))
def test_evaluate_equals_reference(calibrated, key, point):
    system, jsystem, _, _ = calibrated
    cells, jcells = tenergy.CellSpecs(), jenergy.CellSpecs()
    which, jwhich = _evaluate_pairs()[point]
    if which == "TULIP":
        args = (tmapping.TULIP, None), (jmapping.TULIP, None)
    elif which == "YodaNN":
        args = (tmapping.YODANN, None), (jmapping.YODANN, None)
    else:
        assert dataclasses.asdict(which) == dataclasses.asdict(jwhich)
        args = ((which.arch(), which.pe_node_cycles if which.n_pes else None),
                (jwhich.arch(),
                 jwhich.pe_node_cycles if jwhich.n_pes else None))
        assert which.area_um2(cells) == jwhich.area_um2(jcells)
    rep = tenergy.evaluate(WORKLOADS[key], args[0][0], cells, system,
                           args[0][1])
    jrep = jenergy.evaluate(JWORKLOADS[key], args[1][0], jcells, jsystem,
                            args[1][1])
    assert (rep.workload, rep.arch) == (jrep.workload, jrep.arch)
    _close([dataclasses.asdict(ly) for ly in rep.layers],
           [dataclasses.asdict(ly) for ly in jrep.layers], 1e-12)
    for conv_only in (False, True):
        for f in ("ops", "time_s", "energy_j", "perf_gops", "eff_tops_w"):
            _close(getattr(rep, f)(conv_only), getattr(jrep, f)(conv_only),
                   1e-12)


def test_cycle_models_equal_reference():
    cells = tenergy.CellSpecs()
    assert dataclasses.asdict(cells) == \
        dataclasses.asdict(jenergy.CellSpecs())
    for n in (1, 9, 288, 512, 1024, 3000):
        assert tenergy.mac_cycles(n, cells) == jenergy.mac_cycles(
            n, jenergy.CellSpecs())
    for n in (1, 9, 144, 288):
        for acc, cmp_ in itertools.product((False, True), repeat=2):
            assert tenergy.pe_cycles(n, acc, cmp_) == \
                jenergy.pe_cycles(n, acc, cmp_)
    for arch, jarch in ((tmapping.YODANN, jmapping.YODANN),
                        (tmapping.TULIP, jmapping.TULIP)):
        assert tenergy.chip_area_um2(arch, cells) == \
            jenergy.chip_area_um2(jarch, jenergy.CellSpecs())
    assert tenergy.PAPER_TABLE4 == jenergy.PAPER_TABLE4
    assert tenergy.PAPER_TABLE5 == jenergy.PAPER_TABLE5
    for key, wl in WORKLOADS.items():
        for ly, jly in zip(wl.conv, JWORKLOADS[key].conv):
            for arch, jarch in ((tmapping.YODANN, jmapping.YODANN),
                                (tmapping.TULIP, jmapping.TULIP)):
                assert dataclasses.asdict(tenergy.conv_counts(ly, arch)) \
                    == dataclasses.asdict(jenergy.conv_counts(jly, jarch))
    assert dataclasses.asdict(MeshConfig()) == dataclasses.asdict(JMesh())
