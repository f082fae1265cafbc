"""Paper reproduction driver on the PyTorch/CUDA port: simulate the TULIP
ASIC on the paper's workloads and print the Table II-V analogues.

The twin of ``examples/tulip_asic_sim.py``, on ``repro_torch``: the
cycle-accurate PE simulator on a whole convolution window computed
SIMD-style across PEs, then the same workload specs through the port's
graph compiler (one ``graph.compile(spec)`` gives the card's launch
plan and the ASIC-side Table III mapping), then the calibrated chip
model over BinaryNet / AlexNet.  ``benchmarks/table{2,3,4_5}.py``
import the reference's ``repro.core``, so the rows are built here from
``repro_torch.core`` (its copy): they print the reference's text
character for character.

Run:  PYTHONPATH=src python examples/torch_tulip_asic_sim.py [--device cpu]
"""
import argparse
from typing import Any, Callable, Dict, List

import numpy as np

from repro_torch import graph
from repro_torch.core.adder_tree import (make_ext_inputs, schedule_tree,
                                         storage_bound)
from repro_torch.core.energy import (PAPER_TABLE4, PAPER_TABLE5, TULIP,
                                     YODANN, CellSpecs, calibrate,
                                     calibrate_tulip, chip_area_um2,
                                     evaluate, mac_cycles)
from repro_torch.core.mapping import table3_rows
from repro_torch.core.threshold import bnn_node_reference
from repro_torch.core.tulip_pe import run_numpy
from repro_torch.core.workloads import (WORKLOADS, alexnet_imagenet,
                                        binarynet_cifar10)
from repro_torch.kernels.packed import resolve_device

# the paper's Table III: (layer, parts, P_y, Z_y, P_t, Z_t)
TABLE3_PAPER = [
    ("conv1", 4, 1, 3, 1, 3),
    ("conv2", 1, 2, 8, 2, 8),
    ("conv3", 1, 4, 12, 8, 2),
    ("conv4", 1, 6, 12, 12, 2),
    ("conv5", 1, 6, 8, 12, 1),
]


def conv_window_on_pe_array(n_pes: int = 64, k: int = 3, ifm: int = 32,
                            T: int = 144, log=print) -> int:
    """One output-pixel batch: n_pes OFMs of a k*k*ifm binary conv,
    each PE running the identical broadcast micro-op program (SIMD)."""
    n = k * k * ifm
    sched = schedule_tree(n, threshold=T, compact=True)
    rng = np.random.default_rng(0)
    window = (rng.random(n) < 0.5).astype(np.int32)       # shared window
    weights = (rng.random((n_pes, n)) < 0.5).astype(np.int32)
    products = 1 - (window[None, :] ^ weights)            # XNOR per OFM
    ext = make_ext_inputs(sched.ext_layout, products, sched.cycles)
    _, _, trace = run_numpy(sched.program, ext, trace=True)
    got = trace[:, sched.cmp_result_cycle, sched.cmp_neuron]
    ref = bnn_node_reference(window[None, :].repeat(n_pes, 0), weights, T)
    assert (got == ref.astype(np.int32)).all()
    log(f"SIMD conv window: {n_pes} TULIP-PEs x {n}-input node, "
        f"{sched.cycles} cycles, all outputs == reference ✓")
    return sched.cycles


def compiled_spec_bridge(device, log=print) -> List[Dict[str, Any]]:
    """One spec, two targets: the compiled artifact whose plan runs the
    port's kernels also reproduces the paper's Table III mapping and
    carries per-node TULIP-PE fragment cycle counts."""
    out = []
    for wl in (binarynet_cifar10(), alexnet_imagenet()):
        cb = graph.compile(wl, device=device)
        assert cb.table3_rows() == table3_rows(wl), wl.name
        rows = cb.tulip_mapping()
        pe = [r for r in rows if r.get("mapping") is not None
              and r["mapping"].uses_pe]
        cmp_cycles = {r["cmp_cycles"] for r in pe}
        log(f"compiled {wl.name}: {cb.launch_count()} launches on the "
            f"card (legacy chain {cb.legacy_launch_count()}), "
            f"{len(pe)} layers mapped to the TULIP-PEs, threshold-"
            f"compare fragments of {sorted(cmp_cycles)} cycles, "
            f"Table III reproduced from the same spec ✓")
        out.append({"workload": wl.name, "launches": cb.launch_count(),
                    "pe_layers": len(pe)})
    return out


def table2(log=print) -> Dict[str, Any]:
    """Table II: MAC vs TULIP-PE for a 288-input node (3x3 over 32
    IFMs), plus the scheduler design-space study."""
    s = CellSpecs()
    n = 288
    naive = schedule_tree(n, threshold=n // 2, compact=False)
    compact = schedule_tree(n, threshold=n // 2, compact=True)
    mac_cy = mac_cycles(n, s)
    period_ns = 1e9 / s.freq_hz

    log("\n== Table II: MAC vs TULIP-PE, 288-input node ==")
    log(f"{'metric':22s} {'MAC (B)':>12s} {'TULIP-PE (T)':>12s} "
        f"{'B/T':>8s} {'paper B/T':>9s}")
    rows = [
        ("Area (um^2)", s.mac_area_um2, s.pe_area_um2, 23.18),
        ("Power (mW)", s.mac_power_mw, s.pe_power_mw, 59.75),
        ("Cycles", mac_cy, compact.cycles, 0.038),
    ]
    for name, b, t, paper in rows:
        log(f"{name:22s} {b:12.2f} {t:12.2f} {b / t:8.2f} {paper:9.2f}")
    tb = mac_cy * period_ns
    tt = compact.cycles * period_ns
    log(f"{'Time (ns)':22s} {tb:12.1f} {tt:12.1f} {tb / tt:8.3f} "
        f"{'0.038':>9s}")
    pdp_b = s.mac_power_mw * tb
    pdp_t = s.pe_power_mw * tt
    log(f"{'PDP (mW*ns)':22s} {pdp_b:12.1f} {pdp_t:12.1f} "
        f"{pdp_b / pdp_t:8.2f} {'2.27':>9s}")

    log("\n-- scheduler design space (ours vs paper's 441 cycles) --")
    log(f"  naive sequential RPO : {naive.cycles} cycles")
    log(f"  compacting list sched: {compact.cycles} cycles "
        f"({(naive.cycles - compact.cycles) / naive.cycles:.0%} saved)")
    wide = schedule_tree(n, threshold=n // 2, compact=True, n_ext=6)
    log(f"  6 ext channels       : {wide.cycles} cycles — no gain: two "
        "concurrent leaf sums need 6 input paths but the PE has only "
        "2 shared b/c buses (paper §IV-A); the list scheduler proves "
        "the bus is the structural bottleneck, not the channel count")
    log(f"  paper's schedule     : {s.paper_pe_cycles_288} cycles")
    log(f"  storage: fine-grained peak {compact.fine_peak_bits} bits "
        f"(paper bound {storage_bound(n)}), register peak "
        f"{compact.peak_storage_bits}/64 bits")
    return {"pe_cycles": compact.cycles, "naive_cycles": naive.cycles,
            "pdp_ratio": pdp_b / pdp_t,
            "area_ratio": s.mac_area_um2 / s.pe_area_um2}


def table3(log=print) -> Dict[str, Any]:
    """Table III: AlexNet input-refetch (P, Z, P*Z) for YodaNN vs TULIP;
    must match the paper's table exactly."""
    rows = table3_rows(alexnet_imagenet())
    log("\n== Table III: AlexNet input-refetch (P, Z, P*Z) ==")
    log(f"{'layer':8s} {'parts':>5s} | {'Yoda P':>6s} {'Z':>4s} {'P*Z':>5s}"
        f" | {'TULIP P':>7s} {'Z':>4s} {'P*Z':>5s} | match")
    ok_all = True
    for row, (name, parts, py, zy, pt, zt) in zip(rows, TABLE3_PAPER):
        match = (row["YodaNN_P"] == py and row["YodaNN_Z"] == zy
                 and row["TULIP_P"] == pt and row["TULIP_Z"] == zt
                 and row["parts"] == parts)
        ok_all &= match
        log(f"{row['layer']:8s} {row['parts']:5d} | {row['YodaNN_P']:6d} "
            f"{row['YodaNN_Z']:4d} {row['YodaNN_PZ']:5d} | "
            f"{row['TULIP_P']:7d} {row['TULIP_Z']:4d} {row['TULIP_PZ']:5d}"
            f" | {'OK' if match else 'MISMATCH'}")
    tot_y = sum(r["YodaNN_PZ"] for r in rows[2:])
    tot_t = sum(r["TULIP_PZ"] for r in rows[2:])
    log(f"binary-layer P*Z: YodaNN {tot_y} vs TULIP {tot_t} "
        f"({tot_y / tot_t:.1f}x fewer refetches; paper: 3-4x)")
    assert ok_all, "Table III mismatch vs paper"
    return {"match": ok_all, "refetch_gain": tot_y / tot_t}


def _table4_5_rows(log, sys_p, spec, tag):
    log(f"\n-- predictions ({tag}) --")
    log(f"{'net':10s} {'scope':5s} | {'Yoda t(ms)':>10s} {'paper':>7s} | "
        f"{'TULIP t':>8s} {'paper':>7s} | {'Yoda uJ':>8s} {'paper':>7s} | "
        f"{'TULIP uJ':>8s} {'paper':>7s} | {'eff x':>6s} {'paper':>6s}")
    gains = []
    for wl in WORKLOADS.values():
        ry = evaluate(wl, YODANN, spec, sys_p)
        rt = evaluate(wl, TULIP, spec, sys_p)
        for conv_only, tbl in ((True, PAPER_TABLE4), (False, PAPER_TABLE5)):
            py = tbl[(wl.name, "YodaNN")]
            pt = tbl[(wl.name, "TULIP")]
            ey, et = ry.energy_j(conv_only) * 1e6, rt.energy_j(conv_only) * 1e6
            ty, tt = ry.time_s(conv_only) * 1e3, rt.time_s(conv_only) * 1e3
            gain = ey / et
            paper_gain = py["energy_uj"] / pt["energy_uj"]
            gains.append((gain, paper_gain))
            log(f"{wl.name:10s} {'conv' if conv_only else 'all':5s} | "
                f"{ty:10.1f} {py['time_ms']:7.1f} | {tt:8.1f} "
                f"{pt['time_ms']:7.1f} | {ey:8.1f} {py['energy_uj']:7.1f} |"
                f" {et:8.1f} {pt['energy_uj']:7.1f} | {gain:6.2f} "
                f"{paper_gain:6.2f}")
    return gains


def table4_5(log=print) -> Dict[str, Any]:
    """Tables IV & V: whole-chip energy/perf for BinaryNet-CIFAR10 and
    AlexNet-ImageNet, conv-only and end-to-end (cell constants from the
    paper, four system unknowns calibrated on YodaNN only, TULIP
    predicted out of sample; raw PE power and the fitted activity)."""
    spec = CellSpecs()
    log("\n== Tables IV & V: chip-level energy/perf (YodaNN vs TULIP) ==")
    sys_p = calibrate(WORKLOADS, spec)
    log(f"calibrated on YodaNN only: w0={sys_p.w0:.1f} cy/px, "
        f"bw_fc={sys_p.bw_fc:.2f} b/cy, a_int={sys_p.a_int:.2f}, "
        f"g={sys_p.g:.2f}, e_off={sys_p.e_off_pj:.2f} pJ/b")
    g1 = _table4_5_rows(log, sys_p, spec, "raw Table II PE power, "
                        "pe_act=1.0")
    sys_t = calibrate_tulip(WORKLOADS, sys_p, spec)
    log(f"\nPE switching activity fitted to TULIP energies: "
        f"pe_act={sys_t.pe_act:.2f}")
    log("(reproduction finding: the paper's Table II constants alone put "
        "TULIP's BinaryNet conv PE energy above Table IV's total — the "
        "tables reconcile only with sub-100% PE activity)")
    g2 = _table4_5_rows(log, sys_t, spec, f"pe_act={sys_t.pe_act:.2f}")

    ay = chip_area_um2(YODANN, spec) / 1e6
    at = chip_area_um2(TULIP, spec) / 1e6
    log(f"\nchip area: YodaNN {ay:.2f} mm^2-cells vs TULIP {at:.2f} "
        f"(iso-area by design, paper: 1.8 mm^2 die)")
    mean_gain = sum(g for g, _ in g2) / len(g2)
    log(f"\nheadline: mean energy-efficiency gain {mean_gain:.2f}x "
        f"(paper: ~3x conv, 2.4-2.7x end-to-end)")
    return {"gains_raw": g1, "gains_cal": g2, "mean_gain": mean_gain}


def main(device=None, log: Callable[[str], None] = print
         ) -> Dict[str, Any]:
    """The SIMD window, the compiled-spec bridge (compiled for
    ``device``, None = the card) and Tables II-V; returns each part's
    result."""
    dev = resolve_device(device)
    return {"window_cycles": conv_window_on_pe_array(log=log),
            "bridge": compiled_spec_bridge(dev, log=log),
            "table2": table2(log), "table3": table3(log),
            "table4_5": table4_5(log)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the host")
    main(ap.parse_args().device)
