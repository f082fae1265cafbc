"""Design-space exploration over the TULIP-PE mesh (DESIGN.md §14).

The port of ``repro.sim.dse``: the same calibration, the same five
gates and the same sweep, with the execution on the card by default
(``device=None``), where the oracle is ``CompiledBNN.apply`` on the
port's Hopper kernels.

``run_dse`` is the execution-side reproduction of the paper's §V
comparison plus the sweep the paper's fixed silicon could not do:

1. **Execute** both paper workloads (BinaryNet/CIFAR-10 and XNOR-Net
   AlexNet) through :func:`repro_torch.sim.simulate` on the paper's TULIP
   config AND on the YodaNN-style MAC baseline — same compiled plan,
   same random packed params, logits gated bit-identical against the
   ``CompiledBNN.apply`` oracle, measured P/Z loop counts gated
   against ``table3_rows()``.  The headline gate: measured
   energy/classification advantage >= 3x (paper abstract: "at least
   3x"; the calibrated model gives ~4.1x / ~3.8x all-layers).
2. **Sweep** PE count x register bits x schedule variant through the
   calibrated energy model with each config's own measured-schedule
   cycle hook (``MeshConfig.pe_node_cycles``), and emit the Pareto
   frontier on (energy/classification, latency, area proxy).
3. **Situate** the result against the PAPERS.md operating points
   (XNE, XNORBIN, ChewBaccaNN) as context rows.

The returned body has the layout of the reference's committed
artifact (benchmarks/BENCH_dse.json), whose model numbers — the
calibration, Table III, both designs' metrics and every sweep row — a
run must reproduce; ``out_json`` optionally writes it.  Every gate
raises when it fails — a smoke run must satisfy the same invariants
on the workloads it covers.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.energy import (CellSpecs, SystemParams, calibrate,
                                     calibrate_tulip, evaluate)
from repro_torch.core.workloads import WORKLOADS, Workload
from repro_torch.graph.compile import compile as compile_spec
from repro_torch.kernels.packed import resolve_device
from repro_torch.sim.mesh import MeshConfig
from repro_torch.sim.simulator import SimResult, simulate

__all__ = ["run_dse", "sweep_configs", "pareto_front", "sweep"]

# eff_tops_w context rows from PAPERS.md (see module docstring); the
# XNE figure is the inverse of its 21.6 fJ/op headline number
COMPARISON_POINTS = [
    {"name": "XNE (Conti et al.)", "eff_tops_w": 1.0 / 21.6e-3,
     "source": "PAPERS.md: 21.6 fJ/op"},
    {"name": "XNORBIN", "eff_tops_w": 95.0,
     "source": "PAPERS.md: 95 TOp/s/W"},
    {"name": "ChewBaccaNN", "eff_tops_w": 223.0,
     "source": "PAPERS.md: 223 TOPS/W"},
]

MIN_ENERGY_RATIO = 3.0      # the paper's "at least 3x" abstract claim


def _env(device: torch.device) -> Dict[str, Any]:
    cuda = device.type == "cuda"
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device": device.type,
        "device_kind": (torch.cuda.get_device_name(device) if cuda
                        else "cpu"),
        "device_count": torch.cuda.device_count() if cuda else 1,
    }


def _config_dict(cfg: MeshConfig) -> Dict[str, Any]:
    return {"name": cfg.name, "n_pes": cfg.n_pes,
            "reg_bits": cfg.reg_bits, "schedule": cfg.schedule,
            "n_macs": cfg.n_macs}


def sweep_configs(smoke: bool = False) -> List[MeshConfig]:
    """The swept design points + the MAC baseline anchor."""
    pes = (64, 256) if smoke else (64, 128, 256, 512)
    regs = (8, 16) if smoke else (8, 10, 12, 16)
    cfgs = [MeshConfig(n_pes=n, reg_bits=r, schedule=s)
            for n in pes for r in regs for s in ("compact", "naive")]
    cfgs.append(MeshConfig.mac_baseline())
    return cfgs


def pareto_front(points: List[Dict[str, Any]],
                 keys: Tuple[str, ...] = ("energy_uj", "time_ms",
                                          "area_mm2")
                 ) -> List[Dict[str, Any]]:
    """Non-dominated subset, minimizing every key."""

    def dominates(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
        return (all(a[k] <= b[k] for k in keys)
                and any(a[k] < b[k] for k in keys))

    return [p for p in points
            if not any(dominates(q, p) for q in points if q is not p)]


def _sim_metrics(r: SimResult, wl: Workload) -> Dict[str, Any]:
    e, t = r.energy_per_class_j, r.time_s
    return {"config": r.arch_name, "energy_uj": e * 1e6,
            "time_ms": t * 1e3, "ops_mop": wl.total_ops / 1e6,
            "perf_gops": wl.total_ops / t / 1e9,
            "eff_tops_w": wl.total_ops / e / 1e12,
            "area_mm2": r.area_um2 / 1e6,
            "wall_cycles": r.wall_cycles}


def _table3_parity(sim: SimResult, rows: List[Dict[str, Any]],
                   arch_name: str) -> bool:
    """Measured conv-layer P/Z vs the closed-form table3_rows()."""
    got = {d["layer"]: (d["P"], d["Z"]) for d in sim.conv_pz()}
    for row in rows:
        want = (row[f"{arch_name}_P"], row[f"{arch_name}_Z"])
        if got.get(row["layer"]) != want:
            return False
    return len(got) == len(rows)


def _execute_workload(key: str, cells: CellSpecs, system: SystemParams,
                      batch: int, pe_samples: int,
                      log: Callable[[str], None],
                      device: torch.device) -> Dict[str, Any]:
    wl = WORKLOADS[key]
    cb = compile_spec(wl, device=device, batch=batch)
    params = cb.init(torch.Generator().manual_seed(0))
    shape = (batch,) + cb.spec.input_shape
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float32).to(device)

    tulip = simulate(cb, params, x, mesh=MeshConfig(), cells=cells,
                     system=system, pe_samples=pe_samples, seed=0)
    mac = simulate(cb, params, x, mesh=MeshConfig.mac_baseline(),
                   cells=cells, system=system, pe_samples=0, seed=0,
                   check_oracle=False)

    rows = cb.table3_rows()
    ratio = mac.energy_per_class_j / tulip.energy_per_class_j
    closed = evaluate(wl, MeshConfig().arch(), cells, system)
    entry = {
        "name": wl.name,
        "dataset": wl.dataset,
        "batch": batch,
        "oracle_bit_identical": bool(tulip.oracle_bit_identical),
        "mac_logits_bit_identical": bool(
            torch.equal(tulip.logits, mac.logits)),
        "pe_programs_checked": tulip.pe_nodes_checked,
        "pe_programs_ok": tulip.pe_programs_ok,
        "run_torch_crosschecked": tulip.run_torch_crosschecked,
        "cycles_match_table3": bool(
            tulip.counts_match_mapping and mac.counts_match_mapping
            and _table3_parity(tulip, rows, "TULIP")
            and _table3_parity(mac, rows, "YodaNN")),
        "matches_closed_form": bool(math.isclose(
            tulip.energy_per_class_j, closed.energy_j(),
            rel_tol=1e-9)),
        "table3": [
            {"layer": d["layer"], "P": d["P"], "Z": d["Z"],
             "PZ": d["PZ"]} for d in tulip.conv_pz()],
        "tulip": _sim_metrics(tulip, wl),
        "mac_baseline": _sim_metrics(mac, wl),
        "energy_ratio_vs_mac": ratio,
    }
    log(f"  {wl.name}: oracle={entry['oracle_bit_identical']} "
        f"table3={entry['cycles_match_table3']} "
        f"pe_programs={tulip.pe_nodes_checked} ok "
        f"ratio={ratio:.2f}x "
        f"({entry['tulip']['energy_uj']:.1f} vs "
        f"{entry['mac_baseline']['energy_uj']:.1f} uJ/class)")
    for gate, val in (("oracle_bit_identical",
                       entry["oracle_bit_identical"]),
                      ("mac_logits_bit_identical",
                       entry["mac_logits_bit_identical"]),
                      ("pe_programs_ok", entry["pe_programs_ok"]),
                      ("cycles_match_table3",
                       entry["cycles_match_table3"]),
                      ("energy_ratio>=3x", ratio >= MIN_ENERGY_RATIO)):
        if not val:
            raise AssertionError(f"{wl.name}: DSE gate failed: {gate}")
    return entry


def sweep(keys: List[str], cfgs: List[MeshConfig], cells: CellSpecs,
          system: SystemParams) -> Tuple[List[Dict[str, Any]],
                                         Dict[str, List[str]]]:
    """Price every config on each workload through the calibrated model
    with the config's own measured-schedule cycle hook; returns the
    sweep rows (``pareto`` marked) and each workload's front."""
    rows: List[Dict[str, Any]] = []
    fronts: Dict[str, List[str]] = {}
    for key in keys:
        wl = WORKLOADS[key]
        points = []
        for cfg in cfgs:
            rep = evaluate(wl, cfg.arch(), cells, system,
                           cfg.pe_node_cycles if cfg.n_pes else None)
            e, t = rep.energy_j(), rep.time_s()
            points.append({
                "workload": wl.name, **_config_dict(cfg),
                "energy_uj": e * 1e6, "time_ms": t * 1e3,
                "area_mm2": cfg.area_um2(cells) / 1e6,
                "eff_tops_w": wl.total_ops / e / 1e12,
                "pareto": False})
        for p in pareto_front(points):
            p["pareto"] = True
        fronts[wl.name] = [p["name"] for p in points if p["pareto"]]
        rows.extend(points)
    return rows, fronts


def run_dse(log: Callable[[str], None] = print,
            out_json: Optional[str] = None,
            smoke: bool = False, device: Any = None) -> Dict[str, Any]:
    """Execute + sweep; returns (and optionally writes) the artifact
    body.  See module docstring for the three phases.  ``device``: where
    the workloads execute — None means the card (a host without one
    raises); ``"cpu"`` runs the kernels' plain versions."""
    import json

    dev = resolve_device(device)
    cells = CellSpecs()
    log("== TULIP-PE mesh DSE (simulate + Pareto sweep) ==")
    log("calibrating the energy model against Tables IV/V ...")
    system = calibrate_tulip(WORKLOADS, calibrate(WORKLOADS, cells),
                             cells)
    log(f"  w0={system.w0:.1f} bw_fc={system.bw_fc:.3f} "
        f"a_int={system.a_int:.3f} g={system.g:.3f} "
        f"e_off={system.e_off_pj:.2f}pJ pe_act={system.pe_act:.2f}")

    keys = ["binarynet"] if smoke else ["binarynet", "alexnet"]
    batch = 1 if smoke else 2
    pe_samples = 1 if smoke else 2
    workloads = [_execute_workload(k, cells, system, batch, pe_samples,
                                   log, dev) for k in keys]

    log("sweeping mesh configs ...")
    rows, fronts = sweep(keys, sweep_configs(smoke), cells, system)
    for name, front in fronts.items():
        n = sum(r["workload"] == name for r in rows)
        log(f"  {name}: {n} points, {len(front)} on the Pareto front "
            f"({', '.join(front)})")

    out = {
        "env": _env(dev),
        "dse": {
            "smoke": smoke,
            "min_energy_ratio": MIN_ENERGY_RATIO,
            "calibration": {
                "w0": system.w0, "bw_fc": system.bw_fc,
                "a_int": system.a_int, "g": system.g,
                "e_off_pj": system.e_off_pj, "pe_act": system.pe_act},
            "default_config": _config_dict(MeshConfig()),
            "workloads": workloads,
            "sweep": rows,
            "pareto_fronts": fronts,
            "comparison_points": COMPARISON_POINTS,
        },
    }
    if out_json:
        with open(out_json, "w") as f:
            json.dump(out, f, indent=1)
        log(f"wrote {out_json}")
    return out
