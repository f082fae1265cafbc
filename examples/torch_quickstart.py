"""Quickstart on the PyTorch/CUDA port: the TULIP technique end-to-end.

The twin of ``examples/quickstart.py``, on ``repro_torch`` (torch and
numpy only), in the same six sections:

1. A BNN node on the cycle-accurate TULIP-PE simulator (the ASIC).
2. The same math as a binarized layer: latent weights -> PackedArray
   serving path, folded batch norm.
3. A fully-binary 3-layer MLP through the graph compiler: one
   ``compile(spec)`` plans the launches and the activations stay packed
   between layers.
4. One packed binary conv layer, then the whole BinaryNet CIFAR-10 net
   compiled from the Workload rows: forward pass, lowering plan, bytes
   moved against bf16, and the TULIP-PE mapping of the same spec.
5. The serving front door: the compiled BinaryNet behind a
   ``BNNServer`` (pow2 buckets, one CUDA graph a dispatch level on the
   card) on one device.
6. ``simulate`` of the compiled net on the paper's TULIP-PE mesh, and
   the DSE sweep's Pareto front.

It runs on the card (the port's Hopper kernels) unless ``--device cpu``
is passed, where every kernel wrapper takes its plain torch version.
Params come from seeded ``torch.Generator``s (the reference's
``jax.random`` draws cannot be reproduced); the numpy draws are the
reference's, so the ASIC line, the conv byte line and the Pareto rows
print the reference's text.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch import graph
from repro_torch.core.adder_tree import make_ext_inputs, schedule_tree
from repro_torch.core.binarize import xnor_popcount_dot
from repro_torch.core.bnn_layers import (apply_folded, maxpool_packed,
                                         quantize_for_serving)
from repro_torch.core.energy import (CellSpecs, calibrate, calibrate_tulip,
                                     evaluate)
from repro_torch.core.tulip_pe import run_numpy
from repro_torch.core.workloads import WORKLOADS, binarynet_cifar10
from repro_torch.kernels.ops import binarize_pack, binary_conv2d
from repro_torch.kernels.packed import PackedArray, resolve_device
from repro_torch.serving import BNNServer
from repro_torch.sim import simulate
from repro_torch.sim.dse import pareto_front, sweep_configs

# the port's plan for the 3-layer MLP at batch 8: the thresholded
# hidden stack in one fused launch, the logits head its own launch
MLP_PLAN = ["fused_stack", "dense"]


def _words_bytes(a: PackedArray) -> int:
    return a.words.numel() * 4          # uint32 words, as the reference


def asic(rng, log) -> Dict[str, Any]:
    """1. a 96-input binary neuron on one TULIP-PE, 8 PEs in SIMD."""
    n, T = 96, 40
    sched = schedule_tree(n, threshold=T, compact=True)
    x_bits = (rng.random((8, n)) < 0.5).astype(np.int32)
    w_bits = (rng.random(n) < 0.5).astype(np.int32)
    products = 1 - (x_bits ^ w_bits)                    # XNOR array
    ext = make_ext_inputs(sched.ext_layout, products, sched.cycles)
    _, _, trace = run_numpy(sched.program, ext, trace=True)
    pe_out = trace[:, sched.cmp_result_cycle, sched.cmp_neuron]
    ref = (products.sum(axis=1) >= T).astype(np.int32)
    assert (pe_out == ref).all()
    line = (f"[ASIC] 96-input BNN node on a TULIP-PE: {sched.cycles} "
            f"cycles, {sched.fine_peak_bits}-bit peak storage, output == "
            f"reference ✓")
    log(line)
    return {"line": line, "cycles": sched.cycles}


def framework(rng, dev, log) -> Dict[str, Any]:
    """2. a binarized dense layer in the packed serving form."""
    K, N, B = 96, 16, 8
    w = rng.normal(size=(N, K)).astype(np.float32)
    mu, sig = rng.normal(size=N), rng.uniform(0.5, 2, N)
    gam, bet = rng.normal(size=N) + 1.5, rng.normal(size=N)
    wp, fold = quantize_for_serving(
        torch.from_numpy(w).to(dev), *(torch.from_numpy(a).float().to(dev)
                                       for a in (mu, sig, gam, bet)))
    xs = torch.where(torch.from_numpy(
        rng.normal(size=(B, K)).astype(np.float32)).to(dev) > 0, 1.0, -1.0)
    y = apply_folded(xnor_popcount_dot(PackedArray.pack(xs), wp), fold)
    values = sorted(float(v) for v in torch.unique(y).cpu())
    assert set(values) <= {-1.0, 1.0}, values
    log(f"[framework] packed XNOR-popcount serving layer: out shape "
        f"{tuple(y.shape)}, values in {set(values)} ✓")
    return {"shape": tuple(y.shape), "values": values}


def mlp(rng, dev, log) -> Dict[str, Any]:
    """3. a fully-binary 3-layer MLP through graph.compile."""
    D, H, O = 256, 192, 16
    x = rng.normal(size=(8, D)).astype(np.float32)
    Ws = [rng.normal(size=(H, D)), rng.normal(size=(H, H)),
          rng.normal(size=(O, H))]
    spec = graph.from_dense_stack(D, [H, H, O], logits=True, name="mlp3")
    cb = graph.compile(spec, batch=8, device=dev)

    def packed(wi):
        return PackedArray.pack(torch.from_numpy(
            wi.astype(np.float32)).to(dev), axis=-1)
    mparams = {"fc": [{"wp": packed(wi), "t": 0} for wi in Ws[:-1]]
               + [{"wp": packed(Ws[-1])}]}
    logits = cb.apply(mparams, binarize_pack(torch.from_numpy(x).to(dev)))
    plan = [s.kind for s in cb.plan if s.kind in ("fused_stack", "dense")]
    assert plan == MLP_PLAN, plan
    h = np.where(x > 0, 1.0, -1.0)
    for wi in Ws[:-1]:
        h = np.where(h @ np.where(wi > 0, 1.0, -1.0).T >= 0, 1.0, -1.0)
    ref_logits = h @ np.where(Ws[-1] > 0, 1.0, -1.0).T
    assert (logits.cpu().numpy() == ref_logits).all()
    log(f"[compile] 3-layer fully-binary MLP via graph.compile "
        f"({D}->{H}->{H}->{O}): {cb.launch_count()} launches vs "
        f"{cb.legacy_launch_count()} chained, == float sign-net ✓")
    return {"plan": plan, "launches": cb.launch_count(),
            "legacy_launches": cb.legacy_launch_count()}


def conv_and_binarynet(rng, dev, log) -> Dict[str, Any]:
    """4. one packed binary conv layer, then BinaryNet compiled."""
    nb, hh, ww_, cc, ff = 2, 16, 16, 128, 256
    xs = torch.from_numpy(rng.choice([-1.0, 1.0], size=(nb, hh, ww_, cc))
                          .astype(np.float32)).to(dev)
    wc = torch.from_numpy(rng.choice([-1.0, 1.0], size=(3, 3, cc, ff))
                          .astype(np.float32)).to(dev)
    ap = binarize_pack(xs)                               # [2,16,16,C/32]
    out = binary_conv2d(ap, PackedArray.pack(wc, axis=2), threshold=0,
                        pack_out=True)
    pooled = maxpool_packed(out)                         # OR == max on ±1
    act = _words_bytes(ap) + _words_bytes(out)
    bf16_bytes = 2 * (xs.numel() + wc.numel() + out.shape[0] * 16 * 16 * ff)
    conv_line = (f"[conv] binary conv {cc}->{ff} + OR-pool: {act}"
                 f" activation bytes in HBM vs {bf16_bytes} bf16 "
                 f"({bf16_bytes // act}x less), out "
                 f"{tuple(pooled.shape)} still packed ✓")
    log(conv_line)

    wl = binarynet_cifar10()
    cbn = graph.compile(wl, device=dev)
    cnn = cbn.init(torch.Generator().manual_seed(3))
    img = torch.randn((1, 32, 32, 3), generator=torch.Generator()
                      .manual_seed(4)).to(dev)
    logits = cbn.apply(cnn, img)
    assert tuple(logits.shape) == (1, 10) and torch.isfinite(
        logits.float()).all()
    tr = cbn.traffic(batch=1)
    pe_rows = [r for r in cbn.tulip_mapping() if r["kind"] == "conv"
               and r["mapping"].uses_pe]
    log(f"[compile] BinaryNet CIFAR-10 compiled (6 conv + 3 fc, "
        f"{wl.total_ops / 1e6:.0f} MOp): logits {tuple(logits.shape)}, "
        f"{cbn.launch_count()} launches (legacy "
        f"{cbn.legacy_launch_count()}), HBM "
        f"{tr['packed_bytes'] / 1e6:.1f}MB packed vs "
        f"{tr['bf16_bytes'] / 1e6:.1f}MB bf16 "
        f"({tr['ratio_bf16_over_packed']:.1f}x), "
        f"{len(pe_rows)} conv layers on the TULIP-PEs ✓")
    log("[compile] lowering plan:")
    for s in cbn.plan:
        log(f"    {s}")
    return {"conv_line": conv_line, "compiled": cbn, "params": cnn,
            "image": img, "logits": logits,
            "launches": cbn.launch_count(), "pe_layers": len(pe_rows)}


def serve(cbn, cnn, dev, log) -> Dict[str, Any]:
    """5. the compiled BinaryNet behind a BNNServer on one device."""
    def req(i, rows):
        return torch.randn((rows, 32, 32, 3), generator=torch.Generator()
                           .manual_seed(10 + i)).to(dev)
    server = BNNServer(cbn, cnn, max_batch=4, mesh=None, device=dev)
    server.start()
    try:
        futs = [server.submit(req(i, rows))
                for i, rows in enumerate((1, 3, 2, 4))]
        outs = [f.result(timeout=300) for f in futs]
    finally:
        server.stop()
    direct = cbn.apply(cnn, req(0, 1))
    assert torch.equal(outs[0], direct)
    st = server.stats()
    assert st["faults"]["backend_fallbacks"] == 0, st["faults"]
    log(f"[serve] BNNServer over the compiled BinaryNet: "
        f"{st['requests']} requests / {st['rows']} rows on "
        f"{st['devices']} device(s), {st['jit_traces']} graphs "
        f"(bound {st['trace_bound']}), bucket hit rate "
        f"{st['bucket_hit_rate']:.2f}, occupancy {st['occupancy']:.2f}, "
        f"{st['hbm_bytes_per_request'] / 1e6:.2f}MB HBM/request, "
        f"== direct apply ✓")
    return {"stats": st}


def silicon(cbn, cnn, dev, log) -> Dict[str, Any]:
    """6. simulate on the TULIP-PE mesh; the DSE sweep's Pareto front."""
    cells = CellSpecs()
    system = calibrate_tulip(WORKLOADS, calibrate(WORKLOADS, cells), cells)
    img = torch.randn((1, 32, 32, 3), generator=torch.Generator()
                      .manual_seed(10)).to(dev)
    sim = simulate(cbn, cnn, img, cells=cells, system=system,
                   pe_samples=1)
    assert sim.oracle_bit_identical and sim.pe_programs_ok
    log(f"[sim] BinaryNet on {sim.arch_name}: "
        f"{sim.energy_per_class_j * 1e6:.0f} uJ/class, "
        f"{sim.time_s * 1e3:.1f} ms, {sim.area_um2 / 1e6:.2f} mm2, "
        f"logits == apply ✓ ({sim.pe_nodes_checked} PE programs checked)")
    wl = WORKLOADS["binarynet"]
    pts = []
    for cfg in sweep_configs(smoke=True):
        rep = evaluate(wl, cfg.arch(), cells, system,
                       cfg.pe_node_cycles if cfg.n_pes else None)
        pts.append({"name": cfg.name, "energy_uj": rep.energy_j() * 1e6,
                    "time_ms": rep.time_s() * 1e3,
                    "area_mm2": cfg.area_um2(cells) / 1e6})
    rows = []
    for p in pareto_front(pts, keys=("energy_uj", "time_ms", "area_mm2")):
        rows.append(f"[dse]  Pareto: {p['name']:<18s} "
                    f"{p['energy_uj']:7.1f} uJ  {p['time_ms']:6.1f} ms  "
                    f"{p['area_mm2']:.2f} mm2")
        log(rows[-1])
    return {"pareto_rows": rows, "pe_nodes_checked": sim.pe_nodes_checked}


def main(device=None, log: Callable[[str], None] = print
         ) -> Dict[str, Any]:
    """Run the six sections on ``device`` (None = the card); returns
    what each asserted on."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    out = {"asic": asic(rng, log), "framework": framework(rng, dev, log),
           "mlp": mlp(rng, dev, log)}
    out["binarynet"] = conv_and_binarynet(rng, dev, log)
    cbn, cnn = out["binarynet"]["compiled"], out["binarynet"]["params"]
    out["serve"] = serve(cbn, cnn, dev, log)
    out["sim"] = silicon(cbn, cnn, dev, log)
    log("quickstart OK")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the host")
    main(ap.parse_args().device)
