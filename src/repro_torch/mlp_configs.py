"""Every launch config of the fused binary MLP kernel, timed at the main
paths' dense stacks beside the config that ``fused_mlp.launch_config``
picks.

    PYTHONPATH=src python -m repro_torch.mlp_configs [--batches 1 32 256]

For BinaryNet CIFAR-10's fc1+fc2 (8192 -> 1024 -> 1024) and XNOR-AlexNet's
fc6+fc7 (9216 -> 4096 -> 4096) at each batch: random packed operands from
a seeded generator and the main path's per-channel thresholds; every
(BM, CS) of ``fused_mlp.ROW_TILES`` x ``fused_mlp.CLUSTERS`` whose block
fits the shared memory forced through ``fused_mlp._launch``, held bit for
bit against the plan's own call and timed (device time per call,
torch.profiler).  Prints the clusters the card runs at once, then per
shape each config's time, the plan's config, the fastest, and the plan's
time over the fastest; the results also go to
``chiprun_out/mlp_configs.json``.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import fused_mlp
from repro_torch.kernels.fused_mlp import (CLUSTERS, ROW_TILES, SMEM_BYTES,
                                           _launch, fused_mlp_words,
                                           launch_config, smem_bytes,
                                           stack_plan)
from repro_torch.trace import kernel_ms

# the main paths' fused stacks: (name, K0, widths)
MAIN_STACKS = (("BinaryNet fc1+fc2", 8192, (1024, 1024)),
               ("AlexNet fc6+fc7", 9216, (4096, 4096)))


def time_configs(m: int, k0: int, ns, seed: int = 0) -> Dict:
    """Every config that fits, and the plan, at one stack and M."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def rows(n, k):
        w = torch.randint(-2 ** 31, 2 ** 31, (n, -(-k // 32)), generator=g,
                          device=dev, dtype=torch.int64).to(torch.int32)
        if k % 32:                      # zero pad bits past k
            w[:, -1] &= (1 << (k % 32)) - 1
        return w
    x = rows(m, k0)
    ws, ks, ts, k = [], [], [], k0
    for n in ns:
        ws.append(rows(n, k))
        ks.append(k)
        ts.append(torch.randint(-40, 41, (n,), generator=g, device=dev,
                                dtype=torch.int32))
        k = n
    plan = launch_config(dev, m, k0, list(ns), x.shape[1])
    want = fused_mlp_words(x, ws, ks, ts)
    buf_words = stack_plan(m, k0, list(ns))["buf_words"]
    times = {}
    for config in [(bm, cs) for bm in ROW_TILES for cs in CLUSTERS]:
        if smem_bytes(config[0], buf_words) > SMEM_BYTES:
            continue
        if not torch.equal(_launch(x, ws, ks, ts, config), want):
            raise AssertionError(f"config {config} differs from the plan's "
                                 f"call at M={m} {k0}->{list(ns)}")
        times[f"{config[0]}x{config[1]}"] = kernel_ms(
            lambda: _launch(x, ws, ks, ts, config), "fused_mlp_kernel")
    picked = f"{plan[0]}x{plan[1]}"
    best = min(times, key=times.get)
    return {"m": m, "plan": picked, "best": best,
            "plan_over_best": times[picked] / times[best], "ms": times}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 32, 256])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mlp_configs needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    active = {f"BM={bm} CS={cs}": fused_mlp._active_clusters(dev, bm, cs, 288)
              for bm in ROW_TILES for cs in CLUSTERS
              if smem_bytes(bm, 288) <= SMEM_BYTES}
    print(f"{smi}: clusters at once (AlexNet's buffers): {active}")
    rows = []
    for batch in args.batches:
        for name, k0, ns in MAIN_STACKS:
            r = dict(name=name, **time_configs(batch, k0, ns))
            rows.append(r)
            print(f"{smi}: {name} M={batch}: ms "
                  + " ".join(f"{c} {ms:.4f}" for c, ms in r["ms"].items())
                  + f"; plan {r['plan']}, fastest {r['best']}, plan/fastest "
                  f"{r['plan_over_best']:.3f}")
    hits = sum(r["plan"] == r["best"] for r in rows)
    worst = max(rows, key=lambda r: r["plan_over_best"])
    print(f"{smi}: the plan's config is the fastest at {hits} of "
          f"{len(rows)} shapes; at most {worst['plan_over_best']:.3f} of the "
          f"fastest ({worst['name']} M={worst['m']})")
    path = Path("chiprun_out")
    path.mkdir(exist_ok=True)
    (path / "mlp_configs.json").write_text(json.dumps(
        {"card": smi, "clusters_at_once": active, "shapes": rows}, indent=1))


if __name__ == "__main__":
    main()
