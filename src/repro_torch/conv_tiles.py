"""Every output tile of the binary conv kernel, timed at the main paths'
convs beside the tile that ``packed_conv.tile_plan`` picks.

    PYTHONPATH=src python -m repro_torch.conv_tiles [--batches 1 32 256]

For each binary conv of BinaryNet CIFAR-10 (conv2-conv6) and
XNOR-AlexNet (conv3-conv5), 3x3 stride 1 "same", at each batch: random
packed operands from a seeded generator and the main path's epilogue
(per-channel thresholds, packed output); every tile of
``packed_conv.TILES`` forced through ``packed_conv._launch``, held bit
for bit against the plan's own call and timed (device time per call,
torch.profiler).  Prints per shape each tile's time, the plan's tile,
the fastest, and the plan's time over the fastest; the results also go
to ``chiprun_out/conv_tiles.json``.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.packed_conv import (TILES, _launch, packed_conv2d,
                                             pad_words_spatial, tile_plan)
from repro_torch.trace import kernel_ms

# the main paths' binary convs, 3x3 stride 1 "same": (name, H=W, C, F)
MAIN_CONVS = (("BinaryNet conv2", 32, 128, 128),
              ("BinaryNet conv3", 16, 128, 256),
              ("BinaryNet conv4", 16, 256, 256),
              ("BinaryNet conv5", 8, 256, 512),
              ("BinaryNet conv6", 8, 512, 512),
              ("AlexNet conv3", 13, 256, 384),
              ("AlexNet conv4", 13, 384, 384),
              ("AlexNet conv5", 13, 384, 256))


def time_tiles(batch: int, h: int, c: int, f: int, seed: int = 0) -> Dict:
    """Every tile and the plan at one conv shape."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    c32 = -(-c // 32)

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=g,
                             device=dev, dtype=torch.int64).to(torch.int32)
    xw = pad_words_spatial(words(batch, h, h, c32), 1, 1).contiguous()
    ww = words(9 * c32, f)
    kw = dict(kh=3, kw=3, c=c, stride=1, ho=h, wo=h, pack_out=True,
              threshold_vec=torch.randint(-40, 41, (f,), generator=g,
                                          device=dev, dtype=torch.int32))
    plan = tile_plan(batch * h * h, f, 9 * c32, _build.device_sms(dev))
    want = packed_conv2d(xw, ww, **kw)
    times = {}
    for tile in TILES:
        if not torch.equal(_launch(xw, ww, tile, **kw), want):
            raise AssertionError(f"tile {tile} differs from the plan's "
                                 f"call at B={batch} {h}x{h}x{c}->{f}")
        times[f"{tile[0]}x{tile[1]}"] = kernel_ms(
            lambda: _launch(xw, ww, tile, **kw), "packed_conv_kernel")
    picked = f"{plan['bm']}x{plan['bn']}"
    best = min(times, key=times.get)
    return {"batch": batch, "m": batch * h * h, "f": f,
            "k_words": plan["k_words"], "plan": picked, "best": best,
            "plan_over_best": times[picked] / times[best], "ms": times}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 32, 256])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_tiles needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rows = []
    for batch in args.batches:
        for name, h, c, f in MAIN_CONVS:
            r = dict(name=name, **time_tiles(batch, h, c, f))
            rows.append(r)
            print(f"{smi}: {name} B={batch}: ms "
                  + " ".join(f"{t} {ms:.4f}" for t, ms in r["ms"].items())
                  + f"; plan {r['plan']}, fastest {r['best']}, plan/fastest "
                  f"{r['plan_over_best']:.3f}")
    hits = sum(r["plan"] == r["best"] for r in rows)
    worst = max(rows, key=lambda r: r["plan_over_best"])
    print(f"{smi}: the plan's tile is the fastest at {hits} of {len(rows)} "
          f"shapes; at most {worst['plan_over_best']:.3f} of the fastest "
          f"({worst['name']} B={worst['batch']})")
    path = Path("chiprun_out")
    path.mkdir(exist_ok=True)
    (path / "conv_tiles.json").write_text(json.dumps(
        {"card": smi, "shapes": rows}, indent=1))


if __name__ == "__main__":
    main()
