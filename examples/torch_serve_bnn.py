"""Serving example on the PyTorch/CUDA port: batched requests against a
binarized model with the TULIP-packed weight layout (int32 words holding
the uint32 bits, 16x less weight traffic) against the dense baseline —
the same tokens, a different memory roofline.

The twin of ``examples/serve_bnn.py``: the port's
``launch.serve.Engine`` on reduced qwen1.5-0.5b in float32, dense then
packed, on the card unless ``--device cpu`` is passed.  Params are
drawn from a seeded CPU ``torch.Generator`` (one seed, one state on
any device); ``main(params=...)`` serves a given tree instead.

Run:  PYTHONPATH=src python examples/torch_serve_bnn.py [--device cpu]
"""
import argparse
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.kernels.packed import resolve_device
from repro_torch.launch.serve import Engine, Request
from repro_torch.models import init_params


def config():
    return reduced(get_arch("qwen1.5-0.5b")).replace(dtype="float32")


def main(device=None, params: Optional[Any] = None,
         log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Serve 4 requests of 10 tokens, 6 new each, on 2 slots, dense then
    packed; returns both layouts' tokens (equal: the packed product
    rounds as the dense one) and their param bytes."""
    dev = resolve_device(device)
    cfg = config()
    if params is None:
        params = init_params(torch.Generator().manual_seed(0), cfg, dev)

    def mk():
        rng = np.random.default_rng(0)
        return [Request(i, rng.integers(0, cfg.vocab_size, 10).astype(
            np.int32), 6) for i in range(4)]

    out: Dict[str, Any] = {}
    for packed, title in ((False, "dense weight layout (baseline):"),
                          (True, "TULIP bit-packed weight layout:")):
        log(title)
        eng = Engine(cfg, params, batch_slots=2, capacity=32,
                     packed=packed, device=dev)
        reqs = eng.run(mk(), log=log)
        key = "packed" if packed else "dense"
        out[key] = [list(r.out) for r in reqs]
        out[key + "_param_bytes"] = eng.param_bytes
    assert out["packed"] == out["dense"], (out["dense"], out["packed"])
    n_weights = cfg.param_count()
    log(f"\nweights: {n_weights / 1e6:.1f}M params; packed layout moves "
        f"~16x fewer weight bytes per decode step "
        f"({out['dense_param_bytes'] / 1e6:.1f} MB dense, "
        f"{out['packed_param_bytes'] / 1e6:.1f} MB packed here)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the host")
    main(ap.parse_args().device)
