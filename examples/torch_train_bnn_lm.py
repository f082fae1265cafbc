"""End-to-end training example on the PyTorch/CUDA port: a binarized
qwen-family LM trained for a few hundred steps on the deterministic
token stream, with fault-tolerant checkpointing.

The twin of ``examples/train_bnn_lm.py``: the same config (reduced,
4 layers, d_model 128, d_ff 384, vocab 2048, float32; ``--full-05b``
trains the published qwen1.5-0.5b config) through the port's
``launch.train.train``, on the card unless ``--device cpu`` is passed,
and the same assert: the mean loss of the last 10 steps is below that
of the first 10.  Checkpoints go to ``--ckpt-dir``, a temporary
directory by default.

Run:  PYTHONPATH=src python examples/torch_train_bnn_lm.py --steps 200
"""
import argparse
import tempfile
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.configs import get_arch, reduced
from repro_torch.launch.train import train


def config(full_05b: bool = False):
    cfg = get_arch("qwen1.5-0.5b")
    if not full_05b:
        cfg = reduced(cfg, vocab=2048).replace(
            dtype="float32", num_layers=4, d_model=128, d_ff=384,
            name="bnn-lm-small")
    return cfg


def main(steps: int = 200, batch: int = 8, seq: int = 128,
         full_05b: bool = False, ckpt_dir: Optional[str] = None,
         device=None, log: Callable[[str], None] = print
         ) -> Dict[str, Any]:
    """Train and assert the loss fell; returns ``train``'s result with
    ``first10`` / ``last10``, the mean losses the assert compares."""
    cfg = config(full_05b)
    log(f"training {cfg.name} (binarize={cfg.binarize}) for {steps} "
        f"steps")
    with tempfile.TemporaryDirectory(prefix="bnn_lm_") as tmp:
        out = train(cfg, steps=steps, global_batch=batch, seq_len=seq,
                    ckpt_dir=ckpt_dir or tmp, ckpt_every=50, lr=1e-3,
                    log_every=20, device=device, log_fn=log)
    first = float(np.mean(out["losses"][:10]))
    last = float(np.mean(out["losses"][-10:]))
    log(f"\nloss {first:.4f} -> {last:.4f} over {steps} steps "
        f"({'improved ✓' if last < first else 'NO IMPROVEMENT ✗'})")
    assert last < first, "binarized training failed to reduce loss"
    return dict(out, first10=first, last10=last)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-05b", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the host")
    a = ap.parse_args()
    main(a.steps, a.batch, a.seq, a.full_05b, a.ckpt_dir, a.device)
