"""Fault-tolerant LLM trainer — the port of
``repro.launch.train``.

The deterministic token stream (``repro_torch.data``) -> one eager
train step (``loss_fn`` and its gradients by ``torch.autograd``, then
AdamW on the latent binarized weights) -> async atomic checkpoints
(``repro_torch.checkpoint``: params, opt state, the data cursor) ->
auto-resume.

Fault tolerance contract (``tests/test_torch_llm_train.py``, and
``chip_smoke.py`` on the card at qwen1.5-0.5b's published config):
kill the process at any step; rerunning with the same ``ckpt_dir``
resumes from the latest complete checkpoint and reproduces exactly the
step sequence an uninterrupted run would have produced.  A step-time
watchdog records straggler events.

The port trains on one card: SPMD training over a ``torch.distributed``
``DeviceMesh`` (FSDP + TP placements from ``runtime.sharding.
param_specs``) is the next slice of the port, and until then a ``mesh``
other than None raises.  ``train`` runs on the card unless the
caller passes ``device="cpu"``; it never falls back to the CPU.

Bit-identical resume on the card needs a deterministic step: the
embedding lookup's backward (the tied embedding is read twice), the
target-logit gather's and MoE's scatters add with atomics unless
``torch.use_deterministic_algorithms(True)``, which the step runs
under (restored afterwards).  On the card that mode needs
``CUBLAS_WORKSPACE_CONFIG`` set before cuBLAS makes its first handle:
``train`` and ``make_train_step`` set ``:4096:8`` when it is unset and
raise when it holds another value (ROADMAP hazard 12).

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --reduced \\
        --steps 20 --batch 8 --seq 64 [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import get_arch, reduced
from repro_torch.data import DataConfig, DataIterator
from repro_torch.kernels.packed import resolve_device
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime.straggler import StepWatchdog

__all__ = ["deterministic", "loss_and_grads", "main", "make_train_step",
           "train"]

CUBLAS_CONFIGS = (":4096:8", ":16:8")   # cuBLAS's deterministic settings


def _deterministic_cublas() -> None:
    """Make cuBLAS deterministic for this process, or raise."""
    got = os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_CONFIGS[0])
    if got not in CUBLAS_CONFIGS:
        raise RuntimeError(
            f"CUBLAS_WORKSPACE_CONFIG={got!r}: deterministic training on "
            f"the card needs one of {CUBLAS_CONFIGS}")


@contextlib.contextmanager
def deterministic(device: torch.device):
    """``torch.use_deterministic_algorithms(True)`` (and TF32 off) for
    the block, the previous settings restored on exit."""
    if device.type == "cuda":
        _deterministic_cublas()
    was = torch.are_deterministic_algorithms_enabled()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        torch.backends.cuda.matmul.allow_tf32 = tf32


def loss_and_grads(params: Any, cfg, batch: Dict[str, torch.Tensor]):
    """(loss, grads): ``loss_fn`` and one autograd pass over every
    param leaf, deterministic; a leaf the loss does not reach gets a
    zero gradient, as ``jax.grad`` gives."""
    flat, treedef = _tree.flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    with deterministic(leaves[0].device):
        loss = M.loss_fn(_tree.unflatten(treedef, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), _tree.unflatten(treedef, list(grads))


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig):
    """The step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``: loss and grads, then AdamW (every leaf clamped to
    [-1, 1], as the reference's default); metrics ``loss``,
    ``grad_norm``, ``lr``."""

    def step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, cfg, batch)
        with torch.no_grad():
            params, opt_state, metrics = adamw.apply_updates(
                params, opt_state, grads, opt_cfg)
        return params, opt_state, dict(metrics, loss=loss)
    return step


def train(cfg, *, steps: int, global_batch: int, seq_len: int,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 10,
          lr: float = 3e-4, mesh=None, device=None, seed: int = 0,
          log_every: int = 5, log_fn=print,
          run_steps: Optional[int] = None) -> Dict[str, Any]:
    """Train ``cfg`` on the token stream on ``device`` (None = the
    card).  run_steps: execute at most this many steps this invocation
    (simulated preemption — the schedule horizon stays ``steps``)."""
    if mesh is not None:
        raise ValueError("SPMD training over a mesh (a torch.distributed "
                         "DeviceMesh with param_specs placements) is the "
                         "port's next slice: mesh must be None")
    dev = resolve_device(device)
    if dev.type == "cuda":
        _deterministic_cublas()
    opt_cfg = adamw.AdamWConfig(lr=lr, total_steps=max(steps, 2),
                                warmup_steps=max(2, steps // 10))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch, seed=seed)
    # drawn on the host: one seed gives the same params on any device
    params = M.init_params(torch.Generator().manual_seed(seed), cfg, dev)
    opt_state = adamw.init(params)

    start_step = 0
    data = DataIterator(dcfg)
    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        (params, opt_state), meta = restore(ckpt_dir, (params, opt_state))
        start_step = int(meta["extra"]["step"])
        data = DataIterator.from_state(dcfg, meta["extra"]["data"],
                                       shard=0, n_shards=1)
        log_fn(f"[resume] from step {start_step}")

    step_fn = make_train_step(cfg, opt_cfg)
    wd = StepWatchdog()
    losses = []
    end = steps if run_steps is None else min(steps, start_step + run_steps)
    for it in range(start_step, end):
        batch = {k: torch.from_numpy(v).to(dev).long()
                 for k, v in next(data).items()}
        wd.start()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        slow = wd.stop()
        losses.append(loss)
        if it % log_every == 0 or it == steps - 1:
            log_fn(f"step {it:5d} loss {loss:.4f} "
                   f"gnorm {float(metrics['grad_norm']):.3f}"
                   + (" [straggler]" if slow else ""))
        if ckpt and ((it + 1) % ckpt_every == 0 or it == end - 1):
            ckpt.save(it + 1, (params, opt_state),
                      extra={"step": it + 1, "data": data.state_dict()})
    if ckpt:
        ckpt.wait()
    return {"losses": losses, "params": params, "opt_state": opt_state,
            "straggler_events": wd.flags}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the host")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg).replace(dtype="float32")
    out = train(cfg, steps=args.steps, global_batch=args.batch,
                seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, lr=args.lr, seed=args.seed,
                device=args.device)
    first = np.mean(out["losses"][:5])
    last = np.mean(out["losses"][-5:])
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return out


if __name__ == "__main__":
    main()
