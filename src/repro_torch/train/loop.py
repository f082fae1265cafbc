"""The STE training loop: the eager step, the eval path, checkpointed
``fit`` — the port of ``repro.train.loop``.

The deterministic image stream (``repro_torch.data.images``) -> one
autograd pass over train/models.py's STE forward -> AdamW on the latent
weights (``repro_torch.optim.adamw``; clip_mask keeps BN gamma/beta out
of the [-1, 1] clamp) -> atomic sha256-verified checkpoints with the
data cursor -> auto-resume that reproduces the uninterrupted trajectory
bit for bit.

Bit-identical resume on the card needs a step whose device work is
deterministic: the step runs cuDNN with ``deterministic=True`` and
``benchmark=False`` (restored afterwards) and TF32 off, on one stream,
and uses no op whose CUDA backward adds with atomics — the loss picks
each row's log-probability with a one-hot product, not a gather, whose
backward is a scatter-add.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree as _tree
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.data.images import (ImageDataConfig, ImageIterator,
                                     eval_batch_at)
from repro_torch.graph.ir import BNNSpec
from repro_torch.kernels.packed import resolve_device
from repro_torch.optim import adamw
from repro_torch.train.models import (BN_MOMENTUM, clip_mask_for,
                                      init_train_state, train_forward)

__all__ = ["TrainConfig", "fit", "evaluate", "make_train_step",
           "default_logit_scale", "loss_and_grads"]


@dataclass(frozen=True)
class TrainConfig:
    steps: int
    lr: float = 0.01
    weight_decay: float = 1e-4
    warmup_frac: float = 0.1
    clip_norm: float = 5.0
    logit_scale: Optional[float] = None  # None: 1/sqrt(last n_in)
    bn_momentum: float = BN_MOMENTUM
    seed: int = 0
    ckpt_every: int = 0  # 0: no checkpoints
    log_every: int = 10


def default_logit_scale(spec: BNNSpec) -> float:
    """The pm1 dot of the terminal K-wide layer lands in [-K, K]; at
    init its scale is ~sqrt(K), so 1/sqrt(K) puts the softmax in its
    responsive range without touching the (scale-invariant) argmax."""
    return 1.0 / float(np.sqrt(spec.dense_nodes[-1].n_in))


@contextlib.contextmanager
def deterministic():
    """cuDNN deterministic, no autotuning, TF32 off; restored on exit."""
    cd = torch.backends.cudnn
    with cd.flags(enabled=cd.enabled, benchmark=False, deterministic=True,
                  allow_tf32=False):
        yield


def _loss(logits: torch.Tensor, labels: torch.Tensor, scale: float
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    lp = F.log_softmax(logits * scale, dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(lp.dtype)
    ce = -torch.sum(lp * onehot, dim=-1).mean()
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return ce, acc


def _model_input(spec: BNNSpec, images: torch.Tensor) -> torch.Tensor:
    """Dense-entry specs take flattened rows; conv specs NHWC."""
    if len(spec.input_shape) == 1:
        return images.reshape(images.shape[0], -1)
    return images


def loss_and_grads(spec: BNNSpec, params: Any, bn: Any,
                   images: torch.Tensor, labels: torch.Tensor,
                   logit_scale: float, bn_momentum: float = BN_MOMENTUM
                   ) -> Tuple[torch.Tensor, torch.Tensor, Any, Any]:
    """(cross-entropy, accuracy, new bn_state, grads): the STE forward
    with batch-statistic BN and one autograd pass, deterministic on the
    card."""
    flat, treedef = _tree.flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    with deterministic():
        logits, new_bn = train_forward(
            spec, _tree.unflatten(treedef, leaves), bn,
            _model_input(spec, images), train=True, momentum=bn_momentum)
        ce, acc = _loss(logits, labels, logit_scale)
        grads = torch.autograd.grad(ce, leaves)
    return ce.detach(), acc, new_bn, _tree.unflatten(treedef, list(grads))


def make_train_step(spec: BNNSpec, opt_cfg: adamw.AdamWConfig,
                    logit_scale: float, bn_momentum: float = BN_MOMENTUM):
    """The training step ``(params, bn, opt, images, labels) -> (params,
    bn, opt, metrics)``: STE forward with batch-stat BN, cross-entropy on
    the scaled logits, AdamW on the latent weights with the w-only
    [-1, 1] clamp.  Eager: one autograd pass, then the update."""

    def step(params, bn, opt, images, labels):
        ce, acc, new_bn, grads = loss_and_grads(
            spec, params, bn, images, labels, logit_scale, bn_momentum)
        with torch.no_grad():
            params, opt, metrics = adamw.apply_updates(
                params, opt, grads, opt_cfg, clip_mask=clip_mask_for(params))
        return params, new_bn, opt, dict(metrics, loss=ce, acc=acc)

    return step


def _batch_on(batch: Dict[str, np.ndarray], dev: torch.device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.from_numpy(batch["image"]).to(dev),
            torch.from_numpy(batch["label"]).to(dev))


def evaluate(spec: BNNSpec, params, bn, dcfg: ImageDataConfig,
             n_batches: int = 4, binarize: bool = True,
             logit_scale: Optional[float] = None,
             device: Any = None) -> Dict[str, float]:
    """Held-out accuracy/loss on the eval stream (sample counters
    disjoint from every training step), on ``device`` (None: the card),
    where ``params`` and ``bn`` lie.  ``binarize=False`` runs the
    float32-latent twin."""
    dev = resolve_device(device)
    scale = logit_scale if logit_scale is not None \
        else default_logit_scale(spec)
    losses, accs = [], []
    with torch.no_grad():
        for j in range(n_batches):
            images, labels = _batch_on(eval_batch_at(dcfg, j), dev)
            logits, _ = train_forward(spec, params, bn,
                                      _model_input(spec, images),
                                      train=False, binarize=binarize)
            ce, acc = _loss(logits, labels, scale)
            losses.append(float(ce))
            accs.append(float(acc))
    return {
        "loss": float(np.mean(losses)),
        "acc": float(np.mean(accs)),
        "rows": n_batches * dcfg.global_batch,
    }


def fit(spec: BNNSpec, dcfg: ImageDataConfig, tcfg: TrainConfig,
        ckpt_dir: Optional[str] = None, run_steps: Optional[int] = None,
        log_fn=print, device: Any = None) -> Dict[str, Any]:
    """Train ``spec`` on the deterministic image stream, on ``device``
    (None: the card; a host without one raises).

    ``ckpt_dir``: save (params, bn, opt) + the data cursor every
    ``tcfg.ckpt_every`` steps (atomic, sha256-verified) and auto-resume
    from the latest complete checkpoint; a resumed run's loss/param
    trajectory is bit-identical to an uninterrupted one.
    ``run_steps``: execute at most this many steps this invocation
    (simulated preemption — the schedule horizon stays tcfg.steps)."""
    dev = resolve_device(device)
    spec.validate()
    scale = tcfg.logit_scale
    if scale is None:
        scale = default_logit_scale(spec)
    opt_cfg = adamw.AdamWConfig(
        lr=tcfg.lr,
        weight_decay=tcfg.weight_decay,
        clip_norm=tcfg.clip_norm,
        total_steps=max(tcfg.steps, 2),
        warmup_steps=max(1, int(tcfg.steps * tcfg.warmup_frac)),
    )

    params, bn = init_train_state(torch.Generator().manual_seed(tcfg.seed),
                                  spec, device=dev)
    opt = adamw.init(params)
    start_step = 0
    data = ImageIterator(dcfg)
    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        (params, bn, opt), meta = restore(ckpt_dir, (params, bn, opt))
        start_step = int(meta["extra"]["step"])
        data = ImageIterator.from_state(
            dcfg, meta["extra"]["data"], shard=0, n_shards=1)
        log_fn(f"[resume] from step {start_step}")

    step_fn = make_train_step(spec, opt_cfg, scale, tcfg.bn_momentum)
    losses: list = []
    accs: list = []
    end = tcfg.steps
    if run_steps is not None:
        end = min(tcfg.steps, start_step + run_steps)
    for it in range(start_step, end):
        images, labels = _batch_on(next(data), dev)
        params, bn, opt, m = step_fn(params, bn, opt, images, labels)
        losses.append(float(m["loss"]))
        accs.append(float(m["acc"]))
        if it % tcfg.log_every == 0 or it == tcfg.steps - 1:
            log_fn(f"step {it:5d} loss {losses[-1]:.4f} "
                   f"acc {accs[-1]:.3f} "
                   f"gnorm {float(m['grad_norm']):.3f}")
        save_now = (it + 1) % tcfg.ckpt_every == 0 if tcfg.ckpt_every \
            else False
        if ckpt and tcfg.ckpt_every and (save_now or it == end - 1):
            ckpt.save(it + 1, (params, bn, opt),
                      extra={"step": it + 1, "data": data.state_dict()})
    if ckpt:
        ckpt.wait()
    return {
        "losses": losses,
        "accs": accs,
        "params": params,
        "bn": bn,
        "opt": opt,
        "step": end,
        "logit_scale": scale,
    }
