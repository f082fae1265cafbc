"""AdamW with latent binarized weights, global-norm clipping, and a
warmup+cosine schedule — the port of ``repro.optim.adamw``.

BNN training (Courbariaux et al., the paper's §II framing): the
optimizer updates *latent* full-precision weights; the forward pass sees
their sign (``repro_torch.core.binarize.ste_sign`` inside the layers).
Latent weights are clamped to [-1, 1] after each step so the STE
gradient window stays active.

Trees of tensors go in and new trees come out (nothing is updated in
place), walked in jax's leaf order (``repro_torch.tree``).  Every
scalar of the update — the schedule, the bias corrections, the clip
scale — is a float32 tensor on the parameters' device, computed in the
reference's order of operations: the reference computes them in
float32, and Python float64 would move the parameters by an ulp a step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree as _tree

__all__ = ["AdamWConfig", "OptState", "apply_updates",
           "clip_by_global_norm", "global_norm", "init", "schedule"]

F32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    clip_latent: bool = True      # keep latent weights in [-1, 1]


class OptState(NamedTuple):
    step: torch.Tensor      # int32, 0-d
    m: Any
    v: Any


def init(params: Any) -> OptState:
    first = _tree.leaves(params)[0]
    zeros = _tree.map(lambda p: torch.zeros_like(p, dtype=F32), params)
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=first.device),
                    m=zeros, v=_tree.map(torch.clone, zeros))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (float32): linear warmup, then a
    cosine down to ``min_lr_frac`` of ``lr``."""
    step = step.to(F32)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
        * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, the leaves added
    left to right in jax's order (float32)."""
    total = None
    for g in _tree.leaves(tree):
        sq = torch.sum(torch.square(g.to(F32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Any, max_norm: float,
                        gn: Optional[torch.Tensor] = None
                        ) -> Tuple[Any, torch.Tensor]:
    """Scale ``grads`` to a global norm of at most ``max_norm``; ``gn``
    is their norm where the caller has it (None: ``global_norm``)."""
    if gn is None:
        gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return _tree.map(lambda g: (g.to(F32) * scale).to(g.dtype),
                     grads), gn


def apply_updates(params: Any, opt: OptState, grads: Any, cfg: AdamWConfig,
                  clip_mask: Optional[Any] = None,
                  grad_norm: Optional[torch.Tensor] = None
                  ) -> Tuple[Any, OptState, dict]:
    """One AdamW step.  ``clip_mask`` (a bool tree matching params, or
    None) selects which leaves the ``clip_latent`` [-1, 1] clamp applies
    to — the latent sign weights, never BN gamma/beta, whose folded
    thresholds must be free to grow past +-1.  None clamps every leaf
    when cfg.clip_latent.  ``grad_norm``: the global norm of the whole
    gradient where ``grads`` are one rank's blocks of it (an SPMD
    step); None computes it from ``grads``."""
    grads, gn = clip_by_global_norm(grads, cfg.clip_norm, grad_norm)
    step = opt.step + 1
    lr = schedule(cfg, step)
    stepf = step.to(F32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=F32,
                                       device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=F32,
                                       device=stepf.device), stepf)

    def upd(p, m, v, g, clamp):
        g32 = g.to(F32)
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) \
            + cfg.weight_decay * p.to(F32)
        new = p.to(F32) - lr * delta
        if cfg.clip_latent and clamp:
            new = torch.clamp(new, -1.0, 1.0)
        return new.to(p.dtype), m, v

    flat_p, tdef = _tree.flatten(params)
    flat_m, flat_v, flat_g = (_tree.leaves(t) for t in (opt.m, opt.v, grads))
    flat_c = [True] * len(flat_p) if clip_mask is None \
        else [bool(c) for c in _tree.leaves(clip_mask)]
    if not len(flat_p) == len(flat_m) == len(flat_v) == len(flat_g) \
            == len(flat_c):
        raise ValueError("params, moments, grads and clip_mask differ in "
                         "their leaves")
    out = [upd(*xs) for xs in zip(flat_p, flat_m, flat_v, flat_g, flat_c)]
    new_p = _tree.unflatten(tdef, [o[0] for o in out])
    new_m = _tree.unflatten(tdef, [o[1] for o in out])
    new_v = _tree.unflatten(tdef, [o[2] for o in out])
    metrics = {"grad_norm": gn, "lr": lr}
    return new_p, OptState(step=step, m=new_m, v=new_v), metrics
