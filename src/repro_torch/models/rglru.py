"""RG-LRU recurrent block (recurrentgemma / Griffin, arXiv:2402.19427).

    r_t = sigmoid(Wa x_t + ba)            (recurrence gate)
    i_t = sigmoid(Wx x_t + bx)            (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The port of ``repro.models.rglru``.  The diagonal recurrence runs as a
prefix scan in float32 (``ssm.associative_scan``, the reference's
``jax.lax.associative_scan``); the surrounding projections and the
conv1d are binarizable.  The gelu is the tanh approximation
(``jax.nn.gelu``'s default).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense, dtype_of, gelu, normal,
                                       uniform, wparams)
from repro_torch.models.ssm import _conv_train, _pad_left, associative_scan
from repro_torch.runtime.sharding import shard_act

_C = 8.0


def rglru_init(gen, cfg, device) -> Dict[str, Any]:
    d = cfg.d_model
    w = cfg.lru_width or d
    dt = dtype_of(cfg)
    s = 1.0 / math.sqrt(d)
    in_proj = normal(gen, (d, 2 * w), dt, device) * s   # x and gate-input
    conv_w = normal(gen, (w, cfg.conv1d_width), dt, device) * 0.1
    gate_proj = normal(gen, (w, 2 * w), dt, device) * (1.0 / math.sqrt(w))
    out_proj = normal(gen, (w, d), dt, device) * (1.0 / math.sqrt(w))
    # Lambda init so a^c in [0.9, 0.999] (Griffin appendix)
    u = uniform(gen, (w,), 0.9, 0.999, device)
    a_param = torch.log(torch.exp(-torch.log(u) / _C) - 1.0)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((w,), dtype=dt, device=device),
        "gate_proj": gate_proj,
        "a_param": a_param,
        "out_proj": out_proj,
    }


def rglru_apply(p, x, cfg, state: Optional[Dict] = None):
    """x: [B,S,D]; state: {"conv": [B,K-1,W], "h": [B,W]}.
    Returns (y, new_state)."""
    mode = cfg.binarize if cfg.binarize_ffn else "none"
    B, S, _ = x.shape
    w = cfg.lru_width or cfg.d_model
    K = cfg.conv1d_width

    xz = dense(wparams(p, "in_proj"), x, mode)
    u, gate_in = torch.chunk(xz, 2, dim=-1)       # [B,S,W]
    u = shard_act(u, (("pod", "data"), None, "model"))

    decode = state is not None and S == 1
    if decode:
        conv_in = torch.cat([state["conv"], u], dim=1)
        uc = sum(conv_in[:, i:i + 1, :] * p["conv_w"][:, i]
                 for i in range(K)) + p["conv_b"]
        new_conv = conv_in[:, 1:]
    else:
        uc = _conv_train(u, p["conv_w"], p["conv_b"])
        new_conv = u[:, -(K - 1):] if S >= K else _pad_left(u, K - 1 - S)
    uc = gelu(uc)

    gates = dense(wparams(p, "gate_proj"), uc, "none").to(torch.float32)
    r, i = torch.chunk(torch.sigmoid(gates), 2, dim=-1)
    lam = F.softplus(p["a_param"])
    log_a = -_C * lam * r                          # [B,S,W]
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) \
        * (i * uc.to(torch.float32))

    if decode:
        h = a[:, 0] * state["h"] + gated[:, 0]
        hs = h[:, None, :]
        h_last = h
    else:
        aa, bb = associative_scan(a, gated, dim=1)
        h0 = state["h"][:, None] if state is not None \
            else torch.zeros((B, 1, w), dtype=torch.float32,
                             device=x.device)
        hs = aa * h0 + bb
        h_last = hs[:, -1]

    y = dense(wparams(p, "out_proj"), hs.to(x.dtype), mode)
    return y, {"conv": new_conv, "h": h_last}
