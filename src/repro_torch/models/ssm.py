"""Mamba-1 selective-SSM block (falcon-mamba-7b).

The port of ``repro.models.ssm``.  Train/prefill runs the recurrence
h_t = a_t * h_{t-1} + bx_t as a chunked scan: a sequential loop over
time-chunks (the reference's ``lax.scan``; here ``op_cost.scan``) whose
inner step is a parallel prefix scan over the chunk
(``associative_scan``), so the materialized state tensor is [B, chunk,
d_inner, d_state].  Decode is
the O(1) single-step recurrence.  The selective scan stays in float32;
the in/out projections are binarized.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense, dtype_of, normal, uniform,
                                       wparams)
from repro_torch.runtime import op_cost
from repro_torch.runtime.sharding import shard_act


def ssm_init(gen, cfg, device) -> Dict[str, Any]:
    d = cfg.d_model
    din = cfg.ssm_expand * d
    dtr = cfg.dt_rank_()
    n = cfg.ssm_state
    dt = dtype_of(cfg)
    f32 = torch.float32
    s = 1.0 / math.sqrt(d)
    A = torch.arange(1, n + 1, dtype=f32, device=device)[None, :] \
        .repeat(din, 1)
    in_proj = normal(gen, (d, 2 * din), dt, device) * s
    conv_w = normal(gen, (din, cfg.conv1d_width), dt, device) * 0.1
    x_proj = normal(gen, (din, dtr + 2 * n), dt, device) \
        * (1.0 / math.sqrt(din))
    dt_proj = normal(gen, (dtr, din), dt, device) * (1.0 / math.sqrt(dtr))
    u = uniform(gen, (din,), 0.0, 1.0, device)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(0.001))
                    + math.log(0.001))
    out_proj = normal(gen, (din, d), dt, device) * (1.0 / math.sqrt(din))
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((din,), dtype=dt, device=device),
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "dt_bias": torch.log(torch.exp(dt0) - 1.0 + 1e-6).to(f32),
        "A_log": torch.log(A),
        "D": torch.ones((din,), dtype=f32, device=device),
        "out_proj": out_proj,
    }


def _conv_train(x, w, b):
    """Causal depthwise conv for full sequences: pad left K-1."""
    K = w.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = sum(xp[:, i:i + x.shape[1], :] * w[:, i] for i in range(K))
    return y + b


def _pad_left(x, n):
    """Zero-pad [B, S, C] on the left of S by n."""
    return F.pad(x, (0, 0, n, 0))


def associative_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive prefix scan of the linear-recurrence operator
    (l, r) -> (l.a * r.a, r.a * l.b + r.b) along ``dim`` — the
    reference's ``jax.lax.associative_scan(comb, (a, b))`` — in
    log2(n) doubling steps.  Returns (cumulative a, cumulative b)."""
    n = a.shape[dim]
    off = 1
    while off < n:
        a_l = a.narrow(dim, 0, n - off)
        b_l = b.narrow(dim, 0, n - off)
        a_r = a.narrow(dim, off, n - off)
        b_r = b.narrow(dim, off, n - off)
        a = torch.cat([a.narrow(dim, 0, off), a_l * a_r], dim=dim)
        b = torch.cat([b.narrow(dim, 0, off), a_r * b_l + b_r], dim=dim)
        off *= 2
    return a, b


def _scan_chunked(a, bx, h0, chunk: int):
    """h_t = a_t * h_{t-1} + bx_t over axis 1, chunked associative scan.

    a, bx: [B, S, C, N]; h0: [B, C, N]."""
    B, S, C, N = a.shape
    c = chunk
    while S % c:
        c -= 1

    def body(h, i):
        aa, bb = associative_scan(a[:, i:i + c], bx[:, i:i + c], dim=1)
        h_seq = aa * h[:, None] + bb              # [B,c,C,N]
        return h_seq[:, -1], h_seq
    h, hs = op_cost.scan(body, h0, range(0, S, c))
    return h, torch.cat(hs, dim=1)


def ssm_apply(p, x, cfg, state: Optional[Dict] = None,
              scan_chunk: int = 16):
    """x: [B,S,D].  state (decode): {"conv": [B,K-1,din], "h": [B,din,N]}.
    Returns (y, new_state)."""
    mode = cfg.binarize if cfg.binarize_ffn else "none"
    B, S, _ = x.shape
    din = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    dtr = cfg.dt_rank_()
    K = cfg.conv1d_width

    xz = dense(wparams(p, "in_proj"), x, mode)
    xs, z = torch.chunk(xz, 2, dim=-1)            # [B,S,din]
    xs = shard_act(xs, (("pod", "data"), None, "model"))

    decode = state is not None and S == 1
    if decode:
        conv_in = torch.cat([state["conv"], xs], dim=1)
        y = sum(conv_in[:, i:i + 1, :] * p["conv_w"][:, i]
                for i in range(K)) + p["conv_b"]
        new_conv = conv_in[:, 1:]
    else:
        y = _conv_train(xs, p["conv_w"], p["conv_b"])
        new_conv = xs[:, -(K - 1):] if S >= K else _pad_left(xs, K - 1 - S)
    u = F.silu(y)                                 # [B,S,din]

    proj = dense({"w": p["x_proj"]}, u, "none")   # dt/B/C path stays fp
    dt_r, Bc, Cc = torch.split(proj, [dtr, n, n], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"] + p["dt_bias"]).to(torch.float32)
    A = -torch.exp(p["A_log"])                    # [din, N]
    uf = u.to(torch.float32)
    Bf = Bc.to(torch.float32)
    Cf = Cc.to(torch.float32)
    da = torch.exp(dt[..., None] * A)             # [B,S,din,N]
    dbx = dt[..., None] * Bf[:, :, None, :] * uf[..., None]

    if decode:
        h = da[:, 0] * state["h"] + dbx[:, 0]     # [B,din,N]
        ysc = torch.einsum("bcn,bn->bc", h, Cf[:, 0])[:, None, :]
        h_last = h
    else:
        h0 = torch.zeros((B, din, n), dtype=torch.float32, device=x.device)
        h_last, hs = _scan_chunked(da, dbx, h0, scan_chunk)
        ysc = torch.einsum("bscn,bsn->bsc", hs, Cf)
    out = (ysc + uf * p["D"]).to(x.dtype) * F.silu(z)
    y = dense(wparams(p, "out_proj"), out, mode)
    return y, {"conv": new_conv, "h": h_last}
