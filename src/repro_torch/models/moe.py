"""Mixture-of-Experts FFN (phi-3.5-MoE 16e/top-2, mixtral 8e/top-2).

The port of ``repro.models.moe``, with its three dispatch
implementations:

  * "dense"    — every expert runs on every token, combined with top-k
    routing weights (the shape-static reference);
  * "capacity" — GShard-style capacity-C one-hot dispatch einsums;
  * "gather"   — scatter/gather dispatch into [E, C] buffers; a token
    past its expert's capacity is written to an extra slot C that is
    sliced off (the reference's ``.at[].set(mode="drop")``) and its
    output is zeroed.

Expert weights are [E, d_model, d_ff].  Tensor-parallel on d_ff where
a rank holds blocks of them: w_gate / w_up column-parallel, w_down
row-parallel, the router replicated; the experts' input and the routing
weights pass through ``copy_to_model`` and the combined output is summed
over "model".

The Switch aux loss is ``E * sum_e mean(probs)_e * mean(onehot)_e``
over the whole batch.  Inside an SPMD step each rank holds a share of
the rows, so the two means are ``sharding.batch_mean``: global over the
step's batch group (the reference's pjit takes them over the global
batch), and the plain means in one process.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.binarize import ste_sign
from repro_torch.kernels.packed import PackedArray
from repro_torch.models.layers import act_fn, dtype_of, normal, own_cols
from repro_torch.runtime.sharding import (batch_mean, copy_to_model,
                                          reduce_from_model, shard_act,
                                          tp_rank, tp_size)


def moe_init(gen, cfg, device) -> Dict[str, Any]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = dtype_of(cfg)
    s = 1.0 / math.sqrt(d)
    return {
        "router": normal(gen, (d, e), torch.float32, device) * s,
        "w_gate": normal(gen, (e, d, f), dt, device) * s,
        "w_up": normal(gen, (e, d, f), dt, device) * s,
        "w_down": normal(gen, (e, f, d), dt, device)
        * (1.0 / math.sqrt(f)),
    }


def _get_w(p, name, mode, dtype, rows: int = 0):
    """Dense latent weights (train) or packed serving layout; ``rows``
    (w_down under tensor parallelism) is the rank's block of d_ff: a
    latent block's scale is the mean over the whole d_ff, packed words
    held whole give the block's rows."""
    if name + "_p" in p:
        wp = p[name + "_p"]
        if not isinstance(wp, PackedArray):
            raise TypeError("packed weights must be a PackedArray "
                            "(adopt_packed converts raw words)")
        w = wp.unpack(dtype)                  # [E, K, F], pack axis -2
        if rows and w.shape[-2] != rows:
            w = w.narrow(-2, tp_rank() * rows, rows)
        return w * own_cols(p[name + "_alpha"].to(dtype), w.shape[-1])
    return _maybe_bin(p[name], mode,
                      row_parallel=bool(rows) and tp_size() > 1)


def _maybe_bin(w, mode, row_parallel: bool = False):
    if mode == "none":
        return w
    wa = torch.abs(w.detach().to(torch.float32))
    if row_parallel:
        alpha = reduce_from_model(torch.sum(wa, dim=-2, keepdim=True)) \
            / (w.shape[-2] * tp_size())
    else:
        alpha = torch.mean(wa, dim=-2, keepdim=True)
    return ste_sign(w) * alpha.to(w.dtype)


def one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``F.one_hot(idx, n).to(dtype)`` as a compare with an iota (the
    reference's ``jax.nn.one_hot``): the same values, and no host read
    (``F.one_hot`` checks its range with ``.item()`` on the CPU, and
    dispatches other ops on each device)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def router_probs(p, x, cfg):
    """Returns (top-k weights [B,S,k], indices [B,S,k], aux loss)."""
    logits = x.to(torch.float32) @ p["router"]             # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    # load-balancing aux loss (Switch):  E * sum_e f_e * p_e
    e = cfg.num_experts
    me = batch_mean(probs, (0, 1))
    fe = batch_mean(one_hot(idx, e, torch.float32).sum(dim=2), (0, 1))
    aux = e * torch.sum(me * fe)
    return w.to(x.dtype), idx, aux


def moe_apply(p, x, cfg, impl: str = "dense"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    mode = cfg.binarize if cfg.binarize_ffn else "none"
    w, idx, aux = router_probs(p, x, cfg)
    f = act_fn(cfg.act)
    wg = _get_w(p, "w_gate", mode, x.dtype)
    wu = _get_w(p, "w_up", mode, x.dtype)
    split = wg.shape[-1] < cfg.d_ff
    wd = _get_w(p, "w_down", mode, x.dtype,
                rows=wg.shape[-1] if split else 0)
    E = cfg.num_experts
    if split:
        x, w = copy_to_model(x), copy_to_model(w)

    if impl == "dense":
        g = torch.einsum("bsd,edf->besf", x, wg)
        u = torch.einsum("bsd,edf->besf", x, wu)
        h = f(g) * u
        h = shard_act(h, (("pod", "data"), None, None, "model"))
        y_e = torch.einsum("besf,efd->besd", h, wd)        # [B,E,S,D]
        comb = torch.sum(one_hot(idx, E, x.dtype) * w[..., None],
                         dim=2)
        y = torch.einsum("besd,bse->bsd", y_e, comb)
        return (reduce_from_model(y) if split else y), aux

    # capacity-based dispatch: tokens -> [E, C] buffers.
    B, S, D = x.shape
    k = cfg.top_k
    cap = int(2.0 * S * k / E) or 1
    # position of each (token, k) within its expert's buffer
    onehot = one_hot(idx, E, torch.int32)                  # [B,S,k,E]
    flat = onehot.reshape(B, S * k, E)
    pos_in_e = torch.cumsum(flat, dim=1) - 1               # [B,S*k,E]
    pos = torch.sum(flat * pos_in_e, dim=-1).reshape(B, S, k)

    if impl == "capacity":
        keep = pos < cap
        disp = (one_hot(idx, E, x.dtype)[..., None]
                * one_hot(torch.clamp(pos, max=cap - 1), cap, x.dtype)
                [..., None, :]
                * keep[..., None, None].to(x.dtype))       # [B,S,k,E,C]
        xe = torch.einsum("bsd,bskec->becd", x, disp)      # [B,E,C,D]
        h = f(torch.einsum("becd,edf->becf", xe, wg)) \
            * torch.einsum("becd,edf->becf", xe, wu)
        h = shard_act(h, (("pod", "data"), None, None, "model"))
        ye = torch.einsum("becf,efd->becd", h, wd)
        y = torch.einsum("becd,bskec,bsk->bsd", ye, disp, w.to(x.dtype))
        return (reduce_from_model(y) if split else y), aux

    # impl == "gather": scatter/gather dispatch
    bb = torch.arange(B, device=x.device)[:, None, None]
    tok = torch.arange(S, device=x.device)[None, :, None].expand(B, S, k)
    slot = torch.where(pos < cap, pos, cap).long()         # cap slot drops
    buf_tok = torch.zeros((B, E, cap + 1), dtype=torch.int64,
                          device=x.device)
    buf_tok[bb, idx, slot] = tok
    buf_tok = buf_tok[:, :, :cap]                          # [B,E,C]
    xe = torch.gather(x[:, None].expand(B, E, S, D), 2,
                      buf_tok[..., None].expand(B, E, cap, D))  # [B,E,C,D]
    h = f(torch.einsum("becd,edf->becf", xe, wg)) \
        * torch.einsum("becd,edf->becf", xe, wu)
    h = shard_act(h, (("pod", "data"), None, None, "model"))
    ye = torch.einsum("becf,efd->becd", h, wd)             # [B,E,C,D]
    # combine: each token's k expert outputs back from the buffers
    ye_flat = ye.reshape(B, E * cap, D)
    gidx = idx * cap + torch.clamp(slot, max=cap - 1)      # [B,S,k]
    picked = torch.gather(
        ye_flat, 1, gidx.reshape(B, S * k)[..., None].expand(B, S * k, D)
    ).reshape(B, S, k, D)
    picked = picked * (pos < cap)[..., None].to(x.dtype)
    y = torch.einsum("bskd,bsk->bsd", picked, w.to(x.dtype))
    return (reduce_from_model(y) if split else y), aux
