"""Attention: GQA/MQA/MHA, causal + sliding-window/local + cross,
chunked online-softmax for long sequences, ring-buffer KV caches for
bounded-window decode, and binarized projections.

The port of ``repro.models.attention``.  Cache layout: {"k","v": [B, W,
Hkv, D], "pos": [B, W] int32} where W is the cache capacity (full seq
for dense attention, the window for SWA/local).  pos < 0 marks empty
slots; ring indexing is pos % W.  With ``kv_cache_dtype="int8"`` the
payload is int8 with per (token, head) float32 scales.

The online-softmax chunking runs as a Python loop over
``attn_q_chunk`` x ``attn_kv_chunk`` tiles (the reference's
``lax.scan``; ``op_cost.scan``, which a dry-run's counter may scale
from one trip); with grad enabled each q chunk is recomputed in the
backward pass, as the reference's ``jax.checkpoint``.  Scores
and the value sums are float32, as the reference's
``preferred_element_type``.  Caches are updated functionally (the
input cache is not written), as the reference's ``.at[].set``.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (apply_rope, dense, dense_init,
                                       dtype_of, wparams)
from repro_torch.runtime import op_cost
from repro_torch.runtime.sharding import shard_act

NEG_INF = -1e30
_Q_CHUNK = threading.local()


def in_q_chunk() -> bool:
    """True while a q chunk's recomputed body runs.  The reference's
    nested ``jax.checkpoint`` hides its products from an outer remat
    policy, so ``remat="dots"`` must not keep them either."""
    return getattr(_Q_CHUNK, "depth", 0) > 0


def attn_init(gen, cfg, device, cross: bool = False) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.head_dim_()
    dt = dtype_of(cfg)
    p = {
        "wq": dense_init(gen, d, cfg.num_heads * hd, dt, device)["w"],
        "wk": dense_init(gen, d, cfg.num_kv_heads * hd, dt, device)["w"],
        "wv": dense_init(gen, d, cfg.num_kv_heads * hd, dt, device)["w"],
        "wo": dense_init(gen, cfg.num_heads * hd, d, dt, device)["w"],
    }

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)
    if cfg.qkv_bias:
        p["bq"] = zeros(cfg.num_heads * hd)
        p["bk"] = zeros(cfg.num_kv_heads * hd)
        p["bv"] = zeros(cfg.num_kv_heads * hd)
    if cfg.attn_bias:
        p["bo"] = zeros(d)
    return p


def make_cache(cfg, batch: int, capacity: int, device,
               dtype=None) -> Dict[str, torch.Tensor]:
    hkv, hd = max(cfg.num_kv_heads, 1), cfg.head_dim_()
    pos = torch.full((batch, capacity), -1, dtype=torch.int32, device=device)
    shape = (batch, capacity, hkv, hd)
    if cfg.kv_cache_dtype == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros((batch, capacity, hkv),
                                   dtype=torch.float32, device=device),
            "v_scale": torch.zeros((batch, capacity, hkv),
                                   dtype=torch.float32, device=device),
            "pos": pos,
        }
    dt = dtype or dtype_of(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": pos}


def _kv_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., H, D] -> (int8, scale[..., H]) with per-head max-abs."""
    xf = x.to(torch.float32)
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _kv_dequant(q: torch.Tensor, scale: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def _pick_chunk(s: int, target: int) -> int:
    for c in range(min(target, s), 0, -1):
        if s % c == 0:
            return c
    return s


def _proj_qkv(p, x, cfg, mode):
    hd = cfg.head_dim_()
    q = dense(wparams(p, "wq", "bq"), x, mode)
    k = dense(wparams(p, "wk", "bk"), x, mode)
    v = dense(wparams(p, "wv", "bv"), x, mode)
    B, S = x.shape[:2]
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    return q, k, v


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B,S,Hq,D] -> [B,S,Hkv,G,D]"""
    B, S, Hq, D = q.shape
    return q.reshape(B, S, n_kv, Hq // n_kv, D)


def _q_chunk(qi, qpos, k, v, kv_positions, causal: bool, window: int,
             kc: int) -> torch.Tensor:
    """One q chunk of ``chunked_attention``: the online softmax over the
    kv chunks, float32 scores and sums.  qi: [B,qc,Hkv,G,D] float32."""
    B, qc, Hkv, G, D = qi.shape
    scale = 1.0 / math.sqrt(D)
    f32 = torch.float32
    _Q_CHUNK.depth = getattr(_Q_CHUNK, "depth", 0) + 1
    try:
        m = torch.full((B, qc, Hkv, G), -math.inf, dtype=f32,
                       device=qi.device)
        lse = torch.zeros((B, qc, Hkv, G), dtype=f32, device=qi.device)
        acc = torch.zeros((B, qc, Hkv, G, D), dtype=f32, device=qi.device)

        def tile(carry, j):
            m, lse, acc = carry
            kj, vj = k[:, j:j + kc], v[:, j:j + kc]
            kpos = kv_positions[j:j + kc]
            s = torch.einsum("bqhgd,bkhd->bqhgk", qi, kj.to(f32)) * scale
            mask = (kpos >= 0)[None, :].expand(qc, kc)
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window > 0:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lse = lse * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p.to(vj.dtype).to(f32), vj.to(f32))
            return (m_new, lse, acc), None
        (m, lse, acc), _ = op_cost.scan(tile, (m, lse, acc),
                                        range(0, k.shape[1], kc))
        return acc / torch.clamp(lse, min=1e-30)[..., None]
    finally:
        _Q_CHUNK.depth -= 1


def chunked_attention(q, k, v, *, q_positions, kv_positions, causal: bool,
                      window: int, q_chunk: int = 512,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over chunks (memory-bounded prefill).

    q: [B,Sq,Hkv,G,D]; k,v: [B,Skv,Hkv,D]; positions: [Sq]/[Skv] int32.
    window <= 0 means unlimited.  With grad enabled each q chunk is
    recomputed in the backward pass (the reference's
    ``jax.checkpoint``): nothing quadratic survives to it.
    """
    Sq = q.shape[1]
    qc = _pick_chunk(Sq, q_chunk)
    kc = _pick_chunk(k.shape[1], kv_chunk)

    def q_tile(_, i):
        args = (q[:, i:i + qc].to(torch.float32), q_positions[i:i + qc], k,
                v, kv_positions, causal, window, kc)
        out = checkpoint(_q_chunk, *args, use_reentrant=False) \
            if torch.is_grad_enabled() else _q_chunk(*args)
        return None, out.to(q.dtype)
    _, outs = op_cost.scan(q_tile, None, range(0, Sq, qc))
    return torch.cat(outs, dim=1)


def decode_attention(q, cache, step) -> torch.Tensor:
    """Single-token attention over the cache.

    q: [B,1,Hkv,G,D]; returns [B,1,Hkv,G,D].  Works for full caches and
    ring buffers alike — slot validity comes from cache["pos"].
    """
    k, v, pos = cache["k"], cache["v"], cache["pos"]
    if k.dtype == torch.int8:
        k = _kv_dequant(k, cache["k_scale"], q.dtype)
        v = _kv_dequant(v, cache["v_scale"], q.dtype)
    f32 = torch.float32
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhgd,bkhd->bqhgk", q.to(f32), k.to(f32)) * scale
    valid = (pos >= 0) & (pos <= step[:, None])
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p.to(v.dtype).to(f32), v.to(f32))
    return out.to(q.dtype)


def cache_insert(cache, k_new, v_new, step):
    """Insert one token's K/V at ring position step % W."""
    W = cache["k"].shape[1]
    idx = (step % W).long()                              # [B]
    b = torch.arange(k_new.shape[0], device=k_new.device)
    cache = dict(cache)

    def put(name, val):
        t = cache[name].clone()
        t[b, idx] = val.to(t.dtype)
        cache[name] = t
    if cache["k"].dtype == torch.int8:
        kq, ks = _kv_quant(k_new[:, 0])
        vq, vs = _kv_quant(v_new[:, 0])
        put("k", kq)
        put("v", vq)
        put("k_scale", ks)
        put("v_scale", vs)
    else:
        put("k", k_new[:, 0])
        put("v", v_new[:, 0])
    put("pos", step)
    return cache


def fill_cache_from_prefill(cfg, k, v, positions, capacity: int):
    """Build a decode cache from prefill K/V (keep the last `capacity`).

    Ring invariant: the entry for position p sits at slot p % capacity."""
    B, S = k.shape[:2]
    cache = make_cache(cfg, B, capacity, k.device, k.dtype)
    quant = cache["k"].dtype == torch.int8
    if quant:
        k, ks = _kv_quant(k)
        v, vs = _kv_quant(v)
    if S >= capacity:
        pos_keep = positions[-capacity:].to(torch.int32)
        slots = (pos_keep % capacity).long()
        cache["k"][:, slots] = k[:, -capacity:].to(cache["k"].dtype)
        cache["v"][:, slots] = v[:, -capacity:].to(cache["v"].dtype)
        if quant:
            cache["k_scale"][:, slots] = ks[:, -capacity:]
            cache["v_scale"][:, slots] = vs[:, -capacity:]
        cache["pos"][:, slots] = pos_keep
    else:
        # positions 0..S-1 map to slots 0..S-1; the rest stays empty
        cache["k"][:, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :S] = v.to(cache["v"].dtype)
        if quant:
            cache["k_scale"][:, :S] = ks
            cache["v_scale"][:, :S] = vs
        cache["pos"][:, :S] = positions.to(torch.int32)
    return cache


def attn_apply(p, x, cfg, *, kind: str = "causal",
               positions: Optional[torch.Tensor] = None,
               cache: Optional[Dict] = None,
               step: Optional[torch.Tensor] = None,
               kv_ext: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               window: int = 0,
               build_cache_capacity: int = 0):
    """Unified attention entry point.

    kind: "causal" (self), "local" (bounded window self), "full"
    (bidirectional), "cross" (keys/values from kv_ext, e.g. encoder
    output or image tokens).  Returns (y, new_cache_or_None).
    """
    mode = cfg.binarize if cfg.binarize_attn_proj else "none"
    B, S = x.shape[:2]
    hd = cfg.head_dim_()
    decode = cache is not None and S == 1
    new_cache = None

    def arange(n):
        return torch.arange(n, dtype=torch.int32, device=x.device)

    if kind == "cross":
        q = dense(wparams(p, "wq", "bq"), x, mode).reshape(
            B, S, cfg.num_heads, hd)
        if kv_ext is not None:
            ctx_k, ctx_v = kv_ext
            k = dense(wparams(p, "wk", "bk"), ctx_k, mode).reshape(
                B, -1, cfg.num_kv_heads, hd)
            v = dense(wparams(p, "wv", "bv"), ctx_v, mode).reshape(
                B, -1, cfg.num_kv_heads, hd)
        else:  # decode: static cross cache
            k, v = cache["k"], cache["v"]
        qg = _group(q, cfg.num_kv_heads)
        kvp = arange(k.shape[1])
        qp = positions if positions is not None else arange(S)
        out = chunked_attention(qg, k, v, q_positions=qp, kv_positions=kvp,
                                causal=False, window=0)
        if kv_ext is not None and cache is None and build_cache_capacity:
            new_cache = {"k": k, "v": v,
                         "pos": kvp[None].expand(B, k.shape[1]).clone()}
    else:
        q, k, v = _proj_qkv(p, x, cfg, mode)
        if decode:
            qp = step
        else:
            qp = positions if positions is not None else arange(S)
        if cfg.use_rope:
            if decode:
                q = apply_rope(q, step[:, None], cfg.rope_theta)
                k = apply_rope(k, step[:, None], cfg.rope_theta)
            else:
                q = apply_rope(q, qp, cfg.rope_theta)
                k = apply_rope(k, qp, cfg.rope_theta)
        qg = _group(q, cfg.num_kv_heads)
        qg = shard_act(qg, (("pod", "data"), None, "model", None, None))
        if decode:
            cache = cache_insert(cache, k, v, step)
            out = decode_attention(qg, cache, step)
            new_cache = cache
        else:
            out = chunked_attention(qg, k, v, q_positions=qp,
                                    kv_positions=qp,
                                    causal=(kind != "full"),
                                    window=window,
                                    q_chunk=cfg.attn_q_chunk,
                                    kv_chunk=cfg.attn_kv_chunk)
            if build_cache_capacity:
                new_cache = fill_cache_from_prefill(
                    cfg, k, v, qp, build_cache_capacity)

    out = out.reshape(B, S, cfg.num_heads * hd)
    y = dense(wparams(p, "wo", "bo"), out, mode)
    return y, new_cache
