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

Tensor-parallel where a rank holds head blocks of the projections
(``sharding.heads_split``): its q heads, its kv heads where they divide
"model", else the one kv head its q heads read, taken from the whole kv
projections; wo row-parallel.  A decode cache is the rank's
``batch_specs`` block: its kv heads, or its block of slots (split-KV),
whose partial softmaxes are combined over "model".
"""
from __future__ import annotations

import math
import threading
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import (apply_rope, dense, dense_init,
                                       dtype_of, out_width, wparams)
from repro_torch.runtime import op_cost
from repro_torch.runtime.sharding import (copy_to_model, gather_from_model,
                                          max_over_model, reduce_from_model,
                                          shard_act, tp_rank, tp_size)

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
               dtype=None, heads: Optional[int] = None
               ) -> Dict[str, torch.Tensor]:
    """An empty cache of ``heads`` kv heads (default: the config's)."""
    hkv, hd = heads or max(cfg.num_kv_heads, 1), cfg.head_dim_()
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
    """q, k, v [B,S,H,D]: a rank's block of heads where it holds blocks
    of the projections (their input through ``copy_to_model``), all
    heads where it holds them whole."""
    hd = cfg.head_dim_()
    q_split = out_width(p, "wq") < cfg.num_heads * hd
    kv_split = out_width(p, "wk") < cfg.num_kv_heads * hd
    xq = copy_to_model(x) if q_split else x
    q = dense(wparams(p, "wq", "bq"), xq, mode)
    xkv = xq if kv_split else x
    k = dense(wparams(p, "wk", "bk"), xkv, mode)
    v = dense(wparams(p, "wv", "bv"), xkv, mode)
    B, S = x.shape[:2]
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    return q, k, v


def _kv_head(cfg, q_heads: int) -> int:
    """The kv head this rank's ``q_heads`` q heads read, where the q
    heads are a "model" block and the kv heads whole
    (``sharding.heads_split``: one kv head serves the block)."""
    return tp_rank() * q_heads // (cfg.num_heads // cfg.num_kv_heads)


def _read_kv(cfg, q_heads: int, t: torch.Tensor) -> torch.Tensor:
    """Whole-head ``t`` [B,S,Hkv,D] as the kv heads this rank's q heads
    read: the gradient of the whole ``t`` is summed over "model"
    (each rank gives back its heads' part)."""
    if q_heads == cfg.num_heads or t.shape[2] < cfg.num_kv_heads:
        return t
    return copy_to_model(t).narrow(2, _kv_head(cfg, q_heads), 1)


def _seq_block(cache: Dict[str, torch.Tensor]) -> Optional[int]:
    """The first slot of this rank's block of a cache whose sequence is
    split over "model" (split-KV: its k holds fewer slots than its pos),
    else None."""
    wl, w = cache["k"].shape[1], cache["pos"].shape[1]
    return None if wl == w else tp_rank() * wl


def cut_cache(cache: Dict[str, torch.Tensor], kv_split: bool
              ) -> Dict[str, torch.Tensor]:
    """A whole-sequence cache as ``batch_specs`` splits it over "model":
    where the kv heads are not split, k and v (and nothing else) cut to
    this rank's block of slots when the capacity divides (split-KV)."""
    m = tp_size()
    w = cache["k"].shape[1]
    if m == 1 or kv_split or w % m:
        return cache
    out = dict(cache)
    for name in ("k", "v"):
        out[name] = cache[name].narrow(1, tp_rank() * (w // m),
                                       w // m).clone()
    return out


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
    ring buffers alike — slot validity comes from cache["pos"].  A
    split-KV cache (this rank's block of slots, ``_seq_block``) gives a
    partial softmax over the block whose max, sum of exp and weighted
    values are combined over "model".
    """
    lo = _seq_block(cache)
    k, v, pos = cache["k"], cache["v"], cache["pos"]
    wl = k.shape[1]
    if lo is not None:
        pos = pos[:, lo:lo + wl]
    if k.dtype == torch.int8:
        ks, vs = cache["k_scale"], cache["v_scale"]
        if lo is not None:
            ks, vs = ks[:, lo:lo + wl], vs[:, lo:lo + wl]
        k = _kv_dequant(k, ks, q.dtype)
        v = _kv_dequant(v, vs, q.dtype)
    f32 = torch.float32
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhgd,bkhd->bqhgk", q.to(f32), k.to(f32)) * scale
    valid = (pos >= 0) & (pos <= step[:, None])
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    if lo is not None:
        m = max_over_model(s.amax(dim=-1))
        p = torch.exp(s - m[..., None])
        den = reduce_from_model(p.sum(dim=-1))
        acc = reduce_from_model(torch.einsum(
            "bqhgk,bkhd->bqhgd", p.to(v.dtype).to(f32), v.to(f32)))
        return (acc / den[..., None]).to(q.dtype)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p.to(v.dtype).to(f32), v.to(f32))
    return out.to(q.dtype)


def cache_insert(cache, k_new, v_new, step):
    """Insert one token's K/V at ring position step % W.  A cache split
    over "model" by heads takes the rank's heads (the int8 scales,
    held whole, take every rank's, gathered); one split by slots
    (split-KV) is written by the rank whose block holds the slot (pos
    and the scales, held whole, by every rank)."""
    W = cache["pos"].shape[1]
    idx = (step % W).long()                              # [B]
    b = torch.arange(k_new.shape[0], device=k_new.device)
    lo = _seq_block(cache)
    cache = dict(cache)

    def put(name, val, slot=idx, keep=None):
        t = cache[name].clone()
        val = val.to(t.dtype)
        if keep is not None:
            val = torch.where(keep.view(-1, *[1] * (val.ndim - 1)), val,
                              t[b, slot])
        t[b, slot] = val
        cache[name] = t
    mine = None
    slot = idx
    if lo is not None:
        wl = cache["k"].shape[1]
        mine = (idx >= lo) & (idx < lo + wl)
        slot = (idx - lo).clamp(0, wl - 1)
    if cache["k"].dtype == torch.int8:
        kq, ks = _kv_quant(k_new[:, 0])
        vq, vs = _kv_quant(v_new[:, 0])
        put("k", kq, slot, mine)
        put("v", vq, slot, mine)
        put("k_scale", gather_from_model(ks, -1)
            if ks.shape[-1] < cache["k_scale"].shape[-1] else ks)
        put("v_scale", gather_from_model(vs, -1)
            if vs.shape[-1] < cache["v_scale"].shape[-1] else vs)
    else:
        put("k", k_new[:, 0], slot, mine)
        put("v", v_new[:, 0], slot, mine)
    put("pos", step)
    return cache


def fill_cache_from_prefill(cfg, k, v, positions, capacity: int):
    """Build a decode cache from prefill K/V (keep the last `capacity`).

    Ring invariant: the entry for position p sits at slot p % capacity."""
    B, S = k.shape[:2]
    cache = make_cache(cfg, B, capacity, k.device, k.dtype,
                       heads=k.shape[2])
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
    if quant and k.shape[2] < cfg.num_kv_heads:
        # a rank's heads: the scales are held whole over "model"
        for name in ("k_scale", "v_scale"):
            cache[name] = gather_from_model(cache[name], -1)
    return cut_cache(cache, k.shape[2] < cfg.num_kv_heads)


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
        q_split = out_width(p, "wq") < cfg.num_heads * hd
        kv_split = out_width(p, "wk") < cfg.num_kv_heads * hd
        q = dense(wparams(p, "wq", "bq"), copy_to_model(x) if q_split
                  else x, mode).reshape(B, S, -1, hd)
        if kv_ext is not None:
            ctx_k, ctx_v = kv_ext
            if kv_split:
                same = ctx_v is ctx_k
                ctx_k = copy_to_model(ctx_k)
                ctx_v = ctx_k if same else copy_to_model(ctx_v)
            k = dense(wparams(p, "wk", "bk"), ctx_k, mode).reshape(
                B, -1, out_width(p, "wk") // hd, hd)
            v = dense(wparams(p, "wv", "bv"), ctx_v, mode).reshape(
                B, -1, out_width(p, "wv") // hd, hd)
        else:  # decode: static cross cache
            k, v = cache["k"], cache["v"]
            if _seq_block(cache) is not None:
                # a split-KV cross cache is read whole
                k, v = gather_from_model(k, 1), gather_from_model(v, 1)
        kr, vr = _read_kv(cfg, q.shape[2], k), _read_kv(cfg, q.shape[2], v)
        qg = _group(q, kr.shape[2])
        kvp = arange(k.shape[1])
        qp = positions if positions is not None else arange(S)
        out = chunked_attention(qg, kr, vr, q_positions=qp,
                                kv_positions=kvp, causal=False, window=0)
        if kv_ext is not None and cache is None and build_cache_capacity:
            new_cache = cut_cache(
                {"k": k, "v": v,
                 "pos": kvp[None].expand(B, k.shape[1]).clone()}, kv_split)
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
        if decode:
            cache = cache_insert(cache, k, v, step)
            new_cache = cache
            out = _decode_heads(cfg, q, cache, step)
        else:
            kr, vr = _read_kv(cfg, q.shape[2], k), _read_kv(cfg, q.shape[2],
                                                           v)
            qg = _group(q, kr.shape[2])
            qg = shard_act(qg, (("pod", "data"), None, "model", None, None))
            out = chunked_attention(qg, kr, vr, q_positions=qp,
                                    kv_positions=qp,
                                    causal=(kind != "full"),
                                    window=window,
                                    q_chunk=cfg.attn_q_chunk,
                                    kv_chunk=cfg.attn_kv_chunk)
            if build_cache_capacity:
                new_cache = fill_cache_from_prefill(
                    cfg, k, v, qp, build_cache_capacity)

    out = out.reshape(B, S, -1)
    y = dense(wparams(p, "wo", "bo"), out, mode,
              row_parallel=out.shape[-1] < cfg.num_heads * hd)
    return y, new_cache


def _decode_heads(cfg, q, cache, step) -> torch.Tensor:
    """Decode attention of the rank's q heads [B,1,Hq',D] over ``cache``
    (after the insert): on a split-KV cache every q head (gathered over
    "model") over the rank's slots, combined over "model", then the
    rank's heads; else the rank's heads over the kv heads they read."""
    hq = q.shape[2]
    if _seq_block(cache) is not None:
        qa = gather_from_model(q, 2) if hq < cfg.num_heads else q
        out = decode_attention(_group(qa, cache["k"].shape[2]), cache, step)
        out = out.reshape(*q.shape[:2], cfg.num_heads, q.shape[-1])
        return out.narrow(2, tp_rank() * hq, hq) if hq < cfg.num_heads \
            else out
    view = dict(cache)
    hkv = cache["k"].shape[2]
    if hkv < cfg.num_kv_heads:
        # the rank's kv heads: the int8 scales, held whole, cut to them
        for name in ("k_scale", "v_scale"):
            if name in view:
                view[name] = view[name].narrow(2, tp_rank() * hkv, hkv)
    elif hq < cfg.num_heads:
        for name in ("k", "v", "k_scale", "v_scale"):
            if name in view:
                view[name] = view[name].narrow(2, _kv_head(cfg, hq), 1)
    qg = _group(q, view["k"].shape[2])
    qg = shard_act(qg, (("pod", "data"), None, "model", None, None))
    return decode_attention(qg, view, step)
