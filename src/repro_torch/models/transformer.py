"""Layer blocks + grouped stack assembly over pattern cycles.

The port of ``repro.models.transformer``.  Layers are grouped into
repeating pattern cycles (e.g. recurrentgemma's (rglru, rglru,
local_attn), llama-vision's 4x self + 1 cross) with weight-stacked
parameters: every leaf of ``params["layers"][pos]`` carries a leading
[n_cycles] axis (a packed leaf's words too, its pack axis negative so
the slice keeps it valid).  The reference runs the cycles under one
``jax.lax.scan``; here a Python loop runs the cycles, each stacked leaf
unbound once per call (so a backward pass stacks each leaf's gradient
once, not one full-size zero tensor a cycle), and stacks the new
caches back.  Cycle remainders run unstacked.

``remat`` (with grad enabled only; serving runs without autograd) is
the reference's ``jax.checkpoint`` of a cycle: "full" recomputes the
whole cycle in the backward pass, "dots" keeps the matmul outputs and
recomputes the rest (``jax.checkpoint_policies.checkpoint_dots``; an
attention q chunk, checkpointed on its own, keeps none),
"none" keeps every activation.

Block kinds:
  attn          causal self-attention + MLP (or MoE)
  full_attn     bidirectional self-attention + MLP (encoder)
  local_attn    windowed causal self-attention + MLP
  rglru         RG-LRU recurrence + MLP
  mamba         mamba-1 block (no separate MLP)
  cross_attn    cross-attention to ctx + MLP (llama-vision image layers)
  encdec        causal self + cross + MLP (whisper decoder)
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels.packed import PackedArray
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_norm, dtype_of, mlp_apply,
                                       mlp_init, norm_init)
from repro_torch.runtime.sharding import shard_act


# ------------------------------------------------------------------ #
# block init                                                           #
# ------------------------------------------------------------------ #
def block_init(gen, cfg, kind: str, device) -> Dict[str, Any]:
    dt = dtype_of(cfg)
    d = cfg.d_model
    p: Dict[str, Any] = {"norm1": norm_init(d, cfg.norm, dt, device)}
    if kind == "mamba":
        p["ssm"] = ssm_mod.ssm_init(gen, cfg, device)
        return p
    if kind == "rglru":
        p["lru"] = rglru_mod.rglru_init(gen, cfg, device)
    elif kind == "cross_attn":
        p["attn"] = attn.attn_init(gen, cfg, device, cross=True)
    else:
        p["attn"] = attn.attn_init(gen, cfg, device)
        if kind == "encdec":
            p["norm_x"] = norm_init(d, cfg.norm, dt, device)
            p["xattn"] = attn.attn_init(gen, cfg, device, cross=True)
    p["norm2"] = norm_init(d, cfg.norm, dt, device)
    if cfg.num_experts and kind in ("attn", "full_attn", "local_attn"):
        p["moe"] = moe_mod.moe_init(gen, cfg, device)
    else:
        p["mlp"] = mlp_init(gen, cfg, device)
    return p


def _ctx_cache(cfg, batch, ctx_len, device):
    hkv, hd = cfg.num_kv_heads, cfg.head_dim_()
    dt = dtype_of(cfg)
    return {"k": torch.zeros((batch, ctx_len, hkv, hd), dtype=dt,
                             device=device),
            "v": torch.zeros((batch, ctx_len, hkv, hd), dtype=dt,
                             device=device),
            "pos": torch.zeros((batch, ctx_len), dtype=torch.int32,
                               device=device)}


def init_block_cache(cfg, kind: str, batch: int, capacity: int, device,
                     ctx_len: int = 0) -> Optional[Dict]:
    """Decode-time cache structure for one block."""
    dt = dtype_of(cfg)
    f32 = torch.float32
    if kind == "mamba":
        din = cfg.ssm_expand * cfg.d_model
        return {"conv": torch.zeros((batch, cfg.conv1d_width - 1, din),
                                    dtype=dt, device=device),
                "h": torch.zeros((batch, din, cfg.ssm_state), dtype=f32,
                                 device=device)}
    if kind == "rglru":
        w = cfg.lru_width or cfg.d_model
        return {"conv": torch.zeros((batch, cfg.conv1d_width - 1, w),
                                    dtype=dt, device=device),
                "h": torch.zeros((batch, w), dtype=f32, device=device)}
    if kind == "cross_attn":
        return _ctx_cache(cfg, batch, ctx_len, device)
    cap = capacity
    if kind == "local_attn":
        cap = min(capacity, cfg.local_window or capacity)
    elif cfg.sliding_window:
        cap = min(capacity, cfg.sliding_window)
    c: Dict[str, Any] = {"self": attn.make_cache(cfg, batch, cap, device)}
    if kind == "encdec":
        c["cross"] = _ctx_cache(cfg, batch, ctx_len, device)
    return c


# ------------------------------------------------------------------ #
# block apply                                                          #
# ------------------------------------------------------------------ #
def block_apply(p, x, cfg, kind: str, *,
                positions=None, cache=None, step=None, ctx=None,
                cache_capacity: int = 0):
    """Returns (x, new_cache, aux_loss)."""
    aux = 0.0
    h = apply_norm(p["norm1"], x, cfg.norm)
    new_cache: Any = None

    if kind == "mamba":
        y, st = ssm_mod.ssm_apply(p["ssm"], h, cfg, state=cache)
        return x + y, st, aux
    if kind == "rglru":
        y, st = rglru_mod.rglru_apply(p["lru"], h, cfg, state=cache)
        new_cache = st
        x = x + y
    elif kind == "cross_attn":
        y, xc = attn.attn_apply(
            p["attn"], h, cfg, kind="cross",
            positions=positions, step=step,
            cache=cache, kv_ext=(ctx, ctx) if ctx is not None else None,
            build_cache_capacity=cache_capacity)
        new_cache = xc if xc is not None else cache
        x = x + y
    else:
        window = 0
        akind = "causal"
        if kind == "local_attn":
            window = cfg.local_window
        elif cfg.sliding_window and kind == "attn":
            window = cfg.sliding_window
        if kind == "full_attn":
            akind = "full"
        self_cache = cache["self"] if isinstance(cache, dict) \
            and "self" in cache else cache
        y, sc = attn.attn_apply(
            p["attn"], h, cfg, kind=akind, positions=positions,
            cache=self_cache, step=step, window=window,
            build_cache_capacity=cache_capacity)
        x = x + y
        if kind == "encdec":
            hx = apply_norm(p["norm_x"], x, cfg.norm)
            yx, xc = attn.attn_apply(
                p["xattn"], hx, cfg, kind="cross", positions=positions,
                step=step,
                cache=cache["cross"] if isinstance(cache, dict)
                and "cross" in cache else None,
                kv_ext=(ctx, ctx) if ctx is not None else None,
                build_cache_capacity=cache_capacity)
            x = x + yx
            new_cache = {"self": sc, "cross": xc if xc is not None
                         else (cache or {}).get("cross")}
        else:
            new_cache = {"self": sc} if sc is not None else None

    if "moe" in p:
        h2 = apply_norm(p["norm2"], x, cfg.norm)
        y2, aux = moe_mod.moe_apply(p["moe"], h2, cfg, impl=cfg.moe_impl)
        x = x + y2
    elif "mlp" in p:
        h2 = apply_norm(p["norm2"], x, cfg.norm)
        x = x + mlp_apply(p["mlp"], h2, cfg)
    x = shard_act(x, (("pod", "data"), None, "model"))
    return x, new_cache, aux


# ------------------------------------------------------------------ #
# stacks: a loop over pattern cycles                                   #
# ------------------------------------------------------------------ #
def find_cycle(pattern: Tuple[str, ...]) -> Tuple[Tuple[str, ...], int, int]:
    """Return (cycle, n_full_cycles, n_remainder)."""
    n = len(pattern)
    for c in range(1, n + 1):
        if all(pattern[i] == pattern[i % c] for i in range(n - (n % c))):
            # candidate cycle c must also fit at least 2 full repeats
            # (otherwise stacking buys nothing)
            if n // c >= 2:
                return pattern[:c], n // c, n % c
    return pattern, 1, 0


def _tmap(fn, tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the tensor leaves of same-structured trees (a
    PackedArray maps its words and keeps its metadata: the pack axis is
    negative, so a leading cycle axis leaves it valid)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tmap(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tmap(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, PackedArray):
        return tree.with_words(fn(tree.words, *(r.words for r in rest)))
    return fn(tree, *rest)


def _stack_trees(trees: List[Any]) -> Any:
    """Stack same-structured trees leaf by leaf along a new axis 0."""
    return _tmap(lambda *xs: torch.stack(xs), *trees)


def _cycles(tree: Any, n_cycles: int) -> List[Any]:
    """A stacked tree as ``n_cycles`` trees: every leaf unbound on axis
    0 once (views; backward stacks the cycles' gradients once)."""
    parts: List[Tuple[torch.Tensor, ...]] = []

    def unbind(t):
        parts.append(t.unbind(0))
        return t
    _tmap(unbind, tree)
    out = []
    for c in range(n_cycles):
        it = iter(parts)
        out.append(_tmap(lambda t: next(it)[c], tree))
    return out


def stack_init(gen, cfg, pattern: Tuple[str, ...], device) -> Dict[str, Any]:
    """Weight-stacked params, blocks drawn from ``gen`` in layer order.
    Each block is written into its cycle's slot as it is drawn, so at
    most one unstacked block is alive beside the stacks."""
    cycle, n_cycles, n_rem = find_cycle(pattern)
    layers: List[Any] = [None] * len(cycle)
    rem = []
    for i, kind in enumerate(pattern):
        blk = block_init(gen, cfg, kind, device)
        c, pos = divmod(i, len(cycle))
        if c >= n_cycles:
            rem.append(blk)
            continue
        if layers[pos] is None:
            layers[pos] = _tmap(lambda t: t.new_empty((n_cycles, *t.shape)),
                                blk)
        _tmap(lambda dst, src: dst[c].copy_(src), layers[pos], blk)
    return {"layers": tuple(layers), "rem": tuple(rem)}


def stack_cache_init(cfg, pattern, batch: int, capacity: int, device,
                     ctx_len: int = 0) -> Dict[str, Any]:
    cycle, n_cycles, n_rem = find_cycle(pattern)
    layers = tuple(
        _stack_trees([init_block_cache(cfg, kind, batch, capacity, device,
                                       ctx_len) for _ in range(n_cycles)])
        for kind in cycle)
    rem = tuple(init_block_cache(cfg, pattern[n_cycles * len(cycle) + r],
                                 batch, capacity, device, ctx_len)
                for r in range(n_rem))
    return {"layers": layers, "rem": rem}


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``checkpoint_dots``: keep the matmul outputs, recompute the rest
    (an attention q chunk's own products too: it is checkpointed on its
    own, as in the reference)."""
    return CheckpointPolicy.MUST_SAVE \
        if op in _DOTS and not attn.in_q_chunk() \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str):
    """``fn`` under the reference's ``jax.checkpoint`` policy."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"unknown remat {remat!r} (none | dots | full)")


def stack_apply(params, x, cfg, pattern, *, positions=None, caches=None,
                step=None, ctx=None, cache_capacity: int = 0,
                remat: Optional[str] = None):
    """Run the full layer stack.  Returns (x, new_caches, aux)."""
    cycle, n_cycles, n_rem = find_cycle(pattern)

    def one_cycle(x_in, cyc_params, cyc_caches):
        new_caches, aux_sum = [], 0.0
        for pos, kind in enumerate(cycle):
            c_in = cyc_caches[pos] if cyc_caches is not None else None
            x_in, nc, aux = block_apply(
                cyc_params[pos], x_in, cfg, kind, positions=positions,
                cache=c_in, step=step, ctx=ctx,
                cache_capacity=cache_capacity)
            new_caches.append(nc)
            aux_sum = aux_sum + aux
        return x_in, tuple(new_caches), aux_sum

    run = _remat(one_cycle, remat or cfg.remat)
    cyc_params = _cycles(params["layers"], n_cycles)
    cyc_caches = _cycles(caches["layers"], n_cycles) \
        if caches is not None else [None] * n_cycles
    aux_total = 0.0
    per_cycle = []
    for c in range(n_cycles):
        x, ncs, aux = run(x, cyc_params[c], cyc_caches[c])
        per_cycle.append(ncs)
        aux_total = aux_total + aux
    new_stacked = tuple(_stack_trees([cyc[pos] for cyc in per_cycle])
                        for pos in range(len(cycle)))

    new_rem = []
    for r in range(n_rem):
        kind = pattern[n_cycles * len(cycle) + r]
        c_in = caches["rem"][r] if caches is not None else None
        x, nc, aux = block_apply(
            params["rem"][r], x, cfg, kind, positions=positions,
            cache=c_in, step=step, ctx=ctx, cache_capacity=cache_capacity)
        new_rem.append(nc)
        aux_total = aux_total + aux
    return x, {"layers": new_stacked, "rem": tuple(new_rem)}, aux_total
