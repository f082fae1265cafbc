"""Top-level model: init, forward, train loss, prefill, decode.

The port of ``repro.models.model``.  One code path serves all ten
architectures; the config decides the block pattern, attention flavor,
MoE, recurrence, enc-dec and modality-frontend stubs (audio frames /
image patches arrive as precomputed embeddings).

``init_params(generator, cfg, device=None)`` draws from a
``torch.Generator`` (the reference's ``jax.random`` draws cannot be
reproduced): the same tree, shapes and dtypes, other numbers.  It runs
on the card unless the caller passes a CPU device; ``abstract_params``
builds the tree on torch's ``meta`` device.  ``forward`` / ``prefill``
/ ``decode_step`` run on the device of the params they are given, with
no autograd (serving); ``loss_fn`` runs the same forward core
(``_forward``) with grad enabled.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.packed import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (apply_norm, chunked_xent, dtype_of,
                                       embed_init, embed_lookup,
                                       logits_apply, norm_init, normal)
from repro_torch.runtime.sharding import shard_act


def decoder_pattern(cfg: ModelConfig) -> Tuple[str, ...]:
    if cfg.is_encdec:
        return ("encdec",) * cfg.num_layers
    return cfg.pattern_for_layers()


def init_params(generator: Optional[torch.Generator], cfg: ModelConfig,
                device=None) -> Dict[str, Any]:
    """Random params for ``cfg`` on ``device`` (None = the card), drawn
    from ``generator`` in a fixed order (on the generator's device,
    then moved)."""
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    dt = dtype_of(cfg)
    g = generator
    params: Dict[str, Any] = {"embed": embed_init(g, cfg, dev)}
    params["decoder"] = tfm.stack_init(g, cfg, decoder_pattern(cfg), dev)
    params["final_norm"] = norm_init(cfg.d_model, cfg.norm, dt, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(g, cfg, dev)
    if cfg.learned_pos:
        params["pos_emb"] = normal(g, (cfg.max_position, cfg.d_model),
                                   dt, dev) * 0.02
    if cfg.is_encdec:
        params["encoder"] = {
            "stack": tfm.stack_init(g, cfg,
                                    ("full_attn",) * cfg.encoder_layers,
                                    dev),
            "final_norm": norm_init(cfg.d_model, cfg.norm, dt, dev),
            "pos_emb": normal(g, (cfg.encoder_seq, cfg.d_model), dt,
                              dev) * 0.02,
        }
    return params


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """Whisper encoder over precomputed frame embeddings (conv stub)."""
    x = frames.to(dtype_of(cfg))
    x = x + params["encoder"]["pos_emb"][None, :x.shape[1]]
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x, _, _ = tfm.stack_apply(params["encoder"]["stack"], x, cfg,
                              ("full_attn",) * cfg.encoder_layers,
                              positions=pos)
    return apply_norm(params["encoder"]["final_norm"], x, cfg.norm)


def _ctx_from_inputs(params, cfg, batch: Dict[str, torch.Tensor]):
    if cfg.is_encdec and "frames" in batch:
        return encode(params, cfg, batch["frames"])
    if cfg.frontend == "vision_patches" and "image_embeds" in batch:
        return batch["image_embeds"].to(dtype_of(cfg))
    return None


def _forward(params, cfg: ModelConfig, tokens: torch.Tensor,
             ctx: Optional[torch.Tensor] = None,
             cache_capacity: int = 0):
    """The forward core, under whatever grad mode the caller runs."""
    B, S = tokens.shape
    x = embed_lookup(params["embed"], tokens).to(dtype_of(cfg))
    x = shard_act(x, (("pod", "data"), None, "model"))
    pos = torch.arange(S, dtype=torch.int32, device=x.device)
    if cfg.learned_pos:
        x = x + params["pos_emb"][None, :S]
    x, caches, aux = tfm.stack_apply(
        params["decoder"], x, cfg, decoder_pattern(cfg), positions=pos,
        ctx=ctx, cache_capacity=cache_capacity)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return x, caches, aux


@torch.no_grad()
def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            ctx: Optional[torch.Tensor] = None,
            cache_capacity: int = 0):
    """Full-sequence forward, no autograd.  Returns (hidden, caches,
    aux)."""
    return _forward(params, cfg, tokens, ctx=ctx,
                    cache_capacity=cache_capacity)


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    """Next-token cross entropy (+ MoE aux), differentiable in params."""
    tokens, targets = batch["tokens"], batch["targets"]
    ctx = _ctx_from_inputs(params, cfg, batch)
    x, _, aux = _forward(params, cfg, tokens, ctx=ctx)
    emb = params.get("lm_head", params["embed"])
    if cfg.logits_chunk:
        nll = chunked_xent(x, emb, targets, transpose=True,
                           chunk=cfg.logits_chunk)
    else:
        logits = logits_apply(emb, x, transpose=True)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
        nll = lse - tgt
    loss = nll.mean()
    if cfg.num_experts:
        loss = loss + cfg.router_aux_coef * aux
    return loss


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            cache_capacity: int, lengths: Optional[torch.Tensor] = None):
    """Process the prompt; returns (last-token logits, caches).

    lengths: optional [B] int32 true prompt lengths for right-padded
    prompts (the serving engine buckets prompts to shared lengths) —
    logits are taken at position lengths-1 instead of the last padded
    position."""
    tokens = batch["tokens"]
    ctx = _ctx_from_inputs(params, cfg, batch)
    x, caches, _ = forward(params, cfg, tokens, ctx=ctx,
                           cache_capacity=cache_capacity)
    emb = params.get("lm_head", params["embed"])
    if lengths is None:
        x_last = x[:, -1:]
    else:
        idx = (lengths.to(x.device) - 1).long()[:, None, None]
        x_last = torch.gather(x, 1, idx.expand(x.shape[0], 1, x.shape[-1]))
    logits = logits_apply(emb, x_last, transpose=True)
    return logits, caches


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, batch: Dict[str, Any]):
    """One token step.  batch: {"tokens": [B,1], "step": [B],
    "caches": tree}.  Returns (logits [B,1,V], new caches)."""
    tokens, step, caches = batch["tokens"], batch["step"], batch["caches"]
    x = embed_lookup(params["embed"], tokens).to(dtype_of(cfg))
    if cfg.learned_pos:
        x = x + params["pos_emb"][step.long()][:, None]
    x, new_caches, _ = tfm.stack_apply(
        params["decoder"], x, cfg, decoder_pattern(cfg),
        caches=caches, step=step)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    emb = params.get("lm_head", params["embed"])
    logits = logits_apply(emb, x, transpose=True)
    return logits, new_caches


def init_caches(cfg: ModelConfig, batch: int, capacity: int, device=None):
    """Empty decode caches on ``device`` (None = the card)."""
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    return tfm.stack_cache_init(cfg, decoder_pattern(cfg), batch, capacity,
                                dev, ctx_len=_ctx_len(cfg))


def _ctx_len(cfg: ModelConfig) -> int:
    if cfg.is_encdec:
        return cfg.encoder_seq
    if cfg.num_image_tokens:
        return cfg.num_image_tokens
    return 0


# ------------------------------------------------------------------ #
# input specs (meta-device stand-ins, no allocation)                   #
# ------------------------------------------------------------------ #
def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Abstract inputs for one assignment cell, as meta tensors."""
    B, S = shape.global_batch, shape.seq_len
    meta = torch.device("meta")

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=meta)
    tok = spec((B, S), torch.int32)
    out: Dict[str, Any]
    if shape.kind == "train":
        out = {"tokens": tok, "targets": spec((B, S), torch.int32)}
    elif shape.kind == "prefill":
        out = {"tokens": tok}
    else:  # decode: one new token against a capacity-S cache
        out = {"tokens": spec((B, 1), torch.int32),
               "step": spec((B,), torch.int32),
               "caches": init_caches(cfg, B, S, device=meta)}
    if shape.kind != "decode":
        if cfg.is_encdec:
            out["frames"] = spec((B, cfg.encoder_seq, cfg.d_model),
                                 dtype_of(cfg))
        elif cfg.frontend == "vision_patches":
            out["image_embeds"] = spec((B, cfg.num_image_tokens,
                                        cfg.d_model), dtype_of(cfg))
    return out


def abstract_params(cfg: ModelConfig):
    """Parameter shapes without allocation (the meta device)."""
    return init_params(None, cfg, device="meta")
