"""Shared model layers: norms, rotary embedding, binarized dense, MLP.

The port of ``repro.models.layers``.  The paper's technique is
integrated here as ``dense()``: every linear projection in every
architecture routes through it and supports

  mode "none"          a conventional matmul (the MAC/YodaNN path)
  mode "weights"       latent weights, sign+scale at use (XNOR-Net
                       w ~ alpha*sign(w))
  mode "weights+acts"  + sign() on activations (full BNN)

and two serving-time weight layouts:
  dense [K, N]                       (paper-faithful baseline)
  packed int32 [K/32, N] + alpha[N]  (TULIP path: unpacked, then
                                      matmul, as the reference does)

The float x packed-weight product stays unpack -> matmul with alpha
folded into the weights first, exactly as the reference rounds it; it
does not go through ``xnor_gemm``, which scales after the float32 sum.
A packed x (the fully-binary surface) runs on the port's kernels:
``dense`` and ``packed_dense`` through ``popcount_gemm``, ``packed_mlp``
through ``compile_dense_stack`` (``fused_binary_mlp``).

Numerics mirrored on purpose: the norms and RoPE compute in
float32 and cast back, layernorm's variance is the population one
(``jnp.var``), gelu is the tanh approximation (``jax.nn.gelu``'s
default), and ``ste_sign`` maps 0 to +1 while the pack bit is
``x > 0``.  ``chunked_xent`` is the training loss over vocab chunks,
each chunk recomputed in the backward pass (the reference's
``jax.checkpoint``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.binarize import ste_sign
from repro_torch.graph import ir as _gir
from repro_torch.graph.compile import compile as graph_compile
from repro_torch.graph.compile import compile_dense_stack
from repro_torch.kernels import ops as kops
from repro_torch.kernels.packed import PackedArray
from repro_torch.runtime.sharding import (copy_to_model, gather_from_model,
                                          max_over_model, reduce_from_model,
                                          shard_act, tp_rank, tp_size)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ------------------------------------------------------------------ #
# init helpers                                                         #
# ------------------------------------------------------------------ #
def normal(gen: Optional[torch.Generator], shape, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """Standard normal draws in ``dtype`` on ``device``: drawn in float32
    on the generator's device, then moved; on the meta device (abstract
    params) only the shape and dtype exist."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return x.to(device=device, dtype=dtype)


def uniform(gen: Optional[torch.Generator], shape, lo: float, hi: float,
            device: torch.device) -> torch.Tensor:
    """float32 uniform draws in [lo, hi), as ``normal``."""
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    u = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=gen.device)
    return (lo + (hi - lo) * u).to(device)


def dense_init(gen, d_in: int, d_out: int, dtype, device,
               bias: bool = False,
               scale: Optional[float] = None) -> Dict[str, torch.Tensor]:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": normal(gen, (d_in, d_out), dtype, device) * scale}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def pack_dense_params(p: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Offline transform: latent weights -> packed serving layout
    (wp is a PackedArray over the K axis; odd K pads to the word
    boundary, masked out by the logical length)."""
    w = p["w"]
    alpha = torch.mean(torch.abs(w.to(torch.float32)), dim=0)
    out = {"wp": PackedArray.pack(w, axis=0), "alpha": alpha.to(w.dtype)}
    if "b" in p:
        out["b"] = p["b"]
    return out


def wparams(p: Dict[str, Any], name: str,
            bias: Optional[str] = None) -> Dict[str, Any]:
    """Select the dense or packed layout for weight `name` in p."""
    if name + "_p" in p:
        d = {"wp": p[name + "_p"], "alpha": p[name + "_alpha"]}
    else:
        d = {"w": p[name]}
    if bias and bias in p:
        d["b"] = p[bias]
    return d


def out_width(p: Dict[str, Any], name: str) -> int:
    """The output columns of weight `name` in p as this rank holds it
    (a column-parallel block has fewer than the config's width)."""
    if name + "_p" in p:
        return p[name + "_p"].words.shape[-1]
    return p[name].shape[-1]


def own_cols(t: torch.Tensor, n: int) -> torch.Tensor:
    """This "model" rank's block of ``n`` columns (the last dim) of a
    per-column tensor held whole (a packed weight's alpha); ``t`` itself
    where it has ``n``."""
    if t.shape[-1] == n:
        return t
    return t.narrow(-1, tp_rank() * n, n)


def own_halves(p: Dict[str, Any], n: int) -> Dict[str, Any]:
    """A weight (``wparams``' dict) whose output columns are two
    concatenated halves of ``n`` channels each, held whole over "model",
    as this rank's channel block of each half, packed words and their
    alpha by column.  Each rank's gradient of the whole float weight
    covers its columns only: the SPMD step's ``sharding.Block`` of such a
    leaf (``part``) sums it over "model" to the rank's block."""
    c = n // tp_size()
    lo = tp_rank() * c

    def cols(t):
        return torch.cat([t.narrow(-1, lo, c), t.narrow(-1, n + lo, c)],
                         dim=-1)
    if "wp" in p:
        return {"wp": p["wp"].with_words(cols(p["wp"].words)),
                "alpha": cols(p["alpha"])}
    return {"w": cols(p["w"])}


def own_rows(wp: PackedArray, k: int, dtype: torch.dtype) -> torch.Tensor:
    """A [.., K, N] PackedArray (pack axis -2) unpacked to ``dtype``, as
    this "model" rank's block of ``k`` rows where the words are held
    whole over "model" (row-parallel from a weight whose K/32 words do
    not split): only the words that cover the block are unpacked."""
    if wp.length == k:
        return wp.unpack(dtype)
    lo = tp_rank() * k
    first, last = lo // 32, -(-(lo + k) // 32)
    cover = PackedArray(wp.words.narrow(-2, first, last - first),
                        length=min(wp.length, last * 32) - first * 32,
                        axis=-2, values=wp.values)
    return cover.unpack(dtype).narrow(-2, lo - first * 32, k)


def dense(p: Dict[str, Any], x, mode: str = "none",
          binarized: bool = True, row_parallel: bool = False
          ) -> torch.Tensor:
    """Apply a (possibly binarized, possibly packed) linear layer.

    x may itself be a PackedArray (fully-binary path): the GEMM then
    runs packed x packed -> int32 through ``popcount_gemm`` and is
    scaled by alpha.  Use packed_dense() for hidden layers that should
    *stay* packed.

    Tensor-parallel: a column-parallel weight is the rank's block of
    columns (a packed one's alpha, held whole, is cut to it); the caller
    passes x through ``copy_to_model``.  ``row_parallel``: x is the
    rank's block of K, the weight its block of rows (or packed words
    held whole, of which the block's rows are unpacked), a binarized
    weight's scale the mean over the whole K, and the partial products
    are summed over "model" before the bias."""
    wp = p.get("wp")
    if isinstance(x, PackedArray):
        if not isinstance(wp, PackedArray):
            raise ValueError("packed activations require packed weights "
                             "(run pack_dense_params first)")
        s = kops.binary_binary_dense(x, wp.move_pack_axis_last())
        y = s.to(p["alpha"].dtype) * p["alpha"]
    elif isinstance(wp, PackedArray):  # packed serving layout (TULIP)
        w = own_rows(wp, x.shape[-1], x.dtype) \
            * own_cols(p["alpha"], wp.words.shape[-1])
        y = x @ w
    elif wp is not None:
        raise TypeError("packed weights must be a PackedArray "
                        "(adopt_packed converts raw words)")
    elif mode == "none" or not binarized:
        y = x @ p["w"]
    else:
        w = p["w"]
        wa = torch.abs(w.detach().to(torch.float32))
        if row_parallel:
            alpha = reduce_from_model(torch.sum(wa, dim=0)) \
                / (w.shape[0] * tp_size())
        else:
            alpha = torch.mean(wa, dim=0)
        alpha = alpha.to(x.dtype)
        wb = ste_sign(w)
        if mode == "weights+acts":
            x = ste_sign(x)
        y = (x @ wb) * alpha
    if row_parallel:
        y = reduce_from_model(y)
    if "b" in p:
        y = y + p["b"]
    return y


def packed_dense(p: Dict[str, Any], xp: PackedArray, threshold,
                 backend: Optional[str] = None) -> PackedArray:
    """Hidden layer of a fully-binary stack: PackedArray -> PackedArray.

    XNOR + popcount + integer threshold (scalar or per-channel [N]),
    with the threshold->pack epilogue fused in ``popcount_gemm``: the
    sign words come straight out of the kernel."""
    return kops.binary_binary_dense(xp, p["wp"].move_pack_axis_last(),
                                    threshold=threshold, pack_out=True,
                                    backend=backend)


# ------------------------------------------------------------------ #
# DEPRECATED builder shims — the front door is repro_torch.graph       #
# ------------------------------------------------------------------ #
infer_conv_geometry = _gir.infer_conv_geometry
infer_pool = _gir.infer_pool
_fc_entry_size = _gir.fc_entry_size


def packed_cnn_init(generator: torch.Generator, workload,
                    threshold_range: int = 3, dtype=torch.float32,
                    device=None) -> Dict[str, Any]:
    """DEPRECATED shim: ``graph.compile(workload, device=).init(...)``."""
    return graph_compile(workload, device=device).init(
        generator, threshold_range=threshold_range, dtype=dtype)


def packed_cnn_apply(params, x: torch.Tensor, workload,
                     backend: Optional[str] = None,
                     impl: str = "auto") -> torch.Tensor:
    """DEPRECATED shim: ``graph.compile(workload, ...).apply(params,
    x)`` on x's device."""
    cb = graph_compile(workload, backend=backend, device=x.device,
                       batch=x.shape[0], conv_impl=impl)
    return cb.apply(params, x)


def packed_cnn_traffic(workload, batch: int = 1) -> Dict[str, Any]:
    """DEPRECATED shim: ``graph.compile(workload).traffic(batch)``
    (a static byte model: compiled for the CPU, nothing runs)."""
    return graph_compile(workload, device="cpu").traffic(batch=batch)


def packed_mlp(ps, xp: PackedArray, thresholds,
               backend: Optional[str] = None) -> PackedArray:
    """DEPRECATED shim over the compiled dense-stack pipeline.

    ps: sequence of packed layer params (each holding a ``wp``
    PackedArray in the [K, N] axis -2 layout from pack_dense_params);
    thresholds: one int (or per-channel int32 [N_l]) per layer.  The
    plan segments the stack into ``fused_binary_mlp`` launches under
    the shared-memory rule (chained ``popcount_gemm`` where a segment
    does not fit)."""
    ws = [p["wp"].move_pack_axis_last() for p in ps]
    rows = 1
    for d in xp.move_pack_axis_last().words.shape[:-1]:
        rows *= int(d)
    per_chan = [kops.classify_threshold(t, w.words.shape[0])[1]
                is not None for t, w in zip(thresholds, ws)]
    cb = compile_dense_stack(ws[0].length,
                             [w.words.shape[0] for w in ws],
                             backend=backend, device=xp.words.device,
                             batch=rows, per_channel=per_chan)
    params = {"fc": [{"wp": w, "t": t}
                     for w, t in zip(ws, thresholds)]}
    return cb.apply(params, xp)


# ------------------------------------------------------------------ #
# norms                                                                #
# ------------------------------------------------------------------ #
def norm_init(d: int, kind: str, dtype, device) -> Dict[str, torch.Tensor]:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].to(torch.float32) \
            + p["bias"].to(torch.float32)
    else:  # rmsnorm
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


# ------------------------------------------------------------------ #
# rotary position embedding                                            #
# ------------------------------------------------------------------ #
def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    ex = torch.arange(0, head_dim, 2, dtype=torch.float32,
                      device=device) / head_dim
    # a Python base is a kernel argument (float32 here, as jax's weak
    # type), not a host-to-device copy
    return 1.0 / torch.pow(theta, ex)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] (broadcastable)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # [D/2]
    ang = positions[..., None].to(torch.float32) * freqs   # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]                     # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ #
# activations / MLP                                                    #
# ------------------------------------------------------------------ #
def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": gelu, "relu": F.relu}[name]


def mlp_init(gen, cfg, device, d_in: Optional[int] = None
             ) -> Dict[str, Any]:
    d = d_in or cfg.d_model
    dt = dtype_of(cfg)
    p = {}
    if cfg.glu:
        p["w_gate"] = dense_init(gen, d, cfg.d_ff, dt, device,
                                 bias=cfg.attn_bias)["w"]
        p["w_up"] = dense_init(gen, d, cfg.d_ff, dt, device)["w"]
    else:
        p["w_up"] = dense_init(gen, d, cfg.d_ff, dt, device)["w"]
        if cfg.attn_bias:
            p["b_up"] = torch.zeros((cfg.d_ff,), dtype=dt, device=device)
    p["w_down"] = dense_init(gen, cfg.d_ff, d, dt, device)["w"]
    if cfg.attn_bias:
        p["b_down"] = torch.zeros((d,), dtype=dt, device=device)
    return p


def mlp_apply(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """The FFN; tensor-parallel on d_ff (up / gate column-parallel, down
    row-parallel) where the rank holds blocks of its weights."""
    mode = cfg.binarize if cfg.binarize_ffn else "none"
    f = act_fn(cfg.act)
    split = out_width(p, "w_up") < cfg.d_ff
    if split:
        x = copy_to_model(x)
    if cfg.glu:
        g = dense(wparams(p, "w_gate"), x, mode)
        u = dense(wparams(p, "w_up"), x, mode)
        h = f(g) * u
    else:
        h = f(dense(wparams(p, "w_up", "b_up"), x, mode))
    h = shard_act(h, (("pod", "data"), None, "model"))
    return dense(wparams(p, "w_down", "b_down"), h, mode,
                 row_parallel=split)


# ------------------------------------------------------------------ #
# embedding / logits                                                   #
# ------------------------------------------------------------------ #
def embed_init(gen, cfg, device) -> torch.Tensor:
    v = cfg.padded_vocab()
    return normal(gen, (v, cfg.d_model), dtype_of(cfg), device) * 0.02


def _vocab_block(rows: int, vocab: Optional[int]) -> Optional[int]:
    """The first vocab row of this rank's block where an embedding of
    ``rows`` rows is a "model" block of a ``vocab``-row one, else
    None."""
    if vocab is None or rows == vocab:
        return None
    return tp_rank() * rows


def embed_lookup(emb: torch.Tensor, tokens: torch.Tensor,
                 vocab: Optional[int] = None) -> torch.Tensor:
    """The rows of ``tokens``.  Vocab-parallel where ``emb`` is a block
    of a ``vocab``-row embedding: the rows outside the rank's block are
    zero, and the ranks' rows are summed over "model" (one rank holds
    each, so the sum is exact)."""
    lo = _vocab_block(emb.shape[0], vocab)
    if lo is None:
        return emb[tokens]
    idx = tokens - lo
    inside = (idx >= 0) & (idx < emb.shape[0])
    rows = emb[idx.clamp(0, emb.shape[0] - 1)]
    return reduce_from_model(torch.where(inside[..., None], rows, 0.0))


def logits_apply(emb_or_head: torch.Tensor, x: torch.Tensor,
                 transpose: bool, vocab: Optional[int] = None
                 ) -> torch.Tensor:
    """float32 logits; where the embedding is a vocab block (see
    ``embed_lookup``), the ranks' blocks gathered over "model" (the
    serving paths, no gradient)."""
    w = emb_or_head.T if transpose else emb_or_head
    y = (x @ w.to(x.dtype)).to(torch.float32)
    if _vocab_block(w.shape[-1], vocab) is not None:
        y = gather_from_model(y, -1)
    return y


def vocab_parallel_nll(x: torch.Tensor, emb: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """The per-token nll of the full logits where ``emb`` [V/m, D] is
    this rank's vocab block: the max, the sum of exp and the target
    logit of the rank's columns, combined over "model"."""
    lo = tp_rank() * emb.shape[0]
    logits = logits_apply(emb, copy_to_model(x), transpose=True)
    m = max_over_model(logits.amax(dim=-1))
    s = reduce_from_model(torch.exp(logits - m[..., None]).sum(dim=-1))
    idx = targets.long() - lo
    inside = (idx >= 0) & (idx < emb.shape[0])
    got = torch.gather(logits, -1,
                       idx.clamp(0, emb.shape[0] - 1)[..., None])[..., 0]
    tgt = reduce_from_model(torch.where(inside, got, 0.0))
    return (m + torch.log(s)) - tgt


def _xent_chunk(x, wi, targets, m, lse, tgt, base: int, V: int):
    """One vocab chunk of ``chunked_xent``: the running max, the running
    sum of exp and the target logit where it falls in this chunk's rows
    below ``V`` (a target past a padded last chunk is another vocab
    block's)."""
    c = wi.shape[0]
    logits = (x @ wi.to(x.dtype).T).to(torch.float32)
    col = base + torch.arange(c, device=x.device)
    logits = torch.where(col < V, logits, -math.inf)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    lse = torch.exp(m - m_new) * lse + p.sum(dim=-1)
    idx = targets - base
    in_chunk = (idx >= 0) & (idx < min(c, V - base))
    got = torch.gather(logits, -1, idx.clamp(0, c - 1)[..., None])[..., 0]
    return m_new, lse, torch.where(in_chunk, got, tgt)


def chunked_xent(x: torch.Tensor, emb: torch.Tensor, targets: torch.Tensor,
                 transpose: bool, chunk: int,
                 vocab: Optional[int] = None) -> torch.Tensor:
    """Cross-entropy over a huge vocab without materializing full logits.

    The logsumexp runs over vocab chunks (equal chunks of ceil(V /
    ceil(V / chunk)) rows, the last zero-padded and masked) and gathers
    the target logit; x: [B,S,D], emb: [V,D] (transpose=True) or [D,V].
    With grad enabled each chunk is recomputed in the backward pass, so
    the full [B,S,V] logits never live there.  Returns the per-token
    nll [B,S].

    Vocab-parallel where ``emb`` is a "model" block of a ``vocab``-row
    embedding: the chunks run over the rank's rows (their columns at
    the block's offset), then the running max is combined by a max over
    "model", the sums of exp (rescaled to it) and the target logit
    (held by one rank) by sums over "model"."""
    w = emb if transpose else emb.T            # [V, D]
    V = w.shape[0]
    lo = _vocab_block(V, vocab)
    start = 0 if lo is None else lo
    if lo is not None:
        x = copy_to_model(x)
    n_chunks = max(1, -(-V // chunk))
    c = -(-V // n_chunks)
    B, S = targets.shape
    f32 = torch.float32
    m = torch.full((B, S), -math.inf, dtype=f32, device=x.device)
    lse = torch.zeros((B, S), dtype=f32, device=x.device)
    tgt = torch.zeros((B, S), dtype=f32, device=x.device)
    targets = targets.long()
    for i in range(n_chunks):
        wi = w[i * c:(i + 1) * c]
        if wi.shape[0] < c:                    # only the last chunk pads
            wi = F.pad(wi, (0, 0, 0, c - wi.shape[0]))
        args = (x, wi, targets, m, lse, tgt, start + i * c, start + V)
        m, lse, tgt = checkpoint(_xent_chunk, *args, use_reentrant=False) \
            if torch.is_grad_enabled() else _xent_chunk(*args)
    if lo is not None:
        top = max_over_model(m)
        lse = reduce_from_model(torch.exp(m - top) * lse)
        tgt = reduce_from_model(tgt)
        m = top
    return (m + torch.log(lse)) - tgt
