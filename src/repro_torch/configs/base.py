"""Model / run configuration for the repro framework.

The port's own copy of ``repro.configs.base`` (stdlib only): every
field, default and formula is the reference's, so a config means the
same model in both packages.

A single frozen dataclass describes every supported architecture family
(dense / MoE / hybrid-recurrent / SSM / enc-dec audio / VLM).  The paper's
technique (TULIP-style binarization of linear projections) is a first-class
config field (``binarize``), so every architecture can run in:

  * ``none``          — conventional bf16 ("YodaNN / MAC path" baseline)
  * ``weights``       — binary weights, bf16 activations (XNOR-Net style)
  * ``weights+acts``  — binary weights and activations (full BNN)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str = "unnamed"
    family: str = "dense"  # dense | moe | hybrid | ssm | audio | vlm

    # transformer backbone
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0          # 0 -> d_model // num_heads
    d_ff: int = 256
    vocab_size: int = 512
    norm: str = "rmsnorm"      # rmsnorm | layernorm
    act: str = "silu"          # silu | gelu
    glu: bool = True           # gated FFN (SwiGLU/GeGLU) vs plain MLP
    qkv_bias: bool = False     # qwen-style QKV bias
    attn_bias: bool = False    # output-proj / mlp bias (whisper uses True)
    rope_theta: float = 10_000.0
    use_rope: bool = True      # False -> no rotary (whisper, mamba)
    learned_pos: bool = False  # learned absolute position table (whisper)
    max_position: int = 1 << 20
    tie_embeddings: bool = False

    # attention pattern
    sliding_window: int = 0    # >0 -> SWA (mixtral)

    # MoE
    num_experts: int = 0
    top_k: int = 0
    router_aux_coef: float = 0.01

    # hybrid / recurrent (recurrentgemma)
    block_pattern: Tuple[str, ...] = ("attn",)  # cycled over layers
    lru_width: int = 0
    local_window: int = 0      # window for "local_attn" blocks
    conv1d_width: int = 4

    # SSM (falcon-mamba, mamba1)
    ssm_state: int = 0
    ssm_expand: int = 2
    dt_rank: int = 0           # 0 -> ceil(d_model / 16)

    # enc-dec (whisper)
    is_encdec: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500    # whisper encoder frames after conv stem (stub)

    # VLM (llama-3.2-vision)
    cross_attn_every: int = 0  # insert a cross-attn layer every N layers
    num_image_tokens: int = 0

    # modality frontend stub: none | audio_frames | vision_patches
    frontend: str = "none"

    # --- the paper's technique -------------------------------------------
    binarize: str = "weights"          # none | weights | weights+acts
    moe_impl: str = "dense"            # dense | capacity (GShard dispatch)
    binarize_attn_proj: bool = True
    binarize_ffn: bool = True
    pack_weights: bool = False         # serve-time: uint32 bit-packed weights
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | int8

    # numerics / memory
    dtype: str = "bfloat16"
    remat: str = "none"                # none | dots | full
    logits_chunk: int = 0              # >0: chunked logits for huge vocab
    attn_q_chunk: int = 512            # flash-attention tile sizes
    attn_kv_chunk: int = 1024

    # derived -------------------------------------------------------------
    @property
    def kq_dim(self) -> int:
        return self.head_dim_() * self.num_heads

    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    def padded_vocab(self, multiple: int = 32) -> int:
        return _round_up(self.vocab_size, multiple)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k-token contexts? (bounded decode state)"""
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            return True  # RG-LRU + bounded local attention window
        return self.sliding_window > 0  # SWA bounds the decode KV cache

    def dt_rank_(self) -> int:
        return self.dt_rank if self.dt_rank else -(-self.d_model // 16)

    def pattern_for_layers(self) -> Tuple[str, ...]:
        """Expand block_pattern cyclically over num_layers, with VLM
        cross-attention injection."""
        pat = []
        for i in range(self.num_layers):
            kind = self.block_pattern[i % len(self.block_pattern)]
            pat.append(kind)
        if self.cross_attn_every > 0:
            pat = [
                "cross_attn" if (i % self.cross_attn_every
                                 == self.cross_attn_every - 1) else k
                for i, k in enumerate(pat)
            ]
        return tuple(pat)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # parameter counting (analytic; used by roofline MODEL_FLOPS) ---------
    def param_count(self, active_only: bool = False) -> int:
        d, h = self.d_model, self.head_dim_()
        nq, nkv = self.num_heads, self.num_kv_heads
        attn = d * (nq * h) + 2 * d * (nkv * h) + (nq * h) * d
        if self.qkv_bias:
            attn += (nq + 2 * nkv) * h
        ffn_mult = 3 if self.glu else 2
        ffn = ffn_mult * d * self.d_ff
        norms = 2 * d

        def dense_layer():
            return attn + ffn + norms

        n = 0
        if self.family == "moe":
            e = self.top_k if active_only else self.num_experts
            per_layer = attn + e * ffn + self.num_experts * d + norms
            n += self.num_layers * per_layer
        elif self.family == "ssm":
            d_in = self.ssm_expand * d
            dtr = self.dt_rank_()
            per_layer = (d * 2 * d_in              # in_proj (x and z)
                         + d_in * self.conv1d_width
                         + d_in * (dtr + 2 * self.ssm_state)  # x_proj
                         + dtr * d_in              # dt_proj
                         + d_in * self.ssm_state   # A_log
                         + d_in                    # D
                         + d_in * d                # out_proj
                         + d)                      # norm
            n += self.num_layers * per_layer
        elif self.family == "hybrid":
            w = self.lru_width or d
            rec = (d * 2 * w + w * self.conv1d_width + 2 * w  # RG-LRU a,x gates
                   + 2 * w * w                      # input/ gate projections
                   + w * d + norms)
            loc = dense_layer()
            pat = self.pattern_for_layers()
            n += sum(rec if k == "rglru" else loc for k in pat)
        else:
            pat = self.pattern_for_layers()
            cross = attn + norms  # cross-attn layers add their own projections
            for k in pat:
                n += dense_layer() + (cross if k == "cross_attn" else 0)
            if self.is_encdec:
                enc = self.encoder_layers * (dense_layer())
                dec_cross = self.num_layers * (attn + norms)
                n += enc + dec_cross
        # embeddings + final norm (+ untied logits head)
        emb = self.padded_vocab() * d
        n += emb + d + (0 if self.tie_embeddings else emb)
        return n


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape × step-kind) cell from the assignment."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Is this (arch, shape) cell runnable?  Returns (ok, reason)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 524k-token decode needs "
                       "sub-quadratic attention (see DESIGN.md §5)")
    return True, ""


def reduced(cfg: ModelConfig, vocab: int = 512) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    pat_len = len(cfg.block_pattern)
    n_layers = max(2, pat_len)
    if cfg.cross_attn_every:
        n_layers = max(n_layers, cfg.cross_attn_every)
    kw = dict(
        name=cfg.name + "-reduced",
        num_layers=n_layers,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=vocab,
        lru_width=64 if cfg.lru_width else 0,
        local_window=32 if cfg.local_window else 0,
        sliding_window=32 if cfg.sliding_window else 0,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=8 if cfg.ssm_state else 0,
        dt_rank=8 if cfg.family == "ssm" else 0,
        encoder_layers=2 if cfg.is_encdec else 0,
        encoder_seq=16 if cfg.is_encdec else 1500,
        cross_attn_every=4 if cfg.cross_attn_every else 0,
        num_image_tokens=8 if cfg.num_image_tokens else 0,
        max_position=4096,
        logits_chunk=0,
    )
    if cfg.num_heads and cfg.num_kv_heads == cfg.num_heads:
        kw["num_kv_heads"] = 4  # keep MHA archs MHA
    return cfg.replace(**kw)
