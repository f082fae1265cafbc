"""llama-3.2-vision-11b — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, cross-attention image layers every 5.  Vision frontend STUB:
input_specs() provides precomputed patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_every=5,
    num_image_tokens=1600,
    frontend="vision_patches",
    norm="rmsnorm",
    act="silu",
    glu=True,
    rope_theta=500_000.0,
)
