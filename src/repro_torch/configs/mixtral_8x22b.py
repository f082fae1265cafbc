"""mixtral-8x22b — 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, sliding-window attention.  [arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    top_k=2,
    sliding_window=4096,
    norm="rmsnorm",
    act="silu",
    glu=True,
    rope_theta=1_000_000.0,
)
