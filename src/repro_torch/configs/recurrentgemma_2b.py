"""recurrentgemma-2b — 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000, RG-LRU + local attention in a 2:1 pattern.  [arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,                       # 26-block pattern: (rglru, rglru, local)
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local_attn"),
    lru_width=2560,
    local_window=2048,
    conv1d_width=4,
    norm="rmsnorm",
    act="gelu",
    glu=True,                            # GeGLU MLP
    tie_embeddings=True,
    rope_theta=10_000.0,
)
