"""command-r-35b — 40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000,
GQA, no-bias.  [hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    norm="layernorm",
    act="silu",
    glu=True,
    tie_embeddings=True,
    rope_theta=8_000_000.0,
)
