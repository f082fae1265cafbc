"""command-r-plus-104b — 64L d_model=12288 96H (GQA kv=8) d_ff=33792
vocab=256000, GQA, no-bias.  [hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    norm="layernorm",
    act="silu",
    glu=True,
    tie_embeddings=True,      # cohere ties input/output embeddings
    rope_theta=75_000_000.0,
    logits_chunk=0,
)
