"""falcon-mamba-7b — 64L d_model=4096 attention-free mamba1 blocks,
ssm_state=16, vocab=65024.  [arXiv:2410.05355]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_expand=2,
    dt_rank=256,
    conv1d_width=4,
    block_pattern=("mamba",),
    norm="rmsnorm",
    act="silu",
    tie_embeddings=False,
    use_rope=False,
)
