"""whisper-large-v3 — enc-dec, 32L d_model=1280 20H (MHA kv=20) d_ff=5120
vocab=51866 (padded to 51872 for mesh divisibility), conv frontend STUB:
input_specs() provides precomputed frame embeddings.  [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,            # decoder layers
    encoder_layers=32,
    is_encdec=True,
    encoder_seq=1500,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    norm="layernorm",
    act="gelu",
    glu=False,                # plain GELU MLP
    attn_bias=True,
    use_rope=False,
    learned_pos=True,         # learned absolute positions
    frontend="audio_frames",
    tie_embeddings=True,
    max_position=65_536,      # sized for the decode_32k cell
)
