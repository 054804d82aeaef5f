"""whisper-large-v3  [audio]  (arXiv:2212.04356)

Enc-dec, 32 encoder + 32 decoder layers, d_model=1280 20H d_ff=5120
vocab=51866.  The conv frontend is a stub: the encoder takes precomputed
frame embeddings (B, 1500, 1280).  LayerNorm + GELU (not RMS/SwiGLU),
learned decoder positions (no RoPE).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    encoder_layers=32,
    encoder_seq=1500,
    cross_attention=True,
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
    rope_theta=0.0,  # learned absolute positions, no RoPE
    max_position_embeddings=32768,  # decode_32k cell needs this many slots
)
