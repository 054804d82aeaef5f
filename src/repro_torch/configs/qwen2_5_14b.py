"""qwen2.5-14b  [dense]  (Qwen2.5 family) — GQA with QKV bias.

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.  Biases stay bf16
even in ternary mode (BitNet never ternarizes biases).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="transformer",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=False,
)
