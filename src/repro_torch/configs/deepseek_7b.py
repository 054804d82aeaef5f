"""deepseek-7b  [dense]  (arXiv:2401.02954) — llama-arch.

30L d_model=4096 32H (MHA kv=32) d_ff=11008 vocab=102400.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="transformer",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    rope_theta=10000.0,
    tie_embeddings=False,
)
