"""bitnet-730m — the paper's own model (BitNet b1.58 0.73B, W1.58-A8).

LLaMA-shaped 700M-class config per BitNet b1.58 (arXiv:2402.17764); the same
values as the JAX package's ``repro.configs.bitnet_730m``.
"""
from repro_torch.configs.base import ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="bitnet-730m",
    family="transformer",
    num_layers=24,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=4096,
    vocab_size=32002,
    rope_theta=10000.0,
    tie_embeddings=True,
    quant=QuantConfig(mode="ternary"),
)
