"""moonshot-v1-16b-a3b  [moe]  (hf:moonshotai/Moonlight-16B-A3B)

48L d_model=2048 16H (GQA kv=16) per-expert d_ff=1408 vocab=163840,
MoE 64e top-6.  On one card every expert is local (the JAX package's
expert-parallel path is mesh tooling, ROADMAP A.10).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="transformer",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    moe=True,
    num_experts=64,
    top_k=6,
    moe_d_ff=1408,
    rope_theta=50000.0,
)
