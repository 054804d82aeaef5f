"""granite-moe-3b-a800m  [moe]  (hf:ibm-granite granite-3.0 MoE family)

32L d_model=1536 24H (GQA kv=8) per-expert d_ff=512 vocab=49155, MoE 40e top-8.
The assignment header says "MoE 40e top-8" while its trailing note says "32
experts"; the HF 3b-a800m config is 40 experts top-8, so we use 40.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="transformer",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    moe=True,
    num_experts=40,
    top_k=8,
    moe_d_ff=512,
    rope_theta=10000.0,
)
