"""hymba-1.5b  [hybrid]  (arXiv:2411.13676) — parallel attention + mamba heads.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Per Hymba: sliding-window attention everywhere except 3 full-attention
layers (first / middle / last); the SSM branch runs in parallel with the
attention branch in every layer.  SWA + SSM => sub-quadratic, so this arch
runs the long_500k decode cell.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hymba",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    sliding_window=1024,
    global_attn_layers=(0, 15, 31),
    tie_embeddings=True,
)
