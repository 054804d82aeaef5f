"""smollm-135m  [dense]  (hf:HuggingFaceTB/SmolLM-135M) — small llama-arch.

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.  The ~100M-class model,
and the serving CLI's default arch.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="transformer",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    rope_theta=10000.0,
    tie_embeddings=True,
)
