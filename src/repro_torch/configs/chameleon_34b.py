"""chameleon-34b  [vlm]  (arXiv:2405.09818)

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 — early-fusion VLM.
VQ-VAE image tokens share the text vocabulary, so the modality frontend is a
stub: image patches are plain token ids in [0, vocab).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="transformer",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    rope_theta=10000.0,
    tie_embeddings=False,
)
