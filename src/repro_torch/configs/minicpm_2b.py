"""minicpm-2b  [dense]  (arXiv:2404.06395) — llama-like; WSD LR schedule.

40L d_model=2304 36H (MHA kv=36) d_ff=5760 vocab=122753.  The WSD
(warmup-stable-decay) schedule it introduces is ``optim.schedules.wsd``
(the train CLI's ``--schedule wsd``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="transformer",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    rope_theta=10000.0,
    tie_embeddings=True,
)
