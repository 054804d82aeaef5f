"""xlstm-1.3b  [ssm]  (arXiv:2405.04517)

48L d_model=2048 4H d_ff=0 vocab=50304 — sLSTM + mLSTM blocks at the paper's
7:1 ratio (one sLSTM block per 8).  Attention-free: the prefill program is
the chunkwise-parallel mLSTM (and the sequential sLSTM), the decode program
the O(1)-state recurrent update.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="xlstm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=8,
    tie_embeddings=False,
)
