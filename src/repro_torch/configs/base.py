"""Model/config dataclasses: the port's own copy of ``repro.configs.base``.

The fields, defaults and derived quantities match the JAX package's
dataclasses so one configuration means the same model in both packages.
Only the fields the port reads are kept (the family-specific fields of
MoE, SSM, xLSTM and encoder-decoder models come with those families, and
the JAX execution knobs have no counterpart: the port's kernels always run
on CUDA tensors, their plain versions on CPU tensors).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """BitNet-b1.58 style quantization (the paper's W1.58-A8 regime)."""

    mode: str = "bf16"  # "bf16" | "ternary"
    act_bits: int = 8
    tl_group: int = 4

    @property
    def ternary(self) -> bool:
        return self.mode == "ternary"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # transformer | xlstm | hymba | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    moe: bool = False

    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None

    norm: str = "rmsnorm"
    act: str = "silu"
    tie_embeddings: bool = True
    norm_eps: float = 1e-5

    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, (
            f"{self.name}: num_heads={self.num_heads} not a multiple of "
            f"num_kv_heads={self.num_kv_heads}"
        )

    @property
    def q_group(self) -> int:
        return self.num_heads // self.num_kv_heads

    def padded_vocab(self, multiple: int = 256) -> int:
        """Megatron-style vocab padding (the JAX package's embedding rows)."""
        return _round_up(self.vocab_size, multiple)
