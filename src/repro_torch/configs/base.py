"""Model/config dataclasses: the port's own copy of ``repro.configs.base``.

The fields, defaults and derived quantities (``param_count``,
``active_param_count``, ``ffn_hidden``, the shape cells) match the JAX
package's, so one configuration means the same model in both packages.
Of the JAX execution knobs, ``remat`` (the activation checkpointing of
the training layer walk: ``"full"``, ``"dots"`` or ``"none"``) is kept; it
changes the memory a training step holds, never a number.  ``use_pallas``
and ``attn_impl`` have no counterpart: the port's kernels always run on
CUDA tensors, their plain versions on CPU tensors.  The port runs every
model family of the JAX registry (transformer, hymba, xlstm, encdec).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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

    # --- MoE ---
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden size (d_ff is then unused)

    # --- attention details ---
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    global_attn_layers: Tuple[int, ...] = ()
    causal: bool = True

    # --- SSM / recurrent ---
    ssm_state: int = 0
    ssm_conv: int = 4
    slstm_every: int = 8

    # --- encoder-decoder ---
    encoder_layers: int = 0
    encoder_seq: int = 0
    cross_attention: bool = False

    # --- misc ---
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu (SwiGLU) | gelu
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    max_position_embeddings: int = 1 << 20

    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)

    # dropped-token capacity factor for MoE routing
    moe_capacity_factor: float = 1.25

    # activation checkpointing of the training layer walk: full | dots | none
    remat: str = "full"

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

    @property
    def attention_free(self) -> bool:
        return self.family == "xlstm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context with bounded per-step cost?"""
        return self.family in ("xlstm", "hymba")

    @property
    def ffn_hidden(self) -> int:
        return self.moe_d_ff if self.moe else self.d_ff

    def param_count(self) -> int:
        """Analytic parameter count (the JAX package's, term for term)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "xlstm":
            return emb + L * _xlstm_layer_params(self) + d
        attn = (d * (self.num_heads * hd) + d * (2 * self.num_kv_heads * hd)
                + (self.num_heads * hd) * d)
        if self.qkv_bias:
            attn += (self.num_heads + 2 * self.num_kv_heads) * hd
        if self.moe:
            ffn = self.num_experts * (3 * d * self.moe_d_ff) + d * self.num_experts
        elif self.act == "silu":
            ffn = 3 * d * self.d_ff
        else:
            ffn = 2 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        total = emb + L * per_layer + d
        if self.family == "hymba":
            total += L * _ssm_branch_params(self)
        if self.family == "encdec":
            enc_per = attn + (2 * d * self.d_ff) + 2 * d
            cross = attn + d
            total += self.encoder_layers * enc_per + L * cross
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only top_k experts count)."""
        if not self.moe:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        dense = self.param_count() - L * self.num_experts * 3 * d * self.moe_d_ff
        return dense + L * self.top_k * 3 * d * self.moe_d_ff


def _xlstm_layer_params(cfg: ModelConfig) -> int:
    d, H = cfg.d_model, cfg.num_heads
    hd = d // H
    # mLSTM block: q/k/v proj + i/f/o gates + out proj + norm
    m = 3 * d * d + 3 * d * H + d * d + 2 * d
    # sLSTM block: 4 gates input + 4 recurrent (block-diag per head) + out
    s = 4 * d * d + 4 * H * hd * hd + d * d + 2 * d
    n_s = cfg.num_layers // cfg.slstm_every
    n_m = cfg.num_layers - n_s
    return (n_m * m + n_s * s) // cfg.num_layers


def _ssm_branch_params(cfg: ModelConfig) -> int:
    d, N = cfg.d_model, cfg.ssm_state
    d_in = d  # ssm branch inner width == d_model (parallel-heads design)
    return d * 2 * d_in + d_in * (2 * N + 1) + d_in * cfg.ssm_conv + d_in * d + d_in


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell of the assigned matrix."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[ShapeCell]:
    """The shape cells that run for this arch (long_500k: sub-quadratic only)."""
    cells = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.sub_quadratic:
        cells.append(SHAPES["long_500k"])
    return cells
