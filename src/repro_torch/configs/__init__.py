"""Architecture registry of the port: ``--arch <id>`` resolves through here.

Every architecture of the JAX registry, in all four families: the
transformer family (dense and MoE, the models the serving engine drives),
hymba, xlstm and the whisper encoder-decoder.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    QuantConfig,
    ShapeCell,
    applicable_shapes,
)

_ARCH_MODULES = {
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "bitnet-730m": "repro_torch.configs.bitnet_730m",
}

ALL_ARCHS = list(_ARCH_MODULES)


def get_config(arch: str, *, quant_mode: str | None = None) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    cfg: ModelConfig = importlib.import_module(_ARCH_MODULES[arch]).CONFIG
    if quant_mode is not None:
        cfg = dataclasses.replace(cfg, quant=QuantConfig(mode=quant_mode))
    return cfg


def reduced_config(arch: str, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU tests: the JAX package's
    ``reduced_config``."""
    cfg = get_config(arch)
    small = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=2 if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab_size=256,
        max_position_embeddings=2048,
    )
    if cfg.moe:
        small.update(num_experts=4, top_k=2, moe_d_ff=64)
    if cfg.family == "encdec":
        small.update(encoder_layers=2, encoder_seq=16)
    if cfg.family == "hymba":
        small.update(sliding_window=32, global_attn_layers=(0,), ssm_state=8)
    if cfg.family == "xlstm":
        small.update(num_heads=4, num_kv_heads=4, head_dim=32, slstm_every=2)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


__all__ = ["ModelConfig", "QuantConfig", "ShapeCell", "SHAPES", "applicable_shapes",
           "ALL_ARCHS", "get_config", "reduced_config"]
