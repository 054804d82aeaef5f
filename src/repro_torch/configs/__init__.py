"""Architecture registry of the port (only the architectures it serves)."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig, QuantConfig

_ARCH_MODULES = {
    "bitnet-730m": "repro_torch.configs.bitnet_730m",
}

ALL_ARCHS = list(_ARCH_MODULES)


def get_config(arch: str, *, quant_mode: str | None = None) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port serves {sorted(_ARCH_MODULES)} "
                       "(other families: ROADMAP A12)")
    cfg: ModelConfig = importlib.import_module(_ARCH_MODULES[arch]).CONFIG
    if quant_mode is not None:
        cfg = dataclasses.replace(cfg, quant=QuantConfig(mode=quant_mode))
    return cfg


def reduced_config(arch: str, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU tests — the same reduction as the
    JAX package's ``reduced_config`` for the transformer family."""
    cfg = get_config(arch)
    small = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=2 if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab_size=256,
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


__all__ = ["ModelConfig", "QuantConfig", "ALL_ARCHS", "get_config", "reduced_config"]
