"""Uniform model API: family -> module functions, as the JAX package's
``repro.models.registry``.

The port serves the transformer family.  The JAX ``ModelAPI.loss_fn``
comes with training (ROADMAP A.7); the other families with ROADMAP A.4
(hymba), A.5 (xlstm) and A.6 (encdec).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

_FAMILIES = {"transformer": transformer}


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable
    forward_prefill: Callable
    decode_step: Callable
    init_cache: Optional[Callable]
    module: Any


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in _FAMILIES:
        transformer._check_family(cfg)  # raises, naming the item that ports the family
    mod = _FAMILIES[cfg.family]
    return ModelAPI(init=mod.init, forward_prefill=mod.forward_prefill,
                    decode_step=mod.decode_step, init_cache=getattr(mod, "init_cache", None),
                    module=mod)
