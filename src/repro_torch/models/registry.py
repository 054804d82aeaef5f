"""Uniform model API: family -> module functions, as the JAX package's
``repro.models.registry``.

All four families of the JAX registry: the transformer family (dense and
MoE), hymba, xlstm and the whisper encoder-decoder.  The JAX
``ModelAPI.loss_fn`` comes with training (ROADMAP A.7): here it raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hymba, transformer, xlstm

_FAMILIES = {
    "transformer": transformer,
    "xlstm": xlstm,
    "hymba": hymba,
    "encdec": encdec,
}


def _no_training(*args, **kwargs):
    raise NotImplementedError("training is not in the port yet (ROADMAP A.7)")


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable
    forward_prefill: Callable
    decode_step: Callable
    init_cache: Optional[Callable]
    module: Any
    loss_fn: Callable = _no_training


def get_model(cfg: ModelConfig) -> ModelAPI:
    mod = _FAMILIES[cfg.family]
    return ModelAPI(init=mod.init, forward_prefill=mod.forward_prefill,
                    decode_step=mod.decode_step, init_cache=getattr(mod, "init_cache", None),
                    module=mod)
