"""Uniform model API: family -> module functions, as the JAX package's
``repro.models.registry``.

All four families of the JAX registry: the transformer family (dense and
MoE), hymba, xlstm and the whisper encoder-decoder, each with its
``init``, ``loss_fn`` (the training pass and the chunked loss),
``forward_prefill``, ``decode_step`` and ``init_cache``.
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


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable
    loss_fn: Callable
    forward_prefill: Callable
    decode_step: Callable
    init_cache: Optional[Callable]
    module: Any


def get_model(cfg: ModelConfig) -> ModelAPI:
    mod = _FAMILIES[cfg.family]
    return ModelAPI(init=mod.init, loss_fn=mod.loss_fn, forward_prefill=mod.forward_prefill,
                    decode_step=mod.decode_step, init_cache=getattr(mod, "init_cache", None),
                    module=mod)
