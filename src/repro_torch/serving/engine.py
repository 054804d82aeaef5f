"""The JAX package's older import surface over the step-driven serving core:
``ServingEngine`` (with ``Request`` and ``EngineStats``) is ``EngineCore``
under its first name, with the same constructor and ``run()``."""
from __future__ import annotations

from repro_torch.serving.core import EngineCore, EngineStats, Request


class ServingEngine(EngineCore):
    """The first engine's name; a thin alias of the step-driven core."""


__all__ = ["EngineCore", "EngineStats", "Request", "ServingEngine"]
