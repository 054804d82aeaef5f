"""Per-request sampling parameters for the serving API.

The same dataclass as the JAX package's ``repro.serving.sampling``, beside
the sampler itself (``repro_torch.core.sampling``), re-exported here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.sampling import filter_logits, sample_tokens  # noqa: F401 (re-export)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """``temperature == 0`` selects greedy argmax (the default);
    ``stop_tokens`` end generation early (the stop token is kept, finish
    reason ``"stop"``); ``max_tokens`` overrides the request's ``max_new``.
    Token ``i`` is drawn with ``fold_in(PRNGKey(seed), i)``, so seeded
    sampling is the same across runs and across preemption and replay."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    stop_tokens: Tuple[int, ...] = ()
    max_tokens: Optional[int] = None

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 disables), got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.max_tokens is not None and self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {self.max_tokens}")
        object.__setattr__(self, "stop_tokens", tuple(int(t) for t in self.stop_tokens))

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    @property
    def seed32(self) -> int:
        """The seed folded into the non-negative int32 range the key takes."""
        return int(self.seed) & 0x7FFFFFFF
