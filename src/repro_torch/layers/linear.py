"""Linear layers: dense matmul and TLMM-backed packed ternary (the paper's
static region, shared by both phases).

Params are ``{"w": (K, N) tensor}`` (+``"b"``) for dense weights, or
``{"w": TernaryWeight}`` for packed ternary weights.  Latent ternary
weights are packed once (``models.transformer.convert_for_inference``), or
quantized and packed on the fly at every call, as the JAX package's slow
inference path does; the quantization-aware training branch comes with
training (ROADMAP A.7).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.kernels.tlmm.ops import tlmm_matmul
from repro_torch.quant.ternary import TernaryWeight, pack_ternary, ternary_quantize


def linear_init(gen: torch.Generator, k: int, n: int, *, bias: bool = False,
                scale: Optional[float] = None, device=None) -> dict:
    """N(0, 1/K) f32 weights (``scale`` overrides the std), drawn from ``gen``."""
    if scale is None:
        scale = 1.0 / (k**0.5)
    p = {"w": torch.randn((k, n), generator=gen, device=device) * scale}
    if bias:
        p["b"] = torch.zeros((n,), device=device)
    return p


def linear_apply(params: dict, x: torch.Tensor, quant: QuantConfig) -> torch.Tensor:
    w = params["w"]
    if isinstance(w, TernaryWeight):
        y = tlmm_matmul(x, w)
    elif quant.ternary:  # unconverted: quantize on the fly (the slow path)
        # a unit weight scale folds nothing; beta multiplies the f32 product
        # afterwards, in the JAX package's order
        w_q, beta = ternary_quantize(w)
        unit = TernaryWeight(pack_ternary(w_q), torch.ones_like(beta))
        y = (tlmm_matmul(x.float(), unit) * beta).to(x.dtype)
    else:
        y = x @ w.to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y
