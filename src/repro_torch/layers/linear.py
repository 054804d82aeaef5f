"""Linear layers: dense matmul and TLMM-backed packed ternary (the paper's
static region, shared by both phases).

Params are ``{"w": (K, N) tensor}`` (+``"b"``) for dense weights, or
``{"w": TernaryWeight}`` for packed ternary weights.  Latent ternary
weights take one of three regimes, as in the JAX package:

* inference, packed once (``models.transformer.convert_for_inference``)
  and multiplied by the TLMM kernel;
* inference, quantized and packed on the fly at every call (the slow path);
* training (``training=True``): BitNet quantization-aware training, the
  straight-through ternary weights times the straight-through int8
  activations in an f32 product.  It reaches no kernel: a kernel's output
  has no gradient.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.kernels.tlmm.ops import tlmm_matmul
from repro_torch.quant.act_quant import quantize_activations_int8
from repro_torch.quant.ternary import (
    TernaryWeight,
    pack_ternary,
    ternary_quantize,
    ternary_quantize_ste,
)


def linear_init(gen: torch.Generator, k: int, n: int, *, bias: bool = False,
                scale: Optional[float] = None, device=None) -> dict:
    """N(0, 1/K) f32 weights (``scale`` overrides the std), drawn from ``gen``."""
    if scale is None:
        scale = 1.0 / (k**0.5)
    p = {"w": torch.randn((k, n), generator=gen, device=device) * scale}
    if bias:
        p["b"] = torch.zeros((n,), device=device)
    return p


def _act_fake_quant_ste(x: torch.Tensor) -> torch.Tensor:
    """Per-token int8 fake quantization with a straight-through gradient:
    forward ``x + (deq - x)``, deq the int8 codes times their row scale in
    x's dtype; backward the identity."""
    with torch.no_grad():
        x_q, scale = quantize_activations_int8(x)
        deq = (x_q.float() * scale).to(x.dtype)
    return x + (deq - x).detach()


def linear_apply(params: dict, x: torch.Tensor, quant: QuantConfig, *,
                 training: bool = False) -> torch.Tensor:
    w = params["w"]
    if isinstance(w, TernaryWeight):
        if training:
            raise ValueError("a packed TernaryWeight has no latent weights to train; "
                             "train the latent weights and pack them afterwards")
        y = tlmm_matmul(x, w)
    elif quant.ternary and training:  # BitNet QAT
        w_ste, _ = ternary_quantize_ste(w.float())
        y = (_act_fake_quant_ste(x).float() @ w_ste).to(x.dtype)
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
