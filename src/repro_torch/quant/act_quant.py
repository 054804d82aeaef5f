"""Per-token int8 activation quantization (the A8 side of W1.58-A8).

The plain version of the ``act_quant`` kernel in ``csrc/tlmm.cu``, and its
oracle: the kernel must return the same bits.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# f32(1/127): the constant XLA multiplies by where the JAX package writes
# ``absmax / 127.0``
INV_127 = float(np.float32(1.0 / 127.0))


def quantize_activations_int8(x: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token absmax int8 quantization: x (..., K) float ->
    (x_q int8 (..., K), scale f32 (..., 1)) with x ~= x_q * scale.

    scale is ``absmax * f32(1/127) + f32(eps)`` rounded once to f32: what the
    JAX package's jitted programs compute for its ``absmax / 127.0 + eps``
    (XLA turns the division into that product and fuses it with the add
    into one multiply-add).  Here the f32 product is taken exactly in f64,
    eps is added in f64 and the sum is rounded to f32; that can differ from
    a true fused multiply-add only by double rounding, at most once in about
    2**29 rows.  The CUDA kernel computes ``fmaf(absmax, f32(1/127), eps)``.
    Then x / scale is a true f32 division, rounded half to even and clipped
    to +-127."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    eps32 = float(np.float32(eps))
    scale = (absmax.double() * INV_127 + eps32).float()
    x_q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return x_q, scale


def quantize_and_fold(x: torch.Tensor, beta: torch.Tensor,
                      eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_activations_int8`` with the weight scale ``beta`` folded
    into the row scale (one f32 multiply): what the ``act_quant`` kernel
    returns, (x_q (M,K) int8, act_scale * beta (M,1) f32)."""
    x_q, scale = quantize_activations_int8(x, eps)
    return x_q, scale * beta
