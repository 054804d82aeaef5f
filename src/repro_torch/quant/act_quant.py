"""Per-token int8 activation quantization (the A8 side of W1.58-A8)."""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_activations_int8(x: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token absmax int8 quantization: x (..., K) float ->
    (x_q int8 (..., K), scale f32 (..., 1)) with x ~= x_q * scale.
    scale = absmax/127 + eps; round half to even; clip to +-127."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = absmax / 127.0 + eps
    x_q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return x_q, scale
