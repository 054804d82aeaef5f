"""Plain PyTorch version of the TLMM kernel (``csrc/tlmm.cu``)."""
from __future__ import annotations

import torch

from repro_torch.quant.ternary import unpack_ternary


def tlmm_reference(x_q: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(M,K) int8 @ unpack(w_packed) -> (M,N) f32, scaled per row by ``scale``
    (M,1).  The product runs in f32, which is exact integer arithmetic while
    127*K < 2**24 (TF32 is off, see ``repro_torch``), so the one rounding is
    the final scale — the same as the kernel's int32 path."""
    k = x_q.shape[1]
    assert 127 * k < 2**24, f"K={k}: the f32 product is no longer exact"
    w = unpack_ternary(w_packed).float()
    acc = x_q.float() @ w
    return acc * scale
