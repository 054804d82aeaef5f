"""User-facing TLMM op: what ``layers.linear`` calls for a packed weight.

``tlmm_matmul`` quantizes activations per token to int8 (A8), folds the
BitNet weight scale into the per-row activation scale, and launches the
CUDA kernel (``csrc/tlmm.cu``) on CUDA tensors or runs the plain version on
CPU tensors.  The kernel masks the M and N edges itself: unlike the TPU
wrapper, nothing is padded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import COUNTS
from repro_torch.kernels import build
from repro_torch.kernels.tlmm.ref import tlmm_reference
from repro_torch.quant.act_quant import quantize_activations_int8
from repro_torch.quant.ternary import TernaryWeight

_ARGS = [build.P, build.P, build.P, build.P, build.I, build.I, build.I, build.P]


def tlmm_kernel(x_q: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: x_q (M,K) int8, w_packed (K/4,N) uint8,
    scale (M,1) f32 -> y (M,N) f32."""
    m, k = x_q.shape
    kq, n = w_packed.shape
    if kq * 4 != k:
        raise ValueError(f"x_q has K={k} but w_packed holds {kq * 4} rows")
    if x_q.dtype != torch.int8 or w_packed.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise TypeError("tlmm_kernel takes int8 x_q, uint8 w_packed and f32 scale")
    for t in (x_q, w_packed, scale):
        if not t.is_cuda or t.device != x_q.device:
            raise ValueError("tlmm_kernel: every operand must lie on the same CUDA device")
    x_q = x_q.contiguous()
    w_packed = w_packed.contiguous()
    scale = scale.reshape(m).contiguous()
    y = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    fn = build.function("tlmm", "tlmm_launch", _ARGS)
    rc = fn(x_q.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), y.data_ptr(),
            m, n, k, build.stream_ptr(x_q.device))
    build.check(rc, "tlmm_launch", "tlmm")
    COUNTS["tlmm"] += 1
    return y


def tlmm_matmul(x: torch.Tensor, w: TernaryWeight) -> torch.Tensor:
    """y = (quantize_int8(x) @ unpack(w)) * act_scale * w_scale, shape
    (..., N), in x's dtype."""
    *lead, k = x.shape
    x2 = x.reshape(-1, k)
    x_q, act_scale = quantize_activations_int8(x2)
    scale = act_scale * w.scale  # (M, 1) f32 — weight absmean folded in
    y = tlmm_kernel(x_q, w.packed, scale) if x.is_cuda else tlmm_reference(x_q, w.packed, scale)
    return y.to(x.dtype).reshape(*lead, w.n)
