"""User-facing TLMM op: what ``layers.linear`` calls for a packed weight.

``tlmm_matmul`` quantizes activations per token to int8 (A8), folds the
BitNet weight scale into the per-row activation scale, and multiplies by the
packed ternary weight.  On CUDA tensors that is two launches of
``csrc/tlmm.cu``: ``act_quant`` (x_q and the folded scale) and ``tlmm``; on
CPU tensors it is their plain versions.  The kernels mask the M and N
edges themselves: unlike the TPU wrapper, nothing is padded.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import COUNTS, refuse_autograd
from repro_torch.kernels import build
from repro_torch.kernels.tlmm.ref import tlmm_reference
from repro_torch.quant.act_quant import quantize_and_fold
from repro_torch.quant.ternary import TernaryWeight

_ARGS = [build.P, build.P, build.P, build.P, build.I, build.I, build.I, build.P]
_AQ_ARGS = [build.P, build.I, build.P, build.P, build.P, build.I, build.I, build.F, build.P]
_AQ_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def act_quant_kernel(x: torch.Tensor, beta: torch.Tensor,
                     eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: x (M,K) f32 or bf16, beta a one-element f32
    tensor -> (x_q (M,K) int8, scale (M,1) f32 = act_scale * beta), bit-equal
    to ``quantize_and_fold``."""
    refuse_autograd("act_quant_kernel", x, beta)
    m, k = x.shape
    if x.dtype not in _AQ_DTYPES or beta.dtype != torch.float32 or beta.numel() != 1:
        raise TypeError("act_quant_kernel takes f32 or bf16 x and a one-element f32 beta")
    if m == 0 or k % 4:
        raise ValueError(f"act_quant_kernel takes M >= 1 and K % 4 == 0, got M={m} K={k}")
    if not (x.is_cuda and beta.is_cuda and beta.device == x.device):
        raise ValueError("act_quant_kernel: every operand must lie on the same CUDA device")
    x = x.contiguous()
    if x.data_ptr() % 16:  # rows are read 16 bytes at a time
        x = x.clone()
    x_q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    fn = build.function("tlmm", "act_quant_launch", _AQ_ARGS)
    rc = fn(x.data_ptr(), _AQ_DTYPES[x.dtype], beta.data_ptr(), x_q.data_ptr(), scale.data_ptr(),
            m, k, eps, build.stream_ptr(x.device))
    build.check(rc, "act_quant_launch", "tlmm")
    COUNTS.add("act_quant")
    return x_q, scale


def tlmm_kernel(x_q: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: x_q (M,K) int8 with M >= 1, w_packed (K/4,N)
    uint8, scale (M,1) f32 -> y (M,N) f32.  M <= 8 runs the cluster split-K
    kernel, larger M the int8 tensor-core kernel."""
    refuse_autograd("tlmm_kernel", x_q, w_packed, scale)
    m, k = x_q.shape
    kq, n = w_packed.shape
    if kq * 4 != k:
        raise ValueError(f"x_q has K={k} but w_packed holds {kq * 4} rows")
    if m == 0 or n == 0 or k == 0:
        raise ValueError(f"tlmm_kernel takes non-empty operands, got M={m} K={k} N={n}")
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
    COUNTS.add("tlmm")
    return y


def tlmm_matmul(x: torch.Tensor, w: TernaryWeight) -> torch.Tensor:
    """y = (quantize_int8(x) @ unpack(w)) * act_scale * w_scale, shape
    (..., N), in x's dtype."""
    *lead, k = x.shape
    x2 = x.reshape(-1, k)
    if x.is_cuda:
        x_q, scale = act_quant_kernel(x2, w.scale)
        y = tlmm_kernel(x_q, w.packed, scale)
    else:
        x_q, scale = quantize_and_fold(x2, w.scale)
        y = tlmm_reference(x_q, w.packed, scale)
    return y.to(x.dtype).reshape(*lead, w.n)

