"""Prefill attention op: the CUDA kernel (``csrc/prefill_attention.cu``,
3xTF32 on the tensor cores) on CUDA tensors, the plain version on CPU
tensors.  The kernel masks the ragged S edge itself and reads q/k/v through
their strides, so neither padding nor a contiguous copy is made here."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import COUNTS, refuse_autograd
from repro_torch.kernels import build
from repro_torch.kernels.prefill_attention.ref import prefill_attention_reference

_ARGS = ([build.P] * 4 + [build.I] * 5 + [build.I64] * 9 + [build.F, build.P])
HEAD_DIMS = (32, 64, 128)


def prefill_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             sm_scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel: q (B,H,S,D), k/v (B,Hkv,S,D), all f32 with
    unit stride along D, k/v rows 16-byte aligned -> out (B,H,S,D) f32."""
    refuse_autograd("prefill_attention_kernel", q, k, v)
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if k.shape != (b, hkv, s, d) or v.shape != k.shape or h % hkv:
        raise ValueError(f"prefill attention shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"prefill attention kernel takes head_dim in {HEAD_DIMS}, got {d}")
    for t in (q, k, v):
        if not t.is_cuda or t.dtype != torch.float32 or t.stride(-1) != 1 or t.device != q.device:
            raise ValueError("prefill attention kernel takes f32 CUDA tensors on one device "
                             "with unit stride along head_dim")
    for t in (k, v):  # K/V rows are copied 16 bytes at a time (cp.async)
        if t.data_ptr() % 16 or any(st % 4 for st in t.stride()[:3]):
            raise ValueError("prefill attention kernel takes k/v rows 16-byte aligned: "
                             "a 16-byte aligned base and strides that are multiples of 4")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    out = torch.empty((b, h, s, d), dtype=torch.float32, device=q.device)
    fn = build.function("prefill_attention", "prefill_attention_launch", _ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hkv, s, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], float(sm_scale),
            build.stream_ptr(q.device))
    build.check(rc, "prefill_attention_launch", "prefill_attention")
    COUNTS.add("prefill_attention")
    return out


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      sm_scale: Optional[float] = None) -> torch.Tensor:
    """Causal self-attention over a full prompt, (B,H,S,D) layout, output in
    q's dtype.  bf16 operands are widened to f32 for the kernel, as the
    Pallas kernel loads its tiles as f32."""
    if q.is_cuda:
        dtype = q.dtype
        if dtype != torch.float32:
            q, k, v = q.float(), k.float(), v.float()
        return prefill_attention_kernel(q, k, v, sm_scale=sm_scale).to(dtype)
    return prefill_attention_reference(q, k, v, sm_scale=sm_scale)
