"""Decode attention op: the CUDA kernel (``csrc/decode_attention.cu``) on
CUDA tensors, the plain version on CPU tensors.

Takes flat (B, H, D) queries, regroups them to (B, Hkv, G, D), and reads the
cache through its strides: the per-layer slice ``cache[:, li]`` of the
batch-leading (B, L, Hkv, Smax, D) cache is passed where it lies.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import COUNTS
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import decode_attention_reference

_ARGS = ([build.P] * 8 + [build.I] * 6 + [build.I64] * 6 + [build.F, build.P])
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8


def decode_attention_kernel(q, k, v, lengths, starts=None, *, sm_scale=None):
    """Launch the CUDA kernel: q (B,Hkv,G,D) f32, k/v (B,Hkv,S,D) bf16 or
    f32 (any batch/head/position strides, unit stride along D, 16-byte
    aligned rows), lengths/starts (B,) int32 -> (out (B,Hkv,G,D), l, m
    (B,Hkv,G)), all f32."""
    b, hkv, g, d = q.shape
    s = k.shape[2]
    if k.shape != (b, hkv, s, d) or v.shape != k.shape:
        raise ValueError(f"decode attention shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in HEAD_DIMS or g > MAX_GROUP:
        raise ValueError(f"decode attention kernel takes head_dim in {HEAD_DIMS} and "
                         f"at most {MAX_GROUP} query heads per KV head; got D={d}, G={g}")
    if k.dtype not in (torch.bfloat16, torch.float32) or v.dtype != k.dtype:
        raise TypeError(f"decode attention kernel reads bf16 or f32 caches, got {k.dtype}/{v.dtype}")
    if q.dtype != torch.float32 or lengths.dtype != torch.int32:
        raise TypeError("decode attention kernel takes f32 queries and int32 lengths")
    vec = 16 // k.element_size()
    for t in (k, v):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            raise ValueError("decode attention kernel needs unit stride along head_dim "
                             "and 16-byte aligned cache rows")
    for t in (q, k, v, lengths) + (() if starts is None else (starts,)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("decode attention kernel: every operand must lie on one CUDA device")
    if starts is not None and starts.dtype != torch.int32:
        raise TypeError("decode attention kernel takes int32 starts")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    q = q.contiguous()
    lengths = lengths.contiguous()
    out = torch.empty((b, hkv, g, d), dtype=torch.float32, device=q.device)
    l = torch.empty((b, hkv, g), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hkv, g), dtype=torch.float32, device=q.device)
    fn = build.function("decode_attention", "decode_attention_launch", _ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            None if starts is None else starts.contiguous().data_ptr(),
            out.data_ptr(), l.data_ptr(), m.data_ptr(), b, hkv, g, s, d,
            int(k.dtype == torch.bfloat16), *k.stride()[:3], *v.stride()[:3],
            float(sm_scale), build.stream_ptr(q.device))
    build.check(rc, "decode_attention_launch", "decode_attention")
    COUNTS["decode_attention"] += 1
    return out, l, m


def decode_attention(
    q: torch.Tensor,  # (B, H, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int32
    starts: Optional[torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
    return_stats: bool = False,
):
    """Attention of one query token per sequence over a masked KV cache.
    ``return_stats=True`` also returns the softmax stats (l, m), each
    (B, H, 1) f32, with the output left in f32, for ``_merge_new_token``."""
    b, h, d = q.shape
    hkv = k.shape[1]
    qg = q.float().reshape(b, hkv, h // hkv, d)
    if q.is_cuda:
        out, l, m = decode_attention_kernel(qg, k, v, lengths, starts, sm_scale=sm_scale)
    else:
        out, l, m = decode_attention_reference(qg, k, v, lengths, starts, sm_scale=sm_scale)
    if return_stats:
        return out.reshape(b, h, d), l.reshape(b, h, 1), m.reshape(b, h, 1)
    return out.reshape(b, h, d).to(q.dtype)
