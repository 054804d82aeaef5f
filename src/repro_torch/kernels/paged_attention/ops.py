"""Paged decode attention ops: the CUDA kernels (``csrc/paged_attention.cu``,
B5 over bf16/f32 pages and B6 over quantized ones) on CUDA tensors, their
plain versions on CPU tensors.

Takes flat (B, H, D) queries, regroups them to (B, Hkv, G, D), and reads one
layer's pages through their strides: the slice ``pages[:, li]`` of the
(N, L, Hkv, bs, ·) pool, and of its scale planes, is passed where it lies.
The kernels stage a page's rows in one run, so a page's head slice must be
``bs`` contiguous rows (and ``bs`` contiguous scales), as in every pool the
engine builds.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import COUNTS, refuse_autograd
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ops import (
    PAYLOAD_DTYPES,
    check_contiguous_rows,
    check_walk_operands,
    quant_payload_dim,
    strides_arg,
)
from repro_torch.kernels.paged_attention.ref import (
    paged_decode_attention_quant_reference,
    paged_decode_attention_reference,
)

_ARGS = [build.P] * 9 + [build.I] * 8 + [build.P, build.F, build.P]
_QUANT_ARGS = [build.P] * 11 + [build.I] * 8 + [build.P, build.F, build.P]


def _check_tables(block_tables, b, q):
    if block_tables.dim() != 2 or block_tables.shape[0] != b or block_tables.dtype != torch.int32:
        raise ValueError(f"block_tables must be ({b}, P) int32, got "
                         f"{tuple(block_tables.shape)} {block_tables.dtype}")
    if not block_tables.is_cuda or block_tables.device != q.device:
        raise ValueError("paged decode attention: the block tables must lie on the queries' device")


def _outputs(q):
    b, hkv, g, d = q.shape
    return (torch.empty((b, hkv, g, d), dtype=torch.float32, device=q.device),
            torch.empty((b, hkv, g), dtype=torch.float32, device=q.device),
            torch.empty((b, hkv, g), dtype=torch.float32, device=q.device))


def paged_decode_attention_kernel(q, k_pages, v_pages, block_tables, lengths, starts=None, *,
                                  sm_scale=None):
    """Launch B5: q (B,Hkv,G,D) f32; k/v pages (N,Hkv,bs,D) bf16 or f32 (any
    page/head strides, contiguous slots, 16-byte aligned rows);
    block_tables (B,P) int32; lengths/starts (B,) int32 -> (out (B,Hkv,G,D),
    l, m (B,Hkv,G)), all f32."""
    refuse_autograd("paged_decode_attention_kernel", q, k_pages, v_pages)
    b, hkv, g, d = q.shape
    n, _, bs, _ = k_pages.shape
    if k_pages.shape != (n, hkv, bs, d) or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged decode attention shapes q {tuple(q.shape)} "
                         f"k {tuple(k_pages.shape)} v {tuple(v_pages.shape)}")
    if k_pages.dtype not in (torch.bfloat16, torch.float32) or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged decode attention kernel reads bf16 or f32 pages, "
                        f"got {k_pages.dtype}/{v_pages.dtype}")
    check_walk_operands("paged decode attention", q, lengths, starts, (k_pages, v_pages))
    check_contiguous_rows("paged decode attention", (k_pages, v_pages))
    _check_tables(block_tables, b, q)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    q = q.contiguous()
    lengths = lengths.contiguous()
    block_tables = block_tables.contiguous()
    out, l, m = _outputs(q)
    fn = build.function("paged_attention", "paged_decode_attention_launch", _ARGS)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            lengths.data_ptr(), None if starts is None else starts.contiguous().data_ptr(),
            out.data_ptr(), l.data_ptr(), m.data_ptr(), b, hkv, g, n, bs,
            block_tables.shape[1], d, int(k_pages.dtype == torch.bfloat16),
            strides_arg(k_pages, v_pages, k_pages, v_pages), float(sm_scale),
            build.stream_ptr(q.device))
    build.check(rc, "paged_decode_attention_launch", "paged_attention")
    COUNTS.add("paged_decode_attention")
    return out, l, m


def paged_decode_attention_quant_kernel(q, k_pages_q, k_scales, v_pages_q, v_scales,
                                        block_tables, lengths, starts=None, *,
                                        kv_dtype: str, sm_scale=None):
    """Launch B6: as B5 over packed pages (N,Hkv,bs,Dp), int8 (Dp = D) or
    uint8 int4 nibble pairs (Dp = D/2), with f32 scale planes (N,Hkv,bs)."""
    refuse_autograd("paged_decode_attention_quant_kernel", q, k_scales, v_scales)
    b, hkv, g, d = q.shape
    n, _, bs, _ = k_pages_q.shape
    dp = quant_payload_dim(kv_dtype, d)
    if (k_pages_q.shape != (n, hkv, bs, dp) or v_pages_q.shape != k_pages_q.shape
            or k_scales.shape != (n, hkv, bs) or v_scales.shape != k_scales.shape):
        raise ValueError(f"quantized paged decode attention shapes q {tuple(q.shape)} "
                         f"k {tuple(k_pages_q.shape)} v {tuple(v_pages_q.shape)} "
                         f"scales {tuple(k_scales.shape)}/{tuple(v_scales.shape)}")
    if k_pages_q.dtype != PAYLOAD_DTYPES[kv_dtype] or v_pages_q.dtype != k_pages_q.dtype:
        raise TypeError(f"{kv_dtype} pages must be {PAYLOAD_DTYPES[kv_dtype]}, "
                        f"got {k_pages_q.dtype}/{v_pages_q.dtype}")
    check_walk_operands("quantized paged decode attention", q, lengths, starts,
                        (k_pages_q, v_pages_q), (k_scales, v_scales))
    check_contiguous_rows("quantized paged decode attention", (k_pages_q, v_pages_q),
                          (k_scales, v_scales))
    _check_tables(block_tables, b, q)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    q = q.contiguous()
    lengths = lengths.contiguous()
    block_tables = block_tables.contiguous()
    out, l, m = _outputs(q)
    fn = build.function("paged_attention", "paged_decode_attention_quant_launch", _QUANT_ARGS)
    rc = fn(q.data_ptr(), k_pages_q.data_ptr(), k_scales.data_ptr(), v_pages_q.data_ptr(),
            v_scales.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            None if starts is None else starts.contiguous().data_ptr(),
            out.data_ptr(), l.data_ptr(), m.data_ptr(), b, hkv, g, n, bs,
            block_tables.shape[1], d, int(kv_dtype == "int4"),
            strides_arg(k_pages_q, v_pages_q, k_scales, v_scales), float(sm_scale),
            build.stream_ptr(q.device))
    build.check(rc, "paged_decode_attention_quant_launch", "paged_attention")
    COUNTS.add("paged_decode_attention_quant")
    return out, l, m


def paged_decode_attention(
    q: torch.Tensor,  # (B, H, D)
    k_pages: torch.Tensor,  # (N, Hkv, bs, D), or packed (N, Hkv, bs, Dp)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, P) int32
    lengths: torch.Tensor,  # (B,) int32
    starts: Optional[torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
    return_stats: bool = False,
    k_scales: Optional[torch.Tensor] = None,  # (N, Hkv, bs) f32 — quantized pool
    v_scales: Optional[torch.Tensor] = None,
    kv_dtype: str = "fp",
):
    """Attention of one query token per sequence over its paged KV, with the
    contract of ``decode_attention``."""
    b, h, d = q.shape
    hkv = k_pages.shape[1]
    qg = q.float().reshape(b, hkv, h // hkv, d)
    if kv_dtype != "fp":
        if k_scales is None or v_scales is None:
            raise ValueError("a quantized pool needs its scale planes")
        walk = (paged_decode_attention_quant_kernel if q.is_cuda
                else paged_decode_attention_quant_reference)
        out, l, m = walk(qg, k_pages, k_scales, v_pages, v_scales, block_tables, lengths,
                         starts, kv_dtype=kv_dtype, sm_scale=sm_scale)
    else:
        walk = paged_decode_attention_kernel if q.is_cuda else paged_decode_attention_reference
        out, l, m = walk(qg, k_pages, v_pages, block_tables, lengths, starts, sm_scale=sm_scale)
    if return_stats:
        return out.reshape(b, h, d), l.reshape(b, h, 1), m.reshape(b, h, 1)
    return out.reshape(b, h, d).to(q.dtype)
