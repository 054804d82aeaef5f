"""Decode attention ops: the CUDA kernels (``csrc/decode_attention.cu``, B3
over a bf16/f32 cache and B4 over a quantized one) on CUDA tensors, their
plain versions on CPU tensors.

Takes flat (B, H, D) queries, regroups them to (B, Hkv, G, D), and reads the
cache through its batch and head strides (query row b reads cache slot
``b // rows_per_slot``: the W rows of a speculative verify block share
their slot): the per-layer slice ``cache[:, li]``
of the batch-leading (B, L, Hkv, Smax, ·) cache, and of its scale planes, is
passed where it lies.  The kernels stage a slot's rows in runs, so along Smax
the rows must be contiguous (and the scales), as in every cache the engine
builds; other strides raise.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import COUNTS, refuse_autograd
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_quant_reference,
    decode_attention_reference,
)

_ARGS = ([build.P] * 8 + [build.I] * 6 + [build.I64] * 6 + [build.I, build.F, build.P])
_QUANT_ARGS = ([build.P] * 10 + [build.I] * 6 + [build.P, build.I, build.F, build.P])
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8
PAYLOAD_DTYPES = {"int8": torch.int8, "int4": torch.uint8}


def check_walk_operands(what: str, q, lengths, starts, payloads, scales=()) -> None:
    """The checks every decode walk (B3-B6) makes before it launches: one
    CUDA device, f32 grouped queries with a head_dim and group it takes,
    int32 lengths/starts, payload rows with unit stride along the last dim
    and 16-byte aligned, f32 scale planes."""
    d, g = q.shape[-1], q.shape[-2]
    if d not in HEAD_DIMS or g > MAX_GROUP:
        raise ValueError(f"{what} kernel takes head_dim in {HEAD_DIMS} and at most "
                         f"{MAX_GROUP} query heads per KV head; got D={d}, G={g}")
    if q.dtype != torch.float32 or lengths.dtype != torch.int32:
        raise TypeError(f"{what} kernel takes f32 queries and int32 lengths")
    if starts is not None and starts.dtype != torch.int32:
        raise TypeError(f"{what} kernel takes int32 starts")
    for t in (q, lengths, *payloads, *scales) + (() if starts is None else (starts,)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{what} kernel: every operand must lie on one CUDA device")
    for t in payloads:
        vec = 16 // t.element_size()
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(st % vec for st in t.stride()[:-1]):
            raise ValueError(f"{what} kernel needs unit stride along head_dim "
                             "and 16-byte aligned cache rows")
    for t in scales:
        if t.dtype != torch.float32:
            raise TypeError(f"{what} kernel takes f32 scale planes, got {t.dtype}")


def check_contiguous_rows(what: str, payloads, scales=()) -> None:
    """The walks stage whole runs of rows: along dim 2 (a page's slots, or a
    slot's positions) the stride must be the row length, and 1 for the
    scale planes, as in every cache and pool the engine builds."""
    for t in payloads:
        if t.stride(2) != t.shape[3]:
            raise ValueError(f"{what} kernel stages runs of rows: the row stride must be the row "
                             f"length {t.shape[3]}, got {t.stride(2)}")
    for t in scales:
        if t.stride(2) != 1:
            raise ValueError(f"{what} kernel stages runs of rows: the scale planes' row stride "
                             f"must be 1, got {t.stride(2)}")


def strides_arg(*tensors) -> ctypes.Array:
    """The (outer, head, position) strides of each tensor, in elements, as
    the C entry points take them."""
    return (ctypes.c_longlong * (3 * len(tensors)))(*[s for t in tensors for s in t.stride()[:3]])


def quant_payload_dim(kv_dtype: str, d: int) -> int:
    if kv_dtype not in PAYLOAD_DTYPES:
        raise ValueError(f"quantized decode walks take kv_dtype int8 or int4, got {kv_dtype!r}")
    return d // 2 if kv_dtype == "int4" else d


def _check_rows_per_slot(rows_per_slot: int, b: int, slots: int) -> None:
    if rows_per_slot < 1 or slots * rows_per_slot != b:
        raise ValueError(f"{b} query rows do not read {slots} slots at {rows_per_slot} rows a slot")


def decode_attention_kernel(q, k, v, lengths, starts=None, *, sm_scale=None, rows_per_slot=1):
    """Launch B3: q (B,Hkv,G,D) f32, k/v (B/R,Hkv,S,D) bf16 or f32 (any
    batch/head strides, contiguous rows along S, 16-byte aligned rows),
    R = ``rows_per_slot`` query rows a slot, lengths/starts (B,) int32 ->
    (out (B,Hkv,G,D), l, m (B,Hkv,G)), all f32."""
    refuse_autograd("decode_attention_kernel", q, k, v)
    b, hkv, g, d = q.shape
    s = k.shape[2]
    _check_rows_per_slot(rows_per_slot, b, k.shape[0])
    if k.shape[1:] != (hkv, s, d) or v.shape != k.shape:
        raise ValueError(f"decode attention shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if k.dtype not in (torch.bfloat16, torch.float32) or v.dtype != k.dtype:
        raise TypeError(f"decode attention kernel reads bf16 or f32 caches, got {k.dtype}/{v.dtype}")
    check_walk_operands("decode attention", q, lengths, starts, (k, v))
    check_contiguous_rows("decode attention", (k, v))
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
            int(rows_per_slot), float(sm_scale), build.stream_ptr(q.device))
    build.check(rc, "decode_attention_launch", "decode_attention")
    COUNTS.add("decode_attention")
    return out, l, m


def decode_attention_quant_kernel(q, k_q, k_scale, v_q, v_scale, lengths, starts=None, *,
                                  kv_dtype: str, sm_scale=None, rows_per_slot=1):
    """Launch B4: q (B,Hkv,G,D) f32; k_q/v_q the packed payload (B/R,Hkv,S,Dp),
    int8 (Dp = D) or uint8 int4 nibble pairs (Dp = D/2), strided as B3's
    cache; k_scale/v_scale (B/R,Hkv,S) f32, any batch/head strides, unit
    stride along S -> (out, l, m) as B3."""
    refuse_autograd("decode_attention_quant_kernel", q, k_scale, v_scale)
    b, hkv, g, d = q.shape
    s = k_q.shape[2]
    dp = quant_payload_dim(kv_dtype, d)
    _check_rows_per_slot(rows_per_slot, b, k_q.shape[0])
    if (k_q.shape[1:] != (hkv, s, dp) or v_q.shape != k_q.shape
            or k_scale.shape != k_q.shape[:3] or v_scale.shape != k_scale.shape):
        raise ValueError(f"quantized decode attention shapes q {tuple(q.shape)} k {tuple(k_q.shape)} "
                         f"v {tuple(v_q.shape)} scales {tuple(k_scale.shape)}/{tuple(v_scale.shape)}")
    if k_q.dtype != PAYLOAD_DTYPES[kv_dtype] or v_q.dtype != k_q.dtype:
        raise TypeError(f"{kv_dtype} payload must be {PAYLOAD_DTYPES[kv_dtype]}, got {k_q.dtype}/{v_q.dtype}")
    check_walk_operands("quantized decode attention", q, lengths, starts, (k_q, v_q),
                        (k_scale, v_scale))
    check_contiguous_rows("quantized decode attention", (k_q, v_q), (k_scale, v_scale))
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    q = q.contiguous()
    lengths = lengths.contiguous()
    out = torch.empty((b, hkv, g, d), dtype=torch.float32, device=q.device)
    l = torch.empty((b, hkv, g), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hkv, g), dtype=torch.float32, device=q.device)
    fn = build.function("decode_attention", "decode_attention_quant_launch", _QUANT_ARGS)
    rc = fn(q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(), v_q.data_ptr(), v_scale.data_ptr(),
            lengths.data_ptr(), None if starts is None else starts.contiguous().data_ptr(),
            out.data_ptr(), l.data_ptr(), m.data_ptr(), b, hkv, g, s, d,
            int(kv_dtype == "int4"), strides_arg(k_q, v_q, k_scale, v_scale),
            int(rows_per_slot), float(sm_scale), build.stream_ptr(q.device))
    build.check(rc, "decode_attention_quant_launch", "decode_attention")
    COUNTS.add("decode_attention_quant")
    return out, l, m


def decode_attention(
    q: torch.Tensor,  # (B, H, D)
    k: torch.Tensor,  # (B, Hkv, S, D), or the packed payload (B, Hkv, S, Dp)
    v: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int32
    starts: Optional[torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
    return_stats: bool = False,
    k_scales: Optional[torch.Tensor] = None,  # (B, Hkv, S) f32 — quantized cache
    v_scales: Optional[torch.Tensor] = None,
    kv_dtype: str = "fp",
    rows_per_slot: int = 1,
):
    """Attention of one query token per sequence over a masked KV cache;
    ``kv_dtype`` int8/int4 (with the scale planes) reads a quantized cache.
    ``return_stats=True`` also returns the softmax stats (l, m), each
    (B, H, 1) f32, with the output left in f32, for ``_merge_new_token``.
    With ``rows_per_slot`` R > 1, q holds R rows for each of the cache's
    B/R slots (row b reads slot b // R, over its own length): a
    speculative verify block in one launch."""
    b, h, d = q.shape
    hkv = k.shape[1]
    qg = q.float().reshape(b, hkv, h // hkv, d)
    if kv_dtype != "fp" and (k_scales is None or v_scales is None):
        raise ValueError("a quantized cache needs its scale planes")
    if not q.is_cuda and rows_per_slot > 1:  # the plain walk: each row its own slot
        k, v = k.repeat_interleave(rows_per_slot, 0), v.repeat_interleave(rows_per_slot, 0)
        if kv_dtype != "fp":
            k_scales = k_scales.repeat_interleave(rows_per_slot, 0)
            v_scales = v_scales.repeat_interleave(rows_per_slot, 0)
    if kv_dtype != "fp":
        if q.is_cuda:
            out, l, m = decode_attention_quant_kernel(
                qg, k, k_scales, v, v_scales, lengths, starts, kv_dtype=kv_dtype,
                sm_scale=sm_scale, rows_per_slot=rows_per_slot)
        else:
            out, l, m = decode_attention_quant_reference(
                qg, k, k_scales, v, v_scales, lengths, starts, kv_dtype=kv_dtype,
                sm_scale=sm_scale)
    elif q.is_cuda:
        out, l, m = decode_attention_kernel(qg, k, v, lengths, starts, sm_scale=sm_scale,
                                            rows_per_slot=rows_per_slot)
    else:
        out, l, m = decode_attention_reference(qg, k, v, lengths, starts, sm_scale=sm_scale)
    if return_stats:
        return out.reshape(b, h, d), l.reshape(b, h, 1), m.reshape(b, h, 1)
    return out.reshape(b, h, d).to(q.dtype)
