"""Plain PyTorch versions of the paged decode walks (B5, B6).

Each gathers a sequence's pages into the dense (B, Hkv, P*bs, ·) view its
block table describes and calls the contiguous plain walk: page ``i``
covers positions ``[i*bs, (i+1)*bs)``, so every token lands at the index
the contiguous cache would hold it at, and there is one implementation of
the softmax math.  Table entries are clipped to [0, N-1], as the kernels
clip them.

``paged_decode_attention_split_reference`` computes the same function the
way the kernels split it (``csrc/paged_walk.cuh``): the pages holding
[start, length) shared evenly among the ranks of a cluster, one softmax
state per rank, merged in rank order (``decode_attention_split_reference``
over the gathered view).  Only the tests use it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.decode_attention.ref import (
    decode_attention_reference,
    decode_attention_split_reference,
)
from repro_torch.quant.kv_quant import dequantize_kv


def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """(N, Hkv, bs, D) pages + (B, P) tables -> dense (B, Hkv, P*bs, D)."""
    b, p = block_tables.shape
    n, hkv, bs, d = pages.shape
    g = pages[block_tables.long().clamp(0, n - 1)]  # (B, P, Hkv, bs, D)
    return g.transpose(1, 2).reshape(b, hkv, p * bs, d)


def gather_scales(scales: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """(N, Hkv, bs) scale planes + (B, P) tables -> dense (B, Hkv, P*bs)."""
    b, p = block_tables.shape
    n, hkv, bs = scales.shape
    g = scales[block_tables.long().clamp(0, n - 1)]  # (B, P, Hkv, bs)
    return g.transpose(1, 2).reshape(b, hkv, p * bs)


def paged_decode_attention_reference(
    q: torch.Tensor,  # (B, Hkv, G, D)
    k_pages: torch.Tensor,  # (N, Hkv, bs, D), one layer's pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, P) int32
    lengths: torch.Tensor,  # (B,) int32
    starts: Optional[torch.Tensor] = None,
    *,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B5's plain version: (out, l, m) as ``decode_attention_reference``."""
    k = gather_pages(k_pages, block_tables)
    v = gather_pages(v_pages, block_tables)
    return decode_attention_reference(q, k, v, lengths, starts, sm_scale=sm_scale)


def paged_decode_attention_quant_reference(
    q: torch.Tensor,  # (B, Hkv, G, D)
    k_pages_q: torch.Tensor,  # (N, Hkv, bs, Dp) packed payload pool
    k_scales: torch.Tensor,  # (N, Hkv, bs) f32
    v_pages_q: torch.Tensor,
    v_scales: torch.Tensor,
    block_tables: torch.Tensor,
    lengths: torch.Tensor,
    starts: Optional[torch.Tensor] = None,
    *,
    kv_dtype: str,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B6's plain version: gather the packed pages and their scales,
    dequantize the dense view, then the plain walk."""
    k = dequantize_kv(gather_pages(k_pages_q, block_tables),
                      gather_scales(k_scales, block_tables), kv_dtype)
    v = dequantize_kv(gather_pages(v_pages_q, block_tables),
                      gather_scales(v_scales, block_tables), kv_dtype)
    return decode_attention_reference(q, k, v, lengths, starts, sm_scale=sm_scale)


def paged_decode_attention_split_reference(
    q: torch.Tensor,  # (B, Hkv, G, D)
    k_pages: torch.Tensor,  # (N, Hkv, bs, D), or packed (N, Hkv, bs, Dp)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, P) int32
    lengths: torch.Tensor,  # (B,) int32
    starts: Optional[torch.Tensor] = None,
    *,
    ranks: int,
    sm_scale: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,  # (N, Hkv, bs) f32 — quantized pool
    v_scales: Optional[torch.Tensor] = None,
    kv_dtype: str = "fp",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, l, m) as the plain versions above, computed as the kernels
    split the walk: the gathered dense view walked by
    ``decode_attention_split_reference`` in pages of the pool's ``bs``."""
    k, v = gather_pages(k_pages, block_tables), gather_pages(v_pages, block_tables)
    if kv_dtype != "fp":
        k_scales, v_scales = (gather_scales(s, block_tables) for s in (k_scales, v_scales))
    return decode_attention_split_reference(
        q, k, v, lengths, starts, ranks=ranks, bs=k_pages.shape[2], sm_scale=sm_scale,
        k_scales=k_scales, v_scales=v_scales, kv_dtype=kv_dtype)
