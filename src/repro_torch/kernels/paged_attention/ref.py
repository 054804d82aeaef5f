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
state per rank, merged in rank order.  Only the tests use it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.decode_attention.ref import NEG_INF, decode_attention_reference
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


def rank_ranges(starts: torch.Tensor, lengths: torch.Tensor, bs: int, ranks: int,
                capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The positions [lo, hi) that each rank of the kernels' cluster walks,
    each (ranks, B) int64 (empty where hi <= lo): the pages that hold
    [start, length) split evenly among the ranks in page order, whole pages
    each, as ``rank_pages`` in ``csrc/paged_walk.cuh``.  A function of
    (start, length, bs) alone; lengths are clipped to the table's
    ``capacity`` and starts to 0, as the kernels clip them."""
    length = lengths.long().clamp(max=capacity)
    start = starts.long().clamp(min=0)
    p0 = start // bs
    n = torch.where(length > start, (length + bs - 1) // bs - p0, torch.zeros_like(p0))
    per = (n + ranks - 1) // ranks
    first = p0 + torch.arange(ranks)[:, None] * per
    npg = torch.minimum(per, p0 + n - first).clamp(min=0)
    return torch.maximum(start, first * bs), torch.minimum(length, (first + npg) * bs)


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
    split the walk: each rank's (m, l, acc) over its range of
    ``rank_ranges``, merged in rank order (m the largest, l and acc each
    rank's scaled by exp(m_rank - m))."""
    k, v = gather_pages(k_pages, block_tables), gather_pages(v_pages, block_tables)
    if kv_dtype != "fp":
        k = dequantize_kv(k, gather_scales(k_scales, block_tables), kv_dtype)
        v = dequantize_kv(v, gather_scales(v_scales, block_tables), kv_dtype)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if starts is None:
        starts = torch.zeros_like(lengths)
    scores = torch.einsum("bhgd,bhsd->bhgs", q.float(), k.float()) * sm_scale
    pos = torch.arange(k.shape[2])[None, :]
    lo, hi = rank_ranges(starts, lengths, k_pages.shape[2], ranks, k.shape[2])
    ms, ls, accs = [], [], []
    for r in range(ranks):
        mask = ((pos >= lo[r][:, None]) & (pos < hi[r][:, None]))[:, None, None, :]
        s = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        m_r = s.amax(dim=-1)
        p = torch.where(mask, torch.exp(s - m_r[..., None]), torch.zeros_like(s))
        ms.append(m_r)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhgs,bhsd->bhgd", p, v.float()))
    m = torch.stack(ms).amax(dim=0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(accs[0])
    for m_r, l_r, acc_r in zip(ms, ls, accs):
        f = torch.exp(m_r - m)
        l = l + l_r * f
        acc = acc + acc_r * f[..., None]
    return acc / torch.clamp(l, min=1e-30)[..., None], l, m
