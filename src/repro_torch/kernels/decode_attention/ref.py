"""Plain PyTorch versions of the decode attention kernels (B3, B4).

They follow the kernel, not the JAX package's jnp streaming path: K/V are
upcast to f32 and q stays f32 (the jnp path casts q *down* to the cache
dtype, ``repro/kernels/decode_attention/ops.py``; the Pallas kernel, which
is what the serving path runs, does not).

``decode_attention_split_reference`` computes the same function the way the
CUDA walk splits it (``csrc/paged_walk.cuh``): the virtual pages of
``SLOT_PAGE`` rows holding [start, length) shared evenly among the ranks of
a cluster, one softmax state per rank, merged in rank order.  Only the
tests use it and ``rank_ranges``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.quant.kv_quant import dequantize_kv

NEG_INF = -1e30
SLOT_PAGE = 16  # rows of a contiguous slot's virtual page in the CUDA walk (kSlotPage)


def decode_attention_reference(
    q: torch.Tensor,  # (B, Hkv, G, D)
    k: torch.Tensor,  # (B, Hkv, S, D), any float dtype
    v: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int
    starts: Optional[torch.Tensor] = None,  # (B,) int window start
    *,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out (B,Hkv,G,D) f32 normalized, l (B,Hkv,G) f32, m (B,Hkv,G)
    f32) over positions [starts, lengths).  An empty range gives out 0,
    l 0 and m -1e30."""
    d = q.shape[-1]
    s = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if starts is None:
        starts = torch.zeros_like(lengths)
    scores = torch.einsum("bhgd,bhsd->bhgs", q.float(), k.float()) * sm_scale
    pos = torch.arange(s, device=q.device)[None, :]
    mask = ((pos < lengths[:, None]) & (pos >= starts[:, None]))[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v.float()) / torch.clamp(l, min=1e-30)
    return out, l[..., 0], m[..., 0]


def decode_attention_quant_reference(
    q: torch.Tensor,  # (B, Hkv, G, D)
    k_q: torch.Tensor,  # (B, Hkv, S, Dp) packed payload
    k_scale: torch.Tensor,  # (B, Hkv, S) f32
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    lengths: torch.Tensor,
    starts: Optional[torch.Tensor] = None,
    *,
    kv_dtype: str,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The quantized walk's plain version: dequantize, then the plain walk
    above (the JAX package's jnp path does the same)."""
    k = dequantize_kv(k_q, k_scale, kv_dtype)
    v = dequantize_kv(v_q, v_scale, kv_dtype)
    return decode_attention_reference(q, k, v, lengths, starts, sm_scale=sm_scale)


def rank_ranges(starts: torch.Tensor, lengths: torch.Tensor, bs: int, ranks: int,
                capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The positions [lo, hi) that each rank of the kernels' cluster walks,
    each (ranks, B) int64 (empty where hi <= lo): the pages of ``bs`` rows
    that hold [start, length) split evenly among the ranks in page order,
    whole pages each, as ``rank_pages`` in ``csrc/paged_walk.cuh``.  A
    function of (start, length, bs) alone; lengths are clipped to the
    ``capacity`` (a table's P * bs, or a slot's S, which need not be whole
    pages) and starts to 0, as the kernels clip them."""
    length = lengths.long().clamp(max=capacity)
    start = starts.long().clamp(min=0)
    p0 = start // bs
    n = torch.where(length > start, (length + bs - 1) // bs - p0, torch.zeros_like(p0))
    per = (n + ranks - 1) // ranks
    first = p0 + torch.arange(ranks)[:, None] * per
    npg = torch.minimum(per, p0 + n - first).clamp(min=0)
    return torch.maximum(start, first * bs), torch.minimum(length, (first + npg) * bs)


def decode_attention_split_reference(
    q: torch.Tensor,  # (B, Hkv, G, D)
    k: torch.Tensor,  # (B, Hkv, S, D), or the packed payload (B, Hkv, S, Dp)
    v: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int32
    starts: Optional[torch.Tensor] = None,
    *,
    ranks: int,
    bs: int = SLOT_PAGE,
    sm_scale: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,  # (B, Hkv, S) f32 — quantized cache
    v_scales: Optional[torch.Tensor] = None,
    kv_dtype: str = "fp",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, l, m) as the plain versions above, computed as the kernels
    split the walk: each rank's (m, l, acc) over its range of
    ``rank_ranges`` in pages of ``bs`` rows, merged in rank order (m the
    largest, l and acc each rank's scaled by exp(m_rank - m))."""
    if kv_dtype != "fp":
        k = dequantize_kv(k, k_scales, kv_dtype)
        v = dequantize_kv(v, v_scales, kv_dtype)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if starts is None:
        starts = torch.zeros_like(lengths)
    scores = torch.einsum("bhgd,bhsd->bhgs", q.float(), k.float()) * sm_scale
    pos = torch.arange(k.shape[2])[None, :]
    lo, hi = rank_ranges(starts, lengths, bs, ranks, k.shape[2])
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
