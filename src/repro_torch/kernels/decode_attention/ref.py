"""Plain PyTorch version of the decode attention kernel.

It follows the kernel, not the JAX package's jnp streaming path: K/V are
upcast to f32 and q stays f32 (the jnp path casts q *down* to the cache
dtype, ``repro/kernels/decode_attention/ops.py``; the Pallas kernel, which
is what the serving path runs, does not).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.quant.kv_quant import dequantize_kv

NEG_INF = -1e30


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
