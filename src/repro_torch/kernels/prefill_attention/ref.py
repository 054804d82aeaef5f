"""Plain PyTorch version of the prefill attention kernel."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def prefill_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                sm_scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention, q (B,H,S,D), k/v (B,Hkv,S,D), head h reading KV head
    h // (H/Hkv); scores in f32 (f64 for f64 operands) masked with -1e30;
    output in q's dtype."""
    b, h, s, d = q.shape
    g = h // k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    kk = k.repeat_interleave(g, dim=1) if g > 1 else k
    vv = v.repeat_interleave(g, dim=1) if g > 1 else v
    ct = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), kk.to(ct)) * sm_scale
    pos = torch.arange(s, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv.to(ct)).to(q.dtype)
