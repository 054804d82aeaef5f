"""Rotary position embeddings (llama convention: rotate-half).

Projected q/k are (batch, seq, heads, head_dim); positions are (batch, seq).
"""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int -> same shape, rotated."""
    d = x.shape[-1]
    inv = rope_frequencies(d, theta, x.device)
    ang = positions[:, :, None, None].float() * inv  # (B, S, 1, D/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1 = x[..., : d // 2].float()
    x2 = x[..., d // 2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
