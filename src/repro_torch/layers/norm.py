"""RMSNorm (f32 statistics, cast back to the input dtype)."""
from __future__ import annotations

import torch


def rmsnorm_init(d: int, device=None) -> dict:
    return {"scale": torch.ones((d,), device=device)}


def apply_norm(params: dict, x: torch.Tensor, kind: str = "rmsnorm", eps: float = 1e-5) -> torch.Tensor:
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r}: the port serves RMSNorm models (ROADMAP A12)")
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["scale"].float()
    return y.to(x.dtype)
