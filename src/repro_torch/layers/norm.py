"""RMSNorm (f32 statistics, cast back to the input dtype)."""
from __future__ import annotations

import torch


def rmsnorm_init(d: int, device=None) -> dict:
    return {"scale": torch.ones((d,), device=device)}


def apply_norm(params: dict, x: torch.Tensor, kind: str = "rmsnorm", eps: float = 1e-5) -> torch.Tensor:
    if kind != "rmsnorm":
        raise NotImplementedError(
            f"norm {kind!r}: the port serves RMSNorm models (LayerNorm: ROADMAP A.6)")
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["scale"].float()
    return y.to(x.dtype)


def apply_norm_blocks(params: dict, x: torch.Tensor, kind: str = "rmsnorm",
                      eps: float = 1e-5) -> torch.Tensor:
    """``apply_norm`` of a verify block x (B, W, d), its statistics taken one
    block column at a time: each mean runs over B rows, as in a decode
    round.  On a card torch picks a reduction's thread layout from the
    number of rows, so a row summed among 4 rows and among 20 can round
    apart, and a rounding there can move an int8 activation; this way every
    block row is normalized exactly as decode normalizes it."""
    if kind != "rmsnorm":
        raise NotImplementedError(
            f"norm {kind!r}: the port serves RMSNorm models (LayerNorm: ROADMAP A.6)")
    xf = x.float()
    sq = xf * xf
    var = torch.stack([sq[:, i].mean(dim=-1, keepdim=True) for i in range(x.shape[1])], dim=1)
    y = xf * torch.rsqrt(var + eps) * params["scale"].float()
    return y.to(x.dtype)
