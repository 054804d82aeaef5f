"""RMSNorm / LayerNorm (f32 statistics, cast back to the input dtype)."""
from __future__ import annotations

import torch


def rmsnorm_init(d: int, device=None) -> dict:
    return {"scale": torch.ones((d,), device=device)}


def _normalize(params: dict, xf: torch.Tensor, kind: str, eps: float, mean) -> torch.Tensor:
    """The f32 normalization of ``xf`` given ``mean(t)``, the mean of ``t``
    over its last dim."""
    if kind == "rmsnorm":
        return xf * torch.rsqrt(mean(xf * xf) + eps) * params["scale"].float()
    if kind != "layernorm":
        raise ValueError(f"norm must be 'rmsnorm' or 'layernorm', got {kind!r}")
    # the population variance, as jnp.var: the mean square of the centred values
    centred = xf - mean(xf)
    y = centred * torch.rsqrt(mean(centred * centred) + eps)
    return y * params["scale"].float() + params["bias"].float()


def apply_norm(params: dict, x: torch.Tensor, kind: str = "rmsnorm", eps: float = 1e-5) -> torch.Tensor:
    y = _normalize(params, x.float(), kind, eps, lambda t: t.mean(dim=-1, keepdim=True))
    return y.to(x.dtype)


def apply_norm_blocks(params: dict, x: torch.Tensor, kind: str = "rmsnorm",
                      eps: float = 1e-5) -> torch.Tensor:
    """``apply_norm`` of a verify block x (B, W, d), its statistics taken one
    block column at a time: each mean runs over B rows, as in a decode
    round.  On a card torch picks a reduction's thread layout from the
    number of rows, so a row summed among 4 rows and among 20 can round
    apart, and a rounding there can move an int8 activation; this way every
    block row is normalized exactly as decode normalizes it."""

    def mean(t):
        return torch.stack([t[:, i].mean(dim=-1, keepdim=True) for i in range(t.shape[1])], dim=1)

    return _normalize(params, x.float(), kind, eps, mean).to(x.dtype)
