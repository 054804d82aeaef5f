"""Dense SwiGLU FFN (llama family)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.linear import linear_apply, linear_init


def mlp_init(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act != "silu":
        raise NotImplementedError(
            f"act {cfg.act!r}: the port serves SwiGLU models (the GELU MLP: ROADMAP A.6)")
    return {
        "w_gate": linear_init(gen, d, f, device=device),
        "w_up": linear_init(gen, d, f, device=device),
        "w_down": linear_init(gen, f, d, scale=1.0 / f**0.5, device=device),
    }


def mlp_apply(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    g = linear_apply(params["w_gate"], x, cfg.quant)
    u = linear_apply(params["w_up"], x, cfg.quant)
    h = F.silu(g.float()).to(x.dtype) * u
    return linear_apply(params["w_down"], h, cfg.quant)
