"""Dense FFN: SwiGLU (llama family, hymba) or the GELU MLP (whisper)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.linear import linear_apply, linear_init


def mlp_init(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    """SwiGLU weights for ``transformer.init``; the GELU MLP's (whisper)
    come from ``init_like_jax``."""
    if cfg.act != "silu":
        raise ValueError(f"act {cfg.act!r}: mlp_init draws SwiGLU weights")
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": linear_init(gen, d, f, device=device),
        "w_up": linear_init(gen, d, f, device=device),
        "w_down": linear_init(gen, f, d, scale=1.0 / f**0.5, device=device),
    }


def mlp_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              training: bool = False) -> torch.Tensor:
    if cfg.act == "silu":
        g = linear_apply(params["w_gate"], x, cfg.quant, training=training)
        u = linear_apply(params["w_up"], x, cfg.quant, training=training)
        h = F.silu(g.float()).to(x.dtype) * u
        return linear_apply(params["w_down"], h, cfg.quant, training=training)
    h = linear_apply(params["w_in"], x, cfg.quant, training=training)
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return linear_apply(params["w_out"], h, cfg.quant, training=training)
