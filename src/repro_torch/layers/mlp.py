"""Dense FFN: SwiGLU (llama family, hymba) or the GELU MLP (whisper)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.layers import collectives as C
from repro_torch.layers.linear import (
    linear_apply,
    linear_apply_row_parallel,
    linear_apply_train_sharded,
    linear_init,
)
from repro_torch.layers.sharding import NULL_CTX, PartitionCtx


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
              training: bool = False, pctx: PartitionCtx = NULL_CTX) -> torch.Tensor:
    """The FFN of x (..., d).  On a mesh (``pctx``, SwiGLU) w_gate and w_up
    are column-parallel (this rank's d_ff / tp columns) and w_down is
    row-parallel over them: the ranks sum its partial products.  In
    training on a mesh each weight is also gathered over data
    (``linear_apply_train_sharded``), and so is the GELU MLP's (whisper):
    w_in column-parallel with its bias's columns, w_out row-parallel, its
    bias added once the ranks' partial products are summed."""
    if cfg.act == "silu" and training and pctx.mesh is not None:
        x = C.copy_to_tp(x, pctx.mesh.group(pctx.axes.tp))
        g, u = (linear_apply_train_sharded(params[n], x, cfg.quant, pctx, parallel="column")
                for n in ("w_gate", "w_up"))
        h = F.silu(g.float()).to(x.dtype) * u
        return linear_apply_train_sharded(params["w_down"], h, cfg.quant, pctx, parallel="row")
    if cfg.act == "silu":
        g = linear_apply(params["w_gate"], x, cfg.quant, training=training)
        u = linear_apply(params["w_up"], x, cfg.quant, training=training)
        h = F.silu(g.float()).to(x.dtype) * u
        if pctx.mesh is not None:
            return linear_apply_row_parallel(params["w_down"], h, cfg.quant,
                                             pctx.mesh.group(pctx.axes.tp))
        return linear_apply(params["w_down"], h, cfg.quant, training=training)
    if training and pctx.mesh is not None:  # column- and row-parallel, as SwiGLU
        x = C.copy_to_tp(x, pctx.mesh.group(pctx.axes.tp))
        h = linear_apply_train_sharded(params["w_in"], x, cfg.quant, pctx, parallel="column")
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        return linear_apply_train_sharded(params["w_out"], h, cfg.quant, pctx, parallel="row")
    if pctx.mesh is not None:
        raise NotImplementedError(f"{cfg.act} MLP on a serving mesh: the other families' "
                                  "prefill and decode on a mesh are ROADMAP A.13.11")
    h = linear_apply(params["w_in"], x, cfg.quant, training=training)
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return linear_apply(params["w_out"], h, cfg.quant, training=training)
