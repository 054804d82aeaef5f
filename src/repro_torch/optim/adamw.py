"""AdamW over parameter trees: the port of ``repro.optim.adamw``.

The moments live in f32 beside the parameters, in the parameters' tree
layout.  The update runs in place, leaf by leaf (the parameters and both
moments), so a step holds no second copy of the model.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.common.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32, 0-d
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the leaves' squared sums, added in JAX's leaf order (dict
    keys sorted), in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves(tree)))


def adamw_update(grads, state: AdamWState, params, lr,
                 cfg: AdamWConfig = AdamWConfig()) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step with global-norm clipping, in place: ``params``,
    ``state.mu`` and ``state.nu`` are updated and returned, with the new
    step count and {"grad_norm"}.  Decoupled weight decay applies to every
    leaf of two or more dims: on layer-stacked trees that includes the
    stacked (L, d) norm scales and (L, n) biases, and leaves out ``ln_f``
    (d,), as in the JAX package.  The bias corrections are f32, and each
    parameter is updated as ``(p.float() - lr * delta).to(p.dtype)``."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=step.device),
                        step.float())
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=step.device),
                        step.float())
    lr = torch.as_tensor(lr, dtype=torch.float32, device=step.device)

    def upd(g, m, v, p):
        g = g.float() * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)

    with torch.no_grad():
        tree_map(upd, grads, state.mu, state.nu, params)
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm}
