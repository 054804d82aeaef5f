"""AdamW over parameter trees: the port of ``repro.optim.adamw``.

The moments live in f32 beside the parameters, in the parameters' tree
layout.  The update runs in place, leaf by leaf (the parameters and both
moments), so a step holds no second copy of the model.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch
import torch.distributed as dist

from repro_torch.common.tree import leaves, named_leaves, tree_map
from repro_torch.layers import collectives as C


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


def global_norm(tree, mesh=None, replicated=None) -> torch.Tensor:
    """sqrt of the leaves' squared sums, added in JAX's leaf order (dict
    keys sorted), in f32.

    Over the shards of a mesh (``mesh``; ``replicated`` maps each leaf's
    name to the mesh axes it is replicated on) each element counts once: a
    leaf's squares are summed only on the ranks at coordinate 0 of every
    axis it is replicated on, and the ranks' sums are summed over the
    world.  On a world of one that is the unsharded sum, bit for bit."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves(tree)))
    own = [g for name, g in named_leaves(tree)
           if all(mesh.coordinate(a) == 0 for a in replicated[name])]
    total = sum(torch.sum(torch.square(g.float())) for g in own)
    if not own:
        total = torch.zeros((), dtype=torch.float32, device=leaves(tree)[0].device)
    if mesh.size > 1:
        total = C.all_reduce(total, dist.group.WORLD)
    return torch.sqrt(total)


def adamw_update(grads, state: AdamWState, params, lr,
                 cfg: AdamWConfig = AdamWConfig(), *, norm=global_norm) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step with global-norm clipping, in place: ``params``,
    ``state.mu`` and ``state.nu`` are updated and returned, with the new
    step count and {"grad_norm"}.  Decoupled weight decay applies to every
    leaf of two or more dims: on layer-stacked trees that includes the
    stacked (L, d) norm scales and (L, n) biases, and leaves out ``ln_f``
    (d,), as in the JAX package.  The bias corrections are f32, and each
    parameter is updated as ``(p.float() - lr * delta).to(p.dtype)``.  A
    shard keeps its leaf's dims, so the rule holds on a mesh's slices.
    ``norm`` takes the gradients' global norm
    (``global_norm``; on a mesh its sharded form)."""
    gnorm = norm(grads)
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
