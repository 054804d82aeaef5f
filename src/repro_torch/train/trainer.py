"""The train step: microbatch accumulation, remat, AdamW — the port of
``repro.train.trainer`` on one device.

The JAX package's mesh (FSDP x TP shardings, ``train_pctx``,
``jit_train_step``'s in/out shardings) is mesh tooling (ROADMAP A.10): the
port's step runs on one device.  It runs eagerly: each call computes the
loss and its gradients with autograd over the plain paths (no kernel is on
the training path) and updates the parameters and moments in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.common.tree import named_leaves, tree_map, tree_map_with_path_names
from repro_torch.configs.base import ModelConfig
from repro_torch.models.jax_init import init_like_jax
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_init, adamw_update
from repro_torch.optim.schedules import SCHEDULES


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    schedule: str = "cosine"  # cosine | wsd (minicpm)
    warmup: int = 100
    total_steps: int = 1000
    microbatches: int = 1
    adamw: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    aux_weight: float = 0.01


def loss_and_grads(loss_of: Callable, params, batch):
    """(loss, metrics, grads): the gradients of ``loss_of(params, batch)``
    with respect to every leaf of ``params`` (zeros where it has none).  The
    leaves are taken as fresh views that require grad, so ``params`` itself
    never does and serves as it is."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = loss_of(live, batch)
    names, flat = zip(*named_leaves(live))
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_name = {n: torch.zeros_like(p) if g is None else g for n, p, g in zip(names, flat, grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map_with_path_names(lambda name, _: by_name[name], live))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """Returns train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics): params and moments updated in place; metrics
    "loss", "lr", the loss function's scalar metrics (only "nll" under
    microbatches, as in the JAX package) and "grad_norm", 0-d tensors."""
    api = get_model(cfg)
    sched = SCHEDULES[tcfg.schedule]

    def loss_of(params, batch):
        return api.loss_fn(params, batch, cfg, aux_weight=tcfg.aux_weight)

    def grads_of(params, batch):
        n = tcfg.microbatches
        if n <= 1:
            return loss_and_grads(loss_of, params, batch)
        loss_sum = None
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
        for i in range(n):
            mb = {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)] for k, v in batch.items()}
            loss, _, grads = loss_and_grads(loss_of, params, mb)
            acc = tree_map(lambda a, g: a + g.float(), acc, grads)
            loss_sum = loss if loss_sum is None else loss_sum + loss
        return loss_sum / n, {"nll": loss_sum / n}, tree_map(lambda g: g / n, acc)

    def train_step(params, opt_state: AdamWState, batch: dict, step):
        loss, metrics, grads = grads_of(params, batch)
        lr = sched(step, peak_lr=tcfg.lr, warmup=tcfg.warmup, total=tcfg.total_steps)
        params, opt_state, om = adamw_update(grads, opt_state, params, lr, tcfg.adamw)
        out = {"loss": loss, "lr": lr, **{k: v for k, v in metrics.items() if v.dim() == 0}, **om}
        return params, opt_state, out

    return train_step


def init_train_state(cfg: ModelConfig, seed: int = 0, device=None,
                     dtype: torch.dtype = torch.float32) -> tuple[Any, AdamWState]:
    """(params, AdamW state) on ``device`` (CUDA by default): the weights
    of the JAX package's ``init(cfg, PRNGKey(seed), dtype)`` drawn by
    ``init_like_jax`` on that device (to float rounding; a card draws a
    full-width model in seconds, the CPU in minutes), zero moments, step 0."""
    dev = resolve_device(device)
    params = init_like_jax(cfg, seed, dev, draw_device=dev, dtype=dtype)
    return params, adamw_init(params)
