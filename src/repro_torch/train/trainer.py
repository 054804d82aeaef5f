"""The train step: microbatch accumulation, remat, AdamW, FSDP x TP on a
mesh of processes — the port of ``repro.train.trainer``.

It runs eagerly: each call computes the loss and its gradients with
autograd over the plain paths (no kernel is on the training path) and
updates the parameters and moments in place.

On a mesh (``launch.mesh.Mesh``) every rank holds its FSDP x TP slice of
the parameters and moments (``shard_params(train=True)``: the big dim of
every weight over ``data``; heads, d_ff and vocabulary over ``model``) and
runs the same step on its rows of the global batch.  The collectives are
explicit and carry gradients (``layers.collectives``): a weight is
gathered over data where it is used and its gradient reduce-scattered
back, summed over the data ranks' batches; the gradients of leaves
replicated over a batch axis (norms and biases over ``data``, every leaf
over ``pod``) are all-reduced after backward.  That is JAX's
``jit_train_step`` with its FSDP x TP in/out shardings: the step takes the
global batch and returns params, opt and metrics, each rank's slices
updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch import resolve_device
from repro_torch.common.tree import named_leaves, tree_map, tree_map_with_path_names
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding_rules import leaf_specs, shard_params
from repro_torch.layers import collectives as C
from repro_torch.layers.sharding import NULL_CTX, TRAIN_RULES, PartitionCtx, _axes_of
from repro_torch.models.jax_init import init_like_jax
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import batch_rows, check_mesh_model
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_init, adamw_update, global_norm
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


def train_pctx(mesh) -> PartitionCtx:
    """The training rules (``TRAIN_RULES``) on ``mesh``: batch over the dp
    axes (``("pod", "data")`` on the multi-pod mesh), heads, d_ff and
    vocabulary over ``model``, the params' big dim over ``data``.  No mesh:
    ``NULL_CTX``."""
    if mesh is None:
        return NULL_CTX
    from repro_torch.core.phase_engine import _mesh_axes

    return PartitionCtx(mesh=mesh, axes=_mesh_axes(mesh), rules=dict(TRAIN_RULES))


def _group_over(mesh, axes):
    """The process group of ``axes``, taken in the mesh's order."""
    axes = tuple(a for a in mesh.axis_names if a in axes)
    return mesh.group(axes if len(axes) > 1 else axes[0])


def local_rows(pctx: PartitionCtx, batch: dict) -> dict:
    """This data rank's rows of a global ``batch`` (``batch_rows`` of every
    leaf's dim 0); the batch axes must divide the rows."""
    if pctx.mesh is None:
        return batch
    n = next(iter(batch.values())).shape[0]
    k = pctx.size(pctx.axes.dp)
    if n % k:
        raise ValueError(f"a batch of {n} rows does not split over the {k} ranks of the batch "
                         f"axes {pctx.axes.dp}")
    lo, hi = batch_rows(pctx, n)
    return {key: v[lo:hi] for key, v in batch.items()}


def reduce_dp_grads(grads, pctx: PartitionCtx, replicated: Dict[str, tuple]):
    """SUM, in place, each leaf's gradient over the batch axes the leaf is
    replicated on (``replicated``: leaf name -> mesh axes).  An FSDP leaf's
    gradient was reduce-scattered over data in backward already."""
    dp = _axes_of(pctx.axes.dp)
    for name, g in named_leaves(grads):
        axes = tuple(a for a in dp if a in replicated[name])
        if axes and pctx.size(axes) > 1:
            g.copy_(C.all_reduce(g, _group_over(pctx.mesh, axes)))
    return grads


def replicated_axes(params, cfg: ModelConfig, mesh) -> Dict[str, tuple]:
    """Each leaf's name -> the mesh axes its slice is replicated on."""
    return {name: tuple(a for a in mesh.axis_names
                        if a not in {x for ax in spec for x in _axes_of(ax)})
            for name, spec in leaf_specs(params, cfg, mesh, train=True).items()}


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


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None) -> Callable:
    """Returns train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics): params and moments updated in place; metrics
    "loss", "lr", the loss function's scalar metrics (only "nll" under
    microbatches, as in the JAX package) and "grad_norm", 0-d tensors.

    On a ``mesh`` the params and moments are this rank's slices
    (``init_train_state(mesh=)``) and ``batch`` is the global batch, of
    which each rank takes its rows.  Microbatch i is JAX's, the global rows
    [i B/n, (i+1) B/n), each rank taking its rows of it, so each
    microbatch's mean runs over the same rows' mask as in JAX.  The loss
    and nll are summed over the batch axes: a rank's share is its rows' nll
    over the global mask sum; an MoE's aux loss too (its share of the
    whole batch's, ``layers.moe._aux_share``)."""
    api = get_model(cfg)
    sched = SCHEDULES[tcfg.schedule]
    pctx = train_pctx(mesh)
    kw = {} if mesh is None else {"pctx": pctx}
    if mesh is not None:
        check_mesh_model(cfg, pctx, train=True)
    replicated: Dict[str, tuple] = {}  # filled at the first step, from the slices' names

    def loss_of(params, batch):
        return api.loss_fn(params, batch, cfg, aux_weight=tcfg.aux_weight, **kw)

    def grads_of(params, batch):
        n = tcfg.microbatches
        if n <= 1:
            return loss_and_grads(loss_of, params, local_rows(pctx, batch))
        loss_sum = None
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
        for i in range(n):
            mb = {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)] for k, v in batch.items()}
            loss, _, grads = loss_and_grads(loss_of, params, local_rows(pctx, mb))
            acc = tree_map(lambda a, g: a + g.float(), acc, grads)
            loss_sum = loss if loss_sum is None else loss_sum + loss
        return loss_sum / n, {"nll": loss_sum / n}, tree_map(lambda g: g / n, acc)

    def sharded_norm(grads):
        return global_norm(grads, mesh, replicated)

    def train_step(params, opt_state: AdamWState, batch: dict, step):
        if mesh is not None and not replicated:
            replicated.update(replicated_axes(params, cfg, mesh))
        loss, metrics, grads = grads_of(params, batch)
        if mesh is not None:
            reduce_dp_grads(grads, pctx, replicated)
            dp = _axes_of(pctx.axes.dp)
            if pctx.size(dp) > 1:  # the ranks' shares of the global mean (and aux loss)
                group = _group_over(mesh, dp)
                shared = ("nll", "aux") if cfg.moe else ("nll",)
                loss = C.all_reduce(loss, group)
                metrics = {k: C.all_reduce(v, group) if k in shared else v
                           for k, v in metrics.items()}
        lr = sched(step, peak_lr=tcfg.lr, warmup=tcfg.warmup, total=tcfg.total_steps)
        params, opt_state, om = adamw_update(grads, opt_state, params, lr, tcfg.adamw,
                                             norm=global_norm if mesh is None else sharded_norm)
        out = {"loss": loss, "lr": lr, **{k: v for k, v in metrics.items() if v.dim() == 0}, **om}
        return params, opt_state, out

    return train_step


def init_train_state(cfg: ModelConfig, seed: int = 0, device=None,
                     dtype: torch.dtype = torch.float32, mesh=None) -> tuple[Any, AdamWState]:
    """(params, AdamW state) on ``device`` (CUDA by default): the weights
    of the JAX package's ``init(cfg, PRNGKey(seed), dtype)`` drawn by
    ``init_like_jax`` on that device (to float rounding; a card draws a
    full-width model in seconds, the CPU in minutes), zero moments, step 0.
    On a ``mesh`` (on its rank's device by default) the whole tree is
    drawn, this rank's ``shard_params(train=True)`` slice kept and the
    whole tree dropped; the moments are zeros of the slice's shapes and the
    step count is replicated."""
    dev = mesh.device if (mesh is not None and device is None) else resolve_device(device)
    if mesh is not None:
        check_mesh_model(cfg, train_pctx(mesh), train=True)
    params = init_like_jax(cfg, seed, dev, draw_device=dev, dtype=dtype)
    if mesh is not None:
        params = shard_params(params, cfg, mesh, train=True, device=dev)
    return params, adamw_init(params)
