"""Gradient compression for the cross-pod reduction, with error feedback:
the port of ``repro.optim.compression``.

Each rank of an axis group quantizes (grad + carried error) per tensor to
int8, all-gathers the int8 payload and its f32 scale over the group (a
quarter of f32's bytes on the wire), dequantizes and averages locally, and
carries the quantization residual into the next step (1-bit-Adam style).
JAX runs it inside ``shard_map`` over the pod axis; here every rank is a
process and the gathers are explicit (``layers.collectives``).
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import numpy as np
import torch

from repro_torch.common.tree import named_leaves, tree_map, tree_map_with_path_names
from repro_torch.layers import collectives as C

# f32(1/127) and f32(1e-12): XLA turns the JAX package's ``absmax / 127.0 +
# 1e-12`` into one fused multiply-add by the reciprocal
_INV_127 = float(np.float32(1.0 / 127.0))
_EPS = float(np.float32(1e-12))


def _quant_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor int8: (q int8, scale f32 0-d) with x ~= q * scale.  The
    scale is what ``jax.jit`` of the JAX ``_quant_int8`` stores,
    ``fma(absmax, f32(1/127), f32(1e-12))`` (the product exact in f64, one
    rounding to f32); then a true f32 division, rounded half to even."""
    xf = x.float()
    absmax = xf.abs().amax()
    scale = (absmax.double() * _INV_127 + _EPS).float()
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_mean_over_axis(grads: Any, err: Any, mesh, axis) -> Tuple[Any, Any]:
    """The mean of ``grads`` over mesh axis ``axis`` in the int8 wire
    format: (the mean in each leaf's dtype, the new error feedback f32).
    Every rank of the axis group calls it with its own gradients."""
    group = mesh.group(axis)
    n = torch.distributed.get_world_size(group)
    errs = dict(named_leaves(err))
    means, new_errs = {}, {}
    for name, g in named_leaves(grads):  # JAX's leaf order, the same on every rank
        g32 = g.float() + errs[name]
        q, scale = _quant_int8(g32)
        # the residual, carried to the next step: XLA fuses it into one
        # multiply-add, fma(-q, scale, g32) (the product exact in f64)
        new_errs[name] = (g32.double() - q.double() * scale.double()).float()
        q_all = C.all_gather(q[None], group, dim=0)  # (n, ...) int8: the wire's payload
        s_all = C.all_gather(scale.reshape(1), group, dim=0)  # (n,) f32
        means[name] = (torch.tensordot(s_all, q_all.float(), dims=([0], [0])) / n).to(g.dtype)
    return (tree_map_with_path_names(lambda name, _: means[name], grads),
            tree_map_with_path_names(lambda name, _: new_errs[name], grads))


def init_error_feedback(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compressed_dp_grads(loss_fn: Callable, mesh, *, pod_axis: str = "pod") -> Callable:
    """DDP-style compressed data parallelism over ``pod_axis``: returns
    ``grads_fn(params, err, batch) -> (loss_mean, grads_mean, err)``.  Every
    rank calls it with the whole batch (a tree of tensors with the rows on
    dim 0) and differentiates its rows with autograd; the pod ranks' mean
    gradient goes over the int8 wire with error feedback, and the loss is
    their mean (JAX's ``pmean``)."""
    from repro_torch.train.trainer import loss_and_grads

    group = mesh.group(pod_axis)
    k, i = mesh.shape[pod_axis], mesh.coordinate(pod_axis)

    def rows(x):
        if x.shape[0] % k:
            raise ValueError(f"{x.shape[0]} rows do not split over {k} {pod_axis} ranks")
        per = x.shape[0] // k
        return x[i * per:(i + 1) * per]

    def grads_fn(params, err, batch):
        loss, _, grads = loss_and_grads(lambda p, b: (loss_fn(p, b), {}), params,
                                        tree_map(rows, batch))
        mean, err = compressed_mean_over_axis(grads, err, mesh, pod_axis)
        return C.all_reduce(loss, group) / k, mean, err

    return grads_fn
