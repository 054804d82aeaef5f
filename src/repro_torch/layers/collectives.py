"""The collectives a rank of a mesh calls on one mesh axis's group.

Each helper takes this rank's local tensor and a process group (one row
of the mesh: ``launch.mesh.Mesh.group(axis)``) and returns a new local
tensor.  They come in two forms, chosen by the group's backend in one
place (``form``):

* ``native`` (NCCL): the backend's own all-gather and all-to-all;
* ``portable`` (gloo): written with ``broadcast`` and ``all_reduce``
  alone, the two collectives gloo documents for CUDA tensors.  A gather
  or an exchange is one broadcast per rank of the group, so every rank
  receives the very bits that were sent.

Both forms return the same bits.  ``all_reduce`` (sum and max) and
``broadcast`` are native in both.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

FORMS = ("native", "portable")


def form(group) -> str:
    """The form of the helpers on ``group``: native under NCCL, portable
    (broadcast and all_reduce only) under any other backend."""
    return "native" if dist.get_backend(group) == "nccl" else "portable"


def _form(group, how: Optional[str]) -> str:
    how = how or form(group)
    if how not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {how!r}")
    return how


def _broadcast_each(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every group rank's ``x`` (same shape and dtype on each), in group
    order, by one broadcast from each rank."""
    me = dist.get_rank(group)
    out = []
    for i in range(dist.get_world_size(group)):
        buf = x if i == me else torch.empty_like(x)
        dist.broadcast(buf, src=dist.get_global_rank(group, i), group=group)
        out.append(buf)
    return out


def all_gather(x: torch.Tensor, group, *, dim: int, how: Optional[str] = None) -> torch.Tensor:
    """The group ranks' ``x`` concatenated along ``dim`` in group order."""
    x = x.contiguous()
    if _form(group, how) == "native":
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
    else:
        parts = _broadcast_each(x, group)
    return torch.cat(parts, dim=dim)


def all_to_all(x: torch.Tensor, group, *, split_dim: int, cat_dim: int,
               how: Optional[str] = None) -> torch.Tensor:
    """The exchange: ``x`` is cut into k equal chunks along ``split_dim``
    (k the group size), chunk j goes to group rank j, and the chunks this
    rank receives are concatenated along ``cat_dim`` in group order."""
    k = dist.get_world_size(group)
    if x.shape[split_dim] % k:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not split {k} ways")
    if _form(group, how) == "native":
        send = torch.stack(x.chunk(k, dim=split_dim))  # (k, ...): chunk j for rank j
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        return torch.cat(recv.unbind(0), dim=cat_dim)
    me = dist.get_rank(group)
    whole = _broadcast_each(x.contiguous(), group)
    return torch.cat([w.chunk(k, dim=split_dim)[me] for w in whole], dim=cat_dim)


def all_reduce(x: torch.Tensor, group, *, op: str = "sum") -> torch.Tensor:
    """The elementwise ``op`` ("sum" or "max") over the group ranks' ``x``,
    as a new tensor (``x`` is left as it was)."""
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    if op not in ops:
        raise ValueError(f"op must be 'sum' or 'max', got {op!r}")
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=ops[op], group=group)
    return y


def broadcast(x: torch.Tensor, group, *, src: int = 0) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank of the group (in place on
    ``src``'s tensor's copies; returned)."""
    x = x.contiguous()
    dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    return x
