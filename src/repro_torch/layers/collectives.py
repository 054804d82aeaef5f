"""The collectives a rank of a mesh calls on one mesh axis's group.

Each helper takes this rank's local tensor and a process group (one row
of the mesh: ``launch.mesh.Mesh.group(axis)``) and returns a new local
tensor.  They come in two forms, chosen by the group's backend in one
place (``form``):

* ``native`` (NCCL): the backend's own all-gather and all-to-all;
* ``portable`` (gloo): written with ``broadcast`` and ``all_reduce``
  alone, the two collectives gloo documents for CUDA tensors.  A gather
  or an exchange is one broadcast per rank of the group (an exchange's
  carries the sender's chunks for the other ranks, not its own), so every
  rank receives the very bits that were sent.

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
    order, by one broadcast from each rank.  A broadcast counts as writing
    its buffer, also on the rank that sends, so this rank sends a copy:
    ``x`` may be a view that autograd forbids to modify (a layer of an
    unbound stack)."""
    me = dist.get_rank(group)
    out = []
    for i in range(dist.get_world_size(group)):
        buf = x.clone() if i == me else torch.empty_like(x)
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
    # each rank broadcasts the chunks of the other ranks (not its own), and
    # each receiver keeps its one
    me = dist.get_rank(group)
    chunks = x.chunk(k, dim=split_dim)
    if k == 1:
        return torch.cat(chunks, dim=cat_dim)
    shape = list(chunks[0].shape)
    shape[split_dim] *= k - 1
    parts = []
    for i in range(k):
        if i == me:
            buf = torch.cat([c for j, c in enumerate(chunks) if j != me], dim=split_dim)
        else:
            buf = torch.empty(shape, dtype=x.dtype, device=x.device)
        dist.broadcast(buf, src=dist.get_global_rank(group, i), group=group)
        parts.append(chunks[me] if i == me else
                     buf.chunk(k - 1, dim=split_dim)[me if me < i else me - 1])
    return torch.cat(parts, dim=cat_dim)


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


def reduce_scatter(x: torch.Tensor, group, *, dim: int, how: Optional[str] = None) -> torch.Tensor:
    """The SUM of the group ranks' ``x`` cut into k equal parts along
    ``dim`` (k the group size), group rank i keeping part i.  gloo
    documents no reduce-scatter for CUDA tensors, so the portable form is
    an ``all_reduce`` and a slice."""
    k = dist.get_world_size(group)
    if x.shape[dim] % k:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not split {k} ways")
    me, per = dist.get_rank(group), x.shape[dim] // k
    if _form(group, how) == "native":
        send = x.movedim(dim, 0).contiguous()
        recv = torch.empty((per,) + send.shape[1:], dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(recv, send, group=group)
        return recv.movedim(0, dim)
    return all_reduce(x, group).narrow(dim, me * per, per)


# ---- the collectives with gradients: the conjugate pairs a sharded
# training step needs (Megatron's f and g, the FSDP gather, the MoE's
# exchange).  A group of one
# rank is the identity both ways, so a (1, 1) mesh runs the unsharded ops.


def _trivial(group) -> bool:
    return group is None or dist.get_world_size(group) == 1


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _FSDPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, dim=ctx.dim), None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, cat_dim):
        ctx.group, ctx.split_dim, ctx.cat_dim = group, split_dim, cat_dim
        return all_to_all(x, group, split_dim=split_dim, cat_dim=cat_dim)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group, split_dim=ctx.cat_dim, cat_dim=ctx.split_dim), None, None, None


class _SumShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _SliceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        k = dist.get_world_size(group)
        per = x.shape[dim] // k
        return x.narrow(dim, dist.get_rank(group) * per, per).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, dim=ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        me = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, me * ctx.n, ctx.n).contiguous(), None, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """(a) Into a tensor-parallel region: the identity forward; backward
    the SUM over ``group`` of the ranks' partial gradients."""
    return x if _trivial(group) else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """(b) Out of a row-parallel product: the SUM over ``group`` forward;
    backward the identity (every rank holds the whole gradient)."""
    return x if _trivial(group) else _ReduceFromTP.apply(x, group)


def fsdp_gather(x: torch.Tensor, group, *, dim: int) -> torch.Tensor:
    """(c) A parameter's FSDP shards gathered along ``dim`` over ``group``;
    backward the SUM reduce-scatter, each rank keeping the gradient of its
    own shard summed over the ranks' batches."""
    return x if _trivial(group) else _FSDPGather.apply(x, group, dim)


def exchange(x: torch.Tensor, group, *, split_dim: int, cat_dim: int) -> torch.Tensor:
    """(e) ``all_to_all`` with a gradient: the MoE's expert-parallel
    exchange (chunk j of ``split_dim`` to group rank j, the received chunks
    concatenated along ``cat_dim`` in group order); backward the inverse
    exchange, ``split_dim`` and ``cat_dim`` swapped, which hands each
    rank's gradient chunk back to the rank that sent it."""
    return x if _trivial(group) else _Exchange.apply(x, group, split_dim, cat_dim)


def gather_replicated(x: torch.Tensor, group, *, dim: int) -> torch.Tensor:
    """(d) An all-gather whose output every rank uses alike (the vocab
    shards of a chunk's logits): backward this rank's slice of the
    gradient, which every rank holds whole."""
    return x if _trivial(group) else _GatherReplicated.apply(x, group, dim)


def sum_shared(x: torch.Tensor, group) -> torch.Tensor:
    """(f) The SUM over ``group`` of partial results that each rank then
    uses for its own part (the SSM's ``w_bc`` and ``w_dt`` contractions over
    a rank's channels, a norm's mean of squares over channels split across
    the ranks): backward the SUM too, since each rank's use gives a
    different gradient of the sum.  ``reduce_from_tp`` followed by
    ``copy_to_tp``."""
    return x if _trivial(group) else _SumShared.apply(x, group)


def slice_replicated(x: torch.Tensor, group, *, dim: int) -> torch.Tensor:
    """(g) This rank's 1/k along ``dim`` of a tensor every rank of
    ``group`` holds whole (a replicated norm scale over the channels a rank
    holds, whole heads feeding a row-parallel product): backward the
    ranks' gradient slices gathered, so every rank holds the whole
    gradient.  ``gather_replicated``'s conjugate."""
    return x if _trivial(group) else _SliceReplicated.apply(x, group, dim)
