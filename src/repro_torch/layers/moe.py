"""Mixture-of-Experts FFN with sort-based capacity routing: the JAX
package's ``repro.layers.moe``, on one device or on a mesh of processes.

Routing is sort-based (argsort + per-expert rank), never materializing the
(T, E, C) one-hot dispatch tensor.  The expert products are batched
matmuls, as the JAX package's are einsums outside any Pallas kernel.

On a mesh (``pctx`` with a model axis of tp ranks) the layer runs what the
JAX ``moe_apply`` runs inside its ``shard_map``, one of three ways chosen
per call exactly as there:

* **EP** (``num_experts % tp == 0``): a model rank holds E / tp experts.
  It routes its tokens to all E, dispatches them into (E, C, d), and one
  exchange (``collectives.exchange``, split on experts, concatenated on
  capacity in group order) hands each rank (E / tp, tp * C, d): its
  experts' rows from every rank.  The inverse exchange brings the outputs
  home for the combine.
* **local experts** (not EP, the sequence divides tp): every expert on
  every rank (the stacks gathered over the model group), each rank its
  own tokens, no collective inside the block.
* **hidden split** (not EP, the sequence does not divide: decode): every
  row on every model rank, each rank its d_ff / tp slice of every expert,
  the partial outputs summed over the model group.

The tokens are this rank's sequence slice where the sequence divides tp
(gathered back along the sequence after the block), else every row of the
rank.  What the JAX local view computes follows: the capacity is that of
the local token count, so drops follow the dispatch group; a ternary
stack's absmean is taken over the local shard.  On a mesh with no model
axis the JAX package runs no ``shard_map``: the ranks' rows are gathered
and routed as one group.  The aux loss is the whole batch's everywhere.

The layer runs inside the captured decode, chunk and verify programs, so:

* nothing reads a value back to the host: the per-expert counts are a
  ``scatter_add_`` over ``num_experts`` (``bincount`` would size its output
  from the data), and no ``nonzero`` or boolean indexing appears;
* the capacity ``C = max(8, int(T * k / E * factor))`` depends only on the
  row count T, padding rows included, so the port routes exactly the rows
  the JAX programs route (a prefill bucket, every decode slot, B x W verify
  rows, a padded chunk);
* the combine is deterministic: each token's k contributions are summed one
  after another in top-k order in the output dtype, which is also the
  order in which the JAX scatter-add rounds them (``index_add_`` on a card
  adds with atomics in no fixed order);
* a dropped assignment goes to the spare row ``E * C`` of the dispatch
  buffer and is weighted 0 in the combine, as in the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.layers import collectives as C
from repro_torch.layers.sharding import NULL_CTX, PartitionCtx
from repro_torch.quant.ternary import ternary_quantize, ternary_quantize_ste

# Token-chunk size for the dispatch buffer (the JAX package's): bounds the
# (E, C, d) working set of a long prompt.
MOE_TOKEN_CHUNK = 8192


def moe_init(cfg: ModelConfig, gen: torch.Generator, device=None,
             dtype: torch.dtype = torch.float32) -> dict:
    """The JAX package's draws: router N(0, 1/d) kept f32, expert stacks
    w_gate / w_up (E, d, f) N(0, 1/d) and w_down (E, f, d) N(0, 1/f) in
    ``dtype``, each drawn in f32 and cast."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    s_in, s_out = 1.0 / d**0.5, 1.0 / f**0.5

    def draw(shape, s):
        return (torch.randn(shape, generator=gen, device=device) * s).to(dtype)

    return {
        "router": torch.randn((d, e), generator=gen, device=device) * s_in,
        "w_gate": draw((e, d, f), s_in),
        "w_up": draw((e, d, f), s_in),
        "w_down": draw((e, f, d), s_out),
    }


def _maybe_ternary(w: torch.Tensor, cfg: ModelConfig, training: bool = False) -> torch.Tensor:
    """Under ``quant_mode="ternary"``: the (E, ·, ·) stack this rank
    multiplies by fake-quantized with one absmean (not one per expert), as
    the JAX package's ``_maybe_ternary``; on a mesh that is the local shard
    (E / tp experts, or a d_ff / tp slice), as in the JAX ``shard_map``
    body, so its absmean is the shard's.  In training through the
    straight-through quantizer (f32); bf16 configs pass through."""
    if not cfg.quant.ternary:
        return w
    if training:
        return ternary_quantize_ste(w.float())[0]
    w_q, beta = ternary_quantize(w.float())
    return (w_q.float() * beta).to(w.dtype)


def _route(gate_logits: torch.Tensor, k: int, capacity: int, num_experts: int):
    """Sort-based top-k routing.  gate_logits: (T, E) f32.

    Returns (token_idx (T*k,), dest (T*k,) into the E*C flat buffer, or
    E*C when dropped, combine weights (T*k,) f32, probs (T, E))."""
    t = gate_logits.shape[0]
    dev = gate_logits.device
    probs = torch.softmax(gate_logits.float(), dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)  # (T, k), descending
    topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-9)
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros(num_experts, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, 0) - counts  # exclusive prefix sum
    ranks_sorted = torch.arange(t * k, device=dev) - offsets[sorted_e]
    ranks = torch.empty_like(ranks_sorted).scatter_(0, order, ranks_sorted)
    dest = torch.where(ranks < capacity, flat_e * capacity + ranks,
                       torch.full_like(ranks, num_experts * capacity))
    token_idx = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    return token_idx, dest, topv.reshape(-1), probs


def _expert_ffn(buf: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """buf (E, C, d) -> (E, C, d) through each expert's SwiGLU."""
    g = torch.bmm(buf, w_gate.to(buf.dtype))
    u = torch.bmm(buf, w_up.to(buf.dtype))
    h = F.silu(g.float()).to(buf.dtype) * u
    return torch.bmm(h, w_down.to(buf.dtype))


def _dispatch(x_flat, token_idx, dest, e: int, c: int) -> torch.Tensor:
    """Each kept assignment's token row into its expert slot of an
    (E*C + 1, d) buffer (dropped ones add into the spare last row, which is
    cut off): (E, C, d)."""
    buf = torch.zeros((e * c + 1, x_flat.shape[-1]), dtype=x_flat.dtype, device=x_flat.device)
    buf.index_add_(0, dest, x_flat[token_idx])
    return buf[: e * c].reshape(e, c, -1)


def _combine(y_buf, dest, weights, t: int, k: int) -> torch.Tensor:
    """Sum each token's k weighted expert outputs (T*k rows, token-major),
    one after another in top-k order in the buffer's dtype; a dropped
    assignment reads a real row and is weighted 0."""
    e_c = y_buf.shape[0] * y_buf.shape[1]
    y_flat = y_buf.reshape(e_c, -1)
    safe = torch.clamp(dest, max=e_c - 1)
    w = (weights * (dest < e_c)).to(y_flat.dtype)
    contrib = (y_flat[safe] * w[:, None]).reshape(t, k, -1)
    out = torch.zeros((t, y_flat.shape[-1]), dtype=y_flat.dtype, device=y_flat.device)
    for j in range(k):
        out = out + contrib[:, j]
    return out


def _moe_tokens(x_flat: torch.Tensor, gate_logits: torch.Tensor, params: dict,
                cfg: ModelConfig, training: bool = False, tp=None,
                ep: bool = False) -> torch.Tensor:
    """The MoE over T token rows: route, dispatch, expert FFNs, combine.
    ``params`` holds the stacks this rank multiplies by; with a model group
    ``tp`` they are E / tp experts (``ep``: the exchange out and back) or
    every expert's d_ff / tp slice (the partial outputs summed)."""
    t = x_flat.shape[0]
    e, k = cfg.num_experts, cfg.top_k
    cap = max(8, int(t * k / e * cfg.moe_capacity_factor))
    w_gate = _maybe_ternary(params["w_gate"], cfg, training)
    w_up = _maybe_ternary(params["w_up"], cfg, training)
    w_down = _maybe_ternary(params["w_down"], cfg, training)
    token_idx, dest, comb_w, _ = _route(gate_logits, k, cap, e)
    buf = _dispatch(x_flat, token_idx, dest, e, cap)
    if ep and tp is not None:
        recv = C.exchange(buf, tp, split_dim=0, cat_dim=1)  # (E / tp, tp * C, d)
        y_loc = _expert_ffn(recv, w_gate, w_up, w_down)
        y_buf = C.exchange(y_loc, tp, split_dim=1, cat_dim=0)  # (E, C, d): this rank's tokens
        return _combine(y_buf, dest, comb_w, t, k)
    out = _combine(_expert_ffn(buf, w_gate, w_up, w_down), dest, comb_w, t, k)
    return out if tp is None else C.reduce_from_tp(out, tp)


def _moe_tokens_chunked(x_flat: torch.Tensor, gate_logits: torch.Tensor, params: dict,
                        cfg: ModelConfig, chunk: int = MOE_TOKEN_CHUNK,
                        training: bool = False, tp=None, ep: bool = False) -> torch.Tensor:
    """``_moe_tokens`` over chunks of ``chunk`` rows (the last one padded
    with zero rows, which route and claim capacity as in the JAX scan).  On
    a mesh every model rank holds as many rows, so the ranks' exchanges
    pair up chunk by chunk."""
    t, d = x_flat.shape
    if t <= chunk:
        return _moe_tokens(x_flat, gate_logits, params, cfg, training, tp, ep)
    pad = (-t) % chunk
    if pad:
        x_flat = F.pad(x_flat, (0, 0, 0, pad))
        gate_logits = F.pad(gate_logits, (0, 0, 0, pad))
    ys = [_moe_tokens(x_flat[i:i + chunk], gate_logits[i:i + chunk], params, cfg, training,
                      tp, ep)
          for i in range(0, t + pad, chunk)]
    return torch.cat(ys)[:t]


def load_balance_loss(gate_logits: torch.Tensor, k: int, num_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e (f: token fraction, p: prob mass)."""
    probs = torch.softmax(gate_logits.float(), dim=-1).reshape(-1, num_experts)
    _, topi = torch.topk(probs, k, dim=-1)
    f = F.one_hot(topi, num_experts).float().sum(dim=-2).mean(dim=0) / k
    p = probs.mean(dim=0)
    return num_experts * (f * p).sum()


def _batch_axis(pctx: PartitionCtx):
    """The mesh axes the rules put the batch on (None: the rows are whole
    on every rank)."""
    ax = pctx.resolve(["batch"])[0]
    return ax if pctx.size(ax) > 1 else None


def _aux_share(gate_logits: torch.Tensor, k: int, num_experts: int,
               pctx: PartitionCtx) -> torch.Tensor:
    """This rank's share of the aux loss of the whole batch, which the JAX
    package takes once, on the global gate logits: f from the assignment
    counts summed over the batch axes, times this rank's probability sums,
    both over the global row count, so the shares sum over the batch axes
    to the global loss (and its gradient).  The model ranks hold the same
    rows, so nothing is summed over them.  Rows whole on every rank: the
    loss itself."""
    ax = _batch_axis(pctx)
    if ax is None:
        return load_balance_loss(gate_logits, k, num_experts)
    probs = torch.softmax(gate_logits.float(), dim=-1).reshape(-1, num_experts)
    _, topi = torch.topk(probs, k, dim=-1)
    counts = C.all_reduce(F.one_hot(topi, num_experts).float().sum(dim=(0, 1)).detach(),
                          pctx.mesh.group(ax))
    n = probs.shape[0] * pctx.size(ax)
    return num_experts * ((counts / n / k) * (probs.sum(dim=0) / n)).sum()


def _gate_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x.float() @ params["router"].float()


class _ShareGrad(torch.autograd.Function):
    """The identity forward; backward the gradient over ``n``.  Where every
    model rank routes the same rows to experts on every rank (EP with the
    sequence whole), each rank's loss reaches every expert through the
    exchange, so each takes 1 / tp of its output's gradient: what the JAX
    ``shard_map`` transpose does to an output replicated over the axis
    (and its input's gradient is then summed over the axis, ``copy_to_tp``)."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _mesh_params(params: dict, pctx: PartitionCtx, ep: bool, local_experts: bool,
                 training: bool) -> dict:
    """The router and stacks this rank multiplies by.  In training each is
    first gathered over data at the dim ``param_pspec`` shards (an FSDP
    gather: its gradient is reduce-scattered back, summed over the data
    ranks' batches); on the local-expert path every expert's d_ff slices
    are then gathered over the model group too (``shard_map``'s replicated
    in-spec gathers the stacks in JAX; in training each model rank's
    gradient of the whole stack is reduce-scattered back)."""
    mesh, fsdp = pctx.mesh, pctx.axes.fsdp
    p = dict(params)
    if training and fsdp is not None and pctx.size(fsdp) > 1:
        data = mesh.group(fsdp)
        for name, dim in (("router", 0), ("w_gate", 1), ("w_up", 1), ("w_down", 2)):
            p[name] = C.fsdp_gather(p[name], data, dim=dim)
    if not ep and local_experts:
        tp = mesh.group(pctx.axes.tp)
        gather = C.fsdp_gather if training else C.all_gather
        for name, dim in (("w_gate", 2), ("w_up", 2), ("w_down", 1)):
            p[name] = gather(p[name], tp, dim=dim)
    return p


def _moe(params: dict, x: torch.Tensor, cfg: ModelConfig, pctx: PartitionCtx,
         training: bool, with_aux: bool):
    """(y (B, S, d) in x's dtype, the aux loss or None).  On a mesh x holds
    this rank's rows, whole over the model axis, and y comes back so."""
    b, s, d = x.shape
    if pctx.mesh is None:
        gl = _gate_logits(params, x)
        aux = load_balance_loss(gl, cfg.top_k, cfg.num_experts) if with_aux else None
        y = _moe_tokens_chunked(x.reshape(b * s, d), gl.reshape(b * s, -1), params, cfg,
                                training=training)
        return y.reshape(b, s, d).to(x.dtype), aux
    tp_n = pctx.tp_size  # 1 on a mesh with no model axis
    ep = cfg.num_experts % tp_n == 0
    seq_sharded = s % tp_n == 0 and tp_n > 1
    p = _mesh_params(params, pctx, ep, seq_sharded, training)
    gl = _gate_logits(p, x)
    aux = _aux_share(gl, cfg.top_k, cfg.num_experts, pctx) if with_aux else None
    if not isinstance(pctx.axes.tp, str):
        return _moe_whole_batch(p, x, gl, cfg, pctx, training), aux
    tp = pctx.mesh.group(pctx.axes.tp)
    xs, gs = C.copy_to_tp(x, tp), C.copy_to_tp(gl, tp)
    if seq_sharded:  # this model rank's slice of the sequence
        sl = s // tp_n
        lo = pctx.index(pctx.axes.tp) * sl
        xs, gs = xs.narrow(1, lo, sl), gs.narrow(1, lo, sl)
    inner = None if (seq_sharded and not ep) else tp  # local experts: no collective
    y = _moe_tokens_chunked(xs.reshape(-1, d), gs.reshape(-1, gs.shape[-1]), p, cfg,
                            training=training, tp=inner, ep=ep)
    y = y.reshape(b, xs.shape[1], d)
    if seq_sharded:
        y = C.gather_replicated(y, tp, dim=1)
    elif ep and tp_n > 1:
        y = _ShareGrad.apply(y, tp_n)
    return y.to(x.dtype), aux


def _moe_whole_batch(params: dict, x: torch.Tensor, gl: torch.Tensor, cfg: ModelConfig,
                     pctx: PartitionCtx, training: bool) -> torch.Tensor:
    """A mesh with no model axis: the JAX ``moe_apply`` routes the whole
    batch as one group there (no ``shard_map``), so the ranks' rows are
    gathered over the batch axes, routed together, and each rank keeps its
    own (in training the gather's gradient is summed back, as an FSDP
    gather's)."""
    b, s, d = x.shape
    ax = _batch_axis(pctx)
    if ax is not None:
        group = pctx.mesh.group(ax)
        gather = C.fsdp_gather if training else C.all_gather
        x, gl = gather(x, group, dim=0), gather(gl, group, dim=0)
    y = _moe_tokens_chunked(x.reshape(-1, d), gl.reshape(-1, gl.shape[-1]), params, cfg,
                            training=training).reshape(-1, s, d)
    if ax is not None:
        y = y.narrow(0, pctx.index(ax) * b, b)
    return y.to(x.dtype)


def moe_forward(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                training: bool = False, pctx: PartitionCtx = NULL_CTX) -> torch.Tensor:
    """The MoE FFN of x (B, S, d) -> (B, S, d) in x's dtype, without the
    aux loss (the serving programs discard it, as the JAX ones do).  On a
    mesh (``pctx``) x holds this rank's rows, whole over the model axis,
    and ``params`` this rank's slice (``shard_params``)."""
    return _moe(params, x, cfg, pctx, training, with_aux=False)[0]


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              training: bool = False,
              pctx: PartitionCtx = NULL_CTX) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, d), aux loss scalar), as the JAX ``moe_apply``.  On
    a mesh the aux loss is this rank's share of the whole batch's
    (``_aux_share``): the shares sum over the batch axes to JAX's."""
    return _moe(params, x, cfg, pctx, training, with_aux=True)
