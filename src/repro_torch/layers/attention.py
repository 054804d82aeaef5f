"""Attention layer: the *dynamic region* of PD-Swap.

One parameter set, two phase-specialized execution paths (the two engines):

* ``attention_prefill`` — the whole prompt through the causal prefill
  attention kernel (compute-bound engine) where the JAX package runs its
  Pallas kernel: causal, no window, as many queries as keys.  Elsewhere (a
  sliding window, the whisper encoder's non-causal attention, cross
  attention over the encoder's K/V) it computes what the JAX package
  computes outside Pallas, in plain torch: the dense f32 masked softmax up
  to 1,024 queries and keys, else the chunked path (512-query chunks,
  grouped GQA with no KV expansion).  In training (``training=True``) it
  always takes the plain paths, as the JAX training step does
  (``use_pallas=False``): the kernel's output has no gradient.
  ``attention_prefill_chunk`` is the prefill engine run one bounded chunk
  at a time (chunked prefill), the chunk attending the prefix already
  prefilled plus itself.
* ``attention_decode``  — one token against the KV cache through the decode
  attention kernel (bandwidth-bound engine), with per-sequence lengths for
  continuous batching, a sliding window's start (hymba) and the read-only
  cross-attention cache (whisper); ``attention_decode_paged`` is the same
  engine over the paged pool.  The new token is folded in by an
  online-softmax merge, so the cache is only read during the layer walk;
  the caller writes every layer's new token afterwards with one scatter
  (``scatter_new_tokens_q`` or ``scatter_new_tokens_paged_q``).
* ``attention_verify`` / ``attention_verify_paged`` — the decode engine run
  W = k + 1 positions a slot (speculative decoding's verify pass): the
  block's rows are written into this layer's cache first (the
  ``scatter_verify_*`` writers), then block row i of slot b walks
  [0, lengths[b] + i) through the same decode kernel, in one launch over
  all B * W rows, and merges its own fresh token.  Row i thus reads the
  rows, in the storage precision, that sequential decode reads at position
  lengths[b] + i, through the same split of the range.

A cache or pool leaf is a bf16/f32 tensor or a ``QuantKV`` (packed payload
+ f32 scale plane): the leaf carries its precision, and every write into a
quantized leaf quantizes on the way in, from f32.

The JAX package drops out-of-range scatter rows (``mode="drop"``, with the
pool size as the skip id); torch indexing has no such mode, so the paged
and verify writers point every dropped row at the first kept row's target,
with that row's value: the duplicate writes are identical, so the result is
deterministic, and the indices never depend on a host read of which rows
are live (no ``nonzero``), which keeps the writers inside a CUDA graph.
The chunk writers take the slot and start as 0-d device tensors, as the
JAX programs take traced scalars, or as Python ints.

Projections are TLMM/dense linears — the paper's static region.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.kernels.prefill_attention.ops import prefill_attention
from repro_torch.layers import collectives as C
from repro_torch.layers.linear import (
    linear_apply,
    linear_apply_row_parallel,
    linear_apply_train_sharded,
    linear_apply_train_whole,
    linear_init,
    train_weight,
)
from repro_torch.layers.sharding import NULL_CTX, PartitionCtx
from repro_torch.layers.rotary import apply_rope
from repro_torch.quant.kv_quant import QuantKV, infer_kv_dtype, quantize_kv


class KVCache(NamedTuple):
    k: torch.Tensor  # or a QuantKV (payload + scale plane)
    v: torch.Tensor


def _kv_leaf_args(k_leaf, v_leaf):
    """Split a (possibly quantized) K/V leaf pair into the payloads the
    decode ops take positionally and the scale/dtype keywords."""
    if isinstance(k_leaf, QuantKV):
        return k_leaf.q, v_leaf.q, dict(k_scales=k_leaf.scale, v_scales=v_leaf.scale,
                                         kv_dtype=infer_kv_dtype(k_leaf.q))
    return k_leaf, v_leaf, {}


def attention_init(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(device=device)
    return {
        "wq": linear_init(gen, d, h * hd, bias=cfg.qkv_bias, **kw),
        "wk": linear_init(gen, d, hkv * hd, bias=cfg.qkv_bias, **kw),
        "wv": linear_init(gen, d, hkv * hd, bias=cfg.qkv_bias, **kw),
        "wo": linear_init(gen, h * hd, d, scale=1.0 / (h * hd) ** 0.5, **kw),
    }


def _project_q(params, x, cfg: ModelConfig, positions, rope: bool = True,
               training: bool = False):
    b, s, _ = x.shape
    q = linear_apply(params["wq"], x, cfg.quant, training=training)
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    if rope and cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def _heads_whole(pctx: PartitionCtx) -> bool:
    """Whether the phase keeps every head on every rank (decode) while the
    projections' weights hold this rank's columns only."""
    return pctx.mesh is not None and pctx.resolve(["heads"])[0] is None


def _gather_heads(pctx: PartitionCtx, *parts: torch.Tensor):
    """The column-parallel projections' local outputs (..., n_i / tp) made
    whole (..., n_i) on every model rank, in one all-gather."""
    group = pctx.mesh.group(pctx.axes.tp)
    widths = [t.shape[-1] for t in parts]
    both = C.all_gather(torch.cat(parts, dim=-1)[None], group, dim=0)  # (tp, ..., sum n_i/tp)
    return [torch.cat(ranks.unbind(0), dim=-1)
            for ranks in both.split(widths, dim=-1)]


def heads_split(cfg: ModelConfig, pctx: PartitionCtx) -> bool:
    """Whether the training pass on ``pctx``'s mesh gives each model rank
    its own H/tp query and Hkv/tp KV heads: the model axis divides both
    counts.  Else (hymba-1.5b's 25 and 5 heads on 2 or 4 ranks) every rank
    computes every head; the rules still split ``wq``/``wk``/``wv``'s
    columns and ``wo``'s rows where the axis divides them, mid-head, and
    the step gathers them."""
    return cfg.num_heads % pctx.tp_size == 0 and cfg.num_kv_heads % pctx.tp_size == 0


def train_projections(params: dict, x: torch.Tensor, cfg: ModelConfig, pctx: PartitionCtx,
                      names) -> list:
    """The training pass's column projections ``names`` (of "wq", "wk",
    "wv") of x (B, S, d) on a mesh, each (B, S, heads, D): this rank's
    heads where the model axis splits them (column-parallel, x entering
    through ``copy_to_tp``), else every head (the weights gathered whole,
    ``linear_apply_train_whole``)."""
    b, s, d = x.shape
    hd = cfg.head_dim
    if heads_split(cfg, pctx):
        x = C.copy_to_tp(x, pctx.mesh.group(pctx.axes.tp))
        outs = [linear_apply_train_sharded(params[n], x, cfg.quant, pctx, parallel="column")
                for n in names]
    else:
        width = {"wq": cfg.num_heads * hd, "wk": cfg.num_kv_heads * hd, "wv": cfg.num_kv_heads * hd}
        outs = [linear_apply_train_whole(params[n], x, cfg.quant, pctx, (d, width[n]))
                for n in names]
    return [t.reshape(b, s, -1, hd) for t in outs]


def _project_qkv(params, x, cfg: ModelConfig, positions, training: bool = False,
                 pctx: PartitionCtx = NULL_CTX):
    """q (B, S, H, D) and k, v (B, S, Hkv, D), RoPE applied.  On a mesh
    the heads are this rank's (prefill: H/tp of them) or, where the phase
    keeps them whole (decode), gathered from the column-parallel shards;
    in training as ``train_projections`` gives them."""
    b, s, _ = x.shape
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    if pctx.mesh is None:
        q = _project_q(params, x, cfg, positions, training=training)
        k = linear_apply(params["wk"], x, cfg.quant, training=training).reshape(b, s, hkv, hd)
        v = linear_apply(params["wv"], x, cfg.quant, training=training).reshape(b, s, hkv, hd)
    elif training:  # the weights gathered over data
        q, k, v = train_projections(params, x, cfg, pctx, ("wq", "wk", "wv"))
        if cfg.rope_theta > 0:
            q = apply_rope(q, positions, cfg.rope_theta)
    else:
        q, k, v = (linear_apply(params[n], x, cfg.quant) for n in ("wq", "wk", "wv"))
        if _heads_whole(pctx):
            q, k, v = _gather_heads(pctx, q, k, v)
        q, k, v = (t.reshape(b, s, -1, hd) for t in (q, k, v))
        if cfg.rope_theta > 0:
            q = apply_rope(q, positions, cfg.rope_theta)
    if cfg.rope_theta > 0:
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(params, y: torch.Tensor, cfg: ModelConfig, pctx: PartitionCtx,
              training: bool = False) -> torch.Tensor:
    """The output projection of the heads ``y`` (..., heads * D): whole on
    one device; row-parallel on a mesh, over this rank's heads (the heads
    it holds in prefill, its slice of the whole heads in decode)."""
    if pctx.mesh is None:
        return linear_apply(params["wo"], y, cfg.quant, training=training)
    if training and heads_split(cfg, pctx):
        return linear_apply_train_sharded(params["wo"], y, cfg.quant, pctx, parallel="row")
    if training:  # every head on every rank: wo's rows as the rule cut them
        return _out_whole_heads(params, y, cfg, pctx)
    group = pctx.mesh.group(pctx.axes.tp)
    if not _heads_whole(pctx):
        return linear_apply_row_parallel(params["wo"], y, cfg.quant, group)
    return linear_apply_row_parallel(params["wo"], pctx.axis_slice(y, -1, pctx.axes.tp), cfg.quant,
                                     group, whole_row=y)


def _out_whole_heads(params, y: torch.Tensor, cfg: ModelConfig, pctx: PartitionCtx):
    """The training pass's output projection of every head ``y`` (B, S,
    H * D), whole and alike on every model rank: row-parallel over the rows
    the rule gave this rank (a row-parallel product is right for any split
    of its rows; y's slice through ``slice_replicated``, so every rank's
    gradient of y is the whole one), or, where the model axis does not
    divide the rows, the whole weight on every rank."""
    rows = cfg.num_heads * cfg.head_dim
    if rows % pctx.tp_size == 0:
        y = C.slice_replicated(y, pctx.mesh.group(pctx.axes.tp), dim=-1)
        return linear_apply_train_sharded(params["wo"], y, cfg.quant, pctx, parallel="row")
    w = train_weight(params["wo"]["w"], pctx, (rows, cfg.d_model), fsdp_dim=1)
    return linear_apply({**params["wo"], "w": w}, y, cfg.quant, training=True)


def project_cross_kv(params: dict, enc_out: torch.Tensor, cfg: ModelConfig,
                     pctx: PartitionCtx = NULL_CTX):
    """The cross K/V (B, Hkv, Senc, D) of the encoder output through a
    cross-attention layer's ``wk``/``wv`` (no RoPE): the inference linears
    with no mesh, as the JAX package computes them; on a training mesh
    this rank's heads (``train_projections``), the ones its queries attend
    with."""
    b, s, _ = enc_out.shape
    if pctx.mesh is None:
        hkv, hd = cfg.num_kv_heads, cfg.head_dim
        return tuple(linear_apply(params[n], enc_out, cfg.quant).reshape(b, s, hkv, hd)
                     .transpose(1, 2) for n in ("wk", "wv"))
    return tuple(t.transpose(1, 2) for t in train_projections(params, enc_out, cfg, pctx,
                                                              ("wk", "wv")))


DENSE_MAX = 1024  # the dense masked softmax takes up to this many queries and keys
QUERY_CHUNK = 512  # the chunked path's queries a chunk


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """(Sq, Skv) bool: key j is visible to query i."""
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    return mask


def _repeat_kv(t: torch.Tensor, h: int) -> torch.Tensor:
    """(B, Hkv, S, D) -> (B, H, S, D), each KV head repeated for its G = H /
    Hkv query heads (``jnp.repeat``'s order).  An expanded view copied by
    ``reshape``: the same values as ``repeat_interleave``, and a backward
    that sums over the group, where ``repeat_interleave``'s adds with
    atomics on a card (in no fixed order)."""
    b, hkv, s, d = t.shape
    if h == hkv:
        return t
    return t[:, :, None].expand(b, hkv, h // hkv, s, d).reshape(b, h, s, d)


def _dense_attention(q, k, v, *, causal: bool, window: Optional[int]) -> torch.Tensor:
    """The JAX package's dense path: q (B, H, S, D), k/v (B, Hkv, Skv, D)
    upcast to f32 (KV repeated to H heads), the scores masked with -1e30, a
    softmax, the PV product in f32.  Returns f32 (B, H, S, D)."""
    kk, vv = _repeat_kv(k, q.shape[1]), _repeat_kv(v, q.shape[1])
    dev = q.device
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * (1.0 / math.sqrt(q.shape[-1]))
    mask = _mask(torch.arange(q.shape[2], device=dev), torch.arange(k.shape[2], device=dev),
                 causal, window)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), vv.float())


def _chunked_attention(q, k, v, *, causal: bool, window: Optional[int]) -> torch.Tensor:
    """The JAX package's ``_chunked_attention``: exact attention one
    ``QUERY_CHUNK`` of queries at a time, GQA grouped (K/V never expanded
    to H heads).  q (B, H, Sq, D) is rounded to K's dtype; the operands are
    then upcast to f32, which is exact, so each product equals the JAX
    package's product in the storage dtype accumulated in f32; p is rounded
    to V's dtype before the PV product, and the output to q's dtype."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    chunk = min(QUERY_CHUNK, sq)
    qg = q.to(k.dtype).float().reshape(b, hkv, g, sq, d)
    kf, vf = k.float(), v.float()
    # in training each chunk is recomputed in backward, as the JAX package's
    # jax.checkpoint of its scan body: otherwise backward keeps every chunk's
    # (.., chunk, Skv) scores, the whole S x S matrix
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if not grad:
        out = torch.empty(b, hkv, g, sq, d, dtype=q.dtype, device=q.device)
        for c0 in range(0, sq, chunk):
            out[:, :, :, c0:c0 + chunk] = _attend_chunk(qg[:, :, :, c0:c0 + chunk], kf, vf, c0,
                                                        causal, window, v.dtype)
        return out.reshape(b, h, sq, d)
    # under grad the chunks' outputs are concatenated: an in-place write into
    # one tensor would be saved by, and clash with, the chunks' checkpoints
    outs = [checkpoint(_attend_chunk, qg[:, :, :, c0:c0 + chunk], kf, vf, c0, causal, window,
                       v.dtype, use_reentrant=False).to(q.dtype)
            for c0 in range(0, sq, chunk)]
    return torch.cat(outs, dim=3).reshape(b, h, sq, d)


def _attend_chunk(qc, kf, vf, c0: int, causal: bool, window: Optional[int],
                  v_dtype: torch.dtype) -> torch.Tensor:
    """One query chunk of ``_chunked_attention``: qc (B, Hkv, G, c, D) at
    positions c0 + [0, c) over f32 keys and values -> (B, Hkv, G, c, D) f32,
    p rounded to V's dtype before the PV product."""
    dev = qc.device
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qc, kf) * (1.0 / math.sqrt(qc.shape[-1]))
    mask = _mask(c0 + torch.arange(qc.shape[3], device=dev),
                 torch.arange(kf.shape[2], device=dev), causal, window)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1).to(v_dtype).float()
    return torch.einsum("bhgqk,bhkd->bhgqd", p, vf)


def attention_prefill(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                      *, window: Optional[int] = None, causal: bool = True,
                      cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      training: bool = False, pctx: PartitionCtx = NULL_CTX,
                      ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The prefill engine, dispatched as the JAX package dispatches it: the
    causal prefill kernel for causal attention with no window over as many
    keys as queries (never in training: the JAX training step runs
    ``use_pallas=False``); the dense f32 masked softmax when queries and
    keys are at most ``DENSE_MAX``; else the chunked path.  ``training``
    also selects the linears' quantization-aware branch.  ``cross_kv`` (the
    encoder's (B, Hkv, Senc, D) K/V) replaces this input's own K/V, with no
    RoPE, and is not causal.  Returns (y, (k, v)) with k/v (B, Hkv, S, D)
    views in cache layout (the cross K/V where given).  On a mesh
    (``pctx``) the heads are over the model axis: the kernel runs on this
    rank's H/tp and Hkv/tp heads, k/v are those heads, and the output
    projection sums over the ranks.  In training on a mesh the weights are
    gathered over data, and where the model axis does not split the heads
    (``heads_split``) every rank computes every head; ``cross_kv`` is then
    the heads this rank's queries take (``project_cross_kv``)."""
    b, s, _ = x.shape
    if cross_kv is not None:
        if pctx.mesh is not None and training:  # this rank's heads, or every head
            (q,) = train_projections(params, x, cfg, pctx, ("wq",))
            qt = q.transpose(1, 2)
        else:
            qt = _project_q(params, x, cfg, positions, rope=False, training=training).transpose(1, 2)
        kt, vt = cross_kv
        causal = False
    else:
        q, k, v = _project_qkv(params, x, cfg, positions, training=training, pctx=pctx)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)  # strided views
    if not training and window is None and causal and kt.shape[2] == s:
        out = prefill_attention(qt, kt, vt)  # (B, H, S, D)
    elif s <= DENSE_MAX and kt.shape[2] <= DENSE_MAX:
        out = _dense_attention(qt, kt, vt, causal=causal, window=window).to(x.dtype)
    else:
        out = _chunked_attention(qt, kt, vt, causal=causal, window=window)
    y = out.transpose(1, 2).reshape(b, s, qt.shape[1] * cfg.head_dim)
    y = _out_proj(params, y, cfg, pctx, training=training)
    return y, (kt, vt)


def attention_prefill_chunk(params: dict, x: torch.Tensor, k_prefix: torch.Tensor,
                            v_prefix: torch.Tensor, prefix_len: int, cfg: ModelConfig,
                            positions: torch.Tensor, pctx: PartitionCtx = NULL_CTX,
                            ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Chunked-prefill attention: x (B, C, d), one chunk of the prompt at
    global positions ``prefix_len + [0, C)``; k_prefix/v_prefix (B, Hkv, W,
    D) the f32 mirror of the prompt's KV, valid in [0, prefix_len) and
    garbage beyond.  Query q may attend prefix key i < prefix_len and chunk
    keys at or before it.  Plain f32 matmuls and a softmax over the scores
    masked with -1e30, as the JAX package computes it (it has no kernel for
    this path).  Returns (y, (k, v)) with the chunk's K/V (B, Hkv, C, D).
    On a mesh (``pctx``, the prefill rules) the heads, the mirror's
    included, are this rank's H / tp and Hkv / tp, and the output
    projection sums over the ranks."""
    b, c, _ = x.shape
    hd = cfg.head_dim
    cap = k_prefix.shape[2]
    q, k, v = _project_qkv(params, x, cfg, positions, pctx=pctx)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    h, hkv = qt.shape[1], kt.shape[1]
    kk = torch.cat([k_prefix.float(), kt.float()], dim=2)
    vv = torch.cat([v_prefix.float(), vt.float()], dim=2)
    if h > hkv:
        kk = kk.repeat_interleave(h // hkv, dim=1)
        vv = vv.repeat_interleave(h // hkv, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", qt.float(), kk) * (1.0 / math.sqrt(hd))
    dev = x.device
    qpos = prefix_len + torch.arange(c, device=dev)[:, None]
    kpos = torch.cat([torch.arange(cap, device=dev), prefix_len + torch.arange(c, device=dev)])
    valid = torch.cat([torch.arange(cap, device=dev) < prefix_len,
                       torch.ones((c,), dtype=torch.bool, device=dev)])
    mask = valid[None, :] & (qpos >= kpos[None, :])
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), vv).to(x.dtype)
    y = _out_proj(params, out.transpose(1, 2).reshape(b, c, h * hd), cfg, pctx)
    return y, (kt, vt)


def write_chunk_kv(buf: torch.Tensor, new: torch.Tensor, slot, start) -> torch.Tensor:
    """Install one prefill chunk's KV into slot ``slot`` of the contiguous
    decode cache at rows [start, start + C), in place.  buf: (B, L, Hkv,
    Smax, D), or its (B, L, Hkv, Smax) scale plane (the JAX package's
    ``write_chunk_scales``); new: (L, 1, Hkv, C, ·) to match.  ``slot`` and
    ``start`` are Python ints or 0-d integer tensors on buf's device (the
    chunk programs' traced scalars): the rows are an index op on device
    positions either way.  The JAX package's ``dynamic_update_slice`` would
    shift a write that overflows; here an int start that overflows is
    refused, and a device start is checked by the caller, which knows it."""
    c, smax = new.shape[3], buf.shape[3]
    if not isinstance(start, torch.Tensor) and start + c > smax:
        raise ValueError(f"chunk rows [{start}, {start + c}) overflow the cache's {smax} rows")
    rows = start + torch.arange(c, device=buf.device)
    slots = torch.as_tensor(slot, device=buf.device).long().reshape(1)
    # advanced indices on axes 0 and 3 put the C rows first: (C, L, Hkv, ·)
    buf[slots, :, :, rows] = new[:, 0].movedim(2, 0).to(buf.dtype)
    return buf


def write_chunk_kv_q(buf, new: torch.Tensor, slot: int, start: int):
    """``write_chunk_kv`` into a possibly quantized cache leaf: the chunk's
    f32 rows are quantized on the way in, payload and scale plane together.
    The scales are per token, so a chunk writes the bytes the whole prompt's
    quantization would."""
    if not isinstance(buf, QuantKV):
        return write_chunk_kv(buf, new, slot, start)
    payload, scale = quantize_kv(new, infer_kv_dtype(buf.q))
    return QuantKV(write_chunk_kv(buf.q, payload, slot, start),
                   write_chunk_kv(buf.scale, scale, slot, start))


def write_chunk_kv_seq_shard(buf: torch.Tensor, new: torch.Tensor, slot, start, r: int,
                             lo: int) -> torch.Tensor:
    """``write_chunk_kv`` into one rank's block of a cache split over the
    ranks: buf (B_l, L, Hkv, Sl, ·) holds the batch's slots [lo, lo + B_l)
    and the sequence's rows [r * Sl, (r + 1) * Sl).  Of the chunk's rows
    [start, start + C) of slot ``slot`` (a slot of the whole batch) only
    those that fall in the block are written; a row outside it repeats the
    first written row's write, and with none written (another rank's rows,
    or another data rank's slot) the first target is rewritten with what it
    holds.  ``slot`` and ``start`` are ints or 0-d device tensors: no host
    read, so the write stays inside a CUDA graph."""
    bl, sl = buf.shape[0], buf.shape[3]
    c = new.shape[3]
    dev = buf.device
    rows = start + torch.arange(c, device=dev)
    s = torch.as_tensor(slot, device=dev).long().reshape(1) - lo
    keep = (rows // sl == r) & ((s >= 0) & (s < bl))
    src = _first_kept(keep)
    local = torch.clamp(rows - r * sl, 0, sl - 1)[src]
    s = torch.clamp(s, 0, bl - 1)
    vals = new[:, 0].movedim(2, 0)[src].to(buf.dtype)  # (C, L, Hkv, ·)
    buf[s, :, :, local] = torch.where(keep.any(), vals, buf[s, :, :, local])
    return buf


def write_chunk_kv_seq_shard_q(buf, new: torch.Tensor, slot, start, r: int, lo: int):
    """``write_chunk_kv_seq_shard`` into a possibly quantized leaf (the
    whole chunk quantized on the way in, as ``write_chunk_kv_q``)."""
    if not isinstance(buf, QuantKV):
        return write_chunk_kv_seq_shard(buf, new, slot, start, r, lo)
    payload, scale = quantize_kv(new, infer_kv_dtype(buf.q))
    return QuantKV(write_chunk_kv_seq_shard(buf.q, payload, slot, start, r, lo),
                   write_chunk_kv_seq_shard(buf.scale, scale, slot, start, r, lo))


def scatter_new_tokens(buf: torch.Tensor, new: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Write every layer's new token into the decode cache in one in-place
    update.  buf: (B, L, Hkv, Smax, D), batch-leading, or its (B, L, Hkv,
    Smax) scale plane; new: (L, B, Hkv, 1, ·) to match.  The write lands at
    ``min(lengths, Smax - 1)``: a full slot (or a parked one) overwrites its
    last row, as the JAX package's clamped update does."""
    b, _, _, smax = buf.shape[:4]
    idx = torch.clamp(lengths.long(), max=smax - 1)
    rows = torch.arange(b, device=buf.device)
    buf[rows, :, :, idx] = new[:, :, :, 0].transpose(0, 1).to(buf.dtype)
    return buf


def scatter_new_tokens_q(buf, new: torch.Tensor, lengths: torch.Tensor):
    """``scatter_new_tokens`` into a possibly quantized cache leaf: the
    fresh f32 rows (L, B, Hkv, 1, D) are quantized on the way in, payload
    and scale plane together."""
    if not isinstance(buf, QuantKV):
        return scatter_new_tokens(buf, new, lengths)
    payload, scale = quantize_kv(new, infer_kv_dtype(buf.q))
    return QuantKV(scatter_new_tokens(buf.q, payload, lengths),
                   scatter_new_tokens(buf.scale, scale, lengths))


def scatter_new_tokens_seq_shard(buf: torch.Tensor, new: torch.Tensor, lengths: torch.Tensor,
                                 r: int, smax: int) -> torch.Tensor:
    """``scatter_new_tokens`` into rank r's rows [r * Sl, (r + 1) * Sl) of
    a cache whose sequence of ``smax`` rows is split over the ranks (buf
    (B, L, Hkv, Sl, ·)).  The write lands at ``min(lengths, smax - 1)``, as
    on one device, and only the rank holding that row changes anything:
    every other rank writes back what its row already holds (no host read
    of who owns what, so the write stays inside a CUDA graph)."""
    b, _, _, sl = buf.shape[:4]
    g = torch.clamp(lengths.long(), max=smax - 1)
    idx = torch.clamp(g - r * sl, 0, sl - 1)
    rows = torch.arange(b, device=buf.device)
    vals = new[:, :, :, 0].transpose(0, 1).to(buf.dtype)
    owner = ((g // sl) == r).reshape((b,) + (1,) * (vals.dim() - 1))
    buf[rows, :, :, idx] = torch.where(owner, vals, buf[rows, :, :, idx])
    return buf


def scatter_new_tokens_seq_shard_q(buf, new: torch.Tensor, lengths: torch.Tensor, r: int,
                                   smax: int):
    """``scatter_new_tokens_seq_shard`` into a possibly quantized leaf."""
    if not isinstance(buf, QuantKV):
        return scatter_new_tokens_seq_shard(buf, new, lengths, r, smax)
    payload, scale = quantize_kv(new, infer_kv_dtype(buf.q))
    return QuantKV(scatter_new_tokens_seq_shard(buf.q, payload, lengths, r, smax),
                   scatter_new_tokens_seq_shard(buf.scale, scale, lengths, r, smax))


def _first_kept(keep: torch.Tensor) -> torch.Tensor:
    """For each row, the row whose write it makes: itself where ``keep``,
    else the first kept row (row 0 when none is kept).  On the device, with
    no host read."""
    rows = torch.arange(keep.shape[0], device=keep.device)
    first = torch.argmax(keep.to(torch.int32))  # the first maximum: the first kept row
    return torch.where(keep, rows, first)


def scatter_new_tokens_paged(pages: torch.Tensor, new: torch.Tensor, block_tables: torch.Tensor,
                             lengths: torch.Tensor) -> torch.Tensor:
    """Paged analogue of ``scatter_new_tokens``: every layer's new token
    into its sequence's current page, in place.  pages: (N, L, Hkv, bs, D)
    or its (N, L, Hkv, bs) scale plane; new: (L, B, Hkv, 1, ·); block_tables
    (B, P); lengths (B,).  Sequence b's token lands at page
    ``tables[b, len // bs]``, offset ``len % bs``.  Inactive slots (length 0)
    write nothing (the JAX package routes them to the dropped id N): each
    repeats the first active slot's write, and with no active slot every
    row rewrites what the first target holds.  Distinct active slots own
    distinct pages, so no two differing rows collide."""
    bs = pages.shape[3]
    lengths = lengths.long()
    page_idx = torch.clamp(lengths // bs, max=block_tables.shape[1] - 1)
    page = torch.gather(block_tables.long(), 1, page_idx[:, None])[:, 0]
    active = lengths > 0
    src = _first_kept(active)
    page, off = page[src], (lengths % bs)[src]
    vals = new[:, :, :, 0].transpose(0, 1)[src].to(pages.dtype)  # (B, L, Hkv, ·)
    vals = torch.where(active.any(), vals, pages[page, :, :, off])
    pages[page, :, :, off] = vals
    return pages


def scatter_new_tokens_paged_q(pages, new: torch.Tensor, block_tables: torch.Tensor,
                               lengths: torch.Tensor):
    """``scatter_new_tokens_paged`` into a possibly quantized pool leaf
    (quantize on write, as ``scatter_new_tokens_q``)."""
    if not isinstance(pages, QuantKV):
        return scatter_new_tokens_paged(pages, new, block_tables, lengths)
    payload, scale = quantize_kv(new, infer_kv_dtype(pages.q))
    return QuantKV(scatter_new_tokens_paged(pages.q, payload, block_tables, lengths),
                   scatter_new_tokens_paged(pages.scale, scale, block_tables, lengths))


def write_prefill_pages(pages: torch.Tensor, kv: torch.Tensor, page_ids: torch.Tensor, *,
                        block_size: int) -> torch.Tensor:
    """Scatter a prefilled request's KV into its pages, in place.  pages:
    (N, L, Hkv, bs, D) or its (N, L, Hkv, bs) scale plane; kv: prefill
    layout (L, 1, Hkv, S, ·) with S a multiple of ``block_size``; page_ids
    (S/bs,) destinations.  Ids >= N (prefix-cache hits, which keep their
    shared contents, and the bucket's padding pages) are skipped: the JAX
    package's dropped scatter rows.  A skipped page repeats the first kept
    page's write; with none kept, page 0 is rewritten with what it holds."""
    n = pages.shape[0]
    l, _, hkv, s = kv.shape[:4]
    kb = kv[:, 0].reshape(l, hkv, s // block_size, block_size, *kv.shape[4:])
    kb = kb.movedim(2, 0).to(pages.device)  # (P, L, Hkv, bs, ·)
    ids = page_ids.to(pages.device).long()
    keep = ids < n
    src = _first_kept(keep)
    dst = torch.where(keep.any(), ids[src], torch.zeros_like(ids))
    vals = torch.where(keep.any(), kb[src].to(pages.dtype), pages[dst])
    pages[dst] = vals
    return pages


def write_prefill_pages_q(pages, kv: torch.Tensor, page_ids: torch.Tensor, *, block_size: int):
    """``write_prefill_pages`` into a possibly quantized pool leaf: the f32
    prefill KV is quantized on its way into the pool."""
    if not isinstance(pages, QuantKV):
        return write_prefill_pages(pages, kv, page_ids, block_size=block_size)
    payload, scale = quantize_kv(kv, infer_kv_dtype(pages.q))
    return QuantKV(write_prefill_pages(pages.q, payload, page_ids, block_size=block_size),
                   write_prefill_pages(pages.scale, scale, page_ids, block_size=block_size))


def _block_rows(t: torch.Tensor, w: int) -> torch.Tensor:
    """(B, ...) -> (B * W, ...): each slot's row repeated for its W block
    rows, as a view expanded and copied (no repeat count read back)."""
    return t[:, None].expand(t.shape[0], w, *t.shape[1:]).reshape(t.shape[0] * w, *t.shape[1:])


class VerifyTargets(NamedTuple):
    """Where a verify block's rows land, the same for every layer and leaf:
    target r receives the values of block row ``src_i[r]`` of slot
    ``src_b[r]`` at ``(dst0[r], dst1[r])`` — (slot, position) in the cache,
    (page, in-page offset) in the pool.  A dropped row repeats the first
    kept row's target and values; ``kept`` (0-d) is False when no row is
    kept, and every target then rewrites its own contents."""

    dst0: torch.Tensor
    dst1: torch.Tensor
    src_b: torch.Tensor
    src_i: torch.Tensor
    kept: torch.Tensor


def _targets(keep: torch.Tensor, dst0: torch.Tensor, dst1: torch.Tensor, w: int) -> VerifyTargets:
    src = _first_kept(keep)
    return VerifyTargets(dst0[src], dst1[src], src // w, src % w, keep.any())


def verify_targets(lengths: torch.Tensor, n_tokens: torch.Tensor, w: int, smax: int,
                   r: int = 0, sl: Optional[int] = None) -> VerifyTargets:
    """The contiguous cache's targets: row i of slot b at position
    ``lengths[b] + i``, kept iff ``i < n_tokens[b]`` and the position lies
    in the cache (the JAX package drops the others through ``mode="drop"``).
    With ``r`` and ``sl`` the cache is rank r's block [r * sl, (r + 1) * sl)
    of a sequence of ``smax`` rows split over the ranks (``sl`` defaults to
    ``smax``, the whole cache): a row is kept only where its position lies
    in the block, at its local row, so a block that straddles two ranks'
    rows is written part by each."""
    sl = smax if sl is None else sl
    i = torch.arange(w, device=lengths.device)
    pos = (lengths.long()[:, None] + i).reshape(-1)
    keep = ((i[None, :] < n_tokens.long()[:, None]).reshape(-1) & (pos < smax)
            & (pos // sl == r))
    slot = _block_rows(torch.arange(lengths.shape[0], device=lengths.device), w)
    return _targets(keep, slot, torch.clamp(pos - r * sl, 0, sl - 1), w)


def verify_page_targets(block_tables: torch.Tensor, lengths: torch.Tensor, n_tokens: torch.Tensor,
                        w: int, block_size: int) -> VerifyTargets:
    """The paged pool's targets: row i of slot b in page ``tables[b,
    (lengths[b] + i) // bs]`` at offset ``(lengths[b] + i) % bs``, kept iff
    ``i < n_tokens[b]`` and the slot is active (``lengths[b] > 0``): the
    engine grows a table only over a slot's real rows."""
    lengths = lengths.long()
    i = torch.arange(w, device=lengths.device)
    pos = lengths[:, None] + i  # (B, W)
    page_idx = torch.clamp(pos // block_size, max=block_tables.shape[1] - 1)
    page = torch.gather(block_tables.long(), 1, page_idx).reshape(-1)
    keep = ((i[None, :] < n_tokens.long()[:, None]) & (lengths[:, None] > 0)).reshape(-1)
    return _targets(keep, page, (pos % block_size).reshape(-1), w)


def write_verify_rows(buf: torch.Tensor, new: torch.Tensor, t: VerifyTargets) -> torch.Tensor:
    """Write a verify block's rows at their targets, in place.  buf: a
    (B, L, Hkv, Smax, ·) cache or (N, L, Hkv, bs, ·) pool plane, or a scale
    plane without the last dim; new: (L, B, Hkv, W, ·) to match.  Distinct
    kept targets never collide, and the repeats write identical values, so
    the result is deterministic, with no host read."""
    vals = new[:, t.src_b, :, t.src_i].to(buf.dtype)  # (R, L, Hkv, ·)
    buf[t.dst0, :, :, t.dst1] = torch.where(t.kept, vals, buf[t.dst0, :, :, t.dst1])
    return buf


def write_verify_rows_q(buf, new: torch.Tensor, t: VerifyTargets):
    """``write_verify_rows`` into a possibly quantized leaf: the block's f32
    rows are quantized on the way in (payload and per-row scale), so a
    verify round appends the bytes sequential decode appends."""
    if not isinstance(buf, QuantKV):
        return write_verify_rows(buf, new, t)
    payload, scale = quantize_kv(new, infer_kv_dtype(buf.q))
    return QuantKV(write_verify_rows(buf.q, payload, t), write_verify_rows(buf.scale, scale, t))


def _rows_of(leaf) -> torch.Tensor:
    return leaf.q if isinstance(leaf, QuantKV) else leaf


def scatter_verify_tokens(buf: torch.Tensor, new: torch.Tensor, lengths: torch.Tensor,
                          n_tokens: torch.Tensor) -> torch.Tensor:
    """Write a speculative verify block's KV into the contiguous cache, in
    place.  buf: (B, L, Hkv, Smax, D), batch-leading; new: (L, B, Hkv, W,
    D).  Row i of slot b lands at position ``lengths[b] + i`` iff ``i <
    n_tokens[b]`` (and the position lies in the cache): rows past a slot's
    real token count (draft padding, a slot sitting the round out) are
    dropped, so they never touch live KV or the parked-write row ``Smax -
    1``.  A dropped row repeats the first kept row's write; with none kept,
    the first target is rewritten with its own contents."""
    return write_verify_rows(buf, new, verify_targets(lengths, n_tokens, new.shape[3],
                                                      buf.shape[3]))


def scatter_verify_scales(buf: torch.Tensor, new: torch.Tensor, lengths: torch.Tensor,
                          n_tokens: torch.Tensor) -> torch.Tensor:
    """The scale-plane analogue of ``scatter_verify_tokens``: buf (B, L,
    Hkv, Smax) f32, new (L, B, Hkv, W); the same drop routing."""
    return scatter_verify_tokens(buf, new, lengths, n_tokens)


def scatter_verify_tokens_q(buf, new: torch.Tensor, lengths: torch.Tensor,
                            n_tokens: torch.Tensor):
    """``scatter_verify_tokens`` into a possibly quantized cache leaf
    (quantize on write)."""
    return write_verify_rows_q(buf, new, verify_targets(lengths, n_tokens, new.shape[3],
                                                        _rows_of(buf).shape[3]))


def scatter_verify_tokens_paged(pages: torch.Tensor, new: torch.Tensor,
                                block_tables: torch.Tensor, lengths: torch.Tensor,
                                n_tokens: torch.Tensor) -> torch.Tensor:
    """Paged analogue of ``scatter_verify_tokens``, in place: pages (N, L,
    Hkv, bs, D), new (L, B, Hkv, W, D), block_tables (B, P).  Targets and
    drops as ``verify_page_targets``; live slots own distinct pages, so no
    two differing rows collide."""
    return write_verify_rows(pages, new, verify_page_targets(
        block_tables, lengths, n_tokens, new.shape[3], pages.shape[3]))


def scatter_verify_scales_paged(pages: torch.Tensor, new: torch.Tensor,
                                block_tables: torch.Tensor, lengths: torch.Tensor,
                                n_tokens: torch.Tensor) -> torch.Tensor:
    """The scale-plane analogue of ``scatter_verify_tokens_paged``: pages
    (N, L, Hkv, bs) f32, new (L, B, Hkv, W)."""
    return scatter_verify_tokens_paged(pages, new, block_tables, lengths, n_tokens)


def scatter_verify_tokens_paged_q(pages, new: torch.Tensor, block_tables: torch.Tensor,
                                  lengths: torch.Tensor, n_tokens: torch.Tensor):
    """``scatter_verify_tokens_paged`` into a possibly quantized pool leaf
    (quantize on write)."""
    return write_verify_rows_q(pages, new, verify_page_targets(
        block_tables, lengths, n_tokens, new.shape[3], _rows_of(pages).shape[3]))


def _merge_new_token(out_cache, l_cache, m_cache, q, k_new, v_new, sm_scale: float) -> torch.Tensor:
    """Fold the freshly projected token's K/V into the attention over the
    cache (online-softmax merge): out_cache (B,H,D) normalized f32, l/m
    (B,H,1) f32, q (B,H,D), k_new/v_new (B,Hkv,1,D).  Returns f32 (B,H,D)."""
    h = q.shape[1]
    g = h // k_new.shape[1]
    kn = k_new[:, :, 0, :]
    vn = v_new[:, :, 0, :]
    if g > 1:
        kn = kn.repeat_interleave(g, dim=1)
        vn = vn.repeat_interleave(g, dim=1)
    s_new = (q.float() * kn.float()).sum(dim=-1, keepdim=True) * sm_scale
    m = torch.maximum(m_cache, s_new)
    alpha = torch.exp(m_cache - m)
    p_new = torch.exp(s_new - m)
    l = alpha * l_cache + p_new
    return (out_cache * (alpha * l_cache) + p_new * vn.float()) / torch.clamp(l, min=1e-30)


def merge_partials(out: torch.Tensor, l: torch.Tensor, m: torch.Tensor, group):
    """Merge the walks of the k ranks of ``group`` over disjoint parts of
    the cache: each rank's normalized ``out`` (B, H, D) f32 and softmax
    stats ``l``, ``m`` (B, H, 1) are gathered and combined in rank order,
    so every rank holds the same (out, l, m) of the whole walk.  A rank
    with nothing to walk (``l = 0``, ``m`` at the walk's floor) weighs
    nothing; with no rank holding a row the result is out 0, l 0, which
    the fresh token's merge then overrides."""
    if dist.get_world_size(group) == 1:
        return out, l, m
    d = out.shape[-1]
    allp = C.all_gather(torch.cat([out, l, m], dim=-1)[None], group, dim=0)
    return combine_partials(allp[..., :d], allp[..., d:d + 1], allp[..., d + 1:])


def combine_partials(outs: torch.Tensor, ls: torch.Tensor, ms: torch.Tensor):
    """The online-softmax combination of k walks stacked on dim 0: outs
    (k, B, H, D) normalized f32, ls / ms (k, B, H, 1).  Returns the (out,
    l, m) of their union; out is 0 where no walk holds a row."""
    m_g = ms.amax(dim=0)
    w = torch.exp(ms - m_g) * ls
    l_g = w.sum(dim=0)
    return (outs * w).sum(dim=0) / torch.clamp(l_g, min=1e-30), l_g, m_g


def _decode_new_token(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                      attend_cache, pctx: PartitionCtx = NULL_CTX) -> Tuple[torch.Tensor, KVCache]:
    """The decode engine's body, shared by both cache layouts and by the
    verify pass: project the W new tokens a sequence (x (B, W, d) at
    ``positions`` (B, W); W = 1 in decode), attend each over the cache
    through ``attend_cache(q_rows, k, v) -> (out, l, m)`` (q_rows (B*W, H,
    D), one row a token; k/v the fresh (B, W, Hkv, D), which the verify pass
    writes before it walks), merge each row's own fresh token in f32 and
    output-project.  Returns (y (B, W, d), the new tokens' K/V (B, Hkv, W,
    D)); in decode the caller scatters them.  On a mesh (``pctx``) every
    rank projects its columns and gathers the whole heads, and the output
    projection is row-parallel."""
    b, w = x.shape[:2]
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(params, x, cfg, positions, pctx=pctx)
    qd = q.reshape(b * w, h, hd)
    out_c, l_c, m_c = attend_cache(qd, k, v)
    out = _merge_new_token(out_c, l_c, m_c, qd, k.reshape(b * w, hkv, 1, hd),
                           v.reshape(b * w, hkv, 1, hd), 1.0 / math.sqrt(hd)).to(x.dtype)
    y = _out_proj(params, out.reshape(b, w, h * hd), cfg, pctx)
    return y, KVCache(k.transpose(1, 2), v.transpose(1, 2))


def attention_decode(params: dict, x: torch.Tensor, cache: KVCache, lengths: torch.Tensor,
                     cfg: ModelConfig, *, window: Optional[int] = None,
                     cross_len: Optional[int] = None, pctx: PartitionCtx = NULL_CTX,
                     walk: Optional[Tuple[torch.Tensor, object]] = None,
                     ) -> Tuple[torch.Tensor, KVCache]:
    """The decode engine: one token (x (B,1,d)) against this layer's cache
    (leaves (B, Hkv, Smax, ·), possibly strided views, possibly QuantKV).
    The cache is only read.  With ``window`` the walk starts at
    ``max(0, lengths + 1 - window)``: the range the window keeps once the
    fresh token is merged.

    With ``cross_len`` the cache is the read-only cross-attention cache
    (whisper's encoder K/V): the query (no RoPE) walks its first
    ``cross_len`` rows, no fresh token is merged, and the cache comes back
    as it was, in place of the new token's K/V.

    On a mesh the cache is this rank's rows of the sequence and ``walk`` =
    (local lengths, group): the kernel walks the local rows [0, local
    length), and the ranks of ``group``, which hold the other rows, merge
    their partials (``merge_partials``) before the fresh token is folded
    in.  ``lengths`` stay the global ones (positions, the fresh token)."""
    if cross_len is not None:
        b = x.shape[0]
        h, hd = cfg.num_heads, cfg.head_dim
        qd = _project_q(params, x, cfg, None, rope=False).reshape(b, h, hd)
        eff = torch.full((b,), cross_len, dtype=torch.int32, device=x.device)
        out = decode_attention(qd, cache.k, cache.v, eff)
        return linear_apply(params["wo"], out.reshape(b, 1, h * hd), cfg.quant), cache
    starts = (None if window is None
              else torch.clamp(lengths + 1 - window, min=0).to(torch.int32))

    def attend(qd, k, v):
        k_arr, v_arr, qkw = _kv_leaf_args(cache.k, cache.v)
        if walk is None:
            return decode_attention(qd, k_arr, v_arr, lengths, starts, return_stats=True, **qkw)
        local, group = walk
        return merge_partials(*decode_attention(qd, k_arr, v_arr, local, return_stats=True,
                                                **qkw), group)

    return _decode_new_token(params, x, lengths[:, None], cfg, attend, pctx)


def attention_decode_paged(params: dict, x: torch.Tensor, k_pages, v_pages,
                           block_tables: torch.Tensor, lengths: torch.Tensor,
                           cfg: ModelConfig, pctx: PartitionCtx = NULL_CTX,
                           ) -> Tuple[torch.Tensor, KVCache]:
    """The decode engine over the paged pool: one token against this
    layer's pages (N, Hkv, bs, ·), walked through ``block_tables`` (B, P).
    Same contract as ``attention_decode``."""

    def attend(qd, k, v):
        k_arr, v_arr, qkw = _kv_leaf_args(k_pages, v_pages)
        return paged_decode_attention(qd, k_arr, v_arr, block_tables, lengths,
                                      return_stats=True, **qkw)

    return _decode_new_token(params, x, lengths[:, None], cfg, attend, pctx)


class VerifyPlan(NamedTuple):
    """A verify round's bookkeeping, the same for every layer, made once a
    round: the block rows' positions (B, W), each row's walk length (B * W,)
    int32, where the rows land, (paged) each table row W times, and (a
    sequence shard of a mesh) the group of ranks whose walks merge."""

    positions: torch.Tensor
    walk: torch.Tensor
    targets: VerifyTargets
    tables: Optional[torch.Tensor] = None
    group: object = None


def _verify_rows(lengths: torch.Tensor, n_tokens: torch.Tensor, w: int) -> torch.Tensor:
    """The walk length of each block row, (B * W,) int32: row i of slot b
    walks [0, lengths[b] + i), what sequential decode walks at that
    position.  A padding row (i >= n_tokens[b]) walks the slot's last real
    row's range, and a slot sitting the round out (n_tokens 0) its own
    length, so no row reads past the rows its slot's pages cover; their
    outputs are garbage that nothing reads."""
    i = torch.arange(w, device=lengths.device, dtype=lengths.dtype)
    last = torch.clamp(n_tokens - 1, min=0).to(lengths.dtype)
    return (lengths[:, None] + torch.minimum(i[None, :], last[:, None])).reshape(-1)


def verify_plan(lengths: torch.Tensor, n_tokens: torch.Tensor, w: int, *,
                smax: Optional[int] = None, block_tables: Optional[torch.Tensor] = None,
                block_size: Optional[int] = None, seq_shard=None) -> VerifyPlan:
    """The plan of a verify round over the contiguous cache (``smax``) or
    the paged pool (``block_tables``, ``block_size``).  ``seq_shard`` =
    (r, Sl, group): the cache is rank r's block [r * Sl, (r + 1) * Sl) of
    a sequence of ``smax`` rows, whose rows the ranks of ``group`` hold in
    turn; each row walks its local part ``clamp(walk - r * Sl, 0, Sl)`` and
    only the rows that land in the block are written."""
    positions = lengths[:, None] + torch.arange(w, device=lengths.device)
    walk = _verify_rows(lengths, n_tokens, w)
    if block_tables is None:
        r, sl, group = seq_shard or (0, smax, None)
        return VerifyPlan(positions, torch.clamp(walk - r * sl, 0, sl).to(torch.int32),
                          verify_targets(lengths, n_tokens, w, smax, r, sl), group=group)
    return VerifyPlan(positions, walk, verify_page_targets(block_tables, lengths, n_tokens, w,
                                                           block_size),
                      _block_rows(block_tables, w))


def _layer0(leaf):
    """The (.., Hkv, S, ·) walk view of a one-layer (.., 1, Hkv, S, ·) view."""
    if isinstance(leaf, QuantKV):
        return QuantKV(leaf.q[:, 0], leaf.scale[:, 0])
    return leaf[:, 0]


def attention_verify(params: dict, x: torch.Tensor, cache: KVCache, plan: VerifyPlan,
                     cfg: ModelConfig, pctx: PartitionCtx = NULL_CTX
                     ) -> Tuple[torch.Tensor, KVCache]:
    """The speculative verify pass of one layer over the contiguous cache:
    x (B, W, d), per slot [last token, draft_1..draft_k], block row i at
    position ``lengths[b] + i``; cache: this layer's leaves as (B, 1, Hkv,
    Smax, ·) views (possibly QuantKV); ``plan`` the round's
    ``verify_plan``.  The block's kept rows are written first (quantized on
    write), then every row walks its range through the decode kernel (one
    launch, B * W rows) and merges its own fresh token: step for step what
    decode computes at position ``lengths[b] + i``.  Returns (y (B, W, d),
    the block's K/V (B, Hkv, W, D), already written).

    On a mesh (``pctx``, the decode rules; a ``seq_shard`` plan) the cache
    is this rank's block of the sequence: the rank writes the block rows
    that land in it, walks each row's local part, and the ranks of
    ``plan.group`` merge their partials (``merge_partials``) before each
    row's fresh token is folded in, as ``attention_decode`` does."""
    w = x.shape[1]

    def attend(qd, k, v):
        write_verify_rows_q(cache.k, k.transpose(1, 2)[None], plan.targets)
        write_verify_rows_q(cache.v, v.transpose(1, 2)[None], plan.targets)
        k_arr, v_arr, qkw = _kv_leaf_args(_layer0(cache.k), _layer0(cache.v))
        parts = decode_attention(qd, k_arr, v_arr, plan.walk, return_stats=True,
                                 rows_per_slot=w, **qkw)
        return parts if plan.group is None else merge_partials(*parts, plan.group)

    return _decode_new_token(params, x, plan.positions, cfg, attend, pctx)


def attention_verify_paged(params: dict, x: torch.Tensor, k_pages, v_pages, plan: VerifyPlan,
                           cfg: ModelConfig, pctx: PartitionCtx = NULL_CTX
                           ) -> Tuple[torch.Tensor, KVCache]:
    """``attention_verify`` over the paged pool: k_pages/v_pages this
    layer's (N, 1, Hkv, bs, ·) views; the walk takes each slot's table row
    once for each of its W block rows (``plan.tables``).  On a mesh the
    pool is whole and ``plan`` this rank's slots': the rank writes and
    walks their rows (the other data ranks' rows come after the layers,
    ``models.transformer.verify_paged``)."""

    def attend(qd, k, v):
        write_verify_rows_q(k_pages, k.transpose(1, 2)[None], plan.targets)
        write_verify_rows_q(v_pages, v.transpose(1, 2)[None], plan.targets)
        k_arr, v_arr, qkw = _kv_leaf_args(_layer0(k_pages), _layer0(v_pages))
        return paged_decode_attention(qd, k_arr, v_arr, plan.tables, plan.walk,
                                      return_stats=True, rows_per_slot=x.shape[1], **qkw)

    return _decode_new_token(params, x, plan.positions, cfg, attend, pctx)
