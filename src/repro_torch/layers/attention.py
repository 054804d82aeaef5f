"""Attention layer: the *dynamic region* of PD-Swap.

One parameter set, two phase-specialized execution paths (the two engines):

* ``attention_prefill`` — the whole prompt through the causal prefill
  attention kernel (compute-bound engine); ``attention_prefill_chunk`` is
  the same engine run one bounded chunk at a time (chunked prefill), the
  chunk attending the prefix already prefilled plus itself.
* ``attention_decode``  — one token against the KV cache through the decode
  attention kernel (bandwidth-bound engine), with per-sequence lengths for
  continuous batching; ``attention_decode_paged`` is the same engine over
  the paged pool.  The new token is folded in by an online-softmax merge, so
  the cache is only read during the layer walk; the caller writes every
  layer's new token afterwards with one scatter (``scatter_new_tokens_q``
  or ``scatter_new_tokens_paged_q``).

A cache or pool leaf is a bf16/f32 tensor or a ``QuantKV`` (packed payload
+ f32 scale plane): the leaf carries its precision, and every write into a
quantized leaf quantizes on the way in, from f32.

The JAX package drops out-of-range scatter rows (``mode="drop"``, with the
pool size as the skip id); torch indexing has no such mode, so the paged
writers point every dropped row at the first kept row's target, with that
row's value: the duplicate writes are identical, so the result is
deterministic, and the indices never depend on a host read of which rows
are live (no ``nonzero``), which keeps the writers inside a CUDA graph.
The chunk writers take the slot and start as 0-d device tensors, as the
JAX programs take traced scalars, or as Python ints.

Projections are TLMM/dense linears — the paper's static region.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.kernels.prefill_attention.ops import prefill_attention
from repro_torch.layers.linear import linear_apply, linear_init
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


def _check_slice(cfg: ModelConfig) -> None:
    if cfg.sliding_window is not None:
        raise NotImplementedError("sliding-window attention is not in the port yet (ROADMAP A12)")


def _project_qkv(params, x, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = linear_apply(params["wq"], x, cfg.quant).reshape(b, s, h, hd)
    k = linear_apply(params["wk"], x, cfg.quant).reshape(b, s, hkv, hd)
    v = linear_apply(params["wv"], x, cfg.quant).reshape(b, s, hkv, hd)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_prefill(params: dict, x: torch.Tensor, positions: torch.Tensor,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The prefill engine.  Returns (y, (k, v)) with k/v (B, Hkv, S, D) views
    in cache layout."""
    _check_slice(cfg)
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, positions)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)  # strided views
    out = prefill_attention(qt, kt, vt)  # (B, H, S, D)
    y = out.transpose(1, 2).reshape(b, s, cfg.num_heads * cfg.head_dim)
    y = linear_apply(params["wo"], y, cfg.quant)
    return y, (kt, vt)


def attention_prefill_chunk(params: dict, x: torch.Tensor, k_prefix: torch.Tensor,
                            v_prefix: torch.Tensor, prefix_len: int, cfg: ModelConfig,
                            positions: torch.Tensor) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Chunked-prefill attention: x (B, C, d), one chunk of the prompt at
    global positions ``prefix_len + [0, C)``; k_prefix/v_prefix (B, Hkv, W,
    D) the f32 mirror of the prompt's KV, valid in [0, prefix_len) and
    garbage beyond.  Query q may attend prefix key i < prefix_len and chunk
    keys at or before it.  Plain f32 matmuls and a softmax over the scores
    masked with -1e30, as the JAX package computes it (it has no kernel for
    this path).  Returns (y, (k, v)) with the chunk's K/V (B, Hkv, C, D)."""
    _check_slice(cfg)
    b, c, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cap = k_prefix.shape[2]
    q, k, v = _project_qkv(params, x, cfg, positions)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
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
    y = linear_apply(params["wo"], out.transpose(1, 2).reshape(b, c, h * hd), cfg.quant)
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


def _decode_new_token(params: dict, x: torch.Tensor, lengths: torch.Tensor, cfg: ModelConfig,
                      attend_cache) -> Tuple[torch.Tensor, KVCache]:
    """The decode engine's body, shared by both cache layouts: project the
    one new token, attend over the existing cache through
    ``attend_cache(qd) -> (out, l, m)``, merge the fresh token in f32 and
    output-project.  Returns (y, the new token's K/V (B, Hkv, 1, D)); the
    caller scatters it."""
    _check_slice(cfg)
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _project_qkv(params, x, cfg, lengths[:, None])
    qd = q.reshape(b, h, hd)
    k_new = k.transpose(1, 2)  # (B, Hkv, 1, D)
    v_new = v.transpose(1, 2)
    out_c, l_c, m_c = attend_cache(qd)
    out = _merge_new_token(out_c, l_c, m_c, qd, k_new, v_new, 1.0 / math.sqrt(hd)).to(x.dtype)
    y = linear_apply(params["wo"], out.reshape(b, 1, h * hd), cfg.quant)
    return y, KVCache(k_new, v_new)


def attention_decode(params: dict, x: torch.Tensor, cache: KVCache, lengths: torch.Tensor,
                     cfg: ModelConfig) -> Tuple[torch.Tensor, KVCache]:
    """The decode engine: one token (x (B,1,d)) against this layer's cache
    (leaves (B, Hkv, Smax, ·), possibly strided views, possibly QuantKV).
    The cache is only read."""

    def attend(qd):
        k_arr, v_arr, qkw = _kv_leaf_args(cache.k, cache.v)
        return decode_attention(qd, k_arr, v_arr, lengths, return_stats=True, **qkw)

    return _decode_new_token(params, x, lengths, cfg, attend)


def attention_decode_paged(params: dict, x: torch.Tensor, k_pages, v_pages,
                           block_tables: torch.Tensor, lengths: torch.Tensor,
                           cfg: ModelConfig) -> Tuple[torch.Tensor, KVCache]:
    """The decode engine over the paged pool: one token against this
    layer's pages (N, Hkv, bs, ·), walked through ``block_tables`` (B, P).
    Same contract as ``attention_decode``."""

    def attend(qd):
        k_arr, v_arr, qkw = _kv_leaf_args(k_pages, v_pages)
        return paged_decode_attention(qd, k_arr, v_arr, block_tables, lengths,
                                      return_stats=True, **qkw)

    return _decode_new_token(params, x, lengths, cfg, attend)
