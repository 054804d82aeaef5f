"""Attention layer: the *dynamic region* of PD-Swap.

One parameter set, two phase-specialized execution paths (the two engines):

* ``attention_prefill`` — the whole prompt through the causal prefill
  attention kernel (compute-bound engine).
* ``attention_decode``  — one token against the KV cache through the decode
  attention kernel (bandwidth-bound engine), with per-sequence lengths for
  continuous batching.  The new token is folded in by an online-softmax
  merge, so the cache is only read during the layer walk; the caller writes
  every layer's new token afterwards with one ``scatter_new_tokens``.

Projections are TLMM/dense linears — the paper's static region.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.prefill_attention.ops import prefill_attention
from repro_torch.layers.linear import linear_apply, linear_init
from repro_torch.layers.rotary import apply_rope


class KVCache(NamedTuple):
    k: torch.Tensor
    v: torch.Tensor


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


def scatter_new_tokens(buf: torch.Tensor, new: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Write every layer's new token into the decode cache in one in-place
    update.  buf: (B, L, Hkv, Smax, D), batch-leading; new: (L, B, Hkv, 1, D).
    The write lands at ``min(lengths, Smax - 1)``: a full slot (or a parked
    one) overwrites its last row, as the JAX package's clamped update does."""
    b, _, _, smax, _ = buf.shape
    idx = torch.clamp(lengths.long(), max=smax - 1)
    rows = torch.arange(b, device=buf.device)
    buf[rows, :, :, idx] = new[:, :, :, 0, :].permute(1, 0, 2, 3).to(buf.dtype)
    return buf


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


def attention_decode(params: dict, x: torch.Tensor, cache: KVCache, lengths: torch.Tensor,
                     cfg: ModelConfig) -> Tuple[torch.Tensor, KVCache]:
    """The decode engine: one token (x (B,1,d)) against this layer's cache
    (k/v (B, Hkv, Smax, D), possibly strided views).  The cache is only read:
    returns (y, the new token's K/V (B, Hkv, 1, D)); the caller scatters it."""
    _check_slice(cfg)
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _project_qkv(params, x, cfg, lengths[:, None])
    qd = q.reshape(b, h, hd)
    k_new = k.transpose(1, 2)  # (B, Hkv, 1, D)
    v_new = v.transpose(1, 2)
    out_c, l_c, m_c = decode_attention(qd, cache.k, cache.v, lengths, return_stats=True)
    out = _merge_new_token(out_c, l_c, m_c, qd, k_new, v_new, 1.0 / math.sqrt(hd)).to(x.dtype)
    y = linear_apply(params["wo"], out.reshape(b, 1, h * hd), cfg.quant)
    return y, KVCache(k_new, v_new)
