"""Decoder-only dense transformer (bitnet-730m) — the PD-Swap phase programs.

Layer-stacked parameters (leading dim = num_layers) in plain dicts, as in
the JAX package; a Python loop over layers takes the place of its scan.
Entry points:
  * ``forward_prefill`` — full causal pass -> last-position logits + per-layer
    KV, or (``split_tail=True``) the hidden state right after the last
    layer's attention, the point where the KV relayout can start;
  * ``prefill_tail``    — the rest: last FFN + norm + logits;
  * ``prefill_chunk`` / ``prefill_chunk_paged`` — one bounded chunk of a
    prompt, its KV installed into the decode cache or its pages;
  * ``decode_step``     — one token against the batch-leading cache;
  * ``decode_step_paged`` — one token against the paged pool.

Cache and pool leaves are bf16 tensors, or ``QuantKV`` (packed payload +
f32 scale plane) under ``kv_dtype`` int8/int4.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.layers.attention import (
    KVCache,
    attention_decode,
    attention_decode_paged,
    attention_init,
    attention_prefill,
    attention_prefill_chunk,
    scatter_new_tokens_paged_q,
    scatter_new_tokens_q,
    write_chunk_kv_q,
    write_prefill_pages_q,
)
from repro_torch.layers.mlp import mlp_apply, mlp_init
from repro_torch.layers.norm import apply_norm, rmsnorm_init
from repro_torch.quant.kv_quant import QuantKV, assert_kv_dtype
from repro_torch.quant.ternary import TernaryWeight, quantize_and_pack_stacked

LINEARS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
           ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down"))


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "transformer" or cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense transformers (other families: ROADMAP A12)")


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def layer_params(layers, li: int):
    """Layer ``li`` of a layer-stacked params tree (tensors and TernaryWeights)."""
    if isinstance(layers, dict):
        return {k: layer_params(v, li) for k, v in layers.items()}
    return layers[li]


def init(cfg: ModelConfig, seed: int = 0, *, device=None) -> dict:
    """Latent f32 weights with the JAX package's distributions (embedding
    N(0, 0.02^2), linears N(0, 1/K), norms 1), drawn from a
    ``torch.Generator`` seeded with ``seed`` on the target device."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    vp = cfg.padded_vocab()
    emb = torch.randn((vp, cfg.d_model), generator=gen, device=dev) * 0.02
    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "attn": attention_init(cfg, gen, dev),
            "ln1": rmsnorm_init(cfg.d_model, device=dev),
            "ln2": rmsnorm_init(cfg.d_model, device=dev),
            "mlp": mlp_init(cfg, gen, dev),
        })
    params = {"emb": emb, "layers": _stack(layers), "ln_f": rmsnorm_init(cfg.d_model, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = torch.randn((cfg.d_model, vp), generator=gen, device=dev) * 0.02
    return params


def convert_for_inference(params: dict, cfg: ModelConfig) -> dict:
    """Latent ternary linears -> packed ``TernaryWeight`` (one absmean scale
    per layer): the one-time conversion that puts every linear on the TLMM
    kernel.  Dense configs are returned unchanged."""
    if not cfg.quant.ternary:
        return params
    layers = {g: dict(sub) for g, sub in params["layers"].items()}
    for group, name in LINEARS:
        lin = dict(layers[group][name])
        if not isinstance(lin["w"], TernaryWeight):
            lin["w"] = quantize_and_pack_stacked(lin["w"])
        layers[group][name] = lin
    return {**params, "layers": layers}


def _embed(params, tokens):
    return params["emb"][tokens]


def _logits(params, x, cfg: ModelConfig) -> torch.Tensor:
    x = apply_norm(params["ln_f"], x, cfg.norm, cfg.norm_eps)
    head = params["emb"].T if cfg.tie_embeddings else params["lm_head"]
    return x.float() @ head.float()  # full f32: TF32 is off (see repro_torch)


def _block_prefill(x, lp, positions, cfg):
    h = apply_norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
    attn_out, kv = attention_prefill(lp["attn"], h, positions, cfg)
    x = x + attn_out
    h = apply_norm(lp["ln2"], x, cfg.norm, cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h, cfg), kv


def _at(x, last_pos):
    """Position ``last_pos`` (default the last) of x (B, S, d) as (B, 1, d);
    a 0-d device tensor ``last_pos`` selects on the device."""
    if last_pos is None:
        return x[:, -1:, :]
    if isinstance(last_pos, torch.Tensor):
        return x.index_select(1, last_pos.long().reshape(1))
    return x[:, last_pos:last_pos + 1, :]


def forward_prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                    split_tail: bool = False, last_pos: Optional[int] = None):
    """The prefill engine.  Returns (logits of position ``last_pos`` (default
    S-1) (B, Vp), KVCache of (L, B, Hkv, S, D)), or with ``split_tail=True``
    (x_mid (B, S, d), KVCache) after the last layer's attention: the KV is
    complete there, so the relayout can run while ``prefill_tail`` does.
    Right-padded prompts pass their true last position as ``last_pos``;
    causality keeps it independent of the padding."""
    _check_family(cfg)
    b, s = tokens.shape
    x = _embed(params, tokens)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    n_main = cfg.num_layers - 1 if split_tail else cfg.num_layers
    ks, vs = [], []
    for li in range(n_main):
        x, (k, v) = _block_prefill(x, layer_params(params["layers"], li), positions, cfg)
        ks.append(k)
        vs.append(v)
    if not split_tail:
        logits = _logits(params, _at(x, last_pos), cfg)
        return logits[:, -1, :], KVCache(torch.stack(ks), torch.stack(vs))
    last = layer_params(params["layers"], cfg.num_layers - 1)
    h = apply_norm(last["ln1"], x, cfg.norm, cfg.norm_eps)
    attn_out, (k, v) = attention_prefill(last["attn"], h, positions, cfg)
    ks.append(k)
    vs.append(v)
    return x + attn_out, KVCache(torch.stack(ks), torch.stack(vs))


def prefill_tail(params: dict, x_mid: torch.Tensor, cfg: ModelConfig,
                 last_pos: Optional[int] = None) -> torch.Tensor:
    """The tail after the split: last FFN + norm + logits, (B, Vp)."""
    last = layer_params(params["layers"], cfg.num_layers - 1)
    h2 = apply_norm(last["ln2"], x_mid, cfg.norm, cfg.norm_eps)
    x_out = x_mid + mlp_apply(last["mlp"], h2, cfg)
    return _logits(params, _at(x_out, last_pos), cfg)[:, -1, :]


def _prefill_chunk_body(params: dict, tokens: torch.Tensor, prefix: KVCache, prefix_len,
                        cfg: ModelConfig, prefix_width: Optional[int] = None):
    """One prompt chunk (1, C) through the layer stack, each layer attending
    over the f32 ``prefix`` mirror (L, 1, Hkv, Cap, D) of the prompt's KV,
    valid in [0, prefix_len), plus the chunk itself.  Returns (hidden
    (1, C, d), the chunk's K and V (L, 1, Hkv, C, D), the mirror with the
    chunk written at [prefix_len, prefix_len + C) in place).  ``prefix_len``
    is a Python int or a 0-d integer tensor on the tokens' device (the JAX
    program's traced scalar): the positions, the mask and the mirror write
    are then index ops on it, and an overflow is the caller's to refuse.

    ``prefix_width`` cuts the mirror the attention sees to its first
    positions, so a short prompt's chunks do not attend over its whole
    capacity.  The mirror holds f32 values, not the (possibly quantized)
    cache bytes: the chunk then computes what the whole-prompt prefill
    would, and the per-token quantization on write stores the same bytes."""
    _check_family(cfg)
    b, c = tokens.shape
    cap = prefix.k.shape[3]
    if not isinstance(prefix_len, torch.Tensor) and prefix_len + c > cap:
        raise ValueError(f"chunk rows [{prefix_len}, {prefix_len + c}) overflow the mirror's {cap}")
    x = _embed(params, tokens)
    positions = (prefix_len + torch.arange(c, device=tokens.device)).expand(b, c)
    width = cap if prefix_width is None else min(prefix_width, cap)
    ks, vs = [], []
    for li in range(cfg.num_layers):
        lp = layer_params(params["layers"], li)
        h = apply_norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
        attn_out, (k, v) = attention_prefill_chunk(
            lp["attn"], h, prefix.k[li, :, :, :width], prefix.v[li, :, :, :width], prefix_len,
            cfg, positions)
        x = x + attn_out
        h = apply_norm(lp["ln2"], x, cfg.norm, cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], h, cfg)
        ks.append(k)
        vs.append(v)
    tok_k, tok_v = torch.stack(ks), torch.stack(vs)
    prefix.k.index_copy_(3, positions[0], tok_k)
    prefix.v.index_copy_(3, positions[0], tok_v)
    return x, tok_k, tok_v, prefix


def prefill_chunk(params: dict, tokens: torch.Tensor, cache: KVCache, prefix: KVCache, slot,
                  prefix_len, last_pos, cfg: ModelConfig, prefix_width: Optional[int] = None):
    """One right-padded chunk (1, C) of a prompt installed into slot
    ``slot`` of the contiguous cache at [prefix_len, prefix_len + C)
    (quantized on write under int8/int4).  Returns (logits (1, Vp) of
    chunk-local ``last_pos``, cache, prefix), cache and mirror updated in
    place.  ``slot``, ``prefix_len`` and ``last_pos`` are Python ints or
    0-d integer tensors on the device (then nothing depends on their
    values on the host, and one captured program serves every chunk of its
    shape).  Chunk boundaries are a pure function of the prompt length and
    the chunk size, so a restart re-prefills through the same chunks."""
    x, tok_k, tok_v, prefix = _prefill_chunk_body(params, tokens, prefix, prefix_len, cfg,
                                                  prefix_width)
    write_chunk_kv_q(cache.k, tok_k, slot, prefix_len)
    write_chunk_kv_q(cache.v, tok_v, slot, prefix_len)
    return _logits(params, _at(x, last_pos), cfg)[:, -1, :], cache, prefix


def prefill_chunk_paged(params: dict, tokens: torch.Tensor, pages: KVCache, prefix: KVCache,
                        page_ids: torch.Tensor, prefix_len, last_pos, cfg: ModelConfig,
                        prefix_width: Optional[int] = None):
    """``prefill_chunk`` into the paged pool: the chunk (C a multiple of
    the page size, starting on a page boundary) writes whole pages
    ``page_ids`` (C / bs,); ids >= N (prefix-cache hits, padding) are
    skipped.  Returns (logits (1, Vp), pages, prefix)."""
    leaf = pages.k.q if isinstance(pages.k, QuantKV) else pages.k
    bs = leaf.shape[3]
    x, tok_k, tok_v, prefix = _prefill_chunk_body(params, tokens, prefix, prefix_len, cfg,
                                                  prefix_width)
    write_prefill_pages_q(pages.k, tok_k, page_ids, block_size=bs)
    write_prefill_pages_q(pages.v, tok_v, page_ids, block_size=bs)
    return _logits(params, _at(x, last_pos), cfg)[:, -1, :], pages, prefix


def _kv_buffer(shape, dtype, kv_dtype: str, device):
    """One K or V buffer: a zeroed fp tensor, or a QuantKV of a zeroed
    payload (int8, or uint8 nibble pairs for int4) and a scale plane of
    ones, as the JAX package starts them."""
    assert_kv_dtype(kv_dtype)
    if kv_dtype == "fp":
        return torch.zeros(shape, dtype=dtype, device=device)
    d = shape[-1]
    if kv_dtype == "int4":
        if d % 2:
            raise ValueError(f"head_dim must be even for int4 nibble packing, got {d}")
        payload = torch.zeros(shape[:-1] + (d // 2,), dtype=torch.uint8, device=device)
    else:
        payload = torch.zeros(shape, dtype=torch.int8, device=device)
    return QuantKV(payload, torch.ones(shape[:-1], dtype=torch.float32, device=device))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               kv_dtype: str = "fp", device=None) -> KVCache:
    """The batch-leading decode cache (B, L, Hkv, max_len, D): all layers'
    new tokens of one sequence land in one contiguous window."""
    dev = resolve_device(device)
    shape = (batch, cfg.num_layers, cfg.num_kv_heads, max_len, cfg.head_dim)
    return KVCache(_kv_buffer(shape, dtype, kv_dtype, dev), _kv_buffer(shape, dtype, kv_dtype, dev))


def init_paged_pool(cfg: ModelConfig, num_blocks: int, block_size: int, dtype=torch.bfloat16,
                    kv_dtype: str = "fp", device=None) -> KVCache:
    """The paged decode cache (N, L, Hkv, block_size, D): the slot axis of
    ``init_cache`` becomes the page axis, each page layer-complete for
    ``block_size`` positions.  Ownership lives in ``serving.paging``."""
    dev = resolve_device(device)
    shape = (num_blocks, cfg.num_layers, cfg.num_kv_heads, block_size, cfg.head_dim)
    return KVCache(_kv_buffer(shape, dtype, kv_dtype, dev), _kv_buffer(shape, dtype, kv_dtype, dev))


def _slice_layer(leaf, li: int):
    """Layer ``li`` (axis 1) of a cache or pool leaf, as a strided view; a
    QuantKV's payload and scale plane are sliced together."""
    if isinstance(leaf, QuantKV):
        return QuantKV(leaf.q[:, li], leaf.scale[:, li])
    return leaf[:, li]


def _decode_layers(params: dict, token: torch.Tensor, cfg: ModelConfig, attend_layer):
    """The layer walk of one decode step: ``attend_layer(lp, h, li)`` runs
    layer li's attention over the (read-only) cache.  Returns (logits
    (B, Vp), the new tokens' K and V, each (L, B, Hkv, 1, D))."""
    x = _embed(params, token)[:, None, :]
    tok_k, tok_v = [], []
    for li in range(cfg.num_layers):
        lp = layer_params(params["layers"], li)
        h = apply_norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
        attn_out, new_kv = attend_layer(lp["attn"], h, li)
        x = x + attn_out
        h = apply_norm(lp["ln2"], x, cfg.norm, cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], h, cfg)
        tok_k.append(new_kv.k)
        tok_v.append(new_kv.v)
    return _logits(params, x, cfg)[:, 0, :], torch.stack(tok_k), torch.stack(tok_v)


def decode_step(params: dict, token: torch.Tensor, cache: KVCache, lengths: torch.Tensor,
                cfg: ModelConfig):
    """One decode step for every slot: token (B,) int, cache (B, L, Hkv,
    Smax, ·), lengths (B,) int32 tokens already cached.  Returns (logits
    (B, Vp), cache).

    The cache is only read while the layers run (each layer attends over
    its strided slice ``cache[:, li]`` and merges its fresh token in f32);
    afterwards one ``scatter_new_tokens_q`` per leaf writes all layers' new
    tokens in place, cast to the cache dtype or quantized from f32.  Writing
    a token before attending would count it twice."""

    def attend(lp, h, li):
        layer = KVCache(_slice_layer(cache.k, li), _slice_layer(cache.v, li))
        return attention_decode(lp, h, layer, lengths, cfg)

    logits, tok_k, tok_v = _decode_layers(params, token, cfg, attend)
    scatter_new_tokens_q(cache.k, tok_k, lengths)
    scatter_new_tokens_q(cache.v, tok_v, lengths)
    return logits, cache


def decode_step_paged(params: dict, token: torch.Tensor, pages: KVCache,
                      block_tables: torch.Tensor, lengths: torch.Tensor, cfg: ModelConfig):
    """One decode step over the paged pool (N, L, Hkv, bs, ·) walked through
    ``block_tables`` (B, P) int32: the structure of ``decode_step``, with
    one ``scatter_new_tokens_paged_q`` per leaf writing every layer's token
    into each sequence's current page.  Slots of length 0 write nothing.
    Returns (logits (B, Vp), pages)."""

    def attend(lp, h, li):
        return attention_decode_paged(lp, h, _slice_layer(pages.k, li), _slice_layer(pages.v, li),
                                      block_tables, lengths, cfg)

    logits, tok_k, tok_v = _decode_layers(params, token, cfg, attend)
    scatter_new_tokens_paged_q(pages.k, tok_k, block_tables, lengths)
    scatter_new_tokens_paged_q(pages.v, tok_v, block_tables, lengths)
    return logits, pages
