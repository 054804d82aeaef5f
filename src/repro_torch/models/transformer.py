"""Decoder-only transformer, dense and MoE (bitnet, smollm, deepseek, qwen,
minicpm, chameleon, granite, moonshot) — the PD-Swap phase programs.

Layer-stacked parameters (leading dim = num_layers) in plain dicts, as in
the JAX package; a Python loop over layers takes the place of its scan.
Entry points:
  * ``forward_hidden`` / ``forward_train`` / ``loss_fn`` — the training
    pass: every layer's plain paths (no kernel: a kernel's output has no
    gradient), the quantization-aware linears of a ternary config, each
    layer recomputed in backward under ``cfg.remat``, and the chunked loss;
  * ``forward_prefill`` — full causal pass -> last-position logits + per-layer
    KV, or (``split_tail=True``) the hidden state right after the last
    layer's attention, the point where the KV relayout can start;
  * ``prefill_tail``    — the rest: last FFN + norm + logits;
  * ``prefill_chunk`` / ``prefill_chunk_paged`` — one bounded chunk of a
    prompt, its KV installed into the decode cache or its pages;
  * ``decode_step``     — one token against the batch-leading cache;
  * ``decode_step_paged`` — one token against the paged pool;
  * ``verify`` / ``verify_paged`` — speculative decoding's verify pass: a
    W = k + 1 token block a slot ([last token, draft_1..draft_k]) scored in
    one forward against either cache, its rows installed in place.

Cache and pool leaves are bf16 tensors, or ``QuantKV`` (packed payload +
f32 scale plane) under ``kv_dtype`` int8/int4.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.layers.attention import (
    KVCache,
    attention_decode,
    attention_decode_paged,
    attention_init,
    attention_prefill,
    attention_prefill_chunk,
    attention_verify,
    attention_verify_paged,
    scatter_new_tokens_paged_q,
    scatter_new_tokens_q,
    verify_plan,
    write_chunk_kv_q,
    write_prefill_pages_q,
)
from repro_torch.layers.mlp import mlp_apply, mlp_init
from repro_torch.layers.moe import moe_apply, moe_forward, moe_init
from repro_torch.layers.norm import apply_norm, apply_norm_blocks, rmsnorm_init
from repro_torch.quant.kv_quant import QuantKV, assert_kv_dtype
from repro_torch.quant.ternary import TernaryWeight, quantize_and_pack_stacked
from repro_torch.train.losses import chunked_ce_loss

LINEARS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
           ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down"))


def _check_window(cfg: ModelConfig) -> None:
    """No config of the family sets a sliding window, and its programs take
    none (hymba's windowed layers are ``models.hymba``'s)."""
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            f"{cfg.name}: the transformer family's programs take no sliding window")


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def layer_params(layers, li: int):
    """Layer ``li`` of a layer-stacked params tree (tensors and TernaryWeights)."""
    if isinstance(layers, dict):
        return {k: layer_params(v, li) for k, v in layers.items()}
    return layers[li]


def unbind_layers(layers) -> list:
    """The per-layer trees of a layer-stacked tree, each leaf taken apart
    once with ``torch.unbind``.  Indexing ``layers[li]`` layer by layer
    would make each layer's backward a ``select`` backward that allocates
    and adds a whole (L, ...) gradient; an unbind's backward stacks the L
    gradients once."""
    if isinstance(layers, dict):
        per = {k: unbind_layers(v) for k, v in layers.items()}
        n = len(next(iter(per.values())))
        return [{k: per[k][i] for k in per} for i in range(n)]
    if isinstance(layers, TernaryWeight):
        return [TernaryWeight(p, s) for p, s in zip(torch.unbind(layers.packed),
                                                    torch.unbind(layers.scale))]
    return list(torch.unbind(layers))


def remat(fn, mode: str):
    """``fn`` under activation checkpointing ``mode``, as the JAX
    ``_remat``: ``"none"`` saves every activation; ``"full"`` saves only
    ``fn``'s inputs and recomputes the rest in backward.  ``"dots"`` (JAX:
    also keep the matmuls with no batch dims) recomputes everything here,
    as ``"full"``: the policy moves memory, never a number.  With grad
    disabled ``fn`` runs as it is."""
    if mode == "none":
        return fn
    if mode not in ("full", "dots"):
        raise ValueError(f"remat must be 'full', 'dots' or 'none', got {mode!r}")

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)

    return wrapped


def _cast_layer(lp: dict, dtype: torch.dtype) -> dict:
    """A layer's f32 draws in the weight dtype: the linears and their biases
    (the expert stacks are drawn in it); norm scales and the router stay
    f32, as in the JAX package."""
    return {g: ({n: {k: t.to(dtype) for k, t in lin.items()} for n, lin in sub.items()}
                if g in ("attn", "mlp") else sub) for g, sub in lp.items()}


def _put(dst, li: int, src) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _put(dst[k], li, src[k])
    else:
        dst[li].copy_(src)


def _alloc(lp, n: int):
    if isinstance(lp, dict):
        return {k: _alloc(v, n) for k, v in lp.items()}
    return torch.empty((n,) + lp.shape, dtype=lp.dtype, device=lp.device)


def init(cfg: ModelConfig, seed: int = 0, *, device=None,
         dtype: torch.dtype = torch.bfloat16) -> dict:
    """Weights with the JAX package's distributions (embedding N(0, 0.02^2),
    linears N(0, 1/K) with zero biases, norms 1, MoE as ``moe_init``), drawn
    from a ``torch.Generator`` seeded with ``seed`` on the target device, in
    ``dtype`` (bf16 by default, as the JAX ``init``).  Each layer is drawn
    in f32 and cast into the layer-stacked tree before the next, so the
    peak stays one f32 layer above the model.  A ternary config keeps its
    latent weights f32 (``convert_for_inference`` packs them)."""
    _check_window(cfg)
    dev = resolve_device(device)
    if cfg.quant.ternary:
        dtype = torch.float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    vp = cfg.padded_vocab()
    emb = (torch.randn((vp, cfg.d_model), generator=gen, device=dev) * 0.02).to(dtype)
    layers = None
    for li in range(cfg.num_layers):
        lp = {"attn": attention_init(cfg, gen, dev),
              "ln1": rmsnorm_init(cfg.d_model, device=dev),
              "ln2": rmsnorm_init(cfg.d_model, device=dev)}
        if cfg.moe:
            lp["moe"] = moe_init(cfg, gen, dev, dtype)
        else:
            lp["mlp"] = mlp_init(cfg, gen, dev)
        lp = _cast_layer(lp, dtype)
        if layers is None:
            layers = _alloc(lp, cfg.num_layers)
        _put(layers, li, lp)
        del lp
    params = {"emb": emb, "layers": layers, "ln_f": rmsnorm_init(cfg.d_model, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = (torch.randn((cfg.d_model, vp), generator=gen, device=dev)
                             * 0.02).to(dtype)
    return params


def convert_for_inference(params: dict, cfg: ModelConfig) -> dict:
    """Latent ternary linears -> packed ``TernaryWeight`` (one absmean scale
    per layer): the one-time conversion that puts every linear on the TLMM
    kernel.  Dense configs are returned unchanged.  An MoE layer's expert
    stacks stay latent (fake-quantized at each call, as in the JAX
    package): only its attention linears are packed."""
    if not cfg.quant.ternary:
        return params
    layers = {g: dict(sub) for g, sub in params["layers"].items()}
    for group, name in LINEARS:
        if group not in layers:
            continue
        lin = dict(layers[group][name])
        if not isinstance(lin["w"], TernaryWeight):
            lin["w"] = quantize_and_pack_stacked(lin["w"])
        layers[group][name] = lin
    return {**params, "layers": layers}


def _embed(params, tokens):
    return params["emb"][tokens]


def _head(params, cfg: ModelConfig) -> torch.Tensor:
    return params["emb"].T if cfg.tie_embeddings else params["lm_head"]


def _logits(params, x, cfg: ModelConfig, norm=apply_norm) -> torch.Tensor:
    x = norm(params["ln_f"], x, cfg.norm, cfg.norm_eps)
    return x.float() @ _head(params, cfg).float()  # full f32: TF32 is off (see repro_torch)


def _ffn(lp: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A layer's FFN: the MoE (its aux loss, which serving discards, is not
    computed) or the dense SwiGLU."""
    if cfg.moe:
        return moe_forward(lp["moe"], h, cfg)
    return mlp_apply(lp["mlp"], h, cfg)


def _block_train(x, lp, positions, cfg: ModelConfig):
    """One layer of the training pass: (x, the layer's aux loss, f32)."""
    h = apply_norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
    attn_out, _ = attention_prefill(lp["attn"], h, positions, cfg, training=True)
    x = x + attn_out
    h = apply_norm(lp["ln2"], x, cfg.norm, cfg.norm_eps)
    if cfg.moe:
        ffn_out, aux = moe_apply(lp["moe"], h, cfg, training=True)
    else:
        ffn_out = mlp_apply(lp["mlp"], h, cfg, training=True)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + ffn_out, aux


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """The training pass over tokens (B, S): (the final normed hidden state
    (B, S, d), the layers' aux losses summed, f32).  Every layer takes the
    plain attention paths, and the linears of a ternary config are
    quantization-aware.  Each layer runs under ``cfg.remat``."""
    _check_window(cfg)
    b, s = tokens.shape
    x = _embed(params, tokens)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    body = remat(_block_train, cfg.remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in unbind_layers(params["layers"]):
        x, aux_l = body(x, lp, positions, cfg)
        aux = aux + aux_l
    return apply_norm(params["ln_f"], x, cfg.norm, cfg.norm_eps), aux


def forward_train(params: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """The full logits (B, S, Vp) f32 and the aux loss: the small-model
    path; training takes ``loss_fn``, which never holds them whole."""
    x, aux = forward_hidden(params, tokens, cfg)
    return x.float() @ _head(params, cfg).float(), aux


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, aux_weight: float = 0.01):
    """batch: tokens (B, S), targets (B, S), mask (B, S).  Returns (nll +
    aux_weight * aux / num_layers, {"nll", "aux"}), as the JAX ``loss_fn``."""
    x, aux = forward_hidden(params, batch["tokens"], cfg)
    loss = chunked_ce_loss(x, _head(params, cfg), batch["targets"], batch["mask"])
    return loss + aux_weight * aux / max(cfg.num_layers, 1), {"nll": loss, "aux": aux}


def _block_prefill(x, lp, positions, cfg):
    h = apply_norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
    attn_out, kv = attention_prefill(lp["attn"], h, positions, cfg)
    x = x + attn_out
    h = apply_norm(lp["ln2"], x, cfg.norm, cfg.norm_eps)
    return x + _ffn(lp, h, cfg), kv


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
    _check_window(cfg)
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
    x_out = x_mid + _ffn(last, h2, cfg)
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
    _check_window(cfg)
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
        x = x + _ffn(lp, h, cfg)
        ks.append(k)
        vs.append(v)
    tok_k, tok_v = torch.stack(ks), torch.stack(vs)
    prefix.k.index_copy_(3, positions[0], tok_k.to(prefix.k.dtype))
    prefix.v.index_copy_(3, positions[0], tok_v.to(prefix.v.dtype))
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


def prefill_chunk_kv(params: dict, tokens: torch.Tensor, prefix: KVCache, prefix_len, last_pos,
                     cfg: ModelConfig, prefix_width: Optional[int] = None):
    """One chunk computed with no install: the disaggregated prefill pool's
    chunk program.  The math of ``prefill_chunk`` / ``prefill_chunk_paged``
    (the same body, the same logits epilogue); the chunk's f32 KV is
    returned instead of written, so the decode pool can install it with the
    quantize-on-write writer the fused programs run.  Returns (logits (1,
    Vp) of ``last_pos``, chunk KV (L, 1, Hkv, C, D) f32, prefix)."""
    x, tok_k, tok_v, prefix = _prefill_chunk_body(params, tokens, prefix, prefix_len, cfg,
                                                  prefix_width)
    return _logits(params, _at(x, last_pos), cfg)[:, -1, :], KVCache(tok_k, tok_v), prefix


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


def _layer_view(leaf, li: int):
    """Layer ``li`` of a cache or pool leaf as a one-layer (.., 1, Hkv, ·)
    view, which a writer of all layers' rows updates in place."""
    if isinstance(leaf, QuantKV):
        return QuantKV(leaf.q[:, li:li + 1], leaf.scale[:, li:li + 1])
    return leaf[:, li:li + 1]


def _decode_layers(params: dict, tokens: torch.Tensor, cfg: ModelConfig, attend_layer,
                   norm=apply_norm):
    """The layer walk of one decode step over W tokens a sequence (W = 1,
    or a verify block, which takes ``apply_norm_blocks``):
    ``attend_layer(lp, h, li)`` runs layer li's attention over the cache.
    Returns (logits (B, W, Vp), the new tokens' K and V, each (L, B, Hkv,
    W, D))."""
    x = _embed(params, tokens)
    tok_k, tok_v = [], []
    for li in range(cfg.num_layers):
        lp = layer_params(params["layers"], li)
        h = norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
        attn_out, new_kv = attend_layer(lp["attn"], h, li)
        x = x + attn_out
        h = norm(lp["ln2"], x, cfg.norm, cfg.norm_eps)
        x = x + _ffn(lp, h, cfg)
        tok_k.append(new_kv.k)
        tok_v.append(new_kv.v)
    return _logits(params, x, cfg, norm), torch.stack(tok_k), torch.stack(tok_v)


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

    logits, tok_k, tok_v = _decode_layers(params, token[:, None], cfg, attend)
    scatter_new_tokens_q(cache.k, tok_k, lengths)
    scatter_new_tokens_q(cache.v, tok_v, lengths)
    return logits[:, 0], cache


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

    logits, tok_k, tok_v = _decode_layers(params, token[:, None], cfg, attend)
    scatter_new_tokens_paged_q(pages.k, tok_k, block_tables, lengths)
    scatter_new_tokens_paged_q(pages.v, tok_v, block_tables, lengths)
    return logits[:, 0], pages


def verify(params: dict, tokens: torch.Tensor, cache: KVCache, lengths: torch.Tensor,
           n_tokens: torch.Tensor, cfg: ModelConfig):
    """The speculative verify pass over the contiguous cache: tokens (B, W)
    int, per slot [last token, draft_1..draft_k]; cache (B, L, Hkv, Smax,
    ·); lengths (B,) int32 tokens already cached; n_tokens (B,) int32 real
    rows a slot (draft length + 1; 0 sits the round out).  Returns (logits
    (B, W, Vp) — every block position's target — and the cache).

    Where the JAX package attends a dense view of the cache extended by the
    storage-rounded block rows and scatters all layers' rows after its
    scan, each layer here writes its block rows i < n_tokens[b] into its
    own slice first (quantized on write; layer li reads only layer li's
    slice, so the final bytes are the same) and then walks them back
    through the decode kernel, so row i reads what decode reads at position
    ``lengths[b] + i``, rounded as the cache stores it; the norms take
    their statistics at decode's row count (``apply_norm_blocks``).  Rows past
    n_tokens are dropped and their logits are garbage the engine ignores;
    rejected rows are rolled back by the slot's length (and, paged, by
    releasing overshoot pages).  The rows' targets are found once a round
    (``verify_plan``), not once a layer."""
    leaf = cache.k.q if isinstance(cache.k, QuantKV) else cache.k
    plan = verify_plan(lengths, n_tokens, tokens.shape[1], smax=leaf.shape[3])

    def attend(lp, h, li):
        layer = KVCache(_layer_view(cache.k, li), _layer_view(cache.v, li))
        return attention_verify(lp, h, layer, plan, cfg)

    return _decode_layers(params, tokens, cfg, attend, apply_norm_blocks)[0], cache


def verify_paged(params: dict, tokens: torch.Tensor, pages: KVCache, block_tables: torch.Tensor,
                 lengths: torch.Tensor, n_tokens: torch.Tensor, cfg: ModelConfig):
    """``verify`` over the paged pool (N, L, Hkv, bs, ·) walked through
    ``block_tables`` (B, P) int32: block row i of slot b lands in page
    ``tables[b, (lengths[b] + i) // bs]``; slots of length 0 write nothing.
    Returns (logits (B, W, Vp), pages)."""
    leaf = pages.k.q if isinstance(pages.k, QuantKV) else pages.k
    plan = verify_plan(lengths, n_tokens, tokens.shape[1], block_tables=block_tables,
                       block_size=leaf.shape[3])

    def attend(lp, h, li):
        return attention_verify_paged(lp, h, _layer_view(pages.k, li), _layer_view(pages.v, li),
                                      plan, cfg)

    return _decode_layers(params, tokens, cfg, attend, apply_norm_blocks)[0], pages
