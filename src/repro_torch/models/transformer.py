"""Decoder-only dense transformer (bitnet-730m) — the PD-Swap phase programs.

Layer-stacked parameters (leading dim = num_layers) in plain dicts, as in
the JAX package; a Python loop over layers takes the place of its scan.
Entry points:
  * ``forward_prefill`` — full causal pass -> last-position logits + per-layer
    KV, or (``split_tail=True``) the hidden state right after the last
    layer's attention, the point where the KV relayout can start;
  * ``prefill_tail``    — the rest: last FFN + norm + logits;
  * ``decode_step``     — one token against the batch-leading cache.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.layers.attention import (
    KVCache,
    attention_decode,
    attention_init,
    attention_prefill,
    scatter_new_tokens,
)
from repro_torch.layers.mlp import mlp_apply, mlp_init
from repro_torch.layers.norm import apply_norm, rmsnorm_init
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


def _at(x, last_pos: Optional[int]):
    return x[:, -1:, :] if last_pos is None else x[:, last_pos:last_pos + 1, :]


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


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               kv_dtype: str = "fp", device=None) -> KVCache:
    """The batch-leading decode cache (B, L, Hkv, max_len, D), zeroed: all
    layers' new tokens of one sequence land in one contiguous window."""
    if kv_dtype != "fp":
        raise NotImplementedError(f"kv_dtype={kv_dtype!r}: quantized KV is ROADMAP A6")
    dev = resolve_device(device)
    shape = (batch, cfg.num_layers, cfg.num_kv_heads, max_len, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev))


def decode_step(params: dict, token: torch.Tensor, cache: KVCache, lengths: torch.Tensor,
                cfg: ModelConfig):
    """One decode step for every slot: token (B,) int, cache (B, L, Hkv,
    Smax, D), lengths (B,) int32 tokens already cached.  Returns (logits
    (B, Vp), cache).

    The cache is only read while the layers run (each layer attends over
    its strided slice ``cache[:, li]`` and merges its fresh token in f32);
    afterwards one ``scatter_new_tokens`` writes all layers' new tokens in
    place, cast to the cache dtype.  Writing a token before attending would
    count it twice."""
    x = _embed(params, token)[:, None, :]
    tok_k, tok_v = [], []
    for li in range(cfg.num_layers):
        lp = layer_params(params["layers"], li)
        h = apply_norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
        attn_out, new_kv = attention_decode(
            lp["attn"], h, KVCache(cache.k[:, li], cache.v[:, li]), lengths, cfg)
        x = x + attn_out
        h = apply_norm(lp["ln2"], x, cfg.norm, cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], h, cfg)
        tok_k.append(new_kv.k)
        tok_v.append(new_kv.v)
    scatter_new_tokens(cache.k, torch.stack(tok_k), lengths)
    scatter_new_tokens(cache.v, torch.stack(tok_v), lengths)
    return _logits(params, x, cfg)[:, 0, :], cache
