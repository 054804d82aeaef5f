"""Whisper-style encoder-decoder with a stubbed conv frontend — the port of
``repro.models.encdec``.

The encoder takes precomputed frame embeddings (B, encoder_seq, d_model)
(the JAX package's stub).  LayerNorm + GELU, sinusoidal encoder positions,
learned decoder positions, no RoPE.

The encoder is prefill only: its non-causal attention over 1,500 frames is
the chunked plain path (the JAX package has no kernel for it).  The
decoder's self-attention swaps programs as a transformer's does: its causal
prefill runs the prefill attention kernel, its decode the decode attention
kernel.  Cross-attention K/V are computed once after encoding; the
decoder's prefill attends them through the plain path (1,500 keys, not
causal), its decode walks them through the decode attention kernel, over a
cache padded to a multiple of 128 rows (1,500 -> 1,536) whose pad the walk
length ``encoder_seq`` masks.  The training pass (``loss_fn``) encodes
``batch["frames"]`` and runs the decoder on the plain attention paths
(never the kernel: its output has no gradient), each decoder layer
recomputed in backward unless ``cfg.remat`` is "none"; the head is the
tied embedding.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.kv_cache import insert_prefill_kv
from repro_torch.layers.attention import (
    KVCache,
    attention_decode,
    attention_prefill,
    project_cross_kv,
    scatter_new_tokens,
)
from repro_torch.layers.mlp import mlp_apply
from repro_torch.layers.norm import apply_norm
from repro_torch.layers.sharding import NULL_CTX, PartitionCtx
from repro_torch.models.jax_init import init_like_jax
from repro_torch.models.transformer import (
    _embed,
    _train_top,
    check_mesh_model,
    layer_params,
    remat,
    unbind_layers,
    vocab_parallel_loss,
)


class EncDecCache(NamedTuple):
    self_kv: KVCache  # (L, B, Hkv, S, D) from prefill; (B, L, Hkv, Smax, D) to decode
    cross_kv: KVCache  # (L, B, Hkv, Senc_padded, D) from prefill; (B, L, ...) to decode


def _sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """(length, channels) f32: sin then cos of position times the
    geometric timescales, computed in f32 as the JAX package does."""
    log_timescale = torch.log(torch.tensor(10000.0, device=device)) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2, device=device))
    ang = torch.arange(length, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def init(cfg: ModelConfig, seed: int = 0, *, device=None,
         dtype: torch.dtype = torch.bfloat16) -> dict:
    """The JAX ``init``'s weights (``init_like_jax``), drawn on the target
    device: the linears, embeddings and decoder positions in ``dtype``
    (bf16 by default), the LayerNorms f32."""
    dev = resolve_device(device)
    return init_like_jax(cfg, seed, dev, draw_device=dev, dtype=dtype)


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig,
           pctx: PartitionCtx = NULL_CTX) -> torch.Tensor:
    """frames (B, Senc, d), the conv frontend's stub -> the encoder's
    output.  The inference linears, as the JAX package's ``encode`` runs
    them, even in training; on a training mesh (``pctx``; ``frames`` this
    data rank's rows) the layers' weights are gathered over data and their
    heads and d_ff are over the model axis, as the decoder's."""
    b, s, d = frames.shape
    train_mesh = pctx.mesh is not None
    x = frames + _sinusoids(s, d, frames.device).to(frames.dtype)[None]
    positions = torch.arange(s, device=frames.device).expand(b, s)
    for lp in unbind_layers(params["enc_layers"]):
        h = apply_norm(lp["ln1"], x, "layernorm", cfg.norm_eps)
        attn_out, _ = attention_prefill(lp["attn"], h, positions, cfg, causal=False,
                                        training=train_mesh, pctx=pctx)
        x = x + attn_out
        h = apply_norm(lp["ln2"], x, "layernorm", cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], h, cfg, training=train_mesh, pctx=pctx)
    return apply_norm(params["ln_enc"], x, "layernorm", cfg.norm_eps)


def compute_cross_kv(params: dict, enc_out: torch.Tensor, cfg: ModelConfig,
                     pctx: PartitionCtx = NULL_CTX) -> KVCache:
    """Every decoder layer's cross K/V of the encoder output, once:
    (L, B, Hkv, Senc, D) each (on a training mesh this rank's heads, each
    layer's ``wk``/``wv`` gathered over data)."""
    ks, vs = zip(*(project_cross_kv(lp["cross"], enc_out, cfg, pctx)
                   for lp in unbind_layers(params["dec_layers"])))
    return KVCache(torch.stack(ks), torch.stack(vs))


def _dec_block_prefill(x, lp, positions, cross_k, cross_v, cfg: ModelConfig,
                       training: bool = False, pctx: PartitionCtx = NULL_CTX):
    h = apply_norm(lp["ln1"], x, "layernorm", cfg.norm_eps)
    attn_out, kv = attention_prefill(lp["attn"], h, positions, cfg, training=training, pctx=pctx)
    x = x + attn_out
    h = apply_norm(lp["lnx"], x, "layernorm", cfg.norm_eps)
    cross_out, _ = attention_prefill(lp["cross"], h, positions, cfg, cross_kv=(cross_k, cross_v),
                                     training=training, pctx=pctx)
    x = x + cross_out
    h = apply_norm(lp["ln2"], x, "layernorm", cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h, cfg, training=training, pctx=pctx), kv


def _dec_block_train(x, lp, positions, cross_k, cross_v, cfg: ModelConfig,
                     pctx: PartitionCtx = NULL_CTX):
    return _dec_block_prefill(x, lp, positions, cross_k, cross_v, cfg, training=True,
                              pctx=pctx)[0]


def _decoder_hidden(params: dict, tokens: torch.Tensor, cross: KVCache, cfg: ModelConfig,
                    pctx: PartitionCtx = NULL_CTX, *, emb=None) -> torch.Tensor:
    """The training pass of the decoder over tokens (B, S) against the
    cross K/V: the final normed hidden state (B, S, d).  ``emb`` is the
    gathered embedding shard (``_train_top``) on a mesh, where given;
    ``pos_dec`` and the LayerNorms are whole on every rank."""
    b, s = tokens.shape
    if emb is None:
        emb = _train_top(params, cfg, pctx)[0]
    x = _embed(emb, tokens, pctx) + params["pos_dec"][:s][None]
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    body = remat(_dec_block_train, cfg.remat)
    for lp, ck, cv in zip(unbind_layers(params["dec_layers"]), cross.k.unbind(0),
                          cross.v.unbind(0)):
        x = body(x, lp, positions, ck, cv, cfg, pctx)
    return apply_norm(params["ln_f"], x, "layernorm", cfg.norm_eps)


def forward_train(params: dict, batch_inputs: dict, cfg: ModelConfig):
    """batch_inputs: "frames" (B, Senc, d) and "tokens" (B, S) -> the full
    logits (B, S, Vp) f32 and a zero aux loss."""
    enc_out = encode(params, batch_inputs["frames"], cfg)
    x = _decoder_hidden(params, batch_inputs["tokens"], compute_cross_kv(params, enc_out, cfg), cfg)
    return x.float() @ params["emb"].float().T, torch.zeros((), device=x.device)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, aux_weight: float = 0.0,
            pctx: PartitionCtx = NULL_CTX):
    """batch: frames (B, Senc, d), tokens, targets, mask (B, S).  The
    chunked loss over the tied head: (nll, {"nll", "aux": 0}).  On a mesh
    (``pctx``, the train rules; the batch this data rank's rows, its frames
    too) the encoder, the cross K/V and the decoder run on the mesh and
    the loss is vocab-parallel over the embedding shard."""
    check_mesh_model(cfg, pctx, train=True)
    emb, head = _train_top(params, cfg, pctx)
    enc_out = encode(params, batch["frames"], cfg, pctx)
    cross = compute_cross_kv(params, enc_out, cfg, pctx)
    x = _decoder_hidden(params, batch["tokens"], cross, cfg, pctx, emb=emb)
    loss = vocab_parallel_loss(x, head, batch, pctx)
    return loss, {"nll": loss, "aux": torch.zeros((), device=x.device)}


def padded_enc_seq(cfg: ModelConfig) -> int:
    """The cross cache's rows: ``encoder_seq`` padded to a multiple of 128
    (1,500 -> 1,536); the decode walk masks the pad."""
    return ((cfg.encoder_seq + 127) // 128) * 128


def forward_prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                    frames: torch.Tensor):
    """Encode, then the decoder's prefill of tokens (B, S).  Returns (last
    logits (B, Vp), EncDecCache: the self K/V (L, B, Hkv, S, D) and the
    cross K/V padded to ``padded_enc_seq`` rows with zeros)."""
    b, s = tokens.shape
    enc_out = encode(params, frames, cfg)
    cross = compute_cross_kv(params, enc_out, cfg)
    x = params["emb"][tokens] + params["pos_dec"][:s][None]
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    ks, vs = [], []
    for li in range(cfg.num_layers):
        x, (k, v) = _dec_block_prefill(x, layer_params(params["dec_layers"], li), positions,
                                       cross.k[li], cross.v[li], cfg)
        ks.append(k)
        vs.append(v)
    x = apply_norm(params["ln_f"], x, "layernorm", cfg.norm_eps)
    logits = x[:, -1:, :].float() @ params["emb"].float().T
    pad = padded_enc_seq(cfg) - cfg.encoder_seq
    cross_padded = KVCache(*(torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in cross))
    return logits[:, -1, :], EncDecCache(KVCache(torch.stack(ks), torch.stack(vs)), cross_padded)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> EncDecCache:
    """The decode cache, batch-leading: self (B, L, Hkv, max_len, D) and
    cross (B, L, Hkv, ``padded_enc_seq``, D) zeros in ``dtype``."""
    dev = resolve_device(device)
    mk = lambda s: torch.zeros((batch, cfg.num_layers, cfg.num_kv_heads, s, cfg.head_dim),
                               dtype=dtype, device=dev)
    se = padded_enc_seq(cfg)
    return EncDecCache(KVCache(mk(max_len), mk(max_len)), KVCache(mk(se), mk(se)))


def install_prefill(cache: EncDecCache, prefilled: EncDecCache) -> EncDecCache:
    """The logic swap: a prefill's self and cross K/V, layer-major, into the
    same slots of the batch-leading decode cache, in place, through the
    port's relayout (``insert_prefill_kv``)."""
    for buf, new in zip(cache, prefilled):
        for slot in range(new.k.shape[1]):
            insert_prefill_kv(buf, KVCache(new.k[:, slot:slot + 1], new.v[:, slot:slot + 1]), slot)
    return cache


def decode_step(params: dict, token: torch.Tensor, cache: EncDecCache, lengths: torch.Tensor,
                cfg: ModelConfig):
    """One decoder step for every slot: token (B,) at position ``lengths``
    (B,) int32.  Each layer walks its self cache (read only; the fresh
    token merged in f32) and its cross cache's first ``encoder_seq`` rows;
    afterwards one scatter a leaf writes every layer's new self K/V.  The
    cross cache never changes.  Returns (logits (B, Vp), cache)."""
    x = params["emb"][token[:, None]] + params["pos_dec"][lengths.long()][:, None, :]
    tok_k, tok_v = [], []
    for li in range(cfg.num_layers):
        lp = layer_params(params["dec_layers"], li)
        h = apply_norm(lp["ln1"], x, "layernorm", cfg.norm_eps)
        layer = KVCache(cache.self_kv.k[:, li], cache.self_kv.v[:, li])
        attn_out, new_kv = attention_decode(lp["attn"], h, layer, lengths, cfg)
        x = x + attn_out
        h = apply_norm(lp["lnx"], x, "layernorm", cfg.norm_eps)
        cross = KVCache(cache.cross_kv.k[:, li], cache.cross_kv.v[:, li])
        cross_out, _ = attention_decode(lp["cross"], h, cross, lengths, cfg,
                                        cross_len=cfg.encoder_seq)
        x = x + cross_out
        h = apply_norm(lp["ln2"], x, "layernorm", cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], h, cfg)
        tok_k.append(new_kv.k)
        tok_v.append(new_kv.v)
    scatter_new_tokens(cache.self_kv.k, torch.stack(tok_k), lengths)
    scatter_new_tokens(cache.self_kv.v, torch.stack(tok_v), lengths)
    x = apply_norm(params["ln_f"], x, "layernorm", cfg.norm_eps)
    return (x.float() @ params["emb"].float().T)[:, 0, :], cache
