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

from typing import NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.kv_cache import MeshInstall, insert_prefill_kv
from repro_torch.layers import collectives as C
from repro_torch.layers.attention import (
    KVCache,
    attention_decode,
    attention_prefill,
    project_cross_kv,
    scatter_new_tokens,
    scatter_new_tokens_seq_shard,
    seq_walk,
    walk_ranks,
)
from repro_torch.layers.linear import train_weight
from repro_torch.layers.mlp import mlp_apply
from repro_torch.layers.norm import apply_norm
from repro_torch.layers.sharding import NULL_CTX, PartitionCtx, cache_block
from repro_torch.models.jax_init import init_like_jax
from repro_torch.models.transformer import (
    _embed,
    _gather_rows,
    _train_top,
    batch_rows,
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
    them, even in training; on a serving mesh (``pctx``, the prefill
    rules; ``frames`` this data rank's rows) the heads and d_ff over the
    model axis, as the decoder's.  On a training mesh (the train rules)
    the layers' weights are gathered over data and, a dense config's
    inference and training linears being one product, the training
    pass's linears run; a ternary config's layers run the inference
    linears of one device on their weights gathered whole
    (``_whole_layer``), every model rank computing every head, so each
    ternary weight is quantized with its whole tensor's absmean."""
    b, s, d = frames.shape
    train_mesh = pctx.fsdp_axis is not None
    whole = train_mesh and cfg.quant.ternary
    ctx, training = (NULL_CTX, False) if whole else (pctx, train_mesh)
    x = frames + _sinusoids(s, d, frames.device).to(frames.dtype)[None]
    positions = torch.arange(s, device=frames.device).expand(b, s)
    for lp in unbind_layers(params["enc_layers"]):
        if whole:
            lp = _whole_layer(lp, cfg, pctx)
        h = apply_norm(lp["ln1"], x, "layernorm", cfg.norm_eps)
        attn_out, _ = attention_prefill(lp["attn"], h, positions, cfg, causal=False,
                                        training=training, pctx=ctx)
        x = x + attn_out
        h = apply_norm(lp["ln2"], x, "layernorm", cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], h, cfg, training=training, pctx=ctx)
    return apply_norm(params["ln_enc"], x, "layernorm", cfg.norm_eps)


def _whole_layer(lp: dict, cfg: ModelConfig, pctx: PartitionCtx) -> dict:
    """An encoder layer of a training mesh rank with every linear's weight
    (and a column bias) gathered whole over data and model
    (``train_weight``: over data the summing reduce-scatter backward, the
    data ranks' rows differing; over model ``"same"``, every model rank
    using all of it alike)."""
    d, f = cfg.d_model, cfg.d_ff
    widths = {"wq": cfg.num_heads * cfg.head_dim, "wk": cfg.num_kv_heads * cfg.head_dim,
              "wv": cfg.num_kv_heads * cfg.head_dim}

    def column(lin, n):
        out = {"w": train_weight(lin["w"], pctx, (d, n), fsdp_dim=0, tp_dim=1, tp="same")}
        if "b" in lin:
            out["b"] = train_weight(lin["b"], pctx, (n,), tp_dim=0, tp="same")
        return out

    def row(lin, k):
        return {**lin, "w": train_weight(lin["w"], pctx, (k, d), fsdp_dim=1, tp_dim=0,
                                         tp="same")}

    attn = {n: column(lp["attn"][n], w) for n, w in widths.items()}
    attn["wo"] = row(lp["attn"]["wo"], widths["wq"])
    mlp = {"w_in": column(lp["mlp"]["w_in"], f), "w_out": row(lp["mlp"]["w_out"], f)}
    return {**lp, "attn": attn, "mlp": mlp}


def compute_cross_kv(params: dict, enc_out: torch.Tensor, cfg: ModelConfig,
                     pctx: PartitionCtx = NULL_CTX) -> KVCache:
    """Every decoder layer's cross K/V of the encoder output, once:
    (L, B, Hkv, Senc, D) each (on a mesh this rank's heads where the model
    axis splits them, each layer's ``wk``/``wv`` gathered over data in
    training)."""
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


def forward_prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                    pctx: PartitionCtx = NULL_CTX, *, frames: torch.Tensor):
    """Encode, then the decoder's prefill of tokens (B, S).  Returns (last
    logits (B, Vp), EncDecCache: the self K/V (L, B, Hkv, S, D) and the
    cross K/V padded to ``padded_enc_seq`` rows with zeros).

    On a serving mesh (``pctx``, the prefill rules) every rank takes the
    whole ``tokens`` and ``frames`` and runs its rows of the batch (the
    frames split over data with them): the encoder, the cross K/V and the
    decoder on its H / tp heads (the decoder's self-attention through the
    prefill kernel on them), the MLPs on its d_ff / tp.  It returns the
    whole batch's logits and its rows' cache of its heads."""
    check_mesh_model(cfg, pctx)
    b, s = tokens.shape
    lo, hi = batch_rows(pctx, b)
    tokens = tokens[lo:hi]
    enc_out = encode(params, frames[lo:hi], cfg, pctx)
    cross = compute_cross_kv(params, enc_out, cfg, pctx)
    x = _embed(params["emb"], tokens, pctx) + params["pos_dec"][:s][None]
    positions = torch.arange(s, device=tokens.device).expand(hi - lo, s)
    ks, vs = [], []
    for li in range(cfg.num_layers):
        x, (k, v) = _dec_block_prefill(x, layer_params(params["dec_layers"], li), positions,
                                       cross.k[li], cross.v[li], cfg, pctx=pctx)
        ks.append(k)
        vs.append(v)
    logits = _logits(params, x[:, -1:, :], cfg, pctx)
    pad = padded_enc_seq(cfg) - cfg.encoder_seq
    cross_padded = KVCache(*(torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in cross))
    return (_gather_rows(logits[:, -1, :], pctx, b),
            EncDecCache(KVCache(torch.stack(ks), torch.stack(vs)), cross_padded))


def _logits(params, x, cfg: ModelConfig, pctx: PartitionCtx = NULL_CTX) -> torch.Tensor:
    """f32 logits over the tied head; on a serving mesh this rank's
    vocabulary rows of the embedding, the ranks' columns gathered."""
    x = apply_norm(params["ln_f"], x, "layernorm", cfg.norm_eps)
    logits = x.float() @ params["emb"].float().T
    if pctx.mesh is None:
        return logits
    return C.all_gather(logits, pctx.mesh.group(pctx.axes.tp), dim=-1)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None, pctx: PartitionCtx = NULL_CTX) -> EncDecCache:
    """The decode cache, batch-leading: self (B, L, Hkv, max_len, D) and
    cross (B, L, Hkv, ``padded_enc_seq``, D) zeros in ``dtype``.  On a
    mesh (``pctx``, the decode rules) this rank's block of each leaf
    (``layers.sharding.cache_block``): the cross rows split by sequence as
    the self rows."""
    dev = resolve_device(device)
    mk = lambda name, s: torch.zeros(  # noqa: E731
        cache_block(pctx, name, (batch, cfg.num_layers, cfg.num_kv_heads, s, cfg.head_dim)),
        dtype=dtype, device=dev)
    se = padded_enc_seq(cfg)
    return EncDecCache(KVCache(mk("self_kv/k", max_len), mk("self_kv/v", max_len)),
                       KVCache(mk("cross_kv/k", se), mk("cross_kv/v", se)))


def install_prefill(cache: EncDecCache, prefilled: EncDecCache, slots=None,
                    mesh: Optional[MeshInstall] = None) -> EncDecCache:
    """The logic swap: a prefill's self and cross K/V, layer-major, into
    their slots of the batch-leading decode cache (prompt i into
    ``slots[i]``, slot i by default), in place, through the port's
    relayout (``insert_prefill_kv``).  On a mesh (``mesh``) ``cache`` is
    this rank's block: each prompt goes to the data rank whose rows hold
    its slot, its self K/V and its cross K/V (padded rows, split by
    sequence as the self K/V) as this rank's rows, exchanged from the
    heads (or cut from the whole heads)."""
    for buf, new in zip(cache, prefilled):
        if mesh is None:
            rows = enumerate(range(new.k.shape[1]) if slots is None else slots)
        else:
            rows = mesh.rows()
        for i, slot in rows:
            kv = KVCache(new.k[:, i:i + 1], new.v[:, i:i + 1])
            insert_prefill_kv(buf, kv if mesh is None else mesh.kv(kv, buf.k.shape[3]), slot)
    return cache


def decode_step(params: dict, token: torch.Tensor, cache: EncDecCache, lengths: torch.Tensor,
                cfg: ModelConfig, pctx: PartitionCtx = NULL_CTX):
    """One decoder step for every slot: token (B,) at position ``lengths``
    (B,) int32.  Each layer walks its self cache (read only; the fresh
    token merged in f32) and its cross cache's first ``encoder_seq`` rows;
    afterwards one scatter a leaf writes every layer's new self K/V.  The
    cross cache never changes.  Returns (logits (B, Vp), cache).

    On a serving mesh (``pctx``, the decode rules) ``token`` and
    ``lengths`` are the whole batch's and ``cache`` this rank's block: its
    rows of the batch, of the self sequence and of the cross rows.  Each
    walk takes the local rows (the cross walk ``clamp(encoder_seq - r *
    Sl, 0, Sl)`` of them) and the ranks of the sequence axis merge their
    partials; the new token is written by the rank that holds its row."""
    check_mesh_model(cfg, pctx)
    bg = token.shape[0]
    lo, hi = batch_rows(pctx, bg)
    lens = lengths[lo:hi]
    x = _embed(params["emb"], token[lo:hi, None], pctx) + params["pos_dec"][lens.long()][:, None, :]
    sl = cache.self_kv.k.shape[3]
    walk = seq_walk(lens, sl, pctx)
    cross_walk = seq_walk(lens, cache.cross_kv.k.shape[3], pctx)
    tok_k, tok_v = [], []
    for li in range(cfg.num_layers):
        lp = layer_params(params["dec_layers"], li)
        h = apply_norm(lp["ln1"], x, "layernorm", cfg.norm_eps)
        layer = KVCache(cache.self_kv.k[:, li], cache.self_kv.v[:, li])
        attn_out, new_kv = attention_decode(lp["attn"], h, layer, lens, cfg, pctx=pctx, walk=walk)
        x = x + attn_out
        h = apply_norm(lp["lnx"], x, "layernorm", cfg.norm_eps)
        cross = KVCache(cache.cross_kv.k[:, li], cache.cross_kv.v[:, li])
        cross_out, _ = attention_decode(lp["cross"], h, cross, lens, cfg,
                                        cross_len=cfg.encoder_seq, pctx=pctx, walk=cross_walk)
        x = x + cross_out
        h = apply_norm(lp["ln2"], x, "layernorm", cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], h, cfg, pctx=pctx)
        tok_k.append(new_kv.k)
        tok_v.append(new_kv.v)
    if walk is None:
        scatter_new_tokens(cache.self_kv.k, torch.stack(tok_k), lens)
        scatter_new_tokens(cache.self_kv.v, torch.stack(tok_v), lens)
    else:
        smax, r = sl * walk_ranks(pctx), walk.offset // sl
        scatter_new_tokens_seq_shard(cache.self_kv.k, torch.stack(tok_k), lens, r, smax)
        scatter_new_tokens_seq_shard(cache.self_kv.v, torch.stack(tok_v), lens, r, smax)
    return _gather_rows(_logits(params, x, cfg, pctx)[:, 0, :], pctx, bg), cache
