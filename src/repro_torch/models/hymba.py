"""Hymba (arXiv:2411.13676): parallel attention + SSM heads per layer — the
port of ``repro.models.hymba``.

Every layer runs an attention branch and a selective-SSM branch on the same
input and fuses them (per-branch RMSNorm, learned scalar gates, mean).
Attention is sliding-window everywhere except ``global_attn_layers``, which
keep the JAX package's sentinel window ``1 << 30``: every layer then takes
the windowed path, as in the JAX package, whose scan over layers needs one
traced window a layer.  So the prefill's attention is the plain windowed
path (dense up to 1,024 tokens, else chunked; the JAX package has no kernel
for it), and the decode walks the cache through the decode attention kernel
from the window's start.  The SSM branch is plain torch (``models.ssm``).

Entry points, as the JAX ``ModelAPI``: ``init``, ``loss_fn`` (with
``forward_hidden`` / ``forward_train``: the same layers, each recomputed
in backward unless ``cfg.remat`` is ``"none"``), ``forward_prefill`` (KV
layer-major (L, B, Hkv, S, D)), ``init_cache`` (KV batch-leading (B, L,
Hkv, Smax, D), the SSM and conv states (L, B, ...)), ``decode_step``;
``install_prefill`` is the logic swap between the two.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.kv_cache import MeshInstall, insert_prefill_kv
from repro_torch.layers import collectives as C
from repro_torch.layers.attention import (
    KVCache,
    attention_decode,
    attention_prefill,
    scatter_new_tokens,
    scatter_new_tokens_seq_shard,
    seq_walk,
    walk_ranks,
)
from repro_torch.layers.mlp import mlp_apply
from repro_torch.layers.norm import apply_norm
from repro_torch.layers.sharding import NULL_CTX, PartitionCtx, cache_block
from repro_torch.models.jax_init import init_like_jax
from repro_torch.models.ssm import ssm_channels, ssm_decode, ssm_prefill
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

FULL_WINDOW = 1 << 30


class HymbaCache(NamedTuple):
    kv: KVCache  # (L, B, Hkv, S, D) from prefill; (B, L, Hkv, Smax, D) to decode
    ssm_h: torch.Tensor  # (L, B, d_in, N) f32
    conv: torch.Tensor  # (L, B, ssm_conv - 1, d_in) f32


def layer_windows(cfg: ModelConfig) -> List[int]:
    """Each layer's attention window; full-attention layers get the
    sentinel (an index past the last layer is dropped, as the JAX
    package's scatter drops it)."""
    w = [cfg.sliding_window or FULL_WINDOW] * cfg.num_layers
    for li in cfg.global_attn_layers:
        if li < cfg.num_layers:
            w[li] = FULL_WINDOW
    return w


def init(cfg: ModelConfig, seed: int = 0, *, device=None,
         dtype: torch.dtype = torch.bfloat16) -> dict:
    """The JAX ``init``'s weights (``init_like_jax``), drawn on the target
    device: the linears and the SSM's matrices in ``dtype`` (bf16 by
    default, as the JAX ``init``), norms, gates and the SSM's constants
    f32."""
    dev = resolve_device(device)
    return init_like_jax(cfg, seed, dev, draw_device=dev, dtype=dtype)


def _fuse(lp, attn_out, ssm_out, cfg: ModelConfig) -> torch.Tensor:
    a = apply_norm(lp["attn_norm"], attn_out, "rmsnorm", cfg.norm_eps)
    s = apply_norm(lp["ssm_norm"], ssm_out, "rmsnorm", cfg.norm_eps)
    return (0.5 * (lp["gate_a"] * a.float() + lp["gate_s"] * s.float())).to(attn_out.dtype)


def _logits(params, x, cfg: ModelConfig, pctx: PartitionCtx = NULL_CTX) -> torch.Tensor:
    """f32 logits over the tied head; on a serving mesh this rank's
    vocabulary rows of the embedding, the ranks' columns gathered."""
    x = apply_norm(params["ln_f"], x, "rmsnorm", cfg.norm_eps)
    logits = x.float() @ params["emb"].float().T
    if pctx.mesh is None:
        return logits
    return C.all_gather(logits, pctx.mesh.group(pctx.axes.tp), dim=-1)


def _block(x, lp, window: int, positions, cfg: ModelConfig, training: bool = False,
           pctx: PartitionCtx = NULL_CTX):
    """One layer over the whole sequence: (x, (k, v), (SSM state, conv
    state)).  On a training mesh (``pctx``) the attention runs this rank's
    heads, or every head where the model axis does not split them, and
    the SSM this rank's channels; both outputs are whole, so the fusion
    runs on the whole d on every rank."""
    h = apply_norm(lp["ln1"], x, "rmsnorm", cfg.norm_eps)
    attn_out, kv = attention_prefill(lp["attn"], h, positions, cfg, window=window,
                                     training=training, pctx=pctx)
    ssm_out, ssm_state = ssm_prefill(lp["ssm"], h, cfg, pctx=pctx)
    x = x + _fuse(lp, attn_out, ssm_out, cfg)
    h2 = apply_norm(lp["ln2"], x, "rmsnorm", cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h2, cfg, training=training, pctx=pctx), kv, ssm_state


def _block_train(x, lp, window: int, positions, cfg: ModelConfig, pctx: PartitionCtx = NULL_CTX):
    return _block(x, lp, window, positions, cfg, training=True, pctx=pctx)[0]


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                   pctx: PartitionCtx = NULL_CTX, *, emb=None) -> torch.Tensor:
    """The final normed hidden state (B, S, d) of tokens (B, S) for the
    chunked loss, each layer under ``cfg.remat``.  On a mesh (``pctx``,
    the train rules; ``tokens`` this data rank's rows) the weights are
    gathered over data inside each layer, the vocabulary rows of ``emb``
    (the gathered embedding shard, ``_train_top``, where given) are this
    model rank's."""
    check_mesh_model(cfg, pctx, train=True)
    b, s = tokens.shape
    if emb is None:
        emb = _train_top(params, cfg, pctx)[0]
    x = _embed(emb, tokens, pctx)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    body = remat(_block_train, cfg.remat)
    for lp, w in zip(unbind_layers(params["layers"]), layer_windows(cfg)):
        x = body(x, lp, w, positions, cfg, pctx)
    return apply_norm(params["ln_f"], x, "rmsnorm", cfg.norm_eps)


def forward_train(params: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """The full logits (B, S, Vp) f32 and a zero aux loss."""
    x = forward_hidden(params, tokens, cfg)
    return x.float() @ params["emb"].float().T, torch.zeros((), device=x.device)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, aux_weight: float = 0.0,
            pctx: PartitionCtx = NULL_CTX):
    """The chunked loss over the tied head: (nll, {"nll", "aux": 0}).  On a
    mesh the head is this rank's vocabulary shard of the embedding,
    gathered over data (``P(model, data)``), and the loss vocab-parallel,
    as the transformer family's."""
    emb, head = _train_top(params, cfg, pctx)
    x = forward_hidden(params, batch["tokens"], cfg, pctx, emb=emb)
    loss = vocab_parallel_loss(x, head, batch, pctx)
    return loss, {"nll": loss, "aux": torch.zeros((), device=x.device)}


def forward_prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                    pctx: PartitionCtx = NULL_CTX):
    """The prefill program: tokens (B, S), one length a batch.  Returns
    (last-position logits (B, Vp), HymbaCache with the KV layer-major
    (L, B, Hkv, S, D)).

    On a serving mesh (``pctx``, the prefill rules) every rank takes the
    whole ``tokens`` and runs its rows of the batch (all of them where the
    data axis does not divide it): the attention on its Hkv / tp heads, or
    on every head where the model axis does not split them
    (``heads_split``), the SSM on its d / tp channels.  It returns the
    whole batch's logits and its rows' cache: those heads, those
    channels."""
    check_mesh_model(cfg, pctx)
    b, s = tokens.shape
    lo, hi = batch_rows(pctx, b)
    tokens = tokens[lo:hi]
    x = _embed(params["emb"], tokens, pctx)
    positions = torch.arange(s, device=tokens.device).expand(hi - lo, s)
    ks, vs, hs, convs = [], [], [], []
    for li, w in enumerate(layer_windows(cfg)):
        x, (k, v), (ssm_h, conv) = _block(x, layer_params(params["layers"], li), w, positions,
                                          cfg, pctx=pctx)
        ks.append(k)
        vs.append(v)
        hs.append(ssm_h)
        convs.append(conv)
    logits = _logits(params, x[:, -1:, :], cfg, pctx)
    return _gather_rows(logits[:, -1, :], pctx, b), HymbaCache(
        KVCache(torch.stack(ks), torch.stack(vs)), torch.stack(hs), torch.stack(convs))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None, pctx: PartitionCtx = NULL_CTX) -> HymbaCache:
    """The decode cache: KV batch-leading (B, L, Hkv, max_len, D) zeros in
    ``dtype``, the SSM and conv states (L, B, ...) f32 zeros.  On a mesh
    (``pctx``, the decode or long-context rules) this rank's block of each
    leaf (``layers.sharding.cache_block``)."""
    dev = resolve_device(device)
    l, c = cfg.num_layers, cfg.d_model
    kv = cache_block(pctx, "kv/k", (batch, l, cfg.num_kv_heads, max_len, cfg.head_dim))
    return HymbaCache(
        KVCache(torch.zeros(kv, dtype=dtype, device=dev), torch.zeros(kv, dtype=dtype, device=dev)),
        torch.zeros(cache_block(pctx, "ssm_h", (l, batch, c, cfg.ssm_state)), device=dev),
        torch.zeros(cache_block(pctx, "conv", (l, batch, cfg.ssm_conv - 1, c)), device=dev))


def install_prefill(cache: HymbaCache, prefilled: HymbaCache, slots=None,
                    mesh: Optional[MeshInstall] = None) -> HymbaCache:
    """The logic swap: each prompt of a prefill's cache into its slot of
    the decode cache (prompt i into ``slots[i]``, slot i by default), in
    place.  The KV moves from layer-major to batch-leading through the
    port's relayout (``insert_prefill_kv``: cast to the cache dtype, rows
    past the prompt zeroed); the recurrent states keep their (L, B, ...)
    layout.

    On a mesh (``mesh``) ``cache`` is this rank's block and ``prefilled``
    its prefill's rows: each prompt goes to the data rank whose rows hold
    its slot, its KV as this rank's rows of the sequence (exchanged from
    the heads, or cut from the whole heads), the SSM and conv states
    gathered whole over the model axis where the cache holds them whole
    (the decode rules), kept on their channels where it splits them too
    (the long-context rules)."""
    k, v = prefilled.kv
    if mesh is None:
        for i, slot in enumerate(range(k.shape[1]) if slots is None else slots):
            insert_prefill_kv(cache.kv, KVCache(k[:, i:i + 1], v[:, i:i + 1]), slot)
            cache.ssm_h[:, slot] = prefilled.ssm_h[:, i]
            cache.conv[:, slot] = prefilled.conv[:, i]
        return cache
    sl = cache.kv.k.shape[3]
    hs = mesh.state(prefilled.ssm_h, 2, cache.ssm_h.shape[2])
    convs = mesh.state(prefilled.conv, 3, cache.conv.shape[3])
    for i, slot in mesh.rows():
        insert_prefill_kv(cache.kv, mesh.kv(KVCache(k[:, i:i + 1], v[:, i:i + 1]), sl), slot)
        cache.ssm_h[:, slot] = hs[:, i]
        cache.conv[:, slot] = convs[:, i]
    return cache


def _ssm_state_step(lp, h, cfg: ModelConfig, cache: HymbaCache, li: int, pctx: PartitionCtx):
    """Layer li's SSM branch for one token, its states in ``cache`` updated
    in place.  On a mesh each model rank runs its d / tp channels
    (``ssm_decode``); where the cache holds the states whole (the decode
    rules) the rank reads its channels of them and the ranks' new
    channels are gathered back whole, one all-gather of both states a
    layer."""
    h_prev, conv = cache.ssm_h[li], cache.conv[li]
    whole = pctx.mesh is not None and pctx.tp_size > 1 and h_prev.shape[1] == cfg.d_model
    if whole:
        c0, c1 = ssm_channels(cfg, pctx)
        h_prev, conv = h_prev[:, c0:c1], conv[:, :, c0:c1]
    out, (new_h, new_conv) = ssm_decode(lp["ssm"], h, cfg, h_prev, conv, pctx)
    if whole:
        new_h, new_conv = _gather_states(new_h, new_conv, pctx)
    cache.ssm_h[li] = new_h
    cache.conv[li] = new_conv
    return out


def _gather_states(h: torch.Tensor, conv: torch.Tensor, pctx: PartitionCtx):
    """This rank's channels of the SSM state (B, c, N) and the conv state
    (B, w - 1, c) made whole over the model axis, in one all-gather."""
    b = h.shape[0]
    both = torch.cat([h.reshape(b, -1), conv.reshape(b, -1)], dim=-1)
    every = C.all_gather(both[None], pctx.mesh.group(pctx.axes.tp), dim=0)
    n = h[0].numel()
    return (torch.cat([r[:, :n].reshape(h.shape) for r in every], dim=1),
            torch.cat([r[:, n:].reshape(conv.shape) for r in every], dim=2))


def decode_step(params: dict, token: torch.Tensor, cache: HymbaCache, lengths: torch.Tensor,
                cfg: ModelConfig, pctx: PartitionCtx = NULL_CTX):
    """One decode step for every slot: token (B,), lengths (B,) int32 tokens
    already cached.  Each layer walks its slice of the batch-leading KV
    cache from its window's start (read only; the fresh token is merged in
    f32) and updates its SSM and conv states in place; afterwards one
    scatter a leaf writes every layer's new K/V.  Returns (logits (B, Vp),
    cache).

    On a serving mesh (``pctx``, the decode or long-context rules) ``token``
    and ``lengths`` are the whole batch's and ``cache`` this rank's block:
    its rows of the batch and of the sequence.  Each layer walks the local
    rows from the window's start moved onto them (a block wholly before
    the window walks nothing), the ranks of the sequence axis merge their
    partials, the SSM runs channel-parallel (``_ssm_state_step``), and the
    new token is written by the rank that holds its row."""
    check_mesh_model(cfg, pctx)
    bg = token.shape[0]
    lo, hi = batch_rows(pctx, bg)
    lens = lengths[lo:hi]
    x = _embed(params["emb"], token[lo:hi, None], pctx)
    sl = cache.kv.k.shape[3]
    walk = seq_walk(lens, sl, pctx)
    tok_k, tok_v = [], []
    for li, w in enumerate(layer_windows(cfg)):
        lp = layer_params(params["layers"], li)
        h = apply_norm(lp["ln1"], x, "rmsnorm", cfg.norm_eps)
        layer = KVCache(cache.kv.k[:, li], cache.kv.v[:, li])
        attn_out, new_kv = attention_decode(lp["attn"], h, layer, lens, cfg, window=w, pctx=pctx,
                                            walk=walk)
        ssm_out = _ssm_state_step(lp, h, cfg, cache, li, pctx)
        x = x + _fuse(lp, attn_out, ssm_out, cfg)
        h2 = apply_norm(lp["ln2"], x, "rmsnorm", cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], h2, cfg, pctx=pctx)
        tok_k.append(new_kv.k)
        tok_v.append(new_kv.v)
    if walk is None:
        scatter_new_tokens(cache.kv.k, torch.stack(tok_k), lens)
        scatter_new_tokens(cache.kv.v, torch.stack(tok_v), lens)
    else:
        smax = sl * walk_ranks(pctx)
        r = walk.offset // sl
        scatter_new_tokens_seq_shard(cache.kv.k, torch.stack(tok_k), lens, r, smax)
        scatter_new_tokens_seq_shard(cache.kv.v, torch.stack(tok_v), lens, r, smax)
    return _gather_rows(_logits(params, x, cfg, pctx)[:, 0, :], pctx, bg), cache
