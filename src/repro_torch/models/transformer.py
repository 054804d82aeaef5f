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
    scatter_new_tokens_seq_shard_q,
    scatter_verify_tokens_paged_q,
    seq_walk,
    verify_plan,
    write_chunk_kv_q,
    write_prefill_pages_q,
)
from repro_torch.layers import collectives as C
from repro_torch.layers.mlp import mlp_apply, mlp_init
from repro_torch.layers.moe import moe_apply, moe_forward, moe_init
from repro_torch.layers.norm import apply_norm, apply_norm_blocks, rmsnorm_init
from repro_torch.layers.sharding import NULL_CTX, PartitionCtx
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


def _embed(emb: torch.Tensor, tokens, pctx: PartitionCtx = NULL_CTX):
    """The rows of the embedding ``emb`` for ``tokens``.  On a mesh ``emb``
    holds this model rank's Vp / tp vocabulary rows: each rank looks up the
    tokens in its range, zeros elsewhere, and the ranks' sum (the row from
    one rank, zeros from the others) is the row itself, bit for bit; in
    training its gradient reaches every rank whole (``reduce_from_tp``)."""
    if pctx.mesh is None or not pctx.axes.tp:
        return emb[tokens]
    n = emb.shape[0]
    ids = tokens - pctx.index(pctx.axes.tp) * n
    mine = (ids >= 0) & (ids < n)
    x = torch.where(mine[..., None], emb[ids.clamp(0, n - 1)].float(),
                    torch.zeros((), device=emb.device))
    return C.reduce_from_tp(x, pctx.mesh.group(pctx.axes.tp)).to(emb.dtype)


def _head(params, cfg: ModelConfig) -> torch.Tensor:
    return params["emb"].T if cfg.tie_embeddings else params["lm_head"]


def _logits(params, x, cfg: ModelConfig, norm=apply_norm,
            pctx: PartitionCtx = NULL_CTX) -> torch.Tensor:
    """f32 logits (..., Vp).  On a mesh each model rank multiplies by its
    Vp / tp vocabulary columns and the ranks gather them, so a greedy
    argmax over the whole row picks the lowest index on a tie, as
    ``jnp.argmax`` does."""
    x = norm(params["ln_f"], x, cfg.norm, cfg.norm_eps)
    logits = x.float() @ _head(params, cfg).float()  # full f32: TF32 is off (see repro_torch)
    if pctx.mesh is None:
        return logits
    return C.all_gather(logits, pctx.mesh.group(pctx.axes.tp), dim=-1)


def batch_rows(pctx: PartitionCtx, n: int):
    """This rank's [lo, hi) of a batch of ``n`` rows (all of them where the
    batch axis does not divide ``n``, or with no mesh)."""
    if pctx.mesh is None:
        return 0, n
    return pctx.local_range(n, "batch")


def _gather_rows(t: torch.Tensor, pctx: PartitionCtx, n: int, dim: int = 0) -> torch.Tensor:
    """The whole batch of ``n`` rows (along ``dim``) on every rank, from
    this rank's rows of it."""
    if pctx.mesh is None:
        return t
    ax = pctx.spec((n,), "batch")[0]
    if ax is None:
        return t
    return C.all_gather(t, pctx.mesh.group(ax), dim=dim)


def check_mesh_model(cfg: ModelConfig, pctx: PartitionCtx, *, train: bool = False) -> None:
    """Refuse, by name, a model the mesh programs do not shard: a sliding
    window in the transformer family, or dims the model axis does not
    divide (heads, KV heads, d_ff, vocabulary rows, packed K rows; an
    MoE's experts are over it where it divides their count, else its
    d_ff).  In training (``train``) the data axis shards every weight's
    d_model dim (FSDP) and must divide it too; the hymba, xlstm and encdec
    families serve and train on a mesh under their own checks
    (``_check_family_mesh``)."""
    if pctx.mesh is None:
        return
    if cfg.family != "transformer":
        return _check_family_mesh(cfg, pctx, train)
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            f"{cfg.name}: a sliding window on a mesh is ROADMAP A.13")
    tp = pctx.tp_size
    dims = {"num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
            "num_heads * head_dim / 4": cfg.num_heads * cfg.head_dim // 4,
            "padded_vocab": cfg.padded_vocab()}
    if not cfg.moe:
        dims["d_ff / 4"] = cfg.d_ff // 4
    elif cfg.num_experts % tp:  # the experts whole on every rank, their d_ff over the axis
        dims["moe_d_ff"] = cfg.moe_d_ff
    bad = {k: v for k, v in dims.items() if v % tp}
    if bad:
        raise ValueError(f"{cfg.name}: the model axis ({tp}) does not divide {bad}")
    if train:
        fsdp = pctx.size(pctx.axes.fsdp)
        if cfg.d_model % fsdp:
            raise ValueError(f"{cfg.name}: the data axis ({fsdp}) does not divide d_model "
                             f"{cfg.d_model}")


def _check_family_mesh(cfg: ModelConfig, pctx: PartitionCtx, train: bool) -> None:
    """The hymba, xlstm and encdec families on a mesh, served (``pctx``
    under the prefill or decode rules) or trained.  Heads the model axis
    does not divide are computed whole on every rank
    (``layers.attention.heads_split``), and hymba's sliding window is
    taken.  What each rank must hold its own part of is refused where the
    axis does not divide it: the vocabulary rows, d_ff, hymba's SSM
    channels (d_model), xLSTM's heads (its gates and states are
    head-major); serving, also the projections' columns (H * D, Hkv * D)
    that a rank gathers whole heads from; in training the data axis shards
    every weight's d_model dim (FSDP).  xLSTM under the long-context
    decode rules (its states split inside a head) is refused."""
    tp = pctx.tp_size
    dims = {"padded_vocab": cfg.padded_vocab()}
    if cfg.family in ("hymba", "encdec"):
        dims["d_ff"] = cfg.d_ff
        if not train:
            dims["num_heads * head_dim"] = cfg.num_heads * cfg.head_dim
            dims["num_kv_heads * head_dim"] = cfg.num_kv_heads * cfg.head_dim
    if cfg.family == "hymba":
        dims["d_model (the SSM's channels)"] = cfg.d_model
    if cfg.family == "xlstm":
        dims["num_heads"] = cfg.num_heads
        dims["4 * head_dim (sLSTM gates a head)"] = 4 * (cfg.d_model // cfg.num_heads)
    bad = {k: v for k, v in dims.items() if v % tp}
    if bad:
        raise ValueError(f"{cfg.name}: the model axis ({tp}) does not divide {bad}")
    if not train:
        if cfg.family == "xlstm" and pctx.resolve(["state"])[0] is not None:
            raise NotImplementedError(
                f"{cfg.name}: xLSTM under the long-context decode rules (the mLSTM's dv and the "
                "sLSTM's hd split over the model axis inside a head) is ROADMAP A.13.12")
        return
    fsdp = pctx.size(pctx.axes.fsdp)
    if cfg.d_model % fsdp:
        raise ValueError(f"{cfg.name}: the data axis ({fsdp}) does not divide d_model "
                         f"{cfg.d_model}")


def vocab_parallel_loss(x: torch.Tensor, head: torch.Tensor, batch: dict,
                        pctx: PartitionCtx = NULL_CTX) -> torch.Tensor:
    """The chunked loss of the final hidden state x over ``head`` (this
    rank's vocabulary columns on a mesh: the head is a column-parallel
    product, so x enters through ``copy_to_tp``)."""
    if pctx.mesh is not None and pctx.axes.tp:
        x = C.copy_to_tp(x, pctx.mesh.group(pctx.axes.tp))
    return chunked_ce_loss(x, head, batch["targets"], batch["mask"], pctx=pctx)


def _ffn(lp: dict, h: torch.Tensor, cfg: ModelConfig,
         pctx: PartitionCtx = NULL_CTX) -> torch.Tensor:
    """A layer's FFN: the MoE (its aux loss, which serving discards, is not
    computed) or the dense SwiGLU, each on the mesh of ``pctx``."""
    if cfg.moe:
        return moe_forward(lp["moe"], h, cfg, pctx=pctx)
    return mlp_apply(lp["mlp"], h, cfg, pctx=pctx)


def _block_train(x, lp, positions, cfg: ModelConfig, pctx: PartitionCtx = NULL_CTX):
    """One layer of the training pass: (x, the layer's aux loss, f32).  On a
    mesh the layer's weights are gathered over data inside it, so remat
    recomputes the gathers in backward rather than keeping whole weights;
    an MoE layer's aux loss is this rank's share of the batch's."""
    h = apply_norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
    attn_out, _ = attention_prefill(lp["attn"], h, positions, cfg, training=True, pctx=pctx)
    x = x + attn_out
    h = apply_norm(lp["ln2"], x, cfg.norm, cfg.norm_eps)
    if cfg.moe:
        ffn_out, aux = moe_apply(lp["moe"], h, cfg, training=True, pctx=pctx)
    else:
        ffn_out = mlp_apply(lp["mlp"], h, cfg, training=True, pctx=pctx)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + ffn_out, aux


def _train_top(params: dict, cfg: ModelConfig, pctx: PartitionCtx):
    """(the embedding rows, the head) the training pass multiplies by.  On
    a mesh this rank's vocabulary shard of each, gathered over data once
    (``fsdp_gather``): emb (Vp/tp, d), head (d, Vp/tp); a tied head is the
    gathered embedding's transpose, so its gradient and the lookup's reach
    the shard through one reduce-scatter."""
    if pctx.mesh is None or pctx.axes.fsdp is None:
        return params["emb"], _head(params, cfg)
    data = pctx.mesh.group(pctx.axes.fsdp)
    emb = C.fsdp_gather(params["emb"], data, dim=1)
    if cfg.tie_embeddings:
        return emb, emb.T
    return emb, C.fsdp_gather(params["lm_head"], data, dim=0)


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                   pctx: PartitionCtx = NULL_CTX, *, emb: Optional[torch.Tensor] = None):
    """The training pass over tokens (B, S): (the final normed hidden state
    (B, S, d), the layers' aux losses summed, f32).  Every layer takes the
    plain attention paths, and the linears of a ternary config are
    quantization-aware.  Each layer runs under ``cfg.remat``.  On a mesh
    (``pctx``, the train rules; ``tokens`` this data rank's rows) the heads
    and d_ff are over the model axis and every weight is gathered over data
    where it is used; ``emb``, where given, is the gathered embedding shard
    (``_train_top``)."""
    _check_window(cfg)
    check_mesh_model(cfg, pctx, train=True)
    b, s = tokens.shape
    if emb is None:
        emb = _train_top(params, cfg, pctx)[0]
    x = _embed(emb, tokens, pctx)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    body = remat(_block_train, cfg.remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in unbind_layers(params["layers"]):
        x, aux_l = body(x, lp, positions, cfg, pctx)
        aux = aux + aux_l
    return apply_norm(params["ln_f"], x, cfg.norm, cfg.norm_eps), aux


def forward_train(params: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """The full logits (B, S, Vp) f32 and the aux loss: the small-model
    path; training takes ``loss_fn``, which never holds them whole."""
    x, aux = forward_hidden(params, tokens, cfg)
    return x.float() @ _head(params, cfg).float(), aux


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, aux_weight: float = 0.01,
            pctx: PartitionCtx = NULL_CTX):
    """batch: tokens (B, S), targets (B, S), mask (B, S).  Returns (nll +
    aux_weight * aux / num_layers, {"nll", "aux"}), as the JAX ``loss_fn``.
    On a mesh ``batch`` holds this data rank's rows and the nll is this
    rank's share of the global mean: its rows' sum over the mask summed
    over the batch axis, so the ranks' losses (and gradients) sum to the
    global ones; the head is vocab-parallel (``chunked_ce_loss``)."""
    emb, head = _train_top(params, cfg, pctx)
    x, aux = forward_hidden(params, batch["tokens"], cfg, pctx, emb=emb)
    loss = vocab_parallel_loss(x, head, batch, pctx)
    return loss + aux_weight * aux / max(cfg.num_layers, 1), {"nll": loss, "aux": aux}


def _block_prefill(x, lp, positions, cfg, pctx: PartitionCtx = NULL_CTX):
    h = apply_norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
    attn_out, kv = attention_prefill(lp["attn"], h, positions, cfg, pctx=pctx)
    x = x + attn_out
    h = apply_norm(lp["ln2"], x, cfg.norm, cfg.norm_eps)
    return x + _ffn(lp, h, cfg, pctx), kv


def _at(x, last_pos):
    """Position ``last_pos`` (default the last) of x (B, S, d) as (B, 1, d);
    a 0-d device tensor ``last_pos`` selects on the device."""
    if last_pos is None:
        return x[:, -1:, :]
    if isinstance(last_pos, torch.Tensor):
        return x.index_select(1, last_pos.long().reshape(1))
    return x[:, last_pos:last_pos + 1, :]


def forward_prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                    split_tail: bool = False, last_pos: Optional[int] = None,
                    pctx: PartitionCtx = NULL_CTX):
    """The prefill engine.  Returns (logits of position ``last_pos`` (default
    S-1) (B, Vp), KVCache of (L, B, Hkv, S, D)), or with ``split_tail=True``
    (x_mid (B, S, d), KVCache) after the last layer's attention: the KV is
    complete there, so the relayout can run while ``prefill_tail`` does.
    Right-padded prompts pass their true last position as ``last_pos``;
    causality keeps it independent of the padding.

    On a mesh (``pctx``, the prefill rules) every rank takes the whole
    ``tokens``: it runs its rows of the batch (all of them where the data
    axis does not divide it) on its Hkv / tp heads, and returns the whole
    batch's logits, its own KV (L, B_local, Hkv / tp, S, D), and x_mid of
    its rows."""
    _check_window(cfg)
    b, s = tokens.shape
    lo, hi = batch_rows(pctx, b)
    tokens = tokens[lo:hi]
    x = _embed(params["emb"], tokens, pctx)
    positions = torch.arange(s, device=tokens.device).expand(hi - lo, s)
    n_main = cfg.num_layers - 1 if split_tail else cfg.num_layers
    ks, vs = [], []
    for li in range(n_main):
        x, (k, v) = _block_prefill(x, layer_params(params["layers"], li), positions, cfg, pctx)
        ks.append(k)
        vs.append(v)
    if not split_tail:
        logits = _logits(params, _at(x, last_pos), cfg, pctx=pctx)
        return (_gather_rows(logits[:, -1, :], pctx, b),
                KVCache(torch.stack(ks), torch.stack(vs)))
    last = layer_params(params["layers"], cfg.num_layers - 1)
    h = apply_norm(last["ln1"], x, cfg.norm, cfg.norm_eps)
    attn_out, (k, v) = attention_prefill(last["attn"], h, positions, cfg, pctx=pctx)
    ks.append(k)
    vs.append(v)
    return x + attn_out, KVCache(torch.stack(ks), torch.stack(vs))


def prefill_tail(params: dict, x_mid: torch.Tensor, cfg: ModelConfig,
                 last_pos: Optional[int] = None, *, pctx: PartitionCtx = NULL_CTX,
                 batch: Optional[int] = None) -> torch.Tensor:
    """The tail after the split: last FFN + norm + logits, (B, Vp).  On a
    mesh ``x_mid`` holds this rank's rows of a batch of ``batch``, and the
    whole batch's logits come back."""
    last = layer_params(params["layers"], cfg.num_layers - 1)
    h2 = apply_norm(last["ln2"], x_mid, cfg.norm, cfg.norm_eps)
    x_out = x_mid + _ffn(last, h2, cfg, pctx)
    logits = _logits(params, _at(x_out, last_pos), cfg, pctx=pctx)[:, -1, :]
    return _gather_rows(logits, pctx, x_mid.shape[0] if batch is None else batch)


def _prefill_chunk_body(params: dict, tokens: torch.Tensor, prefix: KVCache, prefix_len,
                        cfg: ModelConfig, prefix_width: Optional[int] = None,
                        pctx: PartitionCtx = NULL_CTX):
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
    would, and the per-token quantization on write stores the same bytes.

    On a mesh (``pctx``, the prefill rules) the heads are this rank's: the
    mirror holds them, and so does the KV returned."""
    _check_window(cfg)
    b, c = tokens.shape
    cap = prefix.k.shape[3]
    if not isinstance(prefix_len, torch.Tensor) and prefix_len + c > cap:
        raise ValueError(f"chunk rows [{prefix_len}, {prefix_len + c}) overflow the mirror's {cap}")
    x = _embed(params["emb"], tokens, pctx)
    positions = (prefix_len + torch.arange(c, device=tokens.device)).expand(b, c)
    width = cap if prefix_width is None else min(prefix_width, cap)
    ks, vs = [], []
    for li in range(cfg.num_layers):
        lp = layer_params(params["layers"], li)
        h = apply_norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
        attn_out, (k, v) = attention_prefill_chunk(
            lp["attn"], h, prefix.k[li, :, :, :width], prefix.v[li, :, :, :width], prefix_len,
            cfg, positions, pctx=pctx)
        x = x + attn_out
        h = apply_norm(lp["ln2"], x, cfg.norm, cfg.norm_eps)
        x = x + _ffn(lp, h, cfg, pctx)
        ks.append(k)
        vs.append(v)
    tok_k, tok_v = torch.stack(ks), torch.stack(vs)
    prefix.k.index_copy_(3, positions[0], tok_k.to(prefix.k.dtype))
    prefix.v.index_copy_(3, positions[0], tok_v.to(prefix.v.dtype))
    return x, tok_k, tok_v, prefix


def gather_kv_heads(kv: KVCache, cfg: ModelConfig, pctx: PartitionCtx = NULL_CTX) -> KVCache:
    """Prefill-layout KV (L, B, Hkv / tp, S, D) of this rank's heads made
    whole over the model axis (``pctx``, the prefill rules): one gather
    carrying K and V together.  No mesh: ``kv`` as it is."""
    if pctx.mesh is None:
        return kv
    both = torch.stack([kv.k, kv.v])  # (2, L, B, Hkv / tp, S, D)
    dims = (None, "layers", "batch", "kv_heads", "seq", "head_dim")
    both = pctx.shard(both, dims, dims[:3] + (None,) + dims[4:],
                      both.shape[:3] + (cfg.num_kv_heads,) + both.shape[4:])
    return KVCache(both[0], both[1])


def prefill_chunk(params: dict, tokens: torch.Tensor, cache: KVCache, prefix: KVCache, slot,
                  prefix_len, last_pos, cfg: ModelConfig, prefix_width: Optional[int] = None,
                  pctx: PartitionCtx = NULL_CTX, write=write_chunk_kv_q):
    """One right-padded chunk (1, C) of a prompt installed into slot
    ``slot`` of the contiguous cache at [prefix_len, prefix_len + C)
    (quantized on write under int8/int4).  Returns (logits (1, Vp) of
    chunk-local ``last_pos``, cache, prefix), cache and mirror updated in
    place.  ``slot``, ``prefix_len`` and ``last_pos`` are Python ints or
    0-d integer tensors on the device (then nothing depends on their
    values on the host, and one captured program serves every chunk of its
    shape).  Chunk boundaries are a pure function of the prompt length and
    the chunk size, so a restart re-prefills through the same chunks.

    On a mesh (``pctx``, the prefill rules) the chunk runs on this rank's
    heads against the mirror of those heads (L, 1, Hkv / tp, Cap, D), the
    logits come back whole, and the chunk's KV is gathered over the model
    axis before ``write(leaf, kv, slot, prefix_len)`` installs it: the
    phase engine's writer of this rank's block of the cache
    (``write_chunk_kv_seq_shard_q``)."""
    logits, kv, prefix = prefill_chunk_kv(params, tokens, prefix, prefix_len, last_pos, cfg,
                                          prefix_width, pctx)
    kv = gather_kv_heads(kv, cfg, pctx)
    write(cache.k, kv.k, slot, prefix_len)
    write(cache.v, kv.v, slot, prefix_len)
    return logits, cache, prefix


def prefill_chunk_paged(params: dict, tokens: torch.Tensor, pages: KVCache, prefix: KVCache,
                        page_ids: torch.Tensor, prefix_len, last_pos, cfg: ModelConfig,
                        prefix_width: Optional[int] = None, pctx: PartitionCtx = NULL_CTX):
    """``prefill_chunk`` into the paged pool: the chunk (C a multiple of
    the page size, starting on a page boundary) writes whole pages
    ``page_ids`` (C / bs,); ids >= N (prefix-cache hits, padding) are
    skipped.  Returns (logits (1, Vp), pages, prefix).  On a mesh the pool
    is whole on every rank: each rank gathers the chunk's heads and writes
    the same pages."""
    leaf = pages.k.q if isinstance(pages.k, QuantKV) else pages.k
    bs = leaf.shape[3]
    logits, kv, prefix = prefill_chunk_kv(params, tokens, prefix, prefix_len, last_pos, cfg,
                                          prefix_width, pctx)
    kv = gather_kv_heads(kv, cfg, pctx)
    write_prefill_pages_q(pages.k, kv.k, page_ids, block_size=bs)
    write_prefill_pages_q(pages.v, kv.v, page_ids, block_size=bs)
    return logits, pages, prefix


def prefill_chunk_kv(params: dict, tokens: torch.Tensor, prefix: KVCache, prefix_len, last_pos,
                     cfg: ModelConfig, prefix_width: Optional[int] = None,
                     pctx: PartitionCtx = NULL_CTX):
    """One chunk computed with no install: the disaggregated prefill pool's
    chunk program.  The math of ``prefill_chunk`` / ``prefill_chunk_paged``
    (the same body, the same logits epilogue); the chunk's f32 KV is
    returned instead of written, so the decode pool can install it with the
    quantize-on-write writer the fused programs run.  Returns (logits (1,
    Vp) of ``last_pos``, chunk KV (L, 1, Hkv, C, D) f32, prefix).  On a mesh
    (``pctx``) the heads are this rank's and the logits whole."""
    x, tok_k, tok_v, prefix = _prefill_chunk_body(params, tokens, prefix, prefix_len, cfg,
                                                  prefix_width, pctx)
    logits = _logits(params, _at(x, last_pos), cfg, pctx=pctx)[:, -1, :]
    return logits, KVCache(tok_k, tok_v), prefix


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
                   norm=apply_norm, pctx: PartitionCtx = NULL_CTX):
    """The layer walk of one decode step over W tokens a sequence (W = 1,
    or a verify block, which takes ``apply_norm_blocks``):
    ``attend_layer(lp, h, li)`` runs layer li's attention over the cache.
    Returns (logits (B, W, Vp), the new tokens' K and V, each (L, B, Hkv,
    W, D))."""
    x = _embed(params["emb"], tokens, pctx)
    tok_k, tok_v = [], []
    for li in range(cfg.num_layers):
        lp = layer_params(params["layers"], li)
        h = norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
        attn_out, new_kv = attend_layer(lp["attn"], h, li)
        x = x + attn_out
        h = norm(lp["ln2"], x, cfg.norm, cfg.norm_eps)
        x = x + _ffn(lp, h, cfg, pctx)
        tok_k.append(new_kv.k)
        tok_v.append(new_kv.v)
    return _logits(params, x, cfg, norm, pctx), torch.stack(tok_k), torch.stack(tok_v)


def decode_step(params: dict, token: torch.Tensor, cache: KVCache, lengths: torch.Tensor,
                cfg: ModelConfig, pctx: PartitionCtx = NULL_CTX):
    """One decode step for every slot: token (B,) int, cache (B, L, Hkv,
    Smax, ·), lengths (B,) int32 tokens already cached.  Returns (logits
    (B, Vp), cache).

    The cache is only read while the layers run (each layer attends over
    its strided slice ``cache[:, li]`` and merges its fresh token in f32);
    afterwards one ``scatter_new_tokens_q`` per leaf writes all layers' new
    tokens in place, cast to the cache dtype or quantized from f32.  Writing
    a token before attending would count it twice.

    On a mesh (``pctx``, the decode rules) ``token`` and ``lengths`` are
    the whole batch's and ``cache`` is this rank's block of it: its rows of
    the batch, and its rows [r * Sl, (r + 1) * Sl) of the sequence, r its
    index on the sequence axis (``_decode_step_sharded``)."""
    if pctx.mesh is not None:
        return _decode_step_sharded(params, token, cache, lengths, cfg, pctx)

    def attend(lp, h, li):
        layer = KVCache(_slice_layer(cache.k, li), _slice_layer(cache.v, li))
        return attention_decode(lp, h, layer, lengths, cfg)

    logits, tok_k, tok_v = _decode_layers(params, token[:, None], cfg, attend)
    scatter_new_tokens_q(cache.k, tok_k, lengths)
    scatter_new_tokens_q(cache.v, tok_v, lengths)
    return logits[:, 0], cache


def _decode_step_sharded(params: dict, token: torch.Tensor, cache: KVCache,
                         lengths: torch.Tensor, cfg: ModelConfig, pctx: PartitionCtx):
    """``decode_step`` on this rank's block of the cache.  Each rank walks
    its own rows of the sequence (local length ``clamp(len - r * Sl, 0,
    Sl)``; an empty shard walks nothing), the ranks of the sequence axis
    merge their partials, and the new token is written by the one rank
    that holds its row.  Returns the whole batch's logits."""
    bg = token.shape[0]
    lo, hi = batch_rows(pctx, bg)
    lens = lengths[lo:hi]
    leaf = cache.k.q if isinstance(cache.k, QuantKV) else cache.k
    sl = leaf.shape[3]
    ax = pctx.resolve(["kv_seq"])[0]
    r = pctx.index(ax)
    walk = seq_walk(lens, sl, pctx)

    def attend(lp, h, li):
        layer = KVCache(_slice_layer(cache.k, li), _slice_layer(cache.v, li))
        return attention_decode(lp, h, layer, lens, cfg, pctx=pctx, walk=walk)

    logits, tok_k, tok_v = _decode_layers(params, token[lo:hi, None], cfg, attend, pctx=pctx)
    smax = sl * pctx.size(ax)
    scatter_new_tokens_seq_shard_q(cache.k, tok_k, lens, r, smax)
    scatter_new_tokens_seq_shard_q(cache.v, tok_v, lens, r, smax)
    return _gather_rows(logits[:, 0], pctx, bg), cache


def decode_step_paged(params: dict, token: torch.Tensor, pages: KVCache,
                      block_tables: torch.Tensor, lengths: torch.Tensor, cfg: ModelConfig,
                      pctx: PartitionCtx = NULL_CTX):
    """One decode step over the paged pool (N, L, Hkv, bs, ·) walked through
    ``block_tables`` (B, P) int32: the structure of ``decode_step``, with
    one ``scatter_new_tokens_paged_q`` per leaf writing every layer's token
    into each sequence's current page.  Slots of length 0 write nothing.
    Returns (logits (B, Vp), pages).

    On a mesh the pool is whole on every rank (any slot's table may name
    any page) and each rank walks its rows of the batch.  The ranks gather
    every slot's new token and each writes all of them, so every rank's
    copy of a page is the same bytes: a prefix page written by a slot of
    one data rank reads the same on another."""
    bg = token.shape[0]
    lo, hi = batch_rows(pctx, bg)

    def attend(lp, h, li):
        return attention_decode_paged(lp, h, _slice_layer(pages.k, li), _slice_layer(pages.v, li),
                                      block_tables[lo:hi], lengths[lo:hi], cfg, pctx)

    logits, tok_k, tok_v = _decode_layers(params, token[lo:hi, None], cfg, attend, pctx=pctx)
    tok_k, tok_v = (_gather_rows(t, pctx, bg, dim=1) for t in (tok_k, tok_v))
    scatter_new_tokens_paged_q(pages.k, tok_k, block_tables, lengths)
    scatter_new_tokens_paged_q(pages.v, tok_v, block_tables, lengths)
    return _gather_rows(logits[:, 0], pctx, bg), pages


def verify(params: dict, tokens: torch.Tensor, cache: KVCache, lengths: torch.Tensor,
           n_tokens: torch.Tensor, cfg: ModelConfig, pctx: PartitionCtx = NULL_CTX):
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
    (``verify_plan``), not once a layer.

    On a mesh (``pctx``, the decode rules) ``tokens``, ``lengths`` and
    ``n_tokens`` are the whole batch's and ``cache`` is this rank's block,
    as in ``decode_step``: each rank scores its rows of the batch, writes
    the block rows that land in its rows of the sequence (a block may
    straddle two ranks' rows), walks each row's local part with the local
    per-row lengths, and the ranks of the sequence axis merge their
    partials.  Returns the whole batch's logits."""
    leaf = cache.k.q if isinstance(cache.k, QuantKV) else cache.k
    bg, w = tokens.shape
    lo, hi = batch_rows(pctx, bg)
    shard = None
    smax = leaf.shape[3]
    if pctx.mesh is not None:
        ax = pctx.resolve(["kv_seq"])[0]
        shard = (pctx.index(ax), smax, pctx.mesh.group(ax))
        smax *= pctx.size(ax)
    plan = verify_plan(lengths[lo:hi], n_tokens[lo:hi], w, smax=smax, seq_shard=shard)

    def attend(lp, h, li):
        layer = KVCache(_layer_view(cache.k, li), _layer_view(cache.v, li))
        return attention_verify(lp, h, layer, plan, cfg, pctx)

    logits = _decode_layers(params, tokens[lo:hi], cfg, attend, apply_norm_blocks, pctx)[0]
    return _gather_rows(logits, pctx, bg), cache


def verify_paged(params: dict, tokens: torch.Tensor, pages: KVCache, block_tables: torch.Tensor,
                 lengths: torch.Tensor, n_tokens: torch.Tensor, cfg: ModelConfig,
                 pctx: PartitionCtx = NULL_CTX):
    """``verify`` over the paged pool (N, L, Hkv, bs, ·) walked through
    ``block_tables`` (B, P) int32: block row i of slot b lands in page
    ``tables[b, (lengths[b] + i) // bs]``; slots of length 0 write nothing.
    Returns (logits (B, W, Vp), pages).

    On a mesh the pool is whole on every rank and each rank scores its
    rows of the batch over it, writing their block rows layer by layer;
    after the layers the ranks of the batch axis gather every slot's rows
    and each writes them all (its own again, the same bytes), so every
    rank's copy of a page holds the same bytes, as ``decode_step_paged``."""
    leaf = pages.k.q if isinstance(pages.k, QuantKV) else pages.k
    bg, w = tokens.shape
    lo, hi = batch_rows(pctx, bg)
    plan = verify_plan(lengths[lo:hi], n_tokens[lo:hi], w, block_tables=block_tables[lo:hi],
                       block_size=leaf.shape[3])

    def attend(lp, h, li):
        return attention_verify_paged(lp, h, _layer_view(pages.k, li), _layer_view(pages.v, li),
                                      plan, cfg, pctx)

    logits, tok_k, tok_v = _decode_layers(params, tokens[lo:hi], cfg, attend, apply_norm_blocks,
                                          pctx)
    if hi - lo < bg:  # the other data ranks' rows
        tok_k, tok_v = (_gather_rows(t, pctx, bg, dim=1) for t in (tok_k, tok_v))
        scatter_verify_tokens_paged_q(pages.k, tok_k, block_tables, lengths, n_tokens)
        scatter_verify_tokens_paged_q(pages.v, tok_v, block_tables, lengths, n_tokens)
    return _gather_rows(logits, pctx, bg), pages
